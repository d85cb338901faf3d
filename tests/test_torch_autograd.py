"""Every scenario of `tests/test_autograd.py` on both packages: each runs
with its own assertions on the JAX package and on the port (on the CPU),
the port's tape being torch autograd, and the port's results are held to
the JAX package's within `TOL` (`torch_eager_common.py`: f32 rtol 1e-5 /
atol 1e-6, f64 rtol 1e-10 / atol 1e-12). The higher-order cases (double
and triple grad, cross terms, hessian, jacobian, vjp, jvp) also hold
each package to `jax.grad` / `jax.hessian` / `jax.jvp`, as the originals
do. Then `PyLayer` on both packages, and the edges of `paddle.grad`."""
import numpy as np
import pytest

import jax
import jax.numpy as jnp

from torch_eager_common import Scenarios, fresh, port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

SC = Scenarios()
PKGS = ("jax", "torch")


def simple_backward(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    y = (x * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 4.0, 6.0])
    return {"y": y, "grad": x.grad}


def chain(paddle):
    x = paddle.to_tensor(2.0, stop_gradient=False)
    y = x * x
    z = y * x
    z.backward()
    np.testing.assert_allclose(x.grad.numpy(), 12.0)
    return {"z": z, "grad": x.grad}


def branching_accumulation(paddle):
    x = paddle.to_tensor(3.0, stop_gradient=False)
    out = x * 2 + x * 4
    out.backward()
    np.testing.assert_allclose(x.grad.numpy(), 6.0)
    return {"grad": x.grad}


def matmul_grad(paddle):
    rng = np.random.default_rng(1)
    a_np = rng.standard_normal((3, 4)).astype(np.float32)
    b_np = rng.standard_normal((4, 5)).astype(np.float32)
    a = paddle.to_tensor(fresh(a_np), stop_gradient=False)
    b = paddle.to_tensor(fresh(b_np), stop_gradient=False)
    out = paddle.matmul(a, b).sum()
    out.backward()
    np.testing.assert_allclose(a.grad.numpy(), np.ones((3, 5)) @ b_np.T,
                               rtol=1e-5)
    np.testing.assert_allclose(b.grad.numpy(), a_np.T @ np.ones((3, 5)),
                               rtol=1e-5)
    return {"out": out, "ga": a.grad, "gb": b.grad}


def stop_gradient_blocks(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    y = paddle.to_tensor([2.0], stop_gradient=True)
    (x * y).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [2.0])
    assert y.grad is None
    return {"gx": x.grad, "gy": y.grad is None}


def grad_accumulates_across_backwards(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    (x * 2).sum().backward()
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [5.0])
    g = x.grad.numpy().copy()
    x.clear_grad()
    assert x.grad is None
    return {"g": g, "cleared": x.grad is None}


def no_grad_context(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with paddle.no_grad():
        y = x * 2
    assert y.stop_gradient
    return {"sg": y.stop_gradient, "y": y}


def backward_through_multi_output_op(paddle):
    x = paddle.to_tensor(fresh(np.arange(6, dtype=np.float32)),
                         stop_gradient=False)
    a, b = paddle.split(x, 2)
    out = (a * 2).sum() + (b * 3).sum()
    out.backward()
    np.testing.assert_allclose(x.grad.numpy(), [2, 2, 2, 3, 3, 3])
    return {"a": a, "b": b, "grad": x.grad}


def retain_graph(paddle):
    x = paddle.to_tensor(2.0, stop_gradient=False)
    y = x * x
    y.backward(retain_graph=True)
    y.backward(retain_graph=False)
    np.testing.assert_allclose(x.grad.numpy(), 8.0)
    with pytest.raises(RuntimeError):
        y.backward()
    return {"grad": x.grad}


def paddle_grad_api(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = (x * x).sum()
    (gx,) = paddle.grad(y, x)
    np.testing.assert_allclose(gx.numpy(), [2.0, 4.0])
    assert x.grad is None
    return {"gx": gx, "sg": gx.stop_gradient, "untouched": x.grad is None}


def paddle_grad_nonleaf(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    h = x * 3
    y = (h * h).sum()
    (gh,) = paddle.grad(y, h, retain_graph=True)
    np.testing.assert_allclose(gh.numpy(), [6.0, 12.0])
    return {"gh": gh}


def hook(paddle):
    x = paddle.to_tensor([1.0, 1.0], stop_gradient=False)
    seen = []

    def fn(g):
        seen.append(g.numpy().copy())
        return g * 2

    x.register_hook(fn)
    (x * 3).sum().backward()
    assert len(seen) == 1
    np.testing.assert_allclose(seen[0], [3.0, 3.0])
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])
    return {"seen": seen, "grad": x.grad}


def backward_nonscalar_with_grad_tensor(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    y = x * 2
    y.backward(paddle.to_tensor([1.0, 10.0]))
    np.testing.assert_allclose(x.grad.numpy(), [2.0, 20.0])
    return {"grad": x.grad}


def int_output_op_no_grad(paddle):
    x = paddle.to_tensor([3.0, 1.0, 2.0], stop_gradient=False)
    i = paddle.argmax(x)
    assert i.stop_gradient
    g = paddle.gather(x, paddle.to_tensor([0, 1]))
    g.sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [1.0, 1.0, 0.0])
    return {"i": i, "i_sg": i.stop_gradient, "g": g, "grad": x.grad}


def reduction_grads(paddle):
    x = paddle.to_tensor(fresh(np.ones((2, 3), np.float32)),
                         stop_gradient=False)
    paddle.mean(x).backward()
    np.testing.assert_allclose(x.grad.numpy(), np.full((2, 3), 1 / 6))
    return {"grad": x.grad}


def softmax_ce_style_grad(paddle):
    rng = np.random.default_rng(2)
    logits = paddle.to_tensor(
        fresh(rng.standard_normal((4, 10)).astype(np.float32)),
        stop_gradient=False)
    p = paddle.ops.activation.softmax(logits)
    loss = -(paddle.log(p + 1e-9)[:, 0]).mean()
    loss.backward()
    assert logits.grad is not None
    assert np.isfinite(logits.grad.numpy()).all()
    return {"p": p, "loss": loss, "grad": logits.grad}


def double_grad_matches_jax_composition(paddle):
    rng = np.random.default_rng(0)
    xv = rng.normal(size=(4,))
    wv = rng.normal(size=(4, 4))
    cases = [
        ("cube", lambda x: (x * x * x).sum(), lambda a: (a ** 3).sum()),
        ("exp", lambda x: paddle.exp(x).sum(), lambda a: jnp.exp(a).sum()),
        ("sin", lambda x: paddle.sin(x).sum(), lambda a: jnp.sin(a).sum()),
        ("tanh", lambda x: paddle.tanh(x * x).sum(),
         lambda a: jnp.tanh(a * a).sum()),
        ("div", lambda x: (1.0 / (x * x + 1.0)).sum(),
         lambda a: (1.0 / (a * a + 1.0)).sum()),
        ("matmul", lambda x: paddle.matmul(
            paddle.Tensor(fresh(wv)), x.reshape([4, 1])).sum(),
         lambda a: (jnp.asarray(wv) @ a.reshape(4, 1)).sum()),
    ]
    out = {}
    for name, pf, jf in cases:
        x = paddle.Tensor(fresh(xv))
        x.stop_gradient = False
        (g1,) = paddle.grad(pf(x), [x], create_graph=True)
        (g2,) = paddle.grad(g1.sum(), [x])
        jg2 = jax.grad(lambda a: jax.grad(jf)(a).sum())(jnp.asarray(xv))
        np.testing.assert_allclose(g2.numpy(), np.asarray(jg2), rtol=1e-5,
                                   atol=1e-7, err_msg=name)
        out[name] = (g1.numpy(), g2)
    return out


def triple_grad(paddle):
    x = paddle.Tensor(np.asarray(0.7))
    x.stop_gradient = False
    y = paddle.sin(x * x)
    (g1,) = paddle.grad(y, [x], create_graph=True)
    (g2,) = paddle.grad(g1, [x], create_graph=True)
    (g3,) = paddle.grad(g2, [x])
    ref = jax.grad(jax.grad(jax.grad(lambda a: jnp.sin(a * a))))(0.7)
    np.testing.assert_allclose(float(g3), float(ref), rtol=1e-6)
    return {"g1": g1.numpy(), "g2": g2.numpy(), "g3": g3}


def double_grad_multivar_cross_terms(paddle):
    xv, wv = np.asarray([0.5, -1.0]), np.asarray([2.0, 3.0])
    x = paddle.Tensor(fresh(xv))
    x.stop_gradient = False
    w = paddle.Tensor(fresh(wv))
    w.stop_gradient = False
    y = ((x * w) ** 2).sum()
    (gw,) = paddle.grad(y, [w], create_graph=True)
    (gx,) = paddle.grad(gw.sum(), [x])
    jf = lambda a, b: ((a * b) ** 2).sum()  # noqa: E731
    ref = jax.grad(lambda a, b: jax.grad(jf, argnums=1)(a, b).sum())(
        jnp.asarray(xv), jnp.asarray(wv))
    np.testing.assert_allclose(gx.numpy(), np.asarray(ref), rtol=1e-6)
    return {"gw": gw.numpy(), "gx": gx}


def hessian_and_jacobian(paddle):
    xv = np.asarray([0.3, -0.8, 1.2])
    x = paddle.Tensor(fresh(xv))
    x.stop_gradient = False
    h = paddle.autograd.hessian((paddle.exp(x) * x).sum(), x)
    ref_h = jax.hessian(lambda a: (jnp.exp(a) * a).sum())(jnp.asarray(xv))
    np.testing.assert_allclose(h.numpy(), np.asarray(ref_h), rtol=1e-5)
    x2 = paddle.Tensor(fresh(xv))
    x2.stop_gradient = False
    j = paddle.autograd.jacobian(paddle.sin(x2), x2)
    ref_j = jax.jacobian(jnp.sin)(jnp.asarray(xv))
    np.testing.assert_allclose(j.numpy(), np.asarray(ref_j), rtol=1e-5)
    return {"h": h.numpy(), "j": j.numpy()}


def vjp_jvp_functional(paddle):
    xv = np.asarray([0.4, 0.9])

    def f(x):
        return paddle.exp(x) * x

    ys, g = paddle.autograd.vjp(f, paddle.Tensor(fresh(xv)),
                                paddle.Tensor(np.asarray([1.0, 2.0])))
    _, ref = jax.vjp(lambda a: jnp.exp(a) * a, jnp.asarray(xv))
    np.testing.assert_allclose(g.numpy(),
                               np.asarray(ref(jnp.asarray([1.0, 2.0]))[0]),
                               rtol=1e-6)
    x = paddle.Tensor(fresh(xv))
    ys2, jv = paddle.autograd.jvp(f, x, paddle.Tensor(np.asarray([1.0,
                                                                  2.0])))
    _, ref_jv = jax.jvp(lambda a: jnp.exp(a) * a, (jnp.asarray(xv),),
                        (jnp.asarray([1.0, 2.0]),))
    np.testing.assert_allclose(jv.numpy(), np.asarray(ref_jv), rtol=1e-6)
    return {"ys": ys.numpy(), "vjp": g.numpy(), "jvp": jv.numpy(),
            "x_sg": x.stop_gradient}


def double_grad_with_grad_outputs_on_tape(paddle):
    x = paddle.Tensor(np.asarray([1.0, 2.0]))
    x.stop_gradient = False
    s = paddle.Tensor(np.asarray([3.0, 4.0]))
    s.stop_gradient = False
    (g1,) = paddle.grad([x * x], [x], grad_outputs=[s], create_graph=True)
    (gs,) = paddle.grad(g1.sum(), [s])
    np.testing.assert_allclose(gs.numpy(), [2.0, 4.0], rtol=1e-6)
    return {"g1": g1.numpy(), "gs": gs}


def hessian_cross_blocks(paddle):
    xv, wv = np.asarray([0.5, -1.0]), np.asarray([2.0, 3.0])
    x = paddle.Tensor(fresh(xv))
    x.stop_gradient = False
    w = paddle.Tensor(fresh(wv))
    w.stop_gradient = False
    y = ((x * w) ** 2).sum()
    H = paddle.autograd.hessian(y, [x, w])
    jf = lambda a, b: ((a * b) ** 2).sum()  # noqa: E731
    ref = jax.hessian(jf, argnums=(0, 1))(jnp.asarray(xv), jnp.asarray(wv))
    for i in range(2):
        for j in range(2):
            np.testing.assert_allclose(H[i][j].numpy(), np.asarray(ref[i][j]),
                                       rtol=1e-6, err_msg=f"block {i}{j}")
    with pytest.raises(NotImplementedError):
        paddle.autograd.hessian(y, x, batch_axis=0)
    return {"H": [[H[i][j].numpy() for j in range(2)] for i in range(2)]}


SCENARIOS = [simple_backward, chain, branching_accumulation, matmul_grad,
             stop_gradient_blocks, grad_accumulates_across_backwards,
             no_grad_context, backward_through_multi_output_op, retain_graph,
             paddle_grad_api, paddle_grad_nonleaf, hook,
             backward_nonscalar_with_grad_tensor, int_output_op_no_grad,
             reduction_grads, softmax_ce_style_grad,
             double_grad_matches_jax_composition, triple_grad,
             double_grad_multivar_cross_terms, hessian_and_jacobian,
             vjp_jvp_functional, double_grad_with_grad_outputs_on_tape,
             hessian_cross_blocks]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_autograd_scenario(scenario, pkg):
    SC.run(scenario, pkg)


def pylayer(paddle):
    """A PyLayer (cube with a hand-written backward, one Tensor and one
    float argument) inside a taped expression, its backward's inputs
    recorded, then the same under no_grad."""
    calls = []

    class Cube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, k):
            ctx.save_for_backward(x)
            ctx.k = k
            return x * x * x * k

        @staticmethod
        def backward(ctx, dy):
            (x,) = ctx.saved_tensor()
            calls.append(dy.numpy().copy())
            return dy * 3 * x * x * ctx.k

    x = paddle.to_tensor([1.0, -2.0, 0.5], stop_gradient=False)
    y = Cube.apply(x * 2, 0.5)
    (y.sum() + (y * y).sum()).backward()
    with paddle.no_grad():
        z = Cube.apply(x, 2.0)
    return {"y": y, "y_sg": y.stop_gradient, "grad": x.grad, "calls": calls,
            "z": z, "z_sg": z.stop_gradient}


@pytest.mark.parametrize("pkg", PKGS)
def test_pylayer(pkg):
    SC.run(pylayer, pkg)


def test_pylayer_backward_arity_is_checked():
    import paddle_tpu_torch as paddle

    class Bad(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, x, y):
            return x + y

        @staticmethod
        def backward(ctx, dy):
            return dy

    x = paddle.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError, match="2 tensor inputs"):
        Bad.apply(x, paddle.to_tensor([2.0])).backward()


def test_paddle_grad_edges():
    """Unused and non-differentiable inputs raise unless
    `allow_unused=True`; `no_grad_vars` raises instead of being
    ignored; an output that stops gradient contributes nothing."""
    import paddle_tpu_torch as paddle

    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    w = paddle.to_tensor([3.0, 4.0], stop_gradient=False)
    c = paddle.to_tensor([5.0])
    y = (x * x).sum()
    with pytest.raises(RuntimeError, match="unused"):
        paddle.grad(y, [x, w])
    gx, gw = paddle.grad(y, [x, w], allow_unused=True)
    assert gw is None
    np.testing.assert_allclose(gx.numpy(), [2.0, 4.0])
    with pytest.raises(RuntimeError, match="does not require grad"):
        paddle.grad(y, [c])
    assert paddle.grad(y, [c], allow_unused=True) == [None]
    with pytest.raises(NotImplementedError):
        paddle.grad(y, [x], no_grad_vars=[w])
    (g,) = paddle.grad([y, c.sum()], [x])
    np.testing.assert_allclose(g.numpy(), [2.0, 4.0])
    # a create_graph gradient constant in x still differentiates: zeros
    (g1,) = paddle.grad((x * 3).sum(), [x], create_graph=True)
    (g2,) = paddle.grad(g1.sum(), [x])
    np.testing.assert_array_equal(g2.numpy(), [0.0, 0.0])


def test_grad_mode_switches():
    import paddle_tpu_torch as paddle

    x = paddle.to_tensor([1.0], stop_gradient=False)

    @paddle.no_grad()
    def f(t):
        return t * 2

    assert f(x).stop_gradient and paddle.is_grad_enabled()
    with paddle.set_grad_enabled(False):
        assert not paddle.is_grad_enabled()
        with paddle.enable_grad():
            assert not (x * 2).stop_gradient
    assert paddle.is_grad_enabled()
