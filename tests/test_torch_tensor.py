"""Every scenario of `tests/test_tensor.py` on both packages: each runs
with its own assertions on the JAX package and on the port (on the CPU),
and the port's results are held to the JAX package's — exactly for
integers, dtypes, shapes and `stop_gradient`, within `TOL` for floats
(`torch_eager_common.py`). The draws of `test_creation_ops` are seeded,
so their values are compared too. Then what only the port has: the
default place is the card, `stop_gradient = True` on a non-leaf cuts the
graph, and bfloat16 `.numpy()`."""
import numpy as np
import pytest
import torch

from torch_eager_common import Scenarios, fresh, port_on_cpu  # noqa: F401

SC = Scenarios()
PKGS = ("jax", "torch")


def to_tensor_basics(paddle):
    t = paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]])
    assert t.shape == [2, 2]
    assert t.dtype == paddle.float32
    assert t.stop_gradient is True
    np.testing.assert_allclose(t.numpy(), [[1, 2], [3, 4]])
    return {"t": t, "shape": t.shape, "dtype": t.dtype.name,
            "sg": t.stop_gradient}


def int_dtype_default(paddle):
    t = paddle.to_tensor([1, 2, 3])
    assert t.dtype == paddle.int64
    return {"t": t, "dtype": t.dtype.name}


def scalar_item(paddle):
    t = paddle.to_tensor(3.5)
    assert t.item() == pytest.approx(3.5)
    assert float(t) == pytest.approx(3.5)
    return {"item": t.item(), "shape": t.shape}


def arith_dunders(paddle):
    a = paddle.to_tensor([1.0, 2.0])
    b = paddle.to_tensor([3.0, 4.0])
    out = {"add": a + b, "sub": a - b, "mul": a * b, "div": b / a,
           "add1": a + 1, "radd": 1 + a, "rsub": 2 - a, "pow": a ** 2}
    for k, want in (("add", [4, 6]), ("sub", [-2, -2]), ("mul", [3, 8]),
                    ("div", [3, 2]), ("add1", [2, 3]), ("radd", [2, 3]),
                    ("rsub", [1, 0]), ("pow", [1, 4])):
        np.testing.assert_allclose(out[k].numpy(), want)
    return out


def scalar_promotion(paddle):
    a = paddle.to_tensor([1, 2])
    out = a + 0.5
    assert out.dtype == paddle.float32
    out2 = a + 1
    assert out2.dtype == paddle.int64
    return {"f": out, "i": out2}


def mixed_dtype_promotion(paddle):
    a = paddle.to_tensor([1, 2])
    b = paddle.to_tensor([1.0, 2.0])
    assert (a + b).dtype == paddle.float32
    q = a / paddle.to_tensor([2, 2])
    assert q.dtype == paddle.float32
    return {"sum": a + b, "quot": q}


def getitem_setitem(paddle):
    t = paddle.to_tensor(fresh(np.arange(12, dtype=np.float32)
                               .reshape(3, 4)))
    out = {"row": t[0], "col": t[:, 1], "step": t[1:, ::2]}
    np.testing.assert_allclose(out["row"].numpy(), [0, 1, 2, 3])
    np.testing.assert_allclose(out["col"].numpy(), [1, 5, 9])
    np.testing.assert_allclose(out["step"].numpy(), [[4, 6], [8, 10]])
    t[0, 0] = 100.0
    assert t.numpy()[0, 0] == 100.0
    idx = paddle.to_tensor([0, 2])
    np.testing.assert_allclose(t[idx].numpy()[1], [8, 9, 10, 11])
    out.update(after=t, gathered=t[idx], neg=t[-1], none=t[None, 1])
    return out


def bool_mask_getitem(paddle):
    t = paddle.to_tensor([1.0, 2.0, 3.0, 4.0])
    mask = t > 2
    out = t[mask]
    np.testing.assert_allclose(out.numpy(), [3, 4])
    return {"mask": mask, "out": out}


def astype_cast(paddle):
    t = paddle.to_tensor([1.5, 2.5])
    i = t.astype("int32")
    assert i.dtype == paddle.int32
    b = t.astype(paddle.bfloat16)
    assert b.dtype == paddle.bfloat16
    return {"i": i, "b_dtype": b.dtype.name, "b": b.astype("float32")}


def detach_and_stop_gradient(paddle):
    t = paddle.to_tensor([1.0], stop_gradient=False)
    d = t.detach()
    assert d.stop_gradient
    assert not t.stop_gradient
    return {"d": d.stop_gradient, "t": t.stop_gradient}


def repr_runs(paddle):
    t = paddle.ones([2, 2])
    assert "Tensor" in repr(t)
    return {"starts": repr(t).split("(")[0]}


def compare_ops(paddle):
    a = paddle.to_tensor([1.0, 2.0, 3.0])
    assert (a == a).all().item()
    assert bool((a < 2).numpy()[0])
    assert paddle.equal_all(a, a).item()
    return {"eq": a == a, "lt": a < 2, "all": paddle.equal_all(a, a),
            "ne": a != 2.0, "ge": a >= 2}


def creation_ops(paddle):
    paddle.seed(7)
    assert paddle.zeros([2, 3]).shape == [2, 3]
    assert paddle.ones([2], dtype="int32").dtype == paddle.int32
    assert paddle.full([2], 7).numpy().tolist() == [7.0, 7.0]
    assert paddle.arange(5).dtype == paddle.int64
    assert paddle.arange(0, 1, 0.25).shape == [4]
    assert paddle.eye(3).numpy()[1][1] == 1
    np.testing.assert_allclose(paddle.linspace(0, 1, 5).numpy(),
                               [0, .25, .5, .75, 1])
    t = paddle.rand([4, 4])
    assert t.shape == [4, 4]
    n = paddle.randn([10])
    assert n.dtype == paddle.float32
    r = paddle.randint(0, 5, [100])
    assert int(r.numpy().max()) < 5
    return {"zeros": paddle.zeros([2, 3]), "ones": paddle.ones([2],
                                                              dtype="int32"),
            "full": paddle.full([2], 7), "arange": paddle.arange(5),
            "farange": paddle.arange(0, 1, 0.25), "eye": paddle.eye(3),
            "linspace": paddle.linspace(0, 1, 5), "rand": t, "randn": n,
            "randint": r}


def seed_reproducible(paddle):
    paddle.seed(42)
    a = paddle.rand([4])
    paddle.seed(42)
    b = paddle.rand([4])
    np.testing.assert_allclose(a.numpy(), b.numpy())
    return {"a": a, "b": b}


def inplace_setitem_grad(paddle):
    x = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    y = x * 2
    y[0] = 10.0
    loss = y.sum()
    loss.backward()
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 2.0, 2.0])
    return {"grad": x.grad, "y": y, "loss": loss}


def round_half_away_from_zero(paddle):
    t = paddle.to_tensor([0.5, 1.5, 2.5, -0.5, -2.5])
    assert paddle.round(t).numpy().tolist() == [1.0, 2.0, 3.0, -1.0, -3.0]
    t2 = paddle.to_tensor([1.25, -1.25])
    np.testing.assert_allclose(paddle.round(t2, decimals=1).numpy(),
                               [1.3, -1.3], atol=1e-6)
    return {"r": paddle.round(t), "r1": paddle.round(t2, decimals=1)}


def inplace_on_leaf_raises(paddle):
    x = paddle.to_tensor([1.0], stop_gradient=False)
    with pytest.raises(RuntimeError):
        x.add_(1.0)
    with paddle.no_grad():
        x.add_(1.0)
    assert x.numpy().tolist() == [2.0]
    return {"x": x, "sg": x.stop_gradient, "leaf": x.is_leaf}


def nonscalar_backward_fills_ones(paddle):
    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    (x * 3).backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    return {"grad": x.grad}


def uint_dtypes(paddle):
    t = paddle.Tensor(fresh(np.zeros(2, dtype=np.uint16)))
    assert t.dtype.name == "uint16"
    return {"dtype": t.dtype.name, "shape": t.shape}


SCENARIOS = [to_tensor_basics, int_dtype_default, scalar_item,
             arith_dunders, scalar_promotion, mixed_dtype_promotion,
             getitem_setitem, bool_mask_getitem, astype_cast,
             detach_and_stop_gradient, repr_runs, compare_ops, creation_ops,
             seed_reproducible, inplace_setitem_grad,
             round_half_away_from_zero, inplace_on_leaf_raises,
             nonscalar_backward_fills_ones, uint_dtypes]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_tensor_scenario(scenario, pkg):
    SC.run(scenario, pkg)


# ---------------------------------------------------------------------------
# the port alone
# ---------------------------------------------------------------------------

def test_default_place_is_the_card():
    """Without `set_device("cpu")` a new tensor goes to the card, and with
    no card it raises instead of landing on the CPU."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place

    with place.device_scope(None):
        assert paddle.get_device() == "gpu:0"
        if torch.cuda.is_available():
            assert paddle.to_tensor([1.0]).place == paddle.CUDAPlace(0)
        else:
            for make in (lambda: paddle.to_tensor([1.0]),
                         lambda: paddle.zeros([2]), lambda: paddle.rand([2]),
                         lambda: paddle.Tensor(np.zeros(2))):
                with pytest.raises(RuntimeError, match="set_device"):
                    make()
    assert paddle.to_tensor([1.0]).place == paddle.CPUPlace()


def test_stop_gradient_on_a_non_leaf_cuts_the_graph():
    import paddle_tpu_torch as paddle

    x = paddle.to_tensor([1.0, 2.0], stop_gradient=False)
    h = x * 3
    assert not h.stop_gradient and not h.is_leaf
    h.stop_gradient = True
    assert h.stop_gradient and h.is_leaf
    y = (h * x).sum()
    y.backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 6.0])


def test_hook_handle_removes_and_clear_gradient():
    import paddle_tpu_torch as paddle

    x = paddle.to_tensor([1.0, 1.0], stop_gradient=False)
    handle = x.register_hook(lambda g: g * 2)
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [6.0, 6.0])
    handle.remove()
    x.clear_gradient(set_to_zero=True)
    np.testing.assert_allclose(x.grad.numpy(), [0.0, 0.0])
    (x * 3).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(), [3.0, 3.0])
    with pytest.raises(RuntimeError):
        paddle.to_tensor([1.0]).register_hook(lambda g: g)


def test_bfloat16_numpy_keeps_the_bits_or_raises(monkeypatch):
    """bf16 `.numpy()` gives JAX's `ml_dtypes.bfloat16` array, bit for
    bit; without ml_dtypes it raises, naming `astype`, instead of
    converting to float32."""
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as paddle

    vals = np.array([1.0, -2.5, 3.14159, 1e-3], np.float32)
    got = paddle.to_tensor(fresh(vals), dtype="bfloat16").numpy()
    want = jpaddle.to_tensor(fresh(vals), dtype="bfloat16").numpy()
    assert got.dtype == want.dtype and got.dtype.name == "bfloat16"
    np.testing.assert_array_equal(got.view(np.uint16), want.view(np.uint16))
    back = paddle.to_tensor(got)
    assert back.dtype == paddle.bfloat16
    assert torch.equal(back._data, paddle.to_tensor(fresh(vals),
                                                    dtype="bfloat16")._data)
    monkeypatch.setattr(paddle.bfloat16, "np_dtype", None)
    with pytest.raises(TypeError, match="astype"):
        paddle.to_tensor(fresh(vals)).astype("bfloat16").numpy()


def test_dispatch_hooks_and_check_nan_inf():
    """The dispatcher's hook points: op observers see every op's name and
    outputs, the AMP hook rewrites the inputs, and `FLAGS_check_nan_inf`
    raises on a NaN output in both packages (level 0)."""
    import paddle_tpu as jpaddle
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import dispatch

    seen = []

    def observer(name, outs):
        seen.append((name, [o.shape for o in outs]))

    dispatch.add_op_observer(observer)
    try:
        a = paddle.to_tensor([1.0, 2.0])
        paddle.exp(a * 2)
    finally:
        dispatch.remove_op_observer(observer)
    assert seen == [("multiply", [[2]]), ("exp", [[2]])]
    dispatch.set_amp_hook(lambda name, ins: [
        paddle.Tensor(i._data.double()) if isinstance(i, paddle.Tensor)
        else i for i in ins])
    try:
        assert paddle.exp(a).dtype == paddle.float64
    finally:
        dispatch.set_amp_hook(None)
    for p in (jpaddle, paddle):
        p.set_flags({"FLAGS_check_nan_inf": True})
        try:
            with pytest.raises(FloatingPointError, match="log"):
                p.log(p.to_tensor([-1.0]))
        finally:
            p.set_flags({"FLAGS_check_nan_inf": False})
    assert np.isnan(paddle.log(paddle.to_tensor([-1.0])).numpy()[0])
