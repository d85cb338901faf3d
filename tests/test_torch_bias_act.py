"""The port's fused bias + activation and SwiGLU
(`paddle_tpu_torch.ops.kernels.bias_act`) against the JAX package's
(`paddle_tpu.ops.pallas.bias_act`): the plain versions against the
Pallas `_kernel` and `_kernel2` in interpret mode, for every
act_method with and without a bias, and the gradients against `jax.vjp`
through the custom VJPs (`_ba_bwd`: the vjp of `_ref_bias_act`;
`_sw2_bwd`: its f32 formula).

Tolerances: f32 within 1e-6 (relative to each element and to the
output's largest magnitude); bf16 within one ulp of each element's own
magnitude (both sides compute in f32 and round once), except gelu_tanh,
whose JAX side computes tanh with XLA's CPU approximation (within about
2^-22 of tanh): where x << 0, `1 + tanh` cancels, so an element is held
to one ulp plus |x| * 2^-21; gradients within 1e-5 of their largest
magnitude. Then the routing of `incubate.nn.functional`'s `swiglu` and
`fused_bias_act` (and its refusals) and the linear helpers against the
JAX package's, with `FLAGS_pallas_interpret` set.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework import flags
from paddle_tpu.ops.pallas import bias_act as jba
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.ops.kernels import bias_act as ba
from torch_threads import one_thread  # noqa: F401

ROWS, H = 6, 32
ACTS = sorted(ba.ACT_CODES)


def _inputs(seed, h=H):
    rng = np.random.default_rng(seed)
    x = (3 * rng.normal(size=(ROWS, h))).astype(np.float32)
    x[0, :4] = 0.0                      # relu's tie at exactly 0
    b = rng.normal(size=(h,)).astype(np.float32)
    return x, b


def assert_close_f32(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-6,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


def _ulp_bf16(want):
    return 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), 2.0 ** -126)))
                   - 7)


def assert_within_ulp(got, want, dtype):
    """One ulp of each element's own magnitude (bf16 here)."""
    assert dtype == "bfloat16"
    err = np.abs(np.asarray(got, np.float32) - want)
    assert (err <= _ulp_bf16(want)).all(), float(
        (err / _ulp_bf16(want)).max())


def _pallas(x, b, act, dtype):
    jdt = getattr(jnp, dtype)
    out = jba._pallas_bias_act(jnp.asarray(x).astype(jdt),
                               jnp.asarray(b).astype(jdt), act)
    return np.asarray(out.astype(jnp.float32))


@pytest.mark.parametrize("with_bias", [True, False], ids=["bias", "nobias"])
@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_pallas_kernel_f32(act, with_bias):
    x, b = _inputs(0)
    if not with_bias:
        b = np.zeros_like(b)
    want = _pallas(x, b, act, "float32")
    got = ba.bias_act_ref(torch.tensor(x), torch.tensor(b), act)
    assert got.shape == want.shape
    assert_close_f32(got.numpy(), want)


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_matches_pallas_kernel_bf16(act):
    x, b = _inputs(1)
    want = _pallas(x, b, act, "bfloat16")
    xt = torch.tensor(x).bfloat16()
    bt = torch.tensor(b).bfloat16()
    got = ba.bias_act_ref(xt, bt, act)
    assert got.dtype == torch.bfloat16
    tol = _ulp_bf16(want)
    if act == "gelu_tanh":
        tol = tol + np.abs((xt.float() + bt.float()).numpy()) * 2.0 ** -21
    err = np.abs(got.float().numpy() - want)
    assert (err <= tol).all(), float((err / tol).max())


def test_f32_bias_with_bf16_x_and_routing_shapes():
    """An f32 bias on bf16 x (the sum is f32 either way), any leading
    shape, and `bias=None` as zeros in x's dtype; the CPU launches
    nothing."""
    x, b = _inputs(2)
    x3 = x.reshape(2, 3, H)
    jx = jnp.asarray(x3).astype(jnp.bfloat16)
    before = (ba.LAUNCHES.count, ba.LAUNCHES_SWIGLU.count)
    for bias, jbias in ((torch.tensor(b), jnp.asarray(b)), (None, None)):
        want = np.asarray(jba.fused_bias_act(jx, jbias, "swiglu")
                          .astype(jnp.float32))
        got = ba.fused_bias_act(torch.tensor(x3).bfloat16(), bias, "swiglu")
        assert got.shape == (2, 3, H // 2)
        err = np.abs(got.float().numpy() - want)
        assert (err <= _ulp_bf16(want)).all()
    assert (ba.LAUNCHES.count, ba.LAUNCHES_SWIGLU.count) == before


@pytest.mark.parametrize("act", ACTS)
def test_bias_act_gradients_match_jax_vjp(act):
    """`_ba_bwd`'s vjp of the reference: autograd through `bias_act_ref`,
    the A-S polynomial (sign included) for gelu and geglu, half the
    cotangent where relu's `x + bias` is exactly 0."""
    x, b = _inputs(3)
    b[:4] = 0.0                         # x + b == 0 in row 0's first four
    g = np.random.default_rng(4).normal(
        size=(ROWS, H // 2 if ba.ACT_CODES[act][1] else H)).astype(np.float32)

    # `_ba_bwd` is this vjp; jitted whole, one compile (the Pallas forward
    # is left out: it adds nothing to the backward)
    @jax.jit
    def grads(x_, b_, g_):
        return jax.vjp(lambda u, v: jba._ref_bias_act(u, v, act), x_, b_)[1](g_)

    jdx, jdb = grads(jnp.asarray(x), jnp.asarray(b), jnp.asarray(g))
    xt = torch.tensor(x).requires_grad_()
    bt = torch.tensor(b).requires_grad_()
    (ba.fused_bias_act(xt, bt, act) * torch.tensor(g)).sum().backward()
    for got, want in ((xt.grad, jdx), (bt.grad, jdb)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))
    if act == "relu":
        np.testing.assert_array_equal(xt.grad[0, :4].numpy(), 0.5 * g[0, :4])


def test_relu_backward_at_zero_is_half():
    """`jax.grad` of `jnp.maximum(x, 0)` is [0.5, 1, 0] at [0, 1, -1];
    `torch.relu` would give 0 at 0."""
    xt = torch.tensor([0.0, 1.0, -1.0], requires_grad=True)
    ba.fused_bias_act(xt, None, "relu").sum().backward()
    want = jax.grad(lambda v: jba.fused_bias_act(v, None, "relu").sum())(
        jnp.asarray([0.0, 1.0, -1.0], jnp.float32))
    np.testing.assert_array_equal(xt.grad.numpy(), np.asarray(want))
    np.testing.assert_array_equal(xt.grad.numpy(), [0.5, 1.0, 0.0])


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_swiglu_matches_pallas_kernel_and_gradients(dtype):
    """`swiglu(x, y)` (the Pallas `_kernel2`) and its f32 backward
    formula against `jax.vjp` of `swiglu`; the packed form against
    `swiglu(x)`."""
    x, _ = _inputs(5)
    y = np.random.default_rng(6).normal(size=x.shape).astype(np.float32)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    jx, jy = jnp.asarray(x).astype(jdt), jnp.asarray(y).astype(jdt)
    out, vjp = jax.vjp(jba.swiglu, jx, jy)
    g = np.random.default_rng(7).normal(size=x.shape).astype(np.float32)
    jdx, jdy = vjp(jnp.asarray(g).astype(jdt))
    xt = torch.tensor(x).to(tdt).requires_grad_()
    yt = torch.tensor(y).to(tdt).requires_grad_()
    got = ba.swiglu(xt, yt)
    (got.float() * torch.tensor(g).to(tdt).float()).sum().backward()
    packed = ba.swiglu(torch.cat([xt, yt], dim=-1).detach())
    jpacked = jba.swiglu(jnp.concatenate([jx, jy], axis=-1))
    for t, want in ((got, out), (packed, jpacked), (xt.grad, jdx),
                    (yt.grad, jdy)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            assert_close_f32(t.detach().numpy(), want)
        else:
            err = np.abs(t.detach().float().numpy() - want)
            assert (err <= _ulp_bf16(want)).all()


def test_unknown_act_and_odd_glu_width_raise():
    x = torch.zeros((2, 6))
    with pytest.raises(KeyError):
        ba.fused_bias_act(x, None, "tanh")
    with pytest.raises(KeyError):
        jba.fused_bias_act(jnp.zeros((2, 6)), None, "tanh")
    with pytest.raises(ValueError, match="odd width"):
        ba.fused_bias_act(x[:, :5], None, "geglu")


# ---- the routing of the functional surface ----

@pytest.fixture
def jax_kernel_routes():
    """`FLAGS_pallas_interpret` on around the test (restored after), so the
    JAX package's functional surface takes its Pallas routes."""
    prev = flags.flag_value("pallas_interpret")
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": prev})


def J(a, dtype="float32"):
    """A JAX-side Tensor with its own copy of `a`."""
    return Tensor(jnp.array(a, copy=True).astype(getattr(jnp, dtype)))


def P(a, dtype="float32"):
    """A port-side tensor with its own copy of `a`."""
    return torch.tensor(np.asarray(a)).to(getattr(torch, dtype))


def assert_match(got, want):
    """The file's tolerances, by the port output's dtype."""
    w = np.asarray(want._data.astype(jnp.float32))
    g = got.detach().float().numpy()
    assert g.shape == w.shape
    if got.dtype in (torch.float32, torch.float64):
        assert_close_f32(g, w)
    else:
        assert_within_ulp(g, w, str(got.dtype).replace("torch.", ""))


class Spy:
    """Counts calls through one module attribute (a routing check)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float64"])
def test_swiglu_both_forms_route_as_jax(dtype, monkeypatch,
                                        jax_kernel_routes):
    rng = np.random.default_rng(3)
    x, y = rng.normal(size=(2, 3, 8)), rng.normal(size=(2, 3, 8))
    kernel = dtype != "float64"
    spy2 = Spy(monkeypatch, PF._ba, "swiglu")
    got = PF.swiglu(P(x, dtype), P(y, dtype))
    assert_match(got, JF.swiglu(J(x, dtype), J(y, dtype)))
    xy = np.concatenate([x, y], axis=-1)
    got = PF.swiglu(P(xy, dtype))
    assert got.shape == (2, 3, 8)
    assert_match(got, JF.swiglu(J(xy, dtype)))
    assert spy2.calls == 2 * kernel


@pytest.mark.parametrize("act,bias,dtype", [
    ("gelu", "float32", "bfloat16"), ("GELU_TANH", None, "float32"),
    ("geglu", "float32", "float32"), ("relu", "float64", "float64")])
def test_fused_bias_act_routes_as_jax(act, bias, dtype, monkeypatch,
                                     jax_kernel_routes):
    rng = np.random.default_rng(4)
    x, b = 2 * rng.normal(size=(2, 3, 8)), rng.normal(size=(8,))
    spy = Spy(monkeypatch, PF._ba, "fused_bias_act")
    want = JF.fused_bias_act(J(x, dtype), None if bias is None else
                             J(b, bias), act_method=act)
    got = PF.fused_bias_act(P(x, dtype), None if bias is None else
                            P(b, bias), act_method=act)
    assert spy.calls == int(dtype != "float64")
    assert_match(got, want)


@pytest.mark.parametrize("arg,value", [
    ("dequant_scales", "tensor"), ("shift", "tensor"), ("smooth", "tensor"),
    ("compute_dtype", "fp16"), ("quant_scale", 0.5),
    ("quant_round_type", 1), ("quant_max_bound", 127.0),
    ("quant_min_bound", -127.0)])
def test_fused_bias_act_refuses_what_jax_ignores(arg, value):
    x = torch.zeros((2, 8))
    if value == "tensor":
        value = torch.ones(8)
    with pytest.raises(NotImplementedError, match=arg):
        PF.fused_bias_act(x, act_method="gelu", **{arg: value})
    with pytest.raises(KeyError):
        PF.fused_bias_act(x, act_method="tanh")


def test_fused_linear_and_linear_activation_match_jax(jax_kernel_routes):
    rng = np.random.default_rng(5)
    x, w, b = (rng.normal(size=(2, 3, 6)), rng.normal(size=(6, 4)),
               rng.normal(size=(4,)))
    assert_match(PF.fused_linear(P(x), P(w), P(b)),
                 JF.fused_linear(J(x), J(w), J(b)))
    assert_match(PF.fused_linear(P(x), P(w.T), transpose_weight=True),
                 JF.fused_linear(J(x), J(w.T), transpose_weight=True))
    x2 = rng.normal(size=(6, 3))
    assert_match(
        PF.fused_linear_activation(P(x2), P(w.T), P(b), trans_x=True,
                                   trans_y=True, activation="relu"),
        JF.fused_linear_activation(J(x2), J(w.T), J(b), trans_x=True,
                                   trans_y=True, activation="relu"))
