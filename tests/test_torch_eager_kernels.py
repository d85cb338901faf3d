"""`scaled_dot_product_attention` and `rms_norm` on eager Tensors: the
port's routes (the flash / RMSNorm kernels' plain versions on CPU
tensors, or the composites) against the JAX package's eager ops, with
its default composite and with `FLAGS_pallas_interpret` (its Pallas
kernels in interpret mode), forward and `paddle.grad` — f32, within
rtol 1e-4 / atol 1e-5 (the routes sum in different orders and the
composites divide by `sqrt` where the kernels multiply by `rsqrt`).
Second derivatives through both ops on CPU tensors match JAX's
composite within rtol 1e-4 / atol 1e-4; on a CUDA tensor a second
derivative through the flash kernels raises the typed
`KernelNotDifferentiableError`, never a detached gradient (RMSNorm's
backward is plain PyTorch and differentiates on either device)."""
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.nn.functional as JF
from paddle_tpu.framework import flags as jflags
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.nn.functional as TF
from paddle_tpu_torch.ops.kernels import _support
from paddle_tpu_torch.ops.kernels import flash_attention as tflash

from torch_eager_common import fresh, port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-4, atol=1e-5)
TOL2 = dict(rtol=1e-4, atol=1e-4)
PKGS = {"jax": (jpaddle, JF), "torch": (tpaddle, TF)}


@pytest.fixture(params=["composite", "interpret"])
def jax_mode(request):
    prev = jflags.flag_value("pallas_interpret")
    jflags.set_flags({"pallas_interpret": request.param == "interpret"})
    yield request.param
    jflags.set_flags({"pallas_interpret": prev})


def _attn_inputs(b, s, h, kvh, d, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.standard_normal(shape).astype(np.float32)
            for shape in ((b, s, h, d), (b, s, kvh, d), (b, s, kvh, d),
                          (b, s, h, d))]


def _sdpa_run(pkg, arrays, causal, order=1):
    paddle, F = PKGS[pkg]
    q, k, v, do = (paddle.to_tensor(fresh(a)) for a in arrays)
    for t in (q, k, v):
        t.stop_gradient = False
    out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
    loss = (out * do).sum()
    if order == 1:
        grads = paddle.grad(loss, [q, k, v])
    else:
        (gq,) = paddle.grad(loss, [q], create_graph=True)
        grads = paddle.grad((gq * gq).sum(), [q, k, v])
    return out, out.stop_gradient, [g.numpy() for g in grads]


# (B, S, H, KVH, D): the flash route (D a multiple of 16), GQA, and a
# head dim both packages give to the plain composite
ATTN = [(1, 16, 2, 2, 16), (2, 16, 4, 2, 32), (1, 8, 2, 1, 8)]


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("shape", ATTN, ids=lambda s: "x".join(map(str, s)))
def test_sdpa_on_tensors_matches_jax(shape, causal, jax_mode):
    arrays = _attn_inputs(*shape)
    jo, jsg, jg = _sdpa_run("jax", arrays, causal)
    to, tsg, tg = _sdpa_run("torch", arrays, causal)
    assert isinstance(to, tpaddle.Tensor) and tsg is jsg is False
    np.testing.assert_allclose(to.numpy(), jo.numpy(), **TOL)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, err_msg=f"d{name}", **TOL)


@pytest.mark.parametrize("causal", [False, True])
def test_sdpa_second_derivative_matches_jax_composite(causal):
    arrays = _attn_inputs(1, 16, 2, 1, 16, seed=3)
    _, _, jg = _sdpa_run("jax", arrays, causal, order=2)
    _, _, tg = _sdpa_run("torch", arrays, causal, order=2)
    for name, a, b in zip("qkv", tg, jg):
        np.testing.assert_allclose(a, b, err_msg=f"d2/d{name}", **TOL2)


def _rms_run(pkg, x, w, order=1):
    paddle, F = PKGS[pkg]
    xt, wt = paddle.to_tensor(fresh(x)), paddle.to_tensor(fresh(w))
    xt.stop_gradient = wt.stop_gradient = False
    y = F.rms_norm(xt, wt, 1e-6)
    loss = (y * y * paddle.to_tensor(fresh(np.arange(
        x.shape[-1], dtype=np.float32) / x.shape[-1]))).sum()
    if order == 1:
        grads = paddle.grad(loss, [xt, wt])
    else:
        (gx,) = paddle.grad(loss, [xt], create_graph=True)
        grads = paddle.grad((gx * gx).sum(), [xt, wt])
    return y, [g.numpy() for g in grads]


@pytest.mark.parametrize("shape", [(4, 32), (2, 3, 64), (48,)],
                         ids=lambda s: "x".join(map(str, s)))
def test_rms_norm_on_tensors_matches_jax(shape, jax_mode):
    rng = np.random.default_rng(1)
    x = rng.standard_normal(shape).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(shape[-1])).astype(np.float32)
    jy, jg = _rms_run("jax", x, w)
    ty, tg = _rms_run("torch", x, w)
    assert isinstance(ty, tpaddle.Tensor) and not ty.stop_gradient
    np.testing.assert_allclose(ty.numpy(), jy.numpy(), **TOL)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL)


def test_rms_norm_second_derivative_matches_jax_composite():
    rng = np.random.default_rng(4)
    x = rng.standard_normal((4, 32)).astype(np.float32)
    w = (1 + 0.1 * rng.standard_normal(32)).astype(np.float32)
    _, jg = _rms_run("jax", x, w, order=2)
    _, tg = _rms_run("torch", x, w, order=2)
    for a, b in zip(tg, jg):
        np.testing.assert_allclose(a, b, **TOL2)


def test_plain_tensors_stay_plain_and_cpu_launches_nothing():
    _support.reset_launch_counts()
    q = torch.randn(1, 16, 2, 16)
    out = TF.scaled_dot_product_attention(q, q, q, is_causal=True)
    y = TF.rms_norm(torch.randn(4, 32), torch.ones(32))
    assert type(out) is torch.Tensor and type(y) is torch.Tensor
    assert tflash.LAUNCHES_FWD.count == 0
    # a masked attention is the plain composite on a Tensor too
    masked = TF.scaled_dot_product_attention(
        tpaddle.to_tensor(q.numpy()), q, q, attn_mask=torch.ones(
            (16, 16), dtype=torch.bool).tril())
    np.testing.assert_allclose(masked.numpy(), out.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert tflash.LAUNCHES_FWD.count == 0


def test_second_derivative_through_the_flash_kernels_raises_typed():
    """The rule `_FlashAttention.backward` applies under `create_graph`:
    any device but the CPU raises, naming the kernels (meta tensors stand
    in for the card's here; the card test runs it for real)."""
    q = torch.empty((1, 16, 2, 16), device="meta")
    ctx = SimpleNamespace(needs_input_grad=(True, True, True), causal=True,
                          sm_scale=0.25)
    with pytest.raises(_support.KernelNotDifferentiableError,
                       match="flash_attention_dq"):
        tflash._differentiable_bwd(ctx, q, q, q, None, q)


# ---------------------------------------------------------------------------
# the smoke run's eager phases, rehearsed on the CPU at a tiny width
# ---------------------------------------------------------------------------

def test_smoke_eager_program_matches_jax():
    """`eager_program` (the `eager_reference` phase's program, which the
    card holds to its own CPU run) on both packages: the same results,
    the seeded draws' bits included."""
    from paddle_tpu_torch.tools.eager_workload import eager_program

    from torch_eager_common import assert_same

    want, got = eager_program(jpaddle), eager_program(tpaddle)
    assert str(got.pop("place")) == "Place(cpu:0)"
    want.pop("place")
    np.testing.assert_allclose(got.pop("randn"), want.pop("randn"),
                               rtol=0, atol=1e-5)
    assert_same(want, got)


def test_smoke_attention_block_is_bit_equal_to_torch_direct():
    """`eager_block` (the `eager_attention` phase's block) against
    `torch_block` on the same inputs, every gradient and `paddle.grad` of
    x bit-equal, and both within 1e-5 of `plain_block`."""
    from paddle_tpu_torch.tools import eager_workload as ew

    x, w = ew.block_inputs(1, 32, 64, 4, "cpu", torch.float32, seed=1)
    X = tpaddle.Tensor(x, stop_gradient=False)
    W = {n: tpaddle.Tensor(t, stop_gradient=False) for n, t in w.items()}
    xt = x.clone().requires_grad_()
    wt = {n: t.clone().requires_grad_() for n, t in w.items()}
    (gx,) = tpaddle.grad(ew.eager_block(tpaddle, X, W, 4), [X])
    (gxt,) = torch.autograd.grad(ew.torch_block(xt, wt, 4), [xt])
    assert torch.equal(gx._data, gxt)
    le = ew.eager_block(tpaddle, X, W, 4)
    le.backward()
    lt = ew.torch_block(xt, wt, 4)
    lt.backward()
    assert torch.equal(le._data, lt.detach())
    for n in w:
        assert torch.equal(W[n].grad._data, wt[n].grad), n
    xp = x.clone().requires_grad_()
    wp = {n: t.clone().requires_grad_() for n, t in w.items()}
    ew.plain_block(xp, wp, 4).backward()
    for n in w:
        torch.testing.assert_close(W[n].grad._data, wp[n].grad, rtol=1e-5,
                                   atol=1e-5)
