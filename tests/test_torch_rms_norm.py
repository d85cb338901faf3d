"""The port's RMSNorm (`paddle_tpu_torch.ops.kernels.rms_norm` and the
routing of `nn.functional.rms_norm`) against the JAX package's: the plain
forward against the Pallas `_rms_fwd_kernel` in interpret mode, the
backward against `jax.grad` of `rms_norm`, and the composite against
`_rms_norm_fn`.

Tolerances: f32 within 1e-6 relative (rsqrt and the mean's summation
order); bf16 within one bf16 ulp of the output (both sides round the same
f32 value once or twice; a last-bit difference of the f32 value can flip a
rounding).
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.nn.functional import norm as jax_norm
from paddle_tpu.ops.pallas import rms_norm as jrms
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.ops.kernels import rms_norm as rn

EPS = 1e-6


def _ulp_bf16(x):
    """One bf16 ulp at each value's magnitude (2^-7 of its binade)."""
    a = np.maximum(np.abs(x), 2.0 ** -126)
    return 2.0 ** (np.floor(np.log2(a)) - 7)


def _to_torch(a, dtype):
    return torch.from_numpy(np.asarray(a, np.float32)).to(dtype)


def _inputs(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3).astype(np.float32)
    w = (1 + 0.2 * rng.normal(size=shape[-1:])).astype(np.float32)
    return x, w


@pytest.mark.parametrize("shape", [(16, 64), (3, 5, 48), (2, 7, 256)])
def test_forward_f32_matches_pallas(shape):
    x, w = _inputs(shape, 0)
    want = np.asarray(jrms._pallas_fwd(jnp.asarray(x.reshape(-1, shape[-1])),
                                       jnp.asarray(w), EPS)).reshape(shape)
    got = rn.rms_norm(torch.from_numpy(x), torch.from_numpy(w), EPS)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6, atol=1e-6)


@pytest.mark.parametrize("shape", [(16, 64), (4, 3, 128)])
def test_forward_bf16_within_one_ulp(shape):
    x, w = _inputs(shape, 1)
    xb = jnp.asarray(x).astype(jnp.bfloat16)
    wb = jnp.asarray(w).astype(jnp.bfloat16)
    want = np.asarray(jrms._pallas_fwd(xb.reshape(-1, shape[-1]), wb, EPS)
                      .astype(jnp.float32)).reshape(shape)
    got = rn.rms_norm(_to_torch(x, torch.bfloat16),
                      _to_torch(w, torch.bfloat16), EPS)
    assert got.dtype == torch.bfloat16
    err = np.abs(got.float().numpy() - want)
    assert (err <= _ulp_bf16(want)).all(), float(err.max())


def test_forward_rounds_before_the_multiply_by_w():
    """The kernel's rounding: x * rsqrt(...) goes to bf16 first, then the
    product with w rounds again (the engine's `_rms` rounds once)."""
    x, w = _inputs((8, 64), 2)
    xt, wt = _to_torch(x, torch.bfloat16), _to_torch(w, torch.bfloat16)
    got = rn.rms_norm_ref(xt, wt, EPS)
    xf = xt.float()
    n = (xf * torch.rsqrt(xf.pow(2).mean(-1, keepdim=True) + EPS))
    assert torch.equal(got, (n.to(torch.bfloat16).float() * wt.float())
                       .to(torch.bfloat16))


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_backward_matches_jax_grad(dtype):
    x, w = _inputs((2, 6, 64), 3)
    g = np.random.default_rng(4).normal(size=x.shape).astype(np.float32)
    jdt = getattr(jnp, dtype)
    tdt = getattr(torch, dtype)

    def loss(x_, w_):
        y = jrms.rms_norm(x_, w_, EPS)
        return (y.astype(jnp.float32) * jnp.asarray(g)).sum()

    jdx, jdw = jax.grad(loss, argnums=(0, 1))(
        jnp.asarray(x).astype(jdt), jnp.asarray(w).astype(jdt))
    xt = _to_torch(x, tdt).requires_grad_()
    wt = _to_torch(w, tdt).requires_grad_()
    (rn.rms_norm(xt, wt, EPS).float() * torch.from_numpy(g)).sum().backward()
    assert xt.grad.dtype == tdt and wt.grad.dtype == tdt
    for got, want in ((xt.grad, jdx), (wt.grad, jdw)):
        want = np.asarray(want.astype(jnp.float32))
        got = got.float().numpy()
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-5)
        else:
            assert (np.abs(got - want) <= _ulp_bf16(want)).all()


@pytest.fixture
def _interpret():
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": False})


@pytest.mark.parametrize("shape,dtype", [((4, 32), "float32"),
                                         ((32,), "float32"),
                                         ((32,), "bfloat16")])
def test_functional_routes_as_the_jax_package(shape, dtype, _interpret):
    """`nn.functional.rms_norm`: rank >= 2 takes the kernel's path, rank 1
    the `/ sqrt` composite, on both sides; the outputs agree (bf16: the
    composite's one f32 rounding is the same on both)."""
    x, w = _inputs(shape, 5)
    jdt, tdt = getattr(jnp, dtype), getattr(torch, dtype)
    want = jax_norm.rms_norm(Tensor(jnp.asarray(x).astype(jdt)),
                             Tensor(jnp.asarray(w).astype(jdt)), EPS)
    want = np.asarray(want._data.astype(jnp.float32))
    before = rn.LAUNCHES.count
    got = F.rms_norm(_to_torch(x, tdt), _to_torch(w, tdt), EPS)
    assert rn.LAUNCHES.count == before
    assert rn.supported(shape, tdt) == (len(shape) >= 2)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=1e-6,
                               atol=1e-6)


# every row width the kernel's wrapper can be given, in each dtype and
# alignment: 1 .. 20,000 and the Llama widths past it
PLAN_WIDTHS = list(range(1, 20001)) + [28672, 32768, 65536]


@pytest.mark.parametrize("aligned", [True, False], ids=["aligned", "offset"])
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
def test_plan_maps_every_row_to_an_instance_that_takes_it(dtype, aligned):
    """`rms_plan` (the host rule that picks the kernel's instance) gives
    every (H, dtype, alignment) an instance of `csrc/rms_norm.cu`: a
    register instance only for aligned rows of whole 16-byte vectors that
    fill more than half its vectors (257 to 2048 a row, the instances
    covering that span without a gap); the general instance for every
    other row, reading 16-byte vectors only where the row takes them."""
    item = torch.empty((), dtype=dtype).element_size()
    per = 16 // item
    spans = sorted((t * v // 2, t * v) for t, v in rn.REGISTER_INSTANCES)
    assert spans[0][0] == 256 and spans[-1][1] == 2048
    assert all(a[1] == b[0] for a, b in zip(spans, spans[1:]))
    for h in PLAN_WIDTHS:
        p = rn.rms_plan(h, item, aligned)
        whole = aligned and h % per == 0
        if p.tpr:
            nv = h // per
            assert whole and (p.tpr, p.vpt) in rn.REGISTER_INSTANCES
            # the threads cover the row, and with half the vectors a
            # thread they would not (the fewest vectors that cover it)
            assert p.tpr * p.vpt >= nv > p.tpr * p.vpt // 2
            assert p.vec == 1
        else:
            assert (p.tpr, p.vpt) == (0, 0)
            assert not whole or not 256 < h // per <= 2048
            assert p.vec == int(whole)


def test_register_instances_are_the_sources():
    """The host's `REGISTER_INSTANCES` are exactly the instances the C
    entry point dispatches to (`RMS_CASE` in `csrc/rms_norm.cu`), so a
    plan never names one the library lacks."""
    import pathlib
    import re

    src = (pathlib.Path(rn.__file__).resolve().parents[2] / "csrc"
           / "rms_norm.cu").read_text()
    cases = re.findall(r"^\s*RMS_CASE\((\d+), (\d+)\)\s*$", src, re.M)
    assert sorted((int(t), int(v)) for t, v in cases) == \
        sorted(rn.REGISTER_INSTANCES)


@pytest.mark.parametrize("h,dtype,plan", [
    (4096, torch.bfloat16, (128, 4, 1)), (8192, torch.bfloat16, (256, 4, 1)),
    (5120, torch.bfloat16, (256, 4, 1)), (16384, torch.bfloat16, (256, 8, 1)),
    (4096, torch.float32, (256, 4, 1)), (8192, torch.float32, (256, 8, 1)),
    (16384, torch.float32, (0, 0, 1)), (4100, torch.bfloat16, (0, 0, 0)),
    (256, torch.float16, (0, 0, 1)), (2048, torch.bfloat16, (0, 0, 1))])
def test_plan_at_the_model_widths(h, dtype, plan):
    """Llama-2-7B to 70B widths take the register instance in 16-bit
    types up to H 16384 and in f32 up to H 8192; narrower rows take the
    general instance."""
    item = torch.empty((), dtype=dtype).element_size()
    assert tuple(rn.rms_plan(h, item, True)) == plan
