"""The port's flash attention (`paddle_tpu_torch.ops.kernels.flash_attention`)
against the JAX package's Pallas kernels, run in interpret mode on the CPU:
the same numpy inputs through the forward and backward rules of
`flash_attention_bhsd`'s custom VJP (JAX, `[B, H, S, D]`; the backward
at the cotangent is `jax.grad` of sum(out * ct), each kernel run once)
and through the port's plain
versions and autograd Function (`[B, S, H, D]`), in f32.

Tolerance 1e-5: both sides compute in f32 and differ only in summation
order (the JAX kernels sum blockwise with an online softmax, the plain
versions over whole rows).
"""
import itertools

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.nn.functional import attention as jax_attention
from paddle_tpu.ops.pallas import flash_attention as jfa
from paddle_tpu.core.tensor import Tensor
from paddle_tpu_torch.nn import functional as F
from paddle_tpu_torch.nn.functional import attention
from paddle_tpu_torch.ops.kernels import flash_attention as fa
from torch_threads import one_thread  # noqa: F401

TOL = 1e-5
B, H = 2, 4


def _configs():
    """Every pair of values of (kv heads, S, D, causal, kv_lens) appears:
    the half of the product with an even index sum."""
    axes = ([4, 2, 1], [64, 128], [16, 32], [False, True], [False, True])
    out = []
    for idx in itertools.product(*(range(len(a)) for a in axes)):
        if sum(idx) % 2 == 0:
            out.append(tuple(a[i] for a, i in zip(axes, idx)))
    return out


def _ids(c):
    kvh, s, d, causal, lens = c
    return f"kvh{kvh}-s{s}-d{d}-{'causal' if causal else 'full'}" \
        f"{'-lens' if lens else ''}"


CONFIGS = _configs()
# S = 192 and D = 96 with GQA: a length the card's 128-row tiles cut
# unevenly (the JAX blocks cut it into three of 64) and a head width the
# card pads to 128 columns, causal and not, with and without kv_lens
EDGE_CONFIGS = [(2, 192, 96, causal, lens) for causal in (False, True)
                for lens in (False, True)]


def _inputs(kvh, s, d, lens, seed=0):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=(B, s, H, d)).astype(np.float32)
    k = rng.normal(size=(B, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(B, s, kvh, d)).astype(np.float32)
    ct = rng.normal(size=(B, s, H, d)).astype(np.float32)
    # an empty sequence and one that ends inside a block
    kv_lens = np.array([s - 27, 0], np.int32) if lens else None
    return q, k, v, ct, kv_lens


def _bhsd(x):
    return jnp.asarray(np.swapaxes(x, 1, 2))


def _jax_reference(q, k, v, ct, kv_lens, causal):
    """(out, lse, dq, dk, dv) from the Pallas kernels, in [B, S, H, D]
    (lse [B, H, S])."""
    d = q.shape[-1]
    scale = 1.0 / float(np.sqrt(d))
    lens = None if kv_lens is None else jnp.asarray(kv_lens)
    qt, kt, vt, ctt = _bhsd(q), _bhsd(k), _bhsd(v), _bhsd(ct)
    # the custom VJP's own rules, each kernel run once: the gradient of
    # sum(out * ct) is the backward rule at the cotangent ct
    out, res = jfa._flash_fwd_rule(qt, kt, vt, lens, causal, scale)
    lse = res[-1]
    grads = jfa._flash_bwd_rule(causal, scale, res, ctt)[:3]
    sw = [np.swapaxes(np.asarray(x), 1, 2) for x in (out,) + tuple(grads)]
    return sw[0], np.asarray(lse)[..., 0], sw[1], sw[2], sw[3]


def _port(q, k, v, ct, kv_lens, causal):
    qt, kt, vt = (torch.from_numpy(x).requires_grad_() for x in (q, k, v))
    lens = None if kv_lens is None else torch.from_numpy(kv_lens)
    _out, lse = fa.flash_attention_fwd(qt.detach(), kt.detach(), vt.detach(),
                                       causal, kv_lens=lens)
    out = fa.flash_attention_bshd(qt, kt, vt, causal=causal, kv_lens=lens)
    (out * torch.from_numpy(ct)).sum().backward()
    return (out.detach().numpy(), lse.numpy(), qt.grad.numpy(),
            kt.grad.numpy(), vt.grad.numpy())


def _compare(cfg):
    kvh, s, d, causal, lens = cfg
    q, k, v, ct, kv_lens = _inputs(kvh, s, d, lens)
    ref = _jax_reference(q, k, v, ct, kv_lens, causal)
    got = _port(q, k, v, ct, kv_lens, causal)
    for name, a, b in zip(("out", "lse", "dq", "dk", "dv"), got, ref):
        np.testing.assert_allclose(a, b, atol=TOL, rtol=TOL, err_msg=name)
    if lens:
        # the empty sequence: out 0, lse -1e30, no gradient
        assert (got[0][1] == 0).all() and (got[1][1] == -1e30).all()
        assert (got[2][1] == 0).all() and (got[3][1] == 0).all()


@pytest.mark.parametrize("cfg", CONFIGS + EDGE_CONFIGS, ids=_ids)
def test_matches_pallas_resident(cfg):
    """Rows 5-7: `_fwd_kernel`, `_dq_kernel`, `_dkv_kernel`."""
    _compare(cfg)


@pytest.mark.parametrize("cfg", CONFIGS[::3], ids=_ids)
def test_matches_pallas_streamed(cfg, monkeypatch):
    """Rows 8-10: the K/V-streamed kernels, forced by a 1 KiB resident
    budget (as tests/test_pallas_kernels.py forces them); the port's one
    set of kernels covers both."""
    monkeypatch.setattr(jfa, "_RESIDENT_KV_BYTES", 1 << 10)
    assert jfa._needs_stream(64, 16, 4)
    _compare(cfg)


def test_backward_plain_version_on_the_same_lse_and_delta():
    """`flash_attention_bwd_ref` fed JAX's own lse and delta (as the card
    check feeds each backward kernel) gives JAX's gradients."""
    q, k, v, ct, kv_lens = _inputs(2, 64, 32, True, seed=1)
    ref = _jax_reference(q, k, v, ct, kv_lens, True)
    delta = (ct * ref[0]).sum(-1).transpose(0, 2, 1)        # [B, H, S]
    t = torch.from_numpy
    dq, dk, dv = fa.flash_attention_bwd_ref(
        t(q), t(k), t(v), t(ct), t(np.array(ref[1])),
        t(np.ascontiguousarray(delta)), True, kv_lens=t(kv_lens))
    for a, b in zip((dq, dk, dv), ref[2:]):
        np.testing.assert_allclose(a.numpy(), b, atol=TOL, rtol=TOL)


SUPPORTED_TABLE = [
    ((2, 64, 4, 128), (2, 64, 4, 128), torch.bfloat16, True),
    ((2, 64, 4, 16), (2, 64, 1, 16), torch.float32, True),
    ((2, 64, 4, 64), (2, 32, 2, 64), torch.float16, True),
    ((2, 64, 4, 24), (2, 64, 4, 24), torch.float32, False),   # D % 16
    ((2, 64, 4, 256), (2, 64, 4, 256), torch.float32, False),  # D > 128
    ((2, 60, 4, 32), (2, 60, 4, 32), torch.float32, False),   # no block
    ((2, 64, 4, 32), (2, 64, 3, 32), torch.float32, False),   # H % KVH
    ((2, 64, 4, 32), (2, 64, 4, 32), torch.float64, False),
]


@pytest.mark.parametrize("q_shape,k_shape,dtype,want", SUPPORTED_TABLE)
def test_supported_narrows_the_jax_rule(q_shape, k_shape, dtype, want):
    """The port admits what the JAX rule admits, narrowed to D a multiple
    of 16 up to 128 (the JAX rule takes D <= 256)."""
    assert fa.supported(q_shape, k_shape, dtype) is want
    np_dtype = {torch.bfloat16: jnp.bfloat16, torch.float32: np.float32,
                torch.float16: np.float16, torch.float64: np.float64}[dtype]
    jax_says = jfa.supported(q_shape, k_shape, np_dtype)
    narrowed = q_shape[-1] % 16 != 0 or q_shape[-1] > 128
    assert want == (jax_says and not narrowed)


@pytest.mark.parametrize("causal", [False, True])
@pytest.mark.parametrize("q_shape,k_shape,dtype,want", SUPPORTED_TABLE)
def test_routing_on_each_device(q_shape, k_shape, dtype, want, causal):
    """Where each shape of the table lands. CPU tensors, as before: the
    flash route (its plain versions) where `supported()` holds, the plain
    `_sdpa_fn` elsewhere. CUDA tensors: the kernels where `supported()`
    holds, a raise where only the JAX rule (`jax_supported`, the copy of
    `flash_attention.py:378-391`) admits the shape, `_sdpa_fn` where the
    JAX rule refuses it too; causal with Sq != Sk is `_sdpa_fn` on both,
    as in JAX."""
    np_dtype = {torch.bfloat16: jnp.bfloat16, torch.float32: np.float32,
                torch.float16: np.float16, torch.float64: np.float64}[dtype]
    jax_says = fa.jax_supported(q_shape, k_shape, dtype)
    assert jax_says == jfa.supported(q_shape, k_shape, np_dtype)
    cpu, cuda = (attention._route(q_shape, k_shape, dtype, causal, dev)
                 for dev in ("cpu", "cuda"))
    if causal and q_shape[1] != k_shape[1]:
        assert cpu == cuda == "plain"
    elif want:
        assert cpu == cuda == "flash"
    else:
        assert cpu == "plain"
        assert cuda == ("raise" if jax_says else "plain")


def test_head_dim_256_on_the_cpu_runs_plain():
    """D = 256 (admitted by the JAX rule, not by the kernels) on CPU tensors
    takes the plain `_sdpa_fn`, launching nothing; the card raises there
    (`tests/test_torch_kernels_gpu.py`)."""
    rng = np.random.default_rng(3)
    q, k, v = (torch.from_numpy(rng.normal(size=(1, 16, 2, 256))
                                .astype(np.float32)) for _ in range(3))
    assert attention._route(tuple(q.shape), tuple(k.shape), q.dtype, True,
                            "cuda") == "raise"
    before = fa.LAUNCHES_FWD.count
    out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    assert fa.LAUNCHES_FWD.count == before
    torch.testing.assert_close(out, attention._sdpa_fn(q, k, v, True),
                               atol=0, rtol=0)


@pytest.fixture
def _interpret():
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": False})


@pytest.mark.parametrize("shape,kvh,causal,sk", [
    ((2, 64, 4, 32), 2, True, 64),     # the flash path
    ((2, 64, 4, 32), 4, False, 32),    # flash, Sq != Sk, not causal
    ((2, 32, 4, 32), 4, True, 64),     # causal Sq != Sk: the composite
    ((2, 16, 4, 24), 2, True, 16),     # D = 24: the composite
])
def test_sdpa_routes_as_the_jax_package(shape, kvh, causal, sk, _interpret):
    """`nn.functional.scaled_dot_product_attention` against the JAX
    package's, kernels on (interpret): the same path is taken on both
    sides (flash, or the plain `_sdpa_fn` composite with its bottom-right
    causal mask) and the outputs agree."""
    b, sq, h, d = shape
    rng = np.random.default_rng(2)
    q = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, sk, kvh, d)).astype(np.float32)
    want = jax_attention.scaled_dot_product_attention(
        Tensor(jnp.asarray(q)), Tensor(jnp.asarray(k)),
        Tensor(jnp.asarray(v)), is_causal=causal).numpy()
    before = fa.LAUNCHES_FWD.count
    got = F.scaled_dot_product_attention(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        is_causal=causal)
    assert fa.LAUNCHES_FWD.count == before        # CPU: no kernel launch
    np.testing.assert_allclose(got.numpy(), want, atol=TOL, rtol=TOL)
