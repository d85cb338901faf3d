"""The port's ragged paged attention module against the JAX package's:
packing metadata and the ragged KV scatter exactly, and the attention's
plain PyTorch version against the Pallas kernel (interpreter mode) and
the JAX reference in f32. The same numpy inputs go to both packages."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from torch_threads import one_thread  # noqa: F401

ATOL = RTOL = 1e-5   # f32: the two differ only in summation order


@pytest.fixture
def interpret():
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": False})


def _meta_both(q_lens, kv_lens, t):
    jl, jp = jpa.ragged_metadata(jnp.asarray(q_lens, jnp.int32),
                                 jnp.asarray(kv_lens, jnp.int32), t)
    tl, tp = tpa.ragged_metadata(torch.tensor(q_lens, dtype=torch.int32),
                                 torch.tensor(kv_lens, dtype=torch.int32), t)
    return (np.asarray(jl), np.asarray(jp)), (tl.numpy(), tp.numpy())


@pytest.mark.parametrize("q_lens,kv_lens,t", [
    ([1, 5, 0], [9, 7, 0], 8),          # decode + chunk + guard slots
    ([2, 0, 3], [4, 0, 3], 6),          # empty lane in the middle
    ([0, 0], [0, 0], 4),                # all empty
    ([1, 1, 1, 1], [3, 17, 1, 64], 4),  # pure decode, no guards
    ([32, 1, 0, 1], [40, 512, 0, 9], 40),
])
def test_ragged_metadata_matches_jax(q_lens, kv_lens, t):
    (jl, jp), (tl, tp) = _meta_both(q_lens, kv_lens, t)
    assert tl.dtype == np.int32 and tp.dtype == np.int32
    np.testing.assert_array_equal(tl, jl)
    np.testing.assert_array_equal(tp, jp)


@pytest.mark.parametrize("q_lens,kv_lens", [
    ([2, 0, 3], [7, 0, 3]),             # guards at the end, empty lane
    ([1, 4, 1], [5, 8, 1]),
    ([0, 0, 0], [0, 0, 0]),             # every slot a guard
])
def test_write_kv_ragged_matches_jax_and_drops_guards(q_lens, kv_lens):
    rng = np.random.default_rng(7)
    nb, kvh, bs, d, t = 12, 2, 4, 16, 8
    kc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    tables = np.asarray([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    k = rng.normal(size=(t, kvh, d)).astype(np.float32)
    v = rng.normal(size=(t, kvh, d)).astype(np.float32)
    (jl, jp), (tl, tp) = _meta_both(q_lens, kv_lens, t)
    jk, jv = jpa.write_kv_to_cache_ragged(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(jl), jnp.asarray(jp))
    tkc, tvc = torch.from_numpy(kc.copy()), torch.from_numpy(vc.copy())
    out_k, out_v = tpa.write_kv_to_cache_ragged(
        torch.from_numpy(k), torch.from_numpy(v), tkc, tvc,
        torch.from_numpy(tables), torch.from_numpy(tl), torch.from_numpy(tp))
    assert out_k is tkc and out_v is tvc          # written in place
    np.testing.assert_array_equal(tkc.numpy(), np.asarray(jk))
    np.testing.assert_array_equal(tvc.numpy(), np.asarray(jv))
    # exactly the real tokens' (block, slot) rows changed
    changed = (tkc.numpy() != kc).any(axis=(1, 3)).sum()
    assert changed == sum(q_lens)


def _case(name, rng):
    """(q_lens, kv_lens, tables, h, kvh, d, bs, t) compositions."""
    tables = [[1, 2, 3, 4], [5, 6, 7, 8], [9, 10, 11, 12], [13, 14, 15, 16]]
    if name == "mha":
        return [1, 6, 3, 0], [11, 9, 13, 0], tables, 4, 4, 32, 4, 16
    if name == "gqa":
        return [1, 6, 3, 0], [11, 9, 13, 0], tables, 4, 2, 32, 4, 16
    if name == "gqa_one_kv_head":
        return [1, 6, 3, 0], [11, 9, 13, 0], tables, 4, 1, 32, 4, 16
    if name == "empty_middle_lane":
        return [2, 0, 3, 1], [4, 0, 3, 16], tables, 4, 2, 16, 4, 8
    raise KeyError(name)


# the Pallas kernel (interpret mode) and its reference under one
# `jax.jit` a call: the interpreter's grid loop compiles once instead of
# running op by op
_ragged = jax.jit(jpa.paged_attention_ragged)
_ragged_ref = jax.jit(jpa.paged_attention_ragged_ref)


def _pool(rng, nb, kvh, bs, d):
    return (rng.normal(size=(nb, kvh, bs, d)).astype(np.float32),
            rng.normal(size=(nb, kvh, bs, d)).astype(np.float32))


def _run_all(q, kc, vc, tables, kv_lens, q_lens):
    t = q.shape[0]
    (jl, jp), (tl, tp) = _meta_both(q_lens, kv_lens, t)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(tables, jnp.int32), jnp.asarray(kv_lens, jnp.int32),
             jnp.asarray(jl), jnp.asarray(jp))
    kern = np.asarray(_ragged(*jargs))
    ref = np.asarray(_ragged_ref(*jargs))
    port = tpa.paged_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.tensor(tables, dtype=torch.int32),
        torch.tensor(kv_lens, dtype=torch.int32), torch.from_numpy(tl),
        torch.from_numpy(tp)).numpy()
    return port, kern, ref, tp


@pytest.mark.parametrize("name", ["mha", "gqa", "gqa_one_kv_head",
                                  "empty_middle_lane"])
def test_attention_matches_pallas_kernel_and_ref(name, interpret):
    rng = np.random.default_rng(1)
    q_lens, kv_lens, tables, h, kvh, d, bs, t = _case(name, rng)
    kc, vc = _pool(rng, 20, kvh, bs, d)
    q = rng.normal(size=(t, h, d)).astype(np.float32)
    port, kern, ref, pos = _run_all(q, kc, vc, tables, kv_lens, q_lens)
    np.testing.assert_allclose(port, kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL)
    guard = pos < 0
    assert guard.sum() == t - sum(q_lens)
    assert np.all(port[guard] == 0.0)


@pytest.mark.parametrize("q_len,kv_len", [(4, 4), (4, 8), (5, 8), (3, 11),
                                          (1, 12), (8, 16), (7, 15)])
def test_attention_chunks_at_block_boundaries(q_len, kv_len, interpret):
    rng = np.random.default_rng(6)
    kc, vc = _pool(rng, 16, 2, 4, 32)
    q = rng.normal(size=(q_len + 2, 4, 32)).astype(np.float32)
    port, kern, ref, pos = _run_all(q, kc, vc, [[1, 2, 3, 4]], [kv_len],
                                    [q_len])
    np.testing.assert_allclose(port, kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL)
    assert np.all(port[pos < 0] == 0.0)


def test_ref_tiles_long_packed_buffers():
    """More packed tokens than the ref's 128-token tile: the tiled plain
    version still matches the (tiled) JAX reference row for row."""
    rng = np.random.default_rng(3)
    kc, vc = _pool(rng, 48, 2, 4, 16)
    tables = [list(range(1, 41)), list(range(41, 45)) + [0] * 36]
    q = rng.normal(size=(150, 4, 16)).astype(np.float32)
    port, _kern, ref, pos = _run_all(q, kc, vc, tables, [140, 6], [140, 6])
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL)
    assert np.all(port[pos < 0] == 0.0)


def test_cuda_tensors_never_take_the_plain_path():
    """The wrapper picks the plain version only for CPU tensors: any
    other device is refused, never silently computed on the CPU."""
    q = torch.zeros((2, 4, 16), device="meta")
    with pytest.raises(ValueError):
        tpa.paged_attention_ragged(q, q, q, q, q, q, q)


# ---- int8 pools with per-slot f32 scale planes (kv_bits=8) ----

def _q_pool(rng, nb, kvh, bs, d):
    """int8 K/V pools and their scale planes, quantized from random
    float pages with `quantize_kv` (the writer's formula)."""
    from paddle_tpu_torch.inference import kv_quant

    out = []
    for _ in range(2):
        x = torch.from_numpy(rng.normal(size=(nb, kvh, bs, d))
                             .astype(np.float32))
        out += [t.numpy() for t in kv_quant.quantize_kv(x)]
    kq, ks, vq, vs = out
    return kq, vq, ks, vs


@pytest.mark.parametrize("q_lens,kv_lens", [
    ([2, 0, 3], [7, 0, 3]),             # guards at the end, empty lane
    ([1, 4, 1], [5, 8, 1]),
    ([0, 0, 0], [0, 0, 0]),             # every slot a guard
])
def test_write_kv_ragged_int8_matches_jax(q_lens, kv_lens):
    """Quantize-on-write: the int8 values and their scales land at the
    same (block, slot) as the JAX writer puts them; guard slots write
    nothing, an all-guard step rewrites what is there."""
    rng = np.random.default_rng(8)
    nb, kvh, bs, d, t = 12, 2, 4, 16, 8
    kc, vc, ks, vs = _q_pool(rng, nb, kvh, bs, d)
    tables = np.asarray([[1, 2, 3], [4, 5, 6], [7, 8, 9]], np.int32)
    k = rng.normal(size=(t, kvh, d)).astype(np.float32)
    v = rng.normal(size=(t, kvh, d)).astype(np.float32)
    k[0, 1] = 0.0                                   # a zero head vector
    (jl, jp), (tl, tp) = _meta_both(q_lens, kv_lens, t)
    want = jpa.write_kv_to_cache_ragged(
        jnp.asarray(k), jnp.asarray(v), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(jl), jnp.asarray(jp),
        k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    pools = [torch.from_numpy(a.copy()) for a in (kc, vc, ks, vs)]
    got = tpa.write_kv_to_cache_ragged(
        torch.from_numpy(k), torch.from_numpy(v), pools[0], pools[1],
        torch.from_numpy(tables), torch.from_numpy(tl), torch.from_numpy(tp),
        k_scale=pools[2], v_scale=pools[3])
    assert all(g is p for g, p in zip(got, pools))  # written in place
    assert pools[0].dtype == torch.int8 and pools[2].dtype == torch.float32
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    changed = (pools[2].numpy() != ks).any(axis=1).sum()
    assert changed == sum(q_lens)


def _run_all_q(q, kc, vc, ks, vs, tables, kv_lens, q_lens):
    t = q.shape[0]
    (jl, jp), (tl, tp) = _meta_both(q_lens, kv_lens, t)
    jargs = (jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
             jnp.asarray(tables, jnp.int32), jnp.asarray(kv_lens, jnp.int32),
             jnp.asarray(jl), jnp.asarray(jp))
    jscales = dict(k_scale=jnp.asarray(ks), v_scale=jnp.asarray(vs))
    kern = np.asarray(_ragged(*jargs, **jscales))
    ref = np.asarray(_ragged_ref(*jargs, **jscales))
    before = tpa.LAUNCHES_Q.count
    port = tpa.paged_attention_ragged(
        torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
        torch.tensor(tables, dtype=torch.int32),
        torch.tensor(kv_lens, dtype=torch.int32), torch.from_numpy(tl),
        torch.from_numpy(tp), k_scale=torch.from_numpy(ks),
        v_scale=torch.from_numpy(vs)).numpy()
    assert tpa.LAUNCHES_Q.count == before            # CPU: the plain version
    return port, kern, ref, tp


@pytest.mark.parametrize("name", ["mha", "gqa", "gqa_one_kv_head",
                                  "empty_middle_lane"])
def test_int8_attention_matches_pallas_kernel_and_ref(name, interpret):
    """The plain int8-pool attention against `_ragged_call_q` (Pallas,
    interpreter mode) and the JAX reference, in f32."""
    rng = np.random.default_rng(9)
    q_lens, kv_lens, tables, h, kvh, d, bs, t = _case(name, rng)
    kc, vc, ks, vs = _q_pool(rng, 20, kvh, bs, d)
    q = rng.normal(size=(t, h, d)).astype(np.float32)
    port, kern, ref, pos = _run_all_q(q, kc, vc, ks, vs, tables, kv_lens,
                                      q_lens)
    np.testing.assert_allclose(port, kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL)
    assert np.all(port[pos < 0] == 0.0)


@pytest.mark.parametrize("q_len,kv_len", [(4, 8), (3, 11), (1, 12)])
def test_int8_attention_chunks_at_block_boundaries(q_len, kv_len, interpret):
    rng = np.random.default_rng(10)
    kc, vc, ks, vs = _q_pool(rng, 16, 2, 4, 32)
    q = rng.normal(size=(q_len + 2, 4, 32)).astype(np.float32)
    port, kern, ref, pos = _run_all_q(q, kc, vc, ks, vs, [[1, 2, 3, 4]],
                                      [kv_len], [q_len])
    np.testing.assert_allclose(port, kern, atol=ATOL, rtol=RTOL)
    np.testing.assert_allclose(port, ref, atol=ATOL, rtol=RTOL)
    assert np.all(port[pos < 0] == 0.0)
