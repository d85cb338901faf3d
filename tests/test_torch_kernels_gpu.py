"""The port's CUDA kernels against their plain PyTorch versions on the
card, at small widths. Every test here is marked `gpu` and skips without
a CUDA card (decided inside the test, so every worker collects the same
tests). This file imports no JAX, so it runs where only PyTorch is
installed:

    python -m pytest --noconftest -m gpu tests/test_torch_kernels_gpu.py
"""
import numpy as np
import pytest
import torch

from paddle_tpu_torch.inference import kv_quant
from paddle_tpu_torch.nn import quant as nq
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.ops.kernels import quant_matmul as qm

pytestmark = pytest.mark.gpu

# bf16 inputs, f32 softmax in both: the kernel and the plain version
# differ in summation order and in where the output rounds
TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _case(dev, dtype, h, kvh, d, bs, q_lens, kv_lens, t, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    nb = 64
    b = len(q_lens)
    w = max(-(-n // bs) for n in kv_lens) + 2
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((b, w), np.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        k = -(-n // bs)
        tables[i, :k] = perm[used:used + k]
        used += k
    q = torch.randn((t, h, d), generator=g, device=dev).to(dtype)
    kc = torch.randn((nb, kvh, bs, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((nb, kvh, bs, d), generator=g, device=dev).to(dtype)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    lane, pos = pa.ragged_metadata(ql, kl, t)
    return (q, kc, vc, torch.from_numpy(tables).to(dev), kl, lane, pos)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_kernel_matches_plain_version(dtype, d, h, kvh):
    dev = _card()
    args = _case(dev, dtype, h, kvh, d, 16, q_lens=[1, 7, 0, 1, 3],
                 kv_lens=[40, 23, 0, 1, 16], t=16)
    before = pa.LAUNCHES.count
    out = pa.paged_attention_ragged(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES.count == before + 1
    ref = pa.paged_attention_ragged_ref(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    guard = args[-1] < 0
    assert int(guard.sum()) == 4
    assert bool((out[guard] == 0).all())


@pytest.mark.parametrize("bs,h", [(4, 4), (6, 6), (8, 4), (16, 6)])
def test_block_sizes_and_layer_slices(bs, h):
    """A pool slice of a [L, NB, KVH, BS, D] stack (as the engine passes
    it), chunks crossing block boundaries, and (query head, slot) counts
    that leave the last score round partial."""
    dev = _card()
    q, kc, vc, tables, kl, lane, pos = _case(
        dev, torch.float32, h, 2, 32, bs, q_lens=[9, 1], kv_lens=[21, 33],
        t=12)
    stack_k = torch.stack([torch.zeros_like(kc), kc])
    stack_v = torch.stack([torch.zeros_like(vc), vc])
    out = pa.paged_attention_ragged(q, stack_k[1], stack_v[1], tables, kl,
                                    lane, pos)
    ref = pa.paged_attention_ragged_ref(q, kc, vc, tables, kl, lane, pos)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    args = list(_case(dev, torch.float32, 4, 2, 32, 4, q_lens=[2],
                      kv_lens=[5], t=4))
    bad = list(args)
    bad[3] = args[3].long()                        # int64 tables
    with pytest.raises(ValueError):
        pa.paged_attention_ragged(*bad)
    bad = list(args)
    bad[1] = args[1].to(torch.bfloat16)            # mixed dtypes
    with pytest.raises(ValueError):
        pa.paged_attention_ragged(*bad)
    bad = list(args)
    bad[0] = args[0][:, :, :12].contiguous()       # D % 8 != 0
    with pytest.raises(ValueError):
        pa.paged_attention_ragged(*bad)


def test_write_kv_on_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(2)
    k = torch.from_numpy(rng.normal(size=(6, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(6, 2, 16)).astype(np.float32))
    kc = torch.zeros((8, 2, 4, 16))
    vc = torch.zeros((8, 2, 4, 16))
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lane, pos = pa.ragged_metadata(torch.tensor([3, 1], dtype=torch.int32),
                                   torch.tensor([5, 1], dtype=torch.int32),
                                   6)
    want = pa.write_kv_to_cache_ragged(k, v, kc.clone(), vc.clone(), tables,
                                       lane, pos)
    got = pa.write_kv_to_cache_ragged(
        k.to(dev), v.to(dev), kc.to(dev), vc.to(dev), tables.to(dev),
        lane.to(dev), pos.to(dev))
    for w, g in zip(want, got):
        torch.testing.assert_close(g.cpu(), w, atol=0, rtol=0)


def test_engine_step_on_card_matches_cpu():
    dev = _card()
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny

    model = llama_tiny(vocab=128, layers=2, hidden=64, heads=4, seq=64,
                       num_key_value_heads=2, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    geo = dict(max_batch_size=2, num_blocks=16, block_size=4,
               max_blocks_per_seq=16)
    cpu = LlamaInferenceEngine(model, device="cpu", **geo)
    gpu = LlamaInferenceEngine(model, device=dev, **geo)
    tables = np.asarray([[1, 2, 3] + [0] * 13, [4, 5] + [0] * 14], np.int32)
    for q_lens, kv_lens in (([6, 5], [6, 5]), ([1, 1], [7, 6])):
        tokens = np.arange(1, 13, dtype=np.int32)
        a = cpu.ragged_step(tokens, q_lens, kv_lens, tables)
        b = gpu.ragged_step(tokens, q_lens, kv_lens, tables)
        assert b.device.type == "cuda"
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)


# ---- the int8-pool attention kernel ----

def _q_case(dev, dtype, h, kvh, d, bs, q_lens, kv_lens, t, seed=0):
    """`_case` with the pools quantized by `quantize_kv`."""
    q, kc, vc, tables, kl, lane, pos = _case(dev, torch.float32, h, kvh, d,
                                             bs, q_lens, kv_lens, t, seed)
    kq, ks = kv_quant.quantize_kv(kc)
    vq, vs = kv_quant.quantize_kv(vc)
    return (q.to(dtype), kq, vq, tables, kl, lane, pos), \
        dict(k_scale=ks, v_scale=vs)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 64, 128])
@pytest.mark.parametrize("h,kvh", [(4, 4), (8, 2)], ids=["mha", "gqa"])
def test_int8_kernel_matches_plain_version(dtype, d, h, kvh):
    dev = _card()
    args, scales = _q_case(dev, dtype, h, kvh, d, 16,
                           q_lens=[1, 7, 0, 1, 3],
                           kv_lens=[40, 23, 0, 1, 16], t=16)
    before = (pa.LAUNCHES.count, pa.LAUNCHES_Q.count)
    out = pa.paged_attention_ragged(*args, **scales)
    torch.cuda.synchronize()
    assert (pa.LAUNCHES.count, pa.LAUNCHES_Q.count) == \
        (before[0], before[1] + 1)
    ref = pa.paged_attention_ragged_ref(*args, **scales)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    guard = args[-1] < 0
    assert int(guard.sum()) == 4
    assert bool((out[guard] == 0).all())


@pytest.mark.parametrize("bs", [4, 8, 16])
def test_int8_kernel_layer_slices_and_block_sizes(bs):
    """Slices of [L, NB, KVH, BS(, D)] stacks, as the engine passes them,
    and chunks crossing block boundaries."""
    dev = _card()
    (q, kq, vq, tables, kl, lane, pos), sc = _q_case(
        dev, torch.float32, 6, 2, 32, bs, q_lens=[9, 1], kv_lens=[21, 33],
        t=12)
    stack = [torch.stack([torch.zeros_like(a), a])
             for a in (kq, vq, sc["k_scale"], sc["v_scale"])]
    out = pa.paged_attention_ragged(q, stack[0][1], stack[1][1], tables, kl,
                                    lane, pos, k_scale=stack[2][1],
                                    v_scale=stack[3][1])
    ref = pa.paged_attention_ragged_ref(q, kq, vq, tables, kl, lane, pos,
                                        **sc)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_int8_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    args, sc = _q_case(dev, torch.float32, 4, 2, 32, 4, q_lens=[2],
                       kv_lens=[5], t=4)
    q, kq, vq = args[:3]
    rest = args[3:]
    cases = [
        ((q, kq, vq) + rest, {}),                          # no scales
        ((q, kq.float(), vq.float()) + rest, sc),          # float pool
        ((q, kq, vq) + rest, dict(k_scale=sc["k_scale"][:, :, :2],
                                  v_scale=sc["v_scale"][:, :, :2])),
        ((q, kq, vq) + rest, dict(k_scale=sc["k_scale"])),  # one plane
    ]
    for a, kw in cases:
        with pytest.raises(ValueError):
            pa.paged_attention_ragged(*a, **kw)
    # head_dim 24: a multiple of 8, not of the 16 an int8 vector holds
    args24, sc24 = _q_case(dev, torch.float32, 4, 2, 24, 4, q_lens=[2],
                           kv_lens=[5], t=4)
    with pytest.raises(ValueError, match="multiple of 16"):
        pa.paged_attention_ragged(*args24, **sc24)
    # block_size 6: a 24-byte scale row is not 16-byte aligned
    args6, sc6 = _q_case(dev, torch.float32, 4, 2, 32, 6, q_lens=[2],
                         kv_lens=[5], t=4)
    with pytest.raises(ValueError, match="16-byte aligned"):
        pa.paged_attention_ragged(*args6, **sc6)


def test_int8_write_on_card_matches_cpu():
    dev = _card()
    rng = np.random.default_rng(3)
    k = torch.from_numpy(rng.normal(size=(6, 2, 16)).astype(np.float32))
    v = torch.from_numpy(rng.normal(size=(6, 2, 16)).astype(np.float32))
    pools = [torch.zeros((8, 2, 4, 16), dtype=torch.int8),
             torch.zeros((8, 2, 4, 16), dtype=torch.int8),
             torch.zeros((8, 2, 4)), torch.zeros((8, 2, 4))]
    tables = torch.tensor([[1, 2], [3, 4]], dtype=torch.int32)
    lane, pos = pa.ragged_metadata(torch.tensor([3, 1], dtype=torch.int32),
                                   torch.tensor([5, 1], dtype=torch.int32),
                                   6)
    want = pa.write_kv_to_cache_ragged(
        k, v, pools[0].clone(), pools[1].clone(), tables, lane, pos,
        k_scale=pools[2].clone(), v_scale=pools[3].clone())
    got = pa.write_kv_to_cache_ragged(
        k.to(dev), v.to(dev), pools[0].to(dev), pools[1].to(dev),
        tables.to(dev), lane.to(dev), pos.to(dev),
        k_scale=pools[2].to(dev), v_scale=pools[3].to(dev))
    for w, g in zip(want, got):
        torch.testing.assert_close(g.cpu(), w, atol=0, rtol=0)


# ---- the weight-only gemms ----

def _gemm_case(dev, m, n, k, fmt, x_dtype, seed=0):
    g = torch.Generator(device=dev).manual_seed(seed)
    w = torch.randn((n, k), generator=g, device=dev)
    x = torch.randn((m, k), generator=g, device=dev).to(x_dtype)
    if fmt == "int4":
        q, s = nq.per_channel_quantize(w, "weight_only_int4")
        return x, nq.pack_int4(q), s
    if fmt == "int8":
        return (x,) + nq.per_channel_quantize(w, "weight_only_int8")
    q, s = nq.per_channel_quantize(w, "fp8")
    if fmt == "e5m2":
        q = q.float().to(torch.float8_e5m2)
    return x, q, s


# f32 output: the kernel and the plain version differ in summation order
_GEMM_TOL = dict(atol=1e-3, rtol=1e-4)


@pytest.mark.parametrize("x_dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e5m2", "int4"])
@pytest.mark.parametrize("m,n,k", [(1, 8, 32), (17, 100, 96),
                                   (40, 130, 4096), (70, 64, 224)])
def test_gemm_kernels_match_plain_versions(fmt, x_dtype, m, n, k):
    """Ragged M and N (edge-masked tiles), K short of, at and past one
    64-byte K tile; f32 output against the plain version, and the bf16
    output equal to the f32 output rounded (one accumulation, one
    rounding)."""
    dev = _card()
    x, wq, s = _gemm_case(dev, m, n, k, fmt, x_dtype)
    int4 = fmt == "int4"
    fn = qm.quant_matmul_int4 if int4 else qm.quant_matmul
    ref_fn = qm.quant_matmul_int4_ref if int4 else qm.quant_matmul_ref
    counter = qm.LAUNCHES_INT4 if int4 else qm.LAUNCHES
    before = counter.count
    out32 = fn(x, wq, s, out_dtype=torch.float32)
    out = fn(x, wq, s)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    assert out.dtype == x_dtype and out.shape == (m, n)
    ref = ref_fn(x, wq, s, out_dtype=torch.float32)
    torch.testing.assert_close(out32, ref, **_GEMM_TOL)
    torch.testing.assert_close(out, out32.to(x_dtype), atol=0, rtol=0)


def test_gemm_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    x, wq, s = _gemm_case(dev, 4, 16, 48, "int8", torch.bfloat16)
    with pytest.raises(ValueError, match="K % 16"):
        qm.quant_matmul(x[:, :40], wq[:, :40], s)
    with pytest.raises(ValueError, match="scale"):
        qm.quant_matmul(x, wq, s.double())
    with pytest.raises(ValueError):
        qm.quant_matmul(x, wq.float(), s)                 # not quantized
    x4, w4, s4 = _gemm_case(dev, 4, 16, 48, "int4", torch.bfloat16)
    with pytest.raises(ValueError, match="K % 32"):
        qm.quant_matmul_int4(x4, w4, s4)


@pytest.mark.parametrize("kv_bits,weight_only,wbits", [
    (8, None, None), (16, "int8", None), (16, "fp8", None),
    (16, "int4", None), (8, None, 8), (8, None, 4)])
def test_quantized_engine_step_on_card_matches_cpu(kv_bits, weight_only,
                                                   wbits):
    dev = _card()
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny
    from paddle_tpu_torch.serving.quant import quantize_engine

    model = llama_tiny(vocab=128, layers=2, hidden=64, heads=4, seq=64,
                       num_key_value_heads=2, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    geo = dict(max_batch_size=2, num_blocks=16, block_size=4,
               max_blocks_per_seq=16, kv_bits=kv_bits,
               weight_only=weight_only)
    engines = [LlamaInferenceEngine(model, device=d, **geo)
               for d in ("cpu", dev)]
    if wbits is not None:
        for e in engines:
            quantize_engine(e, wbits)
    cpu, gpu = engines
    tables = np.asarray([[1, 2, 3] + [0] * 13, [4, 5] + [0] * 14], np.int32)
    for q_lens, kv_lens in (([6, 5], [6, 5]), ([1, 1], [7, 6])):
        tokens = np.arange(1, 13, dtype=np.int32)
        a = cpu.ragged_step(tokens, q_lens, kv_lens, tables)
        b = gpu.ragged_step(tokens, q_lens, kv_lens, tables)
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
