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


# ---- the split instance of the ragged kernels (bf16 q, BS 16) ----

# (heads, kv heads, head_dim, q_lens, kv_lens): tiles across lanes at
# q_len 1, 5, 16, 17, 33 and 64 (one or two tiles of a lane, a full and a
# short one, up to 64 rows), kv_len at the edges of a page and of the
# cluster's split (1, 15, 16, 17, 2048), G 1, 4 and 8, an empty lane in
# the middle; T leaves guard slots after the last lane
SPLIT_CASES = {
    "tiles_mha": (4, 4, 128, [1, 5, 16, 0, 17, 33, 64],
                  [40, 21, 16, 0, 50, 100, 64]),
    "edges_gqa4": (16, 4, 128, [1, 1, 1, 1, 0, 1, 5],
                   [1, 15, 16, 17, 0, 2048, 33]),
    "tiles_gqa8": (16, 2, 128, [17, 1, 0, 9, 8], [17, 300, 0, 40, 2048]),
    "d64_mha": (8, 8, 64, [1, 33, 0, 2], [130, 70, 0, 17]),
}


def _split_case(dev, name, quant, seed=0, bs=16):
    """Seeded inputs of SPLIT_CASES[name] with 3 guard slots; the pool
    (NB just over the pages the lanes use, `bs` slots a page) in bf16 or,
    `quant`, int8 with its scale planes."""
    h, kvh, d, q_lens, kv_lens = SPLIT_CASES[name]
    t = sum(q_lens) + 3
    w = max(-(-n // bs) for n in kv_lens) + 1
    nb = sum(-(-n // bs) for n in kv_lens) + 2
    rng = np.random.default_rng(seed)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(q_lens), w), np.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        k = -(-n // bs)
        tables[i, :k] = perm[used:used + k]
        used += k
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((t, h, d), generator=g, device=dev).to(torch.bfloat16)
    kc = torch.randn((nb, kvh, bs, d), generator=g, device=dev)
    vc = torch.randn((nb, kvh, bs, d), generator=g, device=dev)
    sc = {}
    if quant:
        kc, ks = kv_quant.quantize_kv(kc)
        vc, vs = kv_quant.quantize_kv(vc)
        sc = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.to(torch.bfloat16), vc.to(torch.bfloat16)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    lane, pos = pa.ragged_metadata(ql, kl, t)
    return (q, kc, vc, torch.from_numpy(tables).to(dev), kl, lane, pos), sc


def _general_plan(q, k_cache, block_tables, quant):
    """`_plan` forced to the general instance."""
    t, h, d = q.shape
    kvh, bs = k_cache.shape[1], k_cache.shape[2]
    return pa.RaggedPlan(0, 1, t, 3, pa._smem_bytes(
        h // kvh, d, bs, k_cache.element_size(), quant), t * kvh)


@pytest.mark.parametrize("instance", ["split", "general"])
@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", list(SPLIT_CASES))
def test_split_instance_matches_plain_version(name, quant, instance,
                                              monkeypatch):
    dev = _card()
    args, sc = _split_case(dev, name, quant)
    q, kc = args[0], args[1]
    plan = pa._plan(q, kc, args[3], quant)
    want_split = not (quant and q.shape[-1] == 64)   # int8 D 64: general
    assert (plan.splits > 0) == want_split
    if instance == "general":
        monkeypatch.setattr(pa, "_plan", _general_plan)
    counter = pa.LAUNCHES_Q if quant else pa.LAUNCHES
    before = counter.count
    out = pa.paged_attention_ragged(*args, **sc)
    again = pa.paged_attention_ragged(*args, **sc)
    torch.cuda.synchronize()
    assert counter.count == before + 2
    ref = pa.paged_attention_ragged_ref(*args, **sc)
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    # guard slots and the empty lane: exact zeros; repeats: the same bits
    guard = args[-1] < 0
    assert int(guard.sum()) == 3
    assert bool((out[guard] == 0).all())
    assert torch.equal(out, again)


def _forced(splits):
    """`_plan` with the cluster size forced (its tile follows it)."""
    from paddle_tpu_torch.ops.kernels import _support

    def plan(q, k_cache, block_tables, quant):
        t, h, d = q.shape
        return pa.ragged_plan(t, h, k_cache.shape[1], d, k_cache.shape[2],
                              block_tables.shape[1], block_tables.shape[0],
                              q.dtype, quant,
                              _support.sm_count(q.device.index or 0),
                              splits=splits)
    return plan


@pytest.mark.parametrize("quant", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("name", ["tiles_mha", "tiles_gqa8"])
def test_split_instance_is_batch_invariant(name, quant, monkeypatch):
    """A token's rows are the same bits in every packing: with the batch
    around it, with its lane alone, and at every cluster size (whose tile
    size follows it)."""
    dev = _card()
    args, sc = _split_case(dev, name, quant)
    q, kc, vc, tables, kl, lane, pos = args
    want = pa.paged_attention_ragged(*args, **sc)
    g = q.shape[1] // kc.shape[1]
    for splits in pa.PLAN_SPLITS:
        if g > 16 * splits:
            continue
        monkeypatch.setattr(pa, "_plan", _forced(splits))
        assert torch.equal(pa.paged_attention_ragged(*args, **sc), want)
        # each lane alone: its own tokens, one lane in the table
        for b in range(tables.shape[0]):
            rows = (lane == b) & (pos >= 0)
            n = int(rows.sum())
            if n == 0:
                continue
            one = pa.paged_attention_ragged(
                q[rows].contiguous(), kc, vc, tables[b:b + 1].contiguous(),
                kl[b:b + 1].contiguous(),
                torch.zeros(n, dtype=torch.int32, device=dev),
                pos[rows].contiguous(), **sc)
            assert torch.equal(one, want[rows])


def test_decode_takes_the_split_instance_bit_equal_to_ragged():
    """bf16 decode at the split instance's shapes launches it, one query a
    lane, counted as a decode launch: the same bits as a ragged step over
    the same lanes, within the plain version's tolerance; an empty lane
    gives zeros."""
    dev = _card()
    args, _ = _split_case(dev, "edges_gqa4", False)
    q, kc, vc, tables, kl = args[:5]
    qd = q[:kl.shape[0]].contiguous()                # one query a lane
    before = (pa.LAUNCHES.count, pa.LAUNCHES_DECODE.count)
    out = pa.paged_attention(qd, kc, vc, tables, kl)
    torch.cuda.synchronize()
    assert (pa.LAUNCHES.count, pa.LAUNCHES_DECODE.count) == \
        (before[0], before[1] + 1)
    # slot b holds lane b's query at kv_len - 1 (a guard where kv_len 0)
    ln = torch.arange(kl.shape[0], dtype=torch.int32, device=dev)
    rag = pa.paged_attention_ragged(qd, kc, vc, tables, kl, ln, kl - 1)
    assert torch.equal(out, rag)
    assert bool((out[kl == 0] == 0).all())
    ref = pa.paged_attention_ref(qd, kc, vc, tables, kl)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


# (heads, kv heads, head_dim, slots a page, context lengths, S): windows
# with dead rows (ctx < S, an empty lane), across page edges, G 1, 4 and 8,
# pages of 16, 32 and 64 slots
VERIFY_SPLIT_CASES = {
    "mha_s5": (4, 4, 128, 16, [0, 3, 5, 17, 40], 5),
    "gqa4_s17_bs64": (16, 4, 128, 64, [10, 17, 70, 0, 300], 17),
    "gqa8_s64": (16, 2, 128, 16, [64, 100, 3, 2048], 64),
    "d64_s16_bs32": (8, 8, 64, 32, [16, 33, 0, 130], 16),
}


def _no_rows_kernel(*a, **k):
    raise AssertionError("the decode / verify kernel was launched")


@pytest.mark.parametrize("name", list(VERIFY_SPLIT_CASES))
def test_verify_takes_the_split_instance_bit_equal_to_ragged_and_decode(
        name, monkeypatch):
    """bf16 verify at the split instance's shapes launches it once in
    window mode (a verify launch, no ragged or decode one): each row the
    same bits as the ragged kernel on the same windows and as a decode
    call at its position, within the plain version's tolerance, and a
    row at a negative position (a dead row) exact zeros."""
    dev = _card()
    h, kvh, d, bs, lens, s = VERIFY_SPLIT_CASES[name]
    q, kc, vc, tables, kl = _rows_case(dev, torch.bfloat16, h, kvh, d, bs,
                                       lens, s=s)
    assert pa._window_split(q, kc, tables)
    monkeypatch.setattr(pa, "_launch_rows", _no_rows_kernel)
    counts = (pa.LAUNCHES, pa.LAUNCHES_DECODE, pa.LAUNCHES_VERIFY)
    before = [c.count for c in counts]
    out = pa.paged_attention_verify(q, kc, vc, tables, kl)
    torch.cuda.synchronize()
    assert [c.count for c in counts] == [before[0], before[1],
                                         before[2] + 1]
    b = q.shape[0]
    lane, pos = pa.ragged_metadata(
        torch.full((b,), s, dtype=torch.int32, device=dev), kl, b * s)
    rag = pa.paged_attention_ragged(q.reshape(b * s, h, d), kc, vc, tables,
                                    kl, lane, pos)
    assert torch.equal(out, rag.reshape(out.shape))
    for i in range(s):
        cut = torch.clamp(kl - (s - 1 - i), min=0).to(torch.int32)
        assert torch.equal(out[:, i], pa.paged_attention(
            q[:, i].contiguous(), kc, vc, tables, cut))
    ref = pa.paged_attention_verify_ref(q, kc, vc, tables, kl)
    torch.testing.assert_close(out.float(), ref.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])
    last = kl[:, None] - s + torch.arange(s, device=dev)[None, :]
    assert bool((last < 0).any()) and bool((out[last < 0] == 0).all())


@pytest.mark.parametrize("bs", [32, 48, 64, 256])
@pytest.mark.parametrize("op", ["ragged", "ragged_int8", "decode",
                                "verify"])
def test_pages_of_16k_slots_give_the_bits_of_16_slot_pages(op, bs,
                                                           monkeypatch):
    """A pool of pages of any multiple of 16 slots runs the split
    instance and gives the same bits as the same keys in 16-slot pages,
    in the ragged kernel (bf16 and int8 pools), decode and verify."""
    dev = _card()
    from paddle_tpu_torch.tools.kernel_compare import as_16_slot_pages

    monkeypatch.setattr(pa, "_launch_rows", _no_rows_kernel)
    if op.startswith("ragged"):
        quant = op == "ragged_int8"
        args, sc = _split_case(dev, "tiles_gqa8", quant, bs=bs)
        q, kc, vc, tables, kl, lane, pos = args
        assert pa._plan(q, kc, tables, quant).splits > 0
        pool = as_16_slot_pages(kc, vc, tables, sc.get("k_scale"),
                                sc.get("v_scale"))
        sc16 = dict(zip(("k_scale", "v_scale"), pool[3:]))
        want = pa.paged_attention_ragged(q, *pool[:3], kl, lane, pos,
                                         **sc16)
        got = pa.paged_attention_ragged(*args, **sc)
        ref = pa.paged_attention_ragged_ref(*args, **sc)
    else:
        s = 7 if op == "verify" else None
        q, kc, vc, tables, kl = _rows_case(dev, torch.bfloat16, 16, 4, 128,
                                           bs, [0, 5, 40, 300], s=s)
        assert pa._window_split(q, kc, tables)
        fn = pa.paged_attention_verify if s else pa.paged_attention
        ref_fn = pa.paged_attention_verify_ref if s else \
            pa.paged_attention_ref
        want = fn(q, *as_16_slot_pages(kc, vc, tables), kl)
        got = fn(q, kc, vc, tables, kl)
        ref = ref_fn(q, kc, vc, tables, kl)
    torch.cuda.synchronize()
    assert torch.equal(got, want)
    torch.testing.assert_close(got.float(), ref.float(),
                               atol=TOL[torch.bfloat16],
                               rtol=TOL[torch.bfloat16])


@pytest.mark.parametrize("op", ["decode", "verify"])
@pytest.mark.parametrize("case", ["f32", "bf16_d96", "bf16_bs8",
                                  "bf16_g128"])
def test_general_decode_verify_shapes_run_the_rows_kernel(case, op,
                                                          monkeypatch):
    """What the split instance refuses (f32, head_dim 96, 8-slot pages,
    128 query heads a kv head) runs the decode / verify kernel, within
    the file's tolerance, dead rows exact zeros."""
    dev = _card()
    dtype, h, kvh, d, bs = {"f32": (torch.float32, 8, 2, 128, 16),
                            "bf16_d96": (torch.bfloat16, 8, 2, 96, 16),
                            "bf16_bs8": (torch.bfloat16, 8, 2, 128, 8),
                            "bf16_g128": (torch.bfloat16, 128, 1, 128, 16)
                            }[case]
    s = 5 if op == "verify" else None
    args = _rows_case(dev, dtype, h, kvh, d, bs, [0, 3, 37], s=s)
    assert not pa._window_split(*args[:2], args[3])

    def no_split(*a, **k):
        raise AssertionError("the split instance was launched")
    monkeypatch.setattr(pa, "_launch", no_split)
    fn = pa.paged_attention_verify if s else pa.paged_attention
    ref_fn = pa.paged_attention_verify_ref if s else pa.paged_attention_ref
    counter = pa.LAUNCHES_VERIFY if s else pa.LAUNCHES_DECODE
    before = counter.count
    out = fn(*args)
    torch.cuda.synchronize()
    assert counter.count == before + 1
    ref = ref_fn(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    lens = args[-1]
    last = lens[:, None] - (s or 1) + torch.arange(s or 1,
                                                   device=dev)[None, :]
    dead = last < 0 if s else last[:, 0] < 0
    assert bool((out[dead] == 0).all())


def test_split_plan_matches_the_kernels_shared_memory():
    """`ragged_plan`'s shared memory is the library's `SplitSmem`."""
    _card()
    import ctypes
    from paddle_tpu_torch.ops.kernels import _support

    fn = _support.load_library("ragged_paged_attention") \
        .ragged_split_smem_bytes
    fn.argtypes = [ctypes.c_int, ctypes.c_int]
    fn.restype = ctypes.c_longlong
    for d, quant in ((128, False), (64, False), (128, True)):
        plan = pa.ragged_plan(40, 32, 32, d, 16, 128, 8, torch.bfloat16,
                              quant, 132)
        assert plan.splits > 0 and fn(d, int(quant)) == plan.smem_bytes


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
                                   (40, 130, 4096), (70, 64, 224),
                                   (40, 4096, 11008), (3, 4096, 4096),
                                   (257, 12288, 4096), (40, 4096, 4000)])
def test_gemm_kernels_match_plain_versions(fmt, x_dtype, m, n, k):
    """Ragged M and N (edge-masked tiles), K short of, at and past one
    weight tile (int4: K / 2 short of one tile at K 32 and 224, and not a
    multiple of it at K 4000); K split over a cluster (the `down` shape,
    3 tokens, K 4000), and five token tiles; f32 output against the plain
    version, and the bf16 output equal to the f32 output rounded (one
    accumulation, one rounding)."""
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


@pytest.mark.parametrize("fmt", ["int8", "e4m3", "e5m2", "int4"])
def test_gemm_repeat_bit_for_bit(fmt):
    """No atomics: the split-K partials are summed in a fixed order, so
    two calls give the same bits, in both output dtypes."""
    dev = _card()
    m, n, k = 40, 4096, 11008
    x, wq, s = _gemm_case(dev, m, n, k, fmt, torch.bfloat16, seed=4)
    fn = qm.quant_matmul_int4 if fmt == "int4" else qm.quant_matmul
    assert qm.gemm_plan(m, n, k, torch.cuda.get_device_properties(
        dev).multi_processor_count, fmt == "int4").splits > 1
    for out_dtype in (torch.float32, torch.bfloat16):
        a = fn(x, wq, s, out_dtype=out_dtype)
        b = fn(x, wq, s, out_dtype=out_dtype)
        torch.cuda.synchronize()
        assert torch.equal(a, b)


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
    # K 0: a tensor map needs a non-empty K, in either format
    with pytest.raises(ValueError, match="K > 0"):
        qm.quant_matmul_int4(x4[:, :0], w4[:, :0], s4)


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


# ---------------------------------------------------------------------------
# flash attention (forward, dQ, dK/dV) and RMSNorm
# ---------------------------------------------------------------------------

from paddle_tpu_torch.ops.kernels import flash_attention as fa  # noqa: E402
from paddle_tpu_torch.ops.kernels import rms_norm as rn  # noqa: E402

# norm-relative error of the kernels against their plain versions: f32 is
# summation order only; bf16/f16 round P and dS to 16 bits before their
# products (the plain versions keep them in f32)
FLASH_TOL = {torch.float32: 1e-5, torch.bfloat16: 2e-2, torch.float16: 4e-3}

FLASH_CASES = {
    # (B, Sq, Sk, H, KVH, D, causal, kv_lens)
    "ragged_causal": (2, 100, 100, 4, 4, 64, True, None),
    "gqa_ragged": (2, 77, 77, 8, 2, 32, False, None),
    "lens_empty": (3, 64, 64, 4, 2, 128, False, [50, 0, 13]),
    "causal_lens": (2, 130, 130, 4, 1, 16, True, [130, 67]),
    "sq_ne_sk": (2, 40, 100, 4, 4, 48, False, None),
    # several 128-row tiles with a ragged last one, launched heaviest first
    "multi_tile_causal": (2, 1000, 1000, 8, 2, 128, True, None),
    # G = 8, D padded to 128 columns, a kv_lens tail inside a tile
    "gqa8_d96": (2, 384, 384, 16, 2, 96, True, [384, 201]),
    # Sq not a multiple of the 128-row q tile, an empty sequence (its dq
    # exactly 0), D padded to 128 columns
    "ragged_empty_d80": (3, 200, 200, 8, 4, 80, True, [200, 0, 77]),
    # BERT-base's attention in `encoder_train`: D 64, S 512, non-causal
    "bert_d64": (32, 512, 512, 12, 12, 64, False, None),
}


def _rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _flash_inputs(dev, dtype, case, seed=0):
    b, sq, sk, h, kvh, d, causal, lens = FLASH_CASES[case]
    g = torch.Generator(device=dev).manual_seed(seed)
    q = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    k = torch.randn((b, sk, kvh, d), generator=g, device=dev).to(dtype)
    v = torch.randn((b, sk, kvh, d), generator=g, device=dev).to(dtype)
    do = torch.randn((b, sq, h, d), generator=g, device=dev).to(dtype)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    return q, k, v, do, kl, causal


@pytest.mark.parametrize("case", list(FLASH_CASES))
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16],
                         ids=["f32", "bf16", "f16"])
def test_flash_kernels_match_plain_versions(dtype, case):
    dev = _card()
    q, k, v, do, kl, causal = _flash_inputs(dev, dtype, case)
    counts = (fa.LAUNCHES_FWD.count, fa.LAUNCHES_DQ.count,
              fa.LAUNCHES_DKV.count)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, kv_lens=kl)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal,
                                                  kv_lens=kl)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    grads = fa.flash_attention_bwd(q, k, v, do, ref_lse, delta, causal,
                                   kv_lens=kl)
    refs = fa.flash_attention_bwd_ref(q, k, v, do, ref_lse, delta, causal,
                                      kv_lens=kl)
    torch.cuda.synchronize()
    assert (fa.LAUNCHES_FWD.count, fa.LAUNCHES_DQ.count,
            fa.LAUNCHES_DKV.count) == tuple(c + 1 for c in counts)
    assert out.dtype == dtype and lse.dtype == torch.float32
    tol = FLASH_TOL[dtype]
    assert _rel(out, ref_out) <= tol
    live = ref_lse > -1e29
    torch.testing.assert_close(lse[live], ref_lse[live], atol=1e-3 if
                               dtype != torch.float32 else 1e-5, rtol=0)
    assert bool((lse[~live] == -1e30).all())
    for name, got, want in zip(("dq", "dk", "dv"), grads, refs):
        assert got.dtype == dtype and got.shape == want.shape
        assert _rel(got, want) <= tol, name
    if kl is not None and 0 in kl.tolist():
        i = kl.tolist().index(0)
        assert bool((out[i] == 0).all()) and bool((grads[0][i] == 0).all())
        assert bool((grads[1][i] == 0).all()) and bool((grads[2][i] == 0).all())


def test_flash_kernels_repeat_bit_for_bit():
    """No atomics: two forward runs and two backward runs give the same
    bits."""
    dev = _card()
    q, k, v, do, kl, causal = _flash_inputs(dev, torch.bfloat16,
                                            "gqa_ragged", seed=3)
    out, lse = fa.flash_attention_fwd(q, k, v, causal)
    out2, lse2 = fa.flash_attention_fwd(q, k, v, causal)
    assert torch.equal(out, out2) and torch.equal(lse, lse2)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    a = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    b = fa.flash_attention_bwd(q, k, v, do, lse, delta, causal)
    for x, y in zip(a, b):
        assert torch.equal(x, y)


@pytest.mark.parametrize("case", ["ragged_causal", "gqa_ragged",
                                  "causal_lens"])
def test_flash_autograd_against_float64(case):
    """Gradcheck-style: the autograd Function's gradients on the card (f32
    kernels) against autograd through plain f64 attention on the CPU, and
    a central finite difference along one random direction."""
    dev = _card()
    q, k, v, do, kl, causal = _flash_inputs(dev, torch.float32, case, 5)
    leaves = [t.clone().requires_grad_() for t in (q, k, v)]
    out = fa.flash_attention_bshd(*leaves, causal=causal, kv_lens=kl)
    (out * do).sum().backward()

    def ref(q_, k_, v_):
        """Attention in f64 on the CPU (empty rows give 0)."""
        grp = q_.shape[2] // k_.shape[2]
        qt = q_.transpose(1, 2)
        kt = k_.transpose(1, 2).repeat_interleave(grp, dim=1)
        vt = v_.transpose(1, 2).repeat_interleave(grp, dim=1)
        s = (qt @ kt.transpose(-1, -2)) / qt.shape[-1] ** 0.5
        live = fa._live(q_.shape[1], k_.shape[1], causal,
                        None if kl is None else kl.cpu(), "cpu")
        s = s.masked_fill(~live, -1e30)
        p = torch.where(live, torch.exp(s - s.amax(-1, keepdim=True)), 0.0)
        p = p / p.sum(-1, keepdim=True).clamp_min(1e-300)
        return (p @ vt).transpose(1, 2)

    cpu = [t.detach().cpu().double().requires_grad_() for t in (q, k, v)]
    r = ref(*cpu)
    (r * do.cpu().double()).sum().backward()
    torch.testing.assert_close(out.detach().cpu().double(), r.detach(),
                               atol=1e-5, rtol=1e-5)
    for got, want in zip(leaves, cpu):
        torch.testing.assert_close(got.grad.cpu().double(), want.grad,
                                   atol=1e-4, rtol=1e-4)
    g = torch.Generator().manual_seed(6)
    dirs = [torch.randn(t.shape, generator=g, dtype=torch.float64)
            for t in cpu]
    eps = 1e-4
    plus = (ref(*[(t + eps * u) for t, u in zip(cpu, dirs)]) *
            do.cpu().double()).sum()
    minus = (ref(*[(t - eps * u) for t, u in zip(cpu, dirs)]) *
             do.cpu().double()).sum()
    fd = float((plus - minus) / (2 * eps))
    an = sum(float((t.grad.cpu().double() * u).sum())
             for t, u in zip(leaves, dirs))
    assert abs(fd - an) <= 1e-4 * max(1.0, abs(fd))


def test_flash_wrapper_refuses_what_the_kernels_do_not_take():
    dev = _card()
    q, k, v, do, _kl, _c = _flash_inputs(dev, torch.bfloat16, "gqa_ragged")
    with pytest.raises(ValueError, match="dtype|is torch"):
        fa.flash_attention_fwd(q, k.float(), v)
    with pytest.raises(ValueError, match="group"):
        fa.flash_attention_fwd(q, k[:, :, :1].expand(-1, -1, 3, -1)
                               .contiguous(), v[:, :, :1].expand(
                                   -1, -1, 3, -1).contiguous())
    for d in (24, 256):
        x = torch.zeros((1, 16, 2, d), dtype=torch.bfloat16, device=dev)
        with pytest.raises(ValueError, match="head_dim"):
            fa.flash_attention_fwd(x, x, x)
    with pytest.raises(ValueError, match="causal"):
        fa.flash_attention_fwd(q[:, :40], k, v, causal=True)
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention_fwd(q, k, v, kv_lens=torch.tensor(
            [3, 4], device=dev))                         # int64
    with pytest.raises(ValueError, match="kv_lens"):
        fa.flash_attention_fwd(q, k, v, kv_lens=torch.tensor(
            [3, 4], dtype=torch.int32))                  # on the CPU
    wide = torch.zeros((2, 77, 8, 40), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="aligned"):
        fa.flash_attention_fwd(wide[..., 1:33], k, v)    # 2-byte offset
    with pytest.raises(ValueError, match="is on"):
        fa.flash_attention_fwd(q, k.cpu(), v)
    out, lse = fa.flash_attention_fwd(q, k, v)
    with pytest.raises(ValueError, match="lse"):
        fa.flash_attention_bwd(q, k, v, do, lse.transpose(1, 2), lse)


# the register instance at every thread count (H 256, 4096, 5120, 8192,
# 16384 in 16-bit types) and the general one (H 100, 4100, f32 16384), a
# single row
RMS_SHAPES = [(37, 4096), (5, 3, 100), (2, 256), (9, 5120), (6, 8192),
              (7, 4100), (3, 16384), (1, 4096)]


@pytest.mark.parametrize("shape", RMS_SHAPES, ids=str)
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16,
                                   torch.float16], ids=["f32", "bf16", "f16"])
def test_rms_kernel_matches_plain_version(shape, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    x = (3 * torch.randn(shape, generator=g, device=dev)).to(dtype)
    w = (1 + 0.2 * torch.randn(shape[-1:], generator=g, device=dev)) \
        .to(dtype)
    before = rn.LAUNCHES.count
    y = rn.rms_norm(x, w, 1e-6)
    ref = rn.rms_norm_ref(x.reshape(-1, shape[-1]), w, 1e-6).reshape(shape)
    torch.cuda.synchronize()
    assert rn.LAUNCHES.count == before + 1 and y.dtype == dtype
    _assert_rms_close(y, ref)
    # the row's sum runs in a fixed order: a repeat is bit-equal
    assert torch.equal(y, rn.rms_norm(x, w, 1e-6))


def _assert_rms_close(y, ref):
    """f32 within 1e-6; 16-bit within one ulp of the plain version."""
    if y.dtype == torch.float32:
        torch.testing.assert_close(y, ref, rtol=1e-6, atol=1e-6)
    else:
        r = ref.float()
        bits = 7 if y.dtype == torch.bfloat16 else 10
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(
            2.0 ** -14))) - bits)
        assert bool(((y.float() - r).abs() <= ulp).all())


def test_rms_kernel_on_strided_rows_and_autograd():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(8)
    big = torch.randn((16, 2 * 96), generator=g, device=dev)
    x = big[:, 96:]                                 # a row stride of 192
    w = torch.randn((96,), generator=g, device=dev)
    y = rn.rms_norm(x, w, 1e-5)
    torch.testing.assert_close(y, rn.rms_norm_ref(x, w, 1e-5), rtol=1e-6,
                               atol=1e-6)
    # 16-bit rows 2 bytes off a 16-byte boundary (the general instance)
    # and rows of a wider stride that stay aligned (the register
    # instance); a repeat is bit-equal
    for dtype in (torch.bfloat16, torch.float16):
        wide = (2 * torch.randn((5, 4096 + 16), generator=g, device=dev)) \
            .to(dtype)
        w16 = (1 + 0.2 * torch.randn((4096,), generator=g, device=dev)) \
            .to(dtype)
        for off in (1, 8):
            xs = wide[:, off:off + 4096]
            ys = rn.rms_norm(xs, w16, 1e-6)
            _assert_rms_close(ys, rn.rms_norm_ref(xs, w16, 1e-6))
            assert torch.equal(ys, rn.rms_norm(xs, w16, 1e-6))
        # aligned rows against a w 2 bytes off a 16-byte boundary: the
        # register instance reads w as 16-byte vectors, so the general
        # one takes it
        wbuf = (1 + 0.2 * torch.randn((4096 + 8,), generator=g,
                                      device=dev)).to(dtype)
        wo = wbuf[1:1 + 4096]
        xa = wide[:, 8:8 + 4096]
        yo = rn.rms_norm(xa, wo, 1e-6)
        _assert_rms_close(yo, rn.rms_norm_ref(xa, wo, 1e-6))
        assert torch.equal(yo, rn.rms_norm(xa, wo, 1e-6))
    xl = x.clone().requires_grad_()
    wl = w.clone().requires_grad_()
    gy = torch.randn(x.shape, generator=g, device=dev)
    (rn.rms_norm(xl, wl, 1e-5) * gy).sum().backward()
    xc = x.cpu().double().requires_grad_()
    wc = w.cpu().double().requires_grad_()
    ref = xc * torch.rsqrt(xc.pow(2).mean(-1, keepdim=True) + 1e-5) * wc
    (ref * gy.cpu().double()).sum().backward()
    torch.testing.assert_close(xl.grad.cpu().double(), xc.grad, atol=1e-5,
                               rtol=1e-5)
    torch.testing.assert_close(wl.grad.cpu().double(), wc.grad, atol=1e-4,
                               rtol=1e-5)


def test_rms_wrapper_refuses_what_the_kernel_does_not_take():
    dev = _card()
    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    for w_dtype in (torch.float16, torch.float32):
        with pytest.raises(ValueError, match="w must be"):
            rn.rms_norm_fwd(x, torch.ones(64, dtype=w_dtype, device=dev),
                            1e-6)
    with pytest.raises(ValueError, match="contiguous"):
        rn.rms_norm_fwd(x, torch.ones(32, dtype=torch.bfloat16, device=dev),
                        1e-6)
    with pytest.raises(ValueError, match="one CUDA device"):
        rn.rms_norm_fwd(x, torch.ones(64, dtype=torch.bfloat16), 1e-6)
    with pytest.raises(ValueError, match="x must be"):
        rn.rms_norm_fwd(x.double(), torch.ones(64, dtype=torch.float64,
                                               device=dev), 1e-6)


def test_empty_inputs_launch_nothing_and_dkv_writes_zeros():
    """An empty output launches no kernel and counts none; dK/dV with no
    query rows (Sq == 0) is not empty: its kernel writes zeros."""
    dev = _card()
    for dtype in (torch.float32, torch.bfloat16):
        q = torch.zeros((2, 0, 4, 32), dtype=dtype, device=dev)
        k = torch.randn((2, 24, 2, 32), device=dev).to(dtype)
        v = torch.randn((2, 24, 2, 32), device=dev).to(dtype)
        lse = torch.zeros((2, 4, 0), device=dev)
        counts = (fa.LAUNCHES_FWD.count, fa.LAUNCHES_DQ.count,
                  fa.LAUNCHES_DKV.count)
        out, lse_out = fa.flash_attention_fwd(q, k, v)
        dq = fa.flash_attention_dq(q, k, v, q, lse, lse)
        dk, dv = fa.flash_attention_dkv(q, k, v, q, lse, lse)
        torch.cuda.synchronize()
        assert out.shape == q.shape and lse_out.shape == (2, 4, 0)
        assert dq.shape == q.shape
        assert bool((dk == 0).all()) and bool((dv == 0).all())
        assert (fa.LAUNCHES_FWD.count, fa.LAUNCHES_DQ.count,
                fa.LAUNCHES_DKV.count) == (counts[0], counts[1],
                                           counts[2] + 1)
    before = rn.LAUNCHES.count
    for shape in ((0, 64), (3, 0, 64)):
        x = torch.zeros(shape, dtype=torch.bfloat16, device=dev)
        w = torch.ones(64, dtype=torch.bfloat16, device=dev)
        assert rn.rms_norm(x, w, 1e-6).shape == shape
    assert rn.LAUNCHES.count == before


# ---- the decode and verify kernels ----

def _rows_case(dev, dtype, h, kvh, d, bs, lens, s=None, seed=0):
    """Pools, one random table per sequence (a spare column), context
    lengths `lens`, and q [B, H, D] (decode, `s` None) or [B, S, H, D]."""
    g = torch.Generator(device=dev).manual_seed(seed)
    w = max(-(-max(lens) // bs), 1) + 1
    nb = len(lens) * w + 1
    perm = np.random.default_rng(seed).permutation(np.arange(1, nb))
    tables = torch.from_numpy(
        perm[:len(lens) * w].reshape(len(lens), w).astype(np.int32)).to(dev)
    shape = (len(lens), h, d) if s is None else (len(lens), s, h, d)
    q = torch.randn(shape, generator=g, device=dev).to(dtype)
    kc = torch.randn((nb, kvh, bs, d), generator=g, device=dev).to(dtype)
    vc = torch.randn((nb, kvh, bs, d), generator=g, device=dev).to(dtype)
    lens = torch.tensor(lens, dtype=torch.int32, device=dev)
    return q, kc, vc, tables, lens


# (heads, kv heads, block size, context lengths): ctx 0, on a block
# boundary, across one
_ROW_CASES = {"mha_bs4": (4, 4, 4, [0, 8, 13]),
              "gqa_bs4": (8, 2, 4, [5, 0, 12, 17]),
              "mha_bs16": (4, 4, 16, [16, 37, 0]),
              "gqa_bs16": (32, 8, 16, [33, 32, 1, 200])}


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("d", [16, 128])
@pytest.mark.parametrize("case", list(_ROW_CASES))
def test_decode_kernel_matches_plain_version(case, d, dtype):
    dev = _card()
    h, kvh, bs, lens = _ROW_CASES[case]
    args = _rows_case(dev, dtype, h, kvh, d, bs, lens)
    before = pa.LAUNCHES_DECODE.count
    out = pa.paged_attention(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_DECODE.count == before + 1
    ref = pa.paged_attention_ref(*args)
    assert out.dtype == dtype and out.shape == ref.shape
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    empty = args[-1] == 0
    assert bool((out[empty] == 0).all())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [1, 5, 64])
@pytest.mark.parametrize("case", list(_ROW_CASES))
def test_verify_kernel_matches_plain_version(case, s, dtype):
    """All S windows, rows with context_lens - S + s < 0 (exact zeros),
    and S * G up to 256 rows."""
    dev = _card()
    h, kvh, bs, lens = _ROW_CASES[case]
    args = _rows_case(dev, dtype, h, kvh, 32, bs, lens, s=s)
    before = pa.LAUNCHES_VERIFY.count
    out = pa.paged_attention_verify(*args)
    torch.cuda.synchronize()
    assert pa.LAUNCHES_VERIFY.count == before + 1
    ref = pa.paged_attention_verify_ref(*args)
    torch.testing.assert_close(out.float(), ref.float(), atol=TOL[dtype],
                               rtol=TOL[dtype])
    last = args[-1][:, None] - s + torch.arange(s, device=dev)[None, :]
    assert bool((out[last < 0] == 0).all())
    # the ragged kernel on the same windows
    b, _s, hh, dd = out.shape
    lane, pos = pa.ragged_metadata(
        torch.full((b,), s, dtype=torch.int32, device=dev), args[-1], b * s)
    rag = pa.paged_attention_ragged(args[0].reshape(b * s, hh, dd),
                                    *args[1:], lane, pos)
    torch.testing.assert_close(out.float(), rag.reshape(out.shape).float(),
                               atol=TOL[dtype], rtol=TOL[dtype])


def test_decode_verify_layer_slices_and_wide_heads():
    """Pool slices of a [L, NB, KVH, BS, D] stack, as the engine passes
    them, and head_dim 256 in f32 (96 KiB of pages per CTA)."""
    dev = _card()
    q, kc, vc, tables, lens = _rows_case(dev, torch.float32, 8, 2, 256, 16,
                                         [40, 9], s=64)
    sk = torch.stack([torch.zeros_like(kc), kc])
    sv = torch.stack([torch.zeros_like(vc), vc])
    out = pa.paged_attention_verify(q, sk[1], sv[1], tables, lens)
    ref = pa.paged_attention_verify_ref(q, kc, vc, tables, lens)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)
    out = pa.paged_attention(q[:, 0].contiguous(), sk[1], sv[1], tables,
                             lens)
    ref = pa.paged_attention_ref(q[:, 0].contiguous(), kc, vc, tables, lens)
    torch.testing.assert_close(out, ref, atol=2e-5, rtol=2e-5)


def test_decode_verify_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    q, kc, vc, tables, lens = _rows_case(dev, torch.float32, 4, 2, 32, 4,
                                         [5, 9], s=3)
    for fn, qq in ((pa.paged_attention, q[:, 0].contiguous()),
                   (pa.paged_attention_verify, q)):
        for bad in ((qq, kc, vc, tables.long(), lens),       # int64 table
                    (qq, kc, vc, tables, lens[:1]),          # lens [1]
                    (qq, kc.to(torch.bfloat16), vc, tables, lens),
                    (qq.half(), kc.half(), vc.half(), tables, lens),  # f16
                    (qq[..., :12].contiguous(), kc[..., :12].contiguous(),
                     vc[..., :12].contiguous(), tables, lens)):  # D % 8
            with pytest.raises(ValueError):
                fn(*bad)
    with pytest.raises(ValueError):                          # S > 64
        pa.paged_attention_verify(q.repeat(1, 22, 1, 1)[:, :65].contiguous(),
                                  kc, vc, tables, lens)
    # f32 pages of 64 slots x head_dim 256: 384 KiB of shared memory
    big = _rows_case(dev, torch.float32, 2, 1, 256, 64, [70], s=2)
    for fn, qq in ((pa.paged_attention, big[0][:, 0].contiguous()),
                   (pa.paged_attention_verify, big[0])):
        with pytest.raises(ValueError, match="shared memory"):
            fn(qq, *big[1:])


def test_decode_verify_empty_inputs_launch_nothing():
    dev = _card()
    q, kc, vc, tables, lens = _rows_case(dev, torch.float32, 4, 2, 32, 4,
                                         [5], s=3)
    before = (pa.LAUNCHES_DECODE.count, pa.LAUNCHES_VERIFY.count)
    out = pa.paged_attention(q[:0, 0].contiguous(), kc, vc, tables[:0],
                             lens[:0])
    assert out.shape == (0, 4, 32)
    out = pa.paged_attention_verify(q[:, :0].contiguous(), kc, vc, tables,
                                    lens)
    assert out.shape == (1, 0, 4, 32)
    assert (pa.LAUNCHES_DECODE.count, pa.LAUNCHES_VERIFY.count) == before


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_engine_legacy_entry_points_on_card_match_cpu(kv_bits):
    """`prefill` (right-padded, with `lens`) and `decode_step` (kv_bits
    16: the decode kernel) and `verify_step` (both KV modes: the ragged
    kernels) on the card against the engine's CPU run."""
    dev = _card()
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny

    model = llama_tiny(vocab=128, layers=2, hidden=128, heads=4, seq=64,
                       num_key_value_heads=2, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    geo = dict(max_batch_size=2, num_blocks=16, block_size=4,
               max_blocks_per_seq=16, kv_bits=kv_bits)
    cpu = LlamaInferenceEngine(model, device="cpu", **geo)
    gpu = LlamaInferenceEngine(model, device=dev, **geo)
    tables = np.asarray([[1, 2, 3, 4] + [0] * 12, [5, 6, 7] + [0] * 13],
                        np.int32)
    rng = np.random.default_rng(3)
    calls = [("verify_step", (rng.integers(1, 128, (2, 5)).astype(np.int32),
                              np.asarray([13, 9], np.int32), tables))]
    if kv_bits == 16:
        before = pa.LAUNCHES_DECODE.count
        calls = [("prefill", (rng.integers(1, 128, (2, 8)).astype(np.int32),
                              tables, np.asarray([8, 5], np.int32))),
                 ("decode_step", (np.asarray([3, 7], np.int32),
                                  np.asarray([9, 6], np.int32), tables))] \
            + calls
    for name, args in calls:
        a = getattr(cpu, name)(*args)
        b = getattr(gpu, name)(*args)
        assert b.device.type == "cuda"
        torch.testing.assert_close(b.cpu(), a, atol=1e-4, rtol=1e-4)
    if kv_bits == 16:
        assert pa.LAUNCHES_DECODE.count == before + 2      # one per layer


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_copy_kv_block_on_card_is_a_bit_copy(kv_bits):
    """`copy_kv_block` on the card: block src's bytes in every layer's K
    and V pool (bf16) and, on an int8 pool, both scale planes' rows land
    bit for bit in block dst; every other block is untouched."""
    dev = _card()
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny

    model = llama_tiny(vocab=128, layers=2, hidden=256, heads=2, seq=64,
                       num_key_value_heads=1, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    eng = LlamaInferenceEngine(model, device=dev, max_batch_size=2,
                               num_blocks=8, block_size=16,
                               max_blocks_per_seq=4, kv_bits=kv_bits,
                               dtype=torch.bfloat16)
    g = torch.Generator(device=dev).manual_seed(1)
    planes = [eng.k_cache, eng.v_cache]
    if kv_bits == 8:
        planes += [eng.k_scale, eng.v_scale]
    for t in planes:
        if t.dtype == torch.int8:
            t.copy_(torch.randint(-127, 128, t.shape, generator=g,
                                  device=dev, dtype=torch.int8))
        else:
            t.copy_(torch.randn(t.shape, generator=g, device=dev))
    before = [t.clone() for t in planes]
    eng.copy_kv_block(2, 5)
    keep = [i for i in range(8) if i != 5]
    for t, b in zip(planes, before):
        assert torch.equal(t[:, 5], b[:, 2])
        assert torch.equal(t[:, keep], b[:, keep])
    with pytest.raises(ValueError, match="outside the pool"):
        eng.copy_kv_block(2, 8)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_prefix_hit_ragged_rows_equal_the_cold_run(kv_bits):
    """A bf16 engine at the serving head_dim (the split instance): a
    prompt's rows from a prefix hit — its first two blocks written by
    another lane in another packing, then a chunk of 16 at kv_len 48 —
    and a full hit's last token after a copy-on-write of the shared
    partial block are `torch.equal` to the rows of the prompt run cold
    in its own chunks."""
    dev = _card()
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny

    model = llama_tiny(vocab=512, layers=2, hidden=256, heads=2, seq=256,
                       num_key_value_heads=1, device="cpu",
                       generator=torch.Generator().manual_seed(3))
    geo = dict(max_batch_size=4, num_blocks=32, block_size=16,
               max_blocks_per_seq=8, kv_bits=kv_bits, dtype=torch.bfloat16)
    t_slots = 4 + 32
    rng = np.random.default_rng(4)
    prompt = rng.integers(1, 512, 48).astype(np.int32)
    other = rng.integers(1, 512, 4).astype(np.int32)

    def step(eng, lanes):
        """lanes: [(lane, tokens, kv_len, table)] -> per-lane rows."""
        tokens = np.zeros((t_slots,), np.int32)
        q = np.zeros((4,), np.int32)
        kv = np.zeros((4,), np.int32)
        tables = np.zeros((4, 8), np.int32)
        starts, cur = {}, 0
        for lane, toks, kv_len, table in sorted(lanes, key=lambda x: x[0]):
            tokens[cur:cur + len(toks)] = toks
            q[lane], kv[lane] = len(toks), kv_len
            tables[lane, :len(table)] = table
            starts[lane] = cur
            cur += len(toks)
        out = eng.ragged_step(tokens, q, kv, tables)
        return {lane: out[starts[lane]:starts[lane] + len(t)]
                for lane, t, _k, _tb in lanes}

    cold = LlamaInferenceEngine(model, device=dev, **geo)
    step(cold, [(0, prompt[:32], 32, [1, 2, 3])])
    want = step(cold, [(0, prompt[32:], 48, [1, 2, 3])])[0]
    warm = LlamaInferenceEngine(model, device=dev, **geo)
    # another request writes the prefix's two blocks beside a 4-token lane
    step(warm, [(0, other, 4, [9]), (2, prompt[:32], 32, [5, 6])])
    got = step(warm, [(0, other[:1], 5, [9]),
                      (1, prompt[32:], 48, [5, 6, 7])])[1]
    assert torch.equal(got, want)
    # a full hit leaves the last token: its partial block is shared, so
    # it is copied before the write (the manager's COW hook)
    warm.copy_kv_block(7, 10)
    last = step(warm, [(3, prompt[47:], 48, [5, 6, 10])])[3]
    assert torch.equal(last, want[-1:])


def test_mlp_engine_on_card_matches_cpu():
    """`MLPLMEngine` on the card: ragged steps (f32 and int8 pools)
    within 1e-5 of its CPU run, and the same greedy streams served with
    the prefix cache on."""
    dev = _card()
    from paddle_tpu_torch.serving import MLPLMEngine, ServingFrontend

    for kv_bits in (16, 8):
        engines = [MLPLMEngine(vocab_size=256, hidden=32, max_batch_size=4,
                               num_blocks=32, block_size=8,
                               max_blocks_per_seq=8, seed=2,
                               kv_bits=kv_bits, device=d)
                   for d in ("cpu", dev)]
        tables = np.zeros((4, 8), np.int32)
        tables[0, :3] = [3, 4, 5]
        tables[1, :1] = [9]
        rng = np.random.default_rng(5)
        for q_lens, kv_lens in (([17, 5, 0, 0], [17, 5, 0, 0]),
                                ([1, 1, 0, 0], [18, 6, 0, 0])):
            t = np.zeros((24,), np.int32)
            t[:sum(q_lens)] = rng.integers(1, 256, sum(q_lens))
            a, b = (e.ragged_step(t, q_lens, kv_lens, tables)
                    for e in engines)
            assert b.device.type == "cuda"
            torch.testing.assert_close(b.cpu(), a, atol=1e-5, rtol=0)
        prompts = [rng.integers(1, 256, n).tolist() for n in (9, 20, 13)]
        streams = []
        for e in engines:
            fe = ServingFrontend(e.respawn(), prefix_cache=True)
            hs = [fe.submit(q, max_new_tokens=6) for q in prompts * 2]
            fe.run_until_idle()
            streams.append([h.tokens for h in hs])
        assert streams[0] == streams[1]


def test_f16_engine_decode_raises_on_card():
    """The decode kernel takes bf16/f32 only (JAX's gate also takes f16):
    an f16 engine's `decode_step` and `generate` raise on the card
    instead of running the plain version there, as `ragged_step` and
    `verify_step` do; nothing is launched."""
    dev = _card()
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny

    model = llama_tiny(vocab=128, layers=2, hidden=128, heads=4, seq=64,
                       num_key_value_heads=2, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    eng = LlamaInferenceEngine(model, max_batch_size=2, num_blocks=16,
                               block_size=4, max_blocks_per_seq=16,
                               dtype=torch.float16, device=dev)
    tables = np.asarray([[1, 2, 3, 4] + [0] * 12, [5, 6, 7] + [0] * 13],
                        np.int32)
    before = (pa.LAUNCHES_DECODE.count, pa.LAUNCHES.count)
    with pytest.raises(ValueError, match="decode kernel takes"):
        eng.decode_step(np.asarray([3, 7], np.int32),
                        np.asarray([9, 6], np.int32), tables)
    with pytest.raises(ValueError, match="decode kernel takes"):
        eng.generate(np.asarray([[5, 6, 7, 8]], np.int32), max_new_tokens=2)
    with pytest.raises(ValueError, match="ragged kernel takes"):
        eng.verify_step(np.ones((2, 5), np.int32),
                        np.asarray([13, 9], np.int32), tables)
    assert (pa.LAUNCHES_DECODE.count, pa.LAUNCHES.count) == before
    assert eng.manager.free_blocks == eng.manager.num_blocks


# ---- the fused-op kernels: RoPE, bias + activation, SwiGLU ----

from paddle_tpu_torch.ops.kernels import _support  # noqa: E402
from paddle_tpu_torch.ops.kernels import bias_act as bak  # noqa: E402
from paddle_tpu_torch.ops.kernels import rope as rk  # noqa: E402

_DTYPES = [torch.float32, torch.bfloat16, torch.float16]
_DTYPE_IDS = ["f32", "bf16", "f16"]


def _assert_one_rounding(got, want):
    """Both sides compute in f32 and round once: f32 within 1e-6 relative,
    16-bit within one ulp of each element's own magnitude."""
    assert got.dtype == want.dtype and got.shape == want.shape
    if got.dtype == torch.float32:
        torch.testing.assert_close(got, want, rtol=1e-6, atol=1e-6)
        return
    w = want.float()
    bits, tiny = (7, 2.0 ** -126) if got.dtype == torch.bfloat16 \
        else (10, 2.0 ** -14)
    ulp = torch.exp2(torch.floor(torch.log2(w.abs().clamp_min(tiny)))
                     - bits)
    err = (got.float() - w).abs()
    assert bool((err <= ulp).all()), float((err / ulp).max())


@pytest.mark.parametrize("conj", [False, True], ids=["fwd", "conj"])
@pytest.mark.parametrize("table_f32", [True, False], ids=["f32tab", "qtab"])
@pytest.mark.parametrize("dtype", _DTYPES, ids=_DTYPE_IDS)
def test_rope_kernel_matches_plain_version(dtype, table_f32, conj):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(20)
    for shape in ((2, 17, 3, 64), (3, 5, 2, 6)):     # vector, scalar path
        b, s, h, d = shape
        q = torch.randn(shape, generator=g, device=dev).to(dtype)
        k = torch.randn(shape, generator=g, device=dev).to(dtype)
        tab = torch.randn((s + 4, d // 2), generator=g, device=dev)
        cos, sin = tab.cos(), tab.sin()
        if not table_f32:
            cos, sin = cos.to(dtype), sin.to(dtype)
        before = rk.LAUNCHES.count
        oq, ok = rk._rope(q, k, cos[3:3 + s], sin[3:3 + s], conj)
        rq, rkk = rk.rope_ref(q, k, cos[3:3 + s], sin[3:3 + s], conj)
        torch.cuda.synchronize()
        assert rk.LAUNCHES.count == before + 1
        assert oq.is_contiguous() and ok.is_contiguous()
        _assert_one_rounding(oq, rq)
        _assert_one_rounding(ok, rkk)


def test_rope_on_qkv_views_and_autograd():
    """q and k as strided views of one qkv product (and a view 2 bytes off
    16-byte alignment, the scalar path) give what contiguous copies
    give; the backward (the conj kernel) is the transposed rotation."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(21)
    b, s, h, d = 2, 33, 4, 128
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=dev) \
        .to(torch.bfloat16)
    tab = torch.randn((s, d // 2), generator=g, device=dev)
    cos, sin = tab.cos(), tab.sin()
    q, k = qkv[:, :, 0], qkv[:, :, 1]
    assert not q.is_contiguous()
    oq, ok = rk.fused_rope(q, k, cos, sin)
    rq, rkk = rk.rope_ref(q.contiguous(), k.contiguous(), cos, sin)
    _assert_one_rounding(oq, rq)
    _assert_one_rounding(ok, rkk)
    wide = torch.randn((b, s, h, d + 1), generator=g, device=dev) \
        .to(torch.bfloat16)
    oq2, _ = rk.fused_rope(wide[..., 1:], wide[..., 1:], cos, sin)
    _assert_one_rounding(oq2, rk.rope_ref(wide[..., 1:].contiguous(),
                                          wide[..., 1:].contiguous(), cos,
                                          sin)[0])
    qf = torch.randn((b, s, h, d), generator=g, device=dev) \
        .requires_grad_()
    kf = torch.randn((b, s, h, d), generator=g, device=dev) \
        .requires_grad_()
    gq = torch.randn((b, s, h, d), generator=g, device=dev)
    gk = torch.randn((b, s, h, d), generator=g, device=dev)
    before = rk.LAUNCHES.count
    oq, ok = rk.fused_rope(qf, kf, cos, sin, offset=0)
    ((oq * gq).sum() + (ok * gk).sum()).backward()
    torch.cuda.synchronize()
    assert rk.LAUNCHES.count == before + 2            # forward, backward
    qc = qf.detach().cpu().double().requires_grad_()
    kc = kf.detach().cpu().double().requires_grad_()
    rq, rkk = rk.rope_ref(qc, kc, cos.cpu().double(), sin.cpu().double())
    ((rq * gq.cpu().double()).sum() + (rkk * gk.cpu().double()).sum()) \
        .backward()
    torch.testing.assert_close(qf.grad.cpu().double(), qc.grad, rtol=1e-5,
                               atol=1e-5)
    torch.testing.assert_close(kf.grad.cpu().double(), kc.grad, rtol=1e-5,
                               atol=1e-5)


@pytest.mark.parametrize("dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("act", sorted(bak.ACT_CODES))
def test_bias_act_kernel_matches_plain_version(act, dtype):
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(22)
    # (rows, H): the vector path, then widths the vector does not divide
    for rows, h in ((37, 256), (5, 36), (3, 30)):
        x = (3 * torch.randn((rows, h), generator=g, device=dev)).to(dtype)
        x[0, :4] = 0                                  # relu's tie
        for bias in (None, torch.randn((h,), generator=g, device=dev)
                     .to(dtype), torch.randn((h,), generator=g,
                                             device=dev)):
            b = torch.zeros((h,), dtype=dtype, device=dev) \
                if bias is None else bias
            before = bak.LAUNCHES.count
            y = bak.fused_bias_act(x, bias, act)
            torch.cuda.synchronize()
            assert bak.LAUNCHES.count == before + 1
            _assert_one_rounding(y, bak.bias_act_ref(x, b, act))


@pytest.mark.parametrize("dtype", _DTYPES, ids=_DTYPE_IDS)
def test_swiglu_kernel_on_strided_rows(dtype):
    """`silu(x) * y` with x and y the two halves of one gate/up product
    (a row stride of 2H), and 2 bytes off alignment (the scalar path)."""
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(23)
    for rows, h in ((19, 512), (4, 40)):
        gu = (2 * torch.randn((rows, 2 * h + 1), generator=g,
                              device=dev)).to(dtype)
        for x, y in ((gu[:, :h], gu[:, h:2 * h]),
                     (gu[:, 1:h + 1], gu[:, h + 1:])):
            before = bak.LAUNCHES_SWIGLU.count
            out = bak.swiglu(x, y)
            torch.cuda.synchronize()
            assert bak.LAUNCHES_SWIGLU.count == before + 1
            _assert_one_rounding(out, bak.swiglu_ref(x, y))


def test_bias_act_and_swiglu_autograd_on_card_match_cpu():
    dev = _card()
    g = torch.Generator(device=dev).manual_seed(24)
    x = torch.randn((6, 64), generator=g, device=dev)
    b = torch.randn((64,), generator=g, device=dev)
    gy = torch.randn((6, 32), generator=g, device=dev)
    for act in ("geglu", "swiglu"):
        xs = [x.clone().requires_grad_(), x.cpu().requires_grad_()]
        bs = [b.clone().requires_grad_(), b.cpu().requires_grad_()]
        for xi, bi in zip(xs, bs):
            (bak.fused_bias_act(xi, bi, act) * gy.to(xi.device)).sum() \
                .backward()
        torch.testing.assert_close(xs[0].grad.cpu(), xs[1].grad, rtol=1e-6,
                                   atol=1e-6)
        torch.testing.assert_close(bs[0].grad.cpu(), bs[1].grad, rtol=1e-5,
                                   atol=1e-5)
    y = torch.randn((6, 32), generator=g, device=dev)
    pairs = [(x[:, :32].clone().requires_grad_(), y.clone().requires_grad_()),
             (x[:, :32].cpu().requires_grad_(), y.cpu().requires_grad_())]
    for xi, yi in pairs:
        (bak.swiglu(xi, yi) * gy.to(xi.device)).sum().backward()
    for a, c in zip(pairs[0], pairs[1]):
        torch.testing.assert_close(a.grad.cpu(), c.grad, rtol=1e-6,
                                   atol=1e-6)


def test_fused_op_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    q = torch.zeros((2, 4, 2, 16), dtype=torch.bfloat16, device=dev)
    tab = torch.zeros((4, 8), device=dev)
    with pytest.raises(ValueError, match="q must be"):
        rk.fused_rope(q.double(), q.double(), tab, tab)
    with pytest.raises(ValueError, match="k must match"):
        rk.fused_rope(q, q[:, :, :1], tab, tab)
    with pytest.raises(ValueError, match="k must match"):
        rk.fused_rope(q, q.half(), tab, tab)
    with pytest.raises(ValueError, match="is on"):
        rk.fused_rope(q, q, tab.cpu(), tab.cpu())
    with pytest.raises(ValueError, match="rows"):
        rk.fused_rope(q, q, tab, tab, offset=1)       # offset + S > T
    x = torch.zeros((4, 32), dtype=torch.bfloat16, device=dev)
    with pytest.raises(ValueError, match="x must be"):
        bak.fused_bias_act(x.double(), None, "gelu")
    with pytest.raises(ValueError, match="bias must be"):
        bak.fused_bias_act(x, torch.zeros(32, dtype=torch.float16,
                                          device=dev), "gelu")
    with pytest.raises(ValueError, match="is on"):
        bak.fused_bias_act(x, torch.zeros(32, dtype=torch.bfloat16), "gelu")
    with pytest.raises(KeyError, match="unknown act_method"):
        bak.fused_bias_act(x, None, "tanh")
    with pytest.raises(ValueError, match="odd width"):
        bak.fused_bias_act(x[:, :31], None, "swiglu")
    with pytest.raises(ValueError, match="y must match"):
        bak.swiglu(x, x.float())
    with pytest.raises(ValueError, match="x must be"):
        bak.swiglu(x.double(), x.double())


def test_fused_op_empty_inputs_launch_nothing():
    dev = _card()
    before = (rk.LAUNCHES.count, bak.LAUNCHES.count,
              bak.LAUNCHES_SWIGLU.count)
    q = torch.zeros((2, 0, 3, 16), dtype=torch.bfloat16, device=dev)
    tab = torch.zeros((4, 8), device=dev)
    oq, ok = rk.fused_rope(q, q, tab, tab)
    assert oq.shape == q.shape and ok.shape == q.shape
    x = torch.zeros((0, 64), dtype=torch.bfloat16, device=dev)
    assert bak.fused_bias_act(x, None, "swiglu").shape == (0, 32)
    assert bak.fused_bias_act(x, None, "relu").shape == (0, 64)
    assert bak.swiglu(x, x).shape == (0, 64)
    assert (rk.LAUNCHES.count, bak.LAUNCHES.count,
            bak.LAUNCHES_SWIGLU.count) == before


# ---- the fused-op surface (incubate.nn.functional) on the card ----

def test_incubate_surface_on_card_matches_cpu():
    """A small fused layer's pieces through `incubate.nn.functional` on the
    card (the kernels) and on the CPU (their plain versions): RMSNorm with
    a residual, RoPE on views of one qkv product (forward and backward),
    both SwiGLU forms and `fused_bias_act`; one launch of each kernel per
    call on the card."""
    dev = _card()
    import paddle_tpu_torch.incubate.nn.functional as IF

    g = torch.Generator(device=dev).manual_seed(30)
    b, s, h, d, hid, inter = 2, 24, 4, 32, 128, 96
    x = torch.randn((b, s, hid), generator=g, device=dev).bfloat16()
    res = torch.randn((b, s, hid), generator=g, device=dev).bfloat16()
    w = (1 + 0.1 * torch.randn((hid,), generator=g, device=dev)).bfloat16()
    qkv = torch.randn((b, s, 3, h, d), generator=g, device=dev).bfloat16()
    tab = torch.randn((s + 3, d // 2), generator=g, device=dev)
    gu = torch.randn((b, s, 2 * inter), generator=g, device=dev).bfloat16()
    bias = torch.randn((2 * inter,), generator=g, device=dev)
    gq = torch.randn((b, s, h, d), generator=g, device=dev).bfloat16()
    outs = {}
    for where in ("cpu", "cuda"):
        t = {n: v.to(where) for n, v in dict(
            x=x, res=res, w=w, qkv=qkv, cos=tab.cos(), sin=tab.sin(), gu=gu,
            bias=bias, gq=gq).items()}
        t["qkv"].requires_grad_()
        before = {n: _support.launch_counter(n).count for n in (
            "rms_norm", "fused_rope", "swiglu", "bias_act")}
        y, r = IF.fused_rms_norm(t["x"], t["w"], residual=t["res"])
        q, k = IF.fused_rotary_position_embedding(
            t["qkv"][:, :, 0], t["qkv"][:, :, 1], sin=t["sin"], cos=t["cos"],
            use_neox_rotary_style=False, offset=3)
        (q.float() * t["gq"].float()).sum().backward()
        s2 = IF.swiglu(t["gu"][..., :inter], t["gu"][..., inter:])
        s1 = IF.swiglu(t["gu"])
        ba = IF.fused_bias_act(t["gu"], t["bias"], act_method="geglu")
        launched = {n: _support.launch_counter(n).count - c
                    for n, c in before.items()}
        outs[where] = (y, r, q, k, t["qkv"].grad, s2, s1, ba)
        if where == "cuda":
            torch.cuda.synchronize()
            assert launched == {"rms_norm": 1, "fused_rope": 2, "swiglu": 1,
                                "bias_act": 2}
        else:
            assert not any(launched.values())
    for cpu, card in zip(outs["cpu"], outs["cuda"]):
        _assert_one_rounding(card.detach().cpu(), cpu.detach())


def test_block_multihead_attention_on_card_matches_cpu():
    """Prefill then two decode calls through `block_multihead_attention`
    with a bf16 pool and rope_emb: the decode runs the paged decode
    kernel (one launch per call) and matches the CPU run."""
    dev = _card()
    import paddle_tpu_torch.incubate.nn.functional as IF

    g = torch.Generator().manual_seed(31)
    h, kvh, d, bs, nb = 8, 2, 64, 16, 32
    lens = [20, 7, 33]
    b = len(lens)
    tables = torch.arange(1, 1 + b * 4, dtype=torch.int32).reshape(b, 4)
    rope = torch.rand((2, b, 64, 1, d // 2), generator=g) * 2 - 1
    pools = {"cpu": [torch.zeros((nb, kvh, bs, d), dtype=torch.bfloat16)
                     for _ in range(2)]}
    pools["cuda"] = [p.to(dev) for p in pools["cpu"]]
    width = (h + 2 * kvh) * d
    steps = [(lens, [0] * b, lens)] + [([0] * b, [n + i for n in lens],
                                        [1] * b) for i in range(2)]
    for enc, dec, this in steps:
        qkv = torch.randn((sum(this), width), generator=g).bfloat16()
        outs = {}
        for where in ("cpu", "cuda"):
            before = _support.launch_counter("paged_attention").count
            outs[where] = IF.block_multihead_attention(
                qkv.to(where), *pools[where], torch.tensor(enc),
                torch.tensor(dec), torch.tensor(this),
                block_tables=tables.to(where), rope_emb=rope.to(where),
                block_size=bs, num_heads=h, num_kv_heads=kvh)
            n = _support.launch_counter("paged_attention").count - before
            assert n == (int(where == "cuda") if dec[0] else 0)
        torch.cuda.synchronize()
        cpu, card = outs["cpu"], outs["cuda"]
        torch.testing.assert_close(card[0].float().cpu(), cpu[0].float(),
                                   atol=2e-2, rtol=2e-2)
        for a, c in zip(card[1:], cpu[1:]):          # qkv_out, both pools
            _assert_one_rounding(a.cpu(), c)


def test_block_multihead_attention_64_slot_pages_take_the_split_instance(
        monkeypatch):
    """`block_multihead_attention`'s default 64-slot pages: each bf16
    decode call launches the split instance once (a decode launch; the
    decode kernel never runs) and matches the CPU run."""
    dev = _card()
    import paddle_tpu_torch.incubate.nn.functional as IF

    monkeypatch.setattr(pa, "_launch_rows", _no_rows_kernel)
    g = torch.Generator().manual_seed(32)
    h, kvh, d, bs, nb = 8, 2, 128, 64, 8
    lens = [20, 70, 33]
    b = len(lens)
    tables = torch.arange(1, 1 + b * 2, dtype=torch.int32).reshape(b, 2)
    rope = torch.rand((2, b, 128, 1, d // 2), generator=g) * 2 - 1
    pools = {"cpu": [torch.zeros((nb, kvh, bs, d), dtype=torch.bfloat16)
                     for _ in range(2)]}
    pools["cuda"] = [p.to(dev) for p in pools["cpu"]]
    width = (h + 2 * kvh) * d
    steps = [(lens, [0] * b, lens)] + [([0] * b, [n + i for n in lens],
                                        [1] * b) for i in range(3)]
    for enc, dec, this in steps:
        qkv = torch.randn((sum(this), width), generator=g).bfloat16()
        outs = {}
        for where in ("cpu", "cuda"):
            before = pa.LAUNCHES_DECODE.count
            outs[where] = IF.block_multihead_attention(
                qkv.to(where), *pools[where], torch.tensor(enc),
                torch.tensor(dec), torch.tensor(this),
                block_tables=tables.to(where), rope_emb=rope.to(where),
                block_size=bs, num_heads=h, num_kv_heads=kvh)
            n = pa.LAUNCHES_DECODE.count - before
            assert n == (int(where == "cuda") if dec[0] else 0)
        torch.cuda.synchronize()
        torch.testing.assert_close(outs["cuda"][0].float().cpu(),
                                   outs["cpu"][0].float(), atol=2e-2,
                                   rtol=2e-2)


def test_mixed_dtype_fused_rms_norm_weight_raises_on_card():
    """The RMSNorm kernel takes the weight in x's dtype only (the JAX
    package's Pallas kernel refuses an f32 weight on 16-bit x as well):
    `fused_rms_norm` raises before any launch."""
    dev = _card()
    import paddle_tpu_torch.incubate.nn.functional as IF

    x = torch.zeros((4, 64), dtype=torch.bfloat16, device=dev)
    before = rn.LAUNCHES.count
    with pytest.raises(ValueError, match="weight must be"):
        IF.fused_rms_norm(x, torch.ones(64, device=dev))
    with pytest.raises(ValueError, match="w must be"):
        rn.rms_norm(x, torch.ones(64, device=dev))
    assert rn.LAUNCHES.count == before


# ---- flash attention never runs plain on the card where JAX has a kernel

def test_head_dim_256_launches_flash_or_raises_never_plain(monkeypatch):
    """D = 256 bf16 (the JAX rule gives it to its kernel; the port's
    kernels take D <= 128): `F.scaled_dot_product_attention` on CUDA
    tensors launches `flash_attention_fwd` or raises, and never runs the
    plain `_sdpa_fn`."""
    dev = _card()
    from paddle_tpu_torch.nn import functional as F
    from paddle_tpu_torch.nn.functional import attention

    def plain(*a, **k):
        raise AssertionError("_sdpa_fn ran on CUDA tensors")

    monkeypatch.setattr(attention, "_sdpa_fn", plain)
    g = torch.Generator(device=dev).manual_seed(0)
    q, k, v = (torch.randn((1, 64, 2, 256), generator=g, device=dev)
               .to(torch.bfloat16) for _ in range(3))
    before = fa.LAUNCHES_FWD.count
    try:
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    except NotImplementedError as e:
        assert "head dim 256" in str(e)
        assert fa.LAUNCHES_FWD.count == before
    else:
        torch.cuda.synchronize()
        assert fa.LAUNCHES_FWD.count == before + 1
        assert out.shape == q.shape


# ---- MoE dispatch and gather ----

from paddle_tpu_torch.ops.kernels import fused_moe as fmk  # noqa: E402

# (rows N, width H, experts E, capacity C): fits, drops, odd widths
_MOE_CASES = [(64, 128, 4, 32), (64, 128, 4, 6), (40, 4100, 3, 8),
              (33, 5, 3, 8), (48, 100, 2, 16)]


def _moe_routing(dev, n, e, c, seed=0):
    rng = np.random.default_rng(seed)
    e_idx = rng.integers(0, e, n).astype(np.int32)
    p_idx = np.full(n, -1, np.int32)
    counts = [0] * e
    for i in rng.permutation(n):
        if counts[e_idx[i]] < c:
            p_idx[i] = counts[e_idx[i]]
            counts[e_idx[i]] += 1
    return torch.from_numpy(e_idx).to(dev), torch.from_numpy(p_idx).to(dev)


@pytest.mark.parametrize("dtype", _DTYPES, ids=_DTYPE_IDS)
@pytest.mark.parametrize("case", _MOE_CASES, ids=str)
def test_moe_kernels_bit_equal_plain_and_index_routes(case, dtype,
                                                      monkeypatch):
    """Forward and backward of both kernels against their plain versions
    and the index-op route, `torch.equal`; CUDA tensors never run the
    plain versions, and each call launches once."""
    dev = _card()
    n, h, e, c = case
    e_idx, p_idx = _moe_routing(dev, n, e, c)
    g = torch.Generator(device=dev).manual_seed(1)
    x = torch.randn((n, h), generator=g, device=dev).to(dtype)
    buf = torch.randn((e, c, h), generator=g, device=dev).to(dtype)
    refs = {"d": fmk.moe_dispatch_ref(x, e_idx, p_idx, e, c),
            "g": fmk.moe_gather_ref(buf, e_idx, p_idx)}

    def plain(*a, **k):
        raise AssertionError("a plain version ran on CUDA tensors")

    monkeypatch.setattr(fmk, "moe_dispatch_ref", plain)
    monkeypatch.setattr(fmk, "moe_gather_ref", plain)
    before = (fmk.LAUNCHES_DISPATCH.count, fmk.LAUNCHES_GATHER.count)
    xr = x.clone().requires_grad_()
    br = buf.clone().requires_grad_()
    d = fmk.moe_dispatch(xr, e_idx, p_idx, e, c)
    r = fmk.moe_gather(br, e_idx, p_idx)
    gd = torch.randn((e, c, h), generator=g, device=dev).to(dtype)
    gr = torch.randn((n, h), generator=g, device=dev).to(dtype)
    d.backward(gd)
    r.backward(gr)
    torch.cuda.synchronize()
    assert (fmk.LAUNCHES_DISPATCH.count, fmk.LAUNCHES_GATHER.count) == \
        (before[0] + 2, before[1] + 2)
    assert torch.equal(d, refs["d"])
    assert torch.equal(d, fmk.xla_dispatch(x, e_idx, p_idx, e, c))
    assert torch.equal(r, refs["g"])
    assert torch.equal(r, fmk.xla_gather(buf, e_idx, p_idx))
    xi = x.clone().requires_grad_()
    fmk.xla_dispatch(xi, e_idx, p_idx, e, c).backward(gd)
    bi = buf.clone().requires_grad_()
    fmk.xla_gather(bi, e_idx, p_idx).backward(gr)
    assert torch.equal(xr.grad, xi.grad)
    assert torch.equal(br.grad, bi.grad)


def test_moe_kernels_stay_in_bounds_outside_the_contract():
    """Rows whose expert or slot falls outside [0, E) x [0, C) are neither
    written by the dispatch nor read by the gather (zeros), and a dropped
    row gathers exact zeros even where the clipped slot holds NaN (the
    closed divergence from the JAX kernel's multiply by 0)."""
    dev = _card()
    e, c, h = 2, 3, 8
    e_idx = torch.tensor([0, 1, 5, -1, 0, 1], dtype=torch.int32, device=dev)
    p_idx = torch.tensor([0, 2, 0, 1, 7, -1], dtype=torch.int32, device=dev)
    x = torch.arange(6 * h, dtype=torch.float32, device=dev).reshape(6, h) + 1
    out = fmk.moe_dispatch(x, e_idx, p_idx, e, c)
    want = torch.zeros((e, c, h), device=dev)
    want[0, 0], want[1, 2] = x[0], x[1]
    assert torch.equal(out, want)
    buf = torch.full((e, c, h), float("nan"), device=dev)
    buf[0, 0], buf[1, 2] = 1.0, 2.0
    rows = fmk.moe_gather(buf, e_idx, p_idx)
    torch.cuda.synchronize()
    assert torch.equal(rows[:2], buf[[0, 1], [0, 2]])
    assert torch.equal(rows[2:], torch.zeros((4, h), device=dev))


def test_moe_wrappers_refuse_what_the_kernels_do_not_take():
    dev = _card()
    x = torch.zeros((4, 8), device=dev)
    e_idx = torch.zeros(4, dtype=torch.int32, device=dev)
    p_idx = torch.arange(4, dtype=torch.int32, device=dev)
    before = (fmk.LAUNCHES_DISPATCH.count, fmk.LAUNCHES_GATHER.count)
    with pytest.raises(ValueError, match="int32"):
        fmk.moe_dispatch(x, e_idx.long(), p_idx, 1, 4)
    with pytest.raises(ValueError, match="one CUDA device"):
        fmk.moe_dispatch(x, e_idx.cpu(), p_idx, 1, 4)
    with pytest.raises(ValueError, match="int32"):
        fmk.moe_gather(torch.zeros((1, 4, 8), device=dev), e_idx,
                       p_idx[:3])
    assert (fmk.LAUNCHES_DISPATCH.count, fmk.LAUNCHES_GATHER.count) == before
    # nothing to write: no launch
    empty = fmk.moe_gather(torch.zeros((1, 4, 8), device=dev),
                           e_idx[:0], p_idx[:0])
    assert empty.shape == (0, 8)
    assert torch.equal(fmk.moe_dispatch(x[:0], e_idx[:0], p_idx[:0], 1, 4),
                       torch.zeros((1, 4, 8), device=dev))
    assert (fmk.LAUNCHES_DISPATCH.count, fmk.LAUNCHES_GATHER.count) == \
        (before[0] + 1, before[1])


def test_moe_ep_path_on_card_matches_cpu():
    """`_ep_moe_fn` with no group (an ep axis of one device) and the
    kernels on: the card against the CPU in f32, output, aux and every
    gradient within 1e-4 (cuBLAS and the CPU sum in other orders), the
    same routing, and exactly 2 dispatch and 2 gather launches."""
    dev = _card()
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.incubate.distributed.models.moe import moe_layer

    rng = np.random.default_rng(5)
    shapes = {"x": (64, 32), "gate_w": (32, 8), "w1": (8, 32, 64),
              "b1": (8, 1, 64), "w2": (8, 64, 32), "b2": (8, 1, 32)}
    arrs = {k: (0.5 * rng.normal(size=s)).astype(np.float32)
            for k, s in shapes.items()}
    outs = {}
    flags.set_flags({"FLAGS_fused_moe_kernels": True})
    try:
        for where in ("cpu", "cuda"):
            ts = {k: torch.tensor(v, device=where, requires_grad=True)
                  for k, v in arrs.items()}
            before = (fmk.LAUNCHES_DISPATCH.count, fmk.LAUNCHES_GATHER.count)
            y, aux = moe_layer._ep_moe_fn(*ts.values(), top_k=2,
                                          capacity=12, activation="gelu")
            (y.sum() + aux).backward()
            if where == "cuda":
                torch.cuda.synchronize()
                assert (fmk.LAUNCHES_DISPATCH.count,
                        fmk.LAUNCHES_GATHER.count) == (before[0] + 2,
                                                       before[1] + 2)
            outs[where] = [y, aux] + [t.grad for t in ts.values()]
    finally:
        flags.set_flags({"FLAGS_fused_moe_kernels": False})
    for a, b in zip(outs["cuda"], outs["cpu"]):
        torch.testing.assert_close(a.detach().cpu(), b.detach(), atol=1e-4,
                                   rtol=1e-4)


def test_lora_epilogue_bits_ignore_pool_size_and_neighbours():
    """A token's LoRA epilogue on the card (bf16, T 40, Rmax 8 at
    Llama-2-7B's qkv width) gives the same bits whatever the pool's slot
    count and whatever the other 39 tokens hold or point at."""
    from paddle_tpu_torch.serving.lora import _swap_lora, lora_mm

    def epilogue(xs, la, lb, ids):
        swapped = _swap_lora({"t": w}, {"t": {"a": la, "b": lb}}, ids, None)
        return lora_mm(xs, swapped["t"], lambda a, b: a @ b)

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(5)
    T, K, R, N = 40, 4096, 8, 12288
    x = torch.randn(T, K, generator=g, device=dev).to(torch.bfloat16)
    w = (torch.randn(K, N, generator=g, device=dev) * 0.02).to(torch.bfloat16)
    fa = torch.randn(K, R, generator=g, device=dev) * 0.05
    fb = torch.randn(R, N, generator=g, device=dev) * 0.05

    def run(slots, xs, slot):
        la = torch.randn(slots + 1, K, R, generator=g, device=dev) * 0.05
        lb = torch.randn(slots + 1, R, N, generator=g, device=dev) * 0.05
        la[slot], lb[slot] = fa, fb
        ids = torch.randint(0, slots, (T,), generator=g, device=dev)
        ids[7] = slot
        return epilogue(xs, la, lb, ids)[7]

    alone = torch.zeros_like(x)
    alone[7] = x[7]
    a = run(40, x, 23)
    assert torch.equal(a, run(2, x, 1))
    assert torch.equal(a, run(2, alone, 0))
    # the zero slot adds an exact zero
    z = epilogue(x, torch.zeros(3, K, R, device=dev),
                 torch.randn(3, R, N, generator=g, device=dev),
                 torch.full((T,), 2, device=dev))
    assert torch.equal(z, x @ w)


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_kv_migration_round_trip_bit_equal_on_card(kv_bits):
    """extract -> inject -> extract of a Llama engine's blocks on the card
    is bit-equal, leaves the source pools' bytes as they were, and the
    injected sequence's next step gives the source's logits."""
    from paddle_tpu_torch import LlamaInferenceEngine, llama_tiny

    dev = _card()
    model = llama_tiny(vocab=256, layers=2, hidden=256, heads=2, seq=512,
                       device="cpu", dtype=torch.bfloat16,
                       generator=torch.Generator().manual_seed(9))
    geo = dict(max_batch_size=2, num_blocks=32, block_size=16,
               max_blocks_per_seq=16, kv_bits=kv_bits, device=dev)
    src = LlamaInferenceEngine(model, **geo)
    dst = LlamaInferenceEngine(model, **geo)
    n = 45
    blocks = src.manager.allocate(0, n)
    tables = np.zeros((2, 16), np.int32)
    tables[0, :len(blocks)] = blocks
    toks = np.random.default_rng(2).integers(1, 256, n).astype(np.int32)
    src.ragged_step(toks, [n, 0], [n, 0], tables)
    before = [t.clone() for t in src._pools()]
    pay = src.extract_kv_blocks(0)
    assert all(torch.equal(a, b) for a, b in zip(before, src._pools()))
    dst.manager.allocate(9, 20)            # a different block layout
    dst.inject_kv_blocks(3, pay)
    back = dst.extract_kv_blocks(3)
    assert all(torch.equal(pay.slabs[k], back.slabs[k]) for k in pay.slabs)
    # one more token on each engine: the same logits
    outs = []
    for eng, sid in ((src, 0), (dst, 3)):
        eng.manager.append_token(sid)
        t = np.zeros((2, 16), np.int32)
        bl = eng.manager.blocks_of(sid)
        t[0, :len(bl)] = bl
        outs.append(eng.ragged_step(np.asarray([17], np.int32), [1, 0],
                                    [n + 1, 0], t)[0])
    assert torch.equal(outs[0], outs[1])


# ---------------------------------------------------------------------------
# the eager API over the kernels
# ---------------------------------------------------------------------------

def test_eager_attention_block_bit_equal_to_torch_direct():
    """The smoke run's `eager_attention` block at a reduced width (S 256,
    hidden 512, 4 heads of 128, bf16) in eager Tensors: one launch each of
    the flash forward, dQ, dK/dV and RMSNorm, and every gradient, the
    loss and `paddle.grad` of x bit-equal to the same calls on plain
    tensors under torch autograd; a second derivative through the flash
    kernels raises `KernelNotDifferentiableError`."""
    dev = _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools import eager_workload as ew

    with place.device_scope("gpu"):
        x, w = ew.block_inputs(1, 256, 512, 4, dev, torch.bfloat16, seed=2)
        X = paddle.Tensor(x, stop_gradient=False)
        W = {n: paddle.Tensor(t, stop_gradient=False) for n, t in w.items()}
        xt = x.clone().requires_grad_()
        wt = {n: t.clone().requires_grad_() for n, t in w.items()}
        _support.reset_launch_counts()
        le = ew.eager_block(paddle, X, W, 4)
        le.backward()
        torch.cuda.synchronize()
        assert {c: _support.launch_counter(c).count for c in (
            "flash_attention_fwd", "flash_attention_dq",
            "flash_attention_dkv", "rms_norm")} == dict.fromkeys(
                ("flash_attention_fwd", "flash_attention_dq",
                 "flash_attention_dkv", "rms_norm"), 1)
        lt = ew.torch_block(xt, wt, 4)
        lt.backward()
        assert torch.equal(le._data, lt.detach())
        assert torch.equal(X.grad._data, xt.grad)
        for n in w:
            assert torch.equal(W[n].grad._data, wt[n].grad), n
        (gx,) = paddle.grad(ew.eager_block(paddle, X, W, 4), [X])
        (gxt,) = torch.autograd.grad(ew.torch_block(xt, wt, 4), [xt])
        assert torch.equal(gx._data, gxt)
        q = paddle.Tensor(x[..., :128].reshape(1, 256, 1, 128).float(),
                          stop_gradient=False)
        out = paddle.nn.functional.scaled_dot_product_attention(
            q, q, q, is_causal=True)
        with pytest.raises(_support.KernelNotDifferentiableError):
            paddle.grad(out.sum(), [q], create_graph=True)


@pytest.mark.parametrize("low,high", [(-2 ** 40, 2 ** 40),
                                      (-2 ** 62, 2 ** 62 + 3),
                                      (-2 ** 63, 2 ** 63 - 1)])
def test_seeded_randint_past_2_31_on_card_equals_cpu(low, high):
    """A seeded randint over a span past 2^31 is drawn and reduced on the
    card (in 32-bit words) to the CPU's values."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place

    out = {}
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            paddle.seed(11)
            out[dev] = paddle.randint(low, high, [4096])
    assert out["gpu"].place == paddle.CUDAPlace(0)
    assert torch.equal(out["gpu"]._data.cpu(), out["cpu"]._data)


# ---- the paddle-style model path: captured programs on the card ----

def _launched():
    from paddle_tpu_torch.ops.kernels import _support

    counts = {c.name: c.count for c in _support._COUNTERS.values()
              if c.count}
    _support.reset_launch_counts()
    return counts


def test_cpu_saved_program_launches_the_kernels_on_the_card(tmp_path):
    """A program `jit.save`d from CPU tensors (an attention block: one
    RMSNorm, one causal attention, head dim 32), loaded on the card
    (`jit.load` and the `Predictor`): every call launches the flash
    forward and the RMSNorm kernel exactly once, and matches the CPU's
    output within 1e-5."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import jit_workload as jw

    prefix = str(tmp_path / "attention")
    x = np.random.default_rng(0).standard_normal((2, 16, 64)).astype(
        np.float32)
    with place.device_scope("cpu"):
        block = jw.reference_models(paddle)["attention"]
        block.eval()
        paddle.jit.save(block, prefix, input_spec=[
            paddle.jit.InputSpec([None, 16, 64], "float32")])
        ref = block(paddle.to_tensor(x)).numpy()
    with place.device_scope("gpu"):
        loaded = paddle.jit.load(prefix)
        predictor = paddle.inference.create_predictor(
            paddle.inference.Config(prefix + ".pdmodel",
                                    prefix + ".pdiparams"))
        xt = paddle.to_tensor(x)
        for fn in (lambda: loaded(xt), lambda: predictor.run([xt])[0]):
            fn()
            torch.cuda.synchronize()
            _launched()
            outs = [fn() for _ in range(2)]
            torch.cuda.synchronize()
            assert _launched() == {"flash_attention_fwd": 2, "rms_norm": 2}
            for o in outs:
                assert o.place == paddle.CUDAPlace(0)
                np.testing.assert_allclose(o.numpy(), ref, rtol=1e-5,
                                           atol=1e-5)


def test_to_static_training_step_on_card_launches_and_matches_eager():
    """A decoder layer (f32, head dim 32) trained one step eagerly and one
    through `jit.to_static` on the card: one flash forward, dQ, dK/dV and
    two RMSNorm launches a step either way, the same loss and gradients
    (within 1e-5 of each gradient's largest value)."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools.eager_workload import decoder_layer

    x = np.random.default_rng(1).standard_normal((2, 16, 64)).astype(
        np.float32)
    runs = []
    with place.device_scope("gpu"):
        for static in (False, True):
            paddle.seed(5)
            layer = decoder_layer(paddle, 64, 2, 96, 16)
            fwd = paddle.jit.to_static(layer) if static else layer
            torch.cuda.synchronize()
            _launched()
            loss = (fwd(paddle.to_tensor(x)) ** 2).mean()
            loss.backward()
            torch.cuda.synchronize()
            assert _launched() == {"flash_attention_fwd": 1,
                                   "flash_attention_dq": 1,
                                   "flash_attention_dkv": 1, "rms_norm": 2}
            runs.append((float(loss), [p.grad.numpy()
                                       for p in layer.parameters()]))
    (le, ge), (ls, gs) = runs
    assert abs(le - ls) <= 1e-5 * abs(le)
    for a, b in zip(gs, ge):
        np.testing.assert_allclose(a, b, rtol=0,
                                   atol=1e-5 * np.abs(b).max())


def test_lazy_region_replayed_on_card_equals_eager_with_exact_launches():
    """A two-layer Llama in paddle Layers (f32, head dim 16) trained three
    AdamW steps eagerly and three under lazy mode from the same seed: the
    lazy step is one region, run eagerly at its first sight, captured as
    one CUDA graph (forward and backward) at its second and replayed at
    its third; every step launches the flash forward, dQ and dK/dV once a
    layer and the RMSNorm kernel twice a layer and once more, and the
    losses and gradients match the eager run's."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import monitor, place
    from paddle_tpu_torch.models.llama_layers import llama_tiny

    rng = np.random.default_rng(3)
    ids_np, labs_np = (rng.integers(0, 256, (2, 16)) for _ in range(2))
    want = {"flash_attention_fwd": 2, "flash_attention_dq": 2,
            "flash_attention_dkv": 2, "rms_norm": 5}
    runs = {}
    with place.device_scope("gpu"):
        for on in (False, True):
            lazy.clear_graphs()
            paddle.seed(7)
            model = llama_tiny(seq=16)
            opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                         parameters=model.parameters())
            ids, labs = paddle.to_tensor(ids_np), paddle.to_tensor(labs_np)
            losses, grads = [], []
            c0 = monitor.snapshot("lazy.")
            with lazy.lazy_guard(on):
                for _ in range(3):
                    torch.cuda.synchronize()
                    _launched()
                    loss, _ = model(ids, labels=labs)
                    loss.backward()
                    grads.append([p.grad.numpy() for p in model.parameters()])
                    opt.step()
                    opt.clear_grad()
                    torch.cuda.synchronize()
                    assert _launched() == want
                    # kept with its tape: the next capture must not touch
                    # the parameters' accumulators this tape holds
                    losses.append(loss)
            c1 = monitor.snapshot("lazy.")
            runs[on] = [float(v) for v in losses], grads, {
                k: v - c0.get(k, 0) for k, v in c1.items()}
    (le, ge, _), (ll, gl, moved) = runs[False], runs[True]
    np.testing.assert_allclose(ll, le, rtol=1e-5)
    for step_e, step_l in zip(ge, gl):
        for a, b in zip(step_l, step_e):
            np.testing.assert_allclose(a, b, rtol=0,
                                       atol=1e-5 * np.abs(b).max())
    assert moved.get("lazy.graph_first_sight") == 1
    assert moved.get("lazy.graph_captures") == 1
    assert moved.get("lazy.graph_replays") == 2
    assert moved.get("lazy.uncaptured_replays") == 1
    lazy.clear_graphs()


def test_graph_evicted_from_the_bounded_cache_frees_its_memory():
    """With room for one graph, capturing a second region evicts the
    first: the first graph's static output (64 MiB) is freed, and with
    every graph cleared the pool goes back to the card."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import place

    lazy.clear_graphs()
    torch.cuda.synchronize()
    torch.cuda.empty_cache()
    reserved0 = torch.cuda.memory_reserved()
    limit = lazy.GRAPH_LIMIT
    lazy.GRAPH_LIMIT = 1
    try:
        with place.device_scope("gpu"):
            big = paddle.ones([4096, 4096])
            small = paddle.ones([8])
            with lazy.lazy_guard():
                for _ in range(2):      # seen twice: captured
                    (big * 2.0).numpy()
            (nbytes,) = lazy.graph_bytes()
            assert nbytes >= 4096 * 4096 * 4
            torch.cuda.synchronize()
            before = torch.cuda.memory_allocated()
            with lazy.lazy_guard():
                for _ in range(2):
                    (small + 1.0).numpy()
            torch.cuda.synchronize()
            assert len(lazy.graph_bytes()) == 1
            assert torch.cuda.memory_allocated() <= before - 4096 * 4096 * 4
        lazy.clear_graphs()
        del big, small
        torch.cuda.synchronize()
        torch.cuda.empty_cache()
        assert torch.cuda.memory_reserved() <= reserved0 + (2 << 20)
    finally:
        lazy.GRAPH_LIMIT = limit


def test_lazy_dropout_replays_draw_the_eager_masks_on_card():
    """Dropout under lazy mode on the card, four calls: run eagerly at the
    region's first sight, captured at its second, replayed after. Its key
    is an input of the graph, so every call draws a new mask, the one an
    eager call from the same seed draws."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import monitor, place

    outs, moved = {}, {}
    with place.device_scope("gpu"):
        x = paddle.ones([64, 128])
        for on in (False, True):
            lazy.clear_graphs()
            paddle.seed(11)
            c0 = monitor.snapshot("lazy.")
            with lazy.lazy_guard(on):
                outs[on] = [paddle.nn.functional.dropout(x, 0.5).numpy()
                            for _ in range(4)]
            c1 = monitor.snapshot("lazy.")
            moved[on] = {k: v - c0.get(k, 0) for k, v in c1.items()}
    for a, b in zip(outs[False], outs[True]):
        np.testing.assert_array_equal(b, a)
    assert len({m.tobytes() for m in outs[True]}) == 4
    assert moved[True].get("lazy.graph_first_sight") == 1
    assert moved[True].get("lazy.graph_captures") == 1
    assert moved[True].get("lazy.graph_replays") == 3
    lazy.clear_graphs()


def _launch_delta():
    from paddle_tpu_torch.ops.kernels import _support

    counts = {c.name: c.count for c in _support._COUNTERS.values()}
    _support.reset_launch_counts()
    return {n: k for n, k in counts.items() if k}


def test_flash_attention_apis_bit_equal_to_sdpa_on_card():
    """`flash_attention` and `flash_attn_qkvpacked` (B 2, S 256, 4 heads
    of 64, causal bf16): outputs and gradients bit-equal to
    `scaled_dot_product_attention`, one launch each of the flash forward,
    dQ and dK/dV; a causal bool mask takes the composite, launching
    nothing, within 2e-2 of the kernel."""
    dev = _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import loop_workload as lw

    g = torch.Generator(device=dev).manual_seed(4)
    q, k, v, dout = (torch.randn((2, 256, 4, 64), generator=g,
                                 device=dev).to(torch.bfloat16)
                     for _ in range(4))
    with place.device_scope("gpu"):
        report, total = lw.attention_routes(paddle, q, k, v, dout,
                                            torch.cuda.synchronize,
                                            _launch_delta, 2e-2)
    assert total == dict.fromkeys(lw.ROUTE_ONE, 3)
    assert report["masked_causal"]["launches"] == 0


def test_train_loop_small_on_card_equals_cpu():
    """The Trainer loop on `llama_tiny` Layers (3 steps) and the eight new
    optimizers (2 steps each) on the card against the CPU: losses,
    pre-clip norms and learning rates within 1e-5 relative, parameters
    within 1e-5 norm-relative."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import loop_workload as lw

    runs = {}
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            runs[dev] = lw.reference_run(paddle)
    gpu, cpu = runs["gpu"], runs["cpu"]
    for part in ("losses", "norms", "lrs"):
        np.testing.assert_allclose(gpu["loop"][part], cpu["loop"][part],
                                   rtol=1e-5, atol=1e-7, err_msg=part)
    for n, w in cpu["loop"]["params"].items():
        assert np.linalg.norm(gpu["loop"]["params"][n] - w) \
            <= 1e-5 * np.linalg.norm(w), n
    for name, w in cpu["optimizers"].items():
        g = gpu["optimizers"][name]
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-5)
        for a, b in zip(g["params"], w["params"]):
            assert np.linalg.norm(a - b) <= 1e-5 * np.linalg.norm(b), name


def test_embedding_backward_repeats_bit_for_bit():
    """`nn.functional.embedding`'s backward on the card sums duplicate ids
    in a fixed order (torch's own varied from run to run on BERT's two
    token types), so two runs give the same bits."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place

    dev = _card()
    g = torch.Generator(device=dev).manual_seed(7)
    ids = torch.randint(0, 2, (32, 512), generator=g, device=dev)
    dout = torch.randn((32, 512, 768), generator=g, device=dev) \
        .to(torch.bfloat16)
    w0 = torch.randn((2, 768), generator=g, device=dev).to(torch.bfloat16)
    grads = []
    with place.device_scope("gpu"):
        for _ in range(3):
            w = paddle.Tensor(w0, stop_gradient=False)
            out = paddle.nn.functional.embedding(paddle.Tensor(ids), w)
            out.backward(paddle.Tensor(dout))
            grads.append(w.grad._data.clone())
    want = (dout.float().reshape(-1, 768).T
            @ torch.nn.functional.one_hot(ids.reshape(-1), 2).float()).T
    assert torch.equal(grads[0], grads[1]) and torch.equal(grads[0],
                                                           grads[2])
    assert _rel(grads[0], want) <= 1e-2


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16],
                         ids=["f32", "bf16"])
def test_quant_matmul_gradient_on_card_equals_cpu(dtype):
    """Row 11 is differentiable in x by JAX's rule on the card as on the
    CPU: the cotangent `g @ (wq * scale)` in g's dtype, a plain matmul;
    the weights get none. The CPU's gradient is that formula's bits; the
    card's is within one rounding of it (another gemm's summation)."""
    dev = _card()
    g = torch.Generator().manual_seed(3)
    x = torch.randn(48, 256, generator=g).to(dtype)
    wq = torch.randint(-127, 128, (384, 256), generator=g,
                       dtype=torch.int8)
    s = torch.rand(384, generator=g) * 0.02 + 1e-3
    ct = torch.randn(48, 384, generator=g).to(dtype)
    grads = []
    for d in ("cpu", dev):
        xt = x.to(d).detach().clone().requires_grad_()
        out = qm.quant_matmul(xt, wq.to(d), s.to(d))
        out.backward(ct.to(d))
        assert wq.grad is None
        grads.append(xt.grad.float().cpu())
    want = ct @ (wq.to(dtype) * s[:, None].to(dtype))
    assert torch.equal(grads[0], want.float())
    err = float((grads[1] - grads[0]).norm() / grads[0].norm())
    assert err <= TOL[dtype], err


def test_quant_matmul_int4_backward_raises_on_card():
    """Row 12 is forward-only, as JAX's int4 gemm: a backward through the
    kernel raises the typed error instead of losing x's gradient."""
    from paddle_tpu_torch.ops.kernels import _support

    dev = _card()
    g = torch.Generator().manual_seed(4)
    x = torch.randn(32, 256, generator=g).to(torch.bfloat16).to(dev)
    q = torch.randint(-7, 8, (128, 256), generator=g, dtype=torch.int8)
    wp = nq.pack_int4(q).to(dev)
    s = (torch.rand(128, generator=g) * 0.02 + 1e-3).to(dev)
    xt = x.requires_grad_()
    out = qm.quant_matmul_int4(xt, wp, s)
    with pytest.raises(_support.KernelNotDifferentiableError):
        out.float().sum().backward()
    with torch.no_grad():
        torch.testing.assert_close(
            qm.quant_matmul_int4(x, wp, s).float(),
            qm.quant_matmul_int4_ref(x.cpu(), wp.cpu(), s.cpu()).float()
            .to(dev), rtol=2e-2, atol=2e-2)


def test_selected_rows_merge_repeats_bit_for_bit_on_card():
    """The sparse embedding gradient's merge (duplicates summed in
    sorted-id order by index_put_) gives the same bits on every call on
    the card, and the CPU's sums within float rounding."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows, merge_rows

    dev = _card()
    g = torch.Generator().manual_seed(5)
    rows = torch.randint(0, 50, (4096,), generator=g, dtype=torch.int32)
    vals = torch.randn(4096, 64, generator=g).to(torch.bfloat16)
    runs = [merge_rows(rows.to(dev), vals.to(dev), 100) for _ in range(4)]
    for u, m in runs[1:]:
        assert torch.equal(u, runs[0][0]) and torch.equal(m, runs[0][1])
    u_cpu, m_cpu = merge_rows(rows, vals, 100)
    assert torch.equal(runs[0][0].cpu(), u_cpu)
    torch.testing.assert_close(runs[0][1].float().cpu(), m_cpu.float(),
                               rtol=1e-2, atol=1e-2)
    dense = SelectedRows(rows.to(dev), vals.to(dev), 100).to_dense()
    assert torch.equal(dense[u_cpu.long().to(dev)], runs[0][1])


def test_sparse_embedding_under_lazy_mode_on_card_equals_eager():
    """The small Layer Llama with `Embedding(sparse=True)` and
    AdamW(lazy_mode=True), three steps eagerly and three under lazy mode
    on the card: the sparse lookup runs at once, the rest of the step is
    a region (captured as a CUDA graph at its second sight), the word
    embedding's gradient is a SelectedRows either way, and the losses
    and the parameters after the steps match the eager run's."""
    _card()
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.models.llama_layers import llama_tiny

    rng = np.random.default_rng(4)
    ids_np, labs_np = (rng.integers(0, 256, (2, 16)) for _ in range(2))
    runs = {}
    with place.device_scope("gpu"):
        for on in (False, True):
            lazy.clear_graphs()
            paddle.seed(7)
            model = llama_tiny(seq=16)
            model.llama.embed_tokens._sparse = True
            opt = paddle.optimizer.AdamW(learning_rate=1e-3, lazy_mode=True,
                                         parameters=model.parameters())
            ids, labs = paddle.to_tensor(ids_np), paddle.to_tensor(labs_np)
            losses = []
            with lazy.lazy_guard(on):
                for _ in range(3):
                    loss, _ = model(ids, labels=labs)
                    loss.backward()
                    assert isinstance(model.llama.embed_tokens.weight.grad,
                                      SelectedRows)
                    opt.step()
                    opt.clear_grad()
                    losses.append(loss)
            runs[on] = ([float(v) for v in losses],
                        [p.numpy() for p in model.parameters()])
    (le, pe), (ll, pl) = runs[False], runs[True]
    np.testing.assert_allclose(ll, le, rtol=1e-5)
    for a, b in zip(pl, pe):
        np.testing.assert_allclose(a, b, rtol=0, atol=1e-4 * np.abs(b).max())
    lazy.clear_graphs()
