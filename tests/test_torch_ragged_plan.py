"""The ragged kernels' host-side plan (`ops/kernels/paged_attention.py`
`ragged_plan`) and the split instance's partition, without a card:

- every shape `ragged_supported` admits gets a valid instance, the
  serving shapes and pages of any multiple of 16 slots get the split one;
- the tiles (the kernel's leader rule, `ragged_tiles` here) cover every
  live packed token once, and each tile's sub-pages of 16 slots, dealt to
  a cluster's ranks by stream (`rank_pages`), cover the ones its rows need
  exactly once, at kv_len 1, 15, 16, 17 and W * BS;
- a verify window's tiles, found from the lanes' kv_lens alone
  (`window_tiles`, the kernel's window mode), are the packed rule's tiles
  of the same window and cover each live row once, within the plan's
  slots;
- a plain-PyTorch emulation of the split (four streams of sub-pages, an
  online softmax each, on whichever rank) and of its stream-order combine
  matches `paged_attention_ragged_ref` / `paged_attention_verify_ref` and
  the JAX package's `paged_attention_ragged` / `paged_attention_verify`
  (the Pallas kernels in interpret mode) within f32 rounding (1e-5: they
  differ only in summation order), and gives the same bits over a pool of
  64-slot pages as over the same keys in 16-slot pages.

The host mirrors of the kernel's rules and the emulation live here:
nothing on the main path runs them."""
import math

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as pa
from paddle_tpu_torch.tools.kernel_compare import as_16_slot_pages

ATOL = RTOL = 1e-5
SMEM_MAX = 232448
SERVE = dict(tokens=40, heads=32, kv_heads=32, head_dim=128, block_size=16,
             table_width=128, lanes=8)


@pytest.fixture
def interpret():
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": False})


# ---- the kernel's tile and page rules, on the host ----

def _sub_pages(p_last, length, table_width, block_size):
    """The sub-pages of 16 slots a tile reads: those up to its last
    token's (at p_last), cut at the kv_len gate (page j while j * BS <
    kv_len) and the table width, in sub-pages."""
    kp = block_size // 16
    if length <= 0:
        return 0
    return min(p_last // 16 + 1, -(-length // block_size) * kp,
               table_width * kp)


def ragged_tiles(tok_lane, tok_pos, kv_lens, table_width, tile_tokens,
                 block_size=16):
    """The split instance's tiles, by the rule the kernel applies on the
    card (the scan in csrc/ragged_paged_attention.cu
    `ragged_split_kernel`): [(slot, tokens, first position, lane,
    sub-pages)] in slot order. A tile is up to `tile_tokens` consecutive
    packed tokens of one lane at consecutive positions, cut where kv_len -
    pos is a multiple of `tile_tokens`; it reads sub-pages 0 .. its last
    token's (`_sub_pages`). Lists of ints in."""
    m_tok = tile_tokens

    def lead(t):
        p = tok_pos[t]
        if p < 0:
            return False
        cont = (t > 0 and tok_pos[t - 1] >= 0 and tok_pos[t - 1] == p - 1
                and tok_lane[t - 1] == tok_lane[t])
        return not cont or (kv_lens[tok_lane[t]] - p) % m_tok == 0

    tiles = []
    for t in range(len(tok_pos)):
        if not lead(t):
            continue
        p0, ln = tok_pos[t], tok_lane[t]
        length = kv_lens[ln]
        cap = (length - p0) % m_tok or m_tok
        m = 1
        while (m < cap and t + m < len(tok_pos) and tok_pos[t + m] == p0 + m
               and tok_lane[t + m] == ln):
            m += 1
        tiles.append((t, m, p0, ln, _sub_pages(p0 + m - 1, length,
                                               table_width, block_size)))
    return tiles


def window_tiles(ctx_lens, window, table_width, tile_tokens,
                 block_size=16):
    """The tiles of the kernel's window mode (null tok_lane / tok_pos),
    found from the lanes' kv_lens alone as the kernel's lane scan does:
    slot t is query t % S of lane t / S at kv_len - S + t % S; lane b's
    live rows are its last lv = min(kv_len, S), cut into nt = ceil(lv / M)
    tiles, tile k starting at row max(S - lv, S - (nt - k) M). Same
    tuples as `ragged_tiles`."""
    s, m_tok = window, tile_tokens
    tiles = []
    for b, n in enumerate(ctx_lens):
        lv = min(max(n, 0), s)
        nt = -(-lv // m_tok)
        for k in range(nt):
            r0 = max(s - lv, s - (nt - k) * m_tok)
            r1 = s - (nt - 1 - k) * m_tok
            p0 = n - s + r0
            tiles.append((b * s + r0, r1 - r0, p0, b,
                          _sub_pages(p0 + r1 - r0 - 1, n, table_width,
                                     block_size)))
    return tiles


def rank_pages(pages, splits, rank):
    """The pages of cluster rank `rank` of `splits`, as the kernel deals
    them: the streams s = rank (mod splits), pages rank, rank + splits,
    ..."""
    return list(range(rank, pages, splits))


# ---- the plan ----

@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
@pytest.mark.parametrize("sms", [132, 114, 1])
@pytest.mark.parametrize("kv_heads", [32, 8])
def test_serving_shapes_take_the_split_instance(kv_heads, sms, int8):
    p = pa.ragged_plan(**dict(SERVE, kv_heads=kv_heads),
                       dtype=torch.bfloat16, int8=int8, sms=sms)
    g = SERVE["heads"] // kv_heads
    assert p.splits in pa.PLAN_SPLITS
    if sms == 132:      # an H100: the split kernel_compare's sweep favours
        assert p.splits == {32: 1, 8: 2}[kv_heads]
    assert p.tile_tokens == 16 * p.splits // g
    # 8 lanes of T = 40 slots make at most 8 + 32 // tile_tokens tiles
    assert p.slots == 8 + 32 // p.tile_tokens
    assert p.stages == 8 and p.smem_bytes <= SMEM_MAX
    assert p.ctas == p.slots * kv_heads * p.splits


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
@pytest.mark.parametrize("int8", [False, True], ids=["pool", "int8"])
@pytest.mark.parametrize("head_dim", list(range(8, 257, 8)))
def test_every_admitted_shape_gets_a_valid_instance(head_dim, int8, dtype):
    assert pa.ragged_supported((4, 8, head_dim), dtype)
    for tokens, heads, kv_heads, bs, width, lanes, sms in (
            (40, 32, 32, 16, 128, 8, 132), (40, 32, 8, 16, 128, 8, 132),
            (1, 4, 4, 16, 1, 1, 132), (16, 8, 2, 4, 5, 5, 132),
            (16, 6, 2, 6, 5, 5, 78), (300, 128, 1, 16, 3, 2, 132),
            (7, 64, 1, 16, 300, 7, 1), (2048, 8, 8, 8, 32, 1, 114)):
        p = pa.ragged_plan(tokens, heads, kv_heads, head_dim, bs, width,
                           lanes, dtype, int8, sms)
        g = heads // kv_heads
        split = (dtype == torch.bfloat16 and bs % 16 == 0 and g <= 64
                 and (head_dim == 128 or (head_dim == 64 and not int8)))
        assert (p.splits > 0) == split
        if split:
            assert p.splits in pa.PLAN_SPLITS
            assert 1 <= p.tile_tokens and p.tile_tokens * g <= 16 * p.splits
            assert 1 <= p.slots <= tokens
            assert p.smem_bytes <= SMEM_MAX
        else:
            # the general instance: one CTA per packed token and kv head
            assert (p.tile_tokens, p.slots) == (1, tokens)
            assert p.ctas == tokens * kv_heads
            item = 1 if int8 else dtype.itemsize
            assert p.smem_bytes == pa._smem_bytes(g, head_dim, bs, item,
                                                  int8)


@pytest.mark.parametrize("bs", [16, 32, 48, 64, 128, 256, 8, 24, 4])
@pytest.mark.parametrize("int8", [False, True], ids=["bf16", "int8"])
def test_page_sizes_take_the_right_instance(bs, int8):
    """Pages of any multiple of 16 slots take the split instance (it
    streams them as sub-pages of 16; the CTA's shared memory does not
    depend on the page size), others the general one."""
    p = pa.ragged_plan(**dict(SERVE, block_size=bs), dtype=torch.bfloat16,
                       int8=int8, sms=132)
    assert (p.splits > 0) == (bs % 16 == 0)
    if p.splits:
        assert p == pa.ragged_plan(**SERVE, dtype=torch.bfloat16, int8=int8,
                                   sms=132)


def test_unaligned_q_takes_the_general_instance():
    p = pa.ragged_plan(**SERVE, dtype=torch.bfloat16, int8=False, sms=132,
                       aligned=False)
    assert p.splits == 0


# ---- the partition ----

def _meta(q_lens, kv_lens, t):
    lane, pos = pa.ragged_metadata(torch.tensor(q_lens, dtype=torch.int32),
                                   torch.tensor(kv_lens, dtype=torch.int32),
                                   t)
    return lane.tolist(), pos.tolist()


W_BS = 8 * 16     # a table of 8 pages of 16 slots
PARTITION_CASES = [
    ([1, 1, 1, 1, 1], [1, 15, 16, 17, W_BS]),          # decode at the edges
    ([1, 15, 16, 17, 0], [1, 15, 16, 17, 0]),          # whole prompts
    ([5, 0, 33, 64], [5, 0, 50, W_BS]),                 # chunks, empty lane
    ([3, 17, 2], [W_BS, 40, 17]),
]


# (query heads a kv head, cluster size): tiles of 16 x splits // G tokens,
# 1 to 64
PLAN_CASES = [(g, c) for g in (1, 4, 16, 64) for c in pa.PLAN_SPLITS
              if g <= 16 * c]


@pytest.mark.parametrize("g,splits", PLAN_CASES)
@pytest.mark.parametrize("case", range(len(PARTITION_CASES)))
def test_tiles_and_pages_cover_each_need_once(case, g, splits):
    q_lens, kv_lens = PARTITION_CASES[case]
    t = sum(q_lens) + 3
    p = pa.ragged_plan(t, g, 1, 128, 16, 8, len(q_lens), torch.bfloat16,
                       False, 132, splits=splits)
    assert p.splits == splits and p.tile_tokens == 16 * splits // g
    lane, pos = _meta(q_lens, kv_lens, t)
    tiles = ragged_tiles(lane, pos, kv_lens, 8, p.tile_tokens)
    # every live token in exactly one tile, of at most tile_tokens tokens
    owner = {}
    for slot, m, p0, ln, pages in tiles:
        assert 1 <= m <= p.tile_tokens
        for i in range(m):
            assert slot + i not in owner
            assert lane[slot + i] == ln and pos[slot + i] == p0 + i
            owner[slot + i] = slot
        # the pages the tile's rows need: each row's up to its position,
        # cut at the kv_len gate and the table width
        need = set()
        for i in range(m):
            need |= set(range(min((p0 + i) // 16 + 1,
                                  -(-kv_lens[ln] // 16), 8)))
        assert set(range(pages)) == need
        got = [j for r in range(splits) for j in rank_pages(pages, splits, r)]
        assert sorted(got) == list(range(pages))         # each page once
        # a rank holds whole streams (page j in stream j % 4)
        for r in range(splits):
            assert {j % 4 for j in rank_pages(pages, splits, r)} <= \
                set(range(r, 4, splits))
    assert sorted(owner) == [s for s in range(t) if pos[s] >= 0]
    # the plan's clusters hold every tile of a well-formed packing
    assert len(tiles) <= p.slots


# a verify batch's context lengths: empty, shorter than every window,
# around a page's edge and the windows' sizes, the table's end
WINDOW_CTX = [0, 3, 5, 15, 16, 17, 40, 64, 65, 100, 8 * 16]


@pytest.mark.parametrize("g", [1, 4, 8])
@pytest.mark.parametrize("window", [1, 5, 16, 17, 64])
def test_window_tiles_cover_each_live_row_once(window, g):
    """The window mode's tiles (found from kv_lens) are the packed rule's
    tiles of the same windows, cover each live row (position >= 0) once
    and no dead one, and fit the plan's slots, at every cluster size."""
    b = len(WINDOW_CTX)
    t = b * window
    lane, pos = _meta([window] * b, WINDOW_CTX, t)
    for splits in pa.PLAN_SPLITS:
        if g > 16 * splits:
            continue
        p = pa.ragged_plan(t, g, 1, 128, 16, 8, b, torch.bfloat16, False,
                           132, splits=splits)
        tiles = window_tiles(WINDOW_CTX, window, 8, p.tile_tokens)
        assert tiles == ragged_tiles(lane, pos, WINDOW_CTX, 8,
                                     p.tile_tokens)
        rows = [slot + i for slot, m, *_ in tiles for i in range(m)]
        assert sorted(rows) == [s for s in range(t) if pos[s] >= 0]
        assert len(set(rows)) == len(rows)
        for slot, m, p0, ln, pages in tiles:
            assert 1 <= m <= p.tile_tokens and ln == slot // window
            assert p0 == WINDOW_CTX[ln] - window + slot % window >= 0
        assert len(tiles) <= p.slots


# ---- the split and its combine, emulated ----

def _online(q, k, v, rpos, pages, bs, sm_scale):
    """One page lane: an online softmax over `pages` (in order) for rows
    q [R, D] at positions rpos [R]: (m, l, acc), m = -inf where no key is
    live."""
    r, d = q.shape
    m = torch.full((r,), -math.inf)
    l = torch.zeros(r)
    acc = torch.zeros(r, d)
    for j in pages:
        keys = torch.arange(j * bs, (j + 1) * bs)
        s = (q @ k[j].T) * sm_scale
        s = torch.where(keys[None, :] <= rpos[:, None], s,
                        torch.full_like(s, -math.inf))
        m_new = torch.maximum(m, s.max(dim=1).values)
        m_use = torch.where(torch.isinf(m_new), torch.zeros_like(m_new),
                            m_new)
        alpha = torch.exp(m - m_use)
        p = torch.exp(s - m_use[:, None])
        l = l * alpha + p.sum(dim=1)
        acc = acc * alpha[:, None] + p @ v[j]
        m = m_new
    return m, l, acc


def _combine(parts):
    """Partials (m, l, acc) rescaled to their common max and summed in
    the given order."""
    mx = torch.stack([p[0] for p in parts]).max(dim=0).values
    mu = torch.where(torch.isinf(mx), torch.zeros_like(mx), mx)
    l = torch.zeros_like(parts[0][1])
    acc = torch.zeros_like(parts[0][2])
    for m, lp, ap in parts:
        w = torch.exp(m - mu)
        l = l + lp * w
        acc = acc + ap * w[:, None]
    return mx, l, acc


def _emulate(q, kc, vc, tables, kv_lens, lane, pos, splits, tile_tokens,
             window=0):
    """The split instance's arithmetic in f32: per tile and kv head, each
    rank's streams (sub-pages j of 16 slots with j % 4 = s, s = rank mod
    splits; sub-page j is rows 16 (j % k) .. + 15 of block table[j / k]
    for pages of 16 k slots), an online softmax each in order, the four
    combined in stream order; guard rows zero. `window` S > 0: the
    kernel's window mode (lane, pos unused; q [B * S, H, D])."""
    t, h, d = q.shape
    kvh, bs = kc.shape[1], kc.shape[2]
    g = h // kvh
    sm_scale = 1.0 / math.sqrt(d)
    out = torch.zeros(t, h, d)
    if window:
        tiles = window_tiles(kv_lens.tolist(), window, tables.shape[1],
                             tile_tokens, bs)
    else:
        tiles = ragged_tiles(lane.tolist(), pos.tolist(), kv_lens.tolist(),
                             tables.shape[1], tile_tokens, bs)
    for slot, m, p0, ln, pages in tiles:
        rows = m * g
        assert rows <= 16 * splits
        rpos = torch.tensor([p0 + i // g for i in range(rows)])
        blocks = tables[ln].long()
        for kh in range(kvh):
            qr = torch.stack([q[slot + i // g, kh * g + i % g]
                              for i in range(rows)]).float()
            # the lane's sub-pages [W * BS / 16, 16, D]
            k = kc[blocks, kh].float().reshape(-1, 16, d)
            v = vc[blocks, kh].float().reshape(-1, 16, d)
            streams = {}
            for r in range(splits):
                mine = rank_pages(pages, splits, r)
                for s in range(r, pa.PLAN_WARPS, splits):
                    streams[s] = _online(qr, k, v, rpos,
                                         [j for j in mine if j % 4 == s],
                                         16, sm_scale)
            _m, l, acc = _combine([streams[s]
                                   for s in range(pa.PLAN_WARPS)])
            o = acc / torch.where(l == 0, torch.ones_like(l), l)[:, None]
            for i in range(rows):
                out[slot + i // g, kh * g + i % g] = o[i]
    return out


EMULATION_CASES = {
    # name: (q_lens, kv_lens, heads, kv_heads, tile_tokens, splits)
    "decode_edges_mha": ([1, 1, 1, 1, 0, 1], [1, 15, 16, 17, 0, 128], 2, 2,
                         16, 1),
    "chunks_gqa": ([5, 17, 1, 0], [5, 40, 33, 0], 4, 2, 4, 4),
    "long_tile_one_kv_head": ([33, 2], [70, 128], 2, 1, 16, 2),
}


def _emulation_inputs(name, bs=16):
    q_lens, kv_lens, h, kvh, tile, splits = EMULATION_CASES[name]
    rng = np.random.default_rng(4)
    d, w = 16, 128 // bs
    t = sum(q_lens) + 2
    nb = len(q_lens) * w + 1
    tables = (1 + np.arange(len(q_lens) * w, dtype=np.int32)
              .reshape(len(q_lens), w))
    q = rng.normal(size=(t, h, d)).astype(np.float32)
    kc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    return q_lens, kv_lens, tables, q, kc, vc, tile, splits


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_split_emulation_matches_ref_and_jax(name, interpret):
    q_lens, kv_lens, tables, q, kc, vc, tile, splits = \
        _emulation_inputs(name)
    t = q.shape[0]
    lane, pos = pa.ragged_metadata(torch.tensor(q_lens, dtype=torch.int32),
                                   torch.tensor(kv_lens, dtype=torch.int32),
                                   t)
    args = (torch.from_numpy(q), torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(tables), torch.tensor(kv_lens,
                                                   dtype=torch.int32),
            lane, pos)
    emu = _emulate(*args, splits=splits, tile_tokens=tile)
    ref = pa.paged_attention_ragged_ref(*args)
    np.testing.assert_allclose(emu.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)
    jl, jp = jpa.ragged_metadata(jnp.asarray(q_lens, jnp.int32),
                                 jnp.asarray(kv_lens, jnp.int32), t)
    kern = np.asarray(jpa.paged_attention_ragged(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(kv_lens, jnp.int32), jl, jp))
    np.testing.assert_allclose(emu.numpy(), kern, atol=ATOL, rtol=RTOL)
    guard = pos.numpy() < 0
    assert guard.sum() == 2 and np.all(emu.numpy()[guard] == 0.0)


@pytest.mark.parametrize("name", list(EMULATION_CASES))
def test_split_emulation_64_slot_pages_same_bits(name):
    """The ragged emulation over a pool of 64-slot pages gives the same
    bits as over the same keys in 16-slot pages (`as_16_slot_pages`)."""
    q_lens, kv_lens, tables, q, kc, vc, tile, splits = \
        _emulation_inputs(name, bs=64)
    t = q.shape[0]
    lane, pos = pa.ragged_metadata(torch.tensor(q_lens, dtype=torch.int32),
                                   torch.tensor(kv_lens, dtype=torch.int32),
                                   t)
    pool = (torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(tables))
    lens = torch.tensor(kv_lens, dtype=torch.int32)
    out64 = _emulate(torch.from_numpy(q), *pool, lens, lane, pos,
                     splits=splits, tile_tokens=tile)
    out16 = _emulate(torch.from_numpy(q), *as_16_slot_pages(*pool), lens,
                     lane, pos, splits=splits, tile_tokens=tile)
    assert torch.equal(out64, out16)
    ref = pa.paged_attention_ragged_ref(torch.from_numpy(q), *pool, lens,
                                        lane, pos)
    np.testing.assert_allclose(out64.numpy(), ref.numpy(), atol=ATOL,
                               rtol=RTOL)


VERIFY_CASES = {
    # name: (ctx_lens, S, heads, kv_heads, page slots, splits)
    "s5_mha": ([0, 3, 5, 17, 40], 5, 2, 2, 16, 1),
    "s17_gqa4_bs64": ([10, 17, 70, 0, 128], 17, 8, 2, 64, 2),
    "s64_gqa8_bs32": ([64, 100, 3, 128], 64, 8, 1, 32, 4),
    "s1_decode_bs64": ([1, 15, 16, 17, 0, 128], 1, 4, 4, 64, 1),
}


@pytest.mark.parametrize("name", list(VERIFY_CASES))
def test_verify_emulation_matches_ref_and_jax(name, interpret):
    """The split instance's window mode, emulated: live rows match
    `paged_attention_verify_ref` and the JAX verify kernel (interpret
    mode) within f32 rounding, dead rows (position < 0) are zeros, and
    the pool in 16-slot pages gives the same bits."""
    ctx, s, h, kvh, bs, splits = VERIFY_CASES[name]
    rng = np.random.default_rng(6)
    d, w = 16, 128 // bs
    b = len(ctx)
    nb = b * w + 1
    tables = (1 + rng.permutation(b * w)).reshape(b, w).astype(np.int32)
    q = rng.normal(size=(b, s, h, d)).astype(np.float32)
    kc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    tile = 16 * splits // (h // kvh)
    pool = (torch.from_numpy(kc), torch.from_numpy(vc),
            torch.from_numpy(tables))
    lens = torch.tensor(ctx, dtype=torch.int32)
    qp = torch.from_numpy(q).reshape(b * s, h, d)
    emu = _emulate(qp, *pool, lens, None, None, splits=splits,
                   tile_tokens=tile, window=s)
    emu16 = _emulate(qp, *as_16_slot_pages(*pool), lens, None, None,
                     splits=splits, tile_tokens=tile, window=s)
    assert torch.equal(emu, emu16)
    emu = emu.reshape(b, s, h, d).numpy()
    live = (np.asarray(ctx)[:, None] - s + np.arange(s)[None, :]) >= 0
    assert live.any() and (s == 1 or not live.all())
    assert np.all(emu[~live] == 0.0)
    ref = pa.paged_attention_verify_ref(torch.from_numpy(q), *pool, lens)
    np.testing.assert_allclose(emu, ref.numpy(), atol=ATOL, rtol=RTOL)
    kern = np.asarray(jpa.paged_attention_verify(
        jnp.asarray(q), jnp.asarray(kc), jnp.asarray(vc),
        jnp.asarray(tables), jnp.asarray(ctx, jnp.int32)))
    np.testing.assert_allclose(emu[live], kern[live], atol=ATOL, rtol=RTOL)
