"""Paged attention over the block pool, and its KV writers.

The port of `paddle_tpu/ops/pallas/paged_attention.py`:
`ragged_metadata`, `write_kv_to_cache_ragged` and `write_kv_to_cache` are
plain tensor code; three attention functions launch hand-written Hopper
kernels (`csrc/ragged_paged_attention.cu`) on CUDA tensors and run their
plain PyTorch versions on CPU tensors:
- `paged_attention_ragged` (plain: `paged_attention_ragged_ref`), a packed
  query buffer — the bf16/f32-pool kernel, or with `k_scale`/`v_scale`
  the int8-pool kernel, each in the instance `ragged_plan` picks from the
  shapes (the split instance for bf16 q at the serving shapes, else the
  general one); one launch a call, nothing read back to the host;
- `paged_attention` (plain: `paged_attention_ref`), one decode query per
  sequence;
- `paged_attention_verify` (plain: `paged_attention_verify_ref`), S
  causal queries per sequence (the speculative verify window);
  both launch the ragged kernel's split instance in window mode at its
  shapes (bf16), so a decode row, a verify row and a ragged token at one
  position give the same bits, and the decode / verify kernel elsewhere.
There is no fallback between kernel and plain version: a CUDA tensor the
kernel does not take raises.

Layouts are the JAX package's: q [T, H, D] (ragged), [B, H, D] (decode)
or [B, S, H, D] (verify); pools [NB, KVH, BS, D]; int8 pools' scale
planes [NB, KVH, BS] f32 (`inference/kv_quant.py`); tables [B, W] int32;
kv_lens / context_lens [B]; tok_lane/tok_pos [T] int32.
"""
from __future__ import annotations

import ctypes
import functools
import math
from typing import NamedTuple

import torch

from ...inference import kv_quant
from . import _support

__all__ = ["ragged_metadata", "ragged_write_index", "write_kv_to_cache_ragged",
           "write_kv_to_cache", "paged_attention_ragged",
           "paged_attention_ragged_ref", "ragged_supported", "ragged_plan",
           "RaggedPlan",
           "paged_attention", "paged_attention_ref", "supported",
           "paged_attention_verify", "paged_attention_verify_ref",
           "verify_supported", "LAUNCHES", "LAUNCHES_Q", "LAUNCHES_DECODE",
           "LAUNCHES_VERIFY"]

NEG_INF = -1e30

# launches of the CUDA kernels (one per call on CUDA tensors): the ragged
# kernel over a bf16/f32 pool and over an int8 pool, decode and verify
LAUNCHES = _support.launch_counter("ragged_paged_attention")
LAUNCHES_Q = _support.launch_counter("ragged_paged_attention_q")
LAUNCHES_DECODE = _support.launch_counter("paged_attention")
LAUNCHES_VERIFY = _support.launch_counter("paged_attention_verify")


def ragged_metadata(q_lens: torch.Tensor, kv_lens: torch.Tensor,
                    num_tokens: int):
    """Per-token `(lane, position)` for the packed query buffer.

    Lane i owns packed slots [sum(q_lens[:i]), sum(q_lens[:i+1])) and its
    token j sits at absolute position kv_len - q_len + j; slots past
    sum(q_lens) are guards with pos -1 (lane clamped into range).
    Returns (tok_lane [T], tok_pos [T]) int32 on q_lens' device."""
    q_lens = q_lens.to(torch.int32)
    kv_lens = kv_lens.to(torch.int32)
    ends = torch.cumsum(q_lens, 0, dtype=torch.int32)               # [B]
    t_idx = torch.arange(num_tokens, dtype=torch.int32,
                         device=q_lens.device)                     # [T]
    lane = torch.searchsorted(ends, t_idx, right=True).to(torch.int32)
    valid = t_idx < ends[-1]
    lane = torch.clamp(lane, max=q_lens.shape[0] - 1)
    li = lane.long()
    off = t_idx - (ends[li] - q_lens[li])
    pos = kv_lens[li] - q_lens[li] + off
    return lane, torch.where(valid, pos, torch.full_like(pos, -1))


def ragged_write_index(block_tables, tok_lane, tok_pos, block_size: int):
    """Where each packed token's K/V lands: (block [T], slot [T], src [T],
    any_valid) for `write_kv_to_cache_ragged`. JAX drops the guard slots'
    (pos < 0) writes through an out-of-bounds scatter index; torch raises
    on one, so guards are masked explicitly, without a host sync: each
    guard slot repeats the first real token's write (`src` points it at
    that token: same index, same value, so the duplicate is harmless),
    and when no slot is real (`any_valid` false) every slot rewrites the
    value already at its index. The same for every layer of a step."""
    pos = torch.clamp(tok_pos.long(), min=0)
    blk = block_tables.long()[tok_lane.long(), pos // block_size]   # [T]
    off = pos % block_size
    valid = tok_pos >= 0
    first = torch.argmax(valid.to(torch.int32))
    src = torch.where(valid, torch.arange(tok_pos.shape[0],
                                          device=tok_pos.device), first)
    return blk[src], off[src], src, valid.any()


def write_kv_to_cache_ragged(k, v, k_cache, v_cache, block_tables,
                             tok_lane, tok_pos, k_scale=None, v_scale=None,
                             index=None):
    """Scatter packed K/V tokens [T, KVH, D] into the pools IN PLACE.

    Token t lands at absolute position tok_pos[t] of lane tok_lane[t]'s
    block table; guard slots (tok_pos < 0) write nothing (see
    `ragged_write_index`, whose result a caller writing several layers
    may pass as `index`). Returns (k_cache, v_cache), the same tensors
    (the JAX version returns new arrays from donated buffers).

    With `k_scale`/`v_scale` (f32 [NB, KVH, BS]) the pools are int8:
    each token's K/V quantizes with its own per-head absmax scale
    (`kv_quant.quantize_kv`), and the int8 values and their scales land
    at the SAME (block, slot) index, guard handling included. Returns
    (k_cache, v_cache, k_scale, v_scale) then."""
    if index is None:
        index = ragged_write_index(block_tables, tok_lane, tok_pos,
                                   k_cache.shape[2])
    blk, off, src, any_valid = index
    if k_scale is None:
        for new, cache in ((k, k_cache), (v, v_cache)):
            val = torch.where(any_valid, new[src].to(cache.dtype),
                              cache[blk, :, off])
            cache[blk, :, off] = val
        return k_cache, v_cache
    for new, cache, plane in ((k, k_cache, k_scale), (v, v_cache, v_scale)):
        q, s = kv_quant.quantize_kv(new[src])
        cache[blk, :, off] = torch.where(any_valid, q, cache[blk, :, off])
        plane[blk, :, off] = torch.where(any_valid, s, plane[blk, :, off])
    return k_cache, v_cache, k_scale, v_scale


def write_kv_to_cache(k, v, k_cache, v_cache, block_tables, start_pos):
    """Scatter new K/V tokens [B, S, KVH, D] IN PLACE: row b's token s
    lands at position start_pos[b] + s of its block table. Returns
    (k_cache, v_cache), the same tensors.

    A position outside the table (negative, or pos // BS >= W) writes
    nothing. JAX's `take_along_axis` fills that gather and its scatter
    then lands wherever the fill index wraps; the port masks such
    positions explicitly, as the ragged writer's guard slots, and never
    relies on a wrap-around. A right-padded prefill writes its padding
    into the sequence's own padded allocation, as in JAX."""
    b, s, kv_h, d = k.shape
    dev = k.device
    pos = start_pos.to(device=dev, dtype=torch.int32)[:, None] + \
        torch.arange(s, dtype=torch.int32, device=dev)[None, :]      # [B, S]
    cap = block_tables.shape[1] * k_cache.shape[2]
    pos = torch.where((pos >= 0) & (pos < cap), pos,
                      torch.full_like(pos, -1))
    lane = torch.arange(b, dtype=torch.int32, device=dev)[:, None] \
        .expand(b, s)
    return write_kv_to_cache_ragged(
        k.reshape(b * s, kv_h, d), v.reshape(b * s, kv_h, d), k_cache,
        v_cache, block_tables, lane.reshape(-1), pos.reshape(-1))


def supported(q_shape, dtype) -> bool:
    """Inputs the decode kernel takes: q [B, H, D], by the ragged kernel's
    rule (`ragged_supported`). JAX's gate (`supported`) also takes f16;
    the port narrows it, and `paged_attention` raises on a CUDA tensor
    this refuses (the engine routes nothing around it)."""
    return ragged_supported(q_shape, dtype)


def verify_supported(q_shape, dtype) -> bool:
    """Inputs the verify kernel takes: q [B, S, H, D] with S <= 64 (JAX's
    `verify_supported`) and D, dtype as `supported` (JAX also takes
    f16)."""
    return (len(q_shape) == 4 and q_shape[1] <= 64
            and supported((q_shape[0], q_shape[2], q_shape[3]), dtype))


def ragged_supported(q_shape, dtype) -> bool:
    """Inputs the CUDA kernel takes: q [T, H, D] with D a multiple of 8
    and at most 256 (the JAX gate `ragged_supported`), bf16 or f32."""
    return (len(q_shape) == 3 and q_shape[-1] % 8 == 0
            and q_shape[-1] <= 256
            and dtype in (torch.bfloat16, torch.float32))


class RaggedPlan(NamedTuple):
    splits: int       # CTAs of a cluster (1, 2 or 4), each 4 / splits of
                      # a tile's page streams; 0: the general instance
    tile_tokens: int  # tokens a tile at most (rows: tokens x G <= 16 x
                      # splits)
    slots: int        # clusters a kv head: the most tiles T packed tokens
                      # of `lanes` lanes make
    stages: int       # pages in flight a CTA
    smem_bytes: int   # dynamic shared memory a CTA
    ctas: int


# the split instance (`ragged_split_kernel` in csrc/ragged_paged_attention.cu)
PLAN_BLOCK_SIZE = 16          # slots a sub-page (a TMA box of 16 rows); it
                              # takes pages of any multiple of them
PLAN_MAX_ROWS = 64            # rows a tile: four warps of 16
PLAN_WARPS = 4                # consumer warps a CTA, and a row's page streams
PLAN_SPLITS = (1, 2, 4)       # cluster sizes: each CTA whole streams
# the split instance's CTAs an SM holds (at most 168 registers a thread, 5
# warps): a launch takes the largest split whose CTAs, at the most tiles
# the packed buffer can hold, stay within that many an SM; more splits only
# add waves of CTAs, each paying the CTA's fixed latency (PERF.md)
PLAN_CTAS_PER_SM = 2


def _split_smem(head_dim: int, int8: bool):
    """(stages, bytes) of the split instance's CTA (`SplitSmem`): the page
    ring, the f32 partials laid over it, the int8 pool's scale rows, the
    mbarriers, the consumer lanes' q segments and 1 KB of alignment."""
    itemsize = 1 if int8 else 2
    stages = 8
    ring = stages * 2 * PLAN_BLOCK_SIZE * head_dim * itemsize    # K + V
    pitch = head_dim + (4 if int8 else 8)
    part = PLAN_WARPS * 16 * (pitch + 2) * 4    # partials, their m and l
    scales = stages * 2 * PLAN_BLOCK_SIZE * 4 if int8 else 0
    q_areas = PLAN_WARPS * 16 * 2 * head_dim      # each lane's q segments
    return stages, (max(ring, part) + scales + 2 * stages * 8 + q_areas
                    + 1024)


@functools.lru_cache(maxsize=4096)
def ragged_plan(tokens: int, heads: int, kv_heads: int, head_dim: int,
                block_size: int, table_width: int, lanes: int, dtype,
                int8: bool, sms: int, aligned: bool = True,
                splits: int = 0) -> RaggedPlan:
    """The ragged kernel's instance and geometry for q [tokens, heads,
    head_dim] over pools of `kv_heads` heads, `block_size` slots a page
    and tables [lanes, table_width], in `dtype` (or an `int8` pool), on a
    card of `sms` SMs (`aligned`: q starts on a 16-byte boundary). A pure
    function of the shapes.

    Aligned bf16 q with head_dim 128 (64 too for a bf16 pool), pages of
    any multiple of 16 slots (the kernel streams a page as sub-pages of 16;
    the page size bounds nothing else) and at most 64 query heads a kv
    head take the split instance: a
    cluster of `splits` CTAs (1, 2 or 4) a tile of `tile_tokens` = 16 x
    splits // G tokens of a lane (every lane's tokens are at most
    ceil(q_len / tile_tokens) tiles, so `slots` = min(T, B) + (T - B) //
    tile_tokens clusters a kv head hold any packing in one pass, and the
    ceil(S / tile_tokens) tiles a lane of a window of S: `tokens` = B x S,
    `lanes` = B). The rule
    takes the largest split whose slots x kv_heads x splits CTAs stay
    within PLAN_CTAS_PER_SM an SM, else the smallest that holds a token's
    G rows (Llama-2-7B's 32 kv heads at 8 lanes: 1; 8 kv heads: 2);
    `splits` forces one (the split sweep). A row's result does not depend
    on the split. Every other shape takes the general instance (one CTA
    per packed token and kv head)."""
    group = heads // kv_heads if kv_heads and heads % kv_heads == 0 else 0
    split = (aligned and dtype == torch.bfloat16
             and block_size >= PLAN_BLOCK_SIZE
             and block_size % PLAN_BLOCK_SIZE == 0
             and (head_dim == 128 or (head_dim == 64 and not int8))
             and 0 < group <= PLAN_MAX_ROWS and tokens > 0)
    if not split:
        itemsize = 1 if int8 else dtype.itemsize
        return RaggedPlan(0, 1, tokens, _STAGES,
                          _smem_bytes(max(group, 1), head_dim, block_size,
                                      itemsize, int8), tokens * kv_heads)
    best = None
    for c in PLAN_SPLITS:
        if group > 16 * c or (splits and c != splits):
            continue
        tile = 16 * c // group
        slots = max(1, min(tokens, min(tokens, lanes)
                           + max(0, tokens - lanes) // tile))
        if best is None or slots * kv_heads * c <= PLAN_CTAS_PER_SM * sms:
            best = (c, tile, slots)
    if best is None:
        raise ValueError(f"no split of {PLAN_SPLITS} holds {group} heads "
                         f"a kv head in {splits} x 16 rows")
    c, tile, slots = best
    stages, smem = _split_smem(head_dim, int8)
    return RaggedPlan(c, tile, slots, stages, smem, slots * kv_heads * c)


# above this many packed tokens the ref tiles its per-token window
# gather, as the JAX reference does: an untiled T x window gather is
# O(T * max_seq) memory
_REF_TOKEN_TILE = 128


def paged_attention_ragged_ref(q, k_cache, v_cache, block_tables, kv_lens,
                               tok_lane, tok_pos, sm_scale=None,
                               k_scale=None, v_scale=None):
    """Plain PyTorch version of the ragged kernels (gather + masked
    softmax per packed token, in f32). Guard rows (tok_pos < 0) come back
    exactly zero. Ported from `paged_attention_ragged_ref` with its
    128-token tiling. With `k_scale`/`v_scale` (int8 pools) the gathered
    per-lane windows are dequantized right after the gather; the pool
    itself is never dequantized."""
    tokens, h, d = q.shape
    _nb, kv_h, bs, _ = k_cache.shape
    g = h // kv_h
    if sm_scale is None:
        sm_scale = 1.0 / float(math.sqrt(d))
    tables = block_tables.long()
    b, w = tables.shape
    max_s = w * bs
    k, v = k_cache[tables], v_cache[tables]          # [B, W, KVH, BS, D]
    if k_scale is not None:
        k = kv_quant.dequantize_kv(k, k_scale[tables])
        v = kv_quant.dequantize_kv(v, v_scale[tables])
    k = k.transpose(2, 3).reshape(b, max_s, kv_h, d)
    v = v.transpose(2, 3).reshape(b, max_s, kv_h, d)
    wpos = torch.arange(max_s, device=q.device)
    qg = q.reshape(tokens, kv_h, g, d)
    out = torch.empty((tokens, kv_h, g, d), dtype=torch.float32,
                      device=q.device)
    for s0 in range(0, tokens, _REF_TOKEN_TILE):
        sl = slice(s0, min(s0 + _REF_TOKEN_TILE, tokens))
        lane = tok_lane[sl].long()
        pos = tok_pos[sl].long()
        kt = k[lane].float()                       # [t, max_s, KVH, D]
        vt = v[lane].float()
        s = torch.einsum("thgd,tshd->thgs", qg[sl].float(), kt) * sm_scale
        mask = wpos[None, :] <= pos[:, None]                   # [t, max_s]
        s = torch.where(mask[:, None, None, :], s,
                        torch.full_like(s, NEG_INF))
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("thgs,tshd->thgd", p, vt)
        out[sl] = torch.where((pos >= 0)[:, None, None, None], o,
                              torch.zeros_like(o))
    return out.reshape(tokens, h, d).to(q.dtype)


def paged_attention_ragged(q, k_cache, v_cache, block_tables, kv_lens,
                           tok_lane, tok_pos, sm_scale=None, k_scale=None,
                           v_scale=None):
    """Ragged paged attention over a packed query token buffer.

    One launch serves every batch composition: decode lanes (q_len 1),
    prefill chunks (q_len n) and empty lanes. Args as
    `paged_attention_ragged_ref`; kv_lens counts each lane's cache
    INCLUDING this dispatch's tokens; `k_scale`/`v_scale` mark int8
    pools. Returns [T, H, D] in q's dtype; guard rows are exact zeros.
    CPU tensors take the plain version; CUDA tensors launch the kernel
    (the int8-pool kernel with scales) or raise."""
    if q.device.type == "cpu":
        return paged_attention_ragged_ref(q, k_cache, v_cache, block_tables,
                                          kv_lens, tok_lane, tok_pos,
                                          sm_scale, k_scale, v_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_ragged: unsupported device "
                         f"{q.device}")
    return _launch(q, k_cache, v_cache, block_tables, kv_lens, tok_lane,
                   tok_pos, sm_scale, k_scale, v_scale)


def _window(k_cache, v_cache, block_tables):
    """Each sequence's K/V window [B, W * BS, KVH, D] in table order."""
    _nb, kv_h, bs, d = k_cache.shape
    tables = block_tables.long()
    b, w = tables.shape
    k = k_cache[tables].transpose(2, 3).reshape(b, w * bs, kv_h, d)
    v = v_cache[tables].transpose(2, 3).reshape(b, w * bs, kv_h, d)
    return k, v


def paged_attention_verify_ref(q, k_cache, v_cache, block_tables,
                               context_lens, sm_scale=None):
    """Plain PyTorch version of the verify kernel (gather + masked
    softmax, in f32), ported from `paged_attention_verify_ref`: query s
    of sequence b attends to positions <= context_lens[b] - S + s. A row
    with no live position (context_lens[b] - S + s < 0) comes back
    exactly zero, as from the port's kernel; JAX's reference and its TPU
    kernel give such a row a mean of V rows instead."""
    b, s, h, d = q.shape
    kv_h = k_cache.shape[1]
    g = h // kv_h
    if sm_scale is None:
        sm_scale = 1.0 / float(math.sqrt(d))
    k, v = _window(k_cache, v_cache, block_tables)
    qg = q.reshape(b, s, kv_h, g, d).transpose(1, 2)       # [B,KVH,S,G,D]
    sc = torch.einsum("bhqgd,bshd->bhqgs", qg.float(), k.float()) * sm_scale
    wpos = torch.arange(k.shape[1], device=q.device)
    qpos = (context_lens.to(q.device).long()[:, None] - s
            + torch.arange(s, device=q.device)[None, :])           # [B, S]
    mask = wpos[None, None, :] <= qpos[:, :, None]                 # [B, S, W]
    sc = torch.where(mask[:, None, :, None, :], sc,
                     torch.full_like(sc, NEG_INF))
    p = torch.softmax(sc, dim=-1)
    out = torch.einsum("bhqgs,bshd->bhqgd", p, v.float())
    out = torch.where((qpos >= 0)[:, None, :, None, None], out,
                      torch.zeros_like(out))
    return out.transpose(1, 2).reshape(b, s, h, d).to(q.dtype)


def paged_attention_ref(q, k_cache, v_cache, block_tables, context_lens,
                        sm_scale=None):
    """Plain PyTorch version of the decode kernel, ported from
    `paged_attention_ref`: sequence b's one query attends to positions
    < context_lens[b]. A sequence with context_lens 0 comes back exactly
    zero, as from the kernels (the TPU kernel's `l_safe = 1`); JAX's
    reference averages V there instead. The verify function at S = 1."""
    return paged_attention_verify_ref(q[:, None], k_cache, v_cache,
                                      block_tables, context_lens,
                                      sm_scale)[:, 0]


def paged_attention(q, k_cache, v_cache, block_tables, context_lens,
                    sm_scale=None):
    """Decode-step paged attention: q [B, H, D], one query per sequence
    at position context_lens[b] - 1 (context_lens counts the cache
    INCLUDING it). Returns [B, H, D] in q's dtype. CPU tensors take
    `paged_attention_ref`; CUDA tensors launch a kernel or raise: bf16 at
    the shapes `ragged_plan` gives the split instance launch the ragged
    kernel's split instance with one query a lane, everything else the
    decode kernel."""
    if q.device.type == "cpu":
        return paged_attention_ref(q, k_cache, v_cache, block_tables,
                                   context_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention: unsupported device {q.device}")
    if not supported(tuple(q.shape), q.dtype):
        raise ValueError(f"decode kernel takes q [B, H, D] bf16/f32 with "
                         f"D % 8 == 0 and D <= 256, got {tuple(q.shape)} "
                         f"{q.dtype}")
    if _window_split(q, k_cache, block_tables):
        # the ragged kernel's split instance, one query a lane: decode and
        # ragged steps then share one arithmetic, bit for bit
        return _launch(q, k_cache, v_cache, block_tables, context_lens,
                       None, None, sm_scale, None, None, window=1,
                       counter=LAUNCHES_DECODE)
    return _launch_rows(q[:, None], k_cache, v_cache, block_tables,
                        context_lens, sm_scale, verify=False)[:, 0]


def paged_attention_verify(q, k_cache, v_cache, block_tables, context_lens,
                           sm_scale=None):
    """Batched multi-token verify attention: q [B, S, H, D], query s of
    sequence b at position context_lens[b] - S + s attends to positions
    <= its own (context_lens counts all S new tokens, already written).
    Returns [B, S, H, D] in q's dtype. A row with no live position
    (context_lens[b] - S + s < 0) is exact zeros. CPU tensors take
    `paged_attention_verify_ref`; CUDA tensors launch a kernel or raise:
    bf16 at the shapes `ragged_plan` gives the split instance launch the
    ragged kernel's split instance over the B windows of S queries (one
    launch; each row the same bits as the ragged kernel's and a decode
    call's at its position), everything else the verify kernel."""
    if q.device.type == "cpu":
        return paged_attention_verify_ref(q, k_cache, v_cache, block_tables,
                                          context_lens, sm_scale)
    if q.device.type != "cuda":
        raise ValueError(f"paged_attention_verify: unsupported device "
                         f"{q.device}")
    if not verify_supported(tuple(q.shape), q.dtype):
        raise ValueError(f"verify kernel takes q [B, S, H, D] bf16/f32 with "
                         f"S <= 64, D % 8 == 0 and D <= 256, got "
                         f"{tuple(q.shape)} {q.dtype}")
    b, s, h, d = q.shape
    if _window_split(q, k_cache, block_tables):
        return _launch(q.view(b * s, h, d), k_cache, v_cache, block_tables,
                       context_lens, None, None, sm_scale, None, None,
                       window=s, counter=LAUNCHES_VERIFY).view(b, s, h, d)
    return _launch_rows(q, k_cache, v_cache, block_tables, context_lens,
                        sm_scale, verify=True)


def _window_split(q, k_cache, block_tables) -> bool:
    """Whether a decode (q [B, H, D]) or verify (q [B, S, H, D]) call on
    the card launches the split instance in window mode: q contiguous,
    one table row a sequence, a 4-D pool, and the shapes `ragged_plan`
    gives the split instance (B x S tokens of B lanes). Otherwise the
    decode / verify kernel takes it."""
    if not (q.is_contiguous() and q.numel() > 0 and k_cache.dim() == 4
            and block_tables.dim() == 2
            and q.shape[0] == block_tables.shape[0]):
        return False
    return _plan(q.view(-1, q.shape[-2], q.shape[-1]), k_cache,
                 block_tables, False).splits > 0


_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1}
_SMEM_MAX = 232448      # dynamic shared memory one Hopper block may use
_STAGES = 3             # the kernel's ring of K/V pages (kStages)


def _smem_bytes(group, head_dim, block_size, itemsize, quant=False):
    """The kernel's dynamic shared memory (`smem_bytes` in the source)."""
    return (2 * _STAGES * block_size * head_dim * itemsize
            + (2 * _STAGES * block_size * 4 if quant else 0)
            + (2 * group * head_dim + group * block_size + 3 * group) * 4)


def _check_pools(q, k_cache, v_cache, quant=False):
    """q contiguous; both pools [NB, KVH, BS, D] with 16-byte aligned
    rows, in q's dtype (int8 with `quant`)."""
    if not q.is_contiguous():
        raise ValueError("q must be contiguous")
    d = q.shape[-1]
    for name, c in (("k_cache", k_cache), ("v_cache", v_cache)):
        if c.device != q.device:
            raise ValueError(f"{name} is on {c.device}, q on {q.device}")
        if quant and c.dtype != torch.int8:
            raise ValueError(f"scale planes go with an int8 pool; {name} "
                             f"is {c.dtype}")
        if not quant and c.dtype != q.dtype:
            raise ValueError(f"{name} dtype {c.dtype} != q dtype {q.dtype}"
                             + (" (an int8 pool needs k_scale/v_scale)"
                                if c.dtype == torch.int8 else ""))
        if c.dim() != 4 or c.shape[3] != d or c.shape[1:] != \
                k_cache.shape[1:]:
            raise ValueError(f"{name} must be [NB, KVH, BS, {d}], got "
                             f"{tuple(c.shape)}")
        vec = 16 // c.element_size()
        if d % vec:
            raise ValueError(f"{name}: head_dim {d} is not a multiple of "
                             f"{vec}, the values one 16-byte vector holds")
        if c.stride(3) != 1 or any(s % vec for s in c.stride()[:3]) \
                or c.data_ptr() % 16:
            raise ValueError(f"{name} rows must be 16-byte aligned with a "
                             f"unit head_dim stride, got strides "
                             f"{c.stride()}")
    if q.shape[-2] % k_cache.shape[1]:
        raise ValueError(f"{q.shape[-2]} query heads not a multiple of "
                         f"{k_cache.shape[1]} kv heads")


def _check(q, k_cache, v_cache, block_tables, kv_lens, tok_lane, tok_pos,
           k_scale, v_scale):
    quant = k_scale is not None or v_scale is not None
    toks = (("tok_lane", tok_lane), ("tok_pos", tok_pos)) \
        if tok_pos is not None else ()
    for name, t in (("k_cache", k_cache), ("v_cache", v_cache),
                    ("block_tables", block_tables), ("kv_lens", kv_lens)) + \
            toks + \
            ((("k_scale", k_scale), ("v_scale", v_scale)) if quant else ()):
        if t is None:
            raise ValueError(f"an int8 pool needs both scale planes; "
                             f"{name} is missing")
        if t.device != q.device:
            raise ValueError(f"{name} is on {t.device}, q on {q.device}")
    if not ragged_supported(tuple(q.shape), q.dtype):
        raise ValueError(f"ragged kernel takes q [T, H, D] bf16/f32 with "
                         f"D % 8 == 0 and D <= 256, got {tuple(q.shape)} "
                         f"{q.dtype}")
    t, h, d = q.shape
    _check_pools(q, k_cache, v_cache, quant)
    if quant:
        want = kv_quant.scale_shape(k_cache.shape)
        for name, sc in (("k_scale", k_scale), ("v_scale", v_scale)):
            if sc.dtype != torch.float32 or tuple(sc.shape) != want:
                raise ValueError(f"{name} must be f32 {list(want)} (the "
                                 f"pool's shape minus head_dim), got "
                                 f"{tuple(sc.shape)} {sc.dtype}")
            # one page's scale row is staged with 16-byte copies
            if sc.stride(2) != 1 or sc.shape[2] % 4 \
                    or any(s % 4 for s in sc.stride()[:2]) \
                    or sc.data_ptr() % 16:
                raise ValueError(f"{name} rows must be 16-byte aligned "
                                 f"(block_size % 4 == 0, unit slot "
                                 f"stride), got shape {tuple(sc.shape)} "
                                 f"strides {sc.stride()}")
    if block_tables.dim() != 2 or not block_tables.is_contiguous():
        raise ValueError("block_tables must be a contiguous [B, W] tensor")
    for name, x, n in (("kv_lens", kv_lens, block_tables.shape[0]),) + \
            tuple((name, x, t) for name, x in toks):
        if x.dim() != 1 or x.shape[0] != n or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous [{n}] tensor")
    for name, x in (("block_tables", block_tables), ("kv_lens", kv_lens)) \
            + toks:
        if x.dtype != torch.int32:
            raise ValueError(f"{name} must be int32, got {x.dtype}")
    return quant


def _lib(quant):
    lib = _support.load_library("ragged_paged_attention")
    fn = lib.ragged_paged_attention_q if quant else lib.ragged_paged_attention
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        nptr, nstride = (10, 10) if quant else (8, 6)
        fn.argtypes = [p] * nptr + [i] * 6 + [ll] * nstride + \
            [ctypes.c_float] + [i] * 6 + [p]
        fn.restype = ctypes.c_int
    return fn


def _plan(q, k_cache, block_tables, quant):
    """`ragged_plan` for these inputs on q's card."""
    t, h, d = q.shape
    _nb, kv_h, bs, _ = k_cache.shape
    return ragged_plan(t, h, kv_h, d, bs, block_tables.shape[1],
                       block_tables.shape[0], q.dtype, quant,
                       _support.sm_count(q.device.index
                                         if q.device.index is not None
                                         else torch.cuda.current_device()),
                       q.data_ptr() % 16 == 0)


def _launch(q, k_cache, v_cache, block_tables, kv_lens, tok_lane, tok_pos,
            sm_scale, k_scale, v_scale, window=0, counter=None):
    """One launch of the ragged kernel in the instance `_plan` picks;
    raises where that is the general instance and its CTA would not fit.
    `window` S > 0 with tok_lane = tok_pos = None is window mode (the
    split instance only): q [B * S, H, D], row b * S + s query s of lane
    b at kv_lens[b] - S + s, a decode or verify call. Counts one launch on
    `counter` (default: the ragged kernel's of the pool)."""
    quant = _check(q, k_cache, v_cache, block_tables, kv_lens, tok_lane,
                   tok_pos, k_scale, v_scale)
    t, h, d = q.shape
    nb, kv_h, bs, _ = k_cache.shape
    if sm_scale is None:
        sm_scale = 1.0 / float(math.sqrt(d))
    plan = _plan(q, k_cache, block_tables, quant)
    if plan.smem_bytes > _SMEM_MAX:
        raise ValueError(f"ragged kernel needs {plan.smem_bytes} bytes of "
                         f"shared memory per block, over the {_SMEM_MAX} a "
                         "Hopper block may use")
    if window and (plan.splits == 0 or tok_pos is not None
                   or t != window * block_tables.shape[0]):
        raise ValueError("window mode takes the split instance, no "
                         "tok_lane / tok_pos and one window a table row")
    out = torch.empty_like(q)
    fn = _lib(quant)
    if quant:
        ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                k_scale.data_ptr(), v_scale.data_ptr())
        strides = (*k_cache.stride()[:3], *v_cache.stride()[:3],
                   *k_scale.stride()[:2], *v_scale.stride()[:2])
    else:
        ptrs = (q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr())
        strides = (*k_cache.stride()[:3], *v_cache.stride()[:3])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(*ptrs, block_tables.data_ptr(), kv_lens.data_ptr(),
                None if window else tok_lane.data_ptr(),
                None if window else tok_pos.data_ptr(), out.data_ptr(),
                t, h, kv_h, d, bs, block_tables.shape[1], *strides,
                float(sm_scale), _DTYPE_CODE[q.dtype], nb, plan.splits,
                plan.slots, plan.tile_tokens, window, stream)
    name = "ragged_paged_attention_q" if quant else "ragged_paged_attention"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    (counter or (LAUNCHES_Q if quant else LAUNCHES)).add()
    return out


def _launch_rows(q, k_cache, v_cache, block_tables, context_lens, sm_scale,
                 verify):
    """Launch the decode (`verify=False`, q [B, 1, H, D]) or verify kernel
    on q [B, S, H, D]; returns out [B, S, H, D]. Counts one launch, none
    for an empty q."""
    _check_pools(q, k_cache, v_cache)
    b, s, h, d = q.shape
    _nb, kv_h, bs, _ = k_cache.shape
    for name, x, shape in (("block_tables", block_tables, None),
                           ("context_lens", context_lens, (b,))):
        if x.device != q.device:
            raise ValueError(f"{name} is on {x.device}, q on {q.device}")
        if x.dtype != torch.int32 or not x.is_contiguous():
            raise ValueError(f"{name} must be a contiguous int32 tensor, "
                             f"got {x.dtype}")
        if shape is not None and tuple(x.shape) != shape:
            raise ValueError(f"{name} must be {list(shape)}, got "
                             f"{tuple(x.shape)}")
    if block_tables.dim() != 2 or block_tables.shape[0] != b:
        raise ValueError(f"block_tables must be [{b}, W], got "
                         f"{tuple(block_tables.shape)}")
    if sm_scale is None:
        sm_scale = 1.0 / float(math.sqrt(d))
    out = torch.empty_like(q)
    if q.numel() == 0:
        return out
    lib = _support.load_library("ragged_paged_attention")
    need = lib.paged_rows_smem_bytes
    if need.argtypes is None:
        need.argtypes = [ctypes.c_int] * 3
        need.restype = ctypes.c_longlong
    smem = need(d, bs, _DTYPE_CODE[q.dtype])
    if smem > _SMEM_MAX:
        raise ValueError(f"block_size {bs} x head_dim {d} pages need {smem} "
                         f"bytes of shared memory per block, over the "
                         f"{_SMEM_MAX} a Hopper block may use")
    fn = lib.paged_attention_verify if verify else lib.paged_attention_decode
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = [p] * 6 + [i] * (7 if verify else 6) + [ll] * 6 + \
            [ctypes.c_float, i, p]
        fn.restype = ctypes.c_int
    shape = (b, s, h, kv_h, d, bs, block_tables.shape[1]) if verify \
        else (b, h, kv_h, d, bs, block_tables.shape[1])
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = fn(q.data_ptr(), k_cache.data_ptr(), v_cache.data_ptr(),
                block_tables.data_ptr(), context_lens.data_ptr(),
                out.data_ptr(), *shape, *k_cache.stride()[:3],
                *v_cache.stride()[:3], float(sm_scale),
                _DTYPE_CODE[q.dtype], stream)
    name = "paged_attention_verify" if verify else "paged_attention_decode"
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    (LAUNCHES_VERIFY if verify else LAUNCHES_DECODE).add()
    return out
