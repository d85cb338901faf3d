"""Tensor-parallel serving — shard a built engine over a TP x DP mesh of
`torch.distributed` ranks (the port of `paddle_tpu/serving/tp.py`).

`shard_engine` is an offline walk over a built engine, like
`quantize_engine`: it returns a `ShardedEngine`, a drop-in `EngineCore`
holding this rank's shard of the weights and of the KV pool, and the
scheduler / radix / COW bookkeeping is untouched.

SPMD ranks. The JAX package drives one `shard_map` program over a device
mesh from a single controller. Here every rank is its own process: each
builds its base engine, calls `shard_engine` on it, and runs its own
`Scheduler` / `ServingFrontend` over the same requests and seeds, in
lockstep. After the row-parallel reductions and the logit gather every
rank holds the same logits, so the ranks sample the same tokens and take
the same scheduling decisions; their schedulers are replicas, as the JAX
docstring's "scheduler state is replicated" says. A single controller
cannot diverge and SPMD ranks can, so every dispatch first checks, with
one small all-reduce over a digest of the step's tokens, lengths and
block tables, that all ranks of the group dispatch the same step, and
raises `LockstepError` instead of hanging in the next collective. A
decision a rank takes from its own wall clock (deadlines, the watchdog's
stall detection) would break the lockstep: serve TP without them, or
give every rank the same step-counting `clock`.

Layout (the JAX package's, rank by rank):

- **Megatron column/row pairing.** The Llama stack's fused qkv and
  gate_up projections are column-parallel — their columns are PERMUTED
  first (`_interleave_perm`) so every shard holds whole heads of q|k|v
  (resp. matching gate|up halves) contiguously and the unmodified split
  arithmetic of `llama_runner._layer` works on the local shard — and o /
  down are row-parallel, their partial sums all-reduced over the tp
  group. The MLP engine pairs a row-parallel w1 (rows permuted so shard
  s holds the [last_s, mean_s] feature rows) with a column-parallel
  vocab w2. One reduction per pair (Megatron's f / g operators).
- **The KV pool shards along the head axis** (Llama: `KVH % tp == 0`,
  int8 scale planes split with their heads; MLP: the feature axis, its
  int8 scale plane replicated). Block ids stay LOGICAL: every rank's
  block manager takes the same decisions, and only the per-block
  payload narrows per rank.
- **Shard order.** Shard s of a tp group is the rank whose position in
  the group's ascending rank order is s.
- **Groups.** A rank's first `shard_engine` over a tp group creates the
  group, which every member must do together (`dist.new_group`); later
  calls over the same ranks reuse it and are local, so ranks may then
  shard one after another (one full base engine on a card at a time).

`overlap=True` decomposes each row-parallel gemm into `overlap_tiles`
output tiles whose all-reduces run asynchronously, tile k's reduction
under tile k+1's gemm (`distributed/tp_overlap.py`), and all-gathers the
vocab-sharded logits on the device. `overlap=False` is the sequential
baseline: one untiled, blocking all-reduce per gemm, and the logit
shards assembled into a host numpy array after the step.

Shard BEFORE traffic: the sharded engine owns a fresh
`BlockCacheManager` with the base engine's logical geometry and fresh
pools of this rank's width, and the base must not serve afterwards. The
sharded engine holds its own copies of its shard of every split weight
and of the replicated ones (norms, embedding, rope tables), and keeps no
reference to the base's tensors, so a caller that drops the base frees
them. A refused layout raises `ShardingConfigError` before any
allocation and leaves the base as it was.
"""
from __future__ import annotations

import hashlib
import types
from typing import Optional

import numpy as np
import torch
import torch.distributed as dist

from ..distributed.process_mesh import ProcessMesh
from ..distributed.tp_overlap import TPInfo, axis_index
from ..framework import monitor
from ..inference import kv_migrate, kv_quant
from ..nn.quant import pack_int4, unpack_int4

__all__ = ["ShardingConfigError", "LockstepError", "shard_engine",
           "ShardedEngine"]


class ShardingConfigError(ValueError):
    """A TP/DP layout that cannot be built — raised by `shard_engine`
    BEFORE any device allocation (pure shape/topology arithmetic), so a
    bad config never leaves half-sharded state behind."""


class LockstepError(ShardingConfigError):
    """The ranks of a tp group dispatched different steps: their
    schedulers diverged (a rank-local decision, different requests or
    seeds). Raised on every rank of the group by the per-step input
    check, before the step's first collective."""


# ---------------------------------------------------------------------------
# layout arithmetic (pure numpy / host indexing — runs before any collective)
# ---------------------------------------------------------------------------

def _interleave_perm(sizes, tp: int) -> np.ndarray:
    """Column permutation for a FUSED column-parallel weight whose output
    axis concatenates segments of `sizes` (qkv: [nh*d, kvh*d, kvh*d];
    gate_up: [I, I]; the MLP head input: [D, D]): shard s's contiguous
    chunk becomes [seg0_s, seg1_s, ...], so the engine's unmodified
    split arithmetic works on the local shard."""
    offs = np.cumsum([0] + list(sizes[:-1]))
    out = []
    for s in range(tp):
        for off, size in zip(offs, sizes):
            step = size // tp
            out.extend(range(off + s * step, off + (s + 1) * step))
    return np.asarray(out, dtype=np.int64)


def _index(perm, t: torch.Tensor) -> torch.Tensor:
    return torch.as_tensor(perm, dtype=torch.long, device=t.device)


def _permute_cols(w, perm):
    """Apply an output-channel permutation: dense [..., K, N] last axis;
    quantized dicts permute the N axis of q/q4 and s."""
    if isinstance(w, dict):
        out = dict(w)
        key = "q4" if "q4" in w else "q"
        out[key] = w[key][..., _index(perm, w[key]), :]
        out["s"] = w["s"][..., _index(perm, w["s"])]
        return out
    return w[..., _index(perm, w)]


def _shard_rows(w, tp: int, perm=None):
    """Prepare a ROW-parallel weight so that contiguous K-axis sharding
    yields each shard's correct local weight: dense [..., K, N] rows are
    permuted (`perm`, optional), int8 dicts permute the K axis of q, and
    int4 dicts — packed SPLIT-HALF (`nn.quant.pack_int4`: byte j holds
    k=j and k=j+K/2, so the packed axis can neither be permuted nor
    sliced element-wise) — are unpacked, permuted, and REPACKED PER
    SHARD CHUNK, so shard s's contiguous packed slice is exactly the
    split-half pack of its local K rows. Per-OUT-channel scales are
    untouched (every shard needs every output's scale)."""
    if isinstance(w, dict):
        out = dict(w)
        if "q4" in w:
            q = unpack_int4(w["q4"])                     # [..., N, K]
            if perm is not None:
                q = q[..., _index(perm, q)]
            chunk = q.shape[-1] // tp
            out["q4"] = torch.cat(
                [pack_int4(q[..., i * chunk:(i + 1) * chunk])
                 for i in range(tp)], dim=-1)
        elif perm is not None:
            out["q"] = w["q"][..., _index(perm, w["q"])]
        return out
    if perm is not None:
        return w[..., _index(perm, w), :]
    return w


def _own(t: torch.Tensor) -> torch.Tensor:
    """A contiguous copy: a shard never shares storage with the full
    weight it was cut from."""
    return t.clone(memory_format=torch.contiguous_format)


def _take(w, mode: str, s: int, tp: int):
    """Shard s of one gemm weight (the JAX package's PartitionSpec per
    weight, `_wspec`, applied by one rank). Dense weights are [K, N];
    quantized dicts {q|q4 [N, K(/2)], s [N]}. "col" takes the output (N)
    chunk, "row" the input (K) chunk — quantized row shards keep every
    per-out-channel scale (every shard needs every output's scale)."""
    if isinstance(w, dict):
        key = "q4" if "q4" in w else "q"
        q = w[key]
        if mode == "col":
            n = q.shape[-2] // tp
            return {key: _own(q[..., s * n:(s + 1) * n, :]),
                    "s": _own(w["s"][..., s * n:(s + 1) * n])}
        k = q.shape[-1] // tp
        return {key: _own(q[..., s * k:(s + 1) * k]), "s": _own(w["s"])}
    if mode == "col":
        n = w.shape[-1] // tp
        return _own(w[..., s * n:(s + 1) * n])
    k = w.shape[-2] // tp
    return _own(w[..., s * k:(s + 1) * k, :])


def _even(name: str, n: int, tp: int, why: str):
    if n % tp:
        raise ShardingConfigError(
            f"{name}={n} is not divisible by tp={tp} — {why}")


def _first(w):
    """Layer 0's weight of a per-layer list (the Llama engine's layout),
    or the weight itself."""
    return w[0] if isinstance(w, (list, tuple)) else w


def _validate_llama(engine, tp: int):
    cfg = engine.config
    _even("num_key_value_heads", cfg.num_key_value_heads, tp,
          "the paged KV pool shards along the head axis (KVH % tp == 0)")
    _even("num_attention_heads", cfg.num_attention_heads, tp,
          "qkv is column-parallel over whole query heads")
    _even("intermediate_size", cfg.intermediate_size, tp,
          "gate_up/down split the MLP width")
    head = engine.params.get("lm_head")
    if head is not None:
        v = int(head["s"].shape[-1] if isinstance(head, dict)
                else head.shape[-1])
        _even("vocab_size", v, tp,
              "the untied lm_head is vocab-column-parallel")
    for key, k_in in (("o_w", cfg.num_attention_heads * cfg.head_dim),
                      ("down_w", cfg.intermediate_size)):
        w = _first(engine.params.get(key))
        if isinstance(w, dict) and "q4" in w and (k_in // tp) % 2:
            raise ShardingConfigError(
                f"int4 {key}: per-shard in_features {k_in}//{tp} is odd "
                "— the packed byte pairs cannot split across shards")


def _validate_mlp(engine, tp: int):
    d = int(engine.params["embed"].shape[1])
    _even("hidden", d, tp,
          "the embedding pool and w1 rows shard along the feature axis")
    _even("vocab_size", int(engine.vocab_size), tp,
          "w2/b2 are vocab-column-parallel")
    w1 = engine.params.get("w1")
    if isinstance(w1, dict) and "q4" in w1 and (d // tp) % 2:
        raise ShardingConfigError(
            f"int4 w1: per-shard feature slice {d}//{tp} is odd — the "
            "packed byte pairs cannot split across shards")


def _world():
    """(world size, this process's rank): (1, 0) with no process group."""
    if dist.is_available() and dist.is_initialized():
        return dist.get_world_size(), dist.get_rank()
    return 1, 0


# tp groups by their ranks, for the current world: every member creates a
# group the first time it shards over it (`use_local_synchronization`:
# only the members take part), and later engines over the same ranks reuse
# it instead of opening more connections
_GROUPS = {"world": None, "by_ranks": {}}


def _tp_group(ranks):
    world = dist.group.WORLD
    if _GROUPS["world"] is not world:
        _GROUPS["world"], _GROUPS["by_ranks"] = world, {}
    key = tuple(int(r) for r in ranks)
    group = _GROUPS["by_ranks"].get(key)
    if group is None:
        group = dist.new_group(list(key), use_local_synchronization=True)
        _GROUPS["by_ranks"][key] = group
    return group


# ---------------------------------------------------------------------------
# the offline pass
# ---------------------------------------------------------------------------

def shard_engine(engine, mesh: Optional[ProcessMesh] = None, *,
                 tp: int = 2, dp: int = 1, overlap: bool = True,
                 overlap_tiles: int = 4) -> "ShardedEngine":
    """Walk this rank's built serving engine (full-precision OR
    `quantize_engine` int8/int4 weight-only, either KV mode) and return
    its TP shard, a `ShardedEngine` serving the same `ragged_step` /
    `verify_step` / `copy_kv_block` surface. Every rank of the mesh
    calls it on its own base engine built from the same weights.

    `mesh` is an optional `ProcessMesh` of global ranks to shard over
    (size exactly tp*dp; read row-major as (dp, tp)); default: ranks 0 …
    tp*dp-1 of the initialized world. Each dp row is one tp group. `dp`
    replicates the whole engine — compute and KV — across rows; routing
    requests across replicas stays the frontend's business. With no
    process group initialized only tp*dp == 1 is legal, and the shard
    runs with no collective at all. The groups use the backend the
    caller passed to `init_process_group`.

    `overlap=True` (the shipped mode) decomposes each row-parallel gemm
    into `overlap_tiles` all-reduce tiles and all-gathers logits on the
    device; `overlap=False` builds the sequential-collective baseline
    (one blocking all-reduce per gemm, host-side logit assembly). All
    layout problems raise `ShardingConfigError` before any allocation.
    """
    if isinstance(engine, ShardedEngine):
        raise ShardingConfigError("engine is already TP-sharded — "
                                  "shard the underlying engine once")
    tp, dp = int(tp), int(dp)
    if tp < 1 or dp < 1:
        raise ShardingConfigError(
            f"tp and dp must be >= 1, got tp={tp} dp={dp}")
    if hasattr(engine, "adapter_pool"):
        raise ShardingConfigError(
            "a LoRA engine's adapter pools and epilogues are not sharded "
            "— shard a base engine without adapters")
    params = getattr(engine, "params", None)
    if not isinstance(params, dict):
        raise ShardingConfigError(
            f"{type(engine).__name__} has no params dict to shard")
    if "qkv_w" in params:
        kind = "llama"
        _validate_llama(engine, tp)
    elif "w1" in params:
        kind = "mlp"
        _validate_mlp(engine, tp)
    else:
        raise ShardingConfigError(
            f"{type(engine).__name__}: unrecognized parameter layout "
            "(expected llama projection keys or MLP w1/w2)")
    if mesh is not None:
        if int(mesh.size) != tp * dp:
            raise ShardingConfigError(
                f"mesh has {mesh.size} processes but tp*dp = {tp * dp} "
                f"(tp={tp}, dp={dp}) — slice the mesh "
                "(get_mesh_with_dim) before sharding")
        ids = np.asarray(mesh.process_ids, np.int64)
    else:
        ids = np.arange(tp * dp, dtype=np.int64)
    world, rank = _world()
    if tp * dp > world:
        raise ShardingConfigError(
            f"tp*dp = {tp * dp} exceeds the world size {world}")
    if len(set(ids.tolist())) != ids.size or ids.min() < 0 \
            or ids.max() >= world:
        raise ShardingConfigError(
            f"mesh ranks {ids.tolist()} must be distinct ranks of the "
            f"world of {world}")
    if rank not in ids:
        raise ShardingConfigError(
            f"rank {rank} is not in the mesh {ids.tolist()}")
    pmesh = ProcessMesh(ids.reshape(dp, tp), ["dp", "tp"])
    return ShardedEngine(engine, pmesh, tp=tp, dp=dp, kind=kind,
                         overlap=bool(overlap),
                         overlap_tiles=int(overlap_tiles))


class ShardedEngine:
    """One rank's TP shard of a serving engine: the scheduler's dispatch
    surfaces (`ragged_step`, `verify_step`, `copy_kv_block`), KV
    migration of this rank's slice (`extract_kv_blocks` /
    `inject_kv_blocks`) and `quant_info` (per-rank KV bytes). The legacy
    single-sequence entry points (`prefill` / `decode_step` /
    `generate`) raise, as on a `kv_bits=8` engine: the ragged path is
    the only serving program."""

    def __init__(self, base, pmesh: ProcessMesh, *, tp: int, dp: int,
                 kind: str, overlap: bool, overlap_tiles: int):
        _, rank = _world()
        row = int(np.argwhere(pmesh.mesh == rank)[0][0])
        group = None if not (dist.is_available() and dist.is_initialized()) \
            else _tp_group(sorted(pmesh.mesh[row].tolist()))
        self.mesh = pmesh
        self.tp, self.dp = tp, dp
        self.dp_index = row
        self.overlap = overlap
        self._kind = kind
        self.tpinfo = TPInfo(group, tp, overlap_tiles if overlap else 1,
                             gather_logits=overlap)
        self.tp_index = s = axis_index(self.tpinfo)
        self.device = base.device
        self.kv_bits = int(getattr(base, "kv_bits", 16))
        self.max_batch_size = base.max_batch_size
        self.block_size = base.block_size
        self.weight_only = getattr(base, "weight_only", None)
        if hasattr(base, "vocab_size"):
            self.vocab_size = base.vocab_size
        from ..inference.cache import BlockCacheManager

        # fresh paged bookkeeping, same LOGICAL geometry — every rank's
        # manager takes the same decisions; only the payload narrows
        m = base.manager
        self.manager = BlockCacheManager(m.num_blocks, m.block_size,
                                         m.max_blocks_per_seq)
        kv8 = self.kv_bits == 8
        dev = self.device
        with torch.no_grad():
            if kind == "llama":
                self._init_llama(base, s, tp, kv8, dev)
            else:
                self._init_mlp(base, s, tp, kv8, dev)
        self._mig_header = dict(base._mig_header, tp=tp)

    def _init_llama(self, base, s, tp, kv8, dev):
        from ..inference.llama_runner import KV_PLANES, LlamaInferenceEngine

        cfg = base.config
        nh, kvh, d = (cfg.num_attention_heads, cfg.num_key_value_heads,
                      cfg.head_dim)
        qkv_perm = _interleave_perm([nh * d, kvh * d, kvh * d], tp)
        gu_perm = _interleave_perm([cfg.intermediate_size] * 2, tp)
        p = {}
        for key, v in base.params.items():
            if key == "qkv_w":
                p[key] = [_take(_permute_cols(w, qkv_perm), "col", s, tp)
                          for w in v]
            elif key == "gate_up_w":
                p[key] = [_take(_permute_cols(w, gu_perm), "col", s, tp)
                          for w in v]
            elif key in ("o_w", "down_w"):
                p[key] = [_take(_shard_rows(w, tp), "row", s, tp) for w in v]
            elif key == "lm_head":
                p[key] = _take(v, "col", s, tp)
            else:                    # replicated
                p[key] = [_own(t) for t in v] if isinstance(v, list) \
                    else _own(v)
        self.params = p
        self._vocab_sharded = "lm_head" in p
        L, nb = base.k_cache.shape[:2]
        shape = (L, nb, kvh // tp, base.block_size, d)
        self.k_cache = torch.zeros(shape, dtype=base.k_cache.dtype,
                                   device=dev)
        self.v_cache = torch.zeros(shape, dtype=base.k_cache.dtype,
                                   device=dev)
        self.k_scale = self.v_scale = None
        if kv8:
            planes = kv_quant.scale_shape(shape)
            self.k_scale = torch.zeros(planes, dtype=torch.float32,
                                       device=dev)
            self.v_scale = torch.zeros(planes, dtype=torch.float32,
                                       device=dev)
        self.config = types.SimpleNamespace(
            num_attention_heads=nh // tp, num_key_value_heads=kvh // tp,
            head_dim=d, rms_norm_eps=cfg.rms_norm_eps,
            num_hidden_layers=cfg.num_hidden_layers, tp=self.tpinfo)
        geom = dict(base._kv_geom)
        geom["kv_heads"] //= tp
        self._kv_bytes_per_token = kv_quant.kv_bytes_per_token(**geom)
        self.manager.set_kv_geometry(kv_quant.kv_bytes_per_block(**geom),
                                     self.kv_bits)
        self._planes, self._block_axis = KV_PLANES, 1
        self._copy_block = LlamaInferenceEngine._copy_block

    def _init_mlp(self, base, s, tp, kv8, dev):
        from .engine import MLP_PLANES, MLPLMEngine

        d = int(base.params["embed"].shape[1])
        bp = base.params
        v = bp["b2"].shape[-1] // tp
        self.params = {
            "embed": _own(bp["embed"]), "b1": _own(bp["b1"]),
            "w1": _take(_shard_rows(bp["w1"], tp,
                                    _interleave_perm([d, d], tp)),
                        "row", s, tp),
            "w2": _take(bp["w2"], "col", s, tp),
            "b2": _own(bp["b2"][s * v:(s + 1) * v])}
        self._vocab_sharded = True
        nb, bs = base.cache.shape[:2]
        self.cache = torch.zeros((nb, bs, d // tp), dtype=base.cache.dtype,
                                 device=dev)
        # the int8 scale plane stays REPLICATED: absmax is over the FULL
        # feature vector, so every shard holds every slot's scale
        self.cache_scale = torch.zeros((nb, bs), dtype=torch.float32,
                                       device=dev) if kv8 else None
        bpb = (bs * (d // tp) + bs * 4) if kv8 else bs * (d // tp) * 4
        self._kv_bytes_per_token = bpb / bs
        self.manager.set_kv_geometry(bpb, self.kv_bits)
        self._planes, self._block_axis = MLP_PLANES, 0
        self._copy_block = MLPLMEngine._copy_block

    def _pools(self):
        """The pool tensors a block spans, in the payload's plane order."""
        if self._kind == "llama":
            if self.k_scale is None:
                return [self.k_cache, self.v_cache]
            return [self.k_cache, self.v_cache, self.k_scale, self.v_scale]
        if self.cache_scale is None:
            return [self.cache]
        return [self.cache, self.cache_scale]

    # ---- observability surface ----
    def tp_summary(self) -> dict:
        """The sharding mode, for reports."""
        return {"kind": self._kind, "tp": self.tp, "dp": self.dp,
                "overlap": self.overlap, "tiles": self.tpinfo.tiles,
                "mesh": {"shape": self.mesh.shape,
                         "dim_names": self.mesh.dim_names,
                         "size": self.mesh.size},
                "dp_index": self.dp_index, "tp_index": self.tp_index,
                "kv_bytes_per_token_per_chip": self._kv_bytes_per_token}

    def quant_info(self) -> dict:
        """Same surface as the base engines; `kv_bytes_per_token` is the
        PER-RANK cost — the number that divides each card's memory."""
        wb = {"int8": 8, "int4": 4, "fp8": 8}.get(self.weight_only, 16)
        if self._kind == "mlp":
            w1 = self.params.get("w1")
            if isinstance(w1, dict):
                wb = 4 if "q4" in w1 else 8
        return {"wbits": wb, "kv_bits": self.kv_bits,
                "kv_bytes_per_token": self._kv_bytes_per_token}

    def kv_bytes_per_token(self) -> float:
        return self._kv_bytes_per_token

    # ---- the EngineCore dispatch surface ----
    def ragged_step(self, tokens, q_lens, kv_lens, block_tables):
        """Packed ragged step (see `EngineCore.ragged_step`), on this
        rank's shard. Returns f32 logits [T, V]: replicated on the device
        in overlap mode, a host numpy array in sequential mode."""
        if self._kind == "llama":
            monitor.inc("serving.ragged_steps")
        return self._dispatch("ragged", tokens, q_lens, kv_lens,
                              block_tables)

    def verify_step(self, tokens, context_lens, block_tables):
        """Speculative verify (see `EngineCore.verify_step`) on this
        rank's shard — rides the same sharded ragged stack, so spec ==
        plain under TP. Returns [B, S, V]."""
        ids = np.asarray(tokens, np.int32)
        if ids.ndim != 2:
            raise ValueError(f"verify_step: tokens must be [B, S], got "
                             f"shape {ids.shape}")
        b, s = ids.shape
        if self._kind == "llama":
            monitor.inc("serving.verify_steps")
        logits = self._dispatch("verify", ids.reshape(b * s),
                                np.full((b,), s, np.int32), context_lens,
                                block_tables)
        return logits.reshape(b, s, -1)

    def _check_lockstep(self, step: str, arrays) -> None:
        """The single controller's counterpart: one all-reduce (MAX) of
        [digest, -digest] over the tp group, where the digest hashes the
        step kind and every input array. Equal maxima of both means every
        rank dispatched the same step; otherwise every rank raises
        `LockstepError` here, before the step's first collective, instead
        of hanging or mixing different steps' partial sums."""
        h = hashlib.blake2b(step.encode(), digest_size=8)
        for a in arrays:
            h.update(repr(a.shape).encode())
            h.update(a.tobytes())
        v = int.from_bytes(h.digest(), "little") >> 2
        t = torch.tensor([v, -v], dtype=torch.int64, device=self.device)
        dist.all_reduce(t, op=dist.ReduceOp.MAX, group=self.tpinfo.group)
        hi, neg_lo = t.tolist()
        if hi != v or neg_lo != -v:
            raise LockstepError(
                f"tp rank {self.tp_index} of group "
                f"{dist.get_process_group_ranks(self.tpinfo.group)} "
                f"dispatched a different {step} step from its peers: the "
                "ranks' schedulers diverged (every rank must serve the "
                "same requests and seeds, with no rank-local clock "
                "decisions)")

    def _dispatch(self, step, *args):
        arrays = [np.ascontiguousarray(a, np.int32) for a in args]
        if self.tpinfo.group is not None:
            self._check_lockstep(step, arrays)
        dev = self.device
        tok, q, kv, tables = (torch.as_tensor(a).to(dev) for a in arrays)
        with torch.no_grad():
            if self._kind == "llama":
                from ..inference.llama_runner import _ragged_stack

                logits = _ragged_stack(self.params, self.k_cache,
                                       self.v_cache, self.k_scale,
                                       self.v_scale, tok, q, kv, tables,
                                       self.config)
            else:
                from .engine import _mlp_ragged_stack

                logits = _mlp_ragged_stack(
                    self.params, self.cache, self.cache_scale, tok, q, kv,
                    tables, self.block_size, tp=self.tpinfo)
            if self.overlap:
                return logits
            # sequential-collective baseline: the vocab shards meet only
            # after the step and are assembled on the host, fully
            # exposed — the leg the tiled all-reduces and the device
            # all-gather delete
            if not self._vocab_sharded or self.tpinfo.group is None:
                return logits.cpu().numpy()
            parts = [torch.empty_like(logits) for _ in range(self.tp)]
            dist.all_gather(parts, logits.contiguous(),
                            group=self.tpinfo.group)
            return np.concatenate([p.cpu().numpy() for p in parts], axis=-1)

    def copy_kv_block(self, src: int, dst: int) -> None:
        """COW hook: block ids are logical, and the copy moves this
        rank's slice of the block (every rank's scheduler copies the same
        block) with its int8 scale rows; ids outside the pool raise
        `ValueError` before anything is written (the base engine's
        `_copy_block`)."""
        self._copy_block(self._pools(), src, dst)

    def extract_kv_blocks(self, seq_id: int) -> kv_migrate.KVBlockPayload:
        """Export `seq_id`'s blocks of this rank's pools (its head or
        feature slice — a per-rank payload; no collective). The header's
        `tp` pins the partition, so a payload only injects into the same
        rank of an identically sharded engine. Source pools untouched."""
        return kv_migrate.extract_payload(self.manager, self._mig_header,
                                          self._pools(), self._planes,
                                          self._block_axis, seq_id)

    def inject_kv_blocks(self, seq_id: int,
                         payload: kv_migrate.KVBlockPayload) -> None:
        """Import a per-rank payload under `seq_id`: the header (with its
        `tp` degree) is checked before anything is allocated, capacity
        errors come typed from `allocate`, and a failure after the
        allocation frees it."""
        kv_migrate.inject_payload(self.manager, self._mig_header,
                                  self._pools(), self._planes,
                                  self._block_axis, seq_id, payload)

    # ---- legacy single-chip entries ----
    def _no_legacy(self, entry: str):
        raise RuntimeError(
            f"{entry} is a single-chip legacy entry point; a TP-sharded "
            "engine serves through ragged_step/verify_step (the "
            "scheduler's only dispatches)")

    def prefill(self, *a, **k):
        self._no_legacy("prefill")

    def decode_step(self, *a, **k):
        self._no_legacy("decode_step")

    def generate(self, *a, **k):
        self._no_legacy("generate")
