"""EngineCore — the model-agnostic serving engine protocol the scheduler
programs against, and `MLPLMEngine`, its second implementation (the port
of `paddle_tpu/serving/engine.py`).

An engine owns the model weights and a paged KV pool, exposes its
`BlockCacheManager` as `manager`, and serves through `ragged_step` (the
scheduler's plain rounds) and `verify_step` (its speculative rounds); a
draft engine behind `DraftEngineProposer` is driven through `prefill`
and `decode_step`; `copy_kv_block` backs the prefix cache's
copy-on-write; `extract_kv_blocks` / `inject_kv_blocks`, where an engine
has them, move a sequence's blocks between engines
(`inference/kv_migrate.py`).

Failure contract: an engine may raise from a step. A typed
`EngineStepError(phase, seq_ids=...)` names the poisoned lane(s) and
fails only those requests; any other exception is attributed by
per-lane probe replays in the scheduler's fault boundary, retried a
bounded number of times when no lane is culpable, then escalated to the
watchdog (`serving/fault_tolerance.py`). Engines whose device state can
be corrupted pair with an `engine_factory` (e.g. `MLPLMEngine.respawn`)
so the watchdog can rebuild them.
"""
from __future__ import annotations

from typing import Protocol, runtime_checkable

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.tp_overlap import (axis_index, gather_columns,
                                     row_parallel_matmul)
from ..inference import kv_migrate, kv_quant
from ..inference.cache import BlockCacheManager
from ..inference.llama_runner import _mm
from ..ops.kernels._support import resolve_device
from ..ops.kernels.paged_attention import ragged_metadata

__all__ = ["EngineCore", "MLPLMEngine"]

# a migration payload's planes, in pool order (`MLPLMEngine._pools`)
MLP_PLANES = ("cache", "scale")


@runtime_checkable
class EngineCore(Protocol):
    """Structural protocol: `LlamaInferenceEngine` and `MLPLMEngine`
    satisfy it as they are."""

    max_batch_size: int
    manager: BlockCacheManager

    def ragged_step(self, tokens: np.ndarray, q_lens: np.ndarray,
                    kv_lens: np.ndarray, block_tables: np.ndarray):
        """ONE step over a packed ragged batch: tokens [T] lane-major
        (lane i owns q_lens[i] consecutive slots, token j at position
        kv_lens[i] - q_lens[i] + j; q_len 0 = empty lane). Returns logits
        [T, V] (a tensor on the engine's device)."""
        ...

    def verify_step(self, tokens: np.ndarray, context_lens: np.ndarray,
                    block_tables: np.ndarray):
        """Speculative verify: tokens [B, S] (pending token + S - 1
        drafts per lane), token i written at position
        `context_lens - S + i` and attending causally up to itself.
        Returns logits [B, S, V]; row i is the distribution for the token
        after tokens[:, i]."""
        ...

    def prefill(self, input_ids: np.ndarray, block_tables: np.ndarray,
                lens: np.ndarray | None = None):
        """Prompts [B, S] (right-padded; `lens` the true lengths) written
        at positions 0..S-1; returns next-token logits [B, V]."""
        ...

    def decode_step(self, tokens: np.ndarray, context_lens: np.ndarray,
                    block_tables: np.ndarray):
        """One token per sequence at position `context_lens - 1`; returns
        logits [B, V]."""
        ...

    def copy_kv_block(self, src: int, dst: int) -> None:
        """Copy physical pool block `src` onto block `dst` (the
        `BlockCacheManager` copy-on-write hook)."""
        ...


def _i32(a, device) -> torch.Tensor:
    """Host ints -> an int32 tensor on `device`."""
    return torch.as_tensor(np.asarray(a, np.int32)).to(device)


def _mlp_head(params, last, mean, tp=None):
    """`gelu([last, mean] @ w1 + b1) @ w2 + b2`, f32 (tanh gelu). The
    weights take every form `llama_runner._mm` takes: dense, weight-only
    quantized, or a multi-LoRA epilogue dict wrapping either.

    Under TP (`tp` a `distributed.tp_overlap.TPInfo`): `last` / `mean`
    are the local feature slices, `w1` the matching row shard (rows
    permuted by `serving/tp.py` so shard s holds [last_s, mean_s]) whose
    partial sums are all-reduced tile by tile, and `w2` / `b2` vocab
    column shards; `tp.gather_logits` all-gathers the logits so the
    sampler sees replicated ones."""
    h = torch.cat([last, mean], dim=-1)
    if tp is None:
        h = _mm(h, params["w1"])
    else:
        h = row_parallel_matmul(h, params["w1"], group=tp.group,
                                ntiles=tp.tiles, mm=_mm)
    h = F.gelu(h + params["b1"], approximate="tanh")
    logits = _mm(h, params["w2"]) + params["b2"]
    if tp is not None and tp.gather_logits:
        logits = gather_columns(logits, tp.group)
    return logits


def _mlp_ragged_stack(params, cache, cache_scale, tokens, q_lens, kv_lens,
                      tables, block_size: int, tp=None):
    """Packed tokens [T] + per-lane (q_len, kv_len) over the embedding
    pool `cache` (int8 with its `cache_scale` plane, or f32 with None):
    token t embeds, writes its embedding (quantized on an int8 pool) at
    its absolute position in place (guard slots write nothing), and
    conditions on (own embedding, masked mean of its lane's window
    through its position) — what a sequence of decode steps computes.
    Returns f32 logits [T, V].

    `tp` (set by `serving/tp.py`) marks a feature-sharded pool: each
    shard writes and gathers its contiguous D/tp embedding slice, the
    int8 scale is computed over the FULL feature vector (absmax is a
    global reduction: a per-shard scale would change the bits) and its
    plane stays replicated, and the head runs w1 row-parallel / w2
    column-parallel (`_mlp_head`)."""
    bs = block_size
    b, maxb = tables.shape
    tok_lane, tok_pos = ragged_metadata(q_lens, kv_lens, tokens.shape[0])
    x = params["embed"][tokens.long()]                           # [T, D]
    x_loc = x
    if tp is not None:
        dl = cache.shape[-1]                  # local feature width D/tp
        off = axis_index(tp) * dl
        x_loc = x[:, off:off + dl]
    pos = torch.clamp(tok_pos.long(), min=0)
    blocks = tables.long()[tok_lane.long(), pos // bs]           # [T]
    valid = tok_pos >= 0
    idx = (blocks[valid], (pos % bs)[valid])
    if cache_scale is not None:
        q, s = kv_quant.quantize_kv(x)                           # [T, D], [T]
        if tp is not None:
            q = q[:, off:off + dl]
        cache[idx] = q[valid]
        cache_scale[idx] = s[valid]
        window = kv_quant.dequantize_kv(
            cache[tables.long()], cache_scale[tables.long()])    # [B, MAXB, BS, D]
    else:
        cache[idx] = x_loc[valid]
        window = cache[tables.long()]
    window = window.reshape(b, maxb * bs, -1)[tok_lane.long()]  # [T, W, D]
    wpos = torch.arange(maxb * bs, dtype=torch.int32, device=x.device)
    mask = (wpos[None, :] <= tok_pos[:, None]).to(x.dtype)
    mean = (window * mask[..., None]).sum(1) / torch.clamp(
        mask.sum(1, keepdim=True), min=1.0)
    return _mlp_head(params, x_loc, mean, tp).float()


class MLPLMEngine:
    """Bag-of-embeddings MLP language model over the paged cache
    (EngineCore #2), the port of the JAX package's `MLPLMEngine`.

    The "KV" pool is `[num_blocks, block_size, D]` token embeddings (int8
    with a `[num_blocks, block_size]` f32 scale plane at `kv_bits=8`,
    quantized per slot as `inference/kv_quant.py` does); a token's logits
    are `gelu([own embedding, masked mean of its lane's window] @ w1 +
    b1) @ w2 + b2` (tanh gelu, f32). Same paged bookkeeping and step
    contract as the Llama engine at a tiny size, so the scheduler and
    frontend stack run model-agnostic scenarios fast. Plain tensor code:
    the JAX engine has no Pallas body. Weights are drawn from
    `numpy.random.default_rng(seed)` exactly as the JAX engine draws
    them, so one seed gives both packages the same weights
    (`convert.mlp_from_jax_params` loads a JAX engine's weights too).

    `device=None` means the CUDA card and raises without one; tests pass
    `device="cpu"`. `w1` / `w2` may be weight-only quantized
    (`serving.quant.quantize_engine`) and wrapped in LoRA epilogues
    (`serving.lora.attach_adapters`); `extract_kv_blocks` /
    `inject_kv_blocks` migrate a sequence's blocks between engines."""

    def __init__(self, vocab_size: int = 256, hidden: int = 32,
                 max_batch_size: int = 8, num_blocks: int = 64,
                 block_size: int = 8, max_blocks_per_seq: int = 8,
                 seed: int = 0, kv_bits: int = 16, device=None):
        self.kv_bits = int(kv_bits)
        if self.kv_bits not in (8, 16):
            raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
        self.device = resolve_device(device)
        self._init_kwargs = dict(
            vocab_size=vocab_size, hidden=hidden,
            max_batch_size=max_batch_size, num_blocks=num_blocks,
            block_size=block_size, max_blocks_per_seq=max_blocks_per_seq,
            seed=seed, kv_bits=kv_bits, device=self.device)
        self.vocab_size = vocab_size
        self.max_batch_size = max_batch_size
        self.block_size = block_size
        self.manager = BlockCacheManager(num_blocks, block_size,
                                         max_blocks_per_seq)
        rng = np.random.default_rng(seed)
        d = hidden

        def init(*shape):
            return torch.as_tensor(rng.normal(0, 0.08, shape).astype(
                np.float32)).to(self.device)

        def zeros(n):
            return torch.zeros((n,), dtype=torch.float32,
                               device=self.device)

        # drawn in the JAX engine's order: embed, w1, w2
        self.params = {"embed": init(vocab_size, d)}
        self.params["w1"] = init(2 * d, 2 * d)
        self.params["b1"] = zeros(2 * d)
        self.params["w2"] = init(2 * d, vocab_size)
        self.params["b2"] = zeros(vocab_size)
        if self.kv_bits == 8:
            self.cache = torch.zeros((num_blocks, block_size, d),
                                     dtype=torch.int8, device=self.device)
            self.cache_scale = torch.zeros((num_blocks, block_size),
                                           dtype=torch.float32,
                                           device=self.device)
            bpb = block_size * d * 1 + block_size * 4
        else:
            self.cache = torch.zeros((num_blocks, block_size, d),
                                     dtype=torch.float32, device=self.device)
            self.cache_scale = None
            bpb = block_size * d * 4
        self._kv_bytes_per_token = bpb / block_size
        self.manager.set_kv_geometry(bpb, self.kv_bits)
        self._mig_header = {
            "version": kv_migrate.PAYLOAD_VERSION, "engine": "mlp",
            "block_size": block_size,
            "max_blocks_per_seq": max_blocks_per_seq,
            "kv_bits": self.kv_bits, "tp": 1, "hidden": hidden,
            "dtype": kv_migrate.dtype_name(self.cache.dtype),
        }

    def kv_bytes_per_token(self) -> float:
        """Device bytes one cached token costs (int8 pools include the
        scale plane)."""
        return self._kv_bytes_per_token

    def quant_info(self) -> dict:
        """The quantization mode the serving metrics publish: `wbits` 16
        for f32 weights, 8 or 4 after `serving.quant.quantize_engine`."""
        wb = 16
        w1 = self.params.get("w1")
        if isinstance(w1, dict):
            wb = 4 if "q4" in w1 else 8
        return {"wbits": wb, "kv_bits": self.kv_bits,
                "kv_bytes_per_token": self._kv_bytes_per_token}

    def copy_kv_block(self, src: int, dst: int) -> None:
        """Copy one physical cache block (`BlockCacheManager` COW hook,
        wired by the scheduler when prefix caching is on): the block's
        whole `[block_size, D]` slab and, on an int8 pool, its scale row
        in the same call. Ids outside the pool raise `ValueError` on the
        host before anything is enqueued (see
        `LlamaInferenceEngine.copy_kv_block` for what an asynchronous
        device fault means for the manager's books)."""
        self._copy_block(self._pools(), src, dst)

    def _pools(self):
        """The pool tensors a block spans: the embeddings, and on an int8
        pool the scale plane, in the payload's plane order."""
        if self.cache_scale is None:
            return [self.cache]
        return [self.cache, self.cache_scale]

    @staticmethod
    def _copy_block(pools, src: int, dst: int) -> None:
        """Copy block `src` onto `dst` along the block axis (0) of every
        tensor in `pools`, after checking both ids on the host."""
        nb = pools[0].shape[0]
        src, dst = int(src), int(dst)
        if not (0 <= src < nb and 0 <= dst < nb):
            raise ValueError(f"copy_kv_block: blocks ({src}, {dst}) "
                             f"outside the pool of {nb}")
        with torch.no_grad():
            for pool in pools:
                pool[dst].copy_(pool[src])

    def respawn(self) -> "MLPLMEngine":
        """A fresh engine with IDENTICAL weights (seed-derived) and an
        empty pool, on the same device — the watchdog `engine_factory`
        for this engine class (`engine_factory=engine.respawn`)."""
        return MLPLMEngine(**self._init_kwargs)

    def extract_kv_blocks(self, seq_id: int) -> kv_migrate.KVBlockPayload:
        """Export `seq_id`'s committed blocks: one indexed copy of the
        embedding pool (`"cache"`) and, on an int8 pool, of its scale
        plane (`"scale"`), one slab row a real block. The source pool is
        untouched."""
        return kv_migrate.extract_payload(self.manager, self._mig_header,
                                          self._pools(), MLP_PLANES, 0,
                                          seq_id)

    def inject_kv_blocks(self, seq_id: int,
                         payload: kv_migrate.KVBlockPayload) -> None:
        """Import a migrated payload under `seq_id` (see
        `LlamaInferenceEngine.inject_kv_blocks`)."""
        kv_migrate.inject_payload(self.manager, self._mig_header,
                                  self._pools(), MLP_PLANES, 0, seq_id,
                                  payload)

    def _require_full_kv(self, entry: str):
        if self.kv_bits != 16:
            raise RuntimeError(
                f"{entry} is a legacy full-precision entry point; a "
                f"kv_bits={self.kv_bits} engine serves through "
                "ragged_step/verify_step (the scheduler's only dispatches)")

    def _ragged(self, tokens, q_lens, kv_lens, tables):
        return _mlp_ragged_stack(self.params, self.cache, self.cache_scale,
                                 tokens, q_lens, kv_lens, tables,
                                 self.block_size)

    def ragged_step(self, tokens, q_lens, kv_lens, block_tables):
        """Packed ragged step; see `EngineCore.ragged_step`."""
        dev = self.device
        with torch.no_grad():
            return self._ragged(_i32(tokens, dev), _i32(q_lens, dev),
                                _i32(kv_lens, dev), _i32(block_tables, dev))

    def verify_step(self, tokens, context_lens, block_tables):
        """Multi-token verify pass; see `EngineCore.verify_step`. A ragged
        step whose lanes all hold a window of S tokens."""
        ids = np.asarray(tokens, np.int32)
        b, s = ids.shape
        dev = self.device
        with torch.no_grad():
            logits = self._ragged(
                _i32(ids.reshape(b * s), dev),
                _i32(np.full((b,), s, np.int32), dev),
                _i32(context_lens, dev), _i32(block_tables, dev))
        return logits.reshape(b, s, -1)

    def prefill(self, input_ids, block_tables, lens=None):
        """Prompts [B, S] at positions 0..S-1 (right-padded; `lens` the
        true lengths): every position's embedding is written through the
        row's table, and the logits [B, V] condition on the embedding at
        `lens - 1` and the masked mean of the first `lens` embeddings."""
        self._require_full_kv("prefill")
        ids = np.asarray(input_ids, np.int32)
        b, s = ids.shape
        if lens is None:
            lens = np.full((b,), s, np.int32)
        dev, bs = self.device, self.block_size
        with torch.no_grad():
            ids_t = _i32(ids, dev)
            tables = _i32(block_tables, dev).long()
            lens_t = _i32(lens, dev)
            x = self.params["embed"][ids_t.long()]               # [B, S, D]
            p = torch.arange(s, device=dev)
            blocks = tables[:, p // bs]                          # [B, S]
            offs = (p % bs)[None, :].expand(b, s)
            self.cache[blocks.reshape(-1), offs.reshape(-1)] = \
                x.reshape(b * s, -1)
            mask = (p[None, :] < lens_t[:, None]).to(x.dtype)
            mean = (x * mask[..., None]).sum(1) / torch.clamp(
                mask.sum(1, keepdim=True), min=1.0)
            last_i = torch.clamp(lens_t.long() - 1, 0, s - 1)
            last = x[torch.arange(b, device=dev), last_i]
            return _mlp_head(self.params, last, mean).float()

    def decode_step(self, tokens, context_lens, block_tables):
        """One token per sequence, written at `context_lens - 1`; logits
        [B, V] condition on its embedding and the masked mean of the
        sequence's window."""
        self._require_full_kv("decode_step")
        tok = np.asarray(tokens, np.int32)
        q_lens = np.ones(tok.shape, np.int32)
        return self.ragged_step(tok, q_lens, context_lens, block_tables)
