"""Paged-KV inference engine for the Llama model: the serving
scheduler's `ragged_step` and `verify_step`, and the legacy `prefill` /
`decode_step` / `generate` path.

The port of `paddle_tpu/inference/llama_runner.py`, in bf16 or f32.
Where the JAX engine scans one jitted layer body over stacked weights,
this one loops over the layers in Python. Dense projections go to
`torch.matmul`; weight-only quantized ones (`weight_only='int8'|'fp8'|
'int4'`, or `serving.quant.quantize_engine` after construction) to the
hand-written gemm kernels through `nn.quant.dequant_matmul`. Attention
over the paged pool (`ops/kernels/paged_attention.py`):
- `ragged_step` and `verify_step` (a ragged step whose lanes all hold a
  window of S tokens): the hand-written ragged kernel, for a
  full-precision pool (`kv_bits=16`) or an int8 pool with per-slot f32
  scale planes (`kv_bits=8`, quantized on write);
- `decode_step`: the hand-written decode kernel;
- `prefill`: the plain causal composite (`nn.functional.attention.
  _sdpa_fn`) over the in-flight tokens, as the JAX engine calls it.
The legacy path needs a full-precision pool; on a `kv_bits=8` engine it
raises before touching the pool or the block manager. Kernels run on the
card; CPU tensors take their plain versions. The KV pool `[L,
num_blocks, kv_heads, block_size, head_dim]` (and its scale planes `[L,
num_blocks, kv_heads, block_size]`) are updated in place (the JAX engine
donates them to each step instead).

`copy_kv_block` copies one pool block across all layers (the prefix
cache's copy-on-write). `extract_kv_blocks` / `inject_kv_blocks` move a
sequence's blocks between engines (`inference/kv_migrate.py`). A
projection weight may also be a multi-LoRA epilogue dict (`serving/
lora.py`), which wraps a dense or quantized base.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch
import torch.nn.functional as F

from ..distributed.tp_overlap import gather_columns, row_parallel_matmul
from ..framework import monitor
from ..models.llama import LlamaForCausalLM
from ..nn.functional.attention import _sdpa_fn
from ..nn.quant import dequant_matmul, pack_int4, per_channel_quantize
from ..ops.kernels import paged_attention as pk
from ..ops.kernels._support import resolve_device
from . import kv_migrate, kv_quant
from .cache import BlockCacheManager

__all__ = ["LlamaInferenceEngine", "GenerationConfig"]


class GenerationConfig:
    """Decoding knobs of `LlamaInferenceEngine.generate` (greedy by
    default)."""

    def __init__(self, max_new_tokens: int = 32, do_sample: bool = False,
                 temperature: float = 1.0, top_p: float = 1.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None,
                 seed: int = 0):
        self.max_new_tokens = max_new_tokens
        self.do_sample = do_sample
        self.temperature = temperature
        self.top_p = top_p
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.seed = seed


def _stack_llama_params(model: LlamaForCausalLM, device, dtype=None) -> Dict:
    """Per-layer weight lists in the fused layout: q/k/v concatenated
    into one `[H, (nh + 2 kvh) d]` projection, gate/up into one
    `[H, 2 I]`, on `device`; float weights are cast to `dtype` when
    given. The model itself is left as it is (a weight already on
    `device` in `dtype` is shared, not copied)."""
    def cast(t):
        return t.detach().to(device=device, dtype=dtype)

    layers = model.llama.layers

    def per_layer(fn):
        return [cast(fn(l)) for l in layers]

    params = {
        "ln1": per_layer(lambda l: l.input_layernorm.weight),
        "qkv_w": per_layer(lambda l: torch.cat(
            [l.self_attn.q_proj.weight, l.self_attn.k_proj.weight,
             l.self_attn.v_proj.weight], dim=1)),
        "o_w": per_layer(lambda l: l.self_attn.o_proj.weight),
        "ln2": per_layer(lambda l: l.post_attention_layernorm.weight),
        "gate_up_w": per_layer(lambda l: torch.cat(
            [l.mlp.gate_proj.weight, l.mlp.up_proj.weight], dim=1)),
        "down_w": per_layer(lambda l: l.mlp.down_proj.weight),
        "embed": cast(model.llama.embed_tokens.weight),
        "final_norm": cast(model.llama.norm.weight),
        "rope_cos": layers[0].self_attn.rope_cos.to(device),
        "rope_sin": layers[0].self_attn.rope_sin.to(device),
    }
    if model.lm_head is not None:
        params["lm_head"] = cast(model.lm_head.weight)
    return params


QUANT_KEYS = ("qkv_w", "o_w", "gate_up_w", "down_w")
# a migration payload's planes, in pool order (`LlamaInferenceEngine._pools`)
KV_PLANES = ("k", "v", "k_scale", "v_scale")
_WBITS = {"int8": 8, "int4": 4, "fp8": 8}
_ALGO = {"int8": "weight_only_int8", "int4": "weight_only_int4",
         "fp8": "fp8"}


def quantize_weight(w: torch.Tensor, algo: str) -> Dict[str, torch.Tensor]:
    """A `[K, N]` weight -> `{"q": int8/fp8 [N, K], "s": f32 [N]}` (int4:
    `{"q4": [N, K/2] split-half packed, "s"}`), per output channel, with
    `nn.quant.per_channel_quantize` / `pack_int4`."""
    if algo not in _ALGO:
        raise ValueError(
            f"weight_only must be 'int8', 'int4' or 'fp8', got {algo}")
    q, scale = per_channel_quantize(w.t(), _ALGO[algo])
    if algo == "int4":
        return {"q4": pack_int4(q), "s": scale}
    return {"q": q, "s": scale}


def _quantize_layers(params, algo: str) -> Dict:
    """Weight-only-quantize every layer's four projections. The lists are
    replaced, so the dense weights are freed once nothing else holds
    them."""
    out = dict(params)
    for key in QUANT_KEYS:
        out[key] = [quantize_weight(w, algo) for w in params[key]]
    return out


def _mm(x, w):
    """x [..., K] @ a layer weight: dense `[K, N]` (torch.matmul), a
    weight-only quantized `{"q": [N, K], "s": [N]}` / int4-packed
    `{"q4": [N, K/2], "s": [N]}` dict (`nn.quant.dequant_matmul`), or a
    multi-LoRA epilogue dict `{"w", "la", "lb"}` that wraps either
    (`serving.lora.lora_mm`)."""
    if not isinstance(w, dict):
        return torch.matmul(x, w.to(x.dtype))
    if "la" in w:
        from ..serving.lora import lora_mm

        return lora_mm(x, w, _mm)
    if "q4" in w:
        return dequant_matmul(x, w["q4"], w["s"], "int4")
    return dequant_matmul(x, w["q"], w["s"])


def _rms(x, w, eps):
    """RMSNorm in f32, multiplied by w in f32, THEN rounded to x's dtype
    (the engine's rounding; `nn.functional.rms_norm` rounds before the
    multiply)."""
    xf = x.float()
    y = xf * torch.rsqrt(xf.pow(2).mean(dim=-1, keepdim=True) + eps)
    return (y * w.float()).to(x.dtype)


def _rope_half(x, cos, sin):
    """Split-half rotation; cos/sin are cast to x's dtype first."""
    c = cos.to(x.dtype)
    s = sin.to(x.dtype)
    x1, x2 = torch.chunk(x, 2, dim=-1)
    return torch.cat([x1 * c - x2 * s, x2 * c + x1 * s], dim=-1)


class LlamaInferenceEngine:
    """Batch inference over `LlamaForCausalLM` with a paged KV cache.

    `device=None` means the CUDA card and raises without one; tests pass
    `device="cpu"`, which runs the kernels' plain PyTorch versions.

    `weight_only='int8'|'int4'|'fp8'` stores the four projection weights
    of every layer quantized per output channel (after the `dtype` cast)
    and multiplies them in the weight-only gemm kernels; the lm_head
    stays dense (`serving.quant.quantize_engine` quantizes an untied
    one). `kv_bits=8` stores the paged KV pool as int8 with per-slot f32
    scale planes, quantized on write and dequantized in the attention
    kernel."""

    def __init__(self, model: LlamaForCausalLM, max_batch_size: int = 8,
                 num_blocks: int = 256, block_size: int = 16,
                 max_blocks_per_seq: int = 16, dtype=None,
                 weight_only: str | None = None, kv_bits: int = 16,
                 device=None):
        if int(kv_bits) not in (8, 16):
            raise ValueError(f"kv_bits must be 8 or 16, got {kv_bits}")
        cfg = model.config
        # JAX clamps a rope lookup past the table; torch raises (on the
        # card, a device assert), so a sequence must fit the table
        if max_blocks_per_seq * block_size > cfg.max_position_embeddings:
            raise ValueError(
                f"max_blocks_per_seq * block_size = "
                f"{max_blocks_per_seq * block_size} exceeds "
                f"max_position_embeddings = {cfg.max_position_embeddings}: "
                "positions past the rope table have no rotation")
        self.device = resolve_device(device)
        self.config = cfg
        self.block_size = block_size
        self.max_batch_size = max_batch_size
        self.kv_bits = int(kv_bits)
        self.manager = BlockCacheManager(num_blocks, block_size,
                                         max_blocks_per_seq)
        with torch.no_grad():
            self.params = _stack_llama_params(model, self.device, dtype)
            self.weight_only = weight_only
            if weight_only is not None:
                self.params = _quantize_layers(self.params, weight_only)
        cdtype = self.params["embed"].dtype
        L = cfg.num_hidden_layers
        kvh, d = cfg.num_key_value_heads, cfg.head_dim
        shape = (L, num_blocks, kvh, block_size, d)
        pool_dtype = torch.int8 if self.kv_bits == 8 else cdtype
        self.k_cache = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        self.v_cache = torch.zeros(shape, dtype=pool_dtype,
                                   device=self.device)
        self.k_scale = self.v_scale = None
        if self.kv_bits == 8:
            planes = kv_quant.scale_shape(shape)
            self.k_scale = torch.zeros(planes, dtype=torch.float32,
                                       device=self.device)
            self.v_scale = torch.zeros(planes, dtype=torch.float32,
                                       device=self.device)
        self._kv_geom = dict(kv_heads=kvh, block_size=block_size,
                             head_dim=d, kv_bits=self.kv_bits,
                             dtype_bytes=self.params["embed"].element_size(),
                             num_layers=L)
        self.manager.set_kv_geometry(
            kv_quant.kv_bytes_per_block(**self._kv_geom), self.kv_bits)
        self._mig_header = {
            "version": kv_migrate.PAYLOAD_VERSION, "engine": "llama",
            "block_size": block_size,
            "max_blocks_per_seq": max_blocks_per_seq,
            "kv_bits": self.kv_bits, "tp": 1, "num_layers": L,
            "kv_heads": kvh, "head_dim": d,
            "dtype": kv_migrate.dtype_name(pool_dtype),
        }

    def kv_bytes_per_token(self) -> float:
        """Device bytes one cached token costs across K+V and all
        layers."""
        return kv_quant.kv_bytes_per_token(**self._kv_geom)

    def quant_info(self) -> dict:
        """The quantization mode the serving metrics publish: weight bits
        (16 = the native dtype), KV bits, and the per-token KV bytes."""
        return {"wbits": _WBITS.get(self.weight_only, 16),
                "kv_bits": self.kv_bits,
                "kv_bytes_per_token": self.kv_bytes_per_token()}

    def ragged_step(self, tokens, q_lens, kv_lens, block_tables):
        """ONE step over a packed ragged batch — the serving scheduler's
        dispatch for its plain (non-speculative) rounds.

        tokens [T] int: packed lane-major query tokens; lane i owns slots
        [sum(q_lens[:i]), sum(q_lens[:i]) + q_lens[i]), its token j at
        position `kv_lens[i] - q_lens[i] + j` (kv_lens counts the cache
        INCLUDING this step's tokens; q_lens[i] == 0 marks an empty
        lane). Returns f32 logits [T, V] on the engine's device; rows at
        guard slots past sum(q_lens) are meaningless (their KV writes are
        dropped, their attention output is zero)."""
        monitor.inc("serving.ragged_steps")
        with torch.no_grad():
            return _ragged_stack(self.params, self.k_cache, self.v_cache,
                                 self.k_scale, self.v_scale,
                                 self._i32(tokens), self._i32(q_lens),
                                 self._i32(kv_lens),
                                 self._i32(block_tables), self.config)

    def _i32(self, a) -> torch.Tensor:
        """Host ints -> an int32 tensor on the engine's device."""
        return torch.as_tensor(np.asarray(a, np.int32)).to(self.device)

    def _require_full_kv(self, entry: str):
        if self.kv_bits != 16:
            raise RuntimeError(
                f"{entry} is a legacy full-precision entry point; a "
                f"kv_bits={self.kv_bits} engine serves through "
                "ragged_step/verify_step (the scheduler's only dispatches)")

    def prefill(self, input_ids, block_tables, lens=None):
        """input_ids [B, S] int; returns f32 next-token logits [B, V] on
        the engine's device.

        `lens` [B] gives the true prompt length per row when `input_ids`
        is right-padded (to a bucket length); logits are taken at
        position `lens - 1`. Padded positions do write (garbage) KV into
        the sequence's own padded block allocation — callers trim via
        `BlockCacheManager.trim`, and decode overwrites position `lens`
        onward, so the garbage is never attended to."""
        self._require_full_kv("prefill")
        ids = np.asarray(input_ids, np.int32)
        b, s = ids.shape
        if lens is None:
            lens = np.full((b,), s, np.int32)
        monitor.inc("serving.prefill_steps")
        with torch.no_grad():
            return _prefill(self.params, self.k_cache, self.v_cache,
                            self._i32(ids), self._i32(block_tables),
                            self._i32(lens), self.config)

    def decode_step(self, tokens, context_lens, block_tables):
        """tokens [B] int (newest token per sequence, already counted in
        context_lens); returns f32 logits [B, V] on the engine's device."""
        self._require_full_kv("decode_step")
        monitor.inc("serving.legacy_decode_steps")
        with torch.no_grad():
            return _decode(self.params, self.k_cache, self.v_cache,
                           self._i32(tokens), self._i32(context_lens),
                           self._i32(block_tables), self.config)

    def verify_step(self, tokens, context_lens, block_tables):
        """Batched multi-token verify pass (speculative decoding), in
        either KV mode.

        tokens [B, S] int — per row, the pending last committed token
        followed by S - 1 draft tokens; `context_lens` [B] counts the
        cache INCLUDING all S of them, so token i is written at position
        `context_lens - S + i` and attends causally up to itself. A ragged
        step whose lanes all hold S tokens. Returns f32 logits [B, S, V]
        on the engine's device: row i is the distribution for the token
        AFTER tokens[:, i]."""
        ids = np.asarray(tokens, np.int32)
        if ids.ndim != 2:
            raise ValueError(f"verify_step: tokens must be [B, S], got "
                             f"shape {ids.shape}")
        b, s = ids.shape
        lens = np.asarray(context_lens, np.int32)
        tables = np.asarray(block_tables, np.int32)
        if lens.shape != (b,) or tables.ndim != 2 or tables.shape[0] != b:
            raise ValueError(f"verify_step: {b} windows need context_lens "
                             f"[{b}] and block_tables [{b}, W], got "
                             f"{lens.shape} and {tables.shape}")
        monitor.inc("serving.verify_steps")
        with torch.no_grad():
            logits = _ragged_stack(
                self.params, self.k_cache, self.v_cache, self.k_scale,
                self.v_scale, self._i32(ids.reshape(b * s)),
                self._i32(np.full((b,), s, np.int32)), self._i32(lens),
                self._i32(tables), self.config)
        return logits.reshape(b, s, -1)

    def generate(self, input_ids, generation_config=None, **kw):
        """Greedy/sampling generation. input_ids: [B, S] (equal-length
        prompts). Returns np.int32 [B, S + new tokens] (fewer new tokens
        when every row hit `eos_token_id`)."""
        # guard BEFORE any allocation: raising from prefill() below
        # would leave the just-leased blocks held
        self._require_full_kv("generate")
        gc = generation_config or GenerationConfig(**kw)
        ids = np.asarray(input_ids, np.int32)
        if ids.ndim == 1:
            ids = ids[None]
        b, s = ids.shape
        if b > self.max_batch_size:
            raise ValueError(f"{b} prompts exceed max_batch_size "
                             f"{self.max_batch_size}")
        seq_ids = list(range(b))
        for sid in seq_ids:
            self.manager.allocate(sid, s)
        try:
            tables = self.manager.block_table_array(seq_ids)
            logits = self.prefill(ids, tables)
            rng = np.random.default_rng(gc.seed)
            out = [ids]
            done = np.zeros(b, bool)
            last = self._pick(logits, gc, rng)
            for _ in range(gc.max_new_tokens):
                out.append(last[:, None])
                if gc.eos_token_id is not None:
                    done |= last == gc.eos_token_id
                    if done.all():
                        break
                for sid in seq_ids:
                    self.manager.append_token(sid)
                tables = self.manager.block_table_array(seq_ids)
                lens = np.asarray([self.manager.seq_len(sid)
                                   for sid in seq_ids], np.int32)
                logits = self.decode_step(last, lens, tables)
                last = self._pick(logits, gc, rng)
        finally:
            for sid in seq_ids:
                self.manager.free(sid)
        return np.concatenate(out, axis=1)

    @staticmethod
    def _pick(logits, gc: GenerationConfig, rng) -> np.ndarray:
        """The JAX engine's host sampler, on f64 numpy logits: greedy
        argmax, or temperature / top-k / top-p draws from `rng` (a numpy
        `default_rng`), so seeded draws equal the JAX package's."""
        logits = logits.cpu().numpy() if torch.is_tensor(logits) \
            else np.asarray(logits)
        if not gc.do_sample:
            return np.argmax(logits, axis=-1).astype(np.int32)
        x = logits.astype(np.float64) / max(gc.temperature, 1e-6)
        if gc.top_k:
            kth = np.partition(x, -gc.top_k, axis=-1)[:, -gc.top_k][:, None]
            x = np.where(x < kth, -np.inf, x)
        p = np.exp(x - x.max(axis=-1, keepdims=True))
        p /= p.sum(axis=-1, keepdims=True)
        if gc.top_p < 1.0:
            order = np.argsort(-p, axis=-1)
            ps = np.take_along_axis(p, order, -1)
            cum = np.cumsum(ps, axis=-1)
            keep = cum - ps < gc.top_p   # always keep the top token
            ps = np.where(keep, ps, 0.0)
            ps /= ps.sum(axis=-1, keepdims=True)
            picked = np.stack([rng.choice(ps.shape[1], p=ps[i])
                               for i in range(ps.shape[0])])
            return np.take_along_axis(order, picked[:, None], -1)[:, 0] \
                .astype(np.int32)
        return np.stack([rng.choice(p.shape[1], p=p[i])
                         for i in range(p.shape[0])]).astype(np.int32)

    def copy_kv_block(self, src: int, dst: int) -> None:
        """Copy physical block `src` onto block `dst` in every layer's K
        and V pool (the `BlockCacheManager` copy-on-write hook, wired by
        the scheduler when prefix caching is on); on an int8 pool both
        scale planes' rows move in the same call, so a block's q bytes
        and its scales never part. An indexed tensor copy on the pool's
        device, as the JAX engine's jitted `.at[].set`.

        `src` and `dst` are checked on the host before anything is
        enqueued: an id outside the pool raises `ValueError` and leaves
        the pool and the manager's books as they were. A fault the card
        reports later (CUDA errors surface asynchronously, at a later
        synchronizing call) is past that point: `_cow`'s promise that a
        failing hook leaves the pool as it was holds only for what the
        host can refuse."""
        self._copy_block(self._pools(), src, dst)

    def _pools(self):
        """The pool tensors a block spans: K and V, and on an int8 pool
        both scale planes, in the payload's plane order."""
        if self.k_scale is None:
            return [self.k_cache, self.v_cache]
        return [self.k_cache, self.v_cache, self.k_scale, self.v_scale]

    @staticmethod
    def _copy_block(pools, src: int, dst: int) -> None:
        """Copy block `src` onto `dst` along the block axis (1) of every
        tensor in `pools`, after checking both ids on the host."""
        nb = pools[0].shape[1]
        src, dst = int(src), int(dst)
        if not (0 <= src < nb and 0 <= dst < nb):
            raise ValueError(f"copy_kv_block: blocks ({src}, {dst}) "
                             f"outside the pool of {nb}")
        with torch.no_grad():
            for pool in pools:
                pool[:, dst].copy_(pool[:, src])

    def extract_kv_blocks(self, seq_id: int) -> kv_migrate.KVBlockPayload:
        """Export `seq_id`'s committed KV blocks across all layers: one
        indexed copy per pool tensor along the block axis (`{"k", "v"}`,
        and `"k_scale"`, `"v_scale"` on an int8 pool), one slab row a
        real block. The source pools are untouched."""
        return kv_migrate.extract_payload(self.manager, self._mig_header,
                                          self._pools(), KV_PLANES, 1,
                                          seq_id)

    def inject_kv_blocks(self, seq_id: int,
                         payload: kv_migrate.KVBlockPayload) -> None:
        """Import a migrated payload under `seq_id`: the header is checked
        before anything is allocated, the manager's typed capacity errors
        propagate from `allocate`, and any failure after allocation frees
        the blocks again. The payload's slabs are copied, not taken."""
        kv_migrate.inject_payload(self.manager, self._mig_header,
                                  self._pools(), KV_PLANES, 1, seq_id,
                                  payload)

def _layer(x, l: int, params, cos, sin, attend, cfg):
    """One decoder layer over tokens x [..., H] (any leading shape).
    `attend(l, q, k, v)` writes this step's K/V into layer l's pools in
    place and returns the attention [..., nh, d].

    A cfg carrying a `tp` (`distributed.tp_overlap.TPInfo`, set by
    `serving/tp.py`) marks a tensor-parallel shard: its head counts are
    the local ones, qkv / gate_up are column shards holding whole heads
    (resp. matching gate | up halves), and o / down are row shards whose
    partial sums are all-reduced tile by tile over the tp group, so tile
    k's reduction overlaps tile k+1's gemm."""
    lead = x.shape[:-1]
    tp = getattr(cfg, "tp", None)

    def row_mm(a, w):
        if tp is None:
            return _mm(a, w)
        return row_parallel_matmul(a, w, group=tp.group, ntiles=tp.tiles,
                                   mm=_mm)

    nh, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    h1 = _rms(x, params["ln1"][l], cfg.rms_norm_eps)
    qkv = _mm(h1, params["qkv_w"][l])
    q = qkv[..., :nh * d].reshape(*lead, nh, d)
    k = qkv[..., nh * d:(nh + kvh) * d].reshape(*lead, kvh, d)
    v = qkv[..., (nh + kvh) * d:].reshape(*lead, kvh, d)
    q = _rope_half(q, cos, sin).contiguous()
    k = _rope_half(k, cos, sin)
    attn = attend(l, q, k, v)
    x = x + row_mm(attn.reshape(*lead, nh * d).to(x.dtype),
                   params["o_w"][l])
    h2 = _rms(x, params["ln2"][l], cfg.rms_norm_eps)
    g, u = torch.chunk(_mm(h2, params["gate_up_w"][l]), 2, dim=-1)
    act = F.silu(g.float()).to(g.dtype) * u
    return x + row_mm(act, params["down_w"][l])


def _rope_at(params, positions):
    """cos/sin rows at `positions` [...] -> [..., 1, D/2]. A position
    past the table takes its last row, as JAX's clamping gather does;
    only the unused tail of a verify window near the length cap gets
    there (its logits are never read)."""
    pos = torch.clamp(positions.long(), 0, params["rope_cos"].shape[0] - 1)
    return params["rope_cos"][pos][..., None, :], \
        params["rope_sin"][pos][..., None, :]


def _logits(params, x, cfg):
    """Final norm and head: f32 logits [..., V]. On a TP shard (`cfg.tp`)
    an untied head is a vocab column shard, all-gathered when
    `tp.gather_logits` is set (else the shard is returned for the caller
    to assemble); a tied head, the embedding, stays replicated."""
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        return torch.matmul(x, params["embed"].to(x.dtype).t()).float()
    logits = _mm(x, head)
    tp = getattr(cfg, "tp", None)
    if tp is not None and tp.gather_logits:
        logits = gather_columns(logits, tp.group)
    return logits.float()


def _ragged_stack(params, k_cache, v_cache, k_scale, v_scale, tokens, q_lens,
                  kv_lens, tables, cfg):
    """Packed tokens [T] + per-lane (q_len, kv_len) through the decoder
    stack, writing their K/V (quantized, with its scales, into int8
    pools); returns f32 logits [T, V]."""
    tok_lane, tok_pos = pk.ragged_metadata(q_lens, kv_lens,
                                           tokens.shape[0])
    x = params["embed"][tokens.long()]                          # [T, H]
    cos, sin = _rope_at(params, tok_pos)                        # [T, 1, D/2]
    # where this step's K/V land: the same in every layer
    write_index = pk.ragged_write_index(tables, tok_lane, tok_pos,
                                        k_cache.shape[3])

    def attend(l, q, k, v):
        kc, vc = k_cache[l], v_cache[l]
        ks = vs = None
        if k_scale is not None:
            ks, vs = k_scale[l], v_scale[l]
        pk.write_kv_to_cache_ragged(k, v, kc, vc, tables, tok_lane, tok_pos,
                                    k_scale=ks, v_scale=vs,
                                    index=write_index)
        return pk.paged_attention_ragged(q, kc, vc, tables, kv_lens,
                                         tok_lane, tok_pos, k_scale=ks,
                                         v_scale=vs)

    for l in range(cfg.num_hidden_layers):
        x = _layer(x, l, params, cos, sin, attend, cfg)
    return _logits(params, x, cfg)


def _prefill(params, k_cache, v_cache, ids, tables, lens, cfg):
    """`_prefill_fn`: prompts ids [B, S] at positions 0..S-1, their K/V
    written into each row's table, causal attention over the in-flight
    tokens only (the plain composite `_sdpa_fn`, K/V heads repeated for
    GQA, as the JAX engine calls it); f32 logits [B, V] at `lens - 1`."""
    b, s = ids.shape
    x = params["embed"][ids.long()]                             # [B, S, H]
    positions = torch.arange(s, device=ids.device)[None, :].expand(b, s)
    cos, sin = _rope_at(params, positions)                   # [B, S, 1, D/2]
    start = torch.zeros((b,), dtype=torch.int32, device=ids.device)

    def attend(l, q, k, v):
        pk.write_kv_to_cache(k, v, k_cache[l], v_cache[l], tables, start)
        return _sdpa_fn(q, k, v, True)

    for l in range(cfg.num_hidden_layers):
        x = _layer(x, l, params, cos, sin, attend, cfg)
    last = torch.clamp(lens.long() - 1, 0, s - 1)
    return _logits(params, x[torch.arange(b, device=ids.device), last], cfg)


def _decode(params, k_cache, v_cache, tokens, ctx_lens, tables, cfg):
    """`_decode_fn`: one token per sequence at position ctx_lens - 1, its
    K/V written there, paged attention over positions < ctx_lens
    (`paged_attention`: the decode kernel on the card, its plain version
    on the CPU; JAX's `_layer_body` takes the plain version for inputs
    its kernel refuses, the port raises on the card); f32 logits
    [B, V]."""
    x = params["embed"][tokens.long()]                          # [B, H]
    start = ctx_lens - 1
    cos, sin = _rope_at(params, start)                          # [B, 1, D/2]

    def attend(l, q, k, v):
        kc, vc = k_cache[l], v_cache[l]
        pk.write_kv_to_cache(k[:, None], v[:, None], kc, vc, tables, start)
        return pk.paged_attention(q, kc, vc, tables, ctx_lens)

    for l in range(cfg.num_hidden_layers):
        x = _layer(x, l, params, cos, sin, attend, cfg)
    return _logits(params, x, cfg)
