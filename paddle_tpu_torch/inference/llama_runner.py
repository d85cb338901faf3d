"""Paged-KV inference engine for the Llama model — the serving
scheduler's `ragged_step`.

The port of `paddle_tpu/inference/llama_runner.py`'s ragged path, in bf16
or f32. Where the JAX engine scans one jitted layer body over stacked
weights, this one loops over the layers in Python. Dense projections go
to `torch.matmul`; weight-only quantized ones (`weight_only='int8'|'fp8'|
'int4'`, or `serving.quant.quantize_engine` after construction) to the
hand-written gemm kernels through `nn.quant.dequant_matmul`. The
attention over the paged pool is the hand-written ragged kernel
(`ops/kernels/paged_attention.py`), for a full-precision pool
(`kv_bits=16`) or an int8 pool with per-slot f32 scale planes
(`kv_bits=8`, quantized on write). Kernels run on the card; CPU tensors
take their plain versions. The KV pool `[L, num_blocks, kv_heads,
block_size, head_dim]` (and its scale planes `[L, num_blocks, kv_heads,
block_size]`) are updated in place (the JAX engine donates them to each
step instead).

Not ported yet, raising `NotImplementedError`: the legacy
`prefill`/`decode_step`/`generate` path, `verify_step`, `copy_kv_block`
and KV migration.
"""
from __future__ import annotations

from typing import Dict

import numpy as np
import torch
import torch.nn.functional as F

from ..framework import monitor
from ..models.llama import LlamaForCausalLM
from ..nn.quant import dequant_matmul, pack_int4, per_channel_quantize
from ..ops.kernels import paged_attention as pk
from ..ops.kernels._support import resolve_device
from . import kv_quant
from .cache import BlockCacheManager

__all__ = ["LlamaInferenceEngine"]


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
    """x [..., K] @ a layer weight: dense `[K, N]` (torch.matmul), or a
    weight-only quantized `{"q": [N, K], "s": [N]}` / int4-packed
    `{"q4": [N, K/2], "s": [N]}` dict (`nn.quant.dequant_matmul`)."""
    if not isinstance(w, dict):
        return torch.matmul(x, w.to(x.dtype))
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
        only dispatch.

        tokens [T] int: packed lane-major query tokens; lane i owns slots
        [sum(q_lens[:i]), sum(q_lens[:i]) + q_lens[i]), its token j at
        position `kv_lens[i] - q_lens[i] + j` (kv_lens counts the cache
        INCLUDING this step's tokens; q_lens[i] == 0 marks an empty
        lane). Returns f32 logits [T, V] on the engine's device; rows at
        guard slots past sum(q_lens) are meaningless (their KV writes are
        dropped, their attention output is zero)."""
        monitor.inc("serving.ragged_steps")
        dev = self.device

        def as_i32(a):
            return torch.as_tensor(np.asarray(a, np.int32)).to(dev)

        with torch.no_grad():
            return _ragged_stack(self.params, self.k_cache, self.v_cache,
                                 self.k_scale, self.v_scale,
                                 as_i32(tokens), as_i32(q_lens),
                                 as_i32(kv_lens), as_i32(block_tables),
                                 self.config)

    def _not_ported(self, entry: str):
        raise NotImplementedError(
            f"{entry} is not ported yet: this engine serves through "
            "ragged_step")

    def prefill(self, *args, **kw):
        self._not_ported("prefill")

    def decode_step(self, *args, **kw):
        self._not_ported("decode_step")

    def generate(self, *args, **kw):
        self._not_ported("generate")

    def verify_step(self, *args, **kw):
        self._not_ported("verify_step")

    def copy_kv_block(self, *args, **kw):
        self._not_ported("copy_kv_block")

    def extract_kv_blocks(self, *args, **kw):
        self._not_ported("extract_kv_blocks")

    def inject_kv_blocks(self, *args, **kw):
        self._not_ported("inject_kv_blocks")


def _layer(x, l: int, params, k_cache, v_cache, k_scale, v_scale, cos, sin,
           tables, kv_lens, tok_lane, tok_pos, write_index, cfg):
    """One decoder layer over the packed tokens x [T, H]; writes this
    step's K/V into layer l's pools in place (quantized, with its scales,
    when the pools are int8)."""
    t = x.shape[0]
    nh, kvh, d = cfg.num_attention_heads, cfg.num_key_value_heads, \
        cfg.head_dim
    h1 = _rms(x, params["ln1"][l], cfg.rms_norm_eps)
    qkv = _mm(h1, params["qkv_w"][l])
    q = qkv[:, :nh * d].reshape(t, nh, d)
    k = qkv[:, nh * d:(nh + kvh) * d].reshape(t, kvh, d)
    v = qkv[:, (nh + kvh) * d:].reshape(t, kvh, d)
    q = _rope_half(q, cos, sin).contiguous()
    k = _rope_half(k, cos, sin)
    kc, vc = k_cache[l], v_cache[l]
    ks = vs = None
    if k_scale is not None:
        ks, vs = k_scale[l], v_scale[l]
    pk.write_kv_to_cache_ragged(k, v, kc, vc, tables, tok_lane, tok_pos,
                                k_scale=ks, v_scale=vs, index=write_index)
    attn = pk.paged_attention_ragged(q, kc, vc, tables, kv_lens, tok_lane,
                                     tok_pos, k_scale=ks, v_scale=vs)
    x = x + _mm(attn.reshape(t, nh * d).to(x.dtype), params["o_w"][l])
    h2 = _rms(x, params["ln2"][l], cfg.rms_norm_eps)
    g, u = torch.chunk(_mm(h2, params["gate_up_w"][l]), 2, dim=-1)
    act = F.silu(g.float()).to(g.dtype) * u
    return x + _mm(act, params["down_w"][l])


def _ragged_stack(params, k_cache, v_cache, k_scale, v_scale, tokens, q_lens,
                  kv_lens, tables, cfg):
    """Packed tokens [T] + per-lane (q_len, kv_len) through the decoder
    stack; returns f32 logits [T, V]."""
    tok_lane, tok_pos = pk.ragged_metadata(q_lens, kv_lens,
                                           tokens.shape[0])
    x = params["embed"][tokens.long()]                          # [T, H]
    positions = torch.clamp(tok_pos, min=0).long()
    cos = params["rope_cos"][positions][:, None, :]             # [T, 1, D/2]
    sin = params["rope_sin"][positions][:, None, :]
    # where this step's K/V land: the same in every layer
    write_index = pk.ragged_write_index(tables, tok_lane, tok_pos,
                                        k_cache.shape[3])
    for l in range(cfg.num_hidden_layers):
        x = _layer(x, l, params, k_cache, v_cache, k_scale, v_scale, cos,
                   sin, tables, kv_lens, tok_lane, tok_pos, write_index, cfg)
    x = _rms(x, params["final_norm"], cfg.rms_norm_eps)
    head = params.get("lm_head")
    if head is None:
        logits = torch.matmul(x, params["embed"].to(x.dtype).t())
    else:
        logits = _mm(x, head)
    return logits.float()
