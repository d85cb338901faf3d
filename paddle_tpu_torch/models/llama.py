"""Llama-family causal LM: config, presets, and the trainable model.

The port of `paddle_tpu/models/llama.py`: `LlamaForCausalLM` is an
`nn.Module` whose parameters carry the names `paddle_tpu.jit.state_arrays`
gives them (`llama.layers.0.self_attn.q_proj.weight`, ...), also as each
parameter's `param_name` (paddle's `p.name`, which the optimizer's
`apply_decay_param_fun` and `state_dict` read). Linear weights stay
`[in, out]` (paddle's layout, the transpose of `torch.nn.Linear`), so
weights move between the two packages unchanged and a projection is
`x @ w`. The forward is the JAX model's: RMSNorm and attention through
`nn.functional` (the hand-written RMSNorm and flash attention kernels on
the card), split-half RoPE, a SwiGLU MLP, and with `labels` the
cross-entropy loss. The serving engine (`inference/llama_runner.py`) runs
its own layers over copies of these weights.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import numpy as np
import torch
import torch.nn.functional as TF
import torch.utils.checkpoint
from torch import nn

from ..nn import functional as F
from ..ops.activation import swiglu
from ..ops.kernels._support import resolve_device

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "llama_tiny", "llama_7b_shaped"]


@dataclasses.dataclass
class LlamaConfig:
    vocab_size: int = 32000
    hidden_size: int = 4096
    intermediate_size: int = 11008
    num_hidden_layers: int = 32
    num_attention_heads: int = 32
    num_key_value_heads: Optional[int] = None  # GQA; None -> MHA
    max_position_embeddings: int = 2048
    rms_norm_eps: float = 1e-6
    rope_theta: float = 10000.0
    tie_word_embeddings: bool = False
    dtype: str = "float32"

    def __post_init__(self):
        if self.num_key_value_heads is None:
            self.num_key_value_heads = self.num_attention_heads

    @property
    def head_dim(self):
        return self.hidden_size // self.num_attention_heads


def _rope_cache(config: LlamaConfig):
    """cos/sin [max_position, head_dim/2], computed in float64 numpy and
    rounded to float32, exactly as the JAX package does."""
    dim = config.head_dim
    inv_freq = 1.0 / (config.rope_theta **
                      (np.arange(0, dim, 2, dtype=np.float64) / dim))
    t = np.arange(config.max_position_embeddings, dtype=np.float64)
    freqs = np.outer(t, inv_freq)
    return np.cos(freqs).astype("float32"), np.sin(freqs).astype("float32")


def _apply_rope(q, k, cos, sin, offset):
    """`llama.py:62-76`: q/k `[B, S, H, D]`, cos/sin `[T, D/2]` sliced at
    `offset` and cast to q's dtype; rotates the halves
    `(x[..., :D/2], x[..., D/2:])`."""
    s = q.shape[1]
    c = cos[offset:offset + s][None, :, None, :].to(q.dtype)
    si = sin[offset:offset + s][None, :, None, :].to(q.dtype)

    def rot(x):
        x1, x2 = torch.chunk(x, 2, dim=-1)
        return torch.cat([x1 * c - x2 * si, x2 * c + x1 * si], dim=-1)

    return rot(q), rot(k)


class _Weight(nn.Module):
    """A layer that only holds `weight` (Linear [in, out], Embedding
    [V, H], RMSNorm [H])."""

    def __init__(self, shape, init: str, **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty(shape, **factory))
        self.init = init


class LlamaAttention(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, d = config.hidden_size, config.head_dim
        nh, kvh = config.num_attention_heads, config.num_key_value_heads
        self.num_heads, self.num_kv_heads, self.head_dim = nh, kvh, d
        self.q_proj = _Weight((h, nh * d), "normal", **factory)
        self.k_proj = _Weight((h, kvh * d), "normal", **factory)
        self.v_proj = _Weight((h, kvh * d), "normal", **factory)
        self.o_proj = _Weight((nh * d, h), "normal", **factory)
        cos, sin = _rope_cache(config)
        dev = factory["device"]
        self.register_buffer("rope_cos", torch.from_numpy(cos).to(dev),
                             persistent=False)
        self.register_buffer("rope_sin", torch.from_numpy(sin).to(dev),
                             persistent=False)

    def forward(self, x, position_offset=0):
        """`llama.py:109-134` without a KV cache: causal attention over
        the whole sequence; GQA K/V are not repeated."""
        b, s = x.shape[0], x.shape[1]
        q = (x @ self.q_proj.weight).reshape(b, s, self.num_heads,
                                             self.head_dim)
        k = (x @ self.k_proj.weight).reshape(b, s, self.num_kv_heads,
                                             self.head_dim)
        v = (x @ self.v_proj.weight).reshape(b, s, self.num_kv_heads,
                                             self.head_dim)
        q, k = _apply_rope(q, k, self.rope_cos, self.rope_sin,
                           position_offset)
        out = F.scaled_dot_product_attention(q, k, v, is_causal=True)
        return out.reshape(b, s, self.num_heads * self.head_dim) \
            @ self.o_proj.weight


class LlamaMLP(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = _Weight((h, inter), "normal", **factory)
        self.up_proj = _Weight((h, inter), "normal", **factory)
        self.down_proj = _Weight((inter, h), "normal", **factory)

    def forward(self, x):
        return swiglu(x @ self.gate_proj.weight, x @ self.up_proj.weight) \
            @ self.down_proj.weight


class LlamaDecoderLayer(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.self_attn = LlamaAttention(config, **factory)
        self.mlp = LlamaMLP(config, **factory)
        self.input_layernorm = _Weight((config.hidden_size,), "ones",
                                       **factory)
        self.post_attention_layernorm = _Weight((config.hidden_size,),
                                                "ones", **factory)
        self.eps = config.rms_norm_eps

    def forward(self, x, position_offset=0):
        h = F.rms_norm(x, self.input_layernorm.weight, self.eps)
        x = x + self.self_attn(h, position_offset)
        return x + self.mlp(F.rms_norm(x, self.post_attention_layernorm.weight,
                                       self.eps))


class LlamaModel(nn.Module):
    def __init__(self, config: LlamaConfig, **factory):
        super().__init__()
        self.embed_tokens = _Weight((config.vocab_size, config.hidden_size),
                                    "normal", **factory)
        self.layers = nn.ModuleList(
            [LlamaDecoderLayer(config, **factory)
             for _ in range(config.num_hidden_layers)])
        self.norm = _Weight((config.hidden_size,), "ones", **factory)
        self.eps = config.rms_norm_eps
        # True: each decoder layer is recomputed in the backward
        # (`torch.utils.checkpoint`) instead of keeping its activations,
        # when gradients are on (the JAX model's `jax.checkpoint` remat)
        self.remat = False

    def forward(self, input_ids, position_offset=0):
        x = TF.embedding(input_ids, self.embed_tokens.weight)
        use_remat = self.remat and torch.is_grad_enabled()
        for layer in self.layers:
            if use_remat:
                x = torch.utils.checkpoint.checkpoint(
                    layer, x, position_offset, use_reentrant=False)
            else:
                x = layer(x, position_offset)
        return F.rms_norm(x, self.norm.weight, self.eps)


class LlamaForCausalLM(nn.Module):
    """The Llama causal LM. `device=None` means the CUDA card (raises
    without one); weights start random — normal(0, 0.02) for projections
    and embeddings, ones for norms — drawn from `generator` on the
    parameters' device, so a seeded generator gives the same model on
    every run. `model(ids)` returns logits `[B, S, V]`;
    `model(ids, labels=labels)` returns `(loss, logits)`."""

    def __init__(self, config: LlamaConfig, device=None, dtype=None,
                 generator: Optional[torch.Generator] = None):
        super().__init__()
        self.config = config
        factory = {"device": resolve_device(device),
                   "dtype": dtype or getattr(torch, config.dtype)}
        self.llama = LlamaModel(config, **factory)
        self.lm_head = None if config.tie_word_embeddings else _Weight(
            (config.hidden_size, config.vocab_size), "normal", **factory)
        for name, p in self.named_parameters():
            p.param_name = name
        self.init_weights(generator)

    def forward(self, input_ids, labels=None, position_offset=0):
        """`llama.py:227-249` without KV caches (those wait for the legacy
        engine paths)."""
        hidden = self.llama(input_ids, position_offset)
        if self.lm_head is None:
            logits = hidden @ self.llama.embed_tokens.weight.t()
        else:
            logits = hidden @ self.lm_head.weight
        if labels is None:
            return logits
        loss = F.cross_entropy(logits.reshape(-1, self.config.vocab_size),
                               labels.reshape(-1))
        return loss, logits

    def flops_per_token(self, seq_len: int) -> float:
        """`llama.py:307-318`: model FLOPs per trained token (forward and
        backward), 6 * N_params + 12 * L * H * seq_len, where N counts the
        embedding only when it is tied (then it is also the head)."""
        c = self.config
        n_params = sum(p.numel() for name, p in self.named_parameters()
                       if c.tie_word_embeddings or "embed_tokens" not in name)
        attn = 12 * c.num_hidden_layers * c.hidden_size * seq_len
        return 6 * n_params + attn

    @torch.no_grad()
    def init_weights(self,
                     generator: Optional[torch.Generator] = None) -> None:
        for m in self.modules():
            if isinstance(m, _Weight):
                if m.init == "ones":
                    m.weight.fill_(1.0)
                else:
                    m.weight.normal_(0.0, 0.02, generator=generator)


def llama_tiny(vocab=256, layers=2, hidden=64, heads=4, seq=64, device=None,
               dtype=None, generator=None, **kw):
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 3,
        num_hidden_layers=layers, num_attention_heads=heads,
        max_position_embeddings=seq, **kw), device=device, dtype=dtype,
        generator=generator)


def llama_7b_shaped(num_layers=2, device=None, dtype=None, generator=None,
                    **kw):
    """Llama-2-7B shapes (vocab 32000, hidden 4096, intermediate 11008,
    32 heads of 128, max_position 2048) at `num_layers` layers."""
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=num_layers, num_attention_heads=32,
        max_position_embeddings=2048, **kw), device=device, dtype=dtype,
        generator=generator)
