"""The JAX package's Llama (`paddle_tpu/models/llama.py:31-333`) written in
paddle Layers over eager Tensors.

`LlamaForCausalLM` here is an `nn.Layer` of `nn.Linear` (weights
`[in, out]`, no bias), `nn.Embedding`, `nn.RMSNorm` and `nn.LayerList`,
with the JAX model's parameter names (`llama.layers.0.self_attn.q_proj
.weight`, ...), so `set_state_dict` of the JAX model's state, a JAX
checkpoint through `paddle.load`, and `convert.from_jax_state` into the
`nn.Module` Llama (`models/llama.py`, which training and serving use) all
hold the same arrays. Every op goes through `core.dispatch`, under the
JAX package's op names: attention is `nn.functional.
scaled_dot_product_attention` (the flash kernels on the card), the norms
`nn.RMSNorm` (the RMSNorm kernel), the rotary embedding the plain op
`fused_rope` (as in JAX, not the RoPE kernel), the MLP the plain
`swiglu` op, and the loss `nn.functional.cross_entropy`. So the model
runs eagerly, under lazy mode (`core.lazy_guard`) and under `amp`.

`LlamaModel.remat` keeps the JAX package's eager meaning: JAX applies it
only under a trace, so an eager step with `remat=True` runs without
recompute in both packages. `pipeline_parts` / `pipeline_block_modules`
are not ported yet (they belong to the pipeline engine).
"""
from __future__ import annotations

import numpy as np

from .. import nn
from ..core import dispatch
from ..core.tensor import Tensor
from ..nn import functional as F
from ..ops import linalg
from ..ops import manipulation as M
from ..ops.activation import swiglu
from .llama import LlamaConfig, _apply_rope, _rope_cache

__all__ = ["LlamaConfig", "LlamaAttention", "LlamaMLP", "LlamaDecoderLayer",
           "LlamaModel", "LlamaForCausalLM", "llama_tiny", "llama_7b_shaped",
           "fused_rotary_position_embedding"]

dispatch.register_op("fused_rope", lambda q, k, cos, sin, *, offset:
                     _apply_rope(q, k, cos, sin, offset), multi_out=True)


def fused_rotary_position_embedding(q, k, cos, sin, offset=0):
    """Split-half rotary embedding of q and k `[B, S, H, D]` by the cos /
    sin tables `[T, D/2]` from position `offset` (the plain op)."""
    return dispatch.apply("fused_rope", [q, k, cos, sin],
                          {"offset": int(offset)})


class LlamaAttention(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        h = config.hidden_size
        self.num_heads = config.num_attention_heads
        self.num_kv_heads = config.num_key_value_heads
        self.head_dim = config.head_dim
        self.q_proj = nn.Linear(h, self.num_heads * self.head_dim,
                                bias_attr=False)
        self.k_proj = nn.Linear(h, self.num_kv_heads * self.head_dim,
                                bias_attr=False)
        self.v_proj = nn.Linear(h, self.num_kv_heads * self.head_dim,
                                bias_attr=False)
        self.o_proj = nn.Linear(self.num_heads * self.head_dim, h,
                                bias_attr=False)
        cos, sin = _rope_cache(config)
        self.register_buffer("rope_cos", Tensor(cos), persistable=False)
        self.register_buffer("rope_sin", Tensor(sin), persistable=False)

    def forward(self, x, position_offset=0, kv_cache=None):
        b, s = x.shape[0], x.shape[1]
        q = M.reshape(self.q_proj(x), [b, s, self.num_heads, self.head_dim])
        k = M.reshape(self.k_proj(x), [b, s, self.num_kv_heads,
                                       self.head_dim])
        v = M.reshape(self.v_proj(x), [b, s, self.num_kv_heads,
                                       self.head_dim])
        q, k = fused_rotary_position_embedding(q, k, self.rope_cos,
                                               self.rope_sin,
                                               offset=position_offset)
        new_cache = None
        if kv_cache is not None:
            pk, pv = kv_cache
            if pk is not None:
                k = M.concat([pk, k], axis=1)
                v = M.concat([pv, v], axis=1)
            new_cache = (k, v)
        # GQA K/V stay un-repeated: the flash kernels group them
        causal = kv_cache is None or q.shape[1] > 1
        out = F.scaled_dot_product_attention(q, k, v, is_causal=causal)
        out = self.o_proj(M.reshape(out, [b, s,
                                          self.num_heads * self.head_dim]))
        if kv_cache is not None:
            return out, new_cache
        return out


class LlamaMLP(nn.Layer):
    """The SwiGLU MLP."""

    def __init__(self, config: LlamaConfig):
        super().__init__()
        h, inter = config.hidden_size, config.intermediate_size
        self.gate_proj = nn.Linear(h, inter, bias_attr=False)
        self.up_proj = nn.Linear(h, inter, bias_attr=False)
        self.down_proj = nn.Linear(inter, h, bias_attr=False)

    def forward(self, x):
        return self.down_proj(swiglu(self.gate_proj(x), self.up_proj(x)))


class LlamaDecoderLayer(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.self_attn = LlamaAttention(config)
        self.mlp = LlamaMLP(config)
        self.input_layernorm = nn.RMSNorm(config.hidden_size,
                                          epsilon=config.rms_norm_eps)
        self.post_attention_layernorm = nn.RMSNorm(
            config.hidden_size, epsilon=config.rms_norm_eps)

    def forward(self, x, position_offset=0, kv_cache=None):
        h = self.input_layernorm(x)
        if kv_cache is not None:
            attn, new_cache = self.self_attn(h, position_offset, kv_cache)
        else:
            attn = self.self_attn(h, position_offset)
        x = x + attn
        x = x + self.mlp(self.post_attention_layernorm(x))
        if kv_cache is not None:
            return x, new_cache
        return x


class LlamaModel(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.embed_tokens = nn.Embedding(config.vocab_size,
                                         config.hidden_size)
        self.layers = nn.LayerList(
            [LlamaDecoderLayer(config)
             for _ in range(config.num_hidden_layers)])
        self.norm = nn.RMSNorm(config.hidden_size,
                               epsilon=config.rms_norm_eps)
        # JAX recomputes each layer in the backward only under a trace
        # (jax.checkpoint); an eager step ignores it in both packages
        self.remat = False

    def forward(self, input_ids, position_offset=0, kv_caches=None):
        x = self.embed_tokens(input_ids)
        new_caches = []
        for i, layer in enumerate(self.layers):
            if kv_caches is not None:
                x, c = layer(x, position_offset, kv_caches[i])
                new_caches.append(c)
            else:
                x = layer(x, position_offset)
        x = self.norm(x)
        if kv_caches is not None:
            return x, new_caches
        return x


class LlamaForCausalLM(nn.Layer):
    def __init__(self, config: LlamaConfig):
        super().__init__()
        self.config = config
        self.llama = LlamaModel(config)
        if config.tie_word_embeddings:
            self.lm_head = None
        else:
            self.lm_head = nn.Linear(config.hidden_size, config.vocab_size,
                                     bias_attr=False)

    def forward(self, input_ids, labels=None, position_offset=0,
                kv_caches=None):
        if kv_caches is not None:
            hidden, caches = self.llama(input_ids, position_offset,
                                        kv_caches)
        else:
            hidden = self.llama(input_ids, position_offset)
        if self.lm_head is None:
            logits = linalg.matmul(hidden, self.llama.embed_tokens.weight,
                                   transpose_y=True)
        else:
            logits = self.lm_head(hidden)
        if labels is not None:
            loss = F.cross_entropy(
                M.reshape(logits, [-1, self.config.vocab_size]),
                M.reshape(labels, [-1]))
            return loss, logits
        if kv_caches is not None:
            return logits, caches
        return logits

    def flops_per_token(self, seq_len: int) -> float:
        """Model FLOPs per trained token (forward and backward),
        6 * N_params + 12 * L * H * seq_len, where N counts the embedding
        only when it is tied (then it is also the head)."""
        c = self.config
        n_params = sum(int(np.prod(p.shape))
                       for name, p in self.named_parameters()
                       if c.tie_word_embeddings or "embed_tokens" not in name)
        attn = 12 * c.num_hidden_layers * c.hidden_size * seq_len
        return 6 * n_params + attn


def llama_tiny(vocab=256, layers=2, hidden=64, heads=4, seq=64, **kw):
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=vocab, hidden_size=hidden, intermediate_size=hidden * 3,
        num_hidden_layers=layers, num_attention_heads=heads,
        max_position_embeddings=seq, **kw))


def llama_7b_shaped(num_layers=2, **kw):
    """Llama-2-7B shapes (vocab 32000, hidden 4096, intermediate 11008,
    32 heads of 128, max_position 2048) at `num_layers` layers."""
    return LlamaForCausalLM(LlamaConfig(
        vocab_size=32000, hidden_size=4096, intermediate_size=11008,
        num_hidden_layers=num_layers, num_attention_heads=32,
        max_position_embeddings=2048, **kw))
