"""The fused-layer workload, in one place: both `chip_smoke.py` (which
checks and times it) and `paddle_tpu_torch.tools.layer_profile` (which
profiles it) build it here, so the two always measure the same thing.

One Llama decoder layer at Llama-2-7B width (hidden 4096, 32 heads of
128, intermediate 11008), bf16, batch 4 x 2048 tokens, written as
PaddleNLP writes it with the fused-op surface
(`paddle_tpu_torch.incubate.nn.functional`): `fused_rms_norm` -> one qkv
gemm -> `fused_rotary_position_embedding(use_neox_rotary_style=False)`
on views of the qkv product -> flash attention -> o ->
`fused_rms_norm(residual=)` -> the MLP, in either PaddleNLP form:
`swiglu(gate, up)` ("two") or `swiglu(gate_up)` ("packed"). Beside it,
the model's own `LlamaDecoderLayer` ("llama_layer") on the same weights.
Weights are random (normal(0, 0.02), norms 1 + normal(0, 0.1)) from a
seeded `torch.Generator` on the device, in paddle's `[in, out]` layout,
and require gradients: a step is one forward and one backward.
"""
from __future__ import annotations

import torch

BATCH, SEQ, HIDDEN, INTER, HEADS, EPS = 4, 2048, 4096, 11008, 32, 1e-6
RUNS = ("two", "packed", "llama_layer")


class LayerWorkload:
    """The weights (`wt`, with the concatenated `qkv` and `gate_up`), the
    model's layer on the same weights, the f32 RoPE tables, one input
    batch `x0` and one output gradient `dy`."""

    def __init__(self, device="cuda", seed=41):
        from ..models import LlamaConfig
        from ..models.llama import LlamaDecoderLayer

        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)

        def w(*shape, norm=False):
            t = torch.randn(shape, generator=gen, device=dev)
            t = 1 + 0.1 * t if norm else 0.02 * t
            return t.to(torch.bfloat16)

        h, i = HIDDEN, INTER
        wt = {"input_layernorm": w(h, norm=True),
              "post_attention_layernorm": w(h, norm=True),
              "q": w(h, h), "k": w(h, h), "v": w(h, h), "o": w(h, h),
              "gate": w(h, i), "up": w(h, i), "down": w(i, h)}
        wt["qkv"] = torch.cat([wt["q"], wt["k"], wt["v"]], dim=1)
        wt["gate_up"] = torch.cat([wt["gate"], wt["up"]], dim=1)
        self.wt = {k: v.requires_grad_() for k, v in wt.items()}
        self.config = LlamaConfig(hidden_size=h, intermediate_size=i,
                                  num_attention_heads=HEADS,
                                  num_hidden_layers=1, rms_norm_eps=EPS)
        layer = LlamaDecoderLayer(self.config, device=dev,
                                  dtype=torch.bfloat16)
        attn, mlp = layer.self_attn, layer.mlp
        with torch.no_grad():
            for mod, key in ((attn.q_proj, "q"), (attn.k_proj, "k"),
                             (attn.v_proj, "v"), (attn.o_proj, "o"),
                             (mlp.gate_proj, "gate"), (mlp.up_proj, "up"),
                             (mlp.down_proj, "down"),
                             (layer.input_layernorm, "input_layernorm"),
                             (layer.post_attention_layernorm,
                              "post_attention_layernorm")):
                mod.weight.copy_(wt[key])
        self.llama_layer = layer
        self.cos, self.sin = attn.rope_cos, attn.rope_sin   # f32 [2048, 64]
        self.x0 = torch.randn((BATCH, SEQ, HIDDEN), generator=gen,
                              device=dev).to(torch.bfloat16)
        self.dy = torch.randn((BATCH, SEQ, HIDDEN), generator=gen,
                              device=dev).to(torch.bfloat16)

    def forward(self, run, x):
        """The layer `run` ("two", "packed" or "llama_layer") on x."""
        if run == "llama_layer":
            return self.llama_layer(x)
        return incubate_layer(self.wt, x, self.cos, self.sin, run)

    def step(self, run):
        """One forward and backward of `run` from fresh gradients; returns
        (output, input gradient)."""
        for t in [*self.wt.values(), *self.llama_layer.parameters()]:
            t.grad = None
        x = self.x0.clone().requires_grad_()
        y = self.forward(run, x)
        y.backward(self.dy)
        return y.detach(), x.grad


def incubate_layer(wt, x, cos, sin, form):
    """The decoder layer through `incubate.nn.functional`; `form` "two"
    (`swiglu(gate, up)`) or "packed" (`swiglu(gate_up)`)."""
    from ..incubate.nn import functional as IF
    from ..nn import functional as NF

    b, s, hid = x.shape
    d = hid // HEADS
    h = IF.fused_rms_norm(x, wt["input_layernorm"], epsilon=EPS)
    qkv = (h @ wt["qkv"]).view(b, s, 3, HEADS, d)
    q, k = IF.fused_rotary_position_embedding(
        qkv[:, :, 0], qkv[:, :, 1], sin=sin, cos=cos,
        use_neox_rotary_style=False)
    attn = NF.scaled_dot_product_attention(q, k, qkv[:, :, 2],
                                           is_causal=True)
    o = attn.reshape(b, s, hid) @ wt["o"]
    h2, res = IF.fused_rms_norm(o, wt["post_attention_layernorm"],
                                epsilon=EPS, residual=x)
    if form == "two":
        act = IF.swiglu(h2 @ wt["gate"], h2 @ wt["up"])
    else:
        act = IF.swiglu(h2 @ wt["gate_up"])
    return res + act @ wt["down"]
