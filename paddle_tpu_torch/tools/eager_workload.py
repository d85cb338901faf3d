"""The eager API's workloads, in one place for `chip_smoke.py` (its
`eager_reference` and `eager_attention` phases) and the tests that
rehearse them on the CPU and the card.

- `eager_program(paddle)`: one scripted program over the eager ops and
  the tape (creation, promotion, indexing and index assignment,
  reductions, `matmul`, `softmax`, `backward`, a hook, `paddle.grad` with
  `create_graph`, `PyLayer`, `hessian`, seeded `rand` / `randint`, one
  `randint` over a span past 2^62) on the expected place; it returns its
  results as numpy arrays, keyed by name.
- The attention block of a Llama layer, all in eager `Tensor`s
  (`eager_block`): RMSNorm, the q / k / v `matmul`s with `[in, out]`
  weights, causal `scaled_dot_product_attention`, the o `matmul`, and
  `loss = (out.astype('float32') ** 2).mean()`. `torch_block` makes the
  same calls on plain `torch.Tensor`s, so under torch autograd it runs
  the same kernels and should give the same bits; `plain_block` computes
  the function with the kernels' plain PyTorch versions (RMSNorm's
  `rms_norm_ref` and the f32 composite attention `_sdpa_fn`).
- A Llama decoder layer written as users write paddle code
  (`decoder_layer(paddle, ...)`, over either package's `paddle`):
  `nn.RMSNorm`, the q / k / v / o `nn.Linear(bias_attr=False)`s, rotary
  as plain Tensor ops over non-persistable `rope_cos` / `rope_sin`
  buffers (`paddle_tpu/models/llama.py:52-87`), causal
  `F.scaled_dot_product_attention`, `nn.RMSNorm`, the SwiGLU MLP with
  `F.silu`, and the residuals; `mlp=False` keeps the attention half (one
  norm). `LLAMA_7B_LAYER` is its Llama-2-7B width, which the smoke run's
  `jit_layer` phase trains eagerly and through `jit.to_static`, exports
  with `jit.save` and serves through the inference `Predictor`.
"""
from __future__ import annotations

import numpy as np
import torch

__all__ = ["LLAMA_7B_BLOCK", "LLAMA_7B_LAYER", "block_inputs",
           "eager_block", "torch_block", "plain_block", "eager_program",
           "decoder_layer", "rope_tables", "EPS"]

# Llama-2-7B's attention block: hidden 4096, 32 heads of 128; one
# sequence of 2048 tokens
LLAMA_7B_BLOCK = dict(batch=1, seq=2048, hidden=4096, heads=32)
EPS = 1e-6
WEIGHTS = ("norm", "wq", "wk", "wv", "wo")
# one Llama-2-7B decoder layer: hidden 4096, 32 heads of 128, MLP 11008;
# one sequence of 2048 tokens
LLAMA_7B_LAYER = dict(batch=1, seq=2048, hidden=4096, heads=32, ffn=11008)


def block_inputs(batch, seq, hidden, heads, device, dtype=torch.bfloat16,
                 seed=0):
    """(x, weights) as plain tensors from a seeded generator on `device`:
    x `[batch, seq, hidden]` ~ N(0, 1), the projections `[in, out]` ~
    N(0, 1 / hidden), the norm weight ~ 1 + N(0, 0.01)."""
    g = torch.Generator(device=device).manual_seed(seed)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=device)

    w = {n: (randn(hidden, hidden) * hidden ** -0.5).to(dtype)
         for n in ("wq", "wk", "wv", "wo")}
    w["norm"] = (1 + 0.1 * randn(hidden)).to(dtype)
    return randn(batch, seq, hidden).to(dtype), w


def eager_block(paddle, x, w, heads):
    """The block on eager Tensors; returns the scalar f32 loss."""
    F = paddle.nn.functional
    b, s, hidden = x.shape
    d = hidden // heads
    h = F.rms_norm(x, w["norm"], EPS)
    q, k, v = (paddle.matmul(h, w[n]).reshape([b, s, heads, d])
               for n in ("wq", "wk", "wv"))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    out = paddle.matmul(o.reshape([b, s, hidden]), w["wo"])
    return (out.astype("float32") ** 2).mean()


def torch_block(x, w, heads):
    """The same calls on plain tensors: the torch functions the eager ops
    run, in the same order."""
    from ..nn import functional as F

    b, s, hidden = x.shape
    d = hidden // heads
    h = F.rms_norm(x, w["norm"], EPS)
    q, k, v = (torch.reshape(torch.matmul(h, w[n]), (b, s, heads, d))
               for n in ("wq", "wk", "wv"))
    o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
    out = torch.matmul(torch.reshape(o, (b, s, hidden)), w["wo"])
    return torch.mean(torch.pow(out.to(torch.float32), 2),
                      dim=tuple(range(out.dim())))


def plain_block(x, w, heads):
    """The block with the kernels' plain versions, differentiable by
    torch autograd."""
    from ..nn.functional.attention import _sdpa_fn
    from ..ops.kernels.rms_norm import rms_norm_ref

    b, s, hidden = x.shape
    d = hidden // heads
    h = rms_norm_ref(x.reshape(-1, hidden), w["norm"], EPS).reshape(x.shape)
    q, k, v = ((h @ w[n]).reshape(b, s, heads, d)
               for n in ("wq", "wk", "wv"))
    o = _sdpa_fn(q, k, v, True)
    out = o.reshape(b, s, hidden) @ w["wo"]
    return (out.float() ** 2).mean()


def eager_program(paddle):
    """The scripted program over the eager API on the expected place.
    Returns {name: numpy array} (random draws also as their bits)."""
    r = {}

    def keep(name, t):
        r[name] = t.numpy() if hasattr(t, "numpy") else np.asarray(t)

    # creation and dtypes
    keep("to_tensor", paddle.to_tensor([[1.0, 2.0], [3.0, 4.0]]))
    keep("int", paddle.to_tensor([1, 2, 3]))
    keep("zeros", paddle.zeros([2, 3]))
    keep("ones_i32", paddle.ones([2], dtype="int32"))
    keep("full", paddle.full([2], 7))
    keep("arange", paddle.arange(5))
    keep("farange", paddle.arange(0, 1, 0.25))
    keep("eye", paddle.eye(3))
    keep("linspace", paddle.linspace(0, 1, 5))
    # promotion
    a = paddle.to_tensor([1, 2])
    keep("int_plus_half", a + 0.5)
    keep("int_plus_one", a + 1)
    keep("int_div_int", a / paddle.to_tensor([2, 2]))
    keep("mixed", a + paddle.to_tensor([1.0, 2.0]))
    # elementwise, comparison, reduction
    x = paddle.to_tensor(np.linspace(-2, 2, 12, dtype=np.float32)
                         .reshape(3, 4))
    for name, t in (("exp", paddle.exp(x)), ("sin", paddle.sin(x)),
                    ("tanh", paddle.tanh(x)), ("abs", paddle.abs(x)),
                    ("sqrt", paddle.sqrt(paddle.abs(x))),
                    ("log", paddle.log(paddle.abs(x) + 1)),
                    ("pow", paddle.pow(x, 3)), ("round", paddle.round(x)),
                    ("scale", paddle.scale(x, 2.0, 1.0)),
                    ("sub", paddle.subtract(x, 1.5)),
                    ("div", paddle.divide(x, x + 3)),
                    ("lt", x < 0.5), ("eq", paddle.equal(x, x)),
                    ("equal_all", paddle.equal_all(x, x)),
                    ("ne", paddle.not_equal(x, 0.0)),
                    ("sum", paddle.sum(x, axis=1)),
                    ("mean", paddle.mean(x)),
                    ("max", paddle.max(x, axis=0, keepdim=True)),
                    ("min", paddle.min(x)), ("any", paddle.any(x > 1.9)),
                    ("all", paddle.all(x > -3)),
                    ("argmax", paddle.argmax(x, axis=1)),
                    ("softmax", paddle.ops.activation.softmax(x)),
                    ("matmul", paddle.matmul(x, x, transpose_y=True)),
                    ("where", paddle.where(x > 0, x, -x)),
                    ("concat", paddle.concat([x, x], axis=0)),
                    ("cast", x.astype("int32"))):
        keep(name, t)
    # indexing and index assignment
    idx = paddle.to_tensor([0, 2])
    keep("row", x[1])
    keep("step", x[1:, ::2])
    keep("mask", x[x > 0])
    keep("take", x[idx])
    keep("gather", paddle.gather(x, idx, axis=1))
    y = x.clone()
    y[0, 0] = 100.0
    y[y < -1.5] = 0.0
    keep("setitem", y)
    parts = paddle.split(x, [1, -1], axis=1)
    keep("split", parts[1])
    # the tape: backward, a hook, a grad through index assignment
    w = paddle.to_tensor([1.0, 2.0, 3.0], stop_gradient=False)
    seen = []
    w.register_hook(lambda g: seen.append(g.numpy().copy()) or g * 2)
    h = w * w
    h[0] = 5.0
    (h * paddle.to_tensor([1.0, 2.0, 3.0])).sum().backward()
    keep("hook_seen", seen[0])
    keep("w_grad", w.grad)
    # paddle.grad with create_graph: a second derivative
    z = paddle.to_tensor([0.3, -0.7], stop_gradient=False)
    (g1,) = paddle.grad(paddle.sin(z * z).sum(), [z], create_graph=True)
    (g2,) = paddle.grad(g1.sum(), [z])
    keep("grad1", g1)
    keep("grad2", g2)

    class Cube(paddle.autograd.PyLayer):
        @staticmethod
        def forward(ctx, t):
            ctx.save_for_backward(t)
            return t * t * t

        @staticmethod
        def backward(ctx, dy):
            (t,) = ctx.saved_tensor()
            return dy * 3 * t * t

    p = paddle.to_tensor([1.0, -2.0], stop_gradient=False)
    Cube.apply(p * 2).sum().backward()
    keep("pylayer_grad", p.grad)
    q = paddle.to_tensor([0.3, -0.8, 1.2], stop_gradient=False)
    keep("hessian", paddle.autograd.hessian((paddle.exp(q) * q).sum(), q))
    # seeded draws
    paddle.seed(42)
    u = paddle.rand([64])
    keep("rand", u)
    r["rand_bits"] = u.numpy().view(np.uint32)
    keep("randint", paddle.randint(0, 1000, [64]))
    keep("randint_wide", paddle.randint(-2 ** 62, 2 ** 62 + 3, [64]))
    keep("randn", paddle.randn([64]))
    r["place"] = np.asarray(str(u.place))
    return r


def rope_tables(head_dim, positions, theta=10000.0):
    """(cos, sin) f32 `[positions, head_dim / 2]`, computed in float64 as
    `paddle_tpu/models/llama.py:52-59` computes them."""
    inv_freq = 1.0 / (theta ** (np.arange(0, head_dim, 2, dtype=np.float64)
                                / head_dim))
    freqs = np.outer(np.arange(positions, dtype=np.float64), inv_freq)
    return np.cos(freqs).astype("float32"), np.sin(freqs).astype("float32")


def decoder_layer(paddle, hidden, heads, ffn, seq, mlp=True, eps=EPS):
    """A Llama decoder layer (or its attention half, `mlp=False`) as a
    `paddle.nn.Layer` of `paddle` (either package), its weights drawn from
    the shared generator (`paddle.seed`). `x [B, S, hidden]` ->
    `[B, S, hidden]`; any S up to `seq`."""
    nn = paddle.nn
    F = nn.functional
    head_dim = hidden // heads

    class DecoderLayer(nn.Layer):
        def __init__(self):
            super().__init__()
            self.input_layernorm = nn.RMSNorm(hidden, eps)
            self.q_proj = nn.Linear(hidden, hidden, bias_attr=False)
            self.k_proj = nn.Linear(hidden, hidden, bias_attr=False)
            self.v_proj = nn.Linear(hidden, hidden, bias_attr=False)
            self.o_proj = nn.Linear(hidden, hidden, bias_attr=False)
            if mlp:
                self.post_attention_layernorm = nn.RMSNorm(hidden, eps)
                self.gate_proj = nn.Linear(hidden, ffn, bias_attr=False)
                self.up_proj = nn.Linear(hidden, ffn, bias_attr=False)
                self.down_proj = nn.Linear(ffn, hidden, bias_attr=False)
            cos, sin = rope_tables(head_dim, seq)
            self.register_buffer("rope_cos", paddle.to_tensor(cos),
                                 persistable=False)
            self.register_buffer("rope_sin", paddle.to_tensor(sin),
                                 persistable=False)

        def _rope(self, t, s):
            half = head_dim // 2
            c = self.rope_cos[:s].reshape([1, s, 1, half]).astype(t.dtype)
            sn = self.rope_sin[:s].reshape([1, s, 1, half]).astype(t.dtype)
            t1, t2 = paddle.split(t, 2, axis=-1)
            return paddle.concat([t1 * c - t2 * sn, t2 * c + t1 * sn],
                                 axis=-1)

        def forward(self, x):
            s = x.shape[1]
            h = self.input_layernorm(x)
            q, k, v = (proj(h).reshape([-1, s, heads, head_dim])
                       for proj in (self.q_proj, self.k_proj, self.v_proj))
            q, k = self._rope(q, s), self._rope(k, s)
            o = F.scaled_dot_product_attention(q, k, v, is_causal=True)
            x = x + self.o_proj(o.reshape([-1, s, hidden]))
            if not mlp:
                return x
            h = self.post_attention_layernorm(x)
            return x + self.down_proj(F.silu(self.gate_proj(h))
                                      * self.up_proj(h))

    return DecoderLayer()
