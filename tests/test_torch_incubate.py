"""The port's fused-op surface (`paddle_tpu_torch.incubate.nn.functional`)
against the JAX package's (`paddle_tpu.incubate.nn.functional`), with
`FLAGS_pallas_interpret` set around each test so that the JAX side takes
its Pallas routes (restored after): the exports, `fused_rms_norm` (the
RMSNorm kernel route and its composite, bias, residual, flattened axes,
the refused mixed-dtype weight), `fused_layer_norm`, varlen attention,
and `block_multihead_attention` prefill -> decode (MHA and GQA, both
rope styles) with its refusals. The RoPE routing and
`masked_multihead_attention` are in `test_torch_rope.py`, the SwiGLU /
`fused_bias_act` routing and the linear helpers in
`test_torch_bias_act.py`. On the CPU the port's kernel routes run their
plain versions and launch nothing.

Tolerances: f32 within 1e-6 (relative to each element and to the
output's largest magnitude); bf16 / f16 within one ulp of each element's
own magnitude.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework import flags
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.ops.kernels import _support
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _jax_kernel_routes():
    prev = flags.flag_value("pallas_interpret")
    flags.set_flags({"pallas_interpret": True})
    counts = {n: _support.launch_counter(n).count
              for n in ("fused_rope", "bias_act", "swiglu", "rms_norm",
                        "paged_attention")}
    yield
    flags.set_flags({"pallas_interpret": prev})
    assert counts == {n: _support.launch_counter(n).count for n in counts}


def J(a, dtype="float32"):
    """A JAX-side Tensor with its own copy of `a`."""
    return Tensor(jnp.array(a, copy=True).astype(getattr(jnp, dtype)))


def P(a, dtype="float32"):
    """A port-side tensor with its own copy of `a`."""
    return torch.tensor(np.asarray(a)).to(getattr(torch, dtype))


def _np(t):
    if isinstance(t, Tensor):
        t = t._data
    if isinstance(t, torch.Tensor):
        return t.detach().float().numpy()
    return np.asarray(jnp.asarray(t).astype(jnp.float32))


def assert_match(got, want):
    """f32: 1e-6; 16-bit: one ulp of each element's own magnitude."""
    dtype = got.dtype
    g, w = _np(got), _np(want)
    assert g.shape == w.shape
    if dtype in (torch.bfloat16, torch.float16):
        bits, tiny = (7, 2.0 ** -126) if dtype == torch.bfloat16 \
            else (10, 2.0 ** -14)
        ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(w), tiny))) - bits)
        assert (np.abs(g - w) <= ulp).all()
    else:
        np.testing.assert_allclose(g, w, rtol=1e-6, atol=1e-6 * max(
            1.0, float(np.abs(w).max())))


class Spy:
    """Counts calls through one module attribute (a routing check)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


def test_exports_match_the_jax_package():
    assert set(PF.__all__) == set(JF.__all__)
    assert all(callable(getattr(PF, n)) for n in PF.__all__)


# ---- norms ----

@pytest.mark.parametrize("case", ["plain", "bias_residual_flat", "bf16",
                                  "rank1_composite", "mixed_weight"])
def test_fused_rms_norm_matches_jax(case, monkeypatch):
    rng = np.random.default_rng(0)
    shape = (1, 16) if case == "rank1_composite" else (2, 3, 16)
    x = 2 * rng.normal(size=shape)
    w = 1 + 0.2 * rng.normal(size=shape[-1:])
    dt = "bfloat16" if case in ("bf16", "mixed_weight") else "float32"
    wdt = "float32" if case == "mixed_weight" else dt
    kw_j, kw_p = {}, {}
    if case == "bias_residual_flat":
        w = 1 + 0.2 * rng.normal(size=(3, 16))       # normalise [1:]
        extra = {"bias": rng.normal(size=shape),
                 "residual": rng.normal(size=shape),
                 "norm_bias": rng.normal(size=(3, 16))}
        kw_j = {k: J(v) for k, v in extra.items()}
        kw_p = {k: P(v) for k, v in extra.items()}
        kw_j["begin_norm_axis"] = kw_p["begin_norm_axis"] = 1
    if case == "bf16":
        res = rng.normal(size=shape)
        kw_j["residual"], kw_p["residual"] = J(res, dt), P(res, dt)
    if case == "rank1_composite":
        x, w = x[0], w
    spy = Spy(monkeypatch, PF._rms, "rms_norm")
    if case == "mixed_weight":
        # the Pallas kernel refuses an f32 weight on bf16 x, and so does
        # the port's kernel route, on either device
        with pytest.raises(ValueError):
            JF.fused_rms_norm(J(x, dt), J(w, wdt), epsilon=1e-5)
        with pytest.raises(ValueError, match="weight must be"):
            PF.fused_rms_norm(P(x, dt), P(w, wdt), epsilon=1e-5)
        return
    want = JF.fused_rms_norm(J(x, dt), J(w, wdt), epsilon=1e-5, **kw_j)
    got = PF.fused_rms_norm(P(x, dt), P(w, wdt), epsilon=1e-5, **kw_p)
    assert spy.calls == (0 if case == "rank1_composite" else 1)
    if "residual" in kw_p:
        assert_match(got[1], want[1])
        got, want = got[0], want[0]
    assert_match(got, want)


def test_fused_layer_norm_matches_jax():
    rng = np.random.default_rng(1)
    x, bias, res = (rng.normal(size=(2, 3, 8)) for _ in range(3))
    w, b = 1 + 0.1 * rng.normal(size=(3, 8)), rng.normal(size=(3, 8))
    want = JF.fused_layer_norm(J(x), J(w), J(b), epsilon=1e-5,
                               begin_norm_axis=1, bias=J(bias),
                               residual=J(res))
    got = PF.fused_layer_norm(P(x), P(w), P(b), epsilon=1e-5,
                              begin_norm_axis=1, bias=P(bias),
                              residual=P(res))
    assert_match(got[0], want[0])
    assert_match(got[1], want[1])
    assert_match(PF.fused_layer_norm(P(x), P(w[0]), None),
                 JF.fused_layer_norm(J(x), J(w[0]), None))


# ---- varlen attention ----

@pytest.mark.parametrize("mask,causal", [(None, True), ("bool", False),
                                         ("float", True)])
def test_varlen_attention_matches_jax(mask, causal):
    rng = np.random.default_rng(6)
    q = rng.normal(size=(2, 2, 5, 8))
    k, v = rng.normal(size=(2, 2, 7, 8)), rng.normal(size=(2, 2, 7, 8))
    sl, kl = np.array([[5], [3]]), np.array([[7], [4]])
    kw_j, kw_p = {}, {}
    if mask == "bool":
        m = rng.uniform(size=(2, 1, 5, 7)) > 0.3
        kw_j["mask"], kw_p["mask"] = Tensor(jnp.asarray(m)), torch.tensor(m)
    elif mask == "float":
        m = rng.normal(size=(2, 1, 5, 7))
        kw_j["mask"], kw_p["mask"] = J(m), P(m)
    want = JF.variable_length_memory_efficient_attention(
        J(q), J(k), J(v), Tensor(jnp.asarray(sl)), Tensor(jnp.asarray(kl)),
        causal=causal, **kw_j)
    got = PF.variable_length_memory_efficient_attention(
        P(q), P(k), P(v), torch.tensor(sl), torch.tensor(kl), causal=causal,
        **kw_p)
    assert_match(got, want)
    with pytest.raises(NotImplementedError, match="pre_cache_length"):
        PF.variable_length_memory_efficient_attention(
            P(q), P(k), P(v), torch.tensor(sl), torch.tensor(kl),
            pre_cache_length=2)


# ---- decode attention ----

@pytest.mark.parametrize("kv_heads,neox", [(4, False), (2, True)],
                         ids=["mha_pairs", "gqa_halves"])
def test_block_multihead_attention_prefill_then_decode(kv_heads, neox,
                                                       monkeypatch):
    """A prefill call (one sequence with no tokens this step), then a
    decode call, with rope_emb, through the same block pools: outputs,
    qkv_out and both pools after each call. The port writes the pools in
    place; the decode attends through `paged_attention`."""
    rng = np.random.default_rng(7)
    h, d, bs, nb = 4, 16, 4, 16
    lens = np.array([5, 0, 5])
    b = len(lens)
    tables = np.array([[1, 2, 3, 0], [4, 5, 6, 0], [7, 8, 9, 10]], np.int32)
    rope = rng.uniform(-1, 1, size=(2, b, 16, 1, d // 2))
    kc0 = rng.normal(size=(nb, kv_heads, bs, d))
    vc0 = rng.normal(size=(nb, kv_heads, bs, d))
    width = (h + 2 * kv_heads) * d
    heads = {} if kv_heads == h else {"num_heads": h,
                                      "num_kv_heads": kv_heads}
    kc_j, vc_j, kc_p, vc_p = J(kc0), J(vc0), P(kc0), P(vc0)
    spy = Spy(monkeypatch, PF.decode_attention._pa, "paged_attention")
    steps = [(lens, np.zeros(b, int), lens), (np.zeros(b, int), lens,
                                              np.ones(b, int))]
    for enc, dec, this in steps:
        qkv = rng.normal(size=(int(this.sum()), width))
        bias = rng.normal(size=(width,))
        args = lambda f, t: (f(qkv), kc_t[t], vc_t[t],
                             t_(enc, t), t_(dec, t), t_(this, t))
        kc_t, vc_t = {"j": kc_j, "p": kc_p}, {"j": vc_j, "p": vc_p}
        t_ = (lambda a, t: Tensor(jnp.asarray(a)) if t == "j"
              else torch.tensor(a))
        want = JF.block_multihead_attention(
            *args(J, "j"), block_tables=Tensor(jnp.asarray(tables)),
            qkv_bias=J(bias), rope_emb=J(rope), block_size=bs,
            use_neox_style=neox, **heads)
        got = PF.block_multihead_attention(
            *args(P, "p"), block_tables=torch.tensor(tables),
            qkv_bias=P(bias), rope_emb=P(rope), block_size=bs,
            use_neox_style=neox, **heads)
        for g, w in zip(got, want):
            assert_match(g, w)
        assert got[2] is kc_p and got[3] is vc_p          # written in place
        kc_j, vc_j = want[2], want[3]
    assert spy.calls == 1


def test_block_multihead_attention_refusals():
    kc = torch.zeros((4, 2, 4, 8))
    qkv = torch.zeros((2, 6 * 8))
    tables = torch.zeros((2, 2), dtype=torch.int32)
    common = (qkv, kc, kc.clone())
    with pytest.raises(NotImplementedError, match="mixed"):
        PF.block_multihead_attention(*common, torch.tensor([1, 0]),
                                     torch.tensor([0, 3]),
                                     torch.tensor([1, 1]),
                                     block_tables=tables, block_size=4)
    with pytest.raises(NotImplementedError, match="quantization"):
        PF.block_multihead_attention(*common, torch.tensor([0, 0]),
                                     torch.tensor([1, 1]),
                                     torch.tensor([1, 1]),
                                     block_tables=tables, block_size=4,
                                     use_dynamic_cachekv_quant=True)
    with pytest.raises(NotImplementedError, match="mask"):
        PF.block_multihead_attention(*common, torch.tensor([0, 0]),
                                     torch.tensor([1, 1]),
                                     torch.tensor([1, 1]),
                                     block_tables=tables, block_size=4,
                                     mask=torch.zeros(1))
