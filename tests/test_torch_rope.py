"""The port's fused RoPE (`paddle_tpu_torch.ops.kernels.rope`) against the
JAX package's (`paddle_tpu.ops.pallas.rope`): the plain version against
the Pallas `_rope_kernel` in interpret mode, forward and `conj`, and
`fused_rope`'s gradients against `jax.vjp` through its custom VJP (the
same kernel with the sine negated). Then the routing of
`incubate.nn.functional.fused_rotary_position_embedding` against the JAX
package's with `FLAGS_pallas_interpret` set (every branch: the kernel for
q and k, the generic rotation for v, adjacent pairs, `position_ids`, GQA
k, k absent, full-D and generated tables), and the decode-time rotary of
`masked_multihead_attention`.

Tolerances: f32 within 1e-6 (relative to each element and to the
output's largest magnitude); bf16 / f16 within one ulp of each element's
own magnitude (both sides compute in f32 and round once); gradients
within 1e-5 of their largest magnitude; generated tables bit-equal.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu.incubate.nn.functional as JF
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework import flags
from paddle_tpu.ops.pallas import rope as jrope
import paddle_tpu_torch.incubate.nn.functional as PF
from paddle_tpu_torch.ops.kernels import rope as rk
from torch_threads import one_thread  # noqa: F401

SHAPE = (2, 6, 3, 16)           # B, S, H, D
T = 9                           # table rows


def _inputs(seed, shape=SHAPE):
    rng = np.random.default_rng(seed)
    q = rng.normal(size=shape).astype(np.float32)
    k = rng.normal(size=shape).astype(np.float32)
    ang = rng.uniform(0, 6, size=(T, shape[-1] // 2))
    return q, k, np.cos(ang).astype(np.float32), \
        np.sin(ang).astype(np.float32)


def assert_close_f32(got, want):
    want = np.asarray(want, np.float32)
    np.testing.assert_allclose(np.asarray(got, np.float32), want, rtol=1e-6,
                               atol=1e-6 * max(1.0, float(np.abs(want).max())))


def assert_within_ulp(got, want, dtype):
    """One ulp of each element's own magnitude (bf16: 2^-7 of its binade,
    f16: 2^-10)."""
    bits, tiny = (7, 2.0 ** -126) if dtype == "bfloat16" else (10, 2.0 ** -14)
    want = np.asarray(want, np.float32)
    ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want), tiny))) - bits)
    err = np.abs(np.asarray(got, np.float32) - want)
    assert (err <= ulp).all(), float((err / ulp).max())


@pytest.mark.parametrize("conj", [False, True], ids=["fwd", "conj"])
@pytest.mark.parametrize("dtype,table", [("float32", "float32"),
                                         ("bfloat16", "float32"),
                                         ("bfloat16", "bfloat16"),
                                         ("float16", "float16")])
def test_plain_version_matches_pallas_kernel(dtype, table, conj):
    q, k, cos, sin = _inputs(0)
    s = SHAPE[1]
    jdt, jtab = getattr(jnp, dtype), getattr(jnp, table)
    jq, jk = jrope._pallas_rope(
        jnp.asarray(q).astype(jdt), jnp.asarray(k).astype(jdt),
        jnp.asarray(cos[2:2 + s]).astype(jtab),
        jnp.asarray(sin[2:2 + s]).astype(jtab), conj=conj)
    tdt, ttab = getattr(torch, dtype), getattr(torch, table)
    tq, tk = rk.rope_ref(torch.tensor(q).to(tdt), torch.tensor(k).to(tdt),
                         torch.tensor(cos[2:2 + s]).to(ttab),
                         torch.tensor(sin[2:2 + s]).to(ttab), conj)
    assert tq.dtype == tdt and tk.dtype == tdt
    for got, want in ((tq, jq), (tk, jk)):
        want = np.asarray(want.astype(jnp.float32))
        if dtype == "float32":
            assert_close_f32(got.numpy(), want)
        else:
            assert_within_ulp(got.float().numpy(), want, dtype)


@pytest.mark.parametrize("offset", [0, 3])
def test_fused_rope_and_its_gradients_match_jax(offset):
    """Forward at `offset` and the gradients of q and k (the conj rotation)
    against `jax.vjp` of `fused_rope`; strided views of one qkv array take
    the same path. The CPU runs no kernel."""
    q, k, cos, sin = _inputs(1)
    rng = np.random.default_rng(2)
    gq = rng.normal(size=SHAPE).astype(np.float32)
    gk = rng.normal(size=SHAPE).astype(np.float32)
    (jq, jk), vjp = jax.vjp(lambda a, b: jrope.fused_rope(
        a, b, jnp.asarray(cos), jnp.asarray(sin), offset),
        jnp.asarray(q), jnp.asarray(k))
    jdq, jdk = vjp((jnp.asarray(gq), jnp.asarray(gk)))
    qkv = torch.stack([torch.tensor(q), torch.tensor(k)], dim=2)
    qkv.requires_grad_()
    tq, tk = qkv[:, :, 0], qkv[:, :, 1]                 # strided views
    before = rk.LAUNCHES.count
    oq, ok = rk.fused_rope(tq, tk, torch.tensor(cos), torch.tensor(sin),
                           offset)
    ((oq * torch.tensor(gq)).sum() + (ok * torch.tensor(gk)).sum()) \
        .backward()
    assert rk.LAUNCHES.count == before
    assert_close_f32(oq.detach().numpy(), jq)
    assert_close_f32(ok.detach().numpy(), jk)
    for got, want in ((qkv.grad[:, :, 0], jdq), (qkv.grad[:, :, 1], jdk)):
        want = np.asarray(want)
        np.testing.assert_allclose(got.numpy(), want, rtol=0,
                                   atol=1e-5 * float(np.abs(want).max()))


def test_rows_past_the_table_raise():
    q, k, cos, sin = _inputs(3)
    tq, tk = torch.tensor(q), torch.tensor(k)
    tc, ts = torch.tensor(cos), torch.tensor(sin)
    rk.fused_rope(tq, tk, tc, ts, offset=T - SHAPE[1])  # the last rows fit
    for offset in (T - SHAPE[1] + 1, -1):
        with pytest.raises(ValueError, match="rows"):
            rk.fused_rope(tq, tk, tc, ts, offset=offset)


@pytest.mark.parametrize("shape,dtype", [
    ((2, 4, 3, 8), "float32"), ((2, 4, 3, 8), "bfloat16"),
    ((2, 4, 3, 8), "float16"), ((2, 4, 3, 7), "float32"),
    ((4, 3, 8), "float32"), ((2, 4, 3, 8), "float64"),
    ((2, 4, 3, 8), "int32")])
def test_supported_is_the_jax_gate(shape, dtype):
    assert rk.supported(shape, getattr(torch, dtype)) == \
        jrope.supported(shape, getattr(jnp, dtype))


# ---- the routing of the functional surface ----

@pytest.fixture
def jax_kernel_routes():
    """`FLAGS_pallas_interpret` on around the test (restored after), so the
    JAX package's functional surface takes its Pallas routes."""
    prev = flags.flag_value("pallas_interpret")
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": prev})


def J(a, dtype="float32"):
    """A JAX-side Tensor with its own copy of `a`."""
    return Tensor(jnp.array(a, copy=True).astype(getattr(jnp, dtype)))


def P(a, dtype="float32"):
    """A port-side tensor with its own copy of `a`."""
    return torch.tensor(np.asarray(a)).to(getattr(torch, dtype))


def assert_match(got, want):
    """The file's tolerances, by the port output's dtype."""
    w = np.asarray(want._data.astype(jnp.float32))
    g = got.detach().float().numpy()
    assert g.shape == w.shape
    if got.dtype in (torch.float32, torch.float64):
        assert_close_f32(g, w)
    else:
        assert_within_ulp(g, w, str(got.dtype).replace("torch.", ""))


class Spy:
    """Counts calls through one module attribute (a routing check)."""

    def __init__(self, monkeypatch, module, name):
        self.calls = 0
        fn = getattr(module, name)

        def wrapped(*a, **k):
            self.calls += 1
            return fn(*a, **k)

        monkeypatch.setattr(module, name, wrapped)


B, S, HEADS, D = 2, 5, 3, 8

ROPE_CASES = {
    # name: (dtype, neox, tables, position_ids, k heads, v, offset, kernel)
    "kernel_qkv": ("float32", False, "half", False, HEADS, True, 2, True),
    "kernel_bf16": ("bfloat16", False, "half_q_dtype", False, HEADS, False,
                    0, True),
    "kernel_f16_generated": ("float16", False, None, False, HEADS, False, 1,
                             True),
    "neox_pairs": ("float32", True, "half", False, HEADS, True, 1, False),
    "position_ids": ("float32", False, "half", True, HEADS, False, 0,
                     False),
    "full_tables_neox": ("float32", True, "full", False, HEADS, False, 0,
                         False),
    "full_tables_halves": ("float32", False, "full", False, HEADS, False, 0,
                           True),
    "generated_neox_ids": ("bfloat16", True, None, True, HEADS, False, 0,
                           False),
    "gqa_k": ("float32", False, "half", False, 1, False, 0, False),
    "q_only": ("float32", False, "half", False, None, False, 0, False),
}


@pytest.mark.parametrize("case", list(ROPE_CASES))
def test_fused_rotary_position_embedding_routes_as_jax(
        case, monkeypatch, jax_kernel_routes):
    dt, neox, tables, ids, kh, with_v, offset, kernel = ROPE_CASES[case]
    rng = np.random.default_rng(2)
    q = rng.normal(size=(B, S, HEADS, D))
    k = None if kh is None else rng.normal(size=(B, S, kh, D))
    v = rng.normal(size=(B, S, HEADS, D)) if with_v else None
    t = 9
    ang = rng.uniform(0, 6, size=(t, D // 2))
    kw_j, kw_p = {}, {}
    if tables is not None:
        if tables == "full":      # [1, T, 1, D], duplicated per layout
            full = np.repeat(ang, 2, axis=-1) if neox else \
                np.concatenate([ang, ang], axis=-1)
            ang = full[None, :, None, :]
        tdt = dt if tables == "half_q_dtype" else "float32"
        for name, fn in (("cos", np.cos), ("sin", np.sin)):
            kw_j[name], kw_p[name] = J(fn(ang), tdt), P(fn(ang), tdt)
    if ids:
        pid = np.array([[0, 3, 8, 2, 1], [4, -1, 6, 7, 5]])
        kw_j["position_ids"] = Tensor(jnp.asarray(pid))
        kw_p["position_ids"] = torch.tensor(pid)
    for name, arr in (("k", k), ("v", v)):
        if arr is not None:
            kw_j[name], kw_p[name] = J(arr, dt), P(arr, dt)
    spy = Spy(monkeypatch, PF._rope, "fused_rope")
    want = JF.fused_rotary_position_embedding(
        J(q, dt), use_neox_rotary_style=neox, offset=offset, **kw_j)
    got = PF.fused_rotary_position_embedding(
        P(q, dt), use_neox_rotary_style=neox, offset=offset, **kw_p)
    assert spy.calls == int(kernel)
    want = want if isinstance(want, tuple) else (want,)
    got = got if isinstance(got, tuple) else (got,)
    assert len(got) == len(want) == 1 + (k is not None) + (v is not None)
    for g, w in zip(got, want):
        assert g.dtype == getattr(torch, dt)
        assert_match(g, w)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16", "float16"])
def test_generated_tables_are_bit_equal(dtype):
    """`__init__.py:174-182`: float64 tables rounded to q's dtype in one
    step."""
    d, t, base = 64, 300, 10000.0
    inv = 1.0 / (base ** (np.arange(0, d, 2, dtype=np.float64) / d))
    freqs = np.outer(np.arange(t, dtype=np.float64), inv)
    cos, sin = PF._rope_tables(d, t, base, getattr(torch, dtype), "cpu")
    for got, table in ((cos, np.cos(freqs)), (sin, np.sin(freqs))):
        want = np.asarray(jnp.asarray(table, getattr(jnp, dtype))
                          .astype(jnp.float32))
        assert got.dtype == getattr(torch, dtype)
        np.testing.assert_array_equal(got.float().numpy(), want)


@pytest.mark.parametrize("neox", [False, True])
def test_masked_multihead_attention_matches_jax(neox):
    """The decode-time rotary of `masked_multihead_attention` (its
    `rotary_tensor`, adjacent pairs or halves), with a bias and a source
    mask, over a dense cache; and `blha_get_max_len`."""
    rng = np.random.default_rng(8)
    b, h, max_seq, d = 2, 2, 6, 8
    x = rng.normal(size=(b, 3 * h * d))
    cache = rng.normal(size=(2, b, h, max_seq, d))
    bias = rng.normal(size=(3 * h * d,))
    rot = rng.uniform(-1, 1, size=(2, b, 1, max_seq, d))
    src = rng.normal(size=(b, 1, 1, max_seq + 2))
    lens = np.array([3, 5])
    want = JF.masked_multihead_attention(
        J(x), J(cache), bias=J(bias), src_mask=J(src),
        sequence_lengths=Tensor(jnp.asarray(lens)), rotary_tensor=J(rot),
        rotary_emb_dims=1, use_neox_rotary_style=neox)
    got = PF.masked_multihead_attention(
        P(x), P(cache), bias=P(bias), src_mask=P(src),
        sequence_lengths=torch.tensor(lens), rotary_tensor=P(rot),
        rotary_emb_dims=1, use_neox_rotary_style=neox)
    assert_match(got[0], want[0])
    assert_match(got[1], want[1])
    enc, dec = PF.blha_get_max_len(torch.tensor([3, 9, 0]),
                                   torch.tensor([4, 1, 2]))
    assert enc.tolist() == [9] and dec.tolist() == [4]
