"""The port's decode and verify paged attention and its batched KV writer
against the JAX package's: the plain PyTorch versions of the decode and
verify kernels against the Pallas kernels in interpreter mode, and
`write_kv_to_cache` exactly. The same numpy inputs go to both packages."""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.ops.pallas import paged_attention as jpa
from paddle_tpu_torch.ops.kernels import paged_attention as tpa
from torch_threads import one_thread  # noqa: F401

# the Pallas kernels (interpret mode) under one `jax.jit` a call: the
# interpreter's grid loop compiles once instead of running op by op
_decode = jax.jit(jpa.paged_attention)
_verify = jax.jit(jpa.paged_attention_verify)

# f32: the two differ only in summation order. bf16: both sum in f32 and
# round the output once, so a value may sit one bf16 ulp apart (2^-8
# relative); 2^-7 admits that at any magnitude of order 1.
TOL = {"f32": 1e-5, "bf16": 2.0 ** -7}
DTYPES = {"f32": (jnp.float32, torch.float32),
          "bf16": (jnp.bfloat16, torch.bfloat16)}


@pytest.fixture
def interpret():
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": False})


def _pool(rng, h, kvh, d, bs, lens, dtype):
    """Random pools, one random table per sequence with enough blocks
    for the longest context, and the query's numpy source."""
    w = max(-(-max(lens) // bs), 1) + 1             # a spare column
    nb = len(lens) * w + 1
    kc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    tables = rng.permutation(np.arange(1, nb))[:len(lens) * w] \
        .reshape(len(lens), w).astype(np.int32)
    jd, td = DTYPES[dtype]
    # each package gets its own copy of the numpy buffers
    jax_in = (jnp.array(kc, dtype=jd), jnp.array(vc, dtype=jd),
              jnp.array(tables), jnp.array(np.asarray(lens, np.int32)))
    torch_in = (torch.tensor(kc).to(td), torch.tensor(vc).to(td),
                torch.tensor(tables), torch.tensor(lens, dtype=torch.int32))
    return jax_in, torch_in


# (heads, kv heads, head_dim, block size, context lengths): ctx 0, ctx on
# a block boundary, ctx across one
CASES = {
    "mha_bs4": (4, 4, 16, 4, [0, 8, 13]),
    "gqa_bs4": (8, 2, 32, 4, [5, 0, 12, 17]),
    "mha_bs16": (4, 4, 32, 16, [16, 37, 0]),
    "gqa_bs16": (8, 4, 16, 16, [33, 32, 1]),
}


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_decode_plain_matches_pallas(case, dtype, interpret):
    h, kvh, d, bs, lens = CASES[case]
    rng = np.random.default_rng(3)
    (jk, jv, jt, jl), (tk, tv, tt, tl) = _pool(rng, h, kvh, d, bs, lens,
                                               dtype)
    q = rng.normal(size=(len(lens), h, d)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = np.asarray(_decode(jnp.array(q, dtype=jd), jk, jv, jt, jl),
                      np.float32)
    got = tpa.paged_attention(torch.tensor(q).to(td), tk, tv, tt, tl)
    assert got.dtype == td and got.shape == (len(lens), h, d)
    got = got.float().numpy()
    np.testing.assert_allclose(got, want, atol=TOL[dtype], rtol=TOL[dtype])
    # a sequence with no context comes back exactly zero (l_safe = 1)
    empty = np.asarray(lens) == 0
    assert (got[empty] == 0).all() and (want[empty] == 0).all()


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("s", [1, 5, 64])
@pytest.mark.parametrize("case", list(CASES))
def test_verify_plain_matches_pallas(case, s, dtype, interpret):
    """Rows that see at least one position match the Pallas kernel; rows
    with context_lens - S + s < 0 see none and come back exactly zero
    (the Pallas kernel gives them a mean of the V rows it visits)."""
    h, kvh, d, bs, lens = CASES[case]
    rng = np.random.default_rng(4)
    (jk, jv, jt, jl), (tk, tv, tt, tl) = _pool(rng, h, kvh, d, bs, lens,
                                               dtype)
    q = rng.normal(size=(len(lens), s, h, d)).astype(np.float32)
    jd, td = DTYPES[dtype]
    want = np.asarray(_verify(jnp.array(q, dtype=jd), jk, jv, jt, jl),
                      np.float32)
    got = tpa.paged_attention_verify(torch.tensor(q).to(td), tk, tv, tt, tl)
    assert got.dtype == td and got.shape == (len(lens), s, h, d)
    got = got.float().numpy()
    live = (np.asarray(lens)[:, None] - s + np.arange(s)[None, :]) >= 0
    assert live.any() and (s == 1 or not live.all())
    np.testing.assert_allclose(got[live], want[live], atol=TOL[dtype],
                               rtol=TOL[dtype])
    assert (got[~live] == 0).all()


def test_verify_rows_equal_decode_calls(interpret):
    """Verify row s is a decode call over the context cut to
    context_lens - S + s + 1 positions (the JAX package's own check)."""
    h, kvh, d, bs, lens = CASES["gqa_bs4"]
    rng = np.random.default_rng(5)
    _jax_in, (tk, tv, tt, tl) = _pool(rng, h, kvh, d, bs, lens, "f32")
    s = 4
    q = torch.tensor(rng.normal(size=(len(lens), s, h, d)),
                     dtype=torch.float32)
    out = tpa.paged_attention_verify(q, tk, tv, tt, tl)
    for i in range(s):
        cut = torch.clamp(tl - (s - 1 - i), min=0).to(torch.int32)
        row = tpa.paged_attention(q[:, i].contiguous(), tk, tv, tt, cut)
        torch.testing.assert_close(out[:, i], row, atol=1e-6, rtol=1e-6)


def test_gates_narrow_the_jax_rule():
    """The kernels take bf16/f32 with D a multiple of 8 up to 256 and (for
    verify) S <= 64; JAX's gates also take f16. Other inputs take the
    plain version in the engine, as JAX's engine routes them."""
    assert tpa.supported((2, 32, 128), torch.bfloat16)
    assert tpa.supported((2, 32, 256), torch.float32)
    assert not tpa.supported((2, 32, 128), torch.float16)
    assert not tpa.supported((2, 32, 264), torch.float32)
    assert not tpa.supported((2, 32, 12), torch.float32)
    assert not tpa.supported((2, 5, 32, 128), torch.float32)
    assert tpa.verify_supported((2, 64, 32, 128), torch.bfloat16)
    assert not tpa.verify_supported((2, 65, 32, 128), torch.bfloat16)
    assert not tpa.verify_supported((2, 5, 32, 128), torch.float16)
    assert not tpa.verify_supported((2, 32, 128), torch.float32)
    # the plain versions take what the kernels do not
    q = torch.zeros((1, 2, 12), dtype=torch.float16)
    kc = torch.zeros((2, 2, 4, 12), dtype=torch.float16)
    out = tpa.paged_attention(q, kc, kc, torch.ones((1, 1), dtype=torch.int32),
                              torch.tensor([3], dtype=torch.int32))
    assert out.dtype == torch.float16 and out.shape == (1, 2, 12)


def _write_both(rng, s, start, lens_alloc, bs=4, w=4):
    """Both packages' `write_kv_to_cache` on the same numpy inputs."""
    b, kvh, d, nb = len(start), 2, 8, 20
    kc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    vc = rng.normal(size=(nb, kvh, bs, d)).astype(np.float32)
    tables = np.zeros((b, w), np.int32)
    blocks = iter(range(1, nb))
    for i, n in enumerate(lens_alloc):
        for j in range(-(-n // bs)):
            tables[i, j] = next(blocks)
    k = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    v = rng.normal(size=(b, s, kvh, d)).astype(np.float32)
    start = np.asarray(start, np.int32)
    jk, jv = jpa.write_kv_to_cache(jnp.array(k), jnp.array(v), jnp.array(kc),
                                   jnp.array(vc), jnp.array(tables),
                                   jnp.array(start))
    tkc, tvc = torch.tensor(kc), torch.tensor(vc)
    out = tpa.write_kv_to_cache(torch.tensor(k), torch.tensor(v), tkc, tvc,
                                torch.tensor(tables), torch.tensor(start))
    assert out[0] is tkc and out[1] is tvc         # written in place
    return (np.asarray(jk), np.asarray(jv)), (tkc.numpy(), tvc.numpy()), \
        (kc, k, tables)


def test_write_kv_matches_jax_right_padded_prefill():
    """A prefill right-padded to a bucket of 8 tokens: rows of 3 and 8
    real tokens each leased the whole bucket (2 blocks of 4), and the
    padding lands in the row's own padded allocation, as in JAX."""
    rng = np.random.default_rng(8)
    (jk, jv), (tk, tv), _ = _write_both(rng, 8, [0, 0], [8, 8])
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)


def test_write_kv_matches_jax_decode_positions():
    """One token per row at start_pos = context_lens - 1, on and across
    block boundaries."""
    rng = np.random.default_rng(9)
    (jk, jv), (tk, tv), _ = _write_both(rng, 1, [0, 3, 4, 11],
                                        [1, 4, 5, 12])
    np.testing.assert_array_equal(tk, jk)
    np.testing.assert_array_equal(tv, jv)


def test_write_kv_drops_positions_past_the_table():
    """Positions at or past W * BS (and negative ones) write nothing in
    the port; where JAX writes them depends on how its out-of-range fill
    wraps, so only the positions inside the table are held to JAX."""
    rng = np.random.default_rng(10)
    bs, w = 4, 4                                     # 16 positions
    (jk, _jv), (tk, _tv), (kc, k, tables) = _write_both(
        rng, 6, [12, 0, -2], [16, 6, 4], bs=bs, w=w)
    # row 0 writes 12..15 inside, 16..17 past the table; row 1 0..5;
    # row 2 writes 0..3 (its positions -2, -1 are dropped)
    want = kc.copy()
    for b, start in enumerate([12, 0, -2]):
        for s in range(6):
            pos = start + s
            if 0 <= pos < bs * w:
                want[tables[b, pos // bs], :, pos % bs] = k[b, s]
    np.testing.assert_array_equal(tk, want)
    inside = np.zeros(kc.shape[0], bool)
    inside[np.unique(tables[tables > 0])] = True
    np.testing.assert_array_equal(tk[inside], jk[inside])
