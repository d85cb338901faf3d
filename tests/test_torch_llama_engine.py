"""The port's Llama engine against the JAX package's: the same weights
(carried across with `from_jax_state`) and the same ragged-step sequence
give the same f32 logits and the same KV pools after every step, in bf16
-free f32 with a full-precision pool and in every quantized mode."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import LlamaInferenceEngine as JaxEngine
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving.quant import quantize_engine as jax_quantize_engine
from paddle_tpu_torch import LlamaConfig, LlamaInferenceEngine, from_jax_state
from paddle_tpu_torch.serving.quant import quantize_engine
from torch_threads import one_thread  # noqa: F401

ATOL = RTOL = 1e-4   # f32 logits after two layers of matmuls
B, BS, MAXB, NB = 3, 4, 16, 32


def _jax_model(seed, **kw):
    paddle.seed(seed)
    m = jax_llama_tiny(vocab=256, layers=2, hidden=64, heads=4, seq=64, **kw)
    # norms start at ones: perturb them so the rounding order shows
    rng = np.random.default_rng(seed)
    for name, p in m.named_parameters():
        if "norm" in name:
            p._data = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=p.shape), jnp.float32)
    return m


def _port(m, **kw):
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    cfg = LlamaConfig(**dataclasses.asdict(m.config))
    return from_jax_state(state, cfg, device="cpu", **kw)


def _engines(m, wbits=None, **kw):
    """Both packages' engines over the same weights; `kw` (`kv_bits`,
    `weight_only`) goes to both constructors, `wbits` to both
    `quantize_engine`s."""
    je = JaxEngine(m, max_batch_size=B, num_blocks=NB, block_size=BS,
                   max_blocks_per_seq=MAXB, **kw)
    te = LlamaInferenceEngine(_port(m), max_batch_size=B, num_blocks=NB,
                              block_size=BS, max_blocks_per_seq=MAXB,
                              device="cpu", **kw)
    if wbits is not None:
        jax_quantize_engine(je, wbits)
        quantize_engine(te, wbits)
    return je, te


def _tables(rows):
    out = np.zeros((B, MAXB), np.int32)          # guard block 0 elsewhere
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return out


# (tokens per lane, q_lens, kv_lens, tables): lane 0 prefills a 10-token
# prompt in two chunks (crossing block boundaries) then decodes; lane 1
# stays empty; lane 2 prefills 5 tokens in one chunk then decodes
_STEPS = [
    ([6, 0, 5], [6, 0, 5], [[1, 2], [], [4, 5]]),
    ([4, 0, 1], [10, 0, 6], [[1, 2, 3], [], [4, 5]]),
    ([1, 0, 1], [11, 0, 7], [[1, 2, 3], [], [4, 5]]),
    ([1, 0, 1], [12, 0, 8], [[1, 2, 3], [], [4, 5]]),
]


@pytest.mark.parametrize("variant", ["mha", "gqa", "tied"])
def test_ragged_steps_match_jax_engine(variant):
    kw = {"mha": {}, "gqa": {"num_key_value_heads": 2},
          "tied": {"tie_word_embeddings": True}}[variant]
    m = _jax_model(11, **kw)
    je, te = _engines(m)
    rng = np.random.default_rng(5)
    t = B + 8
    for q_lens, kv_lens, rows in _STEPS:
        tokens = np.zeros((t,), np.int32)
        n = sum(q_lens)
        tokens[:n] = rng.integers(1, 256, n)
        args = (tokens, np.asarray(q_lens, np.int32),
                np.asarray(kv_lens, np.int32), _tables(rows))
        jl = np.asarray(je.ragged_step(*args))
        tl = te.ragged_step(*args)
        assert tl.dtype == torch.float32 and tl.shape == (t, 256)
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=RTOL)
        np.testing.assert_allclose(te.k_cache.numpy(),
                                   np.asarray(je.k_cache), atol=1e-5,
                                   rtol=1e-5)
        np.testing.assert_allclose(te.v_cache.numpy(),
                                   np.asarray(je.v_cache), atol=1e-5,
                                   rtol=1e-5)


def test_tied_model_has_no_head():
    te = _port(_jax_model(2, tie_word_embeddings=True))
    assert te.lm_head is None


def test_engine_refuses_sequences_past_the_rope_table():
    """JAX clamps a rope lookup past max_position_embeddings; the port
    refuses an engine whose sequences could reach past it."""
    model = _port(_jax_model(3))                      # max_position 64
    with pytest.raises(ValueError, match="max_position_embeddings"):
        LlamaInferenceEngine(model, block_size=4, max_blocks_per_seq=17,
                             device="cpu")
    LlamaInferenceEngine(model, block_size=4, max_blocks_per_seq=16,
                         device="cpu")


_MODES = {"kv8": ({"kv_bits": 8}, None),
          "w_int8": ({"weight_only": "int8"}, None),
          "w_fp8": ({"weight_only": "fp8"}, None),
          "w_int4": ({"weight_only": "int4"}, None),
          "kv8_q8": ({"kv_bits": 8}, 8),
          "kv8_q4": ({"kv_bits": 8}, 4)}


def _record_jax_kv_quant(monkeypatch):
    """Record every K/V quantization the JAX engine traces: its f32
    input and its (q, scale), one entry per layer and side, in call
    order (`jax.debug.callback`, ordered, inside the jitted step)."""
    import jax

    from paddle_tpu.inference import kv_quant as jax_kv_quant

    calls = []
    orig = jax_kv_quant.quantize_kv

    def record(x):
        q, s = orig(x)
        jax.debug.callback(
            lambda a, b, c: calls.append(
                (np.array(a, np.float32), np.array(b), np.array(c))),
            x.astype(jnp.float32), q, s, ordered=True)
        return q, s

    monkeypatch.setattr(jax_kv_quant, "quantize_kv", record)
    return calls


def _same_kv_writes(monkeypatch, jax_calls):
    """Make the port's quantize-on-write hand the pool the JAX engine's
    int8 values and scales for the same tokens, after checking its own
    against them: scales within 1e-6 relative or 1e-7 absolute (layer
    2's K/V come out of layer 1's f32 sums, taken in another order),
    int8 values at most one step apart, and at every element that
    differs, the two packages' f32 values `x / scale` on either side of
    the `n + 1/2` boundary between the two results and each within 64
    f32 ulps of it: a rounding flip of inputs that agree, not a fault. The
    elements that differ are counted per pool (`flipped`, K and V) for
    the caller's bound. A step's logits are then compared on the same
    quantized K/V the JAX step attended to: a flip written in a step is
    read by that same step.

    Before each step the caller sets `src`, the step's
    `ragged_write_index` source rows (the port quantizes `new[src]`,
    JAX all of `new`), and zeroes `flipped`."""
    from paddle_tpu_torch.inference import kv_quant

    orig = kv_quant.quantize_kv

    def substitute(x):
        q, s = orig(x)
        side = len(jax_calls) % 2               # K, V, K, V, ...
        jx, jq, js = jax_calls.pop(0)
        src = substitute.src.numpy()
        jx, jq, js = jx[src], jq[src], js[src]
        np.testing.assert_allclose(s.numpy(), js, rtol=1e-6, atol=1e-7)
        diff = np.abs(q.numpy().astype(np.int32) - jq.astype(np.int32))
        assert diff.max() <= 1
        rows = np.unique(src)                   # guard rows repeat src
        substitute.flipped[side] += int((diff[rows] != 0).sum())
        for idx in zip(*np.nonzero(diff)):
            tok, head = idx[0], idx[1]
            vp = np.float32(x[idx].item()) / np.float32(s[tok, head].item())
            vj = jx[idx] / js[tok, head]
            edge = (float(q[idx]) + float(jq[idx])) / 2   # n + 1/2
            assert (vp - edge) * (vj - edge) <= 0, (vp, vj, edge)
            # rounding, not a fault: both within 64 f32 ulps of n + 1/2
            # (16 and 1 ulp have been seen)
            ulp = np.spacing(np.float32(abs(edge)))
            assert abs(vp - edge) <= 64 * ulp, (vp, edge, ulp)
            assert abs(vj - edge) <= 64 * ulp, (vj, edge, ulp)
        return torch.from_numpy(jq.copy()), torch.from_numpy(js.copy())

    monkeypatch.setattr(kv_quant, "quantize_kv", substitute)
    return substitute


@pytest.mark.parametrize("variant", ["mha", "gqa", "tied"])
@pytest.mark.parametrize("mode", list(_MODES))
def test_quantized_ragged_steps_match_jax_engine(mode, variant,
                                                 monkeypatch):
    """Quantized modes: f32 logits within 1e-4 (the port's gemm scales
    after its f32 sum, the JAX CPU path before its matmul). With an int8
    pool every step starts from the JAX engine's pools and scale planes,
    and writes the JAX engine's int8 values once its own have been held
    to them (`_same_kv_writes`): an f32 K/V value within rounding of a
    quantization boundary may land one step apart, and such a flip moves
    the logits of the step that reads it by more than 1e-4 (5.4e-4 has
    been seen). The pools after each step then equal the JAX engine's
    exactly, which also holds the write positions."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pk

    kw, wbits = _MODES[mode]
    model_kw = {"mha": {}, "gqa": {"num_key_value_heads": 2},
                "tied": {"tie_word_embeddings": True}}[variant]
    quant_kv = kw.get("kv_bits") == 8
    jax_calls = _record_jax_kv_quant(monkeypatch) if quant_kv else []
    je, te = _engines(_jax_model(12, **model_kw), wbits, **kw)
    assert te.quant_info() == je.quant_info()
    if quant_kv:
        substitute = _same_kv_writes(monkeypatch, jax_calls)
    rng = np.random.default_rng(6)
    t = B + 8
    for step, (q_lens, kv_lens, rows) in enumerate(_STEPS):
        tokens = np.zeros((t,), np.int32)
        n = sum(q_lens)
        tokens[:n] = rng.integers(1, 256, n)
        args = (tokens, np.asarray(q_lens, np.int32),
                np.asarray(kv_lens, np.int32), _tables(rows))
        if quant_kv and step > 0:
            for name in ("k_cache", "v_cache", "k_scale", "v_scale"):
                getattr(te, name).copy_(
                    torch.tensor(np.asarray(getattr(je, name))))
        jax_calls.clear()
        jl = np.asarray(je.ragged_step(*args))
        if quant_kv:
            lane, pos = pk.ragged_metadata(torch.from_numpy(args[1]),
                                           torch.from_numpy(args[2]), t)
            substitute.src = pk.ragged_write_index(
                torch.from_numpy(args[3]), lane, pos, BS)[2]
            substitute.flipped = [0, 0]
            assert len(jax_calls) == 2 * te.config.num_hidden_layers
        tl = te.ragged_step(*args)
        assert not jax_calls            # one port write per JAX write
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=RTOL)
        if not quant_kv:
            continue
        # int8 values one step apart on almost no element of a pool
        assert max(substitute.flipped) < 1e-3 * te.k_cache.numel()
        for tc, jc in ((te.k_cache, je.k_cache), (te.v_cache, je.v_cache),
                       (te.k_scale, je.k_scale), (te.v_scale, je.v_scale)):
            np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


def test_weight_only_quantizes_after_the_dtype_cast():
    """As in the JAX engine, `dtype` casts first and the cast weights are
    quantized; the lm_head stays dense (only `quantize_engine` takes an
    untied head)."""
    te = LlamaInferenceEngine(_port(_jax_model(4)), max_blocks_per_seq=4,
                              device="cpu", dtype=torch.bfloat16,
                              weight_only="int8")
    assert te.params["embed"].dtype == torch.bfloat16
    assert te.params["lm_head"].dtype == torch.bfloat16
    for key in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        assert [w["q"].dtype for w in te.params[key]] == [torch.int8] * 2
        # the kernels stage weight rows with 16-byte copies
        assert all(w["q"].is_contiguous() for w in te.params[key])
    w = _port(_jax_model(4)).llama.layers[1].self_attn.o_proj.weight
    wb = w.to(torch.bfloat16).float()
    want = (wb.abs().amax(dim=0) / 127)
    torch.testing.assert_close(te.params["o_w"][1]["s"], want, atol=0,
                               rtol=0)


@pytest.mark.parametrize("kw", [{"kv_bits": 4}, {"weight_only": "int2"}])
def test_unknown_quant_modes_raise(kw):
    with pytest.raises(ValueError):
        LlamaInferenceEngine(_port(_jax_model(4)), max_blocks_per_seq=4,
                             device="cpu", **kw)


@pytest.mark.parametrize("entry", ["prefill", "decode_step", "generate",
                                   "verify_step", "copy_kv_block"])
def test_legacy_entry_points_raise(entry):
    """Where an entry point refuses: on a kv_bits=8 engine the legacy
    full-precision `prefill` / `decode_step` / `generate` raise as the
    JAX engine's do, before any block is leased; `verify_step` refuses
    lengths and tables that do not match its windows; `copy_kv_block`
    refuses block ids outside the pool on the host, before it touches
    the pool; `extract_kv_blocks` of a sequence without blocks raises
    the typed `KVMigrationError` (a `ValueError`) as the JAX engine's
    does."""
    m = _jax_model(4)
    te = LlamaInferenceEngine(_port(m), max_blocks_per_seq=4, device="cpu",
                              kv_bits=8)
    je = JaxEngine(m, max_blocks_per_seq=4, kv_bits=8)
    tables = np.zeros((2, 4), np.int32)
    args = {"prefill": (np.ones((2, 3), np.int32), tables),
            "decode_step": (np.ones(2, np.int32), np.full(2, 3, np.int32),
                            tables),
            "generate": (np.ones((2, 3), np.int32),)}
    if entry in args:
        for engine in (je, te):
            free = engine.manager.free_blocks
            with pytest.raises(RuntimeError, match="kv_bits=8"):
                getattr(engine, entry)(*args[entry])
            assert engine.manager.free_blocks == free
    elif entry == "verify_step":
        with pytest.raises(ValueError, match="context_lens"):
            te.verify_step(np.ones((2, 3), np.int32),
                           np.full(3, 3, np.int32), tables)
        with pytest.raises(ValueError, match="block_tables"):
            te.verify_step(np.ones((2, 3), np.int32),
                           np.full(2, 3, np.int32), tables[:1])
    else:
        pools = [t.clone() for t in (te.k_cache, te.v_cache, te.k_scale,
                                     te.v_scale)]
        nb = te.k_cache.shape[1]
        for src, dst in ((nb, 2), (1, -1)):
            with pytest.raises(ValueError, match="outside the pool"):
                getattr(te, entry)(src, dst)
        assert all(torch.equal(a, b) for a, b in zip(
            pools, (te.k_cache, te.v_cache, te.k_scale, te.v_scale)))
        for engine in (je, te):
            with pytest.raises(ValueError, match="holds no KV blocks"):
                engine.extract_kv_blocks(1)


def test_kv_geometry_matches_jax():
    m = _jax_model(6, num_key_value_heads=2)
    je, te = _engines(m)
    assert te.kv_bytes_per_token() == je.kv_bytes_per_token()
    assert te.manager.bytes_per_block == je.manager.bytes_per_block


def _pools_match(te, je):
    """Full-precision pools within f32 rounding (1e-5); int8 pools and
    their scale planes exactly (their writes are the JAX engine's, see
    `_same_kv_writes`)."""
    pairs = ((te.k_cache, je.k_cache), (te.v_cache, je.v_cache))
    if te.kv_bits == 16:
        for tc, jc in pairs:
            np.testing.assert_allclose(tc.numpy(), np.asarray(jc),
                                       atol=1e-5, rtol=1e-5)
        return
    for tc, jc in pairs + ((te.k_scale, je.k_scale),
                           (te.v_scale, je.v_scale)):
        np.testing.assert_array_equal(tc.numpy(), np.asarray(jc))


@pytest.mark.parametrize("variant", ["mha", "gqa", "tied"])
@pytest.mark.parametrize("padded", [False, True])
def test_prefill_and_decode_steps_match_jax_engine(variant, padded):
    """`prefill` (right-padded with `lens`, or not) then a sequence of
    `decode_step`s over the same block tables: f32 logits within 1e-4 and
    the pools within f32 rounding after every call. The rows start on
    and across block boundaries (block size 4)."""
    kw = {"mha": {}, "gqa": {"num_key_value_heads": 2},
          "tied": {"tie_word_embeddings": True}}[variant]
    je, te = _engines(_jax_model(13, **kw))
    rng = np.random.default_rng(7)
    lens = np.asarray([5, 8, 3] if padded else [8, 8, 8], np.int32)
    ids = rng.integers(1, 256, (B, 8)).astype(np.int32)
    for sid in range(B):
        for mgr in (je.manager, te.manager):
            mgr.allocate(sid, 8)
            if padded:
                mgr.trim(sid, int(lens[sid]))
    tables = te.manager.block_table_array(list(range(B)))
    np.testing.assert_array_equal(
        tables, je.manager.block_table_array(list(range(B))))
    want = np.asarray(je.prefill(ids, tables, lens=lens if padded else None))
    got = te.prefill(ids, tables, lens=lens if padded else None)
    assert got.dtype == torch.float32 and got.shape == (B, 256)
    np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
    _pools_match(te, je)
    for _ in range(6):
        toks = rng.integers(1, 256, B).astype(np.int32)
        for sid in range(B):
            je.manager.append_token(sid)
            te.manager.append_token(sid)
        ctx = np.asarray([te.manager.seq_len(s) for s in range(B)],
                         np.int32)
        tables = te.manager.block_table_array(list(range(B)))
        want = np.asarray(je.decode_step(toks, ctx, tables))
        got = te.decode_step(toks, ctx, tables)
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        _pools_match(te, je)


_VERIFY_MODES = {"kv16": ({}, None), "kv16_w8": ({}, 8),
                 "kv16_w4": ({}, 4), "kv8": ({"kv_bits": 8}, None),
                 "kv8_w8": ({"kv_bits": 8}, 8), "kv8_w4": ({"kv_bits": 8}, 4)}


@pytest.mark.parametrize("mode", list(_VERIFY_MODES))
def test_verify_steps_match_jax_engine(mode, monkeypatch):
    """Prompts written by a ragged step, then verify windows of S = 3
    (pending token + 2 drafts) with rejected drafts trimmed back between
    them, in both KV modes, with and without weight-only int8/int4
    (`quantize_engine`): f32 logits [B, S, V] within 1e-4 and the pools
    equal after every step (int8 writes as in
    `test_quantized_ragged_steps_match_jax_engine`)."""
    kw, wbits = _VERIFY_MODES[mode]
    quant_kv = kw.get("kv_bits") == 8
    jax_calls = _record_jax_kv_quant(monkeypatch) if quant_kv else []
    je, te = _engines(_jax_model(14, num_key_value_heads=2), wbits, **kw)
    if quant_kv:
        substitute = _same_kv_writes(monkeypatch, jax_calls)
    rng = np.random.default_rng(8)
    s = 3
    prompt = [7, 4, 10]
    for sid, n in enumerate(prompt):
        for mgr in (je.manager, te.manager):
            mgr.allocate(sid, n)

    def step(kind, tokens, lens, tables, q_lens=None):
        if kind == "ragged":
            args = (tokens, q_lens, lens, tables)
        else:
            args = (tokens, lens, tables)
        jax_calls.clear()
        want = np.asarray(getattr(je, f"{kind}_step")(*args))
        if quant_kv:
            q = q_lens if kind == "ragged" else np.full(B, s, np.int32)
            lane, pos = pk.ragged_metadata(torch.from_numpy(q),
                                           torch.from_numpy(lens),
                                           len(tokens.reshape(-1)))
            substitute.src = pk.ragged_write_index(
                torch.from_numpy(tables), lane, pos, BS)[2]
            substitute.flipped = [0, 0]
        got = getattr(te, f"{kind}_step")(*args)
        assert not jax_calls
        np.testing.assert_allclose(got.numpy(), want, atol=ATOL, rtol=RTOL)
        if quant_kv:
            assert max(substitute.flipped) < 1e-3 * te.k_cache.numel()
        _pools_match(te, je)
        return got

    from paddle_tpu_torch.ops.kernels import paged_attention as pk

    n = sum(prompt)
    tokens = rng.integers(1, 256, n).astype(np.int32)
    lens = np.asarray(prompt, np.int32)
    step("ragged", tokens, lens, te.manager.block_table_array([0, 1, 2]),
         q_lens=lens)
    for accept in ([0, 2, 1], [2, 0, 0]):
        for sid in range(B):
            je.manager.append_tokens(sid, s)
            te.manager.append_tokens(sid, s)
        ctx = np.asarray([te.manager.seq_len(i) for i in range(B)],
                         np.int32)
        tables = te.manager.block_table_array([0, 1, 2])
        toks = rng.integers(1, 256, (B, s)).astype(np.int32)
        got = step("verify", toks, ctx, tables)
        assert got.shape == (B, s, 256)
        for sid in range(B):             # keep pending + accepted drafts
            for mgr in (je.manager, te.manager):
                mgr.trim(sid, int(ctx[sid]) - s + 1 + accept[sid])


@pytest.mark.parametrize("sample", [False, True])
def test_generate_matches_jax_engine(sample):
    """`generate` over the same weights gives the same tokens, greedy and
    with seeded temperature / top-k / top-p draws (the host sampler draws
    from the same numpy generator), and frees every block it leased; an
    eos stop ends both at the same length."""
    from paddle_tpu.inference import GenerationConfig as JaxGC
    from paddle_tpu_torch.inference import GenerationConfig

    je, te = _engines(_jax_model(15, num_key_value_heads=2))
    ids = np.random.default_rng(9).integers(1, 256, (2, 6)).astype(np.int32)
    kw = dict(max_new_tokens=9)
    if sample:
        kw.update(do_sample=True, temperature=0.9, top_k=40, top_p=0.9,
                  seed=3)
    want = je.generate(ids, JaxGC(**kw))
    got = te.generate(ids, GenerationConfig(**kw))
    assert got.dtype == np.int32 and got.shape == (2, 6 + 9)
    np.testing.assert_array_equal(got, want)
    assert te.manager.free_blocks == te.manager.num_blocks
    eos = int(want[0, 8])
    np.testing.assert_array_equal(
        te.generate(ids[:1], GenerationConfig(**kw, eos_token_id=eos)),
        je.generate(ids[:1], JaxGC(**kw, eos_token_id=eos)))
