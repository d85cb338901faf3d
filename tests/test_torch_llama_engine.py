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


@pytest.mark.parametrize("variant", ["mha", "gqa", "tied"])
@pytest.mark.parametrize("mode", list(_MODES))
def test_quantized_ragged_steps_match_jax_engine(mode, variant):
    """Quantized modes: f32 logits within 1e-4 (the port's gemm scales
    after its f32 sum, the JAX CPU path before its matmul); int8 pools
    at most one step apart (an f32 K/V value on a rounding boundary),
    almost everywhere exact; scales within 1e-6 relative or 1e-7
    absolute (layer 2's K/V come out of layer 1's f32 sums, taken in
    another order)."""
    kw, wbits = _MODES[mode]
    model_kw = {"mha": {}, "gqa": {"num_key_value_heads": 2},
                "tied": {"tie_word_embeddings": True}}[variant]
    je, te = _engines(_jax_model(12, **model_kw), wbits, **kw)
    assert te.quant_info() == je.quant_info()
    rng = np.random.default_rng(6)
    t = B + 8
    for q_lens, kv_lens, rows in _STEPS:
        tokens = np.zeros((t,), np.int32)
        n = sum(q_lens)
        tokens[:n] = rng.integers(1, 256, n)
        args = (tokens, np.asarray(q_lens, np.int32),
                np.asarray(kv_lens, np.int32), _tables(rows))
        jl = np.asarray(je.ragged_step(*args))
        tl = te.ragged_step(*args)
        np.testing.assert_allclose(tl.numpy(), jl, atol=ATOL, rtol=RTOL)
        if te.kv_bits == 16:
            continue
        for tc, jc in ((te.k_cache, je.k_cache), (te.v_cache, je.v_cache)):
            assert tc.dtype == torch.int8
            diff = np.abs(tc.numpy().astype(np.int32)
                          - np.asarray(jc).astype(np.int32))
            assert diff.max() <= 1 and (diff != 0).mean() < 1e-3
        for ts, js in ((te.k_scale, je.k_scale), (te.v_scale, je.v_scale)):
            np.testing.assert_allclose(ts.numpy(), np.asarray(js),
                                       rtol=1e-6, atol=1e-7)


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
    te = LlamaInferenceEngine(_port(_jax_model(4)), max_blocks_per_seq=4,
                              device="cpu")
    with pytest.raises(NotImplementedError):
        getattr(te, entry)()


def test_kv_geometry_matches_jax():
    m = _jax_model(6, num_key_value_heads=2)
    je, te = _engines(m)
    assert te.kv_bytes_per_token() == je.kv_bytes_per_token()
    assert te.manager.bytes_per_block == je.manager.bytes_per_block
