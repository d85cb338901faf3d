"""Quantized serving over both packages: `quantize_engine`,
`greedy_agreement`, the quantization gauges the scheduler publishes at
bind, and `ServingFrontend` token streams on quantized engines (int8 KV
with int8 or int4 weights), greedy and seeded-stochastic, on the same f32
weights."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.framework import monitor as jax_monitor
from paddle_tpu.inference import LlamaInferenceEngine as JaxEngine
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.serving import ServingMetrics as JaxMetrics
from paddle_tpu.serving.quant import greedy_agreement as jax_agreement
from paddle_tpu.serving.quant import quantize_engine as jax_quantize
from paddle_tpu_torch import (LlamaConfig, LlamaInferenceEngine,
                              ServingFrontend, from_jax_state)
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.serving import ServingMetrics
from paddle_tpu_torch.serving.quant import (greedy_agreement, quant_summary,
                                            quantize_engine)
from torch_threads import one_thread  # noqa: F401

VOCAB = 128
GEO = dict(max_batch_size=4, num_blocks=64, block_size=8,
           max_blocks_per_seq=16)


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(31)
    m = jax_llama_tiny(vocab=VOCAB, layers=2, hidden=64, heads=4, seq=256,
                       num_key_value_heads=2)
    rng = np.random.default_rng(31)
    for name, p in m.named_parameters():
        if "norm" in name:
            p._data = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=p.shape), jnp.float32)
    return m


@pytest.fixture(scope="module")
def port_model(jax_model):
    state = {k: np.asarray(v) for k, v in state_arrays(jax_model).items()}
    return from_jax_state(
        state, LlamaConfig(**dataclasses.asdict(jax_model.config)),
        device="cpu")


@pytest.fixture(autouse=True)
def _fresh_counters():
    JaxMetrics.reset_monitor()
    ServingMetrics.reset_monitor()
    yield


def _pair(jax_model, port_model, kv_bits=16, wbits=None):
    je = JaxEngine(jax_model, kv_bits=kv_bits, **GEO)
    te = LlamaInferenceEngine(port_model, kv_bits=kv_bits, device="cpu",
                              **GEO)
    if wbits is not None:
        jax_quantize(je, wbits)
        quantize_engine(te, wbits)
    return je, te


def _prompts(n, seed, lo=6, hi=40):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(rng.integers(lo, hi)))
            .astype(np.int32) for _ in range(n)]


@pytest.mark.parametrize("wbits", [8, 4])
def test_greedy_agreement_matches_jax(jax_model, port_model, wbits):
    """The port's agreement numbers equal the JAX package's on the same
    weights and prompts, and the small model clears the tie-aware gate
    the JAX package's quantized serving requires (>= 0.99)."""
    prompts = _prompts(4, seed=2)
    jq, tq = _pair(jax_model, port_model, kv_bits=8, wbits=wbits)
    tr = LlamaInferenceEngine(port_model, device="cpu", **GEO)
    want = jax_agreement(jq, JaxEngine(jax_model, **GEO), prompts)
    got = greedy_agreement(tq, tr, prompts)
    assert got["positions"] == want["positions"] == sum(map(len, prompts))
    assert got["agreement"] == want["agreement"]
    assert got["agreement_tie_aware"] == want["agreement_tie_aware"]
    for key in ("max_logit_err", "mean_logit_err"):
        assert got[key] == pytest.approx(want[key], abs=1e-4)
    assert got["agreement_tie_aware"] >= 0.99, got
    # the synthetic leases are returned
    assert tq.manager.free_blocks == tr.manager.free_blocks == GEO[
        "num_blocks"]


def _drive(fe, requests):
    handles = [fe.submit(p, **kw) for p, kw in requests]
    steps = 0
    while not fe.scheduler.idle:
        fe.step()
        steps += 1
        assert steps < 500
    return [(h.tokens, h.status.value, h.finish_reason) for h in handles]


@pytest.mark.parametrize("wbits", [8, 4])
def test_quantized_serving_streams_match_jax(jax_model, port_model, wbits):
    """int8 KV + weight-only int8/int4: chunked prefill, greedy and
    seeded-stochastic decoding give the JAX package's token streams."""
    p = _prompts(5, seed=3)
    reqs = [(p[0], dict(max_new_tokens=8)),
            (p[1], dict(max_new_tokens=6, temperature=0.8, top_k=20,
                        seed=5)),
            (p[2], dict(max_new_tokens=7)),
            (p[3], dict(max_new_tokens=5, temperature=1.2, seed=9)),
            (p[4], dict(max_new_tokens=6))]
    je, te = _pair(jax_model, port_model, kv_bits=8, wbits=wbits)
    want = _drive(JaxFrontend(je, prefill_chunk_tokens=8), reqs)
    got = _drive(ServingFrontend(te, prefill_chunk_tokens=8), reqs)
    assert got == want
    assert all(s == "finished" for _t, s, _r in want)


@pytest.mark.parametrize("kv_bits,wbits", [(16, None), (8, None), (8, 8),
                                           (8, 4)])
def test_quant_gauges_match_jax_at_bind(jax_model, port_model, kv_bits,
                                        wbits):
    je, te = _pair(jax_model, port_model, kv_bits=kv_bits, wbits=wbits)
    JaxFrontend(je)
    ServingFrontend(te)
    assert quant_summary(te) == te.quant_info() == je.quant_info()
    for name in ("serving.quant.wbits", "serving.quant.kv_bits",
                 "serving.kv_bytes_per_token"):
        assert monitor.get(name) == jax_monitor.get(name), name
    assert monitor.get("serving.quant.wbits") == (wbits or 16)
    assert monitor.get("serving.quant.kv_bits") == kv_bits
    assert monitor.get("serving.kv_bytes_per_token") == \
        round(te.kv_bytes_per_token(), 1)


def test_broken_quant_hook_is_counted_not_fatal(port_model):
    te = LlamaInferenceEngine(port_model, device="cpu", **GEO)

    def broken():
        raise RuntimeError("no quant info")

    te.quant_info = broken
    ServingFrontend(te)
    assert monitor.get("serving.quant_info_errors") == 1
    assert monitor.get("serving.quant.wbits") == 0


def test_quantize_engine_layout(jax_model, port_model):
    """The same int storage and scales as the JAX package's observer
    path; an untied head is quantized, the embedding is not; a second
    pass is refused."""
    je, te = _pair(jax_model, port_model, wbits=4)
    assert te.weight_only == je.weight_only == "int4"
    for key in ("qkv_w", "o_w", "gate_up_w", "down_w"):
        for l, w in enumerate(te.params[key]):
            assert w["q4"].is_contiguous()
            np.testing.assert_array_equal(
                w["q4"].numpy(), np.asarray(je.params[key]["q4"][l]))
            np.testing.assert_array_equal(
                w["s"].numpy(), np.asarray(je.params[key]["s"][l]))
    np.testing.assert_array_equal(te.params["lm_head"]["q4"].numpy(),
                                  np.asarray(je.params["lm_head"]["q4"]))
    assert isinstance(te.params["embed"], torch.Tensor)
    with pytest.raises(ValueError, match="already quantized"):
        quantize_engine(te, 8)
    with pytest.raises(ValueError):
        quantize_engine(LlamaInferenceEngine(port_model, device="cpu",
                                             **GEO), 3)


def test_tied_head_stays_dense():
    paddle.seed(5)
    m = jax_llama_tiny(vocab=VOCAB, layers=1, hidden=64, heads=4, seq=64,
                       tie_word_embeddings=True)
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    tm = from_jax_state(state, LlamaConfig(**dataclasses.asdict(m.config)),
                        device="cpu")
    te = quantize_engine(LlamaInferenceEngine(
        tm, device="cpu", max_blocks_per_seq=4), 8)
    assert "lm_head" not in te.params
    assert te.quant_info()["wbits"] == 8
