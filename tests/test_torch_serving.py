"""`ServingFrontend` over both packages: the same f32 Llama weights and
the same requests give the same token streams, final statuses and finish
reasons, through chunked prefill, an eos stop, a forced preemption, a
cancel, a rejected empty prompt, greedy and seeded stochastic decoding."""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.inference import LlamaInferenceEngine as JaxEngine
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.serving import ServingFrontend as JaxFrontend
from paddle_tpu.serving import ServingMetrics as JaxMetrics
from paddle_tpu_torch import (LlamaConfig, LlamaInferenceEngine,
                              ServingFrontend, from_jax_state)
from paddle_tpu_torch.serving import ServingMetrics
from torch_threads import one_thread  # noqa: F401

VOCAB = 256


@pytest.fixture(scope="module")
def jax_model():
    paddle.seed(21)
    m = jax_llama_tiny(vocab=VOCAB, layers=2, hidden=64, heads=4, seq=64,
                       num_key_value_heads=2)
    rng = np.random.default_rng(21)
    for name, p in m.named_parameters():
        if "norm" in name:
            p._data = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=p.shape), jnp.float32)
    return m


@pytest.fixture(autouse=True)
def _fresh_counters():
    JaxMetrics.reset_monitor()
    ServingMetrics.reset_monitor()
    yield


def _frontends(m, num_blocks=48, max_batch=4, chunk=4):
    geo = dict(max_batch_size=max_batch, num_blocks=num_blocks, block_size=4,
               max_blocks_per_seq=16)
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    port = from_jax_state(state, LlamaConfig(**dataclasses.asdict(m.config)),
                          device="cpu")
    return (JaxFrontend(JaxEngine(m, **geo), prefill_chunk_tokens=chunk),
            ServingFrontend(LlamaInferenceEngine(port, device="cpu", **geo),
                            prefill_chunk_tokens=chunk))


def _drive(fe, requests, cancel_at=None):
    """Submit every request, step until idle; `cancel_at=(step, index)`
    cancels one request after that many steps."""
    handles = [fe.submit(p, **kw) for p, kw in requests]
    steps = 0
    while not fe.scheduler.idle:
        fe.step()
        steps += 1
        if cancel_at is not None and steps == cancel_at[0]:
            assert fe.cancel(handles[cancel_at[1]])
        assert steps < 500
    return [(h.tokens, h.status.value, h.finish_reason, h.num_preemptions)
            for h in handles]


def _prompts(seed, lens):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, n).astype(np.int32) for n in lens]


def test_mixed_requests_stream_identically(jax_model):
    p = _prompts(1, [9, 3, 14, 6, 1, 11])
    reqs = [(p[0], dict(max_new_tokens=8)),
            (p[1], dict(max_new_tokens=6, temperature=0.8, top_k=20,
                        seed=5)),
            (p[2], dict(max_new_tokens=10)),
            (p[3], dict(max_new_tokens=7, temperature=1.3, seed=11)),
            ([], dict(max_new_tokens=4)),                    # rejected
            (p[4], dict(max_new_tokens=5)),
            (p[5], dict(max_new_tokens=9, temperature=0.6, top_k=3,
                        seed=2))]
    jfe, tfe = _frontends(jax_model)
    want = _drive(jfe, reqs, cancel_at=(6, 2))
    got = _drive(tfe, reqs, cancel_at=(6, 2))
    assert got == want
    statuses = [s for _t, s, _r, _p in want]
    assert statuses.count("rejected") == 1 and want[4][2] == "empty_prompt"
    assert statuses.count("cancelled") == 1
    assert statuses.count("finished") == 5


def test_eos_stop_matches(jax_model):
    p = _prompts(2, [7, 12])
    jfe, _ = _frontends(jax_model)
    first = _drive(jfe, [(p[0], dict(max_new_tokens=8))])[0][0]
    eos = first[3]                                 # stop on the 4th token
    reqs = [(p[0], dict(max_new_tokens=8, eos_token_id=eos)),
            (p[1], dict(max_new_tokens=5, temperature=0.9, seed=4))]
    jfe, tfe = _frontends(jax_model)
    want = _drive(jfe, reqs)
    got = _drive(tfe, reqs)
    assert got == want
    assert want[0][2] == "eos" and want[0][0][-1] == eos
    assert len(want[0][0]) <= 4


def test_preemption_under_a_small_pool_matches(jax_model):
    p = _prompts(3, [10, 12, 9])
    reqs = [(p[0], dict(max_new_tokens=12)),
            (p[1], dict(max_new_tokens=12, temperature=0.7, seed=8)),
            (p[2], dict(max_new_tokens=12))]
    jfe, tfe = _frontends(jax_model, num_blocks=12, max_batch=3, chunk=8)
    want = _drive(jfe, reqs)
    got = _drive(tfe, reqs)
    assert got == want
    assert sum(n for *_x, n in want) >= 1          # a preemption happened
    assert all(s == "finished" for _t, s, _r, _n in want)
    assert tfe.scheduler.engine.manager.free_blocks == \
        jfe.scheduler.engine.manager.free_blocks


def test_prompt_too_long_and_summary(jax_model):
    _, tfe = _frontends(jax_model)
    h = tfe.submit(np.ones(64, np.int32), max_new_tokens=2)
    assert h.status.value == "rejected" and h.finish_reason == \
        "prompt_too_long"
    ok = tfe.submit([1, 2, 3], max_new_tokens=3)
    toks = list(tfe.stream(ok))
    assert toks == ok.tokens and len(toks) == 3
    s = tfe.summary()
    assert s["serving.requests_submitted"] == 2
    assert s["serving.requests_rejected"] == 1
    assert s["serving.requests_completed"] == 1
    assert s["serving.tokens_generated"] == 2      # first token: prefill
    assert s["serving.ragged_steps"] >= 3
    assert s["serving.ttft_p50_ms"] is not None


def _faulty(fe, handles_of, error_cls, raise_at=3, nan_at=6):
    """Wrap the frontend's engine: dispatch `raise_at` raises a typed
    `EngineStepError` naming request 1; dispatch `nan_at` returns logits
    whose first packed row is NaN (the first occupied lane's token)."""
    eng = fe.scheduler.engine
    step, calls = eng.ragged_step, [0]

    def ragged_step(*args):
        calls[0] += 1
        if calls[0] == raise_at:
            raise error_cls("decode",
                            seq_ids=[handles_of()[1].request_id])
        out = step(*args)
        if calls[0] == nan_at:
            if isinstance(out, torch.Tensor):
                out = out.clone()
            else:
                out = np.array(out)
            out[0] = np.nan
        return out

    eng.ragged_step = ragged_step


def test_fault_isolation_matches(jax_model):
    from paddle_tpu.serving.fault_tolerance import EngineStepError as JErr
    from paddle_tpu_torch.serving import EngineStepError as TErr

    p = _prompts(4, [6, 9, 5, 7])
    reqs = [(q, dict(max_new_tokens=6)) for q in p]
    jfe, tfe = _frontends(jax_model)
    out = {}
    for name, fe, err in (("jax", jfe, JErr), ("port", tfe, TErr)):
        handles = []
        _faulty(fe, lambda: handles, err)
        handles += [fe.submit(q, **kw) for q, kw in reqs]
        fe.run_until_idle()
        out[name] = [(h.tokens, h.status.value, h.finish_reason)
                     for h in handles]
    assert out["port"] == out["jax"]
    reasons = [r for _t, _s, r in out["jax"]]
    assert reasons[1] == "engine_fault:decode"
    assert "nan_logits" in reasons
    assert sum(s == "finished" for _t, s, _r in out["jax"]) == 2
