"""Speculative serving over both packages: the proposers give the same
drafts, and `ServingFrontend(engine, spec=SpecDecodeConfig(...))` with
the n-gram and the draft-engine proposer streams the same tokens, final
statuses and `serving.spec_*` counters as the JAX package's, through
chunked prefill, an eos stop, a small pool that preempts, a cancel,
greedy and seeded stochastic decoding; and the same tokens as the
port's own plain serving."""
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
from paddle_tpu.serving import spec as jax_spec
from paddle_tpu_torch import (LlamaConfig, LlamaInferenceEngine,
                              ServingFrontend, from_jax_state)
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.inference.cache import KVCacheExhausted
from paddle_tpu_torch.serving import (DraftEngineProposer, NGramProposer,
                                      ServingMetrics, SpecDecodeConfig)
from torch_threads import one_thread  # noqa: F401

VOCAB = 64
GEO = dict(block_size=4, max_blocks_per_seq=16)
SPEC_COUNTERS = ("serving.spec_steps", "serving.spec_proposed_tokens",
                 "serving.spec_accepted_tokens",
                 "serving.spec_acceptance_pct",
                 "serving.spec_tokens_per_lane_step",
                 "serving.tokens_generated", "serving.preemptions")


def _jax_model(seed, layers=2, hidden=64):
    paddle.seed(seed)
    m = jax_llama_tiny(vocab=VOCAB, layers=layers, hidden=hidden, heads=4,
                       seq=64, num_key_value_heads=2)
    rng = np.random.default_rng(seed)
    for name, p in m.named_parameters():
        if "norm" in name:
            p._data = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=p.shape), jnp.float32)
    return m


@pytest.fixture(scope="module")
def models():
    """The target and a smaller draft model (same vocab). A small vocab
    keeps greedy drafts agreeing with the target often enough that
    rounds accept some drafts and reject others."""
    return _jax_model(31), _jax_model(32, layers=1, hidden=32)


@pytest.fixture(autouse=True)
def _fresh_counters():
    JaxMetrics.reset_monitor()
    ServingMetrics.reset_monitor()
    yield


def _port(m):
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    return from_jax_state(state, LlamaConfig(**dataclasses.asdict(m.config)),
                          device="cpu")


def _engines(m, num_blocks, max_batch):
    geo = dict(GEO, max_batch_size=max_batch, num_blocks=num_blocks)
    return JaxEngine(m, **geo), LlamaInferenceEngine(_port(m), device="cpu",
                                                     **geo)


def _frontends(target, proposer, k, num_blocks=64, max_batch=3, chunk=4,
               draft=None):
    """Both packages' frontends over the same target weights, with the
    n-gram proposer (`proposer="ngram"`), a draft engine over `draft`'s
    weights (`"draft"`), or no speculation (`None`)."""
    je, te = _engines(target, num_blocks, max_batch)
    specs = [None, None]
    if proposer == "ngram":
        specs = [jax_spec.SpecDecodeConfig(jax_spec.NGramProposer(), k),
                 SpecDecodeConfig(NGramProposer(), k)]
    elif proposer == "draft":
        jd, td = _engines(draft, 64, 1)
        specs = [jax_spec.SpecDecodeConfig(
            jax_spec.DraftEngineProposer(jd), k),
            SpecDecodeConfig(DraftEngineProposer(td), k)]
    return (JaxFrontend(je, prefill_chunk_tokens=chunk, spec=specs[0]),
            ServingFrontend(te, prefill_chunk_tokens=chunk, spec=specs[1]))


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


def _counters(get):
    return {n: get(n) for n in SPEC_COUNTERS}


def _prompts(seed, lens, cyclic=()):
    """Random prompts; the indices in `cyclic` repeat a 3-token phrase,
    so the n-gram proposer has something to find."""
    rng = np.random.default_rng(seed)
    out = []
    for i, n in enumerate(lens):
        if i in cyclic:
            out.append(np.resize(rng.integers(1, VOCAB, 3), n)
                       .astype(np.int32))
        else:
            out.append(rng.integers(1, VOCAB, n).astype(np.int32))
    return out


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_ngram_proposals_match_jax(seed):
    rng = np.random.default_rng(seed)
    contexts = [rng.integers(0, 5, n) for n in (1, 2, 7, 30)]
    contexts += [np.resize(rng.integers(0, 50, p), n)
                 for p, n in ((1, 6), (3, 17), (5, 40))]
    for kw in ({}, {"max_ngram": 2, "min_ngram": 2},
               {"max_ngram": 4, "min_ngram": 1}):
        jp, tp = jax_spec.NGramProposer(**kw), NGramProposer(**kw)
        for ctx in contexts:
            for k in (1, 3, 8):
                assert tp.propose(0, ctx, k) == jp.propose(0, ctx, k)


def test_ngram_rejects_bad_sizes_as_jax_does():
    for kw in ({"max_ngram": 1, "min_ngram": 2}, {"min_ngram": 0}):
        with pytest.raises(ValueError):
            jax_spec.NGramProposer(**kw)
        with pytest.raises(ValueError):
            NGramProposer(**kw)
    with pytest.raises(ValueError):
        SpecDecodeConfig(NGramProposer(), 0)


def test_draft_proposals_match_jax(models):
    """A draft engine over the same weights proposes the same tokens as
    the JAX package's, through the first prefill, catch-up decode steps,
    a re-score of an unchanged context, and a shorter (trimmed) one."""
    _target, draft = models
    jd, td = _engines(draft, 64, 1)
    jp, tp = jax_spec.DraftEngineProposer(jd), DraftEngineProposer(td)
    ctx = _prompts(5, [40])[0]
    for n, k in ((9, 3), (12, 4), (12, 2), (13, 4), (11, 3), (40, 4)):
        want = jp.propose(7, ctx[:n], k)
        got = tp.propose(7, ctx[:n], k)
        assert got == want and len(got) == k
        assert td.manager.seq_len(7) == jd.manager.seq_len(7) == n
    # a context past the draft's sequence cap proposes nothing and drops
    # the lease
    assert tp.propose(7, np.ones(70, np.int32), 2) == [] == \
        jp.propose(7, np.ones(70, np.int32), 2)
    assert td.manager.free_blocks == jd.manager.free_blocks == 64
    tp.release(7)


def test_draft_fault_after_allocate_frees_the_lease(models):
    """A draft `prefill` that raises after its blocks were leased leaves
    the draft pool whole: out of pool it proposes nothing, and any other
    error (a kernel that fails to launch) propagates."""
    _target, draft = models
    _jd, td = _engines(draft, 64, 1)
    for err, want in ((KVCacheExhausted(1, 0, 64), []),
                      (RuntimeError("decode kernel launch failed"), None)):
        def broken(*args, _err=err, **kw):
            raise _err

        td.prefill = broken
        tp = DraftEngineProposer(td)
        if want is None:
            with pytest.raises(RuntimeError, match="launch failed"):
                tp.propose(3, _prompts(6, [10])[0], 2)
        else:
            assert tp.propose(3, _prompts(6, [10])[0], 2) == want
        assert td.manager.free_blocks == 64


def _requests(seed):
    p = _prompts(seed, [9, 3, 14, 6, 11], cyclic=(0, 2))
    return [(p[0], dict(max_new_tokens=10)),
            (p[1], dict(max_new_tokens=7, temperature=0.8, top_k=20,
                        seed=5)),
            (p[2], dict(max_new_tokens=12)),
            (p[3], dict(max_new_tokens=8, temperature=1.3, seed=11)),
            (p[4], dict(max_new_tokens=9))]


@pytest.mark.parametrize("proposer,k", [("ngram", 3), ("draft", 2)])
def test_spec_streams_match_jax_and_plain(models, proposer, k):
    """Greedy and seeded-stochastic lanes, chunked prefill (chunk 4 into
    windows of K + 1) and a cancel: the same tokens, statuses and spec
    counters as the JAX package, and the same tokens as the port's own
    plain (non-speculative) serving."""
    target, draft = models
    reqs = _requests(3)
    jfe, tfe = _frontends(target, proposer, k, draft=draft)
    want = _drive(jfe, reqs, cancel_at=(5, 4))
    want_c = _counters(jax_monitor.get)
    got = _drive(tfe, reqs, cancel_at=(5, 4))
    assert got == want
    assert _counters(monitor.get) == want_c
    assert want_c["serving.spec_proposed_tokens"] > 0
    assert 0 < want_c["serving.spec_accepted_tokens"] < \
        want_c["serving.spec_proposed_tokens"]
    statuses = [s for _t, s, _r, _p in want]
    assert statuses.count("cancelled") == 1 and statuses.count("finished") \
        == 4
    s = tfe.summary()
    assert s["serving.spec_steps"] == want_c["serving.spec_steps"]
    assert s["serving.spec_acceptance_pct"] == \
        want_c["serving.spec_acceptance_pct"]
    # spec == plain inside the port (the cancel lands on another step
    # there, so drop the cancelled request)
    _, plain = _frontends(target, None, k)
    base = _drive(plain, reqs[:4])
    assert [t for t, *_x in got[:4]] == [t for t, *_x in base]
    if proposer == "draft":
        # every request left the batch: the draft engine holds nothing
        dm = tfe.scheduler.spec.proposer.engine.manager
        assert dm.free_blocks == dm.num_blocks


@pytest.mark.parametrize("proposer,k", [("ngram", 3), ("draft", 2)])
def test_spec_eos_and_preemption_match_jax(models, proposer, k):
    """An eos stop inside an accepted window, and a pool small enough
    that growing the windows preempts."""
    target, draft = models
    p = _prompts(4, [10, 12, 9], cyclic=(0, 1))
    jfe, _ = _frontends(target, proposer, k, draft=draft)
    eos = _drive(jfe, [(p[0], dict(max_new_tokens=8))])[0][0][3]
    reqs = [(p[0], dict(max_new_tokens=10, eos_token_id=eos)),
            (p[1], dict(max_new_tokens=14, temperature=0.7, seed=8)),
            (p[2], dict(max_new_tokens=14))]
    JaxMetrics.reset_monitor()
    jfe, tfe = _frontends(target, proposer, k, num_blocks=12, chunk=8,
                          draft=draft)
    want = _drive(jfe, reqs)
    want_c = _counters(jax_monitor.get)
    got = _drive(tfe, reqs)
    assert got == want
    assert _counters(monitor.get) == want_c
    assert want[0][2] == "eos" and want[0][0][-1] == eos
    assert sum(n for *_x, n in want) >= 1          # a preemption happened
    assert tfe.scheduler.engine.manager.free_blocks == \
        jfe.scheduler.engine.manager.free_blocks


def test_spec_on_an_int8_pool_matches_jax(models):
    """Speculation over a kv_bits=8 target: verify_step rides the int8
    ragged path in both packages."""
    target, _ = models
    geo = dict(GEO, max_batch_size=3, num_blocks=64, kv_bits=8)
    jfe = JaxFrontend(JaxEngine(target, **geo), prefill_chunk_tokens=4,
                      spec=jax_spec.SpecDecodeConfig(
                          jax_spec.NGramProposer(), 3))
    tfe = ServingFrontend(LlamaInferenceEngine(_port(target), device="cpu",
                                               **geo),
                          prefill_chunk_tokens=4,
                          spec=SpecDecodeConfig(NGramProposer(), 3))
    reqs = _requests(6)[:3]
    want = _drive(jfe, reqs)
    got = _drive(tfe, reqs)
    assert got == want
    assert _counters(monitor.get) == _counters(jax_monitor.get)


class _FailingProposer:
    def __init__(self):
        self.released = []

    def propose(self, seq_id, context, k):
        raise KVCacheExhausted(1, 0, 64)

    def release(self, seq_id):
        self.released.append(seq_id)


def test_failing_proposer_degrades_to_plain_decoding(models):
    """A proposer out of pool proposes nothing: the lanes decode one
    token per round, the same tokens as plain serving, and every
    request's proposer state is released when it leaves the batch."""
    target, _ = models
    prop = _FailingProposer()
    _, tfe = _frontends(target, None, 2)
    tfe.scheduler.spec = SpecDecodeConfig(prop, 2)
    reqs = _requests(7)[:3]
    got = _drive(tfe, reqs)
    _, plain = _frontends(target, None, 2)
    assert [t for t, *_x in got] == [t for t, *_x in _drive(plain, reqs)]
    assert monitor.get("serving.spec_proposed_tokens") == 0
    assert len(set(prop.released)) == len(reqs)    # one per request


def test_failing_draft_decode_step_propagates(models):
    """A draft engine whose `decode_step` raises (a decode kernel that
    fails to build or launch) stops serving with that error instead of
    serving on without drafts: the round's lanes roll back to their
    lengths before it, and the failing sequence holds no draft lease."""
    target, draft = models
    _, tfe = _frontends(target, "draft", 2, draft=draft)
    proposer = tfe.scheduler.spec.proposer

    def broken(*args, **kw):
        raise RuntimeError("paged_attention_decode launch failed")

    proposer.engine.decode_step = broken
    for q, kw in _requests(9)[:3]:
        tfe.submit(q, **kw)
    mgr = tfe.scheduler.engine.manager
    for _ in range(100):
        before = {r.seq_id: mgr.seq_len(r.seq_id)
                  for r in tfe.scheduler.slots if r is not None}
        try:
            tfe.step()
        except RuntimeError as e:
            assert "launch failed" in str(e)
            break
    else:
        pytest.fail("the failing draft decode_step was never reached")
    assert {r.seq_id: mgr.seq_len(r.seq_id)
            for r in tfe.scheduler.slots if r is not None} == before
    assert proposer._synced == {}
    dm = proposer.engine.manager
    assert dm.free_blocks == dm.num_blocks
    assert monitor.get("serving.spec_proposed_tokens") == 0


def test_spec_fault_isolation_matches_jax(models):
    """A verify dispatch that raises a typed `EngineStepError` naming one
    request fails that request alone (the others roll back and replay),
    and a verify whose first lane's logits are NaN fails that lane alone,
    in both packages alike."""
    from paddle_tpu.serving.fault_tolerance import EngineStepError as JErr
    from paddle_tpu_torch.serving import EngineStepError as TErr

    target, _ = models
    reqs = [(q, dict(max_new_tokens=8))
            for q in _prompts(8, [6, 9, 5], cyclic=(1,))]
    out = {}
    for name, fe, err in zip(("jax", "port"),
                             _frontends(target, "ngram", 3), (JErr, TErr)):
        handles = []
        eng = fe.scheduler.engine
        verify, calls = eng.verify_step, [0]

        def verify_step(*args, _verify=verify, _calls=calls, _err=err,
                        _handles=handles):
            _calls[0] += 1
            if _calls[0] == 3:
                raise _err("verify", seq_ids=[_handles[1].request_id])
            out = _verify(*args)
            if _calls[0] == 6:
                out = out.clone() if isinstance(out, torch.Tensor) \
                    else np.array(out)
                out[0] = np.nan
            return out

        eng.verify_step = verify_step
        handles += [fe.submit(q, **kw) for q, kw in reqs]
        fe.run_until_idle()
        out[name] = [(h.tokens, h.status.value, h.finish_reason)
                     for h in handles]
        assert fe.scheduler.engine.manager.free_blocks == \
            fe.scheduler.engine.manager.num_blocks - 1     # the guard
    assert out["port"] == out["jax"]
    reasons = [r for _t, _s, r in out["jax"]]
    assert reasons[1] == "engine_fault:verify"
    assert "nan_logits" in reasons
