"""Disaggregated prefill/decode serving on the port
(`paddle_tpu_torch.serving.disagg`): every scenario of the JAX suite
`tests/test_serving_disagg.py` runs on the port (`device="cpu"`) with the
JAX suite's own assertions, on the same tiny MLP engine (its retrace
test, whose subject is jit, becomes a second identical burst that must
take as many decode steps and prefill tokens as the first); the handoff,
the extraction-fault fallback and the cross-replica prefix stream also
run on the JAX router, and the outcomes are compared: token streams, statuses, replica ids, relocation counts,
handoff states, each request's timeline event names in order, the
`fleet.*` and `serving.handoff.*` counters (the payload bytes included)
and the tiers."""
import pytest

import torch_fleet_common as C
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.resilience import faults
from paddle_tpu_torch.serving import (DisaggRouter, FleetRouter,
                                      HandoffError, HandoffState,
                                      MLPLMEngine, NGramProposer,
                                      RequestStatus, ServingFrontend,
                                      SpecDecodeConfig)

POOL = C.JaxEnginePool()
JAX, PORT = C.packages(POOL)
make_engine = PORT.make_engine
prompts = C.prompts


@pytest.fixture(autouse=True)
def _clean():
    for p in (JAX, PORT):
        C.fresh(p)
    yield
    for p in (JAX, PORT):
        p.faults.clear()
        p.obs.disable()


def reference_tokens(ps, max_new=6):
    return C.reference_tokens(PORT, ps, max_new)


def disagg(num_prefill=2, num_decode=2, **kw):
    return DisaggRouter(make_engine, num_prefill=num_prefill,
                        num_decode=num_decode, **kw)


def _handoff_counters(p):
    return {k: v for k, v in p.monitor.snapshot("serving.handoff.").items()
            if v and not k.endswith(("wall_ms", "_sum"))
            and "_bucket_" not in k}


# ---------------------------------------------------------------------------
# held to the JAX router
# ---------------------------------------------------------------------------

class TestAgainstJax:
    def test_handoff(self):
        def scenario(p):
            ps = prompts(8)
            ref = C.reference_tokens(p, ps)
            with p.s.DisaggRouter(p.make_engine, num_prefill=2,
                                  num_decode=2) as r:
                tiers = r.fleet_summary()["tiers"]
                hs = [r.submit(x, max_new_tokens=6) for x in ps]
                r.run_until_idle()
                assert [h.tokens for h in hs] == ref
                assert all(h.replica_id in tiers["decode"] for h in hs)
                assert all(rep.scheduler.kv_leaked_blocks() == 0
                           for rep in r.replicas)
                return (tiers, C.handle_outcome(hs),
                        [r.handoff_state(h).value for h in hs],
                        C.fleet_counters(p), _handoff_counters(p))

        out = C.both(POOL, scenario)
        assert out[3]["fleet.handoffs"] == 8
        assert "fleet.handoff_fallbacks" not in out[3]
        assert out[4]["serving.handoff.count"] == 8
        assert out[4]["serving.handoff.latency_seconds_count"] == 8
        # decode-tier events follow a second queued/admitted pair
        names = out[1][0][-1]
        assert names.count("queued") == 2 and names.count("prefill") == 1

    def test_prefix_stream(self):
        prompt = TestCrossReplicaPrefixStream.PROMPT

        def scenario(p):
            with p.s.FleetRouter(p.make_engine, 2, frontend_kwargs=dict(
                    prefix_cache=True)) as r:
                h1 = r.submit(prompt, max_new_tokens=6)
                r.run_until_idle()
                busy = r.submit(list(range(20, 28)), max_new_tokens=40)
                h2 = r.submit(prompt, max_new_tokens=6)
                r.run_until_idle()
                h3 = r.submit(prompt, max_new_tokens=6)
                r.run_until_idle()
                assert h2.tokens == h1.tokens == h3.tokens
                for rep in r.replicas:
                    assert rep.scheduler.kv_leaked_blocks() == 0
                return (C.handle_outcome([h1, busy, h2, h3]),
                        C.fleet_counters(p),
                        [h._req._prefix_hit_tokens for h in (h2, h3)])

        out = C.both(POOL, scenario)
        assert out[1]["fleet.prefix_streams"] == 1
        assert out[1]["fleet.prefix_stream_tokens"] == 12
        assert out[1]["fleet.prefix_stream_bytes"] == 3 * 4 * 16 * 4

    def test_extraction_fault_falls_back_to_fold(self):
        def scenario(p):
            ps = prompts(5, seed=11)
            ref = C.reference_tokens(p, ps)
            p.faults.inject("fleet.handoff", after_n=1, times=1,
                            action="raise")
            with p.s.DisaggRouter(p.make_engine, num_prefill=2,
                                  num_decode=2) as r:
                hs = [r.submit(x, max_new_tokens=6) for x in ps]
                r.run_until_idle()
                assert [h.tokens for h in hs] == ref
                return (C.handle_outcome(hs),
                        C.fleet_counters(p))

        out = C.both(POOL, scenario)
        assert out[1]["fleet.handoff_faults"] == 1
        assert out[1]["fleet.handoff_fallbacks"] == 1


# ---------------------------------------------------------------------------
# every scenario of tests/test_serving_disagg.py, on the port
# ---------------------------------------------------------------------------

class TestTiers:
    def test_roles_and_tiers_surface(self):
        with disagg(num_prefill=2, num_decode=1, num_mixed=1) as r:
            s = r.fleet_summary()
            assert len(s["tiers"]["prefill"]) == 2
            assert len(s["tiers"]["decode"]) == 1
            assert len(s["tiers"]["mixed"]) == 1
            assert sorted(s["roles"].values()) == [
                "decode", "mixed", "prefill", "prefill"]

    def test_config_validation(self):
        with pytest.raises(ValueError):
            DisaggRouter(make_engine, num_prefill=0, num_decode=0,
                         num_mixed=0)
        with pytest.raises(ValueError):
            DisaggRouter(make_engine, roles=["mixed"])
        with pytest.raises(ValueError):
            FleetRouter(make_engine, num_replicas=2,
                        roles=["prefill", "typo"])
        with pytest.raises(ValueError):
            FleetRouter(make_engine, num_replicas=2, roles=["prefill"])
        assert issubclass(HandoffError, RuntimeError)

    def test_fresh_prompts_land_on_prefill_tier(self):
        with disagg() as r:
            tier = set(r.fleet_summary()["tiers"]["prefill"])
            hs = [r.submit(p, max_new_tokens=4) for p in prompts(6)]
            assert all(h.replica_id in tier for h in hs)
            assert all(r.handoff_state(h) is HandoffState.PREFILLING
                       for h in hs)
            r.run_until_idle()

    def test_mixed_only_disagg_is_the_colocated_fleet(self):
        ps = prompts(5)
        ref = reference_tokens(ps)
        with disagg(num_prefill=0, num_decode=0, num_mixed=2) as r:
            hs = [r.submit(p, max_new_tokens=6) for p in ps]
            r.run_until_idle()
            assert [h.tokens for h in hs] == ref
            assert monitor.get("fleet.handoffs") == 0


class TestHandoff:
    def test_handoff_metrics_and_bytes(self):
        with disagg(num_prefill=1, num_decode=1) as r:
            hs = [r.submit(p, max_new_tokens=4) for p in prompts(4)]
            r.run_until_idle()
            assert all(h.finished for h in hs)
            assert monitor.get("serving.handoff.count") \
                == monitor.get("fleet.handoffs") == 4
            assert monitor.get("serving.handoff.bytes") > 0
            assert monitor.get("serving.handoff.wall_ms") >= 0.0
            snap = monitor.snapshot("serving.handoff.")
            assert snap["serving.handoff.latency_seconds_count"] == 4
            assert all(h.num_relocations == 0 for h in hs)

    def test_second_burst_takes_the_first_bursts_steps(self):
        ps = prompts(6, seed=7)
        with disagg() as r:
            steps = []
            for _ in range(2):
                before = [monitor.get(f"serving.{c}") for c in
                          ("decode_steps", "prefill_tokens", "prefills")]
                hs = [r.submit(p, max_new_tokens=5) for p in ps]
                r.run_until_idle()
                assert all(h.finished for h in hs)
                steps.append([monitor.get(f"serving.{c}") - b0 for c, b0 in
                              zip(("decode_steps", "prefill_tokens",
                                   "prefills"), before)])
            assert steps[0] == steps[1] and min(steps[0]) > 0
            assert monitor.get("fleet.handoffs") == 2 * len(ps)

    def test_single_token_requests_finish_without_handoff_harm(self):
        ps = prompts(4, seed=2)
        ref = reference_tokens(ps, max_new=1)
        with disagg() as r:
            hs = [r.submit(p, max_new_tokens=1) for p in ps]
            r.run_until_idle()
            assert all(h.status is RequestStatus.FINISHED for h in hs)
            assert [h.tokens for h in hs] == ref

    def test_spec_decode_parity_on_handed_off_sessions(self):
        ps = prompts(6, seed=5)
        ref = reference_tokens(ps, max_new=8)
        with disagg(frontend_kwargs=dict(
                spec=SpecDecodeConfig(NGramProposer(),
                                      num_draft_tokens=3))) as r:
            hs = [r.submit(p, max_new_tokens=8) for p in ps]
            r.run_until_idle()
            assert all(h.status is RequestStatus.FINISHED for h in hs)
            assert [h.tokens for h in hs] == ref
            assert monitor.get("fleet.handoffs") >= 1


class TestChaosEdges:
    def test_extraction_fault_relocation_budget_and_leaks(self):
        faults.inject("fleet.handoff", after_n=1, times=1, action="raise")
        with disagg() as r:
            hs = [r.submit(p, max_new_tokens=6) for p in prompts(5, seed=11)]
            r.run_until_idle()
            assert all(h.status is RequestStatus.FINISHED for h in hs)
            assert sum(h.num_relocations for h in hs) == 1
            for rep in r.replicas:
                assert rep.scheduler.kv_leaked_blocks() == 0

    def test_prefill_worker_killed_mid_handoff(self):
        ps = prompts(8, seed=13)
        ref = {tuple(p): t for p, t in zip(ps, reference_tokens(ps))}
        faults.inject("fleet.handoff", after_n=2, times=1, action="flag")
        with disagg() as r:
            hs = [r.submit(p, max_new_tokens=6) for p in ps]
            r.run_until_idle()
            assert all(h.status.terminal for h in hs)
            dead = [rep for rep in r.replicas if not rep.alive]
            assert len(dead) == 1
            assert dead[0].role == "prefill"
            assert dead[0].death_reason == "handoff_chaos_kill"
            for p, h in zip(ps, hs):
                if h.status is RequestStatus.FINISHED:
                    assert h.tokens == ref[tuple(p)]
            assert sum(1 for h in hs
                       if h.status is RequestStatus.FINISHED) >= len(ps) - 1
            for rep in r.replicas:
                if rep.alive:
                    assert rep.scheduler.kv_leaked_blocks() == 0

    def test_budget_zero_fault_terminalizes_typed(self):
        faults.inject("fleet.handoff", after_n=0, times=None, action="raise")
        with disagg(num_prefill=1, num_decode=1, relocation_budget=0) as r:
            h = r.submit(prompts(1)[0], max_new_tokens=6)
            r.run_until_idle()
            assert h.status is RequestStatus.FAILED
            assert h.finish_reason == "relocation_budget_exhausted"
            for rep in r.replicas:
                assert rep.scheduler.kv_leaked_blocks() == 0


class TestRelocationShipsKV:
    def _run_until_decoding(self, r, h, min_tokens=2):
        for _ in range(200):
            if len(h._req.generated) >= min_tokens:
                return
            r.step()
        raise AssertionError("request never reached decode")

    def test_kill_folds_and_reprefills_bitwise(self):
        ps = prompts(1, seed=22, lo=6, hi=10)
        ref = reference_tokens(ps, max_new=12)
        with FleetRouter(make_engine, num_replicas=2) as r:
            h = r.submit(ps[0], max_new_tokens=12)
            self._run_until_decoding(r, h)
            r.fail_replica(h.replica_id, reason="test_kill")
            r.run_until_idle()
            assert h.status is RequestStatus.FINISHED
            assert h.tokens == ref[0]
            assert monitor.get("fleet.relocations_shipped") == 0
            assert monitor.get("fleet.shipped_kv_bytes") == 0


class TestResidentKVLifecycle:
    def _minted(self):
        fe1 = ServingFrontend(make_engine(), stall_after=256)
        h = fe1.submit(prompts(1, seed=31, lo=5, hi=8)[0],
                       max_new_tokens=10)
        req = h._req
        while len(req.generated) < 2:
            fe1.step()
        payload = fe1.scheduler.engine.extract_kv_blocks(req.seq_id)
        fe1.release(h)
        return req, payload

    def test_release_while_waiting_frees_blocks(self):
        req, payload = self._minted()
        fe2 = ServingFrontend(make_engine(), stall_after=256)
        free0 = fe2.scheduler.engine.manager.free_blocks
        fe2.import_session(req, payload)
        assert fe2.scheduler.engine.manager.free_blocks < free0
        assert fe2.release(req)
        assert fe2.scheduler.engine.manager.free_blocks == free0
        assert fe2.scheduler.kv_leaked_blocks() == 0
        fe2.scheduler.engine.manager.check_consistency()

    def test_imported_session_runs_to_finish_leak_free(self):
        req, payload = self._minted()
        fe2 = ServingFrontend(make_engine(), stall_after=256)
        free0 = fe2.scheduler.engine.manager.free_blocks
        fe2.import_session(req, payload)
        fe2.run_until_idle()
        assert req.status is RequestStatus.FINISHED
        assert fe2.scheduler.engine.manager.free_blocks == free0
        assert fe2.scheduler.kv_leaked_blocks() == 0


class TestCrossReplicaPrefixStream:
    PROMPT = list(range(1, 13))     # 3 full blocks on the bs=4 engine

    def _router(self, n=2, **kw):
        kw.setdefault("frontend_kwargs", dict(prefix_cache=True))
        return FleetRouter(make_engine, n, **kw)

    def test_first_miss_streams_and_matches_bitwise(self):
        with self._router() as r:
            h1 = r.submit(self.PROMPT, max_new_tokens=6)
            r.run_until_idle()
            assert h1._replica.replica_id == "replica-0"
            busy = r.submit(list(range(20, 28)), max_new_tokens=40)
            h2 = r.submit(self.PROMPT, max_new_tokens=6)
            assert h2._replica.replica_id == "replica-1"
            r.run_until_idle()
            assert busy.status is RequestStatus.FINISHED
            assert h2.status is RequestStatus.FINISHED
            assert h2.tokens == h1.tokens
            assert monitor.get("fleet.prefix_streams") == 1
            assert monitor.get("fleet.prefix_stream_tokens") == 12
            assert monitor.get("fleet.prefix_stream_bytes") > 0
            assert monitor.get("fleet.prefix_stream_failures") == 0
            h3 = r.submit(self.PROMPT, max_new_tokens=6)
            r.run_until_idle()
            assert h3.tokens == h1.tokens
            assert monitor.get("fleet.prefix_streams") == 1
            for rep in r.replicas:
                sch = rep.frontend.scheduler
                assert sch.kv_leaked_blocks() == 0
                sch.engine.manager.check_consistency(
                    external=sch.prefix_cache.block_ref_counts())

    def test_stream_failure_falls_back_to_cold_prefill(self):
        [ref] = reference_tokens([self.PROMPT])
        with self._router(n=1) as r:
            # the only peer is geometry-mismatched: its bs=4 exports
            # cannot inject into the bs=8 joiner
            r.add_replica(lambda: MLPLMEngine(
                vocab_size=C.VOCAB, hidden=16, max_batch_size=4,
                num_blocks=48, block_size=8, max_blocks_per_seq=8,
                seed=0, device="cpu"))
            h1 = r.submit(self.PROMPT, max_new_tokens=6)
            r.run_until_idle()
            assert h1._replica.replica_id == "replica-0"
            r.submit(list(range(20, 28)), max_new_tokens=40)
            h2 = r.submit(self.PROMPT, max_new_tokens=6)
            assert h2._replica.replica_id == "replica-1"
            r.run_until_idle()
            assert monitor.get("fleet.prefix_stream_failures") == 1
            assert monitor.get("fleet.prefix_streams") == 0
            assert h2.status is RequestStatus.FINISHED
            assert h2.tokens == ref == h1.tokens

    def test_parallel_and_opt_out_leave_hook_unset(self):
        with self._router(parallel=True) as r:
            assert all(rep.frontend.scheduler.prefix_stream_hook is None
                       for rep in r.replicas)
        with self._router(prefix_streaming=False) as r:
            assert all(rep.frontend.scheduler.prefix_stream_hook is None
                       for rep in r.replicas)
        with FleetRouter(make_engine, 2) as r:
            assert all(rep.frontend.scheduler.prefix_stream_hook is None
                       for rep in r.replicas)
            h = r.submit(self.PROMPT, max_new_tokens=4)
            r.run_until_idle()
            assert h.status is RequestStatus.FINISHED

    def test_disagg_prefill_tier_streams_prefixes(self):
        with disagg(frontend_kwargs=dict(prefix_cache=True)) as r:
            h1 = r.submit(self.PROMPT, max_new_tokens=6)
            prefill_1 = h1._replica
            r.run_until_idle()
            r.submit(list(range(20, 28)), max_new_tokens=40)
            h2 = r.submit(self.PROMPT, max_new_tokens=6)
            assert h2._replica is not prefill_1
            r.run_until_idle()
            assert h2.status is RequestStatus.FINISHED
            assert h2.tokens == h1.tokens
            assert monitor.get("fleet.prefix_streams") >= 1
            assert monitor.get("fleet.prefix_stream_failures") == 0
