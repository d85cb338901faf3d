"""Multi-LoRA serving on both packages: the scenarios of
`tests/test_lora_serving.py` (but the profiler's summary line, whose
profiler is not ported) run on the port (`device="cpu"`) holding the JAX suite's own
assertions, and, where an outcome is more than those pinned values, on
the JAX package too, with the outcomes compared:
`lora_mm` within f32 rounding; the adapter pool's integer state (slots,
LRU order, hits, misses, evictions, leases), `random_adapter`'s arrays
and the uploaded pool tensors exactly; greedy token streams, statuses and
finish reasons exactly over `MLPLMEngine` and a tiny Llama (bf16 factors
over f32, int8 and int4 bases, int8 KV); ragged and verify logits of a
mixed lane -> slot vector within the tolerance `test_torch_llama_engine`
uses (1e-4)."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.inference import LlamaInferenceEngine as JaxLlamaEngine
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.resilience import faults as jfaults
from paddle_tpu.serving import lora as jlora
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import LlamaConfig, LlamaInferenceEngine, from_jax_state
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.resilience import faults as tfaults
from paddle_tpu_torch.serving import lora as tlora
from paddle_tpu_torch.serving.quant import greedy_agreement, quantize_engine
from torch_threads import one_thread  # noqa: F401

ATOL = RTOL = 1e-4   # f32 logits after two layers of matmuls


def _pkg(name, serving, lora, monitor, faults, **engine_kw):
    def engine(**kw):
        return serving.MLPLMEngine(**{**engine_kw, **kw})

    return SimpleNamespace(name=name, s=serving, lora=lora, monitor=monitor,
                           faults=faults, engine=engine)


JAX = _pkg("jax", jserving, jlora, jmonitor, jfaults)
PORT = _pkg("port", tserving, tlora, tmonitor, tfaults, device="cpu")
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _fresh_state():
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
        p.faults.clear()
    yield
    for p in PKGS:
        p.faults.clear()


def both(scenario, *args):
    """`scenario(pkg, *args)` on each package (counters and fault
    registries fresh for each); the outcomes must be equal. Returns the
    JAX package's."""
    out = {}
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
        p.faults.clear()
        out[p.name] = scenario(p, *args)
        p.faults.clear()
    assert out["port"] == out["jax"]
    return out["jax"]


def _prompts(n=6, vocab=256, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(3, 14))).tolist()
            for _ in range(n)]


def _finish_all(fe, prompts, adapters=None, max_new=6):
    adapters = adapters or [None] * len(prompts)
    hs = [fe.submit(pr, max_new_tokens=max_new, adapter=a)
          for pr, a in zip(prompts, adapters)]
    fe.run_until_idle(max_steps=2000)
    assert all(h.status.value == "finished" for h in hs), \
        [(h.status, h.finish_reason) for h in hs]
    return hs


def _mlp_lora(p, seed=3, pool_slots=4, buckets=(2, 4, 8), **kw):
    return p.s.attach_adapters(p.engine(seed=seed, **kw),
                               pool_slots=pool_slots, rank_buckets=buckets)


def _pool_state(pool):
    """The pool's integer state: stats, slot map, free list, refs, pins
    and LRU order."""
    order = sorted(pool._last_used, key=pool._last_used.get)
    return (pool.stats(), dict(pool._slot_of), list(pool._free),
            dict(pool._refs), sorted(pool._pinned), order)


def _streams(hs):
    return [(h.tokens, h.status.value, h.finish_reason) for h in hs]


# ---------------------------------------------------------------------------
# the epilogue
# ---------------------------------------------------------------------------

def _epilogue(x, w, la, lb, ids):
    """The port's epilogue as the engine's step runs it: the factors of
    every token gathered from the pools (`_swap_lora`), then `lora_mm`."""
    swapped = tlora._swap_lora({"t": w}, {"t": {"a": la, "b": lb}}, ids,
                               None)
    return tlora.lora_mm(x, swapped["t"], lambda a, b: a @ b)


class TestLoraMM:
    @pytest.mark.parametrize("lead", [(), (2,)])
    def test_matches_jax(self, lead):
        rng = np.random.default_rng(0)
        S, K, R, N, T = 3, 8, 4, 6, 5
        x = rng.normal(0, 1, lead + (T, K)).astype(np.float32)
        w = rng.normal(0, 1, (K, N)).astype(np.float32)
        la = rng.normal(0, 1, (S, K, R)).astype(np.float32)
        lb = rng.normal(0, 1, (S, R, N)).astype(np.float32)
        ids = np.array([0, 2, 1, 2, 0], np.int32)
        want = np.asarray(jlora.lora_mm(
            jnp.asarray(x), {"w": jnp.asarray(w), "la": jnp.asarray(la),
                             "lb": jnp.asarray(lb), "ids": jnp.asarray(ids)},
            lambda a, b: a @ b))
        got = _epilogue(torch.from_numpy(x), torch.from_numpy(w),
                        torch.from_numpy(la), torch.from_numpy(lb),
                        torch.from_numpy(ids))
        np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=1e-5)
        ref = x @ w + np.stack([x[..., t, :] @ la[ids[t]] @ lb[ids[t]]
                                for t in range(T)], axis=-2)
        np.testing.assert_allclose(got.numpy(), ref, rtol=1e-5, atol=1e-5)

    @pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
    def test_zero_slot_adds_an_exact_zero(self, dtype):
        g = torch.Generator().manual_seed(1)
        x = torch.randn(4, 8, generator=g).to(dtype)
        w = torch.randn(8, 6, generator=g).to(dtype)
        lb = torch.randn(2, 4, 6, generator=g)        # B alone is inert
        out = _epilogue(x, w, torch.zeros(2, 8, 4), lb,
                        torch.ones(4, dtype=torch.long))
        assert torch.equal(out, x @ w)

    def test_a_tokens_bits_ignore_neighbours_and_pool_size(self):
        """The same token through pools of 2 and 40 slots, beside other
        tokens or alone, gives the same bits (every shape is fixed by
        the packed buffer and Rmax)."""
        g = torch.Generator().manual_seed(2)
        T, K, R, N = 40, 64, 8, 48
        x = torch.randn(T, K, generator=g).to(torch.bfloat16)
        w = torch.randn(K, N, generator=g).to(torch.bfloat16)
        fa, fb = torch.randn(K, R, generator=g), torch.randn(R, N,
                                                            generator=g)

        def run(slots, xs, slot):
            la = torch.randn(slots + 1, K, R, generator=g)
            lb = torch.randn(slots + 1, R, N, generator=g)
            la[slot], lb[slot] = fa, fb
            ids = torch.randint(0, slots, (T,), generator=g)
            ids[7] = slot
            return _epilogue(xs, w, la, lb, ids)[7]

        alone = torch.zeros_like(x)
        alone[7] = x[7]
        a = run(40, x, 23)
        assert torch.equal(a, run(2, x, 1))
        assert torch.equal(a, run(2, alone, 0))


# ---------------------------------------------------------------------------
# the paged adapter pool
# ---------------------------------------------------------------------------

def _errors(calls):
    """Run each call; record its result or its exception's type name."""
    out = []
    for call in calls:
        try:
            out.append(("ok", call()))
        except Exception as e:   # noqa: BLE001 - the type is the outcome
            out.append(("raised", type(e).__name__))
    return out


class TestAdapterPool:
    def test_random_adapter_equals_jax(self):
        for rank, seed, kw in ((4, 0, {}), (3, 7, {"scale": 0.2})):
            want = jlora.random_adapter(_mlp_lora(JAX), rank=rank, seed=seed,
                                        **kw)
            got = tlora.random_adapter(_mlp_lora(PORT), rank=rank, seed=seed,
                                       **kw)
            assert sorted(got) == sorted(want)
            for k in want:
                for a, b in zip(got[k], want[k]):
                    assert a.dtype == np.float32 and np.array_equal(a, b)

    def test_register_validation(self):
        def scenario(p):
            eng = _mlp_lora(p)
            pool = eng.adapter_pool
            good = p.lora.random_adapter(eng, rank=4, seed=0)
            mixed = dict(p.lora.random_adapter(eng, rank=4, seed=2))
            k0 = sorted(mixed)[0]
            mixed[k0] = p.lora.random_adapter(eng, rank=2, seed=2)[k0]
            out = _errors([
                lambda: pool.register("a", good),
                lambda: pool.register("a", good),
                lambda: pool.register(
                    "a", p.lora.random_adapter(eng, rank=2, seed=1),
                    allow_update=True),
                lambda: pool.rank_of("a"),
                lambda: pool.register("bad", {"w1": good["w1"]}),
                lambda: pool.register("mixed", mixed),
                lambda: pool.register(
                    "fat", p.lora.random_adapter(eng, rank=16, seed=3)),
                lambda: pool.register("shape", {
                    k: (np.zeros((3, 4), np.float32),
                        np.zeros((4, 5), np.float32))
                    for k in eng._lora_targets}),
                lambda: pool.register("r3", p.lora.random_adapter(
                    eng, rank=3, seed=0))])
            a, b = pool._registry["r3"]["w1"]
            assert a.shape[-1] == pool.rank_max == 8 and b.shape[-2] == 8
            assert not a[..., 3:].any() and not b[..., 3:, :].any()
            return out, pool.rank_of("r3"), _pool_state(pool)

        out, rank, _state = both(scenario)
        assert [o[1] for o in out] == [
            4, "AdapterError", 2, 2, "AdapterError", "AdapterRankError",
            "AdapterRankError", "AdapterError", 4]
        assert rank == 3

    def test_lease_refcount_lru_and_pool_tensors(self):
        def scenario(p):
            eng = _mlp_lora(p, pool_slots=2)
            pool = eng.adapter_pool
            for i in range(3):
                pool.register(f"ad{i}",
                              p.lora.random_adapter(eng, rank=2, seed=i))
            trace = _errors([
                lambda: pool.lease("ad0"), lambda: pool.lease("ad0"),
                lambda: pool.lease("ad1"), lambda: pool.release("ad1"),
                lambda: pool.is_resident("ad1"),
                lambda: pool.lease("ad2"),         # evicts LRU idle ad1
                lambda: pool.is_resident("ad1"),
                lambda: pool.lease("ad1"),         # ad0 + ad2 leased
                lambda: pool.release("ad0"), lambda: pool.release("ad0"),
                lambda: pool.release("ad0")])
            pool.check_consistency()
            tensors = {k: tuple(np.asarray(t).tobytes() for t in
                                (pl["a"], pl["b"]))
                       for k, pl in eng._pools.items()}
            return trace, _pool_state(pool), tensors

        trace, (stats, slots, *_), _tensors = both(scenario)
        assert [t[1] for t in trace] == [
            1, 1, 0, None, True, 0, False, "AdapterPoolExhausted", None,
            None, "AdapterError"]
        assert (stats["hits"], stats["misses"], stats["evictions"]) == (1, 3, 1)

    def test_pin_survives_pressure_and_deregister_refusals(self):
        def scenario(p):
            eng = _mlp_lora(p, pool_slots=2)
            pool = eng.adapter_pool
            for i in range(3):
                pool.register(f"ad{i}",
                              p.lora.random_adapter(eng, rank=2, seed=i))
            trace = _errors([
                lambda: pool.pin("ad0"), lambda: pool.leases(),
                lambda: pool.lease("ad1"), lambda: pool.release("ad1"),
                lambda: pool.lease("ad2"), lambda: pool.is_resident("ad0"),
                lambda: pool.deregister("ad0"),
                lambda: pool.deregister("ad2"), lambda: pool.unpin("ad0"),
                lambda: pool.deregister("ad0"),
                lambda: pool.is_registered("ad0"),
                lambda: pool.lease("ad0")])
            pool.check_consistency()
            return trace, _pool_state(pool)

        trace, _ = both(scenario)
        assert [t[1] for t in trace][5:] == [
            True, "AdapterError", "AdapterError", None, None, False,
            "UnknownAdapterError"]

    def test_zero_slot_and_failed_upload(self):
        def scenario(p):
            eng = _mlp_lora(p, pool_slots=2)
            pool = eng.adapter_pool
            for i in range(2):
                pool.register(f"ad{i}",
                              p.lora.random_adapter(eng, rank=2, seed=i))
            slots = [pool.lease("ad0")]
            assert eng.zero_slot == pool.pool_slots
            orig = eng._upload_slot
            eng._upload_slot = lambda *_a: (_ for _ in ()).throw(
                RuntimeError("upload boom"))
            with pytest.raises(RuntimeError, match="upload boom"):
                pool.lease("ad1")
            eng._upload_slot = orig
            assert not pool.is_resident("ad1")
            pool.check_consistency()
            slots.append(pool.lease("ad1"))          # the slot came back
            assert all(s < pool.pool_slots for s in slots)
            pool.check_consistency()
            return slots, _pool_state(pool)

        both(scenario)

    def test_wrap_validation(self):
        def scenario(p):
            eng = _mlp_lora(p)
            plain = p.engine(seed=3)
            plain.params = {"nope": None}
            return _errors([
                lambda: p.s.attach_adapters(eng),
                lambda: p.s.attach_adapters(SimpleNamespace(tpinfo={})),
                lambda: p.s.attach_adapters(plain)])

        assert [o[1] for o in both(scenario)] == ["AdapterError"] * 3


# ---------------------------------------------------------------------------
# one engine, many tenants
# ---------------------------------------------------------------------------

class TestMultiAdapterServing:
    def test_zero_slot_parity_with_plain_engine(self):
        """Requests without an adapter through the port's LoRA engine are
        bitwise its plain engine's streams (the JAX package's LoRA streams
        with base lanes are held in the mixed-batch case)."""
        prompts = _prompts(5)
        eng = _mlp_lora(PORT, seed=3)
        eng.adapter_pool.register(
            "a", tlora.random_adapter(eng, rank=4, seed=0))
        wrapped = _streams(_finish_all(tserving.ServingFrontend(eng),
                                       prompts))
        assert wrapped == _streams(_finish_all(
            tserving.ServingFrontend(PORT.engine(seed=3)), prompts))

    def test_mixed_batch_matches_dedicated_engines(self):
        prompts = _prompts(6, seed=5)
        adapters = [None, "ad0", "ad1", "ad0", None, "ad1"]

        def scenario(p):
            shared = _mlp_lora(p, seed=3)
            for i in range(2):
                shared.adapter_pool.register(f"ad{i}", p.lora.random_adapter(
                    shared, rank=4, seed=i, scale=0.2))
            mixed = _finish_all(p.s.ServingFrontend(shared), prompts,
                                adapters)
            for name, seed in (("ad0", 0), ("ad1", 1)) if p is PORT else ():
                ded = _mlp_lora(p, seed=3, pool_slots=2)
                ded.adapter_pool.register(name, p.lora.random_adapter(
                    ded, rank=4, seed=seed, scale=0.2))
                idx = [i for i, a in enumerate(adapters) if a == name]
                want = [h.tokens for h in _finish_all(
                    p.s.ServingFrontend(ded), [prompts[i] for i in idx],
                    [name] * len(idx))]
                assert [mixed[i].tokens for i in idx] == want, name
            assert shared.adapter_pool.leases() == 0
            shared.adapter_pool.check_consistency()
            return _streams(mixed), _pool_state(shared.adapter_pool)

        both(scenario)

    def test_adapter_switches_serve_on(self):
        """Any adapter mix (including adapters first seen after the
        warm-up) serves through the same engine: streams, books."""
        def scenario(p):
            eng = _mlp_lora(p, seed=3, pool_slots=3)
            for i in range(4):
                eng.adapter_pool.register(f"ad{i}", p.lora.random_adapter(
                    eng, rank=2 + 2 * (i % 2), seed=i))
            fe = p.s.ServingFrontend(eng)
            out = _streams(_finish_all(fe, _prompts(3), ["ad0", None,
                                                         "ad1"]))
            out += _streams(_finish_all(
                fe, _prompts(6, seed=9),
                ["ad2", "ad3", "ad0", None, "ad3", "ad1"]))
            assert fe.scheduler.kv_leaked_blocks() == 0
            eng.manager.check_consistency()
            return out, _pool_state(eng.adapter_pool)

        both(scenario)

    def test_adapter_changes_logits(self):
        """`use_adapter` points every lane at one adapter: its logits move
        away from the base's (the JAX suite's bound, on the port), and
        agree with the JAX package's on a prompt."""
        prompt = _prompts(1)[0]
        rows = {}
        for p in PKGS:
            eng = _mlp_lora(p, seed=3)
            eng.adapter_pool.register("a", p.lora.random_adapter(
                eng, rank=8, seed=0, scale=0.5))
            eng.use_adapter("a")
            eng.manager.allocate(0, len(prompt))
            n = np.asarray([len(prompt)], np.int32)
            rows[p.name] = np.asarray(eng.ragged_step(
                prompt, n, n, eng.manager.block_table_array([0])))
            eng.manager.free(0)
            if p is PORT:
                r = greedy_agreement(eng, p.engine(seed=3), _prompts(3))
                assert r["max_logit_err"] > 1e-3
            eng.use_adapter(None)
            assert eng.adapter_pool.leases() == 0
        np.testing.assert_allclose(rows["port"], rows["jax"], atol=ATOL,
                                   rtol=RTOL)

    def test_spec_plain_parity_with_adapters(self):
        rng = np.random.default_rng(0)
        prompts = []
        for _ in range(5):
            phrase = rng.integers(1, 256, int(rng.integers(2, 4))).tolist()
            prompts.append((phrase * 5)[:int(rng.integers(6, 13))])
        adapters = ["ad0", None, "ad1", "ad0", "ad1"]

        def run(p, spec):
            eng = _mlp_lora(p, seed=3)
            for i in range(2):
                eng.adapter_pool.register(f"ad{i}", p.lora.random_adapter(
                    eng, rank=4, seed=i, scale=0.2))
            fe = p.s.ServingFrontend(
                eng, spec=p.s.SpecDecodeConfig(p.s.NGramProposer(), 3)
                if spec else None)
            return _streams(_finish_all(fe, prompts, adapters))

        def scenario(p):
            out = run(p, False)
            if p is PORT:       # the JAX suite holds its own package
                assert run(p, True) == out
            return out

        both(scenario)

    @pytest.mark.parametrize("wbits,kv_bits", [(8, 8), (4, 16)])
    def test_quantized_base_serving_end_to_end(self, wbits, kv_bits):
        """Adapters over an int8 base with int8 KV and over an int4 base,
        on the port (the JAX suite's int8 case): finishes, drains, no
        leak, the pool's books clean."""
        eng = tserving.attach_adapters(
            quantize_engine(PORT.engine(seed=3, kv_bits=kv_bits),
                            wbits=wbits),
            pool_slots=3, rank_buckets=(2, 4))
        for i in range(3):
            eng.adapter_pool.register(
                f"ad{i}", tlora.random_adapter(eng, rank=2, seed=i))
        fe = tserving.ServingFrontend(eng)
        _finish_all(fe, _prompts(5), ["ad0", "ad1", None, "ad2", "ad0"])
        assert fe.scheduler.kv_leaked_blocks() == 0
        assert eng.adapter_pool.leases() == 0
        eng.adapter_pool.check_consistency()
        assert eng.quant_info()["wbits"] == wbits

    def test_submit_rejections_and_legacy_entries(self):
        def scenario(p):
            eng = _mlp_lora(p, seed=3)
            eng.adapter_pool.register(
                "a", p.lora.random_adapter(eng, rank=2, seed=0))
            h = p.s.ServingFrontend(eng).submit([1, 2, 3], adapter="nope")
            h2 = p.s.ServingFrontend(p.engine(seed=3)).submit(
                [1, 2, 3], adapter="a")
            for entry in ("prefill", "decode_step", "generate"):
                with pytest.raises(RuntimeError, match="ragged_step"):
                    getattr(eng, entry)()
            return [(x.status.value, x.finish_reason) for x in (h, h2)]

        assert both(scenario) == [("rejected", "unknown_adapter"),
                                  ("rejected", "no_adapter_pool")]

    def test_respawn_carries_registry_and_pins(self):
        def scenario(p):
            eng = _mlp_lora(p, seed=3, pool_slots=2)
            for i in range(2):
                eng.adapter_pool.register(
                    f"ad{i}", p.lora.random_adapter(eng, rank=2, seed=i))
            eng.adapter_pool.pin("ad0")
            eng.adapter_pool.lease("ad1")
            fresh = eng.respawn()
            pool = fresh.adapter_pool
            assert pool.is_registered("ad0") and pool.is_registered("ad1")
            assert pool.is_resident("ad0") and not pool.is_resident("ad1")
            assert pool.leases() == 0
            pool.check_consistency()
            return _pool_state(pool)

        both(scenario)

    def test_adapter_fault_isolates_the_request(self):
        """An armed `serve.adapter` fault fails the admitting miss as
        `engine_fault:adapter` before the pool is touched; resident
        adapters and base lanes serve on, the books stay clean."""
        def scenario(p):
            eng = _mlp_lora(p, seed=3, pool_slots=3)
            pool = eng.adapter_pool
            for i in range(2):
                pool.register(f"ad{i}",
                              p.lora.random_adapter(eng, rank=2, seed=i))
            pool.lease("ad0")
            pool.release("ad0")                     # resident
            fe = p.s.ServingFrontend(eng)
            p.faults.inject("serve.adapter", times=1)
            hs = [fe.submit(pr, max_new_tokens=4, adapter=a)
                  for pr, a in zip(_prompts(3), ["ad1", "ad0", None])]
            fe.run_until_idle(max_steps=2000)
            pool.check_consistency()
            assert pool.leases() == 0 and not pool.is_resident("ad1")
            assert fe.scheduler.kv_leaked_blocks() == 0
            return _streams(hs), _pool_state(pool), p.monitor.get(
                "serving.isolated_faults.adapter")

        streams, _state, isolated = both(scenario)
        assert [s[1:] for s in streams] == [
            ("failed", "engine_fault:adapter"), ("finished",
                                                  "max_new_tokens"),
            ("finished", "max_new_tokens")]
        assert isolated == 1


# ---------------------------------------------------------------------------
# priced admission
# ---------------------------------------------------------------------------

class TestAdmissionPricing:
    def test_miss_budget_limits_loads_per_step(self):
        def scenario(p):
            eng = _mlp_lora(p, seed=3, pool_slots=4)
            for i in range(3):
                eng.adapter_pool.register(
                    f"ad{i}", p.lora.random_adapter(eng, rank=2, seed=i))
            fe = p.s.ServingFrontend(eng)
            assert fe.scheduler.adapter_miss_loads_per_step == 1
            hs = [fe.submit(pr, max_new_tokens=4, adapter=f"ad{i}")
                  for i, pr in enumerate(_prompts(3))]
            fe.step()
            first = (p.monitor.get("serving.lora.miss_loads"),
                     sum(r is not None for r in fe.scheduler.slots))
            fe.run_until_idle(max_steps=2000)
            assert eng.adapter_pool.leases() == 0
            return first, p.monitor.get("serving.lora.miss_loads"), \
                _streams(hs)

        first, loads, streams = both(scenario)
        assert first == (1, 1) and loads == 3
        assert all(s[1] == "finished" for s in streams)

    def test_resident_adapters_admit_unbudgeted(self):
        def scenario(p):
            eng = _mlp_lora(p, seed=3, pool_slots=4)
            pool = eng.adapter_pool
            for i in range(3):
                pool.register(f"ad{i}",
                              p.lora.random_adapter(eng, rank=2, seed=i))
                pool.lease(f"ad{i}")
                pool.release(f"ad{i}")
            loads = p.monitor.get("serving.lora.miss_loads")
            fe = p.s.ServingFrontend(eng)
            for i, pr in enumerate(_prompts(3)):
                fe.submit(pr, max_new_tokens=4, adapter=f"ad{i}")
            fe.step()
            return (sum(r is not None for r in fe.scheduler.slots),
                    p.monitor.get("serving.lora.miss_loads") - loads)

        assert both(scenario) == (3, 0)

    def test_pool_pressure_reaches_terminal_states(self):
        def scenario(p):
            eng = _mlp_lora(p, seed=3, pool_slots=1, buckets=(2,))
            for i in range(3):
                eng.adapter_pool.register(
                    f"ad{i}", p.lora.random_adapter(eng, rank=2, seed=i))
            fe = p.s.ServingFrontend(eng)
            hs = _finish_all(fe, _prompts(6, seed=2),
                             [f"ad{i % 3}" for i in range(6)], max_new=4)
            assert eng.adapter_pool.leases() == 0
            assert p.monitor.get("serving.lora.evictions") > 0
            assert fe.scheduler.kv_leaked_blocks() == 0
            eng.adapter_pool.check_consistency()
            return _streams(hs), _pool_state(eng.adapter_pool)

        both(scenario)


# ---------------------------------------------------------------------------
# tenant = adapter, and the metrics surface
# ---------------------------------------------------------------------------

class TestTenancyAndTelemetry:
    """The JAX suite's assertions on the port (the values they pin are
    the JAX package's)."""

    def test_frontend_maps_adapter_to_tenant(self):
        eng = _mlp_lora(PORT, seed=3)
        for i in range(2):
            eng.adapter_pool.register(
                f"ad{i}", tlora.random_adapter(eng, rank=2, seed=i))
        fe = tserving.ServingFrontend(
            eng, slo=tserving.slo_for_adapters(["ad0", "ad1"]))
        hs = _finish_all(fe, _prompts(2), ["ad0", "ad1"], max_new=4)
        assert [h._req.tenant for h in hs] == ["ad0", "ad1"]
        assert tmonitor.get("serving.tenant.ad0.admitted") >= 1

    def test_bind_time_gauges_and_per_adapter_ttft(self):
        eng = _mlp_lora(PORT, seed=3, pool_slots=5, buckets=(2, 4))
        eng.adapter_pool.register(
            "a", tlora.random_adapter(eng, rank=2, seed=0))
        fe = tserving.ServingFrontend(eng)
        assert [tmonitor.get(f"serving.lora.{g}") for g in (
            "pool_slots", "registered_adapters", "rank_max")] == [5, 1, 4]
        _finish_all(fe, _prompts(2), ["a", None], max_new=4)
        snap = tmonitor.snapshot("serving.lora.ttft_seconds.")
        assert snap["serving.lora.ttft_seconds.a_count"] == 1
        # a reset zeroes (and keeps) the histograms earlier tests observed
        assert sorted(k for k, v in snap.items() if k.endswith("_count")
                      and v) == ["serving.lora.ttft_seconds.a_count"]

    def test_fleet_adapter_affinity(self):
        def scenario(p):
            def factory():
                eng = _mlp_lora(p, seed=3, pool_slots=2, buckets=(2,),
                                num_blocks=64)
                eng.adapter_pool.register(
                    "hot", p.lora.random_adapter(eng, rank=2, seed=0))
                return eng

            r = p.s.FleetRouter(factory, num_replicas=2)
            try:
                reps = r.live_replicas
                # warm the adapter onto replica 1 only
                pool1 = reps[1].frontend.scheduler.engine.adapter_pool
                pool1.lease("hot")
                pool1.release("hot")
                loads = [rep.load()["resident_adapters"] for rep in reps]
                assert loads == [[], ["hot"]]
                targets = r._targets(None, set(), adapter="hot")
                assert targets[0].replica_id == reps[1].replica_id
                h = r.submit(_prompts(1)[0], max_new_tokens=3,
                             adapter="hot")
                r.run_until_idle()
                assert h.status.value == "finished"
                assert h.replica_id == reps[1].replica_id
                return loads, [t.replica_id for t in targets], h.tokens
            finally:
                r.close()

        both(scenario)

    def test_timeline_carries_adapter_attribution(self):
        def scenario(p):
            from paddle_tpu import observability as jobs
            from paddle_tpu_torch import observability as tobs

            o = jobs if p is JAX else tobs
            o.enable()
            o.timeline.reset()
            try:
                eng = _mlp_lora(p, seed=3)
                eng.adapter_pool.register(
                    "a", p.lora.random_adapter(eng, rank=2, seed=0))
                fe = p.s.ServingFrontend(eng)
                hs = _finish_all(fe, _prompts(2), ["a", None], max_new=3)
                named = [[(e["name"], (e.get("meta") or {}).get("adapter"))
                          for e in h.timeline()] for h in hs]
            finally:
                o.disable()
                o.timeline.reset()
            assert any(ad == "a" for _n, ad in named[0])
            assert all(ad == "a" for _n, ad in named[0])
            assert all(ad is None for _n, ad in named[1])
            return named

        both(scenario)


# ---------------------------------------------------------------------------
# the Llama engine: logits, quantized bases, multi-adapter serving
# ---------------------------------------------------------------------------

VOCAB = 128


@pytest.fixture(scope="module")
def models():
    paddle.seed(7)
    jm = jax_llama_tiny(vocab=VOCAB, layers=2, hidden=64, heads=4, seq=256,
                        num_key_value_heads=2)
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    tm = from_jax_state(state, LlamaConfig(**dataclasses.asdict(jm.config)),
                        device="cpu")
    return jm, tm


def _llama_lora(p, models, kv_bits=16, wbits=None, seed=0, pool_slots=2):
    jm, tm = models
    geo = dict(max_batch_size=4, num_blocks=64, block_size=8,
               max_blocks_per_seq=16, kv_bits=kv_bits)
    if p is JAX:
        assert wbits is None, "quantized bases are held on the port"
        eng = JaxLlamaEngine(jm, **geo)
    else:
        eng = LlamaInferenceEngine(tm, device="cpu", **geo)
        if wbits is not None:
            quantize_engine(eng, wbits)
    eng = p.s.attach_adapters(eng, pool_slots=pool_slots, rank_buckets=(4,))
    eng.adapter_pool.register("ft", p.lora.random_adapter(
        eng, rank=4, seed=seed, scale=0.1))
    return eng


@pytest.fixture(scope="module")
def kv8_engines(models):
    """One int8-pool LoRA engine per package, shared by the two int8
    Llama cases below (the JAX package compiles its step once for them:
    both run 24-token packed steps over [4, 16] tables)."""
    return {p.name: _llama_lora(p, models, 8) for p in PKGS}


class TestLlama:
    @pytest.mark.parametrize("kv_bits", [16, 8])
    def test_ragged_and_verify_logits_with_mixed_lanes(self, request, models,
                                                       kv_bits):
        """Ragged steps (and, over the f32 pool, a verify window) with
        lanes on two adapters and the zero slot: the port's logits within
        1e-4 of the JAX package's, the lane on the zero slot equal to the
        plain engine's run of the same step. (A verify step is a ragged
        step of S-token lanes in the port, so the int8 pool's is the
        ragged case again.)"""
        rng = np.random.default_rng(4)
        tables = np.zeros((4, 16), np.int32)
        tables[0, :3] = [1, 2, 3]
        tables[1, :2] = [4, 5]
        tables[2, :2] = [6, 7]
        steps = [([9, 5, 7, 0], [9, 5, 7, 0]), ([1, 1, 1, 0], [10, 6, 8, 0])]
        toks = [rng.integers(1, VOCAB, 24).astype(np.int32) for _ in steps]
        vtok = rng.integers(1, VOCAB, (4, 3)).astype(np.int32)
        vctx = np.asarray([13, 9, 11, 3], np.int32)
        out = {}
        shared = request.getfixturevalue("kv8_engines") if kv_bits == 8 \
            else {}
        for p in PKGS:
            eng = shared.get(p.name) or _llama_lora(p, models, kv_bits)
            eng.adapter_pool.register("ft2", p.lora.random_adapter(
                eng, rank=3, seed=5, scale=0.1))
            s0, s1 = eng.adapter_pool.lease("ft"), \
                eng.adapter_pool.lease("ft2")
            eng.set_lane_adapters(np.asarray([s0, eng.zero_slot, s1,
                                              eng.zero_slot], np.int32))
            rows = [np.asarray(eng.ragged_step(t, q, kv, tables))
                    for t, (q, kv) in zip(toks, steps)]
            if kv_bits == 16:
                rows.append(np.asarray(eng.verify_step(vtok, vctx, tables)))
            out[p.name] = rows
            for name in ("ft", "ft2"):
                eng.adapter_pool.release(name)
            eng.set_lane_adapters(np.full((4,), eng.zero_slot, np.int32))
            if p is PORT:
                plain = eng.base
                for t, (q, kv), got in zip(toks, steps, rows):
                    want = plain.ragged_step(t, q, kv, tables).numpy()
                    lo = q[0]
                    np.testing.assert_array_equal(got[lo:lo + q[1]],
                                                  want[lo:lo + q[1]])
        for a, b in zip(out["port"], out["jax"]):
            np.testing.assert_allclose(a, b, atol=ATOL, rtol=RTOL)

    @pytest.mark.parametrize("wbits,min_strict,max_err",
                             [(8, 0.9, 0.5), (4, None, 2.0)])
    def test_quantized_base_agreement(self, models, wbits, min_strict,
                                      max_err):
        """The same adapter over an int8 / int4 base and int8 KV against
        the full-precision base, on the port: the JAX suite's bounds (its
        own file holds the JAX package to them)."""
        cand = _llama_lora(PORT, models, 8, wbits)
        ref = _llama_lora(PORT, models)
        cand.use_adapter("ft")
        ref.use_adapter("ft")
        r = greedy_agreement(cand, ref, _prompts(4, vocab=VOCAB, seed=2))
        assert r["agreement_tie_aware"] >= 0.99, r
        if min_strict is not None:
            assert r["agreement"] >= min_strict, r
        assert r["max_logit_err"] < max_err, r

    def test_multi_adapter_serving_streams(self, kv8_engines):
        """Two adapters and base lanes through the layers over an int8
        pool, streams equal to the JAX package's (the quantized bases are
        held by `test_quantized_base_agreement` and the MLP cases)."""
        def scenario(p):
            eng = kv8_engines[p.name]
            eng.adapter_pool.register("ft3", p.lora.random_adapter(
                eng, rank=4, seed=7, scale=0.1))
            fe = p.s.ServingFrontend(eng, prefill_chunk_tokens=20)
            out = _streams(_finish_all(fe, _prompts(2, vocab=VOCAB, seed=4),
                                       ["ft", None], max_new=4))
            out += _streams(_finish_all(fe, _prompts(3, vocab=VOCAB, seed=5),
                                        ["ft3", "ft", None], max_new=4))
            assert fe.scheduler.kv_leaked_blocks() == 0
            assert eng.adapter_pool.leases() == 0
            return out

        both(scenario)
