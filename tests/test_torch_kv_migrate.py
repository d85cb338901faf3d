"""KV-block migration on both packages: the scenarios of
`tests/test_kv_migrate.py` (but the tensor-parallel ones, which wait for
the TP slice) run on the JAX package and on the port (`device="cpu"`),
each holding the JAX suite's own assertions, with the outcomes compared:
payload headers field for field, slab shapes and dtypes, the MLP
engine's embeddings bit for bit and the Llama engine's K/V within f32
rounding,
typed errors, block-manager books, and greedy streams of a session
shipped between frontends and of a prefix streamed between schedulers,
token for token. The port's own round trips (extract -> inject ->
extract) are bitwise, and so are those of a `LoRAEngine` over its own
pools."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.inference import LlamaInferenceEngine as JaxLlamaEngine
from paddle_tpu.inference import kv_migrate as jmig
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import LlamaConfig, LlamaInferenceEngine, from_jax_state
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.inference import kv_migrate as tmig
from torch_threads import one_thread  # noqa: F401

MLP_KW = dict(vocab_size=64, hidden=16, max_batch_size=4, num_blocks=32,
              block_size=4, max_blocks_per_seq=8, seed=3)
ATOL = RTOL = 1e-5   # f32 K/V after one and two layers' projections


def _pkg(name, serving, mig, monitor, **engine_kw):
    def mlp(**over):
        return serving.MLPLMEngine(**{**MLP_KW, **engine_kw, **over})

    return SimpleNamespace(name=name, s=serving, mig=mig, monitor=monitor,
                           mlp=mlp)


JAX = _pkg("jax", jserving, jmig, jmonitor)
PORT = _pkg("port", tserving, tmig, tmonitor, device="cpu")
PKGS = (JAX, PORT)


@pytest.fixture(autouse=True)
def _clean_monitor():
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
    yield


def both(scenario, *args):
    out = {}
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
        out[p.name] = scenario(p, *args)
    assert out["port"] == out["jax"]
    return out["jax"]


def _np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def _fill(eng, seq_id=0, n=7, seed=1):
    """Write `n` tokens of real KV under `seq_id` through one ragged
    dispatch (a prompt-only lane); returns the tokens."""
    mgr = eng.manager
    blocks = mgr.allocate(seq_id, n)
    toks = np.random.default_rng(seed).integers(1, 60, n).astype(np.int32)
    q = np.zeros(4, np.int32)
    kv = np.zeros(4, np.int32)
    q[0] = kv[0] = n
    tables = np.zeros((4, mgr.max_blocks_per_seq), np.int32)
    tables[0, :len(blocks)] = blocks
    eng.ragged_step(toks, q, kv, tables)
    return toks


def _slabs_equal(a, b):
    return set(a) == set(b) and all(np.array_equal(_np(a[k]), _np(b[k]))
                                    for k in a)


def _shapes(slabs):
    return {k: (tuple(_np(v).shape), str(_np(v).dtype))
            for k, v in slabs.items()}


def _real_rows(payload, axis):
    """A JAX payload's slabs cut to their real block rows: the JAX
    package pads its slabs to `max_blocks_per_seq` rows, the port's hold
    only the `num_blocks` real ones."""
    cut = (slice(None),) * axis + (slice(0, payload.num_blocks),)
    return {k: _np(v)[cut] for k, v in payload.slabs.items()}


def _raised(call):
    try:
        call()
    except Exception as e:   # noqa: BLE001 - the type is the outcome
        return type(e).__name__
    return None


# ---------------------------------------------------------------------------
# payload plumbing
# ---------------------------------------------------------------------------

class TestPayloadPlumbing:
    def test_pad_and_check_header(self):
        def scenario(p):
            m = p.mig
            idx = m.pad_block_indices([3, 7, 1], 8)
            assert idx.dtype == np.int32 and idx.shape == (8,)
            errs = []
            for call in (lambda: m.pad_block_indices([], 4),
                         lambda: m.pad_block_indices([1, 2, 3, 4, 5], 4),
                         lambda: m.check_header({"kv_bits": 8},
                                                {"kv_bits": 16}),
                         lambda: m.check_header({}, {"block_size": 4}),
                         lambda: m.check_header([], {"block_size": 4})):
                try:
                    call()
                    errs.append(None)
                except m.KVMigrationError as e:
                    errs.append(str(e))
            return idx.tolist(), errs, m.PAYLOAD_VERSION

        idx, errs, _ = both(scenario)
        assert idx == [3, 7, 1, 1, 1, 1, 1, 1]
        assert "kv_bits" in errs[2] and "block_size" in errs[3]

    @pytest.mark.parametrize("kv_bits", [16, 8])
    def test_mlp_payload_equals_jax(self, kv_bits):
        """Header, slabs on the real rows and `nbytes`: the embedding
        pool holds gathered embeddings bit for bit (on an int8 pool their
        codes; the scale plane within 1e-6, XLA's f32 division being an
        ulp off)."""
        out = {}
        for p in PKGS:
            eng = p.mlp(kv_bits=kv_bits)
            _fill(eng, n=7)
            pay = eng.extract_kv_blocks(0)
            assert pay.num_tokens == 7 and pay.num_blocks == 2
            full = sum(int(_np(s).nbytes) for s in pay.slabs.values())
            rows = 2 if p is PORT else 8     # JAX pads to max_blocks_per_seq
            assert pay.nbytes == full * 2 // rows
            assert eng.manager.seq_blocks(0) == 2    # extraction is a copy
            out[p.name] = pay
        tp, jp = out["port"], out["jax"]
        assert tp.header == jp.header and tp.nbytes == jp.nbytes
        jreal = _real_rows(jp, 0)
        assert _shapes(tp.slabs) == _shapes(jreal)
        assert np.array_equal(_np(tp.slabs["cache"]), jreal["cache"])
        if kv_bits == 8:
            np.testing.assert_allclose(_np(tp.slabs["scale"]),
                                       jreal["scale"], rtol=1e-6, atol=0)

    def test_extract_without_blocks_is_typed(self):
        assert both(lambda p: _raised(
            lambda: p.mlp().extract_kv_blocks(99))) == "KVMigrationError"


# ---------------------------------------------------------------------------
# MLP engine round trips
# ---------------------------------------------------------------------------

class TestMLPRoundTrip:
    @pytest.mark.parametrize("kv_bits,planes", [(16, {"cache"}),
                                                (8, {"cache", "scale"})])
    def test_bitwise(self, kv_bits, planes):
        src = PORT.mlp(kv_bits=kv_bits)
        _fill(src, seq_id=0, n=9)
        pool0 = [t.clone() for t in src._pools()]
        p = src.extract_kv_blocks(0)
        assert set(p.slabs) == planes
        assert all(torch.equal(a, b) for a, b in zip(pool0, src._pools()))
        dst = PORT.mlp(kv_bits=kv_bits)
        dst.inject_kv_blocks(5, p)
        assert dst.manager.seq_len(5) == 9
        assert len(dst.manager.blocks_of(5)) == 3
        q = dst.extract_kv_blocks(5)
        assert _slabs_equal(p.slabs, q.slabs)
        # the inject copied: the payload is not aliased by the pool
        dst._pools()[0].fill_(0)
        assert _slabs_equal(p.slabs, src.extract_kv_blocks(0).slabs)
        dst.manager.check_consistency()

    def test_free_returns_pool_to_empty(self):
        def scenario(p):
            src = p.mlp()
            _fill(src, n=7)
            dst = p.mlp()
            free0 = dst.manager.free_blocks
            dst.inject_kv_blocks(1, src.extract_kv_blocks(0))
            held = free0 - dst.manager.free_blocks
            dst.manager.free(1)
            dst.manager.check_consistency()
            return held, dst.manager.free_blocks == free0

        assert both(scenario) == (2, True)


# ---------------------------------------------------------------------------
# typed mismatches, checked BEFORE the target pool is touched
# ---------------------------------------------------------------------------

class TestTypedMismatch:
    @pytest.mark.parametrize("target_kw", [
        dict(block_size=8, max_blocks_per_seq=4), dict(kv_bits=8)])
    def test_geometry_mismatch_pre_inject(self, target_kw):
        def scenario(p):
            src = p.mlp()
            _fill(src, n=7)
            pay = src.extract_kv_blocks(0)
            dst = p.mlp(**target_kw)
            free0 = dst.manager.free_blocks
            with pytest.raises(p.mig.KVMigrationError) as e:
                dst.inject_kv_blocks(0, pay)
            assert dst.manager.free_blocks == free0
            assert dst.manager.seq_blocks(0) == 0
            dst.manager.check_consistency()
            return str(e.value)

        both(scenario)

    def test_tampered_block_count_and_version(self):
        def scenario(p):
            src = p.mlp()
            _fill(src, n=7)
            pay = src.extract_kv_blocks(0)
            out = []
            for bad in (dict(num_tokens=3), dict(version=0)):
                dst = p.mlp()
                free0 = dst.manager.free_blocks
                tampered = p.mig.KVBlockPayload(dict(pay.header, **bad),
                                                pay.slabs)
                with pytest.raises(p.mig.KVMigrationError) as e:
                    dst.inject_kv_blocks(0, tampered)
                assert dst.manager.free_blocks == free0
                assert dst.manager.seq_blocks(0) == 0
                dst.manager.check_consistency()
                out.append(str(e.value))
            return out

        msgs = both(scenario)
        assert "blocks" in msgs[0] and "version" in msgs[1]


# ---------------------------------------------------------------------------
# Llama engine round trips (f32 pools, and int8 with K/V scale planes)
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def models():
    paddle.seed(11)
    jm = jax_llama_tiny(vocab=128, layers=2, hidden=64, heads=4, seq=256)
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    tm = from_jax_state(state, LlamaConfig(**dataclasses.asdict(jm.config)),
                        device="cpu")
    return jm, tm


def _llama(p, models, kv_bits=16):
    geo = dict(max_batch_size=4, num_blocks=32, block_size=8,
               max_blocks_per_seq=8, kv_bits=kv_bits)
    if p is JAX:
        return JaxLlamaEngine(models[0], **geo)
    return LlamaInferenceEngine(models[1], device="cpu", **geo)


class TestLlamaRoundTrip:
    @pytest.mark.parametrize("kv_bits,planes", [
        (16, {"k", "v"}), (8, {"k", "v", "k_scale", "v_scale"})])
    def test_payload_equals_jax_and_round_trips(self, models, kv_bits,
                                                planes):
        pays = {}
        for p in PKGS:
            src = _llama(p, models, kv_bits)
            _fill(src, seq_id=0, n=11)
            pays[p.name] = src.extract_kv_blocks(0)
            assert set(pays[p.name].slabs) == planes
        jp, tp = pays["jax"], pays["port"]
        assert tp.header == jp.header and tp.nbytes == jp.nbytes
        jreal = _real_rows(jp, 1)
        assert _shapes(tp.slabs) == _shapes(jreal)
        for k in ("k", "v", "k_scale", "v_scale")[:len(planes)]:
            if k in ("k", "v") and kv_bits == 8:
                # int8 codes of f32 values a rounding apart: one step
                assert np.abs(_np(tp.slabs[k]).astype(np.int32)
                              - jreal[k].astype(np.int32)).max() <= 1
            else:
                np.testing.assert_allclose(_np(tp.slabs[k]), jreal[k],
                                           atol=ATOL, rtol=RTOL)
        # the port's round trip is bitwise
        dst = _llama(PORT, models, kv_bits)
        dst.inject_kv_blocks(3, tp)
        assert dst.manager.seq_len(3) == 11
        assert _slabs_equal(tp.slabs, dst.extract_kv_blocks(3).slabs)
        dst.manager.check_consistency()

    def test_family_mismatch_typed(self, models):
        def scenario(p):
            src = p.mlp(block_size=8)
            _fill(src, n=7)
            dst = _llama(p, models)
            free0 = dst.manager.free_blocks
            with pytest.raises(p.mig.KVMigrationError) as e:
                dst.inject_kv_blocks(0, src.extract_kv_blocks(0))
            assert dst.manager.free_blocks == free0
            return str(e.value)

        assert "engine" in both(scenario)

    @pytest.mark.parametrize("kv_bits", [16, 8])
    def test_lora_engine_migrates_its_own_pools(self, models, kv_bits):
        """A `LoRAEngine` extracts from and injects into its own pools
        (the base engine's stay untouched), under the base's header."""
        base = _llama(PORT, models, kv_bits)
        src = tserving.attach_adapters(base, pool_slots=2, rank_buckets=(4,))
        _fill(src, seq_id=0, n=13)
        pay = src.extract_kv_blocks(0)
        assert pay.header == base._mig_header | dict(num_blocks=2,
                                                     num_tokens=13)
        assert all(not t.any() for t in base._pools())
        dst = tserving.attach_adapters(_llama(PORT, models, kv_bits),
                                       pool_slots=2, rank_buckets=(4,))
        dst.inject_kv_blocks(1, pay)
        assert _slabs_equal(pay.slabs, dst.extract_kv_blocks(1).slabs)
        plain = _llama(PORT, models, kv_bits)
        plain.inject_kv_blocks(1, pay)      # the payload of either engine
        assert _slabs_equal(pay.slabs, plain.extract_kv_blocks(1).slabs)


# ---------------------------------------------------------------------------
# scheduler-level import: a released session resumes bitwise, no prefill
# ---------------------------------------------------------------------------

class TestImportSession:
    def test_shipped_session_resumes_bitwise(self):
        prompt = [5, 9, 13, 2, 40, 11]

        def scenario(p):
            fe0 = p.s.ServingFrontend(p.mlp(), stall_after=256)
            h0 = fe0.submit(prompt, max_new_tokens=8)
            fe0.run_until_idle()
            reference = h0.tokens

            fe1 = p.s.ServingFrontend(p.mlp(), stall_after=256)
            h = fe1.submit(prompt, max_new_tokens=8)
            req = h._req
            while len(req.generated) < 3:
                fe1.step()
            carried = list(req.generated)
            assert fe1.in_flight() == [req]
            payload = fe1.scheduler.engine.extract_kv_blocks(req.seq_id)
            assert fe1.release(h)
            assert req.status.value == "preempted" and not fe1.release(h)
            assert fe1.scheduler.kv_leaked_blocks() == 0
            fe2 = p.s.ServingFrontend(p.mlp(), stall_after=256)
            prefills0 = p.monitor.get("serving.prefills")
            fe2.import_session(req, payload)
            fe2.run_until_idle()
            assert h.status.value == "finished"
            assert req.generated[:len(carried)] == carried
            assert h.tokens == reference
            assert p.monitor.get("serving.prefills") == prefills0
            assert fe2.scheduler.kv_leaked_blocks() == 0
            fe2.scheduler.engine.manager.check_consistency()
            return h.tokens, payload.header, carried

        both(scenario)

    def test_import_without_primitive_and_oversized(self):
        def scenario(p):
            class NoMigration(p.s.MLPLMEngine):
                extract_kv_blocks = None
                inject_kv_blocks = None

            src = p.mlp()
            _fill(src, n=4)
            payload = src.extract_kv_blocks(0)
            kw = {} if p is JAX else {"device": "cpu"}
            fe = p.s.ServingFrontend(NoMigration(**MLP_KW, **kw),
                                     stall_after=256)
            h = fe.submit([1, 2, 3, 4], max_new_tokens=4)
            fe.release(h)
            with pytest.raises(p.mig.KVMigrationError):
                fe.import_session(h._req, payload)

            src = p.mlp()
            toks = _fill(src, n=20)
            payload = src.extract_kv_blocks(0)
            big = p.s.ServingFrontend(p.mlp(), stall_after=256)
            h = big.submit(toks.tolist(), max_new_tokens=4)
            big.release(h)
            tiny = p.s.ServingFrontend(p.mlp(max_blocks_per_seq=4),
                                       stall_after=256)
            free0 = tiny.scheduler.engine.manager.free_blocks
            tiny.import_session(h._req, payload)
            assert tiny.scheduler.engine.manager.free_blocks == free0
            tiny.scheduler.engine.manager.check_consistency()
            return h.status.value, h.finish_reason

        assert both(scenario) == ("rejected", "prompt_too_long")

    def test_resubmit_replays_a_released_request(self):
        """`release` + `resubmit`: the committed tokens fold into the
        prompt and the stream continues token for token (the relocation
        path without KV)."""
        prompt = [7, 3, 22, 9]

        def scenario(p):
            fe1 = p.s.ServingFrontend(p.mlp(), stall_after=256)
            h = fe1.submit(prompt, max_new_tokens=6)
            req = h._req
            while len(req.generated) < 2:
                fe1.step()
            assert fe1.release(h)
            kept = list(req.generated)
            req.prompt = np.concatenate([req.prompt, np.asarray(
                kept, np.int32)]).astype(np.int32)
            req.sampling.max_new_tokens -= len(kept)
            req.generated = []
            req._last = None
            req.status = p.s.RequestStatus.QUEUED
            fe2 = p.s.ServingFrontend(p.mlp(), stall_after=256)
            fe2.resubmit(req)
            fe2.run_until_idle()
            return kept + req.generated, req.status.value

        both(scenario)


# ---------------------------------------------------------------------------
# prefix streaming between schedulers
# ---------------------------------------------------------------------------

PROMPT = list(range(1, 13))     # 12 tokens = 3 full blocks (block size 4)


def _fe(p, **over):
    return p.s.ServingFrontend(p.mlp(**over), prefix_cache=True,
                               stall_after=256)


def _publish_on(fe, max_new=6):
    h = fe.submit(PROMPT, max_new_tokens=max_new)
    fe.run_until_idle()
    assert h.status.value == "finished"
    return h.tokens


class TestPrefixStreaming:
    def test_export_import_roundtrip_bitwise(self):
        def scenario(p):
            fe1, fe2 = _fe(p), _fe(p)
            ref = _publish_on(fe1)
            blocks, hit = fe1.scheduler.prefix_cache.match_export(PROMPT)
            assert hit == 12 and len(blocks) == 3
            payload = fe1.scheduler.export_prefix(PROMPT)
            assert payload.num_tokens == 12 and payload.num_blocks == 3
            free0 = fe2.scheduler.engine.manager.free_blocks
            assert fe2.scheduler.import_prefix(PROMPT, payload) == 12
            assert fe2.scheduler.engine.manager.free_blocks == free0 - 3
            assert fe2.scheduler.kv_leaked_blocks() == 0
            hit0 = p.monitor.get("serving.prefix_cache.hit_tokens")
            assert _publish_on(fe2) == ref
            gained = p.monitor.get("serving.prefix_cache.hit_tokens") - hit0
            assert gained >= 8
            for fe in (fe1, fe2):
                fe.scheduler.engine.manager.check_consistency()
            return ref, gained, payload.header

        both(scenario)

    def test_extraction_leaves_source_untouched(self):
        def scenario(p):
            fe1 = _fe(p)
            _publish_on(fe1)
            eng = fe1.scheduler.engine
            free0 = eng.manager.free_blocks
            cache0 = _np(eng.cache).copy()
            fe1.scheduler.export_prefix(PROMPT)
            assert eng.manager.free_blocks == free0
            assert np.array_equal(_np(eng.cache), cache0)
            eng.manager.check_consistency()
            return free0

        both(scenario)

    def test_import_is_idempotent_and_capacity_safe(self):
        def scenario(p):
            fe1, fe2 = _fe(p), _fe(p)
            _publish_on(fe1)
            payload = fe1.scheduler.export_prefix(PROMPT)
            first = fe2.scheduler.import_prefix(PROMPT, payload)
            free1 = fe2.scheduler.engine.manager.free_blocks
            again = fe2.scheduler.import_prefix(PROMPT, payload)
            assert fe2.scheduler.engine.manager.free_blocks == free1
            tiny = _fe(p, max_blocks_per_seq=2)
            small = tiny.scheduler.import_prefix(PROMPT, payload)
            tiny.scheduler.engine.manager.check_consistency()
            return first, again, small

        assert both(scenario) == (12, 0, 0)

    def test_cold_disabled_and_mismatched(self):
        def scenario(p):
            out = [_fe(p).scheduler.export_prefix(PROMPT)]
            off = p.s.ServingFrontend(p.mlp(), stall_after=256)
            out += [off.scheduler.export_prefix(PROMPT),
                    off.scheduler.import_prefix(PROMPT, object())]
            fe1 = _fe(p)
            _publish_on(fe1)
            payload = fe1.scheduler.export_prefix(PROMPT)
            other = _fe(p, block_size=8)
            free0 = other.scheduler.engine.manager.free_blocks
            with pytest.raises(p.mig.KVMigrationError):
                other.scheduler.import_prefix(PROMPT, payload)
            assert other.scheduler.engine.manager.free_blocks == free0
            other.scheduler.engine.manager.check_consistency()
            return out

        assert both(scenario) == [None, None, 0]
