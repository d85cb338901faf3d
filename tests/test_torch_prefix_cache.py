"""The shared-prefix radix cache and tenant SLO scenarios of
`tests/test_prefix_cache.py` on both packages: the block manager's
reference counts and copy-on-write, the radix tree's lease / publish /
evict lifecycle, scheduler integration (hits skip prefill, a full hit
costs one step, spec == plain on a hit, the tree rebuilt after a
watchdog restart) and tenant isolation (quota, reserve, weighted lanes,
tiered watermarks), on each package's `MLPLMEngine` with the same
weights (the port's on the CPU, loaded through `mlp_from_jax_params`).
Integer state — block tables, reference counts, free-list order, tree
nodes — is exact, and so are token streams, statuses, finish reasons,
tree stats, prefill tokens and leak counts; logits agree within 1e-5.
Then a random op sequence applied to both managers and trees
(hypothesis), and a tiny Llama served with the cache on and a forced
copy-on-write, over a bf16-width f32 pool and an int8 pool."""
import dataclasses
from types import SimpleNamespace

import numpy as np
import pytest
import torch
from hypothesis import given, settings
from hypothesis import strategies as st

import jax.numpy as jnp

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.inference import LlamaInferenceEngine as JaxEngine
from paddle_tpu.inference.cache import BlockCacheManager as JMgr
from paddle_tpu.inference.prefix_cache import RadixPrefixCache as JTree
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.resilience import faults as jfaults
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import (LlamaConfig, LlamaInferenceEngine,
                              from_jax_state, mlp_from_jax_params)
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.inference.cache import BlockCacheManager as TMgr
from paddle_tpu_torch.inference.prefix_cache import RadixPrefixCache as TTree
from paddle_tpu_torch.resilience import faults as tfaults
from torch_threads import one_thread  # noqa: F401

VOCAB = 64
BS = 4


def _pkg(name, serving, monitor, faults, mgr, tree, engine):
    return SimpleNamespace(name=name, s=serving, monitor=monitor,
                           faults=faults, Mgr=mgr, Tree=tree, engine=engine)


def _jax_engine(max_batch=4, num_blocks=48, block_size=BS,
                max_blocks_per_seq=8, seed=0, kv_bits=16):
    return jserving.MLPLMEngine(vocab_size=VOCAB, hidden=16,
                                max_batch_size=max_batch,
                                num_blocks=num_blocks, block_size=block_size,
                                max_blocks_per_seq=max_blocks_per_seq,
                                seed=seed, kv_bits=kv_bits)


def _port_engine(**kw):
    """The port's engine, its weights loaded from the JAX engine built
    with the same arguments (they are also the same seed-derived
    draws: `test_mlp_engines_share_seed_weights`)."""
    geo = dict(vocab_size=VOCAB, hidden=16)
    j = dict(max_batch=4, num_blocks=48, block_size=BS,
             max_blocks_per_seq=8, seed=0, kv_bits=16)
    j.update(kw)
    eng = tserving.MLPLMEngine(max_batch_size=j["max_batch"],
                               num_blocks=j["num_blocks"],
                               block_size=j["block_size"],
                               max_blocks_per_seq=j["max_blocks_per_seq"],
                               seed=j["seed"], kv_bits=j["kv_bits"],
                               device="cpu", **geo)
    ref = _jax_engine(**j)
    return mlp_from_jax_params({k: np.asarray(v)
                                for k, v in ref.params.items()}, eng)


JAX = _pkg("jax", jserving, jmonitor, jfaults, JMgr, JTree, _jax_engine)
PORT = _pkg("port", tserving, tmonitor, tfaults, TMgr, TTree, _port_engine)
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
    """Run `scenario(pkg, *args)` on each package with fresh counters and
    assert equal outcomes; returns the JAX package's."""
    out = {}
    for p in PKGS:
        p.s.ServingMetrics.reset_monitor()
        p.faults.clear()
        out[p.name] = scenario(p, *args)
        p.faults.clear()
    assert out["port"] == out["jax"]
    return out["jax"]


def toks(rng, n):
    return rng.integers(1, VOCAB, n).tolist()


def mgr_state(mgr):
    """The manager's whole integer state, in order."""
    return (list(mgr._free), {k: list(v) for k, v in mgr._tables.items()},
            dict(mgr._lens), dict(mgr._refs), mgr.cow_copies)


def tree_state(tree):
    return (sorted((b, n.tokens, n.parent.block, n.stamp)
                   for b, n in tree._by_block.items()),
            sorted(tree._unpinned), tree.stats())


def outcome(hs):
    return [(h.tokens, h.status.value, h.finish_reason) for h in hs]


# ---------------------------------------------------------------- manager

def _refcounts(p, case):
    mgr = p.Mgr(8, BS, 8)
    log = []
    if case == "adopt_free":
        blocks = mgr.allocate(1, 8)
        mgr.adopt(2, blocks, 8)
        log.append(([mgr.ref_count(b) for b in blocks], mgr.free_blocks))
        mgr.free(1)
        log.append(([mgr.ref_count(b) for b in blocks], mgr.free_blocks))
        mgr.free(2)
    elif case == "trim_lease":
        blocks = mgr.allocate(1, 8)
        mgr.adopt(2, blocks, 8)
        mgr.trim(2, 2)
        log.append((mgr.ref_count(blocks[1]), mgr.free_blocks))
        mgr.free(1)
    elif case == "cow_append":
        copies = []
        mgr.set_cow_hook(lambda s, d: copies.append((s, d)))
        blocks = mgr.allocate(1, 6)
        mgr.adopt(2, blocks, 6)
        mgr.append_tokens(2, 1)               # diverges inside shared
        mgr.append_tokens(2, 1)               # private now: no 2nd COW
        log.append((copies, mgr.blocks_of(1), mgr.blocks_of(2)))
    elif case == "cow_after_trim":
        blocks = mgr.allocate(1, 8)
        mgr.adopt(3, blocks, 8)
        mgr.trim(3, 5)                        # mid-block, keeps both
        log.append(mgr.ref_count(blocks[1]))
        mgr.append_tokens(3, 1)               # divergent write -> COW
        mgr.adopt(4, blocks, 8)
        mgr.trim(4, 4)                        # boundary: lease dropped
        mgr.append_tokens(4, 1)               # a fresh block, no COW
        log.append((mgr.blocks_of(1), mgr.blocks_of(3), mgr.blocks_of(4)))
    elif case == "cow_pool_empty":
        mgr = p.Mgr(3, BS, 8)
        blocks = mgr.allocate(1, 6)
        mgr.adopt(2, blocks, 6)
        mgr.allocate(3, 4)                    # the last free block
        try:
            mgr.append_tokens(2, 1)
        except Exception as e:                # KVCacheExhausted
            log.append(type(e).__name__)
        log.append(mgr.seq_len(2))
    elif case == "cow_hook_fails":
        def hook(s, d):
            raise RuntimeError("device copy failed")

        mgr.set_cow_hook(hook)
        blocks = mgr.allocate(1, 6)
        mgr.adopt(2, blocks, 6)
        with pytest.raises(RuntimeError):
            mgr.append_tokens(2, 1)
        log.append((mgr.free_blocks, mgr.seq_len(2)))
    mgr.check_consistency()
    return log, mgr_state(mgr)


@pytest.mark.parametrize("case", ["adopt_free", "trim_lease", "cow_append",
                                  "cow_after_trim", "cow_pool_empty",
                                  "cow_hook_fails"])
def test_refcounted_blocks_and_cow(case):
    """Adopt / free / trim move leases, not blocks; a divergent append
    (also after a trim back into a shared block) copies on write once;
    a COW with no free block, or whose hook fails, leaves everything as
    it was."""
    log, state = both(_refcounts, case)
    free, _tables, _lens, _refs, cow = state
    if case == "adopt_free":
        assert log == [([2, 2], 6), ([1, 1], 6)] and len(free) == 8
    elif case == "trim_lease":
        assert log == [(1, 6)]
    elif case == "cow_append":
        (copies, b1, b2), = log
        assert len(copies) == 1 and b2[1] == copies[0][1] != b1[1] \
            == copies[0][0] and cow == 1
    elif case == "cow_after_trim":
        assert log[0] == 2 and cow == 1
        b1, b3, _b4 = log[1]
        assert b3[1] != b1[1]
    elif case == "cow_pool_empty":
        assert log == ["KVCacheExhausted", 6] and cow == 0
    else:
        assert log == [(6, 6)] and cow == 0


def _utilization_shared(p):
    mgr = p.Mgr(4, BS, 4)
    blocks = mgr.allocate(1, 16)
    for sid in (2, 3, 4):
        mgr.adopt(sid, blocks, 16)
    frag = mgr.fragmentation()
    out = (mgr.utilization(), {k: frag[k] for k in (
        "leased_blocks", "lease_count", "shared_blocks",
        "internal_frag_ratio", "free_blocks", "utilization")})
    for sid in (1, 2, 3, 4):
        mgr.free(sid)
    mgr.check_consistency()
    return out, mgr_state(mgr)


def test_utilization_counts_shared_block_once():
    (util, frag), _ = both(_utilization_shared)
    assert util == 1.0
    assert (frag["leased_blocks"], frag["lease_count"],
            frag["shared_blocks"]) == (4, 16, 4)


# ------------------------------------------------------------- radix tree

def _published(mgr, tree, rng, n_tokens, seq_id=100):
    ids = toks(rng, n_tokens)
    mgr.allocate(seq_id, n_tokens)
    tree.publish(seq_id, ids)
    mgr.free(seq_id)
    return ids


def _radix(p, case):
    mgr = p.Mgr(16, BS, 8)
    tree = p.Tree(mgr)
    log = []
    if case == "lease":
        rng = np.random.default_rng(0)
        ids = _published(mgr, tree, rng, 12)
        log += [tree.num_nodes, tree.lease(1, ids), mgr.seq_blocks(1),
                tree.lease(2, ids[:6] + toks(rng, 6))]
        mgr.free(1)
        mgr.free(2)
    elif case == "miss":
        rng = np.random.default_rng(1)
        _published(mgr, tree, rng, 8)
        log += [tree.lease(1, toks(rng, 8)), mgr.seq_blocks(1), tree.misses]
    elif case == "lru":
        mgr.set_reclaimer(tree)
        rng = np.random.default_rng(2)
        a = _published(mgr, tree, rng, 8, seq_id=100)
        _published(mgr, tree, rng, 8, seq_id=101)
        tree.lease(1, a)
        log += [tree.reclaimable(), tree.evict(10), tree.num_nodes,
                set(tree.blocks()) == set(mgr.blocks_of(1)), tree.evict(10)]
        mgr.free(1)
        log.append(tree.evict(10))
    elif case == "pressure":
        mgr = p.Mgr(6, BS, 8)
        tree = p.Tree(mgr)
        mgr.set_reclaimer(tree)
        rng = np.random.default_rng(3)
        _published(mgr, tree, rng, 16)
        log += [mgr.free_blocks, len(mgr.allocate(1, 16)), tree.evictions]
    mgr.check_consistency(external=tree.block_ref_counts())
    return log, mgr_state(mgr), tree_state(tree)


@pytest.mark.parametrize("case,want", [
    ("lease", [3, 11, 3, 6]), ("miss", [0, 0, 1]),
    ("lru", [2, 2, 2, True, 0, 2]), ("pressure", [2, 4, 2])])
def test_radix_tree_lifecycle(case, want):
    """Publish then a full (capped at len - 1) and a partial lease; a miss
    leases nothing; LRU eviction goes leaf-up and never takes a leased
    block; pool pressure reclaims through the manager."""
    log, _mgr, _tree = both(_radix, case)
    assert log == want


def _property(p):
    """The randomized lifecycle of `test_eviction_under_pressure_property`:
    after EVERY op the pool accounting is exact with the tree's leases."""
    rng = np.random.default_rng(4)
    mgr = p.Mgr(24, BS, 8)
    tree = p.Tree(mgr)
    mgr.set_reclaimer(tree)
    live = {}
    next_id = 0
    vocab_pool = [toks(rng, 16) for _ in range(6)]
    trace = []
    for _step in range(300):
        op = rng.random()
        if op < 0.5 and len(live) < 6:
            sid = next_id = next_id + 1
            base = vocab_pool[rng.integers(0, len(vocab_pool))]
            ids = list(base[:int(rng.integers(4, 15))])
            try:
                hit = tree.lease(sid, ids)
                if hit == 0:
                    mgr.allocate(sid, 0)
                mgr.append_tokens(sid, len(ids) - hit)
            except Exception as e:            # KVCacheExhausted
                trace.append(type(e).__name__)
                if mgr.seq_blocks(sid):
                    mgr.free(sid)
                continue
            live[sid] = ids
            trace.append(hit)
        elif live:
            sid = list(live)[int(rng.integers(0, len(live)))]
            ids = live.pop(sid)
            if rng.random() < 0.8:
                trace.append(tree.publish(sid, ids))
            mgr.free(sid)
        mgr.check_consistency(external=tree.block_ref_counts())
    return trace, mgr_state(mgr), tree_state(tree)


def test_eviction_under_pressure_property():
    trace, _m, (_nodes, _unp, stats) = both(_property)
    assert stats["hits"] > 0


OPS = ("allocate", "lease", "adopt", "append", "trim", "free", "publish",
       "evict")


def _apply(mgr, tree, live, kind, a, b, seed):
    """One op on one (manager, tree); `live` is the harness's model of
    each sequence's token content (identical for both packages: it is
    updated from the op's result, which the test holds equal)."""
    rng = np.random.default_rng(seed)
    sids = sorted(live)
    if kind == "allocate":
        return ("new", mgr.allocate(a, b))
    if kind == "lease":
        return ("new", tree.lease(a, rng.integers(1, 4, b).tolist()))
    if not sids:
        return None
    sid = sids[a % len(sids)]
    if kind == "adopt":
        k = max(1, b % (mgr.seq_blocks(sid) + 1))
        blocks = list(mgr.blocks_of(sid))[:k]
        n = min(len(live[sid]), k * mgr.block_size)
        return ("adopt", sid, mgr.adopt(1000 + seed % 1000, blocks, n), n)
    if kind == "append":
        return mgr.append_tokens(sid, b)
    if kind == "trim":
        return mgr.trim(sid, b % (len(live[sid]) + 1))
    if kind == "free":
        return mgr.free(sid)
    if kind == "publish":
        return tree.publish(sid, live[sid])
    return tree.evict(b)


@settings(max_examples=60, deadline=None, derandomize=True)
@given(st.lists(st.tuples(st.sampled_from(OPS), st.integers(0, 7),
                          st.integers(0, 20), st.integers(0, 10 ** 6)),
                min_size=4, max_size=40))
def test_manager_and_tree_differential(ops):
    """One random sequence of allocate / adopt / append_tokens / trim /
    free / publish / lease / evict on both packages' manager + tree
    (a pool of 12 blocks of 4, 6 a sequence, the tree as reclaimer, a
    COW hook recording copies): after each op the results (or exception
    types), block tables, lengths, reference counts, free-list order,
    tree nodes and stamps, the unpinned set and the COW copies agree."""
    pairs = {}
    for name, Mgr, Tree in (("jax", JMgr, JTree), ("port", TMgr, TTree)):
        mgr = Mgr(12, 4, 6)
        tree = Tree(mgr)
        mgr.set_reclaimer(tree)
        copies = []
        mgr.set_cow_hook(lambda s, d, _c=copies: _c.append((s, d)))
        pairs[name] = (mgr, tree, copies)
    live = {}
    for step, (kind, a, b, seed) in enumerate(ops):
        if kind in ("allocate", "lease"):
            a = step                       # a fresh sequence id
        results = {}
        for name, (mgr, tree, _c) in pairs.items():
            try:
                results[name] = _apply(mgr, tree, live, kind, a, b, seed)
            except Exception as e:
                results[name] = type(e).__name__
        assert results["port"] == results["jax"], (kind, results)
        res = results["jax"]
        mgr = pairs["jax"][0]
        if isinstance(res, tuple) and res[0] == "new":
            if mgr.seq_blocks(a):
                live[a] = np.random.default_rng(seed).integers(
                    1, 4, b).tolist()[:mgr.seq_len(a)]
        elif isinstance(res, tuple) and res[0] == "adopt":
            live[1000 + seed % 1000] = live[res[1]][:res[3]]
        elif res is None or isinstance(res, str):
            pass
        elif kind == "append":
            sid = sorted(live)[a % len(live)]
            live[sid] = live[sid] + [int(x) for x in
                                     np.random.default_rng(seed).integers(
                                         1, 4, b)]
        elif kind == "trim":
            sid = sorted(live)[a % len(live)]
            live[sid] = live[sid][:mgr.seq_len(sid)]
        elif kind == "free":
            live.pop(sorted(live)[a % len(live)])
        states = {n: (mgr_state(m), tree_state(t), list(c))
                  for n, (m, t, c) in pairs.items()}
        assert states["port"] == states["jax"], kind
        for m, t, _c in pairs.values():
            m.check_consistency(external=t.block_ref_counts())


# ------------------------------------------------- scheduler integration

def test_mlp_engines_share_seed_weights_and_logits():
    """One seed gives both packages' `MLPLMEngine` the same weights, and
    a ragged step (f32 pool and int8 pool, a chunk and a decode lane)
    gives logits within 1e-5."""
    for kv_bits in (16, 8):
        je = _jax_engine(kv_bits=kv_bits)
        te = tserving.MLPLMEngine(vocab_size=VOCAB, hidden=16,
                                  max_batch_size=4, num_blocks=48,
                                  block_size=BS, max_blocks_per_seq=8,
                                  kv_bits=kv_bits, device="cpu")
        for k, v in je.params.items():
            assert np.array_equal(np.asarray(v), te.params[k].numpy()), k
        tables = np.zeros((4, 8), np.int32)
        tables[0, :3] = [3, 4, 5]
        tables[2, :1] = [7]
        rng = np.random.default_rng(0)
        for q_lens, kv_lens in (([9, 0, 3, 0], [9, 0, 3, 0]),
                                ([1, 0, 1, 0], [10, 0, 4, 0])):
            t = np.zeros((12,), np.int32)
            t[:sum(q_lens)] = rng.integers(1, VOCAB, sum(q_lens))
            a = np.asarray(je.ragged_step(t, q_lens, kv_lens, tables))
            b = te.ragged_step(t, q_lens, kv_lens, tables).numpy()
            np.testing.assert_allclose(b, a, atol=1e-5, rtol=0)
        np.testing.assert_array_equal(te.cache.numpy(), np.asarray(je.cache))


def _hit_skips_prefill(p):
    fe = p.s.ServingFrontend(p.engine(), prefix_cache=True,
                             prefill_chunk_tokens=4)
    prompt = toks(np.random.default_rng(5), 16)
    h1 = fe.submit(prompt, max_new_tokens=3)
    fe.run_until_idle()
    pre0 = p.monitor.get("serving.prefill_tokens")
    h2 = fe.submit(prompt, max_new_tokens=3)
    fe.run_until_idle()
    return (outcome([h1, h2]), p.monitor.get("serving.prefill_tokens") - pre0,
            h2._req._prefix_hit_tokens, fe.scheduler.kv_leaked_blocks(),
            fe.scheduler.prefix_stats())


def test_hit_skips_prefill_chunks():
    out, prefilled, hit, leaked, stats = both(_hit_skips_prefill)
    assert out[1][1] == "finished" and out[1][0] == out[0][0]
    assert prefilled <= 2 and hit >= 15 and leaked == 0
    assert stats["cow_copies"] >= 1          # the capped token's block


def _full_hit_one_step(p):
    fe = p.s.ServingFrontend(p.engine(), prefix_cache=True,
                             prefill_chunk_tokens=4)
    prompt = toks(np.random.default_rng(6), 12)
    fe.submit(prompt, max_new_tokens=2)
    fe.run_until_idle()
    h = fe.submit(prompt, max_new_tokens=4)
    fe.step()                              # admission + the ONE chunk
    return h.tokens


def test_full_hit_ttft_is_one_step():
    assert len(both(_full_hit_one_step)) >= 1


def _republish(p):
    fe = p.s.ServingFrontend(p.engine(max_batch=2, num_blocks=16),
                             prefix_cache=True, prefill_chunk_tokens=8)
    rng = np.random.default_rng(7)
    hs = [fe.submit(toks(rng, 8), max_new_tokens=10) for _ in range(4)]
    fe.run_until_idle()
    fe.scheduler.engine.manager.check_consistency(
        external=fe.scheduler.prefix_cache.block_ref_counts())
    return (outcome(hs), [h.num_preemptions for h in hs],
            fe.scheduler.kv_leaked_blocks(), fe.scheduler.prefix_stats(),
            p.monitor.get("serving.prefill_tokens"))


def test_preempted_work_republishes_and_rehits():
    out, _preempts, leaked, _stats, _pre = both(_republish)
    assert all(s == "finished" for _t, s, _r in out) and leaked == 0


def _spec_vs_plain(p, spec):
    rng = np.random.default_rng(8)
    prompt = (toks(rng, 3) * 6)[:14]
    fe = p.s.ServingFrontend(
        p.engine(), prefix_cache=True,
        spec=p.s.SpecDecodeConfig(p.s.NGramProposer(), num_draft_tokens=3)
        if spec else None)
    a = fe.submit(prompt, max_new_tokens=6)
    fe.run_until_idle()
    b = fe.submit(prompt, max_new_tokens=6)
    fe.run_until_idle()
    return (a.tokens, b.tokens, b._req._prefix_hit_tokens > 0,
            fe.scheduler.kv_leaked_blocks())


def test_spec_equals_plain_on_prefix_hit():
    plain = both(_spec_vs_plain, False)
    spec = both(_spec_vs_plain, True)
    assert spec == plain and plain[2] and plain[3] == 0


def _session_turns(p):
    fe = p.s.ServingFrontend(p.engine(num_blocks=64, max_blocks_per_seq=16),
                             prefix_cache=True)
    rng = np.random.default_rng(9)
    turn1 = toks(rng, 12)
    h1 = fe.submit(turn1, max_new_tokens=4)
    fe.run_until_idle()
    h2 = fe.submit(turn1 + h1.tokens + toks(rng, 4), max_new_tokens=4)
    fe.run_until_idle()
    return outcome([h1, h2]), h2._req._prefix_hit_tokens


def test_session_turns_reuse_response_kv():
    out, hit = both(_session_turns)
    assert out[1][1] == "finished" and hit >= (12 + 3) // BS * BS


def _metrics(p):
    fe = p.s.ServingFrontend(p.engine(), prefix_cache=True)
    prompt = toks(np.random.default_rng(10), 12)
    for _ in range(2):
        fe.submit(prompt, max_new_tokens=2)
        fe.run_until_idle()
    s = fe.summary()
    rate = jmonitor.get("serving.prefix_cache.hit_rate_pct") if p is JAX \
        else s["serving.prefix_cache.hit_rate_pct"]
    return ({k: p.monitor.get(f"serving.prefix_cache.{k}")
             for k in ("hits", "misses", "hit_tokens", "cow_copies")},
            round(rate, 1),
            s["serving.prefix_cache.ttft_cached_p50_ms"] is not None,
            s["serving.prefix_cache.ttft_cold_p50_ms"] is not None)


def test_prefix_metrics():
    """The `serving.prefix_cache.*` counters, the hit-rate gauge and the
    cached / cold TTFT split of `summary()` (the JAX profiler's prefix
    line has no port yet)."""
    c, rate, cached, cold = both(_metrics)
    assert c["hits"] >= 1 and c["misses"] >= 1 and c["hit_tokens"] >= 8
    assert rate > 0 and cached and cold


def _restart_rebuilds_tree(p):
    fe = p.s.ServingFrontend(
        p.engine(), prefix_cache=True,
        watchdog=p.s.WatchdogConfig(step_retries=0, max_restarts=1),
        engine_factory=p.engine)
    prompt = toks(np.random.default_rng(11), 12)
    fe.submit(prompt, max_new_tokens=2)
    fe.run_until_idle()
    tree0 = fe.scheduler.prefix_cache
    p.faults.inject("serve.decode", after_n=0, times=1)
    h = fe.submit(prompt, max_new_tokens=2)
    fe.run_until_idle()
    return (outcome([h]), fe.scheduler.prefix_cache is not tree0,
            fe.scheduler.kv_leaked_blocks(), tree_state(
                fe.scheduler.prefix_cache),
            p.monitor.get("serving.engine_restarts"))


def test_engine_restart_rebuilds_tree():
    out, fresh, leaked, _tree, restarts = both(_restart_rebuilds_tree)
    assert out[0][1] == "finished" and fresh and leaked == 0
    assert restarts == 1


# --------------------------------------------------------- tenant SLOs

def _quota(p):
    slo = p.s.SLOConfig([p.s.SLOClass("small", kv_quota_blocks=3),
                         p.s.SLOClass("big")])
    fe = p.s.ServingFrontend(p.engine(max_batch=4), slo=slo)
    rng = np.random.default_rng(12)
    hs = [fe.submit(toks(rng, 6), max_new_tokens=6, tenant="small")
          for _ in range(4)]
    hb = [fe.submit(toks(rng, 6), max_new_tokens=6, tenant="big")
          for _ in range(4)]
    fe.step()
    running = [r.tenant for r in fe.scheduler.slots if r is not None]
    fe.run_until_idle()
    return (running, outcome(hs + hb),
            p.monitor.get("serving.tenant.small.deferred.kv_quota"))


def test_quota_defers_without_blocking_others():
    running, out, deferred = both(_quota)
    assert running.count("small") == 1 and running.count("big") == 3
    assert all(s == "finished" for _t, s, _r in out) and deferred > 0


def _reserve(p):
    slo = p.s.SLOConfig([p.s.SLOClass("premium", kv_reserve_blocks=8),
                         p.s.SLOClass("burst")])
    fe = p.s.ServingFrontend(p.engine(max_batch=4, num_blocks=12), slo=slo)
    rng = np.random.default_rng(13)
    hs = [fe.submit(toks(rng, 4), max_new_tokens=4, tenant="burst")
          for _ in range(6)]
    fe.step()
    mgr = fe.scheduler.engine.manager
    burst = sum(mgr.seq_blocks(r.seq_id) for r in fe.scheduler.slots
                if r is not None and r.tenant == "burst")
    hp = fe.submit(toks(rng, 8), max_new_tokens=4, tenant="premium")
    fe.step()
    premium = hp._req.status.value
    fe.run_until_idle()
    return burst, premium, outcome(hs + [hp])


def test_reserve_protects_quiet_tenant():
    burst, premium, out = both(_reserve)
    assert burst <= 3 and premium in ("running", "finished")
    assert all(s == "finished" for _t, s, _r in out)


def _admission_order(p, case):
    rng = np.random.default_rng({"weights": 14, "idle": 17}[case])
    if case == "weights":
        slo = p.s.SLOConfig([p.s.SLOClass("gold", weight=3.0),
                             p.s.SLOClass("econ", weight=1.0)])
        fe = p.s.ServingFrontend(p.engine(max_batch=2, num_blocks=48),
                                 slo=slo)
        for t in ("gold", "econ"):
            for _ in range(8):
                fe.submit(toks(rng, 4), max_new_tokens=4, tenant=t)
    else:
        slo = p.s.SLOConfig([p.s.SLOClass("a"), p.s.SLOClass("b")])
        fe = p.s.ServingFrontend(p.engine(max_batch=1, num_blocks=48),
                                 slo=slo)
        for _ in range(10):
            fe.submit(toks(rng, 4), max_new_tokens=2, tenant="a")
        fe.run_until_idle()
        for t in ("b",) * 6 + ("a",) * 6:
            fe.submit(toks(rng, 4), max_new_tokens=2, tenant=t)
    order, seen = [], set()
    while not fe.scheduler.idle:
        fe.step()
        for r in fe.scheduler.slots:
            if r is not None and r.req_id not in seen:
                seen.add(r.req_id)
                order.append(r.tenant)
    return order


@pytest.mark.parametrize("case", ["weights", "idle"])
def test_fair_admission_order(case):
    """3:1 weights admit ~3:1 under contention; an idle tenant returns
    without banked arrears (it interleaves instead of monopolizing)."""
    order = both(_admission_order, case)
    if case == "weights":
        assert order[:8].count("gold") >= 5, order
    else:
        assert order[:6].count("a") >= 2, order


def _tiered(p):
    slo = p.s.SLOConfig([p.s.SLOClass("interactive", admission_scale=1.0),
                         p.s.SLOClass("batch", admission_scale=0.25)])
    fe = p.s.ServingFrontend(
        p.engine(max_batch=2),
        admission=p.s.AdmissionConfig(queue_high=8, queue_low=2), slo=slo)
    rng = np.random.default_rng(15)
    hs = [fe.submit(toks(rng, 4), max_new_tokens=8, tenant="interactive")
          for _ in range(6)]
    hb = fe.submit(toks(rng, 4), max_new_tokens=4, tenant="batch")
    hi = fe.submit(toks(rng, 4), max_new_tokens=4, tenant="interactive")
    first = (hb.status.value, hi.status.value)
    fe.run_until_idle()
    return first, outcome(hs + [hb, hi])


def test_tiered_watermarks_shed_batch_first():
    (batch, interactive), out = both(_tiered)
    assert batch == "shed" and interactive != "shed"
    assert all(s in ("finished", "shed") for _t, s, _r in out)


def _fifo(p):
    fe = p.s.ServingFrontend(p.engine(max_batch=2))
    rng = np.random.default_rng(16)
    hs = [fe.submit(toks(rng, 4), max_new_tokens=2, tenant=t)
          for t in ("a", "b", "c", "d")]
    fe.run_until_idle()
    t_first = [h._req.t_first_token for h in hs]
    return outcome(hs), t_first == sorted(t_first)


def test_no_slo_config_is_fifo():
    out, in_order = both(_fifo)
    assert all(s == "finished" for _t, s, _r in out) and in_order


# ------------------------------------------------- tiny Llama, forced COW

@pytest.fixture(scope="module")
def jax_llama():
    paddle.seed(23)
    m = jax_llama_tiny(vocab=256, layers=2, hidden=64, heads=4, seq=64,
                       num_key_value_heads=2)
    rng = np.random.default_rng(23)
    for name, p in m.named_parameters():
        if "norm" in name:
            p._data = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=p.shape), jnp.float32)
    return m


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_llama_prefix_cache_with_forced_cow_matches_jax(jax_llama, kv_bits):
    """A tiny Llama (2 layers) served with the cache on: a prompt, then
    the same prompt again (a full hit, capped at its last token, so the
    append copies the shared last block) and a prompt sharing its first
    two blocks. Both packages give the same streams, hits, COW copies and
    prefill tokens, and the cached streams equal the cold ones."""
    m = jax_llama
    geo = dict(max_batch_size=4, num_blocks=32, block_size=4,
               max_blocks_per_seq=16, kv_bits=kv_bits)
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    port = from_jax_state(state, LlamaConfig(**dataclasses.asdict(m.config)),
                          device="cpu")
    rng = np.random.default_rng(3)
    a = rng.integers(1, 256, 14).tolist()
    b = a[:8] + rng.integers(1, 256, 5).tolist()
    out = {}
    for name, fe_cls, eng in (
            ("jax", jserving.ServingFrontend, lambda: JaxEngine(m, **geo)),
            ("port", tserving.ServingFrontend,
             lambda: LlamaInferenceEngine(port, device="cpu", **geo))):
        runs = []
        for cache in (True, False):
            fe = fe_cls(eng(), prefix_cache=cache, prefill_chunk_tokens=4)
            hs = []
            for q in (a, a, b):
                hs.append(fe.submit(q, max_new_tokens=5))
                fe.run_until_idle()
            stats = fe.scheduler.prefix_stats()
            runs.append((outcome(hs), [h._req._prefix_hit_tokens
                                       for h in hs],
                         None if stats is None else (stats["hits"],
                                                     stats["cow_copies"]),
                         fe.scheduler.kv_leaked_blocks()))
        out[name] = runs
    assert out["port"] == out["jax"]
    (cached, hits, stats, leaked), (cold, _h, _s, cold_leaked) = out["port"]
    assert [t for t, _s, _r in cached] == [t for t, _s, _r in cold]
    assert hits[1] == 13 and hits[2] == 8 and stats[1] >= 1
    assert leaked == cold_leaked == 0


@pytest.mark.parametrize("kv_bits", [16, 8])
def test_copy_kv_block_moves_every_plane(jax_llama, kv_bits):
    """`copy_kv_block` copies one block in every layer's K and V pool and,
    on an int8 pool, both scale planes' rows, leaving every other block as
    it was — the JAX engine's copy on the same pools."""
    m = jax_llama
    geo = dict(max_batch_size=2, num_blocks=8, block_size=4,
               max_blocks_per_seq=4, kv_bits=kv_bits)
    je = JaxEngine(m, **geo)
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    te = LlamaInferenceEngine(from_jax_state(
        state, LlamaConfig(**dataclasses.asdict(m.config)), device="cpu"),
        device="cpu", **geo)
    rng = np.random.default_rng(9)
    names = ["k_cache", "v_cache"] + (["k_scale", "v_scale"]
                                      if kv_bits == 8 else [])
    for n in names:
        t = getattr(te, n)
        if t.dtype == torch.int8:
            arr = rng.integers(-127, 128, t.shape).astype(np.int8)
        else:
            arr = rng.normal(size=t.shape).astype(np.float32)
        t.copy_(torch.from_numpy(arr))
        setattr(je, n, jnp.asarray(arr))
    before = {n: getattr(te, n).clone() for n in names}
    je.copy_kv_block(2, 5)
    te.copy_kv_block(2, 5)
    for n in names:
        got, b = getattr(te, n), before[n]
        assert torch.equal(got[:, 5], b[:, 2]), n
        keep = [i for i in range(8) if i != 5]
        assert torch.equal(got[:, keep], b[:, keep]), n
        np.testing.assert_array_equal(got.numpy(),
                                      np.asarray(getattr(je, n)))


# The trace's time goes to ops over the [40, 32000] logits of every step
# (the head's matmul, the scheduler's finiteness screen) and the plain
# attention; on torch's default of one thread a core in each of six test
# workers it took 100 s in a 6-worker run, about 7 s on one thread
# (`one_thread`, which every test of this file runs under).
def test_prefix_workload_trace_meets_the_card_gates():
    """The card's `serve_prefix` trace (`tools/serve_workload.py`
    `prefix_workload`: 42 requests, a 192-token shared prefix, a pool of
    128 blocks of 16) at a tiny width on the CPU: the scheduler's integer
    outcome the card phase gates on — every request finished with its
    tokens, the same greedy streams with the cache on and off, a trace
    hit rate > 0.6, evictions and copy-on-writes, no preemption, the
    cold run's prefill tokens less the cached run's equal to the hit
    tokens, no leaked block."""
    from paddle_tpu_torch import llama_tiny
    from paddle_tpu_torch.tools import serve_workload as sw

    model = llama_tiny(vocab=32000, layers=1, hidden=32, heads=2, seq=512,
                       num_key_value_heads=1, device="cpu",
                       generator=torch.Generator().manual_seed(0))
    make, shared, trace = sw.prefix_workload(device="cpu", model=model)
    assert len(shared) == sw.PREFIX_LEN and len(trace) == \
        sw.PREFIX_REQUESTS + sw.PREFIX_REPEATS
    assert trace[-1][1] == trace[-2][1] == next(p for _t, p, s in trace if s)
    runs = {}
    for cache in (True, False):
        tserving.ServingMetrics.reset_monitor()
        fe = make(cache)
        tree = fe.scheduler.prefix_cache
        s0 = tree.stats() if tree is not None else None
        pre0 = tmonitor.get("serving.prefill_tokens")
        hs, _steps = sw.drive_prefix_trace(fe, trace)
        assert all(h.status.value == "finished"
                   and len(h.tokens) == sw.PREFIX_NEW for h in hs)
        assert fe.scheduler.kv_leaked_blocks() == 0
        assert tmonitor.get("serving.preemptions") == 0
        d = None
        if tree is not None:
            fe.scheduler.engine.manager.check_consistency(
                external=tree.block_ref_counts())
            st = tree.stats()
            d = {k: st[k] - s0[k] for k in ("hits", "misses", "hit_tokens",
                                             "evictions", "cow_copies")}
        runs[cache] = ([h.tokens for h in hs],
                       tmonitor.get("serving.prefill_tokens") - pre0, d)
    (on, pre_on, d), (off, pre_off, _d) = runs[True], runs[False]
    assert on == off
    assert d["hits"] / (d["hits"] + d["misses"]) > 0.6
    assert d["evictions"] > 0 and d["cow_copies"] > 0
    assert pre_off - pre_on == d["hit_tokens"]
