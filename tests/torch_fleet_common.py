"""Shared pieces of the fleet and disaggregation parity tests
(`test_torch_fleet.py`, `test_torch_disagg.py`): the tiny MLP engine of
the JAX suites `test_serving_fleet.py` / `test_serving_disagg.py` on both
packages, one JAX engine pool per test module, and the comparison of one
scenario's outcome across the packages.

The JAX engines are built once per module and handed out again with a
fresh block manager (a jitted JAX engine retraces per instance; the pool
contents a fresh manager points at are written before they are read).
The port's engines are built per scenario, on the CPU, with the JAX
engine's weights (`mlp_from_jax_params`)."""
from types import SimpleNamespace

import numpy as np

import paddle_tpu.serving as jserving
from paddle_tpu import observability as jobs
from paddle_tpu.framework import monitor as jmonitor
from paddle_tpu.inference.cache import BlockCacheManager as JaxManager
from paddle_tpu.resilience import faults as jfaults
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import mlp_from_jax_params
from paddle_tpu_torch import observability as tobs
from paddle_tpu_torch.framework import monitor as tmonitor
from paddle_tpu_torch.observability import timeline as ttimeline
from paddle_tpu_torch.resilience import faults as tfaults

VOCAB = 64
MLP_KW = dict(vocab_size=VOCAB, hidden=16, max_batch_size=4, num_blocks=48,
              block_size=4, max_blocks_per_seq=8, seed=0)


class JaxEnginePool:
    """The JAX `MLPLMEngine`s of one test module: `factory()` hands out
    engine 0, 1, 2, ... of the pool (built on first use), each with a
    fresh block manager; `reset()` starts the next scenario at engine 0."""

    def __init__(self):
        self._engines = []
        self._next = 0

    def reset(self):
        self._next = 0

    def factory(self):
        if self._next >= len(self._engines):
            self._engines.append(jserving.MLPLMEngine(**MLP_KW))
            self._next += 1
            return self._engines[-1]
        eng = self._engines[self._next]
        self._next += 1
        old = eng.manager
        eng.manager = JaxManager(old.num_blocks, old.block_size,
                                 old.max_blocks_per_seq)
        eng.manager.set_kv_geometry(old.bytes_per_block, old.kv_bits)
        return eng

    def params(self):
        if not self._engines:
            self._engines.append(jserving.MLPLMEngine(**MLP_KW))
        return {k: np.asarray(v) for k, v in self._engines[0].params.items()}


def port_factory(pool: JaxEnginePool):
    def make():
        eng = tserving.MLPLMEngine(**MLP_KW, device="cpu")
        return mlp_from_jax_params(pool.params(), eng)
    return make


def packages(pool: JaxEnginePool):
    jax = SimpleNamespace(name="jax", s=jserving, monitor=jmonitor,
                          faults=jfaults, obs=jobs, timeline=jobs.timeline,
                          make_engine=pool.factory)
    port = SimpleNamespace(name="port", s=tserving, monitor=tmonitor,
                           faults=tfaults, obs=tobs, timeline=ttimeline,
                           make_engine=port_factory(pool))
    return jax, port


def fresh(p, pool=None):
    """Counters, fault rules and the timeline ring of package `p`
    cleared (and the JAX engine pool rewound)."""
    p.faults.clear()
    p.s.ServingMetrics.reset_monitor()
    for prefix in ("fleet.", "elastic.", "mesh."):
        p.monitor.reset_prefix(prefix)
    p.timeline.reset()
    if pool is not None:
        pool.reset()


def both(pool, scenario, *args):
    """`scenario(pkg, *args)` on each package with its timeline on,
    counters and faults fresh for each; the outcomes must be equal.
    Returns the JAX package's."""
    out = {}
    for p in packages(pool):
        fresh(p, pool)
        p.obs.enable()
        try:
            out[p.name] = scenario(p, *args)
        finally:
            p.obs.disable()
            p.faults.clear()
    assert out["port"] == out["jax"]
    return out["jax"]


def prompts(n=8, seed=0, lo=2, hi=10):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, VOCAB, int(rng.integers(lo, hi))).tolist()
            for _ in range(n)]


def reference_tokens(p, ps, max_new=6):
    """Single-frontend greedy reference on package `p`."""
    fe = p.s.ServingFrontend(p.make_engine())
    hs = [fe.submit(x, max_new_tokens=max_new) for x in ps]
    fe.run_until_idle()
    assert all(h.status.value == "finished" for h in hs)
    return [h.tokens for h in hs]


def fleet_counters(p):
    """The non-zero `fleet.*` counters and gauges."""
    return {k: v for k, v in p.monitor.snapshot("fleet.").items() if v}


def handle_outcome(hs):
    """Per request: tokens, status, reason, replica, relocations and the
    names of its timeline events, in order."""
    return [(h.tokens, h.status.value, h.finish_reason, h.replica_id,
             h.num_relocations, [e["name"] for e in h.timeline()])
            for h in hs]
