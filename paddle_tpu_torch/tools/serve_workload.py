"""The serving workloads of the port's main path, in one place: both
`chip_smoke.py` (which times them) and `paddle_tpu_torch.tools.serve_profile`
(which profiles them) build them here, so the two always measure the same
thing.

Llama-2-7B width at its full 32 layers in bf16, random weights from a
seed; 8 lanes, a pool of 1024 blocks of 16 tokens, up to 128 blocks per
sequence, chunked prefill of 32 tokens. The requests are 8 prompts of
64-512 tokens from `numpy.random.default_rng(0)`, each asking for 32 new
tokens: 6 greedy, 2 sampled at temperature 0.8, top-k 50. The quantized
modes serve the same traffic: `kv_bits=8` builds an int8 KV pool, and
`wbits=8|4` runs `serving.quant.quantize_engine` on the built engine
(the JAX package's `serving_quant` mode is `kv_bits=8, wbits=8`).

`spec="ngram"|"draft"` serves speculatively with K = 4 drafts
(`bench.py serving_spec`'s default K): `NGramProposer()`, or
`DraftEngineProposer` over a second engine holding the target's own
weights (a self-draft: random weights have no smaller model that agrees
with them). Each prompt then repeats a phrase of 3-5 random tokens to its
length, the repetition-heavy trace of `bench.py serving_spec`, at the same
lengths and sampling as the plain workload.

`generate_workload` is `LlamaInferenceEngine.generate` on the same
seed-0 weights: 2 prompts of 128 tokens, 16 new greedy tokens.

`prefix_workload` is `bench.py serving_shared_prefix`'s trace at this
width, for the prefix cache: a shared prefix of 192 tokens; 24 requests
from `numpy.random.default_rng(0)`, 80 % of them the shared prefix + 8-16
unique tokens and 20 % cold at the same length, plus two exact repeats
of the first shared request's prompt (a "regenerate": a full hit and a
copy-on-write); 8 greedy new tokens each; a pool of 128 blocks of 16
slots (bench.py's 256 x 8: the same 2,048 slots, which the trace
outgrows, so the tree must evict), 22 blocks a sequence. Requests arrive
by scheduler step (`drive_prefix_trace`), from bench.py's exponential
gaps at one request a step on average, never by wall clock, so the runs
with the cache on and off see one trace. Each frontend first serves two
short warm-up requests and the shared prompt alone (bench.py seeds the
cache with it the same way).

`lora_workload` is `bench.py serving_lora`'s mix at this width: 36
tenant adapters `ad0..ad35` (`serving.lora.random_adapter(seed=i)`, ranks
cycling 2, 3, 4, 6, 8, rank buckets (2, 4, 8)) on one engine with 40
pool slots; 72 requests of 12-token prompts from
`numpy.random.default_rng(0)` over the model's vocabulary, request i on
adapter `ad{i % 36}`, 8 greedy new tokens each, arriving by scheduler
step from bench.py's exponential gaps (scaled to one request a step on
average, as `prefix_trace` does).

`migrate_workload` is KV migration at this width: the serve workload's 8
prompts (64-512 tokens), greedy, handed from one engine to another
after their prefill and 4 decode tokens (`drive_migration`), and the
prefix trace's shared prefix streamed between two prefix-cached
schedulers.

`fleet_workload` is the serve workload over a fleet of `FLEET_REPLICAS`
replicas (`serving.FleetRouter`, `serving.DisaggRouter`): each replica's
engine is built once, on the seed-0 weights, with its own pool of 1024
blocks of 16 slots, and served one warm-up request; `hand_out()` gives
a router an engine factory that hands those engines out in order (and
builds a fresh engine on fresh seed-0 weights when asked for more, as a
replica's watchdog does to rebuild its engine). `retire(router)` closes
a router and frees the guard blocks its live and drained replicas
leased, so the next router over the same engines starts from empty
pools.
"""
from __future__ import annotations

import numpy as np
import torch

# serving geometry
LAYERS, B, BS, NB, MAXB, CHUNK = 32, 8, 16, 1024, 128, 32
NEW_TOKENS = 32
SPEC_K = 4
# generate: prompts x tokens, new tokens
GEN_PROMPTS, GEN_LEN, GEN_NEW = 2, 128, 16
# the shared-prefix trace: prefix tokens, requests, repeats, new tokens,
# and its pool (blocks, blocks a sequence)
PREFIX_LEN, PREFIX_REQUESTS, PREFIX_REPEATS, PREFIX_NEW = 192, 40, 2, 8
PREFIX_NB, PREFIX_MAXB = 128, 22
# the multi-LoRA mix (bench.py serving_lora): adapters, their ranks and
# rank buckets, pool slots, prompt tokens, new tokens, and the adapters
# the per-adapter parity gate serves on a dedicated wrapper
LORA_ADAPTERS, LORA_RANKS, LORA_BUCKETS = 36, (2, 3, 4, 6, 8), (2, 4, 8)
LORA_SLOTS, LORA_PROMPT, LORA_NEW = 40, 12, 8
LORA_PARITY = ("ad0", "ad7", "ad23")
# KV migration: new tokens, and the tokens a request has generated (its
# first token and 4 decode tokens) when it moves
MIGRATE_NEW, MIGRATE_AT = 12, 5
# the fleet: replicas over the serve workload
FLEET_REPLICAS = 2


def _model(device):
    from .. import llama_7b_shaped

    return llama_7b_shaped(num_layers=LAYERS, device=device,
                           dtype=torch.bfloat16,
                           generator=torch.Generator(
                               device=device).manual_seed(0))


def _engine(model, device, kv_bits=16, max_batch_size=B):
    from .. import LlamaInferenceEngine

    return LlamaInferenceEngine(model, max_batch_size=max_batch_size,
                                num_blocks=NB, block_size=BS,
                                max_blocks_per_seq=MAXB, kv_bits=kv_bits,
                                device=device)


def serve_workload(device="cuda", kv_bits=16, wbits=None, spec=None):
    """Build the engine (`kv_bits` 16 or 8; `wbits` None, 8 or 4 for
    `quantize_engine`; `spec` None, "ngram" or "draft") and its frontend
    on `device`, serve one short warm-up request (cuBLAS handles, first
    launches), and return `(frontend, requests)`, where `requests` is a
    list of `(prompt, submit_kwargs)` not yet submitted."""
    from .. import ServingFrontend
    from ..serving import DraftEngineProposer, NGramProposer, SpecDecodeConfig
    from ..serving.quant import quantize_engine

    if spec not in (None, "ngram", "draft"):
        raise ValueError(f"spec must be None, 'ngram' or 'draft', got "
                         f"{spec!r}")
    model = _model(device)
    engine = _engine(model, device, kv_bits)
    config = None
    if spec == "ngram":
        config = SpecDecodeConfig(NGramProposer(), SPEC_K)
    elif spec == "draft":
        # the proposer drives one sequence at a time; its pool holds every
        # in-flight context. The draft engine shares every weight the
        # target shares with the model (o, down, norms, embedding, head)
        # and concatenates its own q/k/v and gate/up.
        config = SpecDecodeConfig(
            DraftEngineProposer(_engine(model, device, max_batch_size=1)),
            SPEC_K)
    del model                     # the engines hold what they serve
    if wbits is not None:
        quantize_engine(engine, wbits)
    fe = ServingFrontend(engine, prefill_chunk_tokens=CHUNK, spec=config)
    warm_up(fe)
    return fe, serve_requests(spec)


def serve_engine(device="cuda", kv_bits=16, wbits=None):
    """The serve workload's engine alone (`kv_bits` 16 or 8; `wbits` None,
    8 or 4), on `device`, with no frontend: the base engine each rank of
    a tensor-parallel run shards (`serving.tp.shard_engine`)."""
    from ..serving.quant import quantize_engine

    model = _model(device)
    engine = _engine(model, device, kv_bits)
    del model
    if wbits is not None:
        quantize_engine(engine, wbits)
    return engine


def warm_up(fe):
    """Serve one short request to idle (cuBLAS handles, first launches)."""
    fe.submit(list(range(1, 17)), max_new_tokens=2)
    fe.run_until_idle()


def serve_requests(spec=None):
    """The serve workload's 8 requests, `(prompt, submit_kwargs)` each:
    prompts of 64-512 tokens from `numpy.random.default_rng(0)` (with
    `spec`, a repeated phrase of 3-5 tokens), 32 new tokens, the first 6
    greedy and the last 2 sampled at temperature 0.8, top-k 50."""
    rng = np.random.default_rng(0)
    lens = rng.integers(64, 513, B)
    prompts = []
    for n in lens:
        if spec is None:
            prompts.append(rng.integers(1, 32000, n).tolist())
        else:
            phrase = rng.integers(1, 32000, int(rng.integers(3, 6)))
            prompts.append(np.resize(phrase, n).tolist())
    return [(p, dict(max_new_tokens=NEW_TOKENS,
                     **({} if i < 6 else dict(temperature=0.8, top_k=50,
                                              seed=i))))
            for i, p in enumerate(prompts)]


def generate_workload(device="cuda"):
    """Build the engine on `device` (the serve workload's weights and
    pool) and return `(engine, prompts [GEN_PROMPTS, GEN_LEN] int32,
    GenerationConfig)` for `engine.generate`: greedy, `GEN_NEW` new
    tokens, prompts from `numpy.random.default_rng(0)`."""
    from ..inference import GenerationConfig

    model = _model(device)
    engine = _engine(model, device)
    del model
    prompts = np.random.default_rng(0).integers(
        1, 32000, (GEN_PROMPTS, GEN_LEN)).astype(np.int32)
    return engine, prompts, GenerationConfig(max_new_tokens=GEN_NEW)


def prefix_trace(vocab: int = 32000):
    """The shared-prefix trace: `(shared_prefix, [(arrival_step, prompt,
    is_shared), ...])` in arrival order (bench.py's draws, in its order,
    then the repeats and the step gaps)."""
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, PREFIX_LEN).tolist()
    specs = []
    for _ in range(PREFIX_REQUESTS):
        sfx = rng.integers(8, 17)
        if rng.random() < 0.8:
            specs.append((True, shared + rng.integers(1, vocab,
                                                      sfx).tolist()))
        else:
            specs.append((False, rng.integers(1, vocab,
                                              PREFIX_LEN + sfx).tolist()))
    first = next(p for is_shared, p in specs if is_shared)
    specs += [(True, list(first))] * PREFIX_REPEATS
    steps = np.floor(np.cumsum(rng.exponential(1.0, len(specs)))).astype(int)
    return shared, [(int(t), p, s) for t, (s, p) in zip(steps, specs)]


def prefix_workload(device="cuda", kv_bits=16, model=None):
    """`(make_frontend, shared_prefix, trace)` for the shared-prefix
    trace. `make_frontend(prefix_cache)` builds a fresh engine (`kv_bits`
    16 or 8) over one model — `model`, or the serve workload's seed-0
    Llama-2-7B-width weights built once on `device` — and its frontend,
    and serves the warm-up (two short requests, then the shared prompt,
    2 tokens each) to idle. The frontends of one call share the model's
    weights."""
    from .. import LlamaInferenceEngine, ServingFrontend

    if model is None:
        model = _model(device)
    vocab = model.config.vocab_size
    shared, trace = prefix_trace(vocab)
    warm = np.random.default_rng(1)

    def make_frontend(prefix_cache: bool):
        engine = LlamaInferenceEngine(
            model, max_batch_size=B, num_blocks=PREFIX_NB, block_size=BS,
            max_blocks_per_seq=PREFIX_MAXB, kv_bits=kv_bits, device=device)
        fe = ServingFrontend(engine, prefill_chunk_tokens=CHUNK,
                             prefix_cache=prefix_cache)
        for n in (3, 17):
            fe.submit(warm.integers(1, vocab, n).tolist(), max_new_tokens=2)
        fe.submit(shared, max_new_tokens=2)
        fe.run_until_idle()
        return fe

    return make_frontend, shared, trace


def drive_prefix_trace(fe, trace, max_steps: int = 10000):
    """Submit each request at its arrival step (greedy, `PREFIX_NEW` new
    tokens) and step the frontend until every request is terminal.
    Returns `(handles, scheduler_steps)`."""
    handles, i, steps = [], 0, 0
    while i < len(trace) or not fe.scheduler.idle:
        while i < len(trace) and trace[i][0] <= steps:
            handles.append(fe.submit(trace[i][1],
                                     max_new_tokens=PREFIX_NEW))
            i += 1
        fe.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"trace not done after {max_steps} steps")
    return handles, steps


def lora_trace(vocab: int = 32000):
    """The multi-LoRA mix: `[(arrival_step, prompt, adapter), ...]` in
    arrival order (bench.py's draws in its order: the prompts, then the
    exponential gaps, here in steps)."""
    rng = np.random.default_rng(0)
    n = 2 * LORA_ADAPTERS
    prompts = [rng.integers(1, vocab, LORA_PROMPT).tolist()
               for _ in range(n)]
    gap = 0.002                       # bench.py's mean gap, in seconds
    steps = np.floor(np.cumsum(rng.exponential(gap, n) / gap)).astype(int)
    return [(int(t), p, f"ad{i % LORA_ADAPTERS}")
            for i, (t, p) in enumerate(zip(steps, prompts))]


def lora_adapters(engine):
    """The mix's host factors on a LoRA-wrapped engine's targets:
    `{name: factors}` for `ad0..ad35` (rank `LORA_RANKS[i % 5]`, seed i),
    registered as they are into every wrapper of one width."""
    from ..serving.lora import random_adapter

    return {f"ad{i}": random_adapter(
        engine, rank=LORA_RANKS[i % len(LORA_RANKS)], seed=i)
        for i in range(LORA_ADAPTERS)}


def lora_workload(device="cuda", kv_bits=16, wbits=None):
    """`(base_engine, attach, trace)` for the multi-LoRA mix: the serve
    workload's engine (`kv_bits` 16 or 8; `wbits` None, 8 or 4 for
    `quantize_engine`) on `device`; `attach(pool_slots, factors)` wraps
    it in a `LoRAEngine` (own KV pools, rank buckets `LORA_BUCKETS`) and
    registers `factors` (`{name: factors}`, e.g. `lora_adapters`'s); and
    the trace (`lora_trace`)."""
    from ..serving import attach_adapters
    from ..serving.quant import quantize_engine

    model = _model(device)
    engine = _engine(model, device, kv_bits)
    del model
    if wbits is not None:
        quantize_engine(engine, wbits)

    def attach(pool_slots, factors):
        lora = attach_adapters(engine, pool_slots=pool_slots,
                               rank_buckets=LORA_BUCKETS)
        for name, f in factors.items():
            lora.adapter_pool.register(name, f)
        return lora

    return engine, attach, lora_trace(engine.config.vocab_size)


def drive_lora_trace(fe, trace, adapters=True, max_steps: int = 10000):
    """Submit each request of `trace` at its arrival step (greedy,
    `LORA_NEW` new tokens; on its adapter, or on none with
    `adapters=False`) and step `fe` until every request is terminal.
    Returns `(handles, scheduler_steps)`."""
    handles, i, steps = [], 0, 0
    while i < len(trace) or not fe.scheduler.idle:
        while i < len(trace) and trace[i][0] <= steps:
            handles.append(fe.submit(
                trace[i][1], max_new_tokens=LORA_NEW,
                adapter=trace[i][2] if adapters else None))
            i += 1
        fe.step()
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"trace not done after {max_steps} steps")
    return handles, steps


def migrate_workload(device="cuda", kv_bits=16):
    """`(engine, prompts, make_prefix_frontend, shared_prefix,
    shared_prompt)` for KV migration: the serve workload's engine
    (`kv_bits` 16 or 8) and its 8 prompts; `make_prefix_frontend()`
    builds a prefix-cached frontend over a fresh engine of the prefix
    trace's pool on the same weights (two short warm-up requests served);
    the prefix trace's shared prefix and its first shared prompt."""
    from .. import LlamaInferenceEngine, ServingFrontend

    model = _model(device)
    engine = _engine(model, device, kv_bits)
    vocab = model.config.vocab_size
    rng = np.random.default_rng(0)
    prompts = [rng.integers(1, vocab, n).tolist()
               for n in rng.integers(64, 513, B)]
    shared, trace = prefix_trace(vocab)
    first = next(p for _t, p, is_shared in trace if is_shared)
    warm = np.random.default_rng(1)

    def make_prefix_frontend():
        eng = LlamaInferenceEngine(
            model, max_batch_size=B, num_blocks=PREFIX_NB, block_size=BS,
            max_blocks_per_seq=PREFIX_MAXB, kv_bits=kv_bits, device=device)
        fe = ServingFrontend(eng, prefill_chunk_tokens=CHUNK,
                             prefix_cache=True)
        for n in (3, 17):
            fe.submit(warm.integers(1, vocab, n).tolist(), max_new_tokens=2)
        fe.run_until_idle()
        return fe

    return engine, prompts, make_prefix_frontend, shared, first


def drive_migration(fe_src, fe_dst, prompts, max_steps: int = 10000):
    """Serve `prompts` (greedy, `MIGRATE_NEW` new tokens) on `fe_src`; as
    soon as a request has generated `MIGRATE_AT` tokens, move it: extract
    its blocks from the source engine, `release` it there, and
    `import_session` it into `fe_dst`, which finishes it. Returns the
    handles."""
    src = fe_src.scheduler.engine
    handles = [fe_src.submit(p, max_new_tokens=MIGRATE_NEW)
               for p in prompts]
    moved, steps = set(), 0
    while not (fe_src.scheduler.idle and fe_dst.scheduler.idle):
        fe_src.step()
        fe_dst.step()
        for h in handles:
            req = h._req
            if h.request_id in moved or req.status.terminal \
                    or len(req.generated) < MIGRATE_AT:
                continue
            payload = src.extract_kv_blocks(req.seq_id)
            if not fe_src.release(h):
                raise RuntimeError(f"request {h.request_id} not released")
            fe_dst.import_session(req, payload)
            moved.add(h.request_id)
        steps += 1
        if steps > max_steps:
            raise RuntimeError(f"migration not done after {max_steps} "
                               "steps")
    return handles


def fleet_workload(device="cuda"):
    """`(hand_out, engines, requests)` for the fleet: `FLEET_REPLICAS`
    bf16 engines built once on one seed-0 model, each served the
    warm-up request through a throwaway frontend whose guard block is
    then freed; `hand_out()` returns a new engine factory for one router
    (the built engines in order, then fresh ones); and the serve
    workload's requests (`serve_requests`)."""
    from .. import ServingFrontend

    model = _model(device)
    engines = [_engine(model, device) for _ in range(FLEET_REPLICAS)]
    del model                     # the engines hold what they serve
    for engine in engines:
        fe = ServingFrontend(engine, prefill_chunk_tokens=CHUNK)
        warm_up(fe)
        engine.manager.free(fe.scheduler._pad_seq_id)

    def hand_out():
        queue = list(engines)

        def factory():
            return queue.pop(0) if queue else serve_engine(device)

        return factory

    return hand_out, engines, serve_requests()


def retire(router):
    """Close `router` and free the guard block each live or drained
    replica's scheduler leased on its engine (a dead replica's pool is
    left as its death left it)."""
    router.close()
    for rep in router.replicas:
        if rep.alive or rep.death_reason == "drained":
            sch = rep.scheduler
            sch.engine.manager.free(sch._pad_seq_id)
