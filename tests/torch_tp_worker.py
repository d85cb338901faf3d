"""One rank of the gloo world of 4 that `tests/test_torch_tp_serving.py`
spawns (it imports no JAX, so a rank starts in seconds):

    python tests/torch_tp_worker.py RANK WORLD PORT DIR

Reads `DIR/llama.npz` (a tiny Llama's JAX state) and `DIR/llama.json`
(its config), runs every tensor-parallel scenario of the port on
this rank (tp=2 as dp=2 rows {0,1} and {2,3}; tp=4 over the world), and
writes `DIR/rank{RANK}.pkl`: a dict of scenario name -> outcome (raw
logits, token streams, agreements, payload checks, typed errors). Every
rank runs the same scenarios in the same order, so the ranks' groups
and collectives line up.
"""
import datetime
import json
import pickle
import sys
import time

import numpy as np
import torch
import torch.distributed as dist

MLP_KW = dict(vocab_size=64, hidden=16, max_batch_size=4, num_blocks=32,
              block_size=4, max_blocks_per_seq=4, seed=3, device="cpu")


def ragged_batch(step):
    q = np.array([3, 1, 0, 2], np.int32)
    kv = np.array([3 + step, 1 + step, 0, 2 + step], np.int32)
    toks = ((np.arange(8, dtype=np.int32) * 7 + step * 3) % 40 + 1)
    tables = np.arange(16, dtype=np.int32).reshape(4, 4)
    return toks.astype(np.int32), q, kv, tables


def as_np(x):
    return x.numpy() if torch.is_tensor(x) else np.asarray(x)


def run_steps(eng):
    """Three carried ragged steps + one verify window; raw logits (the
    scenario of `tests/test_tp_serving.py`)."""
    outs = [as_np(eng.ragged_step(*ragged_batch(s))) for s in range(3)]
    vt = (np.arange(8, dtype=np.int32) % 30 + 1).reshape(2, 4)
    outs.append(as_np(eng.verify_step(
        vt, np.array([8, 9], np.int32),
        np.arange(8, dtype=np.int32).reshape(2, 4))))
    return outs


def prompts(n=6, vocab=64, seed=0):
    rng = np.random.default_rng(seed)
    return [rng.integers(1, vocab, int(rng.integers(3, 12))).tolist()
            for _ in range(n)]


def spec_prompts():
    rng = np.random.default_rng(0)
    out = []
    for _ in range(5):
        phrase = rng.integers(1, 64, int(rng.integers(2, 4))).tolist()
        out.append((phrase * 5)[:int(rng.integers(6, 13))])
    return out


def cow_prompts():
    """A shared 8-token prefix (two whole blocks) behind 6 prompts, then
    the prefix alone twice: a full hit, which copies its last block."""
    prefix = list(range(1, 9))
    return [prefix + [10 + i] for i in range(6)] + [prefix, prefix]


def serve_tokens(eng, ps, spec=False, max_new=6, prefix_cache=False):
    """Greedy + seeded-stochastic token streams through the frontend;
    with the frontend's books after the run."""
    from paddle_tpu_torch.serving import (NGramProposer, RequestStatus,
                                          ServingFrontend, SpecDecodeConfig)

    fe = ServingFrontend(
        eng, spec=SpecDecodeConfig(NGramProposer(), num_draft_tokens=3)
        if spec else None, prefix_cache=prefix_cache)
    hs = [fe.submit(p, max_new_tokens=max_new,
                    temperature=(0.7 if i % 2 else 0.0), seed=i)
          for i, p in enumerate(ps)]
    fe.run_until_idle(max_steps=4000)
    assert all(h.status is RequestStatus.FINISHED for h in hs), \
        [(h.status, h.finish_reason) for h in hs]
    return [list(h.tokens) for h in hs], fe


def fill(eng, seq_id=0, n=7, seed=1):
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


def raised(call):
    try:
        call()
    except Exception as e:   # noqa: BLE001 - the type is the outcome
        return type(e).__name__, str(e)
    return None


def main(rank, world, port, d):
    from paddle_tpu_torch import (LlamaConfig, LlamaInferenceEngine,
                                  from_jax_state)
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.serving import (MLPLMEngine, ServingFrontend,
                                          greedy_agreement, quantize_engine,
                                          shard_engine)

    torch.set_num_threads(1)         # four ranks share the test's cores
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}",
                            rank=rank, world_size=world,
                            timeout=datetime.timedelta(seconds=60))
    with open(f"{d}/llama.json") as f:
        cfg = LlamaConfig(**json.load(f))
    model = from_jax_state(dict(np.load(f"{d}/llama.npz")), cfg,
                           device="cpu")

    def mlp(kv_bits=16, wbits=None, **over):
        eng = MLPLMEngine(**{**MLP_KW, "kv_bits": kv_bits, **over})
        if wbits is not None:
            quantize_engine(eng, wbits)
        return eng

    def llama(kv_bits=16, wbits=None):
        eng = LlamaInferenceEngine(model, max_batch_size=4, num_blocks=32,
                                   block_size=4, max_blocks_per_seq=4,
                                   kv_bits=kv_bits, device="cpu")
        if wbits is not None:
            quantize_engine(eng, wbits)
        return eng

    def tp2(eng, **kw):
        return shard_engine(eng, tp=2, dp=2, **kw)

    out = {}
    start = time.perf_counter()
    for kv in (16, 8):
        for ov in (True, False):
            eng = tp2(mlp(kv), overlap=ov, overlap_tiles=3)
            out[f"mlp_raw/{kv}/{ov}"] = run_steps(eng)
    seq = tp2(mlp(), overlap=False)
    out["seq_types"] = (
        type(seq.ragged_step(*ragged_batch(0))).__name__,
        type(tp2(mlp()).ragged_step(*ragged_batch(0))).__name__)
    for w, ov in ((8, True), (4, True), (4, False)):
        out[f"mlp_rawq/{w}/{ov}"] = run_steps(
            tp2(mlp(wbits=w), overlap=ov, overlap_tiles=3))
    out["summary"] = tp2(mlp(), overlap_tiles=3).tp_summary()
    for kv, w, ov in ((16, None, True), (8, None, False), (8, 4, True)):
        out[f"mlp_raw4/{kv}/{w}/{ov}"] = run_steps(shard_engine(
            mlp(kv, w), tp=4, overlap=ov, overlap_tiles=3))

    ps = prompts()
    out["tokens/2"], _ = serve_tokens(tp2(mlp()), ps)
    out["tokens/4"], _ = serve_tokens(shard_engine(mlp(), tp=4), ps)
    out["tokens/2/seq"], _ = serve_tokens(tp2(mlp(), overlap=False), ps)
    sp = spec_prompts()
    out["spec"], _ = serve_tokens(tp2(mlp()), sp, spec=True)
    out["plain"], _ = serve_tokens(tp2(mlp()), sp)
    cow_ps = cow_prompts()
    eng = tp2(mlp())
    out["cow"], fe = serve_tokens(eng, cow_ps, prefix_cache=True)
    out["cow_books"] = (fe.scheduler.kv_leaked_blocks(),
                        eng.manager.cow_copies)

    # steady state: a second batch on the same frontend
    fe = ServingFrontend(tp2(mlp(kv_bits=8), overlap_tiles=3))
    for batch in (prompts(3, seed=4), prompts(4, seed=5)):
        hs = [fe.submit(p, max_new_tokens=4) for p in batch]
        fe.run_until_idle(max_steps=2000)
    out["steady"] = ([h.status.value for h in hs], [h.tokens for h in hs],
                     fe.scheduler.kv_leaked_blocks())

    for w in (8, 4):
        out[f"agree/{w}"] = greedy_agreement(
            tp2(mlp(kv_bits=8, wbits=w), overlap_tiles=3),
            mlp(kv_bits=8, wbits=w), ps)
    out["quant_info"] = (tp2(mlp(kv_bits=8, wbits=4)).quant_info(),
                         mlp(kv_bits=8).kv_bytes_per_token())

    for kv, w in ((16, None), (8, None), (16, 8), (8, 4)):
        out[f"llama_raw/{kv}/{w}"] = run_steps(
            tp2(llama(kv, w), overlap_tiles=3))
    out["llama_raw/seq"] = run_steps(tp2(llama(), overlap=False))
    out["llama_agree"] = greedy_agreement(tp2(llama(8, 8)), llama(8, 8),
                                          prompts(4, seed=2))
    out["llama_quant_info"] = (tp2(llama(8, 4)).quant_info(),
                               llama(8, 4).kv_bytes_per_token())

    # sharded KV migration: per-rank slabs round-trip into a second tp=2
    # engine bit for bit; a released session resumes on it
    for kv in (16, 8):
        src = tp2(mlp(kv_bits=kv))
        fill(src, seq_id=0, n=7)
        p = src.extract_kv_blocks(0)
        dst = tp2(mlp(kv_bits=kv))
        dst.inject_kv_blocks(4, p)
        q = dst.extract_kv_blocks(4)
        dst.manager.check_consistency()
        out[f"mig/{kv}"] = (dict(p.header), {k: as_np(v)
                                            for k, v in p.slabs.items()},
                            {k: as_np(v) for k, v in q.slabs.items()})
    prompt = [5, 9, 13, 2, 40, 11]
    fe0 = ServingFrontend(tp2(mlp()), stall_after=256)
    h0 = fe0.submit(prompt, max_new_tokens=8)
    fe0.run_until_idle()
    fe1 = ServingFrontend(tp2(mlp()), stall_after=256)
    h = fe1.submit(prompt, max_new_tokens=8)
    req = h._req
    while len(req.generated) < 3:
        fe1.step()
    carried = list(req.generated)
    payload = fe1.scheduler.engine.extract_kv_blocks(req.seq_id)
    assert fe1.release(h)
    fe2 = ServingFrontend(tp2(mlp()), stall_after=256)
    fe2.import_session(req, payload)
    fe2.run_until_idle()
    out["session"] = (h0.tokens, carried, h.tokens, h.status.value,
                      fe1.scheduler.kv_leaked_blocks(),
                      fe2.scheduler.kv_leaked_blocks())
    src = tp2(mlp())
    fill(src, n=7)
    p = src.extract_kv_blocks(0)
    plain = mlp()
    dst4 = shard_engine(mlp(), tp=4)
    free0 = dst4.manager.free_blocks
    out["mig_mismatch"] = (raised(lambda: plain.inject_kv_blocks(0, p)),
                           raised(lambda: dst4.inject_kv_blocks(0, p)),
                           free0, dst4.manager.free_blocks,
                           plain.manager.free_blocks)

    # lockstep: the second rank of each tp group dispatches other tokens;
    # every rank must raise the typed error, none may hang
    eng = tp2(mlp())
    toks, q, kv, tables = ragged_batch(0)
    if eng.tp_index == 1:
        toks = toks + 1
    t0 = time.perf_counter()
    out["lockstep"] = (raised(lambda: eng.ragged_step(toks, q, kv, tables)),
                       time.perf_counter() - t0)
    # ... and the group still serves in step afterwards
    out["after_lockstep"] = as_np(eng.ragged_step(*ragged_batch(1)))

    # the monitor's cross-host aggregation gathers over the world when
    # given no snapshots: each rank contributes its own counter and wall
    monitor.reset_prefix("tpw.")
    monitor.inc("tpw.requests", rank + 1)
    monitor.set_gauge("tpw.step_wall_ms", 10.0 * (rank + 1))
    out["aggregate"] = (
        monitor.snapshot("tpw.", include_histograms=False),
        monitor.aggregate_mesh("tpw.", step_wall_key="tpw.step_wall_ms"))

    out["seconds"] = time.perf_counter() - start
    with open(f"{d}/rank{rank}.pkl", "wb") as f:
        pickle.dump(out, f)
    dist.barrier()
    dist.destroy_process_group()


if __name__ == "__main__":
    main(int(sys.argv[1]), int(sys.argv[2]), int(sys.argv[3]), sys.argv[4])
