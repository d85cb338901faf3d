"""Tensor-parallel serving on both packages: the scenarios of
`tests/test_tp_serving.py` (but `TestRowParallelOverlapTiles`, the
train-side layer, and `cost_card_args`) and the sharded round trips of
`tests/test_kv_migrate.py::TestShardedRoundTrip`, on the port's
`shard_engine` / `ShardedEngine` (`device="cpu"`).

The port runs one process per rank. One spawn in total: a module-scoped
gloo world of 4 running `tests/torch_tp_worker.py` (no JAX), where tp=2
runs on the dp=2 rows {0, 1} and {2, 3} and tp=4 on the world; tp=1 runs
here, with no process group. While the world runs, this process computes
the JAX references once each: the JAX package's `shard_engine` on the
8-virtual-device CPU mesh for every MLP configuration and the dense
kv16 Llama one (overlap mode), the JAX unsharded Llama engine for the
other Llama configurations (the JAX suite's TP tolerance). Every rank
is also held to the unsharded port, and all ranks to each other (the
lockstep invariant: the same streams on every rank).

Tolerances: TP changes the order of every row-parallel sum, so sharded
against unsharded logits is the JAX suite's `allclose(2e-4)` with equal
argmax; the port's ranks against JAX's shards, both f32 in the same
layout, within 1e-5. tp=1 is held to the unsharded port with the tp>1
tolerance (the JAX suite's bitwise tp=1 claims fail on the reference
side and are not the port's contract).
"""
import dataclasses
import json
import os
import pickle
import socket
import subprocess
import sys

import numpy as np
import pytest
import torch

import paddle_tpu as paddle
import paddle_tpu.serving as jserving
from paddle_tpu.distributed.process_mesh import ProcessMesh as JaxMesh
from paddle_tpu.inference import LlamaInferenceEngine as JaxLlamaEngine
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
import paddle_tpu_torch.serving as tserving
from paddle_tpu_torch import LlamaConfig, LlamaInferenceEngine, from_jax_state
from paddle_tpu_torch.distributed import (ProcessMesh, out_features,
                                          row_parallel_matmul,
                                          slice_out_channels)
from paddle_tpu_torch.inference.kv_migrate import KVMigrationError
from paddle_tpu_torch.serving import tp as ttp

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, os.path.join(REPO, "tests"))
import torch_tp_worker as W  # noqa: E402

MLP_KW = {k: v for k, v in W.MLP_KW.items() if k != "device"}
TP_TOL = 2e-4      # sharded vs unsharded (the JAX suite's)
JAX_TOL = 1e-5     # the port's ranks vs the JAX package's shards
RANKS = 4
WORLD_TIMEOUT_S = 240
LLAMA_CASES = ((16, None), (8, None), (16, 8), (8, 4))


def _jmlp(kv_bits=16, wbits=None, **over):
    eng = jserving.MLPLMEngine(**{**MLP_KW, "kv_bits": kv_bits, **over})
    if wbits is not None:
        jserving.quantize_engine(eng, wbits)
    return eng


def _tmlp(kv_bits=16, wbits=None, **over):
    eng = tserving.MLPLMEngine(**{**W.MLP_KW, "kv_bits": kv_bits, **over})
    if wbits is not None:
        tserving.quantize_engine(eng, wbits)
    return eng


def _llama_geo(kv_bits):
    return dict(max_batch_size=4, num_blocks=32, block_size=4,
                max_blocks_per_seq=4, kv_bits=kv_bits)


def _jllama(model, kv_bits=16, wbits=None):
    eng = JaxLlamaEngine(model, **_llama_geo(kv_bits))
    if wbits is not None:
        jserving.quantize_engine(eng, wbits)
    return eng


def _tllama(model, kv_bits=16, wbits=None):
    eng = LlamaInferenceEngine(model, device="cpu", **_llama_geo(kv_bits))
    if wbits is not None:
        tserving.quantize_engine(eng, wbits)
    return eng


def _jax_serve(eng, prompts):
    """`W.serve_tokens` on the JAX package's frontend."""
    fe = jserving.ServingFrontend(eng)
    hs = [fe.submit(p, max_new_tokens=6,
                    temperature=(0.7 if i % 2 else 0.0), seed=i)
          for i, p in enumerate(prompts)]
    fe.run_until_idle(max_steps=4000)
    assert all(h.status is jserving.RequestStatus.FINISHED for h in hs)
    return [list(h.tokens) for h in hs]


def _close(a, b, tol):
    for x, y in zip(a, b, strict=True):
        x, y = np.asarray(x), np.asarray(y)
        assert x.shape == y.shape
        np.testing.assert_allclose(x, y, atol=tol, rtol=tol)
        assert (np.argmax(x, -1) == np.argmax(y, -1)).all()


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


@pytest.fixture(scope="module")
def world(tmp_path_factory):
    """Spawn the gloo world of 4, compute the JAX references while it
    runs, and return (jax references, each rank's outcomes, the two
    packages' tiny Llama models)."""
    d = tmp_path_factory.mktemp("tp_world")
    paddle.seed(7)
    jm = jax_llama_tiny(vocab=64, layers=2, hidden=32, heads=4, seq=64,
                        num_key_value_heads=2)
    jm.eval()
    state = {k: np.asarray(v) for k, v in state_arrays(jm).items()}
    cfg = dataclasses.asdict(jm.config)
    np.savez(d / "llama.npz", **state)
    (d / "llama.json").write_text(json.dumps(cfg))
    port = _free_port()
    env = dict(os.environ, PYTHONPATH=REPO)
    procs = [subprocess.Popen(
        [sys.executable, os.path.join(REPO, "tests", "torch_tp_worker.py"),
         str(r), str(RANKS), str(port), str(d)], cwd=REPO, env=env,
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
        for r in range(RANKS)]
    try:
        # overlap mode only: the sequential mode's logits differ from it
        # by the order of one reduction, within JAX_TOL
        ref = {}
        for kv in (16, 8):
            ref[f"mlp_raw/{kv}"] = W.run_steps(jserving.shard_engine(
                _jmlp(kv), tp=2, overlap_tiles=3))
        for w in (8, 4):
            ref[f"mlp_rawq/{w}"] = W.run_steps(jserving.shard_engine(
                _jmlp(wbits=w), tp=2, overlap_tiles=3))
        ref["tokens/2"] = _jax_serve(jserving.shard_engine(_jmlp(), tp=2),
                                     W.prompts())
        ref["llama_raw/16/None"] = W.run_steps(jserving.shard_engine(
            _jllama(jm), tp=2, overlap_tiles=3))
        for kv, w in LLAMA_CASES[1:]:
            ref[f"llama_raw/{kv}/{w}"] = W.run_steps(_jllama(jm, kv, w))
        logs = [p.communicate(timeout=WORLD_TIMEOUT_S)[0] for p in procs]
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    assert all(p.returncode == 0 for p in procs), "\n".join(logs)
    ranks = []
    for r in range(RANKS):
        with open(d / f"rank{r}.pkl", "rb") as f:
            ranks.append(pickle.load(f))
    tm = from_jax_state(state, LlamaConfig(**cfg), device="cpu")
    return ref, ranks, (jm, tm)


# ---------------------------------------------------------------------------
# layout arithmetic and the distributed helpers (no world)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("sizes,tp", [([8, 4, 4], 2), ([32, 16, 16], 4),
                                      ([6, 6], 3), ([16, 16], 1)])
def test_interleave_perm_matches_the_jax_helper(sizes, tp):
    from paddle_tpu.serving import tp as jtp

    np.testing.assert_array_equal(ttp._interleave_perm(sizes, tp),
                                  jtp._interleave_perm(sizes, tp))


@pytest.mark.parametrize("fmt", ["dense", "int8", "int4"])
@pytest.mark.parametrize("tp", [2, 4])
def test_shard_rows_and_cols_match_the_jax_helpers(fmt, tp):
    """The row preparation (int4: unpack, permute, repack per shard
    chunk) and the column permutation give the JAX helpers' arrays."""
    import jax.numpy as jnp

    from paddle_tpu.serving import tp as jtp

    rng = np.random.default_rng(tp)
    k, n = 32, 24
    perm = jtp._interleave_perm([k // 2, k // 2], tp)
    cperm = jtp._interleave_perm([n // 2, n // 2], tp)
    if fmt == "dense":
        w = rng.normal(size=(k, n)).astype(np.float32)
        jw, tw = jnp.asarray(w), torch.tensor(w)
    else:
        q = rng.integers(-8 if fmt == "int4" else -127,
                         8 if fmt == "int4" else 128, (n, k)).astype(np.int8)
        s = rng.random(n).astype(np.float32)
        if fmt == "int4":
            from paddle_tpu.nn.quant import pack_int4 as jpack

            q = np.asarray(jpack(jnp.asarray(q)))
        key = "q4" if fmt == "int4" else "q"
        jw = {key: jnp.asarray(q), "s": jnp.asarray(s)}
        tw = {key: torch.tensor(q), "s": torch.tensor(s)}

    def same(a, b):
        if isinstance(a, dict):
            assert set(a) == set(b)
            for key in a:
                np.testing.assert_array_equal(np.asarray(a[key]),
                                              b[key].numpy())
        else:
            np.testing.assert_array_equal(np.asarray(a), b.numpy())

    same(jtp._shard_rows(jw, tp, perm), ttp._shard_rows(tw, tp, perm))
    same(jtp._permute_cols(jw, cperm), ttp._permute_cols(tw, cperm))


def test_process_mesh_matches_the_jax_mesh():
    ids = np.arange(8).reshape(2, 4)
    j, t = JaxMesh(ids, ["dp", "tp"]), ProcessMesh(ids, ["dp", "tp"])
    assert (t.shape, t.ndim, t.size, t.process_ids, t.dim_names) == \
        (j.shape, j.ndim, j.size, j.process_ids, j.dim_names)
    assert t.get_dim_size("tp") == j.get_dim_size("tp") == 4
    for pid in (0, 5, 9):
        for dim in ("dp", "tp"):
            assert t.get_rank_by_dim_and_process_id(dim, pid) == \
                j.get_rank_by_dim_and_process_id(dim, pid)
    for sub_t, sub_j in ((t.get_mesh_with_dim("tp"),
                          j.get_mesh_with_dim("tp")),
                         (t.get_mesh_with_dim("tp", 1),
                          j.get_mesh_with_dim("tp", 1)),
                         (t[1], j[1]), (t[0, 2], j[0, 2]),
                         (t[:, 1:], j[:, 1:])):
        assert (sub_t.shape, sub_t.process_ids, sub_t.dim_names) == \
            (sub_j.shape, sub_j.process_ids, sub_j.dim_names)
    assert t == ProcessMesh(ids, ["dp", "tp"]) and t != t[0]
    assert hash(t) == hash(ProcessMesh(ids.copy(), ["dp", "tp"]))
    assert repr(t) == repr(j)
    desc = t.describe()
    assert (desc["shape"], desc["dim_names"], desc["size"],
            desc["processes"]) == ([2, 4], ["dp", "tp"], 8, 1)
    with pytest.raises(ValueError, match="duplicate"):
        ProcessMesh([[0, 1]], ["x", "x"])


def test_row_parallel_matmul_tiles_and_slices():
    """No group: the tiled product is the untiled one within f32
    rounding (BLAS blocks a narrower product differently; tiles clamp to
    the largest divisor of N: 4 -> 3 for N = 9), for dense weights and
    for a quantized dict, whose tiles are views of whole weight rows."""
    from paddle_tpu_torch.inference.llama_runner import _mm, quantize_weight

    g = torch.Generator().manual_seed(0)
    x = torch.randn(5, 12, generator=g)
    w = torch.randn(12, 9, generator=g)
    full = row_parallel_matmul(x, w)
    for tiles in (3, 4):
        np.testing.assert_allclose(
            row_parallel_matmul(x, w, ntiles=tiles).numpy(), full.numpy(),
            rtol=1e-6, atol=1e-6)
    wq = quantize_weight(w, "int8")
    assert out_features(wq) == out_features(w) == 9
    tile = slice_out_channels(wq, 3, 6)
    assert tile["q"].data_ptr() == wq["q"][3].data_ptr()
    assert tile["q"].stride() == wq["q"].stride()
    np.testing.assert_allclose(
        row_parallel_matmul(x, wq, ntiles=3, mm=_mm).numpy(),
        _mm(x, wq).numpy(), rtol=1e-6, atol=1e-6)


# ---------------------------------------------------------------------------
# tp=1: no process group, held to the unsharded port
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 8])
def test_tp1_raw_logits(kv_bits):
    base = W.run_steps(_tmlp(kv_bits))
    tp1 = W.run_steps(tserving.shard_engine(_tmlp(kv_bits), tp=1,
                                            overlap_tiles=3))
    _close(base, tp1, TP_TOL)


def _tensors(obj):
    if torch.is_tensor(obj):
        return [obj]
    vals = obj.values() if isinstance(obj, dict) else obj
    return [t for v in vals for t in _tensors(v)]


@pytest.mark.parametrize("kind", ["mlp", "llama"])
def test_shard_holds_its_own_copies(world, kind):
    """No tensor of a shard shares storage with its base engine (so
    dropping the base frees it), and sharding leaves the base's weights
    as they were."""
    _ref, _ranks, (_jm, tm) = world
    base = _tmlp(8, 4) if kind == "mlp" else _tllama(tm, 8, 4)
    before = [t.clone() for t in _tensors(base.params)]
    shard = tserving.shard_engine(base, tp=1)

    def storages(obj):
        return {t.untyped_storage().data_ptr() for t in _tensors(obj)}

    assert not storages(shard.params) & storages(base.params)
    assert not storages(shard._pools()) & storages(base._pools())
    assert all(torch.equal(a, b)
               for a, b in zip(before, _tensors(base.params), strict=True))


def test_tp1_scheduler_token_parity_greedy_and_stochastic(world):
    ref, _ranks, _ = world
    prompts = W.prompts()
    base, _ = W.serve_tokens(_tmlp(), prompts)
    tp1, _ = W.serve_tokens(tserving.shard_engine(_tmlp(), tp=1), prompts)
    assert base == tp1 == ref["tokens/2"]


def test_tp1_sequential_mode_returns_host_logits():
    sh = tserving.shard_engine(_tmlp(), tp=1, overlap=False)
    out = sh.ragged_step(*W.ragged_batch(0))
    assert isinstance(out, np.ndarray) and out.shape[-1] == 64
    out = sh.verify_step(np.ones((2, 4), np.int32),
                         np.array([4, 4], np.int32),
                         np.arange(8, dtype=np.int32).reshape(2, 4))
    assert isinstance(out, np.ndarray) and out.shape == (2, 4, 64)


# ---------------------------------------------------------------------------
# typed errors BEFORE allocation (no world: every layout check runs first)
# ---------------------------------------------------------------------------

def test_kv_heads_indivisible(world):
    _ref, _ranks, (jm, tm) = world
    for pkg, eng in ((jserving, _jllama(jm)), (tserving, _tllama(tm))):
        with pytest.raises(pkg.ShardingConfigError,
                           match="num_key_value_heads"):
            pkg.shard_engine(eng, tp=4)
    # the failed attempt left the base engine serviceable
    assert W.run_steps(eng)[0].shape[-1] == 64


@pytest.fixture(scope="module")
def jax_mlp():
    """One JAX engine for every refused layout (a refusal leaves it as it
    was, which each case checks by serving a step on it)."""
    return _jmlp()


@pytest.mark.parametrize("case", ["hidden", "degrees", "mesh", "world",
                                  "already", "unrecognized", "int4_odd"])
def test_sharding_config_errors(case, jax_mlp):
    """Each refused layout raises `ShardingConfigError` on both packages
    (the port says "world size" where JAX says "visible devices"; the
    int4 case on the port alone: JAX's int4 quantization of that engine
    costs seconds of compilation), and the base engine still serves."""
    class Weird:
        params = {"mystery": np.zeros((2, 2))}

    pkgs = ((jserving, _jmlp, JaxMesh), (tserving, _tmlp, ProcessMesh))
    for pkg, mk, mesh_cls in pkgs[1:] if case == "int4_odd" else pkgs:
        if case == "int4_odd":
            eng = mk(wbits=4, vocab_size=66, hidden=18)
        else:
            eng = jax_mlp if pkg is jserving else mk()
        call, match = {
            "hidden": (lambda: pkg.shard_engine(eng, tp=3), "hidden"),
            "degrees": (lambda: pkg.shard_engine(eng, tp=0), ">= 1"),
            "mesh": (lambda: pkg.shard_engine(
                eng, mesh=mesh_cls([0, 1, 2, 3], ["x"]), tp=2, dp=1),
                "mesh has"),
            "world": (lambda: pkg.shard_engine(eng, tp=16),
                      "visible devices" if pkg is jserving
                      else "exceeds the world size 1"),
            "already": (lambda: pkg.shard_engine(
                pkg.shard_engine(mk(), tp=1), tp=1), "already"),
            "unrecognized": (lambda: pkg.shard_engine(Weird(), tp=2),
                             "unrecognized"),
            "int4_odd": (lambda: pkg.shard_engine(eng, tp=2), "int4"),
        }[case]
        with pytest.raises(pkg.ShardingConfigError, match=match):
            call()
        assert np.asarray(W.as_np(eng.ragged_step(*W.ragged_batch(0)))) \
            .shape[-1] == eng.vocab_size


def test_port_refuses_tp2_without_a_world():
    with pytest.raises(tserving.ShardingConfigError, match="world size"):
        tserving.shard_engine(_tmlp(), tp=2)


def test_legacy_entry_points_raise():
    sh = tserving.shard_engine(_tmlp(), tp=1)
    for entry in ("prefill", "decode_step", "generate"):
        with pytest.raises(RuntimeError, match="ragged_step"):
            getattr(sh, entry)()


def test_lora_and_tp_do_not_stack():
    """A shard cannot be wrapped in adapters, nor a LoRA engine sharded
    (its pools and epilogues would be dropped): both refuse, typed."""
    with pytest.raises(tserving.AdapterError, match="shard"):
        tserving.attach_adapters(tserving.shard_engine(_tmlp(), tp=1))
    with pytest.raises(tserving.ShardingConfigError, match="LoRA"):
        tserving.shard_engine(tserving.attach_adapters(_tmlp()), tp=1)


# ---------------------------------------------------------------------------
# tp>1 on the gloo world: raw logits, overlap and sequential modes
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits,overlap", [(16, True), (16, False),
                                             (8, True), (8, False)])
def test_raw_logits_tp2(world, kv_bits, overlap):
    ref, ranks, _ = world
    key = f"mlp_raw/{kv_bits}/{overlap}"
    base = W.run_steps(_tmlp(kv_bits))
    for res in ranks:
        _close(res[key], ref[f"mlp_raw/{kv_bits}"], JAX_TOL)
        _close(res[key], base, TP_TOL)


@pytest.mark.parametrize("wbits,overlap", [(8, True), (4, True),
                                           (4, False)])
def test_raw_logits_quantized_tp2(world, wbits, overlap):
    ref, ranks, _ = world
    key = f"mlp_rawq/{wbits}/{overlap}"
    base = W.run_steps(_tmlp(wbits=wbits))
    for res in ranks:
        _close(res[key], ref[f"mlp_rawq/{wbits}"], JAX_TOL)
        _close(res[key], base, TP_TOL)


@pytest.mark.parametrize("kv_bits,wbits,overlap", [(16, None, True),
                                                   (8, None, False),
                                                   (8, 4, True)])
def test_raw_logits_tp4(world, kv_bits, wbits, overlap):
    """tp=4 over the world (a feature slice of 4 a rank): every rank
    against the unsharded port, and all four ranks' logits equal."""
    _ref, ranks, _ = world
    key = f"mlp_raw4/{kv_bits}/{wbits}/{overlap}"
    base = W.run_steps(_tmlp(kv_bits, wbits))
    for res in ranks:
        _close(res[key], base, TP_TOL)
        for a, b in zip(res[key], ranks[0][key]):
            np.testing.assert_array_equal(a, b)


def test_sequential_mode_returns_host_logits(world):
    _ref, ranks, _ = world
    for res in ranks:
        assert res["seq_types"] == ("ndarray", "Tensor")


@pytest.mark.parametrize("tp", [2, 4])
def test_scheduler_token_parity(world, tp):
    """Greedy and seeded-stochastic streams: every rank's equal the JAX
    package's tp=2 shards' and the unsharded port's."""
    ref, ranks, _ = world
    base, _ = W.serve_tokens(_tmlp(), W.prompts())
    assert ref["tokens/2"] == base
    for res in ranks:
        assert res[f"tokens/{tp}"] == base
        assert res["tokens/2/seq"] == base


def test_spec_equals_plain_under_tp(world):
    _ref, ranks, _ = world
    for res in ranks:
        assert res["spec"] == res["plain"]


def test_shared_prefix_cow_parity(world):
    """Radix sharing + COW under TP (prefix cache on): block ids stay
    logical, each rank's copy moves its slice, and the streams equal the
    unsharded port's with the cache on."""
    _ref, ranks, _ = world
    eng = _tmlp()
    base, fe = W.serve_tokens(eng, W.cow_prompts(), prefix_cache=True)
    for res in ranks:
        assert res["cow"] == base
        leaked, cow = res["cow_books"]
        assert leaked == 0 and cow == eng.manager.cow_copies > 0


def test_steady_state_serves_without_leaks(world):
    """A second batch on the same sharded frontend: every request
    finishes, no block leaks, and the greedy streams equal the unsharded
    port's."""
    _ref, ranks, _ = world
    fe = tserving.ServingFrontend(_tmlp(kv_bits=8))
    for batch in (W.prompts(3, seed=4), W.prompts(4, seed=5)):
        hs = [fe.submit(p, max_new_tokens=4) for p in batch]
        fe.run_until_idle(max_steps=2000)
    for res in ranks:
        statuses, tokens, leaked = res["steady"]
        assert statuses == ["finished"] * 4 and leaked == 0
        assert tokens == [h.tokens for h in hs]


def test_every_rank_streams_identical(world):
    _ref, ranks, _ = world
    for key in ("tokens/2", "tokens/4", "tokens/2/seq", "spec", "plain",
                "cow", "steady"):
        assert all(res[key] == ranks[0][key] for res in ranks), key


# ---------------------------------------------------------------------------
# quantized + TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("wbits", [8, 4])
def test_greedy_agreement_quantized(world, wbits):
    _ref, ranks, _ = world
    for res in ranks:
        r = res[f"agree/{wbits}"]
        assert r["agreement_tie_aware"] >= 0.99, r


def test_quant_info_reports_per_rank_kv(world):
    _ref, ranks, _ = world
    for res in ranks:
        info, unsharded = res["quant_info"]
        assert info["wbits"] == 4 and info["kv_bits"] == 8
        # the feature axis halves, the replicated scale plane does not
        assert info["kv_bytes_per_token"] < unsharded
        info, unsharded = res["llama_quant_info"]
        assert (info["wbits"], info["kv_bits"]) == (4, 8)
        assert info["kv_bytes_per_token"] * 2 == unsharded


# ---------------------------------------------------------------------------
# the Llama stack under TP
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits,wbits", LLAMA_CASES)
def test_llama_tp2_parity(world, kv_bits, wbits):
    """Every rank against the JAX shards (kv16 dense) or the JAX
    unsharded engine (the others), and against the unsharded port."""
    ref, ranks, (_jm, tm) = world
    key = f"llama_raw/{kv_bits}/{wbits}"
    base = W.run_steps(_tllama(tm, kv_bits, wbits))
    tol = JAX_TOL if wbits is None and kv_bits == 16 else TP_TOL
    for res in ranks:
        _close(res[key], ref[key], tol)
        _close(res[key], base, TP_TOL)
    for res in ranks:
        _close(res["llama_raw/seq"], ranks[0]["llama_raw/16/None"], TP_TOL)


def test_llama_greedy_agreement_quantized_tp(world):
    _ref, ranks, _ = world
    for res in ranks:
        r = res["llama_agree"]
        assert r["agreement_tie_aware"] >= 0.99, r


def test_tp_summary(world):
    _ref, ranks, _ = world
    for r, res in enumerate(ranks):
        s = res["summary"]
        assert (s["tp"], s["dp"], s["overlap"], s["tiles"]) == (2, 2, True, 3)
        assert s["mesh"]["dim_names"] == ["dp", "tp"]
        assert (s["dp_index"], s["tp_index"]) == divmod(r, 2)


def test_aggregate_mesh_gathers_over_the_world(world):
    """With no snapshots, `aggregate_mesh` gathers every rank's over the
    default group: 4 hosts, and the JAX formula over the same four
    snapshots."""
    from paddle_tpu.framework import monitor as jmonitor

    _ref, ranks, _ = world
    snaps = [res["aggregate"][0] for res in ranks]
    want = jmonitor.aggregate_mesh("tpw.", snapshots=snaps,
                                   step_wall_key="tpw.step_wall_ms")
    jmonitor.reset_prefix("mesh.")
    assert want["hosts"] == RANKS and want["sum"]["tpw.requests"] == 10
    for res in ranks:
        assert res["aggregate"][1] == want


# ---------------------------------------------------------------------------
# sharded KV migration: per-rank export, partition pinning
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("kv_bits", [16, 8])
def test_tp2_roundtrip_bitwise(world, kv_bits):
    _ref, ranks, _ = world
    for res in ranks:
        header, p, q = res[f"mig/{kv_bits}"]
        assert header["tp"] == 2 and header["hidden"] == 16
        assert set(p) == ({"cache", "scale"} if kv_bits == 8 else {"cache"})
        assert p["cache"].shape[-1] == 8            # this rank's slice
        assert set(p) == set(q)
        for k in p:
            np.testing.assert_array_equal(p[k], q[k])


def test_session_resumes_on_a_second_tp2_engine(world):
    _ref, ranks, _ = world
    for res in ranks:
        reference, carried, tokens, status, leak1, leak2 = res["session"]
        assert status == "finished" and tokens == reference
        assert tokens[:len(carried)] == carried
        assert leak1 == leak2 == 0


def test_tp_mismatch_typed(world):
    _ref, ranks, _ = world
    for res in ranks:
        into_plain, into_tp4, free0, free_after, plain_free = \
            res["mig_mismatch"]
        for err in (into_plain, into_tp4):
            assert err[0] == "KVMigrationError" and "'tp'" in err[1]
        assert free_after == free0 and plain_free == 32
    src = tserving.shard_engine(_tmlp(), tp=1)
    W.fill(src, n=7)
    p = src.extract_kv_blocks(0)
    p.header["tp"] = 2
    with pytest.raises(KVMigrationError, match="tp"):
        _tmlp().inject_kv_blocks(0, p)


# ---------------------------------------------------------------------------
# lockstep
# ---------------------------------------------------------------------------

def test_lockstep_divergence_raises_typed(world):
    """The second rank of each tp group dispatches other tokens: every
    rank raises `LockstepError` (a `ShardingConfigError`) well inside the
    group's timeout, and the group goes on serving in step."""
    _ref, ranks, _ = world
    assert issubclass(tserving.LockstepError, tserving.ShardingConfigError)
    for res in ranks:
        err, seconds = res["lockstep"]
        assert err[0] == "LockstepError", err
        assert seconds < 10.0
    for a, b in ((0, 1), (2, 3)):
        np.testing.assert_array_equal(ranks[a]["after_lockstep"],
                                      ranks[b]["after_lockstep"])


# ---------------------------------------------------------------------------
# the weight-only gemm at the per-rank shapes of the TP path
# ---------------------------------------------------------------------------

def _tp_gemm_shapes(tp=2, tiles=4, h=4096, inter=11008, heads=32, d=128,
                    vocab=32000):
    """Per-rank [N, K] of Llama-2-7B's gemms at `tp`, `tiles`: qkv and
    gate_up column shards, one tile of the o and down row shards, the
    untied head's vocab shard."""
    return {"qkv_tp2": (3 * heads * d // tp, h),
            "o_tile_tp2": (h // tiles, heads * d // tp),
            "gate_up_tp2": (2 * inter // tp, h),
            "down_tile_tp2": (h // tiles, inter // tp),
            "head_tp2": (vocab // tp, h)}


def test_the_smoke_times_the_tp_shapes():
    import chip_smoke

    assert chip_smoke.TP_GEMM_SHAPES == _tp_gemm_shapes(
        chip_smoke.TP, chip_smoke.TP_TILES)


@pytest.mark.parametrize("name", list(_tp_gemm_shapes()))
def test_gemm_plan_and_tma_rules_take_the_tp_shapes(name):
    """`gemm_plan` splits each per-rank shape into whole weight tiles (K
    5504 = 43 x 128 leaves a ragged last int4 tile of 128 k values), the
    kernel's K rule holds (int4: a multiple of 32), and a tile of whole
    weight rows is a view whose rows and start stay 16-byte aligned, as
    the TMA maps need (the int4 down tile's packed row: 2,752 bytes)."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    n, k = _tp_gemm_shapes()[name]
    assert k % 32 == 0 and (k // 2) % 16 == 0
    for int4 in (False, True):
        plan = qm.gemm_plan(40, n, k, 132, int4)
        per = plan.k_tiles_per_split
        assert plan.k_tiles == -(-k // (256 if int4 else 128))
        assert (plan.splits - 1) * per < plan.k_tiles <= plan.splits * per
        assert plan.smem_bytes <= qm.SMEM_PER_BLOCK
    if "tile" in name:
        full = torch.empty((4 * n, k // 2), dtype=torch.int8)
        tile = slice_out_channels({"q4": full, "s": torch.empty(4 * n)},
                                  n, 2 * n)
        assert tile["q4"].stride() == (k // 2, 1)
        assert (tile["q4"].data_ptr() - full.data_ptr()) % 16 == 0
        assert tile["s"].is_contiguous()
