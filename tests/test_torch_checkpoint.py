"""Checkpoints on the CPU, held to the JAX package: the port's
`distributed/checkpoint/`, `resilience/checkpoint_manager.py` and
`resilience/guard.py` through the cases of `tests/test_dist_checkpoint.py`
and `tests/test_resilience.py` (the manager, the quarantine, async
saves, the typed load errors, `StepGuard`), and checkpoints crossing the
packages both ways: one the JAX package writes from a sharded 8-device
CPU mesh loads whole in the port, one the port writes loads onto a JAX
mesh, and a `CheckpointManager` directory (model, AdamW accumulators,
`GradScaler` and RNG state) restores in the other package bit for bit.

Tolerances: every restored tensor, counter and file byte exact; the
two packages' trajectories of four AdamW steps 1e-5 (XLA's CPU
reductions sum in another order).
"""
import json
import os
import signal
import threading

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.distributed as tdist
from paddle_tpu.resilience import CheckpointManager as JManager
from paddle_tpu_torch.distributed.checkpoint import (AsyncSaveError,
                                                     CheckpointCorrupt,
                                                     save_state_dict,
                                                     verify_checkpoint)
from paddle_tpu_torch.framework import monitor
from paddle_tpu_torch.framework.random import get_rng_state
from paddle_tpu_torch.resilience import (CheckpointManager,
                                         NoValidCheckpoint, Preempted,
                                         RestartBudgetExceeded, StepGuard,
                                         faults)
from paddle_tpu_torch.resilience.checkpoint_manager import QUARANTINE_PREFIX
from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401


@pytest.fixture(autouse=True)
def _clean_faults():
    faults.clear()
    yield
    faults.clear()


def T(a):
    return tpaddle.to_tensor(np.asarray(a))


def _np(t):
    d = t._data if hasattr(t, "_data") else t
    if isinstance(d, torch.Tensor):
        d = d.detach()
        if d.dtype == torch.bfloat16:
            return d.view(torch.int16).numpy()
        return d.numpy()
    a = np.asarray(d)
    return a.view(np.int16) if a.dtype.name == "bfloat16" else a


def small_state(seed=0):
    rng = np.random.default_rng(seed)
    return {"w": T(rng.standard_normal((4, 4)).astype("float32")),
            "b": T(rng.standard_normal((4,)).astype("float32"))}


def make_manager(tmp_path, **kw):
    kw.setdefault("sleep", lambda s: None)
    return CheckpointManager(str(tmp_path / "ckpt"), **kw)


def complete_dirs(root):
    return sorted(d for d in os.listdir(root)
                  if d.startswith("step_")
                  and os.path.exists(os.path.join(root, d, "COMPLETE")))


def _mesh(shape, names):
    return jdist.ProcessMesh(np.arange(int(np.prod(shape))).reshape(shape),
                             list(names))


# -- distributed/checkpoint ------------------------------------------------

def test_save_load_roundtrip_and_layout(tmp_path):
    w = np.arange(64, dtype=np.float32).reshape(8, 8)
    tdist.save_state_dict({"w": T(w)}, str(tmp_path))
    assert sorted(os.listdir(tmp_path)) == ["0.metadata", "0_0.distcp"]
    dest = {"w": T(np.zeros_like(w))}
    before = dest["w"]._data
    tdist.load_state_dict(dest, str(tmp_path))
    assert dest["w"]._data is before        # loaded in place
    np.testing.assert_array_equal(_np(dest["w"]), w)


def test_async_save_then_load_waits(tmp_path):
    w = np.random.default_rng(0).random((8, 4)).astype(np.float32)
    tdist.save_state_dict({"w": T(w)}, str(tmp_path), async_save=True)
    dest = {"w": T(np.zeros_like(w))}
    tdist.load_state_dict(dest, str(tmp_path))
    np.testing.assert_array_equal(_np(dest["w"]), w)


def test_load_torch_tensor_and_missing_key(tmp_path):
    w = np.random.default_rng(1).random((8, 4)).astype(np.float32)
    tdist.save_state_dict({"w": T(w)}, str(tmp_path))
    dest = {"w": torch.zeros(8, 4)}
    tdist.load_state_dict(dest, str(tmp_path))
    np.testing.assert_array_equal(dest["w"].numpy(), w)
    with pytest.raises(KeyError):
        tdist.load_state_dict({"nope": T(w)}, str(tmp_path))


def test_no_pickle_and_corruption_detected(tmp_path):
    w = np.random.default_rng(2).random((8, 4)).astype(np.float32)
    tdist.save_state_dict({"w": T(w)}, str(tmp_path))
    json.load(open(tmp_path / "0.metadata"))
    target = tmp_path / "0_0.distcp"
    raw = bytearray(target.read_bytes())
    raw[-1] ^= 0xFF
    target.write_bytes(bytes(raw))
    with pytest.raises(CheckpointCorrupt, match="checksum|corrupt"):
        tdist.load_state_dict({"w": T(np.zeros_like(w))}, str(tmp_path))


def test_bf16_and_large_with_checksums(tmp_path):
    rng = np.random.default_rng(1)
    big = rng.standard_normal((1024, 6 * 1024)).astype(np.float32)  # 24 MB
    bf = torch.from_numpy(rng.standard_normal((64, 64)).astype(
        np.float32)).to(torch.bfloat16)
    tdist.save_state_dict({"big": T(big), "bf": tpaddle.Tensor(bf)},
                          str(tmp_path))
    dest = {"big": T(np.zeros_like(big)),
            "bf": tpaddle.Tensor(torch.zeros(64, 64, dtype=torch.bfloat16))}
    tdist.load_state_dict(dest, str(tmp_path))
    np.testing.assert_array_equal(_np(dest["big"]), big)
    assert dest["bf"]._data.dtype == torch.bfloat16
    np.testing.assert_array_equal(_np(dest["bf"]), _np(bf))


@pytest.mark.parametrize("layout", ["dp2mp4", "world8"])
def test_jax_sharded_checkpoint_loads_whole(tmp_path, layout):
    """The JAX package saves from its 8-device CPU mesh (one shard file a
    device, replicated shards once); the port assembles each tensor
    whole, bf16 included."""
    import jax.numpy as jnp

    rng = np.random.default_rng(0)
    w1 = rng.standard_normal((16, 8)).astype(np.float32)
    w2 = rng.standard_normal((8, 12)).astype(np.float32)
    bf = rng.standard_normal((16, 4)).astype(np.float32)
    if layout == "dp2mp4":
        mesh = _mesh((2, 4), ["dp", "mp"])
        specs = [[jdist.Replicate(), jdist.Shard(1)],
                 [jdist.Replicate(), jdist.Shard(0)],
                 [jdist.Replicate(), jdist.Shard(0)]]
    else:
        mesh = _mesh((8,), ["world"])
        specs = [[jdist.Shard(0)]] * 3
    st = {"w1": jdist.shard_tensor(jpaddle.Tensor(w1), mesh, specs[0]),
          "w2": jdist.shard_tensor(jpaddle.Tensor(w2), mesh, specs[1]),
          "bf": jdist.shard_tensor(jpaddle.Tensor(jnp.asarray(
              bf, jnp.bfloat16)), mesh, specs[2])}
    jdist.save_state_dict(st, str(tmp_path))
    assert len([f for f in os.listdir(tmp_path)
                if f.endswith(".distcp")]) > 1
    dest = {"w1": T(np.zeros_like(w1)), "w2": T(np.zeros_like(w2)),
            "bf": tpaddle.Tensor(torch.zeros(16, 4, dtype=torch.bfloat16))}
    tdist.load_state_dict(dest, str(tmp_path))
    np.testing.assert_array_equal(_np(dest["w1"]), w1)
    np.testing.assert_array_equal(_np(dest["w2"]), w2)
    np.testing.assert_array_equal(
        _np(dest["bf"]), _np(jnp.asarray(bf, jnp.bfloat16)))


def test_port_checkpoint_loads_onto_a_jax_mesh(tmp_path):
    rng = np.random.default_rng(3)
    w = rng.standard_normal((16, 8)).astype(np.float32)
    m = rng.standard_normal((16, 8)).astype(np.float32)
    tdist.save_state_dict({"w": T(w), "m_w": T(m)}, str(tmp_path))
    mesh = _mesh((4, 2), ["dp", "mp"])
    dest = {"w": jdist.shard_tensor(jpaddle.Tensor(np.zeros_like(w)), mesh,
                                    [jdist.Replicate(), jdist.Shard(1)]),
            "m_w": jdist.shard_tensor(jpaddle.Tensor(np.zeros_like(m)),
                                      mesh, [jdist.Replicate(),
                                             jdist.Shard(0)])}
    jdist.load_state_dict(dest, str(tmp_path))
    np.testing.assert_array_equal(np.asarray(dest["w"]._data), w)
    np.testing.assert_array_equal(np.asarray(dest["m_w"]._data), m)
    assert len(dest["w"]._data.sharding.device_set) == 8


def test_async_thread_exception_reraised_per_path(tmp_path, monkeypatch):
    import importlib

    ssd = importlib.import_module(
        "paddle_tpu_torch.distributed.checkpoint.save_state_dict")

    def failing_write(*a, **kw):
        raise IOError("disk gone")

    monkeypatch.setattr(ssd.sft, "save_file", failing_write)
    tdist.save_state_dict({"w": T(np.ones((2, 2), np.float32))},
                          str(tmp_path / "a"), async_save=True)
    with pytest.raises(AsyncSaveError):
        ssd._wait_pending(str(tmp_path / "a"))
    ssd._wait_pending(str(tmp_path / "a"))


def test_second_async_save_same_path_does_not_interleave(tmp_path):
    import importlib

    ssd = importlib.import_module(
        "paddle_tpu_torch.distributed.checkpoint.save_state_dict")
    path = str(tmp_path / "ck")
    order = []
    gate = threading.Event()
    orig = ssd.sft.save_file

    def slow_save(tensors, p, metadata=None):
        order.append("start")
        gate.wait(5)
        orig(tensors, p, metadata=metadata)
        order.append("end")

    ssd.sft.save_file = slow_save
    try:
        st = {"w": T(np.ones((2, 2), np.float32))}
        tdist.save_state_dict(st, path, async_save=True)
        t = threading.Thread(target=tdist.save_state_dict, args=(st, path),
                             kwargs={"async_save": True})
        t.start()
        gate.set()
        t.join()
        ssd._wait_pending(path)
    finally:
        ssd.sft.save_file = orig
    assert order == ["start", "end", "start", "end"]


def test_missing_shard_file_raises_typed_error(tmp_path):
    tdist.save_state_dict({"w": T(np.arange(16, dtype=np.float32)
                                  .reshape(4, 4))}, str(tmp_path))
    os.remove(tmp_path / "0_0.distcp")
    with pytest.raises(CheckpointCorrupt) as ei:
        tdist.load_state_dict({"w": T(np.zeros((4, 4), np.float32))},
                              str(tmp_path))
    assert ei.value.file == "0_0.distcp" and ei.value.key == "w"


def test_short_shard_file_raises_typed_error(tmp_path):
    tdist.save_state_dict({"w": T(np.arange(64, dtype=np.float32))},
                          str(tmp_path))
    shard = tmp_path / "0_0.distcp"
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) - 16)
    with pytest.raises(CheckpointCorrupt, match="truncated"):
        tdist.load_state_dict({"w": T(np.zeros(64, np.float32))},
                              str(tmp_path))


def test_missing_metadata_raises_typed_error(tmp_path):
    with pytest.raises(CheckpointCorrupt, match="0.metadata"):
        tdist.load_state_dict({"w": T(np.zeros(4, np.float32))},
                              str(tmp_path))


def test_crc_mismatch_on_read_raises_typed_error(tmp_path):
    tdist.save_state_dict({"w": T(np.arange(64, dtype=np.float32))},
                          str(tmp_path))
    shard = tmp_path / "0_0.distcp"
    size = os.path.getsize(shard)
    with open(shard, "r+b") as f:
        f.seek(size - 5)
        f.write(b"\xff")
    with pytest.raises(CheckpointCorrupt, match="integrity"):
        tdist.load_state_dict({"w": T(np.zeros(64, np.float32))},
                              str(tmp_path))


def test_verify_checkpoint_rejects_missing_storage_entry(tmp_path):
    path = str(tmp_path / "ck")
    save_state_dict(small_state(), path)
    meta_path = os.path.join(path, "0.metadata")
    with open(meta_path) as f:
        raw = json.load(f)
    raw["storage_metadata"].popitem()
    with open(meta_path, "w") as f:
        json.dump(raw, f)
    with pytest.raises(CheckpointCorrupt, match="no shard file"):
        verify_checkpoint(path)


# -- CheckpointManager -----------------------------------------------------

def test_save_layout_and_rotation(tmp_path):
    cm = make_manager(tmp_path, keep_last_n=2)
    st = small_state()
    for step in range(5):
        p = cm.save(step, state_dict=st)
    assert sorted(os.listdir(p)) == ["0.metadata", "0_0.distcp", "COMPLETE",
                                     "extra_state.json"]
    assert complete_dirs(cm.root) == ["step_000003", "step_000004"]


def test_milestones_survive_rotation(tmp_path):
    cm = make_manager(tmp_path, keep_last_n=2, keep_every_k=5)
    st = small_state()
    for step in range(1, 13):
        cm.save(step, state_dict=st)
    assert complete_dirs(cm.root) == ["step_000005", "step_000010",
                                      "step_000011", "step_000012"]


def test_save_retries_transient_io_then_succeeds(tmp_path):
    cm = make_manager(tmp_path, retries=3)
    before = monitor.get("resilience.retries")
    faults.inject("ckpt.write", times=2)
    cm.save(0, state_dict=small_state())
    assert monitor.get("resilience.retries") - before == 2
    assert cm.latest_valid()[0] == 0


def test_save_gives_up_on_persistent_io(tmp_path):
    cm = make_manager(tmp_path, retries=2)
    faults.inject("ckpt.write", times=None)
    with pytest.raises(faults.InjectedIOError):
        cm.save(0, state_dict=small_state())
    assert cm.latest_valid() is None


def _saved(tmp_path, n=3):
    cm = make_manager(tmp_path, keep_last_n=10)
    st = small_state()
    for step in range(n):
        cm.save(step, state_dict=st)
    return cm


def _flip(path, back=3):
    size = os.path.getsize(path)
    with open(path, "r+b") as f:
        f.seek(size - back)
        b = f.read(1)
        f.seek(size - back)
        f.write(bytes([b[0] ^ 0xFF]))
    assert os.path.getsize(path) == size


def test_missing_complete_marker_is_quarantined(tmp_path):
    cm = _saved(tmp_path)
    os.remove(os.path.join(cm.root, "step_000002", "COMPLETE"))
    before = monitor.get("resilience.quarantines")
    step, path = cm.latest_valid()
    assert step == 1 and path.endswith("step_000001")
    assert os.path.isdir(os.path.join(cm.root,
                                      QUARANTINE_PREFIX + "step_000002"))
    assert monitor.get("resilience.quarantines") - before == 1


def test_truncated_shard_is_quarantined(tmp_path):
    cm = _saved(tmp_path)
    shard = os.path.join(cm.root, "step_000002", "0_0.distcp")
    with open(shard, "r+b") as f:
        f.truncate(os.path.getsize(shard) - 8)
    assert cm.latest_valid()[0] == 1


def test_bitflip_crc_mismatch_is_quarantined(tmp_path):
    cm = _saved(tmp_path)
    _flip(os.path.join(cm.root, "step_000002", "0_0.distcp"))
    assert cm.latest_valid()[0] == 1


def test_all_torn_returns_none(tmp_path):
    cm = _saved(tmp_path, n=2)
    for d in complete_dirs(cm.root):
        os.remove(os.path.join(cm.root, d, "COMPLETE"))
    assert cm.latest_valid() is None


def test_quarantined_dirs_never_reload(tmp_path):
    cm = _saved(tmp_path)
    os.remove(os.path.join(cm.root, "step_000002", "COMPLETE"))
    cm.latest_valid()
    before = monitor.get("resilience.quarantines")
    assert cm.latest_valid()[0] == 1
    assert monitor.get("resilience.quarantines") == before


def test_async_save_completes_and_next_save_joins(tmp_path):
    cm = make_manager(tmp_path, async_save=True)
    st = small_state()
    cm.save(0, state_dict=st)
    cm.save(1, state_dict=st)
    cm.wait()
    assert complete_dirs(cm.root) == ["step_000000", "step_000001"]


def test_background_error_reraised_at_next_save(tmp_path):
    cm = make_manager(tmp_path, async_save=True, retries=0)
    faults.inject("ckpt.write", times=1)
    cm.save(0, state_dict=small_state())
    with pytest.raises(AsyncSaveError):
        cm.save(1, state_dict=small_state())
    cm.save(2, state_dict=small_state())
    cm.wait()
    assert cm.latest_valid()[0] == 2


def test_background_error_reraised_at_wait(tmp_path):
    cm = make_manager(tmp_path, async_save=True, retries=0)
    faults.inject("ckpt.write", times=1)
    cm.save(0, state_dict=small_state())
    with pytest.raises(AsyncSaveError):
        cm.wait()


def test_error_swallowed_by_latest_valid_is_deferred_not_lost(tmp_path):
    cm = make_manager(tmp_path, async_save=True, retries=0)
    st = small_state()
    cm.save(0, state_dict=st)
    cm.wait()
    faults.inject("ckpt.write", times=1)
    cm.save(1, state_dict=st)
    assert cm.latest_valid()[0] == 0
    with pytest.raises(AsyncSaveError):
        cm.save(2, state_dict=st)


def test_emergency_save_does_not_destroy_existing_checkpoint(tmp_path):
    cm = make_manager(tmp_path)
    st = small_state()
    cm.save(3, state_dict=st)
    marker = os.path.join(cm.root, "step_000003", "COMPLETE")
    mtime = os.path.getmtime(marker)
    cm.emergency_save(3, state_dict=st)
    assert os.path.getmtime(marker) == mtime
    assert cm.latest_valid()[0] == 3


def test_placements_are_refused(tmp_path):
    cm = _saved(tmp_path, n=1)
    with pytest.raises(NotImplementedError, match="placements"):
        cm.restore_latest(state_dict=small_state(), placements={"w": None})


# -- StepGuard -------------------------------------------------------------

def tiny_training(p=tpaddle, seed=3):
    """A Linear trained by AdamW on a fixed batch, its parameters named
    alike in both packages."""
    rng = np.random.default_rng(seed)
    m = p.nn.Linear(4, 4)
    m.weight.set_value(rng.standard_normal((4, 4)).astype("float32"))
    m.bias.set_value(rng.standard_normal((4,)).astype("float32"))
    m.weight.name, m.bias.name = "lin.w_0", "lin.b_0"
    opt = p.optimizer.AdamW(learning_rate=0.05, parameters=m.parameters())
    x = p.to_tensor(np.random.default_rng(0).standard_normal((8, 4))
                    .astype("float32"))

    def step_fn(step_idx):
        y = m(x)
        loss = (y * y).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        return loss

    return m, opt, step_fn


def test_nan_rollback_restores_exact_params_and_rng(tmp_path):
    m, opt, step_fn = tiny_training()
    cm = make_manager(tmp_path)
    guard = StepGuard(step_fn, cm, model=m, optimizer=opt, save_every=1)
    for i in range(3):
        assert guard.step(i) is not None
    snap = {k: _np(t).copy() for k, t in m.state_dict().items()}
    rng_snap = get_rng_state()
    before = monitor.get("resilience.rollbacks")
    faults.inject("guard.nan_loss", times=1)
    assert guard.step(3) is None
    assert monitor.get("resilience.rollbacks") - before == 1
    assert monitor.get("resilience.trips.non_finite_loss") >= 1
    for k, t in m.state_dict().items():
        np.testing.assert_array_equal(_np(t), snap[k])
    assert get_rng_state() == rng_snap
    assert guard.last_step == 2
    assert guard.step(3) is not None


def test_rollback_replay_is_bit_equal_to_the_uninterrupted_run(tmp_path):
    """NaN at step 4, checkpoints every 2 steps: the guard restores step 3
    and the replayed losses and final parameters are the uninterrupted
    run's bits (AdamW moments and beta powers restored exactly)."""
    def run(guarded):
        m, opt, step_fn = tiny_training()
        cm = make_manager(tmp_path / ("g" if guarded else "u"))
        guard = StepGuard(step_fn, cm, model=m, optimizer=opt, save_every=2)
        losses, i, tripped = {}, 0, False
        while i < 6:
            if guarded and i == 4 and not tripped:
                faults.inject("guard.nan_loss", times=1)
                tripped = True
            loss = guard.step(i)
            if loss is None:
                i = guard.last_step + 1
                continue
            losses[i] = loss
            i += 1
        return losses, {k: _np(t) for k, t in m.state_dict().items()}
    lu, su = run(False)
    lg, sg = run(True)
    assert lg == lu
    for k in su:
        np.testing.assert_array_equal(sg[k], su[k])


def test_restart_budget_exceeded(tmp_path):
    m, opt, step_fn = tiny_training()
    cm = make_manager(tmp_path)
    guard = StepGuard(step_fn, cm, model=m, optimizer=opt, max_restarts=2)
    cm.save(0, model=m, optimizer=opt)
    faults.inject("guard.nan_loss", times=None)
    assert guard.step(1) is None
    assert guard.step(1) is None
    with pytest.raises(RestartBudgetExceeded):
        guard.step(1)


def test_trip_without_checkpoint_raises(tmp_path):
    m, opt, step_fn = tiny_training()
    guard = StepGuard(step_fn, make_manager(tmp_path), model=m,
                      optimizer=opt)
    faults.inject("guard.nan_loss", times=1)
    with pytest.raises(NoValidCheckpoint):
        guard.step(0)


def test_step_exception_trips(tmp_path):
    m, opt, step_fn = tiny_training()
    cm = make_manager(tmp_path)
    cm.save(0, model=m, optimizer=opt)
    guard = StepGuard(step_fn, cm, model=m, optimizer=opt)
    faults.inject("guard.step", times=1, exc=RuntimeError("card died"))
    assert guard.step(1) is None
    assert monitor.get("resilience.trips.exception") >= 1


def test_loss_spike_trips_with_configured_window(tmp_path):
    losses = iter([1.0, 1.1, 0.9, 1.0, 50.0])
    cm = make_manager(tmp_path)
    m, opt, _ = tiny_training()
    cm.save(0, model=m, optimizer=opt)
    guard = StepGuard(lambda i: next(losses), cm, model=m, optimizer=opt,
                      window=4, threshold=10.0)
    for i in range(4):
        assert guard.step(i) is not None
    assert guard.step(4) is None
    assert monitor.get("resilience.trips.loss_spike") >= 1


def test_grad_norm_spike_trips(tmp_path):
    vals = iter([(1.0, 1.0)] * 3 + [(1.0, 99.0)])
    cm = make_manager(tmp_path)
    m, opt, _ = tiny_training()
    cm.save(0, model=m, optimizer=opt)
    guard = StepGuard(lambda i: next(vals), cm, model=m, optimizer=opt,
                      window=3, threshold=5.0)
    for i in range(3):
        assert guard.step(i) is not None
    assert guard.step(3) is None
    assert monitor.get("resilience.trips.grad_spike") >= 1


def test_scaler_skip_is_not_an_anomaly_but_streak_trips(tmp_path):
    scaler = tpaddle.amp.GradScaler(init_loss_scaling=8.0)
    p = tpaddle.Tensor(np.ones(4, np.float32), stop_gradient=False)
    opt = tpaddle.optimizer.SGD(learning_rate=0.1, parameters=[p])

    def amp_step(step_idx, bad):
        y = (p * (np.inf if bad else 1.0)).sum()
        scaler.scale(y).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
        return 1.0

    cm = make_manager(tmp_path)
    cm.save(0, state_dict={"p": p})
    guard = StepGuard(amp_step, cm, scaler=scaler, max_scaler_skips=2)
    before = monitor.get("resilience.rollbacks")
    assert guard.step(1, True) == 1.0
    assert scaler.last_step_skipped()
    assert monitor.get("resilience.rollbacks") == before
    assert guard.step(2, False) == 1.0
    assert not scaler.last_step_skipped()
    assert guard.step(3, True) == 1.0
    assert guard.step(4, True) == 1.0
    assert guard.step(5, True) is None
    assert monitor.get("resilience.trips.scaler_stuck") >= 1


def test_sigterm_emergency_save_in_process(tmp_path):
    m, opt, step_fn = tiny_training()
    cm = make_manager(tmp_path)
    guard = StepGuard(step_fn, cm, model=m, optimizer=opt,
                      exit_on_preempt=False)
    guard.step(0)
    before = monitor.get("resilience.emergency_saves")
    guard.install_preemption_hook()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        guard.uninstall_preemption_hook()
    assert monitor.get("resilience.emergency_saves") - before == 1
    step, path = cm.latest_valid()
    assert step == 0
    with open(os.path.join(path, "extra_state.json")) as f:
        extra = json.load(f)
    assert extra["extras"]["preempt_signal"] == int(signal.SIGTERM)


def test_preempt_exit_raises_preempted(tmp_path):
    m, opt, step_fn = tiny_training()
    cm = make_manager(tmp_path)
    guard = StepGuard(step_fn, cm, model=m, optimizer=opt,
                      exit_on_preempt=True)
    guard.step(0)
    guard.install_preemption_hook()
    try:
        faults.inject("guard.preempt", action="sigterm", times=1)
        with pytest.raises(Preempted):
            guard.step(1)
    finally:
        guard.uninstall_preemption_hook()
    assert cm.latest_valid()[0] == 0


def test_async_save_survives_in_place_updates(tmp_path):
    """The optimizers write parameters and moments in place: an async
    save's snapshot is a finished host copy before `save` returns, so the
    steps after it do not leak into the checkpoint."""
    m, opt, step_fn = tiny_training()
    step_fn(0)
    want = {k: _np(t).copy() for k, t in m.state_dict().items()}
    moments = {k: _np(v).copy() for k, v in opt.state_dict().items()
               if hasattr(v, "_data")}
    cm = make_manager(tmp_path, async_save=True)
    cm.save(0, model=m, optimizer=opt)
    for i in range(3):
        step_fn(i + 1)
    cm.wait()
    step, path = cm.latest_valid()
    assert step == 0
    cm.load(path, model=m, optimizer=opt)
    for k, t in m.state_dict().items():
        np.testing.assert_array_equal(_np(t), want[k])
    for k, v in opt.state_dict().items():
        if k in moments:
            np.testing.assert_array_equal(_np(v), moments[k])


def test_load_joins_pending_async_save(tmp_path):
    m, opt, _ = tiny_training()
    cm = make_manager(tmp_path, async_save=True)
    path = cm.save(0, model=m, optimizer=opt)
    assert cm.load(path, model=m, optimizer=opt).step == 0


def test_negative_loss_never_trips_spike_guard(tmp_path):
    cm = make_manager(tmp_path)
    losses = iter([-5.0, -5.1, -4.9, -5.0, -4.8, -4.95, -5.05, -4.7])
    guard = StepGuard(lambda i: next(losses), cm, window=2, threshold=10.0)
    for i in range(8):
        assert guard.step(i) is not None, f"spike trip at step {i}"


def test_sigterm_mid_step_defers_to_step_boundary(tmp_path):
    m, opt, inner = tiny_training()
    cm = make_manager(tmp_path)

    def step_fn(i):
        loss = inner(i)
        os.kill(os.getpid(), signal.SIGTERM)
        return loss

    guard = StepGuard(step_fn, cm, model=m, optimizer=opt,
                      exit_on_preempt=True)
    guard.install_preemption_hook()
    try:
        with pytest.raises(Preempted):
            guard.step(0)
    finally:
        guard.uninstall_preemption_hook()
    step, _ = cm.latest_valid()
    assert step == 0 and guard.last_step == 0


def test_preempt_before_any_step_saves_nothing(tmp_path):
    m, opt, step_fn = tiny_training()
    cm = make_manager(tmp_path)
    guard = StepGuard(step_fn, cm, model=m, optimizer=opt,
                      exit_on_preempt=False)
    before = monitor.get("resilience.emergency_saves")
    guard.install_preemption_hook()
    try:
        os.kill(os.getpid(), signal.SIGTERM)
    finally:
        guard.uninstall_preemption_hook()
    assert monitor.get("resilience.emergency_saves") == before
    assert cm.latest_valid() is None


def test_state_dict_rollback_restores_bitwise(tmp_path):
    cm = make_manager(tmp_path)
    st = small_state(seed=4)
    snap = {k: _np(t).copy() for k, t in st.items()}
    losses = iter([1.0, float("nan")])
    guard = StepGuard(lambda i: next(losses), cm, state_dict=st,
                      save_every=1)
    assert guard.step(0) == 1.0
    for t in st.values():
        t._data = t._data * 0 + 7.0
    assert guard.step(1) is None
    for k, t in st.items():
        np.testing.assert_array_equal(_np(t), snap[k])


def test_escalate_types_pass_through_untripped(tmp_path):
    class CollectiveAborted(RuntimeError):
        pass

    cm = make_manager(tmp_path)
    cm.save(0, state_dict=small_state())
    trips0 = monitor.get("resilience.trips.exception")

    def step_fn(i):
        raise CollectiveAborted("pod2")

    guard = StepGuard(step_fn, cm, state_dict=small_state(),
                      escalate=(CollectiveAborted,))
    with pytest.raises(CollectiveAborted):
        guard.step(1)
    assert monitor.get("resilience.trips.exception") == trips0


# -- across the packages ---------------------------------------------------

def _trained(p, steps=3):
    """tiny_training in package p, a GradScaler beside it, `steps` AdamW
    steps from `paddle.seed(11)`."""
    p.seed(11)
    m, opt, step_fn = tiny_training(p)
    scaler = p.amp.GradScaler(init_loss_scaling=512.0,
                              incr_every_n_steps=2)
    for i in range(steps):
        step_fn(i)
        scaler._update()
    p.rand([3])                     # move the RNG counter
    return m, opt, scaler


def _state(p, m, opt, scaler):
    sd = {k: _np(t) for k, t in m.state_dict().items()}
    for k, v in opt.state_dict().items():
        sd["opt." + k] = _np(v) if hasattr(v, "_data") else v
    sd["scale"] = scaler.get_loss_scaling()
    sd["rng"] = [tuple(s) for s in p.get_rng_state()]
    return sd


@pytest.mark.parametrize("writer", ["jax", "port"])
def test_manager_checkpoint_crosses_packages_bit_for_bit(tmp_path, writer):
    """A CheckpointManager directory with the model, AdamW's moments and
    beta powers, `global_step`, the GradScaler and the RNG state, written
    by one package and restored by the other into a fresh model: every
    tensor, scalar and counter equal."""
    src_p, dst_p = (jpaddle, tpaddle) if writer == "jax" \
        else (tpaddle, jpaddle)
    src_cls, dst_cls = (JManager, CheckpointManager) if writer == "jax" \
        else (CheckpointManager, JManager)
    m, opt, scaler = _trained(src_p)
    want = _state(src_p, m, opt, scaler)
    src_cls(str(tmp_path), sleep=lambda s: None).save(
        3, model=m, optimizer=opt, scaler=scaler)
    dst_p.seed(0)
    m2, opt2, _ = tiny_training(dst_p, seed=99)
    scaler2 = dst_p.amp.GradScaler()
    res = dst_cls(str(tmp_path), sleep=lambda s: None).restore_latest(
        model=m2, optimizer=opt2, scaler=scaler2)
    assert res.step == 3
    got = _state(dst_p, m2, opt2, scaler2)
    assert set(got) == set(want)
    for k in want:
        if isinstance(want[k], np.ndarray):
            np.testing.assert_array_equal(np.asarray(got[k]), want[k],
                                          err_msg=k)
        else:
            assert got[k] == want[k], k


def test_guard_rollback_restores_jax_equal_state(tmp_path):
    """The same guarded run in both packages (NaN at step 3, checkpoints
    every step): the state after the rollback and one replayed step is
    the JAX package's."""
    def run(p, cls, gcls, inject):
        m, opt, step_fn = tiny_training(p)
        cm = cls(str(tmp_path / p.__name__), sleep=lambda s: None)
        guard = gcls(step_fn, cm, model=m, optimizer=opt, save_every=1)
        for i in range(3):
            guard.step(i)
        inject()
        assert guard.step(3) is None and guard.last_step == 2
        guard.step(3)
        return {k: _np(t) for k, t in m.state_dict().items()}

    from paddle_tpu.resilience import StepGuard as JGuard
    from paddle_tpu.resilience import faults as jfaults

    want = run(jpaddle, JManager, JGuard,
               lambda: jfaults.inject("guard.nan_loss", times=1))
    got = run(tpaddle, CheckpointManager, StepGuard,
              lambda: faults.inject("guard.nan_loss", times=1))
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-5, atol=1e-6,
                                   err_msg=k)


@pytest.mark.parametrize("writer", ["jax", "port"])
@pytest.mark.parametrize("backend", ["weight_only_int4", "fp8"])
def test_quantized_model_checkpoint_crosses_packages(tmp_path, writer,
                                                     backend):
    """A PTQ-deployed model's CheckpointManager directory (packed int4 or
    fp8 weights, f32 scales, biases) restores in the other package with
    every buffer's bytes equal."""
    x = np.random.default_rng(5).normal(size=(4, 16)).astype(np.float32)

    def deployed(p, seed):
        p.seed(seed)
        m = p.nn.Sequential(p.nn.Linear(16, 32), p.nn.ReLU(),
                            p.nn.Linear(32, 8))
        ptq = p.quantization.PTQ(p.quantization.QuantConfig())
        observed = ptq.quantize(m)
        observed(p.to_tensor(x))
        return ptq.convert(observed, deploy_backend=backend)

    def raw(m):
        return {k: np.asarray(v.numpy()).view(np.uint8)
                for k, v in m.state_dict().items()}

    src_p, dst_p = (jpaddle, tpaddle) if writer == "jax" \
        else (tpaddle, jpaddle)
    src_cls, dst_cls = (JManager, CheckpointManager) if writer == "jax" \
        else (CheckpointManager, JManager)
    src = deployed(src_p, 0)
    src_cls(str(tmp_path), sleep=lambda s: None).save(0, model=src)
    dst = deployed(dst_p, 1)
    dst_cls(str(tmp_path), sleep=lambda s: None).restore_latest(model=dst)
    want, got = raw(src), raw(dst)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)


def test_resilient_train_rehearsal(tmp_path):
    """`chip_smoke.py`'s resilient_train on the tiny sparse Llama: 8 steps
    under StepGuard(save_every=3) over an async CheckpointManager
    (keep_last_n=2), NaN once at step 6; one rollback to step 5, every
    loss and the final state bit-equal to an uninterrupted run; then a
    flipped byte in the newest checkpoint is quarantined and step 2
    restores bit for bit."""
    from paddle_tpu_torch.tools import resilience_workload as rw

    def host(work):
        return {k: v.detach().clone()
                for k, v in rw.model_state(work[0], work[1]).items()}

    work = rw.sparse_workload(tpaddle, True, tiny=True)
    plain, at2 = [], None
    for i in range(8):
        plain.append(float(rw.f32(rw.train_step(tpaddle, work))))
        if i == 2:
            at2 = host(work)
    final = host(work)
    work = rw.sparse_workload(tpaddle, True, tiny=True)
    cm = CheckpointManager(str(tmp_path), keep_last_n=2, async_save=True)
    losses, rollbacks, _ = rw.guarded_run(tpaddle, work, cm, 8, 6, 3)
    assert rollbacks == [5]
    assert [losses[i] for i in range(8)] == plain
    got = host(work)
    assert all(torch.equal(got[k], final[k]) for k in final)
    _flip(str(tmp_path / "step_000005" / "0_0.distcp"), back=100)
    assert cm.latest_valid()[0] == 2
    assert cm.restore_latest(model=work[0], optimizer=work[1]).step == 2
    got = host(work)
    assert all(torch.equal(got[k], at2[k]) for k in at2)
