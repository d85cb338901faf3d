"""The elastic-training workloads, in one place for `chip_smoke.py` (its
`elastic_reference` and `elastic_train` phases) and the tests that
rehearse them on the CPU: the port's counterpart of
`tools/train_chaos_smoke.py`.

- `chaos_smoke(paddle, root, device)`: the chaos scenario on the
  emulated world: an `ElasticTrainSupervisor` trains
  `EmulatedTrainable` at world `N_PODS` (parameters and momentum
  sharded over `world`, a heartbeat and a checkpoint every step); an
  armed `train.step` fault kills the busiest pod in the middle of step
  `KILL_AT`; the supervisor fences the dead epoch, re-forms to
  `N_PODS - 1`, reshards the latest checkpoint and resumes. Checks the
  resumed losses `repr`-equal to an unkilled world-7 run restored from
  the same checkpoint, the counters, the gauge, the stale-incarnation
  rejection, the forensics dump, no quarantined directory, and the
  world-8 checkpoint restored at world 4 bit for bit; returns what the
  card is held to the CPU on.
- `collective_cases(paddle, device)`: `shard_tensor` / `reshard` and
  every eager collective on rank-stacked tensors, as numpy arrays.
- `checkpoint_reshard(paddle, root, device)`: a dp2 x mp4 save loaded
  at dp4 x mp2, shard by shard.
- `LlamaTrainable(paddle, world, tiny)`: the `resilient_train` phase's
  model and optimizer at `LAYERS` layers
  (`resilience_workload.sparse_workload`: the JAX Llama as Layers, O2
  bf16 by `amp.decorate`, AdamW with `lazy_mode` and
  `multi_precision`, the Trainer's clip and schedule) with a
  `GradScaler`, its state placed by `EmulatedTrainable`'s rule (the
  leading dim `Shard(0)` over `world` iff it divides, else replicated)
  through `shard_layer` and `shard_optimizer`.
- `elastic_run(paddle, manager, build, pods, steps, kills, flight_dir)`:
  the `elastic_train` phase's supervised run (`MIN_WORLD`,
  `REFORM_BUDGET`, a save every `SAVE_EVERY` steps), killing a pod at each
  `(world, after_n)` of `kills`.
"""
from __future__ import annotations

import json
import os
import time

import numpy as np

from . import loop_workload as lw
from . import resilience_workload as rw

__all__ = ["N_PODS", "STEPS", "KILL_AT", "MIN_WORLD", "REFORM_BUDGET",
           "LAYERS", "SAVE_EVERY", "chaos_smoke", "collective_cases", "checkpoint_reshard",
           "LlamaTrainable", "elastic_run", "reference_from_restored",
           "state_equal", "flight_dumps"]

N_PODS = 8
STEPS = 14
KILL_AT = 7
MIN_WORLD = 2
REFORM_BUDGET = 2
LAYERS = 1                  # of Llama-2-7B's 32: one checkpoint ~6.5 GB
SAVE_EVERY = 2              # elastic_run's saves: after steps 1, 3, 5
SEED = 0
INIT_LOSS_SCALING = 2.0 ** 15


def _manager(store_path, n):
    from ..distributed.elastic import ElasticManager, MembershipStore

    store = MembershipStore(store_path, ttl=1000.0)
    mgr = ElasticManager(store, min_nodes=1, max_nodes=n, stabilize_s=0.0,
                         sleep=lambda s: None)
    return store, mgr


def flight_dumps(flight_dir):
    """[(header, first line)] of each `flight_elastic_reform_*.jsonl`, in
    the order they were written."""
    out = []
    names = sorted((f for f in os.listdir(flight_dir)
                    if f.startswith("flight_elastic_reform")),
                   key=lambda f: os.path.getmtime(os.path.join(flight_dir,
                                                               f)))
    for name in names:
        with open(os.path.join(flight_dir, name)) as f:
            out.append((json.loads(f.readline()), json.loads(f.readline())))
    return out


def reference_from_restored(ckpt, build, world, restored, steps):
    """Unkilled reference at `world`, restored from the checkpoint of step
    `restored`: `({step: loss}, trainable)` for the steps after it."""
    tr = build(world)
    ckpt.load(os.path.join(ckpt.root, f"step_{restored:06d}"),
              state_dict=tr.state_dict(), placements=tr.placements())
    return {i: tr.step(i) for i in range(restored + 1, steps)}, tr


def chaos_smoke(paddle, root, device=None):
    """The chaos scenario (module docstring) under `root`; raises
    AssertionError on a failed check. Returns the losses, the victim,
    the worlds, the restored step, the counters' moves, the recovery
    ms, the world-7 replay, the gathered state and the world-4 restore."""
    from ..framework import monitor
    from ..observability import timeline
    from ..resilience import (CheckpointManager, ElasticTrainSupervisor,
                              faults, make_emulated_trainable)

    flight = os.path.join(root, "flight")
    timeline.configure(flight_dir=flight)
    pods = [f"pod{i}" for i in range(N_PODS)]
    store, mgr = _manager(os.path.join(root, "members.json"), N_PODS)
    ckpt = CheckpointManager(os.path.join(root, "ckpt"),
                             keep_last_n=STEPS + 1)
    m0 = {k: monitor.get(k) for k in ("elastic.reforms", "elastic.lost_pods",
                                      "elastic.stale_heartbeats")}
    build = make_emulated_trainable(device=device)
    sup = ElasticTrainSupervisor(build, mgr, ckpt, pods,
                                 min_world=MIN_WORLD, save_every=1,
                                 reform_budget=REFORM_BUDGET,
                                 quorum_deadline_s=5.0)
    sup.start()
    pre_kill = dict(sup._incarnations)
    faults.inject("train.step", after_n=KILL_AT, times=1, action="flag")
    try:
        losses = sup.run(STEPS)
    finally:
        sup.close()
        faults.clear()
    victim = sorted(set(pods) - set(sup.world))
    restored = sup.last_restored_step
    moved = {k: monitor.get(k) - v for k, v in m0.items()}
    if sup.reforms != 1 or len(sup.world) != N_PODS - 1 or \
            victim != [f"pod{N_PODS - 1}"] or restored != KILL_AT - 1 or \
            sorted(losses) != list(range(STEPS)):
        raise AssertionError(f"chaos_smoke: reforms {sup.reforms}, world "
                             f"{sup.world}, restored {restored}")
    if moved["elastic.reforms"] != 1 or moved["elastic.lost_pods"] != 1:
        raise AssertionError(f"chaos_smoke: counters {moved}")
    recovery_ms = monitor.get("elastic.recovery_ms")
    if not recovery_ms or recovery_ms != sup.last_recovery_ms:
        raise AssertionError(f"chaos_smoke: recovery gauge {recovery_ms}")
    # the dead epoch's incarnation cannot write
    if store.heartbeat("pod0", incarnation=pre_kill["pod0"]) is not False \
            or monitor.get("elastic.stale_heartbeats") <= \
            m0["elastic.stale_heartbeats"] or victim[0] in store.alive():
        raise AssertionError("chaos_smoke: a stale incarnation wrote")
    ref, _ = reference_from_restored(ckpt, build, sup.world, restored,
                                     STEPS)
    bad = {i: (repr(losses[i]), repr(v)) for i, v in ref.items()
           if repr(v) != repr(losses[i])}
    if bad:
        raise AssertionError(f"chaos_smoke: replay diverged {bad}")
    (header, first), = flight_dumps(flight)
    if header["lost_pods"] != victim or header["restored_step"] != restored \
            or first["lost_pod"] != victim[0] or \
            first["final_payload"]["step"] != restored or \
            "loss" not in first["final_payload"]:
        raise AssertionError(f"chaos_smoke: dump {header} {first}")
    quarantined = [d for d in os.listdir(ckpt.root)
                   if d.startswith("QUARANTINED-")]
    if quarantined:
        raise AssertionError(f"chaos_smoke: quarantined {quarantined}")
    # the same kind of world-8 checkpoint restores at world 4 bit for bit,
    # genuinely re-sliced (4 shards of 2 rows)
    tr8 = build(pods)
    ckpt8 = CheckpointManager(os.path.join(root, "ckpt8"))
    for i in range(3):
        tr8.step(i)
    ckpt8.save(2, state_dict=tr8.state_dict())
    tr4 = make_emulated_trainable(seed=123, device=device)(pods[:4])
    res = ckpt8.restore_latest(state_dict=tr4.state_dict(),
                               placements=tr4.placements())
    full8, full4 = tr8.gather(), tr4.gather()
    shard_rows = [tuple(v.shape) for _, _, v in
                  tr4.state_dict()["w"].local_shards()]
    if res.step != 2 or any(not np.array_equal(full8[k], full4[k])
                            for k in full8) or shard_rows != [(2, 8)] * 4:
        raise AssertionError(f"chaos_smoke: world-4 restore {shard_rows}")
    return {"losses": {i: losses[i] for i in sorted(losses)},
            "victim": victim, "world": f"{N_PODS}->{len(sup.world)}",
            "restored": restored, "moved": moved,
            "recovery_ms": recovery_ms, "replayed": sorted(ref),
            "state": sup.trainable.gather(), "world4_shards": shard_rows,
            "header": {k: header[k] for k in ("lost_pods", "old_world",
                                              "new_world", "restored_step",
                                              "cause", "reforms")}}


def collective_cases(paddle, device=None):
    """`shard_tensor`, `reshard` (s->r, s->s', p->r, p->s, r->p) and every
    eager collective on rank-stacked tensors over 8 ranks, from
    `default_rng(0)`; `{case: numpy array}`."""
    from ..distributed.process_mesh import emulated_world, \
        set_emulated_world

    d = paddle.distributed
    prev = emulated_world()
    set_emulated_world(8)
    try:
        rng = np.random.default_rng(0)
        vals = rng.standard_normal((8, 16)).astype(np.float32)

        def t(a):
            return paddle.to_tensor(np.array(a, copy=True), place=device)

        mesh = d.ProcessMesh(np.arange(8), ["x"])
        mesh2 = d.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
        out = {}
        xs = d.shard_tensor(t(vals), mesh, [d.Shard(0)])
        out["shard"] = np.stack([v.cpu().numpy() for _, _, v in
                                 xs.local_shards()])
        out["s_to_r"] = d.reshard(xs, mesh, [d.Replicate()]).numpy()
        out["s_to_s"] = np.concatenate(
            [v.cpu().numpy() for _, _, v in
             d.reshard(xs, mesh, [d.Shard(1)]).local_shards()], axis=1)
        xp = d.shard_tensor(t(vals), mesh2, [d.Partial(), d.Shard(1)])
        out["p_to_r"] = d.reshard(xp, mesh2,
                                  [d.Replicate(), d.Replicate()]).numpy()
        out["p_to_s"] = d.reshard(xp, mesh2,
                                  [d.Shard(0), d.Replicate()]).numpy()
        out["r_to_p"] = np.stack([v.cpu().numpy() for _, _, v in d.reshard(
            d.shard_tensor(t(vals), mesh2), mesh2,
            [d.Partial("max"), d.Shard(0)]).local_shards()])

        def stacked():
            return d.shard_tensor(t(vals), mesh, [d.Shard(0)])

        for op in ("SUM", "AVG", "MAX", "MIN", "PROD"):
            s = stacked()
            d.all_reduce(s, op=getattr(d.ReduceOp, op))
            out[f"all_reduce_{op.lower()}"] = s.numpy()
        s = stacked()
        d.reduce(s, dst=3)
        out["reduce"] = s.numpy()
        s = stacked()
        d.broadcast(s, src=5)
        out["broadcast"] = s.numpy()
        got = []
        d.all_gather(got, stacked())
        out["all_gather"] = np.stack([g.numpy() for g in got])
        s = stacked()
        d.reduce_scatter(s)
        out["reduce_scatter"] = s.numpy()
        parts = [t(vals[i, :2]) for i in range(8)]
        s = t(np.zeros((16,), np.float32))
        d.scatter(s, parts)
        out["scatter"] = s.numpy()
        got = []
        d.alltoall(got, parts)
        out["alltoall"] = np.stack([g.numpy() for g in got])
        s = t(np.zeros((8, 16), np.float32))
        d.alltoall_single(s, stacked())
        out["alltoall_single"] = s.numpy()
        out["shift"] = d.communication.collective.p2p_shift(
            stacked(), 3).numpy()
        box = t(np.zeros((16,), np.float32))
        d.send(t(vals[2]), dst=1)
        d.recv(box, src=0)
        out["send_recv"] = box.numpy()
        d.barrier()
        return out
    finally:
        set_emulated_world(prev)


def checkpoint_reshard(paddle, root, device=None):
    """A dp2 x mp4 save (column- and row-parallel weights, a bf16 one)
    loaded at dp4 x mp2: `{key: (saved value, loaded value, loaded shard
    count, files written)}`."""
    d = paddle.distributed
    rng = np.random.default_rng(0)
    vals = {"w1": rng.standard_normal((16, 8)).astype(np.float32),
            "w2": rng.standard_normal((8, 12)).astype(np.float32),
            "bf": rng.standard_normal((16, 4)).astype(np.float32)}
    specs = {"w1": lambda: [d.Replicate(), d.Shard(1)],
             "w2": lambda: [d.Replicate(), d.Shard(0)],
             "bf": lambda: [d.Shard(0), d.Shard(1)]}

    def build(shape, zeros):
        mesh = d.ProcessMesh(np.arange(8).reshape(shape), ["dp", "mp"])
        st = {}
        for k, v in vals.items():
            x = paddle.to_tensor(np.zeros_like(v) if zeros else v,
                                 place=device)
            if k == "bf":
                x = x.astype("bfloat16")
            st[k] = d.shard_tensor(x, mesh, specs[k]())
        return st

    src = build((2, 4), False)
    d.save_state_dict(src, root)
    dest = build((4, 2), True)
    d.load_state_dict(dest, root)
    files = sorted(f for f in os.listdir(root) if f.endswith(".distcp"))
    return {k: (src[k].astype("float32").numpy(),
                dest[k].astype("float32").numpy(),
                len(dest[k].local_shards()), files) for k in vals}


# ---- Llama-2-7B width: elastic_train ----------------------------------------


class LlamaTrainable:
    """`resilience_workload.sparse_workload`'s Llama (`LAYERS` layers,
    `llama_tiny`'s widths if `tiny`) and AdamW with a
    `GradScaler`, its state placed over the 1-D `world` mesh of `world`'s
    pods by `EmulatedTrainable`'s rule through `shard_layer` and
    `shard_optimizer` (moments and f32 masters follow their parameter).
    The optimizer's state is made at build time, so `state_dict()` holds
    every tensor a checkpoint restores into; a step `i` sets the
    schedule's epoch to `i`, so a restored run's learning rates are the
    uninterrupted run's. `step_ms` lists each step's wall ms (the loss
    read on the host ends it)."""

    def __init__(self, paddle, world, tiny=False):
        from ..distributed.auto_parallel import sharding_bridge as sb

        d = paddle.distributed
        self.paddle = paddle
        self.world = list(world)
        n = len(self.world)
        self.mesh = d.ProcessMesh(np.arange(n), ["world"])
        model, opt, sched, ids, labels = rw.sparse_workload(
            paddle, True, layers=LAYERS, seed=SEED, tiny=tiny)

        def rule(shape):
            return [d.Shard(0) if shape and shape[0] % n == 0
                    else d.Replicate()]

        def shard_fn(name, layer, mesh):
            for p in layer.parameters(include_sublayers=False):
                sb.set_meta(p, sb.DistMeta(mesh, rule(p.shape)))

        d.shard_layer(model, self.mesh, shard_fn)
        self.opt = d.shard_optimizer(opt, mesh=self.mesh)
        for p in model.parameters():
            self.opt._ensure_state(p)
        self.model, self.sched = model, sched
        self.ids, self.labels = ids, labels
        self.scaler = paddle.amp.GradScaler(
            init_loss_scaling=INIT_LOSS_SCALING)
        self._state = rw.model_state(model, opt)
        self.step_ms = []

    def state_dict(self):
        return self._state

    def placements(self):
        from ..distributed.auto_parallel import sharding_bridge as sb

        return {k: sb.meta_of(t) for k, t in self._state.items()}

    def step(self, step_idx: int) -> float:
        paddle = self.paddle
        t0 = time.perf_counter()
        self.sched.step(step_idx)
        with paddle.amp.auto_cast(level="O2"):
            logits = self.model(self.ids)
        loss = lw._loss(paddle, logits, self.labels,
                        self.model.config.vocab_size)
        del logits
        self.scaler.scale(loss).backward()
        self.scaler.step(self.opt)
        self.scaler.update()
        self.opt.clear_grad()
        out = float(rw.f32(loss))
        self.step_ms.append((time.perf_counter() - t0) * 1e3)
        return out


def state_equal(a, b) -> list:
    """The keys whose tensors differ between two trainables' states (on
    their device, bit for bit)."""
    import torch

    sa, sb_ = a.state_dict(), b.state_dict()
    if set(sa) != set(sb_):
        return sorted(set(sa) ^ set(sb_))
    return [k for k in sa if not torch.equal(sa[k], sb_[k])]


def elastic_run(paddle, manager, build, pods, steps, kills, flight_dir):
    """`steps` steps under an `ElasticTrainSupervisor` over `manager` (a
    `CheckpointManager`), starting at `pods`; `kills` is
    `[(world, after_n)]`: once the supervisor builds the trainable at
    `world` pods, the `train.step` fault kills the busiest pod after
    `after_n` more steps. Returns the supervisor, the membership store,
    the first incarnations, the losses and the recovery ms of each
    re-form (`flight_dumps(flight_dir)` names each re-form's lost pods
    and restored step)."""
    from ..observability import timeline
    from ..resilience import ElasticTrainSupervisor, faults

    timeline.configure(flight_dir=flight_dir)
    store, mgr = _manager(os.path.join(os.path.dirname(manager.root),
                                       "members.json"), len(pods))
    plan = dict(kills)
    recovery = []
    holder = {}

    def build_and_arm(world):
        sup = holder.get("sup")
        if sup is not None and sup.reforms >= 2:
            recovery.append(sup.last_recovery_ms)   # the previous re-form's
        tr = build(world)
        if len(world) in plan:
            faults.inject("train.step", after_n=plan.pop(len(world)),
                          times=1, action="flag")
        return tr

    sup = ElasticTrainSupervisor(build_and_arm, mgr, manager, pods,
                                 min_world=MIN_WORLD, save_every=SAVE_EVERY,
                                 reform_budget=REFORM_BUDGET,
                                 quorum_deadline_s=5.0)
    holder["sup"] = sup
    sup.start()
    first_incs = dict(sup._incarnations)
    try:
        losses = sup.run(steps)
    finally:
        sup.close()
        faults.clear()
    if sup.reforms:
        recovery.append(sup.last_recovery_ms)
    return sup, store, first_incs, losses, recovery
