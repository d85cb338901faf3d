"""The single-controller distributed core on the CPU, held to the JAX
package: every case of `tests/test_distributed_core.py` (ProcessMesh,
placements, `shard_tensor` / `reshard`, `dtensor_from_local`,
`shard_layer`, `shard_optimizer`, the collectives, groups,
`DataParallel`) run on both packages from the same numpy inputs, the
port over 8 emulated ranks (`set_emulated_world(8)`) and the JAX package
over its 8 virtual CPU devices (`tests/conftest.py`).

Held: placements, shard counts, offsets and shapes, and host logic
exactly; copies and reshards bit for bit (each rank's shard against the
JAX device's); reductions float32 `rtol=1e-6`; matmuls `rtol=1e-5`.
"""

import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu.distributed as jdist
import paddle_tpu_torch as tpaddle
import paddle_tpu_torch.distributed as tdist
from paddle_tpu_torch.core import lazy
from paddle_tpu_torch.distributed.auto_parallel import sharding_bridge as sb
from paddle_tpu_torch.distributed.communication import collective as tcoll
from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

PKGS = ((jpaddle, jdist), (tpaddle, tdist))
RED = dict(rtol=1e-6, atol=0)
MATMUL = dict(rtol=1e-5, atol=1e-6)


@pytest.fixture(autouse=True)
def _env():
    tdist.set_emulated_world(8)
    jdist.init_parallel_env()
    tdist.init_parallel_env()
    yield
    tdist.set_emulated_world(None)


def _np(t):
    d = t._data if hasattr(t, "_data") else t
    if isinstance(d, torch.Tensor):
        return d.detach().cpu().numpy()
    return np.asarray(d)


def shards(d, t):
    """[(rank / device id, global offset, numpy)] in rank order."""
    if d is tdist:     # a Tensor, or an optimizer's torch moment
        return [(r, tuple(o), v.detach().numpy())
                for r, o, v in sb.local_shards(t)]
    out = []
    for s in getattr(t, "_data", t).addressable_shards:
        off = tuple(0 if sl.start is None else int(sl.start)
                    for sl in s.index)
        out.append((int(s.device.id), off, np.asarray(s.data)))
    return sorted(out, key=lambda e: e[0])


def same_shards(a, b):
    assert [(r, o, v.shape) for r, o, v in a] == \
        [(r, o, v.shape) for r, o, v in b]
    for (_, _, x), (_, _, y) in zip(a, b):
        np.testing.assert_array_equal(x, y)


def both(fn):
    """`fn(paddle, dist)` on the JAX package, then on the port."""
    return [fn(p, d) for p, d in PKGS]


def T(p, a):
    return p.to_tensor(np.array(a, copy=True))


# -- mesh and placements -----------------------------------------------------

def test_process_mesh_basics():
    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
        sub = mesh.get_mesh_with_dim("mp")
        return (mesh.shape, mesh.ndim, mesh.get_dim_size("mp"),
                mesh.process_ids, sub.dim_names, sub.shape,
                mesh == d.ProcessMesh(np.arange(8).reshape(2, 4),
                                      ["dp", "mp"]),
                mesh.get_rank_by_dim_and_process_id("mp", 6),
                repr(mesh), mesh[1].process_ids)
    j, t = both(case)
    assert j == t
    assert t[:4] == ([2, 4], 2, 4, list(range(8)))


def test_default_mesh_spans_the_emulated_world():
    assert tdist.emulated_world() == 8
    assert tdist.default_mesh().shape == [8] == [jdist.process_mesh
                                                 .default_mesh().size]
    assert tdist.get_mesh() is not None and \
        tdist.get_mesh().dim_names == ["world"]
    tdist.set_emulated_world(3)
    assert tdist.default_mesh().process_ids == [0, 1, 2]
    with pytest.raises(ValueError):
        tdist.set_emulated_world(0)


def test_placements():
    def case(p, d):
        return (d.Shard(0) == d.Shard(0), d.Shard(0) != d.Shard(1),
                d.Replicate().is_replicated(), d.Partial().is_partial(),
                d.Shard(1).is_shard(1), d.Shard(1).is_shard(0),
                d.Shard(1).is_shard(), hash(d.Shard(2)) == hash(d.Shard(2)),
                len({d.Replicate(), d.Replicate(), d.Partial("max"),
                     d.Partial()}),
                repr(d.Shard(3)), repr(d.Partial()), repr(d.Replicate()),
                d.Replicate().is_shard(), d.Partial("max") == d.Partial())
    j, t = both(case)
    assert j == t


# -- shard_tensor / reshard --------------------------------------------------

def test_shard_tensor_shard_and_replicate():
    x = np.arange(64, dtype=np.float32).reshape(8, 8)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["x"])
        xs = d.shard_tensor(T(p, x), mesh, [d.Shard(0)])
        xr = d.shard_tensor(T(p, x), mesh, [d.Replicate()])
        return (xs.shape, d.auto_parallel.placements_of(xs),
                shards(d, xs), shards(d, xr), _np(xs))
    j, t = both(case)
    assert t[0] == [8, 8] == j[0]
    assert [repr(a) for a in j[1]] == [repr(a) for a in t[1]]
    assert len(t[2]) == 8 and t[2][0][2].shape == (1, 8)
    assert t[3][0][2].shape == (8, 8)
    same_shards(j[2], t[2])
    same_shards(j[3], t[3])
    np.testing.assert_array_equal(t[4], x)


def test_reshard_s_to_r_and_s_to_s():
    x = np.random.default_rng(0).random((8, 16)).astype(np.float32)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["x"])
        xs = d.shard_tensor(T(p, x), mesh, [d.Shard(0)])
        xr = d.reshard(xs, mesh, [d.Replicate()])
        x1 = d.reshard(xs, mesh, [d.Shard(1)])  # all-to-all
        return shards(d, xr), shards(d, x1), _np(xr), _np(x1)
    j, t = both(case)
    assert t[0][0][2].shape == (8, 16) and t[1][0][2].shape == (8, 2)
    same_shards(j[0], t[0])
    same_shards(j[1], t[1])
    np.testing.assert_array_equal(t[2], x)
    np.testing.assert_array_equal(t[3], x)


def test_partial_to_replicate():
    x = np.full((8, 4), 3.0, np.float32)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["x"])
        xp = d.shard_tensor(T(p, x), mesh, [d.Partial()])
        xr = d.reshard(xp, mesh, [d.Replicate()])
        xs = d.reshard(xp, mesh, [d.Shard(0)])  # p->s: reduce-scatter
        return (d.auto_parallel.placements_of(xp)[0].is_partial(),
                shards(d, xp), _np(xr), shards(d, xs))
    j, t = both(case)
    assert t[0] and j[0]
    # slot 0 carries the value, the neutral slots are zeros
    same_shards(j[1], t[1])
    assert [v.shape for _, _, v in t[1]] == [(1, 8, 4)] * 8
    assert (t[1][1][2] == 0).all() and (t[1][0][2] == 3.0).all()
    np.testing.assert_allclose(t[2], np.full((8, 4), 3.0), **RED)
    same_shards(j[3], t[3])
    assert t[3][0][2].shape == (1, 4)


@pytest.mark.parametrize("kind", ["sum", "avg", "max", "min", "prod"])
def test_partial_kinds_round_trip(kind):
    x = np.random.default_rng(1).random((4, 8)).astype(np.float32) + 0.5

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8).reshape(2, 4), ["a", "b"])
        xp = d.shard_tensor(T(p, x), mesh, [d.Partial(kind), d.Shard(1)]
                            if kind != "prod" else
                            [d.Partial(kind), d.Replicate()])
        return shards(d, xp), _np(d.reshard(xp, mesh,
                                            [d.Replicate(), d.Shard(0)]))
    j, t = both(case)
    same_shards(j[0], t[0])
    np.testing.assert_allclose(t[1], j[1], **RED)


def test_two_axes_split_one_dim_like_jax():
    """A dim split over two mesh axes takes JAX's block order (the first
    mesh axis the most significant), on either axis order."""
    x = np.arange(16 * 4, dtype=np.float32).reshape(16, 4)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8).reshape(2, 4), ["a", "b"])
        return (shards(d, d.shard_tensor(T(p, x), mesh,
                                         [d.Shard(0), d.Shard(0)])),
                shards(d, d.shard_tensor(T(p, x), mesh,
                                         [d.Replicate(), d.Shard(0)])),
                shards(d, d.shard_tensor(T(p, x), mesh,
                                         [d.Shard(1), d.Shard(0)])))
    j, t = both(case)
    for a, b in zip(j, t):
        same_shards(a, b)


def test_non_divisible_shard_raises_where_jax_raises():
    for p, d in PKGS:
        mesh = d.ProcessMesh(np.arange(8).reshape(2, 4), ["a", "b"])
        with pytest.raises(ValueError, match="divisible by 4"):
            d.shard_tensor(T(p, np.zeros((7, 3), np.float32)), mesh,
                           [d.Replicate(), d.Shard(0)])
        with pytest.raises(ValueError, match="out of range"):
            d.shard_tensor(T(p, np.zeros((4,), np.float32)), mesh,
                           [d.Shard(1), d.Replicate()])


def test_2d_mesh_tp_dp_matmul_propagates():
    rng = np.random.default_rng(2)
    x = rng.random((4, 16)).astype(np.float32)
    w = rng.random((16, 8)).astype(np.float32)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
        xd = d.shard_tensor(T(p, x), mesh, [d.Shard(0), d.Replicate()])
        wd = d.shard_tensor(T(p, w), mesh, [d.Replicate(), d.Shard(1)])
        return _np(p.matmul(xd, wd))
    j, t = both(case)
    np.testing.assert_allclose(t, x @ w, **MATMUL)
    np.testing.assert_allclose(t, j, **MATMUL)


def test_dtensor_from_to_local():
    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["x"])
        local = T(p, np.arange(8, dtype=np.float32).reshape(2, 4))
        gt = d.dtensor_from_local(local, mesh, [d.Shard(0)])
        back = d.dtensor_to_local(gt)
        rep = d.unshard_dtensor(gt)
        return (gt.shape, back.shape, rep.shape, _np(gt), _np(back),
                shards(d, gt), d.auto_parallel.is_dist_tensor(rep))
    j, t = both(case)
    assert t[:3] == j[:3] == ([16, 4], [2, 4], [16, 4])
    for a, b in zip(j[3:5], t[3:5]):
        np.testing.assert_array_equal(a, b)
    same_shards(j[5], t[5])
    assert t[6] is False


def _linear(p, n_in, n_out, seed=0):
    rng = np.random.default_rng(seed)
    m = p.nn.Linear(n_in, n_out)
    m.weight.set_value(rng.standard_normal((n_in, n_out)).astype("float32"))
    m.bias.set_value(rng.standard_normal((n_out,)).astype("float32"))
    return m


def test_shard_layer_and_optimizer_stage1():
    x = np.random.default_rng(3).random((8, 16)).astype(np.float32)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["dp"])
        model = _linear(p, 16, 16)
        d.shard_layer(model, mesh)  # replicate params
        opt = p.optimizer.AdamW(parameters=model.parameters())
        opt = d.shard_optimizer(opt, d.ShardingStage1(), mesh=mesh)
        loss = (model(T(p, x)) ** 2).mean()
        loss.backward()
        opt.step()
        acc = opt._inner._accumulators["moment1"][id(model.weight)]
        sh = shards(d, acc)
        opt.clear_grad()
        return (d.auto_parallel.is_dist_tensor(model.weight),
                [repr(a) for a in d.auto_parallel.placements_of(
                    model.weight)], _np(model.weight), sh)
    j, t = both(case)
    assert t[0] and j[0] and t[1] == j[1]
    np.testing.assert_allclose(t[2], j[2], **MATMUL)
    assert len(t[3]) == 8 and t[3][0][2].shape[0] == 2  # 16 / 8
    assert [(r, o, v.shape) for r, o, v in j[3]] == \
        [(r, o, v.shape) for r, o, v in t[3]]
    for (_, _, a), (_, _, b) in zip(j[3], t[3]):
        np.testing.assert_allclose(b, a, **MATMUL)


def test_shard_optimizer_stage3_shards_params():
    x = np.random.default_rng(4).random((4, 16)).astype(np.float32)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["dp"])
        model = _linear(p, 16, 16, seed=1)
        opt = p.optimizer.SGD(parameters=model.parameters())
        opt = d.shard_optimizer(opt, d.ShardingStage3(), mesh=mesh)
        meta = d.auto_parallel.placements_of(model.weight)
        loss = model(T(p, x)).sum()
        loss.backward()
        opt.step()
        return [repr(a) for a in meta], _np(model.weight), \
            shards(d, model.weight)
    j, t = both(case)
    assert t[0] == j[0] == ["Shard(dim=0)"]
    assert np.isfinite(t[1]).all()
    np.testing.assert_allclose(t[1], j[1], **MATMUL)
    assert [v.shape for _, _, v in t[2]] == [v.shape for _, _, v in j[2]]


def test_sharded_optimizer_masters_follow_their_parameter():
    """Under `amp.decorate(level="O2")` a bf16 parameter's f32 master
    takes the parameter's placements (the JAX package's master is its
    `astype`, which keeps the sharding); without a stage the moments
    follow the parameter too, and the scalar beta powers stay plain."""
    mesh = tdist.ProcessMesh(np.arange(4), ["world"])
    model = _linear(tpaddle, 8, 6)
    opt = tpaddle.optimizer.AdamW(parameters=model.parameters(),
                                  multi_precision=True)
    model, opt = tpaddle.amp.decorate(model, opt, level="O2",
                                      dtype="bfloat16")
    tdist.shard_layer(model, mesh, lambda n, lyr, m: [
        tdist.auto_parallel.api._shard_param_inplace(
            q, m, [tdist.Shard(0)] if q.shape[0] % 4 == 0
            else [tdist.Replicate()])
        for q in lyr.parameters(include_sublayers=False)])
    opt = tdist.shard_optimizer(opt, mesh=mesh)
    with tpaddle.amp.auto_cast(level="O2"):
        y = model(T(tpaddle, np.ones((2, 8), np.float32)))
    y.astype("float32").sum().backward()
    opt.step()
    pid = id(model.weight)
    assert model.weight.dtype == tpaddle.bfloat16
    assert sb.meta_of(opt._master_weights[pid]).placements == \
        (tdist.Shard(0),)
    assert sb.meta_of(opt._accumulators["moment1"][pid]).placements == \
        (tdist.Shard(0),)
    assert sb.meta_of(opt._accumulators["moment1"][id(model.bias)]) \
        .placements == (tdist.Replicate(),)
    assert sb.meta_of(opt._accumulators["beta1_pow"][pid]) is None


# -- collectives ---------------------------------------------------------------

def _ranked(p, d, shape=(8, 4)):
    """Stacked per-rank tensor: rank r holds value r."""
    mesh = d.ProcessMesh(np.arange(8), ["x"])
    vals = np.stack([np.full(shape[1:], r, np.float32) for r in range(8)])
    return d.shard_tensor(T(p, vals), mesh, [d.Shard(0)])


def _coll(fn):
    j, t = both(fn)
    np.testing.assert_allclose(t, j, **RED)
    return t


def test_all_reduce_stacked():
    def case(p, d):
        t = _ranked(p, d)
        d.all_reduce(t)
        return _np(t)
    np.testing.assert_allclose(_coll(case), np.full((8, 4), 28.0))


def test_all_reduce_plain_replicated():
    def case(p, d):
        t = T(p, np.ones((3, 3), np.float32))
        d.all_reduce(t)
        return _np(t)
    np.testing.assert_allclose(_coll(case), np.full((3, 3), 8.0))


@pytest.mark.parametrize("op", ["MAX", "MIN", "PROD", "AVG"])
def test_all_reduce_ops(op):
    def case(p, d):
        t = _ranked(p, d)
        d.all_reduce(t, op=getattr(d.ReduceOp, op))
        return _np(t)
    want = {"MAX": 7.0, "MIN": 0.0, "PROD": 0.0, "AVG": 3.5}[op]
    np.testing.assert_allclose(_coll(case), np.full((8, 4), want))


def test_all_reduce_sum_is_rank_ordered():
    """The port's reduction over the stacked axis is rank-ordered: the
    same bits as a left fold in float32, on every call."""
    vals = np.random.default_rng(5).standard_normal((8, 64)) \
        .astype(np.float32) * 1e4
    t = tdist.shard_tensor(T(tpaddle, vals), tdist.ProcessMesh(
        np.arange(8), ["x"]), [tdist.Shard(0)])
    tdist.all_reduce(t)
    fold = vals[0].copy()
    for r in range(1, 8):
        fold = (fold + vals[r]).astype(np.float32)
    np.testing.assert_array_equal(_np(t)[3], fold)


def test_all_gather():
    def case(p, d):
        out = []
        d.all_gather(out, _ranked(p, d))
        return len(out), _np(out[3])
    j, t = both(case)
    assert t[0] == j[0] == 8
    np.testing.assert_array_equal(t[1], np.full((4,), 3.0))
    np.testing.assert_array_equal(t[1], j[1])


def test_broadcast():
    def case(p, d):
        t = _ranked(p, d)
        d.broadcast(t, src=5)
        return _np(t)
    np.testing.assert_array_equal(_coll(case), np.full((8, 4), 5.0))


def test_reduce_to_dst():
    def case(p, d):
        t = _ranked(p, d)
        d.reduce(t, dst=2)
        return _np(t)
    arr = _coll(case)
    np.testing.assert_allclose(arr[2], np.full((4,), 28.0))
    np.testing.assert_allclose(arr[1], np.full((4,), 1.0))


def test_scatter_and_alltoall():
    def case(p, d):
        parts = [T(p, np.full((2,), float(i), np.float32))
                 for i in range(8)]
        target = T(p, np.zeros((16,), np.float32))
        d.scatter(target, parts, src=0)
        out = []
        d.alltoall(out, parts)
        return (tuple(target._data.shape), _np(target), len(out),
                [_np(o) for o in out])
    j, t = both(case)
    assert t[0] == j[0] == (8, 2) and t[2] == j[2] == 8
    np.testing.assert_array_equal(t[1], j[1])
    np.testing.assert_array_equal(t[3][4], np.full((2,), 4.0))
    for a, b in zip(j[3], t[3]):
        np.testing.assert_array_equal(a, b)


def test_alltoall_single():
    def case(p, d):
        vals = np.arange(8 * 16, dtype=np.float32).reshape(8, 16)
        src = d.shard_tensor(T(p, vals), d.ProcessMesh(np.arange(8), ["x"]),
                             [d.Shard(0)])
        out = T(p, np.zeros((8, 16), np.float32))
        d.alltoall_single(out, src)
        return _np(out)
    j, t = both(case)
    np.testing.assert_array_equal(t, j)


def test_reduce_scatter():
    def case(p, d):
        t = _ranked(p, d, shape=(8, 16))
        d.reduce_scatter(t)
        return _np(t)
    arr = _coll(case)
    assert arr.shape == (8, 2)
    np.testing.assert_allclose(arr, np.full((8, 2), 28.0))


def test_reduce_scatter_list():
    def case(p, d):
        parts = [T(p, np.full((2,), float(i), np.float32))
                 for i in range(8)]
        t = T(p, np.zeros((2,), np.float32))
        d.reduce_scatter(t, parts)
        return _np(t)
    _coll(case)


def test_p2p_shift_and_mailbox():
    def case(p, d):
        shifted = d.communication.collective.p2p_shift(_ranked(p, d), 1)
        src = T(p, np.arange(4, dtype=np.float32))
        dst = T(p, np.zeros(4, np.float32))
        d.send(src, dst=0)
        d.recv(dst, src=0)
        # recv posted before send via batch_isend_irecv: the deferred
        # handle pops the mailbox at wait() time instead of raising
        buf = T(p, np.zeros(4, np.float32))
        tasks = d.batch_isend_irecv([d.P2POp(d.irecv, buf, 0),
                                     d.P2POp(d.isend, src, 0)])
        done = tasks[0].is_completed()
        for tk in tasks:
            tk.wait()
        with pytest.raises(RuntimeError, match="no matching send"):
            d.recv(T(p, np.zeros(4, np.float32)), src=0)
        return _np(shifted), _np(dst), _np(buf), done
    j, t = both(case)
    np.testing.assert_array_equal(t[0][1], np.full((4,), 0.0))
    np.testing.assert_array_equal(t[0][0], np.full((4,), 7.0))
    for a, b in zip(j[:3], t[:3]):
        np.testing.assert_array_equal(a, b)
    assert t[3] and j[3]


def test_groups_and_env():
    def case(p, d):
        g = d.new_group([0, 1, 2, 3])
        env = d.ParallelEnv()
        d.barrier()
        vals = np.stack([np.full((2,), r, np.float32) for r in range(4)])
        t = T(p, vals)
        d.communication.collective._mark_stacked(t)
        d.all_reduce(t, group=g)
        return (g.nranks, d.get_world_size(), d.get_rank(),
                d.get_world_size(g), env.world_size, env.nranks,
                g.get_group_rank(2), g.get_group_rank(5), g.rank,
                d.is_initialized(), d.get_group(g.id) is g, _np(t))
    j, t = both(case)
    assert t[:11] == j[:11]
    assert t[:5] == (4, 8, 0, 4, 8)
    np.testing.assert_allclose(t[11], np.full((4, 2), 6.0))
    np.testing.assert_allclose(t[11], j[11], **RED)
    assert tdist.get_backend() == "emulated"


def test_all_gather_object():
    def case(p, d):
        objs, out, sc = [], [{"b": 2}], []
        d.all_gather_object(objs, {"a": 1})
        d.broadcast_object_list(out, src=0)
        d.scatter_object_list(sc, [5, 6, 7])
        return objs, out, sc
    j, t = both(case)
    assert t == j and len(t[0]) == 8 and t[0][0] == {"a": 1}


def test_stream_namespace_and_wait():
    for p, d in PKGS:
        t = _ranked(p, d)
        d.stream.all_reduce(t)
        d.wait(t)
        assert d.all_reduce(t).is_completed()
        assert d.communication.stream.all_reduce is d.all_reduce


def test_data_parallel_wrapper():
    x = np.random.default_rng(6).random((16, 8)).astype(np.float32)

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8), ["dp"])
        model = _linear(p, 8, 4, seed=2)
        dp = d.DataParallel(model, mesh=mesh)
        seen = []
        model.register_forward_pre_hook(
            lambda lyr, inp: seen.append(
                [repr(a) for a in d.auto_parallel.placements_of(inp[0])]))
        out = dp(T(p, x))
        loss = out.sum()
        loss = dp.scale_loss(loss)
        loss.backward()
        dp.apply_collective_grads()
        return (out.shape, seen, [repr(a) for a in
                                  d.auto_parallel.placements_of(
                                      model.weight)],
                _np(out), _np(model.weight.grad))
    j, t = both(case)
    assert t[0] == j[0] == [16, 4]
    assert t[1] == j[1] == [["Shard(dim=0)"]]
    assert t[2] == j[2] == ["Replicate()"]
    np.testing.assert_allclose(t[3], j[3], **MATMUL)
    np.testing.assert_allclose(t[4], j[4], **MATMUL)
    assert np.isfinite(t[4]).all()
    assert tpaddle.DataParallel is tdist.DataParallel


def test_shard_dataloader_and_strategy():
    batches = [{"x": np.ones((8, 2), np.float32),
                "y": np.zeros((8,), np.float32)}]

    def case(p, d):
        mesh = d.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
        loader = [{k: T(p, v) for k, v in b.items()} for b in batches]
        sl = d.shard_dataloader(loader, mesh, input_keys=["x"])
        got = list(sl)
        s = d.Strategy({"sharding": {"enable": True, "stage": 2}})
        with pytest.raises(ValueError):
            d.Strategy({"amp": {"nope": 1}})
        return (len(sl), [repr(a) for a in
                          d.auto_parallel.placements_of(got[0]["x"])],
                d.auto_parallel.is_dist_tensor(got[0]["y"]),
                s.sharding.to_dict(), repr(s.amp))
    j, t = both(case)
    assert t == j
    assert t[1] == ["Shard(dim=0)", "Replicate()"]


def test_reshard_keeps_the_tape_and_flushes_lazy_values():
    """A differentiable reshard stays on the tape; a reshard or a
    collective of a value pending in a lazy region flushes it first
    (`jax.device_put` is a value barrier of the JAX package's lazy
    mode)."""
    mesh = tdist.ProcessMesh(np.arange(8), ["x"])
    x = T(tpaddle, np.arange(8, dtype=np.float32))
    x.stop_gradient = False
    y = tdist.reshard(tdist.shard_tensor(x, mesh, [tdist.Shard(0)]),
                      mesh, [tdist.Replicate()])
    (y * y).sum().backward()
    np.testing.assert_array_equal(_np(x.grad), 2 * np.arange(8))
    with lazy.lazy_guard():
        z = T(tpaddle, np.ones((8, 2), np.float32)) * 3.0
        assert lazy.is_pending(z)
        zs = tdist.shard_tensor(z, mesh, [tdist.Shard(0)])
        assert not lazy.is_pending(z)
        w = T(tpaddle, np.ones((8, 2), np.float32)) + 1.0
        tcoll._mark_stacked(w)
        tdist.all_reduce(w)
    np.testing.assert_array_equal(_np(zs), np.full((8, 2), 3.0))
    np.testing.assert_array_equal(_np(w), np.full((8, 2), 16.0))


def test_multi_process_branch_raises_typed(monkeypatch):
    monkeypatch.setattr(tcoll, "_multiproc", lambda: True)
    with pytest.raises(tdist.MultiProcessNotPorted, match="next"):
        tdist.all_reduce(T(tpaddle, np.ones(2, np.float32)))
    with pytest.raises(NotImplementedError):
        tdist.barrier()
    monkeypatch.setenv("PADDLE_TRAINERS_NUM", "2")
    with pytest.raises(tdist.MultiProcessNotPorted):
        tdist.init_parallel_env()


def test_jax_all_names_resolve():
    missing = [n for n in jdist.__all__ if not hasattr(tdist, n)]
    assert missing == []
    assert set(jdist.__all__) <= set(tdist.__all__)
    from paddle_tpu_torch.framework import monitor
    assert monitor.get("mesh.devices") == 8


def test_dist_from_jax_state_keeps_mesh_and_placements():
    """JAX state over a mesh (DistTensors, a Partial one, and an array
    whose NamedSharding alone says where it lives) becomes port
    DistTensors whose every shard is the JAX device's of the same id."""
    import jax.numpy as jnp

    rng = np.random.default_rng(9)
    mesh = jdist.ProcessMesh(np.arange(8).reshape(2, 4), ["dp", "mp"])
    st = {"col": jdist.shard_tensor(T(jpaddle, rng.random((8, 8))
                                      .astype(np.float32)), mesh,
                                    [jdist.Replicate(), jdist.Shard(1)]),
          "both": jdist.shard_tensor(T(jpaddle, rng.random((8, 4))
                                       .astype(np.float32)), mesh,
                                     [jdist.Shard(0), jdist.Shard(0)]),
          "part": jdist.shard_tensor(T(jpaddle, rng.random((4, 4))
                                       .astype(np.float32)), mesh,
                                     [jdist.Partial(), jdist.Shard(1)]),
          "bf": jdist.shard_tensor(jpaddle.Tensor(jnp.asarray(
              rng.random((8, 2)), jnp.bfloat16)), mesh,
              [jdist.Shard(0), jdist.Replicate()])}
    st["raw"] = st["col"]._data
    got = tpaddle.convert.dist_from_jax_state(st, device="cpu")
    for k, t in got.items():
        want = st[k]
        jplace = jdist.auto_parallel.placements_of(want) if k != "raw" \
            else jdist.auto_parallel.placements_of(jpaddle.Tensor(want))
        assert [repr(a) for a in tdist.auto_parallel.placements_of(t)] == \
            [repr(a) for a in jplace]
        a = [(r, o, v.detach().float().numpy()) for r, o, v in
             t.local_shards()]
        b = shards(jdist, want if k != "raw" else jpaddle.Tensor(want))
        assert [(r, o) for r, o, _ in a] == [(r, o) for r, o, _ in b]
        for (_, _, x), (_, _, y) in zip(a, b):
            np.testing.assert_array_equal(x, np.asarray(y, np.float32))


def test_elastic_reference_rehearsal(tmp_path):
    """The `elastic_reference` smoke phase's collective and checkpoint
    cases on the CPU: each value against its numpy definition, and a
    second run bit-equal to the first."""
    from paddle_tpu_torch.tools import elastic_workload as ew

    got = ew.collective_cases(tpaddle, device="cpu")
    again = ew.collective_cases(tpaddle, device="cpu")
    assert sorted(got) == sorted(again)
    for k in got:
        np.testing.assert_array_equal(got[k], again[k])
    vals = np.random.default_rng(0).standard_normal((8, 16)) \
        .astype(np.float32)
    fold = vals[0].copy()
    for r in range(1, 8):
        fold = fold + vals[r]
    np.testing.assert_array_equal(got["shard"], vals[:, None, :])
    for k in ("s_to_r", "s_to_s", "p_to_r", "p_to_s"):
        np.testing.assert_array_equal(got[k], vals)
    np.testing.assert_array_equal(got["all_reduce_sum"],
                                  np.broadcast_to(fold, (8, 16)))
    np.testing.assert_array_equal(got["all_reduce_max"],
                                  np.broadcast_to(vals.max(0), (8, 16)))
    np.testing.assert_array_equal(got["broadcast"],
                                  np.broadcast_to(vals[5], (8, 16)))
    np.testing.assert_array_equal(got["reduce"][3], fold)
    np.testing.assert_array_equal(got["reduce_scatter"],
                                  fold.reshape(8, 2))
    np.testing.assert_array_equal(got["shift"], np.roll(vals, 3, 0))
    np.testing.assert_array_equal(got["send_recv"], vals[2])
    np.testing.assert_array_equal(got["all_gather"], vals)
    ck = ew.checkpoint_reshard(tpaddle, str(tmp_path / "ck"), device="cpu")
    for k, (saved, loaded, n_shards, files) in ck.items():
        np.testing.assert_array_equal(saved, loaded)
        assert n_shards == 8
    assert ck["w1"][3] == [f"{r}_0.distcp" for r in range(8)]
