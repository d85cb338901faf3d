"""SelectedRows on the CPU, held to the JAX package: every case of
`tests/test_selected_rows.py`, each run on both packages from the same
numpy inputs (`core/selected_rows.py`, the sparse `embedding`, the
accumulation beside the leaf, the sparse branches of the clips, the
optimizers' lazy update and `GradScaler`), plus the optimizer
configurations the card's `resilience_reference` phase trains, the
remaining clips and JAX's lazy mode.

Tolerances: rows, heights, shapes and untouched parameter rows exact;
float32 values 1e-6 (a merge or a norm sums in another order than XLA's
CPU reductions); trajectories of several optimizer steps 1e-5.
"""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.core.selected_rows import SelectedRows as JRows
from paddle_tpu_torch.core.selected_rows import SelectedRows as TRows
from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

F32 = dict(rtol=1e-6, atol=1e-7)
STEPS = dict(rtol=1e-5, atol=1e-6)


def _np(x):
    if isinstance(x, torch.Tensor):
        x = x.detach()
        return (x.float() if x.dtype == torch.bfloat16 else x).numpy()
    if hasattr(x, "numpy") and hasattr(x, "stop_gradient"):
        return np.asarray(x.numpy(), np.float32) \
            if str(x.dtype).endswith("bfloat16") else np.asarray(x.numpy())
    return np.asarray(x)


def _rows(g):
    return _np(g.rows)


def _set(p, emb, w):
    """Give an embedding the weight `w` (a numpy array) in either
    package."""
    if p is tpaddle:
        with torch.no_grad():
            emb.weight._data.copy_(torch.from_numpy(np.array(w)))
    else:
        emb.weight._data = jnp.asarray(np.array(w))


def _loss(p, emb, ids):
    return (emb(p.to_tensor(np.asarray(ids))) ** 2).sum()


def _table(v, h, seed=0):
    return np.random.default_rng(seed).standard_normal((v, h)).astype(
        np.float32)


def _both(fn):
    """fn(paddle) on both packages; returns (JAX's, the port's)."""
    return fn(jpaddle), fn(tpaddle)


# -- the gradient ----------------------------------------------------------

def test_grad_is_selected_rows_not_dense():
    def run(p):
        emb = p.nn.Embedding(1000, 16, sparse=True)
        _set(p, emb, _table(1000, 16))
        _loss(p, emb, [[3, 7, 3], [1, 999, 7]]).backward()
        g = emb.weight.grad
        assert getattr(g, "is_selected_rows", False)
        assert g.height == 1000 and list(g.shape) == [1000, 16]
        return _rows(g), _np(g.values)
    (wr, wv), (gr, gv) = _both(run)
    assert gr.dtype == wr.dtype == np.int32
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gr, [3, 7, 3, 1, 999, 7])
    np.testing.assert_allclose(gv, wv, **F32)


def test_sparse_matches_dense_grad():
    def run(p):
        w = _table(50, 8, 1)
        dense = p.nn.Embedding(50, 8, sparse=False)
        sparse = p.nn.Embedding(50, 8, sparse=True)
        _set(p, dense, w)
        _set(p, sparse, w)
        _loss(p, dense, [[3, 7, 3, 0]]).backward()
        _loss(p, sparse, [[3, 7, 3, 0]]).backward()
        got = _np(sparse.weight.grad.to_dense())
        np.testing.assert_allclose(got, _np(dense.weight.grad), rtol=1e-6)
        return got
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **F32)


def test_padding_idx_rows_kept_with_zero_values():
    def run(p):
        emb = p.nn.Embedding(20, 4, padding_idx=2, sparse=True)
        _set(p, emb, _table(20, 4, 22))
        _loss(p, emb, [[2, 5]]).backward()
        g = emb.weight.grad
        dense = _np(g.to_dense())
        np.testing.assert_array_equal(dense[2], np.zeros(4))
        assert np.abs(dense[5]).max() > 0
        return _rows(g), _np(g.values)
    (wr, wv), (gr, gv) = _both(run)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gr, [2, 5])
    np.testing.assert_array_equal(gv[0], np.zeros(4))
    np.testing.assert_allclose(gv, wv, **F32)


def test_accumulation_concats_earlier_first():
    def run(p):
        w = _table(30, 4, 2)
        emb = p.nn.Embedding(30, 4, sparse=True)
        _set(p, emb, w)
        _loss(p, emb, [[1, 2]]).backward()
        _loss(p, emb, [[2, 3]]).backward()
        g = emb.weight.grad
        assert g.values.shape[0] == 4
        dense = p.nn.Embedding(30, 4, sparse=False)
        _set(p, dense, w)
        _loss(p, dense, [[1, 2]]).backward()
        _loss(p, dense, [[2, 3]]).backward()
        np.testing.assert_allclose(_np(g.to_dense()),
                                   _np(dense.weight.grad), rtol=1e-6)
        return _rows(g), _np(g.values)
    (wr, wv), (gr, gv) = _both(run)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_array_equal(gr, [1, 2, 2, 3])
    np.testing.assert_allclose(gv, wv, **F32)


def test_single_rows_concatenate_in_accumulation_order():
    """One-row lookups accumulate as [5, 2], not sorted: torch's own
    sparse gradients would coalesce them."""
    def run(p):
        emb = p.nn.Embedding(10, 3, sparse=True)
        _loss(p, emb, [[5]]).backward()
        _loss(p, emb, [[2]]).backward()
        return _rows(emb.weight.grad)
    want, got = _both(run)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(got, [5, 2])


def test_merged_static_dedupes():
    rows = np.array([5, 2, 5], np.int32)
    vals = np.array([[1.0], [2.0], [3.0]], np.float32)
    wu, wm = JRows(jnp.asarray(rows), jnp.asarray(vals), 10).merged_static()
    gu, gm = TRows(torch.from_numpy(rows), torch.from_numpy(vals),
                   10).merged_static()
    np.testing.assert_array_equal(_np(gu), np.asarray(wu))
    np.testing.assert_array_equal(_np(gm), np.asarray(wm))
    got = {int(r): float(v) for r, v in zip(_np(gu), _np(gm)[:, 0])
           if int(r) < 10}
    assert got == {2: 2.0, 5: 4.0}
    merged = TRows(torch.from_numpy(rows), torch.from_numpy(vals),
                   10).merged()
    np.testing.assert_array_equal(_np(merged.to_dense()),
                                  np.asarray(JRows(jnp.asarray(rows),
                                                   jnp.asarray(vals), 10)
                                             .merged().to_dense()))


def test_selected_rows_methods_match():
    rng = np.random.default_rng(3)
    rows = np.array([4, 1, 4, 7, 1], np.int32)
    vals = rng.standard_normal((5, 3)).astype(np.float32)
    j = JRows(jnp.asarray(rows), jnp.asarray(vals), 9)
    t = TRows(torch.from_numpy(rows), torch.from_numpy(vals), 9)
    assert t.shape == j.shape == [9, 3]
    np.testing.assert_allclose(t.numpy(), j.numpy(), **F32)
    np.testing.assert_allclose(float(t.sq_sum()), float(j.sq_sum()),
                               rtol=1e-6)
    np.testing.assert_allclose(_np(t.scaled(0.5).values),
                               np.asarray(j.scaled(0.5).values), **F32)
    c_t, c_j = t.concat(t), j.concat(j)
    np.testing.assert_array_equal(_np(c_t.rows), np.asarray(c_j.rows))
    assert "height=9" in repr(t)


# -- the optimizers --------------------------------------------------------

OPTS = [("SGD", {}), ("Momentum", {"momentum": 0.9}),
        ("Adam", {"lazy_mode": True}),
        ("AdamW", {"weight_decay": 0.0, "lazy_mode": True})]


@pytest.mark.parametrize("name,kw", OPTS)
def test_sparse_step_matches_dense_on_touched_rows(name, kw):
    ids = [[3, 7, 3]]

    def run(p):
        w = _table(40, 8, 4)
        d_emb = p.nn.Embedding(40, 8, sparse=False)
        s_emb = p.nn.Embedding(40, 8, sparse=True)
        _set(p, d_emb, w)
        _set(p, s_emb, w)
        cls = getattr(p.optimizer, name)
        d_opt = cls(learning_rate=0.1, parameters=d_emb.parameters(), **kw)
        s_opt = cls(learning_rate=0.1, parameters=s_emb.parameters(), **kw)
        for _ in range(3):
            _loss(p, d_emb, ids).backward()
            d_opt.step()
            d_opt.clear_grad()
            _loss(p, s_emb, ids).backward()
            s_opt.step()
            s_opt.clear_grad()
        d_w, s_w = _np(d_emb.weight), _np(s_emb.weight)
        np.testing.assert_allclose(s_w[[3, 7]], d_w[[3, 7]], rtol=2e-5,
                                   atol=1e-6)
        untouched = [i for i in range(40) if i not in (3, 7)]
        np.testing.assert_array_equal(s_w[untouched], w[untouched])
        return s_w
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **STEPS)


def test_non_lazy_adam_matches_dense_everywhere():
    def run(p):
        w = _table(12, 4, 5)
        d_emb = p.nn.Embedding(12, 4, sparse=False)
        s_emb = p.nn.Embedding(12, 4, sparse=True)
        _set(p, d_emb, w)
        _set(p, s_emb, w)
        d_opt = p.optimizer.Adam(learning_rate=0.1,
                                 parameters=d_emb.parameters())
        s_opt = p.optimizer.Adam(learning_rate=0.1,
                                 parameters=s_emb.parameters())
        for ids in ([[3]], [[8]], [[3]]):   # row 3 untouched at step 2
            _loss(p, d_emb, ids).backward()
            d_opt.step()
            d_opt.clear_grad()
            _loss(p, s_emb, ids).backward()
            s_opt.step()
            s_opt.clear_grad()
        np.testing.assert_allclose(_np(s_emb.weight), _np(d_emb.weight),
                                   rtol=1e-5, atol=1e-7)
        return _np(s_emb.weight)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **STEPS)


def test_weight_decay_only_touches_looked_up_rows():
    def run(p):
        w = _table(30, 4, 6)
        emb = p.nn.Embedding(30, 4, sparse=True)
        _set(p, emb, w)
        opt = p.optimizer.AdamW(learning_rate=0.1, weight_decay=0.5,
                                lazy_mode=True, parameters=emb.parameters())
        _loss(p, emb, [[5]]).backward()
        opt.step()
        w1 = _np(emb.weight)
        assert np.abs(w1[5] - w[5]).max() > 0
        untouched = [i for i in range(30) if i != 5]
        np.testing.assert_array_equal(w1[untouched], w[untouched])
        return w1
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **STEPS)


def test_multi_precision_master_tracks_sparse_updates():
    def run(p):
        w = _table(30, 8, 7)
        emb = p.nn.Embedding(30, 8, sparse=True)
        _set(p, emb, w)
        if p is tpaddle:
            emb.weight._data = emb.weight._data.detach().to(
                torch.bfloat16).requires_grad_()
        else:
            emb.weight._data = emb.weight._data.astype(jnp.bfloat16)
        opt = p.optimizer.Adam(learning_rate=0.1, multi_precision=True,
                               lazy_mode=True, parameters=emb.parameters())
        for _ in range(2):
            _loss(p, emb, [[5, 6]]).backward()
            opt.step()
            opt.clear_grad()
        master = _np(opt._master_weights[id(emb.weight)]).astype(np.float32)
        assert str(opt._master_weights[id(emb.weight)].dtype).endswith(
            "float32")
        np.testing.assert_allclose(
            _np(torch.from_numpy(master).to(torch.bfloat16)),
            _np(emb.weight))
        assert np.abs(master[[5, 6]]).sum() > 0
        untouched = [i for i in range(30) if i not in (5, 6)]
        np.testing.assert_array_equal(
            master[untouched],
            _np(torch.from_numpy(w).to(torch.bfloat16))[untouched])
        return master
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **STEPS)


# the optimizer configurations of the card's `resilience_reference`
# phase, each under a global-norm clip, on an embedding + Linear model
CONFIGS = [("SGD", {}), ("Adam", {"lazy_mode": True}),
           ("Adam", {"lazy_mode": False}),
           ("AdamW", {"lazy_mode": True, "multi_precision": True}),
           ("Momentum", {"momentum": 0.9})]


@pytest.mark.parametrize("scaled", [False, True])
@pytest.mark.parametrize("name,kw", CONFIGS)
def test_optimizer_configurations_under_clip(name, kw, scaled):
    rng = np.random.default_rng(8)
    ids = rng.integers(0, 64, (3, 2, 6))
    w_emb, w_fc = _table(64, 8, 9), _table(8, 3, 10)

    def run(p):
        emb = p.nn.Embedding(64, 8, sparse=True)
        fc = p.nn.Linear(8, 3)
        _set(p, emb, w_emb)
        fc.weight.set_value(w_fc)
        params = emb.parameters() + fc.parameters()
        opt = getattr(p.optimizer, name)(
            learning_rate=0.05, parameters=params,
            grad_clip=p.nn.ClipGradByGlobalNorm(0.5), **kw)
        scaler = p.amp.GradScaler(init_loss_scaling=256.0) if scaled \
            else None
        losses = []
        for step in range(3):
            loss = (fc(emb(p.to_tensor(ids[step]))) ** 2).mean()
            if scaler is not None:
                scaler.scale(loss).backward()
                scaler.step(opt)
                scaler.update()
            else:
                loss.backward()
                opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        return {"losses": np.array(losses, np.float32),
                "emb": _np(emb.weight), "fc": _np(fc.weight)}
    want, got = _both(run)
    for k in want:
        np.testing.assert_allclose(got[k], want[k], err_msg=k, **STEPS)


def test_lbfgs_refuses_selected_rows():
    def run(p):
        emb = p.nn.Embedding(10, 3, sparse=True)
        opt = p.optimizer.LBFGS(learning_rate=0.1,
                                parameters=emb.parameters())

        def closure():
            loss = _loss(p, emb, [[1, 2]])
            loss.backward()
            return loss
        with pytest.raises(RuntimeError) as e:
            opt.step(closure)
        return str(e.value)
    want, got = _both(run)
    assert got == want and "SelectedRows" in got


# -- clips and loss scaling ------------------------------------------------

def test_global_norm_clip_includes_sparse():
    def run(p):
        w = _table(20, 4, 11)
        d_emb = p.nn.Embedding(20, 4, sparse=False)
        s_emb = p.nn.Embedding(20, 4, sparse=True)
        _set(p, d_emb, w)
        _set(p, s_emb, w)
        clip = p.nn.ClipGradByGlobalNorm(0.01)
        d_opt = p.optimizer.SGD(learning_rate=0.1, grad_clip=clip,
                                parameters=d_emb.parameters())
        s_opt = p.optimizer.SGD(learning_rate=0.1, grad_clip=clip,
                                parameters=s_emb.parameters())
        _loss(p, d_emb, [[2, 2, 9]]).backward()
        d_opt.step()
        _loss(p, s_emb, [[2, 2, 9]]).backward()
        s_opt.step()
        np.testing.assert_allclose(_np(s_emb.weight), _np(d_emb.weight),
                                   rtol=1e-5, atol=1e-7)
        return _np(s_emb.weight)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **STEPS)


@pytest.mark.parametrize("clip", ["value", "norm"])
def test_value_and_norm_clips_on_merged_rows(clip):
    rows = np.array([3, 1, 3, 6], np.int32)
    vals = np.random.default_rng(12).standard_normal((4, 5)).astype(
        np.float32) * 3

    def run(p):
        cls = p.nn.ClipGradByValue if clip == "value" \
            else p.nn.ClipGradByNorm
        sr = (TRows(torch.from_numpy(rows), torch.from_numpy(vals), 8)
              if p is tpaddle else
              JRows(jnp.asarray(rows), jnp.asarray(vals), 8))
        (_, g), = cls(1.0)([(object(), sr)])
        return _rows(g), _np(g.values), _np(g.to_dense())
    (wr, wv, wd), (gr, gv, gd) = _both(run)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_allclose(gv, wv, **F32)
    np.testing.assert_allclose(gd, wd, **F32)


def test_clip_grad_norm_counts_sparse():
    def run(p):
        emb = p.nn.Embedding(12, 3, sparse=True)
        fc = p.nn.Linear(3, 2)
        _set(p, emb, _table(12, 3, 13))
        fc.weight.set_value(_table(3, 2, 14))
        (fc(emb(p.to_tensor(np.array([[4, 4, 9]])))) ** 2).sum().backward()
        params = emb.parameters() + fc.parameters()
        total = p.nn.utils.clip_grad_norm_(params, 0.1) \
            if hasattr(p.nn, "utils") and hasattr(p.nn.utils,
                                                  "clip_grad_norm_") \
            else p.nn.clip.clip_grad_norm_(params, 0.1)
        return float(total), _np(emb.weight.grad.to_dense()), \
            _np(fc.weight.grad)
    (wt, we, wf), (gt, ge, gf) = _both(run)
    np.testing.assert_allclose(gt, wt, rtol=1e-6)
    np.testing.assert_allclose(ge, we, **F32)
    np.testing.assert_allclose(gf, wf, **F32)


def test_grad_scaler_unscales_sparse():
    def run(p):
        w = _table(20, 4, 15)
        emb = p.nn.Embedding(20, 4, sparse=True)
        _set(p, emb, w)
        opt = p.optimizer.SGD(learning_rate=0.1,
                              parameters=emb.parameters())
        scaler = p.amp.GradScaler(init_loss_scaling=1024.0)
        scaler.scale(_loss(p, emb, [[3]])).backward()
        scaler.step(opt)
        scaler.update()
        emb2 = p.nn.Embedding(20, 4, sparse=True)
        _set(p, emb2, w)
        opt2 = p.optimizer.SGD(learning_rate=0.1,
                               parameters=emb2.parameters())
        _loss(p, emb2, [[3]]).backward()
        opt2.step()
        np.testing.assert_allclose(_np(emb.weight), _np(emb2.weight),
                                   rtol=1e-4)
        return _np(emb.weight)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **STEPS)


def test_grad_scaler_skips_non_finite_sparse_values():
    def run(p):
        emb = p.nn.Embedding(6, 2, sparse=True)
        _set(p, emb, _table(6, 2, 16))
        opt = p.optimizer.SGD(learning_rate=0.1,
                              parameters=emb.parameters())
        scaler = p.amp.GradScaler(init_loss_scaling=2.0 ** 127)
        scaler.scale(_loss(p, emb, [[1]]) * 1e10).backward()
        scaler.step(opt)
        scaler.update()
        return scaler.get_loss_scaling(), _np(emb.weight)
    (ws, ww), (gs, gw) = _both(run)
    assert float(gs) == float(ws)
    np.testing.assert_array_equal(gw, ww)


# -- the tape --------------------------------------------------------------

def test_clear_grad_set_to_zero_and_paddle_grad_densifies():
    def run(p):
        emb = p.nn.Embedding(10, 3, sparse=True)
        _set(p, emb, _table(10, 3, 17))
        _loss(p, emb, [[1]]).backward()
        emb.weight.clear_gradient(True)
        assert list(emb.weight.grad.shape) == [10, 3]
        assert float(np.abs(_np(emb.weight.grad)).max()) == 0
        g, = p.grad(_loss(p, emb, [[1]]), [emb.weight])
        assert list(g.shape) == [10, 3] and not getattr(
            g, "is_selected_rows", False)
        return _np(g)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **F32)


def test_hook_sees_dense_cotangent():
    def run(p):
        emb = p.nn.Embedding(10, 3, sparse=True)
        _set(p, emb, _table(10, 3, 18))
        seen = {}
        emb.weight.register_hook(lambda g: seen.update(g=_np(g)))
        _loss(p, emb, [[4]]).backward()
        assert list(seen["g"].shape) == [10, 3]
        return seen["g"], _np(emb.weight.grad)
    (wh, wg), (gh, gg) = _both(run)
    np.testing.assert_allclose(gh, wh, **F32)
    np.testing.assert_allclose(gg, wg, **F32)


def test_mixed_sparse_and_dense_contributions_densify():
    """A table read sparsely and used densely in one loss (tied weights)
    accumulates one dense gradient."""
    def run(p):
        emb = p.nn.Embedding(8, 3, sparse=True)
        _set(p, emb, _table(8, 3, 19))
        loss = _loss(p, emb, [[2, 5]]) + (emb.weight * 2.0).sum()
        loss.backward()
        g = emb.weight.grad
        assert not getattr(g, "is_selected_rows", False)
        return _np(g)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **F32)


def test_lazy_mode_keeps_the_sparse_gradient():
    """JAX's lazy mode records the lookup and still gives the weight a
    SelectedRows (the port runs the sparse lookup now, outside the
    pending region)."""
    def run(p):
        emb = p.nn.Embedding(10, 4, sparse=True)
        _set(p, emb, _table(10, 4, 20))
        lin = p.nn.Linear(4, 2)
        lin.weight.set_value(_table(4, 2, 21))
        with p.core.lazy.lazy_guard():
            out = lin(emb(p.to_tensor(np.array([[1, 3, 1]]))))
            out.sum().backward()
        g = emb.weight.grad
        assert getattr(g, "is_selected_rows", False)
        return _rows(g), _np(g.values), _np(lin.weight.grad)
    (wr, wv, wl), (gr, gv, gl) = _both(run)
    np.testing.assert_array_equal(gr, wr)
    np.testing.assert_allclose(gv, wv, **F32)
    np.testing.assert_allclose(gl, wl, **F32)


# -- scale -----------------------------------------------------------------

def test_256k_vocab_no_dense_grad():
    V, H = 256_000, 64
    ids = np.random.default_rng(0).integers(0, V, (4, 32))
    touched = np.unique(ids)

    def run(p):
        p.seed(0)
        emb = p.nn.Embedding(V, H, sparse=True)
        w = _np(emb.weight).copy()
        opt = p.optimizer.Adam(learning_rate=0.01, lazy_mode=True,
                               parameters=emb.parameters())
        (emb(p.to_tensor(ids)) ** 2).sum().backward()
        g = emb.weight.grad
        assert getattr(g, "is_selected_rows", False)
        assert list(g.values.shape) == [128, H]
        opt.step()
        opt.clear_grad()
        assert emb.weight.grad is None
        w1 = _np(emb.weight)
        keep = np.ones(V, bool)
        keep[touched] = False
        np.testing.assert_array_equal(w1[keep], w[keep])
        return w[touched], w1[touched]
    (w0, w1), (g0, g1) = _both(run)
    np.testing.assert_array_equal(g0, w0)   # the same seeded init
    np.testing.assert_allclose(g1, w1, **STEPS)


def test_mixed_sparse_dense_model_trains():
    ids = np.random.default_rng(1).integers(0, 500, (8, 6))
    y = np.ones((8, 1), np.float32)

    def run(p):
        p.seed(3)
        emb = p.nn.Embedding(500, 16, sparse=True)
        fc = p.nn.Linear(16, 1)
        opt = p.optimizer.Adam(learning_rate=0.05,
                               parameters=emb.parameters() + fc.parameters())
        losses = []
        for _ in range(25):
            loss = ((fc(emb(p.to_tensor(ids)).mean(axis=1))
                     - p.to_tensor(y)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.2, losses
        return np.array(losses, np.float32)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-6)


def test_sparse_train_rehearsal():
    """`chip_smoke.py`'s sparse_train on the tiny Llama (O2 bf16, the
    Trainer loop's AdamW with lazy_mode): the sparse run's embedding
    gradient is a SelectedRows of every token (no dense gradient), rows
    the batch did not touch keep their bits in the parameter, the f32
    master and both moments, and the losses are the dense run's within
    1e-3."""
    from paddle_tpu_torch.tools import resilience_workload as rw

    runs = {}
    for sparse in (False, True):
        work = rw.sparse_workload(tpaddle, sparse, tiny=True)
        model, opt = work[0], work[1]
        w = model.llama.embed_tokens.weight
        w0 = w._data.detach().clone()
        ids = work[3]._data.reshape(-1)
        untouched = torch.ones(w.shape[0], dtype=torch.bool)
        untouched[ids] = False
        losses = []
        for _ in range(3):
            with tpaddle.amp.auto_cast(level="O2"):
                logits = model(work[3])
            loss = (rw.lw._loss(tpaddle, logits, work[4],
                                model.config.vocab_size))
            loss.backward()
            if sparse:
                g = w.grad
                assert isinstance(g, TRows) and w._data.grad is None
                assert list(g.values.shape) == [16, w.shape[1]]
            opt.step()
            opt.clear_grad()
            work[2].step()
            losses.append(float(loss.astype("float32").item()))
            if sparse:
                master = opt._master_weights[id(w)]
                assert torch.equal(w._data[untouched], w0[untouched])
                assert torch.equal(master[untouched],
                                   w0[untouched].float())
                for k in ("moment1", "moment2"):
                    assert not opt._accumulators[k][id(w)][untouched].any()
        runs[sparse] = np.array(losses)
    np.testing.assert_allclose(runs[True], runs[False], rtol=1e-3)


def test_grad_scaler_unscales_mixed_sparse_and_dense():
    """A table read sparsely and densely in one scaled loss: both parts
    of its gradient are unscaled before they meet."""
    def run(p):
        emb = p.nn.Embedding(8, 3, sparse=True)
        _set(p, emb, _table(8, 3, 23))
        opt = p.optimizer.SGD(learning_rate=0.1,
                              parameters=emb.parameters())
        scaler = p.amp.GradScaler(init_loss_scaling=64.0)
        loss = _loss(p, emb, [[2, 5]]) + (emb.weight * 2.0).sum()
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        return _np(emb.weight)
    want, got = _both(run)
    np.testing.assert_allclose(got, want, **F32)
