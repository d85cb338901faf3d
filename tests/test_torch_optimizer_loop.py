"""The training loop's optimizers, clipping, regularizers and schedulers on
both packages: every case of the JAX package's `tests/test_optimizer.py`
(convergence, mechanics, the LR-scheduler cases, multi-precision, the
review regressions), each run on both packages with its original checks
and the port held to the JAX package's numbers; `test_nn.py`'s global-
norm clip; every scheduler's sequence; parameter groups with their own
decay and clip; the state dict with a scheduler saved and loaded across
the packages; and the `train_loop` configuration on `llama_tiny` for 3
steps (`tools/loop_workload.py`, the smoke run's `train_loop_reference`
rehearsed), with the 8 new optimizers' two steps each."""
import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu.regularizer  # noqa: F401  (paddle_tpu.regularizer)
import paddle_tpu_torch as tpaddle
from torch_eager_common import assert_same, port_on_cpu  # noqa: F401
from torch_ops_surface_common import one_thread  # noqa: F401

PACKAGES = [jpaddle, tpaddle]


# the steps over which the packages' trajectories are compared: later, a
# fit oscillating at its optimum (Lamb's trust ratio keeps its step size)
# amplifies an ulp into a visible difference
EARLY = 50


def _fit(p, factory, steps=150):
    """`test_optimizer._fit`: a linear regression from seed 7; returns
    the final loss and the weights after EARLY steps."""
    p.seed(7)
    np.random.seed(7)
    X = np.random.randn(64, 10).astype("float32")
    W = np.random.randn(10, 1).astype("float32")
    model = p.nn.Linear(10, 1)
    o = factory(p.optimizer, model.parameters())
    xs, ys = p.to_tensor(X), p.to_tensor(X @ W)
    for i in range(steps):
        loss = ((model(xs) - ys) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
        if i + 1 == EARLY:
            early = model.weight.numpy()
    return float(loss), early


FITS = {
    "sgd": (lambda o, ps: o.SGD(0.1, parameters=ps), 150, 1e-2),
    "momentum": (lambda o, ps: o.Momentum(0.05, parameters=ps), 150, 1e-2),
    "momentum_nesterov": (lambda o, ps: o.Momentum(
        0.05, parameters=ps, use_nesterov=True), 150, 1e-2),
    "adam": (lambda o, ps: o.Adam(0.05, parameters=ps), 150, 1e-2),
    "adamw": (lambda o, ps: o.AdamW(0.05, parameters=ps), 150, 1e-2),
    "adagrad": (lambda o, ps: o.Adagrad(0.5, parameters=ps), 300, 1e-2),
    "rmsprop": (lambda o, ps: o.RMSProp(0.05, parameters=ps), 300, 5e-2),
    "adamax": (lambda o, ps: o.Adamax(0.05, parameters=ps), 300, 1e-2),
    "lamb": (lambda o, ps: o.Lamb(0.03, parameters=ps), 300, 1e-2),
    "nadam": (lambda o, ps: o.NAdam(0.05, parameters=ps), 200, 1e-2),
    "radam": (lambda o, ps: o.RAdam(0.05, parameters=ps), 300, 1e-2),
    "adadelta": (lambda o, ps: o.Adadelta(1.0, rho=0.9, parameters=ps),
                 400, 0.3),
}


@pytest.mark.parametrize("name", sorted(FITS))
def test_convergence(name):
    """TestConvergence: both packages fit under the original bound, and
    the port's weights after EARLY steps are the JAX package's within
    1e-5 (f32 updates, rounded apart by an ulp a step at most)."""
    factory, steps, bound = FITS[name]
    (jl, jw), (tl, tw) = (_fit(p, factory, steps) for p in PACKAGES)
    assert jl < bound and tl < bound, (jl, tl)
    np.testing.assert_allclose(tw, jw, rtol=1e-5, atol=1e-5)


def _both(case):
    want = case(jpaddle)
    assert_same(want, case(tpaddle), case.__name__)
    return want


def _ones(p, shape, v=1.0):
    return p.to_tensor(np.full(shape, v, "float32"))


def test_sgd_exact_update():
    def case(p):
        p.seed(1)
        w = p.nn.Linear(2, 2).weight
        before = w.numpy().copy()
        o = p.optimizer.SGD(0.5, parameters=[w])
        w.grad = _ones(p, (2, 2))
        o.step()
        np.testing.assert_allclose(w.numpy(), before - 0.5, rtol=1e-6)
        return w

    _both(case)


def test_weight_decay_l2():
    def case(p):
        p.seed(2)
        w = p.nn.Linear(2, 2).weight
        before = w.numpy().copy()
        o = p.optimizer.SGD(0.1, parameters=[w], weight_decay=0.1)
        w.grad = _ones(p, (2, 2), 0.0)
        o.step()
        np.testing.assert_allclose(w.numpy(), before * (1 - 0.01), rtol=1e-5)
        return w

    _both(case)


def test_adamw_decoupled_decay():
    def case(p):
        p.seed(3)
        w = p.nn.Linear(2, 2).weight
        before = w.numpy().copy()
        o = p.optimizer.AdamW(0.1, parameters=[w], weight_decay=0.5)
        w.grad = _ones(p, (2, 2), 0.0)
        o.step()
        np.testing.assert_allclose(w.numpy(), before * (1 - 0.05), rtol=1e-4)
        return w

    _both(case)


def test_grad_clip_integration():
    def case(p):
        p.seed(4)
        w = p.nn.Linear(2, 2).weight
        o = p.optimizer.SGD(1.0, parameters=[w],
                            grad_clip=p.nn.ClipGradByGlobalNorm(0.001))
        before = w.numpy().copy()
        w.grad = _ones(p, (2, 2), 100.0)
        o.step()
        assert np.abs(w.numpy() - before).max() < 0.001
        return w

    _both(case)


def test_state_dict_roundtrip():
    def case(p):
        p.seed(5)
        model = p.nn.Linear(4, 2)
        o = p.optimizer.Adam(0.01, parameters=model.parameters())
        model(_ones(p, (2, 4))).sum().backward()
        o.step()
        sd = o.state_dict()
        o2 = p.optimizer.Adam(0.01, parameters=model.parameters())
        o2.set_state_dict(sd)
        pid = id(model.parameters()[0])
        a = np.asarray(o2._accumulators["moment1"][pid])
        np.testing.assert_allclose(a, np.asarray(
            o._accumulators["moment1"][pid]))
        return a

    _both(case)


def test_minimize():
    def case(p):
        p.seed(6)
        model = p.nn.Linear(2, 1)
        o = p.optimizer.SGD(0.1, parameters=model.parameters())
        o.minimize(model(_ones(p, (1, 2))).sum())
        assert model.weight.grad is not None
        return model.weight

    _both(case)


def test_set_lr_get_lr():
    for p in PACKAGES:
        o = p.optimizer.SGD(0.1, parameters=[p.nn.Linear(2, 2).weight])
        assert o.get_lr() == 0.1
        o.set_lr(0.01)
        assert o.get_lr() == 0.01


def _seq(s, n, arg=None):
    vals = [s()]
    for _ in range(n):
        s.step() if arg is None else s.step(arg)
        vals.append(s())
    return vals


def test_lr_scheduler_cases():
    """TestLRSchedulers' eight cases, their checks on both packages and
    the port's values equal to the JAX package's."""
    def case(p):
        L = p.optimizer.lr
        out = {"step": _seq(L.StepDecay(0.1, step_size=2, gamma=0.5), 4)}
        np.testing.assert_allclose(out["step"], [0.1, 0.1, 0.05, 0.05, 0.025],
                                   rtol=1e-6)
        s = L.MultiStepDecay(1.0, milestones=[2, 4], gamma=0.1)
        out["multistep"] = _seq(s, 4)
        np.testing.assert_allclose(out["multistep"],
                                   [1.0, 1.0, 0.1, 0.1, 0.01], rtol=1e-6)
        s = L.CosineAnnealingDecay(1.0, T_max=10)
        assert s() == pytest.approx(1.0)
        s.step(10)
        assert s() == pytest.approx(0.0, abs=1e-6)
        s = L.LinearWarmup(0.1, warmup_steps=10, start_lr=0.0, end_lr=0.1)
        assert s() == pytest.approx(0.0)
        s.step(5)
        assert s() == pytest.approx(0.05)
        s.step(15)
        assert s() == pytest.approx(0.1)
        e = L.ExponentialDecay(1.0, gamma=0.5)
        e.step(3)
        assert e() == pytest.approx(0.125)
        n = L.NoamDecay(d_model=64, warmup_steps=100)
        n.step(100)
        poly = L.PolynomialDecay(1.0, decay_steps=10, end_lr=0.0)
        poly.step(5)
        assert poly() == pytest.approx(0.5)
        out["exp_noam_poly"] = [e(), n(), poly()]
        r = L.ReduceOnPlateau(1.0, patience=1, factor=0.1)
        for _ in range(3):
            r.step(1.0)
        assert r() == pytest.approx(0.1)
        sched = L.StepDecay(0.1, step_size=1, gamma=0.1)
        o = p.optimizer.SGD(sched, parameters=[p.nn.Linear(2, 2).weight])
        assert o.get_lr() == pytest.approx(0.1)
        sched.step()
        assert o.get_lr() == pytest.approx(0.01)
        s = L.OneCycleLR(max_learning_rate=1.0, total_steps=100)
        oc = _seq(s, 29)
        assert oc[-1] > oc[0]
        c = L.CyclicLR(0.1, 1.0, step_size_up=4)
        out["cyclic"] = _seq(c, 4)
        assert max(out["cyclic"]) == pytest.approx(1.0)
        out["one_cycle"] = oc
        return out

    _both(case)


def test_every_scheduler_sequence():
    """All 17 schedulers' values over 12 steps, and ReduceOnPlateau's
    state machine over a metric sequence, equal on both packages."""
    metrics = [1.0, 0.9, 0.95, 0.96, 0.97, 0.5, 0.6, 0.6, 0.6, 0.6, 0.2,
               0.3]

    def case(p):
        L = p.optimizer.lr
        scheds = {
            "noam": L.NoamDecay(64, 4),
            "piecewise": L.PiecewiseDecay([3, 6], [0.1, 0.05, 0.01]),
            "natural_exp": L.NaturalExpDecay(0.5, 0.1),
            "inverse_time": L.InverseTimeDecay(0.5, 0.2),
            "poly": L.PolynomialDecay(0.5, 5, 0.01, power=2.0),
            "poly_cycle": L.PolynomialDecay(0.5, 4, cycle=True),
            "warmup_cos": L.LinearWarmup(L.CosineAnnealingDecay(3e-4, 8),
                                         2, 0.0, 3e-4),
            "exp": L.ExponentialDecay(0.5, 0.9),
            "multistep": L.MultiStepDecay(0.5, [2, 5, 9], 0.5),
            "step": L.StepDecay(0.5, 3, 0.3),
            "lambda": L.LambdaDecay(0.5, lambda e: 0.95 ** e),
            "cos": L.CosineAnnealingDecay(0.5, 5, eta_min=0.01),
            "multiplicative": L.MultiplicativeDecay(0.5, lambda e: 0.9),
            "one_cycle": L.OneCycleLR(1.0, 12, three_phase=False),
            "one_cycle_lin": L.OneCycleLR(1.0, 12, anneal_strategy="linear"),
            "cyclic2": L.CyclicLR(0.1, 1.0, 2, 3, mode="triangular2"),
            "cyclic_exp": L.CyclicLR(0.1, 1.0, 2, mode="exp_range",
                                     exp_gamma=0.9),
            "linear": L.LinearLR(0.5, 6, start_factor=0.2),
            "warm_restarts": L.CosineAnnealingWarmRestarts(0.5, 3, T_mult=2,
                                                           eta_min=0.01),
        }
        out = {k: _seq(s, 12) for k, s in scheds.items()}
        r = L.ReduceOnPlateau(1.0, patience=1, factor=0.5, cooldown=1,
                              threshold=0.05)
        out["plateau"] = [(r.step(m), r())[1] for m in metrics]
        r = L.ReduceOnPlateau(1.0, mode="max", patience=0,
                              threshold_mode="abs", threshold=0.1,
                              min_lr=0.3)
        out["plateau_max"] = [(r.step(m), r())[1] for m in metrics]
        return out

    _both(case)


def test_master_weights_bf16():
    def case(p):
        p.seed(8)
        model = p.nn.Linear(4, 2)
        model.astype("bfloat16")
        o = p.optimizer.Adam(0.01, parameters=model.parameters(),
                             multi_precision=True)
        x = p.to_tensor(np.ones((2, 4)).astype("float32")).astype("bfloat16")
        model(x).sum().backward()
        o.step()
        pid = id(model.parameters()[0])
        assert pid in o._master_weights
        m = o._master_weights[pid]
        m = m.numpy() if hasattr(m, "numpy") and not isinstance(
            m, np.ndarray) else np.asarray(m)
        assert str(m.dtype) == "float32"
        return {"master": np.asarray(m),
                "weight": model.weight.astype("float32")}

    _both(case)


def test_param_groups_per_group_lr():
    def case(p):
        p.seed(9)
        p1 = p.nn.Linear(2, 2, bias_attr=False).weight
        p2 = p.nn.Linear(2, 2, bias_attr=False).weight
        b1, b2 = p1.numpy().copy(), p2.numpy().copy()
        o = p.optimizer.SGD(0.1, parameters=[
            {"params": [p1], "learning_rate": 1.0},
            {"params": [p2], "learning_rate": 0.1}])
        p1.grad, p2.grad = _ones(p, (2, 2)), _ones(p, (2, 2))
        o.step()
        np.testing.assert_allclose(p1.numpy(), b1 - 0.1, rtol=1e-5)
        np.testing.assert_allclose(p2.numpy(), b2 - 0.01, rtol=1e-5)
        return [p1, p2]

    _both(case)


def test_adamw_decay_mask_positional():
    def case(p):
        p.seed(10)
        p1 = p.nn.Linear(2, 2, bias_attr=False).weight
        p2 = p.nn.Linear(2, 2, bias_attr=False).weight
        p1.name, p2.name = "decay_me", "no_decay"
        b2 = p2.numpy().copy()
        o = p.optimizer.AdamW(0.1, parameters=[p1, p2], weight_decay=0.5,
                              apply_decay_param_fun=lambda n: n == "decay_me")
        p2.grad = _ones(p, (2, 2), 0.0)
        o.step()
        np.testing.assert_allclose(p2.numpy(), b2, atol=1e-7)
        return p2

    _both(case)


def test_lamb_exclusion():
    def case(p):
        p.seed(11)
        w = p.nn.Linear(2, 2, bias_attr=False).weight
        before = w.numpy().copy()
        o = p.optimizer.Lamb(0.1, lamb_weight_decay=1.0, parameters=[w],
                             exclude_from_weight_decay_fn=lambda param: True)
        w.grad = _ones(p, (2, 2), 0.0)
        o.step()
        np.testing.assert_allclose(w.numpy(), before, atol=1e-6)
        return w

    _both(case)


def test_l1_decay_is_l1():
    def case(p):
        w = p.nn.Linear(2, 2, bias_attr=False).weight
        w.set_value(np.full((2, 2), 2.0, "float32"))
        o = p.optimizer.SGD(0.1, parameters=[w],
                            weight_decay=p.regularizer.L1Decay(0.5))
        w.grad = _ones(p, (2, 2), 0.0)
        o.step()
        np.testing.assert_allclose(w.numpy(), np.full((2, 2), 1.95),
                                   rtol=1e-5)
        return w

    _both(case)


def test_clip_global_norm():
    """tests/test_nn.py::test_clip_global_norm, and the three clips with
    `need_clip` and the in-place helpers, on both packages."""
    g = np.arange(1.0, 9.0, dtype=np.float32).reshape(2, 4)

    def case(p):
        p.seed(12)
        w1, w2, w3 = (p.create_parameter([2, 4], "float32")
                      for _ in range(3))
        w3.need_clip = False
        pairs = [(w1, p.to_tensor(g)), (w2, p.to_tensor(-g * 3)),
                 (w3, p.to_tensor(g * 100)), (w1, None)]
        nn = p.nn
        out = {name: [t for _, t in clip(pairs) if t is not None]
               for name, clip in (("global", nn.ClipGradByGlobalNorm(1.0)),
                                  ("norm", nn.ClipGradByNorm(5.0)),
                                  ("value", nn.ClipGradByValue(3.0, -2.0)))}
        out["one"] = nn.ClipGradByGlobalNorm(1.0)([(w1, _ones(
            p, (4,), 10.0))])[0][1]
        np.testing.assert_allclose(np.linalg.norm(out["one"].numpy()), 1.0,
                                   rtol=1e-5)
        assert np.array_equal(out["global"][2].numpy(), g * 100)
        return out

    _both(case)


def test_param_groups_decay_clip_and_regularizers():
    """Groups with their own weight decay (a float, an L2Decay) and clip,
    a ParamAttr learning rate and regularizer, and a momentum step."""
    def case(p):
        p.seed(13)
        a = p.create_parameter([3, 2], "float32")
        b = p.create_parameter([3, 2], "float32", attr=p.ParamAttr(
            learning_rate=0.5, regularizer=p.regularizer.L1Decay(0.2)))
        c = p.create_parameter([2], "float32")
        o = p.optimizer.Momentum(0.1, momentum=0.8, parameters=[
            {"params": [a], "weight_decay": 0.05,
             "grad_clip": p.nn.ClipGradByNorm(0.5)},
            {"params": [b]},
            {"params": [c], "weight_decay": p.regularizer.L2Decay(0.3),
             "learning_rate": 2.0}])
        for i in range(2):
            for t, k in ((a, 1.0), (b, -2.0), (c, 0.5)):
                t.grad = p.to_tensor(np.full(t.shape, k * (i + 1),
                                             "float32"))
            o.step()
        return [a, b, c]

    _both(case)


def test_state_dict_with_scheduler_across_packages(tmp_path):
    """An AdamW state dict holding its scheduler's state, saved by each
    package and loaded by the other: the accumulators, masters, step and
    scheduler arrive, and the next step equals the saver's."""
    def build(p):
        p.seed(14)
        model = p.nn.Linear(4, 3)
        sched = p.optimizer.lr.StepDecay(0.1, step_size=1, gamma=0.5)
        o = p.optimizer.AdamW(sched, parameters=model.parameters(),
                              weight_decay=0.1)
        return model, o, sched

    def train(p, model, o, sched):
        model(p.to_tensor(np.ones((2, 4), "float32"))).sum().backward()
        o.step()
        o.clear_grad()
        sched.step()

    for src, dst in ((jpaddle, tpaddle), (tpaddle, jpaddle)):
        path = str(tmp_path / f"{src.__name__}.pdopt")
        m, o, s = build(src)
        train(src, m, o, s)
        train(src, m, o, s)
        src.save(o.state_dict(), path)
        msd = {k: v.numpy() for k, v in m.state_dict().items()}
        train(src, m, o, s)
        m2, o2, s2 = build(dst)
        m2.set_state_dict(msd)
        o2.set_state_dict(dst.load(path))
        assert s2.last_epoch == 2 and s2() == pytest.approx(0.025)
        train(dst, m2, o2, s2)
        for (n, w), (_, w2) in zip(m.named_parameters(),
                                   m2.named_parameters()):
            np.testing.assert_allclose(w2.numpy(), w.numpy(), rtol=1e-5,
                                       atol=1e-6, err_msg=n)


_PORT_REFERENCE = {}


def _port_reference():
    """The port's `reference_run` on the CPU, once a module."""
    from paddle_tpu_torch.tools import loop_workload as lw

    if not _PORT_REFERENCE:
        _PORT_REFERENCE["run"] = lw.reference_run(tpaddle)
    return _PORT_REFERENCE["run"]


def test_train_loop_reference_rehearsed():
    """`train_loop_reference` at tiny width on both packages: the Trainer
    loop on `llama_tiny` (losses and pre-clip norms within 1e-5 relative,
    each parameter after within 1e-5 norm-relative: AdamW normalises each
    coordinate, so one whose gradient is near epsilon moves by a fraction
    of the learning rate on a last-bit difference; learning rates equal
    to the schedule's closed form), and the 8 new optimizers two steps
    each within 1e-5."""
    from paddle_tpu_torch.tools import loop_workload as lw

    want, got = lw.reference_run(jpaddle), _port_reference()
    for r in (want, got):
        np.testing.assert_allclose(r["loop"]["lrs"],
                                   [lw.lr_at(i) for i in range(3)],
                                   rtol=0, atol=1e-7)
        assert r["loop"]["losses"][-1] < r["loop"]["losses"][0]
    for part in ("losses", "norms", "lrs"):
        np.testing.assert_allclose(got["loop"][part], want["loop"][part],
                                   rtol=1e-5, atol=1e-6, err_msg=part)
    for n, w in want["loop"]["params"].items():
        g = got["loop"]["params"][n]
        assert np.linalg.norm(g - w) <= 1e-5 * np.linalg.norm(w), n
    for name, w in want["optimizers"].items():
        g = got["optimizers"][name]
        np.testing.assert_allclose(g["losses"], w["losses"], rtol=1e-5,
                                   err_msg=name)
        for a, b in zip(g["params"], w["params"]):
            np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6,
                                       err_msg=name)


def test_loop_reference_on_the_cpu_is_its_own_reference():
    """The smoke run holds the card's `reference_run` to the CPU's and
    its harness sweep to the CPU's (`compare_sweeps`); on the CPU two
    runs are the same run, bit for bit."""
    from paddle_tpu_torch.tools import loop_workload as lw

    a = _port_reference()
    b = lw.tiny_loop(tpaddle)
    assert a["loop"]["losses"] == b["losses"]
    assert a["loop"]["norms"] == b["norms"]
    # one namespace (the surface files sweep all four)
    full = lw.load_manifest()
    nn_only = {"namespaces": {"paddle.nn":
                              full["namespaces"]["paddle.nn"]}}
    sweep1 = lw.ops_sweep(tpaddle, "cpu", nn_only)
    sweep2 = lw.ops_sweep(tpaddle, "cpu", nn_only)
    stats = lw.compare_sweeps(sweep1, sweep2, device="cpu")
    assert stats["max_abs_err"] == 0.0
    assert stats["per_namespace"]["paddle.nn"]["compared"] >= 50


_LOOP_RUNS = {}


@pytest.mark.parametrize("lazy_on", [False, True], ids=["eager", "lazy"])
def test_train_loop_phase_rehearsed_on_the_cpu(lazy_on):
    """The smoke run's `train_loop` steps on `llama_tiny` (bf16 by O2
    decorate, 2 warm-up and 4 timed steps), eagerly and under lazy mode:
    the scheduled learning rates, the clipped norm min(pre-clip, 1) in
    the warm-up (the scale rounds to bf16: within 1e-2), falling losses,
    and the lazy run within 1e-3 of the eager one."""
    from paddle_tpu_torch.tools import loop_workload as lw

    def run(lazy):
        if lazy not in _LOOP_RUNS:
            _LOOP_RUNS[lazy] = lw.run_loop(
                tpaddle, lw.loop_workload(tpaddle, tiny=True), lazy,
                lambda: None, dict, None)
        return _LOOP_RUNS[lazy]

    r = run(lazy_on)
    np.testing.assert_allclose(r["lrs"], [lw.lr_at(i) for i in range(6)],
                               rtol=0, atol=1e-7)
    for pre, post in zip(r["norms"], r["post_norms"]):
        assert abs(post - min(pre, 1.0)) <= 1e-2 * min(pre, 1.0)
    assert len(r["post_norms"]) == lw.WARMUP_STEPS
    assert np.isfinite(r["losses"]).all()
    assert r["losses"][-1] < r["losses"][lw.WARMUP_STEPS]
    if lazy_on:
        eager = run(False)
        for part in ("losses", "norms"):
            a, b = np.asarray(r[part]), np.asarray(eager[part])
            assert np.linalg.norm(a - b) <= 1e-3 * np.linalg.norm(b)
        assert r["timed_counters"].get("lazy.fused_backward") \
            == lw.TIMED_STEPS
