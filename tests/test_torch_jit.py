"""`paddle.jit` and the inference `Predictor` of the port: every case of
`tests/test_jit_static.py:17-165` (to_static equal to eager, training
through it, the graph break warning once with "data-dependent" and still
training, per-shape capture, tuple outputs, the save / load round trip,
a dynamic batch of 1, 3 and 7) and `tests/test_inference.py:318`'s
Predictor flow, each run on both packages with the port's results held
to the JAX package's (`torch_eager_common.py`). Then what is the port's
own: each package's `jit.save` / `jit.load` within 1e-5 of its eager
forward with the `.pdiparams` bit-equal across packages; the JAX
package's StableHLO `.pdmodel` refused with a typed error; the kernels
recorded as custom ops in a captured program (never the plain
attention); and the smoke run's `jit_reference` / `jit_layer` bodies at
tiny widths on the CPU. `torch.export` takes ~3 s on its first capture
in a process; one warm-up per module pays it once."""
import os
import warnings

import numpy as np
import pytest

from torch_eager_common import (Scenarios, fresh, jpaddle,  # noqa: F401
                                port_on_cpu, tpaddle)
from torch_threads import one_thread  # noqa: F401

SC = Scenarios()
PKGS = ("jax", "torch")


@pytest.fixture(scope="module", autouse=True)
def export_warm_up(port_on_cpu):  # noqa: F811
    """One small capture, so the first `torch.export` in this process
    (its one-time setup) is paid once for the module."""
    @tpaddle.jit.to_static
    def twice(x):
        return x * 2.0

    twice(tpaddle.ones([2]))


def _x(shape, seed=0):
    return np.random.default_rng(seed).random(shape).astype(np.float32)


def to_static_layer_matches_eager(paddle):
    nn = paddle.nn
    paddle.seed(0)
    model = nn.Sequential(nn.Linear(8, 16), nn.GELU(), nn.Linear(16, 4))
    x = paddle.Tensor(_x((2, 8)))
    eager = model(x)
    static = paddle.jit.to_static(model)(x)
    np.testing.assert_allclose(static.numpy(), eager.numpy(), rtol=1e-5,
                               atol=1e-6)
    return {"static": static, "eager": eager}


def _fit(paddle, smodel, model, steps, lr):
    opt = paddle.optimizer.SGD(learning_rate=lr,
                               parameters=model.parameters())
    X = _x((16, 4), 1)
    Y = X.sum(1, keepdims=True)
    losses = []
    for _ in range(steps):
        loss = ((smodel(paddle.Tensor(X)) - paddle.Tensor(Y)) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(float(loss))
    return losses


def to_static_trains_params(paddle):
    paddle.seed(1)
    model = paddle.nn.Linear(4, 1)
    losses = _fit(paddle, paddle.jit.to_static(model), model, 40, 0.1)
    assert losses[-1] < losses[0] * 0.1, losses
    return {"losses": np.asarray(losses, np.float32), "w": model.weight}


def to_static_graph_break_falls_back_to_eager(paddle):
    nn = paddle.nn

    class Branchy(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 1)

        def forward(self, x):
            h = self.lin(x)
            # a Python `if` on a tensor VALUE: no one program holds it
            if float(h.sum()) > 0:
                return h * 2.0
            return h

    paddle.seed(5)
    model = Branchy()
    smodel = paddle.jit.to_static(model)
    x = paddle.Tensor(_x((8, 4), 2))
    with pytest.warns(UserWarning, match="data-dependent"):
        out = smodel(x)
    assert out.shape == [8, 1]
    # second call: the cached graph break, no second warning
    with warnings.catch_warnings():
        warnings.simplefilter("error")
        out2 = smodel(x)
    np.testing.assert_allclose(out2.numpy(), out.numpy())
    losses = _fit(paddle, smodel, model, 30, 0.05)
    assert losses[-1] < losses[0], losses
    return {"out": out, "losses": np.asarray(losses, np.float32)}


def to_static_function_and_recompile_per_shape(paddle):
    @paddle.jit.to_static
    def fn(a, b):
        return paddle.matmul(a, b).sum()

    a, b = paddle.Tensor(_x((4, 8), 3)), paddle.Tensor(_x((8, 2), 4))
    out = fn(a, b)
    np.testing.assert_allclose(float(out), float((a.numpy() @ b.numpy())
                                                 .sum()), rtol=1e-5)
    out2 = fn(a, b)
    assert out2.shape == []
    out3 = fn(paddle.Tensor(_x((3, 8), 5)), b)
    if hasattr(fn, "_programs"):      # the port: one program a shape
        assert len(fn._programs) == 2
    return {"out": out, "out2": out2, "out3": out3}


def to_static_tuple_outputs(paddle):
    nn = paddle.nn

    class M(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(4, 4)

        def forward(self, x):
            h = self.lin(x)
            return h, h.sum()

    paddle.seed(6)
    h, s = paddle.jit.to_static(M())(paddle.Tensor(_x((2, 4), 6)))
    assert h.shape == [2, 4] and s.shape == []
    return {"h": h, "s": s}


def _saved(paddle, path, spec_shape, seed, act="ReLU"):
    nn = paddle.nn
    paddle.seed(seed)
    model = nn.Sequential(nn.Linear(8, 16), getattr(nn, act)(),
                          nn.Linear(16, 4))
    model.eval()
    paddle.jit.save(model, path, input_spec=[
        paddle.jit.InputSpec(spec_shape, "float32")])
    return model


def jit_save_load_roundtrip(paddle, tmp):
    path = os.path.join(tmp, "model")
    model = _saved(paddle, path, [2, 8], 2)
    x = paddle.Tensor(_x((2, 8), 7))
    ref = model(x)
    assert os.path.exists(path + ".pdmodel")
    assert os.path.exists(path + ".pdiparams")
    out = paddle.jit.load(path)(x)
    np.testing.assert_allclose(out.numpy(), ref.numpy(), rtol=1e-5,
                               atol=1e-6)
    assert len(list(paddle.jit.load(path).parameters())) == 4
    return {"out": out}


def jit_save_load_dynamic_batch(paddle, tmp):
    path = os.path.join(tmp, "dyn")
    model = _saved(paddle, path, [None, 8], 7)
    loaded = paddle.jit.load(path)
    out = {}
    for bs in (1, 3, 7):
        x = paddle.Tensor(_x((bs, 8), bs))
        out[bs] = loaded(x)
        np.testing.assert_allclose(out[bs].numpy(), model(x).numpy(),
                                   rtol=1e-5, atol=1e-6)
    return {str(k): v for k, v in out.items()}


def predictor_over_saved_program(paddle, tmp):
    """`test_inference.py:318`: jit.save -> Config -> create_predictor ->
    handles -> run, and the list form."""
    infer = paddle.inference
    path = os.path.join(tmp, "model")
    nn = paddle.nn
    paddle.seed(0)
    net = nn.Sequential(nn.Linear(8, 16), nn.ReLU(), nn.Linear(16, 4))
    paddle.jit.save(net, path, input_spec=[
        paddle.jit.InputSpec([2, 8], "float32")])
    cfg = infer.Config(path + ".pdmodel", path + ".pdiparams")
    cfg.disable_gpu()
    predictor = infer.create_predictor(cfg)
    assert predictor.get_input_names() == ["x0"]
    h = predictor.get_input_handle("x0")
    assert h.shape() == [2, 8] and h.type() == "float32"
    x = np.random.default_rng(0).normal(size=(2, 8)).astype(np.float32)
    h.copy_from_cpu(x)
    assert predictor.run()
    out_h = predictor.get_output_handle(predictor.get_output_names()[0])
    got = out_h.copy_to_cpu()
    ref = net(paddle.Tensor(x)).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    got2 = predictor.run([x])[0]
    np.testing.assert_allclose(got2, ref, atol=1e-5)
    return {"got": got, "got2": got2, "out_shape": out_h.shape()}


SCENARIOS = [to_static_layer_matches_eager, to_static_trains_params,
             to_static_graph_break_falls_back_to_eager,
             to_static_function_and_recompile_per_shape,
             to_static_tuple_outputs]
FILE_SCENARIOS = [jit_save_load_roundtrip, jit_save_load_dynamic_batch,
                  predictor_over_saved_program]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_jit_scenario(scenario, pkg):
    SC.run(scenario, pkg)


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", FILE_SCENARIOS,
                         ids=lambda f: f.__name__)
def test_jit_file_scenario(scenario, pkg, tmp_path):
    def run(paddle):
        d = tmp_path / paddle.__name__
        d.mkdir(exist_ok=True)
        return scenario(paddle, str(d))
    run.__name__ = scenario.__name__
    SC.run(run, pkg)


def test_pdiparams_equal_across_packages_and_programs_refused(tmp_path):
    """The same seeded model saved by both packages: the `.pdiparams`
    hold the same names and bits (each loads in the other package), each
    program reloads within 1e-5 of its eager forward, and the port's
    `jit.load` refuses the JAX package's StableHLO `.pdmodel` (and a
    file that is no program) with `ProgramFormatError`."""
    jpath, tpath = str(tmp_path / "jax"), str(tmp_path / "port")
    models = {"jax": _saved(jpaddle, jpath, [None, 8], 9, "GELU"),
              "torch": _saved(tpaddle, tpath, [None, 8], 9, "GELU")}
    x = _x((3, 8), 10)
    for pkg, path in (("jax", jpath), ("torch", tpath)):
        paddle = {"jax": jpaddle, "torch": tpaddle}[pkg]
        out = paddle.jit.load(path)(paddle.Tensor(fresh(x)))
        np.testing.assert_allclose(
            out.numpy(), models[pkg](paddle.Tensor(fresh(x))).numpy(),
            rtol=1e-5, atol=1e-5)
    for paddle in (jpaddle, tpaddle):
        a = paddle.load(jpath + ".pdiparams")
        b = paddle.load(tpath + ".pdiparams")
        assert list(a) == list(b) == ["0.bias", "0.weight", "2.bias",
                                      "2.weight"]
        for k in a:
            np.testing.assert_array_equal(a[k].numpy(), b[k].numpy(), k)
    with pytest.raises(tpaddle.jit.ProgramFormatError,
                       match=r"StableHLO.*pdiparams"):
        tpaddle.jit.load(jpath)
    (tmp_path / "junk.pdmodel").write_bytes(b"not a pickle at all")
    with pytest.raises(tpaddle.jit.ProgramFormatError):
        tpaddle.jit.load(str(tmp_path / "junk"))
    # the port's own program refuses a layer whose forward it cannot take
    with pytest.raises(ValueError, match="input_spec"):
        tpaddle.jit.save(models["torch"], tpath)


def test_captured_programs_record_the_kernels(tmp_path):
    """A captured decoder layer holds the flash attention and RMSNorm
    custom ops (which pick their route where they run) and no softmax;
    so does a head dim the port's kernels refuse and the JAX rule takes
    (D 8), which the eager path gives to the plain attention on the CPU
    and refuses on the card. No kernel launches at capture."""
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools import eager_workload as ew
    from paddle_tpu_torch.tools.jit_workload import program_ops

    tpaddle.seed(3)
    layer = tpaddle.jit.to_static(ew.decoder_layer(tpaddle, 64, 2, 96, 16))
    _support.reset_launch_counts()
    layer(tpaddle.to_tensor(_x((1, 16, 64))))
    (gm, _), = layer.forward._programs.values()
    assert program_ops(gm) == {"paddle_tpu_torch.flash_attention.default": 1,
                               "paddle_tpu_torch.rms_norm.default": 2}
    F = tpaddle.nn.functional
    q = tpaddle.to_tensor(_x((1, 16, 2, 8)))
    f = tpaddle.jit.to_static(
        lambda t: F.scaled_dot_product_attention(t, t, t, is_causal=True))
    np.testing.assert_allclose(
        f(q).numpy(), F.scaled_dot_product_attention(q, q, q,
                                                     is_causal=True).numpy(),
        rtol=1e-5, atol=1e-6)
    (gm, _), = f._programs.values()
    assert program_ops(gm) == {"paddle_tpu_torch.flash_attention.default": 1}
    assert all(c.count == 0 for c in _support._COUNTERS.values())


def test_smoke_jit_phases_rehearsed_on_the_cpu(tmp_path):
    """The `jit_layer` phase's body (`jit_workload.layer_run`) at hidden
    64 in f32: to_static bit-equal to eager over two AdamW steps, the
    Predictor at batch 1 and 2 equal to the eager eval forward, the
    saved program's kernels; and the `jit_reference` body on the CPU:
    to_static, jit.load and the Predictor within 1e-5 of eager at batch
    1, 3 and 7."""
    from paddle_tpu_torch.tools import jit_workload as jw

    cfg = dict(batch=1, seq=16, hidden=64, heads=2, ffn=96)
    r = jw.layer_run(tpaddle, cfg, "float32", str(tmp_path / "l" / "layer"))
    assert r["bit_equal"] and set(r["launches"]) == {
        "eager0", "eager1", "static0", "static1"}
    assert {k: v["norm_rel_err"] for k, v in r["serve"].items()} == {
        "b1": 0.0, "b2": 0.0}
    assert r["serve"]["b2"]["shape"] == [2, 16, 64]
    assert r["program_ops"] == {
        "paddle_tpu_torch.flash_attention.default": 1,
        "paddle_tpu_torch.rms_norm.default": 2}
    out = jw.reference_run(tpaddle, jw.reference_models(tpaddle),
                           str(tmp_path))
    for name in ("mlp", "attention", "decoder"):
        for kind in ("static", "static_dx"):
            np.testing.assert_allclose(
                out[f"{name}.{kind}"],
                out[f"{name}.{kind.replace('static', 'eager')}"],
                rtol=1e-5, atol=1e-6)
        for b in (1, 3, 7):
            for kind in ("loaded", "predictor"):
                np.testing.assert_allclose(out[f"{name}.{kind}.b{b}"],
                                           out[f"{name}.eval.b{b}"],
                                           rtol=1e-5, atol=1e-6)


def test_predictor_places_and_refused_options(tmp_path):
    """The Predictor runs on the card unless `disable_gpu()` (so here,
    without a card, it raises); `enable_profile` is not ported."""
    import torch

    path = str(tmp_path / "m")
    _saved(tpaddle, path, [None, 8], 4)
    cfg = tpaddle.inference.Config(path + ".pdmodel", path + ".pdiparams")
    assert cfg.use_gpu() and cfg.device() == "gpu:0"
    with pytest.raises(NotImplementedError, match="profiler"):
        cfg.enable_profile()
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="CUDA|set_device"):
            tpaddle.inference.create_predictor(cfg)
    cfg.disable_gpu()
    p = tpaddle.inference.create_predictor(cfg)
    (out,) = p.run([tpaddle.to_tensor(_x((5, 8)))])
    assert isinstance(out, tpaddle.Tensor) and out.shape == [5, 4]
    assert tpaddle.inference.get_version().startswith("paddle_tpu_torch")
