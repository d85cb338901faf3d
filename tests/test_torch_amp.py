"""AMP of the port (`paddle_tpu_torch/amp/`) against the JAX package's
(`paddle_tpu/amp/`): every case of `tests/test_amp.py` runs on both
packages from the same seeded numpy inputs, and the port's results
(dtypes exactly; float values within `torch_eager_common.TOL` of their
dtype: bf16 rtol / atol 1e-2, f32 rtol 1e-5 / atol 1e-6) are held to the
JAX package's. Then: every op name of the JAX white and black lists that
one of the port's ops dispatches is the name the JAX package dispatches
for the same call, so the lists key the same ops in both."""
import numpy as np
import pytest

from torch_eager_common import (Scenarios, fresh, jpaddle,  # noqa: F401
                                port_on_cpu, tpaddle)

SC = Scenarios()
PKGS = ("jax", "torch")


def _rand(shape, seed):
    return fresh(np.random.default_rng(seed).random(shape).astype(
        np.float32))


def _dt(t):
    return t.dtype.name


def o1_white_op_runs_bf16(paddle):
    x = paddle.Tensor(_rand((8, 16), 0))
    y = paddle.Tensor(_rand((16, 4), 1))
    with paddle.amp.auto_cast(level="O1"):
        out = paddle.matmul(x, y)
    out2 = paddle.matmul(x, y)
    assert _dt(out) == "bfloat16" and _dt(out2) == "float32"
    return {"out": out.astype("float32"), "dtype": _dt(out),
            "out2": out2, "dtype2": _dt(out2)}


def o1_black_op_stays_fp32(paddle):
    x = paddle.Tensor(_rand((4, 8), 2))
    w = paddle.Tensor(_rand((8, 8), 3))
    with paddle.amp.auto_cast(level="O1"):
        h = paddle.matmul(x, w)
        s = paddle.nn.functional.softmax(h)
    assert _dt(s) == "float32"
    return {"h": _dt(h), "s": s, "s_dtype": _dt(s)}


def o1_grads_cast_back_to_param_dtype(paddle):
    w = paddle.Tensor(_rand((8, 4), 4), stop_gradient=False)
    x = paddle.Tensor(_rand((2, 8), 5))
    with paddle.amp.auto_cast(level="O1"):
        loss = paddle.matmul(x, w).sum()
    loss.backward()
    assert w.grad is not None and _dt(w.grad) == "float32"
    return {"loss": loss.astype("float32"), "loss_dtype": _dt(loss),
            "grad": w.grad, "grad_dtype": _dt(w.grad)}


def o1_gray_promote(paddle):
    x = paddle.Tensor(_rand((4, 4), 6))
    y = paddle.Tensor(_rand((4, 4), 7))
    with paddle.amp.auto_cast(level="O1"):
        h = paddle.matmul(x, y)
        z = h + x
    assert _dt(z) == "float32"
    return {"z": z, "dtype": _dt(z)}


def custom_lists(paddle):
    x = paddle.Tensor(_rand((4, 4), 8))
    y = paddle.Tensor(_rand((4, 4), 9))
    with paddle.amp.auto_cast(level="O1", custom_black_list={"matmul"}):
        out = paddle.matmul(x, y)
    with pytest.raises(ValueError):
        paddle.amp.AutoMixedPrecisionLists(custom_white_list={"softmax"},
                                           custom_black_list={"softmax"})
    return {"out": out, "dtype": _dt(out)}


def o2_decorate_casts_params_keeps_norms_fp32(paddle):
    nn = paddle.nn
    paddle.seed(0)
    model = nn.Sequential(nn.Linear(8, 8), nn.LayerNorm(8), nn.Linear(8, 4))
    opt = paddle.optimizer.AdamW(parameters=model.parameters())
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    assert _dt(model[0].weight) == "bfloat16"
    assert _dt(model[1].weight) == "float32"
    assert opt._use_master_weights
    x = paddle.Tensor(_rand((2, 8), 10))
    with paddle.amp.auto_cast(level="O2"):
        out = model(x)
        loss = out.sum()
    loss.backward()
    opt.step()
    masters = sorted(str(v.dtype).replace("torch.", "")
                     for v in opt._master_weights.values())
    assert "float32" in masters
    return {"out": out.astype("float32"), "out_dtype": _dt(out),
            "params": [p.astype("float32") for p in model.parameters()],
            "param_dtypes": [_dt(p) for p in model.parameters()],
            "masters": masters}


def grad_scaler_normal_step(paddle):
    w = paddle.Tensor(np.ones((4, 4), np.float32), stop_gradient=False)
    w.persistable = True
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w])
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0)
    x = paddle.Tensor(np.ones((2, 4), np.float32))
    with paddle.amp.auto_cast(level="O1"):
        loss = paddle.matmul(x, w).sum()
    scaled = scaler.scale(loss)
    scaled.backward()
    before = w.numpy().copy()
    scaler.step(opt)
    scaler.update()
    after = w.numpy()
    assert not np.allclose(before, after)
    g = w.grad.astype("float32").numpy()
    np.testing.assert_allclose(g, np.full((4, 4), 2.0), rtol=2e-2)
    return {"after": after, "grad": g, "scale": scaler.get_loss_scaling()}


def grad_scaler_skips_on_inf_and_decays_scale(paddle):
    w = paddle.Tensor(np.ones((2, 2), np.float32), stop_gradient=False)
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w])
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0, decr_ratio=0.5,
                                   decr_every_n_nan_or_inf=1)
    x = paddle.Tensor(np.full((1, 2), np.inf, np.float32))
    loss = paddle.matmul(x, w).sum()
    scaler.scale(loss).backward()
    before = w.numpy().copy()
    scaler.step(opt)
    scaler.update()
    np.testing.assert_array_equal(before, w.numpy())
    assert scaler.get_loss_scaling() == 512.0
    return {"w": w, "scale": scaler.get_loss_scaling(),
            "skipped": scaler.last_step_skipped(),
            "skips": scaler.get_skipped_steps()}


def scaler_minimize_and_state_dict(paddle):
    w = paddle.Tensor(np.ones((2, 2), np.float32), stop_gradient=False)
    opt = paddle.optimizer.SGD(learning_rate=0.1, parameters=[w])
    scaler = paddle.amp.GradScaler(init_loss_scaling=256.0)
    x = paddle.Tensor(np.ones((1, 2), np.float32))
    loss = paddle.matmul(x, w).sum()
    scaler.scale(loss).backward()
    scaler.minimize(opt, loss)
    sd = scaler.state_dict()
    s2 = paddle.amp.GradScaler()
    s2.load_state_dict(sd)
    assert s2.get_loss_scaling() == scaler.get_loss_scaling()
    return {"w": w, "sd": {k: np.asarray(v) if k == "scale" else v
                           for k, v in sd.items()},
            "grad_cleared": w.grad is None}


def operator_stats_collection(paddle):
    x = paddle.Tensor(_rand((4, 4), 11))
    with paddle.amp.debugging.collect_operator_stats():
        with paddle.amp.auto_cast(level="O1"):
            paddle.matmul(x, x)
        stats = paddle.amp.debugging.operator_stats()
        assert stats["matmul"]["bfloat16"] >= 1
    return {"matmul": stats["matmul"], "cast": stats.get("cast")}


def bf16_supported(paddle):
    assert paddle.amp.is_bfloat16_supported()
    return {"bf16": paddle.amp.is_bfloat16_supported(),
            "fp16_cpu": paddle.amp.is_float16_supported("cpu")}


CASES = [o1_white_op_runs_bf16, o1_black_op_stays_fp32,
         o1_grads_cast_back_to_param_dtype, o1_gray_promote, custom_lists,
         o2_decorate_casts_params_keeps_norms_fp32, grad_scaler_normal_step,
         grad_scaler_skips_on_inf_and_decays_scale,
         scaler_minimize_and_state_dict, operator_stats_collection,
         bf16_supported]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("case", CASES, ids=lambda f: f.__name__)
def test_amp_case(case, pkg, capsys):
    SC.run(case, pkg)


def test_operator_stats_print_the_table(capsys):
    x = tpaddle.Tensor(_rand((4, 4), 12))
    with tpaddle.amp.debugging.collect_operator_stats():
        with tpaddle.amp.auto_cast(level="O1"):
            tpaddle.matmul(x, x)
    out = capsys.readouterr().out
    assert "matmul" in out and "<bfloat16>" in out


# one call per op in the lists that the port has: the op name each
# package dispatches for it must be the same, so a list keys both
_LISTED_CALLS = {
    "matmul": lambda p, x: p.matmul(x, x),
    "linear": lambda p, x: p.nn.functional.linear(x, x, x[0]),
    "linear_nobias": lambda p, x: p.nn.functional.linear(x, x),
    "sdpa": lambda p, x: p.nn.functional.scaled_dot_product_attention(
        x.reshape([1, 4, 1, 4]), x.reshape([1, 4, 1, 4]),
        x.reshape([1, 4, 1, 4]), is_causal=True),
    "exp": lambda p, x: p.exp(x),
    "log": lambda p, x: p.log(x),
    "elementwise_pow": lambda p, x: p.pow(x, x),
    "reduce_sum": lambda p, x: p.sum(x),
    "reduce_mean": lambda p, x: p.mean(x),
    "softmax": lambda p, x: p.nn.functional.softmax(x),
    "cross_entropy_hard": lambda p, x: p.nn.functional.cross_entropy(
        x, p.to_tensor(np.array([0, 1, 2, 3]))),
    "layer_norm": lambda p, x: p.nn.functional.layer_norm(x, 4, x[0],
                                                          x[1]),
    "layer_norm_nob": lambda p, x: p.nn.functional.layer_norm(x, 4, x[0]),
    "layer_norm_now": lambda p, x: p.nn.functional.layer_norm(x, 4,
                                                              bias=x[1]),
    "layer_norm_nowb": lambda p, x: p.nn.functional.layer_norm(x, 4),
    "rms_norm": lambda p, x: p.nn.RMSNorm(4)(x),
}


def _dispatched(paddle, call):
    names = []

    def obs(name, outs):
        names.append(name)

    paddle.core.dispatch.add_op_observer(obs)
    try:
        call(paddle, paddle.Tensor(_rand((4, 4), 13) + 0.5))
    finally:
        paddle.core.dispatch.remove_op_observer(obs)
    return names


@pytest.mark.parametrize("name", sorted(_LISTED_CALLS))
def test_listed_op_names_are_held_under_the_same_name(name):
    from paddle_tpu.amp.amp_lists import BLACK_LIST, WHITE_LIST

    from paddle_tpu_torch.amp import amp_lists

    assert name in WHITE_LIST | BLACK_LIST
    assert amp_lists.WHITE_LIST == WHITE_LIST
    assert amp_lists.BLACK_LIST == BLACK_LIST
    assert name in tpaddle.core.dispatch.op_registry()
    call = _LISTED_CALLS[name]
    jax_names = _dispatched(jpaddle, call)
    port_names = _dispatched(tpaddle, call)
    assert name in port_names
    listed = WHITE_LIST | BLACK_LIST
    assert [n for n in port_names if n in listed] \
        == [n for n in jax_names if n in listed]
