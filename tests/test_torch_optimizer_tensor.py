"""The port's optimizers over a Layer's `Parameter`s
(`paddle_tpu_torch.optimizer`: SGD, Momentum with and without Nesterov,
Adam, AdamW): the counterparts of `tests/test_optimizer.py`'s
convergence fits, exact updates, L2 and decoupled decay, `state_dict`
round trip, `minimize`, `set_lr` / `get_lr`, bf16 master weights and the
positional decay mask, each on both packages with the port held to the
JAX package (`torch_eager_common.py`); and three-step trajectories from
the same seeded weights, f32 within 1e-7 (as
`test_torch_training.py` holds AdamW over torch parameters) and bf16
with f32 masters within one bf16 ulp."""
import numpy as np
import pytest

from torch_eager_common import (Scenarios, jpaddle,  # noqa: F401
                                port_on_cpu, tpaddle)

SC = Scenarios()
PKGS = ("jax", "torch")


def _ones(paddle, shape, v=1.0):
    return paddle.to_tensor(np.full(shape, v, "float32"))


def sgd_exact_update(paddle):
    paddle.seed(7)
    p = paddle.nn.Linear(2, 2).weight
    before = p.numpy().copy()
    o = paddle.optimizer.SGD(0.5, parameters=[p])
    p.grad = _ones(paddle, (2, 2))
    o.step()
    np.testing.assert_allclose(p.numpy(), before - 0.5, rtol=1e-6)
    return {"p": p}


def weight_decay_l2(paddle):
    paddle.seed(7)
    p = paddle.nn.Linear(2, 2).weight
    before = p.numpy().copy()
    o = paddle.optimizer.SGD(0.1, parameters=[p], weight_decay=0.1)
    p.grad = _ones(paddle, (2, 2), 0.0)
    o.step()
    np.testing.assert_allclose(p.numpy(), before * (1 - 0.01), rtol=1e-5)
    return {"p": p}


def adamw_decoupled_decay(paddle):
    paddle.seed(7)
    p = paddle.nn.Linear(2, 2).weight
    before = p.numpy().copy()
    o = paddle.optimizer.AdamW(0.1, parameters=[p], weight_decay=0.5)
    p.grad = _ones(paddle, (2, 2), 0.0)
    o.step()
    # zero grad -> pure decay: p *= (1 - lr*wd)
    np.testing.assert_allclose(p.numpy(), before * (1 - 0.05), rtol=1e-4)
    return {"p": p}


def state_dict_roundtrip(paddle):
    paddle.seed(7)
    model = paddle.nn.Linear(4, 2)
    o = paddle.optimizer.Adam(0.01, parameters=model.parameters())
    model(_ones(paddle, (2, 4))).sum().backward()
    o.step()
    sd = o.state_dict()
    o2 = paddle.optimizer.Adam(0.01, parameters=model.parameters())
    o2.set_state_dict(sd)
    pid = id(model.parameters()[0])
    np.testing.assert_allclose(
        np.asarray(o2._accumulators["moment1"][pid]),
        np.asarray(o._accumulators["moment1"][pid]))
    names = {p.name: n for n, p in model.named_parameters()}
    keys = sorted(k.replace(k.rsplit("_", 2)[0] if "pow" in k
                            else k.rsplit("_", 1)[0], names.get(
                                k.rsplit("_", 2)[0] if "pow" in k
                                else k.rsplit("_", 1)[0], "?"))
                  for k in sd if k != "global_step")
    return {"keys": keys, "global_step": sd["global_step"],
            "m1": np.asarray(o2._accumulators["moment1"][pid])}


def minimize(paddle):
    paddle.seed(7)
    model = paddle.nn.Linear(2, 1)
    o = paddle.optimizer.SGD(0.1, parameters=model.parameters())
    loss = model(_ones(paddle, (1, 2))).sum()
    o.minimize(loss)
    assert model.weight.grad is not None
    return {"w": model.weight, "g": model.weight.grad}


def set_lr_get_lr(paddle):
    o = paddle.optimizer.SGD(0.1, parameters=[paddle.nn.Linear(2, 2).weight])
    assert o.get_lr() == 0.1
    o.set_lr(0.01)
    assert o.get_lr() == 0.01
    return {"lr": o.get_lr()}


def master_weights_bf16(paddle):
    paddle.seed(7)
    model = paddle.nn.Linear(4, 2)
    model.astype("bfloat16")
    o = paddle.optimizer.Adam(0.01, parameters=model.parameters(),
                              multi_precision=True)
    x = _ones(paddle, (2, 4)).astype("bfloat16")
    model(x).sum().backward()
    o.step()
    pid = id(model.parameters()[0])
    assert pid in o._master_weights
    master = np.asarray(o._master_weights[pid])
    assert master.dtype == np.float32
    return {"w_bits": model.weight.numpy().view(np.uint16),
            "master": master}


def adamw_decay_mask_positional(paddle):
    paddle.seed(7)
    p1 = paddle.nn.Linear(2, 2, bias_attr=False).weight
    p2 = paddle.nn.Linear(2, 2, bias_attr=False).weight
    p1.name, p2.name = "decay_me", "no_decay"
    b2 = p2.numpy().copy()
    o = paddle.optimizer.AdamW(0.1, parameters=[p1, p2], weight_decay=0.5,
                               apply_decay_param_fun=lambda n:
                               n == "decay_me")
    # p1 has NO grad this step; p2 does: the mask follows identity
    p2.grad = _ones(paddle, (2, 2), 0.0)
    o.step()
    np.testing.assert_allclose(p2.numpy(), b2, atol=1e-7)  # not decayed
    return {"p1": p1, "p2": p2}


def per_parameter_learning_rate(paddle):
    """A `ParamAttr(learning_rate=...)` multiplies the step's lr."""
    attr = paddle.ParamAttr(learning_rate=0.5,
                            initializer=paddle.nn.initializer.Constant(1.0))
    lin = paddle.nn.Linear(2, 2, weight_attr=attr, bias_attr=False)
    o = paddle.optimizer.SGD(0.3, parameters=lin.parameters())
    lin.weight.grad = _ones(paddle, (2, 2))
    o.step()
    np.testing.assert_allclose(lin.weight.numpy(), 1 - 0.15, rtol=1e-6)
    return {"w": lin.weight}


SCENARIOS = [sgd_exact_update, weight_decay_l2, adamw_decoupled_decay,
             state_dict_roundtrip, minimize, set_lr_get_lr,
             master_weights_bf16, adamw_decay_mask_positional,
             per_parameter_learning_rate]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_optimizer_scenario(scenario, pkg):
    SC.run(scenario, pkg)


def _fit(paddle, make, steps=150):
    rng = np.random.default_rng(7)
    X = rng.standard_normal((64, 10)).astype("float32")
    Y = X @ rng.standard_normal((10, 1)).astype("float32")
    paddle.seed(7)
    model = paddle.nn.Linear(10, 1)
    o = make(paddle.optimizer, model.parameters())
    xs, ys = paddle.to_tensor(X), paddle.to_tensor(Y)
    loss = None
    for _ in range(steps):
        loss = ((model(xs) - ys) ** 2).mean()
        loss.backward()
        o.step()
        o.clear_grad()
    return float(loss)


OPTIMIZERS = {
    "sgd": lambda O, ps: O.SGD(0.1, parameters=ps),
    "momentum": lambda O, ps: O.Momentum(0.05, parameters=ps),
    "nesterov": lambda O, ps: O.Momentum(0.05, parameters=ps,
                                         use_nesterov=True),
    "adam": lambda O, ps: O.Adam(0.05, parameters=ps),
    "adamw": lambda O, ps: O.AdamW(0.05, parameters=ps),
}


@pytest.mark.parametrize("name", sorted(OPTIMIZERS))
def test_convergence(name):
    """`TestConvergence` on the port: 150 steps of a linear fit."""
    assert _fit(tpaddle, OPTIMIZERS[name]) < 1e-2


TRAJECTORIES = {
    "sgd_l2": lambda O, ps, mp: O.SGD(0.05, parameters=ps,
                                      weight_decay=0.01,
                                      multi_precision=mp),
    "momentum": lambda O, ps, mp: O.Momentum(0.05, 0.9, parameters=ps,
                                             weight_decay=0.01,
                                             multi_precision=mp),
    "nesterov": lambda O, ps, mp: O.Momentum(0.05, 0.9, parameters=ps,
                                             use_nesterov=True,
                                             multi_precision=mp),
    "adam_l2": lambda O, ps, mp: O.Adam(0.01, parameters=ps,
                                        weight_decay=0.01,
                                        multi_precision=mp),
    "adamw": lambda O, ps, mp: O.AdamW(0.01, 0.9, 0.95, parameters=ps,
                                       weight_decay=0.1,
                                       apply_decay_param_fun=lambda n:
                                       not n.endswith("bias"),
                                       multi_precision=mp),
}


def _trajectory(paddle, make, dtype, mp):
    """Three steps of a two-layer net from seeded weights: the parameters
    and optimizer state after each step. In f32 the gradients come from
    the net's backward; in bf16 they are the same seeded arrays in both
    packages (the two packages' bf16 forwards round differently, and the
    update is what is under test)."""
    rng = np.random.default_rng(3)
    X = rng.standard_normal((8, 6)).astype("float32")
    Y = rng.standard_normal((8, 2)).astype("float32")
    paddle.seed(3)
    nn = paddle.nn
    model = nn.Sequential(nn.Linear(6, 5), nn.Tanh(), nn.Linear(5, 2))
    for i, (n, p) in enumerate(model.named_parameters()):
        p.name = n.replace(".", "_")
    model.astype(dtype)
    o = make(paddle.optimizer, model.parameters(), mp)
    xs = paddle.to_tensor(X).astype(dtype)
    ys = paddle.to_tensor(Y).astype(dtype)
    out = []
    for _ in range(3):
        if dtype == "float32":
            loss = ((model(xs) - ys).astype("float32") ** 2).mean()
            loss.backward()
        else:
            for p in model.parameters():
                p.grad = paddle.to_tensor(rng.standard_normal(
                    p.shape).astype("float32")).astype(dtype)
        o.step()
        o.clear_grad()
        out.append({n: p.astype("float32").numpy()
                    for n, p in model.named_parameters()})
    state = {k: v.astype("float32").numpy() for k, v in
             o.state_dict().items() if k != "global_step"}
    return out, state


@pytest.mark.parametrize("dtype,mp", [("float32", False),
                                      ("bfloat16", True)])
@pytest.mark.parametrize("name", sorted(TRAJECTORIES))
def test_three_step_trajectory_matches_jax(name, dtype, mp):
    jsteps, jstate = _trajectory(jpaddle, TRAJECTORIES[name], dtype, mp)
    tsteps, tstate = _trajectory(tpaddle, TRAJECTORIES[name], dtype, mp)
    assert sorted(tstate) == sorted(jstate)
    if mp:
        assert any(k.endswith("_master") for k in tstate)
    for step, (want, got) in enumerate(zip(jsteps, tsteps)):
        for n in want:
            if dtype == "float32":
                np.testing.assert_allclose(got[n], want[n], rtol=1e-7,
                                           atol=1e-7, err_msg=f"{n}@{step}")
            else:
                ulp = 2.0 ** (np.floor(np.log2(np.maximum(
                    np.abs(want[n]), 2.0 ** -126))) - 7)
                assert (np.abs(got[n] - want[n]) <= ulp).all(), (n, step)
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=1e-6,
                                   atol=1e-7, err_msg=k)


def test_torch_parameter_path_is_unchanged():
    """The optimizers still take plain torch parameters (the training
    model's): state keyed by `param_name`, torch tensors in the state
    dict, `clear_grad` on `.grad`."""
    import torch

    from paddle_tpu_torch.optimizer import Momentum

    p = torch.nn.Parameter(torch.ones(3))
    p.param_name = "w"
    o = Momentum(0.1, 0.5, parameters=[p])
    p.grad = torch.ones(3)
    o.step()
    o.step()
    assert torch.allclose(p.detach(), torch.full((3,), 1 - 0.1 - 0.15))
    sd = o.state_dict()
    assert set(sd) == {"w_velocity", "global_step"}
    assert isinstance(sd["w_velocity"], torch.Tensor)
    o.clear_grad()
    assert p.grad is None
