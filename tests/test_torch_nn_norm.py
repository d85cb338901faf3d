"""The norm family of the port (`nn/functional/norm.py`,
`nn/layer/norm.py`) held to the JAX package: the BatchNorm cases of
`tests/test_nn.py` `TestNorm` and `TestFunctionalMisc.test_normalize`,
each with its own assertions on both packages; the batch norms' running
statistics after two training steps (JAX's momentum convention, the
unbiased variance), NHWC, missing affine parameters and
`use_global_stats`; group, instance and local-response norms;
`SpectralNorm` (its `weight_u` / `weight_v` written by the forward);
`SyncBatchNorm.convert_sync_batchnorm`; gradients; and a model with
buffers carried from the JAX package by `convert.layers_from_jax_state`.
Seeded `Orthogonal` and `Dirac` weights are bit-equal.

The JAX package's running variance turns float64 after a training step
(its unbiased factor is a numpy float64 under `jax_enable_x64`), and so
do eval outputs that read it; the port keeps the buffer float32. Those
values are compared in float32 (`_f32`), and the port's dtype is
asserted float32."""
import numpy as np
import pytest

from torch_nn_common import (cotangent_grads, grads_of,  # noqa: F401
                             jpaddle, one_thread, param_grads, port_on_cpu,
                             rng, scenario_test, t, tpaddle)


def _x(shape, seed=0):
    return rng(seed).standard_normal(shape).astype("float32")


def _f32(paddle, v):
    """A running variance (or what reads it) as float32; the port's is
    float32 already."""
    if paddle is tpaddle:
        assert v.dtype == tpaddle.float32
    return v.astype("float32")


# -- TestNorm (batch norm) --------------------------------------------------

def batchnorm_train_stats(paddle):
    paddle.seed(0)
    bn = paddle.nn.BatchNorm1D(4, data_format="NCL")
    x = _x((8, 4, 5)) * 3 + 1
    out = bn(t(paddle, x))
    np.testing.assert_allclose(out.numpy().mean((0, 2)), np.zeros(4),
                               atol=1e-5)
    np.testing.assert_allclose(out.numpy().std((0, 2)), np.ones(4),
                               atol=1e-3)
    assert not np.allclose(bn._mean.numpy(), 0)
    return {"out": out, "mean": bn._mean, "var": _f32(paddle, bn._variance)}


def batchnorm_eval_uses_running(paddle):
    bn = paddle.nn.BatchNorm2D(3)
    bn.eval()
    x = _x((2, 3, 4, 4))
    out = bn(t(paddle, x))
    np.testing.assert_allclose(out.numpy(), x, atol=1e-4)
    return {"out": out}


def normalize(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((3, 4)))
    out = F.normalize(x, axis=1)
    np.testing.assert_allclose(np.linalg.norm(out.numpy(), axis=1),
                               np.ones(3), rtol=1e-5)
    return {"out": out, "p1": F.normalize(x, p=1, axis=0),
            "p3": F.normalize(x, p=3.0, axis=-1, epsilon=1e-3)}


# -- batch norm options -------------------------------------------------------

def batchnorm_two_steps(paddle):
    """A conv net with BatchNorm2D two SGD steps: the running statistics
    follow JAX's `new = 0.9 * running + 0.1 * batch` (unbiased variance),
    then an eval forward uses them."""
    paddle.seed(5)
    nn = paddle.nn
    net = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.BatchNorm2D(4),
                        nn.ReLU(), nn.MaxPool2D(2))
    opt = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=net.parameters())
    x = t(paddle, _x((4, 3, 6, 6)) * 2 + 0.5)
    losses = []
    for _ in range(2):
        loss = (net(x) ** 2).mean()
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)
    net.eval()
    return {"losses": losses, "mean": net[1]._mean,
            "var": _f32(paddle, net[1]._variance),
            "eval": _f32(paddle, net(x)),
            "params": dict(net.named_parameters())}


def batchnorm_options(paddle):
    F = paddle.nn.functional
    x = t(paddle, _x((4, 5, 3, 2)) + 1)
    out = {}
    for name, kw in (("nhwc", dict(data_format="NHWC")),
                     ("no_affine", dict(weight_attr=False, bias_attr=False)),
                     ("no_bias", dict(bias_attr=False)),
                     ("global", dict(use_global_stats=True)),
                     ("momentum", dict(momentum=0.5, epsilon=1e-3))):
        paddle.seed(1)
        c = 2 if name == "nhwc" else 5
        bn = paddle.nn.BatchNorm2D(c, **kw)
        out[name] = bn(x)
        out[name + "_stats"] = [bn._mean, _f32(paddle, bn._variance)]
    paddle.seed(2)
    bn3 = paddle.nn.BatchNorm3D(5)
    out["bn3"] = bn3(x.unsqueeze(-1))
    out["bn3_stats"] = [bn3._mean, _f32(paddle, bn3._variance)]
    rm = t(paddle, np.full(5, 0.5, "float32"))
    rv = t(paddle, np.full(5, 2.0, "float32"))
    out["f_eval"] = F.batch_norm(x, rm, rv, epsilon=1e-3)
    out["f_train"] = F.batch_norm(x, rm, rv, training=True, momentum=0.8)
    out["f_stats"] = [rm, _f32(paddle, rv)]
    return out


def batchnorm_gradients(paddle):
    paddle.seed(3)
    bn = paddle.nn.BatchNorm1D(3)
    x = t(paddle, _x((6, 3, 4)), sg=False)
    y = bn(x)
    g = cotangent_grads(paddle, [y], {"x": x})
    return {"y": y, "grads": {**g, **param_grads(bn)}}


# -- group / instance / local response ----------------------------------------

def group_instance_lrn(paddle):
    nn, F = paddle.nn, paddle.nn.functional
    x = t(paddle, _x((2, 6, 4, 5)))
    paddle.seed(4)
    gn = nn.GroupNorm(3, 6)
    inn = nn.InstanceNorm2D(6)
    return {
        "gn": gn(x), "gn_nhwc": F.group_norm(x.transpose([0, 2, 3, 1]), 2,
                                            data_format="NHWC"),
        "gn_w": F.group_norm(x, 2, weight=t(paddle, _x((6,), 1))),
        "in": inn(x), "in1": nn.InstanceNorm1D(6)(x[:, :, 0]),
        "in3": nn.InstanceNorm3D(6, weight_attr=False,
                                 bias_attr=False)(x.unsqueeze(2)),
        "in_f": F.instance_norm(x, bias=t(paddle, _x((6,), 2)), eps=1e-3),
        "lrn": nn.LocalResponseNorm(3)(x),
        "lrn_nhwc": F.local_response_norm(x.transpose([0, 2, 3, 1]), 4,
                                          alpha=1e-2, beta=0.5, k=2.0,
                                          data_format="NHWC"),
    }


def norm_gradients(paddle):
    nn = paddle.nn
    paddle.seed(6)
    gn = nn.GroupNorm(2, 4)
    inn = nn.InstanceNorm2D(4)
    x = t(paddle, _x((2, 4, 3, 3)), sg=False)
    outs = [gn(x), inn(x), nn.LocalResponseNorm(3)(x),
            paddle.nn.functional.normalize(x, axis=1)]
    return {"grads": {**cotangent_grads(paddle, outs, {"x": x}),
                      **param_grads(gn), **param_grads(inn)}}


def spectral_norm(paddle):
    paddle.seed(7)
    sn = paddle.nn.SpectralNorm([4, 3, 2], dim=1, power_iters=2)
    w = t(paddle, _x((4, 3, 2)), sg=False)
    out = sn(w)
    u0, v0 = sn.weight_u.numpy(), sn.weight_v.numpy()
    out2 = sn(w)
    assert sn.weight_u.stop_gradient is False
    names = [n for n, _ in sn.named_parameters()]
    g = grads_of(out2.sum(), {"w": w})
    return {"out": out, "out2": out2, "u0": u0, "v0": v0,
            "u": sn.weight_u, "v": sn.weight_v, "names": names, "grads": g}


def sync_batchnorm(paddle):
    paddle.seed(8)
    nn = paddle.nn
    net = nn.Sequential(nn.Conv2D(2, 3, 1), nn.BatchNorm2D(3))
    conv = nn.SyncBatchNorm.convert_sync_batchnorm(net)
    assert isinstance(conv[1], nn.SyncBatchNorm)
    assert conv[1].weight is net[1].weight
    x = t(paddle, _x((2, 2, 3, 3)))
    y = conv(x)
    return {"y": y, "mean": conv[1]._mean,
            "keys": sorted(conv.state_dict())}


SCENARIOS = [batchnorm_train_stats, batchnorm_eval_uses_running, normalize,
             batchnorm_two_steps, batchnorm_options, batchnorm_gradients,
             group_instance_lrn, norm_gradients, spectral_norm,
             sync_batchnorm]

test_scenario = scenario_test(SCENARIOS)


def test_state_with_buffers_crosses_from_jax():
    """`layers_from_jax_state` takes the JAX package's parameters and
    persistable buffers (BatchNorm's `_mean` / `_variance`) and the port
    model then computes the JAX model's outputs."""
    from paddle_tpu_torch.convert import layers_from_jax_state

    def make(paddle):
        nn = paddle.nn
        return nn.Sequential(nn.Conv2D(3, 4, 3), nn.BatchNorm2D(4),
                             nn.ReLU(), nn.AdaptiveAvgPool2D(1))

    jpaddle.seed(9)
    jm = make(jpaddle)
    x = _x((2, 3, 5, 5))
    jm(jpaddle.to_tensor(x))                  # moves the running stats
    jm.eval()
    state = {n: np.asarray(v.numpy()) for n, v in jm.state_dict().items()}
    assert "1._mean" in state and "1._variance" in state
    tpaddle.seed(10)
    tm = layers_from_jax_state(state, make(tpaddle))
    tm.eval()
    np.testing.assert_array_equal(tm[1]._variance.numpy(),
                                  state["1._variance"].astype("float32"))
    np.testing.assert_allclose(tm(tpaddle.to_tensor(x)).numpy(),
                               jm(jpaddle.to_tensor(x)).numpy()
                               .astype("float32"),
                               rtol=1e-5, atol=1e-6)
    with pytest.raises(KeyError):
        layers_from_jax_state({k: v for k, v in state.items()
                               if k != "1._mean"}, make(tpaddle))


@pytest.mark.parametrize("shape", [(6, 4), (3, 8), (4, 2, 3, 3)])
def test_seeded_orthogonal_and_dirac_are_bit_equal(shape):
    got = []
    for paddle in (jpaddle, tpaddle):
        init = paddle.nn.initializer
        paddle.seed(13)
        o = init.Orthogonal(gain=1.5)(list(shape), "float32")
        d = init.Dirac(groups=2)([4, 2, 3, 3], "float32")
        lin = paddle.nn.Linear(
            4, 6, weight_attr=paddle.ParamAttr(
                initializer=init.Orthogonal()))
        got.append([np.asarray(getattr(o, "numpy", lambda: o)()),
                    np.asarray(getattr(d, "numpy", lambda: d)()),
                    lin.weight.numpy()])
    for a, b in zip(*got):
        np.testing.assert_array_equal(np.asarray(b), np.asarray(a))
