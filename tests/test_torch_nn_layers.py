"""The Layer surface of the port (`paddle_tpu_torch.nn`): every case of
`tests/test_nn.py` `TestLinear`, `test_layernorm`, `test_rmsnorm`,
`test_dropout_train_eval`, `test_embedding`, `test_embedding_grad`,
`TestContainers`, `TestLayerMechanics` (with a registered buffer where
the JAX case uses BatchNorm's; gradient clipping is not ported) and
`TestActivationsLayers`, each run on both packages with its own
assertions and the port's results held to the JAX package's
(`torch_eager_common.py`): values within the dtype's tolerance, the
seeded weights and dropout masks bit for bit. Then the decoder layer of
the smoke run's `jit_layer` phase at a tiny width, forward and
gradients, on both packages."""
import numpy as np
import pytest

from torch_eager_common import (Scenarios, fresh, jpaddle,  # noqa: F401
                                port_on_cpu, tpaddle)
from torch_threads import one_thread  # noqa: F401

SC = Scenarios()
PKGS = ("jax", "torch")


def t(paddle, x, sg=True):
    return paddle.to_tensor(fresh(np.asarray(x)), stop_gradient=sg)


def _rng():
    return np.random.default_rng(0)


# -- TestLinear -------------------------------------------------------------

def linear_forward_matches_numpy(paddle):
    paddle.seed(0)
    lin = paddle.nn.Linear(6, 4)
    x = _rng().standard_normal((3, 6)).astype("float32")
    out = lin(t(paddle, x))
    ref = x @ lin.weight.numpy() + lin.bias.numpy()
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-5)
    return {"out": out, "w": lin.weight, "b": lin.bias}


def linear_backward(paddle):
    paddle.seed(0)
    lin = paddle.nn.Linear(6, 4)
    x = t(paddle, _rng().standard_normal((3, 6)).astype("float32"),
          sg=False)
    lin(x).sum().backward()
    np.testing.assert_allclose(x.grad.numpy(),
                               np.tile(lin.weight.numpy().sum(1), (3, 1)),
                               rtol=1e-5)
    assert lin.weight.grad.shape == [6, 4]
    assert lin.bias.grad.shape == [4]
    return {"dx": x.grad, "dw": lin.weight.grad, "db": lin.bias.grad}


def linear_no_bias(paddle):
    lin = paddle.nn.Linear(6, 4, bias_attr=False)
    assert lin.bias is None
    out = lin(t(paddle, np.ones((2, 6), "float32")))
    assert out.shape == [2, 4]
    return {"shape": out.shape,
            "params": [n for n, _ in lin.named_parameters()]}


# -- norms, dropout, embedding ----------------------------------------------

def layernorm(paddle):
    ln = paddle.nn.LayerNorm(8)
    x = _rng().standard_normal((4, 8)).astype("float32")
    out = ln(t(paddle, x))
    ref = (x - x.mean(-1, keepdims=True)) / np.sqrt(
        x.var(-1, keepdims=True) + 1e-5)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    return {"out": out, "params": [n for n, _ in ln.named_parameters()]}


def rmsnorm(paddle):
    rn = paddle.nn.RMSNorm(8)
    x = _rng().standard_normal((4, 8)).astype("float32")
    out = rn(t(paddle, x))
    ref = x / np.sqrt((x ** 2).mean(-1, keepdims=True) + 1e-6)
    np.testing.assert_allclose(out.numpy(), ref, rtol=1e-4, atol=1e-5)
    return {"out": out, "w": rn.weight}


def dropout_train_eval(paddle):
    F = paddle.nn.functional
    paddle.seed(0)
    x = t(paddle, np.ones((100, 100), "float32"))
    out = F.dropout(x, 0.5, training=True)
    kept = out.numpy()
    assert 0.3 < (kept == 0).mean() < 0.7
    np.testing.assert_allclose(kept[kept != 0], 2.0)  # upscale
    np.testing.assert_allclose(F.dropout(x, 0.5, training=False).numpy(),
                               np.ones((100, 100)))
    # the masks are the JAX package's bits: the whole output, and the
    # axis, downscale and layer forms
    layer = paddle.nn.Dropout(0.25)
    return {"out": out, "axis": F.dropout(x, 0.3, axis=1),
            "down": F.dropout(x, 0.4, mode="downscale_in_infer"),
            "down_eval": F.dropout(x, 0.4, training=False,
                                   mode="downscale_in_infer"),
            "layer": layer(x), "layer_eval": layer.eval()(x)}


def embedding(paddle):
    paddle.seed(0)
    emb = paddle.nn.Embedding(10, 4, padding_idx=0)
    ids = t(paddle, np.array([[1, 0, 3]]))
    out = emb(ids)
    np.testing.assert_allclose(out.numpy()[0, 1], np.zeros(4))
    np.testing.assert_allclose(out.numpy()[0, 2], emb.weight.numpy()[3])
    return {"out": out, "w": emb.weight}


def embedding_grad(paddle):
    emb = paddle.nn.Embedding(10, 4)
    out = emb(t(paddle, np.array([1, 1, 2])))
    out.sum().backward()
    g = emb.weight.grad.numpy()
    np.testing.assert_allclose(g[1], 2 * np.ones(4))
    np.testing.assert_allclose(g[2], np.ones(4))
    np.testing.assert_allclose(g[0], np.zeros(4))
    # padding_idx: its lookups give zeros and no gradient
    pad = paddle.nn.Embedding(10, 4, padding_idx=-1)
    pad(t(paddle, np.array([9, 2, 9]))).sum().backward()
    return {"g": emb.weight.grad, "pad_g": pad.weight.grad}


# -- TestContainers -----------------------------------------------------------

def sequential(paddle):
    nn = paddle.nn
    m = nn.Sequential(nn.Linear(4, 8), nn.ReLU(), nn.Linear(8, 2))
    out = m(t(paddle, np.ones((2, 4), "float32")))
    assert out.shape == [2, 2]
    assert len(m) == 3
    assert isinstance(m[1], nn.ReLU)
    named = nn.Sequential(("a", nn.Linear(2, 2)), ("b", nn.Tanh()))
    assert isinstance(m[1:], nn.Sequential) and len(m[1:]) == 2
    return {"shape": out.shape, "len": len(m),
            "named": [n for n, _ in named.named_sublayers()]}


def layerlist(paddle):
    nn = paddle.nn
    ll = nn.LayerList([nn.Linear(2, 2) for _ in range(3)])
    ll.append(nn.Linear(2, 2))
    assert len(ll) == 4
    assert len(list(ll.parameters())) == 8
    ll.insert(1, nn.ReLU())
    del ll[0]
    return {"len": len(ll), "types": [type(x).__name__ for x in ll],
            "names": [n for n, _ in ll.named_parameters()]}


def layerdict_parameterlist(paddle):
    nn = paddle.nn
    ld = nn.LayerDict({"a": nn.Linear(2, 2)})
    assert "a" in ld
    pl = nn.ParameterList([nn.Linear(2, 2).weight])
    assert len(pl) == 1
    ld["b"] = nn.ReLU()
    ld.pop("a")
    return {"keys": list(ld.keys()), "pl": len(pl),
            "pl_names": [n for n, _ in pl.named_parameters()]}


# -- TestLayerMechanics -------------------------------------------------------

def named_parameters_nested(paddle):
    nn = paddle.nn
    m = nn.Sequential(nn.Linear(2, 2), nn.Sequential(nn.Linear(2, 2)))
    names = dict(m.named_parameters()).keys()
    assert "0.weight" in names and "1.0.bias" in names
    return {"names": list(names),
            "sublayers": [n for n, _ in m.named_sublayers()]}


def train_eval_propagates(paddle):
    nn = paddle.nn
    m = nn.Sequential(nn.Dropout(0.5), nn.Linear(2, 2))
    m.eval()
    assert not m[0].training
    m.train()
    assert m[0].training
    return {"training": m[0].training}


def buffers_in_state_dict(paddle):
    """`test_buffers_in_state_dict` over registered buffers (BatchNorm is
    not ported): persistable ones are in the state dict, the others are
    buffers but not state; `set_state_dict` fills them back."""
    nn = paddle.nn

    class WithStats(nn.Layer):
        def __init__(self):
            super().__init__()
            self.lin = nn.Linear(3, 3)
            self.register_buffer("_mean", paddle.zeros([3]))
            self.register_buffer("_scratch", paddle.ones([3]),
                                 persistable=False)

        def forward(self, x):
            return self.lin(x) - self._mean

    m = WithStats()
    sd = m.state_dict()
    assert "_mean" in sd and "lin.weight" in sd and "_scratch" not in sd
    assert [n for n, _ in m.named_buffers()] == ["_mean", "_scratch"]
    new = {k: np.full(v.shape, 0.5, "float32") for k, v in sd.items()}
    missing, unexpected = m.set_state_dict({**new, "extra": new["_mean"]})
    return {"keys": list(sd), "missing": missing, "unexpected": unexpected,
            "mean": m._mean, "w": m.lin.weight}


def forward_hooks(paddle):
    lin = paddle.nn.Linear(2, 2)
    calls = []
    h = lin.register_forward_post_hook(
        lambda layer, inp, out: calls.append(1))
    pre = lin.register_forward_pre_hook(lambda layer, inp: (inp[0] * 2,))
    out = lin(t(paddle, np.ones((1, 2), "float32")))
    assert calls == [1]
    h.remove()
    pre.remove()
    out2 = lin(t(paddle, np.ones((1, 2), "float32")))
    assert calls == [1]
    return {"pre_doubled": out, "plain": out2}


def apply_and_astype(paddle):
    nn = paddle.nn
    m = nn.Linear(2, 2)
    m.astype("bfloat16")
    assert m.weight.dtype == paddle.bfloat16
    seen = []
    nn.Sequential(m, nn.ReLU()).apply(lambda l: seen.append(
        type(l).__name__))
    return {"dtype": m.weight.dtype.name, "seen": seen,
            "sg": m.weight.stop_gradient, "w": m.weight.astype("float32")}


# -- TestActivationsLayers ----------------------------------------------------

def activations_various(paddle):
    nn = paddle.nn
    x = t(paddle, _rng().standard_normal((4, 8)).astype("float32"))
    out = {}
    for cls in [nn.ReLU, nn.GELU, nn.Sigmoid, nn.Tanh, nn.Silu, nn.ELU,
                nn.LeakyReLU, nn.Hardswish, nn.Mish, nn.Softplus]:
        y = cls()(x)
        assert y.shape == [4, 8]
        out[cls.__name__] = y
    assert nn.Softmax()(x).numpy().sum(-1) == pytest.approx(
        np.ones(4), rel=1e-5)
    F = paddle.nn.functional
    out.update(softmax=nn.Softmax()(x), gelu_tanh=nn.GELU(True)(x),
               elu2=F.elu(x, 2.0), leaky=F.leaky_relu(x, 0.2),
               softplus=F.softplus(x, 2.0, 1.0), swish=nn.Swish()(x))
    return out


def prelu_param(paddle):
    p = paddle.nn.PReLU(8, init=0.1)
    x = t(paddle, -np.ones((2, 8), "float32"))
    np.testing.assert_allclose(p(x).numpy(), -0.1 * np.ones((2, 8)),
                               rtol=1e-5)
    return {"out": p(x), "w": p.weight}


# -- seeded draws -------------------------------------------------------------

def seeded_weights(paddle):
    """After `paddle.seed`, every initializer's draw (f32 and bf16)."""
    nn, I = paddle.nn, paddle.nn.initializer
    paddle.seed(11)
    out = {"linear": nn.Linear(5, 7).weight,
           "embedding": nn.Embedding(6, 3).weight}
    for name, init in (("normal", I.Normal(0.5, 2.0)),
                       ("truncated", I.TruncatedNormal(0.0, 1.0)),
                       ("uniform", I.Uniform(-0.3, 0.2)),
                       ("xavier_normal", I.XavierNormal()),
                       ("kaiming_uniform", I.KaimingUniform()),
                       ("kaiming_normal", I.KaimingNormal()),
                       ("constant", I.Constant(0.7)),
                       ("assign", I.Assign(np.arange(6.0).reshape(2, 3)))):
        out[name] = paddle.create_parameter([2, 3], "float32",
                                            default_initializer=init)
    bf = nn.Linear(6, 3)
    bf.astype("bfloat16")
    out["bf16_bits"] = bf.weight.numpy().view(np.uint16)
    out["bf16_direct_bits"] = paddle.create_parameter(
        [4, 4], "bfloat16").numpy().view(np.uint16)
    out["gain"] = paddle.nn.initializer.calculate_gain("leaky_relu", 0.2)
    attr = paddle.ParamAttr(name="named_w", initializer=I.Constant(2.0),
                            learning_rate=0.5, trainable=False)
    p = paddle.create_parameter([2], "float32", attr=attr)
    out["attr"] = [p.name, p.trainable, p.optimize_attr["learning_rate"]]
    return out


SCENARIOS = [linear_forward_matches_numpy, linear_backward, linear_no_bias,
             layernorm, rmsnorm, dropout_train_eval, embedding,
             embedding_grad, sequential, layerlist, layerdict_parameterlist,
             named_parameters_nested, train_eval_propagates,
             buffers_in_state_dict, forward_hooks, apply_and_astype,
             activations_various, prelu_param, seeded_weights]


@pytest.mark.parametrize("pkg", PKGS)
@pytest.mark.parametrize("scenario", SCENARIOS, ids=lambda f: f.__name__)
def test_layer_scenario(scenario, pkg):
    SC.run(scenario, pkg)


def test_seeded_weights_and_masks_are_bit_equal():
    """Weights after `paddle.seed` and dropout masks: the same bits in
    both packages (not only within a tolerance)."""
    want, got = seeded_weights(jpaddle), seeded_weights(tpaddle)
    for k in want:
        if isinstance(want[k], (int, float, list)):
            continue
        np.testing.assert_array_equal(np.asarray(got[k].numpy() if hasattr(
            got[k], "numpy") else got[k]), np.asarray(
            want[k].numpy() if hasattr(want[k], "numpy") else want[k]), k)
    dw, dt = dropout_train_eval(jpaddle), dropout_train_eval(tpaddle)
    for k in ("out", "axis", "down", "layer"):
        np.testing.assert_array_equal(dt[k].numpy(), dw[k].numpy(), k)


def test_layer_lives_on_the_expected_place():
    """Construction puts parameters on the expected place (the card by
    default, so without one it raises); `Layer.to` moves them and keeps
    them trainable leaves."""
    import torch

    from paddle_tpu_torch.framework import place

    if not torch.cuda.is_available():
        with place.device_scope(None):
            with pytest.raises(RuntimeError, match="set_device"):
                tpaddle.nn.Linear(2, 2)
    lin = tpaddle.nn.Linear(2, 2)
    assert lin.weight.place == tpaddle.CPUPlace()
    lin.to("cpu", dtype="float64")
    assert lin.weight.dtype == tpaddle.float64
    assert not lin.weight.stop_gradient and lin.weight.is_leaf
    lin(tpaddle.ones([1, 2], "float64")).sum().backward()
    assert lin.weight.grad.shape == [2, 2]


def test_decoder_layer_matches_jax():
    """`tools.eager_workload.decoder_layer` (the `jit_layer` phase's
    layer) at hidden 64, 2 heads of 32, MLP 96, B 2 x S 16: the same
    seeded weights, forward and every parameter's gradient of
    `(out ** 2).mean()` within 1e-5 of the largest value (the port takes
    its flash and RMSNorm kernels' plain versions; JAX its composites)."""
    from paddle_tpu_torch.tools.eager_workload import decoder_layer

    x = _rng().standard_normal((2, 16, 64)).astype("float32")
    res = {}
    for name, paddle in (("jax", jpaddle), ("torch", tpaddle)):
        paddle.seed(4)
        layer = decoder_layer(paddle, 64, 2, 96, 32)
        out = layer(paddle.to_tensor(fresh(x)))
        (out ** 2).mean().backward()
        res[name] = [out.numpy()] + [p.grad.numpy()
                                     for p in layer.parameters()]
        assert [n for n, _ in layer.named_buffers()] == ["rope_cos",
                                                         "rope_sin"]
        assert "rope_cos" not in layer.state_dict()
    for want, got in zip(res["jax"], res["torch"]):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=1e-5 * np.abs(want).max())
