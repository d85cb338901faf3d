"""The paddle quantization API on the CPU, held to the JAX package: every
case of `tests/test_quantized_execution.py` but the engine's (which
`test_torch_quant_serving.py` holds), each run on both packages from the
same numpy inputs: `nn.quant` (`weight_quantize` / `weight_dequantize`,
`weight_only_linear`, `llm_int8_linear`, `WeightOnlyLinear`), the
gradient of the int8 gemm against `jax.grad` of JAX's `quant_matmul` in
interpret mode, and `paddle.quantization` (observers, QAT, PTQ in both
convert forms). As in the JAX package, an eager QAT Layer trains its bias
only (`quant_dequant` of a Tensor stops gradient).

Tolerances: quantized weights, scales' bits and packings exact; f32
outputs 1e-6 relative to their range (2e-6 for a 128- or 256-long
dot, summed in another order), bf16 gradients within one bf16 ulp.
The weight-only products are held
at 1e-5 of the output range: JAX's CPU `dequant_matmul` rounds
`wq * scale` to x's dtype before its matmul, the port (as the kernels do)
scales once after the f32 sum.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.framework import flags
from paddle_tpu.nn import quant as JQ
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu_torch.nn import quant as TQ
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm
from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

QMOD = {jpaddle: JQ, tpaddle: TQ}


def _np(t):
    a = np.asarray(t.numpy())
    return a.view(np.uint8) if a.dtype.name.startswith("float8") else a


def _both(fn):
    return fn(jpaddle), fn(tpaddle)


def _close_range(got, want, rel):
    assert np.abs(got - want).max() <= rel * max(np.abs(want).max(), 1e-30)


@pytest.mark.parametrize("algo,shape", [("weight_only_int8", (64, 32)),
                                        ("weight_only_int4", (16, 8)),
                                        ("fp8", (32, 16))])
def test_weight_quantize_layout_and_roundtrip(algo, shape):
    w = np.random.default_rng(0).normal(size=shape).astype(np.float32)

    def run(p):
        Q = QMOD[p]
        wq, scale = Q.weight_quantize(p.to_tensor(w), algo=algo)
        back = Q.weight_dequantize(wq, scale, algo=algo, out_dtype="float32")
        return _np(wq), _np(scale), _np(back), str(wq.dtype)
    (wq, ws, wb, wd), (gq, gs, gb, gd) = _both(run)
    assert gd.split(".")[-1] == wd.split(".")[-1]
    np.testing.assert_array_equal(gq, wq)
    np.testing.assert_array_equal(gs.view(np.uint32), ws.view(np.uint32))
    np.testing.assert_array_equal(gb, wb)
    k, n = shape
    assert list(gq.shape) == ([n, k // 2] if algo.endswith("int4")
                              else [n, k])
    atol = np.abs(w).max() / {"weight_only_int8": 64,
                              "weight_only_int4": 6, "fp8": 8}[algo]
    np.testing.assert_allclose(gb, w, atol=atol)


def test_int4_odd_k_raises():
    for p in (jpaddle, tpaddle):
        with pytest.raises(ValueError, match="even"):
            QMOD[p].weight_quantize(p.to_tensor(np.ones((7, 4), np.float32)),
                                    algo="weight_only_int4")


@pytest.mark.parametrize("algo,wdtype", [("weight_only_int8", "int8"),
                                         ("weight_only_int4", "int4"),
                                         ("fp8", "fp8")])
def test_weight_only_linear_matches(algo, wdtype):
    rng = np.random.default_rng(3)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)
    b = rng.normal(size=(32,)).astype(np.float32)

    def run(p):
        Q = QMOD[p]
        wq, scale = Q.weight_quantize(p.to_tensor(w), algo=algo)
        out = Q.weight_only_linear(p.to_tensor(x), wq, bias=p.to_tensor(b),
                                   weight_scale=scale, weight_dtype=wdtype)
        ref = x @ w + b
        rel = {"int8": 0.02, "int4": 0.25, "fp8": 0.1}[wdtype]
        assert np.abs(_np(out) - ref).max() < np.abs(ref).max() * rel
        back = _np(Q.weight_dequantize(wq, scale, algo=algo,
                                       out_dtype="float32"))
        np.testing.assert_allclose(_np(out), x @ back + b, atol=1e-4)
        return _np(out)
    want, got = _both(run)
    _close_range(got, want, 1e-5)


def test_quant_matmul_plain_matches_pallas_kernel():
    """The plain version of row 11 against the Pallas kernel in interpret
    mode at an aligned shape."""
    rng = np.random.default_rng(4)
    x = rng.normal(size=(8, 256)).astype(np.float32)
    wq = rng.integers(-127, 128, (128, 256)).astype(np.int8)
    s = rng.uniform(0.001, 0.02, (128,)).astype(np.float32)
    flags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        want = np.asarray(jqm.quant_matmul(jnp.asarray(x), jnp.asarray(wq),
                                           jnp.asarray(s)))
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})
    got = tqm.quant_matmul(torch.from_numpy(x), torch.from_numpy(wq),
                           torch.from_numpy(s)).numpy()
    _close_range(got, want, 2e-6)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_quant_matmul_grad_is_jax_vjp(dtype):
    """Row 11's gradient to x: `jax.grad` of JAX's custom VJP (the kernel
    in interpret mode) against the port's autograd rule on CPU tensors
    (`g @ (wq * scale)` in g's dtype); the weights get no gradient."""
    rng = np.random.default_rng(5)
    x = rng.normal(size=(8, 128)).astype(np.float32)
    wq = rng.integers(-127, 128, (128, 128)).astype(np.int8)
    s = np.full((128,), 0.01, np.float32)
    g = rng.normal(size=(8, 128)).astype(np.float32)
    jdt = jnp.bfloat16 if dtype == "bfloat16" else jnp.float32
    tdt = torch.bfloat16 if dtype == "bfloat16" else torch.float32
    flags.set_flags({"FLAGS_pallas_interpret": True})
    try:
        _, vjp = jax.vjp(lambda a: jqm.quant_matmul(a, jnp.asarray(wq),
                                                    jnp.asarray(s)),
                         jnp.asarray(x, jdt))
        want, = vjp(jnp.asarray(g, jdt))
    finally:
        flags.set_flags({"FLAGS_pallas_interpret": False})
    xt = torch.from_numpy(x).to(tdt).requires_grad_()
    out = tqm.quant_matmul(xt, torch.from_numpy(wq), torch.from_numpy(s))
    assert out.grad_fn is not None
    out.backward(torch.from_numpy(g).to(tdt))
    got = xt.grad.float().numpy()
    want = np.asarray(want, np.float32)
    if dtype == "float32":
        _close_range(got, want, 2e-6)
    else:
        # one bf16 rounding of a sum taken in another order: an ulp
        np.testing.assert_allclose(got, want, rtol=2 ** -7, atol=0)


def test_int4_plain_version_differentiates_on_cpu():
    """JAX's CPU int4 path is ordinary XLA ops, so it differentiates; the
    port's plain version does too (the card's kernel refuses)."""
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    w = rng.normal(size=(64, 32)).astype(np.float32)

    def run(p):
        Q = QMOD[p]
        wq, scale = Q.weight_quantize(p.to_tensor(w),
                                      algo="weight_only_int4")
        xt = p.to_tensor(x)
        xt.stop_gradient = False
        (Q.weight_only_linear(xt, wq, weight_scale=scale,
                              weight_dtype="int4") ** 2).sum().backward()
        return _np(xt.grad)
    want, got = _both(run)
    _close_range(got, want, 1e-5)


def test_llm_int8_linear():
    rng = np.random.default_rng(6)
    x = rng.normal(size=(4, 64)).astype(np.float32)
    x[:, 3] *= 50.0            # one outlier feature channel
    w = rng.normal(size=(64, 32)).astype(np.float32)

    def run(p):
        Q = QMOD[p]
        wq, scale = Q.weight_quantize(p.to_tensor(w),
                                      algo="weight_only_int8")
        out = _np(Q.llm_int8_linear(p.to_tensor(x), wq, weight_scale=scale,
                                    threshold=6.0))
        ref = x @ w
        assert np.abs(out - ref).max() < np.abs(ref).max() * 0.05
        return out
    want, got = _both(run)
    _close_range(got, want, 1e-6)


def test_llm_int8_product_is_exact_past_float32():
    """K = 4096 at |x| = |w| = 127: the int32 sum 66,064,384 is past
    float32's exact integers, and the port's int32 product keeps it."""
    xq = torch.full((2, 4096), 127, dtype=torch.int8)
    wq = torch.full((3, 4096), -127, dtype=torch.int8)
    wq[1, 0] = 126
    got = TQ._int8_product(xq, wq)
    assert got.dtype == torch.int32
    np.testing.assert_array_equal(
        got.numpy(), xq.numpy().astype(np.int64) @ wq.numpy().astype(
            np.int64).T)


def test_apply_per_channel_scale():
    rng = np.random.default_rng(7)
    x = rng.normal(size=(3, 5)).astype(np.float32)
    s = rng.uniform(0.5, 2, (5,)).astype(np.float32)
    want, got = _both(lambda p: _np(QMOD[p].apply_per_channel_scale(
        p.to_tensor(x), p.to_tensor(s))))
    np.testing.assert_array_equal(got, want)


def test_weight_only_linear_state_dict_roundtrip():
    x = np.random.default_rng(8).normal(size=(4, 16)).astype(np.float32)
    w1 = np.random.default_rng(9).normal(size=(16, 8)).astype(np.float32)
    w2 = np.random.default_rng(10).normal(size=(16, 8)).astype(np.float32)

    def run(p):
        lin = p.nn.Linear(16, 8)
        lin.weight.set_value(w1)
        wol = QMOD[p].WeightOnlyLinear.from_linear(lin)
        sd = wol.state_dict()
        assert "weight" in sd and "weight_scale" in sd
        ref = _np(wol(p.to_tensor(x)))
        lin2 = p.nn.Linear(16, 8)
        lin2.weight.set_value(w2)
        wol2 = QMOD[p].WeightOnlyLinear.from_linear(lin2)
        wol2.set_state_dict(sd)
        np.testing.assert_allclose(_np(wol2(p.to_tensor(x))), ref,
                                   atol=1e-5)
        return _np(sd["weight"]), _np(sd["weight_scale"]), ref
    (ww, ws, wr), (gw, gs, gr) = _both(run)
    np.testing.assert_array_equal(gw, ww)
    np.testing.assert_array_equal(gs, ws)
    _close_range(gr, wr, 1e-5)


# -- observers, QAT, PTQ ---------------------------------------------------

def test_observers_match():
    rng = np.random.default_rng(11)
    xs = [rng.normal(size=(6, 10)).astype(np.float32) * (i + 1)
          for i in range(3)]

    def run(p):
        q = p.quantization
        obs = [q.AbsmaxObserver(), q.ChannelAbsmaxObserver(),
               q.HistObserver(bins=64)]
        for x in xs:
            for o in obs:
                o.observe(p.to_tensor(x))
        return [obs[0].scale(), obs[1].scales(), obs[1].scale(),
                obs[2].scale()]
    want, got = _both(run)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_quant_dequant_matches():
    x = np.random.default_rng(12).normal(size=(5, 7)).astype(np.float32)

    def run(p):
        out = p.quantization.quant_dequant(p.to_tensor(x), 1.7, bits=8)
        return _np(out), out.stop_gradient
    (wo, ws), (go, gs) = _both(run)
    np.testing.assert_array_equal(go, wo)
    assert gs == ws


def test_quant_dequant_straight_through_on_torch_tensors():
    x = torch.randn(6, requires_grad=True)
    tpaddle.quantization.quant_dequant(x, torch.tensor(1.0)).sum().backward()
    np.testing.assert_array_equal(x.grad.numpy(), np.ones(6, np.float32))


def test_qat_linear_two_steps():
    x = np.random.default_rng(13).normal(size=(4, 6)).astype(np.float32)
    w1 = np.random.default_rng(14).normal(size=(6, 5)).astype(np.float32)
    w2 = np.random.default_rng(15).normal(size=(5, 2)).astype(np.float32)

    def run(p):
        model = p.nn.Sequential(p.nn.Linear(6, 5), p.nn.ReLU(),
                                p.nn.Linear(5, 2))
        model[0].weight.set_value(w1)
        model[2].weight.set_value(w2)
        q = p.quantization.QAT(p.quantization.QuantConfig()).quantize(model)
        kinds = [type(m).__name__ for m in q.sublayers()]
        assert kinds.count("QuantedLinear") == 2
        opt = p.optimizer.SGD(learning_rate=0.1, parameters=q.parameters())
        losses = []
        for _ in range(2):
            loss = (q(p.to_tensor(x)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(loss))
        conv = p.quantization.QAT(p.quantization.QuantConfig()).convert(q)
        return (np.array(losses, np.float32), _np(conv(p.to_tensor(x))),
                [_np(t) for t in q.parameters()])
    (wl, wo, wp), (gl, go, gp) = _both(run)
    np.testing.assert_allclose(gl, wl, rtol=1e-6)
    _close_range(go, wo, 1e-6)
    for a, b in zip(gp, wp):
        np.testing.assert_allclose(a, b, rtol=1e-6, atol=1e-7)


def test_qat_quantizes_conv2d():
    x = np.random.default_rng(0).normal(size=(2, 3, 8, 8)).astype(
        np.float32)

    def run(p):
        p.seed(0)
        model = p.nn.Sequential(p.nn.Conv2D(3, 4, 3, padding=1), p.nn.ReLU(),
                                p.nn.Conv2D(4, 2, 1))
        q = p.quantization.QAT(p.quantization.QuantConfig()).quantize(model)
        kinds = [type(m).__name__ for m in q.sublayers()]
        assert kinds.count("QuantedConv2D") == 2
        ref = _np(model(p.to_tensor(x)))
        out = _np(q(p.to_tensor(x)))
        assert np.abs(out - ref).max() < np.abs(ref).max() * 0.1
        opt = p.optimizer.SGD(learning_rate=0.01, parameters=q.parameters())
        (q(p.to_tensor(x)) ** 2).mean().backward()
        opt.step()
        return out, [_np(t) for t in q.parameters()]
    (wo, wp), (go, gp) = _both(run)
    _close_range(go, wo, 1e-5)
    for a, b in zip(gp, wp):
        np.testing.assert_allclose(a, b, rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("backend", [None, "weight_only_int8",
                                     "weight_only_int4", "fp8"])
def test_ptq_convert(backend):
    x = np.random.default_rng(7).normal(size=(16, 32)).astype(np.float32)

    def run(p):
        p.seed(0)
        model = p.nn.Sequential(p.nn.Linear(32, 64), p.nn.ReLU(),
                                p.nn.Linear(64, 8))
        ref = _np(model(p.to_tensor(x)))
        ptq = p.quantization.PTQ(p.quantization.QuantConfig())
        observed = ptq.quantize(model)
        observed(p.to_tensor(x))             # calibrate
        deployed = ptq.convert(observed, deploy_backend=backend)
        kinds = [type(m).__name__ for m in deployed.sublayers()]
        if backend is not None:
            assert kinds.count("WeightOnlyLinear") == 2
        out = _np(deployed(p.to_tensor(x)))
        rel = {None: 0.02, "weight_only_int8": 0.02,
               "weight_only_int4": 0.3, "fp8": 0.1}[backend]
        assert np.abs(out - ref).max() < np.abs(ref).max() * rel
        return out, ref
    (wo, wr), (go, gr) = _both(run)
    _close_range(gr, wr, 1e-6)
    _close_range(go, wo, 1e-5)


def _deployed(p, backend, x, seed=0):
    p.seed(seed)
    m = p.nn.Sequential(p.nn.Linear(32, 64), p.nn.ReLU(), p.nn.Linear(64, 8))
    ptq = p.quantization.PTQ(p.quantization.QuantConfig())
    observed = ptq.quantize(m)
    observed(p.to_tensor(x))
    return ptq.convert(observed, deploy_backend=backend)


@pytest.mark.parametrize("backend", ["weight_only_int8", "weight_only_int4",
                                     "fp8"])
def test_quantized_model_state_crosses_packages(backend):
    """`convert.layers_from_jax_state` loads a JAX quantized model's
    `state_dict` (the WeightOnlyLinear buffers under JAX's names) into the
    port, and the port's state loads back into the JAX model: buffers
    bit-equal, outputs within the weight-only tolerance."""
    from paddle_tpu_torch.convert import layers_from_jax_state

    x = np.random.default_rng(0).normal(size=(4, 32)).astype(np.float32)
    jm, tm = _deployed(jpaddle, backend, x), _deployed(tpaddle, backend, x)
    jstate = {k: np.asarray(v._data) for k, v in jm.state_dict().items()}
    tstate = {k: np.asarray(v.numpy()) for k, v in tm.state_dict().items()}
    assert sorted(tstate) == sorted(jstate)
    for k in jstate:
        np.testing.assert_array_equal(tstate[k].view(np.uint8),
                                      jstate[k].view(np.uint8), err_msg=k)
    t2 = layers_from_jax_state(jstate, _deployed(tpaddle, backend, x, 1))
    j2 = _deployed(jpaddle, backend, x, 1)
    j2.set_state_dict(tstate)
    want = _np(jm(jpaddle.to_tensor(x)))
    _close_range(_np(t2(tpaddle.to_tensor(x))), want, 1e-5)
    _close_range(_np(j2(jpaddle.to_tensor(x))), want, 1e-6)


@pytest.mark.parametrize("int4", [False, True], ids=["int8", "int4"])
@pytest.mark.parametrize("m", [40, 2048])
def test_gemm_plans_at_training_length_are_legal(m, int4):
    """Rows 11-12 at a training batch (M 2,048) as at serving's M 40:
    every plan the host rule picks for Llama-2-7B's projections on an
    H100 (132 SMs) splits K into whole, non-empty slices, fits a CTA's
    shared memory, and tiles M in at most 64 tokens."""
    shapes = [(4096, 4096), (12288, 4096), (11008, 4096), (22016, 4096),
              (4096, 11008), (32000, 4096)]
    for n, k in shapes:
        p = tqm.gemm_plan(m, n, k, 132, int4)
        k_tile = tqm.PLAN_K_TILE_INT4 if int4 else tqm.PLAN_K_TILE
        assert p.k_tiles == -(-k // k_tile)
        assert 1 <= p.splits <= tqm.PLAN_MAX_SPLITS
        assert (p.splits - 1) * p.k_tiles_per_split < p.k_tiles \
            <= p.splits * p.k_tiles_per_split
        assert p.smem_bytes <= tqm.SMEM_PER_BLOCK
        assert 8 <= p.tokens <= tqm.PLAN_MAX_TOKENS and p.tokens % 8 == 0
        assert p.m_tiles * p.tokens >= m and p.n_tiles * 128 >= n
        if m == 2048:
            assert p.splits == 1        # 32 x n/128 tiles fill the card


@pytest.mark.parametrize("backend,bound", [("weight_only_int8", 3e-2),
                                           ("weight_only_int4", 4e-1)])
def test_quant_deploy_rehearsal(backend, bound):
    """`chip_smoke.py`'s quant_deploy on the tiny sparse Llama (O2 bf16):
    PTQ on two batches deploys every Linear (7 a layer and the head) as a
    WeightOnlyLinear; each one's output on the forward's own input is
    its plain product; the logits stay within the phase's bound of the
    bf16 model's (the bound the CPU rehearsal holds: 4 layers at hidden
    256-1024 give 0.020 / 0.26-0.30)."""
    from paddle_tpu_torch.tools import quant_workload as qw
    from paddle_tpu_torch.tools import resilience_workload as rw

    model, _, _, ids, _ = rw.sparse_workload(tpaddle, True, tiny=True)
    ref = qw.logits(tpaddle, model, ids)._data.float()
    dm = qw.deploy(tpaddle, model, backend, [ids, ids])
    layers = qw.weight_only_layers(dm)
    assert len(layers) == 7 * model.config.num_hidden_layers + 1
    inputs, remove = qw.capture_inputs(dm)
    out = qw.logits(tpaddle, dm, ids)._data.float()
    remove()
    assert float((out - ref).norm() / ref.norm()) <= bound
    int4 = backend.endswith("int4")
    for name, layer in layers:
        x2d = inputs[name].reshape(-1, inputs[name].shape[-1])
        fn = tqm.quant_matmul_int4 if int4 else tqm.quant_matmul
        got = fn(x2d, layer.weight._data, layer.weight_scale._data)
        want = (tqm.quant_matmul_int4_ref if int4 else tqm.quant_matmul_ref)(
            x2d, layer.weight._data, layer.weight_scale._data)
        assert torch.equal(got, want)
