"""The port's weight-only quantization and int8 KV quantization against the
JAX package's: the quantizers and the int4 packing bit for bit, and the
weight-only gemms' plain versions against the Pallas kernels (interpreter
mode) on the same numpy inputs."""
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from paddle_tpu.framework import flags
from paddle_tpu.inference import kv_quant as jkv
from paddle_tpu.nn import quant as jq
from paddle_tpu.ops.pallas import quant_matmul as jqm
from paddle_tpu_torch.inference import kv_quant as tkv
from paddle_tpu_torch.nn import quant as tq
from paddle_tpu_torch.ops.kernels import quant_matmul as tqm
from torch_threads import one_thread  # noqa: F401

_TORCH_OF = {"int8": torch.int8, "float8_e4m3fn": torch.float8_e4m3fn,
             "float8_e5m2": torch.float8_e5m2}


@pytest.fixture
def interpret():
    flags.set_flags({"pallas_interpret": True})
    yield
    flags.set_flags({"pallas_interpret": False})


def _to_torch(a):
    """A JAX/numpy array -> torch with the same bytes (fp8 included)."""
    a = np.asarray(a)
    if a.dtype.name in ("float8_e4m3fn", "float8_e5m2"):
        return torch.from_numpy(a.view(np.uint8).copy()).view(
            _TORCH_OF[a.dtype.name])
    return torch.from_numpy(a.copy())


def _bytes(t):
    return t.view(torch.uint8).numpy() if t.element_size() == 1 \
        else t.numpy()


def _weights(seed, n=24, k=64):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (n, k)).astype(np.float32)
    w[3] = 0.0                                  # a zero channel
    w[5, 7] = 40.0                              # an outlier channel
    return w


@pytest.mark.parametrize("algo", ["weight_only_int8", "weight_only_int4",
                                  "fp8"])
def test_per_channel_quantize_is_bit_exact(algo):
    w = _weights(1)
    jqv, js = jq.per_channel_quantize(jnp.asarray(w), algo)
    tqv, ts = tq.per_channel_quantize(torch.from_numpy(w), algo)
    assert tqv.dtype == _TORCH_OF[np.asarray(jqv).dtype.name]
    np.testing.assert_array_equal(_bytes(tqv), _bytes(_to_torch(jqv)))
    assert ts.dtype == torch.float32
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[3] == 0).item() and (tqv[3].float() == 0).all()


def test_fp8_quotient_above_448_rounds_to_448():
    """absmax / (absmax / 448) can land a hair above 448; both packages
    round it to 448, never to NaN."""
    w = np.asarray([[1.0, -3.0, 0.1] * 4] * 3, np.float32) * np.float32(
        [[1.0], [1.0 + 2 ** -20], [7.3e-3]])
    _, s = tq.per_channel_quantize(torch.from_numpy(w), "fp8")
    q = (torch.from_numpy(w) / s[:, None]).to(torch.float8_e4m3fn).float()
    assert torch.isfinite(q).all() and q.abs().max() == 448.0
    jqv, _ = jq.per_channel_quantize(jnp.asarray(w), "fp8")
    tqv, _ = tq.per_channel_quantize(torch.from_numpy(w), "fp8")
    np.testing.assert_array_equal(_bytes(tqv), _bytes(_to_torch(jqv)))


@pytest.mark.parametrize("bits", [4, 8])
def test_quantize_with_scales_is_bit_exact(bits):
    w = _weights(2)
    rng = np.random.default_rng(3)
    s = (np.abs(w).max(-1) / ((1 << (bits - 1)) - 1)
         * rng.uniform(0.5, 1.5, w.shape[0])).astype(np.float32)
    s[4] = 0.0                                  # a zero scale divides by 1
    jv = jq.quantize_with_scales(jnp.asarray(w), jnp.asarray(s), bits)
    tv = tq.quantize_with_scales(torch.from_numpy(w), torch.from_numpy(s),
                                 bits)
    assert tv.dtype == torch.int8
    np.testing.assert_array_equal(tv.numpy(), np.asarray(jv))


def test_pack_int4_covers_every_nibble_pair():
    """All 256 (low, high) pairs of int4 values pack to the JAX package's
    bytes and unpack back exactly."""
    lo, hi = np.meshgrid(np.arange(-8, 8), np.arange(-8, 8), indexing="ij")
    q = np.concatenate([lo.reshape(2, 128), hi.reshape(2, 128)],
                       axis=-1).astype(np.int8)             # [2, 256]
    jp = np.asarray(jq.pack_int4(jnp.asarray(q)))
    tp = tq.pack_int4(torch.from_numpy(q))
    assert tp.dtype == torch.int8 and tp.shape == (2, 128)
    np.testing.assert_array_equal(tp.numpy(), jp)
    assert len(set(tp.numpy().view(np.uint8).ravel().tolist())) == 256
    np.testing.assert_array_equal(tq.unpack_int4(tp).numpy(), q)
    np.testing.assert_array_equal(
        tq.unpack_int4(torch.from_numpy(jp.copy())).numpy(),
        np.asarray(jq.unpack_int4(jnp.asarray(jp))))
    with pytest.raises(ValueError):
        tq.pack_int4(torch.zeros((2, 3), dtype=torch.int8))


@pytest.mark.parametrize("shape", [(5, 2, 16), (7, 3, 128)])
def test_quantize_kv_is_bit_exact(shape):
    rng = np.random.default_rng(4)
    x = rng.normal(0, 2, shape).astype(np.float32)
    x[1, 0] = 0.0                               # zero vector: q 0, scale 0
    jq8, js = jkv.quantize_kv(jnp.asarray(x))
    tq8, ts = tkv.quantize_kv(torch.from_numpy(x))
    assert tq8.dtype == torch.int8 and ts.dtype == torch.float32
    np.testing.assert_array_equal(tq8.numpy(), np.asarray(jq8))
    np.testing.assert_array_equal(ts.numpy(), np.asarray(js))
    assert (ts[1, 0] == 0).item() and (tq8[1, 0] == 0).all()
    np.testing.assert_array_equal(
        tkv.dequantize_kv(tq8, ts).numpy(),
        np.asarray(jkv.dequantize_kv(jq8, js)))
    assert tkv.scale_shape((3, 8, 2, 4, 16)) == \
        jkv.scale_shape((3, 8, 2, 4, 16)) == (3, 8, 2, 4)


# m = 8, k = 256, n = 128: shapes the Pallas kernels take as they are
M, K, N = 8, 256, 128
# f32 x: the two differ only in summation order. bf16 output: both
# accumulate in f32 and round once, so within one bf16 ulp (2^-8
# relative) of each other, plus summation order.
TOL = {"float32": dict(atol=1e-4, rtol=1e-5),
       "bfloat16": dict(atol=1e-2, rtol=8e-3)}


def _gemm_inputs(algo, x_dtype, seed=5):
    rng = np.random.default_rng(seed)
    w = rng.normal(0, 1, (N, K)).astype(np.float32)
    x = rng.normal(0, 1, (M, K)).astype(np.float32)
    jx = jnp.asarray(x, jnp.bfloat16 if x_dtype == "bfloat16"
                     else jnp.float32)
    tx = torch.from_numpy(x).to(getattr(torch, x_dtype))
    jw, js = jq.per_channel_quantize(jnp.asarray(w), algo)
    return jx, tx, jw, js


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
@pytest.mark.parametrize("wfmt", ["int8", "e4m3", "e5m2"])
def test_quant_matmul_ref_matches_pallas_kernel(wfmt, x_dtype, interpret):
    algo = "fp8" if wfmt != "int8" else "weight_only_int8"
    jx, tx, jw, js = _gemm_inputs(algo, x_dtype)
    if wfmt == "e5m2":
        jw = jw.astype(jnp.float32).astype(jnp.float8_e5m2)
    kern = np.asarray(jqm.quant_matmul(jx, jw, js).astype(jnp.float32))
    before = tqm.LAUNCHES.count
    port = tqm.quant_matmul(tx, _to_torch(jw), _to_torch(js))
    assert tqm.LAUNCHES.count == before          # CPU: the plain version
    assert port.dtype == tx.dtype and port.shape == (M, N)
    np.testing.assert_allclose(port.float().numpy(), kern, **TOL[x_dtype])
    ref = tqm.quant_matmul_ref(tx, _to_torch(jw), _to_torch(js),
                               out_dtype=torch.float32)
    assert ref.dtype == torch.float32


@pytest.mark.parametrize("x_dtype", ["float32", "bfloat16"])
def test_quant_matmul_int4_ref_matches_pallas_kernel(x_dtype, interpret):
    jx, tx, jw, js = _gemm_inputs("weight_only_int4", x_dtype, seed=6)
    jp = jq.pack_int4(jw)
    kern = np.asarray(jqm.quant_matmul_int4(jx, jp, js)
                      .astype(jnp.float32))
    before = tqm.LAUNCHES_INT4.count
    port = tqm.quant_matmul_int4(tx, _to_torch(jp), _to_torch(js))
    assert tqm.LAUNCHES_INT4.count == before
    assert port.dtype == tx.dtype and port.shape == (M, N)
    np.testing.assert_allclose(port.float().numpy(), kern, **TOL[x_dtype])


@pytest.mark.parametrize("weight_dtype", ["int8", "int4"])
def test_dequant_matmul_keeps_leading_axes(weight_dtype):
    """`dequant_matmul` flattens x's leading axes into the gemm's M and
    restores them; int4 takes the packed weight."""
    rng = np.random.default_rng(7)
    w = torch.from_numpy(rng.normal(0, 1, (48, 64)).astype(np.float32))
    x = torch.from_numpy(rng.normal(0, 1, (2, 3, 64)).astype(np.float32))
    algo = "weight_only_int4" if weight_dtype == "int4" else \
        "weight_only_int8"
    q, s = tq.per_channel_quantize(w, algo)
    wq = tq.pack_int4(q) if weight_dtype == "int4" else q
    out = tq.dequant_matmul(x, wq, s, weight_dtype)
    assert out.shape == (2, 3, 48)
    want = x.reshape(6, 64) @ (q.float() * s[:, None]).t()
    torch.testing.assert_close(out.reshape(6, 48), want, atol=1e-4,
                               rtol=1e-5)


def test_gemm_wrappers_refuse_other_devices():
    """The plain version runs only for CPU tensors: any other device is
    refused, never computed on the CPU."""
    x = torch.zeros((4, 32), device="meta")
    w = torch.zeros((8, 32), dtype=torch.int8, device="meta")
    s = torch.zeros((8,), device="meta")
    with pytest.raises(ValueError):
        tqm.quant_matmul(x, w, s)
    with pytest.raises(ValueError):
        tqm.quant_matmul_int4(x, w[:, :16], s)
