"""`paddle.save` / `paddle.load` and safetensors across the two packages:
a `.pdparams` (f32, bf16, fp8, int64, nested dicts / lists / tuples,
plain values) or `.pdopt` written by either package loads in the other
with the same bits; an Adam state saved by the JAX package continues in
the port with the same next step (within 1e-7, f32); safetensors files
are byte-identical across packages and load in either, bf16 included,
with the lazy reader's crc32 check. The port's `load` maps the JAX
package's payload class onto its own and refuses any other global of
that package."""
import io
import pickle

import numpy as np
import pytest

from paddle_tpu.framework import safetensors as jst
from paddle_tpu_torch.framework import safetensors as tst

from torch_eager_common import (PACKAGES, jpaddle,  # noqa: F401
                                port_on_cpu, tpaddle)


def _bits(t):
    a = np.asarray(t.numpy() if hasattr(t, "numpy") else t)
    return a.view(f"uint{a.dtype.itemsize * 8}") if a.dtype.kind in "fV" \
        else a


def _payload(paddle):
    paddle.seed(5)
    lin = paddle.nn.Linear(3, 4)
    bf = paddle.nn.Linear(4, 2)
    bf.astype("bfloat16")
    fp8 = paddle.to_tensor(np.linspace(-2, 2, 6, dtype="float32")) \
        .astype("float8_e4m3fn")
    g = paddle.to_tensor(np.ones(3, "float32"), stop_gradient=False)
    return {"lin": lin.state_dict(), "bf": bf.state_dict(),
            "misc": [paddle.to_tensor(np.arange(5)), (fp8, g), 7, "s",
                     {"lr": 0.5, "none": None}]}


def _flat(obj, path="", out=None):
    out = {} if out is None else out
    if isinstance(obj, dict):
        for k in obj:
            _flat(obj[k], f"{path}.{k}", out)
    elif isinstance(obj, (list, tuple)):
        out[path + ":type"] = type(obj).__name__
        for i, v in enumerate(obj):
            _flat(v, f"{path}[{i}]", out)
    elif hasattr(obj, "stop_gradient") and hasattr(obj, "numpy"):
        out[path] = (_bits(obj), obj.dtype.name, obj.shape,
                     obj.stop_gradient)
    else:
        out[path] = obj
    return out


def _same(a, b):
    fa, fb = _flat(a), _flat(b)
    assert sorted(fa) == sorted(fb)
    for k in fa:
        if isinstance(fa[k], tuple):
            np.testing.assert_array_equal(fa[k][0], fb[k][0], k)
            assert fa[k][1:] == fb[k][1:], (k, fa[k][1:], fb[k][1:])
        else:
            assert fa[k] == fb[k], k


@pytest.mark.parametrize("writer,reader", [("jax", "torch"),
                                          ("torch", "jax"),
                                          ("torch", "torch")])
@pytest.mark.parametrize("protocol", [2, 4])
def test_pdparams_cross_package_bit_equal(tmp_path, writer, reader,
                                          protocol):
    w, r = PACKAGES[writer], PACKAGES[reader]
    path = str(tmp_path / "sub" / "m.pdparams")
    w.save(_payload(w), path, protocol=protocol)
    loaded = r.load(path)
    _same(_payload(r), loaded)
    assert loaded["misc"][1][1].stop_gradient is False
    # return_numpy gives arrays with the same bits
    arrs = r.load(path, return_numpy=True)
    np.testing.assert_array_equal(_bits(arrs["bf"]["weight"]),
                                  _bits(loaded["bf"]["weight"]))


def test_port_load_to_a_file_object_and_into_a_layer():
    """A JAX-written state dict through a file object into the port
    Layer's `set_state_dict`: the weight bridge for Layers."""
    buf = io.BytesIO()
    jpaddle.seed(9)
    jl = jpaddle.nn.Sequential(jpaddle.nn.Linear(3, 4),
                               jpaddle.nn.LayerNorm(4))
    jpaddle.save(jl.state_dict(), buf)
    buf.seek(0)
    sd = tpaddle.load(buf)
    tpaddle.seed(0)
    tl = tpaddle.nn.Sequential(tpaddle.nn.Linear(3, 4),
                               tpaddle.nn.LayerNorm(4))
    missing, unexpected = tl.set_state_dict(sd)
    assert missing == [] and unexpected == []
    for (n, p), (m, q) in zip(jl.named_parameters(), tl.named_parameters()):
        assert n == m
        np.testing.assert_array_equal(q.numpy(), p.numpy())
    # numpy state dicts (the JAX package's `.numpy()`) work the same
    tl.set_state_dict({k: v.numpy() * 2 for k, v in jl.state_dict().items()})
    np.testing.assert_array_equal(tl[0].weight.numpy(),
                                  jl[0].weight.numpy() * 2)


def test_port_load_refuses_other_jax_package_globals():
    assert tpaddle.load(io.BytesIO(pickle.dumps({"x": 1}))) == {"x": 1}
    blob = pickle.dumps({"cls": jpaddle.Tensor})
    with pytest.raises(pickle.UnpicklingError, match="does not import"):
        tpaddle.load(io.BytesIO(blob))


def _adam_run(paddle, state=None, params=None):
    """An Adam model (its weights from `params` if given, its optimizer
    state from `state`), then one step on fixed gradients."""
    paddle.seed(13)
    model = paddle.nn.Linear(4, 3)
    for n, p in model.named_parameters():
        p.name = "fc_" + n
    if params is not None:
        model.set_state_dict(params)
    o = paddle.optimizer.Adam(0.01, parameters=model.parameters(),
                              weight_decay=0.01)
    if state is not None:
        o.set_state_dict(state)
    rng = np.random.default_rng(2)
    for p in model.parameters():
        p.grad = paddle.to_tensor(rng.standard_normal(p.shape)
                                  .astype("float32"))
    o.step()
    o.clear_grad()
    return model, o


def test_jax_optimizer_state_continues_in_the_port(tmp_path):
    jm, jo = _adam_run(jpaddle)
    jpaddle.save(jm.state_dict(), str(tmp_path / "m.pdparams"))
    jpaddle.save(jo.state_dict(), str(tmp_path / "m.pdopt"))
    # the JAX package's next step
    rng = np.random.default_rng(2)
    grads = [rng.standard_normal(p.shape).astype("float32")
             for p in jm.parameters()]
    for p, g in zip(jm.parameters(), grads):
        p.grad = jpaddle.to_tensor(g)
    jo.step()
    state = tpaddle.load(str(tmp_path / "m.pdopt"))
    assert state["global_step"] == 1
    tm, to = _adam_run(tpaddle, state=state,
                       params=tpaddle.load(str(tmp_path / "m.pdparams")))
    for p, q in zip(jm.parameters(), tm.parameters()):
        np.testing.assert_allclose(q.numpy(), p.numpy(), rtol=1e-7,
                                   atol=1e-7)
    # and back: the port's state loads in the JAX package
    tpaddle.save(to.state_dict(), str(tmp_path / "t.pdopt"))
    back = jpaddle.load(str(tmp_path / "t.pdopt"))
    assert back["global_step"] == 2
    np.testing.assert_array_equal(back["fc_weight_moment1"].numpy(),
                                  to.state_dict()["fc_weight_moment1"]
                                  .numpy())


def _tensors():
    rng = np.random.default_rng(1)
    ml = pytest.importorskip("ml_dtypes")
    return {"w": rng.standard_normal((3, 5)).astype("float32"),
            "bf": rng.standard_normal((4,)).astype(ml.bfloat16),
            "ids": np.arange(6, dtype=np.int64).reshape(2, 3),
            "mask": np.array([True, False])}


def test_safetensors_bytes_identical_and_cross_load(tmp_path):
    ts = _tensors()
    jpath, tpath = str(tmp_path / "j.safetensors"), \
        str(tmp_path / "t.safetensors")
    jst.save_file(ts, jpath, metadata={"step": "3"})
    tst.save_file(ts, tpath, metadata={"step": "3"})
    assert open(jpath, "rb").read() == open(tpath, "rb").read()
    for reader, path in ((tst, jpath), (jst, tpath)):
        got = reader.load_file(path)
        assert sorted(got) == sorted(ts)
        for k in ts:
            assert got[k].dtype == ts[k].dtype
            np.testing.assert_array_equal(_bits(got[k]), _bits(ts[k]))
    r = tst.SafetensorsReader(jpath)
    assert r.metadata["step"] == "3" and sorted(r.keys()) == sorted(ts)
    assert tst.np_dtype("bfloat16") == ts["bf"].dtype


def test_safetensors_crc_catches_corruption(tmp_path):
    path = str(tmp_path / "c.safetensors")
    tst.save_file({"w": np.arange(8, dtype=np.float32)}, path)
    raw = bytearray(open(path, "rb").read())
    raw[-1] ^= 0xFF
    open(path, "wb").write(bytes(raw))
    with pytest.raises(IOError, match="checksum"):
        tst.load_file(path)
    assert tst.load_file(path, verify=False)["w"].shape == (8,)
