"""The port's MoE dispatch and gather (`paddle_tpu_torch.ops.kernels.
fused_moe`) against the JAX package's (`paddle_tpu.ops.pallas.fused_moe`),
as `test_fused_moe_kernels_match_xla_path` runs them: the Pallas kernels
in interpret mode and the XLA route.

Every comparison is exact: both functions only move rows (dispatch adds
zeros to a row at most), so the port's `moe_dispatch` / `moe_gather` (the
CPU route: the kernels' plain versions), `moe_dispatch_ref` /
`moe_gather_ref`, `xla_dispatch` / `xla_gather`, and their backwards
equal the JAX package's `moe_dispatch` / `moe_gather` (Pallas) and
`xla_dispatch` / `xla_gather` bit for bit, in f32, bf16 and f16, with
rows dropped at a low capacity and at an odd row width. Then the one
deliberate difference (a dropped row gathers exact zeros where the JAX
kernel multiplies by 0), and the port's flag registry.
"""
import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from paddle_tpu.framework import flags as jflags
from paddle_tpu.ops.pallas import fused_moe as jfm
from paddle_tpu_torch.framework import flags
from paddle_tpu_torch.ops.kernels import fused_moe as fm
from torch_threads import one_thread  # noqa: F401

DTYPES = {"f32": (torch.float32, jnp.float32),
          "bf16": (torch.bfloat16, jnp.bfloat16),
          "f16": (torch.float16, jnp.float16)}
# name -> (rows N, width H, experts E, capacity C)
CASES = {"fits": (24, 16, 4, 8), "drops": (24, 16, 4, 3),
         "odd_width": (20, 5, 3, 4)}


@pytest.fixture
def _interpret():
    jflags.set_flags({"FLAGS_pallas_interpret": True,
                      "FLAGS_fused_moe_kernels": True})
    yield
    jflags.set_flags({"FLAGS_pallas_interpret": False,
                      "FLAGS_fused_moe_kernels": False})


def _routing(seed, n, e, c):
    """e_idx random; slots handed out in row order, rows past an expert's
    capacity dropped (p = -1): unique slots per expert."""
    rng = np.random.default_rng(seed)
    e_idx = rng.integers(0, e, n).astype(np.int32)
    p_idx = np.full(n, -1, np.int32)
    counts = [0] * e
    for i in range(n):
        if counts[e_idx[i]] < c:
            p_idx[i] = counts[e_idx[i]]
            counts[e_idx[i]] += 1
    return e_idx, p_idx


def _np(t):
    return t.detach().float().numpy()


def _jnp32(a):
    return np.asarray(jnp.asarray(a, jnp.float32))


@pytest.mark.parametrize("dtype", list(DTYPES))
@pytest.mark.parametrize("case", list(CASES))
def test_forwards_equal_the_jax_package(case, dtype, _interpret):
    n, h, e, c = CASES[case]
    tdt, jdt = DTYPES[dtype]
    e_idx, p_idx = _routing(1, n, e, c)
    if case == "drops":
        assert (p_idx < 0).any()
    rng = np.random.default_rng(2)
    x = rng.normal(size=(n, h)).astype(np.float32)
    buf = rng.normal(size=(e, c, h)).astype(np.float32)
    tx, tb = torch.tensor(x).to(tdt), torch.tensor(buf).to(tdt)
    te, tp = torch.tensor(e_idx), torch.tensor(p_idx)
    jx, jb = jnp.asarray(x, jdt), jnp.asarray(buf, jdt)
    je, jp = jnp.asarray(e_idx), jnp.asarray(p_idx)

    want = _jnp32(jfm.xla_dispatch(jx, je, jp, e, c))
    np.testing.assert_array_equal(_jnp32(jfm.moe_dispatch(jx, je, jp, e, c)),
                                  want)
    for got in (fm.moe_dispatch(tx, te, tp, e, c),
                fm.moe_dispatch_ref(tx, te, tp, e, c),
                fm.xla_dispatch(tx, te, tp, e, c)):
        assert got.dtype == tdt and got.shape == (e, c, h)
        np.testing.assert_array_equal(_np(got), want)

    want = _jnp32(jfm.xla_gather(jb, je, jp))
    np.testing.assert_array_equal(_jnp32(jfm.moe_gather(jb, je, jp)), want)
    for got in (fm.moe_gather(tb, te, tp), fm.moe_gather_ref(tb, te, tp),
                fm.xla_gather(tb, te, tp)):
        assert got.dtype == tdt and got.shape == (n, h)
        np.testing.assert_array_equal(_np(got), want)


@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("case", list(CASES))
def test_backwards_equal_the_jax_package(case, dtype, _interpret):
    """dispatch's backward is the gather of the cotangent and gather's the
    dispatch: the port's autograd Functions and its index route's
    autograd against `jax.vjp` of both JAX routes."""
    n, h, e, c = CASES[case]
    tdt, jdt = DTYPES[dtype]
    e_idx, p_idx = _routing(3, n, e, c)
    rng = np.random.default_rng(4)
    x = rng.normal(size=(n, h)).astype(np.float32)
    buf = rng.normal(size=(e, c, h)).astype(np.float32)
    ct_slots = rng.normal(size=(e, c, h)).astype(np.float32)
    ct_rows = rng.normal(size=(n, h)).astype(np.float32)
    te, tp = torch.tensor(e_idx), torch.tensor(p_idx)
    je, jp = jnp.asarray(e_idx), jnp.asarray(p_idx)

    def jvjp(fn, arg, ct):
        _, pull = jax.vjp(fn, jnp.asarray(arg, jdt))
        return _jnp32(pull(jnp.asarray(ct, jdt))[0])

    def tvjp(fn, arg, ct):
        a = torch.tensor(arg).to(tdt).requires_grad_()
        (g,) = torch.autograd.grad(fn(a), a, torch.tensor(ct).to(tdt))
        return _np(g)

    want = jvjp(lambda v: jfm.xla_dispatch(v, je, jp, e, c), x, ct_slots)
    np.testing.assert_array_equal(
        jvjp(lambda v: jfm.moe_dispatch(v, je, jp, e, c), x, ct_slots), want)
    for fn in (fm.moe_dispatch, fm.xla_dispatch):
        np.testing.assert_array_equal(
            tvjp(lambda v: fn(v, te, tp, e, c), x, ct_slots), want)

    want = jvjp(lambda b: jfm.xla_gather(b, je, jp), buf, ct_rows)
    np.testing.assert_array_equal(
        jvjp(lambda b: jfm.moe_gather(b, je, jp), buf, ct_rows), want)
    for fn in (fm.moe_gather, fm.xla_gather):
        np.testing.assert_array_equal(
            tvjp(lambda b: fn(b, te, tp), buf, ct_rows), want)


def test_a_dropped_row_gathers_exact_zeros(_interpret):
    """The closed divergence (ROADMAP Queue C): a dropped row reads the
    clipped slot (e, 0); the JAX kernel and both XLA routes multiply that
    row by 0, so a NaN or inf there gives NaN, where the port's kernel
    route writes exact zeros without reading it."""
    e_idx = np.array([0, 1, 0, 1], np.int32)
    p_idx = np.array([0, 0, -1, -1], np.int32)
    buf = np.ones((2, 2, 3), np.float32)
    buf[0, 0, 1] = np.nan
    buf[1, 0, 2] = np.inf
    je, jp, jb = jnp.asarray(e_idx), jnp.asarray(p_idx), jnp.asarray(buf)
    te, tp, tb = torch.tensor(e_idx), torch.tensor(p_idx), torch.tensor(buf)
    for got in (np.asarray(jfm.moe_gather(jb, je, jp)),
                np.asarray(jfm.xla_gather(jb, je, jp)),
                fm.xla_gather(tb, te, tp).numpy()):
        assert np.isnan(got[2, 1]) and np.isnan(got[3, 2])
    for got in (fm.moe_gather(tb, te, tp), fm.moe_gather_ref(tb, te, tp)):
        np.testing.assert_array_equal(got[2:].numpy(), 0.0)
        np.testing.assert_array_equal(got[:2].numpy(), buf[[0, 1], 0])


def test_cpu_route_launches_no_kernel():
    before = (fm.LAUNCHES_DISPATCH.count, fm.LAUNCHES_GATHER.count)
    flags.set_flags({"FLAGS_fused_moe_kernels": True})
    try:
        assert fm.kernels_available()
        e_idx, p_idx = (torch.tensor(a) for a in _routing(5, 8, 2, 4))
        x = torch.randn(8, 4, requires_grad=True)
        rows = fm.moe_gather(fm.moe_dispatch(x, e_idx, p_idx, 2, 4), e_idx,
                             p_idx)
        rows.sum().backward()
    finally:
        flags.set_flags({"FLAGS_fused_moe_kernels": False})
    assert (fm.LAUNCHES_DISPATCH.count, fm.LAUNCHES_GATHER.count) == before
    keep = (p_idx >= 0)[:, None].float()
    assert 0 < int(keep.sum()) < 8                    # some rows dropped
    torch.testing.assert_close(rows, x.detach() * keep, atol=0, rtol=0)
    torch.testing.assert_close(x.grad, keep.expand(8, 4), atol=0, rtol=0)


@pytest.mark.parametrize("row_bytes,ptrs,want", [
    (8192, (0, 256), 16), (8200, (0, 256), 8), (8194, (0, 256), 2),
    (20, (0, 256), 4), (8192, (8, 256), 8), (5, (0, 0), 1)])
def test_copy_unit(row_bytes, ptrs, want):
    """16-byte units where the row's bytes and both base addresses allow,
    the widest narrower unit otherwise (H = 4100 bf16 rows take 8)."""
    assert fm._unit(row_bytes, *ptrs) == want


def test_flag_registry_matches_the_jax_package(monkeypatch):
    """`FLAGS_fused_moe_kernels` defaults to False in both packages;
    `set_flags` / `get_flags` / `flag_value` take names with or without
    the prefix; a `FLAGS_name` environment variable sets a flag's value
    when it is defined."""
    assert flags.get_flags("FLAGS_fused_moe_kernels") == \
        {"FLAGS_fused_moe_kernels": False} == \
        jflags.get_flags("FLAGS_fused_moe_kernels")
    assert not fm.kernels_available()
    flags.set_flags({"fused_moe_kernels": 1})
    try:
        assert flags.flag_value("FLAGS_fused_moe_kernels") is True
    finally:
        flags.set_flags({"FLAGS_fused_moe_kernels": False})
    for value, want in (("on", True), ("0", False)):
        name = f"port_rules_env_{value}"
        monkeypatch.setenv(f"FLAGS_{name}", value)
        assert flags.define_flag(name, not want).value is want
        assert jflags.define_flag(name, not want).value is want
    with pytest.raises(KeyError):
        flags.get_flags("FLAGS_not_defined_anywhere")
