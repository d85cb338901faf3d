"""Op-surface parity of `paddle.linalg`, `paddle.fft` and `paddle.signal`:
every export the port resolves, on the JAX harness recipe's seeded
inputs, held to the JAX package (`torch_ops_surface_common.py`: float64
1e-10, float32 1e-5 relative; complex at its real type's tolerance), the
port's own harness sweep held to the floors this port reaches, and the
manifest's resolution in the port.

Compared here otherwise, each with its reason (`NOT_COMPARED`):
- `svd`, `svd_lowrank`, `pca_lowrank`: singular vectors are unique up to
  sign (LAPACK's and XLA's CPU SVDs pick different ones), so the singular
  values and the product U diag(S) V^T are held to JAX's;
- `eigh`: eigenvectors likewise; the eigenvalues and V diag(w) V^T;
- `lu_unpack`, `ormqr`: they take the factors of a real factorisation
  (the harness has no recipe), so they run on `lu`'s and `geqrf`'s
  outputs, in both packages, and are held to JAX's.
"""
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from torch_ops_surface_common import (MANIFEST, NOT_COMPARED, TOL32, TOL64,
                                      compare, compared, exports,
                                      not_compared, port_sweep)
from torch_ops_surface_common import one_thread, port_on_cpu  # noqa: F401

NAMESPACES = ['paddle.linalg', 'paddle.fft', 'paddle.signal']
# exports each namespace resolves at least
TARGETS = {'paddle.linalg': 33, 'paddle.fft': 22, 'paddle.signal': 2}
# (ran, matched the recipe's numpy reference, finite-difference verified)
FLOORS = {'paddle.linalg': (31, 13, 12), 'paddle.fft': (22, 22, 0),
          'paddle.signal': (2, 0, 0)}
# the manifest's paddle names the port leaves to later items (Queue A
# items 4 and 6)
PADDLE_MISSING = {"DataParallel", "Model", "summary", "flops",
                  "enable_static", "disable_static", "in_dynamic_mode"}

CASES = [(ns, n) for ns in NAMESPACES for n in compared(ns)]


@pytest.mark.parametrize("ns,name", CASES,
                         ids=[f"{ns}:{n}" for ns, n in CASES])
def test_export_matches_jax(ns, name):
    compare(ns, name)


def test_uncompared_exports_are_listed():
    for ns in NAMESPACES:
        for n in not_compared(ns):
            assert NOT_COMPARED[(ns, n)]
        assert {n for (s, n) in NOT_COMPARED if s == ns} \
            == set(not_compared(ns))
        assert len(compared(ns)) + len(not_compared(ns)) >= TARGETS[ns]


def test_manifest_resolution():
    """linalg 33 / 33, fft 22 / 22, signal 2 / 2, Tensor 380 / 380, and
    paddle all but the seven names of later items."""
    for ns in NAMESPACES + ["Tensor"]:
        assert len(exports(ns)) == len(MANIFEST["namespaces"][ns]["exports"])
    missing = set(MANIFEST["namespaces"]["paddle"]["exports"]) \
        - set(exports("paddle"))
    assert missing == PADDLE_MISSING


def test_port_harness_sweep_floors():
    res = port_sweep(NAMESPACES)
    for ns, floor in FLOORS.items():
        ran, ref, vjp, fails = res[ns]
        assert not fails, (ns, fails)
        assert ran >= floor[0] and ref >= floor[1] and vjp >= floor[2], \
            (ns, (ran, ref, vjp), floor)


def _both(fn):
    """fn(package) on both packages, outputs as numpy arrays."""
    out = {}
    for pkg in (jpaddle, tpaddle):
        pkg.seed(11)
        r = fn(pkg)
        r = r if isinstance(r, (list, tuple)) else [r]
        out[pkg.__name__] = [np.asarray(t.numpy()) for t in r]
    return out["paddle_tpu"], out["paddle_tpu_torch"]


def _t(p, a):
    return p.to_tensor(a, dtype=str(a.dtype))


def _close(got, want, label):
    tol = TOL64 if want.dtype in (np.float64, np.complex128) else TOL32
    np.testing.assert_allclose(got, want, err_msg=label, **tol)


def _mat(dtype, shape=(5, 3), seed=0):
    return np.random.default_rng(seed).standard_normal(shape).astype(dtype)


@pytest.mark.parametrize("dtype", ["float32", "float64"])
@pytest.mark.parametrize("full", [False, True])
def test_svd_by_invariants(dtype, full):
    a = _mat(dtype)

    def run(p):
        u, s, vh = p.linalg.svd(_t(p, a), full_matrices=full)
        return u, s, vh

    (ju, js, jvh), (tu, ts, tvh) = _both(run)
    assert (tu.dtype, tu.shape, tvh.shape) == (ju.dtype, ju.shape, jvh.shape)
    _close(ts, js, "singular values")
    k = js.shape[0]
    _close((tu[:, :k] * ts) @ tvh[:k], (ju[:, :k] * js) @ jvh[:k],
           "U diag(S) V^T")
    _close(tu.T @ tu, np.eye(tu.shape[1], dtype=dtype), "U orthonormal")


@pytest.mark.parametrize("uplo", ["L", "U"])
def test_eigh_by_invariants(uplo):
    m = _mat("float64", (4, 4))
    a = m + m.T

    def run(p):
        return p.linalg.eigh(_t(p, a), UPLO=uplo)

    (jw, jv), (tw, tv) = _both(run)
    _close(tw, jw, "eigenvalues")
    _close((tv * tw) @ tv.T, (jv * jw) @ jv.T, "V diag(w) V^T")


@pytest.mark.parametrize("name", ["svd_lowrank", "pca_lowrank"])
@pytest.mark.parametrize("method", [False, True])
def test_lowrank_by_invariants(name, method):
    """The sketch is the threefry normal (float64 draws within 1e-10 of
    JAX's), so U diag(S) V^T and S are held at float64's tolerance."""
    a = _mat("float64", (6, 4), seed=3)

    def run(p):
        x = _t(p, a)
        if method:
            return getattr(x, name)(q=2)
        return getattr(p.linalg, name)(x, q=2)

    (ju, js, jv), (tu, ts, tv) = _both(run)
    assert (tu.shape, ts.shape, tv.shape) == (ju.shape, js.shape, jv.shape)
    _close(ts, js, f"{name} singular values")
    _close((tu * ts) @ tv.T, (ju * js) @ jv.T, f"{name} U diag(S) V^T")


@pytest.mark.parametrize("shape", [(4, 4), (5, 3), (3, 5)])
@pytest.mark.parametrize("method", [False, True])
def test_lu_unpack_on_lu(shape, method):
    a = _mat("float64", shape, seed=4)

    def run(p):
        lu, piv = p.linalg.lu(_t(p, a))
        if method:
            return lu.lu_unpack(piv)
        return p.linalg.lu_unpack(lu, piv)

    want, got = _both(run)
    for label, g, w in zip("PLU", got, want):
        assert (g.dtype, g.shape) == (w.dtype, w.shape), label
        _close(g, w, label)
    p, lo, up = got
    _close(p @ lo @ up, a, "P L U")


@pytest.mark.parametrize("left", [True, False])
@pytest.mark.parametrize("transpose", [False, True])
def test_ormqr_on_geqrf(left, transpose):
    a = _mat("float64", (5, 5), seed=5)
    qr_a, tau = (t.numpy() for t in torch.geqrf(torch.from_numpy(a)))
    y = _mat("float64", (5, 2) if left else (2, 5), seed=6)

    def run(p):
        x = _t(p, qr_a)
        out = [p.linalg.ormqr(x, _t(p, tau), _t(p, y), left=left,
                              transpose=transpose)]
        out.append(x.ormqr(_t(p, tau), _t(p, y), left=left,
                           transpose=transpose))
        return out

    want, got = _both(run)
    for g, w in zip(got, want):
        _close(g, w, "ormqr")


@pytest.mark.parametrize("dtype", ["float32", "float64"])
def test_realistic_decomposition_case_at_a_small_size(dtype):
    """`loop_workload.decompositions`, the card's 1024 x 1024 case, at
    n 48 on the CPU: each residual within a few hundred ulps, and the
    values within as much of numpy's float64 ones (`float64_values`)."""
    from paddle_tpu_torch.tools import loop_workload as lw

    eps = float(np.finfo(dtype).eps)
    r = lw.decompositions(tpaddle, 48, dtype)
    assert set(r["residuals"]) == {"cholesky", "solve", "eigh",
                                   "eigh_orthonormal", "svd", "qr",
                                   "qr_orthonormal", "lu"}
    assert max(r["residuals"].values()) < 300 * eps, r["residuals"]
    exact = lw.float64_values(48, dtype)
    for k in ("eigenvalues", "singular_values"):
        got, want = np.sort(r[k]), np.sort(exact[k])
        assert np.abs(got - want).max() < 300 * eps * want.max(), k
