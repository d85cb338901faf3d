"""Linear algebra: the port of `paddle_tpu/ops/linalg.py` (the
`paddle.linalg` namespace and the products, norms, counts,
decompositions and solvers the top level exports), in plain torch as the
JAX package computes them outside any Pallas kernel.

Where torch's call differs from the jnp one, the jnp semantics are
kept: `cross`'s `axis=9` default is the first axis of size 3;
`histogram` bins as `jnp.histogram` (right-closed last bin, a constant
input widened by 0.5 each way); `lstsq` is jnp's SVD solve (rcond eps *
max(m, n), residuals always returned); `ormqr` applies the Q of
`householder_product` (the input's shape) as a matmul; `lu` returns
LAPACK's 1-based pivots; `svd_lowrank` / `pca_lowrank` draw their sketch
from the port's threefry normal. Decompositions run where their input
lies: LAPACK on the CPU, cuSOLVER on the card, whose eigen- and singular
vectors need not take LAPACK's signs."""
from __future__ import annotations

import builtins

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ._helpers import as_tensor, normalize_axis, prep_binary

__all__ = ["matmul", "mm", "bmm", "dot", "mv", "cross", "norm",
           "vector_norm", "matrix_norm", "dist", "histogram", "bincount",
           "cholesky", "qr", "svd", "inv", "inverse", "pinv", "solve",
           "triangular_solve", "cholesky_solve", "lu", "det", "slogdet",
           "eig", "eigh", "eigvals", "eigvalsh", "matrix_power",
           "matrix_rank", "multi_dot", "lstsq", "corrcoef", "cov", "cond",
           "einsum", "matrix_transpose", "matrix_exp", "cholesky_inverse",
           "householder_product", "ormqr", "lu_unpack", "svd_lowrank",
           "pca_lowrank", "fp8_fp8_half_gemm_fused"]


def _reg(name, fn, multi_out=False):
    if name not in dispatch.op_registry():
        dispatch.register_op(name, fn, multi_out=multi_out)


def _one(opname, x, attrs=None):
    return dispatch.apply(opname, [as_tensor(x)], attrs)


def _mm(x, y, *, transpose_x, transpose_y):
    if transpose_x and x.dim() >= 2:
        x = x.transpose(-1, -2)
    if transpose_y and y.dim() >= 2:
        y = y.transpose(-1, -2)
    return torch.matmul(x, y)


_reg("matmul", _mm)


def matmul(x, y, transpose_x=False, transpose_y=False, name=None):
    return dispatch.apply("matmul", list(prep_binary(x, y)),
                          {"transpose_x": bool(transpose_x),
                           "transpose_y": bool(transpose_y)})


def mm(input, mat2, name=None):
    return matmul(input, mat2)


def bmm(x, y, name=None):
    return matmul(x, y)


def mv(x, vec, name=None):
    return matmul(x, vec)


_reg("dot", lambda x, y: (x * y).sum(dim=-1))


def dot(x, y, name=None):
    return dispatch.apply("dot", list(prep_binary(x, y)))


_reg("cross", lambda x, y, *, axis: torch.linalg.cross(x, y, dim=axis))


def cross(x, y, axis=9, name=None):
    x, y = prep_binary(x, y)
    if axis == 9:       # paddle's default: the first axis of size 3
        axis = next(i for i, s in enumerate(x.shape) if s == 3)
    return dispatch.apply("cross", [x, y],
                          {"axis": normalize_axis(axis, x.ndim)})


def _pnorm(x, *, p, axis, keepdim):
    dims = axis if axis is not None else tuple(range(x.dim()))
    a = x.abs()
    if p in ("fro", 2):
        return torch.sqrt((a * a).sum(dim=dims, keepdim=keepdim))
    if p in ("inf", np.inf):
        return a.amax(dim=dims, keepdim=keepdim)
    if p in ("-inf", -np.inf):
        return a.amin(dim=dims, keepdim=keepdim)
    if p == 0:
        return (x != 0).to(x.dtype).sum(dim=dims, keepdim=keepdim)
    if p == 1:
        return a.sum(dim=dims, keepdim=keepdim)
    return torch.pow(torch.pow(a, p).sum(dim=dims, keepdim=keepdim), 1.0 / p)


_reg("p_norm", _pnorm)


def norm(x, p=None, axis=None, keepdim=False, name=None):
    from .manipulation import cast

    x = as_tensor(x)
    if not dtype_mod.is_inexact(x._data.dtype):
        x = cast(x, dtype_mod.get_default_dtype())
    if p is None:
        p = "fro" if axis is None or isinstance(axis, (list, tuple)) else 2
    return dispatch.apply("p_norm", [x], {
        "p": p if isinstance(p, (int, float)) else str(p),
        "axis": normalize_axis(axis, x.ndim), "keepdim": bool(keepdim)})


def vector_norm(x, p=2.0, axis=None, keepdim=False, name=None):
    x = as_tensor(x)
    return dispatch.apply("p_norm", [x], {
        "p": float(p), "axis": normalize_axis(axis, x.ndim),
        "keepdim": bool(keepdim)})


_reg("matrix_norm_op", lambda x, *, p, axis, keepdim: torch.linalg.matrix_norm(
    x, ord=p, dim=axis, keepdim=keepdim))


def matrix_norm(x, p="fro", axis=(-2, -1), keepdim=False, name=None):
    pk = p if isinstance(p, (int, float)) else str(p)
    if pk in ("inf", "-inf"):
        pk = float(pk)
    return _one("matrix_norm_op", x, {"p": pk, "axis": tuple(axis),
                                      "keepdim": bool(keepdim)})


def dist(x, y, p=2, name=None):
    from .math import subtract

    return norm(subtract(x, y), p=p)


def _histogram(x, *, bins, min, max):
    a = x if dtype_mod.is_inexact(x.dtype) else x.to(torch.float64)
    if min != 0 or max != 0:
        lo = torch.tensor(min, dtype=a.dtype, device=a.device)
        hi = torch.tensor(max, dtype=a.dtype, device=a.device)
    else:
        lo, hi = a.min(), a.max()
    flat = hi == lo
    lo, hi = torch.where(flat, lo - 0.5, lo), torch.where(flat, hi + 0.5, hi)
    step = torch.arange(bins, dtype=a.dtype, device=a.device) / bins
    edges = torch.cat([lo * (1 - step) + hi * step, hi.reshape(1)])
    idx = torch.searchsorted(edges, a.reshape(-1), right=True)
    idx = torch.where(a.reshape(-1) == edges[-1], bins, idx)
    # an index past the last edge (a value above the range) is dropped,
    # as `.at[].add` drops it
    counts = torch.bincount(idx, minlength=bins + 2)[1:bins + 1]
    return counts.to(torch.int64)


_reg("histogram", _histogram)


def histogram(input, bins=100, min=0, max=0, weight=None, density=False,
              name=None):
    return _one("histogram", input, {"bins": int(bins), "min": float(min),
                                     "max": float(max)})


def _bincount(x, *w, length):
    if not w:
        return torch.bincount(x, minlength=length).to(torch.int64)
    return torch.zeros(length, dtype=w[0].dtype, device=x.device).index_add(
        0, x, w[0])


_reg("bincount", _bincount)


def bincount(x, weights=None, minlength=0, name=None):
    """Counts (or summed weights) of each value of x; the length reads
    x's maximum on the host, as the JAX package does."""
    x = as_tensor(x)
    n = int(x._data.max().item()) + 1 if x.size else 0
    ins = [x] if weights is None else [x, as_tensor(weights)]
    return dispatch.apply("bincount", ins,
                          {"length": builtins.max(n, int(minlength))})


_reg("cholesky", lambda x, *, upper: torch.linalg.cholesky(x, upper=upper))


def cholesky(x, upper=False, name=None):
    return _one("cholesky", x, {"upper": bool(upper)})


_reg("qr", lambda x, *, mode: tuple(torch.linalg.qr(x, mode=mode)),
     multi_out=True)


def qr(x, mode="reduced", name=None):
    if mode not in ("reduced", "complete"):
        raise KeyError(f"qr_{mode}")
    return tuple(_one("qr", x, {"mode": mode}))


def _svd(x, *, full):
    # on the card, cuSOLVER's QR-based gesvd: torch's default driver
    # there leaves a 1024 x 1024 float32 reconstruction 3e-4 off (1.9e-6
    # on the CPU's LAPACK)
    driver = "gesvd" if x.is_cuda else None
    return tuple(torch.linalg.svd(x, full_matrices=full, driver=driver))


_reg("svd", _svd, multi_out=True)


def svd(x, full_matrices=False, name=None):
    return tuple(_one("svd", x, {"full": bool(full_matrices)}))


_reg("inverse", torch.linalg.inv)


def inv(x, name=None):
    return _one("inverse", x)


inverse = inv

_reg("pinv", lambda x, *, rcond: torch.linalg.pinv(x, rtol=rcond))


def pinv(x, rcond=1e-15, hermitian=False, name=None):
    return _one("pinv", x, {"rcond": float(rcond)})


def _solve(a, b):
    # jnp.linalg.solve: b is a vector (or a batch of them) where it has
    # one axis fewer than a
    if b.dim() == 1 or b.dim() == a.dim() - 1:
        return torch.linalg.solve(a, b.unsqueeze(-1)).squeeze(-1)
    return torch.linalg.solve(a, b)


_reg("matrix_solve", _solve)


def solve(x, y, name=None):
    return dispatch.apply("matrix_solve", list(prep_binary(x, y)))


def _tri_solve(a, b, *, upper, transpose, unitriangular):
    if transpose:
        a, upper = a.transpose(-1, -2), not upper
    return torch.linalg.solve_triangular(a, b, upper=upper,
                                         unitriangular=unitriangular)


_reg("triangular_solve", _tri_solve)


def triangular_solve(x, y, upper=True, transpose=False, unitriangular=False,
                     name=None):
    return dispatch.apply("triangular_solve", list(prep_binary(x, y)), {
        "upper": bool(upper), "transpose": bool(transpose),
        "unitriangular": bool(unitriangular)})


_reg("cholesky_solve", lambda b, f, *, upper: torch.cholesky_solve(
    b, f, upper=upper))


def cholesky_solve(x, y, upper=False, name=None):
    return dispatch.apply("cholesky_solve", [as_tensor(x), as_tensor(y)],
                          {"upper": bool(upper)})


_reg("lu_op", lambda x: tuple(torch.linalg.lu_factor(x)), multi_out=True)


def lu(x, pivot=True, get_infos=False, name=None):
    """(LU packed, 1-based int32 pivots[, infos]): the combined L\\U
    factor and the row swaps; `infos` is LAPACK getrf's: i (1-based) for
    the first exactly zero U(i, i), else 0."""
    packed, pivots = _one("lu_op", x)
    if get_infos:
        diag = torch.diagonal(packed._data.detach(), dim1=-2, dim2=-1)
        zero = diag == 0
        first = torch.argmax(zero.to(torch.int32), dim=-1) + 1
        info = torch.where(zero.any(-1), first, 0).to(torch.int32)
        return packed, pivots, Tensor._wrap(info)
    return packed, pivots


_reg("det", torch.linalg.det)


def det(x, name=None):
    return _one("det", x)


_reg("slogdet", lambda x: tuple(torch.linalg.slogdet(x)), multi_out=True)


def slogdet(x, name=None):
    return tuple(_one("slogdet", x))


_reg("eig", lambda x: tuple(torch.linalg.eig(x)), multi_out=True)
_reg("eigh_op", lambda x, *, uplo: tuple(torch.linalg.eigh(x, UPLO=uplo)),
     multi_out=True)
_reg("eigvals", torch.linalg.eigvals)
_reg("eigvalsh_op", lambda x, *, uplo: torch.linalg.eigvalsh(x, UPLO=uplo))


def eig(x, name=None):
    return tuple(_one("eig", x))


def eigh(x, UPLO="L", name=None):
    return tuple(_one("eigh_op", x, {"uplo": UPLO}))


def eigvals(x, name=None):
    return _one("eigvals", x)


def eigvalsh(x, UPLO="L", name=None):
    return _one("eigvalsh_op", x, {"uplo": UPLO})


_reg("matrix_power", lambda x, *, n: torch.linalg.matrix_power(x, n))


def matrix_power(x, n, name=None):
    return _one("matrix_power", x, {"n": int(n)})


def _matrix_rank(x, *, tol):
    if tol is None:
        return torch.linalg.matrix_rank(x)
    return torch.linalg.matrix_rank(x, atol=tol, rtol=0.0)


_reg("matrix_rank_tol", _matrix_rank)


def matrix_rank(x, tol=None, hermitian=False, name=None):
    return _one("matrix_rank_tol", x,
                {"tol": float(tol) if tol is not None else None})


def multi_dot(x, name=None):
    ts = [as_tensor(t) for t in x]
    out = ts[0]
    for t in ts[1:]:
        out = matmul(out, t)
    return out


def _lstsq(a, b):
    """`jnp.linalg.lstsq(a, b)`: the SVD solve with rcond = eps *
    max(m, n); (x, residuals, rank, singular values)."""
    vec = b.dim() == 1
    if vec:
        b = b[:, None]
    m, n = a.shape
    rcond = float(torch.finfo(a.dtype).eps) * builtins.max(n, m)
    u, s, vt = torch.linalg.svd(a, full_matrices=False)
    mask = (s > 0) & (s >= rcond * s[0])
    rank = mask.sum()
    safe = torch.where(mask, s, torch.ones_like(s))
    s_inv = torch.where(mask, 1 / safe, torch.zeros_like(s))[:, None]
    x = vt.conj().T @ (s_inv * (u.conj().T @ b))
    resid = torch.linalg.vector_norm(b - a @ x, dim=0) ** 2
    if vec:
        x = x.reshape(-1)
    return x, resid, rank, s


_reg("lstsq_op", _lstsq, multi_out=True)


def lstsq(x, y, rcond=None, driver=None, name=None):
    return tuple(dispatch.apply("lstsq_op", [as_tensor(x), as_tensor(y)]))


def _corrcoef(x, *, rowvar):
    return torch.corrcoef(x if rowvar else x.T)


_reg("corrcoef_op", _corrcoef)


def corrcoef(x, rowvar=True, name=None):
    return _one("corrcoef_op", x, {"rowvar": bool(rowvar)})


_reg("cov_op", lambda x, *, rowvar, ddof: torch.cov(
    x if rowvar or x.dim() < 2 else x.T, correction=ddof))


def cov(x, rowvar=True, ddof=True, fweights=None, aweights=None, name=None):
    return _one("cov_op", x, {"rowvar": bool(rowvar),
                              "ddof": 1 if ddof else 0})


_reg("cond_op", lambda x, *, p: torch.linalg.cond(x, p))


def cond(x, p=None, name=None):
    pk = p if isinstance(p, (int, float)) or p is None else str(p)
    return _one("cond_op", x, {"p": pk})


_reg("einsum", lambda *xs, eq: torch.einsum(eq, *xs))


def einsum(equation, *operands):
    return dispatch.apply("einsum", [as_tensor(t) for t in operands],
                          {"eq": equation})


def matrix_transpose(x, name=None):
    from .manipulation import swapaxes

    return swapaxes(x, -1, -2)


_reg("matrix_exp_op", torch.linalg.matrix_exp)


def matrix_exp(x, name=None):
    return _one("matrix_exp_op", x)


_reg("cholesky_inverse_op", lambda f, *, upper: torch.cholesky_inverse(
    f, upper=upper))


def cholesky_inverse(x, upper=False, name=None):
    """A^-1 from A's Cholesky factor."""
    return _one("cholesky_inverse_op", x, {"upper": bool(upper)})


_reg("householder_product_op", torch.linalg.householder_product)


def householder_product(x, tau, name=None):
    return dispatch.apply("householder_product_op",
                          [as_tensor(x), as_tensor(tau)])


def _ormqr(a, taus, y, *, left, transpose):
    q = torch.linalg.householder_product(a, taus)
    if transpose:
        q = q.transpose(-1, -2)
    return torch.matmul(q, y) if left else torch.matmul(y, q)


_reg("ormqr_op", _ormqr)


def ormqr(x, tau, y, left=True, transpose=False, name=None):
    """`y` times Q (from the Householder factors `x`, `tau`), Q formed by
    `householder_product` as the JAX package forms it."""
    return dispatch.apply("ormqr_op", [as_tensor(x), as_tensor(tau),
                                       as_tensor(y)],
                          {"left": bool(left), "transpose": bool(transpose)})


def _lu_unpack(lu_data, pivots, *, unpack_ludata, unpack_pivots):
    empty = torch.zeros((0,), dtype=lu_data.dtype, device=lu_data.device)
    p, lo, up = torch.lu_unpack(lu_data, pivots.to(torch.int32).contiguous())
    return (p if unpack_pivots else empty,
            lo if unpack_ludata else empty,
            up if unpack_ludata else empty)


_reg("lu_unpack_op", _lu_unpack, multi_out=True)


def lu_unpack(x, y, unpack_ludata=True, unpack_pivots=True, name=None):
    """(P, L, U) from `lu`'s packed factor and 1-based pivots, A = P L
    U."""
    return dispatch.apply("lu_unpack_op", [as_tensor(x), as_tensor(y)],
                          {"unpack_ludata": bool(unpack_ludata),
                           "unpack_pivots": bool(unpack_pivots)})


def _svd_lowrank(a, omega, m_off, *, niter, has_m):
    if has_m:
        a = a - m_off
    at = a.transpose(-1, -2)
    qmat = torch.linalg.qr(a @ omega).Q
    for _ in range(niter):
        z = torch.linalg.qr(at @ qmat).Q
        qmat = torch.linalg.qr(a @ z).Q
    u_b, s, vh = torch.linalg.svd(qmat.transpose(-1, -2) @ a,
                                  full_matrices=False)
    return qmat @ u_b, s, vh.transpose(-1, -2)


_reg("svd_lowrank_op", _svd_lowrank, multi_out=True)


def svd_lowrank(x, q=6, niter=2, M=None, name=None):
    """Randomised low-rank SVD: a q-column sketch (the threefry normal of
    `jax.random.normal`), `niter` power iterations, a small dense SVD."""
    xt = as_tensor(x)
    d = xt._data
    omega = Tensor._wrap(random_mod.normal(
        random_mod.next_key(), (d.shape[-1], int(q)), d.dtype, d.device))
    m_arg = as_tensor(M) if M is not None else Tensor._wrap(
        torch.zeros((1,), dtype=d.dtype, device=d.device))
    return tuple(dispatch.apply("svd_lowrank_op", [xt, omega, m_arg],
                                {"niter": int(niter), "has_m": M is not None}))


def pca_lowrank(x, q=None, center=True, niter=2, name=None):
    """Randomised PCA: centre the rows' mean, then `svd_lowrank`."""
    from .manipulation import unsqueeze
    from .math import subtract
    from .reduction import mean

    xt = as_tensor(x)
    if q is None:
        q = builtins.min(6, xt._data.shape[-2], xt._data.shape[-1])
    if center:
        xt = subtract(xt, unsqueeze(mean(xt, axis=-2), -2))
    return svd_lowrank(xt, q=q, niter=niter)


def _fp8_gemm(x, y, *, tx, ty, scale, out_dtype):
    a = x.transpose(-1, -2) if tx else x
    b = y.transpose(-1, -2) if ty else y
    out = torch.matmul(a.to(torch.float32), b.to(torch.float32))
    return (out * scale).to(out_dtype)


_reg("fp8_gemm_op", _fp8_gemm)


def fp8_fp8_half_gemm_fused(x, y, bias=None, transpose_x=False,
                            transpose_y=False, scale=1.0,
                            output_dtype="float16", name=None):
    """fp8 x fp8 -> half gemm: the inputs widened to f32, an f32 matmul,
    times `scale`, rounded once to `output_dtype` (then + bias)."""
    out = dispatch.apply("fp8_gemm_op", [as_tensor(x), as_tensor(y)], {
        "tx": bool(transpose_x), "ty": bool(transpose_y),
        "scale": float(scale),
        "out_dtype": dtype_mod.to_torch(output_dtype)})
    if bias is not None:
        out = out + as_tensor(bias)
    return out
