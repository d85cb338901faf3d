"""Tensor creation: the port of `paddle_tpu/ops/creation.py`:
`to_tensor`, `zeros`, `ones`, `full`, `empty`, the `_like` forms,
`arange`, `eye`, `linspace`, `assign`, `tril` / `triu`, `diag` /
`diagflat`, `meshgrid`, and the seeded draws `rand`, `randn`, `randint`,
`uniform`, `normal`, `randperm`, `bernoulli` and `multinomial`, which take
a key from the default generator and give the JAX package's values
(`framework/random.py`): `randperm` is `jax.random.permutation`'s sort of
arange by 32-bit random keys (stable, in as many rounds as JAX takes),
`bernoulli` is `uniform(key, p.shape, p.dtype) < p`, and `multinomial` is
`jax.random.choice` with `p` (with replacement: the search of
`total * (1 - uniform)` in the cumulative sum; without: the top `n` of
Gumbel noise plus `log p`, ties to the lower index), row by row on
`split(key, rows)` for a 2-D `p`. The draws that take a key pass it as
a tensor input of their op. New tensors go to the expected place
(`set_device`), the CUDA card by default; the `_like` forms and the
draws shaped by a tensor go to its device.

Default dtypes as the JAX package's: Python floats (and numpy float64
arrays given to `to_tensor`) take the default float dtype, Python ints
int64; `full` / `zeros` / `ones` are float unless asked otherwise, even
for an int fill; `arange` of ints is int64.
"""
from __future__ import annotations

import numpy as np
import torch

from ..core import dispatch
from ..core.tensor import Tensor, _to_torch
from ..framework import dtype as dtype_mod
from ..framework import random as random_mod
from ..framework.place import expected_device
from .sampling import threefry2x32
from ._helpers import as_tensor, cast_to, shape_to_tuple

__all__ = ["to_tensor", "full", "zeros", "ones", "empty", "full_like",
           "zeros_like", "ones_like", "empty_like", "arange", "eye",
           "linspace", "tril", "triu", "diag", "diagflat", "meshgrid",
           "assign", "clone", "rand", "randn", "randint", "uniform",
           "normal", "randperm", "bernoulli", "multinomial"]


def to_tensor(data, dtype=None, place=None, stop_gradient=True) -> Tensor:
    if isinstance(data, Tensor):
        t = data
        if dtype is not None and t.dtype != dtype_mod.convert_dtype(dtype):
            t = cast_to(t, dtype)
        return Tensor(t._data, stop_gradient=stop_gradient)
    if isinstance(data, torch.Tensor):
        t = data.detach().to(expected_device(place))
    else:
        arr = np.asarray(data)
        t = _to_torch(arr, place)
        if dtype is None and arr.dtype == np.float64:
            dtype = dtype_mod.get_default_dtype()
    if dtype is not None:
        t = t.to(dtype_mod.to_torch(dtype))
    return Tensor(t, stop_gradient=stop_gradient)


def _float_dtype(dtype) -> torch.dtype:
    return dtype_mod.to_torch(dtype) if dtype is not None \
        else dtype_mod.get_default_dtype().torch_dtype


def full(shape, fill_value, dtype=None, name=None) -> Tensor:
    if isinstance(fill_value, Tensor):
        fill_value = fill_value.item()
    if dtype is None:
        dt = torch.bool if isinstance(fill_value, bool) else _float_dtype(None)
    else:
        dt = dtype_mod.to_torch(dtype)
    return Tensor._wrap(torch.full(shape_to_tuple(shape), fill_value,
                                   dtype=dt, device=expected_device()))


def zeros(shape, dtype=None, name=None) -> Tensor:
    return full(shape, 0, dtype=dtype or dtype_mod.get_default_dtype())


def ones(shape, dtype=None, name=None) -> Tensor:
    return full(shape, 1, dtype=dtype or dtype_mod.get_default_dtype())


def empty(shape, dtype=None, name=None) -> Tensor:
    return zeros(shape, dtype=dtype)


dispatch.register_op("full_like", lambda x, *, value: torch.full_like(
    x, value))
dispatch.register_op("zeros_like", torch.zeros_like)
dispatch.register_op("ones_like", torch.ones_like)


def _like(opname, x, dtype, **attrs):
    x = as_tensor(x)
    if dtype is not None:
        x = cast_to(x, dtype)
    return dispatch.apply(opname, [x], attrs or None)


def full_like(x, fill_value, dtype=None, name=None) -> Tensor:
    return _like("full_like", x, dtype, value=fill_value)


def zeros_like(x, dtype=None, name=None) -> Tensor:
    return _like("zeros_like", x, dtype)


def ones_like(x, dtype=None, name=None) -> Tensor:
    return _like("ones_like", x, dtype)


def empty_like(x, dtype=None, name=None) -> Tensor:
    return zeros_like(x, dtype=dtype)


def arange(start=0, end=None, step=1, dtype=None, name=None) -> Tensor:
    if end is None:
        start, end = 0, start
    for v in (start, end, step):
        if isinstance(v, Tensor):
            raise TypeError("arange with Tensor bounds is not supported; "
                            "pass python numbers")
    if dtype is None:
        dt = torch.int64 if all(isinstance(v, (int, np.integer))
                                for v in (start, end, step)) \
            else _float_dtype(None)
    else:
        dt = dtype_mod.to_torch(dtype)
    return Tensor._wrap(torch.arange(start, end, step, dtype=dt,
                                     device=expected_device()))


def eye(num_rows, num_columns=None, dtype=None, name=None) -> Tensor:
    m = int(num_columns) if num_columns is not None else int(num_rows)
    return Tensor._wrap(torch.eye(int(num_rows), m, dtype=_float_dtype(dtype),
                                  device=expected_device()))


def linspace(start, stop, num, dtype=None, name=None) -> Tensor:
    start, stop, num = (v.item() if isinstance(v, Tensor) else v
                        for v in (start, stop, num))
    return Tensor._wrap(torch.linspace(float(start), float(stop), int(num),
                                       dtype=_float_dtype(dtype),
                                       device=expected_device()))


dispatch.register_op("tril", lambda x, *, diagonal: torch.tril(x, diagonal))
dispatch.register_op("triu", lambda x, *, diagonal: torch.triu(x, diagonal))


def tril(x, diagonal=0, name=None) -> Tensor:
    return dispatch.apply("tril", [as_tensor(x)], {"diagonal": int(diagonal)})


def triu(x, diagonal=0, name=None) -> Tensor:
    return dispatch.apply("triu", [as_tensor(x)], {"diagonal": int(diagonal)})


dispatch.register_op("diag", lambda x, *, offset: torch.diag(x, offset))


def diag(x, offset=0, padding_value=0, name=None) -> Tensor:
    """A 1-D x on the `offset` diagonal of a square matrix (the rest
    `padding_value`), or a 2-D x's `offset` diagonal."""
    x = as_tensor(x)
    out = dispatch.apply("diag", [x], {"offset": int(offset)})
    if padding_value != 0 and x.ndim == 1:
        from .manipulation import where

        mask = Tensor._wrap(torch.diag(torch.ones(
            x.shape[0], dtype=torch.bool, device=out._data.device),
            int(offset)))
        out = where(mask, out, full_like(out, padding_value))
    return out


def diagflat(x, offset=0, name=None) -> Tensor:
    from .manipulation import flatten

    return diag(flatten(as_tensor(x)), offset=offset)


def meshgrid(*args, **kwargs):
    """`ij`-indexed grids of the 1-D inputs (given as arguments or one
    list), op `meshgrid_<n>`."""
    tensors = [as_tensor(a) for a in (
        args[0] if len(args) == 1 and isinstance(args[0], (list, tuple))
        else args)]
    name = f"meshgrid_{len(tensors)}"
    if name not in dispatch.op_registry():
        dispatch.register_op(name, lambda *xs: tuple(
            torch.meshgrid(*xs, indexing="ij")), multi_out=True)
    return dispatch.apply(name, tensors)


dispatch.register_op("assign", torch.clone)


def assign(x, output=None) -> Tensor:
    out = dispatch.apply("assign", [as_tensor(x)])
    if output is not None:
        output._data = out._data
        return output
    return out


def clone(x, name=None) -> Tensor:
    return assign(x)


# ---------------------------------------------------------------------------
# seeded draws: one key from the default generator per call
# ---------------------------------------------------------------------------

def uniform(shape, dtype=None, min=-1.0, max=1.0, seed=0, name=None):
    return Tensor._wrap(random_mod.uniform(
        random_mod.next_key(), shape_to_tuple(shape), _float_dtype(dtype),
        float(min), float(max), expected_device()))


def rand(shape, dtype=None, name=None) -> Tensor:
    return uniform(shape, dtype=dtype, min=0.0, max=1.0)


def randn(shape, dtype=None, name=None) -> Tensor:
    return Tensor._wrap(random_mod.normal(
        random_mod.next_key(), shape_to_tuple(shape), _float_dtype(dtype),
        expected_device()))


def normal(mean=0.0, std=1.0, shape=None, name=None) -> Tensor:
    if isinstance(mean, Tensor) or isinstance(std, Tensor):
        m, s = as_tensor(mean), as_tensor(std)
        g = randn(m.shape if isinstance(mean, Tensor) else s.shape)
        return g * s + m
    g = randn(shape)
    return Tensor._wrap(g._data * float(std) + float(mean))


def randint(low=0, high=None, shape=(1,), dtype=None, name=None) -> Tensor:
    if high is None:
        low, high = 0, low
    dt = dtype_mod.to_torch(dtype) if dtype is not None else torch.int64
    return Tensor._wrap(random_mod.randint(
        random_mod.next_key(), shape_to_tuple(shape), int(low), int(high),
        dt, expected_device()))


def _key_tensor(device=None) -> Tensor:
    """A fresh key of the default generator as an int64 tensor of its
    two uint32 words, on `device` (the expected place by default)."""
    return Tensor._wrap(torch.tensor(random_mod.next_key(), dtype=torch.int64,
                                     device=expected_device(device)))


def _subkey(key, i):
    """`jax.random.split(key)[i]` on a key tensor, as a pair of 0-d
    tensors (no host read)."""
    return threefry2x32(key[0], key[1], 0, i)


def _randperm(key, *, n, dtype):
    # jax.random.permutation: `rounds` stable sorts of arange(n) by fresh
    # 32-bit keys
    rounds = int(np.ceil(3 * np.log(max(1, n)) / np.log(2 ** 32 - 1)))
    x = torch.arange(n, dtype=torch.int64, device=key.device)
    k = (key[0], key[1])
    for _ in range(rounds):
        k, sub = threefry2x32(k[0], k[1], 0, 0), threefry2x32(k[0], k[1], 0,
                                                              1)
        bits = random_mod.random_bits(sub, 32, (n,), key.device)
        x = x[torch.sort(bits, stable=True).indices]
    return x.to(dtype)


dispatch.register_op("randperm", _randperm)


def randperm(n, dtype="int64", name=None) -> Tensor:
    return dispatch.apply("randperm", [_key_tensor()],
                          {"n": int(n), "dtype": dtype_mod.to_torch(dtype)})


def _bernoulli(key, p):
    u = random_mod.uniform((key[0], key[1]), tuple(p.shape), p.dtype, 0.0,
                           1.0, p.device)
    return (u < p).to(p.dtype)


dispatch.register_op("bernoulli", _bernoulli)


def bernoulli(x, name=None) -> Tensor:
    x = as_tensor(x)
    return dispatch.apply("bernoulli", [_key_tensor(x._data.device), x])


def _choice(k, p, n, replace):
    """`jax.random.choice(k, len(p), (n,), replace, p)` for one row."""
    p = p / p.sum()
    if replace:
        cum = torch.cumsum(p, 0)
        u = random_mod.uniform(k, (n,), p.dtype, 0.0, 1.0, p.device)
        r = cum[-1] * (1 - u)
        return torch.searchsorted(cum, r).to(torch.int64)
    tiny = float(torch.finfo(p.dtype).tiny)
    u = random_mod.uniform(k, (p.shape[0],), p.dtype, tiny, 1.0, p.device)
    g = -torch.log(-torch.log(u)) + torch.log(p)
    return torch.sort(g, descending=True, stable=True).indices[:n]


def _multinomial(key, p, *, n, replace):
    if p.dim() == 1:
        return _choice((key[0], key[1]), p, n, replace)
    return torch.stack([_choice(_subkey(key, i), p[i], n, replace)
                        for i in range(p.shape[0])])


dispatch.register_op("multinomial_rep", lambda key, p, *, n: _multinomial(
    key, p, n=n, replace=True))
dispatch.register_op("multinomial_norep", lambda key, p, *, n: _multinomial(
    key, p, n=n, replace=False))


def multinomial(x, num_samples=1, replacement=False, name=None) -> Tensor:
    x = as_tensor(x)
    opname = "multinomial_rep" if replacement else "multinomial_norep"
    return dispatch.apply(opname, [_key_tensor(x._data.device), x],
                          {"n": int(num_samples)})
