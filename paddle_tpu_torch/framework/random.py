"""Seeded random state: the port of `paddle_tpu/framework/random.py`, and
the `jax.random` draws the JAX package's creation ops make.

`Generator` keeps JAX's `(seed, counter)` state: each `next_key()` bumps
the counter and returns `fold_in(key(seed), counter)`, a raw threefry key
(a pair of uint32 words as Python ints). `uniform`, `normal` and
`randint` turn a key into a tensor on a device with the bits of
`jax.random.uniform`, `jax.random.normal` and `jax.random.randint` in the
`jax_threefry_partitionable` mode: the threefry hash of each element's
flat index (`ops/sampling.py`'s `threefry2x32`), mantissa-filled floats,
and randint's two draws reduced modulo the span. `normal` goes through
`torch.erfinv`, so its values agree with JAX's within a float tolerance,
not bit for bit.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.sampling import threefry2x32

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "next_key", "key_of_seed", "fold_in",
           "split", "random_bits", "uniform", "normal", "randint"]

_M32 = 0xFFFFFFFF


def key_of_seed(s: int):
    """`jax.random.key(s)` (threefry): the seed's 64 bits as two words."""
    s = int(s) & 0xFFFFFFFFFFFFFFFF
    return (s >> 32, s & _M32)


def fold_in(key, data: int):
    """`jax.random.fold_in(key, data)` on a raw key."""
    return tuple(int(w) for w in threefry2x32(key[0], key[1], 0,
                                              int(data) & _M32))


def split(key, n: int = 2):
    """`jax.random.split(key, n)` (fold-like in the partitionable mode):
    key i hashes the counter pair (0, i)."""
    return [tuple(int(w) for w in threefry2x32(key[0], key[1], 0, i))
            for i in range(n)]


def random_bits(key, bit_width: int, shape, device):
    """`_threefry_random_bits_partitionable`: element i (row-major) hashes
    the counter pair (i >> 32, i & 0xFFFFFFFF). Returns an int64 tensor of
    the unsigned bits for widths up to 32, and the (high, low) 32-bit
    words for 64."""
    n = int(np.prod(shape)) if len(shape) else 1
    idx = torch.arange(n, dtype=torch.int64, device=device)
    b1, b2 = threefry2x32(key[0], key[1], idx >> 32, idx & _M32)
    if bit_width == 64:
        return b1.reshape(shape), b2.reshape(shape)
    bits = b1 ^ b2
    if bit_width < 32:
        bits = bits & ((1 << bit_width) - 1)
    return bits.reshape(shape)


_MANTISSA = {torch.float16: 10, torch.bfloat16: 7, torch.float32: 23,
             torch.float64: 52}
_SAME_WIDTH_INT = {2: torch.int16, 4: torch.int32, 8: torch.int64}


def _unit_floats(key, shape, dtype, device):
    """Floats in [0, 1): random mantissa bits under the exponent of 1.0,
    minus 1."""
    if dtype not in _MANTISSA:
        raise TypeError(f"uniform: unsupported dtype {dtype}")
    nbits, nmant = dtype.itemsize * 8, _MANTISSA[dtype]
    one = int(np.array(1.0, {16: np.float16, 32: np.float32,
                             64: np.float64}[nbits]).view(
        f"uint{nbits}")) if dtype != torch.bfloat16 else 0x3F80
    if nbits == 64:
        hi, lo = random_bits(key, 64, shape, device)
        shift = 64 - nmant
        fbits = (hi << (32 - shift)) | (lo >> shift)
    else:
        rng_bits = nbits if nmant >= 8 else 8
        fbits = random_bits(key, rng_bits, shape, device) >> (rng_bits - nmant)
    fbits = (fbits | one).to(_SAME_WIDTH_INT[dtype.itemsize])
    return fbits.view(dtype) - torch.ones((), dtype=dtype, device=device)


def _fma64(a, b, c):
    """a * b + c rounded once, for float64 tensors a and b and a float
    `c`: Dekker's exact product and a compensated sum."""
    def split(x):
        t = x * 134217729.0             # 2^27 + 1
        hi = t - (t - x)
        return hi, x - hi
    p = a * b
    ah, al = split(a)
    bh, bl = split(b)
    err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
    s = p + c
    bb = s - p
    return s + (((p - (s - bb)) + (c - bb)) + err)


def uniform(key, shape, dtype, minval, maxval, device):
    """`jax.random.uniform(key, shape, dtype, minval, maxval)`. XLA's CPU
    backend rounds `floats * (maxval - minval) + minval` once in f16, f32
    and f64 (here in float64, the product exact, and for float64 with an
    exact product and a compensated sum) and after each op in bfloat16."""
    lo = torch.tensor(minval, dtype=dtype, device=device)
    hi = torch.tensor(maxval, dtype=dtype, device=device)
    f = _unit_floats(key, tuple(shape), dtype, device)
    scale, lo64 = (hi - lo).double(), lo.double()
    if dtype == torch.bfloat16:
        y = f * (hi - lo) + lo
    elif dtype == torch.float64:
        y = _fma64(f, scale.expand_as(f), float(lo64))
    else:
        y = (f.double() * scale + lo64).to(dtype)
    return torch.maximum(lo, y)


def normal(key, shape, dtype, device):
    """`jax.random.normal(key, shape, dtype)`: sqrt(2) * erfinv(u) for u
    uniform in (-1, 1)."""
    np_t = {torch.float16: np.float16, torch.float32: np.float32,
            torch.float64: np.float64}.get(dtype)
    lo = float(np.nextafter(np_t(-1.0), np_t(0.0))) if np_t is not None \
        else float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                                   torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return torch.tensor(np.sqrt(2), dtype=dtype, device=device) \
        * torch.erfinv(u)


def _u64_const(c: int):
    """A Python int's 64 bits as (high, low) words."""
    c &= (1 << 64) - 1
    return c >> 32, c & _M32


def _u64_signed(x):
    """(high, low) words -> the int64 of the same bits."""
    h, lo = x
    return torch.where(h >= 1 << 31, h - (1 << 32), h) * (1 << 32) + lo


def _u64_words(xs):
    """int64 -> (high, low) words of the same bits."""
    return (xs >> 32) & _M32, xs & _M32


def _u64_add(x, y):
    """(x + y) mod 2^64 on words."""
    lo = x[1] + y[1]
    return (x[0] + y[0] + (lo >> 32)) & _M32, lo & _M32


def _mul32(a, c: int):
    """a * c for words a and a 32-bit int c, as (high, low) words, in
    16-bit pieces so no product leaves int64."""
    p0 = (a & 0xFFFF) * c
    p1 = (a >> 16) * c
    lo = p0 + ((p1 & 0xFFFF) << 16)
    return (p1 >> 16) + (lo >> 32), lo & _M32


def _u64_mul(x, m: int):
    """(x * m) mod 2^64 on words, for a Python int m."""
    mh, ml = _u64_const(m)
    ph, pl = _mul32(x[1], ml)
    return (ph + _mul32(x[0], ml)[1] + _mul32(x[1], mh)[1]) & _M32, pl


def _u64_mod(x, span: int):
    """x mod span on words, for 2^31 <= span < 2^64, through the int64
    of x's bits: x is that int64, or it plus 2^64 where it is negative."""
    xs = _u64_signed(x)
    if span < 1 << 63:
        r = torch.remainder(xs, span)
        # r + 2^64 mod span, reduced without leaving int64
        t = r - (span - (1 << 64) % span)
        r = torch.where(xs < 0, torch.where(t >= 0, t, t + span), r)
    else:
        # x < 2 span: one subtraction where x >= span (unsigned)
        ss = span - (1 << 64)
        r = torch.where((xs < 0) & (xs >= ss), xs - ss, xs)
    return _u64_words(r)


def randint(key, shape, low: int, high: int, dtype, device):
    """`jax.random.randint(key, shape, low, high, dtype)` for int32 and
    int64: two draws of the dtype's width, `(hi % span) * (2^nbits % span)
    + lo % span` reduced modulo the span, in the unsigned arithmetic JAX
    uses."""
    if dtype not in (torch.int32, torch.int64):
        raise TypeError(f"randint: dtype must be int32 or int64, got {dtype}")
    nbits = dtype.itemsize * 8
    info = torch.iinfo(dtype)
    out_of_range = high > info.max
    low = min(max(int(low), info.min), info.max)
    high = min(max(int(high), info.min), info.max)
    mask = (1 << nbits) - 1
    span = (high - low) & mask
    if high <= low:
        span = 1
    elif out_of_range:
        span = (span + 1) & mask
    if span == 0:
        raise NotImplementedError("randint over the whole range of the "
                                  "dtype")
    # 2^nbits % span as JAX forms it, its square wrapping in nbits bits
    mult = ((((1 << (nbits // 2)) % span) ** 2) & mask) % span
    k1, k2 = split(key)
    shape = tuple(shape)
    if nbits == 32:
        hb = random_bits(k1, 32, shape, device)
        lb = random_bits(k2, 32, shape, device)
        off = (((hb % span) * mult) & _M32) + lb % span
        off = (off & _M32) % span
    elif span < (1 << 31):
        # 64-bit draws as (high, low) words; every product stays < 2^62
        w32 = (1 << 32) % span

        def mod(words):
            return ((words[0] % span) * w32 + words[1] % span) % span
        off = (mod(random_bits(k1, 64, shape, device)) * mult
               + mod(random_bits(k2, 64, shape, device))) % span
    else:
        # a span past 2^31: JAX's wrapping uint64 arithmetic on (high,
        # low) 32-bit words, on the tensors' device
        a = _u64_mod(random_bits(k1, 64, shape, device), span)
        b = _u64_mod(random_bits(k2, 64, shape, device), span)
        off = _u64_mod(_u64_add(_u64_mul(a, mult), b), span)
        return _u64_signed(_u64_add(off, _u64_const(low))).to(dtype)
    return (off + low).to(dtype)


class Generator:
    """The `(seed, counter)` random state of `phi/core/generator.h`: key
    material is `fold_in(key(seed), counter)`, so a state is reproducible
    from the pair alone."""

    def __init__(self, seed: int = 0):
        self._lock = threading.Lock()
        self.manual_seed(seed)

    def manual_seed(self, seed: int):
        with self._lock:
            self._seed = int(seed)
            self._counter = 0
        return self

    def initial_seed(self) -> int:
        return self._seed

    def next_key(self):
        """A fresh key; advances the counter."""
        with self._lock:
            self._counter += 1
            return fold_in(key_of_seed(self._seed), self._counter)

    def get_state(self):
        return (self._seed, self._counter)

    def set_state(self, state):
        with self._lock:
            self._seed, self._counter = int(state[0]), int(state[1])


_default_generator = Generator(np.random.randint(0, 2 ** 31 - 1))


def default_generator() -> Generator:
    return _default_generator


def seed(s: int) -> Generator:
    """paddle.seed: reseed the default generator."""
    return _default_generator.manual_seed(s)


def get_rng_state():
    return [_default_generator.get_state()]


def set_rng_state(states):
    _default_generator.set_state(states[0])


def next_key():
    return _default_generator.next_key()
