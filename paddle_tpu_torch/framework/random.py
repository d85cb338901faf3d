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
`erf_inv`, XLA's own f32 / f64 `ErfInv` polynomial (not `torch.erfinv`,
which rounds otherwise) over XLA's `log1p`, each Horner step one fused
multiply-add as XLA's CPU build contracts it. One step stays torch's:
`log(1 + x)` for |x| >= sqrt(2) - 1, where XLA's own `log` rounds
otherwise in about one draw in a few thousand.
"""
from __future__ import annotations

import threading

import numpy as np
import torch

from ..ops.sampling import threefry2x32

__all__ = ["Generator", "default_generator", "seed", "get_rng_state",
           "set_rng_state", "next_key", "key_of_seed", "fold_in",
           "split", "random_bits", "uniform", "normal", "randint",
           "erf_inv"]

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


def _fma(a, b, c):
    """a * b + c rounded once (f32: exact in float64, then rounded; f64:
    `_fma64`'s compensated sum); c a float or a tensor."""
    if a.dtype == torch.float64:
        p = a * b
        ah, al = _split27(a)
        bh, bl = _split27(b)
        err = ((ah * bh - p) + ah * bl + al * bh) + al * bl
        s = p + c
        bb = s - p
        return s + (((p - (s - bb)) + (c - bb)) + err)
    return (a.double() * b.double() + (c.double() if torch.is_tensor(c)
                                       else c)).to(a.dtype)


def _split27(x):
    t = x * 134217729.0             # 2^27 + 1
    hi = t - (t - x)
    return hi, x - hi


# XLA's log1p for |x| < sqrt(2) - 1: x - x^2 / 2 + x^3 * P(x) / Q(x)
# (Cephes), elemental_ir_emitter.cc EmitLog1p
_LOG1P_NUM = (4.5270000862445199635215E-5, 4.9854102823193375972212E-1,
              6.5787325942061044846969E0, 2.9911919328553073277375E1,
              6.0949667980987787057556E1, 5.7112963590585538103336E1,
              2.0039553499201281259648E1)
_LOG1P_DEN = (1., 1.5062909083469192043167E1, 8.3047565967967209469434E1,
              2.2176239823732856465394E2, 3.0909872225312059774938E2,
              2.1642788614495947685003E2, 6.0118660497603843919306E1)


def _horner(x, coeffs):
    r = torch.full_like(x, coeffs[0])
    for c in coeffs[1:]:
        r = _fma(r, x, c)
    return r


def _log1p_xla(x):
    x2 = x * x
    small = (x * x2) * (_horner(x, _LOG1P_NUM) / _horner(x, _LOG1P_DEN))
    small = x + _fma(torch.full_like(x, -0.5), x2, small)
    return torch.where(x.abs() < 0.41421356237309504880, small,
                       torch.log(x + 1.0))


# XLA's ErfInv (chlo_legalize_to_hlo.cc, materializeErfInvF32 / F64):
# Giles' polynomials in w = -log1p(-x^2)
_ERFINV32 = ((2.81022636e-08, 3.43273939e-07, -3.5233877e-06,
              -4.39150654e-06, 0.00021858087, -0.00125372503,
              -0.00417768164, 0.246640727, 1.50140941),
             (-0.000200214257, 0.000100950558, 0.00134934322,
              -0.00367342844, 0.00573950773, -0.0076224613,
              0.00943887047, 1.00167406, 2.83297682))
_ERFINV64_LT625 = (
    -3.6444120640178196996e-21, -1.685059138182016589e-19,
    1.2858480715256400167e-18, 1.115787767802518096e-17,
    -1.333171662854620906e-16, 2.0972767875968561637e-17,
    6.6376381343583238325e-15, -4.0545662729752068639e-14,
    -8.1519341976054721522e-14, 2.6335093153082322977e-12,
    -1.2975133253453532498e-11, -5.4154120542946279317e-11,
    1.051212273321532285e-09, -4.1126339803469836976e-09,
    -2.9070369957882005086e-08, 4.2347877827932403518e-07,
    -1.3654692000834678645e-06, -1.3882523362786468719e-05,
    0.0001867342080340571352, -0.00074070253416626697512,
    -0.0060336708714301490533, 0.24015818242558961693,
    1.6536545626831027356)
_ERFINV64_LT16 = (
    2.2137376921775787049e-09, 9.0756561938885390979e-08,
    -2.7517406297064545428e-07, 1.8239629214389227755e-08,
    1.5027403968909827627e-06, -4.013867526981545969e-06,
    2.9234449089955446044e-06, 1.2475304481671778723e-05,
    -4.7318229009055733981e-05, 6.8284851459573175448e-05,
    2.4031110387097893999e-05, -0.0003550375203628474796,
    0.00095328937973738049703, -0.0016882755560235047313,
    0.0024914420961078508066, -0.0037512085075692412107,
    0.005370914553590063617, 1.0052589676941592334,
    3.0838856104922207635)
_ERFINV64_GT16 = (
    -2.7109920616438573243e-11, -2.5556418169965252055e-10,
    1.5076572693500548083e-09, -3.7894654401267369937e-09,
    7.6157012080783393804e-09, -1.4960026627149240478e-08,
    2.9147953450901080826e-08, -6.7711997758452339498e-08,
    2.2900482228026654717e-07, -9.9298272942317002539e-07,
    4.5260625972231537039e-06, -1.9681778105531670567e-05,
    7.5995277030017761139e-05, -0.00021503011930044477347,
    -0.00013871931833623122026, 1.0103004648645343977,
    4.8499064014085844221)


def erf_inv(x: torch.Tensor) -> torch.Tensor:
    """XLA's `ErfInv` of a float tensor (f16 / bf16 through f32)."""
    if x.dtype not in (torch.float32, torch.float64):
        return erf_inv(x.float()).to(x.dtype)
    w = -_log1p_xla(x * -x)
    if x.dtype == torch.float32:
        lo, hi = _ERFINV32
        lt5 = w < 5.0
        w = torch.where(lt5, w - 2.5, torch.sqrt(w) - 3.0)
        p = torch.where(lt5, lo[0], hi[0]).to(x.dtype)
        for a, b in zip(lo[1:], hi[1:]):
            p = _fma(p, w, torch.where(lt5, a, b).to(x.dtype))
    else:
        a, b, c = _ERFINV64_LT625, _ERFINV64_LT16, _ERFINV64_GT16
        lt625, lt16 = w < 6.25, w < 16.0

        def coef(i):
            k = torch.full_like(x, a[i])
            if i < 19:
                k = torch.where(lt625, k, b[i])
            if i < 17:
                k = torch.where(lt16, k, c[i])
            return k
        w = torch.where(lt625, w - 3.125,
                        torch.sqrt(w) - torch.where(lt16, 3.25, 5.0))
        p = coef(0)
        for i in range(1, 17):
            p = _fma(p, w, coef(i))
        for i in range(17, 19):
            p = torch.where(lt16, _fma(p, w, coef(i)), p)
        for i in range(19, 23):
            p = torch.where(lt625, _fma(p, w, coef(i)), p)
    return torch.where(x.abs() == 1.0, torch.inf * x, p * x)


def normal(key, shape, dtype, device):
    """`jax.random.normal(key, shape, dtype)`: sqrt(2) * erf_inv(u) for u
    uniform in (-1, 1)."""
    np_t = {torch.float16: np.float16, torch.float32: np.float32,
            torch.float64: np.float64}.get(dtype)
    lo = float(np.nextafter(np_t(-1.0), np_t(0.0))) if np_t is not None \
        else float(torch.nextafter(torch.tensor(-1.0, dtype=dtype),
                                   torch.tensor(0.0, dtype=dtype)))
    u = uniform(key, shape, dtype, lo, 1.0, device)
    return torch.tensor(np.sqrt(2), dtype=dtype, device=device) \
        * erf_inv(u)


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
