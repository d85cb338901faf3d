"""Shared machinery of the op-surface parity tests
(`test_torch_ops_surface_*.py`): each manifest export that the port
resolves runs on the JAX package's harness recipe
(`paddle_tpu.testing.op_harness.SPEC`), with the same seeded numpy
inputs, on both packages (each its own copy of every buffer), and the
port's outputs are held to the JAX package's: float64 within 1e-10
relative, float32 within 1e-5 relative (1e-6 absolute), integers, bools
and seeded draws bit-equal. An export whose recipe has a numpy reference
is held to that reference instead, at the same tolerances (the JAX
package's forward costs ~0.1 s an op on the CPU; the reference is the
function JAX's own harness checks it against). A recipe that is a
bespoke check runs on both packages and must pass on both; an export
with no recipe takes the harness's first generic input strategy that
the JAX package accepts.
The port's own harness sweep (`paddle_tpu_torch.testing`) runs too,
held to per-namespace floors.
"""
import json
import os

import numpy as np
import pytest

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.testing import op_harness as JH

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MANIFEST = json.load(open(os.path.join(REPO, "OPS_PARITY.json")))

TOL64 = dict(rtol=1e-10, atol=1e-12)
TOL32 = dict(rtol=1e-5, atol=1e-6)

# exports that compute in float32 whatever their input's dtype: their
# float64 outputs are held to the float32 tolerance
F32_INSIDE = {
    "pairwise_distance": "the norm of the f32 difference (XLA's CPU sum "
                         "fuses the squares into FMAs, torch's rounds each)",
    "gumbel_softmax": "the Gumbel noise is a float32 draw and its float32 "
                      "-log(-log(u)) (one ulp apart in XLA's and torch's "
                      "log)",
}

# exports with a numpy reference that are held to the JAX package all
# the same, and why
JAX_HELD = {(ns, n): "the recipe's reference takes no keyword arguments"
            for ns in ("paddle", "Tensor") for n in ("cumsum", "cumprod")}

# exports the comparison leaves out, with the reason
NOT_COMPARED = {
    ("paddle", "grad"): "the tape: held to JAX by test_torch_autograd.py",
    ("paddle", "load"): "files: held to JAX by test_torch_io.py",
    ("paddle", "save"): "files: held to JAX by test_torch_io.py",
    ("paddle", "shape"): "the harness skips it (exercised everywhere)",
    ("Tensor", "shape"): "a property of Tensor in both packages",
}
# list-first functions as methods (self would be the whole list)
for _n in JH.SKIP_AS_METHOD:
    if hasattr(tpaddle.Tensor, _n):
        NOT_COMPARED[("Tensor", _n)] = "list-first: compared as paddle." + _n


def resolve(pkg, ns, name):
    path = MANIFEST["namespaces"][ns]["attr_path"]
    if path == "__tensor__":
        return name if hasattr(pkg.Tensor, name) else None
    obj = pkg
    for part in [p for p in path.split(".") if p]:
        obj = getattr(obj, part, None)
        if obj is None:
            return None
    return getattr(obj, name, None)


def exports(ns):
    """The namespace's manifest exports that the port resolves."""
    return [n for n in MANIFEST["namespaces"][ns]["exports"]
            if resolve(tpaddle, ns, n) is not None]


def spec_of(ns, name):
    spec = (JH.NS_SPEC.get((ns, name)) or JH.SPEC.get(name)
            or JH.NON_OP.get(name))
    if spec is None and name.endswith("_"):
        spec = JH.SPEC.get(name[:-1])
    return spec


def _port_spec(ns, name):
    """The port harness's recipe of the export (`spec_of`'s lookup)."""
    from paddle_tpu_torch.testing import op_harness as TH

    spec = (TH.NS_SPEC.get((ns, name)) or TH.SPEC.get(name)
            or TH.NON_OP.get(name))
    if spec is None and name.endswith("_"):
        spec = TH.SPEC.get(name[:-1])
    return spec


def _to_pkg(pkg, a):
    if isinstance(a, np.ndarray):
        return pkg.Tensor(np.array(a, copy=True))
    if isinstance(a, (list, tuple)) and a and isinstance(a[0], np.ndarray):
        return [pkg.Tensor(np.array(x, copy=True)) for x in a]
    return a


def _flat(pkg, out):
    res, stack = [], [out]
    while stack:
        o = stack.pop(0)
        if isinstance(o, (list, tuple)):
            stack[:0] = list(o)
        elif isinstance(o, pkg.Tensor):
            res.append(np.asarray(o.numpy()))
        elif isinstance(o, (bool, int, float, np.ndarray, np.generic)):
            res.append(np.asarray(o))
    return res


_GENERIC = [
    lambda rng: ([JH._f(rng)], {}),
    lambda rng: ([JH._f(rng), JH._f(rng)], {}),
    lambda rng: ([JH._i(rng)], {}),
    lambda rng: ([JH._i(rng), JH._i(rng)], {}),
    lambda rng: ([JH._b(rng), JH._b(rng)], {}),
    lambda rng: ([JH._mat(rng)], {}),
]


def _call(pkg, ns, name, spec, build):
    """The export on `build`'s inputs (or the class spec's) in `pkg`."""
    fn = resolve(pkg, ns, name)
    pkg.seed(11)
    rng = np.random.default_rng(0)
    if spec is not None and spec.get("cls"):
        layer = fn(*spec["ctor"], **spec["ckw"])
        layer.eval()
        raw = [JH._cast_f32(a) for a in spec["inp"](rng)]
        return layer(*[_to_pkg(pkg, a) for a in raw])
    args, kw = build(rng)
    a = [_to_pkg(pkg, x) for x in args]
    k = {kk: _to_pkg(pkg, v) for kk, v in kw.items()}
    if ns == "Tensor":
        return getattr(a[0], name)(*a[1:], **k)
    return fn(*a, **k)


def assert_close(want, got, label, f32_inside=False):
    assert len(want) == len(got), (label, len(want), len(got))
    for i, (w, g) in enumerate(zip(want, got)):
        assert (w.dtype, w.shape) == (g.dtype, g.shape), \
            (label, i, w.dtype, w.shape, g.dtype, g.shape)
        if w.dtype.kind in "fc":
            tol = TOL64 if w.dtype in (np.float64, np.complex128) \
                and not f32_inside else TOL32
            np.testing.assert_allclose(g, w, equal_nan=True,
                                       err_msg=f"{label}[{i}]", **tol)
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{label}[{i}]")


def by_reference(ns, name):
    """Whether the export is held to its recipe's numpy reference rather
    than to the JAX package: a recipe with a reference, for a function
    (not a class, a check or an in-place form)."""
    spec = spec_of(ns, name)
    return (spec is not None and spec.get("ref") is not None
            and "check" not in spec and not spec.get("cls")
            and spec is JH.SPEC.get(name) and (ns, name) not in JAX_HELD)


def _compare_to_reference(ns, name, spec):
    args, kw = spec["build"](np.random.default_rng(0))
    want = np.asarray(spec["ref"](*args, **kw))
    got = _flat(tpaddle, _call(tpaddle, ns, name, spec, spec["build"]))[0]
    if got.shape != want.shape:
        got = got.reshape(want.shape)
    label = f"{ns}:{name} (numpy reference)"
    if got.dtype.kind == "b" or want.dtype.kind == "b":
        np.testing.assert_array_equal(got, want, err_msg=label)
        return
    tol = TOL64 if got.dtype in (np.float64, np.complex128) \
        or got.dtype.kind in "iu" else TOL32
    np.testing.assert_allclose(got.astype(np.complex128 if got.dtype.kind
                                          == "c" else np.float64),
                               want, equal_nan=True, err_msg=label, **tol)


def compare(ns, name):
    """Run one export on both packages and hold the port to JAX, or to
    the recipe's numpy reference where it has one (`by_reference`)."""
    assert (ns, name) not in NOT_COMPARED
    spec = spec_of(ns, name)
    if by_reference(ns, name):
        _compare_to_reference(ns, name, spec)
        return
    if spec is not None and "check" in spec:
        # each package's own harness check: the JAX harness's checks read
        # `._data` as an array, which is a JAX internal
        assert spec["check"](jpaddle), name
        assert _port_spec(ns, name)["check"](tpaddle), name
        return
    if spec is not None:
        build = spec.get("build")
    else:
        # the first generic strategy the JAX package accepts
        for build in _GENERIC:
            try:
                _call(jpaddle, ns, name, None, build)
                break
            except Exception:
                continue
        else:
            raise AssertionError(f"{name}: no generic strategy runs on JAX")
    want = _flat(jpaddle, _call(jpaddle, ns, name, spec, build))
    got = _flat(tpaddle, _call(tpaddle, ns, name, spec, build))
    assert_close(want, got, f"{ns}:{name}", name in F32_INSIDE)


def compared(ns):
    return [n for n in exports(ns) if (ns, n) not in NOT_COMPARED]


def not_compared(ns):
    return sorted(n for n in exports(ns) if (ns, n) in NOT_COMPARED)


def port_sweep(namespaces):
    """The port's harness sweep on the CPU: {namespace: (ran, fwd_ref,
    vjp, failures)}."""
    from paddle_tpu_torch.testing import op_harness

    res = op_harness.sweep(tpaddle, MANIFEST, namespaces=namespaces,
                           device="cpu")
    out = {}
    for key, r in res.items():
        ns, _, name = key.partition(":")
        ran, ref, vjp, fails = out.get(ns, (0, 0, 0, []))
        if r.get("ran"):
            ran, ref, vjp = ran + 1, ref + bool(r["fwd_ref"]), \
                vjp + bool(r["vjp"])
        elif not r.get("skip") and r["error"] != "unresolved":
            fails = fails + [(name, r["error"])]
        out[ns] = (ran, ref, vjp, fails)
    return out


@pytest.fixture(autouse=True, scope="module")
def port_on_cpu():
    from paddle_tpu_torch.framework import place

    with place.device_scope("cpu"):
        yield


@pytest.fixture(autouse=True, scope="module")
def one_thread():
    """One intra-op thread: the ops here are tiny, and six test workers'
    default thread pools would oversubscribe the cores."""
    import torch

    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)
