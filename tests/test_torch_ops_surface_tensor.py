"""Op-surface parity of the `Tensor` methods: every export the port
resolves, on the JAX harness recipe's seeded inputs, held to the JAX
package (`torch_ops_surface_common.py`), and the port's own harness sweep
held to the floors this port reaches."""
import pytest

from torch_ops_surface_common import (NOT_COMPARED, compare, compared,
                                      not_compared, port_sweep)
from torch_ops_surface_common import one_thread, port_on_cpu  # noqa: F401

NAMESPACES = ['Tensor']
# exports each namespace resolves at least
TARGETS = {'Tensor': 380}
# (ran, matched the recipe's numpy reference, finite-difference verified)
FLOORS = {'Tensor': (371, 166, 130)}

CASES = sum([
    [("Tensor", n) for n in compared("Tensor")]], [])


@pytest.mark.parametrize("ns,name", CASES,
                         ids=[f"{ns}:{n}" for ns, n in CASES])
def test_export_matches_jax(ns, name):
    compare(ns, name)


def test_uncompared_exports_are_listed():
    """Every resolved export is compared or listed with its reason, no
    listed one is stale, and the compared counts reach the slice's
    targets."""
    for ns in NAMESPACES:
        for n in not_compared(ns):
            assert NOT_COMPARED[(ns, n)]
        assert {n for (s, n) in NOT_COMPARED if s == ns} \
            == set(not_compared(ns))
        assert len(compared(ns)) + len(not_compared(ns)) >= TARGETS[ns]


def test_port_harness_sweep_floors():
    res = port_sweep(NAMESPACES)
    for ns, floor in FLOORS.items():
        ran, ref, vjp, fails = res[ns]
        assert not fails, (ns, fails)
        assert ran >= floor[0] and ref >= floor[1] and vjp >= floor[2], \
            (ns, (ran, ref, vjp), floor)
