"""The port's op-level test harness (`op_harness`): the JAX package's
recipes, numpy references and finite-difference check, without jax."""
from .op_harness import run_export, sweep  # noqa: F401
