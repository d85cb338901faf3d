"""Fault injection for the port's serving path (`faults`)."""
from . import faults

__all__ = ["faults"]
