"""Regularizers (`paddle.regularizer`): the port's copy of
`paddle_tpu/regularizer.py`, coefficient carriers the optimizers read
(`L2Decay` adds `coeff * w` to the gradient, `L1Decay` adds
`coeff * sign(w)`)."""
from __future__ import annotations

__all__ = ["L1Decay", "L2Decay"]


class L2Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"L2Decay({self._coeff})"


class L1Decay:
    def __init__(self, coeff=0.0):
        self._coeff = float(coeff)

    @property
    def coeff(self):
        return self._coeff

    def __repr__(self):
        return f"L1Decay({self._coeff})"
