"""Optimizers of the port (`paddle_tpu/optimizer`): SGD, Momentum, Adam
and AdamW."""
from .optimizer import SGD, Adam, AdamW, Momentum, Optimizer

__all__ = ["SGD", "Momentum", "Adam", "AdamW", "Optimizer"]
