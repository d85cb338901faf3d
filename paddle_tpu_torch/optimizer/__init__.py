"""Optimizers of the port (`paddle_tpu/optimizer`): Adam and AdamW."""
from .optimizer import Adam, AdamW, Optimizer

__all__ = ["Adam", "AdamW", "Optimizer"]
