"""Optimizers of the port (`paddle_tpu/optimizer`): SGD, Momentum,
Adagrad, Adadelta, RMSProp, Adam, AdamW, Adamax, Lamb, NAdam, RAdam and
LBFGS, and the learning-rate schedulers (`optimizer.lr`)."""
from . import lr
from .optimizer import (LBFGS, SGD, Adadelta, Adagrad, Adam, Adamax, AdamW,
                        Lamb, Momentum, NAdam, Optimizer, RAdam, RMSProp)

__all__ = ["lr", "SGD", "Momentum", "Adagrad", "Adadelta", "RMSProp", "Adam",
           "AdamW", "Adamax", "Lamb", "NAdam", "RAdam", "LBFGS", "Optimizer"]
