"""The eager framework core: `Tensor` (`core/tensor.py`), op dispatch
(`core/dispatch.py`), the autograd API over torch autograd
(`core/autograd.py`) and lazy eager mode (`core/lazy.py`: `sync`,
`lazy_guard`, `set_lazy_mode`, `is_lazy_enabled`, `pending_ops`)."""
from . import autograd, dispatch, lazy
from .lazy import (LazyArray, is_lazy_enabled, lazy_guard, pending_ops,
                   set_lazy_mode, sync)

__all__ = ["autograd", "dispatch", "lazy", "LazyArray", "is_lazy_enabled",
           "lazy_guard", "pending_ops", "set_lazy_mode", "sync"]
