"""The eager framework core: `Tensor` (`core/tensor.py`), op dispatch
(`core/dispatch.py`) and the autograd API over torch autograd
(`core/autograd.py`)."""
