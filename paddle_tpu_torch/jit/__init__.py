"""`paddle.jit` of the port: `functional_call`, `to_static` (whole-program
capture by `torch.export`), and `save` / `load` of the captured
program."""
from .functional import buffer_arrays, functional_call, state_arrays
from .save_load import ProgramFormatError, TranslatedLayer, load, save
from .to_static import (InputSpec, StaticFunction, ignore_module,
                        not_to_static, to_static)

__all__ = ["buffer_arrays", "functional_call", "state_arrays",
           "ProgramFormatError", "TranslatedLayer", "load", "save",
           "InputSpec", "StaticFunction", "ignore_module", "not_to_static",
           "to_static"]
