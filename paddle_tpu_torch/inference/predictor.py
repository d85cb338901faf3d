"""Inference `Config` / `Predictor`: the port of
`paddle_tpu/inference/predictor.py`.

`create_predictor(Config(prog_file, params_file))` loads a `jit.save`d
program (`jit.load`) and runs it with handle-based IO: `copy_from_cpu`
puts numpy inputs on the predictor's device, `run()` calls the program,
`copy_to_cpu` reads an output back. The predictor runs on the CUDA card
unless `Config.disable_gpu()`, the CPU switch; its programs reach the
hand-written kernels (flash attention, RMSNorm) there, as the custom ops
they record launch on CUDA tensors. `Config.enable_profile()` is not
ported yet (the profiler, ROADMAP Queue A item 7).
"""
from __future__ import annotations

import os
from typing import Dict, List, Optional

import numpy as np
import torch

__all__ = ["Config", "Predictor", "create_predictor", "PredictorTensor",
           "PlaceType", "DataType", "get_version"]


def get_version() -> str:
    return f"paddle_tpu_torch-inference torch-{torch.__version__}"


class PlaceType:
    CPU = "cpu"
    GPU = "gpu"


class DataType:
    FLOAT32 = "float32"
    FLOAT16 = "float16"
    BFLOAT16 = "bfloat16"
    INT32 = "int32"
    INT64 = "int64"
    UINT8 = "uint8"
    INT8 = "int8"
    BOOL = "bool"


def _strip(prog_file):
    if prog_file is not None and prog_file.endswith(".pdmodel"):
        return prog_file[:-len(".pdmodel")]
    return prog_file


class Config:
    """`paddle.inference.Config` (AnalysisConfig). The pass-management
    switches are kept for the reference's surface and only recorded
    (`summary()`): the program runs as saved."""

    def __init__(self, prog_file: Optional[str] = None,
                 params_file: Optional[str] = None):
        self._model_path = _strip(prog_file)
        self._params_file = params_file
        self._device = "gpu"
        self._device_id = 0
        self._memory_optim = True
        self._ir_optim = True
        self._cpu_math_threads = 1

    # --- model path ---
    def set_model(self, prog_file: str, params_file: Optional[str] = None):
        self._model_path = _strip(prog_file)
        self._params_file = params_file

    def model_dir(self) -> Optional[str]:
        return os.path.dirname(self._model_path or "") or None

    def prog_file(self) -> Optional[str]:
        return self._model_path

    # --- device selection ---
    def enable_use_gpu(self, memory_pool_init_size_mb=100, device_id=0):
        self._device = "gpu"
        self._device_id = int(device_id)

    def disable_gpu(self):
        self._device = "cpu"

    def use_gpu(self) -> bool:
        return self._device != "cpu"

    def device(self) -> str:
        """The predictor's device: `cpu`, or `gpu:<id>`."""
        return "cpu" if self._device == "cpu" else f"gpu:{self._device_id}"

    # --- knobs kept for parity ---
    def enable_memory_optim(self, x=True):
        self._memory_optim = bool(x)

    def switch_ir_optim(self, x=True):
        self._ir_optim = bool(x)

    def set_cpu_math_library_num_threads(self, n: int):
        self._cpu_math_threads = int(n)

    def enable_profile(self):
        raise NotImplementedError(
            "Config.enable_profile: the profiler is not ported yet "
            "(ROADMAP Queue A item 7)")

    def disable_profile(self):
        pass

    def summary(self) -> Dict[str, object]:
        return dict(model=self._model_path, device=self.device(),
                    memory_optim=self._memory_optim, ir_optim=self._ir_optim,
                    cpu_math_threads=self._cpu_math_threads, profile=False)


class PredictorTensor:
    """An input or output handle (the reference's ZeroCopyTensor /
    `paddle_infer.Tensor`)."""

    def __init__(self, name: str, owner: "Predictor", is_input: bool):
        self.name = name
        self._owner = owner
        self._is_input = is_input

    def reshape(self, shape):
        # the program fixes every size but its dynamic ones: check rank
        self._owner._check_shape(self.name, list(shape))

    def copy_from_cpu(self, arr: np.ndarray):
        if not self._is_input:
            raise RuntimeError("copy_from_cpu on an output handle")
        self._owner._set_input(self.name, np.asarray(arr))

    def share_external_data(self, arr):
        self._owner._set_input(self.name, arr)

    def copy_to_cpu(self) -> np.ndarray:
        return self._owner._get_output(self.name).numpy()

    def shape(self) -> List[int]:
        return self._owner._handle_shape(self.name, self._is_input)

    def type(self):
        return self._owner._handle_dtype(self.name, self._is_input)


class Predictor:
    """Runs a `jit.save`d program with handle-based IO
    (`analysis_predictor.h:105` in the reference)."""

    def __init__(self, config: Config):
        from ..framework.place import device_scope
        from ..jit.save_load import load as jit_load

        if config.prog_file() is None:
            raise ValueError("Config has no model path")
        self.config = config
        with device_scope(config.device()):
            self._layer = jit_load(config.prog_file())
        self._avals = self._layer._meta["input_avals"]
        self._input_names = [f"x{i}" for i in range(len(self._avals))]
        self._inputs: Dict[str, object] = {}
        self._outputs: List[object] = []
        self._output_names: List[str] = []

    # --- reference API surface ---
    def get_input_names(self) -> List[str]:
        return list(self._input_names)

    def get_input_handle(self, name: str) -> PredictorTensor:
        if name not in self._input_names:
            raise KeyError(name)
        return PredictorTensor(name, self, is_input=True)

    def get_output_names(self) -> List[str]:
        if not self._output_names:
            return [f"out{i}" for i in range(max(1, len(self._outputs)))]
        return list(self._output_names)

    def get_output_handle(self, name: str) -> PredictorTensor:
        return PredictorTensor(name, self, is_input=False)

    def run(self, inputs: Optional[List[np.ndarray]] = None):
        """Run the program. With `inputs`, return the outputs: as Tensors
        on the predictor's device if every input is a Tensor (paddle's
        `run(list[Tensor])`), else as numpy arrays. Without, read the
        inputs set through the handles and return True."""
        from ..core.tensor import Tensor
        from ..framework.place import device_scope

        if inputs is not None:
            for n, a in zip(self._input_names, inputs):
                self._set_input(n, a)
        missing = [n for n in self._input_names if n not in self._inputs]
        if missing:
            raise RuntimeError(f"inputs not set: {missing}")
        dev = self.config.device()
        with device_scope(dev):
            out = self._layer(*[
                a.to(dev) if isinstance(a, Tensor) else Tensor(np.asarray(a))
                for a in (self._inputs[n] for n in self._input_names)])
        flat = out if isinstance(out, (list, tuple)) else [out]
        self._outputs = list(flat)
        self._output_names = [f"out{i}" for i in range(len(self._outputs))]
        if inputs is None:
            return True
        if all(isinstance(a, Tensor) for a in inputs):
            return list(self._outputs)
        return [o.numpy() for o in self._outputs]

    def try_shrink_memory(self):
        self._inputs.clear()
        self._outputs = []

    def clear_intermediate_tensor(self):
        pass

    # --- internals ---
    def _set_input(self, name, arr):
        self._inputs[name] = arr

    def _get_output(self, name):
        idx = self._output_names.index(name) if name in self._output_names \
            else int(name.replace("out", "") or 0)
        return self._outputs[idx]

    def _check_shape(self, name, shape):
        declared = self._avals[self._input_names.index(name)][0]
        if len(declared) != len(shape):
            raise ValueError(
                f"rank mismatch for {name}: program has {declared}")

    def _handle_shape(self, name, is_input):
        if is_input:
            dims = self._avals[self._input_names.index(name)][0]
            return [int(d) if str(d).isdigit() else -1 for d in dims]
        return list(self._get_output(name).shape)

    def _handle_dtype(self, name, is_input):
        if is_input:
            return self._avals[self._input_names.index(name)][1]
        return self._get_output(name).dtype.name


def create_predictor(config: Config) -> Predictor:
    """`paddle_infer.create_predictor`."""
    return Predictor(config)
