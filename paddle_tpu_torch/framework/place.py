"""Device identity: the port of `paddle_tpu/framework/place.py`.

A `Place` names a device type and index; `torch_device` is its
`torch.device`. The expected place (`set_device` / `get_device`) is where
tensor creation puts new tensors. Its default is the CUDA card: with no
card and no `set_device("cpu")`, creating a tensor raises instead of
falling back to the CPU.
"""
from __future__ import annotations

from contextlib import contextmanager

import torch

__all__ = ["Place", "CPUPlace", "CUDAPlace", "CUDAPinnedPlace", "set_device",
           "get_device", "device_scope", "expected_device",
           "is_compiled_with_cuda", "device_count"]


class Place:
    __slots__ = ("device_type", "device_id")

    def __init__(self, device_type: str, device_id: int = 0):
        self.device_type = device_type
        self.device_id = device_id

    def __repr__(self):
        return f"Place({self.device_type}:{self.device_id})"

    def __eq__(self, other):
        return (isinstance(other, Place)
                and self.device_type == other.device_type
                and self.device_id == other.device_id)

    def __hash__(self):
        return hash((self.device_type, self.device_id))

    def is_cpu_place(self):
        return self.device_type == "cpu"

    def is_gpu_place(self):
        return self.device_type == "gpu"

    @property
    def torch_device(self) -> torch.device:
        if self.device_type == "cpu":
            return torch.device("cpu")
        return torch.device("cuda", self.device_id)

    @staticmethod
    def of(device: torch.device) -> "Place":
        if device.type == "cpu":
            return Place("cpu", 0)
        return Place("gpu", device.index or 0)


class CPUPlace(Place):
    def __init__(self):
        super().__init__("cpu", 0)


class CUDAPlace(Place):
    def __init__(self, device_id: int = 0):
        super().__init__("gpu", device_id)


class CUDAPinnedPlace(Place):
    """Pinned host memory: the host side of a transfer."""

    def __init__(self):
        super().__init__("cpu", 0)


_expected_place = None


def set_device(device: str) -> Place:
    """`"cpu"`, or `"gpu"` / `"cuda"` with an optional `:index`."""
    global _expected_place
    kind, _, idx = str(device).partition(":")
    if kind in ("gpu", "cuda"):
        _expected_place = Place("gpu", int(idx or 0))
    elif kind == "cpu":
        _expected_place = Place("cpu", 0)
    else:
        raise ValueError(f"set_device: unknown device {device!r}; use "
                         f"'cpu' or 'gpu[:index]'")
    return _expected_place


@contextmanager
def device_scope(device=None):
    """The expected place is `device` (`set_device`'s argument; None: the
    default, the card) inside the block, and the caller's again after
    it."""
    global _expected_place
    prev = _expected_place
    try:
        if device is None:
            _expected_place = None
        else:
            set_device(device)
        yield
    finally:
        _expected_place = prev


def _get_expected_place() -> Place:
    return _expected_place if _expected_place is not None else Place("gpu")


def get_device() -> str:
    p = _get_expected_place()
    return f"{p.device_type}:{p.device_id}"


def expected_device(place=None) -> torch.device:
    """The `torch.device` new tensors go to: `place` (a `Place`, string or
    `torch.device`) if given, else the expected place. A CUDA device with
    no card raises."""
    if place is None:
        place = _get_expected_place()
    elif isinstance(place, str):
        kind, _, idx = place.partition(":")
        place = Place("gpu" if kind in ("gpu", "cuda") else kind,
                      int(idx or 0))
    elif isinstance(place, torch.device):
        place = Place.of(place)
    dev = place.torch_device
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "no CUDA device is available; call "
            "paddle_tpu_torch.set_device('cpu') to create tensors on the "
            "CPU")
    return dev


def is_compiled_with_cuda() -> bool:
    return torch.cuda.is_available()


def device_count() -> int:
    return torch.cuda.device_count()
