"""Device resolution, the build of the port's CUDA kernels, and their
launch counters — the counterpart of `paddle_tpu/ops/pallas/_support.py`.

Kernels are CUDA C++ sources under `paddle_tpu_torch/csrc/` with a plain C
entry point. `nvcc` compiles each one for `sm_90a` into a shared library
under `build/paddle_tpu_torch/` at the repository root the first time a
wrapper launches it, and the library is loaded with `ctypes`. Nothing here
needs `nvcc` or a card at import time: the CPU tests import every module,
and a wrapper given CPU tensors runs its plain PyTorch version instead.

Launch accounting under CUDA graphs: a replayed graph runs no Python, so
no wrapper counts its launches. While a `LaunchRecord` is recording (a
graph's capture) every `LaunchCounter.add` is noted against the record
instead of counted, and `LaunchRecord.replayed()` adds the noted counts
each time the graph is replayed; `launches_discarded()` drops the adds of
a warm-up run. So a region captured once and replayed N times counts the
launches of N eager runs. Both are host mechanisms: the record is global
(the autograd engine launches a capture's backward kernels from its own
thread) and needs no card.
"""
from __future__ import annotations

import contextlib
import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path
from typing import Dict, Iterable, Optional

import torch

__all__ = ["resolve_device", "launch_counter", "reset_launch_counts",
           "LaunchRecord", "launches_discarded",
           "KernelNotDifferentiableError",
           "build", "load_library", "sm_count", "CSRC_DIR", "BUILD_DIR"]

CSRC_DIR = Path(__file__).resolve().parents[2] / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "paddle_tpu_torch"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v")


def resolve_device(device=None) -> torch.device:
    """`None` means the CUDA card; with no card that raises instead of
    falling back, so a run never lands on the CPU unasked. Pass
    `device="cpu"` to run the plain PyTorch path."""
    if device is None:
        if not torch.cuda.is_available():
            raise RuntimeError(
                "no CUDA device is available; pass device='cpu' to run "
                "the plain PyTorch path")
        return torch.device("cuda")
    return torch.device(device)


class LaunchCounter:
    """The count of one kernel's launches. `add()` takes a lock, so
    wrappers called from several threads at once (a fleet router stepping
    its replicas in parallel) lose no increment."""

    __slots__ = ("name", "count", "_lock")

    def __init__(self, name: str):
        self.name = name
        self.count = 0
        self._lock = threading.Lock()

    def add(self, n: int = 1) -> None:
        rec = _RECORDING
        if rec is not None:
            rec.note(self.name, n)
            return
        with self._lock:
            self.count += n


_COUNTERS: Dict[str, LaunchCounter] = {}


def launch_counter(name: str) -> LaunchCounter:
    c = _COUNTERS.get(name)
    if c is None:
        c = _COUNTERS[name] = LaunchCounter(name)
    return c


def reset_launch_counts() -> None:
    for c in _COUNTERS.values():
        c.count = 0


# the record the counters' adds go to while a graph is captured, else None
_RECORDING: Optional["LaunchRecord"] = None


class LaunchRecord:
    """The kernel launches one replay of a captured graph makes:
    `{counter name: launches}`, noted while `recording()`, added to the
    counters by `replayed()`. With `discard=True` the notes are dropped
    (a warm-up run whose work is thrown away)."""

    def __init__(self, discard: bool = False):
        self.counts: Dict[str, int] = {}
        self._discard = discard
        self._lock = threading.Lock()

    def note(self, name: str, n: int) -> None:
        if not self._discard:
            with self._lock:
                self.counts[name] = self.counts.get(name, 0) + n

    @contextlib.contextmanager
    def recording(self):
        global _RECORDING
        prev, _RECORDING = _RECORDING, self
        try:
            yield self
        finally:
            _RECORDING = prev

    def replayed(self) -> None:
        for name, n in self.counts.items():
            launch_counter(name).add(n)


def launches_discarded():
    """A context in which no launch is counted (a capture's warm-up)."""
    return LaunchRecord(discard=True).recording()


class KernelNotDifferentiableError(RuntimeError):
    """A higher-order gradient asked through a kernel whose backward is
    itself a kernel with no derivative (`create_graph=True` reaching it on
    a CUDA tensor), as a Pallas call with no JVP rule refuses to be
    differentiated in the JAX package. Raised instead of returning a
    gradient detached from the graph."""

    def __init__(self, kernels: str):
        super().__init__(
            f"{kernels}: a second derivative through the hand-written "
            f"kernels is not defined (their backward is a kernel with no "
            f"derivative); compute it on CPU tensors, which run the "
            f"differentiable plain version")
        self.kernels = kernels


def _nvcc() -> str:
    cands = []
    for env in ("CUDA_HOME", "CUDA_PATH"):
        if os.environ.get(env):
            cands.append(Path(os.environ[env]) / "bin" / "nvcc")
    cands.append(Path("/usr/local/cuda/bin/nvcc"))
    for c in cands:
        if c.is_file():
            return str(c)
    found = shutil.which("nvcc")
    if found is None:
        raise RuntimeError("nvcc not found (set CUDA_HOME): the CUDA "
                           "kernels are built from source at first use")
    return found


def _lib_path(src: Path) -> Path:
    # the shared headers (`csrc/*.cuh`) are part of every source's key
    headers = b"".join(p.read_bytes()
                       for p in sorted(src.parent.glob("*.cuh")))
    h = hashlib.sha256(src.read_bytes() + headers
                       + " ".join(NVCC_FLAGS).encode())
    return BUILD_DIR / f"lib{src.stem}_{h.hexdigest()[:12]}.so"


_BUILD_LOCK = threading.Lock()


def build(sources: Optional[Iterable[Path]] = None) -> Dict[str, dict]:
    """Compile every source (default: all of `csrc/*.cu`), one `nvcc`
    process per source, all started together. A library whose source
    and flags are unchanged is reused. Returns `{stem: {"path", "log",
    "built"}}`, with nvcc's output (`-Xptxas -v`: registers, shared
    memory, spills) in `log`, kept beside the library for a reused one;
    raises on any failed compile."""
    srcs = sorted(CSRC_DIR.glob("*.cu")) if sources is None \
        else [Path(s) for s in sources]
    out: Dict[str, dict] = {}
    with _BUILD_LOCK:
        BUILD_DIR.mkdir(parents=True, exist_ok=True)
        procs = []
        for src in srcs:
            lib = _lib_path(src)
            if lib.is_file():
                log = lib.with_suffix(".log")
                out[src.stem] = {"path": lib, "built": False,
                                 "log": log.read_text() if log.is_file()
                                 else ""}
                continue
            tmp = lib.with_suffix(f".{os.getpid()}.tmp")
            cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(src)]
            procs.append((src, lib, tmp, subprocess.Popen(
                cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
                text=True)))
        failed = []
        for src, lib, tmp, p in procs:
            log, _ = p.communicate()
            if p.returncode != 0:
                failed.append(f"{src.name}:\n{log}")
                continue
            lib.with_suffix(".log").write_text(log)
            os.replace(tmp, lib)
            out[src.stem] = {"path": lib, "log": log, "built": True}
        if failed:
            raise RuntimeError("nvcc failed:\n" + "\n".join(failed))
    return out


@functools.lru_cache(maxsize=None)
def load_library(stem: str) -> ctypes.CDLL:
    """Build (if needed) and load `csrc/<stem>.cu`'s shared library."""
    info = build([CSRC_DIR / f"{stem}.cu"])[stem]
    return ctypes.CDLL(str(info["path"]))


@functools.lru_cache(maxsize=None)
def sm_count(index: int) -> int:
    """The SMs of CUDA device `index` (the kernels' launch plans take it)."""
    return torch.cuda.get_device_properties(index).multi_processor_count
