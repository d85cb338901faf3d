"""Rotating, verified, fault-tolerant checkpoints: the port of
`paddle_tpu/resilience/checkpoint_manager.py`, over the port's
`distributed/checkpoint/` (the JAX package's files: a directory either
package writes, the other restores).

- **Step directories** `<root>/step_000123/` hold the shard files, an
  `extra_state.json` (step, the `(seed, counter)` RNG state, optimizer
  scalars, `GradScaler` state, extras) and a `COMPLETE` manifest written
  atomically last: every file's size and crc32, so a directory without
  it, or whose bytes disagree with it, is torn.
- **Retention**: `keep_last_n` rolling checkpoints plus `keep_every_k`
  milestones.
- **Verified resume**: `latest_valid` walks the step directories newest
  first, renames one that fails verification `QUARANTINED-<name>` and
  returns the newest that passes.
- **Async saves**: the snapshot is a finished host copy before `save`
  returns (the optimizers write parameters and moments in place); the
  writer's failure re-raises as `AsyncSaveError` at the next `save` or
  `wait`; transient I/O failures inside a write are retried by
  `framework/retry.py`.
- `emergency_save` never rewrites a step that already verifies (a
  SIGKILL in the middle would destroy the newest good checkpoint).
- Monitor counters `resilience.saves`, `.retries`, `.quarantines`,
  `.emergency_saves`.

The multi-process barrier around a write is `torch.distributed.barrier()`
when a process group is initialised, else nothing. `load` /
`restore_latest` with `placements=` re-place the destination templates
first (each named key takes a `DistMeta`, or `(mesh, placements)`), so
a checkpoint saved at world N restores at world M: the loader re-slices
the saved shards onto the new placements.

Layout::

    <root>/
      step_000010/
        0.metadata          sharded-tensor index
        <rank>_0.distcp     safetensors shard files, per-tensor crc32
        extra_state.json    step / rng / optimizer scalars / scaler / extras
        COMPLETE            {"step": N, "files": {name: {size, crc32}}}
      QUARANTINED-step_000011/
"""
from __future__ import annotations

import json
import os
import re
import shutil
import time
import zlib
from types import SimpleNamespace
from typing import Callable, Dict, Optional

import numpy as np
import torch

from ..core.tensor import Tensor
from ..distributed.auto_parallel import sharding_bridge as sb
from ..distributed.checkpoint import CheckpointCorrupt, load_state_dict
from ..distributed.checkpoint.errors import AsyncSaveError
from ..distributed.checkpoint.load_state_dict import _read_metadata
from ..distributed.checkpoint.save_state_dict import (_rank, _SaveThread,
                                                      snapshot_state_dict,
                                                      write_snapshot)
from ..framework import dtype as dtype_mod
from ..framework import monitor
from ..framework.random import get_rng_state, set_rng_state
from ..framework.retry import retry_call
from . import faults

__all__ = ["CheckpointManager"]

STEP_DIR_RE = re.compile(r"^step_(\d{6,})$")
QUARANTINE_PREFIX = "QUARANTINED-"
_MODEL = "model."
_OPT = "opt."


def _step_dirname(step: int) -> str:
    return f"step_{step:06d}"


def _file_crc32(path: str) -> int:
    crc = 0
    with open(path, "rb") as f:
        for chunk in iter(lambda: f.read(1 << 20), b""):
            crc = zlib.crc32(chunk, crc)
    return crc


def _distributed() -> bool:
    return torch.distributed.is_available() and \
        torch.distributed.is_initialized()


class CheckpointManager:
    def __init__(self, root: str, keep_last_n: int = 3,
                 keep_every_k: Optional[int] = None,
                 async_save: bool = False,
                 retries: int = 2, retry_base_delay: float = 0.05,
                 retry_max_delay: float = 1.0,
                 retry_deadline: Optional[float] = 30.0,
                 sleep: Callable[[float], None] = time.sleep):
        if keep_last_n < 1:
            raise ValueError("keep_last_n must be >= 1")
        if keep_every_k is not None and keep_every_k < 1:
            raise ValueError("keep_every_k must be >= 1 (or None)")
        self.root = os.path.abspath(root)
        self.keep_last_n = int(keep_last_n)
        self.keep_every_k = keep_every_k
        self.async_save = bool(async_save)
        self._retry_kw = dict(retries=retries, base_delay=retry_base_delay,
                              max_delay=retry_max_delay,
                              deadline=retry_deadline, sleep=sleep,
                              monitor_name="resilience.retries")
        self._pending: Optional[_SaveThread] = None
        self._deferred_error: Optional[AsyncSaveError] = None
        os.makedirs(self.root, exist_ok=True)

    # -- save ---------------------------------------------------------------
    def save(self, step: int, model=None, optimizer=None, scaler=None,
             extras: Optional[dict] = None, state_dict: Optional[dict] = None,
             async_save: Optional[bool] = None) -> str:
        """Write checkpoint `step`; returns its directory. A failure of a
        previous async save re-raises here first."""
        self._join_pending()
        snap, extra = self._snapshot(step, model, optimizer, scaler, extras,
                                     state_dict)
        path = os.path.join(self.root, _step_dirname(step))
        use_async = self.async_save if async_save is None else async_save
        if use_async:
            self._pending = _SaveThread(
                lambda: self._write(path, step, snap, extra))
            self._pending.start()
        else:
            self._write(path, step, snap, extra)
        return path

    def emergency_save(self, step: int, model=None, optimizer=None,
                       scaler=None, extras: Optional[dict] = None,
                       state_dict: Optional[dict] = None) -> str:
        """One synchronous save with no retries, on the way down. A step
        that already verifies (existence and sizes) is left as it is."""
        self._join_pending(swallow=True)
        path = os.path.join(self.root, _step_dirname(step))
        try:
            self._verify_dir(path, crc=False)
        except CheckpointCorrupt:
            snap, extra = self._snapshot(step, model, optimizer, scaler,
                                         extras, state_dict)
            self._write(path, step, snap, extra, retries=0)
        monitor.inc("resilience.emergency_saves")
        return path

    def wait(self) -> None:
        """Block until a pending async save lands; re-raise its failure."""
        self._join_pending()

    def _join_pending(self, swallow: bool = False) -> None:
        """Join the pending writer; its failure raises here, or with
        `swallow` is deferred to the next save / wait."""
        th, self._pending = self._pending, None
        if th is not None:
            th.join()
            if th.error is not None:
                err = th.error if isinstance(th.error, AsyncSaveError) \
                    else AsyncSaveError(self.root, th.error)
                if swallow:
                    self._deferred_error = err
                else:
                    raise err
        if not swallow and self._deferred_error is not None:
            err, self._deferred_error = self._deferred_error, None
            raise err

    def _snapshot(self, step, model, optimizer, scaler, extras, state_dict):
        """Everything to save, copied to the host on the caller's
        thread."""
        flat: Dict[str, object] = {}
        src = state_dict if state_dict is not None else (
            model.state_dict() if model is not None else {})
        for k, t in src.items():
            flat[_MODEL + k] = t
        opt_scalars = {}
        if optimizer is not None:
            for k, v in optimizer.state_dict().items():
                if isinstance(v, (Tensor, torch.Tensor)):
                    flat[_OPT + k] = v
                else:  # global_step, the scheduler's dict: JSON
                    opt_scalars[k] = v
        extra = {
            "step": int(step),
            "rng": [list(s) for s in get_rng_state()],
            "opt_scalars": opt_scalars,
            "scaler": self._scaler_state(scaler),
            "extras": extras or {},
        }
        return snapshot_state_dict(flat), extra

    @staticmethod
    def _scaler_state(scaler) -> Optional[dict]:
        if scaler is None:
            return None
        st = dict(scaler.state_dict())
        if "scale" in st:
            st["scale"] = float(np.asarray(st["scale"]))
        return st

    def _write(self, path: str, step: int, snap, extra: dict,
               retries: Optional[int] = None) -> None:
        coord = _rank() == 0
        if coord and os.path.isdir(path):  # a torn earlier attempt
            shutil.rmtree(path)
        self._barrier()
        os.makedirs(path, exist_ok=True)

        def attempt():
            faults.check("ckpt.write")
            write_snapshot(snap, path)
            if coord:
                tmp = os.path.join(path, "extra_state.json.tmp")
                with open(tmp, "w") as f:
                    json.dump(extra, f)
                os.replace(tmp, os.path.join(path, "extra_state.json"))

        kw = dict(self._retry_kw)
        if retries is not None:
            kw["retries"] = retries
        retry_call(attempt, **kw)
        self._barrier()     # every rank's shards on disk before COMPLETE
        if not coord:
            return
        faults.check("ckpt.complete")
        manifest = {"step": step, "files": {}}
        for name in sorted(os.listdir(path)):
            fp = os.path.join(path, name)
            manifest["files"][name] = {"size": os.path.getsize(fp),
                                       "crc32": _file_crc32(fp)}
        tmp = os.path.join(path, "COMPLETE.tmp")
        with open(tmp, "w") as f:
            json.dump(manifest, f)
        os.replace(tmp, os.path.join(path, "COMPLETE"))
        monitor.inc("resilience.saves")
        self._apply_retention()

    @staticmethod
    def _barrier() -> None:
        """All ranks of an initialised process group meet; else nothing."""
        if _distributed():
            torch.distributed.barrier()

    # -- retention ----------------------------------------------------------
    def _complete_steps(self):
        """[(step, dirname)] of COMPLETE checkpoints, ascending."""
        out = []
        for name in os.listdir(self.root):
            m = STEP_DIR_RE.match(name)
            if m and os.path.exists(os.path.join(self.root, name,
                                                 "COMPLETE")):
                out.append((int(m.group(1)), name))
        return sorted(out)

    def _apply_retention(self) -> None:
        steps = self._complete_steps()
        keep = {name for _, name in steps[-self.keep_last_n:]}
        if self.keep_every_k:
            keep |= {name for s, name in steps
                     if s % self.keep_every_k == 0}
        for _, name in steps:
            if name not in keep:
                shutil.rmtree(os.path.join(self.root, name),
                              ignore_errors=True)

    # -- verified resume ----------------------------------------------------
    def _verify_dir(self, path: str, crc: bool = True) -> None:
        """Raise CheckpointCorrupt unless `path` matches its COMPLETE
        manifest (existence, size and, with `crc`, crc32 of every file)."""
        marker = os.path.join(path, "COMPLETE")
        if not os.path.exists(marker):
            raise CheckpointCorrupt(path, "no COMPLETE marker (torn save)",
                                    file="COMPLETE")
        try:
            with open(marker) as f:
                manifest = json.load(f)
        except (ValueError, OSError) as exc:
            raise CheckpointCorrupt(path, f"unreadable COMPLETE: {exc}",
                                    file="COMPLETE")
        if "0.metadata" not in manifest.get("files", {}):
            raise CheckpointCorrupt(path, "COMPLETE manifest lacks the "
                                    "0.metadata index", file="0.metadata")
        for name, want in manifest.get("files", {}).items():
            fp = os.path.join(path, name)
            if not os.path.exists(fp):
                raise CheckpointCorrupt(path, "file in COMPLETE manifest "
                                        "is missing", file=name)
            if os.path.getsize(fp) != want["size"]:
                raise CheckpointCorrupt(
                    path, f"size mismatch ({os.path.getsize(fp)} != "
                    f"{want['size']})", file=name)
            if crc and _file_crc32(fp) != want["crc32"]:
                raise CheckpointCorrupt(path, "crc32 mismatch", file=name)

    def _quarantine(self, name: str) -> None:
        src = os.path.join(self.root, name)
        dst = os.path.join(self.root, QUARANTINE_PREFIX + name)
        n = 0
        while os.path.exists(dst):
            n += 1
            dst = os.path.join(self.root, f"{QUARANTINE_PREFIX}{name}.{n}")
        os.rename(src, dst)
        monitor.inc("resilience.quarantines")

    def latest_valid(self):
        """`(step, path)` of the newest checkpoint that passes full
        verification, or None; failures are quarantined on the way."""
        self._join_pending(swallow=True)
        names = sorted((name for name in os.listdir(self.root)
                        if STEP_DIR_RE.match(name)), reverse=True)
        for name in names:
            path = os.path.join(self.root, name)
            try:
                self._verify_dir(path)
            except CheckpointCorrupt:
                self._quarantine(name)
                continue
            return int(STEP_DIR_RE.match(name).group(1)), path
        return None

    # -- load ---------------------------------------------------------------
    def load(self, path: str, model=None, optimizer=None, scaler=None,
             state_dict: Optional[dict] = None,
             placements: Optional[Dict[str, object]] = None
             ) -> SimpleNamespace:
        """Restore `path` into the given objects in place (parameters and
        buffers, the optimizer's accumulators and scalars, the scaler and
        the RNG state); returns `SimpleNamespace(step, extras)`.

        `placements` is the world-shape-aware path: a dict from the
        caller's state keys (no ``model.`` prefix) to target placements
        (`DistMeta`, or `(mesh, placements)`). Each named destination
        takes its placements before the load, which then copies into
        every shard of the new world only its overlap with the saved
        shards."""
        self._join_pending(swallow=True)
        with open(os.path.join(path, "extra_state.json")) as f:
            extra = json.load(f)
        src = state_dict if state_dict is not None else (
            model.state_dict() if model is not None else {})
        if placements:
            self._apply_placements(src, placements)
        dest: Dict[str, object] = {_MODEL + k: t for k, t in src.items()}
        meta = _read_metadata(path)
        opt_keys = [k for k in meta.state_dict_metadata
                    if k.startswith(_OPT)]
        if optimizer is not None:
            # a fresh optimizer has no accumulators yet: the checkpoint's
            # own index gives their shapes and dtypes
            for k in opt_keys:
                m = meta.state_dict_metadata[k][0]
                dest[k] = torch.zeros(
                    m.global_shape or m.local_shape,
                    dtype=dtype_mod.convert_dtype(m.dtype).torch_dtype)
        load_state_dict(dest, path)
        if optimizer is not None:
            opt_sd = {k[len(_OPT):]: dest[k] for k in opt_keys}
            if opt_sd:
                names = {optimizer._name_of(p) for p in optimizer._params}
                if not any(k.startswith(n) for k in opt_sd for n in names):
                    raise RuntimeError(
                        "checkpoint optimizer state matches none of this "
                        "optimizer's parameter names — the model must be "
                        "constructed identically (same order, fresh "
                        "process) for accumulator names to line up")
            opt_sd.update(extra.get("opt_scalars", {}))
            optimizer.set_state_dict(opt_sd)
        if scaler is not None and extra.get("scaler"):
            scaler.load_state_dict(extra["scaler"])
        if extra.get("rng"):
            set_rng_state([tuple(s) for s in extra["rng"]])
        return SimpleNamespace(step=int(extra["step"]),
                               extras=extra.get("extras", {}))

    @staticmethod
    def _apply_placements(src: Dict[str, object],
                          placements: Dict[str, object]) -> None:
        """Give destination templates their target placements before the
        load assembles bytes: `load_state_dict` re-slices onto whatever
        placements a destination carries, so placing the template is
        choosing the restored world shape. Unknown keys are an error: a
        typo here would silently restore the old layout."""
        missing = [k for k in placements if k not in src]
        if missing:
            raise KeyError(f"placements name keys absent from the state "
                           f"dict: {missing}")
        for k, target in placements.items():
            if target is not None and not isinstance(target, sb.DistMeta):
                target = sb.DistMeta(*target)
            sb.set_meta(src[k], target)

    def restore_latest(self, model=None, optimizer=None, scaler=None,
                       state_dict: Optional[dict] = None,
                       placements: Optional[Dict[str, object]] = None):
        """`latest_valid()` and `load()`; None when nothing is valid."""
        found = self.latest_valid()
        if found is None:
            return None
        return self.load(found[1], model=model, optimizer=optimizer,
                         scaler=scaler, state_dict=state_dict,
                         placements=placements)
