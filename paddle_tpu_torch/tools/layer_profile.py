"""Where a fused decoder layer's time goes, on the card.

Runs `layer_workload`'s Llama-2-7B-width decoder layer (bf16, batch
4 x 2048) in its three runs — built from `incubate.nn.functional` with
`swiglu(gate, up)` ("two") or `swiglu(gate_up)` ("packed"), and the
model's `LlamaDecoderLayer` ("llama_layer") on the same weights — and
prints one JSON line: for each run, one forward + backward's wall time
from CUDA events outside the profiler (median of 5), and under
`torch.profiler` over two more: device time by class (the port's RoPE,
bias + activation, SwiGLU, flash and RMSNorm kernels, the cuBLAS matrix
products, everything else) and its top kernels, the device's busy
share, and kernels per forward + backward.

    python -m paddle_tpu_torch.tools.layer_profile [--out layer_profile.json]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from .layer_workload import RUNS, LayerWorkload
from .serve_profile import _busy_ms

PROFILED = 2

_CLASSES = (("fused_rope", ("rope_kernel",)),
            ("bias_act / swiglu", ("bias_act_kernel",)),
            ("flash_attention", ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                                 "dkv_wgmma_kernel")),
            ("rms_norm", ("rms_norm_kernel", "rms_norm_regs_kernel")),
            ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")))


def _class_of(name: str) -> str:
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def _profile(work, run):
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED):
            work.step(run)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3
    by_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_kernel[ev.name][1] += 1
            intervals.append((ev.time_range.start, ev.time_range.end))
    dev_total = sum(v[0] for v in by_kernel.values())
    by_class = defaultdict(lambda: [0.0, 0])
    for name, (ms, calls) in by_kernel.items():
        c = by_class[_class_of(name)]
        c[0] += ms / PROFILED
        c[1] += calls / PROFILED
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:12]
    busy = _busy_ms(intervals)
    return {
        "profiled_window_ms": window,
        "device_busy_ms": busy / PROFILED,
        "device_busy_share": busy / window,
        "device_kernel_ms": dev_total / PROFILED,
        "device_kernels": sum(v[1] for v in by_kernel.values()) / PROFILED,
        "by_class": {k: {"ms": v[0], "calls": v[1],
                         "share_of_device": v[0] * PROFILED / dev_total}
                     for k, v in sorted(by_class.items())},
        "top_kernels": [{"name": nm[:90], "ms": v[0] / PROFILED,
                         "calls": v[1] / PROFILED} for nm, v in top]}


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("layer_profile needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    work = LayerWorkload()
    times = {run: [] for run in RUNS}
    for run in RUNS:
        work.step(run)                                  # warm-up
    for _ in range(5):
        for run in RUNS:
            start = torch.cuda.Event(enable_timing=True)
            end = torch.cuda.Event(enable_timing=True)
            start.record()
            work.step(run)
            end.record()
            end.synchronize()
            times[run].append(start.elapsed_time(end))
    out = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
           "runs": {run: {"fwd_bwd_ms_median": statistics.median(times[run]),
                          "fwd_bwd_ms": times[run], **_profile(work, run)}
                    for run in RUNS},
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30}
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
