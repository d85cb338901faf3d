"""Where a training step's time goes, on the card.

Runs the chip smoke's training workload (`train_workload`: Llama-2-7B
width at 8 layers, bf16, batch 4 x 2048 tokens, AdamW with f32 masters)
and prints one JSON line:
  - the forward / backward / optimizer split of the step, from CUDA events
    over `train_workload.TIMED_STEPS` steps outside the profiler;
  - under `torch.profiler` over two more steps: device time by kernel name
    and by class (the port's flash and RMSNorm kernels, the cuBLAS matrix
    products, everything else), the device's busy share of the profiled
    window, and device kernels per step.

    python -m paddle_tpu_torch.tools.train_profile [--out train_profile.json]
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import time
from collections import defaultdict

import torch

from .serve_profile import _busy_ms
from .train_workload import (BATCH, LAYERS, SEQ, SPLIT, TOKENS,
                             WARMUP_STEPS, timed_steps, train_step,
                             train_workload)

# dense bf16 tensor-core peak of one H100 SXM (NVIDIA's data sheet)
BF16_PEAK = 989e12
PROFILED_STEPS = 2

_CLASSES = (("flash_attention", ("fwd_wgmma_kernel", "dq_wgmma_kernel",
                                 "dkv_wgmma_kernel")),
            ("rms_norm", ("rms_norm_kernel", "rms_norm_regs_kernel")),
            ("matmul", ("gemm", "nvjet", "cutlass", "sm90_xmma", "cublas")))


def _class_of(name: str) -> str:
    for cls, keys in _CLASSES:
        if any(k in name for k in keys):
            return cls
    return "other"


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("train_profile needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    model, opt, ids, labels = train_workload()
    for _ in range(WARMUP_STEPS):
        train_step(model, opt, ids, labels)
    torch.cuda.synchronize()
    _losses, walls, splits = timed_steps(model, opt, ids, labels)

    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(PROFILED_STEPS):
            train_step(model, opt, ids, labels)
        torch.cuda.synchronize()
        window = (time.perf_counter() - t0) * 1e3

    by_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            by_kernel[ev.name][0] += ev.time_range.elapsed_us() / 1e3
            by_kernel[ev.name][1] += 1
            intervals.append((ev.time_range.start, ev.time_range.end))
    n = PROFILED_STEPS
    dev_total = sum(v[0] for v in by_kernel.values())
    by_class = defaultdict(lambda: [0.0, 0])
    for name, (ms, calls) in by_kernel.items():
        c = by_class[_class_of(name)]
        c[0] += ms / n
        c[1] += calls / n
    busy = _busy_ms(intervals)
    step_ms = statistics.median(walls)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:20]
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "layers": LAYERS, "batch": BATCH, "seq": SEQ,
        "step_ms_median": step_ms, "step_ms": walls,
        "tok_s": TOKENS / (step_ms / 1e3),
        "mfu": model.flops_per_token(SEQ) * TOKENS / (step_ms / 1e3)
        / BF16_PEAK,
        "split_ms_median": {k: statistics.median(s[k] for s in splits)
                            for k in SPLIT},
        "profiled_steps": n, "profiled_window_ms": window,
        "device_busy_ms_per_step": busy / n,
        "device_busy_share": busy / window,
        "device_kernel_ms_per_step": dev_total / n,
        "device_kernels_per_step": sum(v[1] for v in by_kernel.values()) / n,
        "by_class_per_step": {k: {"ms": v[0], "calls": v[1],
                                  "share_of_device": v[0] * n / dev_total}
                              for k, v in sorted(by_class.items())},
        "top_kernels": [{"name": nm[:90], "ms_per_step": v[0] / n,
                         "calls_per_step": v[1] / n,
                         "share_of_device": v[0] / dev_total}
                        for nm, v in top],
        "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
