"""Where a serving step's time goes, on the card.

Serves the chip smoke's workload (`serve_workload`: Llama-2-7B width at
32 layers, bf16, random weights from a seed, 8 requests with prompts of
64-512 tokens and 32 new tokens, chunked prefill of 32) under
`torch.profiler`, then prints one JSON line:
device time by kernel name, the device's busy and idle share of the
profiled window, and the host wall time per scheduler step split into
the engine's step (`ragged_step`, or `verify_step` when speculative),
the draft engine's `prefill` / `decode_step` (with `--spec draft`), the
sampler and the rest.

    python -m paddle_tpu_torch.tools.serve_profile \
        [--kv-bits 8] [--wbits 8|4] [--spec ngram|draft] \
        [--out serve_profile.json]

`--kv-bits 8` serves from an int8 KV pool and `--wbits` quantizes the
engine's weights (`serving.quant.quantize_engine`), as the smoke's
quantized serve phase does; `--spec` serves the speculative workload
(`serve_workload(spec=...)`), as the smoke's `serve_spec_*` phases do.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import time
from collections import defaultdict

import torch

from .serve_workload import LAYERS, serve_workload


def _busy_ms(intervals):
    """Length of the union of [start, end) intervals (microseconds in,
    milliseconds out)."""
    total, cur_s, cur_e = 0.0, None, None
    for s, e in sorted(intervals):
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total / 1e3


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--kv-bits", type=int, choices=(16, 8), default=16)
    ap.add_argument("--wbits", type=int, choices=(8, 4), default=None)
    ap.add_argument("--spec", choices=("ngram", "draft"), default=None)
    ap.add_argument("--out", default=None)
    args = ap.parse_args(argv)

    from ..serving import scheduler as sched_mod

    if not torch.cuda.is_available():
        raise RuntimeError("serve_profile needs a CUDA card")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60,
                         check=True).stdout.strip().splitlines()[0]
    fe, requests = serve_workload(kv_bits=args.kv_bits, wbits=args.wbits,
                                  spec=args.spec)
    engine = fe.scheduler.engine
    sample_fn = sched_mod.sample_tokens

    # host wall split: wrap the engine steps and the sampler
    host = defaultdict(float)

    def timed(name, fn):
        def wrapper(*a, **kw):
            t0 = time.perf_counter()
            out = fn(*a, **kw)
            host[name] += time.perf_counter() - t0
            return out
        return wrapper

    for name in ("ragged_step", "verify_step"):
        setattr(engine, name, timed(f"{name}_enqueue",
                                    getattr(engine, name)))
    if args.spec == "draft":
        draft = fe.scheduler.spec.proposer.engine
        for name in ("prefill", "decode_step"):
            setattr(draft, name, timed(f"draft_{name}_enqueue",
                                       getattr(draft, name)))
    sched_mod.sample_tokens = timed("sample_tokens", sample_fn)

    handles = [fe.submit(p, **kw) for p, kw in requests]
    torch.cuda.synchronize()
    acts = [torch.profiler.ProfilerActivity.CPU,
            torch.profiler.ProfilerActivity.CUDA]
    steps = 0
    with torch.profiler.profile(activities=acts) as prof:
        t0 = time.perf_counter()
        while not fe.scheduler.idle:
            fe.step()
            steps += 1
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    sched_mod.sample_tokens = sample_fn
    assert all(h.status.value == "finished" for h in handles)

    by_kernel = defaultdict(lambda: [0.0, 0])
    intervals = []
    for ev in prof.events():
        if ev.device_type == torch.autograd.DeviceType.CUDA:
            dur = ev.time_range.elapsed_us()
            by_kernel[ev.name][0] += dur / 1e3
            by_kernel[ev.name][1] += 1
            intervals.append((ev.time_range.start, ev.time_range.end))
    dev_total = sum(v[0] for v in by_kernel.values())
    busy = _busy_ms(intervals)
    top = sorted(by_kernel.items(), key=lambda kv: -kv[1][0])[:15]
    out = {
        "device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
        "layers": LAYERS, "kv_bits": args.kv_bits, "wbits": args.wbits,
        "spec": args.spec,
        "steps": steps, "wall_ms": wall * 1e3,
        "wall_ms_per_step": wall * 1e3 / steps,
        "device_busy_ms": busy, "device_busy_share": busy / (wall * 1e3),
        "device_kernel_ms_total": dev_total,
        "device_kernels_per_step": sum(v[1] for v in by_kernel.values())
        / steps,
        "host_ms_per_step": {k: v * 1e3 / steps for k, v in host.items()},
        "top_kernels": [{"name": n[:90], "ms": v[0], "calls": v[1],
                         "share_of_device": v[0] / dev_total}
                        for n, v in top],
    }
    line = json.dumps(out)
    print(line, flush=True)
    if args.out:
        with open(args.out, "w") as f:
            f.write(line + "\n")


if __name__ == "__main__":
    main()
