"""The wall time of `paddle.randn([4096, 4096])` in one dtype, and of
the draw's `log1p` step alone (`framework.random._log1p_xla` on
`-u * u`, `u` uniform in (-1, 1), as `erf_inv` calls it), to compare
the normal draws of two checkouts on one machine:

    python3 paddle_tpu_torch/tools/draw_timing.py --device cpu \\
        --dtype float64 [--root DIR]

`--root` puts another checkout's package first on the path (run once
with each checkout, in one session, and compare the medians). The first
call of each is a warm-up; REPS calls are timed, each on the card
ending with a `torch.cuda.synchronize()`. Prints one JSON line: the
package's path, the device, dtype, shape, each call's ms and their
medians.
"""
import argparse
import json
import os
import statistics
import sys
import time

SHAPE = [4096, 4096]
REPS = 3


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", choices=("cpu", "gpu"), default="gpu")
    ap.add_argument("--dtype", default="float32")
    ap.add_argument("--root", default=None)
    args = ap.parse_args(argv)
    if args.root:
        sys.path.insert(0, os.path.abspath(args.root))
    import torch

    import paddle_tpu_torch as paddle

    paddle.set_device(args.device)
    paddle.seed(0)

    def sync():
        if args.device == "gpu":
            torch.cuda.synchronize()

    from paddle_tpu_torch.framework import random as random_mod

    u = paddle.uniform(SHAPE, dtype=args.dtype, min=-1.0, max=1.0)._data
    arg = u * -u

    def timed(fn):
        fn()
        sync()
        ms = []
        for _ in range(REPS):
            t0 = time.perf_counter()
            fn()
            sync()
            ms.append((time.perf_counter() - t0) * 1e3)
        return ms

    ms = timed(lambda: paddle.randn(SHAPE, dtype=args.dtype))
    log1p_ms = timed(lambda: random_mod._log1p_xla(arg))
    print(json.dumps({"package": os.path.dirname(paddle.__file__),
                      "device": args.device, "dtype": args.dtype,
                      "shape": SHAPE, "ms": ms,
                      "median_ms": statistics.median(ms),
                      "log1p_ms": log1p_ms,
                      "log1p_median_ms": statistics.median(log1p_ms)}))


if __name__ == "__main__":
    main()
