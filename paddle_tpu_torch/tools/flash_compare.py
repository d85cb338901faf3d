"""Time the flash attention kernels of two checkouts on one card, in turns.

    python -m paddle_tpu_torch.tools.flash_compare --parent DIR \\
        [--out flash_compare.json]

`DIR` is another checkout of the repository (e.g. `git archive` of the
parent commit unpacked under `build/`). Four processes run one after
another: the other checkout, this one, this one, the other. Each imports
`paddle_tpu_torch` from its own tree (so it builds that tree's
`csrc/flash_attention.cu` into that tree's `build/`), times
`flash_attention_fwd`, `flash_attention_dq` and `flash_attention_dkv` on
the same seeded inputs at each shape of `SHAPES` (median device time of one
call with a cold L2, as `chip_smoke.py` times), and prints one JSON line.
The script prints the card's name and power limit, then one JSON object
with every run, and writes it to `--out` when given. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
from pathlib import Path

# (B, S, H, KVH, D, causal): the training shape, with GQA, past the JAX
# package's K/V streaming switch, several ragged tiles, the 64-column
# instance
SHAPES = {
    "train_mha": (4, 2048, 32, 32, 128, True),
    "train_gqa": (4, 2048, 32, 8, 128, True),
    "stream_17408": (1, 17408, 2, 1, 128, True),
    "edge_bf16": (2, 1000, 8, 2, 128, True),
    "d64_bf16": (4, 2048, 16, 16, 64, True),
}
KERNELS = ("flash_attention_fwd", "flash_attention_dq",
           "flash_attention_dkv")


def _time_ms(fn, flush, reps=30):
    """`chip_smoke.time_ms`, copied: a worker imports nothing from its
    tree but the kernel wrappers both trees have."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def worker():
    """One timing run of the `paddle_tpu_torch` on `sys.path`."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    out = {"tree": str(Path(fa.__file__).resolve().parents[3])}
    for name, (b, s, h, kvh, d, causal) in SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(10)
        q, k, v, do = (torch.randn((b, s, n, d), generator=g, device=dev)
                       .to(torch.bfloat16) for n in (h, kvh, kvh, h))
        o, lse = fa.flash_attention_fwd(q, k, v, causal)
        delta = (do.float() * o.float()).sum(-1).transpose(1, 2) \
            .contiguous()
        args = (q, k, v, do, lse, delta, causal)
        out[name] = {
            "flash_attention_fwd": _time_ms(
                lambda: fa.flash_attention_fwd(q, k, v, causal), flush),
            "flash_attention_dq": _time_ms(
                lambda: fa.flash_attention_dq(*args), flush),
            "flash_attention_dkv": _time_ms(
                lambda: fa.flash_attention_dkv(*args), flush)}
        del q, k, v, do, o, lse, delta, args
        torch.cuda.empty_cache()
    print(json.dumps(out), flush=True)


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", required=True,
                    help="another checkout of the repository")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        worker()
        return 0
    import torch

    if not torch.cuda.is_available():
        print("flash_compare needs a CUDA card", file=sys.stderr)
        return 1
    here = Path(__file__).resolve().parents[2]
    other = Path(a.parent).resolve()
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    runs = []
    for label, tree in (("parent", other), ("change", here),
                        ("change", here), ("parent", other)):
        env = dict(os.environ, PYTHONPATH=str(tree))
        r = subprocess.run([sys.executable, __file__, "--parent", str(other),
                            "--worker"], cwd=tree, env=env,
                           capture_output=True, text=True, check=True)
        run = json.loads(r.stdout.strip().splitlines()[-1])
        run["label"] = label
        runs.append(run)
        print(json.dumps(run), flush=True)
    summary = {}
    for name in SHAPES:
        summary[name] = {
            k: {lab: [r[name][k] for r in runs if r["label"] == lab]
                for lab in ("parent", "change")} for k in KERNELS}
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi,
              "order": [r["label"] for r in runs], "ms": summary}
    text = json.dumps(result)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
