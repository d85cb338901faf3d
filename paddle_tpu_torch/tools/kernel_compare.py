"""Time the flash attention kernels, the weight-only gemms, the RMSNorm
forward and the paged attention (ragged, decode, verify) of two checkouts
on one card, in turns.

    python -m paddle_tpu_torch.tools.kernel_compare --parent DIR \\
        [--only paged] [--out kernel_compare.json]
    python -m paddle_tpu_torch.tools.kernel_compare --sweep-splits \\
        [--out split_sweep.json]

`DIR` is another checkout of the repository (e.g. `git archive` of the
parent commit unpacked under `build/`). Four processes run one after
another: the other checkout, this one, this one, the other. Each imports
`paddle_tpu_torch` from its own tree (so it builds that tree's kernels
into that tree's `build/`), times `flash_attention_fwd`,
`flash_attention_dq` and `flash_attention_dkv` on the same seeded inputs
at each shape of `SHAPES`, `quant_matmul` (int8 weights) and
`quant_matmul_int4` (bf16 x, M = 40) at each shape of `GEMM_SHAPES`, and
`rms_norm_fwd` at each case of `RMS_CASES`, and `paged_attention_ragged`
at each composition of `RAGGED_COMPOSITIONS` over a bf16 pool and an int8
pool, and `paged_attention` / `paged_attention_verify` at each case of
`PAGED_CASES` (median device time of one call with a cold L2, as
`chip_smoke.py` times; the gemms, RMSNorm and the paged attention also
after an L2 left clean), and prints one JSON line; `--only paged` times
the paged attention alone. `--sweep-splits` times this tree's int8
and int4 gemms at every K split the kernel takes (1 .. 8) beside the one
`gemm_plan` picks, and its ragged kernel at every cluster size (1, 2, 4)
beside the one `ragged_plan` picks, with 32 and 8 kv heads, and the
verify windows of `PAGED_CASES` likewise (`--only paged`: these alone,
no gemm). The script
prints the card's name and power limit, then one JSON object with every
run, and writes it to `--out` when given. Needs a CUDA card.
"""
from __future__ import annotations

import argparse
import json
import os
import statistics
import subprocess
import sys
import time
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
# the gemm's device time after a write that leaves L2 full of dirty lines
# (`chip_smoke.time_ms`) and after a read that leaves it clean, and the
# host's time to enqueue one call (the serving step is host-bound)
GEMM_KERNELS = ("quant_matmul", "quant_matmul_clean_l2",
                "quant_matmul_host_us")
# M = 40 packed tokens against Llama-2-7B's projections [N, K] and its
# untied head (the serving step's weight-only gemms)
GEMM_SHAPES = {"qkv": (12288, 4096), "o": (4096, 4096),
               "gate_up": (22016, 4096), "down": (4096, 11008),
               "head": (32000, 4096)}
GEMM_M = 40
# the int8 and int4 weight-only gemms, by the prefix of their cases
GEMM_FORMATS = {"gemm": "int8", "gemm4": "int4"}
# RMSNorm forward: the training step's rows [8192, 4096] in bf16 and f32,
# and Llama-2-70B's width in bf16
RMS_CASES = {"rms_bf16": ((8192, 4096), "bfloat16"),
             "rms_f32": ((8192, 4096), "float32"),
             "rms_h8192_bf16": ((8192, 8192), "bfloat16")}
RMS_KERNELS = ("rms_norm", "rms_norm_clean_l2")
# the ragged kernels at the serving geometry (tools/serve_workload.py: 8
# lanes, T = 8 + 32 packed slots, pages of 16, 128 a table, a pool of 1024
# blocks) at Llama-2-7B width (32 heads of 128): (q_lens, kv_lens) of the
# serving step (`serve`: six decode lanes at ~512, an empty lane, a
# 32-token chunk at kv_len 72, two guard slots), the steady decode step
# (`decode8`: 8 decode lanes at 512-544, 32 guard slots) and a 32-token
# chunk at kv_len 512 beside 7 decode lanes (`prefill512`, one guard)
RAGGED_COMPOSITIONS = {
    "serve": ([1, 1, 1, 0, 1, 1, 32, 1],
              [512, 509, 530, 0, 498, 520, 72, 515]),
    "decode8": ([1] * 8, [512, 520, 530, 544, 515, 525, 538, 541]),
    "prefill512": ([1, 1, 1, 32, 1, 1, 1, 1],
                   [520, 530, 512, 512, 540, 515, 525, 544]),
}
RAGGED_GEOMETRY = dict(T=40, H=32, D=128, BS=16, W=128, NB=1024)
RAGGED_KERNELS = ("ragged", "ragged_clean_l2")
# decode (S None) and verify windows of S queries over the serve workload's
# context lengths (`paged_inputs`) at Llama-2-7B width: (kv heads, S, slots
# a page); 64-slot pages are `block_multihead_attention`'s default
PAGED_CASES = {
    "decode_mha_bs16": (32, None, 16),
    "decode_mha_bs64": (32, None, 64),
    "verify_mha_s5": (32, 5, 16),
    "verify_gqa_s5": (8, 5, 16),
    "verify_mha_s64": (32, 64, 16),
    "verify_gqa_s64": (8, 64, 16),
    "verify_mha_s5_bs64": (32, 5, 64),
}
PAGED_KERNELS = ("paged", "paged_clean_l2")


def ragged_inputs(name, kv_heads, quant, dtype, gen, bs=16):
    """The composition `name` on the card: (args, scales, tok_pos) for
    `paged_attention_ragged`. Block 0 is the guard block; each lane's
    pages are distinct blocks in a seeded order. `quant`: int8 pools and
    their scale planes from `quantize_kv` of the same random K/V. `bs`:
    slots a page (the serving pool's 16, or another for the general
    instance; the pool holds the same tokens)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.inference import kv_quant
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    q_lens, kv_lens = RAGGED_COMPOSITIONS[name]
    geo = RAGGED_GEOMETRY
    scale = 16 // bs
    nb, w = geo["NB"] * scale, geo["W"] * scale
    rng = np.random.default_rng(0)
    perm = rng.permutation(np.arange(1, nb))
    tables = np.zeros((len(q_lens), w), np.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        k = -(-n // bs)
        tables[i, :k] = perm[used:used + k]
        used += k
    dev = torch.device("cuda")
    q = torch.randn((geo["T"], geo["H"], geo["D"]), generator=gen,
                    device=dev).to(dtype)
    kc = torch.randn((nb, kv_heads, bs, geo["D"]), generator=gen, device=dev)
    vc = torch.randn((nb, kv_heads, bs, geo["D"]), generator=gen, device=dev)
    scales = {}
    if quant:
        kc, ks = kv_quant.quantize_kv(kc)
        vc, vs = kv_quant.quantize_kv(vc)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    lane, pos = pa.ragged_metadata(ql, kl, geo["T"])
    return (q, kc, vc, torch.from_numpy(tables).to(dev), kl, lane, pos), \
        scales, pos


def paged_inputs(kv_heads, dtype, gen, s=None, bs=16, d=128):
    """Decode or verify inputs at the serving geometry: the serve
    workload's context lengths (`default_rng(0)`, 64-512) plus an empty
    sequence and one of 3 tokens, 32 query heads of `d`, a pool holding
    the workload's 1024 x 16 slots in pages of `bs` (tables of 2048 slots),
    each sequence's pages distinct blocks in a seeded order; q [B, H, D]
    (decode, `s` None) or [B, S, H, D], random from `gen`. Returns (args,
    context lengths)."""
    import numpy as np
    import torch
    from paddle_tpu_torch.tools.serve_workload import BS, MAXB, NB

    h = 32
    nb, w = NB * BS // bs, MAXB * BS // bs
    ctx = [int(n) for n in np.random.default_rng(0).integers(64, 513, 8)]
    ctx += [0, 3]
    b = len(ctx)
    perm = np.random.default_rng(1).permutation(np.arange(1, nb))
    tables = np.zeros((b, w), np.int32)
    used = 0
    for i, n in enumerate(ctx):
        k = -(-n // bs)
        tables[i, :k] = perm[used:used + k]
        used += k
    dev = torch.device("cuda")
    shape = (b, h, d) if s is None else (b, s, h, d)
    q = torch.randn(shape, generator=gen, device=dev).to(dtype)
    kc = torch.randn((nb, kv_heads, bs, d), generator=gen,
                     device=dev).to(dtype)
    vc = torch.randn((nb, kv_heads, bs, d), generator=gen,
                     device=dev).to(dtype)
    lens = torch.tensor(ctx, dtype=torch.int32, device=dev)
    return (q, kc, vc, torch.from_numpy(tables).to(dev), lens), ctx


def as_16_slot_pages(k_cache, v_cache, block_tables, k_scale=None,
                     v_scale=None):
    """The same pool in pages of 16 slots: block j's slots 16 i .. 16 i +
    15 become block j * BS / 16 + i, and each table entry the BS / 16
    blocks of its page in order (scale planes likewise)."""
    import torch

    nb, kvh, bs, d = k_cache.shape
    k = bs // 16

    def split(x):
        return x.reshape(nb, kvh, k, 16, *x.shape[3:]).transpose(1, 2) \
            .reshape(nb * k, kvh, 16, *x.shape[3:]).contiguous()
    ar = torch.arange(k, dtype=block_tables.dtype,
                      device=block_tables.device)
    tables = (block_tables[:, :, None] * k + ar).reshape(
        block_tables.shape[0], -1).contiguous()
    scales = [split(x) for x in (k_scale, v_scale) if x is not None]
    return (split(k_cache), split(v_cache), tables, *scales)


def _time_ms(fn, flush, reps=30, clean=None):
    """`chip_smoke.time_ms`, copied: a worker imports nothing from its
    tree but the kernel wrappers both trees have. With `clean` (a 256 MB
    tensor) the write that evicts L2 is followed by a read of `clean`, so
    the call finds L2 holding clean lines instead of the write's dirty
    ones, which it would otherwise write back while it runs."""
    import torch

    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        flush.zero_()
        if clean is not None:
            clean.max()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return statistics.median(times)


def _gemm_inputs(n, k, dev, fmt="int8"):
    """Seeded weights [n, k] quantized to `fmt` (int4: packed [n, k / 2])
    with their scales, and bf16 x [40, k]."""
    import torch
    from paddle_tpu_torch.nn import quant as nq

    g = torch.Generator(device=dev).manual_seed(2)
    w = torch.randn((n, k), generator=g, device=dev) * 0.02
    x = torch.randn((GEMM_M, k), generator=g, device=dev).to(torch.bfloat16)
    q, s = nq.per_channel_quantize(w, f"weight_only_{fmt}")
    return x, nq.pack_int4(q) if fmt == "int4" else q, s


def worker(only=None):
    """One timing run of the `paddle_tpu_torch` on `sys.path` (`only`
    "paged": the paged attention alone)."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    dev = torch.device("cuda")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    clean = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    out = {"tree": str(Path(fa.__file__).resolve().parents[3])}
    if only != "paged":
        _time_dense(out, flush, clean)
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    for name in RAGGED_COMPOSITIONS:
        for pool in ("bf16", "int8"):
            g = torch.Generator(device=dev).manual_seed(13)
            args, sc, _pos = ragged_inputs(name, 32, pool == "int8",
                                           torch.bfloat16, g)

            def call():
                return pa.paged_attention_ragged(*args, **sc)
            out[f"ragged_{pool}_{name}"] = dict(zip(RAGGED_KERNELS, (
                _time_ms(call, flush), _time_ms(call, flush, clean=clean))))
            del args, sc
    for name, (kvh, s, bs) in PAGED_CASES.items():
        g = torch.Generator(device=dev).manual_seed(13)
        args, _ctx = paged_inputs(kvh, torch.bfloat16, g, s, bs)
        fn = pa.paged_attention if s is None else pa.paged_attention_verify

        def call():
            return fn(*args)
        out[name] = dict(zip(PAGED_KERNELS, (
            _time_ms(call, flush), _time_ms(call, flush, clean=clean))))
        del args
    print(json.dumps(out), flush=True)


def _time_dense(out, flush, clean):
    """The flash kernels, both gemms and RMSNorm, into `out`."""
    import torch
    from paddle_tpu_torch.ops.kernels import flash_attention as fa
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    dev = torch.device("cuda")
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
    for prefix, fmt in GEMM_FORMATS.items():
        fn = qm.quant_matmul_int4 if fmt == "int4" else qm.quant_matmul
        for name, (n, k) in GEMM_SHAPES.items():
            x, wq, s = _gemm_inputs(n, k, dev, fmt)

            def call():
                return fn(x, wq, s)
            call()                  # the first call builds the library
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(200):
                call()
            host_us = (time.perf_counter() - t0) / 200 * 1e6
            torch.cuda.synchronize()
            out[f"{prefix}_{name}"] = dict(zip(GEMM_KERNELS, (
                _time_ms(call, flush), _time_ms(call, flush, clean=clean),
                host_us)))
            del x, wq, s
    from paddle_tpu_torch.ops.kernels import rms_norm as rn

    for name, (shape, dtype) in RMS_CASES.items():
        g = torch.Generator(device=dev).manual_seed(12)
        x = (2 * torch.randn(shape, generator=g, device=dev)) \
            .to(getattr(torch, dtype))
        w = (1 + 0.1 * torch.randn(shape[-1:], generator=g, device=dev)) \
            .to(x.dtype)

        def call():
            return rn.rms_norm_fwd(x, w, 1e-6)
        out[name] = dict(zip(RMS_KERNELS, (
            _time_ms(call, flush), _time_ms(call, flush, clean=clean))))
        del x, w


def sweep_splits(only=None):
    """This tree's int8 and int4 gemms at every K split (one launch each
    through the C entry point) at each of `GEMM_SHAPES` (not with `only`
    "paged"), and `sweep_ragged`."""
    import torch
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    clean = torch.ones(256 << 20, dtype=torch.uint8, device=dev)
    stream = torch.cuda.current_stream(dev).cuda_stream
    res = {}
    if only == "paged":
        return {"sms": sms, "ragged": sweep_ragged(flush, clean)}
    for prefix, fmt in GEMM_FORMATS.items():
        int4 = fmt == "int4"
        fn = qm._lib(int4)
        ref_fn = qm.quant_matmul_int4_ref if int4 else qm.quant_matmul_ref
        for name, (n, k) in GEMM_SHAPES.items():
            x, wq, s = _gemm_inputs(n, k, dev, fmt)
            out = torch.empty((GEMM_M, n), dtype=torch.bfloat16, device=dev)
            plan = qm.gemm_plan(GEMM_M, n, k, sms, int4)
            want = ref_fn(x, wq, s)
            base = qm._kernel_args(x, wq, s, out, int4, sms)[:-1]
            ms = {}
            for splits in range(1, min(qm.PLAN_MAX_SPLITS,
                                       plan.k_tiles) + 1):
                per = -(-plan.k_tiles // splits)
                if -(-plan.k_tiles // per) != splits:
                    continue        # the kernel refuses an empty split

                def call(splits=splits):
                    rc = fn(*base, splits, stream)
                    if rc != 0:
                        raise RuntimeError(f"{fmt} gemm: CUDA error {rc}")
                call()
                torch.cuda.synchronize()
                err = float((out.float() - want.float()).abs().max())
                if not err <= 2.0 ** -7 * float(want.float().abs().max()):
                    raise AssertionError(f"{fmt} {name} splits {splits}: "
                                         f"err {err}")
                ms[splits] = [_time_ms(call, flush),
                              _time_ms(call, flush, clean=clean)]
            res[f"{prefix}_{name}"] = {
                "N": n, "K": k, "format": fmt, "planned": plan.splits,
                "ctas_per_split": plan.m_tiles * plan.n_tiles,
                "ms_dirty_clean_l2": ms}
            del x, wq, s, out, want
    return {"sms": sms, "gemm": res, "ragged": sweep_ragged(flush, clean)}


def sweep_ragged(flush, clean):
    """This tree's ragged kernels (bf16 q, a bf16 and an int8 pool) at
    every cluster size the split instance takes (its tile follows it), at
    each composition with 32 (Llama-2-7B) and 8 kv heads, and the verify
    windows of `PAGED_CASES`; every split checked against the plain
    version first."""
    import torch
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    dev = torch.device("cuda")
    sms = _support.sm_count(torch.cuda.current_device())
    res = {}
    planned = pa._plan

    def forced(splits):
        def plan(q, k_cache, block_tables, quant):
            t, h, d = q.shape
            return pa.ragged_plan(t, h, k_cache.shape[1], d,
                                  k_cache.shape[2], block_tables.shape[1],
                                  block_tables.shape[0], q.dtype, quant, sms,
                                  splits=splits)
        return plan
    try:
        for kvh in (32, 8):
            for name in RAGGED_COMPOSITIONS:
                for pool in ("bf16", "int8"):
                    g = torch.Generator(device=dev).manual_seed(13)
                    args, sc, _pos = ragged_inputs(name, kvh, pool == "int8",
                                                   torch.bfloat16, g)
                    plan = planned(args[0], args[1], args[3], pool == "int8")
                    want = pa.paged_attention_ragged_ref(*args, **sc).float()
                    ms = {}
                    for splits in pa.PLAN_SPLITS:
                        pa._plan = forced(splits)
                        err = float((pa.paged_attention_ragged(*args, **sc)
                                     .float() - want).abs().max())
                        if not err <= 4e-3 * (1 + float(want.abs().max())):
                            raise AssertionError(f"ragged {name} {pool} "
                                                 f"kvh {kvh} splits {splits}"
                                                 f": err {err}")

                        def call():
                            return pa.paged_attention_ragged(*args, **sc)
                        ms[splits] = [_time_ms(call, flush),
                                      _time_ms(call, flush, clean=clean)]
                    pa._plan = planned
                    res[f"ragged_{pool}_{name}_kvh{kvh}"] = {
                        "planned": plan.splits, "tile_tokens":
                        plan.tile_tokens, "slots": plan.slots,
                        "ms_dirty_clean_l2": ms}
                    del args, sc, want
        for name, (kvh, s, bs) in PAGED_CASES.items():
            if s is None:
                continue
            g = torch.Generator(device=dev).manual_seed(13)
            args, _ctx = paged_inputs(kvh, torch.bfloat16, g, s, bs)
            q = args[0]
            plan = planned(q.view(-1, *q.shape[2:]), args[1], args[3], False)
            want = pa.paged_attention_verify_ref(*args).float()
            ms = {}
            for splits in pa.PLAN_SPLITS:
                if q.shape[2] // args[1].shape[1] > 16 * splits:
                    continue
                pa._plan = forced(splits)
                err = float((pa.paged_attention_verify(*args).float()
                             - want).abs().max())
                if not err <= 4e-3 * (1 + float(want.abs().max())):
                    raise AssertionError(f"{name} splits {splits}: err "
                                         f"{err}")

                def call():
                    return pa.paged_attention_verify(*args)
                ms[splits] = [_time_ms(call, flush),
                              _time_ms(call, flush, clean=clean)]
            pa._plan = planned
            res[name] = {"planned": plan.splits,
                         "tile_tokens": plan.tile_tokens,
                         "slots": plan.slots, "ms_dirty_clean_l2": ms}
            del args, want
    finally:
        pa._plan = planned
    return res


def main(argv=None):
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--parent", default=None,
                    help="another checkout of the repository")
    ap.add_argument("--sweep-splits", action="store_true")
    ap.add_argument("--only", choices=("paged",), default=None,
                    help="time the paged attention kernels alone")
    ap.add_argument("--out", default=None)
    ap.add_argument("--worker", action="store_true", help=argparse.SUPPRESS)
    a = ap.parse_args(argv)
    if a.worker:
        worker(a.only)
        return 0
    import torch

    if not torch.cuda.is_available():
        print("kernel_compare needs a CUDA card", file=sys.stderr)
        return 1
    if a.parent is None and not a.sweep_splits:
        ap.error("give --parent DIR or --sweep-splits")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True).stdout.strip()
    print(smi, flush=True)
    result = {"device": torch.cuda.get_device_name(0), "nvidia_smi": smi}
    if a.sweep_splits:
        result["sweep"] = sweep_splits(a.only)
    else:
        here = Path(__file__).resolve().parents[2]
        other = Path(a.parent).resolve()
        runs = []
        for label, tree in (("parent", other), ("change", here),
                            ("change", here), ("parent", other)):
            env = dict(os.environ, PYTHONPATH=str(tree))
            r = subprocess.run([sys.executable, __file__, "--worker"]
                               + (["--only", a.only] if a.only else []),
                               cwd=tree, env=env, capture_output=True,
                               text=True)
            if r.returncode != 0:
                raise RuntimeError(f"the {label} worker failed:\n{r.stderr}")
            run = json.loads(r.stdout.strip().splitlines()[-1])
            run["label"] = label
            runs.append(run)
            print(json.dumps(run), flush=True)
        cases = [] if a.only else \
            [(name, k) for name in SHAPES for k in KERNELS] + \
            [(f"{prefix}_{name}", k) for prefix in GEMM_FORMATS
             for name in GEMM_SHAPES for k in GEMM_KERNELS] + \
            [(name, k) for name in RMS_CASES for k in RMS_KERNELS]
        cases += [(f"ragged_{pool}_{name}", k)
                  for name in RAGGED_COMPOSITIONS for pool in ("bf16", "int8")
                  for k in RAGGED_KERNELS] + \
            [(name, k) for name in PAGED_CASES for k in PAGED_KERNELS]
        summary = {}
        for name, k in cases:
            summary.setdefault(name, {})[k] = {
                lab: [r[name][k] for r in runs if r["label"] == lab]
                for lab in ("parent", "change")}
        result.update(order=[r["label"] for r in runs], ms=summary)
    text = json.dumps(result)
    if a.out:
        Path(a.out).parent.mkdir(parents=True, exist_ok=True)
        Path(a.out).write_text(text + "\n")
    print(text)
    return 0


if __name__ == "__main__":
    sys.exit(main())
