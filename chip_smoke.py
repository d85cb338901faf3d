#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA
card: builds the CUDA kernels from `paddle_tpu_torch/csrc/`, holds each
kernel against its plain PyTorch version at the serving shapes (the
ragged paged attention over a bf16/f32 pool and over an int8 pool, and
the int8/fp8 and int4 weight-only gemms), checks the engine on the card
against its CPU run on a small model in every quantization mode, then
serves a few requests through `ServingFrontend` at the full width of
Llama-2-7B (32 layers, random weights from a seed): once in bf16, then
with an int8 KV pool and int8 weights, and with an int8 KV pool and int4
weights.

    python3 chip_smoke.py

Each phase prints one JSON line. Any failure raises, so the script exits
non-zero and never prints the last line, which on success is exactly
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA card it fails at the first phase.
"""
from __future__ import annotations

import gc
import json
import statistics
import subprocess
import time

import numpy as np
import torch

# published peaks of one H100 SXM (dense): HBM bytes/s, bf16 tensor-core
# FLOP/s, float32 FLOP/s outside the tensor cores
HBM_BYTES_S = 3.35e12
BF16_FLOPS = 989e12
F32_FLOPS = 67e12


def emit(obj) -> None:
    print(json.dumps(obj), flush=True)


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True).stdout
    return out.strip().splitlines()[0].strip()


def time_ms(fn, flush: torch.Tensor, reps: int = 30) -> float:
    """Median device time of one call with a cold L2: a large write
    evicts the cache before each timed call, and keeps the card busy
    while the host enqueues the call."""
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


def bound(nbytes, flops, peak):
    """The least time the card could take: the larger of the bytes over
    the memory rate and the operations over the peak rate."""
    t_bytes, t_ops = nbytes / HBM_BYTES_S, flops / peak
    return max(t_bytes, t_ops) * 1e3, \
        "bytes" if t_bytes >= t_ops else "operations"


def release():
    gc.collect()
    torch.cuda.empty_cache()


def phase_device():
    if not torch.cuda.is_available():
        raise RuntimeError("chip_smoke: torch.cuda.is_available() is False")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = smi_line()
    kind = torch.cuda.get_device_name(0)
    emit({"phase": "device", "kind": kind,
          "count": torch.cuda.device_count(), "nvidia_smi": smi,
          "torch": torch.__version__, "cuda": torch.version.cuda,
          "tf32": {"matmul": False, "cudnn": False}})
    return kind, smi


def phase_build():
    from paddle_tpu_torch.ops.kernels import _support

    t0 = time.perf_counter()
    built = _support.build()
    secs = time.perf_counter() - t0
    ptxas = {name: [ln.strip() for ln in info["log"].splitlines()
                    if "registers" in ln or "spill" in ln]
             for name, info in built.items()}
    emit({"phase": "build", "seconds": secs, "sources": sorted(built),
          "ptxas": ptxas})


def _composition(kv_heads, dtype, gen, quant=False):
    """The serving batch at T = 8 + 32 packed slots: six decode lanes at
    kv_len ~512, an empty lane in the middle, a 32-token prefill chunk
    crossing two block boundaries, and two guard slots. `quant`: int8
    pools and their scale planes, from `quantize_kv` of random K/V."""
    from paddle_tpu_torch.inference import kv_quant
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.tools.serve_workload import B, BS, CHUNK, MAXB, NB

    T = B + CHUNK
    h, d = 32, 128
    q_lens = [1, 1, 1, 0, 1, 1, 32, 1]
    kv_lens = [512, 509, 530, 0, 498, 520, 72, 515]
    rng = np.random.default_rng(0)
    perm = rng.permutation(np.arange(1, NB))       # block 0: the guard
    tables = np.zeros((B, MAXB), np.int32)
    used = 0
    for i, n in enumerate(kv_lens):
        nblk = -(-n // BS)
        tables[i, :nblk] = perm[used:used + nblk]
        used += nblk
    dev = torch.device("cuda")
    q = torch.randn((T, h, d), generator=gen, device=dev).to(dtype)
    kc = torch.randn((NB, kv_heads, BS, d), generator=gen, device=dev)
    vc = torch.randn((NB, kv_heads, BS, d), generator=gen, device=dev)
    scales = {}
    if quant:
        kc, ks = kv_quant.quantize_kv(kc)
        vc, vs = kv_quant.quantize_kv(vc)
        scales = dict(k_scale=ks, v_scale=vs)
    else:
        kc, vc = kc.to(dtype), vc.to(dtype)
    ql = torch.tensor(q_lens, dtype=torch.int32, device=dev)
    kl = torch.tensor(kv_lens, dtype=torch.int32, device=dev)
    lane, pos = pa.ragged_metadata(ql, kl, T)
    args = (q, kc, vc, torch.from_numpy(tables).to(dev), kl, lane, pos)
    # the least work: each lane's K/V (and, int8, its scales) read once,
    # q read and out written once; 4 * H * D flops per (token, attended
    # position)
    pos_h = pos.cpu().numpy()
    item = q.element_size()
    per_pos = kv_heads * (d * kc.element_size() + (4 if quant else 0)) * 2
    meta_bytes = 4 * (2 * T + B + sum(-(-n // BS) for n in kv_lens))
    nbytes = 2 * T * h * d * item + sum(kv_lens) * per_pos + meta_bytes
    flops = 4 * h * d * int((pos_h[pos_h >= 0] + 1).sum())
    return args, scales, pos_h, nbytes, flops


def _attention_cases(quant, cases):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for name, kvh, dtype, tol in cases:
        args, sc, pos, nbytes, flops = _composition(kvh, dtype, gen, quant)
        out = pa.paged_attention_ragged(*args, **sc)
        ref = pa.paged_attention_ragged_ref(*args, **sc)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        err = float((o - r).abs().max())
        if not torch.allclose(o, r, atol=tol, rtol=tol):
            raise AssertionError(f"{name}: kernel != plain version, max "
                                 f"abs err {err} (atol=rtol={tol})")
        guard = torch.from_numpy(pos < 0).cuda()
        if int(guard.sum()) != 2 or bool((out[guard] != 0).any()):
            raise AssertionError(f"{name}: guard rows are not exact zeros")
        kernel_ms = time_ms(lambda: pa.paged_attention_ragged(*args, **sc),
                            flush)
        plain_ms = time_ms(
            lambda: pa.paged_attention_ragged_ref(*args, **sc), flush,
            reps=20)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS
                                   if dtype == torch.bfloat16 else F32_FLOPS)
        results[name] = {
            "kv_heads": kvh, "dtype": str(dtype).replace("torch.", ""),
            "tol": tol, "max_abs_err": err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by, "library_ms": None}
    return results


def _attention_shapes():
    from paddle_tpu_torch.tools.serve_workload import B, BS, CHUNK, MAXB, NB

    return {"T": B + CHUNK, "H": 32, "D": 128, "BS": BS, "B": B, "W": MAXB,
            "NB": NB}


def phase_kernel():
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    # bf16: a few times the largest error seen (9.8e-4), below the ~5e-3 a
    # decode lane's output moves if its mask is one position off
    results = _attention_cases(False, (
        ("mha_bf16", 32, torch.bfloat16, 4e-3),
        ("gqa_bf16", 8, torch.bfloat16, 4e-3),
        ("mha_f32", 32, torch.float32, 1e-4)))
    emit({"phase": "kernel", "kernel": "ragged_paged_attention",
          "shapes": _attention_shapes(), "launches": pa.LAUNCHES.count,
          "cases": results})
    return results


def phase_kernel_q():
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    # the same tolerances as the bf16/f32 pool: both sides dequantize the
    # same int8 values with the same f32 scales and differ in summation
    # order and where the scale multiplies, so a bf16 output may round
    # one ulp apart (3.9e-3 at |out| in [0.5, 1) has been seen on an
    # H100); atol = rtol = 4e-3 admits one ulp at any magnitude
    results = _attention_cases(True, (
        ("mha_bf16", 32, torch.bfloat16, 4e-3),
        ("gqa_bf16", 8, torch.bfloat16, 4e-3),
        ("mha_f32", 32, torch.float32, 1e-4)))
    emit({"phase": "kernel", "kernel": "ragged_paged_attention_q",
          "shapes": dict(_attention_shapes(), pool="int8 + f32 scales"),
          "launches": pa.LAUNCHES_Q.count, "cases": results})
    return results


# M = 40 packed tokens against Llama-2-7B's projections [N, K] and its
# untied head
GEMM_SHAPES = {"qkv": (12288, 4096), "o": (4096, 4096),
               "gate_up": (22016, 4096), "down": (4096, 11008),
               "head": (32000, 4096)}
GEMM_M = 40


def _gemm_cases(fmt, shapes, gen, flush, x_dtype=torch.bfloat16):
    from paddle_tpu_torch.nn import quant as nq
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    int4 = fmt == "int4"
    fn = qm.quant_matmul_int4 if int4 else qm.quant_matmul
    ref_fn = qm.quant_matmul_int4_ref if int4 else qm.quant_matmul_ref
    results = {}
    for name in shapes:
        n, k = GEMM_SHAPES[name]
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        x = torch.randn((GEMM_M, k), generator=gen,
                        device="cuda").to(x_dtype)
        algo = {"int8": "weight_only_int8", "int4": "weight_only_int4"}.get(
            fmt, "fp8")
        q, s = nq.per_channel_quantize(w, algo)
        if fmt == "e5m2":
            q = q.float().to(torch.float8_e5m2)
        deq = q.to(torch.bfloat16)                 # unpacked int values
        wq = nq.pack_int4(q) if int4 else q
        del w
        out = fn(x, wq, s)
        ref = ref_fn(x, wq, s)
        torch.cuda.synchronize()
        err = float((out.float() - ref.float()).abs().max())
        mag = float(ref.float().abs().max())
        # bf16 out: both sides sum in f32 and round once, so they differ
        # by rounding flips, at most one bf16 ulp of the output's largest
        # magnitude (2^-7 relative; about three times the largest error
        # seen at these shapes on an H100); f32 out (values of order 1):
        # summation order only
        tol = 2.0 ** -7 * mag if x_dtype == torch.bfloat16 else 1e-4
        if not err <= tol:
            raise AssertionError(f"{fmt} {name}: kernel != plain version, "
                                 f"max abs err {err} > {tol}")
        kernel_ms = time_ms(lambda: fn(x, wq, s), flush)
        plain_ms = time_ms(lambda: ref_fn(x, wq, s), flush, reps=10)
        w16 = deq * s[:, None].to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.matmul(
            x.to(torch.bfloat16), w16.t()), flush)
        w_bytes = wq.numel() * wq.element_size()
        nbytes = (x.numel() * x.element_size() + w_bytes + 4 * n
                  + GEMM_M * n * x.element_size())
        flops = 2 * GEMM_M * n * k
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS
                                   if x_dtype == torch.bfloat16 else
                                   F32_FLOPS)
        results[f"{name}_{fmt}" + ("" if x_dtype == torch.bfloat16
                                   else "_f32")] = {
            "N": n, "K": k, "M": GEMM_M, "tol": tol,
            "max_abs_err": err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "weight_bytes": w_bytes, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by}
        del x, wq, s, deq, w16, out, ref
    return results


def phase_gemm():
    """The weight-only gemms at M = 40 against the five Llama-2-7B
    shapes. `library_ms` is cuBLAS (`torch.matmul`) on the weight
    dequantized to bf16 outside the timed call: the 16-bit product a
    weight-only gemm exists to beat; the port never calls it."""
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    int8 = _gemm_cases("int8", list(GEMM_SHAPES), gen, flush)
    int8.update(_gemm_cases("e4m3", ["qkv"], gen, flush))
    int8.update(_gemm_cases("e5m2", ["qkv"], gen, flush))
    int8.update(_gemm_cases("int8", ["qkv"], gen, flush, torch.float32))
    int4 = _gemm_cases("int4", list(GEMM_SHAPES), gen, flush)
    del flush
    release()
    for kernel, cases, counter in (("quant_matmul", int8, qm.LAUNCHES),
                                   ("quant_matmul_int4", int4,
                                    qm.LAUNCHES_INT4)):
        emit({"phase": "kernel", "kernel": kernel, "M": GEMM_M,
              "library": "torch.matmul(x, w_bf16.T), w dequantized to "
                         "bf16 outside the timed call (cuBLAS)",
              "launches": counter.count, "cases": cases})
    return int8, int4


def _small_model():
    from paddle_tpu_torch import llama_tiny

    return llama_tiny(vocab=512, layers=2, hidden=256, heads=2, seq=256,
                      num_key_value_heads=1, device="cpu",
                      generator=torch.Generator().manual_seed(3))


# the small-model engines phase_reference runs on the card and on the CPU
REF_MODES = {"kv16": ({}, None),
             "kv8": ({"kv_bits": 8}, None),
             "w_int8": ({"weight_only": "int8"}, None),
             "w_fp8": ({"weight_only": "fp8"}, None),
             "w_int4": ({"weight_only": "int4"}, None),
             "kv8_q8": ({"kv_bits": 8}, 8)}


def phase_reference():
    """The whole engine step on the card against its CPU run (plain
    versions) on a small f32 model with the serving head_dim, in every
    quantization mode; then the tie-aware greedy agreement of the int8
    engine against the full-precision one on the card."""
    from paddle_tpu_torch import LlamaInferenceEngine
    from paddle_tpu_torch.serving.quant import (greedy_agreement,
                                                quantize_engine)

    model = _small_model()
    geo = dict(max_batch_size=4, num_blocks=64, block_size=16,
               max_blocks_per_seq=16)
    tables = np.zeros((4, 16), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[2, :2] = [4, 5]
    report = {}
    for mode, (kw, wbits) in REF_MODES.items():
        cpu = LlamaInferenceEngine(model, device="cpu", **geo, **kw)
        gpu = LlamaInferenceEngine(model, device="cuda", **geo, **kw)
        if wbits is not None:
            quantize_engine(cpu, wbits)
            quantize_engine(gpu, wbits)
        rng = np.random.default_rng(4)
        err = pool_steps = scale_rel = 0.0
        for q_lens, kv_lens in (([20, 0, 9, 0], [20, 0, 9, 0]),
                                ([1, 0, 1, 0], [21, 0, 10, 0]),
                                ([12, 0, 1, 0], [33, 0, 11, 0])):
            tokens = np.zeros((12 + 20,), np.int32)
            n = sum(q_lens)
            tokens[:n] = rng.integers(1, 512, n)
            a = cpu.ragged_step(tokens, q_lens, kv_lens, tables)
            b = gpu.ragged_step(tokens, q_lens, kv_lens, tables).cpu()
            err = max(err, float((a - b).abs().max()))
            if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
                raise AssertionError(f"{mode}: engine on the card != CPU "
                                     f"run: max abs err {err}")
            if cpu.kv_bits != 8:
                continue
            for c, g in ((cpu.k_cache, gpu.k_cache),
                         (cpu.v_cache, gpu.v_cache)):
                pool_steps = max(pool_steps, float(
                    (c.int() - g.cpu().int()).abs().max()))
            for c, g in ((cpu.k_scale, gpu.k_scale),
                         (cpu.v_scale, gpu.v_scale)):
                g = g.cpu()
                scale_rel = max(scale_rel, float(
                    ((c - g).abs() / c.abs().clamp_min(1e-30)).max()))
                # 1e-6 relative, or 1e-7 absolute: layer 2's K/V come
                # out of f32 sums taken in another order on the card
                if not torch.allclose(c, g, rtol=1e-6, atol=1e-7):
                    raise AssertionError(f"{mode}: scale planes differ, "
                                         f"max rel {scale_rel}")
            if pool_steps > 1:
                raise AssertionError(f"{mode}: int8 pools {pool_steps} "
                                     "steps apart")
        report[mode] = {"max_abs_err": err, "int8_pool_max_steps":
                        pool_steps, "scale_max_rel": scale_rel}
        del cpu, gpu

    # the JAX package's serving_quant gate, on the small model: int8 KV +
    # int8 weights against full precision, tie-aware top-1 >= 0.99
    quant = quantize_engine(LlamaInferenceEngine(
        model, device="cuda", kv_bits=8, **geo), 8)
    dense = LlamaInferenceEngine(model, device="cuda", **geo)
    rng = np.random.default_rng(5)
    prompts = [rng.integers(1, 512, int(n)) for n in (24, 57, 96, 131)]
    agree = greedy_agreement(quant, dense, prompts)
    if agree["agreement_tie_aware"] < 0.99:
        raise AssertionError(f"small-model greedy agreement {agree}")
    emit({"phase": "reference", "model": "llama_tiny(vocab=512, layers=2, "
          "hidden=256, heads=2, kv_heads=1) f32", "steps": 3, "tol": 1e-3,
          "modes": report, "max_abs_err": max(r["max_abs_err"]
                                              for r in report.values()),
          "greedy_agreement_kv8_q8": agree})
    release()


def _serve(label, kv_bits, wbits, kind, smi):
    """Serve the workload once in one mode; the launch counts are zeroed
    just before the run and read just after it."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm
    from paddle_tpu_torch.tools.serve_workload import (LAYERS, NEW_TOKENS,
                                                       serve_workload)

    t0 = time.perf_counter()
    fe, requests = serve_workload(kv_bits=kv_bits, wbits=wbits)
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine = fe.scheduler.engine
    info = engine.quant_info()
    gauges = {n: monitor.get(n) for n in (
        "serving.quant.wbits", "serving.quant.kv_bits",
        "serving.kv_bytes_per_token")}
    want = {"serving.quant.wbits": info["wbits"],
            "serving.quant.kv_bits": info["kv_bits"],
            "serving.kv_bytes_per_token": round(info["kv_bytes_per_token"],
                                                1)}
    if gauges != want:
        raise AssertionError(f"{label}: quant gauges {gauges} != "
                             f"quant_info {want}")

    fe.metrics.reset_window()
    torch.cuda.reset_peak_memory_stats()
    _support.reset_launch_counts()
    monitor.reset("serving.ragged_steps")
    t1 = time.perf_counter()
    handles = [fe.submit(p, **kw) for p, kw in requests]
    steps = fe.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c: _support.launch_counter(c).count for c in (
        "ragged_paged_attention", "ragged_paged_attention_q",
        "quant_matmul", "quant_matmul_int4")}
    ragged_steps = monitor.get("serving.ragged_steps")

    # the scheduler checks every lane's logits row by row and fails a lane
    # with a non-finite row (`nan_logits`): all FINISHED = all finite
    bad = [(h.request_id, h.status.value, h.finish_reason, len(h.tokens))
           for h in handles
           if h.status.value != "finished" or len(h.tokens) != NEW_TOKENS]
    if bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{NEW_TOKENS} tokens: {bad}")
    attn = "ragged_paged_attention_q" if kv_bits == 8 else \
        "ragged_paged_attention"
    gemm = {8: "quant_matmul", 4: "quant_matmul_int4"}.get(wbits)
    expect = {c: 0 for c in launches}
    expect[attn] = LAYERS * ragged_steps
    if gemm is not None:
        # four projections per layer and the untied head
        expect[gemm] = (4 * LAYERS + 1) * ragged_steps
    if ragged_steps == 0 or launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"{expect} over {ragged_steps} ragged steps")
    s = fe.summary()
    tokens_out = sum(len(h.tokens) for h in handles)
    emit({"phase": label,
          "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
          "kv_bits": kv_bits, "wbits": wbits or 16,
          "requests": len(handles),
          "prompt_lens": [len(p) for p, _ in requests],
          "tokens_out": tokens_out, "scheduler_steps": steps,
          "ragged_steps": ragged_steps, "kernel_launches": launches,
          "wall_s": wall, "tok_s": tokens_out / wall,
          "ttft_p50_ms": s["serving.ttft_p50_ms"],
          "tpot_p50_ms": s["serving.tpot_p50_ms"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "kv_bytes_per_token": info["kv_bytes_per_token"],
          "setup_s": setup_s, "device": kind, "nvidia_smi": smi,
          "sample_tokens": handles[0].tokens[:8]})
    return fe, requests, launches


def phase_serve(kind, smi):
    fe, _requests, launches = _serve("serve", 16, None, kind, smi)
    del fe
    release()
    return launches


def phase_serve_quant(kind, smi):
    """The JAX package's `serving_quant` mode (int8 KV + int8 weights) and
    int8 KV + int4 weights, on the bf16 serve's traffic; then the greedy
    agreement of the int8 engine against a bf16 engine over 4 prompts
    (reported, not gated: random weights are not a trained model)."""
    from paddle_tpu_torch.serving.quant import greedy_agreement
    from paddle_tpu_torch.tools.serve_workload import serve_workload

    fe8, requests, l8 = _serve("serve_quant_w8_kv8", 8, 8, kind, smi)
    ref_fe, _ = serve_workload()
    agree = greedy_agreement(fe8.scheduler.engine, ref_fe.scheduler.engine,
                             [p for p, _ in requests[:4]])
    emit({"phase": "serve_quant_agreement", "engine": "kv_bits=8 + "
          "quantize_engine(8)", "reference": "bf16", "gated": False,
          **agree})
    del fe8, ref_fe
    release()
    fe4, _requests, l4 = _serve("serve_quant_w4_kv8", 8, 4, kind, smi)
    del fe4
    release()
    return l8, l4


def _row(name, source, replaces, launches, case):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "ok": True}


def main():
    kind, smi = phase_device()
    phase_build()
    attn = phase_kernel()
    attn_q = phase_kernel_q()
    int8, int4 = phase_gemm()
    phase_reference()
    bf16_launches = phase_serve(kind, smi)
    l8, l4 = phase_serve_quant(kind, smi)
    attn_src = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    gemm_src = "paddle_tpu_torch/csrc/quant_matmul.cu"
    emit({"kernels": [
        _row("ragged_paged_attention", attn_src,
             "paddle_tpu/ops/pallas/paged_attention.py:278",
             bf16_launches["ragged_paged_attention"], attn["mha_bf16"]),
        _row("ragged_paged_attention_q", attn_src,
             "paddle_tpu/ops/pallas/paged_attention.py:380",
             l8["ragged_paged_attention_q"]
             + l4["ragged_paged_attention_q"], attn_q["mha_bf16"]),
        _row("quant_matmul", gemm_src,
             "paddle_tpu/ops/pallas/quant_matmul.py:29",
             l8["quant_matmul"], int8["qkv_int8"]),
        _row("quant_matmul_int4", gemm_src,
             "paddle_tpu/ops/pallas/quant_matmul.py:115",
             l4["quant_matmul_int4"], int4["qkv_int4"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main()
