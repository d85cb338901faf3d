#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (`paddle_tpu_torch`) on one NVIDIA
card: builds the CUDA kernels from `paddle_tpu_torch/csrc/` (and fails if
ptxas spills in a warp-specialised `wgmma` kernel: the flash forward, dQ
and dK/dV, and the split-K weight-only gemm in every weight format and
token tile; or in an instance of the split ragged kernel), holds each
kernel against its plain PyTorch version at the serving shapes (the
ragged paged attention over a bf16/f32 pool and over an int8 pool, at
the serving step, the steady decode step and a 32-token chunk at kv_len
512, each in the instance `ragged_plan` picks, and in the general
instance over 8-slot pages; the paged decode and verify attention in 16-
and 64-slot pages, bf16 on the split instance, bit-equal to the ragged
kernel on the same windows and to 16-slot pages, and the decode / verify
kernel at f32, head_dim 96 and 8-slot pages; and the int8/fp8 and int4
weight-only gemms), checks the engine
on the card against its CPU run on a small model in every quantization
mode (ragged steps, prefill, decode and verify), then serves a few
requests through `ServingFrontend` at the full width of Llama-2-7B (32
layers, random weights from a seed): once in bf16, then with an int8 KV
pool and int8 weights, and with an int8 KV pool and int4 weights; runs
`LlamaInferenceEngine.generate`; and serves speculatively, with the
n-gram proposer and with a self-draft engine, holding every greedy token
teacher-forced against the plain engine. Then the serving policy layer:
bench.py serving_shared_prefix's trace at the same width (42 requests
behind a 192-token shared prefix, arriving by scheduler step) over a
bf16 pool and an int8 pool, with the prefix cache on and off (greedy
streams identical, hit rate, evictions, copy-on-writes, the prefill
tokens saved equal to the hit tokens, no leaked block), and the fault
layer on a small model: a transient dispatch fault, a watchdog restart
through an engine factory, an overload burst under queue watermarks,
and `MLPLMEngine` on the card against the CPU. Then multi-LoRA serving
and KV migration: `LoRAEngine` on small models on the card against the
CPU (MLP and Llama engines, int8 pools, int8 and int4 bases); bench.py
serving_lora's mix at the same width (36 adapters on 40 pool slots, 72
requests arriving by step) on a LoRA engine and on its base engine, with
each parity adapter's stream in a mixed batch equal to a dedicated
wrapper's, then the same over an int8 pool and int4 weights; and the
serve prompts moved between engines mid-stream (extract, release,
import_session) over a bf16 and an int8 pool, streams equal to the
unmigrated ones, and a shared prefix streamed between two prefix-cached
schedulers. Then fleet routing and disaggregated prefill/decode
(`serving.FleetRouter`, `serving.DisaggRouter`): on small engines (MLP
and Llama, 16- and 8-bit KV) a kill in mid-decode, a drain, a replica
added, session affinity, a 1 + 1 handoff and a prefix streamed between
replicas, each against a single frontend's streams, with the fleet's
integer counters equal on the card and the CPU; then the serve workload
at Llama-2-7B width over two replicas built once: a clean fleet run, a
disaggregated run (one prefill and one decode replica, every session
handed off with its KV, streams equal the clean run's, no prompt token
prefilled on the decode tier) and a chaos run that kills the busiest
replica mid-decode (its requests folded and re-prefilled on the
survivor, greedy streams bit-equal to the clean run's), each with exact
launches a step and no leaked block. Then tensor-parallel serving (`serving.tp.shard_engine`): two
rank processes sharing the card over a gloo group of CUDA tensors (NCCL
refuses two ranks on one device) hold small sharded engines (MLP and
Llama, every KV and weight format) on the card against the same shards
on the CPU and against the unsharded engine, then serve the serve
workload at Llama-2-7B width at tp=2 in bf16 and with int8 KV + int4
weights (both ranks' streams identical, exact launches a step, per-rank
KV bytes, every greedy token teacher-forced through the unsharded
engine), then bf16 at tp=1 over a one-rank NCCL group, and the int4 gemm
at each per-rank shape. Then the training path: the
flash attention kernels (forward, dQ, dK/dV) and the RMSNorm kernel
against their plain versions at the training shapes, past the length
where the JAX package streams K/V, over ragged 128-row tiles and at the
64-column instance, three AdamW steps of a small model on
the card against the CPU, and `train_workload`'s steps at Llama-2-7B
width (8 layers, batch 4 x 2048). Last the fused-op surface
(`incubate.nn.functional`): the RoPE, bias + activation and SwiGLU
kernels against their plain versions at the training step's 8,192
tokens, one Llama-2-7B-width decoder layer built from the `incubate`
functions (forward and backward, both SwiGLU forms) against the model's
`LlamaDecoderLayer` on the same weights, and `block_multihead_attention`
prefilling the serve workload's prompts and decoding 32 tokens against a
dense causal attention. Last the MoE layer: the dispatch and gather
kernels bit-equal to their plain versions and the index-op route at the
workload's shapes (forward and backward), a small layer on the card
against the CPU on the dense and the expert-parallel routes, and one
forward + backward of a Mixtral-8x7B-width `MoELayer` (8,192 tokens) on
the EP route over a one-rank NCCL group with the kernels on and off, and
on the dense route. Between the training and the fused-op phases, the
eager API (`paddle_tpu_torch.Tensor` over torch autograd): one scripted
program over the eager ops and the tape on the card against its CPU run
(`eager_reference`), and Llama-2-7B's attention block (one sequence of
2048 tokens, bf16) in eager Tensors with exactly one launch of each of
the flash forward, dQ, dK/dV and RMSNorm kernels, its gradients bit-equal
to the same calls on plain tensors and near the kernels' plain versions
(`eager_attention`). After them the paddle-style model path: small f32
Layers through eager, `jit.to_static`, `jit.save` -> `jit.load` and the
inference `Predictor` (dynamic batch 1 / 3 / 7) on the card against the
CPU, and a program saved from CPU tensors launching the flash and
RMSNorm kernels once a call on the card (`jit_reference`); then one
Llama-2-7B decoder layer written as paddle Layers (bf16, one sequence of
2048 tokens) trained two AdamW steps eagerly and two through
`jit.to_static`, exported with `jit.save` and served by the `Predictor`
at batch 1 and 2, with exact launches (`jit_layer`). Then lazy eager mode
and AMP: the Llama in paddle Layers (`models/llama_layers.py`, small,
f32) trained two AdamW steps eagerly and two under lazy mode, whose
region runs as a CUDA graph captured at its second sight, on the card
against the CPU, with AMP O1 / O2 and a GradScaler skip
(`lazy_reference`); then that Llama at Llama-2-7B width (4 layers, O2
bf16, one sequence of 2048 tokens) two warm-up and three timed steps
eagerly and again under lazy mode: lazy within 1e-3 of eager, no capture
after the warm-up, no uncaptured replay, exact launches a step
(`lazy_llama`). Then the op surface and the training loop
(`tools/loop_workload.py`): the op harness over every ported export of
`paddle`, `Tensor`, `nn.functional` and `nn` on the card against the
CPU, and `flash_attention` / `flash_attn_qkvpacked` bit-equal to
`scaled_dot_product_attention` at the training shape, a causal bool mask
taking the composite (`ops_reference`); the loop PaddleNLP's Trainer
builds (AdamW with decay off the norms, a global-norm clip, warm-up +
cosine) on a small Llama, and the eight new optimizers, on the card
against the CPU (`train_loop_reference`); then that loop at Llama-2-7B
width (4 layers, O2 bf16, 2048 tokens with the last 256 labels ignored)
eagerly and under lazy mode: scheduled learning rates, clipped norms,
lazy within 1e-3 of eager, exact launches a step (`train_loop`). Then
the `paddle.nn` layer surface (`tools/encoder_workload.py`): a conv net
with BatchNorm2D and pools, bidirectional LSTM and GRU stacks with
inter-layer dropout, the encoder-decoder Transformer and `bert_tiny`'s
two AdamW steps on the card against the CPU (f32 within 1e-4
norm-relative, dropout masks bit-equal; `nn_reference`); then BERT-base
(12 layers, 768 / 12 x 64 / 3072, dropout 0.1) built from
`nn.TransformerEncoder`, B 32 x S 512, O2 bf16, 2 warm-up and 4 timed
pre-training steps eagerly and again under lazy mode: exactly 12 / 12 /
12 flash launches a step, lazy bit-equal to eager, falling losses
(`encoder_train`). The op harness of `ops_reference` covers
`paddle.linalg`, `paddle.fft` and `paddle.signal` too (decompositions by
their sign-free invariants), and two realistic-size cases run on the
card against the CPU: Whisper's STFT front end over 8 x 30 s of 16 kHz
audio and back through `istft`, and 1024 x 1024 `cholesky`, `solve`,
`eigh`, `svd`, `qr` and `lu` in f32 and f64 by reconstruction residual.
Then FNet through `paddle.fft` (`tools/fnet_workload.py`): `fnet_tiny`
two AdamW steps on the card against the CPU (f32 within 1e-4
norm-relative, dropout masks bit-equal; `fnet_reference`); then
FNet-base (google/fnet-base widths, 12 layers), B 32 x S 512, O2 bf16,
2 warm-up and 4 timed pre-training steps eagerly and again under lazy
mode: no flash or RMSNorm launch (FNet has no attention and LayerNorm
norms), lazy bit-equal to eager, falling losses, the Fourier sublayers'
share of the step (`fnet_train`). Then sparse embeddings, quantization
and guarded training (`tools/resilience_workload.py`,
`tools/quant_workload.py`): the Layer Llama (small, f32) with
`Embedding(sparse=True)` under SGD, Adam (lazy and not), AdamW (lazy,
multi_precision) and Momentum with a global-norm clip and under a
GradScaler, the weight-only (int8, fp8, int4) and LLM.int8 products, the
int8 gemm's gradient, QAT and PTQ, on the card against the CPU; the
SelectedRows merge repeating bit for bit; a CheckpointManager save on
the card restored on the CPU and back bit for bit; a torn and a
bit-flipped directory quarantined (`resilience_reference`). Then
Llama-2-7B width (4 layers, O2 bf16, 2048 tokens) with a dense and then
a sparse word embedding under the Trainer loop's AdamW in lazy_mode:
exact launches, no dense embedding gradient, untouched rows
bit-unchanged, losses near the dense run's (`sparse_train`); at 1
layer, 8 steps under `StepGuard` over an async CheckpointManager, the
step function returning NaN once: one rollback, the replay and the
final state bit-equal to an uninterrupted run, then a corrupted newest
checkpoint quarantined and the previous one restored bit for bit
(`resilient_train`); the trained 4-layer model deployed by PTQ through
the int8 and int4 weight-only gemms at B 1 x S 2048 (29 launches a
forward, each Linear against its plain version, logits near the bf16
model's), two QAT steps, and both gemms timed at M 2,048 over the five
serving shapes (`quant_deploy`). Then the single-controller distributed
core and elastic training (`tools/elastic_workload.py`): the chaos
scenario on `EmulatedTrainable` (world 8, the busiest pod killed
mid-step, re-formed to 7, resumed), `shard_tensor` / `reshard` and
every eager collective on rank-stacked tensors, and a dp2 x mp4
checkpoint loaded at dp4 x mp2, on the card against the CPU, each device
replaying itself bit for bit (`elastic_reference`); then Llama-2-7B
width at 1 of 32 layers (O2 bf16, AdamW, GradScaler, B 1 x S 2048, its
state placed over a `world` mesh by the leading-dim rule) under
`ElasticTrainSupervisor` from world 4, a pod killed so it re-forms to 3
(every tensor replicated), then to 2 (every tensor re-sliced): each
resumed step's loss `repr`-equal to an uninterrupted run restored from
the same checkpoint, the final state bit-equal to it, exact launches
(`elastic_train`).

    python3 chip_smoke.py
    python3 chip_smoke.py --only serve_lora,serve_migrate
    python3 chip_smoke.py --only fleet_reference,serve_fleet,serve_disagg
    python3 chip_smoke.py --only tp_reference,serve_tp
    python3 chip_smoke.py --only eager_reference,eager_attention
    python3 chip_smoke.py --only jit_reference,jit_layer
    python3 chip_smoke.py --only lazy_reference,lazy_llama
    python3 chip_smoke.py --only ops_reference,train_loop_reference,train_loop
    python3 chip_smoke.py --only nn_reference,encoder_train
    python3 chip_smoke.py --only ops_reference,fnet_reference,fnet_train
    python3 chip_smoke.py --only resilience_reference,sparse_train,resilient_train,quant_deploy
    python3 chip_smoke.py --only elastic_reference,elastic_train

Each phase prints one JSON line. `--only` runs the device check and the
named phases alone (`lora_reference`, `serve_lora`, `serve_lora_quant`,
`serve_migrate`, `fleet_reference`, `serve_fleet`, `serve_disagg` (these
two are one run: the disaggregated run sits between the clean and the
chaos fleet runs), `tp_reference`, `serve_tp`, `eager_reference`,
`eager_attention`, `jit_reference`, `jit_layer`, `lazy_reference`,
`lazy_llama`, `ops_reference`, `train_loop_reference`, `train_loop`,
`nn_reference`, `encoder_train`, `fnet_reference`, `fnet_train`,
`resilience_reference`, `sparse_train`, `resilient_train`,
`quant_deploy`, `elastic_reference`, `elastic_train`), with no kernels
line and
no last line: a measurement of those phases without the whole run. The TP
phases start their rank processes as `chip_smoke.py --tp-rank ...`. Any failure raises, so the script exits
non-zero and never prints the last line, which on success is exactly
`{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}`.
Without a CUDA card it fails at the first phase.
"""
from __future__ import annotations

import gc
import json
import math
import re
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch
import torch.distributed

# M = 40 packed tokens against Llama-2-7B's projections [N, K] and its
# untied head (`kernel_compare` times the same shapes)
from paddle_tpu_torch.tools.kernel_compare import GEMM_M, GEMM_SHAPES

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
    return statistics.median(times_ms(fn, flush, reps))


def times_ms(fn, flush: torch.Tensor, reps: int) -> list:
    """`time_ms`'s device time of each of `reps` calls."""
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
    return times


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
    ptxas = {name: _ptxas_by_function(info["log"])
             for name, info in built.items()}
    # the warp-specialised wgmma kernels and the split ragged kernel keep
    # every value in registers
    wgmma = {f"{src}:{f}": v for src, fns in ptxas.items()
             for f, v in fns.items()
             if "wgmma" in f or f.startswith("ragged_split_kernel")}
    missing = sorted(set(WGMMA_KERNELS)
                     - {f.split(":")[1].split("<")[0] for f in wgmma}) + \
        sorted(set(QMM_INSTANCES + RAGGED_SPLIT_INSTANCES)
               - {f.split(":")[1] for f in wgmma})
    spilled = [f for f, v in wgmma.items()
               if " 0 bytes spill stores" not in v.get("spill", "")]
    emit({"phase": "build", "seconds": secs, "sources": sorted(built),
          "spill_checked": sorted(wgmma), "ptxas": ptxas})
    if missing:
        raise AssertionError(f"ptxas reported no {missing}")
    if spilled:
        raise AssertionError(f"ptxas spills in {spilled}")


# the warp-specialised kernels whose every instance must not spill
WGMMA_KERNELS = ("fwd_wgmma_kernel", "dq_wgmma_kernel", "dkv_wgmma_kernel",
                 "qmm_wgmma_kernel")
# the gemm's instances: every weight format (int8, e4m3, e5m2, int4) at
# every token tile
QMM_INSTANCES = tuple(f"qmm_wgmma_kernel<{fmt},{mt}>" for fmt in range(4)
                      for mt in range(8, 65, 8))
# the split ragged kernel's instances: (pool type, head_dim)
RAGGED_SPLIT_INSTANCES = ("ragged_split_kernel<bf16,128>",
                          "ragged_split_kernel<bf16,64>",
                          "ragged_split_kernel<int8,128>")


def _ptxas_by_function(log):
    """`-Xptxas -v` lines by kernel: {"fwd_wgmma_kernel<bf16,128>":
    {"spill": ..., "registers": ...}} (a short form of each mangled
    entry name and its template arguments)."""
    out, cur = {}, None
    types = {"13__nv_bfloat16": "bf16", "6__half": "f16", "a": "int8"}
    arg = re.compile(r"Li(-?\d+)E|13__nv_bfloat16|6__half|a")
    for ln in log.splitlines():
        m = re.search(r"Compiling entry function '(\S+)'", ln)
        if m:
            cur = name = m.group(1)
            # the mangled kernel name: <length><name>, then I, its
            # arguments (types, or L<type><value>E), E
            for i in range(len(name)):
                k = re.match(r"(\d+)(\w+?_kernel)", name[i:])
                if k and int(k.group(1)) == len(k.group(2)):
                    cur, j, args = k.group(2), i + k.end(), []
                    if name[j:j + 1] == "I":
                        j += 1
                        while (a := arg.match(name, j)) is not None:
                            args.append(a.group(1) or types[a.group(0)])
                            j = a.end()
                    if args:
                        cur += f"<{','.join(args)}>"
                    break
            out[cur] = {}
        elif cur and "spill" in ln:
            out[cur]["spill"] = ln.strip()
        elif cur and "registers" in ln:
            out[cur]["registers"] = ln.split("info    :")[-1].strip()
    return out


def _composition(kv_heads, dtype, gen, quant=False, name="serve", bs=16):
    """A ragged batch of `kernel_compare.RAGGED_COMPOSITIONS` at T = 8 +
    32 packed slots and Llama-2-7B width (`serve`: six decode lanes at
    kv_len ~512, an empty lane, a 32-token prefill chunk crossing two
    block boundaries, two guard slots; `decode8`: the steady decode step;
    `prefill512`: a 32-token chunk at kv_len 512 beside 7 decode lanes).
    `quant`: int8 pools and their scale planes, from `quantize_kv` of
    random K/V; `bs`: slots a page."""
    from paddle_tpu_torch.tools.kernel_compare import (RAGGED_COMPOSITIONS,
                                                       ragged_inputs)

    args, scales, pos = ragged_inputs(name, kv_heads, quant, dtype, gen, bs)
    if bs != 16:
        # the same tokens in 8-slot pages: the block table is twice as wide
        assert args[3].shape[1] == 16 // bs * 128
    q, kc = args[0], args[1]
    t, h, d = q.shape
    q_lens, kv_lens = RAGGED_COMPOSITIONS[name]
    # the least work: each lane's K/V (and, int8, its scales) read once,
    # q read and out written once, the metadata read once; 4 * H * D flops
    # per (token, attended position)
    pos_h = pos.cpu().numpy()
    item = q.element_size()
    per_pos = kv_heads * (d * kc.element_size() + (4 if quant else 0)) * 2
    meta_bytes = 4 * (2 * t + len(kv_lens)
                      + sum(-(-n // bs) for n in kv_lens))
    nbytes = 2 * t * h * d * item + sum(kv_lens) * per_pos + meta_bytes
    flops = 4 * h * d * int((pos_h[pos_h >= 0] + 1).sum())
    return args, scales, pos_h, nbytes, flops


def _instance(args, quant):
    """The instance `ragged_plan` picks for these inputs on this card."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    p = pa._plan(args[0], args[1], args[3], quant)
    if p.splits == 0:
        return {"instance": "general"}
    return {"instance": "split", "splits": p.splits,
            "tile_tokens": p.tile_tokens, "slots": p.slots,
            "smem_bytes": p.smem_bytes}


def _attention_cases(quant, cases):
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.tools.kernel_compare import RAGGED_COMPOSITIONS

    gen = torch.Generator(device="cuda").manual_seed(1)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for name, kvh, dtype, tol, comp, bs, instance in cases:
        args, sc, pos, nbytes, flops = _composition(kvh, dtype, gen, quant,
                                                    comp, bs)
        plan = _instance(args, quant)
        if plan["instance"] != instance:
            raise AssertionError(f"{name}: ragged_plan picked {plan}, "
                                 f"expected the {instance} instance")
        out = pa.paged_attention_ragged(*args, **sc)
        ref = pa.paged_attention_ragged_ref(*args, **sc)
        torch.cuda.synchronize()
        o, r = out.float(), ref.float()
        err = float((o - r).abs().max())
        if not torch.allclose(o, r, atol=tol, rtol=tol):
            raise AssertionError(f"{name}: kernel != plain version, max "
                                 f"abs err {err} (atol=rtol={tol})")
        guard = torch.from_numpy(pos < 0).cuda()
        n_guard = args[0].shape[0] - sum(RAGGED_COMPOSITIONS[comp][0])
        if int(guard.sum()) != n_guard or n_guard == 0 or \
                bool((out[guard] != 0).any()):
            raise AssertionError(f"{name}: guard rows are not exact zeros")
        kernel_ms = time_ms(lambda: pa.paged_attention_ragged(*args, **sc),
                            flush)
        plain_ms = time_ms(
            lambda: pa.paged_attention_ragged_ref(*args, **sc), flush,
            reps=20)
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS
                                   if dtype == torch.bfloat16 else F32_FLOPS)
        results[name] = {
            "composition": comp, "block_size": bs, **plan,
            "kv_heads": kvh, "dtype": str(dtype).replace("torch.", ""),
            "tol": tol, "max_abs_err": err, "guard_rows": n_guard,
            "kernel_ms": kernel_ms, "plain_ms": plain_ms, "bytes": nbytes,
            "flops": flops, "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None}
        del args, sc, out, ref
    return results


def _attention_shapes():
    from paddle_tpu_torch.tools.kernel_compare import RAGGED_GEOMETRY
    from paddle_tpu_torch.tools.serve_workload import B

    return dict(RAGGED_GEOMETRY, B=B)


# (name, kv heads, dtype, tolerance, composition, block size, the instance
# ragged_plan must pick): the serving composition in MHA, GQA and f32, the
# steady decode step and a 32-token chunk at kv_len 512 at full width, and
# the serving composition over 8-slot pages (the general instance). bf16:
# a few times the largest error seen (9.8e-4), below the ~5e-3 a decode
# lane's output moves if its mask is one position off; f32 1e-4.
ATTENTION_CASES = (
    ("mha_bf16", 32, torch.bfloat16, 4e-3, "serve", 16, "split"),
    ("gqa_bf16", 8, torch.bfloat16, 4e-3, "serve", 16, "split"),
    ("mha_f32", 32, torch.float32, 1e-4, "serve", 16, "general"),
    ("decode8_bf16", 32, torch.bfloat16, 4e-3, "decode8", 16, "split"),
    ("prefill512_bf16", 32, torch.bfloat16, 4e-3, "prefill512", 16,
     "split"),
    ("mha_bf16_bs8", 32, torch.bfloat16, 4e-3, "serve", 8, "general"),
)


def phase_kernel():
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    results = _attention_cases(False, ATTENTION_CASES)
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
    results = _attention_cases(True, ATTENTION_CASES)
    emit({"phase": "kernel", "kernel": "ragged_paged_attention_q",
          "shapes": dict(_attention_shapes(), pool="int8 + f32 scales"),
          "launches": pa.LAUNCHES_Q.count, "cases": results})
    return results


# per output row, relative to the row's largest |ref| (the rule of the
# flash forward's check): bf16 2^-6, a few bf16 ulps of that value (both sides sum
# in f32 and round the output once); f32 1e-5 (summation order). A row
# with no live key must be exactly 0.
ROW_REL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}


def _row_check(name, out, ref, dead):
    """Hold `out` to `ref` row by row (rows over the last axis) and the
    `dead` rows to exact zeros; returns the largest error and the largest
    row-relative error."""
    o, r = out.float(), ref.float()
    row_err = (o - r).abs().amax(dim=-1)
    row_mag = r.abs().amax(dim=-1)
    tol = ROW_REL[out.dtype] * row_mag
    bad = ~(row_err <= tol)
    bad[dead] = False
    if bool(bad.any()):
        worst = int((row_err - tol).flatten().argmax())
        raise AssertionError(f"{name}: row {worst} (flat index) off by "
                             f"{float(row_err.flatten()[worst])}")
    if bool((out[dead] != 0).any()):
        raise AssertionError(f"{name}: rows with no live key are not "
                             "exact zeros")
    live = ~dead
    rel = float((row_err[live] / row_mag[live].clamp_min(1e-30)).max())
    return float(row_err.max()), rel


def _paged_inputs(kv_heads, dtype, gen, s=None, bs=16, d=128):
    """`kernel_compare.paged_inputs`: the serve workload's context lengths
    (`default_rng(0)`, 64-512) plus an empty sequence and one of 3
    tokens, over the serving pool's slots in pages of `bs` (tables of 2048
    slots), H 32; q [B, H, D] (decode, `s` None) or [B, S, H, D]. Also
    the dead rows and the least bytes and operations of the call."""
    from paddle_tpu_torch.tools.kernel_compare import paged_inputs

    args, ctx = paged_inputs(kv_heads, dtype, gen, s, bs, d)
    q = args[0]
    h, b = q.shape[-2], len(ctx)
    # rows of each sequence and their last visible position
    sq = 1 if s is None else s
    last = np.asarray(ctx)[:, None] - sq + np.arange(sq)[None, :]  # [B, S]
    item = q.element_size()
    nbytes = (2 * q.numel() * item + sum(ctx) * 2 * kv_heads * d * item
              + 4 * (b + sum(-(-n // bs) for n in ctx)))
    flops = 4 * h * d * int(np.clip(last + 1, 0, None).sum())
    return args, last < 0, nbytes, flops


def _paged_cases(verify, cases, flush, gen):
    """Check and time each case, asserting the instance it takes (the
    split instance in window mode, or the decode / verify kernel); a case
    over pages of 16 k slots on the split instance also gives the bits of
    the same keys in 16-slot pages. Returns the results and the launches
    of the checked calls (one per case)."""
    from paddle_tpu_torch.ops.kernels import paged_attention as pa
    from paddle_tpu_torch.tools.kernel_compare import as_16_slot_pages

    fn = pa.paged_attention_verify if verify else pa.paged_attention
    ref_fn = pa.paged_attention_verify_ref if verify else \
        pa.paged_attention_ref
    counter = pa.LAUNCHES_VERIFY if verify else pa.LAUNCHES_DECODE
    results, checked = {}, 0
    for name, kvh, dtype, s, bs, d, instance in cases:
        label = f"{'verify' if verify else 'decode'} {name}"
        args, dead, nbytes, flops = _paged_inputs(kvh, dtype, gen, s, bs, d)
        split = pa._window_split(args[0], args[1], args[3])
        if split != (instance == "split"):
            raise AssertionError(f"{label}: takes the "
                                 f"{'split' if split else 'general'} "
                                 f"instance, expected the {instance} one")
        before = counter.count
        out = fn(*args)
        checked += counter.count - before
        ref = ref_fn(*args)
        torch.cuda.synchronize()
        dead_t = torch.from_numpy(dead if verify else dead[:, 0]).cuda()
        err, rel = _row_check(label, out, ref, dead_t)
        res = {"kv_heads": kvh, "dtype": str(dtype).replace("torch.", ""),
               "S": s, "block_size": bs, "head_dim": d,
               "instance": instance, "batch": int(args[0].shape[0]),
               "row_rel_tol": ROW_REL[dtype], "max_abs_err": err,
               "row_rel_err": rel, "dead_rows": int(dead.sum()) if verify
               else int(dead[:, 0].sum())}
        if split and bs != 16:
            same = fn(args[0], *as_16_slot_pages(*args[1:4]), args[4])
            res["bits_of_16_slot_pages"] = bool(torch.equal(out, same))
            if not res["bits_of_16_slot_pages"]:
                raise AssertionError(f"{label}: {bs}-slot pages differ "
                                     "from the same keys in 16-slot pages")
        if verify:
            # the ragged kernel on the same windows: lane b holds S query
            # tokens at positions ctx - S .. ctx - 1 (negative: guards);
            # on the split instance the same bits
            q, kc, vc, tables, lens = args
            b, sq, h, d = q.shape
            ql = torch.full((b,), sq, dtype=torch.int32, device="cuda")
            lane, pos = pa.ragged_metadata(ql, lens, b * sq)
            rag = pa.paged_attention_ragged(q.reshape(b * sq, h, d), kc, vc,
                                            tables, lens, lane, pos)
            torch.cuda.synchronize()
            res["vs_ragged_max_abs_err"], res["vs_ragged_row_rel_err"] = \
                _row_check(f"{label} vs ragged", out,
                           rag.reshape(b, sq, h, d), dead_t)
            if split and res["vs_ragged_max_abs_err"] != 0.0:
                raise AssertionError(f"{label}: not the ragged kernel's "
                                     "bits on the same windows")
        res["kernel_ms"] = time_ms(lambda: fn(*args), flush)
        res["plain_ms"] = time_ms(lambda: ref_fn(*args), flush, reps=10)
        res["bound_ms"], res["bound_by"] = bound(
            nbytes, flops, BF16_FLOPS if dtype == torch.bfloat16
            else F32_FLOPS)
        res.update(bytes=nbytes, flops=flops, library_ms=None)
        results[name] = res
        del args, out, ref
    if checked != len(cases):
        raise AssertionError(f"{counter.name}: {checked} launches for "
                             f"{len(cases)} checked calls")
    return results, checked


# (name, kv heads, dtype, S (None: decode), slots a page, head_dim, the
# instance): bf16 at the split shapes in 16- and 64-slot pages (64:
# `block_multihead_attention`'s default), and what the split instance
# refuses (f32, head_dim 96, 8-slot pages) on the decode / verify kernel
_BF16, _F32 = torch.bfloat16, torch.float32
DECODE_CASES = (
    ("mha_bf16", 32, _BF16, None, 16, 128, "split"),
    ("gqa_bf16", 8, _BF16, None, 16, 128, "split"),
    ("mha_f32", 32, _F32, None, 16, 128, "general"),
    ("gqa_f32", 8, _F32, None, 16, 128, "general"),
    ("mha_bf16_bs64", 32, _BF16, None, 64, 128, "split"),
    ("gqa_bf16_bs64", 8, _BF16, None, 64, 128, "split"),
    ("mha_bf16_d96", 32, _BF16, None, 16, 96, "general"),
    ("mha_bf16_bs8", 32, _BF16, None, 8, 128, "general"))
VERIFY_CASES = (
    ("mha_bf16_s5", 32, _BF16, 5, 16, 128, "split"),
    ("gqa_bf16_s5", 8, _BF16, 5, 16, 128, "split"),
    ("mha_f32_s5", 32, _F32, 5, 16, 128, "general"),
    ("gqa_f32_s5", 8, _F32, 5, 16, 128, "general"),
    ("mha_bf16_s64", 32, _BF16, 64, 16, 128, "split"),
    ("gqa_bf16_s64", 8, _BF16, 64, 16, 128, "split"),
    ("gqa_f32_s64", 8, _F32, 64, 16, 128, "general"),
    ("mha_bf16_s5_bs64", 32, _BF16, 5, 64, 128, "split"),
    ("gqa_bf16_s64_bs64", 8, _BF16, 64, 64, 128, "split"),
    ("mha_bf16_s5_d96", 32, _BF16, 5, 16, 96, "general"),
    ("mha_bf16_s5_bs8", 32, _BF16, 5, 8, 128, "general"))


def phase_paged():
    """The decode and verify calls against their plain versions at the
    serving shapes (`_paged_inputs`), row by row (`ROW_REL`), each in the
    instance it must take, and verify against the ragged kernel on the
    same windows (bit-equal on the split instance). No one PyTorch call
    computes paged attention over a block table, so `library_ms` is
    null."""
    gen = torch.Generator(device="cuda").manual_seed(13)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    decode, _ = _paged_cases(False, DECODE_CASES, flush, gen)
    emit({"phase": "paged_decode", "kernel": "paged_attention_decode",
          "shapes": {"H": 32, "D": 128, "slots": 2048}, "cases": decode})
    verify, verify_launches = _paged_cases(True, VERIFY_CASES, flush, gen)
    emit({"phase": "paged_verify", "kernel": "paged_attention_verify",
          "shapes": {"H": 32, "D": 128, "slots": 2048},
          "launches_checked": verify_launches, "cases": verify})
    del flush
    release()
    return decode, verify, verify_launches


def _gemm_cases(fmt, shapes, gen, flush, x_dtype=torch.bfloat16,
                table=GEMM_SHAPES, m=GEMM_M):
    from paddle_tpu_torch.nn import quant as nq
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    int4 = fmt == "int4"
    fn = qm.quant_matmul_int4 if int4 else qm.quant_matmul
    ref_fn = qm.quant_matmul_int4_ref if int4 else qm.quant_matmul_ref
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    results = {}
    for name in shapes:
        n, k = table[name]
        w = torch.randn((n, k), generator=gen, device="cuda") * 0.02
        x = torch.randn((m, k), generator=gen,
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
        # split-K sums its partials in a fixed order: a repeat is bit-equal
        again = fn(x, wq, s)
        if not torch.equal(out, again):
            raise AssertionError(f"{fmt} {name}: a repeat call differs")
        kernel_ms = time_ms(lambda: fn(x, wq, s), flush)
        plain_ms = time_ms(lambda: ref_fn(x, wq, s), flush, reps=10)
        w16 = deq * s[:, None].to(torch.bfloat16)
        library_ms = time_ms(lambda: torch.matmul(
            x.to(torch.bfloat16), w16.t()), flush)
        w_bytes = wq.numel() * wq.element_size()
        nbytes = (x.numel() * x.element_size() + w_bytes + 4 * n
                  + m * n * x.element_size())
        flops = 2 * m * n * k
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS
                                   if x_dtype == torch.bfloat16 else
                                   F32_FLOPS)
        split_k = x_dtype == torch.bfloat16
        results[f"{name}_{fmt}" + ("" if x_dtype == torch.bfloat16
                                   else "_f32")] = {
            "N": n, "K": k, "M": m, "tol": tol,
            "max_abs_err": err, "kernel_ms": kernel_ms,
            "plain_ms": plain_ms, "library_ms": library_ms,
            "weight_bytes": w_bytes, "bytes": nbytes, "flops": flops,
            "bound_ms": bound_ms, "bound_by": bound_by,
            "splits": qm.gemm_plan(m, n, k, sms, int4).splits
            if split_k else 1,
            "gb_per_s": nbytes / kernel_ms / 1e6,
            "bound_fraction": bound_ms / kernel_ms,
            "repeat_bit_equal": True}
        del x, wq, s, deq, w16, out, ref, again
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


def _legacy_reference(mode, cpu, gpu):
    """`prefill` (right-padded, with `lens`) and two `decode_step`s on a
    full-precision pool, then a verify window of S = 5 in every mode, on
    the card against the CPU: logits within 1e-3. Rows use blocks 20-23,
    away from the ragged steps' tables."""
    rng = np.random.default_rng(6)
    tables = np.zeros((2, 16), np.int32)
    tables[:, :2] = [[20, 21], [22, 23]]
    calls = []
    if cpu.kv_bits == 16:
        ids = rng.integers(1, 512, (2, 24)).astype(np.int32)
        lens = np.asarray([24, 17], np.int32)
        calls.append(("prefill", (ids, tables, lens)))
        for step in range(2):
            calls.append(("decode_step", (
                rng.integers(1, 512, 2).astype(np.int32),
                lens + 1 + step, tables)))
    calls.append(("verify_step", (
        rng.integers(1, 512, (2, 5)).astype(np.int32),
        np.asarray([31, 24], np.int32), tables)))
    errs = {}
    for name, args in calls:
        a = getattr(cpu, name)(*args)
        b = getattr(gpu, name)(*args).cpu()
        err = float((a - b).abs().max())
        errs[name] = max(errs.get(name, 0.0), err)
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"{mode}: {name} on the card != CPU run: "
                                 f"max abs err {err}")
    return {f"{name}_max_abs_err": e for name, e in errs.items()}


def phase_reference():
    """The whole engine step on the card against its CPU run (plain
    versions) on a small f32 model with the serving head_dim, in every
    quantization mode: three ragged steps, then `_legacy_reference`'s
    prefill / decode / verify calls; then the tie-aware greedy agreement
    of the int8 engine against the full-precision one on the card."""
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
                        pool_steps, "scale_max_rel": scale_rel,
                        **_legacy_reference(mode, cpu, gpu)}
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
          "hidden=256, heads=2, kv_heads=1) f32", "ragged_steps": 3,
          "legacy": "prefill + 2 decode_steps (kv_bits 16), verify S = 5",
          "tol": 1e-3,
          "modes": report, "max_abs_err": max(r["max_abs_err"]
                                              for r in report.values()),
          "greedy_agreement_kv8_q8": agree})
    release()


# the kernels a serve or generate run may launch, by launch counter
SERVE_KERNELS = ("ragged_paged_attention", "ragged_paged_attention_q",
                 "paged_attention", "paged_attention_verify",
                 "quant_matmul", "quant_matmul_int4")
# the engine's call counters (`serving.*` in the port's monitor)
ENGINE_CALLS = ("ragged_steps", "verify_steps", "legacy_decode_steps",
                "prefill_steps")


def _engine_calls(monitor):
    return {c: monitor.get(f"serving.{c}") for c in ENGINE_CALLS}


def _reset_engine_calls(monitor):
    """Zero the engine-call counters (`monitor.reset(name)` zeroes one)."""
    for c in ENGINE_CALLS:
        monitor.reset(f"serving.{c}")


def _teacher_forced(engine, prompt, tokens, cand_rows, step=None):
    """Score `prompt + tokens[:-1]` teacher-forced through the plain
    engine's `ragged_step` (one step, or steps of `step` packed slots)
    and judge each greedy token against it (`_judge`)."""
    seq = 2_000_000                   # out of any request id space
    ctx = np.concatenate([np.asarray(prompt, np.int32),
                          np.asarray(tokens[:-1], np.int32)])
    n = len(ctx)
    step = step or n
    engine.manager.allocate(seq, n)
    try:
        tables = engine.manager.block_table_array([seq])
        parts = []
        for start in range(0, n, step):
            m = min(step, n - start)
            packed = np.zeros((step,), np.int32)
            packed[:m] = ctx[start:start + m]
            parts.append(engine.ragged_step(
                packed, np.array([m], np.int32),
                np.array([start + m], np.int32), tables)[:m])
        logits = torch.cat(parts)
    finally:
        engine.manager.free(seq)
    return _judge(logits[len(prompt) - 1:n], tokens, cand_rows)


def _judge(ref, tokens, cand_rows):
    """Hold each greedy token to the reference row's top-1, or to
    `greedy_agreement`'s tie rule: the reference's margin between its
    top-1 and the token within twice the position's logit perturbation,
    max |candidate - reference| over the vocabulary, where the candidate
    row is the logits the token was picked from (its argmax, checked
    here). Returns (top-1 matches, tie-aware matches, tokens, largest
    perturbation)."""
    ref = ref.double()
    cand = torch.stack(list(cand_rows)).double()
    tok = torch.as_tensor(np.asarray(tokens), device=ref.device)
    if not bool((cand.argmax(-1) == tok).all()):
        raise AssertionError("a greedy token is not the argmax of the "
                             "logits it was recorded with")
    idx = torch.arange(len(tokens), device=ref.device)
    top = ref.argmax(-1)
    match = top == tok
    eps = (cand - ref).abs().amax(-1)
    tie = ref[idx, top] - ref[idx, tok] <= 2.0 * eps
    return (int(match.sum()), int((match | tie).sum()), len(tokens),
            float(eps.max()))


def _generate_reference(engine, prompts, out, n_new):
    """Teacher-forced logits [B, n_new, V] for `generate`'s tokens, with
    generate's own row counts: the same `prefill` of the prompts (the
    rows it picked token 0 from), then per new token one `ragged_step`
    holding one token of every sequence, where generate's `decode_step`
    ran. Only the attention kernel differs: ragged for decode."""
    b, s = prompts.shape
    mgr = engine.manager
    seqs = [2_000_000 + i for i in range(b)]   # out of any id space
    for sid in seqs:
        mgr.allocate(sid, s)
    try:
        rows = [engine.prefill(prompts, mgr.block_table_array(seqs))]
        for j in range(1, n_new):
            for sid in seqs:
                mgr.append_token(sid)
            rows.append(engine.ragged_step(
                np.ascontiguousarray(out[:, s + j - 1]),
                np.ones((b,), np.int32), np.full((b,), s + j, np.int32),
                mgr.block_table_array(seqs)))
    finally:
        for sid in seqs:
            mgr.free(sid)
    return torch.stack(rows, 1)


def _agreement_gate(label, results, min_top1):
    """Sum `_judge` results; tie-aware agreement must be 1.0 and strict
    top-1 at least `min_top1`."""
    m, t, n, eps = (sum(r[0] for r in results), sum(r[1] for r in results),
                    sum(r[2] for r in results),
                    max(r[3] for r in results))
    out = {"tokens_checked": n, "top1": m / n, "tie_aware": t / n,
           "max_logit_perturbation": eps, "min_top1": min_top1}
    if out["tie_aware"] < 1.0 or out["top1"] < min_top1:
        raise AssertionError(f"{label}: teacher-forced agreement {out}")
    return out


def _record_spec(fe):
    """Record, per request, the verify logits row each committed token
    was sampled from, and each decode round's drafts with the logits
    that judged them (device views: no host sync in the timed run)."""
    sched = fe.scheduler
    engine = sched.engine
    proposer = sched.spec.proposer
    state = {"logits": None, "count": {}, "drafts": {}}
    rows, rounds = {}, {}
    verify, commit = engine.verify_step, sched._commit_token
    propose = proposer.propose

    def propose_rec(seq_id, context, k):
        out = propose(seq_id, context, k)
        state["drafts"][seq_id] = list(out)
        return out

    def verify_rec(*a):
        state["logits"] = verify(*a)
        state["count"] = {}
        return state["logits"]

    def commit_rec(req, tok, slot, t_tok, **kw):
        j = state["count"].get(req.req_id, 0)
        state["count"][req.req_id] = j + 1
        lg = state["logits"]
        rows.setdefault(req.req_id, []).append(lg[slot, j])
        drafts = state["drafts"].pop(req.req_id, None) if j == 0 else None
        if drafts is not None:
            rounds.setdefault(req.req_id, []).append((lg[slot], drafts))
        return commit(req, tok, slot, t_tok, **kw)

    proposer.propose = propose_rec
    engine.verify_step = verify_rec
    sched._commit_token = commit_rec
    return rows, rounds


def _greedy_acceptance(rounds):
    """Accepted / proposed drafts over greedy rounds: a draft is accepted
    while it equals the argmax of its window row."""
    accepted = proposed = 0
    for window, drafts in rounds:
        top = window[:len(drafts)].argmax(-1).tolist()
        a = 0
        while a < len(drafts) and drafts[a] == top[a]:
            a += 1
        accepted += a
        proposed += len(drafts)
    return accepted, proposed


def _weights_gb(*engines):
    """Device bytes of the engines' weights, each storage counted once."""
    seen, total = set(), 0
    for eng in engines:
        stack = list(eng.params.values())
        while stack:
            t = stack.pop()
            if isinstance(t, (list, tuple)):
                stack.extend(t)
            elif isinstance(t, dict):
                stack.extend(t.values())
            elif torch.is_tensor(t) and t.data_ptr() not in seen:
                seen.add(t.data_ptr())
                total += t.numel() * t.element_size()
    return total / 2 ** 30


def _serve(label, kv_bits, wbits, kind, smi, spec=None):
    """Serve the workload once in one mode; the launch and engine-call
    counts are zeroed just before the run and read just after it. With
    `spec`, every greedy token is also held teacher-forced to the plain
    engine (`_teacher_forced`)."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.serve_workload import (LAYERS, NEW_TOKENS,
                                                       serve_workload)

    t0 = time.perf_counter()
    fe, requests = serve_workload(kv_bits=kv_bits, wbits=wbits, spec=spec)
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
    if spec is not None:
        rows, rounds = _record_spec(fe)

    fe.metrics.reset_window()
    torch.cuda.reset_peak_memory_stats()
    _support.reset_launch_counts()
    _reset_engine_calls(monitor)
    monitor.reset_prefix("serving.spec_")
    t1 = time.perf_counter()
    handles = [fe.submit(p, **kw) for p, kw in requests]
    steps = fe.run_until_idle()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c: _support.launch_counter(c).count for c in SERVE_KERNELS}
    calls = _engine_calls(monitor)

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
    steps_main = calls["ragged_steps"] + calls["verify_steps"]
    expect = {c: 0 for c in launches}
    expect[attn] = LAYERS * steps_main
    # the draft engine's decode steps (a self-draft: the same depth)
    expect["paged_attention"] = LAYERS * calls["legacy_decode_steps"]
    if gemm is not None:
        # four projections per layer and the untied head
        expect[gemm] = (4 * LAYERS + 1) * steps_main
    # plain serving only ragged-steps, speculative serving only verifies,
    # and only a draft engine decodes (and prefills)
    want_calls = (calls["ragged_steps"] > 0) == (spec is None) and \
        (calls["verify_steps"] > 0) == (spec is not None) and \
        (calls["legacy_decode_steps"] > 0) == (spec == "draft") and \
        (calls["prefill_steps"] > 0) == (spec == "draft")
    if not want_calls or launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"{expect} over engine calls {calls}")
    s = fe.summary()
    tokens_out = sum(len(h.tokens) for h in handles)
    out = {"phase": label,
           "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
           "kv_bits": kv_bits, "wbits": wbits or 16, "spec": spec,
           "requests": len(handles),
           "prompt_lens": [len(p) for p, _ in requests],
           "tokens_out": tokens_out, "scheduler_steps": steps,
           "engine_calls": calls, "kernel_launches": launches,
           "wall_s": wall, "tok_s": tokens_out / wall,
           "ttft_p50_ms": s["serving.ttft_p50_ms"],
           "tpot_p50_ms": s["serving.tpot_p50_ms"],
           "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
           "kv_bytes_per_token": info["kv_bytes_per_token"],
           "setup_s": setup_s, "device": kind, "nvidia_smi": smi,
           "sample_tokens": handles[0].tokens[:8]}
    if spec is not None:
        greedy = [(h, p) for h, (p, kw) in zip(handles, requests)
                  if not kw.get("temperature")]
        # the reference steps through the context in packed steps of the
        # verify's token count (B x (K + 1)), so every gemm runs at the
        # row count the verify gave it: a bf16 gemm's rounding depends on
        # its shape, and one step over the whole context puts random
        # weights' near-ties a rounding apart (PERF.md)
        vstep = len(fe.scheduler.slots) * (fe.scheduler.spec.num_draft_tokens
                                           + 1)
        out["teacher_forced_greedy"] = _agreement_gate(label, [
            _teacher_forced(engine, p, h.tokens, rows[h.request_id], vstep)
            for h, p in greedy], 0.99)
        g_acc, g_prop = _greedy_acceptance(
            [r for h, _p in greedy for r in rounds.get(h.request_id, [])])
        out.update(
            spec_k=fe.scheduler.spec.num_draft_tokens,
            acceptance_pct=s["serving.spec_acceptance_pct"],
            greedy_acceptance_pct=100.0 * g_acc / max(g_prop, 1),
            greedy_proposed=g_prop,
            tokens_per_lane_step=s["serving.spec_tokens_per_lane_step"],
            proposed=s["serving.spec_proposed_tokens"],
            accepted=s["serving.spec_accepted_tokens"])
        engines = [engine]
        if spec == "draft":
            draft = fe.scheduler.spec.proposer.engine
            engines.append(draft)
            dm = draft.manager
            if dm.free_blocks != dm.num_blocks:
                raise AssertionError(f"{label}: the draft engine still "
                                     f"holds {dm.num_blocks - dm.free_blocks}"
                                     " blocks")
        out["weights_gb"] = _weights_gb(*engines)
        out["kv_pools_gb"] = sum(
            (e.k_cache.numel() * e.k_cache.element_size()) * 2 / 2 ** 30
            for e in engines)
    emit(out)
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


def phase_generate(kind, smi):
    """`LlamaInferenceEngine.generate` (`generate_workload`: Llama-2-7B
    width, 32 layers, bf16, the serve workload's weights; 2 prompts of
    128 tokens, 16 new greedy tokens). Gates: exactly 32 decode-kernel
    launches per `decode_step` and none of the other attention kernels;
    every token teacher-forced against the same prefill and one-token
    `ragged_step`s on the same context (`_generate_reference`): top-1 >=
    0.99 and tie-aware 1.0."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.serve_workload import (GEN_NEW, LAYERS,
                                                       generate_workload)

    t0 = time.perf_counter()
    engine, prompts, config = generate_workload()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    engine.generate(prompts[:, :16], max_new_tokens=2)      # warm-up
    rows = []
    prefill, decode = engine.prefill, engine.decode_step

    def record(fn):
        def wrapper(*a, **kw):
            out = fn(*a, **kw)
            rows.append(out)
            return out
        return wrapper

    engine.prefill, engine.decode_step = record(prefill), record(decode)
    torch.cuda.reset_peak_memory_stats()
    _support.reset_launch_counts()
    _reset_engine_calls(monitor)
    t1 = time.perf_counter()
    out = engine.generate(prompts, config)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c: _support.launch_counter(c).count for c in SERVE_KERNELS}
    calls = _engine_calls(monitor)
    engine.prefill, engine.decode_step = prefill, decode
    b, s = prompts.shape
    if out.shape != (b, s + GEN_NEW) or not (out[:, :s] == prompts).all():
        raise AssertionError(f"generate: output shape {out.shape}")
    expect = {c: 0 for c in launches}
    expect["paged_attention"] = LAYERS * calls["legacy_decode_steps"]
    if calls != {"ragged_steps": 0, "verify_steps": 0,
                 "legacy_decode_steps": GEN_NEW, "prefill_steps": 1} \
            or launches != expect:
        raise AssertionError(f"generate: kernel launches {launches} != "
                             f"{expect} over engine calls {calls}")
    # row j of call j scored token j of every sequence (the last decode
    # step's pick is discarded, as in the JAX engine)
    ref = _generate_reference(engine, prompts, out, GEN_NEW)
    agree = _agreement_gate("generate", [
        _judge(ref[i], out[i, s:], [r[i] for r in rows[:GEN_NEW]])
        for i in range(b)], 0.99)
    emit({"phase": "generate",
          "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
          "prompts": [b, s], "new_tokens": GEN_NEW, "engine_calls": calls,
          "kernel_launches": launches, "wall_s": wall,
          "tok_s": b * GEN_NEW / wall,
          "ms_per_decode_step": wall * 1e3 / GEN_NEW,
          "teacher_forced_greedy": agree,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "setup_s": setup_s, "device": kind, "nvidia_smi": smi,
          "sample_tokens": out[0, s:s + 8].tolist()})
    # the saved bound methods hold the engine too
    del engine, prefill, decode, rows
    release()
    return launches


def phase_serve_spec(kind, smi):
    """Speculative serving of the repetition trace (`serve_workload(spec=
    ...)`, K = 4): with `NGramProposer`, then with a self-draft engine.
    Gates (in `_serve`): every request FINISHED with 32 tokens; exactly
    32 ragged-kernel launches per verify step, 32 decode-kernel launches
    per draft `decode_step`, no verify-kernel launch; every greedy token
    teacher-forced against the plain engine (top-1 >= 0.99, tie-aware
    1.0)."""
    fe, _r, ngram = _serve("serve_spec_ngram", 16, None, kind, smi,
                           spec="ngram")
    del fe
    release()
    fe, _r, draft = _serve("serve_spec_draft", 16, None, kind, smi,
                           spec="draft")
    del fe
    release()
    return ngram, draft


def _prefix_run(fe, trace, shared_idx, kv_bits, label):
    """Drive the shared-prefix trace once on `fe` (its warm-up already
    served) with the launch and engine-call counts zeroed just before
    and read just after; gate it (every request FINISHED with its tokens,
    no leaked block, the manager's refcounts consistent with the tree's
    leases, exactly 32 ragged launches a ragged step and no other
    kernel) and return its numbers."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.serve_workload import (LAYERS, PREFIX_NEW,
                                                       drive_prefix_trace)

    sch = fe.scheduler
    tree = sch.prefix_cache
    stats0 = tree.stats() if tree is not None else None
    fe.metrics.reset_window()
    _support.reset_launch_counts()
    _reset_engine_calls(monitor)
    pre0 = monitor.get("serving.prefill_tokens")
    preempt0 = monitor.get("serving.preemptions")
    torch.cuda.synchronize()
    t1 = time.perf_counter()
    handles, steps = drive_prefix_trace(fe, trace)
    torch.cuda.synchronize()
    wall = time.perf_counter() - t1
    launches = {c: _support.launch_counter(c).count for c in SERVE_KERNELS}
    calls = _engine_calls(monitor)
    bad = [(h.request_id, h.status.value, h.finish_reason, len(h.tokens))
           for h in handles
           if h.status.value != "finished" or len(h.tokens) != PREFIX_NEW]
    if bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{PREFIX_NEW} tokens: {bad}")
    mgr = sch.engine.manager
    leaked = sch.kv_leaked_blocks()
    if leaked:
        raise AssertionError(f"{label}: {leaked} leaked blocks")
    mgr.check_consistency(external=None if tree is None
                          else tree.block_ref_counts())
    attn = "ragged_paged_attention_q" if kv_bits == 8 else \
        "ragged_paged_attention"
    expect = {c: 0 for c in launches}
    expect[attn] = LAYERS * calls["ragged_steps"]
    if launches != expect or calls["ragged_steps"] == 0 or any(
            calls[c] for c in ENGINE_CALLS if c != "ragged_steps"):
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"{expect} over engine calls {calls}")
    ttft = [h.ttft_ms() for i, h in enumerate(handles) if i in shared_idx]
    out = {"ragged_steps": calls["ragged_steps"], "scheduler_steps": steps,
           "wall_s": wall, "tok_s": len(handles) * PREFIX_NEW / wall,
           "ttft_shared_p50_ms": float(np.percentile(ttft, 50)),
           "ttft_shared_p99_ms": float(np.percentile(ttft, 99)),
           "prefill_tokens": monitor.get("serving.prefill_tokens") - pre0,
           "preemptions": monitor.get("serving.preemptions") - preempt0,
           "launches": launches[attn], "leaked_blocks": leaked}
    if tree is not None:
        st = tree.stats()
        d = {k: st[k] - stats0[k] for k in ("hits", "misses", "hit_tokens",
                                             "evictions", "cow_copies")}
        d["hit_rate"] = d["hits"] / max(d["hits"] + d["misses"], 1)
        d["nodes"] = st["nodes"]
        out["prefix"] = d
        s = fe.summary()
        out["ttft_cached_p50_ms"] = s["serving.prefix_cache.ttft_cached_p50_ms"]
        out["ttft_cold_p50_ms"] = s["serving.prefix_cache.ttft_cold_p50_ms"]
    return [h.tokens for h in handles], out


def phase_serve_prefix(kind, smi):
    """The shared-prefix trace (`prefix_workload`: bench.py
    serving_shared_prefix's trace at Llama-2-7B width, 32 layers, bf16)
    over a bf16 pool and an int8 pool, each with the prefix cache on and
    off over one model build. Gates (beside `_prefix_run`'s): greedy
    streams identical with the cache on and off; the trace's hit rate >
    0.6, evictions > 0, copy-on-write copies > 0; the cold run's prefill
    tokens less the cached run's == the trace's hit tokens. bench.py's
    CPU bands (shared TTFT p99 > 3x, tok/s > 1.5x) are reported, not
    gated."""
    from paddle_tpu_torch.serving import ServingMetrics
    from paddle_tpu_torch.tools.serve_workload import (
        LAYERS, PREFIX_LEN, PREFIX_MAXB, PREFIX_NB, PREFIX_NEW,
        prefix_workload)

    launches = {"ragged_paged_attention": 0, "ragged_paged_attention_q": 0}
    for kv_bits in (16, 8):
        label = f"serve_prefix_kv{kv_bits}"
        t0 = time.perf_counter()
        make_frontend, _shared, trace = prefix_workload(kv_bits=kv_bits)
        torch.cuda.synchronize()
        setup_s = time.perf_counter() - t0     # the model build
        shared_idx = {i for i, (_t, _p, is_shared) in enumerate(trace)
                      if is_shared}
        runs = {}
        for cache in (True, False):
            ServingMetrics.reset_monitor()
            fe = make_frontend(cache)
            torch.cuda.synchronize()
            runs[cache] = _prefix_run(fe, trace, shared_idx, kv_bits,
                                      f"{label}_{'on' if cache else 'off'}")
            del fe
            release()
        del make_frontend             # the model, before the next pool's
        release()
        (tok_on, on), (tok_off, off) = runs[True], runs[False]
        if tok_on != tok_off:
            diff = [i for i, (a, b) in enumerate(zip(tok_on, tok_off))
                    if a != b]
            raise AssertionError(f"{label}: greedy streams differ with the "
                                 f"cache on and off at requests {diff}")
        d = on["prefix"]
        saved = off["prefill_tokens"] - on["prefill_tokens"]
        if not (d["hit_rate"] > 0.6 and d["evictions"] > 0
                and d["cow_copies"] > 0 and saved == d["hit_tokens"]):
            raise AssertionError(f"{label}: prefix gates failed: {d}, cold "
                                 f"- cached prefill tokens {saved}")
        ttft_x = off["ttft_shared_p99_ms"] / on["ttft_shared_p99_ms"]
        tok_x = on["tok_s"] / off["tok_s"]
        emit({"phase": label,
              "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
              "kv_bits": kv_bits, "requests": len(trace),
              "shared_requests": len(shared_idx),
              "prefix_tokens": PREFIX_LEN, "new_tokens": PREFIX_NEW,
              "pool": [PREFIX_NB, 16], "max_blocks_per_seq": PREFIX_MAXB,
              "arrival_steps": [t for t, _p, _s in trace],
              "cache_on": on, "cache_off": off,
              "streams_identical": True,
              "prefill_tokens_saved": saved,
              "ttft_shared_p99_speedup": ttft_x, "tok_s_speedup": tok_x,
              "bench_cpu_bands": {"ttft_p99_gt_3x": ttft_x > 3.0,
                                  "tok_s_gt_1_5x": tok_x > 1.5},
              "setup_s": setup_s, "device": kind, "nvidia_smi": smi,
              "sample_tokens": tok_on[0]})
        attn = "ragged_paged_attention_q" if kv_bits == 8 else \
            "ragged_paged_attention"
        launches[attn] += on["launches"] + off["launches"]
    return launches


def phase_serve_faults(kind, smi):
    """The fault-tolerance layer on the card, on the small model (f32)
    and on `MLPLMEngine`, each case against its fault-free greedy run:
    (a) a transient `serve.decode` fault within the retry budget (every
    lane replays); (b) more consecutive faults than `step_retries`: one
    watchdog restart through an `engine_factory` that builds the same
    engine on the card, no leak on the new pool; (c) a burst of 4x the
    lane count a step under `AdmissionConfig(queue_high=1, queue_low=0)`:
    some shed, all terminal, the admitted ones' streams those of the
    admitted prompts served alone; (d) `MLPLMEngine` on the card against
    its CPU run (ragged-step logits within 1e-5, the same greedy
    streams)."""
    from paddle_tpu_torch import LlamaInferenceEngine
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import (AdmissionConfig, MLPLMEngine,
                                          ServingFrontend, ServingMetrics,
                                          WatchdogConfig)

    model = _small_model()
    geo = dict(max_batch_size=4, num_blocks=64, block_size=16,
               max_blocks_per_seq=16)

    def engine():
        return LlamaInferenceEngine(model, device="cuda", **geo)

    rng = np.random.default_rng(12)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in (9, 40, 23, 61, 17, 33)]

    def serve(fe, plist, new=8):
        hs = [fe.submit(q, max_new_tokens=new) for q in plist]
        fe.run_until_idle()
        return hs

    ref = [h.tokens for h in serve(ServingFrontend(engine()), prompts)]
    report = {}
    try:
        # (a) transient: 1 fault, within the default 3 retries
        ServingMetrics.reset_monitor()
        faults.inject("serve.decode", after_n=3, times=1)
        fe = ServingFrontend(engine())
        hs = serve(fe, prompts)
        faults.clear()
        got = [h.tokens for h in hs]
        if got != ref or monitor.get("serving.step_faults") != 1:
            raise AssertionError(f"serve_faults (a): streams {got == ref}, "
                                 "step faults "
                                 f"{monitor.get('serving.step_faults')}")
        report["transient"] = {"step_faults": 1, "streams_equal": True}
        # (b) 3 faults in a row > step_retries=1: one restart
        ServingMetrics.reset_monitor()
        faults.inject("serve.decode", after_n=3, times=3)
        fe = ServingFrontend(engine(), watchdog=WatchdogConfig(
            step_retries=1, max_restarts=2), engine_factory=engine)
        hs = serve(fe, prompts)
        faults.clear()
        got = [h.tokens for h in hs]
        sch = fe.scheduler
        mgr = sch.engine.manager
        restarts = monitor.get("serving.engine_restarts")
        if got != ref or restarts != 1 \
                or sch.engine_restarts_remaining != 1 \
                or sch.kv_leaked_blocks() != 0 \
                or mgr.free_blocks != mgr.num_blocks - 1:
            raise AssertionError(
                f"serve_faults (b): streams {got == ref}, restarts "
                f"{restarts}, remaining {sch.engine_restarts_remaining}, "
                f"leaked {sch.kv_leaked_blocks()}")
        report["restart"] = {"engine_restarts": restarts,
                             "restarts_remaining":
                                 sch.engine_restarts_remaining,
                             "leaked_blocks": 0, "streams_equal": True}
    finally:
        faults.clear()
    # (c) 4 arrivals a step for 6 steps into 4 lanes, queue_high=1
    ServingMetrics.reset_monitor()
    fe = ServingFrontend(engine(), admission=AdmissionConfig(
        queue_high=1, queue_low=0))
    burst = [rng.integers(1, 512, int(n)).tolist()
             for n in rng.integers(8, 48, 24)]
    hs = []
    for step in range(6):
        hs += [fe.submit(q, max_new_tokens=8)
               for q in burst[4 * step:4 * step + 4]]
        fe.step()
    fe.run_until_idle()
    shed = [h for h in hs if h.status.value == "shed"]
    admitted = [(h, q) for h, q in zip(hs, burst)
                if h.status.value != "shed"]
    alone = serve(ServingFrontend(engine()), [q for _h, q in admitted])
    if not shed or not all(h.finished for h in hs) or any(
            h.status.value != "finished" or h.tokens != a.tokens
            for (h, _q), a in zip(admitted, alone)):
        raise AssertionError(
            f"serve_faults (c): shed {len(shed)}, statuses "
            f"{[h.status.value for h in hs]}")
    report["burst"] = {"requests": len(hs), "shed": len(shed),
                       "admitted": len(admitted), "streams_equal": True,
                       "shed_by_reason": ServingMetrics.shed_by_reason()}
    # (d) MLPLMEngine on the card against its CPU run
    mlp = {dev: MLPLMEngine(vocab_size=512, hidden=64, max_batch_size=4,
                            num_blocks=64, block_size=16,
                            max_blocks_per_seq=8, seed=5, device=dev)
           for dev in ("cpu", "cuda")}
    tables = np.zeros((4, 8), np.int32)
    tables[0, :3] = [3, 4, 5]
    tables[2, :2] = [7, 8]
    err = 0.0
    for q_lens, kv_lens in (([30, 0, 12, 0], [30, 0, 12, 0]),
                            ([1, 0, 1, 0], [31, 0, 13, 0])):
        t = np.zeros((44,), np.int32)
        t[:sum(q_lens)] = rng.integers(1, 512, sum(q_lens))
        a = mlp["cpu"].ragged_step(t, q_lens, kv_lens, tables)
        b = mlp["cuda"].ragged_step(t, q_lens, kv_lens, tables).cpu()
        err = max(err, float((a - b).abs().max()))
    streams = {dev: [h.tokens for h in serve(ServingFrontend(
        e.respawn(), prefix_cache=True), prompts + prompts[:2])]
        for dev, e in mlp.items()}
    if err > 1e-5 or streams["cuda"] != streams["cpu"]:
        raise AssertionError(f"serve_faults (d): MLPLMEngine on the card "
                             f"max abs err {err}, streams "
                             f"{streams['cuda'] == streams['cpu']}")
    report["mlp_engine"] = {"max_abs_err": err, "tol": 1e-5,
                            "streams_equal": True}
    emit({"phase": "serve_faults", "model": "llama_tiny(vocab=512, "
          "layers=2, hidden=256, heads=2, kv_heads=1) f32; MLPLMEngine("
          "vocab=512, hidden=64)", "cases": report, "device": kind,
          "nvidia_smi": smi})
    del model, mlp
    release()


# ---- multi-LoRA serving and KV migration ----

def _sync(device="cuda"):
    if torch.device(device).type == "cuda":
        torch.cuda.synchronize()


def _launches():
    from paddle_tpu_torch.ops.kernels import _support

    return {c: _support.launch_counter(c).count for c in SERVE_KERNELS}


def _launch_gate(label, launches, expect):
    if launches != expect:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"{expect}")


def _lora_pair(base):
    """A LoRAEngine over `base` with two adapters (ranks 3 and 8) leased
    and a lane -> slot vector of [first, zero, second, zero]."""
    from paddle_tpu_torch.serving import attach_adapters
    from paddle_tpu_torch.serving.lora import random_adapter

    eng = attach_adapters(base, pool_slots=3, rank_buckets=(2, 4, 8))
    for i, (ad, rank) in enumerate((("a", 3), ("b", 8))):
        eng.adapter_pool.register(ad, random_adapter(eng, rank=rank,
                                                     seed=11 + i,
                                                     scale=0.1))
    s0, s1 = eng.adapter_pool.lease("a"), eng.adapter_pool.lease("b")
    eng.set_lane_adapters(np.asarray([s0, eng.zero_slot, s1, eng.zero_slot],
                                     np.int32))
    return eng


def phase_lora_reference(kind, smi, device="cuda"):
    """`LoRAEngine` on the card against its CPU run on small models: over
    `MLPLMEngine` (f32 and int8 pools) and over the small Llama (f32 and
    int8 pools, int8 and int4 weight-only bases), with lanes on two
    adapters and on the zero slot: three ragged steps and a verify
    window (S = 5), logits within 1e-3; the zero-slot lane's rows
    bit-equal to the base engine's run of the same step on the card."""
    from paddle_tpu_torch import LlamaInferenceEngine
    from paddle_tpu_torch.serving import MLPLMEngine
    from paddle_tpu_torch.serving.quant import quantize_engine

    model = _small_model()
    geo = dict(max_batch_size=4, num_blocks=64, block_size=16,
               max_blocks_per_seq=16)

    def llama(kv_bits, wbits):
        def build(dev):
            e = LlamaInferenceEngine(model, device=dev, kv_bits=kv_bits,
                                     **geo)
            return quantize_engine(e, wbits) if wbits else e
        return build

    def mlp(kv_bits):
        return lambda dev: MLPLMEngine(vocab_size=512, hidden=64, seed=5,
                                       kv_bits=kv_bits, device=dev, **geo)

    cases = {"mlp_kv16": mlp(16), "mlp_kv8": mlp(8),
             "llama_kv16": llama(16, None), "llama_kv8": llama(8, None),
             "llama_w8": llama(16, 8), "llama_kv8_w4": llama(8, 4)}
    tables = np.zeros((4, 16), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[1, :2] = [4, 5]
    tables[2, :2] = [6, 7]
    steps = (([20, 7, 9, 0], [20, 7, 9, 0]), ([1, 1, 1, 0], [21, 8, 10, 0]),
             ([12, 1, 1, 0], [33, 9, 11, 0]))
    report = {}
    for name, build in cases.items():
        rng = np.random.default_rng(8)
        engines = {dev: _lora_pair(build(dev)) for dev in ("cpu", device)}
        base = build(device)             # the plain engine, same steps
        err = 0.0
        for q_lens, kv_lens in steps:
            tokens = np.zeros((40,), np.int32)
            n = sum(q_lens)
            tokens[:n] = rng.integers(1, 512, n)
            a = engines["cpu"].ragged_step(tokens, q_lens, kv_lens, tables)
            b = engines[device].ragged_step(tokens, q_lens, kv_lens,
                                            tables).cpu()
            err = max(err, float((a - b).abs().max()))
            if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
                raise AssertionError(f"lora_reference {name}: ragged step "
                                     f"on the card != CPU: {err}")
            c = base.ragged_step(tokens, q_lens, kv_lens, tables).cpu()
            lo = q_lens[0]
            if not torch.equal(b[lo:lo + q_lens[1]], c[lo:lo + q_lens[1]]):
                raise AssertionError(f"lora_reference {name}: the zero-slot "
                                     "lane differs from the base engine")
        vtok = rng.integers(1, 512, (4, 5)).astype(np.int32)
        vctx = np.asarray([38, 14, 16, 5], np.int32)
        a = engines["cpu"].verify_step(vtok, vctx, tables)
        b = engines[device].verify_step(vtok, vctx, tables).cpu()
        verr = float((a - b).abs().max())
        if not torch.allclose(a, b, atol=1e-3, rtol=1e-3):
            raise AssertionError(f"lora_reference {name}: verify on the "
                                 f"card != CPU: {verr}")
        report[name] = {"ragged_max_abs_err": err,
                        "verify_max_abs_err": verr,
                        "zero_slot_lane_bit_equal_to_base": True}
        del engines, base
    emit({"phase": "lora_reference", "model": "llama_tiny(vocab=512, "
          "layers=2, hidden=256, heads=2, kv_heads=1) f32; MLPLMEngine("
          "vocab=512, hidden=64)", "adapters": "ranks 3 and 8, buckets "
          "(2, 4, 8), lanes [a, zero, b, zero]", "tol": 1e-3,
          "ragged_steps": len(steps), "verify": "S = 5",
          "cases": report, "device": kind, "nvidia_smi": smi})
    release()


def _epilogue_ms(lora, tokens):
    """Device ms of one step's LoRA epilogues (the engine step's gather
    of every target's factors, then every layer's four targets at
    `tokens` packed rows, the engine's own pools and a mixed slot
    vector), replayed from one CUDA graph so host launch gaps do not
    count."""
    from paddle_tpu_torch.serving.lora import _swap_lora, lora_mm

    dev = lora.device
    g = torch.Generator(device=dev).manual_seed(3)
    dtype = lora.params["embed"].dtype
    ids = torch.randint(0, lora.adapter_pool.pool_slots + 1, (tokens,),
                        generator=g, device=dev)
    xs = {k: torch.randn(tokens, kk, generator=g, device=dev).to(dtype)
          for k, (kk, _n) in lora._lora_targets.items()}
    ys = {k: torch.zeros(tokens, n, device=dev, dtype=dtype)
          for k, (_kk, n) in lora._lora_targets.items()}

    nl = lora._nlayers

    def step():
        swapped = _swap_lora({k: [y] * nl for k, y in ys.items()},
                             lora._pools, ids, nl)
        for l in range(nl):
            for k in lora._pools:
                lora_mm(xs[k], swapped[k][l], lambda _x, w: w)

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        for _ in range(2):
            step()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        step()
    times = []
    for _ in range(10):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    del graph
    return statistics.median(times)


def _lora_trace_run(fe, trace, adapters, label, kv_bits, wbits, device):
    """Drive the multi-LoRA trace on `fe` with the launch and engine-call
    counts zeroed just before and read just after; gate it (every
    request FINISHED with its tokens, no leaked block, consistent books,
    exactly 32 ragged launches a ragged step and, on a quantized base,
    4 x 32 + 1 weight-only gemms a ragged step, nothing else) and return
    `(streams, numbers)`."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.serve_workload import (LAYERS, LORA_NEW,
                                                       drive_lora_trace)

    fe.metrics.reset_window()
    _support.reset_launch_counts()
    _reset_engine_calls(monitor)
    loads0 = monitor.get("serving.lora.miss_loads")
    _sync(device)
    t1 = time.perf_counter()
    handles, steps = drive_lora_trace(fe, trace, adapters=adapters)
    _sync(device)
    wall = time.perf_counter() - t1
    launches = _launches()
    calls = _engine_calls(monitor)
    bad = [(h.request_id, h.status.value, h.finish_reason, len(h.tokens))
           for h in handles
           if h.status.value != "finished" or len(h.tokens) != LORA_NEW]
    if bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{LORA_NEW} tokens: {bad}")
    sch = fe.scheduler
    leaked = sch.kv_leaked_blocks()
    if leaked:
        raise AssertionError(f"{label}: {leaked} leaked blocks")
    sch.engine.manager.check_consistency()
    attn = "ragged_paged_attention_q" if kv_bits == 8 else \
        "ragged_paged_attention"
    gemm = {8: "quant_matmul", 4: "quant_matmul_int4"}.get(wbits)
    expect = {c: 0 for c in launches}
    expect[attn] = LAYERS * calls["ragged_steps"]
    if gemm is not None:
        expect[gemm] = (4 * LAYERS + 1) * calls["ragged_steps"]
    if calls["ragged_steps"] == 0 or any(
            calls[c] for c in ENGINE_CALLS if c != "ragged_steps"):
        raise AssertionError(f"{label}: engine calls {calls}")
    _launch_gate(label, launches, expect)
    ttft = [h.ttft_ms() for h in handles]
    tokens_out = len(handles) * LORA_NEW
    return [h.tokens for h in handles], {
        "ragged_steps": calls["ragged_steps"], "scheduler_steps": steps,
        "wall_s": wall, "tok_s": tokens_out / wall,
        "ms_per_step": wall / calls["ragged_steps"] * 1e3,
        "ttft_p50_ms": float(np.percentile(ttft, 50)),
        "ttft_p99_ms": float(np.percentile(ttft, 99)),
        "miss_loads": monitor.get("serving.lora.miss_loads") - loads0,
        "launches": launches, "leaked_blocks": leaked}


def _serve_lora(label, kv_bits, wbits, kind, smi, factors=None,
                parity=None, device="cuda"):
    """One multi-LoRA serve phase: the mix on a `LoRAEngine` of 40 slots
    (residency pre-warmed: each adapter leased and released once), then
    the same trace on the base engine with no adapters; the no-adapter
    streams of the LoRA engine against the base's; each of `parity`
    served in a mixed batch beside two other adapters against a
    dedicated wrapper (2 slots) of the same base. Returns `(launches,
    factors)`."""
    from paddle_tpu_torch.serving import ServingFrontend, ServingMetrics
    from paddle_tpu_torch.tools.serve_workload import (
        CHUNK, LAYERS, LORA_ADAPTERS, LORA_NEW, LORA_PARITY, LORA_SLOTS,
        lora_adapters, lora_workload)

    t0 = time.perf_counter()
    base, attach, trace = lora_workload(device=device, kv_bits=kv_bits,
                                        wbits=wbits)
    vocab = base.config.vocab_size
    lora = attach(LORA_SLOTS, {})
    if factors is None:
        factors = lora_adapters(lora)
    for name, f in factors.items():
        lora.adapter_pool.register(name, f)
    pool = lora.adapter_pool
    ServingMetrics.reset_monitor()
    fe = ServingFrontend(lora, prefill_chunk_tokens=CHUNK)
    for name in factors:               # pre-warm: every adapter uploads
        pool.lease(name)
        pool.release(name)
    warm = np.random.default_rng(1)
    for n in (3, 17):
        fe.submit(warm.integers(1, vocab, n).tolist(), max_new_tokens=2,
                  adapter="ad0")
    fe.run_until_idle()
    fe_base = ServingFrontend(base, prefill_chunk_tokens=CHUNK)
    for n in (3, 17):
        fe_base.submit(warm.integers(1, vocab, n).tolist(),
                       max_new_tokens=2)
    fe_base.run_until_idle()
    _sync(device)
    setup_s = time.perf_counter() - t0

    mix_tokens, mix = _lora_trace_run(fe, trace, True, f"{label}_mix",
                                      kv_bits, wbits, device)
    st = pool.stats()
    pool.check_consistency()
    if mix["miss_loads"] or st["resident_adapters"] != LORA_ADAPTERS \
            or st["leases"] or st["evictions"]:
        raise AssertionError(f"{label}: pool books {st}, timed miss loads "
                             f"{mix['miss_loads']}")
    base_tokens, single = _lora_trace_run(fe_base, trace, False,
                                          f"{label}_base", kv_bits, wbits,
                                          device)
    # no-adapter requests on the LoRA engine: the base engine's streams
    plain = [fe.submit(p, max_new_tokens=LORA_NEW) for _t, p, _a in
             trace[:8]]
    fe.run_until_idle()
    if [h.tokens for h in plain] != base_tokens[:8]:
        raise AssertionError(f"{label}: no-adapter streams on the LoRA "
                             "engine differ from the base engine's")
    # per-adapter parity: mixed batch on the shared engine == dedicated
    prompt = trace[0][1]
    parity_out = {}
    for name in parity or LORA_PARITY:
        ded = attach(2, {name: factors[name]})
        fe_d = ServingFrontend(ded, prefill_chunk_tokens=CHUNK)
        hd = fe_d.submit(prompt, max_new_tokens=LORA_NEW, adapter=name)
        fe_d.run_until_idle()
        others = [a for a in LORA_PARITY if a != name][:2]
        hs = [fe.submit(prompt, max_new_tokens=LORA_NEW, adapter=a)
              for a in [name] + others]
        fe.run_until_idle()
        if hd.status.value != "finished" or hs[0].tokens != hd.tokens:
            raise AssertionError(f"{label}: {name} shared {hs[0].tokens} != "
                                 f"dedicated {hd.tokens}")
        parity_out[name] = {"tokens": hd.tokens, "beside": others}
        del ded, fe_d
        release()
    st = pool.stats()
    pool.check_consistency()
    if st["leases"] or fe.scheduler.kv_leaked_blocks():
        raise AssertionError(f"{label}: books after parity {st}")
    epi_ms = _epilogue_ms(lora, fe.scheduler.ragged_tokens)
    pool_gb = sum(t.numel() * t.element_size() for pl in lora._pools.values()
                  for t in pl.values()) / 2 ** 30
    emit({"phase": label,
          "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
          "kv_bits": kv_bits, "wbits": wbits or 16,
          "adapters": LORA_ADAPTERS, "pool_slots": LORA_SLOTS,
          "requests": len(trace), "new_tokens": LORA_NEW,
          "arrival_steps": [t for t, _p, _a in trace],
          "mix": mix, "single_model": single,
          "tok_s_ratio": mix["tok_s"] / single["tok_s"],
          "bench_band_tok_s_ratio_ge_0_8":
              mix["tok_s"] / single["tok_s"] >= 0.8,
          "pool": st, "adapter_pool_gb": pool_gb,
          "epilogue_device_ms_per_step": epi_ms,
          "epilogue_share_of_step": epi_ms / mix["ms_per_step"],
          "parity": parity_out, "no_adapter_streams_equal_base": True,
          "setup_s": setup_s, "device": kind, "nvidia_smi": smi,
          "sample_tokens": mix_tokens[0]})
    launches = {c: mix["launches"][c] + single["launches"][c]
                for c in mix["launches"]}
    del fe, fe_base, lora, base, attach
    release()
    return launches, factors


def phase_serve_lora(kind, smi, device="cuda"):
    return _serve_lora("serve_lora", 16, None, kind, smi, device=device)


def phase_serve_lora_quant(kind, smi, factors, device="cuda"):
    launches, _f = _serve_lora("serve_lora_quant", 8, 4, kind, smi,
                               factors=factors, parity=("ad7",),
                               device=device)
    return launches


def _byte_sums(pools):
    """A checksum of each pool: its bytes read as int32 and summed in
    int64, one layer at a time (no pool-sized temporary)."""
    return [int(torch.stack([p[l].view(torch.int32).sum(dtype=torch.int64)
                             for l in range(p.shape[0])]).sum())
            for p in pools]


def phase_serve_migrate(kind, smi, device="cuda"):
    """KV migration at Llama-2-7B width (32 layers, bf16) over a bf16 and
    an int8 pool (`migrate_workload`): the 8 serve prompts served greedy
    unmigrated, then again with each request moved after its first token
    and 4 decode tokens into a `LoRAEngine` over the same engine with no
    adapter (its own pools). Gates: the payload's slabs bit-equal to the
    source blocks and the source pools' bytes unchanged by each
    extraction; every migrated stream token for token the unmigrated
    one; no leaked block on either engine; 32 ragged launches a ragged
    step. Then the prefix trace's 192-token shared prefix exported from
    one prefix-cached scheduler and imported into another: the
    importer's first shared request leases the whole prefix (192 hit
    tokens) and streams the exporter's tokens."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.serving import (ServingFrontend, ServingMetrics,
                                          attach_adapters)
    from paddle_tpu_torch.tools.serve_workload import (
        CHUNK, LAYERS, MIGRATE_AT, MIGRATE_NEW, PREFIX_LEN, PREFIX_NEW,
        drive_migration, migrate_workload)

    launches = {"ragged_paged_attention": 0, "ragged_paged_attention_q": 0}
    for kv_bits in (16, 8):
        label = f"serve_migrate_kv{kv_bits}"
        ServingMetrics.reset_monitor()
        engine, prompts, make_prefix_frontend, shared, first = \
            migrate_workload(device=device, kv_bits=kv_bits)
        fe = ServingFrontend(engine, prefill_chunk_tokens=CHUNK)
        ref = [fe.submit(p, max_new_tokens=MIGRATE_NEW) for p in prompts]
        fe.run_until_idle()
        ref = [h.tokens for h in ref]
        dst = attach_adapters(engine, pool_slots=1, rank_buckets=(8,))
        fe_dst = ServingFrontend(dst, prefill_chunk_tokens=CHUNK)
        moves = []
        extract, inject = engine.extract_kv_blocks, dst.inject_kv_blocks

        def checked_extract(seq_id):
            sums = _byte_sums(engine._pools())
            _sync(device)
            t0 = time.perf_counter()
            pay = extract(seq_id)
            _sync(device)
            dt = time.perf_counter() - t0
            blocks = list(engine.manager.blocks_of(seq_id))
            for name, pool in zip(pay.slabs, engine._pools()):
                slab = pay.slabs[name]
                if not all(torch.equal(slab[:, j], pool[:, b])
                           for j, b in enumerate(blocks)):
                    raise AssertionError(f"{label}: slab {name} differs "
                                         "from the source blocks")
            if _byte_sums(engine._pools()) != sums:
                raise AssertionError(f"{label}: extraction changed the "
                                     "source pool")
            moves.append({"tokens": pay.num_tokens,
                          "blocks": pay.num_blocks,
                          "payload_mb": pay.nbytes / 1e6,
                          "extract_ms": dt * 1e3})
            return pay

        def timed_inject(seq_id, payload):
            _sync(device)
            t0 = time.perf_counter()
            inject(seq_id, payload)
            _sync(device)
            moves[-1]["inject_ms"] = (time.perf_counter() - t0) * 1e3

        engine.extract_kv_blocks = checked_extract
        dst.inject_kv_blocks = timed_inject
        _support.reset_launch_counts()
        monitor.reset("serving.ragged_steps")
        handles = drive_migration(fe, fe_dst, prompts)
        del engine.extract_kv_blocks, dst.inject_kv_blocks
        lch = _launches()
        steps = monitor.get("serving.ragged_steps")
        got = [h.tokens for h in handles]
        if got != ref or len(moves) != len(prompts) or any(
                h.status.value != "finished" for h in handles):
            raise AssertionError(f"{label}: migrated streams equal "
                                 f"{got == ref}, moves {len(moves)}")
        for f in (fe, fe_dst):
            if f.scheduler.kv_leaked_blocks():
                raise AssertionError(f"{label}: leaked blocks")
            f.scheduler.engine.manager.check_consistency()
        attn = "ragged_paged_attention_q" if kv_bits == 8 else \
            "ragged_paged_attention"
        expect = {c: 0 for c in lch}
        expect[attn] = LAYERS * steps
        _launch_gate(label, lch, expect)
        launches[attn] += lch[attn]
        del fe, fe_dst, dst, engine
        release()
        # prefix streaming between two prefix-cached schedulers
        fe1, fe2 = make_prefix_frontend(), make_prefix_frontend()
        fe1.submit(shared, max_new_tokens=2)
        fe1.run_until_idle()
        h1 = fe1.submit(first, max_new_tokens=PREFIX_NEW)
        fe1.run_until_idle()
        _sync(device)
        t0 = time.perf_counter()
        payload = fe1.scheduler.export_prefix(shared)
        _sync(device)
        t1 = time.perf_counter()
        gained = fe2.scheduler.import_prefix(shared, payload)
        _sync(device)
        t2 = time.perf_counter()
        h2 = fe2.submit(first, max_new_tokens=PREFIX_NEW)
        fe2.run_until_idle()
        hit = h2._req._prefix_hit_tokens
        if gained != PREFIX_LEN or hit != PREFIX_LEN \
                or h2.tokens != h1.tokens:
            raise AssertionError(f"{label}: prefix import gained {gained}, "
                                 f"hit {hit}, streams "
                                 f"{h2.tokens == h1.tokens}")
        for f in (fe1, fe2):
            if f.scheduler.kv_leaked_blocks():
                raise AssertionError(f"{label}: prefix leak")
            f.scheduler.engine.manager.check_consistency(
                external=f.scheduler.prefix_cache.block_ref_counts())
        ext = [m["extract_ms"] for m in moves]
        inj = [m["inject_ms"] for m in moves]
        mb = [m["payload_mb"] for m in moves]
        emit({"phase": label,
              "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
              "kv_bits": kv_bits, "requests": len(prompts),
              "prompt_lens": [len(p) for p in prompts],
              "moved_at_tokens": MIGRATE_AT, "new_tokens": MIGRATE_NEW,
              "moves": moves, "streams_equal_unmigrated": True,
              "ragged_steps": steps, "launches": lch[attn],
              "payload_mb_median": statistics.median(mb),
              "extract_ms_median": statistics.median(ext),
              "inject_ms_median": statistics.median(inj),
              # GB/s of the sequence's blocks, each byte read once and
              # written once (pool to slab, or slab to pool)
              "extract_gb_s_median": statistics.median(
                  2 * m["payload_mb"] / m["extract_ms"] for m in moves),
              "inject_gb_s_median": statistics.median(
                  2 * m["payload_mb"] / m["inject_ms"] for m in moves),
              "prefix": {"tokens": PREFIX_LEN, "gained": gained,
                         "importer_hit_tokens": hit,
                         "payload_mb": payload.nbytes / 1e6,
                         "export_ms": (t1 - t0) * 1e3,
                         "import_ms": (t2 - t1) * 1e3,
                         "streams_equal": True},
              "device": kind, "nvidia_smi": smi,
              "sample_tokens": got[0]})
        del fe1, fe2, make_prefix_frontend, payload
        release()
    return launches


# ---------------------------------------------------------------------------
# fleet routing and disaggregated prefill/decode (`serving/fleet.py`,
# `serving/disagg.py`): replicas in one process, sessions moved as KV
# ---------------------------------------------------------------------------

# the integer counters the card's fleet must match the CPU's in
FLEET_COUNTERS = ("relocations", "relocations_shipped", "shipped_kv_bytes",
                  "handoffs", "handoff_fallbacks", "prefix_streams",
                  "prefix_stream_tokens", "session_hits")
FLEET_REF_NEW = 10
# the counters of faults a fleet absorbs without failing a request (a
# replica that fails on the card relocates its requests, and their
# streams stay equal): each must stay 0 in a run that injects none
FLEET_FAULTS = ("fleet.relocations", "fleet.handoff_faults",
                "fleet.handoff_fallbacks", "fleet.submit_faults",
                "fleet.kv_ship_failures", "fleet.kv_import_failures",
                "fleet.prefix_stream_failures", "serving.step_faults",
                "serving.engine_restarts")


def _fleet_fault_gate(label, router, dead=(), allow=()):
    """Fail unless `dead` (death reasons) are the reasons of exactly the
    replicas that are not alive, and no counter of `FLEET_FAULTS` but
    those in `allow` moved."""
    from paddle_tpu_torch.framework import monitor

    gone = sorted(r.death_reason for r in router.replicas if not r.alive)
    moved = {c: monitor.get(c) for c in FLEET_FAULTS
             if c not in allow and monitor.get(c)}
    if gone != sorted(dead) or moved:
        raise AssertionError(f"{label}: replicas dead {gone} (expected "
                             f"{sorted(dead)}), fault counters {moved}")


def _fleet_engines(device):
    """The small engines `fleet_reference` runs on `device`, by name: an
    engine factory each."""
    from paddle_tpu_torch import LlamaInferenceEngine
    from paddle_tpu_torch.serving import MLPLMEngine

    model = _small_model()
    geo = dict(max_batch_size=4, num_blocks=64, block_size=16,
               max_blocks_per_seq=16)
    out = {}
    for kv in (16, 8):
        out[f"mlp_kv{kv}"] = lambda kv=kv: MLPLMEngine(
            vocab_size=512, hidden=64, max_batch_size=4, num_blocks=64,
            block_size=16, max_blocks_per_seq=8, seed=5, kv_bits=kv,
            device=device)
        out[f"llama_kv{kv}"] = lambda kv=kv: LlamaInferenceEngine(
            model, device=device, kv_bits=kv, **geo)
    return out


def _fleet_scenarios(make_engine):
    """The fleet scenarios of `fleet_reference` over `make_engine` (one
    device): a kill in mid-decode (fold), a drain (KV shipped), a
    replica added under load, session affinity, a disaggregated 1 + 1
    handoff and a prefix streamed between two prefix-cached replicas.
    Each is held to a single frontend's streams over the same engine
    kind; every request FINISHED; no leaked block on a live (or drained)
    replica. Returns `{scenario: (streams, fleet counters, ragged steps
    of the fleet, ragged launches by counter)}`: launches and ragged
    steps are zeroed just before each router run and read just after
    it, before the single frontend runs. No replica dies but the one
    killed or drained, and no fault counter moves (`_fleet_fault_gate`).
    """
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.serving import (DisaggRouter, FleetRouter,
                                          ServingFrontend, ServingMetrics)

    rng = np.random.default_rng(21)
    prompts = [rng.integers(1, 512, int(n)).tolist()
               for n in (9, 40, 23, 61, 17, 33)]
    shared = rng.integers(1, 512, 48).tolist()      # three full blocks
    other = rng.integers(1, 512, 40).tolist()

    def alone(plist, new=FLEET_REF_NEW):
        fe = ServingFrontend(make_engine())
        hs = [fe.submit(q, max_new_tokens=new) for q in plist]
        fe.run_until_idle()
        return [h.tokens for h in hs]

    def submit(r, plist, new=FLEET_REF_NEW, **kw):
        return [r.submit(q, max_new_tokens=new, **kw) for q in plist]

    def kill(r):
        hs = submit(r, prompts)
        while not any(len(h._req.generated) >= 2 for h in hs):
            r.step()
        r.chaos_kill_replica()
        r.run_until_idle()
        return hs, prompts

    def drain(r):
        hs = submit(r, prompts)
        while len(hs[0]._req.generated) < 2:
            r.step()
        victim = hs[0].replica_id
        r.drain_replica(victim)
        r.run_until_idle()
        if r._rep(victim).death_reason != "drained":
            raise AssertionError("fleet drain: the replica did not drain")
        return hs, prompts

    def add_replica(r):
        hs = submit(r, prompts[:3])
        r.step()
        rid = r.add_replica()
        hs += submit(r, prompts[3:])
        if hs[3].replica_id != rid:
            raise AssertionError("fleet add_replica: the new replica took "
                                 "no placement")
        r.run_until_idle()
        return hs, prompts

    def session(r):
        a = r.submit(prompts[0], max_new_tokens=FLEET_REF_NEW,
                     session_id="s")
        r.run_until_idle()
        b = r.submit(prompts[1], max_new_tokens=FLEET_REF_NEW,
                     session_id="s")
        r.run_until_idle()
        if a.replica_id != b.replica_id:
            raise AssertionError("fleet session: the second turn moved")
        return [a, b], prompts[:2]

    def disagg(r):
        hs = submit(r, prompts)
        r.run_until_idle()
        decode = {rep.replica_id for rep in r.replicas
                  if rep.role == "decode"}
        if any(h.replica_id not in decode for h in hs):
            raise AssertionError("fleet disagg: a session stayed on the "
                                 "prefill tier")
        return hs, prompts

    def prefix_stream(r):
        h1 = r.submit(shared, max_new_tokens=6)
        r.run_until_idle()
        busy = r.submit(other, max_new_tokens=30)
        h2 = r.submit(shared, max_new_tokens=6)
        if h2.replica_id == h1.replica_id:
            raise AssertionError("fleet prefix_stream: no cold peer")
        r.run_until_idle()
        if h2.tokens != h1.tokens:
            raise AssertionError("fleet prefix_stream: the streamed prefix "
                                 "changed the stream")
        return [h1, busy, h2], None

    # scenario: (run, router, death reasons, fault counters it moves)
    moved = ("fleet.relocations",)
    cases = {
        "kill": (kill, lambda: FleetRouter(make_engine, 2),
                 ("chaos_kill",), moved),
        "drain": (drain, lambda: FleetRouter(make_engine, 2),
                  ("drained",), moved),
        "add_replica": (add_replica, lambda: FleetRouter(make_engine, 1),
                        (), ()),
        "session": (session, lambda: FleetRouter(make_engine, 2), (), ()),
        "disagg": (disagg, lambda: DisaggRouter(
            make_engine, num_prefill=1, num_decode=1), (), ()),
        "prefix_stream": (prefix_stream, lambda: FleetRouter(
            make_engine, 2, frontend_kwargs=dict(prefix_cache=True)),
            (), ()),
    }
    out = {}
    for name, (run, build, dead, allow) in cases.items():
        ServingMetrics.reset_monitor()
        monitor.reset_prefix("fleet.")
        with build() as r:
            _support.reset_launch_counts()
            monitor.reset("serving.ragged_steps")
            hs, plist = run(r)
            lch = _launches()
            steps = monitor.get("serving.ragged_steps")
            bad = [(h.status.value, h.finish_reason) for h in hs
                   if h.status.value != "finished"]
            if bad:
                raise AssertionError(f"fleet {name}: not finished {bad}")
            for rep in r.replicas:
                if rep.alive or rep.death_reason == "drained":
                    sch = rep.scheduler
                    if sch.kv_leaked_blocks():
                        raise AssertionError(f"fleet {name}: {rep} leaks "
                                             f"{sch.kv_leaked_blocks()}")
            _fleet_fault_gate(f"fleet {name}", r, dead, allow)
            got = [h.tokens for h in hs]
            counters = {c: monitor.get(f"fleet.{c}") for c in FLEET_COUNTERS}
        if plist is not None and got != alone(plist):
            raise AssertionError(f"fleet {name}: streams differ from a "
                                 "single frontend's")
        out[name] = (got, counters, steps, lch)
    c = {n: v[1] for n, v in out.items()}
    want = {"kill": c["kill"]["relocations"] >= 1,
            "drain": c["drain"]["relocations_shipped"] >= 1,
            "session": c["session"]["session_hits"] == 1,
            "disagg": c["disagg"]["handoffs"] == len(prompts)
            and c["disagg"]["handoff_fallbacks"] == 0,
            "prefix_stream": c["prefix_stream"]["prefix_streams"] == 1
            and c["prefix_stream"]["prefix_stream_tokens"] == len(shared)}
    if not all(want.values()):
        raise AssertionError(f"fleet counters {c}: {want}")
    return out


def phase_fleet_reference(kind, smi):
    """Fleet routing on small engines, on the card against the CPU: the
    `_fleet_scenarios` over `MLPLMEngine` and `phase_reference`'s small
    f32 Llama, each over a 16- and an 8-bit KV pool. Gates: each
    scenario's own (every request FINISHED, streams equal a single
    frontend's over the same engine on the same device, no leaked
    block); the `fleet.*` integer counters equal on the card and the
    CPU; on the card, in each scenario's router run, 2 ragged launches
    (one a layer) per ragged step of the Llama engines and none of the
    MLP engines. Returns the router runs' ragged launches by counter."""
    launches = {"ragged_paged_attention": 0, "ragged_paged_attention_q": 0}
    report = {}
    cpu, card = _fleet_engines("cpu"), _fleet_engines("cuda")
    for name in card:
        ref = _fleet_scenarios(cpu[name])
        got = _fleet_scenarios(card[name])
        attn = "ragged_paged_attention_q" if name.endswith("kv8") else \
            "ragged_paged_attention"
        fleet_launches = 0
        for s, (_toks, _c, steps, lch) in got.items():
            expect = {c: 0 for c in lch}
            if name.startswith("llama"):
                expect[attn] = 2 * steps
            _launch_gate(f"fleet_reference {name} {s}", lch, expect)
            fleet_launches += lch[attn]
        launches[attn] += fleet_launches
        steps = sum(v[2] for v in got.values())
        diff = {s: (got[s][1], ref[s][1]) for s in got
                if got[s][1] != ref[s][1]}
        if diff:
            raise AssertionError(f"fleet_reference {name}: counters on the "
                                 f"card != CPU: {diff}")
        report[name] = {
            "counters": {s: v[1] for s, v in got.items()},
            "ragged_steps": steps, "launches": fleet_launches,
            "streams_equal_cpu": {s: got[s][0] == ref[s][0] for s in got}}
    emit({"phase": "fleet_reference",
          "engines": "MLPLMEngine(vocab=512, hidden=64) and llama_tiny("
                     "vocab=512, layers=2, hidden=256, heads=2, kv_heads=1)"
                     " f32, KV 16 and 8 bits",
          "scenarios": list(next(iter(report.values()))["counters"]),
          "new_tokens": FLEET_REF_NEW, "results": report,
          "device": kind, "nvidia_smi": smi})
    release()
    return launches


def _fleet_run(router, requests, label, on_step=None):
    """Submit `requests` to `router`, drive it to idle and gate the run:
    every request FINISHED with `NEW_TOKENS` tokens, 32 ragged launches
    (one a layer) per ragged step, no leaked block on a live replica, two
    hosts in `fleet_summary`'s aggregation. Launch and engine-call counts
    are zeroed just before the run and read just after. Returns `(handles,
    token_times, report)`: `token_times[i]` holds the `perf_counter` of
    each token request i committed. `on_step(router, handles, step)` is
    called before each router step."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.serve_workload import LAYERS, NEW_TOKENS

    times = []
    _support.reset_launch_counts()
    monitor.reset("serving.ragged_steps")
    t0 = time.perf_counter()
    handles = []
    for p, kw in requests:
        stamps = []
        times.append(stamps)
        handles.append(router.submit(
            p, stream_cb=lambda _tok, s=stamps: s.append(time.perf_counter()),
            **kw))
    steps = 0
    while not router.idle:
        if on_step is not None:
            on_step(router, handles, steps + 1)
        router.step()
        steps += 1
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    lch = _launches()
    ragged = monitor.get("serving.ragged_steps")
    bad = [(h.request_id, h.status.value, h.finish_reason, len(h.tokens))
           for h in handles
           if h.status.value != "finished" or len(h.tokens) != NEW_TOKENS]
    if bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{NEW_TOKENS} tokens: {bad}")
    expect = {c: 0 for c in lch}
    expect["ragged_paged_attention"] = LAYERS * ragged
    _launch_gate(label, lch, expect)
    for rep in router.live_replicas:
        if rep.scheduler.kv_leaked_blocks():
            raise AssertionError(f"{label}: {rep} leaks "
                                 f"{rep.scheduler.kv_leaked_blocks()}")
    summary = router.fleet_summary()
    if monitor.get("mesh.hosts") != 2:
        raise AssertionError(f"{label}: fleet_summary aggregated "
                             f"{monitor.get('mesh.hosts')} hosts")
    tokens_out = sum(len(h.tokens) for h in handles)
    return handles, times, {
        "router_steps": steps, "ragged_steps": ragged,
        "launches": lch["ragged_paged_attention"], "wall_s": wall,
        "tok_s": tokens_out / wall, "tokens_out": tokens_out,
        "replicas": {r.replica_id: r.death_reason or "alive"
                     for r in router.replicas},
        "aggregate_tokens": summary["aggregate"]["fleet.tokens_generated"],
        "hosts": monitor.get("mesh.hosts")}


def phase_serve_fleet(kind, smi):
    """`_serve_fleet_runs`, then the card's memory back: the engines,
    routers and wrappers die with that function's frame. Returns the
    ragged launches."""
    launches = _serve_fleet_runs(kind, smi)
    release()
    return launches


def _serve_fleet_runs(kind, smi):
    """The serve workload over two replicas at Llama-2-7B width (32
    layers, bf16; `fleet_workload`: each replica's engine built once,
    with its own 1024 x 16 pool), three runs over the same engines:

    (a) a clean `FleetRouter` run over two mixed replicas, whose streams
        are the reference; every router step records, per the chaos
        site's own choice of the busiest replica, the tokens its
        in-flight requests have committed;
    serve_disagg: a `DisaggRouter` of one prefill and one decode replica.
        Gates: every request handed off (32 tokens each), no fold
        fallback; all 8 streams equal (a)'s (the session keeps its
        sampler draws); the decode tier prefills no token; the shipped
        bytes equal the payloads' blocks times the pool's bytes per
        block; both tiers leak-free;
    (c) the chaos run: the `fleet.step` flag fires at the first router
        step at which every in-flight request of the busiest replica has
        committed 4 to 24 tokens (from (a)'s records; sequential stepping
        is deterministic), killing it. Gates: `fleet.relocations` equals
        the killed replica's in-flight requests, `relocated_tokens` > 0,
        the 6 greedy streams equal (a)'s bit for bit.

    Every run: 8 of 8 FINISHED with 32 tokens, 32 ragged launches a
    ragged step, no leak on a live replica, two hosts in the
    aggregation, no replica dead but (c)'s killed one and no fault
    counter moved but (c)'s relocations (`_fleet_fault_gate`). Returns
    the ragged launches."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.resilience import faults
    from paddle_tpu_torch.serving import (DisaggRouter, FleetRouter,
                                          ServingMetrics)
    from paddle_tpu_torch.tools.serve_workload import (CHUNK, LAYERS,
                                                       fleet_workload,
                                                       retire)

    ServingMetrics.reset_monitor()
    monitor.reset_prefix("fleet.")
    t0 = time.perf_counter()
    hand_out, engines, requests = fleet_workload()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    kw = dict(frontend_kwargs=dict(prefill_chunk_tokens=CHUNK))
    greedy = [i for i, (_p, k) in enumerate(requests)
              if not k.get("temperature")]
    launches = 0
    weights_kv_gb = torch.cuda.memory_allocated() / 2 ** 30

    # (a) the clean fleet, with the chaos site's view before each step
    records = []

    def record(router, handles, step):
        live = router.live_replicas
        busy = max(live, key=lambda r: (r.scheduler.num_running
                                        + len(r.scheduler.waiting),
                                        -router.replicas.index(r)))
        records.append((step, busy.replica_id, [
            len(h.tokens) for h in handles
            if h._replica is busy and not h.status.terminal]))

    torch.cuda.reset_peak_memory_stats()
    router = FleetRouter(hand_out(), 2, **kw)
    clean, _t, run_a = _fleet_run(router, requests, "serve_fleet (a)",
                                  record)
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    _fleet_fault_gate("serve_fleet (a)", router)
    placement = [h.replica_id for h in clean]
    retire(router)
    launches += run_a["launches"]
    ref = [h.tokens for h in clean]

    # serve_disagg: prefill tier engines[0], decode tier engines[1]
    monitor.reset_prefix("fleet.")
    ServingMetrics.reset_monitor()
    moves = {}
    src, dst = engines
    extract, inject = src.extract_kv_blocks, dst.inject_kv_blocks

    def timed_extract(seq_id):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        pay = extract(seq_id)
        torch.cuda.synchronize()
        moves[seq_id] = {"blocks": pay.num_blocks, "tokens": pay.num_tokens,
                         "bytes": pay.nbytes,
                         "extract_ms": (time.perf_counter() - ts) * 1e3}
        return pay

    def timed_inject(seq_id, payload):
        torch.cuda.synchronize()
        ts = time.perf_counter()
        inject(seq_id, payload)
        torch.cuda.synchronize()
        moves[seq_id]["inject_ms"] = (time.perf_counter() - ts) * 1e3

    src.extract_kv_blocks, dst.inject_kv_blocks = timed_extract, timed_inject
    router = DisaggRouter(hand_out(), num_prefill=1, num_decode=1, **kw)
    decode_rep = next(r for r in router.replicas if r.role == "decode")
    decode_prefill = []
    on_chunk = decode_rep.frontend.metrics.on_prefill_chunk

    def counted_chunk(n):
        decode_prefill.append(n)
        on_chunk(n)

    decode_rep.frontend.metrics.on_prefill_chunk = counted_chunk
    try:
        handed, _t, run_d = _fleet_run(router, requests, "serve_disagg")
    finally:
        del src.extract_kv_blocks, dst.inject_kv_blocks
    _fleet_fault_gate("serve_disagg", router)
    launches += run_d["launches"]
    got = [h.tokens for h in handed]
    handoffs = monitor.get("fleet.handoffs")
    bpb = src.manager.bytes_per_block
    shipped = monitor.get("serving.handoff.bytes")
    want_bytes = sum(m["blocks"] * bpb for m in moves.values())
    if handoffs != len(requests) or len(moves) != len(requests) \
            or monitor.get("fleet.handoff_fallbacks") \
            or got != ref or sum(decode_prefill) \
            or shipped != want_bytes \
            or any(m["bytes"] != m["blocks"] * bpb for m in moves.values()) \
            or any(h.replica_id != decode_rep.replica_id for h in handed):
        raise AssertionError(
            f"serve_disagg: handoffs {handoffs} of {len(requests)}, "
            f"fallbacks {monitor.get('fleet.handoff_fallbacks')}, streams "
            f"equal {[a == b for a, b in zip(got, ref)]}, decode-tier "
            f"prefill tokens {sum(decode_prefill)}, bytes {shipped} != "
            f"{want_bytes}")
    per = [m["extract_ms"] + m["inject_ms"] for m in moves.values()]
    emit({"phase": "serve_disagg",
          "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
          "tiers": {"prefill": 1, "decode": 1}, "requests": len(requests),
          "handoffs": handoffs, "handoff_fallbacks": 0,
          "streams_equal_clean_fleet": True,
          "decode_tier_prefill_tokens": 0,
          "shipped_bytes": shipped, "bytes_per_block": bpb,
          "moves": list(moves.values()),
          "handoff_ms_median": statistics.median(per),
          "handoff_ms_max": max(per),
          "handoff_gb_s_median": statistics.median(
              2 * m["bytes"] / 1e6 / (m["extract_ms"] + m["inject_ms"])
              for m in moves.values()),
          **run_d, "tok_s_clean_fleet": run_a["tok_s"],
          "device": kind, "nvidia_smi": smi})
    retire(router)

    # (c) the chaos run: kill the busiest replica mid-decode
    chaos = next((s for s, _rid, toks in records
                  if toks and all(4 <= t <= 24 for t in toks)), None)
    if chaos is None:
        raise AssertionError("serve_fleet: no router step of (a) has every "
                             "in-flight request of the busiest replica at "
                             "4-24 tokens")
    monitor.reset_prefix("fleet.")
    ServingMetrics.reset_monitor()
    router = FleetRouter(hand_out(), 2, **kw)
    killed = {}
    fail = router.fail_replica

    def timed_fail(replica_id, reason="killed"):
        t = time.perf_counter()
        carried = {h.request_id: len(h.tokens) for h in router._handles
                   if h._replica is router._rep(replica_id)
                   and not h.status.terminal}
        victims = fail(replica_id, reason)
        killed.update(t=t, replica=replica_id, victims=victims,
                      carried=carried)
        return victims

    router.fail_replica = timed_fail
    faults.inject("fleet.step", after_n=chaos - 1, times=1, action="flag")
    try:
        hs, times, run_c = _fleet_run(router, requests, "serve_fleet (c)")
    finally:
        faults.clear("fleet.step")
    _fleet_fault_gate("serve_fleet (c)", router, dead=("chaos_kill",),
                      allow=("fleet.relocations",))
    launches += run_c["launches"]
    victims = killed.get("victims", [])
    relocated = [i for i, h in enumerate(hs) if h.num_relocations]
    got = [h.tokens for h in hs]
    if not victims or monitor.get("fleet.relocations") != len(victims) \
            or monitor.get("fleet.relocated_tokens") <= 0 \
            or len(relocated) != len(victims) \
            or any(got[i] != ref[i] for i in greedy):
        raise AssertionError(
            f"serve_fleet (c): {len(victims)} in flight on the killed "
            f"replica, relocations {monitor.get('fleet.relocations')}, "
            f"relocated tokens {monitor.get('fleet.relocated_tokens')}, "
            f"greedy streams equal "
            f"{[got[i] == ref[i] for i in greedy]}")
    next_token_ms = {}
    for i in relocated:
        after = [t for t in times[i] if t > killed["t"]]
        next_token_ms[hs[i].request_id] = (after[0] - killed["t"]) * 1e3
    reprefill = sum(len(hs[i]._req.prompt) for i in relocated)
    sampled = [i for i in range(len(requests)) if i not in greedy]
    emit({"phase": "serve_fleet",
          "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16",
          "replicas": 2, "requests": len(requests),
          "prompt_lens": [len(p) for p, _ in requests],
          "placement": placement, "setup_s": setup_s,
          "weights_and_pools_gb": weights_kv_gb, "peak_mem_gb": peak_gb,
          "clean": run_a, "chaos": {
              **run_c, "chaos_step": chaos, "killed": killed["replica"],
              "in_flight_killed": len(victims),
              "tokens_at_kill": killed["carried"],
              "relocations": monitor.get("fleet.relocations"),
              "relocated_tokens": monitor.get("fleet.relocated_tokens"),
              "reprefilled_tokens": reprefill,
              "kill_to_next_token_ms": next_token_ms,
              "greedy_streams_equal_clean": True,
              "sampled_streams_equal_clean": {
                  hs[i].request_id: got[i] == ref[i] for i in sampled}},
          "device": kind, "nvidia_smi": smi, "sample_tokens": ref[0][:8]})
    router.close()
    return {"ragged_paged_attention": launches}


# ---------------------------------------------------------------------------
# tensor-parallel serving (`serving/tp.py`): SPMD ranks over a gloo group
# ---------------------------------------------------------------------------

TP = 2                 # the ranks' tp degree; NCCL refuses two ranks on
TP_TILES = 4           # one card, so the ranks share it over gloo
TP_WORLD_TIMEOUT_S = 300
# per rank at tp=2 and 4 tiles: qkv and gate_up column shards, one tile of
# the o and down row shards (a view of whole weight rows), the untied head's
# vocab shard (`kernel_compare` times the unsharded shapes)
TP_GEMM_SHAPES = {"qkv_tp2": (6144, 4096), "o_tile_tp2": (1024, 2048),
                  "gate_up_tp2": (11008, 4096),
                  "down_tile_tp2": (1024, 5504), "head_tp2": (16000, 4096)}
TP_REF_TOL = 1e-3      # the card against its CPU run (phase_reference)
TP_TOL = 2e-4          # sharded against unsharded (tests/test_tp_serving.py)
TP_SERVE_MODES = (("serve_tp", 16, None), ("serve_tp_quant", 8, 4))


def _tp_small_llama():
    """The small f32 model of `phase_reference` widened to 4 query and 2
    KV heads (head_dim 128 still), so tp=2 holds whole heads."""
    from paddle_tpu_torch import llama_tiny

    return llama_tiny(vocab=512, layers=2, hidden=512, heads=4, seq=256,
                      num_key_value_heads=2, device="cpu",
                      generator=torch.Generator().manual_seed(3))


def _tp_engines(kind, kv_bits, wbits, device, model):
    from paddle_tpu_torch import LlamaInferenceEngine
    from paddle_tpu_torch.serving import MLPLMEngine, quantize_engine

    geo = dict(max_batch_size=4, num_blocks=64, block_size=16,
               max_blocks_per_seq=16, kv_bits=kv_bits, device=device)
    if kind == "mlp":
        eng = MLPLMEngine(vocab_size=256, hidden=32, seed=5, **geo)
    else:
        eng = LlamaInferenceEngine(model, **geo)
    if wbits is not None:
        quantize_engine(eng, wbits)
    return eng


def _tp_steps(eng, vocab):
    """Three ragged steps (`phase_reference`'s lanes) and a verify window
    of S = 5 on blocks 20-23; f32 logits on the CPU."""
    rng = np.random.default_rng(4)
    tables = np.zeros((4, 16), np.int32)
    tables[0, :3] = [1, 2, 3]
    tables[2, :2] = [4, 5]
    outs = []
    for q_lens, kv_lens in (([20, 0, 9, 0], [20, 0, 9, 0]),
                            ([1, 0, 1, 0], [21, 0, 10, 0]),
                            ([12, 0, 1, 0], [33, 0, 11, 0])):
        tokens = np.zeros((32,), np.int32)
        n = sum(q_lens)
        tokens[:n] = rng.integers(1, vocab, n)
        outs.append(torch.as_tensor(eng.ragged_step(
            tokens, q_lens, kv_lens, tables)).cpu())
    vt = np.zeros((2, 16), np.int32)
    vt[:, :2] = [[20, 21], [22, 23]]
    outs.append(torch.as_tensor(eng.verify_step(
        rng.integers(1, vocab, (2, 5)).astype(np.int32),
        np.asarray([31, 24], np.int32), vt)).cpu())
    return outs


def _tp_reference_cases(tp):
    """Every small engine at `tp` (tp=2: this rank's shard, over the
    world's gloo group): the sharded engine on the card against the same
    shard on the CPU (plain kernel versions) within `TP_REF_TOL`, and
    against the unsharded engine on the card within `TP_TOL` with equal
    argmax."""
    from paddle_tpu_torch.serving import shard_engine

    model = _tp_small_llama()
    report = {}
    for kind, vocab in (("mlp", 256), ("llama", 512)):
        for kv_bits in (16, 8):
            for wbits in (None, 8, 4):
                mk = lambda dev: _tp_engines(  # noqa: E731
                    kind, kv_bits, wbits, dev, model)
                card = _tp_steps(shard_engine(mk("cuda"), tp=tp,
                                              overlap_tiles=TP_TILES), vocab)
                cpu = _tp_steps(shard_engine(mk("cpu"), tp=tp,
                                             overlap_tiles=TP_TILES), vocab)
                plain = _tp_steps(mk("cuda"), vocab)
                name = f"{kind}_kv{kv_bits}_w{wbits or 32}"
                err = max(float((a - b).abs().max())
                          for a, b in zip(card, cpu))
                err_tp = max(float((a - b).abs().max())
                             for a, b in zip(card, plain))
                for a, b, tol, what in (
                        *((a, b, TP_REF_TOL, "its CPU run")
                          for a, b in zip(card, cpu)),
                        *((a, b, TP_TOL, "the unsharded engine")
                          for a, b in zip(card, plain))):
                    if not torch.allclose(a, b, atol=tol, rtol=tol) or \
                            not torch.equal(a.argmax(-1), b.argmax(-1)):
                        raise AssertionError(
                            f"tp_reference {name} tp={tp}: the shard on "
                            f"the card != {what} (max abs err "
                            f"{float((a - b).abs().max())})")
                report[name] = {"card_vs_cpu": err,
                                "card_vs_unsharded": err_tp}
    return report


def _record_rows(fe):
    """Record, per request, the logits row each committed token was
    sampled from (device views: no host sync in the timed run)."""
    sched = fe.scheduler
    state, rows = {}, {}
    gather, commit = sched._gather_rows, sched._commit_token

    def gather_rec(logits, idx):
        state["rows"] = gather(logits, idx)
        return state["rows"]

    def commit_rec(req, tok, slot, t_tok, **kw):
        rows.setdefault(req.req_id, []).append(state["rows"][slot])
        return commit(req, tok, slot, t_tok, **kw)

    sched._gather_rows = gather_rec
    sched._commit_token = commit_rec
    return rows


class _CollectiveClock:
    """Host seconds spent inside `torch.distributed` collective calls and
    in waits on their handles (the tp collectives, the lockstep check and
    the logit gather), while installed. With gloo over CUDA tensors a
    call also waits for the kernels that produce its input."""

    NAMES = ("all_reduce", "all_gather")

    def __init__(self):
        self.seconds, self.calls = 0.0, 0
        self._saved = {}

    def __enter__(self):
        dist = torch.distributed
        for name in self.NAMES:
            fn = getattr(dist, name)
            self._saved[name] = fn
            setattr(dist, name, self._timed(fn))
        return self

    def __exit__(self, *exc):
        for name, fn in self._saved.items():
            setattr(torch.distributed, name, fn)

    def _timed(self, fn):
        clock = self

        class Handle:
            def __init__(self, work):
                self.work = work

            def wait(self):
                t0 = time.perf_counter()
                try:
                    return self.work.wait()
                finally:
                    clock.seconds += time.perf_counter() - t0

        def call(*a, **k):
            t0 = time.perf_counter()
            try:
                out = fn(*a, **k)
            finally:
                clock.seconds += time.perf_counter() - t0
                clock.calls += 1
            return Handle(out) if k.get("async_op") else out
        return call


def _serve_tp_run(label, kv_bits, wbits, rank, tp, group_note):
    """This rank's TP serve of the serve workload: the ranks build and
    shard their base engines one after the other (one full base at a time
    on the card), then serve in lockstep. Gates every request FINISHED
    with its tokens, exact launches a step, per-rank KV bytes equal to
    the unsharded engine's over `tp`, no leaked block. Returns the
    report, every request's stream and the greedy requests' rows."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.serving import ServingFrontend, shard_engine
    from paddle_tpu_torch.tools.serve_workload import (CHUNK, LAYERS,
                                                       NEW_TOKENS,
                                                       serve_engine,
                                                       serve_requests,
                                                       warm_up)

    from paddle_tpu_torch.serving import MLPLMEngine

    dist = torch.distributed
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    # the first `shard_engine` over a group is collective (it creates the
    # group on every rank); later ones reuse it and run one rank at a time
    shard_engine(MLPLMEngine(device="cuda"), tp=tp)
    shard = unsharded_kv = None
    for turn in range(tp):
        if turn == rank:
            base = serve_engine(kv_bits=kv_bits, wbits=wbits)
            unsharded_kv = base.kv_bytes_per_token()
            shard = shard_engine(base, tp=tp, overlap_tiles=TP_TILES)
            del base
            release()
        if dist.is_initialized() and tp > 1:
            dist.barrier()
    setup_s = time.perf_counter() - t0
    build_peak = torch.cuda.max_memory_allocated() / 2 ** 30
    info = shard.quant_info()
    if info["kv_bytes_per_token"] * tp != unsharded_kv:
        raise AssertionError(f"{label}: per-rank KV bytes "
                             f"{info['kv_bytes_per_token']} x {tp} != "
                             f"the unsharded engine's {unsharded_kv}")
    fe = ServingFrontend(shard, prefill_chunk_tokens=CHUNK)
    warm_up(fe)
    requests = serve_requests()
    rows = _record_rows(fe)
    fe.metrics.reset_window()
    torch.cuda.reset_peak_memory_stats()
    _support.reset_launch_counts()
    _reset_engine_calls(monitor)
    clock = _CollectiveClock()
    with clock:
        t1 = time.perf_counter()
        handles = [fe.submit(p, **kw) for p, kw in requests]
        steps = fe.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
    launches = {c: _support.launch_counter(c).count for c in SERVE_KERNELS}
    calls = _engine_calls(monitor)
    bad = [(h.request_id, h.status.value, h.finish_reason, len(h.tokens))
           for h in handles
           if h.status.value != "finished" or len(h.tokens) != NEW_TOKENS]
    if bad:
        raise AssertionError(f"{label}: requests not finished with "
                             f"{NEW_TOKENS} tokens: {bad}")
    n = calls["ragged_steps"]
    expect = {c: 0 for c in launches}
    expect["ragged_paged_attention_q" if kv_bits == 8 else
           "ragged_paged_attention"] = LAYERS * n
    if wbits is not None:
        # qkv, gate_up, the untied head once; o and down once a tile
        expect["quant_matmul_int4" if wbits == 4 else "quant_matmul"] = \
            ((2 + 2 * TP_TILES) * LAYERS + 1) * n
    if launches != expect or calls["verify_steps"] or \
            calls["legacy_decode_steps"] or calls["prefill_steps"]:
        raise AssertionError(f"{label}: kernel launches {launches} != "
                             f"{expect} over engine calls {calls}")
    leaked = fe.scheduler.kv_leaked_blocks()
    if leaked:
        raise AssertionError(f"{label}: {leaked} leaked blocks")
    s = fe.summary()
    tokens_out = sum(len(h.tokens) for h in handles)
    report = {
        "phase": label, "rank": rank, "tp": tp, "group": group_note,
        "tiles": TP_TILES, "kv_bits": kv_bits, "wbits": wbits or 16,
        "requests": len(handles), "tokens_out": tokens_out,
        "scheduler_steps": steps, "engine_calls": calls,
        "kernel_launches": launches,
        "launches_per_step": {c: v / n for c, v in launches.items() if v},
        "wall_s": wall, "tok_s": tokens_out / wall,
        "ms_per_step": 1e3 * wall / n,
        "collective_calls": clock.calls,
        "collective_host_ms_per_step": 1e3 * clock.seconds / n,
        "collective_share": clock.seconds / wall,
        "ttft_p50_ms": s["serving.ttft_p50_ms"],
        "tpot_p50_ms": s["serving.tpot_p50_ms"],
        "kv_bytes_per_token_per_rank": info["kv_bytes_per_token"],
        "kv_bytes_per_token_unsharded": unsharded_kv,
        "setup_s": setup_s, "build_peak_mem_gb": build_peak,
        "serve_peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
        "leaked_blocks": leaked}
    greedy = [i for i, (_p, kw) in enumerate(requests)
              if not kw.get("temperature")]
    saved = {i: torch.stack(rows[handles[i].request_id]).float().cpu()
             for i in greedy}
    streams = [list(h.tokens) for h in handles]
    del fe, shard, rows, handles
    release()
    return report, streams, saved


def _tp_rank_main(rank, world, port, d, tasks):
    """One rank of `phase_tp`'s gloo world (`chip_smoke.py --tp-rank`):
    runs the `tasks` ("reference", "serve") and saves its outcomes to
    `d/rank{rank}.pt`."""
    import datetime

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.distributed.init_process_group(
        "gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank,
        world_size=world, timeout=datetime.timedelta(seconds=300))
    out = {}
    if "reference" in tasks:
        t0 = time.perf_counter()
        out["reference"] = _tp_reference_cases(world)
        out["reference_s"] = time.perf_counter() - t0
    if "serve" in tasks:
        for label, kv_bits, wbits in TP_SERVE_MODES:
            out[label] = _serve_tp_run(label, kv_bits, wbits, rank, world,
                                       f"gloo world of {world} over CUDA "
                                       "tensors, one card")
    torch.save(out, f"{d}/rank{rank}.pt")
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()


def _tp_world(tasks):
    """Spawn the TP ranks (`chip_smoke.py --tp-rank`, one process each,
    sharing the one card over a gloo group) and return their outcomes."""
    import os
    import socket
    import tempfile

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    here = os.path.dirname(os.path.abspath(__file__))
    with tempfile.TemporaryDirectory() as d:
        procs = []
        for r in range(TP):
            with open(f"{d}/rank{r}.log", "w") as log:
                procs.append(subprocess.Popen(
                    [sys.executable, os.path.abspath(__file__), "--tp-rank",
                     str(r), str(TP), str(port), d, ",".join(tasks)],
                    cwd=here, stdout=log, stderr=subprocess.STDOUT))
        deadline = time.monotonic() + TP_WORLD_TIMEOUT_S
        try:
            for p in procs:
                p.wait(timeout=max(1.0, deadline - time.monotonic()))
        except subprocess.TimeoutExpired:
            pass
        finally:
            for p in procs:
                if p.poll() is None:
                    p.kill()
                    p.wait()
        logs = [open(f"{d}/rank{r}.log").read() for r in range(TP)]
        if any(p.returncode for p in procs):
            raise AssertionError("tp ranks failed:\n" + "\n".join(
                f"--- rank {r} (rc {p.returncode}) ---\n{log[-6000:]}"
                for r, (p, log) in enumerate(zip(procs, logs))))
        return [torch.load(f"{d}/rank{r}.pt", weights_only=False)
                for r in range(TP)]


def phase_tp(kind, smi, tasks=("reference", "serve")):
    """Tensor-parallel serving (`serving.tp.shard_engine`). The card holds
    one H100 and NCCL refuses two ranks on one device, so tp=2 runs as
    two processes sharing the card over a gloo group of CUDA tensors; the
    backend real multi-card TP uses, NCCL, runs tp=1 over a one-rank
    group here. These are correctness runs on one card: TP speed needs
    several cards.

    `tp_reference`: small f32 engines (MLP and Llama, kv_bits 16 and 8,
    dense, int8 and int4) at tp=2 in the world of 2 and at tp=1 with no
    group (`_tp_reference_cases`). `serve_tp` / `serve_tp_quant`: the
    serve workload at Llama-2-7B width, 32 layers, bf16 and int8 KV +
    int4, at tp=2 (`_serve_tp_run` on each rank; both ranks' streams
    identical), then every greedy token of rank 0 teacher-forced through
    the unsharded engine (tie-aware agreement 1.0; strict top-1
    reported); then bf16 at tp=1 over a one-rank NCCL group; then the
    int4 gemm at each per-rank shape of the TP path."""
    from paddle_tpu_torch.ops.kernels import _support

    t0 = time.perf_counter()
    # built here once, so the ranks load them instead of compiling twice
    _support.build([_support.CSRC_DIR / f"{stem}.cu" for stem in
                    ("ragged_paged_attention", "quant_matmul")])
    ranks = _tp_world(tasks)
    launches = {c: 0 for c in SERVE_KERNELS}
    if "reference" in tasks:
        one = _tp_reference_cases(1)
        emit({"phase": "tp_reference", "tol_card_vs_cpu": TP_REF_TOL,
              "tol_vs_unsharded": TP_TOL, "tiles": TP_TILES,
              "models": "MLPLMEngine(vocab 256, hidden 32) and llama_tiny("
                        "vocab=512, layers=2, hidden=512, heads=4, "
                        "kv_heads=2) f32",
              "steps": "3 ragged + verify S = 5",
              "tp2": [r["reference"] for r in ranks], "tp1": one,
              "tp2_rank_s": [r["reference_s"] for r in ranks],
              "seconds": time.perf_counter() - t0})
    if "serve" not in tasks:
        return launches
    from paddle_tpu_torch.tools.serve_workload import (CHUNK, serve_engine,
                                                       serve_requests)

    requests = serve_requests()
    for label, kv_bits, wbits in TP_SERVE_MODES:
        reports = [r[label][0] for r in ranks]
        streams = [r[label][1] for r in ranks]
        if any(s != streams[0] for s in streams):
            raise AssertionError(f"{label}: the ranks' token streams "
                                 "differ (lockstep broken)")
        for c in launches:
            launches[c] += reports[0]["kernel_launches"][c]
        engine = serve_engine(kv_bits=kv_bits, wbits=wbits)
        judged = [_teacher_forced(engine, requests[i][0], streams[0][i],
                                  rows.to(engine.device),
                                  CHUNK + engine.max_batch_size)
                  for i, rows in sorted(ranks[0][label][2].items())]
        agreement = _agreement_gate(label, judged, 0.0)
        extra = {}
        if wbits is None:
            extra = _serve_tp1_nccl(engine, requests, launches)
        del engine
        release()
        emit({**reports[0], "rank": None, "ranks": reports,
              "streams_identical_across_ranks": True,
              "teacher_forced_greedy": agreement,
              "reference": "the unsharded engine, teacher-forced in "
                           "steps of the scheduler's 40 packed tokens",
              "note": "a correctness run on one card: both ranks share "
                      "it, so ms a step is not TP speed",
              "device": kind, "nvidia_smi": smi, **extra})
    _tp_gemms(kind, smi)
    emit({"phase": "tp", "seconds": time.perf_counter() - t0})
    return launches


def _tp_gemms(kind, smi):
    """The int4 gemm at each per-rank shape of the TP path (`_gemm_cases`:
    against its plain version, timed beside the plain version and cuBLAS
    bf16); the unsharded shapes are `phase_gemm`'s."""
    gen = torch.Generator(device="cuda").manual_seed(2)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    gemms = _gemm_cases("int4", list(TP_GEMM_SHAPES), gen, flush,
                        table=TP_GEMM_SHAPES)
    del flush
    release()
    emit({"phase": "tp_gemm", "kernel": "quant_matmul_int4", "M": GEMM_M,
          "shapes": "per rank at tp=2, 4 tiles (o and down: one tile)",
          "cases": gemms, "device": kind, "nvidia_smi": smi})


def _serve_tp1_nccl(engine, requests, launches):
    """The bf16 serve at tp=1 over a one-rank NCCL group in this process
    (every collective a real NCCL call): shard `engine`, serve, gate
    FINISHED / launches / leaks, and teacher-force its greedy tokens
    through `engine` (unsharded; its own pools)."""
    from paddle_tpu_torch.framework import monitor
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.serving import ServingFrontend, shard_engine
    from paddle_tpu_torch.tools.moe_workload import one_rank_group
    from paddle_tpu_torch.tools.serve_workload import (CHUNK, LAYERS,
                                                       NEW_TOKENS, warm_up)

    one_rank_group()
    try:
        shard = shard_engine(engine, tp=1, overlap_tiles=TP_TILES)
        fe = ServingFrontend(shard, prefill_chunk_tokens=CHUNK)
        warm_up(fe)
        rows = _record_rows(fe)
        _support.reset_launch_counts()
        _reset_engine_calls(monitor)
        t1 = time.perf_counter()
        handles = [fe.submit(p, **kw) for p, kw in requests]
        steps = fe.run_until_idle()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t1
        got = {c: _support.launch_counter(c).count for c in SERVE_KERNELS}
        n = monitor.get("serving.ragged_steps")
        want = {c: 0 for c in got}
        want["ragged_paged_attention"] = LAYERS * n
        bad = [h.request_id for h in handles
               if h.status.value != "finished" or len(h.tokens) != NEW_TOKENS]
        if bad or got != want or fe.scheduler.kv_leaked_blocks():
            raise AssertionError(f"serve_tp1_nccl: unfinished {bad}, "
                                 f"launches {got} != {want}, leaked "
                                 f"{fe.scheduler.kv_leaked_blocks()}")
        for c in launches:
            launches[c] += got[c]
        judged = [_teacher_forced(engine, requests[i][0], handles[i].tokens,
                                  rows[handles[i].request_id],
                                  CHUNK + engine.max_batch_size)
                  for i, (_p, kw) in enumerate(requests)
                  if not kw.get("temperature")]
        return {"tp1_nccl": {
            "scheduler_steps": steps, "ragged_steps": n,
            "kernel_launches": got, "ms_per_step": 1e3 * wall / n,
            "tok_s": sum(len(h.tokens) for h in handles) / wall,
            "teacher_forced_greedy": _agreement_gate(
                "serve_tp1_nccl", judged, 0.0)}}
    finally:
        torch.distributed.destroy_process_group()


FLASH_SRC = "paddle_tpu_torch/csrc/flash_attention.cu"
FA_PY = "paddle_tpu/ops/pallas/flash_attention.py"

# (B, S, H, KVH, D, causal, dtype, kv_lens): (a) the training shape, (b)
# with GQA, (c) f32 causal and not, (d) kv_lens with an empty sequence,
# (e) past the length where the JAX package streams K/V
# (2 * Sk * D * 2 bytes = 8.9 MB > 8 MiB), (f) several 128-row tiles with
# a ragged last one (the forward's heaviest-first order), (g) the 64-column
# instance at the training length, (h) BERT-base's non-causal attention
FLASH_CASES = {
    "train_mha": (4, 2048, 32, 32, 128, True, torch.bfloat16, None),
    "train_gqa": (4, 2048, 32, 8, 128, True, torch.bfloat16, None),
    "f32_causal": (2, 256, 4, 2, 64, True, torch.float32, None),
    "f32_full": (2, 256, 4, 2, 64, False, torch.float32, None),
    "lens_bf16": (4, 512, 4, 4, 128, False, torch.bfloat16,
                  [512, 259, 0, 17]),
    "stream_17408": (1, 17408, 2, 1, 128, True, torch.bfloat16, None),
    "edge_bf16": (2, 1000, 8, 2, 128, True, torch.bfloat16, None),
    "d64_bf16": (4, 2048, 16, 16, 64, True, torch.bfloat16, None),
    "bert_d64": (32, 512, 12, 12, 64, False, torch.bfloat16, None),
}
# out, per row, relative to the row's largest |out|. bf16: 2^-6, two to
# four bf16 ulps of that largest value: the kernel rounds P to bf16 for
# P.V (relative 2^-9 per term, so about 2^-9 of the row's size after the
# sum) and both sides round the output once; the largest seen on an H100
# is 2^-7, one ulp. f32: 1e-5, ten times the largest seen (1.1e-6). The
# gradients (sums over up to 17408 positions of products whose P and dS
# the kernels round to bf16) within a norm-relative 1e-2, f32 1e-4.
FLASH_OUT_ROW_REL = {torch.bfloat16: 2.0 ** -6, torch.float32: 1e-5}
FLASH_GRAD_TOL = {torch.bfloat16: 1e-2, torch.float32: 1e-4}


def _live_pairs(b, s, causal, lens):
    """(row, column) pairs one head attends to, summed over the batch:
    the work this run's data needs."""
    def one(n):
        n = min(n, s)
        if not causal:
            return s * n
        return n * (n + 1) // 2 + (s - n) * n
    return sum(one(s if lens is None else n) for n in (lens or [s] * b))


def _norm_rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _flash_case(name, gen, flush):
    from paddle_tpu_torch.ops.kernels import flash_attention as fa

    b, s, h, kvh, d, causal, dtype, lens = FLASH_CASES[name]
    dev = torch.device("cuda")
    q = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    k = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype)
    v = torch.randn((b, s, kvh, d), generator=gen, device=dev).to(dtype)
    do = torch.randn((b, s, h, d), generator=gen, device=dev).to(dtype)
    kl = None if lens is None else torch.tensor(lens, dtype=torch.int32,
                                                device=dev)
    out, lse = fa.flash_attention_fwd(q, k, v, causal, kv_lens=kl)
    ref_out, ref_lse = fa.flash_attention_fwd_ref(q, k, v, causal,
                                                  kv_lens=kl)
    delta = (do.float() * ref_out.float()).sum(-1).transpose(1, 2) \
        .contiguous()
    args = (q, k, v, do, ref_lse, delta, causal)
    dq = fa.flash_attention_dq(*args, kv_lens=kl)
    dk, dv = fa.flash_attention_dkv(*args, kv_lens=kl)
    rdq, rdk, rdv = fa.flash_attention_bwd_ref(*args, kv_lens=kl)
    torch.cuda.synchronize()

    o, r = out.float(), ref_out.float()
    err = float((o - r).abs().max())
    mag = float(r.abs().max())
    tol = 2.0 ** (math.floor(math.log2(max(mag, 2.0 ** -126))) - 6) \
        if dtype == torch.bfloat16 else 1e-4
    # row by row: a causal row averages over up to S keys, so most rows
    # are far smaller than row 0 (= v[0]); each row is held to
    # FLASH_OUT_ROW_REL of its own largest |out|, and never looser than
    # `tol` (an empty row must be exactly 0)
    row_err = (o - r).abs().amax(dim=-1)
    row_mag = r.abs().amax(dim=-1)
    row_tol = (FLASH_OUT_ROW_REL[dtype] * row_mag).clamp(max=tol)
    row_rel = float((row_err / row_mag.clamp_min(1e-30)).max())
    if not bool((row_err <= row_tol).all()):
        worst = int((row_err - row_tol).argmax())
        raise AssertionError(
            f"flash {name}: out != plain version in row {worst} (flat "
            f"[B, S, H] index): err {float(row_err.flatten()[worst])} > "
            f"{float(row_tol.flatten()[worst])}; largest row-relative err "
            f"{row_rel}")
    out_rel = _norm_rel(out, ref_out)
    live = ref_lse > -1e29
    lse_err = float((lse[live] - ref_lse[live]).abs().max())
    if lse_err > (1e-3 if dtype == torch.bfloat16 else 1e-5) \
            or not bool((lse[~live] == -1e30).all()):
        raise AssertionError(f"flash {name}: lse != plain version "
                             f"({lse_err})")
    gtol = FLASH_GRAD_TOL[dtype]
    grad = {}
    for gname, got, want in (("dq", dq, rdq), ("dk", dk, rdk),
                             ("dv", dv, rdv)):
        rel = _norm_rel(got, want)
        grad[gname] = {"norm_rel_err": rel, "max_abs_err": float(
            (got.float() - want.float()).abs().max()),
            "max_abs": float(want.float().abs().max())}
        if not rel <= gtol:
            raise AssertionError(f"flash {name}: {gname} != plain version, "
                                 f"norm-relative err {rel} > {gtol}")

    kernel = {
        "flash_attention_fwd": time_ms(lambda: fa.flash_attention_fwd(
            q, k, v, causal, kv_lens=kl), flush),
        "flash_attention_dq": time_ms(lambda: fa.flash_attention_dq(
            *args, kv_lens=kl), flush),
        "flash_attention_dkv": time_ms(lambda: fa.flash_attention_dkv(
            *args, kv_lens=kl), flush)}
    plain_fwd = time_ms(lambda: fa.flash_attention_fwd_ref(
        q, k, v, causal, kv_lens=kl), flush, reps=5)
    plain_bwd = time_ms(lambda: fa.flash_attention_bwd_ref(
        *args, kv_lens=kl), flush, reps=5)

    # the library yardstick: SDPA on [B, H, S, D] copies made here
    sdpa = torch.nn.functional.scaled_dot_product_attention
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_()
                  for x in (q, k, v))
    dot = do.transpose(1, 2).contiguous()
    mask = None if kl is None else fa._live(s, s, causal, kl, dev)
    sdpa_kw = dict(attn_mask=mask, is_causal=causal and mask is None,
                   enable_gqa=h != kvh)

    def lib_fwd():
        return sdpa(qt, kt, vt, **sdpa_kw)

    def lib_fwd_bwd():
        for x in (qt, kt, vt):
            x.grad = None
        lib_fwd().backward(dot)

    lib_f = time_ms(lib_fwd, flush)
    lib_fb = time_ms(lib_fwd_bwd, flush)
    del qt, kt, vt, dot, mask

    pairs = _live_pairs(b, s, causal, lens)
    item = q.element_size()
    nq, nk = b * s * h * d * item, b * s * kvh * d * item
    rows = 4 * b * h * s
    peak = BF16_FLOPS if dtype == torch.bfloat16 else F32_FLOPS
    work = {"flash_attention_fwd": (2 * nq + 2 * nk + rows, 4),
            "flash_attention_dq": (3 * nq + 2 * nk + 2 * rows, 6),
            "flash_attention_dkv": (2 * nq + 4 * nk + 2 * rows, 8)}
    errs = {"flash_attention_fwd": err,
            "flash_attention_dq": grad["dq"]["max_abs_err"],
            "flash_attention_dkv": max(grad["dk"]["max_abs_err"],
                                       grad["dv"]["max_abs_err"])}
    res = {}
    for kname, (nbytes, prods) in work.items():
        flops = prods * d * h * pairs
        bound_ms, bound_by = bound(nbytes, flops, peak)
        res[kname] = {
            "max_abs_err": errs[kname], "kernel_ms": kernel[kname],
            "plain_ms": plain_fwd if kname.endswith("fwd") else plain_bwd,
            "library_ms": lib_f if kname.endswith("fwd") else (
                max(lib_fb - lib_f, 0.0) if kname.endswith("dq") else None),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by}
    res["shape"] = {"B": b, "S": s, "H": h, "KVH": kvh, "D": d,
                    "causal": causal, "kv_lens": lens,
                    "dtype": str(dtype).replace("torch.", "")}
    res["out_tol"] = tol
    res["out_row_rel_tol"] = FLASH_OUT_ROW_REL[dtype]
    res["out_row_rel_err"] = row_rel
    res["out_norm_rel_err"] = out_rel
    res["grad_tol_norm_rel"] = gtol
    res["grads"] = grad
    res["lse_max_abs_err"] = lse_err
    res["library_fwd_bwd_ms"] = lib_fb
    return res


def phase_flash():
    """The three flash kernels against their plain versions (the backward
    kernels on the plain version's own lse and delta). `plain_ms` of dQ
    and dK/dV is the plain backward, which computes both; `library_ms` is
    `F.scaled_dot_product_attention` on [B, H, S, D] copies: its forward
    for the forward kernel, and its forward + backward less its forward
    for the pair, reported once, on the dQ entry ("dq+dkv")."""
    gen = torch.Generator(device="cuda").manual_seed(10)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for name in FLASH_CASES:
        results[name] = _flash_case(name, gen, flush)
        release()
    del flush
    release()
    emit({"phase": "flash", "kernels": ["flash_attention_fwd",
                                        "flash_attention_dq",
                                        "flash_attention_dkv"],
          "library": "F.scaled_dot_product_attention ([B,H,S,D] copies); "
                     "backward = fwd+bwd - fwd, on the dq entry (dq+dkv)",
          "cases": results})
    return results


def phase_rms():
    """The RMSNorm kernel at [8192, 4096] (the training step's rows) in
    bf16 and f32, and at [8192, 8192] (Llama-2-70B's width) in bf16,
    against `rms_norm_ref`: bf16 within one bf16 ulp of the output's
    largest magnitude, f32 within 1e-6 relative, a repeat bit-equal;
    `library_ms` is `F.rms_norm`."""
    from paddle_tpu_torch.ops.kernels import rms_norm as rn

    gen = torch.Generator(device="cuda").manual_seed(12)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    results = {}
    for name, dtype, h in (("bf16", torch.bfloat16, 4096),
                           ("f32", torch.float32, 4096),
                           ("h8192_bf16", torch.bfloat16, 8192)):
        x = (2 * torch.randn((8192, h), generator=gen,
                             device="cuda")).to(dtype)
        w = (1 + 0.1 * torch.randn((h,), generator=gen,
                                   device="cuda")).to(dtype)
        y = rn.rms_norm_fwd(x, w, 1e-6)
        ref = rn.rms_norm_ref(x, w, 1e-6)
        torch.cuda.synchronize()
        yf, rf = y.float(), ref.float()
        err = float((yf - rf).abs().max())
        if dtype == torch.bfloat16:
            # one bf16 ulp of the output's largest magnitude: the output
            # rounds twice (the normalised row, then its product with w),
            # so a one-ulp flip of the first rounding (rsqrtf, summation
            # order) moves a smaller output by up to two of its own ulps
            tol = 2.0 ** (math.floor(math.log2(float(rf.abs().max()))) - 7)
            ok = err <= tol
        else:
            ok = torch.allclose(yf, rf, rtol=1e-6, atol=1e-6)
        if not ok:
            raise AssertionError(f"rms_norm {name}: kernel != plain "
                                 f"version, max abs err {err}")
        # a row's sum runs in a fixed order: a repeat is bit-equal
        if not torch.equal(y, rn.rms_norm_fwd(x, w, 1e-6)):
            raise AssertionError(f"rms_norm {name}: a repeat call differs")
        nbytes = 2 * x.numel() * x.element_size() + w.numel() * \
            w.element_size()
        flops = 4 * x.numel()
        bound_ms, bound_by = bound(nbytes, flops, BF16_FLOPS
                                   if dtype == torch.bfloat16 else F32_FLOPS)
        results[name] = {
            "shape": [8192, h], "max_abs_err": err,
            "kernel_ms": time_ms(lambda: rn.rms_norm_fwd(x, w, 1e-6), flush),
            "plain_ms": time_ms(lambda: rn.rms_norm_ref(x, w, 1e-6), flush),
            "library_ms": time_ms(lambda: torch.nn.functional.rms_norm(
                x, (h,), w, 1e-6), flush),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by, "repeat_bit_equal": True}
        del x, w, y, ref
    del flush
    release()
    emit({"phase": "kernel", "kernel": "rms_norm", "cases": results})
    return results


def phase_train_reference():
    """Three AdamW steps of the small f32 model (head_dim 128, so the f32
    flash kernels and the RMSNorm kernel run on the card) on the card and
    on the CPU (plain versions): losses within 1e-4, every gradient of
    step 1 within 1e-3 of that gradient's largest magnitude, parameters
    after step 3 within 1e-4. lr is 1e-5: Adam's step is scale-free (up to
    lr per element per step whatever the gradient's size), so a gradient
    element at the f32 noise floor moves its parameter by at most 3e-5
    here."""
    from paddle_tpu_torch import llama_tiny
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.optimizer import AdamW

    cpu_m = _small_model()
    gpu_m = llama_tiny(vocab=512, layers=2, hidden=256, heads=2, seq=256,
                       num_key_value_heads=1, device="cuda")
    gpu_m.load_state_dict(cpu_m.state_dict())
    rng = np.random.default_rng(11)
    ids = torch.from_numpy(rng.integers(0, 512, (2, 256)))
    labels = torch.from_numpy(rng.integers(0, 512, (2, 256)))
    kw = dict(learning_rate=1e-5, beta1=0.9, beta2=0.95, epsilon=1e-8,
              weight_decay=0.1)
    runs = [(cpu_m, AdamW(parameters=cpu_m.parameters(), **kw), "cpu"),
            (gpu_m, AdamW(parameters=gpu_m.parameters(), **kw), "cuda")]
    before = {c: _support.launch_counter(c).count for c in (
        "flash_attention_fwd", "flash_attention_dq", "flash_attention_dkv",
        "rms_norm")}
    losses, grads = [], {}
    for step in range(3):
        pair = []
        for m, opt, dev in runs:
            loss, _ = m(ids.to(dev), labels=labels.to(dev))
            loss.backward()
            if step == 0:
                grads[dev] = {n: p.grad.detach().cpu().clone()
                              for n, p in m.named_parameters()}
            opt.step()
            opt.clear_grad()
            pair.append(float(loss.detach()))
        losses.append(pair)
        if abs(pair[0] - pair[1]) > 1e-4:
            raise AssertionError(f"train reference step {step}: loss on the "
                                 f"card {pair[1]} != CPU {pair[0]}")
    grad_err = 0.0
    for n, g in grads["cpu"].items():
        e = float((grads["cuda"][n] - g).abs().max())
        rel = e / max(float(g.abs().max()), 1e-30)
        grad_err = max(grad_err, rel)
        if rel > 1e-3:
            raise AssertionError(f"train reference: grad {n} off by {e} "
                                 f"({rel} of its max)")
    gp = dict(gpu_m.named_parameters())
    param_err = max(float((gp[n].detach().cpu() - p.detach()).abs().max())
                    for n, p in cpu_m.named_parameters())
    if param_err > 1e-4:
        raise AssertionError(f"train reference: parameters after 3 steps "
                             f"off by {param_err}")
    launched = {c: _support.launch_counter(c).count - n
                for c, n in before.items()}
    if not all(launched.values()):
        raise AssertionError(f"train reference: kernels not launched on the "
                             f"card: {launched}")
    emit({"phase": "train_reference", "model": "llama_tiny(vocab=512, "
          "layers=2, hidden=256, heads=2, kv_heads=1) f32", "steps": 3,
          "losses_cpu_card": losses, "grad_max_rel_err": grad_err,
          "param_max_abs_err": param_err, "launches": launched})
    del cpu_m, gpu_m, runs
    release()


TRAIN_KERNELS = {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                 "flash_attention_dkv": 1, "rms_norm": 2}


def phase_train(kind, smi):
    """`train_workload` at Llama-2-7B width (8 layers, batch 4 x 2048): two
    warm-up steps, then timed steps with the launch counts zeroed just
    before and read just after. Gates: every loss finite, the first
    between ln 32000 and 12.4 (random logits of std ~1.3 start near
    11.2), the last below the first (the batch repeats), and per step
    exactly one flash forward, dQ and dK/dV per layer, two RMSNorms per
    layer plus the final one, and no serving kernel."""
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.train_workload import (
        BATCH, LAYERS, SEQ, SPLIT, TIMED_STEPS, TOKENS, WARMUP_STEPS,
        timed_steps, train_step, train_workload)

    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model, opt, ids, labels = train_workload()
    torch.cuda.synchronize()
    setup_s = time.perf_counter() - t0
    losses = [train_step(model, opt, ids, labels)
              for _ in range(WARMUP_STEPS)]
    torch.cuda.synchronize()
    steps = TIMED_STEPS
    _support.reset_launch_counts()
    timed, walls, splits = timed_steps(model, opt, ids, labels)
    losses += timed
    launches = {c: _support.launch_counter(c).count for c in (
        *SERVE_KERNELS, *TRAIN_KERNELS)}
    losses = [float(x) for x in losses]
    if not all(math.isfinite(x) for x in losses):
        raise AssertionError(f"train: non-finite loss {losses}")
    if not math.log(32000) <= losses[0] <= 12.4:
        raise AssertionError(f"train: first loss {losses[0]} outside "
                             f"[ln 32000, 12.4]")
    if not losses[-1] < losses[0]:
        raise AssertionError(f"train: loss did not fall: {losses}")
    expect = {c: 0 for c in launches}
    for c, per_layer in TRAIN_KERNELS.items():
        expect[c] = (per_layer * LAYERS + (c == "rms_norm")) * steps
    if launches != expect:
        raise AssertionError(f"train: kernel launches {launches} != "
                             f"{expect} over {steps} steps")
    step_ms = statistics.median(walls)
    flops = model.flops_per_token(SEQ) * TOKENS
    split = {k: statistics.median(s[k] for s in splits) for k in SPLIT}
    emit({"phase": "train",
          "model": f"llama_7b_shaped(num_layers={LAYERS}) bf16, AdamW "
                   "multi_precision", "batch": BATCH, "seq": SEQ,
          "steps_timed": steps, "step_ms_median": step_ms,
          "step_ms_range": [min(walls), max(walls)], "step_ms": walls,
          "split_ms_median": split, "tok_s": TOKENS / (step_ms / 1e3),
          "model_flops_per_step": flops,
          "mfu": flops / (step_ms / 1e3) / BF16_FLOPS,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "losses": losses, "kernel_launches": launches,
          "setup_s": setup_s, "device": kind, "nvidia_smi": smi})
    del model, opt, ids, labels
    release()
    return launches


# ---- the eager API (paddle_tpu_torch.Tensor over torch autograd) ----

# the eager program's f32 results on the card against its CPU run: a few
# ulps of one op (exp, sin, erfinv, a reduction's order), at most 1e-5
# relative; integers, bools and the seeded draws' bits exactly
EAGER_TOL = dict(rtol=1e-5, atol=1e-6)
# the eager block's gradients against the block with the kernels' plain
# versions, norm-relative: the flash kernels alone are held to 1e-2 in
# bf16, and the block chains two bf16 matmuls after them
EAGER_PLAIN_TOL = 2e-2
EAGER_KERNELS = {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                 "flash_attention_dkv": 1, "rms_norm": 1}


def phase_eager_reference():
    """`eager_workload.eager_program` (creation, promotion, indexing and
    index assignment, reductions, matmul, softmax, backward, a hook,
    `paddle.grad` with `create_graph`, PyLayer, hessian, seeded draws) on
    the card and on the CPU: every float result within EAGER_TOL, every
    integer, bool and random bit equal, every card tensor on the card."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools.eager_workload import eager_program

    with place.device_scope("gpu"):
        t0 = time.perf_counter()
        gpu = eager_program(paddle)
        torch.cuda.synchronize()
        gpu_s = time.perf_counter() - t0
    with place.device_scope("cpu"):
        cpu = eager_program(paddle)
    if str(gpu.pop("place")) != "Place(gpu:0)" \
            or str(cpu.pop("place")) != "Place(cpu:0)":
        raise AssertionError("eager_reference: the program ran on the "
                             "wrong device")
    if set(gpu) != set(cpu):
        raise AssertionError(f"eager_reference: results differ in names "
                             f"{sorted(set(gpu) ^ set(cpu))}")
    worst = {}
    for name in sorted(cpu):
        g, c = np.asarray(gpu[name]), np.asarray(cpu[name])
        if g.dtype != c.dtype or g.shape != c.shape:
            raise AssertionError(f"eager_reference {name}: {g.dtype} "
                                 f"{g.shape} on the card, {c.dtype} "
                                 f"{c.shape} on the CPU")
        if g.dtype.kind == "f":
            np.testing.assert_allclose(g, c, err_msg=name, **EAGER_TOL)
            worst[name] = float(np.abs(g.astype(np.float64) - c).max()) \
                if g.size else 0.0
        elif not np.array_equal(g, c):
            raise AssertionError(f"eager_reference {name}: card {g} != "
                                 f"CPU {c}")
    emit({"phase": "eager_reference", "results": len(cpu),
          "float_results": len(worst), "tol": EAGER_TOL,
          "max_abs_err": max(worst.values()),
          "worst": max(worst, key=worst.get), "card_run_s": gpu_s})


def _apply_overhead_us(n=1000, rounds=7):
    """Host microseconds one eager call adds over its torch call, on
    16-element card tensors: `dispatch.apply` alone, and the public
    `paddle.add` (promotion and checks included). Each loop of `n` calls
    ends in a synchronise; the three loops run in turns, `rounds` times,
    and the medians are compared."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import dispatch

    a = paddle.ones([16])
    t = a._data
    loops = {"torch_add": lambda: torch.add(t, t),
             "apply": lambda: dispatch.apply("add", [a, a]),
             "paddle_add": lambda: paddle.add(a, a)}
    times = {k: [] for k in loops}
    for fn in loops.values():
        for _ in range(50):
            fn()
    for _ in range(rounds):
        for name, fn in loops.items():
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(n):
                fn()
            torch.cuda.synchronize()
            times[name].append((time.perf_counter() - t0) / n * 1e6)
    med = {k: statistics.median(v) for k, v in times.items()}
    return {"torch_add_us": med["torch_add"],
            "apply_us": med["apply"] - med["torch_add"],
            "paddle_add_us": med["paddle_add"] - med["torch_add"]}


def _eager_attention_run(smi):
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import dispatch
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools import eager_workload as ew

    cfg = ew.LLAMA_7B_BLOCK
    heads = cfg["heads"]
    x, w = ew.block_inputs(cfg["batch"], cfg["seq"], cfg["hidden"], heads,
                           "cuda", torch.bfloat16, seed=16)
    X = paddle.Tensor(x, stop_gradient=False)
    W = {n: paddle.Tensor(t, stop_gradient=False) for n, t in w.items()}
    xt = x.clone().requires_grad_()
    wt = {n: t.clone().requires_grad_() for n, t in w.items()}

    def eager_step():
        for t in (X, *W.values()):
            t.clear_gradient()
        loss = ew.eager_block(paddle, X, W, heads)
        loss.backward()
        return loss

    def torch_step():
        for t in (xt, *wt.values()):
            t.grad = None
        loss = ew.torch_block(xt, wt, heads)
        loss.backward()
        return loss

    eager_step()
    torch_step()
    torch.cuda.synchronize()
    _support.reset_launch_counts()
    loss_e = eager_step()
    torch.cuda.synchronize()
    launches = {c: _support.launch_counter(c).count
                for c in (*SERVE_KERNELS, *TRAIN_KERNELS)}
    expect = {c: EAGER_KERNELS.get(c, 0) for c in launches}
    if launches != expect:
        raise AssertionError(f"eager_attention: kernel launches {launches} "
                             f"!= {expect} in one step")
    grads_e = {n: W[n].grad._data.clone() for n in w}
    grads_e["x"] = X.grad._data.clone()
    loss_t = torch_step()
    grads_t = {n: wt[n].grad for n in w}
    grads_t["x"] = xt.grad
    unequal = [n for n in grads_e if not torch.equal(grads_e[n], grads_t[n])]
    if unequal or not torch.equal(loss_e._data, loss_t.detach()):
        raise AssertionError(f"eager_attention: eager != torch-direct in "
                             f"{unequal or ['loss']}")
    (gx,) = paddle.grad(ew.eager_block(paddle, X, W, heads), [X])
    (gxt,) = torch.autograd.grad(ew.torch_block(xt, wt, heads), [xt])
    if not torch.equal(gx._data, gxt):
        raise AssertionError("eager_attention: paddle.grad of x != "
                             "torch.autograd.grad")
    del gx, gxt
    # the plain versions of the kernels on the same inputs
    xp = x.clone().requires_grad_()
    wp = {n: t.clone().requires_grad_() for n, t in w.items()}
    loss_p = ew.plain_block(xp, wp, heads)
    loss_p.backward()
    plain_err = {n: _norm_rel(grads_e[n], (xp if n == "x" else wp[n]).grad)
                 for n in grads_e}
    lp = float(loss_p.detach())
    plain_err["loss"] = abs(float(loss_e) - lp) / abs(lp)
    bad = {n: e for n, e in plain_err.items() if not e <= EAGER_PLAIN_TOL}
    if bad:
        raise AssertionError(f"eager_attention: gradients off the plain "
                             f"versions beyond {EAGER_PLAIN_TOL}: {bad}")
    del xp, wp, loss_p
    release()
    # applies a step, counted outside the timed steps
    n_apply = [0]

    def count(name, outs):
        n_apply[0] += 1
    dispatch.add_op_observer(count)
    eager_step()
    dispatch.remove_op_observer(count)
    walls = {"eager": [], "torch": []}
    for _ in range(6):
        for name, step in (("eager", eager_step), ("torch", torch_step),
                           ("torch", torch_step), ("eager", eager_step)):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            step()
            torch.cuda.synchronize()
            walls[name].append((time.perf_counter() - t0) * 1e3)
    # a second derivative through the flash kernels raises, typed
    q = paddle.to_tensor(np.ones((1, 16, 2, 16), np.float32) * 0.1,
                         stop_gradient=False)
    out = paddle.nn.functional.scaled_dot_product_attention(q, q, q,
                                                            is_causal=True)
    try:
        paddle.grad(out.sum(), [q], create_graph=True)
    except _support.KernelNotDifferentiableError as e:
        refused = str(e)
    else:
        raise AssertionError("eager_attention: create_graph through the "
                             "flash kernels did not raise")
    overhead = _apply_overhead_us()
    eager_ms = statistics.median(walls["eager"])
    torch_ms = statistics.median(walls["torch"])
    emit({"phase": "eager_attention",
          "block": "Llama-2-7B attention block in eager Tensors: rms_norm, "
                   "q/k/v matmul [in, out], causal sdpa, o matmul, "
                   "(out.astype('float32') ** 2).mean(), backward",
          **cfg, "dtype": "bfloat16", "kernel_launches": launches,
          "grads_bit_equal_to_torch_direct": sorted(grads_e),
          "paddle_grad_x_bit_equal": True,
          "plain_norm_rel_err": plain_err,
          "plain_tol_norm_rel": EAGER_PLAIN_TOL,
          "step_ms_eager": eager_ms, "step_ms_torch_direct": torch_ms,
          "step_ms_eager_all": walls["eager"],
          "step_ms_torch_direct_all": walls["torch"],
          "applies_per_step": n_apply[0],
          "host_overhead_us": overhead,
          "create_graph_refused": refused,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "nvidia_smi": smi})
    return launches


def phase_eager_attention(kind, smi):
    """The Llama-2-7B attention block (B 1, S 2048, hidden 4096, 32 heads
    of 128, bf16, `[in, out]` weight Tensors with stop_gradient=False) in
    eager Tensors, one step: exactly one flash forward, dQ, dK/dV and
    RMSNorm launch; every `.grad`, the loss and `paddle.grad` of x
    bit-equal to the same calls on plain tensors under torch autograd;
    the gradients within EAGER_PLAIN_TOL of the block with the kernels'
    plain versions. Times the eager and the torch-direct step (host clock
    around a synchronised step, median of 12 each, in turns), the host
    overhead of one eager op, and checks that `create_graph` through the
    flash kernels raises."""
    from paddle_tpu_torch.framework import place

    torch.cuda.reset_peak_memory_stats()
    with place.device_scope("gpu"):
        launches = _eager_attention_run(smi)
    release()
    return launches


# ---- the paddle-style model path (nn.Layer, optimizer, jit, Predictor) ----

JIT_DIR = Path(__file__).resolve().parent / "build" / "jit_smoke"
JIT_REF_TOL = dict(rtol=1e-5, atol=1e-5)
JIT_LAYER_TOL = 1e-2
# kernel launches a training step of the decoder layer makes (its two
# RMSNorms, one attention), and a Predictor run (the forward)
JIT_TRAIN_STEP = {"flash_attention_fwd": 1, "flash_attention_dq": 1,
                  "flash_attention_dkv": 1, "rms_norm": 2}
JIT_SERVE_RUN = {"flash_attention_fwd": 1, "rms_norm": 2}


def _launch_delta():
    """Every kernel's launches since the last call (the counters are
    zeroed), the non-zero ones."""
    from paddle_tpu_torch.ops.kernels import _support

    counts = {c.name: c.count for c in _support._COUNTERS.values()}
    _support.reset_launch_counts()
    return {n: k for n, k in counts.items() if k}


def phase_jit_reference():
    """`jit_workload.reference_run` (small f32 Layers: an MLP, an
    attention block and a decoder layer, head dim 32) through eager,
    `jit.to_static` (forward and gradients), `jit.save` -> `jit.load` and
    the `Predictor` at batch 1, 3 and 7 of one dynamic-batch program, on
    the card against the same run on the CPU: every result within
    JIT_REF_TOL, with TF32 off. Then a program saved from CPU tensors
    (the attention block: one RMSNorm, one attention) is loaded on the
    card, through `jit.load` and through the `Predictor`: each call
    launches the flash forward and the RMSNorm kernel exactly once, and
    matches the CPU's output within JIT_REF_TOL."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import jit_workload as jw

    assert not torch.backends.cuda.matmul.allow_tf32
    runs = {}
    for dev in ("gpu", "cpu"):
        d = JIT_DIR / f"reference_{dev}"
        d.mkdir(parents=True, exist_ok=True)
        with place.device_scope(dev):
            runs[dev] = jw.reference_run(paddle, jw.reference_models(paddle),
                                         str(d))
    gpu, cpu = runs["gpu"], runs["cpu"]
    if set(gpu) != set(cpu):
        raise AssertionError("jit_reference: results differ in names")
    worst = {}
    for name in sorted(cpu):
        np.testing.assert_allclose(gpu[name], cpu[name], err_msg=name,
                                   **JIT_REF_TOL)
        worst[name] = float(np.abs(gpu[name] - cpu[name]).max())
    # a program saved from CPU tensors, run on the card
    prefix = str(JIT_DIR / "cpu_saved_attention")
    x = np.random.default_rng(23).standard_normal(
        (3, jw.REF["seq"], jw.REF["hidden"])).astype(np.float32)
    with place.device_scope("cpu"):
        block = jw.reference_models(paddle)["attention"]
        block.eval()
        paddle.jit.save(block, prefix, input_spec=[paddle.jit.InputSpec(
            [None, jw.REF["seq"], jw.REF["hidden"]], "float32")])
        ref = block(paddle.to_tensor(x)).numpy()
    expect = {"flash_attention_fwd": 3, "rms_norm": 3}
    cpu_saved = {}
    with place.device_scope("gpu"):
        loaded = paddle.jit.load(prefix)
        predictor = paddle.inference.create_predictor(
            paddle.inference.Config(prefix + ".pdmodel",
                                    prefix + ".pdiparams"))
        for label, fn in (("jit_load", lambda: loaded(paddle.to_tensor(x))),
                          ("predictor", lambda: predictor.run(
                              [paddle.to_tensor(x)])[0])):
            fn()
            torch.cuda.synchronize()
            _launch_delta()
            outs = [fn() for _ in range(3)]
            torch.cuda.synchronize()
            launched = _launch_delta()
            if launched != expect:
                raise AssertionError(f"jit_reference {label}: a CPU-saved "
                                     f"program launched {launched} in 3 "
                                     f"calls, not {expect}")
            if outs[0].place != paddle.CUDAPlace(0):
                raise AssertionError(f"jit_reference {label}: output on "
                                     f"{outs[0].place}")
            for o in outs:
                np.testing.assert_allclose(o.numpy(), ref, err_msg=label,
                                           **JIT_REF_TOL)
            cpu_saved[label] = {"launches_per_call": {
                k: v / 3 for k, v in launched.items()},
                "max_abs_err": float(np.abs(outs[0].numpy() - ref).max())}
        ops = jw.program_ops(loaded._program)
    emit({"phase": "jit_reference", "results": len(cpu),
          "tol": JIT_REF_TOL, "max_abs_err": max(worst.values()),
          "worst": max(worst, key=worst.get),
          "cpu_saved_program_on_card": cpu_saved, "program_ops": ops})
    release()


def phase_jit_layer(kind, smi):
    """One Llama-2-7B decoder layer (`eager_workload.decoder_layer`:
    RMSNorm, q/k/v/o Linear 4096 -> 4096, rotary over rope buffers,
    causal sdpa of 32 heads of 128, RMSNorm, SwiGLU 11008; bf16, one
    sequence of 2048 tokens) written as paddle Layers
    (`jit_workload.layer_run`): two AdamW(multi_precision) steps eagerly
    and two through `jit.to_static` from the same seeded weights (loss
    and every gradient within JIT_LAYER_TOL norm-relative of the eager
    ones; whether they are bit-equal is printed), then `jit.save` with a
    dynamic batch and the `Predictor` at batch 1 and 2 (each output within
    JIT_LAYER_TOL of the eager eval forward). Launch gates, each exact:
    JIT_TRAIN_STEP a training step, eager and to_static, and
    JIT_SERVE_RUN a Predictor run; the saved program holds the flash and
    RMSNorm custom ops and no softmax (no plain attention). Step ms are
    host time around a synchronised step (step 0 of to_static includes
    its capture)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import eager_workload as ew
    from paddle_tpu_torch.tools import jit_workload as jw

    cfg = ew.LLAMA_7B_LAYER
    JIT_DIR.mkdir(parents=True, exist_ok=True)
    torch.cuda.reset_peak_memory_stats()
    with place.device_scope("gpu"):
        r = jw.layer_run(paddle, cfg, "bfloat16",
                         str(JIT_DIR / "llama7b_layer"), steps=2,
                         sync=torch.cuda.synchronize,
                         launches=_launch_delta)
    totals = {}
    for label, got in r["launches"].items():
        if got != JIT_TRAIN_STEP:
            raise AssertionError(f"jit_layer {label}: launches {got} != "
                                 f"{JIT_TRAIN_STEP}")
        for k, v in got.items():
            totals[k] = totals.get(k, 0) + v
    for step, errs in r["static_vs_eager"].items():
        bad = {n: e for n, e in errs.items() if not e <= JIT_LAYER_TOL}
        if bad:
            raise AssertionError(f"jit_layer {step}: to_static off eager "
                                 f"beyond {JIT_LAYER_TOL}: {bad}")
    for label, run in r["serve"].items():
        if run["launches_per_run"] != JIT_SERVE_RUN:
            raise AssertionError(f"jit_layer predictor {label}: launches "
                                 f"{run['launches_per_run']} != "
                                 f"{JIT_SERVE_RUN} a run")
        if not run["norm_rel_err"] <= JIT_LAYER_TOL:
            raise AssertionError(f"jit_layer predictor {label}: "
                                 f"{run['norm_rel_err']} off the eager "
                                 f"eval forward")
        for k, v in run["launches_per_run"].items():
            totals[k] = totals.get(k, 0) + int(v * 3)
    ops = r["program_ops"]
    if any("softmax" in k for k in ops) or ops.get(
            "paddle_tpu_torch.flash_attention.default") != 1 or ops.get(
            "paddle_tpu_torch.rms_norm.default") != 2:
        raise AssertionError(f"jit_layer: the saved program's ops {ops}")
    emit({"phase": "jit_layer",
          "layer": "Llama-2-7B decoder layer as paddle Layers (RMSNorm, "
                   "q/k/v/o Linear, rotary over rope buffers, causal sdpa, "
                   "RMSNorm, SwiGLU MLP), AdamW(multi_precision)",
          **cfg, "dtype": "bfloat16", "kernel_launches": r["launches"],
          "static_vs_eager_norm_rel": r["static_vs_eager"],
          "static_bit_equal_to_eager": r["bit_equal"],
          "tol_norm_rel": JIT_LAYER_TOL, "step_ms": r["ms"],
          "export_s": r["export_s"], "load_s": r["load_s"],
          "pdiparams_bytes": r["pdiparams_bytes"],
          "pdmodel_bytes": r["pdmodel_bytes"], "program_ops": ops,
          "predictor": r["serve"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "device": kind, "nvidia_smi": smi})
    del r
    release()
    return totals


# ---- lazy eager mode as CUDA graphs, and AMP (core/lazy.py, amp/) ----

LAZY_REF_TOL = dict(rtol=1e-5, atol=1e-5)
# the parameters after the AdamW steps: an eps-dominated first update
# turns a last-bit difference of a gradient into up to one lr step
# (1e-3), the bound `tests/test_lazy_eager.py` holds them to
LAZY_PARAM_TOL = dict(rtol=0, atol=1e-3)
# bf16 results of the AMP cases: the card's and the CPU's bf16 products
# round alike only within a bf16 ulp or two
LAZY_AMP_TOL = dict(rtol=1e-2, atol=1e-2)
LAZY_LLAMA_TOL = 1e-3
# kernel launches of one lazy_llama step: the flash forward, dQ and dK/dV
# once a layer, the RMSNorm kernel twice a layer and once at the end
LAZY_STEP = {"flash_attention_fwd": 4, "flash_attention_dq": 4,
             "flash_attention_dkv": 4, "rms_norm": 9}


def _held_to(label, got, want, tol):
    """Every float array of `want` (nested dicts / lists) within `tol` of
    `got`'s; everything else equal. Returns the largest difference."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: keys {sorted(set(got) ^ set(want))}")
        return max([_held_to(f"{label}.{k}", got[k], want[k], tol)
                    for k in want] or [0.0])
    if isinstance(want, (list, tuple)) and want and \
            isinstance(want[0], np.ndarray):
        return max(_held_to(f"{label}[{i}]", g, w, tol)
                   for i, (g, w) in enumerate(zip(got, want)))
    if isinstance(want, np.ndarray) and want.dtype.kind == "f":
        np.testing.assert_allclose(got, want, err_msg=label, **tol)
        return float(np.abs(np.asarray(got, np.float64) - want).max()) \
            if want.size else 0.0
    if isinstance(want, np.ndarray):
        np.testing.assert_array_equal(got, want, err_msg=label)
    elif got != want:
        raise AssertionError(f"{label}: card {got} != CPU {want}")
    return 0.0


def phase_lazy_reference():
    """`lazy_workload.reference_run` on the card and on the CPU: the
    Llama in paddle Layers (`llama_tiny`, f32, seed 7) two AdamW steps
    eagerly and two under lazy mode (a region run eagerly at its first
    sight and captured as a CUDA graph at its second), the card within
    LAZY_REF_TOL of the CPU and lazy within LAZY_REF_TOL of eager on each
    (losses, first-step gradients; the parameters after within
    LAZY_PARAM_TOL);
    AMP O1 and O2 (decorate, float32 masters) and a GradScaler step that
    skips on an inf, the card equal to the CPU (bf16 results within
    LAZY_AMP_TOL). Prints the lazy.* counters of each device's lazy run.
    Returns the kernel launches of its card run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import lazy_workload as lw

    assert not torch.backends.cuda.matmul.allow_tf32
    runs = {}
    _launch_delta()
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            runs[dev] = lw.reference_run(paddle)
        if dev == "gpu":
            torch.cuda.synchronize()
            launches = _launch_delta()
    gpu, cpu = runs["gpu"], runs["cpu"]
    worst = {}
    tols = {"losses": LAZY_REF_TOL, "grads": LAZY_REF_TOL,
            "params": LAZY_PARAM_TOL}
    for mode in ("eager", "lazy"):
        for part, tol in tols.items():
            worst[f"{mode}.{part}"] = _held_to(
                f"lazy_reference card {mode} {part}", gpu[mode][part],
                cpu[mode][part], tol)
    for dev, r in runs.items():
        for part, tol in tols.items():
            worst[f"{dev}.lazy_vs_eager.{part}"] = _held_to(
                f"lazy_reference {dev} lazy vs eager {part}",
                r["lazy"][part], r["eager"][part], tol)
    worst["amp"] = _held_to("lazy_reference amp", gpu["amp"], cpu["amp"],
                            LAZY_AMP_TOL)
    if not gpu["amp"]["inf_step_skipped"]:
        raise AssertionError("lazy_reference: the GradScaler did not skip "
                             "the inf step on the card")
    shared = {k: v for k, v in gpu["lazy"]["counters"].items()
              if k in cpu["lazy"]["counters"]}
    if shared != cpu["lazy"]["counters"]:
        raise AssertionError(f"lazy_reference: lazy counters {shared} on "
                             f"the card, {cpu['lazy']['counters']} on the "
                             f"CPU")
    lazy.clear_graphs()
    emit({"phase": "lazy_reference", "tol": LAZY_REF_TOL,
          "param_tol": LAZY_PARAM_TOL,
          "amp_tol": LAZY_AMP_TOL, "max_abs_err": worst,
          "lazy_counters": {"gpu": gpu["lazy"]["counters"],
                            "cpu": cpu["lazy"]["counters"]},
          "amp": {k: v for k, v in gpu["amp"].items()
                  if not isinstance(v, (np.ndarray, list))},
          "launches": launches})
    release()
    return launches


def _lazy_llama_run(paddle, lw, lazy_on):
    model, opt, ids, labels = lw.llama_workload(paddle, seed=0)
    r = lw.run_steps(paddle, model, opt, ids, labels, lazy_on,
                     torch.cuda.synchronize, _launch_delta)
    del model, opt, ids, labels
    return r


def phase_lazy_llama(kind, smi):
    """Llama-2-7B width at LAYERS of its 32 layers as paddle Layers
    (`lazy_workload.llama_workload`: bf16 by `amp.decorate(level="O2")`
    under `auto_cast(level="O2")`, AdamW(multi_precision), B 1 x S 2048):
    2 warm-up and 3 timed steps eagerly, the eager model freed, then the
    same from the same seed under lazy mode. Gates: finite, falling
    losses; lazy losses and first-step gradients within LAZY_LLAMA_TOL
    norm-relative of eager (bit-equality printed); no capture after the
    warm-up and no uncaptured card replay in the timed steps; LAZY_STEP
    launches every timed step, eager and lazy. Step ms are host time
    around a synchronised step; host ms end when the step returns."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import lazy_workload as lw

    torch.cuda.reset_peak_memory_stats()
    _launch_delta()
    runs = {}
    with place.device_scope("gpu"):
        for mode in ("eager", "lazy"):
            runs[mode] = _lazy_llama_run(paddle, lw, mode == "lazy")
            if mode == "lazy":
                graph_bytes = sum(lazy.graph_bytes())
                reserved_gb = torch.cuda.memory_reserved() / 2 ** 30
                lazy.clear_graphs()
            release()
    eager, lz = runs["eager"], runs["lazy"]
    totals = {}
    for mode, r in runs.items():
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[0]:
            raise AssertionError(f"lazy_llama {mode}: losses {losses}")
        for i, got in enumerate(r["launches"]):
            if got != LAZY_STEP:
                raise AssertionError(f"lazy_llama {mode} timed step {i}: "
                                     f"launches {got} != {LAZY_STEP}")
        for d in [r["warmup_launches"], *r["launches"]]:
            for k, v in d.items():
                totals[k] = totals.get(k, 0) + v
    loss_err = max(abs(a - b) / abs(b)
                   for a, b in zip(lz["losses"], eager["losses"]))
    grad_err = {n: _norm_rel(lz["grads"][n], eager["grads"][n])
                for n in eager["grads"]}
    worst = max(grad_err, key=grad_err.get)
    if not loss_err <= LAZY_LLAMA_TOL or \
            not grad_err[worst] <= LAZY_LLAMA_TOL:
        raise AssertionError(f"lazy_llama: lazy off eager: loss {loss_err}, "
                             f"{worst} {grad_err[worst]}")
    bit_equal = {"losses": lz["losses"] == eager["losses"],
                 "grads": sorted(n for n in eager["grads"] if torch.equal(
                     lz["grads"][n], eager["grads"][n]))}
    timed = lz["timed_counters"]
    if timed.get("lazy.graph_captures", 0) or \
            timed.get("lazy.uncaptured_replays", 0) or \
            timed.get("lazy.graph_replays") != lw.TIMED_STEPS:
        raise AssertionError(f"lazy_llama: timed steps moved {timed}")
    emit({"phase": "lazy_llama",
          "model": f"Llama-2-7B width in paddle Layers, {lw.LAYERS} of 32 "
                   f"layers, amp O2 bf16 (norms f32), AdamW(multi_precision)",
          "batch": lw.BATCH, "seq": lw.SEQ, "launches_per_step": LAZY_STEP,
          "losses": {"eager": eager["losses"], "lazy": lz["losses"]},
          "loss_norm_rel": loss_err, "grad_norm_rel_worst": [
              worst, grad_err[worst]], "tol_norm_rel": LAZY_LLAMA_TOL,
          "lazy_bit_equal_to_eager": {"losses": bit_equal["losses"],
                                      "grads": len(bit_equal["grads"]),
                                      "of": len(eager["grads"])},
          "step_ms": {m: statistics.median(r["wall_ms"])
                      for m, r in runs.items()},
          "host_ms": {m: statistics.median(r["host_ms"])
                      for m, r in runs.items()},
          "step_ms_all": {m: r["wall_ms"] for m, r in runs.items()},
          "host_ms_all": {m: r["host_ms"] for m, r in runs.items()},
          "lazy_counters": {"warmup": lz["warmup_counters"],
                            "timed": timed},
          "graph_static_bytes": graph_bytes,
          "reserved_gb_with_graph": reserved_gb,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "device": kind, "nvidia_smi": smi})
    del runs, eager, lz
    release()
    return totals


# ---- the op surface and the training loop (tools/loop_workload.py) ----

# the attention routes at the training shape (B, S, H, D), causal bf16
ROUTE_SHAPE = (4, 2048, 32, 128)
# the causal bool mask's composite against the kernel, norm-relative
ROUTE_MASK_TOL = 2e-2
LOOP_REF_TOL = 1e-5
LOOP_LR_TOL = 1e-7
LOOP_CLIP_TOL = 1e-2
LOOP_LAZY_TOL = 1e-3


def _attention_routes():
    """`loop_workload.attention_routes` at ROUTE_SHAPE (causal, bf16).
    Returns its report and launches."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import loop_workload as lw

    gen = torch.Generator(device="cuda").manual_seed(19)
    q, k, v, dout = (torch.randn(ROUTE_SHAPE, generator=gen,
                                 device="cuda").to(torch.bfloat16)
                     for _ in range(4))
    return lw.attention_routes(paddle, q, k, v, dout,
                               torch.cuda.synchronize, _launch_delta,
                               ROUTE_MASK_TOL)


# the exports of each manifest namespace the harness runs on the card,
# and of those the ones whose outputs are held to the CPU's by value (the
# rest run on inputs of no recipe, or are layers, checks or samplers the
# harness keeps no output of): all of the nn, fft and signal namespaces;
# all of paddle.linalg but `lu_unpack` and `ormqr` and of `paddle` /
# `Tensor` but the names the harness skips (held instead by the
# realistic-size decompositions and the CPU tests)
OPS_NS_HELD = {"paddle.nn.functional": (128, 111), "paddle.nn": (140, 120),
               "paddle.linalg": (31, 31), "paddle.fft": (22, 22),
               "paddle.signal": (2, 2), "paddle": (410, 356),
               "Tensor": (371, 359)}
# the realistic-size cases, card against CPU: Whisper's spectrum and log
# power norm-relative, the reconstruction of the audio absolutely
WHISPER_TOL = 1e-5
# each factorisation's reconstruction residual (norm-relative, in float64
# on the host; `solve` by its backward error) on both devices, and the
# eigen- / singular values card against CPU relative to the largest. The
# float32 limits lie between the sound readings on an H100 and those of
# cuSOLVER's default SVD driver, which the port's `svd` does not take:
# residual 4.6e-6 sound, 3.2e-4 default; singular values card / CPU
# 1.28e-5 sound (the card's own distance from float64), 1.69e-4 default
DECOMP_N = 1024
DECOMP_RESIDUAL = {"float32": 3e-5, "float64": 1e-12}
DECOMP_VALUES = {"float32": 3e-5, "float64": 1e-10}


def phase_ops_reference():
    """The op harness (`testing/op_harness.py`) over the manifest's
    `paddle`, `Tensor`, `paddle.nn.functional`, `paddle.nn`,
    `paddle.linalg`, `paddle.fft` and `paddle.signal` exports on the card
    and on the CPU (`loop_workload.ops_sweep`), the card held to the CPU
    (`compare_sweeps`: the same exports ran, at least OPS_NS_HELD of each
    namespace run and compared by value, outputs on the card, float64
    within 1e-9 relative, float32 within 1e-5, integers, bools and seeded
    draws bit-equal, the same finite-difference verdicts, the
    decompositions by their sign-free invariants); then the attention routes at the training shape
    (`_attention_routes`) and the two realistic-size cases
    (`_whisper_case`, `_decomposition_case` in f32 and f64). Returns the
    kernel launches of its card run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import loop_workload as lw

    _launch_delta()
    t0 = time.perf_counter()
    card = lw.ops_sweep(paddle, "gpu")
    torch.cuda.synchronize()
    launches = _launch_delta()
    t1 = time.perf_counter()
    cpu = lw.ops_sweep(paddle, "cpu")
    t2 = time.perf_counter()
    stats = lw.compare_sweeps(card, cpu, device="cuda")
    for ns, (ran, held) in OPS_NS_HELD.items():
        got = stats["per_namespace"].get(ns, {})
        if got.get("ran", 0) < ran or got.get("compared", 0) < held:
            raise AssertionError(f"ops_reference: {ns} {got}, asked for "
                                 f"{ran} run and {held} compared")
    routes, route_launches = _attention_routes()
    for n, c in route_launches.items():
        launches[n] = launches.get(n, 0) + c
    t3 = time.perf_counter()
    whisper = _whisper_case(paddle, lw)
    decomp = {dt: _decomposition_case(paddle, lw, dt)
              for dt in ("float32", "float64")}
    emit({"phase": "ops_reference", "per_namespace": stats["per_namespace"],
          "max_abs_err": stats["max_abs_err"],
          "tol": {"float64": lw.TOL64, "float32": lw.TOL32},
          "sweep_s": {"card": t1 - t0, "cpu": t2 - t1},
          "attention_routes": routes, "whisper_stft": whisper,
          "decompositions": decomp,
          "realistic_cases_s": time.perf_counter() - t3,
          "launches": launches})
    release()
    return launches


def _whisper_case(paddle, lw):
    """`loop_workload.whisper_front_end` on the card and on the CPU: the
    spectrum and log power within WHISPER_TOL norm-relative, and each
    device's `istft` within WHISPER_TOL of the audio."""
    from paddle_tpu_torch.framework import place

    runs, secs = {}, {}
    for dev in ("gpu", "cpu"):
        t0 = time.perf_counter()
        with place.device_scope(dev):
            runs[dev] = lw.whisper_front_end(paddle)
        secs[dev] = time.perf_counter() - t0
    gpu, cpu = runs["gpu"], runs["cpu"]
    err = {k: float(np.linalg.norm(gpu[k] - cpu[k])
                    / np.linalg.norm(cpu[k])) for k in ("spec", "log_spec")}
    err.update({f"istft_{d}": float(np.abs(r["back"] - r["audio"]).max())
                for d, r in runs.items()})
    if not max(err.values()) <= WHISPER_TOL:
        raise AssertionError(f"ops_reference whisper stft: {err}")
    return {"batch": lw.WHISPER_BATCH, "samples": cpu["audio"].shape[-1],
            "n_fft": lw.WHISPER_N_FFT, "hop": lw.WHISPER_HOP,
            "spec_shape": list(cpu["spec"].shape), "err": err,
            "tol": WHISPER_TOL, "run_s": secs}


def _decomposition_case(paddle, lw, dtype):
    """`loop_workload.decompositions` at DECOMP_N on the card and on the
    CPU: every residual within DECOMP_RESIDUAL on both, the eigen- and
    singular values card against CPU within DECOMP_VALUES of the
    largest. Reports each device's values against numpy's float64 ones
    (`float64_values`), which says which device the difference is on."""
    from paddle_tpu_torch.framework import place

    runs = {}
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            runs[dev] = lw.decompositions(paddle, DECOMP_N, dtype)
    worst = max(v for r in runs.values() for v in r["residuals"].values())
    keys = ("eigenvalues", "singular_values")

    def rel(got, want):
        return float(np.abs(got - want).max() / np.abs(want).max())

    values = {k: rel(runs["gpu"][k], runs["cpu"][k]) for k in keys}
    exact = lw.float64_values(DECOMP_N, dtype)
    off64 = {d: {k: rel(r[k], exact[k]) for k in keys}
             for d, r in runs.items()}
    if not worst <= DECOMP_RESIDUAL[dtype] or \
            not max(values.values()) <= DECOMP_VALUES[dtype]:
        raise AssertionError(f"ops_reference decompositions {dtype}: "
                             f"{ {d: r['residuals'] for d, r in runs.items()} }"
                             f" {values}")
    return {"n": DECOMP_N, "residuals": {d: r["residuals"]
                                         for d, r in runs.items()},
            "values_rel_err": values, "values_off_float64": off64,
            "tol": {"residual": DECOMP_RESIDUAL[dtype],
                    "values": DECOMP_VALUES[dtype]}}


def _held_rel(label, got, want, tol):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    err = float(np.abs(got - want).max() / max(np.abs(want).max(), 1e-30))
    if not err <= tol:
        raise AssertionError(f"{label}: relative {err} > {tol}")
    return err


def phase_train_loop_reference():
    """`loop_workload.reference_run` on the card and on the CPU: the
    Trainer's loop (AdamW with decay off the norms, a global-norm clip,
    warm-up + cosine) on `llama_tiny` Layers (f32, seed 7) for 3 steps,
    the card within LOOP_REF_TOL of the CPU for the losses, pre-clip
    norms and learning rates and (norm-relative) each parameter after;
    and each of Adagrad, Adadelta, RMSProp, Adamax, Lamb, NAdam, RAdam
    and LBFGS two steps on a small Layer model, card within LOOP_REF_TOL
    of the CPU. Returns the kernel launches of its card run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import loop_workload as lw

    runs = {}
    _launch_delta()
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            runs[dev] = lw.reference_run(paddle)
        if dev == "gpu":
            torch.cuda.synchronize()
            launches = _launch_delta()
    gpu, cpu = runs["gpu"]["loop"], runs["cpu"]["loop"]
    worst = {p: _held_rel(f"train_loop_reference {p}", gpu[p], cpu[p],
                          LOOP_REF_TOL) for p in ("losses", "norms", "lrs")}
    worst["params"] = max(_norm_rel(torch.from_numpy(gpu["params"][n]),
                                    torch.from_numpy(w))
                          for n, w in cpu["params"].items())
    for dev, r in runs.items():
        lr_err = max(abs(a - lw.lr_at(i))
                     for i, a in enumerate(r["loop"]["lrs"]))
        if not lr_err <= LOOP_LR_TOL:
            raise AssertionError(f"train_loop_reference {dev}: lr off the "
                                 f"schedule by {lr_err}")
    opt_err = {}
    for name, w in runs["cpu"]["optimizers"].items():
        g = runs["gpu"]["optimizers"][name]
        opt_err[name] = max([_held_rel(f"train_loop_reference {name}",
                                       g["losses"], w["losses"],
                                       LOOP_REF_TOL)]
                            + [_norm_rel(torch.from_numpy(a),
                                         torch.from_numpy(b))
                               for a, b in zip(g["params"], w["params"])])
    if not max([worst["params"], *opt_err.values()]) <= LOOP_REF_TOL:
        raise AssertionError(f"train_loop_reference: {worst} {opt_err}")
    emit({"phase": "train_loop_reference", "tol": LOOP_REF_TOL,
          "max_rel_err": worst, "optimizers_rel_err": opt_err,
          "losses": {"gpu": gpu["losses"], "cpu": cpu["losses"]},
          "launches": launches})
    release()
    return launches


def _train_loop_run(paddle, lw, lazy_on):
    work = lw.loop_workload(paddle, seed=0)
    r = lw.run_loop(paddle, work, lazy_on, torch.cuda.synchronize,
                    _launch_delta,
                    lambda: torch.cuda.Event(enable_timing=True))
    del work
    return r


def phase_train_loop(kind, smi):
    """The loop PaddleNLP's Trainer builds, at Llama-2-7B width
    (`loop_workload.loop_workload`: LAYERS of 32 layers as paddle Layers,
    bf16 by `amp.decorate(level="O2")`, B 1 x S 2048 with the last 256
    labels ignored, AdamW(multi_precision, beta2 0.95, decay 0.01 off the
    norms) with ClipGradByGlobalNorm(1.0) over LinearWarmup(
    CosineAnnealingDecay(3e-4, 8), 2)): 2 warm-up and 4 timed steps
    eagerly, the model freed, then the same from the same seed under lazy
    mode. Gates: finite losses, the last timed loss below the first; each
    step's learning rate the schedule's closed form within LOOP_LR_TOL;
    in the warm-up the clipped gradients' norm min(pre-clip, 1) within
    LOOP_CLIP_TOL; lazy within LOOP_LAZY_TOL norm-relative of eager
    (losses, pre-clip norms; bit-equality printed); no capture and no
    uncaptured replay in the timed steps and the same replays in each;
    LAZY_STEP launches every timed step, eager and lazy. Returns the
    launches of both runs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import loop_workload as lw

    torch.cuda.reset_peak_memory_stats()
    _launch_delta()
    runs, totals = {}, {}
    with place.device_scope("gpu"):
        for mode in ("eager", "lazy"):
            runs[mode] = _train_loop_run(paddle, lw, mode == "lazy")
            for d in [runs[mode]["warmup_launches"],
                      *runs[mode]["launches"]]:
                for n, c in d.items():
                    totals[n] = totals.get(n, 0) + c
            if mode == "lazy":
                lazy.clear_graphs()
            release()
    n_warm = lw.WARMUP_STEPS
    for mode, r in runs.items():
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[n_warm]:
            raise AssertionError(f"train_loop {mode}: losses {losses}")
        lr_err = max(abs(a - lw.lr_at(i)) for i, a in enumerate(r["lrs"]))
        if not lr_err <= LOOP_LR_TOL:
            raise AssertionError(f"train_loop {mode}: lr {r['lrs']}")
        for pre, post in zip(r["norms"], r["post_norms"]):
            if not abs(post - min(pre, 1.0)) <= LOOP_CLIP_TOL * min(pre,
                                                                    1.0):
                raise AssertionError(f"train_loop {mode}: clipped norm "
                                     f"{post} of {pre}")
        for i, got in enumerate(r["launches"]):
            if got != LAZY_STEP:
                raise AssertionError(f"train_loop {mode} timed step {i}: "
                                     f"launches {got} != {LAZY_STEP}")
    eager, lz = runs["eager"], runs["lazy"]
    err = {p: _norm_rel(torch.tensor(lz[p]), torch.tensor(eager[p]))
           for p in ("losses", "norms")}
    if not max(err.values()) <= LOOP_LAZY_TOL:
        raise AssertionError(f"train_loop: lazy off eager {err}")
    timed = lz["timed_counters"]
    replays = [c.get("lazy.graph_replays", 0) for c in lz["step_counters"]]
    if timed.get("lazy.graph_captures", 0) or \
            timed.get("lazy.uncaptured_replays", 0) or \
            len(set(replays)) != 1 or not replays[0]:
        raise AssertionError(f"train_loop: timed steps moved {timed}, "
                             f"replays {replays}")

    def med(r, key):
        return statistics.median(r[key])

    emit({"phase": "train_loop",
          "model": f"Llama-2-7B width in paddle Layers, {lw.LAYERS} of 32 "
                   f"layers, amp O2 bf16, AdamW(multi_precision, beta2 "
                   f"0.95, wd 0.01 off the norms), ClipGradByGlobalNorm"
                   f"(1.0), LinearWarmup(CosineAnnealingDecay(3e-4, 8), 2)",
          "batch": lw.BATCH, "seq": lw.SEQ, "ignored_labels": lw.IGNORED,
          "launches_per_step": LAZY_STEP,
          "losses": {"eager": eager["losses"], "lazy": lz["losses"]},
          "lrs": eager["lrs"],
          "pre_clip_norms": {"eager": eager["norms"], "lazy": lz["norms"]},
          "warmup_post_clip_norms": {"eager": eager["post_norms"],
                                     "lazy": lz["post_norms"]},
          "lazy_norm_rel": err, "tol_norm_rel": LOOP_LAZY_TOL,
          "lazy_bit_equal_to_eager": {
              "losses": lz["losses"] == eager["losses"],
              "norms": lz["norms"] == eager["norms"]},
          "step_ms": {m: med(r, "wall_ms") for m, r in runs.items()},
          "host_ms": {m: med(r, "host_ms") for m, r in runs.items()},
          "clip_ms": {m: med(r, "clip_ms") for m, r in runs.items()},
          "optimizer_ms": {m: med(r, "opt_ms") for m, r in runs.items()},
          "clip_share": {m: med(r, "clip_ms") / med(r, "wall_ms")
                         for m, r in runs.items()},
          "optimizer_share": {m: med(r, "opt_ms") / med(r, "wall_ms")
                              for m, r in runs.items()},
          "step_ms_all": {m: r["wall_ms"] for m, r in runs.items()},
          "host_ms_all": {m: r["host_ms"] for m, r in runs.items()},
          "lazy_counters": {"warmup": lz["warmup_counters"],
                            "timed": timed, "replays_per_step": replays},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "device": kind, "nvidia_smi": smi})
    del runs, eager, lz
    release()
    return totals


# ---- the nn layer surface and the BERT encoder ----

# card against CPU, norm-relative, for every float result of
# `encoder_workload.reference_run` (f32; dropout masks bit-equal)
NN_REF_TOL = 1e-4
# the key projections' biases get no gradient in exact arithmetic
# (softmax ignores a per-query shift): their gradients and AdamW's
# updates of them (rounding noise scaled to the learning rate) are held
# absolutely, at 2 % of one step's learning rate
NN_REF_ZERO_GRAD_ATOL = 1e-6
# each timed BERT-base step: one forward, dQ and dK/dV launch a layer
ENC_STEP = {"flash_attention_fwd": 12, "flash_attention_dq": 12,
            "flash_attention_dkv": 12}


def _rel_tree(label, got, want, tol):
    """Every float array of `want` (nested dicts / lists) within `tol`
    norm-relative of `got`'s; everything else equal. Returns the largest
    error."""
    if isinstance(want, dict):
        if set(got) != set(want):
            raise AssertionError(f"{label}: keys "
                                 f"{sorted(set(got) ^ set(want))}")
        return max([_rel_tree(f"{label}.{k}", got[k], want[k], tol)
                    for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        return max([_rel_tree(f"{label}[{i}]", g, w, tol)
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    got, want = np.asarray(got), np.asarray(want)
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype}{got.shape} on the card, "
                             f"{want.dtype}{want.shape} on the CPU")
    if want.dtype.kind != "f":
        np.testing.assert_array_equal(got, want, err_msg=label)
        return 0.0
    if label.endswith("k_proj.bias"):
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=NN_REF_ZERO_GRAD_ATOL, err_msg=label)
        return 0.0
    err = _norm_rel(torch.from_numpy(got.astype(np.float64)),
                    torch.from_numpy(want.astype(np.float64)))
    if not err <= tol:
        raise AssertionError(f"{label}: card off the CPU by {err} "
                             f"norm-relative > {tol}")
    return err


def phase_nn_reference():
    """`encoder_workload.reference_run` on the card and on the CPU (f32):
    a conv net with BatchNorm2D and pools two AdamW steps (losses,
    parameters, running statistics, the eval forward), bidirectional
    two-layer LSTM and GRU stacks with inter-layer dropout (outputs,
    states, gradients), the encoder-decoder Transformer in training with a
    square subsequent mask (output, gradients), and `bert_tiny`'s two
    AdamW steps; card within NN_REF_TOL norm-relative of the CPU, and
    dropout masks (dropout, alpha, feature alpha, dropout2d) bit-equal.
    Returns the kernel launches of its card run."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import encoder_workload as ew

    assert not torch.backends.cudnn.allow_tf32
    runs, secs = {}, {}
    _launch_delta()
    for dev in ("gpu", "cpu"):
        t0 = time.perf_counter()
        with place.device_scope(dev):
            runs[dev] = ew.reference_run(paddle)
        if dev == "gpu":
            torch.cuda.synchronize()
            launches = _launch_delta()
        secs[dev] = time.perf_counter() - t0
    gpu, cpu = runs["gpu"], runs["cpu"]
    for name, want in cpu["masks"].items():
        if not np.array_equal(gpu["masks"][name], want):
            raise AssertionError(f"nn_reference: {name} mask differs on "
                                 f"the card")
    worst = {part: _rel_tree(f"nn_reference {part}", gpu[part], cpu[part],
                             NN_REF_TOL)
             for part in ("conv", "rnn", "transformer", "bert")}
    if not all(launches.get(n) for n in ENC_STEP):
        raise AssertionError(f"nn_reference: the unmasked attention of the "
                             f"Transformer and bert_tiny launched {launches}")
    emit({"phase": "nn_reference", "tol_norm_rel": NN_REF_TOL,
          "max_norm_rel_err": worst, "masks_bit_equal": True,
          "losses": {"conv": {d: [float(v) for v in r["conv"]["losses"]]
                              for d, r in runs.items()},
                     "bert": {d: r["bert"]["losses"]
                              for d, r in runs.items()}},
          "run_s": secs, "launches": launches})
    release()
    return launches


def _encoder_run(paddle, ew, lazy_on):
    work = ew.encoder_workload(paddle)
    r = ew.run_encoder(paddle, work, lazy_on, torch.cuda.synchronize,
                       _launch_delta,
                       lambda: torch.cuda.Event(enable_timing=True))
    del work
    return r


def phase_encoder_train(kind, smi):
    """BERT-base pre-training steps through `nn.TransformerEncoder`
    (`encoder_workload.encoder_workload`: 12 layers, 768 / 12 x 64 / 3072,
    vocab 30522, dropout 0.1, the tied MLM head over 15 % labelled
    positions, bf16 by `amp.decorate(level="O2")`, AdamW(1e-4, eps 1e-6,
    decay 0.01 off biases and norms, multi_precision) with
    ClipGradByGlobalNorm(1.0) over a linear warm-up), one batch of B 32 x
    S 512 with no padding and no mask: 2 warm-up and 4 timed steps
    eagerly, the model freed, then the same from the same seed under lazy
    mode. Gates: finite losses, the last timed loss below the first; each
    step's learning rate the schedule's within LOOP_LR_TOL; ENC_STEP
    launches (12 / 12 / 12 of rows 5 / 6 / 7, no RMSNorm) every timed
    step, eager and lazy; lazy losses and pre-clip norms bit-equal to
    eager (dropout on: each replay draws its own keys); no capture and no
    uncaptured replay in the timed steps, the same replays in each.
    Returns the launches of both runs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import encoder_workload as ew

    torch.cuda.reset_peak_memory_stats()
    _launch_delta()
    runs, totals = {}, {}
    with place.device_scope("gpu"):
        for mode in ("eager", "lazy"):
            runs[mode] = _encoder_run(paddle, ew, mode == "lazy")
            for d in [runs[mode]["warmup_launches"],
                      *runs[mode]["launches"]]:
                for n, c in d.items():
                    totals[n] = totals.get(n, 0) + c
            if mode == "lazy":
                lazy.clear_graphs()
            release()
    n_warm = ew.WARMUP_STEPS
    for mode, r in runs.items():
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[n_warm]:
            raise AssertionError(f"encoder_train {mode}: losses {losses}")
        lr_err = max(abs(a - ew.lr_at(i)) for i, a in enumerate(r["lrs"]))
        if not lr_err <= LOOP_LR_TOL:
            raise AssertionError(f"encoder_train {mode}: lr {r['lrs']}")
        for i, got in enumerate(r["launches"]):
            if got != ENC_STEP:
                raise AssertionError(f"encoder_train {mode} timed step {i}: "
                                     f"launches {got} != {ENC_STEP}")
    # one dropout of the hidden shape (its threefry mask and the select),
    # times the dropouts a step: the embeddings', and per layer the
    # attention output's and both residual branches'
    cfg = ew.CONFIGS["bert_base"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    with place.device_scope("gpu"):
        h = paddle.Tensor(torch.randn(ew.BATCH, ew.SEQ, cfg["hidden"],
                                      device="cuda").to(torch.bfloat16))
        drop_ms = time_ms(lambda: paddle.nn.functional.dropout(
            h, cfg["dropout"]), flush, reps=10)
    del h, flush
    n_drop = 1 + 3 * cfg["layers"]
    eager, lz = runs["eager"], runs["lazy"]
    bit_equal = {"losses": lz["losses"] == eager["losses"],
                 "norms": lz["norms"] == eager["norms"]}
    if not all(bit_equal.values()):
        raise AssertionError(f"encoder_train: lazy not bit-equal to eager: "
                             f"losses {lz['losses']} / {eager['losses']}, "
                             f"norms {lz['norms']} / {eager['norms']}")
    timed = lz["timed_counters"]
    replays = [c.get("lazy.graph_replays", 0) for c in lz["step_counters"]]
    if timed.get("lazy.graph_captures", 0) or \
            timed.get("lazy.uncaptured_replays", 0) or \
            len(set(replays)) != 1 or not replays[0]:
        raise AssertionError(f"encoder_train: timed steps moved {timed}, "
                             f"replays {replays}")

    def med(r, key):
        return statistics.median(r[key])

    tokens = ew.BATCH * ew.SEQ
    emit({"phase": "encoder_train",
          "model": "BERT-base (google-bert/bert-base-uncased widths) built "
                   "from nn.TransformerEncoderLayer x 12, MLM head tied to "
                   "the word embedding, no NSP head; amp O2 bf16, AdamW("
                   "1e-4, eps 1e-6, wd 0.01 off biases and norms, "
                   "multi_precision), ClipGradByGlobalNorm(1.0), "
                   "LinearWarmup(PolynomialDecay)",
          "batch": ew.BATCH, "seq": ew.SEQ, "mlm_rate": ew.MLM_RATE,
          "launches_per_step": ENC_STEP,
          "losses": {"eager": eager["losses"], "lazy": lz["losses"]},
          "lrs": eager["lrs"],
          "pre_clip_norms": {"eager": eager["norms"], "lazy": lz["norms"]},
          "lazy_bit_equal_to_eager": bit_equal,
          "step_ms": {m: med(r, "wall_ms") for m, r in runs.items()},
          "host_ms": {m: med(r, "host_ms") for m, r in runs.items()},
          "tokens_per_s": {m: tokens / (med(r, "wall_ms") / 1e3)
                           for m, r in runs.items()},
          "clip_ms": {m: med(r, "clip_ms") for m, r in runs.items()},
          "optimizer_ms": {m: med(r, "opt_ms") for m, r in runs.items()},
          "dropout_ms": drop_ms, "dropouts_per_step": n_drop,
          "dropout_share": {m: n_drop * drop_ms / med(r, "wall_ms")
                            for m, r in runs.items()},
          "step_ms_all": {m: r["wall_ms"] for m, r in runs.items()},
          "host_ms_all": {m: r["host_ms"] for m, r in runs.items()},
          "lazy_counters": {"warmup": lz["warmup_counters"],
                            "timed": timed, "replays_per_step": replays},
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "device": kind, "nvidia_smi": smi})
    del runs, eager, lz
    release()
    return totals


# ---- FNet through paddle.fft (tools/fnet_workload.py) ----

# card against CPU, norm-relative, for `fnet_workload.reference_run`
FNET_REF_TOL = 1e-4
# the kernels FNet must not reach: rows 5-7 (flash) and 13 (RMSNorm)
FNET_NO_LAUNCH = ("flash_attention_fwd", "flash_attention_dq",
                  "flash_attention_dkv", "rms_norm")
# timed calls of one Fourier sublayer's forward and backward (a call is
# ~1 ms; the median of ten read 0.68 in one run and 1.17 in another)
FOURIER_REPS = 100


def phase_fnet_reference():
    """`fnet_workload.reference_run` on the card and on the CPU (f32):
    dropout masks at FNet's rate bit-equal, and `fnet_tiny`'s two AdamW
    steps (dropout on) within FNET_REF_TOL norm-relative for the losses
    and every parameter after. Returns the kernel launches of its card
    run (none of FNET_NO_LAUNCH)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import fnet_workload as fw

    t0 = time.perf_counter()
    runs = {}
    _launch_delta()
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            runs[dev] = fw.reference_run(paddle)
        if dev == "gpu":
            torch.cuda.synchronize()
            launches = _launch_delta()
    gpu, cpu = runs["gpu"], runs["cpu"]
    for name, want in cpu["masks"].items():
        if not np.array_equal(gpu["masks"][name], want):
            raise AssertionError(f"fnet_reference: {name} mask differs")
    worst = _rel_tree("fnet_reference", gpu["fnet"], cpu["fnet"],
                      FNET_REF_TOL)
    if any(launches.get(n) for n in FNET_NO_LAUNCH):
        raise AssertionError(f"fnet_reference: launches {launches}")
    secs = time.perf_counter() - t0
    emit({"phase": "fnet_reference", "tol_norm_rel": FNET_REF_TOL,
          "max_norm_rel_err": worst, "masks_bit_equal": True,
          "losses": {d: r["fnet"]["losses"] for d, r in runs.items()},
          "launches": launches, "phase_s": secs})
    release()
    return launches


def _fnet_run(paddle, fw, lazy_on):
    work = fw.fnet_workload(paddle)
    r = fw.run_fnet(paddle, work, lazy_on, torch.cuda.synchronize,
                    _launch_delta,
                    lambda: torch.cuda.Event(enable_timing=True))
    del work
    return r


def _fourier_ms(paddle, fw, cfg, flush):
    """Device ms of one Fourier sublayer's forward and backward at the
    step's shape: `fftn(h, axes=(1, 2)).real()` of the O2 bf16 hidden
    state (widened to f32 inside), and its gradient; the median of
    FOURIER_REPS calls and their spread."""
    h = paddle.Tensor(torch.randn(fw.BATCH, fw.SEQ, cfg["hidden"],
                                  device="cuda").to(torch.bfloat16),
                      stop_gradient=False)
    g = torch.randn(fw.BATCH, fw.SEQ, cfg["hidden"], device="cuda")

    def fwd_bwd():
        out = fw.fourier(paddle, h)
        out._data.backward(g)
        h._data.grad = None

    times = sorted(times_ms(fwd_bwd, flush, FOURIER_REPS))
    return statistics.median(times), {
        "reps": len(times), "min": times[0], "max": times[-1],
        "p10": times[len(times) // 10],
        "p90": times[len(times) * 9 // 10]}


def phase_fnet_train(kind, smi):
    """FNet-base pre-training steps through `paddle.fft`
    (`fnet_workload.fnet_workload`: google/fnet-base widths, 12 layers of
    `fftn(h, axes=(1, 2)).real()` + LayerNorm + a 768 / 3072 / 768 tanh-
    gelu MLP, dropout 0.1, the tied MLM head over 15 % labelled positions,
    bf16 by `amp.decorate(level="O2")`, AdamW(1e-4, eps 1e-6, decay 0.01
    off biases and norms, multi_precision), ClipGradByGlobalNorm(1.0),
    linear warm-up and decay), one batch of B 32 x S 512: 2 warm-up and 4
    timed steps eagerly, the model freed, then the same from the same seed
    under lazy mode. Gates: finite losses, the last timed loss below the
    first; each step's learning rate the schedule's within LOOP_LR_TOL;
    no launch of FNET_NO_LAUNCH (the flash and RMSNorm kernels) in any
    step, eager or lazy; lazy losses and pre-clip norms bit-equal to
    eager; no capture and no uncaptured replay in the timed steps, one
    replay a step. Reports the step, host and Fourier sublayers' times,
    tokens/s, the dropouts' share and the peak memory. Returns the
    launches of both runs."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core import lazy
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import fnet_workload as fw

    t0 = time.perf_counter()
    torch.cuda.reset_peak_memory_stats()
    _launch_delta()
    runs, totals = {}, {}
    with place.device_scope("gpu"):
        for mode in ("eager", "lazy"):
            runs[mode] = _fnet_run(paddle, fw, mode == "lazy")
            for d in [runs[mode]["warmup_launches"],
                      *runs[mode]["launches"]]:
                for n, c in d.items():
                    totals[n] = totals.get(n, 0) + c
            if mode == "lazy":
                lazy.clear_graphs()
            release()
    peak_gb = torch.cuda.max_memory_allocated() / 2 ** 30
    n_warm = fw.WARMUP_STEPS
    for mode, r in runs.items():
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) \
                or not losses[-1] < losses[n_warm]:
            raise AssertionError(f"fnet_train {mode}: losses {losses}")
        lr_err = max(abs(a - fw.lr_at(i)) for i, a in enumerate(r["lrs"]))
        if not lr_err <= LOOP_LR_TOL:
            raise AssertionError(f"fnet_train {mode}: lr {r['lrs']}")
    if any(totals.get(n) for n in FNET_NO_LAUNCH):
        raise AssertionError(f"fnet_train: launches {totals}")
    eager, lz = runs["eager"], runs["lazy"]
    bit_equal = {"losses": lz["losses"] == eager["losses"],
                 "norms": lz["norms"] == eager["norms"]}
    if not all(bit_equal.values()):
        raise AssertionError(f"fnet_train: lazy not bit-equal to eager: "
                             f"losses {lz['losses']} / {eager['losses']}, "
                             f"norms {lz['norms']} / {eager['norms']}")
    timed = lz["timed_counters"]
    replays = [c.get("lazy.graph_replays", 0) for c in lz["step_counters"]]
    if timed.get("lazy.graph_captures", 0) or \
            timed.get("lazy.uncaptured_replays", 0) or \
            replays != [1] * fw.TIMED_STEPS:
        raise AssertionError(f"fnet_train: timed steps moved {timed}, "
                             f"replays {replays}")
    cfg = fw.CONFIGS["fnet_base"]
    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    with place.device_scope("gpu"):
        fourier_ms, fourier_spread = _fourier_ms(paddle, fw, cfg, flush)
        h = paddle.Tensor(torch.randn(fw.BATCH, fw.SEQ, cfg["hidden"],
                                      device="cuda").to(torch.bfloat16))
        drop_ms = time_ms(lambda: paddle.nn.functional.dropout(
            h, cfg["dropout"]), flush, reps=10)
    del h, flush
    release()
    # the embeddings' dropout and one a layer
    n_drop = 1 + cfg["layers"]

    def med(r, key):
        return statistics.median(r[key])

    tokens = fw.BATCH * fw.SEQ
    emit({"phase": "fnet_train",
          "model": "FNet-base (google/fnet-base widths) as PaddleNLP's "
                   "FNetForPreTraining builds it, 12 layers of "
                   "paddle.fft.fftn(h, axes=(1, 2)).real(), MLM head tied "
                   "to the word embedding, no NSP head; amp O2 bf16, AdamW("
                   "1e-4, eps 1e-6, wd 0.01 off biases and norms, "
                   "multi_precision), ClipGradByGlobalNorm(1.0), "
                   "LinearWarmup(PolynomialDecay)",
          "batch": fw.BATCH, "seq": fw.SEQ,
          "launches": totals, "no_launch_of": list(FNET_NO_LAUNCH),
          "losses": {"eager": eager["losses"], "lazy": lz["losses"]},
          "lrs": eager["lrs"],
          "pre_clip_norms": {"eager": eager["norms"], "lazy": lz["norms"]},
          "lazy_bit_equal_to_eager": bit_equal,
          "step_ms": {m: med(r, "wall_ms") for m, r in runs.items()},
          "host_ms": {m: med(r, "host_ms") for m, r in runs.items()},
          "tokens_per_s": {m: tokens / (med(r, "wall_ms") / 1e3)
                           for m, r in runs.items()},
          "fourier_fwd_bwd_ms": fourier_ms,
          "fourier_fwd_bwd_ms_spread": fourier_spread,
          "fourier_sublayers": cfg["layers"],
          "fourier_share": {m: cfg["layers"] * fourier_ms
                            / med(r, "wall_ms") for m, r in runs.items()},
          "dropout_ms": drop_ms, "dropouts_per_step": n_drop,
          "dropout_share": {m: n_drop * drop_ms / med(r, "wall_ms")
                            for m, r in runs.items()},
          "clip_ms": {m: med(r, "clip_ms") for m, r in runs.items()},
          "optimizer_ms": {m: med(r, "opt_ms") for m, r in runs.items()},
          "step_ms_all": {m: r["wall_ms"] for m, r in runs.items()},
          "host_ms_all": {m: r["host_ms"] for m, r in runs.items()},
          "lazy_counters": {"warmup": lz["warmup_counters"],
                            "timed": timed, "replays_per_step": replays},
          "cufft_plan_cache_size":
              torch.backends.cuda.cufft_plan_cache.size,
          "peak_mem_gb": peak_gb, "phase_s": time.perf_counter() - t0,
          "device": kind, "nvidia_smi": smi})
    del runs, eager, lz
    release()
    return totals


# ---- the fused-op surface (incubate.nn.functional) ----

ROPE_SRC = "paddle_tpu_torch/csrc/rope.cu"
BIAS_ACT_SRC = "paddle_tpu_torch/csrc/bias_act.cu"
ROPE_PY = "paddle_tpu/ops/pallas/rope.py"
BA_PY = "paddle_tpu/ops/pallas/bias_act.py"
# f32 operations per output element (the bias add included), counted from
# the formulas in `ops/kernels/bias_act.py`; every case is bound by bytes
ACT_FLOPS = {"identity": 1, "relu": 2, "sigmoid": 5, "silu": 6, "swish": 6,
             "gelu_tanh": 10, "gelu": 25, "swiglu": 9, "geglu": 28}
# the one PyTorch call computing each activation WITHOUT the bias (none
# computes bias + activation, nor a GLU)
ACT_LIBRARY = {"identity": torch.clone, "relu": torch.nn.functional.relu,
               "sigmoid": torch.sigmoid, "silu": torch.nn.functional.silu,
               "swish": torch.nn.functional.silu,
               "gelu": torch.nn.functional.gelu,
               "gelu_tanh": lambda x: torch.nn.functional.gelu(
                   x, approximate="tanh")}


def _one_rounding(name, out, ref):
    """Both sides compute in f32 and round once: f32 within 1e-6 relative,
    16-bit within one ulp of each element's own magnitude. Returns the
    largest error and the share of elements that are bit-equal."""
    o, r = out.float(), ref.float()
    err = (o - r).abs()
    if out.dtype == torch.float32:
        ok = bool((err <= 1e-6 + 1e-6 * r.abs()).all())
    else:
        bits, tiny = (7, 2.0 ** -126) if out.dtype == torch.bfloat16 \
            else (10, 2.0 ** -14)
        ulp = torch.exp2(torch.floor(torch.log2(r.abs().clamp_min(tiny)))
                         - bits)
        ok = bool((err <= ulp).all())
    if not ok:
        raise AssertionError(f"{name}: kernel != plain version, max abs err "
                             f"{float(err.max())}")
    return float(err.max()), float((out == ref).float().mean())


def _fused_case(name, fn, ref_fn, outs_refs, nbytes, flops, flush,
                library=None):
    errs = [_one_rounding(name, o, r) for o, r in outs_refs]
    bound_ms, bound_by = bound(nbytes, flops, F32_FLOPS)
    return {"max_abs_err": max(e for e, _ in errs),
            "bit_equal_share": min(b for _, b in errs),
            "kernel_ms": time_ms(fn, flush),
            "plain_ms": time_ms(ref_fn, flush, reps=10),
            "library_ms": None if library is None else time_ms(library,
                                                               flush),
            "bytes": nbytes, "flops": flops, "bound_ms": bound_ms,
            "bound_by": bound_by}


def phase_incubate_kernels():
    """The RoPE, bias + activation and SwiGLU kernels against their plain
    versions at the training step's 8,192 tokens and Llama-2-7B width
    (`_one_rounding`'s tolerance): RoPE on q and k [4, 2048, 32, 128] with
    [2048, 64] tables (bf16 and f32 with f32 tables, f16 with f16 tables,
    and the conj rotation of the backward); gelu + bias [8192, 11008]
    (bf16 and f32), the packed swiglu [8192, 22016] -> [8192, 11008], and
    every act_method at [8192, 4096] bf16; `silu(x) * y` [8192, 11008]
    (bf16 and f32). `library_ms` is the bias-less activation's one
    PyTorch call where there is one; nothing computes RoPE or a GLU in
    one call."""
    from paddle_tpu_torch.ops.kernels import bias_act as bak
    from paddle_tpu_torch.ops.kernels import rope as rk

    gen = torch.Generator(device="cuda").manual_seed(40)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    results = {}

    def randn(shape, dtype, scale=1.0):
        return (scale * torch.randn(shape, generator=gen,
                                    device="cuda")).to(dtype)

    ang = torch.rand((2048, 64), generator=gen, device="cuda") * 6.0
    for name, dtype, tab_dtype, conj in (
            ("rope_bf16", torch.bfloat16, torch.float32, False),
            ("rope_bf16_conj", torch.bfloat16, torch.float32, True),
            ("rope_f32", torch.float32, torch.float32, False),
            ("rope_f16", torch.float16, torch.float16, False)):
        q = randn((4, 2048, 32, 128), dtype)
        k = randn((4, 2048, 32, 128), dtype)
        c, sn = ang.cos().to(tab_dtype), ang.sin().to(tab_dtype)
        outs = rk._rope(q, k, c, sn, conj)
        refs = rk.rope_ref(q, k, c, sn, conj)
        torch.cuda.synchronize()
        nbytes = 4 * q.numel() * q.element_size() + 2 * c.numel() * \
            c.element_size()
        results[name] = _fused_case(
            name, lambda: rk._rope(q, k, c, sn, conj),
            lambda: rk.rope_ref(q, k, c, sn, conj), list(zip(outs, refs)),
            nbytes, 3 * 2 * q.numel(), flush)
        results[name]["shape"] = [4, 2048, 32, 128]
        del q, k, outs, refs
        release()

    ba_cases = [("bias_act_gelu_bf16", "gelu", (8192, 11008),
                 torch.bfloat16, True),
                ("bias_act_gelu_f32", "gelu", (8192, 11008), torch.float32,
                 True),
                ("bias_act_swiglu_packed_bf16", "swiglu", (8192, 22016),
                 torch.bfloat16, False)]
    ba_cases += [(f"bias_act_{act}_4096", act, (8192, 4096), torch.bfloat16,
                  True) for act in sorted(bak.ACT_CODES)]
    for name, act, shape, dtype, with_bias in ba_cases:
        x = randn(shape, dtype, 3.0)
        b = randn(shape[-1:], dtype) if with_bias else None
        bz = b if with_bias else torch.zeros(shape[-1:], dtype=dtype,
                                             device="cuda")
        out = bak.fused_bias_act(x, b, act)
        ref = bak.bias_act_ref(x, bz, act)
        torch.cuda.synchronize()
        item = x.element_size()
        nbytes = (x.numel() + out.numel()) * item + bz.numel() * item
        lib = ACT_LIBRARY.get(act)
        results[name] = _fused_case(
            name, lambda: bak.fused_bias_act(x, b, act),
            lambda: bak.bias_act_ref(x, bz, act), [(out, ref)], nbytes,
            ACT_FLOPS[act] * out.numel(), flush,
            library=None if lib is None else (lambda: lib(x)))
        results[name].update(act_method=act, shape=list(shape),
                             bias=with_bias)
        del x, b, bz, out, ref
        release()

    for name, dtype in (("swiglu_bf16", torch.bfloat16),
                        ("swiglu_f32", torch.float32)):
        x = randn((8192, 11008), dtype, 3.0)
        y = randn((8192, 11008), dtype)
        out = bak.swiglu(x, y)
        ref = bak.swiglu_ref(x, y)
        torch.cuda.synchronize()
        nbytes = 3 * x.numel() * x.element_size()
        results[name] = _fused_case(
            name, lambda: bak.swiglu(x, y), lambda: bak.swiglu_ref(x, y),
            [(out, ref)], nbytes, 7 * x.numel(), flush)
        results[name]["shape"] = [8192, 11008]
        del x, y, out, ref
        release()
    del flush
    release()
    emit({"phase": "incubate_kernels",
          "kernels": ["fused_rope", "bias_act", "swiglu"],
          "library": "the bias-less activation's one call (F.gelu, "
                     "F.relu, ...); none for RoPE or a GLU",
          "cases": results})
    return results


INCUBATE_KERNELS = ("fused_rope", "bias_act", "swiglu")
LAYER_LAUNCHES = {"rms_norm": 2, "fused_rope": 2, "flash_attention_fwd": 1,
                  "flash_attention_dq": 1, "flash_attention_dkv": 1}


def phase_incubate_layer(kind, smi):
    """`layer_workload`'s decoder layer at Llama-2-7B width (hidden 4096,
    32 heads of 128, intermediate 11008), bf16, B 4 x S 2048, built from
    the port's `incubate` functions in both MLP forms, forward and
    backward, against the port's `LlamaDecoderLayer` on the same weights:
    the output and the input gradient within 2^-6 norm-relative. Each
    run's first forward + backward runs with the launch counts zeroed
    just before and read just after: exactly 2 RMSNorm, 2 RoPE (forward,
    backward), one flash forward, dQ and dK/dV, and one `swiglu` ("two")
    or `bias_act` ("packed"), nothing else. Then the three runs are timed
    in turns. An f32 copy of the model's layer on the same weights says
    how far each bf16 run is from the exact math (reported, not
    gated)."""
    from paddle_tpu_torch.models.llama import LlamaDecoderLayer
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.layer_workload import RUNS, LayerWorkload

    torch.cuda.reset_peak_memory_stats()
    work = LayerWorkload()
    counters = (*SERVE_KERNELS, *TRAIN_KERNELS, *INCUBATE_KERNELS)
    results, launches, outs = {}, {}, {}
    for run in RUNS:
        _support.reset_launch_counts()
        outs[run] = work.step(run)
        torch.cuda.synchronize()
        launched = {c: _support.launch_counter(c).count for c in counters}
        launches[run] = {c: n for c, n in launched.items() if n}
        if run != "llama_layer":
            expect = dict(LAYER_LAUNCHES)
            expect["swiglu" if run == "two" else "bias_act"] = 1
            if launches[run] != expect:
                raise AssertionError(f"incubate layer ({run}): launches "
                                     f"{launches[run]} != {expect}")
    for run in ("two", "packed"):
        for i, what in enumerate(("out", "input_grad")):
            got, want = outs[run][i], outs["llama_layer"][i]
            if not bool(torch.isfinite(got).all()):
                raise AssertionError(f"incubate layer ({run}): non-finite "
                                     f"{what}")
            rel = _norm_rel(got, want)
            results[f"{run}_{what}_norm_rel_err"] = rel
            if not rel <= 2.0 ** -6:
                raise AssertionError(f"incubate layer ({run}): {what} "
                                     f"{rel} from LlamaDecoderLayer's > "
                                     f"2^-6")
    # the f32 layer: how far each bf16 run is from the exact math
    f32_layer = LlamaDecoderLayer(work.config, device=torch.device("cuda"),
                                  dtype=torch.float32)
    f32_layer.load_state_dict({k: v.float() for k, v in
                               work.llama_layer.state_dict().items()})
    xf = work.x0.float().requires_grad_()
    yf = f32_layer(xf)
    yf.backward(work.dy.float())
    results["vs_f32_norm_rel_err"] = {
        run: {"out": _norm_rel(outs[run][0], yf.detach()),
              "input_grad": _norm_rel(outs[run][1], xf.grad)}
        for run in RUNS}
    del outs, f32_layer, xf, yf
    release()
    # timing: the runs in turns, CUDA events around one forward + backward
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
    results["fwd_bwd_ms_median"] = {r: statistics.median(t)
                                    for r, t in times.items()}
    results["fwd_bwd_ms"] = times
    emit({"phase": "incubate_layer",
          "layer": "Llama-2-7B width (hidden 4096, 32 x 128 heads, "
                   "intermediate 11008), bf16, B 4 x S 2048, fwd + bwd "
                   "with weight gradients",
          "tol_norm_rel": 2.0 ** -6, "launches": launches, **results,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "device": kind, "nvidia_smi": smi})
    del work
    release()
    return {c: launches["two"].get(c, 0) + launches["packed"].get(c, 0)
            for c in INCUBATE_KERNELS}


def _rope_pairs(t, cos, sin):
    """The adjacent-pair rotation `block_multihead_attention` applies with
    `use_neox_style=False`, written out here: t [T, heads, D], cos/sin
    [T, D/2] cast to t's dtype."""
    c = cos[:, None, :].to(t.dtype)
    s = sin[:, None, :].to(t.dtype)
    te, to = t[..., 0::2], t[..., 1::2]
    return torch.stack([te * c - to * s, to * c + te * s],
                       dim=-1).reshape(t.shape)


def phase_incubate_serve(kind, smi):
    """`block_multihead_attention` at H 32, D 128 with a bf16 pool in
    blocks of 64: one prefill call holding the serve workload's 8 prompt
    lengths (`default_rng(0)`, 64-512), then 32 decode calls with
    rope_emb (the model's f32 tables), random bf16 qkv from a seed. The
    launch counts are zeroed before the prefill (it launches no kernel:
    its attention is the plain composite) and before the decode loop
    (exactly one decode-kernel launch per call, nothing else: the split
    instance in window mode at these 64-slot pages). Every output row is
    held to a dense causal attention over the same rotated tokens, per row
    within 2^-6 of its largest |out|. Then the decode kernel is timed on
    its own at the last call's lengths, beside the wall time per call.
    Returns the decode launches."""
    import paddle_tpu_torch.incubate.nn.functional as IF
    from paddle_tpu_torch.models.llama import LlamaConfig, _rope_cache
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.ops.kernels import paged_attention as pa

    h, d, bs, steps = 32, 128, 64, 32
    lens = [int(n) for n in np.random.default_rng(0).integers(64, 513, 8)]
    b = len(lens)
    nblk = [-(-(n + steps) // bs) for n in lens]
    w = max(nblk)
    tables = torch.zeros((b, w), dtype=torch.int32)
    used = 1
    for i, n in enumerate(nblk):
        tables[i, :n] = torch.arange(used, used + n)
        used += n
    dev = torch.device("cuda")
    tables = tables.to(dev)
    kc = torch.zeros((used, h, bs, d), dtype=torch.bfloat16, device=dev)
    vc = torch.zeros_like(kc)
    cos, sin = (torch.from_numpy(t) for t in _rope_cache(LlamaConfig(
        hidden_size=h * d, num_attention_heads=h,
        max_position_embeddings=1024)))
    max_seq = max(lens) + steps
    rope = torch.stack([cos[:max_seq], sin[:max_seq]])[:, None, :, None] \
        .expand(2, b, max_seq, 1, d // 2).contiguous().to(dev)
    gen = torch.Generator(device="cuda").manual_seed(42)
    hd = h * d
    counters = (*SERVE_KERNELS, *TRAIN_KERNELS, *INCUBATE_KERNELS)

    # per sequence: the rotated K and V of every token, and each call's
    # output rows and their positions, for the dense reference
    keys = [[] for _ in range(b)]
    vals = [[] for _ in range(b)]
    rows = [[] for _ in range(b)]

    def record(qkv, out, dec, this):
        off = 0
        for i in range(b):
            n = this[i]
            pos = torch.arange(dec[i], dec[i] + n, device=dev)
            t = qkv[off:off + n].reshape(n, 3, h, d)
            c, s_ = rope[0, i, pos, 0], rope[1, i, pos, 0]
            keys[i].append(_rope_pairs(t[:, 1], c, s_))
            vals[i].append(t[:, 2])
            rows[i].append((_rope_pairs(t[:, 0], c, s_), out[off:off + n],
                            pos))
            off += n

    zeros = [0] * b
    qkv = torch.randn((sum(lens), 3 * hd), generator=gen, device=dev) \
        .to(torch.bfloat16)
    _support.reset_launch_counts()
    out = IF.block_multihead_attention(
        qkv, kc, vc, torch.tensor(lens), torch.tensor(zeros),
        torch.tensor(lens), block_tables=tables, rope_emb=rope,
        block_size=bs)[0]
    torch.cuda.synchronize()
    prefill_launches = {c: _support.launch_counter(c).count
                        for c in counters}
    if any(prefill_launches.values()):
        raise AssertionError(f"incubate serve: the prefill launched "
                             f"{prefill_launches}")
    record(qkv, out, zeros, lens)
    qkvs = [torch.randn((b, 3 * hd), generator=gen, device=dev)
            .to(torch.bfloat16) for _ in range(steps)]
    ones = torch.ones(b, dtype=torch.int64)
    enc0 = torch.zeros(b, dtype=torch.int64)
    outs = []
    torch.cuda.synchronize()
    _support.reset_launch_counts()
    t0 = time.perf_counter()
    for i in range(steps):
        outs.append(IF.block_multihead_attention(
            qkvs[i], kc, vc, enc0, torch.tensor([n + i for n in lens]),
            ones, block_tables=tables, rope_emb=rope, block_size=bs)[0])
    torch.cuda.synchronize()
    wall = time.perf_counter() - t0
    launched = {c: _support.launch_counter(c).count for c in counters}
    expect = {c: steps if c == "paged_attention" else 0 for c in counters}
    if launched != expect:
        raise AssertionError(f"incubate serve: decode launches {launched} "
                             f"!= {expect}")
    for i in range(steps):
        record(qkvs[i], outs[i], [n + i for n in lens], [1] * b)

    worst, worst_rel = 0.0, 0.0
    for i in range(b):
        k_all = torch.cat(keys[i]).float()                # [N, H, D]
        v_all = torch.cat(vals[i]).float()
        for q, o, pos in rows[i]:
            sc = torch.einsum("thd,nhd->htn", q.float(), k_all) / \
                math.sqrt(d)
            keep = torch.arange(k_all.shape[0], device=dev)[None, :] <= \
                pos[:, None]
            sc = sc.masked_fill(~keep[None], -1e30)
            ref = torch.einsum("htn,nhd->thd", torch.softmax(sc, -1), v_all)
            err, rel = _row_check(f"incubate serve seq {i}",
                                  o.reshape(-1, h, d), ref.to(o.dtype),
                                  torch.zeros(ref.shape[:2], dtype=torch.bool,
                                              device=dev))
            worst, worst_rel = max(worst, err), max(worst_rel, rel)
    # the decode kernel alone on this pool, at the last call's lengths
    q = torch.randn((b, h, d), generator=gen, device=dev).to(torch.bfloat16)
    ctx = torch.tensor([n + steps for n in lens], dtype=torch.int32,
                       device=dev)
    if not pa._window_split(q, kc, tables):
        raise AssertionError("incubate serve: decode does not take the "
                             "split instance")
    flush = torch.empty(512 << 20, dtype=torch.uint8, device=dev)
    kernel_ms = time_ms(lambda: pa.paged_attention(q, kc, vc, tables, ctx),
                        flush)
    del flush
    emit({"phase": "incubate_serve",
          "geometry": {"heads": h, "head_dim": d, "block_size": bs,
                       "prompt_lens": lens, "decode_calls": steps,
                       "dtype": "bfloat16"},
          "decode_ms_per_call": wall / steps * 1e3,
          "decode_kernel_ms": kernel_ms, "decode_instance": "split",
          "decode_launches": launched["paged_attention"],
          "row_rel_tol": ROW_REL[torch.bfloat16], "max_abs_err": worst,
          "row_rel_err": worst_rel, "device": kind, "nvidia_smi": smi})
    del kc, vc, keys, vals, rows, outs, qkvs
    release()
    return launched["paged_attention"]


MOE_SRC = "paddle_tpu_torch/csrc/fused_moe.cu"
MOE_PY = "paddle_tpu/ops/pallas/fused_moe.py"
MOE_KERNELS = ("moe_dispatch", "moe_gather")
# name -> (rows N = k * T, width H, dtype, capacity C); C = 4096 is the
# EP capacity of the moe_layer workload (cf 2.0, 8,192 tokens, top-2, 8
# experts), 1024 that of cf 0.5, which drops about half the rows
MOE_CASES = {"bf16": (16384, 4096, torch.bfloat16, 4096),
             "f32": (16384, 4096, torch.float32, 4096),
             "bf16_h4100": (16384, 4100, torch.bfloat16, 4096),
             "bf16_cf0.5": (16384, 4096, torch.bfloat16, 1024)}
MOE_EXPERTS = 8


def _moe_routing(n_rows, n_experts, capacity, gen):
    """Rows to experts uniformly at random, each expert's slots handed
    out in row order (the EP route's cumsum), rows past its capacity
    dropped (-1)."""
    e = torch.randint(0, n_experts, (n_rows,), generator=gen, device="cuda")
    sel = torch.nn.functional.one_hot(e, n_experts).to(torch.int32)
    pos = (torch.cumsum(sel, 0, dtype=torch.int32) - 1).gather(
        1, e[:, None])[:, 0]
    slot = torch.where(pos < capacity, pos, -1)
    return e.to(torch.int32), slot.to(torch.int32)


def _bit_equal(name, got, want):
    if not torch.equal(got, want):
        err = float((got.float() - want.float()).abs().max())
        raise AssertionError(f"{name}: not bit-equal, max abs err {err}")


def phase_moe_kernels():
    """Both MoE kernels against their plain versions (`moe_dispatch_ref`,
    `moe_gather_ref`) and the index-op route (`xla_dispatch`,
    `xla_gather`), forward and backward (each kernel is the other's
    backward), all bit-equal (`torch.equal`), at the moe_layer workload's
    shapes (N = 16,384 rows, H 4096, E 8, C 4096, bf16), in f32, at
    H 4100 (8-byte units) and at capacity factor 0.5 (rows dropped).
    `library_ms`: for dispatch, `index_put_` of the kept rows into a
    zeroed [E, C, H]; for gather, `buf.view(E*C, H)[flat]`. The bound
    counts the kept rows read once, both index vectors, and the output
    written once."""
    from paddle_tpu_torch.ops.kernels import fused_moe as fm

    gen = torch.Generator(device="cuda").manual_seed(60)
    flush = torch.empty(512 << 20, dtype=torch.uint8, device="cuda")
    e_n = MOE_EXPERTS
    results = {}
    for name, (n, h, dtype, c) in MOE_CASES.items():
        e_idx, p_idx = _moe_routing(n, e_n, c, gen)
        keep = p_idx >= 0
        kept = int(keep.sum())
        x = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
        buf = torch.randn((e_n, c, h), generator=gen, device="cuda").to(dtype)
        gd = torch.randn((e_n, c, h), generator=gen, device="cuda").to(dtype)
        gr = torch.randn((n, h), generator=gen, device="cuda").to(dtype)
        xr = x.clone().requires_grad_()
        br = buf.clone().requires_grad_()
        d = fm.moe_dispatch(xr, e_idx, p_idx, e_n, c)
        r = fm.moe_gather(br, e_idx, p_idx)
        d.backward(gd)
        r.backward(gr)
        torch.cuda.synchronize()
        _bit_equal(f"moe_dispatch {name}", d,
                   fm.moe_dispatch_ref(x, e_idx, p_idx, e_n, c))
        _bit_equal(f"moe_dispatch {name} (index route)", d,
                   fm.xla_dispatch(x, e_idx, p_idx, e_n, c))
        _bit_equal(f"moe_gather {name}", r,
                   fm.moe_gather_ref(buf, e_idx, p_idx))
        _bit_equal(f"moe_gather {name} (index route)", r,
                   fm.xla_gather(buf, e_idx, p_idx))
        _bit_equal(f"moe_dispatch backward {name}", xr.grad,
                   fm.moe_gather_ref(gd, e_idx, p_idx))
        _bit_equal(f"moe_gather backward {name}", br.grad,
                   fm.moe_dispatch_ref(gr, e_idx, p_idx, e_n, c))
        xi = x.clone().requires_grad_()
        fm.xla_dispatch(xi, e_idx, p_idx, e_n, c).backward(gd)
        bi = buf.clone().requires_grad_()
        fm.xla_gather(bi, e_idx, p_idx).backward(gr)
        _bit_equal(f"moe_dispatch backward {name} (index route)", xr.grad,
                   xi.grad)
        _bit_equal(f"moe_gather backward {name} (index route)", br.grad,
                   bi.grad)
        del xr, br, d, r, xi, bi, gd, gr
        release()
        item = x.element_size()
        idx_bytes = 2 * 4 * n
        ek, pk, xk = e_idx[keep].long(), p_idx[keep].long(), x[keep]
        flat = e_idx.long() * c + p_idx.clamp(min=0).long()
        out = {}
        for kern, nbytes, fn, ref_fn, lib in (
                ("dispatch", kept * h * item + idx_bytes + e_n * c * h * item,
                 lambda: fm.moe_dispatch(x, e_idx, p_idx, e_n, c),
                 lambda: fm.moe_dispatch_ref(x, e_idx, p_idx, e_n, c),
                 lambda: torch.zeros((e_n, c, h), dtype=dtype,
                                     device="cuda").index_put_((ek, pk),
                                                               xk)),
                ("gather", kept * h * item + idx_bytes + n * h * item,
                 lambda: fm.moe_gather(buf, e_idx, p_idx),
                 lambda: fm.moe_gather_ref(buf, e_idx, p_idx),
                 lambda: buf.view(e_n * c, h)[flat])):
            bound_ms, bound_by = bound(nbytes, 0, BF16_FLOPS)
            out[kern] = {"max_abs_err": 0.0, "kernel_ms": time_ms(fn, flush),
                         "plain_ms": time_ms(ref_fn, flush, reps=10),
                         "library_ms": time_ms(lib, flush),
                         "bytes": nbytes, "bound_ms": bound_ms,
                         "bound_by": bound_by}
        results[name] = {"rows": n, "width": h, "dtype": str(dtype),
                         "experts": e_n, "capacity": c, "kept_rows": kept,
                         **out}
        del x, buf, ek, pk, xk, flat, e_idx, p_idx, keep
        release()
    del flush
    release()
    emit({"phase": "moe_kernels", "kernels": list(MOE_KERNELS),
          "check": "bit-equal (torch.equal) to the plain versions and the "
                   "index route, forward and backward",
          "library": {"dispatch": "zeros + index_put_ of the kept rows",
                      "gather": "buf.view(E*C, H)[flat]"},
          "cases": results})
    return results


def phase_moe_reference(group):
    """A small MoE layer (d 64, E 8, F 128, top-2, f32, 64 tokens, capacity
    factor 2) on the card against the same weights on the CPU: the dense
    route (`MoELayer.forward`) and the EP route (`_ep_moe_fn`, the card
    through the one-rank group with the kernels on, the CPU with no group
    and the kernels' plain versions): output, aux loss and every gradient
    within 1e-4 (cuBLAS and the CPU sum in other orders), and identical
    routing: the dense dispatch mask, the EP top-k and slots."""
    from paddle_tpu_torch.framework import flags
    from paddle_tpu_torch.incubate.distributed.models.moe import (
        MoELayer, moe_layer)
    from paddle_tpu_torch.ops.kernels import _support

    d, e, f, t, k = 64, 8, 128, 64, 2
    cpu = MoELayer(d_model=d, num_experts=e, d_hidden=f, top_k=k,
                   device="cpu", generator=torch.Generator().manual_seed(62))
    with torch.no_grad():
        for p in cpu.experts.parameters():          # non-zero biases
            p.add_(0.05 * torch.randn(p.shape, generator=torch.Generator()
                                      .manual_seed(63)))
    card = MoELayer(d_model=d, num_experts=e, d_hidden=f, top_k=k,
                    device="cuda")
    card.load_state_dict(cpu.state_dict())
    x = torch.randn((t, d), generator=torch.Generator().manual_seed(64))
    cap = max(1, int(2.0 * t * k / e))
    results = {}

    def run(layer, route, dev):
        for p in layer.parameters():
            p.grad = None
        xt = x.detach().to(dev).requires_grad_()
        if route == "dense":
            y = layer(xt)
            aux = layer.aux_loss
        else:
            ex = layer.experts
            y, aux = moe_layer._ep_moe_fn(
                xt, layer.gate.gate_proj.weight, ex.w1, ex.b1, ex.w2, ex.b2,
                top_k=k, capacity=cap, activation="gelu",
                group=group if dev == "cuda" else None)
        (y.sum() + aux).backward()
        return [y, aux, xt.grad] + [p.grad for p in layer.parameters()]

    flags.set_flags({"FLAGS_fused_moe_kernels": True})
    try:
        for route in ("dense", "ep"):
            _support.reset_launch_counts()
            got = run(card, route, "cuda")
            torch.cuda.synchronize()
            launched = {c: _support.launch_counter(c).count
                        for c in MOE_KERNELS}
            want_launches = {c: 2 if route == "ep" else 0
                             for c in MOE_KERNELS}
            if launched != want_launches:
                raise AssertionError(f"moe_reference ({route}): launches "
                                     f"{launched} != {want_launches}")
            ref = run(cpu, route, "cpu")
            errs = [float((a.detach().cpu() - b.detach()).abs().max())
                    for a, b in zip(got, ref)]
            if not max(errs) <= 1e-4:
                raise AssertionError(f"moe_reference ({route}): card vs CPU "
                                     f"errors {errs} > 1e-4")
            results[route] = {"max_abs_err": max(errs), "launches": launched}
    finally:
        flags.set_flags({"FLAGS_fused_moe_kernels": False})
    with torch.no_grad():
        routes = {}
        for dev, layer in (("cuda", card), ("cpu", cpu)):
            xd = x.to(dev)
            probs = layer.gate(xd)
            dcap = max(1, int(2.0 * t / e)) * k
            routes[dev] = [moe_layer._dispatch_combine_fn(xd, probs, dcap,
                                                          k)[1]]
            r = moe_layer._ep_routing(xd, layer.gate.gate_proj.weight, k,
                                      cap)
            routes[dev] += [r[1], r[4]]
        for what, a, b in zip(("dense dispatch mask", "EP top-k",
                               "EP slots"), routes["cuda"], routes["cpu"]):
            if not torch.equal(a.cpu(), b):
                raise AssertionError(f"moe_reference: {what} differs "
                                     f"between the card and the CPU")
    emit({"phase": "moe_reference", "config": {"d_model": d, "experts": e,
                                               "d_hidden": f, "top_k": k,
                                               "tokens": t, "dtype": "f32",
                                               "ep_capacity": cap},
          "tol": 1e-4, "routing": "identical", **results})


def phase_moe_layer(kind, smi, group):
    """`moe_workload`'s layer at Mixtral-8x7B width (H 4096, F 14336, 8
    experts, top-2, the JAX expert form: stacked tanh-gelu experts with
    biases), GShardGate, capacity factor 2, 8,192 bf16 tokens; one forward
    + backward of `y.sum() + aux` in each run: (a) "ep_kernels", the EP
    route over the one-rank group with the kernels on, (b) "ep_index", the
    same with the flag off, (c) "dense", `MoELayer.forward`. Each run's
    first step runs with every launch count zeroed just before and read
    just after: exactly 2 `moe_dispatch` and 2 `moe_gather` in (a) (the
    forward's dispatch and gather, and each one's backward), no kernel
    launch in (b) and (c). (a) and (b) are bit-equal in the output, aux
    and every gradient (the kernels move the same bytes as the index ops,
    and nothing else differs); everything is finite. Then the runs are
    timed in turns (CUDA events, median of 5 after a warm-up)."""
    from paddle_tpu_torch.ops.kernels import _support
    from paddle_tpu_torch.tools.moe_workload import (
        BATCH, CAPACITY_FACTOR, D_HIDDEN, D_MODEL, EXPERTS, RUNS, SEQ,
        TOKENS, TOP_K, MoEWorkload, expert_flops)

    torch.cuda.reset_peak_memory_stats()
    work = MoEWorkload(group=group)
    counters = (*SERVE_KERNELS, *TRAIN_KERNELS, *INCUBATE_KERNELS,
                *MOE_KERNELS)
    launches, outs = {}, {}
    for run in RUNS:
        _support.reset_launch_counts()
        outs[run] = work.step(run, keep=True)
        torch.cuda.synchronize()
        launched = {c: _support.launch_counter(c).count for c in counters}
        launches[run] = {c: n for c, n in launched.items() if n}
        expect = {c: 2 for c in MOE_KERNELS} if run == "ep_kernels" else {}
        if launches[run] != expect:
            raise AssertionError(f"moe_layer ({run}): launches "
                                 f"{launches[run]} != {expect}")
        for key, v in outs[run].items():
            if not bool(torch.isfinite(v).all()):
                raise AssertionError(f"moe_layer ({run}): non-finite {key}")
        if run == "dense":
            outs["dense"] = {"y": outs["dense"]["y"],
                             "aux": outs["dense"]["aux"]}
    unequal = [key for key in outs["ep_kernels"]
               if not torch.equal(outs["ep_kernels"][key],
                                  outs["ep_index"][key])]
    if unequal:
        raise AssertionError(f"moe_layer: the kernel route differs from the "
                             f"index route in {unequal}")
    results = {
        "ep_capacity": work.ep_capacity,
        "dense_capacity": work.dense_capacity,
        "aux": {run: float(outs[run]["aux"]) for run in RUNS},
        "dense_vs_ep_norm_rel": _norm_rel(outs["dense"]["y"],
                                          outs["ep_kernels"]["y"]),
        "expert_tflop_fwd": expert_flops(work.ep_capacity) / 1e12,
        "dense_einsum_tflop_fwd_each": 2 * TOKENS * EXPERTS
        * work.dense_capacity * D_MODEL / 1e12}
    del outs
    release()
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
    results["fwd_bwd_ms_median"] = {r: statistics.median(v)
                                    for r, v in times.items()}
    results["fwd_bwd_ms"] = times
    emit({"phase": "moe_layer",
          "layer": f"Mixtral-8x7B width (hidden {D_MODEL}, intermediate "
                   f"{D_HIDDEN}, {EXPERTS} experts, top-{TOP_K}), stacked "
                   f"tanh-gelu experts with biases, GShardGate, capacity "
                   f"factor {CAPACITY_FACTOR}, bf16, B {BATCH} x S {SEQ}, "
                   f"fwd + bwd of y.sum() + aux",
          "group": "one-rank NCCL" if group is not None else None,
          "launches": launches, "kernel_vs_index_route": "bit-equal",
          **results,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "device": kind, "nvidia_smi": smi})
    del work
    release()
    return launches["ep_kernels"]


# ---- SelectedRows, quantization and guarded training ----

# card against CPU on the small cases (`resilience_workload.reference_run`),
# norm-relative for each f32 array: the sparse trajectories' losses, the
# weight-only products and the int8 gradient, QAT and PTQ within
# RES_REF_TOL; the tiny Llama's parameters after three steps at lr 0.01
# within RES_PARAM_TOL: Adam and AdamW normalise each gradient by its
# own magnitude, so an element whose gradient is near rounding noise
# (the card's flash kernel against SDPA's plain version on the CPU)
# moves by a different fraction of lr (an H100 gave 1.1e-5 on a gate_proj
# weight after 3 Adam steps; lazy_reference holds parameters at 1e-3
# for the same reason)
RES_REF_TOL = 1e-5
RES_PARAM_TOL = 1e-4
# sparse_train: Llama-2-7B width at LAYERS layers, SPARSE_STEPS steps each
# way; the sparse run's losses within SPARSE_LOSS_TOL (relative) of the
# dense run's
SPARSE_STEPS = 4
SPARSE_LOSS_TOL = 1e-3
# resilient_train: 1 of 32 layers (at 2, each 9.3 GB checkpoint written,
# verified and read back made the phase ~180 s on an H100), 8 steps, a
# checkpoint every 3 steps (after steps 2 and 5), NaN returned once at
# step 6
RESILIENT_LAYERS, RESILIENT_STEPS, RESILIENT_NAN_AT = 1, 8, 6
RESILIENT_SAVE_EVERY = 3
# quant_deploy: each WeightOnlyLinear's kernel output against its plain
# version on the forward's own input (norm-relative), and the deployed
# logits against the bf16 model's. The logit bounds are those the CPU
# rehearsal holds at 4 layers of random (Xavier) weights, where the
# absmax quantizer sits at its worst: int8 0.020 and int4 0.26-0.30 of
# the logits' norm at hidden 256-1024
QUANT_KERNEL_TOL = 1e-2
QUANT_LOGIT_TOL = {"weight_only_int8": 3e-2, "weight_only_int4": 4e-1}
# a forward at 4 layers: 7 Linears a layer and the head through row 11
# (int8) or 12 (int4), one flash forward a layer, 2 RMSNorms a layer and
# the final one
DEPLOY_GEMMS = 7 * 4 + 1


def _state_equal(label, got, want):
    """Every array / value of `want` equal to `got`'s, bit for bit."""
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(set(got) ^ set(want))}")
    for k, w in want.items():
        g = got[k]
        same = np.array_equal(g, w) if isinstance(w, np.ndarray) \
            else g == w
        if not same:
            raise AssertionError(f"{label}: {k} differs")


def _max_abs_tree(got, want):
    """The largest elementwise difference over the float arrays of two
    nested results."""
    if isinstance(want, dict):
        return max([_max_abs_tree(got[k], want[k]) for k in want] or [0.0])
    if isinstance(want, (list, tuple)):
        return max([_max_abs_tree(g, w) for g, w in zip(got, want)]
                   or [0.0])
    want = np.asarray(want)
    if want.dtype.kind != "f" or not want.size:
        return 0.0
    return float(np.abs(np.asarray(got, np.float64) - want).max())


def _checkpoint_cross_device(paddle, rw, root):
    """A CheckpointManager save of the sparse tiny Llama (AdamW lazy,
    masters, GradScaler, RNG) made on the card restores on the CPU, and
    the CPU's save of that restores on the card: every tensor, scalar
    and counter equal."""
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.resilience import CheckpointManager

    with place.device_scope("gpu"):
        model, opt, scaler = rw.tiny_trained(paddle)
        want = rw.checkpoint_state(paddle, model, opt, scaler)
        CheckpointManager(f"{root}/card").save(2, model=model,
                                               optimizer=opt, scaler=scaler)
    for dev, src, dst in (("cpu", "card", "cpu"), ("gpu", "cpu", None)):
        with place.device_scope(dev):
            model, opt, scaler = rw.tiny_trained(paddle, seed=99, steps=1)
            res = CheckpointManager(f"{root}/{src}").restore_latest(
                model=model, optimizer=opt, scaler=scaler)
            if res is None or res.step != 2:
                raise AssertionError(f"resilience_reference: restore on "
                                     f"{dev} gave {res}")
            _state_equal(f"resilience_reference checkpoint {src} -> {dev}",
                         rw.checkpoint_state(paddle, model, opt, scaler),
                         want)
            if dst is not None:
                CheckpointManager(f"{root}/{dst}").save(
                    2, model=model, optimizer=opt, scaler=scaler)
    return {"card_to_cpu": True, "cpu_to_card": True,
            "tensors": sum(isinstance(v, np.ndarray) for v in want.values())}


def _quarantine_cases(paddle, root):
    """A torn directory (no COMPLETE) and a bit-flipped shard of card
    saves are each quarantined, and the newest good step restores."""
    from paddle_tpu_torch.framework import monitor, place
    from paddle_tpu_torch.resilience import CheckpointManager

    with place.device_scope("gpu"):
        st = {"w": paddle.randn([64, 64]), "b": paddle.randn([64])}
        cm = CheckpointManager(root, keep_last_n=10)
        for step in range(3):
            cm.save(step, state_dict=st)
    q0 = monitor.get("resilience.quarantines")
    Path(root, "step_000002", "COMPLETE").unlink()
    torn = cm.latest_valid()
    shard = Path(root, "step_000001", "0_0.distcp")
    raw = bytearray(shard.read_bytes())
    raw[len(raw) // 2] ^= 0xFF
    shard.write_bytes(bytes(raw))
    flipped = cm.latest_valid()
    quarantined = sorted(p.name for p in Path(root).iterdir()
                         if p.name.startswith("QUARANTINED-"))
    if torn[0] != 1 or flipped[0] != 0 or quarantined != [
            "QUARANTINED-step_000001", "QUARANTINED-step_000002"] or \
            monitor.get("resilience.quarantines") - q0 != 2:
        raise AssertionError(f"resilience_reference: quarantine gave "
                             f"{torn} {flipped} {quarantined}")
    return {"torn_to": torn[0], "bit_flip_to": flipped[0],
            "quarantined": quarantined}


def phase_resilience_reference():
    """`resilience_workload.reference_run` on the card and on the CPU:
    the Layer Llama (`llama_tiny`, f32) with `Embedding(sparse=True)`
    three steps of SGD, Adam(lazy_mode True / False), AdamW(lazy_mode,
    multi_precision) and Momentum under ClipGradByGlobalNorm(1.0), and
    Adam under a GradScaler, the SelectedRows' rows equal, losses
    within RES_REF_TOL and parameters within RES_PARAM_TOL norm-relative
    of the CPU's; `weight_only_linear` int8 / fp8 / int4,
    `llm_int8_linear` and the int8 gemm's gradient to x, QAT (Linear,
    Conv2D) two steps and PTQ in both convert forms within RES_REF_TOL
    (the largest elementwise differences printed). Then the merge of a 2,048 x 4,096
    bf16 SelectedRows repeats bit for bit on the card; a CheckpointManager
    save on the card restores on the CPU and back, bit for bit; a torn
    directory and a bit-flipped shard are quarantined. Returns the
    card run's launches."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.core.selected_rows import merge_rows
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import resilience_workload as rw

    runs = {}
    _launch_delta()
    for dev in ("gpu", "cpu"):
        with place.device_scope(dev):
            runs[dev] = rw.reference_run(paddle)
        if dev == "gpu":
            torch.cuda.synchronize()
            launches = _launch_delta()
    gpu, cpu = runs["gpu"], runs["cpu"]
    worst = {part: _rel_tree(f"resilience_reference {part}", gpu[part],
                             cpu[part], RES_REF_TOL)
             for part in ("quant", "qat_ptq")}
    for key, run in cpu["sparse"].items():
        got = gpu["sparse"][key]
        worst[f"sparse.{key}.losses"] = _rel_tree(
            f"resilience_reference {key} losses", got["losses"],
            run["losses"], RES_REF_TOL)
        worst[f"sparse.{key}.rows"] = _rel_tree(
            f"resilience_reference {key} rows", got["rows"], run["rows"],
            RES_REF_TOL)
        worst[f"sparse.{key}.params"] = _rel_tree(
            f"resilience_reference {key} params", got["params"],
            run["params"], RES_PARAM_TOL)
    max_abs = {part: _max_abs_tree(gpu[part], cpu[part])
               for part in ("sparse", "quant", "qat_ptq")}
    if not launches.get("quant_matmul", 0) >= 4 or \
            not launches.get("quant_matmul_int4", 0) >= 1:
        raise AssertionError(f"resilience_reference: launches {launches}")
    gen = torch.Generator(device="cuda").manual_seed(9)
    rows = torch.randint(0, 32000, (2048,), generator=gen, device="cuda",
                         dtype=torch.int32)
    vals = torch.randn((2048, 4096), generator=gen,
                       device="cuda").to(torch.bfloat16)
    merges = [merge_rows(rows, vals, 32000) for _ in range(5)]
    if not all(torch.equal(u, merges[0][0]) and torch.equal(m, merges[0][1])
               for u, m in merges[1:]):
        raise AssertionError("resilience_reference: the merge does not "
                             "repeat bit for bit")
    root = tempfile.mkdtemp(prefix="resilience_reference_")
    try:
        ckpt = _checkpoint_cross_device(paddle, rw, root)
        quarantine = _quarantine_cases(paddle, f"{root}/quarantine")
    finally:
        shutil.rmtree(root, ignore_errors=True)
    emit({"phase": "resilience_reference", "tol_norm_rel": RES_REF_TOL,
          "param_tol_norm_rel": RES_PARAM_TOL,
          "norm_rel": worst, "max_abs_err": max_abs,
          "merge_repeats_bit_equal": True, "merge_rows": 2048,
          "checkpoint": ckpt, "quarantine": quarantine,
          "launches": launches})
    del runs, gpu, cpu, merges
    release()
    return launches


def _sparse_run(paddle, rw, lw, sparse, timer):
    """SPARSE_STEPS Trainer steps of `sparse_workload` at LAYERS layers;
    returns the report, the embedding's touched rows (param, master,
    moments) after each step, and (sparse) the work."""
    from paddle_tpu_torch.core.selected_rows import SelectedRows, merge_rows

    torch.cuda.reset_peak_memory_stats()
    work = rw.sparse_workload(paddle, sparse)
    model, opt, sched, ids, labels = work
    w = model.llama.embed_tokens.weight
    idx = torch.unique(ids._data.reshape(-1)).long()
    untouched = torch.ones(w.shape[0], dtype=torch.bool, device="cuda")
    untouched[idx] = False
    w0 = w._data.detach().clone()
    losses, launches, step_ms, rows, merge_ms = [], [], [], [], None
    _launch_delta()
    for step in range(SPARSE_STEPS):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with paddle.amp.auto_cast(level="O2"):
            logits = model(ids)
        loss = lw._loss(paddle, logits, labels, model.config.vocab_size)
        del logits
        loss.backward()
        g = w.grad
        if sparse:
            if not isinstance(g, SelectedRows) or w._data.grad is not None \
                    or list(g.values.shape) != [lw.BATCH * lw.SEQ, 4096]:
                raise AssertionError(f"sparse_train: the embedding's "
                                     f"gradient is {g!r}, dense "
                                     f"{w._data.grad is not None}")
        elif list(g.shape) != [lw.VOCAB, 4096]:
            raise AssertionError(f"sparse_train: dense gradient {g.shape}")
        opt.step()
        opt.clear_grad()
        sched.step()
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        launches.append(_launch_delta())
        if sparse and merge_ms is None:
            merge_ms = timer(lambda: merge_rows(g.rows, g.values, g.height))
            _launch_delta()
        del g
        losses.append(float(loss.astype("float32").item()))
        accs = {k: opt._accumulators[k][id(w)] for k in ("moment1",
                                                         "moment2")}
        master = opt._master_weights[id(w)]
        rows.append({"param": w._data.detach()[idx].float().cpu(),
                     "master": master[idx].cpu(),
                     **{k: a[idx].cpu() for k, a in accs.items()}})
        if sparse:
            same = {"param": torch.equal(w._data[untouched], w0[untouched]),
                    "master": torch.equal(master[untouched],
                                          w0[untouched].float()),
                    **{k: not bool(a[untouched].any())
                       for k, a in accs.items()}}
            if not all(same.values()):
                raise AssertionError(f"sparse_train step {step}: untouched "
                                     f"rows moved {same}")
    report = {"losses": losses, "launches": launches, "step_ms": step_ms,
              "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
              "touched_rows": int(idx.numel()), "merge_ms": merge_ms}
    del w0, untouched
    if not sparse:
        del work, model, opt, w
        return report, rows, None
    return report, rows, work


def phase_sparse_train(kind, smi):
    """Llama-2-7B width at LAYERS layers (`resilience_workload.
    sparse_workload`: the Trainer loop's AdamW with lazy_mode=True, clip
    and schedule, O2 bf16, B 1 x S 2048), SPARSE_STEPS eager steps with a
    dense word embedding, the model freed, then the same from the same
    seed with `Embedding(sparse=True)`. Gates: LAZY_STEP launches every
    step both ways; the sparse run's embedding gradient a SelectedRows of
    2,048 rows x 4,096 and no dense [32000, 4096] gradient; rows the
    batch did not touch bit-unchanged in the parameter, the f32 master
    and both moments after every step; the touched rows of the parameter
    after step 1 the dense run's within one bf16 ulp (bit-equality
    reported); losses within SPARSE_LOSS_TOL of the dense run's, finite
    and falling. Returns the launches and the sparse run's work (its
    trained model feeds quant_deploy)."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import loop_workload as lw
    from paddle_tpu_torch.tools import resilience_workload as rw

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timer = lambda fn: time_ms(fn, flush, reps=10)  # noqa: E731
    runs, rows = {}, {}
    with place.device_scope("gpu"):
        runs["dense"], rows["dense"], _ = _sparse_run(paddle, rw, lw, False,
                                                      timer)
        release()
        runs["sparse"], rows["sparse"], work = _sparse_run(
            paddle, rw, lw, True, timer)
    del flush
    totals = {}
    for mode, r in runs.items():
        for i, got in enumerate(r["launches"]):
            if got != LAZY_STEP:
                raise AssertionError(f"sparse_train {mode} step {i}: "
                                     f"launches {got} != {LAZY_STEP}")
            for n, c in got.items():
                totals[n] = totals.get(n, 0) + c
        losses = r["losses"]
        if not all(math.isfinite(v) for v in losses) or \
                not losses[-1] < losses[0]:
            raise AssertionError(f"sparse_train {mode}: losses {losses}")
    rel = max(abs(a - b) / abs(b) for a, b in zip(runs["sparse"]["losses"],
                                                 runs["dense"]["losses"]))
    if not rel <= SPARSE_LOSS_TOL:
        raise AssertionError(f"sparse_train: losses {runs['sparse']} off "
                             f"the dense run's {runs['dense']}")
    first = {}
    for k in rows["dense"][0]:
        a, b = rows["sparse"][0][k], rows["dense"][0][k]
        first[k] = {"bit_equal": bool(torch.equal(a, b)),
                    "max_abs_diff": float((a - b).abs().max())}
    p_s = rows["sparse"][0]["param"].to(torch.bfloat16)
    p_d = rows["dense"][0]["param"].to(torch.bfloat16)
    ulps = int((p_s.view(torch.int16).int() - p_d.view(torch.int16).int())
               .abs().max())
    if ulps > 1:
        raise AssertionError(f"sparse_train: touched rows after step 1 "
                             f"{ulps} bf16 ulps off the dense run's")
    later = [{k: float((s[k] - d[k]).abs().max()) for k in s}
             for s, d in zip(rows["sparse"][1:], rows["dense"][1:])]
    emit({"phase": "sparse_train",
          "model": f"Llama-2-7B width in paddle Layers, {lw.LAYERS} of 32 "
                   f"layers, amp O2 bf16, Embedding(32000, 4096, "
                   f"sparse=True), AdamW(lazy_mode, multi_precision, "
                   f"beta2 0.95, wd 0.01), ClipGradByGlobalNorm(1.0), "
                   f"LinearWarmup(CosineAnnealingDecay(3e-4, 8), 2)",
          "batch": lw.BATCH, "seq": lw.SEQ, "steps": SPARSE_STEPS,
          "launches_per_step": LAZY_STEP,
          "losses": {m: r["losses"] for m, r in runs.items()},
          "loss_rel_max": rel, "tol": SPARSE_LOSS_TOL,
          "touched_rows_after_step_1": first,
          "touched_param_ulps_after_step_1": ulps,
          "touched_rows_max_abs_diff_later_steps": later,
          "untouched_rows_bit_unchanged": True,
          "embedding_grad": {"rows": lw.BATCH * lw.SEQ, "width": 4096,
                             "dense_grad_made": False},
          "step_ms": {m: r["step_ms"] for m, r in runs.items()},
          "step_ms_median": {m: statistics.median(r["step_ms"][1:])
                             for m, r in runs.items()},
          "merge_ms": runs["sparse"]["merge_ms"],
          "touched_rows": runs["sparse"]["touched_rows"],
          "peak_mem_gb": {m: r["peak_mem_gb"] for m, r in runs.items()},
          "device": kind, "nvidia_smi": smi})
    trained = (work[0], work[3])
    work[1].clear_grad()
    del work, runs, rows
    release()
    return totals, trained


def _timed_manager(root, **kw):
    """A CheckpointManager whose snapshots and writes are timed into its
    `times`."""
    from paddle_tpu_torch.resilience import CheckpointManager

    class Timed(CheckpointManager):
        def _snapshot(self, *a, **k):
            t0 = time.perf_counter()
            out = super()._snapshot(*a, **k)
            self.times["snapshot_ms"].append(
                (time.perf_counter() - t0) * 1e3)
            return out

        def _write(self, path, *a, **k):
            t0 = time.perf_counter()
            super()._write(path, *a, **k)
            self.times["write_ms"].append((time.perf_counter() - t0) * 1e3)
            self.times["bytes"].append(sum(
                p.stat().st_size for p in Path(path).iterdir()))

        def _verify_dir(self, *a, **k):
            t0 = time.perf_counter()
            super()._verify_dir(*a, **k)
            self.times["verify_ms"].append((time.perf_counter() - t0) * 1e3)

        def load(self, *a, **k):
            t0 = time.perf_counter()
            out = super().load(*a, **k)
            torch.cuda.synchronize()
            self.times["load_ms"].append((time.perf_counter() - t0) * 1e3)
            return out

    m = Timed(root, **kw)
    m.times = {"snapshot_ms": [], "write_ms": [], "bytes": [],
               "verify_ms": [], "load_ms": []}
    return m


def _host_state(rw, work):
    return {k: v.detach().cpu() for k, v in
            rw.model_state(work[0], work[1]).items()}


def _state_matches(label, rw, work, want):
    got = rw.model_state(work[0], work[1])
    if set(got) != set(want):
        raise AssertionError(f"{label}: keys {sorted(set(got) ^ set(want))}")
    bad = [k for k, v in want.items() if not torch.equal(got[k].cpu(), v)]
    if bad:
        raise AssertionError(f"{label}: {len(bad)} tensors differ, e.g. "
                             f"{bad[:3]}")


def phase_resilient_train(kind, smi):
    """`StepGuard` around the sparse Trainer loop at Llama-2-7B width
    (RESILIENT_LAYERS of 32 layers, B 1 x S 2048): first RESILIENT_STEPS
    steps uninterrupted (the state after step 2 and at the end kept on
    the host), then the same from the same seed under
    `StepGuard(save_every=3)` over `CheckpointManager(keep_last_n=2,
    async_save=True)` in a temporary directory, the step function
    returning NaN once at step 6. Gates: one non-finite trip and one
    rollback, to step 5; every step's loss and the final parameters,
    masters and moments bit-equal to the uninterrupted run's. Then one
    byte of the newest checkpoint's shard is flipped: `latest_valid()`
    quarantines it and `restore_latest` restores step 2 bit for bit
    against the uninterrupted run's state after step 2. Reports the
    snapshot and write ms, GB and GB/s, the verify and restore ms, peak
    memory. Returns the launches of its steps."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import monitor, place
    from paddle_tpu_torch.tools import resilience_workload as rw

    root = tempfile.mkdtemp(prefix="resilient_train_")
    _launch_delta()
    free_gb = shutil.disk_usage(root).free / 1e9
    print(f"resilient_train: {free_gb:.1f} GB free under {root}",
          flush=True)
    torch.cuda.reset_peak_memory_stats()
    try:
        with place.device_scope("gpu"):
            work = rw.sparse_workload(paddle, True, layers=RESILIENT_LAYERS)
            plain, at2 = [], None
            for i in range(RESILIENT_STEPS):
                plain.append(float(rw.f32(rw.train_step(paddle, work))))
                if i == 2:
                    at2 = _host_state(rw, work)
            final = _host_state(rw, work)
            del work
            release()
            work = rw.sparse_workload(paddle, True, layers=RESILIENT_LAYERS)
            cm = _timed_manager(root, keep_last_n=2, async_save=True)
            m0 = monitor.snapshot("resilience.")
            losses, rollbacks, _ = rw.guarded_run(
                paddle, work, cm, RESILIENT_STEPS, RESILIENT_NAN_AT,
                RESILIENT_SAVE_EVERY)
            counters = {k: v - m0.get(k, 0) for k, v in
                        monitor.snapshot("resilience.").items()
                        if v != m0.get(k, 0)}
            if rollbacks != [RESILIENT_NAN_AT - 1] or \
                    counters.get("resilience.rollbacks") != 1 or \
                    counters.get("resilience.trips.non_finite_loss") != 1:
                raise AssertionError(f"resilient_train: rollbacks "
                                     f"{rollbacks}, counters {counters}")
            if [losses[i] for i in range(RESILIENT_STEPS)] != plain:
                raise AssertionError(f"resilient_train: losses {losses} "
                                     f"!= the uninterrupted {plain}")
            _state_matches("resilient_train final state", rw, work, final)
            newest = Path(root, "step_000005", "0_0.distcp")
            with open(newest, "r+b") as f:
                f.seek(newest.stat().st_size // 2)
                b = f.read(1)
                f.seek(newest.stat().st_size // 2)
                f.write(bytes([b[0] ^ 0xFF]))
            t0 = time.perf_counter()
            found = cm.latest_valid()
            verify_ms = (time.perf_counter() - t0) * 1e3
            if found is None or found[0] != 2 or not Path(
                    root, "QUARANTINED-step_000005").is_dir():
                raise AssertionError(f"resilient_train: latest_valid "
                                     f"{found}")
            t0 = time.perf_counter()
            res = cm.restore_latest(model=work[0], optimizer=work[1])
            torch.cuda.synchronize()
            restore_ms = (time.perf_counter() - t0) * 1e3
            if res.step != 2:
                raise AssertionError(f"resilient_train: restored {res}")
            _state_matches("resilient_train restored step 2", rw, work, at2)
            times = cm.times
            del work, at2, final
        torch.cuda.synchronize()
        launches = _launch_delta()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    gb = [b / 1e9 for b in times["bytes"]]
    emit({"phase": "resilient_train",
          "model": f"Llama-2-7B width, {RESILIENT_LAYERS} of 32 layers, "
                   f"sparse embedding, AdamW(lazy_mode, multi_precision), "
                   f"O2 bf16, B 1 x S 2048",
          "steps": RESILIENT_STEPS, "nan_at": RESILIENT_NAN_AT,
          "save_every": RESILIENT_SAVE_EVERY, "rollback_to": rollbacks,
          "counters": counters, "losses": plain,
          "replay_bit_equal": True, "final_state_bit_equal": True,
          "corrupted": "step_000005/0_0.distcp, one byte",
          "quarantined_and_restored": 2, "restored_bit_equal": True,
          "free_gb_before": free_gb,
          "snapshot_ms": times["snapshot_ms"], "write_ms": times["write_ms"],
          "checkpoint_gb": gb,
          "write_gb_per_s": [g / (t / 1e3) for g, t in
                             zip(gb, times["write_ms"])],
          "verify_ms": verify_ms, "restore_ms": restore_ms,
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "device": kind, "nvidia_smi": smi})
    return launches


def _norm_rel_t(a, b):
    a, b = a.float(), b.float()
    return float((a - b).norm() / b.norm())


def _deploy_case(paddle, qw, model, backend, calib, ids, ref, timer):
    from paddle_tpu_torch.ops.kernels import quant_matmul as qm

    row = {"weight_only_int8": "quant_matmul",
           "weight_only_int4": "quant_matmul_int4"}[backend]
    dm = qw.deploy(paddle, model, backend, calib)
    inputs, remove = qw.capture_inputs(dm)
    _launch_delta()
    out = qw.logits(paddle, dm, ids)
    torch.cuda.synchronize()
    launches = _launch_delta()
    remove()
    want = {row: DEPLOY_GEMMS, "flash_attention_fwd": 4, "rms_norm": 9}
    if launches != want:
        raise AssertionError(f"quant_deploy {backend}: launches {launches} "
                             f"!= {want}")
    logit_err = _norm_rel_t(out._data, ref)
    if not logit_err <= QUANT_LOGIT_TOL[backend]:
        raise AssertionError(f"quant_deploy {backend}: logits "
                             f"{logit_err} off the bf16 model's")
    int4 = backend.endswith("int4")
    fn = qm.quant_matmul_int4 if int4 else qm.quant_matmul
    ref_fn = qm.quant_matmul_int4_ref if int4 else qm.quant_matmul_ref
    kernel_err = {}
    with torch.no_grad():
        for name, layer in qw.weight_only_layers(dm):
            x = inputs[name].to(torch.bfloat16)
            x2d = x.reshape(-1, x.shape[-1])
            wq, s = layer.weight._data, layer.weight_scale._data
            kernel_err[name] = _norm_rel_t(fn(x2d, wq, s),
                                           ref_fn(x2d, wq, s))
    _launch_delta()
    if not max(kernel_err.values()) <= QUANT_KERNEL_TOL:
        raise AssertionError(f"quant_deploy {backend}: kernel off its plain "
                             f"version {kernel_err}")
    forward_ms = timer(lambda: qw.logits(paddle, dm, ids))
    _launch_delta()
    del dm, inputs, out
    release()
    return {"launches": launches, "logits_norm_rel": logit_err,
            "tol": QUANT_LOGIT_TOL[backend],
            "kernel_norm_rel_max": max(kernel_err.values()),
            "kernel_tol": QUANT_KERNEL_TOL, "forward_ms": forward_ms}


def phase_quant_deploy(kind, smi, trained=None):
    """sparse_train's trained 4-layer model (a fresh one under `--only`)
    in eval: `PTQ(QuantConfig(), AbsmaxObserver)` calibrated on 2
    batches, then `convert(deploy_backend="weight_only_int8")` and
    `("weight_only_int4")`, each with an eval forward at B 1 x S 2048.
    Gates: DEPLOY_GEMMS launches of row 11 (int8) or 12 (int4) a
    forward, 4 of the flash forward and 9 of RMSNorm, nothing else; each
    WeightOnlyLinear's kernel output within QUANT_KERNEL_TOL of its plain
    version on the forward's own input; logits within QUANT_LOGIT_TOL of
    the bf16 model's. Then two QAT (fake-quant) AdamW steps on the same
    model: finite losses. Reports the forward ms in bf16 / int8 / int4,
    and both gemms at M 2,048 over the five serving shapes (ms, bound,
    cuBLAS bf16 ms). Returns the launches of the deployed forwards and
    the M 2,048 gemm cases."""
    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.framework import place
    from paddle_tpu_torch.tools import loop_workload as lw
    from paddle_tpu_torch.tools import quant_workload as qw
    from paddle_tpu_torch.tools import resilience_workload as rw

    flush = torch.empty(256 << 20, dtype=torch.uint8, device="cuda")
    timer = lambda fn: time_ms(fn, flush, reps=5)  # noqa: E731
    with place.device_scope("gpu"):
        if trained is None:
            work = rw.sparse_workload(paddle, True)
            trained = (work[0], work[3])
            del work
        model, ids = trained
        model.eval()
        rng = np.random.default_rng(1)
        calib = [ids, paddle.to_tensor(rng.integers(0, lw.VOCAB,
                                                    (lw.BATCH, lw.SEQ)))]
        _launch_delta()
        ref = qw.logits(paddle, model, ids)._data
        bf16_ms = timer(lambda: qw.logits(paddle, model, ids))
        _launch_delta()
        cases = {b: _deploy_case(paddle, qw, model, b, calib, ids, ref,
                                 timer)
                 for b in ("weight_only_int8", "weight_only_int4")}
        del ref
        q = paddle.quantization
        qat = q.QAT(q.QuantConfig()).quantize(model)
        del model, trained
        qat.train()
        opt = paddle.optimizer.AdamW(learning_rate=1e-4,
                                     parameters=qat.parameters(),
                                     multi_precision=True)
        labels = paddle.to_tensor(rng.integers(0, lw.VOCAB,
                                               (lw.BATCH, lw.SEQ)))
        qat_losses, qat_launches = [], []
        for _ in range(2):
            with paddle.amp.auto_cast(level="O2"):
                logits = qat(ids)
            loss = lw._loss(paddle, logits, labels, lw.VOCAB)
            del logits
            loss.backward()
            opt.step()
            opt.clear_grad()
            torch.cuda.synchronize()
            qat_launches.append(_launch_delta())
            qat_losses.append(float(loss.astype("float32").item()))
        if not all(math.isfinite(v) for v in qat_losses) or any(
                d.get("flash_attention_fwd") != 4 or d.get("rms_norm") != 9
                for d in qat_launches):
            raise AssertionError(f"quant_deploy QAT: losses {qat_losses}, "
                                 f"launches {qat_launches}")
        del qat, opt
    release()
    gen = torch.Generator(device="cuda").manual_seed(12)
    gemms = {"int8": _gemm_cases("int8", list(GEMM_SHAPES), gen, flush,
                                 m=2048),
             "int4": _gemm_cases("int4", list(GEMM_SHAPES), gen, flush,
                                 m=2048)}
    _launch_delta()
    del flush
    release()
    emit({"phase": "quant_deploy",
          "model": "sparse_train's Llama-2-7B-width model, 4 of 32 layers, "
                   "PTQ(QuantConfig(), AbsmaxObserver) on 2 batches, "
                   "deployed as WeightOnlyLinear (row 11 / 12)",
          "batch": lw.BATCH, "seq": lw.SEQ, "cases": cases,
          "forward_ms": {"bf16": bf16_ms,
                         **{b: c["forward_ms"] for b, c in cases.items()}},
          "qat": {"losses": qat_losses, "launches": qat_launches},
          "gemm_m2048": {f: {n: {k: c[k] for k in (
              "N", "K", "M", "kernel_ms", "plain_ms", "library_ms",
              "bound_ms", "bound_by", "splits", "max_abs_err",
              "bound_fraction")} for n, c in cs.items()}
              for f, cs in gemms.items()},
          "library": "torch.matmul(x, w_bf16.T) (cuBLAS bf16)",
          "device": kind, "nvidia_smi": smi})
    launches = {}
    for c in cases.values():
        for n, k in c["launches"].items():
            launches[n] = launches.get(n, 0) + k
    for d in qat_launches:
        for n, k in d.items():
            launches[n] = launches.get(n, 0) + k
    return launches, gemms


# elastic_reference: the chaos scenario's losses on the card within
# ELASTIC_LOSS_TOL (relative) of the CPU's, the stacked collectives'
# reductions within ELASTIC_RED_TOL; copies, reshards and checkpoint
# round trips bit-equal
ELASTIC_LOSS_TOL = 1e-6
ELASTIC_RED_TOL = 1e-6
ELASTIC_COPIES = ("shard", "s_to_r", "s_to_s", "r_to_p", "broadcast",
                  "all_gather", "scatter", "alltoall", "alltoall_single",
                  "shift", "send_recv")
# elastic_train: Llama-2-7B width at elastic_workload.LAYERS of 32
# layers (one 6.5 GB checkpoint a save), ELASTIC_STEPS steps from
# ELASTIC_PODS pods, a save every elastic_workload.SAVE_EVERY steps
# (after steps 1, 3 and 5: three saves); a pod killed 4 steps after the world-4 build (in step 4, back
# to step 3) and 2 steps after the world-3 build (in step 6, back to
# step 5)
ELASTIC_STEPS, ELASTIC_PODS = 7, 4
ELASTIC_KILLS = ((4, 4), (3, 2))


def _elastic_device_run(paddle, ew, dev, root):
    from paddle_tpu_torch.framework import place

    with place.device_scope(dev):
        chaos = ew.chaos_smoke(paddle, f"{root}/chaos")
        coll = ew.collective_cases(paddle)
        ck = ew.checkpoint_reshard(paddle, f"{root}/ckpt")
    return chaos, coll, ck


def phase_elastic_reference():
    """`elastic_workload` on the card and on the CPU, twice on each: the
    chaos scenario (`chaos_smoke`: world 8, the busiest pod killed in
    step 7, re-formed to 7, every check of `tools/train_chaos_smoke.py`
    on each device), `collective_cases` and `checkpoint_reshard`. Gates:
    the host logic (victim, worlds, restored step, counters, dumps,
    shard shapes) and integer results equal; copies, reshards and
    checkpoint round trips bit-equal between the card and the CPU; the
    losses and the collectives' reductions within 1e-6 relative; each
    device's second run `repr`-equal to its first. Returns the card
    runs' launches (none: the emulated step runs no kernel)."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.tools import elastic_workload as ew

    root = tempfile.mkdtemp(prefix="elastic_reference_")
    runs = {}
    _launch_delta()
    try:
        for dev in ("gpu", "cpu"):
            runs[dev] = [_elastic_device_run(paddle, ew, dev,
                                             f"{root}/{dev}{i}")
                         for i in range(2)]
            if dev == "gpu":
                torch.cuda.synchronize()
                launches = _launch_delta()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    for dev, (a, b) in runs.items():
        if repr(a[0]["losses"]) != repr(b[0]["losses"]) or any(
                not np.array_equal(a[1][k], b[1][k]) for k in a[1]):
            raise AssertionError(f"elastic_reference: the {dev} does not "
                                 f"replay itself")
    (gchaos, gcoll, gck), (cchaos, ccoll, cck) = runs["gpu"][0], \
        runs["cpu"][0]
    host = ("victim", "world", "restored", "moved", "replayed",
            "world4_shards", "header")
    bad = [k for k in host if gchaos[k] != cchaos[k]]
    if bad:
        raise AssertionError(f"elastic_reference: host logic differs: "
                             f"{[(k, gchaos[k], cchaos[k]) for k in bad]}")
    gl = np.array([gchaos["losses"][i] for i in sorted(gchaos["losses"])])
    cl = np.array([cchaos["losses"][i] for i in sorted(cchaos["losses"])])
    loss_rel = float(np.max(np.abs(gl - cl) / np.abs(cl)))
    state_rel = max(float(np.max(np.abs(gchaos["state"][k]
                                        - cchaos["state"][k])))
                    / max(float(np.max(np.abs(cchaos["state"][k]))), 1e-30)
                    for k in cchaos["state"])
    if loss_rel > ELASTIC_LOSS_TOL:
        raise AssertionError(f"elastic_reference: losses {loss_rel} off")
    red_rel = {}
    for k, want in ccoll.items():
        got = gcoll[k]
        if k in ELASTIC_COPIES:
            if not np.array_equal(got, want):
                raise AssertionError(f"elastic_reference: {k} differs")
            continue
        red_rel[k] = float(np.max(np.abs(got - want))
                           / max(float(np.max(np.abs(want))), 1e-30))
        if red_rel[k] > ELASTIC_RED_TOL:
            raise AssertionError(f"elastic_reference: {k} {red_rel[k]}")
    for k, (saved, loaded, n_shards, files) in cck.items():
        g = gck[k]
        if not (np.array_equal(g[0], saved) and np.array_equal(g[1], loaded)
                and np.array_equal(loaded, saved) and g[2] == n_shards == 8
                and g[3] == files):
            raise AssertionError(f"elastic_reference: checkpoint {k}")
    emit({"phase": "elastic_reference", "loss_tol_rel": ELASTIC_LOSS_TOL,
          "losses_max_rel": loss_rel, "state_max_rel": state_rel,
          "chaos": {k: gchaos[k] for k in host},
          "recovery_ms": {"gpu": gchaos["recovery_ms"],
                          "cpu": cchaos["recovery_ms"]},
          "collectives_bit_equal": list(ELASTIC_COPIES),
          "reductions_max_rel": red_rel,
          "checkpoint_dp2mp4_to_dp4mp2": {k: {"shards": v[2],
                                              "files": len(v[3])}
                                          for k, v in gck.items()},
          "self_replay_repr_equal": True, "launches": launches})
    del runs
    release()
    return launches


def phase_elastic_train(kind, smi):
    """`elastic_workload.elastic_run` at Llama-2-7B width
    (elastic_workload.LAYERS of 32 layers, B 1 x S 2048, O2 bf16, AdamW with
    lazy_mode and multi_precision, a GradScaler): an
    `ElasticTrainSupervisor` over ELASTIC_PODS pods checkpointing every
    elastic_workload.SAVE_EVERY steps through an async `CheckpointManager` in a
    temporary directory, min_world 2, reform_budget 2; a pod killed in
    step 4 (re-formed to 3: no dim of 4096, 11008 or 32000 divides by 3,
    every tensor replicated) and another in step 6 (re-formed to 2: every
    tensor re-sliced). Gates: `reforms == 2`, `elastic.lost_pods` up by
    2; a heartbeat with a first-epoch incarnation rejected; both lost
    pods in the forensics dumps with their last payloads; no
    quarantined directory; each re-form's resumed losses `repr`-equal to
    an uninterrupted run at the new world restored from the same
    checkpoint, and the final parameters, masters and moments bit-equal
    to the second reference's; one launch of rows 5, 6 and 7 a layer and
    3 of row 13 a step run (the replayed steps and the references'
    included). Reports the step ms, each re-form's recovery ms, the
    checkpoints' snapshot / write / verify / restore ms and GB, and peak
    memory. Returns the launches."""
    import shutil
    import tempfile

    import paddle_tpu_torch as paddle
    from paddle_tpu_torch.distributed.auto_parallel.sharding_bridge import \
        local_shards
    from paddle_tpu_torch.framework import monitor, place
    from paddle_tpu_torch.tools import elastic_workload as ew

    root = tempfile.mkdtemp(prefix="elastic_train_")
    _launch_delta()
    free_gb = shutil.disk_usage(root).free / 1e9
    print(f"elastic_train: {free_gb:.1f} GB free under {root}", flush=True)
    torch.cuda.reset_peak_memory_stats()
    pods = [f"pod{i}" for i in range(ELASTIC_PODS)]
    step_ms = []            # each trainable's step-ms list, by build

    def build(world):
        tr = ew.LlamaTrainable(paddle, world)
        step_ms.append((len(world), tr.step_ms))
        return tr

    try:
        with place.device_scope("gpu"):
            lost0 = monitor.get("elastic.lost_pods")
            cm = _timed_manager(f"{root}/ckpt", keep_last_n=4,
                                async_save=True)
            t0 = time.perf_counter()
            sup, store, incs, losses, recovery = ew.elastic_run(
                paddle, cm, build, pods, ELASTIC_STEPS, ELASTIC_KILLS,
                f"{root}/flight")
            torch.cuda.synchronize()
            run_s = time.perf_counter() - t0
            n_sup = len(step_ms)        # the supervised run's builds
            run_steps = sum(len(ms) for _, ms in step_ms)
            dumps = ew.flight_dumps(f"{root}/flight")
            lost = [h["lost_pods"] for h, _ in dumps]
            restored = [h["restored_step"] for h, _ in dumps]
            if sup.reforms != 2 or sorted(sup.world) != pods[:2] or \
                    monitor.get("elastic.lost_pods") - lost0 != 2 or \
                    sorted(losses) != list(range(ELASTIC_STEPS)):
                raise AssertionError(f"elastic_train: reforms "
                                     f"{sup.reforms}, world {sup.world}")
            if store.heartbeat("pod0", incarnation=incs["pod0"]) \
                    is not False:
                raise AssertionError("elastic_train: a dead incarnation "
                                     "beat")
            if lost != [["pod3"], ["pod2"]] or restored != [3, 5] or [
                    (f["lost_pod"], f["final_payload"]["step"],
                     "loss" in f["final_payload"]) for _, f in dumps] != \
                    [("pod3", 3, True), ("pod2", 5, True)]:
                raise AssertionError(f"elastic_train: dumps {dumps}")
            if any(d.name.startswith("QUARANTINED-")
                   for d in Path(cm.root).iterdir()):
                raise AssertionError("elastic_train: a quarantined dir")
            worlds = [(pods[:3], 3, 6), (pods[:2], 5, ELASTIC_STEPS)]
            refs = []
            for world, back, end in worlds:
                ref, tr = ew.reference_from_restored(cm, build, world, back,
                                                     end)
                bad = {i: (repr(losses[i]), repr(v)) for i, v in
                       ref.items() if repr(losses[i]) != repr(v)}
                if bad:
                    raise AssertionError(f"elastic_train: world "
                                         f"{len(world)} replay {bad}")
                refs.append(ref)
                # distinct shards a tensor: 1 at world 3 (replicated),
                # 2 at world 2 (every tensor re-sliced), scalars whole
                split = {len({o for _, o, _ in local_shards(t)})
                         for t in tr.state_dict().values() if t.dim()}
                if split != {2 if len(world) == 2 else 1}:
                    raise AssertionError(f"elastic_train: world "
                                         f"{len(world)} shards {split}")
                if len(world) == 2:
                    diff = ew.state_equal(sup.trainable, tr)
                    if diff:
                        raise AssertionError(f"elastic_train: final state "
                                             f"differs at {diff[:3]}")
                del tr
                release()
            torch.cuda.synchronize()
            launches = _launch_delta()
            n = run_steps + sum(len(r) for r in refs)
            want = {"flash_attention_fwd": n * ew.LAYERS,
                    "flash_attention_dq": n * ew.LAYERS,
                    "flash_attention_dkv": n * ew.LAYERS,
                    "rms_norm": n * (2 * ew.LAYERS + 1)}
            if launches != want:
                raise AssertionError(f"elastic_train: launches {launches} "
                                     f"!= {want} over {n} step runs")
            times = cm.times
            del sup
        torch.cuda.synchronize()
    finally:
        shutil.rmtree(root, ignore_errors=True)
    release()
    gb = [b / 1e9 for b in times["bytes"]]
    emit({"phase": "elastic_train",
          "model": f"Llama-2-7B width, {ew.LAYERS} of 32 layers, "
                   f"O2 bf16, AdamW(lazy_mode, multi_precision), "
                   f"GradScaler, B 1 x S 2048, state Shard(0) over world "
                   f"where the leading dim divides",
          "worlds": "4->3->2", "steps": ELASTIC_STEPS,
          "save_every": ew.SAVE_EVERY, "lost_pods": lost,
          "restored_steps": restored,
          "losses": {i: losses[i] for i in sorted(losses)},
          "replays_repr_equal": True, "final_state_bit_equal": True,
          "step_runs": n, "step_ms_by_world": [
              {"world": w, "ms": ms} for w, ms in step_ms[:n_sup]],
          "reference_step_ms_by_world": [
              {"world": w, "ms": ms} for w, ms in step_ms[n_sup:]],
          "recovery_ms": recovery, "run_s": run_s,
          "free_gb_before": free_gb,
          "snapshot_ms": times["snapshot_ms"], "write_ms": times["write_ms"],
          "checkpoint_gb": gb, "verify_ms": times["verify_ms"],
          "restore_ms": times["load_ms"],
          "peak_mem_gb": torch.cuda.max_memory_allocated() / 2 ** 30,
          "launches": launches, "device": kind, "nvidia_smi": smi})
    return launches


def _m2048(cases):
    """A gemm's times at M 2,048 by serving shape: kernel, bound and
    cuBLAS bf16 ms."""
    return {n: {"ms": c["kernel_ms"], "bound_ms": c["bound_ms"],
                "library_ms": c["library_ms"], "plain_ms": c["plain_ms"]}
            for n, c in cases.items()}


def _row(name, source, replaces, launches, case, **extra):
    return {"name": name, "route": "cuda", "source": source,
            "replaces": replaces, **extra, "launches": launches,
            "max_abs_err": case["max_abs_err"], "ms": case["kernel_ms"],
            "plain_ms": case["plain_ms"], "bound_ms": case["bound_ms"],
            "bound_by": case["bound_by"], "library_ms": case["library_ms"],
            "ok": True}


# the phases `--only` runs alone, after the device check
ONLY = {
    "lora_reference": phase_lora_reference,
    "serve_lora": phase_serve_lora,
    "serve_lora_quant":
        lambda kind, smi: phase_serve_lora_quant(kind, smi, None),
    "serve_migrate": phase_serve_migrate,
    "fleet_reference": phase_fleet_reference,
    # one run serves both: the disaggregated run sits between the clean
    # and the chaos fleet runs over the same engines
    "serve_fleet": phase_serve_fleet,
    "serve_disagg": phase_serve_fleet,
    "tp_reference": None,
    "serve_tp": None,
    "eager_reference": lambda kind, smi: phase_eager_reference(),
    "eager_attention": phase_eager_attention,
    "jit_reference": lambda kind, smi: phase_jit_reference(),
    "jit_layer": phase_jit_layer,
    "lazy_reference": lambda kind, smi: phase_lazy_reference(),
    "lazy_llama": phase_lazy_llama,
    "ops_reference": lambda kind, smi: phase_ops_reference(),
    "train_loop_reference": lambda kind, smi: phase_train_loop_reference(),
    "train_loop": phase_train_loop,
    "nn_reference": lambda kind, smi: phase_nn_reference(),
    "encoder_train": phase_encoder_train,
    "fnet_reference": lambda kind, smi: phase_fnet_reference(),
    "fnet_train": phase_fnet_train,
    "resilience_reference": lambda kind, smi: phase_resilience_reference(),
    "sparse_train": phase_sparse_train,
    "resilient_train": phase_resilient_train,
    "quant_deploy": phase_quant_deploy,
    "elastic_reference": lambda kind, smi: phase_elastic_reference(),
    "elastic_train": phase_elastic_train,
}
# the TP phases by `phase_tp` task: `--only` runs them in one world
TP_ONLY = {"tp_reference": "reference", "serve_tp": "serve"}


def main(argv=()):
    if argv and argv[0] == "--tp-rank":
        # one rank of phase_tp's world: RANK WORLD PORT DIR TASKS
        _tp_rank_main(int(argv[1]), int(argv[2]), int(argv[3]), argv[4],
                      argv[5].split(","))
        return
    if argv:
        names = argv[1].split(",") if len(argv) == 2 and \
            argv[0] == "--only" else []
        if not names or any(n not in ONLY for n in names):
            raise SystemExit("usage: python3 chip_smoke.py [--only "
                             f"PHASE[,PHASE...]], phases {sorted(ONLY)}")
        kind, smi = phase_device()
        done = set()
        for name in names:
            if name not in TP_ONLY and ONLY[name] not in done:
                done.add(ONLY[name])
                ONLY[name](kind, smi)
        tasks = tuple(TP_ONLY[n] for n in TP_ONLY if n in names)
        if tasks:                       # one world of ranks for both
            phase_tp(kind, smi, tasks)
        print(smi, flush=True)
        return
    kind, smi = phase_device()
    phase_build()
    attn = phase_kernel()
    attn_q = phase_kernel_q()
    decode, verify, verify_launches = phase_paged()
    int8, int4 = phase_gemm()
    phase_reference()
    bf16_launches = phase_serve(kind, smi)
    l8, l4 = phase_serve_quant(kind, smi)
    gen_launches = phase_generate(kind, smi)
    ngram_launches, draft_launches = phase_serve_spec(kind, smi)
    prefix_launches = phase_serve_prefix(kind, smi)
    phase_serve_faults(kind, smi)
    phase_lora_reference(kind, smi)
    lora_launches, factors = phase_serve_lora(kind, smi)
    lora_q_launches = phase_serve_lora_quant(kind, smi, factors)
    del factors
    migrate_launches = phase_serve_migrate(kind, smi)
    fleet_ref_launches = phase_fleet_reference(kind, smi)
    fleet_launches = phase_serve_fleet(kind, smi)
    tp_launches = phase_tp(kind, smi)
    flash = phase_flash()
    rms = phase_rms()
    phase_train_reference()
    train_launches = phase_train(kind, smi)
    phase_eager_reference()
    eager_launches = phase_eager_attention(kind, smi)
    phase_jit_reference()
    jit_launches = phase_jit_layer(kind, smi)
    lazy_ref_launches = phase_lazy_reference()
    lazy_launches = phase_lazy_llama(kind, smi)
    ops_ref_launches = phase_ops_reference()
    loop_ref_launches = phase_train_loop_reference()
    loop_launches = phase_train_loop(kind, smi)
    nn_ref_launches = phase_nn_reference()
    enc_launches = phase_encoder_train(kind, smi)
    phase_fnet_reference()
    phase_fnet_train(kind, smi)
    res_ref_launches = phase_resilience_reference()
    sparse_launches, trained = phase_sparse_train(kind, smi)
    resilient_launches = phase_resilient_train(kind, smi)
    deploy_launches, gemm_m2048 = phase_quant_deploy(kind, smi, trained)
    del trained
    release()
    phase_elastic_reference()
    elastic_launches = phase_elastic_train(kind, smi)
    fused = phase_incubate_kernels()
    layer_launches = phase_incubate_layer(kind, smi)
    incubate_decode_launches = phase_incubate_serve(kind, smi)
    from paddle_tpu_torch.tools.moe_workload import one_rank_group

    group = one_rank_group()
    moe = phase_moe_kernels()
    phase_moe_reference(group)
    moe_launches = phase_moe_layer(kind, smi, group)
    torch.distributed.destroy_process_group()
    attn_src = "paddle_tpu_torch/csrc/ragged_paged_attention.cu"
    gemm_src = "paddle_tpu_torch/csrc/quant_matmul.cu"
    pa_py = "paddle_tpu/ops/pallas/paged_attention.py"
    emit({"kernels": [
        _row("ragged_paged_attention", attn_src, f"{pa_py}:278",
             bf16_launches["ragged_paged_attention"]
             + ngram_launches["ragged_paged_attention"]
             + draft_launches["ragged_paged_attention"]
             + prefix_launches["ragged_paged_attention"]
             + lora_launches["ragged_paged_attention"]
             + migrate_launches["ragged_paged_attention"]
             + fleet_ref_launches["ragged_paged_attention"]
             + fleet_launches["ragged_paged_attention"]
             + tp_launches["ragged_paged_attention"], attn["mha_bf16"],
             instance=attn["mha_bf16"]["instance"],
             splits=attn["mha_bf16"]["splits"]),
        _row("ragged_paged_attention_q", attn_src, f"{pa_py}:380",
             l8["ragged_paged_attention_q"]
             + l4["ragged_paged_attention_q"]
             + prefix_launches["ragged_paged_attention_q"]
             + lora_q_launches["ragged_paged_attention_q"]
             + migrate_launches["ragged_paged_attention_q"]
             + fleet_ref_launches["ragged_paged_attention_q"]
             + tp_launches["ragged_paged_attention_q"],
             attn_q["mha_bf16"],
             instance=attn_q["mha_bf16"]["instance"],
             splits=attn_q["mha_bf16"]["splits"]),
        _row("paged_attention_decode", attn_src, f"{pa_py}:38",
             gen_launches["paged_attention"]
             + draft_launches["paged_attention"] + incubate_decode_launches,
             decode["mha_bf16"], instance=decode["mha_bf16"]["instance"],
             general_instance_ms=decode["mha_f32"]["kernel_ms"]),
        _row("paged_attention_verify", attn_src, f"{pa_py}:146",
             verify_launches, verify["mha_bf16_s5"],
             instance=verify["mha_bf16_s5"]["instance"],
             general_instance_ms=verify["mha_f32_s5"]["kernel_ms"],
             launches_from="the paged_verify phase (no engine path "
                           "reaches the verify kernel)"),
        _row("quant_matmul", gemm_src,
             "paddle_tpu/ops/pallas/quant_matmul.py:29",
             l8["quant_matmul"] + res_ref_launches["quant_matmul"]
             + deploy_launches["quant_matmul"], int8["qkv_int8"],
             splits=int8["qkv_int8"]["splits"],
             deploy_launches=deploy_launches["quant_matmul"],
             m2048=_m2048(gemm_m2048["int8"])),
        _row("quant_matmul_int4", gemm_src,
             "paddle_tpu/ops/pallas/quant_matmul.py:115",
             l4["quant_matmul_int4"] + lora_q_launches["quant_matmul_int4"]
             + tp_launches["quant_matmul_int4"]
             + res_ref_launches["quant_matmul_int4"]
             + deploy_launches["quant_matmul_int4"],
             int4["qkv_int4"],
             splits=int4["qkv_int4"]["splits"],
             deploy_launches=deploy_launches["quant_matmul_int4"],
             m2048=_m2048(gemm_m2048["int4"])),
        *[_row(name, FLASH_SRC, f"{FA_PY}:{line}",
               train_launches[name] + eager_launches[name]
               + jit_launches[name] + lazy_ref_launches[name]
               + lazy_launches[name] + ops_ref_launches.get(name, 0)
               + loop_ref_launches.get(name, 0) + loop_launches[name]
               + nn_ref_launches.get(name, 0) + enc_launches[name]
               + res_ref_launches.get(name, 0) + sparse_launches[name]
               + resilient_launches[name] + deploy_launches.get(name, 0)
               + elastic_launches[name],
               flash["train_mha"][name], also_replaces=f"{FA_PY}:{also}",
               bert_d64_ms=flash["bert_d64"][name]["kernel_ms"],
               bert_d64_bound_ms=flash["bert_d64"][name]["bound_ms"],
               bert_d64_library_ms=flash["bert_d64"][name]["library_ms"],
               bert_d64_plain_ms=flash["bert_d64"][name]["plain_ms"])
          for name, line, also in (("flash_attention_fwd", 49, 424),
                                   ("flash_attention_dq", 100, 537),
                                   ("flash_attention_dkv", 149, 594))],
        _row("rms_norm", "paddle_tpu_torch/csrc/rms_norm.cu",
             "paddle_tpu/ops/pallas/rms_norm.py:18",
             train_launches["rms_norm"] + eager_launches["rms_norm"]
             + jit_launches["rms_norm"] + lazy_ref_launches["rms_norm"]
             + lazy_launches["rms_norm"]
             + ops_ref_launches.get("rms_norm", 0)
             + loop_ref_launches.get("rms_norm", 0)
             + loop_launches["rms_norm"]
             + res_ref_launches.get("rms_norm", 0)
             + sparse_launches["rms_norm"] + resilient_launches["rms_norm"]
             + deploy_launches["rms_norm"] + elastic_launches["rms_norm"],
             rms["bf16"]),
        _row("fused_rope", ROPE_SRC, f"{ROPE_PY}:20",
             layer_launches["fused_rope"], fused["rope_bf16"]),
        _row("bias_act", BIAS_ACT_SRC, f"{BA_PY}:57",
             layer_launches["bias_act"],
             fused["bias_act_swiglu_packed_bf16"]),
        _row("swiglu", BIAS_ACT_SRC, f"{BA_PY}:113",
             layer_launches["swiglu"], fused["swiglu_bf16"]),
        _row("moe_dispatch", MOE_SRC, f"{MOE_PY}:40",
             moe_launches["moe_dispatch"], moe["bf16"]["dispatch"]),
        _row("moe_gather", MOE_SRC, f"{MOE_PY}:45",
             moe_launches["moe_gather"], moe["bf16"]["gather"])]})
    print(smi, flush=True)
    emit({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                 "count": torch.cuda.device_count()}})


if __name__ == "__main__":
    main(sys.argv[1:])
