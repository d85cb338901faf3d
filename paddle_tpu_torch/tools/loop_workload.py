"""The workloads of the op surface and the training loop, in one place for
`chip_smoke.py` (its `ops_reference`, `train_loop_reference` and
`train_loop` phases) and the tests that rehearse them on the CPU.

- `ops_sweep(paddle, device)`: the op harness (`testing/op_harness.py`)
  over the manifest's `paddle`, `Tensor`, `paddle.nn.functional`,
  `paddle.nn`, `paddle.linalg`, `paddle.fft` and `paddle.signal` exports
  on one device, keeping every forward output;
  `compare_sweeps(card, cpu)` holds one run to another: the same exports
  ran, every output on the device asked for, float64 outputs within
  `TOL64` relative, float32 within `TOL32`, integer, bool and seeded
  draws bit-equal, the same finite-difference verdicts; the
  decompositions whose vectors are unique only up to sign (`svd`, `qr`,
  `eig`, `eigh`, the low-rank SVDs) by their values and the products the
  signs leave alone. `whisper_front_end` (Whisper's STFT at its real
  size) and `decompositions` (1024 x 1024 factorisations by residual,
  their values beside numpy's float64 ones, `float64_values`) are the
  two realistic-size cases the card is held to the CPU on.
  `attention_routes` holds `flash_attention` / `flash_attn_qkvpacked` to
  `scaled_dot_product_attention` on the card, bit for bit with one launch
  of each flash kernel, and the masked composite near them.
- The loop PaddleNLP's Trainer builds around a Llama (`build_optimizer`):
  AdamW (`multi_precision`, beta2 0.95, weight decay 0.01 on every
  parameter but the norm weights, by `apply_decay_param_fun` over the
  parameters' names) with `ClipGradByGlobalNorm(1.0)` over
  `LinearWarmup(CosineAnnealingDecay(3e-4, T_max=8), 2, 0.0, 3e-4)`, the
  scheduler stepped after each step; the labels' last positions are
  `IGNORE` and the loss is `cross_entropy(ignore_index=IGNORE)`.
  `lr_at(step)` is the schedule's closed form.
- `tiny_loop(paddle)`: that loop on `llama_tiny` Layers (f32, seed 7),
  3 steps, with the losses, pre-clip global norms (read on the host from
  the gradients), learning rates and parameters after; either package.
- `optimizer_cases(paddle)`: each of Adagrad, Adadelta, RMSProp, Adamax,
  Lamb, NAdam, RAdam and LBFGS two steps on a small Layer model.
- `loop_workload(paddle)` / `run_loop`: the `train_loop` phase:
  Llama-2-7B width at `LAYERS` layers in paddle Layers, bf16 by
  `amp.decorate(level="O2")`, one sequence of `SEQ` tokens whose last
  `IGNORED` labels are ignored, `WARMUP_STEPS` + `TIMED_STEPS` steps,
  eagerly or under `lazy_guard()`; the clip (a recording
  `ClipGradByGlobalNorm`) keeps each
  step's pre-clip norm on the card, and in the warm-up the post-clip
  norm, and CUDA events time the clip and the optimizer step inside each
  timed step without a sync.
"""
from __future__ import annotations

import json
import math
import time
from pathlib import Path

import numpy as np

__all__ = ["NAMESPACES", "TOL64", "TOL32", "load_manifest", "ops_sweep",
           "compare_sweeps", "whisper_front_end", "decompositions",
           "float64_values",
           "attention_routes", "BASE_LR", "T_MAX", "WARMUP", "IGNORE", "lr_at",
           "decay_names", "build_optimizer", "tiny_loop", "optimizer_cases",
           "reference_run", "loop_workload", "run_loop",
           "LAYERS", "BATCH", "SEQ", "VOCAB", "IGNORED", "WARMUP_STEPS",
           "TIMED_STEPS"]

NAMESPACES = ("paddle", "Tensor", "paddle.nn.functional", "paddle.nn",
              "paddle.linalg", "paddle.fft", "paddle.signal")
TOL64 = dict(rtol=1e-9, atol=1e-12)
TOL32 = dict(rtol=1e-5, atol=1e-6)
# seeded draws whose values are the generator's bits: bit-equal across
# devices (`randn` / `normal` go through erfinv and take the float
# tolerance)
RANDOM_BITS = {"rand", "uniform", "randint", "randperm", "bernoulli",
               "multinomial", "bernoulli_", "uniform_", "randint_like"}
# float64 outputs of float32 arithmetic: a float32 draw (normal_,
# log_normal_) or softmax (top_p_sampling's probabilities) cast to the
# input's dtype, held at the float32 tolerance
F32_INSIDE = {"normal_", "log_normal_", "top_p_sampling"}
# decompositions whose vectors are unique up to sign or phase: cuSOLVER
# need not pick LAPACK's, so the card is held to the CPU on what the
# signs leave alone
_INVARIANTS = {
    "svd": lambda u, s, vh: [s, (u[..., :, :s.shape[-1]] * s[..., None, :])
                             @ vh[..., :s.shape[-1], :]],
    "svd_lowrank": lambda u, s, v: [s, (u * s[..., None, :])
                                    @ np.swapaxes(v, -1, -2)],
    "eigh": lambda w, v: [w, (v * w[..., None, :])
                          @ np.swapaxes(v, -1, -2).conj()],
    "qr": lambda q, r: [q[..., :, :r.shape[-2]] @ r],
    "eig": lambda w, v: [np.sort_complex(w), (v * w[..., None, :])
                         @ np.linalg.inv(v)],
}
_INVARIANTS["pca_lowrank"] = _INVARIANTS["svd_lowrank"]

BASE_LR, T_MAX, WARMUP, IGNORE = 3e-4, 8, 2, -100
LAYERS, BATCH, SEQ, VOCAB, IGNORED = 4, 1, 2048, 32000, 256
WARMUP_STEPS, TIMED_STEPS = 2, 4


# ---- the op surface ----------------------------------------------------------


def load_manifest(root=None) -> dict:
    """The parity manifest (`OPS_PARITY.json` at the repository root)."""
    root = Path(root) if root else Path(__file__).resolve().parents[2]
    return json.loads((root / "OPS_PARITY.json").read_text())


def ops_sweep(paddle, device, manifest=None):
    """The harness sweep of `NAMESPACES` on `device`, outputs kept."""
    from ..testing import op_harness

    return op_harness.sweep(paddle, manifest or load_manifest(),
                            namespaces=NAMESPACES, device=device,
                            record=True)


def _same(label, got, want, bits, f32=False):
    if got.dtype != want.dtype or got.shape != want.shape:
        raise AssertionError(f"{label}: {got.dtype}{got.shape} != "
                             f"{want.dtype}{want.shape}")
    if want.dtype.kind in "fc" and not bits:
        tol = TOL64 if (want.dtype.itemsize >= 8 and want.dtype.kind == "f"
                        or want.dtype == np.complex128) and not f32 \
            else TOL32
        np.testing.assert_allclose(got, want, err_msg=label,
                                   equal_nan=True, **tol)
        return float(np.nanmax(np.abs(got.astype(np.complex128)
                                      - want))) if want.size else 0.0
    np.testing.assert_array_equal(got, want, err_msg=label)
    return 0.0


def compare_sweeps(card, cpu, device="cuda"):
    """Hold the sweep `card` (run on `device`) to `cpu`. Returns, per
    namespace, the exports that ran, those compared by value, the
    finite-difference verdicts, and the largest float difference; raises
    listing every export that fails a gate."""
    if set(card) != set(cpu):
        raise AssertionError("sweeps over different exports")
    stats, worst, bad = {}, 0.0, []
    for key, want in sorted(cpu.items()):
        got = card[key]
        ns, _, name = key.partition(":")
        s = stats.setdefault(ns, {"ran": 0, "compared": 0, "vjp": 0})
        if want["ran"] != got["ran"]:
            bad.append(f"{key}: ran on the CPU {want['ran']}, on {device} "
                       f"{got['ran']} ({got.get('error')})")
            continue
        if bool(want.get("vjp")) != bool(got.get("vjp")):
            bad.append(f"{key}: finite-difference verdict {want.get('vjp')} "
                       f"on the CPU, {got.get('vjp')} on {device}")
        if not want["ran"]:
            continue
        s["ran"] += 1
        s["vjp"] += bool(want.get("vjp"))
        if "outs" not in want:
            continue
        try:
            if got["devices"] != ([device] if want["devices"] else []):
                raise AssertionError(f"outputs on {got['devices']}, asked "
                                     f"for {device}")
            if len(got["outs"]) != len(want["outs"]):
                raise AssertionError(f"{len(got['outs'])} outputs, CPU "
                                     f"{len(want['outs'])}")
            g_outs, w_outs = got["outs"], want["outs"]
            if name in _INVARIANTS:
                g_outs = _INVARIANTS[name](*g_outs)
                w_outs = _INVARIANTS[name](*w_outs)
            for i, (g, w) in enumerate(zip(g_outs, w_outs)):
                worst = max(worst, _same(f"[{i}]", g, w,
                                         name in RANDOM_BITS,
                                         name in F32_INSIDE))
        except AssertionError as e:
            bad.append(f"{key}: {' '.join(str(e).split())[:300]}")
            continue
        s["compared"] += 1
    if bad:
        raise AssertionError(f"{len(bad)} exports off the CPU:\n"
                             + "\n".join(bad))
    return {"per_namespace": stats, "max_abs_err": worst}


# the Whisper log-spectrogram front end (openai/whisper `audio.py`: 16 kHz
# audio in 30 s chunks, a 400-point periodic Hann window every 160
# samples), over a batch of chunks
WHISPER_RATE, WHISPER_SECONDS, WHISPER_N_FFT, WHISPER_HOP = 16000, 30, \
    400, 160
WHISPER_BATCH = 8
# the seed of the realistic-size cases' numpy inputs
CASE_SEED = 0


def whisper_front_end(paddle):
    """`stft` of WHISPER_BATCH chunks of seeded noise (centred, reflect
    padded), the log10 power of every frame but the last clamped at
    1e-10 (whisper's `log_mel_spectrogram` before its mel filters), and
    `istft` back to the audio. Returns numpy arrays: the audio, the
    spectrum, the log power and the reconstruction."""
    n = WHISPER_RATE * WHISPER_SECONDS
    audio = (np.random.default_rng(CASE_SEED).standard_normal(
        (WHISPER_BATCH, n)) * 0.1).astype(np.float32)
    x = paddle.to_tensor(audio)
    window = paddle.to_tensor(
        np.hanning(WHISPER_N_FFT + 1)[:-1].astype(np.float32))
    spec = paddle.signal.stft(x, WHISPER_N_FFT, WHISPER_HOP, window=window)
    power = spec[..., :-1].abs() ** 2
    log_spec = paddle.log10(paddle.clip(power, min=1e-10))
    back = paddle.signal.istft(spec, WHISPER_N_FFT, WHISPER_HOP,
                               window=window, length=n)
    return {"audio": audio, "spec": spec.numpy(),
            "log_spec": log_spec.numpy(), "back": back.numpy()}


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-300))


def decompositions(paddle, n, dtype):
    """`cholesky`, `solve`, `eigh`, `svd`, `qr` and `lu` / `lu_unpack`
    of seeded n x n matrices (a Gaussian A, an SPD S = A A^T / n + I) in
    `dtype`, each by its reconstruction residual (norm-relative, in
    float64 on the host), with S's eigenvalues and A's singular values.
    """
    a, spd, b = _case_matrices(n)
    A, S, B = (paddle.to_tensor(v, dtype=dtype) for v in (a, spd, b))
    a, spd, b = (t.numpy().astype(np.float64) for t in (A, S, B))
    lo = paddle.linalg.cholesky(S).numpy().astype(np.float64)
    x = paddle.linalg.solve(A, B).numpy().astype(np.float64)
    w, v = (t.numpy().astype(np.float64) for t in paddle.linalg.eigh(S))
    u, s, vh = (t.numpy().astype(np.float64) for t in paddle.linalg.svd(A))
    q, r = (t.numpy().astype(np.float64) for t in paddle.linalg.qr(A))
    packed, piv = paddle.linalg.lu(A)
    p, lf, uf = (t.numpy().astype(np.float64)
                 for t in paddle.linalg.lu_unpack(packed, piv))
    eye = np.eye(n)
    return {"residuals": {
        "cholesky": _rel(lo @ lo.T, spd),
        # the backward error ||Ax - b|| / (||A|| ||x||)
        "solve": float(np.linalg.norm(a @ x - b)
                       / (np.linalg.norm(a) * np.linalg.norm(x))),
        "eigh": _rel((v * w) @ v.T, spd),
        "eigh_orthonormal": _rel(v.T @ v, eye),
        "svd": _rel((u * s) @ vh, a),
        "qr": _rel(q @ r, a),
        "qr_orthonormal": _rel(q.T @ q, eye),
        "lu": _rel(p @ lf @ uf, a)},
        "eigenvalues": w, "singular_values": s}


def _case_matrices(n):
    rng = np.random.default_rng(CASE_SEED)
    a = rng.standard_normal((n, n))
    return a, a @ a.T / n + np.eye(n), rng.standard_normal((n, 4))


def float64_values(n, dtype):
    """numpy's float64 eigenvalues of S and singular values of A, the
    matrices of `decompositions(paddle, n, dtype)` rounded to `dtype`,
    each sorted as `decompositions` gives them."""
    a, spd, _ = (v.astype(dtype).astype(np.float64)
                 for v in _case_matrices(n))
    return {"eigenvalues": np.linalg.eigvalsh(spd),
            "singular_values": np.linalg.svd(a, compute_uv=False)}


ROUTE_ONE = {"flash_attention_fwd": 1, "flash_attention_dq": 1,
             "flash_attention_dkv": 1}


def _norm_rel(a, b):
    a, b = a.double(), b.double()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def _route_case(paddle, api, q, k, v, dout, sync, launches):
    """One causal attention call on fresh leaves over the torch tensors
    q, k, v ([B, S, H, D]) and its backward with `dout`; returns the
    output, the gradients stacked as qkv's, and the launches of each
    half."""
    import torch

    F = paddle.nn.functional
    qs = [paddle.Tensor(t, stop_gradient=False) for t in (q, k, v)]
    launches()
    if api == "qkvpacked":
        qkv = paddle.Tensor(torch.stack([q, k, v], dim=2),
                            stop_gradient=False)
        out, _ = F.flash_attn_qkvpacked(qkv, causal=True)
    elif api == "flash_attention":
        out, _ = F.flash_attention(*qs, causal=True)
    elif api == "masked":
        mask = torch.ones((q.shape[1], q.shape[1]), dtype=torch.bool,
                          device=q.device).tril()
        out = F.scaled_dot_product_attention(*qs,
                                             attn_mask=paddle.Tensor(mask))
    else:
        out = F.scaled_dot_product_attention(*qs, is_causal=True)
    sync()
    fwd = launches()
    out.backward(paddle.Tensor(dout))
    sync()
    bwd = launches()
    grads = qkv.grad._data if api == "qkvpacked" \
        else torch.stack([t.grad._data for t in qs], dim=2)
    return out._data.detach(), grads, fwd, bwd


def attention_routes(paddle, q, k, v, dout, sync, launches, mask_tol):
    """On CUDA tensors: `flash_attention` and `flash_attn_qkvpacked` give
    the outputs and gradients of `scaled_dot_product_attention`, bit for
    bit, each with one launch of the flash forward, dQ and dK/dV; a
    causal bool `attn_mask` takes the composite (no launch) within
    `mask_tol` norm-relative of the kernel. Raises on a failed gate;
    returns a report and the launches."""
    import torch

    ref_out, ref_grad, fwd, bwd = _route_case(paddle, "sdpa", q, k, v, dout,
                                              sync, launches)
    total = {n: fwd.get(n, 0) + bwd.get(n, 0) for n in ROUTE_ONE}
    if total != ROUTE_ONE:
        raise AssertionError(f"sdpa launches {fwd} {bwd}")
    report = {}
    for api in ("flash_attention", "qkvpacked"):
        out, grad, fwd, bwd = _route_case(paddle, api, q, k, v, dout, sync,
                                          launches)
        got = {n: fwd.get(n, 0) + bwd.get(n, 0) for n in ROUTE_ONE}
        if fwd != {"flash_attention_fwd": 1} or got != ROUTE_ONE:
            raise AssertionError(f"{api}: launches {fwd} {bwd}")
        if not torch.equal(out, ref_out) or not torch.equal(grad, ref_grad):
            raise AssertionError(f"{api}: not bit-equal to "
                                 f"scaled_dot_product_attention")
        report[api] = {"bit_equal": True, "forward": fwd, "backward": bwd}
        for n, c in got.items():
            total[n] += c
    out, grad, fwd, bwd = _route_case(paddle, "masked", q, k, v, dout, sync,
                                      launches)
    if fwd or bwd:
        raise AssertionError(f"masked sdpa launched {fwd} {bwd}")
    err = {"out": _norm_rel(out, ref_out), "grads": _norm_rel(grad,
                                                              ref_grad)}
    if not max(err.values()) <= mask_tol:
        raise AssertionError(f"masked sdpa off the kernel: {err}")
    report["masked_causal"] = {"launches": 0, "norm_rel": err,
                               "tol": mask_tol}
    return report, total


# ---- the training loop ------------------------------------------------------


def lr_at(step: int) -> float:
    """The schedule's closed form at scheduler step `step`: linear warm-up
    from 0 to BASE_LR over WARMUP steps, then the cosine from BASE_LR to 0
    over T_MAX steps."""
    if step < WARMUP:
        return BASE_LR * step / WARMUP
    return BASE_LR * (1 + math.cos(math.pi * (step - WARMUP) / T_MAX)) / 2


def decay_names(model):
    """PaddleNLP's Trainer rule: every parameter but biases and norms
    decays, named by `p.name`."""
    return {p.name for n, p in model.named_parameters()
            if not any(nd in n for nd in ("bias", "norm"))}


def build_optimizer(paddle, model, clip=None):
    """`(optimizer, scheduler)` as the Trainer builds them."""
    sched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(BASE_LR, T_max=T_MAX),
        warmup_steps=WARMUP, start_lr=0.0, end_lr=BASE_LR)
    names = decay_names(model)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(), beta2=0.95,
        weight_decay=0.01, multi_precision=True,
        apply_decay_param_fun=lambda n: n in names,
        grad_clip=clip if clip is not None
        else paddle.nn.ClipGradByGlobalNorm(1.0))
    return opt, sched


def _loss(paddle, logits, labels, vocab):
    return paddle.nn.functional.cross_entropy(
        logits.reshape([-1, vocab]).astype("float32"), labels.reshape([-1]),
        ignore_index=IGNORE)


def _host_norm(model):
    """The f32 global norm of the gradients, read on the host."""
    sq = 0.0
    for p in model.parameters():
        if p.grad is not None:
            g = p.grad.astype("float32").numpy().astype(np.float64)
            sq += float((g * g).sum())
    return math.sqrt(sq)


def tiny_loop(paddle, steps=3):
    """The Trainer's loop on `llama_tiny(seq=16)` (f32, `paddle.seed(7)`)
    over one batch of 2 x 16 ids from `default_rng(3)`, the last 4 labels
    of each row ignored."""
    paddle.seed(7)
    model = paddle.models.llama_layers.llama_tiny(seq=16) \
        if hasattr(paddle.models, "llama_layers") \
        else paddle.models.llama_tiny(seq=16)
    model.train()
    opt, sched = build_optimizer(paddle, model)
    rng = np.random.default_rng(3)
    vocab = model.config.vocab_size
    ids = rng.integers(0, vocab, (2, 16))
    labels = rng.integers(0, vocab, (2, 16))
    labels[:, -4:] = IGNORE
    ids, labels = paddle.to_tensor(ids), paddle.to_tensor(labels)
    out = {"losses": [], "norms": [], "lrs": []}
    for _ in range(steps):
        out["lrs"].append(opt.get_lr())
        loss = _loss(paddle, model(ids), labels, vocab)
        loss.backward()
        out["norms"].append(_host_norm(model))
        opt.step()
        opt.clear_grad()
        sched.step()
        out["losses"].append(float(loss.numpy()))
    out["params"] = {n: p.numpy() for n, p in model.named_parameters()}
    return out


_OPTIMIZERS = {
    "Adagrad": dict(learning_rate=0.1, epsilon=1e-6,
                    initial_accumulator_value=0.1),
    "Adadelta": dict(learning_rate=1.0, rho=0.9, epsilon=1e-6),
    "RMSProp": dict(learning_rate=0.01, rho=0.9, momentum=0.5,
                    centered=True),
    "Adamax": dict(learning_rate=0.01),
    "Lamb": dict(learning_rate=0.01, lamb_weight_decay=0.01),
    "NAdam": dict(learning_rate=0.01),
    "RAdam": dict(learning_rate=0.01),
    "LBFGS": dict(learning_rate=0.5, history_size=4),
}


def optimizer_cases(paddle, steps=2):
    """Each new optimizer `steps` steps on Linear(8, 16) -> tanh ->
    Linear(16, 4) (`paddle.seed(5)`) against a fixed target; the losses
    and the parameters after, by optimizer. Lamb excludes the biases from
    decay (`exclude_from_weight_decay_fn`)."""
    rng = np.random.default_rng(13)
    xs = rng.standard_normal((6, 8)).astype(np.float32)
    ys = rng.standard_normal((6, 4)).astype(np.float32)
    nn = paddle.nn
    out = {}
    for name, kw in _OPTIMIZERS.items():
        paddle.seed(5)
        model = nn.Sequential(nn.Linear(8, 16), nn.Tanh(), nn.Linear(16, 4))
        x, y = paddle.to_tensor(xs), paddle.to_tensor(ys)
        kw = dict(kw, parameters=model.parameters())
        if name == "Lamb":
            biases = {id(p) for n, p in model.named_parameters()
                      if n.endswith("bias")}
            kw["exclude_from_weight_decay_fn"] = lambda p: id(p) in biases
        opt = getattr(paddle.optimizer, name)(**kw)

        def closure():
            opt.clear_grad()
            loss = ((model(x) - y) ** 2).mean()
            loss.backward()
            return loss

        losses = []
        for _ in range(steps):
            if name == "LBFGS":
                loss = opt.step(closure)
            else:
                loss = closure()
                opt.step()
            losses.append(float(loss.numpy()))
        out[name] = {"losses": np.asarray(losses, np.float32),
                     "params": [p.numpy() for p in model.parameters()]}
    return out


def reference_run(paddle):
    """The `train_loop_reference` phase's body on the expected place."""
    return {"loop": tiny_loop(paddle), "optimizers": optimizer_cases(paddle)}


# ---- train_loop: Llama-2-7B width, eager and lazy -------------------------


def _recording_clip(paddle):
    base = paddle.nn.ClipGradByGlobalNorm

    class RecordingClip(base):
        """`ClipGradByGlobalNorm(1.0)` that keeps each call's global norm
        (a device scalar, never read inside a step) and, while
        `post_norms` is a list, the norm of what it returns; `events`, a
        pair of CUDA events, are recorded around each call."""

        def __init__(self):
            super().__init__(1.0)
            self.norms, self.post_norms, self.events = [], None, None

        def global_norm(self, grads):
            n = super().global_norm(grads)
            self.norms.append(n)
            return n

        def __call__(self, params_grads):
            if self.events is not None:
                self.events[0].record()
            out = super().__call__(params_grads)
            if self.events is not None:
                self.events[1].record()
            if self.post_norms is not None:
                self.post_norms.append(base.global_norm(self, [
                    g._data for _, g in out if g is not None]))
            return out

    return RecordingClip()


def loop_workload(paddle, seed=0, tiny=False):
    """`(model, opt, sched, clip, ids, labels)` on the expected place:
    Llama-2-7B width at LAYERS layers and one sequence of SEQ tokens, or
    with `tiny` (the CPU rehearsal) `llama_tiny(seq=16)` and 16 tokens,
    the last IGNORED (4) labels ignored."""
    paddle.seed(seed)
    layers = paddle.models.llama_layers
    model = layers.llama_tiny(seq=16) if tiny \
        else layers.llama_7b_shaped(num_layers=LAYERS)
    clip = _recording_clip(paddle)
    opt, sched = build_optimizer(paddle, model, clip)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    vocab, seq, ignored = (model.config.vocab_size, 16, 4) if tiny \
        else (VOCAB, SEQ, IGNORED)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (BATCH, seq))
    labels = rng.integers(0, vocab, (BATCH, seq))
    labels[:, -ignored:] = IGNORE
    return (model, opt, sched, clip, paddle.to_tensor(ids),
            paddle.to_tensor(labels))


def _step(paddle, model, opt, sched, ids, labels, events=None):
    with paddle.amp.auto_cast(level="O2"):
        logits = model(ids)
    loss = _loss(paddle, logits, labels, model.config.vocab_size)
    del logits
    loss.backward()
    if events is not None:
        events[0].record()
    opt.step()
    if events is not None:
        events[1].record()
    opt.clear_grad()
    sched.step()
    return loss


def run_loop(paddle, work, lazy_on, sync, launches, event=None, step=None):
    """`WARMUP_STEPS` + `TIMED_STEPS` steps of `work` (`loop_workload`),
    eagerly or under lazy mode; `step` replaces the Llama's step
    (`_step`'s signature) for another model. `sync()` waits for the card, `launches()`
    returns (and zeroes) the kernel launches since its last call, and
    `event()` makes a timing event (None: no events). Returns the losses,
    learning rates, pre-clip norms and warm-up post-clip norms (floats,
    read after the steps), the launches of the warm-up and of each timed
    step, the host ms
    (until the step returned) and wall ms (until the card finished) of
    each timed step, the clip's and the optimizer step's ms in each timed
    step, and the `lazy.*` counters of the warm-up, of the timed steps
    and of each timed step."""
    model, opt, sched, clip, ids, labels = work
    step = step or _step
    lazy = paddle.core.lazy
    monitor = paddle.framework.monitor
    losses, lrs, per_step, host_ms, wall_ms, spans = [], [], [], [], [], []
    step_counters = []
    prev = lazy.set_lazy_mode(lazy_on)
    try:
        c0 = monitor.snapshot("lazy.")
        clip.post_norms = []
        for _ in range(WARMUP_STEPS):
            lrs.append(opt.get_lr())
            losses.append(step(paddle, model, opt, sched, ids, labels)
                          .detach())
        post = clip.post_norms
        clip.post_norms = None
        sync()
        c1 = c_prev = monitor.snapshot("lazy.")
        warmup_launches = launches()
        for _ in range(TIMED_STEPS):
            ev = None if event is None else [event() for _ in range(4)]
            clip.events = None if ev is None else ev[2:]
            lrs.append(opt.get_lr())
            t0 = time.perf_counter()
            losses.append(step(paddle, model, opt, sched, ids, labels,
                               None if ev is None else ev[:2]).detach())
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            host_ms.append((t1 - t0) * 1e3)
            wall_ms.append((t2 - t0) * 1e3)
            per_step.append(launches())
            spans.append(ev)
            c = monitor.snapshot("lazy.")
            step_counters.append(_delta(c, c_prev))
            c_prev = c
        clip.events = None
        c2 = monitor.snapshot("lazy.")
    finally:
        lazy.set_lazy_mode(prev)
    clip_ms = [e[2].elapsed_time(e[3]) for e in spans if e is not None]
    opt_ms = [e[0].elapsed_time(e[1]) - c
              for e, c in zip([e for e in spans if e is not None], clip_ms)]
    return {"losses": [float(v.astype("float32").item()) for v in losses],
            "lrs": lrs, "norms": [float(n) for n in clip.norms],
            "post_norms": [float(n) for n in post], "launches": per_step,
            "warmup_launches": warmup_launches,
            "host_ms": host_ms, "wall_ms": wall_ms, "clip_ms": clip_ms,
            "opt_ms": opt_ms,
            "warmup_counters": _delta(c1, c0),
            "timed_counters": _delta(c2, c1), "step_counters": step_counters}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}
