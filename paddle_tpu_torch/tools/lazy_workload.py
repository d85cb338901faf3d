"""The workloads of lazy mode and AMP, in one place for `chip_smoke.py`
(its `lazy_reference` and `lazy_llama` phases) and the tests that
rehearse them on the CPU.

- `tiny_llama_steps(paddle, lazy_on)`: the JAX package's `llama_tiny`
  written in paddle Layers (f32, `paddle.seed(7)`, sequence 16), two
  AdamW steps on a fixed batch, eagerly or under `lazy_guard()`; returns
  the losses, the first step's gradients and the parameters after, by
  name, and the `lazy.*` counters the run moved.
- `amp_cases(paddle)`: AMP on a small model: an O1 matmul and a
  black-listed softmax, an O2 `decorate` + `auto_cast` step with the
  optimizer's float32 masters, and a `GradScaler` step that finds an inf
  and skips (the scale halves, the weights stay).
- `reference_run(paddle)`: both, over either package's `paddle` on the
  expected place; the smoke run holds the card's run to the CPU's.
- `llama_workload(paddle)` / `train_step` / `run_steps`: the
  `lazy_llama` phase: Llama-2-7B width (vocab 32000, hidden 4096,
  intermediate 11008, 32 heads of 128) at `LAYERS` of its 32 layers as
  paddle Layers, bf16 by `amp.decorate(level="O2")` with the forward
  under `amp.auto_cast(level="O2")`, the train workload's AdamW
  (`multi_precision=True`) and loss (the mean cross entropy over the
  tokens, taken outside the guard on the logits cast to float32, as
  paddle's AMP recipes take it), one sequence of `SEQ` tokens from
  `numpy.random.default_rng(0)`; `WARMUP_STEPS` untimed and
  `TIMED_STEPS` timed steps, eagerly or under `lazy_guard()`.
"""
from __future__ import annotations

import time

import numpy as np

from .train_workload import ADAMW

__all__ = ["tiny_llama_steps", "amp_cases", "reference_run",
           "llama_workload", "train_step", "run_steps", "LAYERS", "BATCH",
           "SEQ", "VOCAB", "WARMUP_STEPS", "TIMED_STEPS"]

LAYERS, BATCH, SEQ, VOCAB = 4, 1, 2048, 32000
WARMUP_STEPS, TIMED_STEPS = 2, 3


def _lazy_counters(paddle):
    return {k: v for k, v in paddle.framework.monitor.snapshot(
        "lazy.").items()}


def _delta(after, before):
    return {k: v - before.get(k, 0) for k, v in after.items()
            if v != before.get(k, 0)}


def _models(paddle):
    """The Llama-in-Layers module of either package."""
    if hasattr(paddle, "models") and hasattr(paddle.models, "llama_layers"):
        return paddle.models.llama_layers
    return paddle.models


def tiny_llama_steps(paddle, lazy_on, steps=2, state=None):
    """`llama_tiny(seq=16)` from `paddle.seed(7)` (or from `state`, name ->
    numpy array), `steps` AdamW(1e-3) steps on one batch of 2 x 16 ids and
    labels from `default_rng(3)`."""
    paddle.seed(7)
    model = _models(paddle).llama_tiny(seq=16)
    if state is not None:
        model.set_state_dict(state)
    model.train()
    opt = paddle.optimizer.AdamW(learning_rate=1e-3,
                                 parameters=model.parameters())
    rng = np.random.default_rng(3)
    vocab = model.config.vocab_size
    ids = paddle.to_tensor(rng.integers(0, vocab, (2, 16)))
    labels = paddle.to_tensor(rng.integers(0, vocab, (2, 16)))
    names = [n for n, _ in model.named_parameters()]
    paddle.framework.monitor.reset("lazy.max_region_ops")
    before = _lazy_counters(paddle)
    losses, grads = [], None
    prev = paddle.core.lazy.set_lazy_mode(lazy_on)
    try:
        for _ in range(steps):
            loss, _logits = model(ids, labels=labels)
            loss.backward()
            if grads is None:
                grads = {n: p.grad.numpy().copy()
                         for n, p in zip(names, model.parameters())
                         if p.grad is not None}
            opt.step()
            opt.clear_grad()
            losses.append(np.asarray(loss.numpy(), np.float32))
    finally:
        paddle.core.lazy.set_lazy_mode(prev)
    params = {n: p.numpy() for n, p in zip(names, model.parameters())}
    return {"losses": np.stack(losses), "grads": grads, "params": params,
            "counters": _delta(_lazy_counters(paddle), before)}


def _f32(t):
    return np.asarray(t.astype("float32").numpy(), np.float32)


def amp_cases(paddle):
    """AMP's O1 / O2 rules and a GradScaler skip on a small model; every
    float result as float32 numpy, dtypes as names."""
    nn, amp = paddle.nn, paddle.amp
    out = {}
    rng = np.random.default_rng(11)
    x = paddle.to_tensor(rng.standard_normal((4, 8)).astype(np.float32))
    w = paddle.to_tensor(rng.standard_normal((8, 8)).astype(np.float32))
    with amp.auto_cast(level="O1"):
        h = paddle.matmul(x, w)
        s = nn.functional.softmax(h)
    out["o1_matmul_dtype"] = h.dtype.name
    out["o1_softmax_dtype"] = s.dtype.name
    out["o1_softmax"] = _f32(s)

    paddle.seed(5)
    model = nn.Sequential(nn.Linear(8, 16), nn.RMSNorm(16), nn.Linear(16, 4))
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=model.parameters())
    model, opt = amp.decorate(model, opt, level="O2", dtype="bfloat16")
    out["o2_param_dtypes"] = [p.dtype.name for p in model.parameters()]
    with amp.auto_cast(level="O2"):
        loss = (model(x).astype("float32") ** 2).mean()
    loss.backward()
    opt.step()
    opt.clear_grad()
    out["o2_loss"] = _f32(loss)
    out["o2_params"] = [_f32(p) for p in model.parameters()]

    lin = nn.Linear(8, 4)
    sgd = paddle.optimizer.SGD(learning_rate=0.1,
                               parameters=lin.parameters())
    scaler = amp.GradScaler(init_loss_scaling=1024.0)
    with amp.auto_cast(level="O1"):
        loss = lin(x).astype("float32").sum()
    scaler.scale(loss).backward()
    scaler.step(sgd)
    scaler.update()
    sgd.clear_grad()
    out["scaled_step_weight"] = _f32(lin.weight)
    bad = paddle.to_tensor(np.full((1, 8), np.inf, np.float32))
    before = _f32(lin.weight)
    scaler.scale(lin(bad).sum()).backward()
    scaler.step(sgd)
    scaler.update()
    sgd.clear_grad()
    out["inf_step_skipped"] = bool(np.array_equal(before, _f32(lin.weight)))
    out["scale_after_inf"] = float(scaler.get_loss_scaling())
    return out


def reference_run(paddle, state=None):
    """The `lazy_reference` phase's body on the expected place."""
    res = {}
    for mode in ("eager", "lazy"):
        r = tiny_llama_steps(paddle, mode == "lazy", state=state)
        res[mode] = r
    res["amp"] = amp_cases(paddle)
    return res


# ---- lazy_llama: Llama-2-7B width in paddle Layers, eager and lazy ----


def llama_workload(paddle, seed=0):
    """`(model, opt, ids, labels)` on the expected place."""
    paddle.seed(seed)
    model = _models(paddle).llama_7b_shaped(num_layers=LAYERS)
    opt = paddle.optimizer.AdamW(parameters=model.parameters(), **ADAMW)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    rng = np.random.default_rng(0)
    ids = paddle.to_tensor(rng.integers(0, VOCAB, (BATCH, SEQ)))
    labels = paddle.to_tensor(rng.integers(0, VOCAB, (BATCH, SEQ)))
    return model, opt, ids, labels


def train_step(paddle, model, opt, ids, labels, keep_grads=None):
    """One O2 step; returns the loss Tensor. `keep_grads`, a dict, gets a
    copy of every gradient before the update."""
    with paddle.amp.auto_cast(level="O2"):
        logits = model(ids)
    loss = paddle.nn.functional.cross_entropy(
        logits.reshape([-1, VOCAB]).astype("float32"), labels.reshape([-1]))
    del logits
    loss.backward()
    if keep_grads is not None:
        for n, p in model.named_parameters():
            keep_grads[n] = p.grad._data.clone()
    opt.step()
    opt.clear_grad()
    return loss


def run_steps(paddle, model, opt, ids, labels, lazy_on, sync, launches):
    """`WARMUP_STEPS` + `TIMED_STEPS` steps, eagerly or under lazy mode.
    `sync()` waits for the card; `launches()` returns (and zeroes) the
    kernel launches since its last call. Returns the losses, the first
    step's gradients, the launches of the warm-up and of each timed
    step, the host ms
    (until the step returned) and wall ms (until the card finished) of
    each timed step, and the `lazy.*` counters of the warm-up and of the
    timed steps."""
    lazy = paddle.core.lazy
    grads = {}
    losses, per_step, host_ms, wall_ms = [], [], [], []
    prev = lazy.set_lazy_mode(lazy_on)
    try:
        c0 = _lazy_counters(paddle)
        for i in range(WARMUP_STEPS):
            losses.append(train_step(paddle, model, opt, ids, labels,
                                     grads if i == 0 else None).detach())
        sync()
        c1 = _lazy_counters(paddle)
        warmup_launches = launches()
        for _ in range(TIMED_STEPS):
            t0 = time.perf_counter()
            losses.append(train_step(paddle, model, opt, ids, labels)
                          .detach())
            t1 = time.perf_counter()
            sync()
            t2 = time.perf_counter()
            host_ms.append((t1 - t0) * 1e3)
            wall_ms.append((t2 - t0) * 1e3)
            per_step.append(launches())
        c2 = _lazy_counters(paddle)
    finally:
        lazy.set_lazy_mode(prev)
    return {"losses": [float(v.astype("float32").item()) for v in losses],
            "grads": grads, "launches": per_step,
            "warmup_launches": warmup_launches, "host_ms": host_ms,
            "wall_ms": wall_ms, "warmup_counters": _delta(c1, c0),
            "timed_counters": _delta(c2, c1)}
