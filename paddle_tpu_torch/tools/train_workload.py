"""The training workload of the port's main path, in one place: both
`chip_smoke.py` (which times it) and `paddle_tpu_torch.tools.train_profile`
(which profiles it) build and time it here, so the two always measure the
same thing.

It follows `bench.py`'s `train_mfu` step: Llama-2-7B width (vocab 32000,
hidden 4096, intermediate 11008, 32 heads of 128, MHA, untied head) at 8 of
its 32 layers, bf16 parameters drawn normal(0, 0.02) from a seeded
`torch.Generator` on the card, sequence 2048, batch 4, one fixed batch of
ids and labels from `numpy.random.default_rng(0)` reused every step, and
`AdamW(learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
weight_decay=0.1, multi_precision=True)`. A step is the paddle idiom:
`loss, _ = model(ids, labels=labels); loss.backward(); opt.step();
opt.clear_grad()`.
"""
from __future__ import annotations

import time

import numpy as np
import torch

LAYERS, BATCH, SEQ, VOCAB = 8, 4, 2048, 32000
TOKENS = BATCH * SEQ
# untimed steps before the timed ones, and the timed ones
WARMUP_STEPS, TIMED_STEPS = 2, 5
ADAMW = dict(learning_rate=3e-4, beta1=0.9, beta2=0.95, epsilon=1e-8,
             weight_decay=0.1, multi_precision=True)
SPLIT = ("forward", "backward", "optimizer")


def train_workload(device="cuda"):
    """Build `(model, optimizer, ids, labels)` on `device`."""
    from .. import llama_7b_shaped
    from ..optimizer import AdamW

    model = llama_7b_shaped(num_layers=LAYERS, device=device,
                            dtype=torch.bfloat16,
                            generator=torch.Generator(
                                device=device).manual_seed(0))
    opt = AdamW(parameters=model.parameters(), **ADAMW)
    rng = np.random.default_rng(0)
    ids = torch.from_numpy(rng.integers(0, VOCAB, (BATCH, SEQ))).to(device)
    labels = torch.from_numpy(rng.integers(0, VOCAB, (BATCH, SEQ))).to(device)
    return model, opt, ids, labels


def train_step(model, opt, ids, labels, marks=None):
    """One training step; returns the loss (a device scalar). `marks`, a
    list of three `torch.cuda.Event`s, records the ends of the forward, the
    backward and the optimizer step."""
    loss, _logits = model(ids, labels=labels)
    del _logits
    if marks:
        marks[0].record()
    loss.backward()
    if marks:
        marks[1].record()
    opt.step()
    opt.clear_grad()
    if marks:
        marks[2].record()
    return loss.detach()


def timed_steps(model, opt, ids, labels):
    """`TIMED_STEPS` steps, each synchronised: -> (losses, wall ms per step,
    and per step the {forward, backward, optimizer} ms from CUDA events)."""
    losses, walls, splits = [], [], []
    for _ in range(TIMED_STEPS):
        ev = [torch.cuda.Event(enable_timing=True) for _ in range(4)]
        t0 = time.perf_counter()
        ev[0].record()
        losses.append(train_step(model, opt, ids, labels, marks=ev[1:]))
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
        splits.append({name: ev[i].elapsed_time(ev[i + 1])
                       for i, name in enumerate(SPLIT)})
    return losses, walls, splits
