"""FNet through `paddle.fft` (`tools/fnet_workload.py`) in the port against
the JAX package's traced path. `fnet_tiny` (2 layers, hidden 64,
intermediate 128, B 2 x S 32, f32) is built in both packages from one
state (`convert.layers_from_jax_state`). The JAX package's eager
`paddle.fft` stops gradient (the closed divergence of ROADMAP Queue C),
so its loss and gradients come from `jit.functional.functional_call`
under `jax.value_and_grad`, the path on which JAX trains such a model.

- Dropout off: the loss and every parameter's gradient within 1e-5
  (float32, norm-relative).
- Dropout on: the dropout masks at FNet's rate are JAX's bit for bit;
  the port's two AdamW steps (`tiny_steps`) are rehearsed against a run
  of the same optimizer whose gradients come from JAX's traced path, its
  parameters loaded into the JAX model before each step and the
  generator at the same key: the losses within 1e-5 and every parameter
  after the steps within 1e-5 norm-relative. The card is held to the CPU
  by `chip_smoke.py`'s `fnet_reference`.
"""
import jax
import numpy as np
import pytest
import torch

import paddle_tpu as jpaddle
import paddle_tpu_torch as tpaddle
from paddle_tpu.jit.functional import functional_call, state_arrays
from paddle_tpu_torch.convert import layers_from_jax_state
from paddle_tpu_torch.tools import encoder_workload as ew
from paddle_tpu_torch.tools import fnet_workload as fw

from torch_eager_common import port_on_cpu  # noqa: F401
from torch_threads import one_thread  # noqa: F401

TOL = 1e-5
VOCAB = fw.CONFIGS["fnet_tiny"]["vocab"]
_RUNS = {}


def _norm_rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / max(np.linalg.norm(b), 1e-30))


def _models():
    """The JAX model (from its seed), its state, and the port's model
    from that state, built once a module."""
    if not _RUNS:
        jpaddle.seed(fw.SEED)
        jm = fw.build(jpaddle, "fnet_tiny")
        state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
        tpaddle.seed(fw.SEED)
        tm = layers_from_jax_state(state, fw.build(tpaddle, "fnet_tiny"))
        _RUNS.update(jm=jm, state=state, tm=tm)
    return _RUNS["jm"], _RUNS["state"], _RUNS["tm"]


def _jax_traced(jm, params):
    """(loss, {name: gradient}) of `jm` at `params` on the tiny batch,
    from `functional_call` under `jax.value_and_grad`."""
    inputs, labels = fw.tiny_inputs(jpaddle)

    def loss_fn(p):
        logits = functional_call(jm, p, *inputs)
        return ew.loss_of(jpaddle, logits, labels, VOCAB)._data

    loss, grads = jax.value_and_grad(loss_fn)(params)
    return float(loss), {n: np.asarray(g) for n, g in grads.items()}


def test_dropout_off_loss_and_every_gradient():
    jm, state, tm = _models()
    jm.eval()
    tm.eval()
    try:
        want_loss, want = _jax_traced(jm, state_arrays(jm))
        inputs, labels = fw.tiny_inputs(tpaddle)
        loss = ew.loss_of(tpaddle, tm(*inputs), labels, VOCAB)
        loss.backward()
        got = {n: p.grad.numpy() for n, p in tm.named_parameters()}
        tm.clear_gradients()
    finally:
        jm.train()
        tm.train()
    np.testing.assert_allclose(float(loss.numpy()), want_loss, rtol=TOL)
    assert set(got) == set(want)
    worst = {n: _norm_rel(got[n], w) for n, w in want.items()}
    assert max(worst.values()) <= TOL, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]


def test_dropout_masks_bit_equal():
    out = []
    for p in (jpaddle, tpaddle):
        p.seed(fw.SEED + 2)
        out.append(np.asarray(p.nn.functional.dropout(
            p.ones([fw.TINY_BATCH, fw.TINY_SEQ, 64]), 0.1).numpy()))
    np.testing.assert_array_equal(out[1], out[0])


def test_two_adamw_steps_rehearsed_on_jax_gradients():
    jm, state, _ = _models()
    got = fw.tiny_steps(tpaddle, state=state)
    # the rehearsal: the port's AdamW fed JAX's traced gradients
    tpaddle.seed(fw.SEED)
    rm = layers_from_jax_state(state, fw.build(tpaddle, "fnet_tiny"))
    opt, sched = ew.build_optimizer(tpaddle, rm)
    jpaddle.seed(fw.SEED + 1)
    losses, lrs = [], []
    for _ in range(2):
        params = {n: jax.numpy.asarray(p.numpy())
                  for n, p in rm.named_parameters()}
        loss, grads = _jax_traced(jm, params)
        for n, p in rm.named_parameters():
            p._data.grad = torch.from_numpy(grads[n].copy())
        lrs.append(opt.get_lr())
        opt.step()
        opt.clear_grad()
        sched.step()
        losses.append(loss)
    assert got["lrs"] == lrs
    np.testing.assert_allclose(got["losses"], losses, rtol=TOL)
    worst = {n: _norm_rel(got["params"][n], p.numpy())
             for n, p in rm.named_parameters()}
    assert max(worst.values()) <= TOL, sorted(worst.items(),
                                              key=lambda kv: -kv[1])[:3]


def test_fnet_train_loop_rehearsed_on_the_cpu():
    """The smoke run's `fnet_train` loop (O2 bf16, recording clip, warm-up
    and timed steps) on `fnet_tiny`, eagerly and under lazy mode: finite
    losses, the schedule's learning rates, lazy losses and pre-clip norms
    bit-equal to eager."""
    runs = {}
    for lazy in (False, True):
        work = fw.fnet_workload(tpaddle, "fnet_tiny", fw.TINY_BATCH,
                                fw.TINY_SEQ)
        runs[lazy] = fw.run_fnet(tpaddle, work, lazy, lambda: None,
                                 lambda: {})
    eager, lz = runs[False], runs[True]
    assert all(np.isfinite(eager["losses"]))
    assert all(abs(a - fw.lr_at(i)) <= 1e-12
               for i, a in enumerate(eager["lrs"]))
    assert lz["losses"] == eager["losses"] and lz["norms"] == eager["norms"]


@pytest.mark.parametrize("lazy", [False, True])
def test_reference_run_finite_and_lazy_equal(lazy):
    """The smoke run's `fnet_reference` body on the CPU, eagerly and
    under lazy mode (which records the transforms): finite, and the lazy
    run equal to the eager one."""
    from paddle_tpu_torch.core import lazy as lazy_mod

    eager = fw.reference_run(tpaddle)
    prev = lazy_mod.set_lazy_mode(lazy)
    try:
        run = fw.reference_run(tpaddle)
    finally:
        lazy_mod.set_lazy_mode(prev)
    assert all(np.isfinite(v) for v in run["fnet"]["losses"])
    np.testing.assert_array_equal(run["masks"]["dropout"],
                                  eager["masks"]["dropout"])
    np.testing.assert_allclose(run["fnet"]["losses"],
                               eager["fnet"]["losses"], rtol=1e-6)
    for n, w in eager["fnet"]["params"].items():
        assert _norm_rel(run["fnet"]["params"][n], w) <= 1e-6, n
