"""Training through the port against the JAX package: the Llama forward
(logits and loss), the gradients of `loss.backward()`, remat, the model
FLOP count, AdamW step by step, and a 3-step training trajectory, all on
the CPU with the same numpy-made inputs and the same weights (carried
across with `from_jax_state`).

Tolerances (f32): logits 1e-5 and loss 1e-6 (two layers of f32 matmuls
summed in another order); every parameter's gradient within 1e-5 of its
largest magnitude; AdamW 1e-7 in f32 (the same operations in the same
order; only XLA's fusion may contract a multiply-add) and one bf16 ulp in
bf16; the trajectory 1e-5.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax.numpy as jnp

import paddle_tpu as paddle
from paddle_tpu.core.tensor import Tensor
from paddle_tpu.framework import flags
from paddle_tpu.jit.functional import state_arrays
from paddle_tpu.models import llama_tiny as jax_llama_tiny
from paddle_tpu.nn.parameter import Parameter as JaxParameter
from paddle_tpu.optimizer import AdamW as JaxAdamW
from paddle_tpu_torch import (LlamaConfig, LlamaInferenceEngine,
                              from_jax_state, llama_tiny)
from paddle_tpu_torch.ops.kernels import _support
from paddle_tpu_torch.optimizer import AdamW
from torch_threads import one_thread  # noqa: F401

VARIANTS = {"mha": {}, "gqa": {"num_key_value_heads": 2},
            "tied": {"tie_word_embeddings": True}}
B, S, V = 2, 64, 256


def _jax_model(seed, **kw):
    paddle.seed(seed)
    m = jax_llama_tiny(vocab=V, layers=2, hidden=64, heads=4, seq=S, **kw)
    # norms start at ones: perturb them so both norm roundings show
    rng = np.random.default_rng(seed)
    for name, p in m.named_parameters():
        if "norm" in name:
            p._data = jnp.asarray(
                1.0 + 0.1 * rng.normal(size=p.shape), jnp.float32)
    return m


def _port(m, model=None):
    state = {k: np.asarray(v) for k, v in state_arrays(m).items()}
    cfg = LlamaConfig(**dataclasses.asdict(m.config))
    return from_jax_state(state, cfg, device="cpu", model=model)


def _batch(seed):
    rng = np.random.default_rng(seed)
    ids = rng.integers(0, V, (B, S))
    labels = rng.integers(0, V, (B, S))
    labels[1, :5] = -100                    # ignore_index positions
    return ids, labels


@pytest.fixture(params=[False, True], ids=["plain", "interpret"])
def jax_kernels(request):
    """The JAX model with its Pallas kernels off (composites) or on
    (interpret mode)."""
    flags.set_flags({"pallas_interpret": request.param})
    yield request.param
    flags.set_flags({"pallas_interpret": False})


def _jax_loss_and_grads(m, ids, labels):
    loss, logits = m(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
    loss.backward()
    grads = {n: np.asarray(p.grad.numpy()) for n, p in m.named_parameters()}
    return float(loss), np.asarray(logits.numpy()), grads


def _port_loss_and_grads(tm, ids, labels):
    loss, logits = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in tm.named_parameters()}
    return float(loss.detach()), logits.detach().numpy(), grads


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_forward_loss_and_grads_match_jax(variant, jax_kernels):
    m = _jax_model(0, **VARIANTS[variant])
    tm = _port(m)
    assert all(p.requires_grad for p in tm.parameters())
    ids, labels = _batch(1)
    jl, jlogits, jgrads = _jax_loss_and_grads(m, ids, labels)
    _support.reset_launch_counts()
    tl, tlogits, tgrads = _port_loss_and_grads(tm, ids, labels)
    # CPU tensors take the plain versions: no kernel is launched
    assert all(c.count == 0 for c in _support._COUNTERS.values())
    np.testing.assert_allclose(tlogits, jlogits, atol=1e-5, rtol=1e-5)
    assert abs(tl - jl) <= 1e-6 * max(1.0, abs(jl))
    assert sorted(tgrads) == sorted(jgrads)
    for name, g in tgrads.items():
        scale = max(float(np.abs(jgrads[name]).max()), 1e-30)
        err = float(np.abs(g - jgrads[name]).max())
        assert err <= 1e-5 * scale, (name, err, scale)


def test_logits_without_labels_and_ignore_index():
    m = _jax_model(3)
    tm = _port(m)
    ids, labels = _batch(4)
    logits = tm(torch.from_numpy(ids))
    assert logits.shape == (B, S, V)
    labels[:] = -100
    labels[0, 0] = 7
    loss, _ = tm(torch.from_numpy(ids), labels=torch.from_numpy(labels))
    want = -torch.log_softmax(logits[0, 0], -1)[7]
    assert abs(float(loss) - float(want)) < 1e-5


def test_remat_gives_the_same_gradients():
    m = _jax_model(5, num_key_value_heads=2)
    ids, labels = _batch(6)
    grads = []
    for remat in (False, True):
        tm = _port(m)
        tm.llama.remat = remat
        grads.append(_port_loss_and_grads(tm, ids, labels)[2])
    for name in grads[0]:
        np.testing.assert_allclose(grads[1][name], grads[0][name], rtol=1e-7,
                                   atol=1e-9, err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
@pytest.mark.parametrize("seq", [64, 2048])
def test_flops_per_token_equals_jax(variant, seq):
    m = _jax_model(0, **VARIANTS[variant])
    assert _port(m).flops_per_token(seq) == m.flops_per_token(seq)


# -- AdamW -----------------------------------------------------------------

SHAPES = {"w_a": (16, 24), "w_b": (40,), "norm_c": (8, 8)}


def _params_and_grads(seed):
    rng = np.random.default_rng(seed)
    params = {n: (0.5 * rng.normal(size=s)).astype(np.float32)
              for n, s in SHAPES.items()}
    grads = [{n: rng.normal(size=s).astype(np.float32)
              for n, s in SHAPES.items()} for _ in range(3)]
    return params, grads


def _run_adamw(dtype, multi_precision, decay_fun, seed=7):
    """3 AdamW steps on both packages' parameters from the same numpy
    values and gradients; returns (jax params, port params, jax state,
    port state) as numpy. Each side gets its own copy of the values: on
    the CPU `jnp.asarray` of a numpy array may share the array's memory,
    as `torch.from_numpy` does, and the port's step writes its parameters
    in place."""
    params, grads = _params_and_grads(seed)
    jdt = {"float32": jnp.float32, "bfloat16": jnp.bfloat16}[dtype]
    tdt = getattr(torch, dtype)
    jp = {n: JaxParameter(jnp.array(a, copy=True).astype(jdt), name=n)
          for n, a in params.items()}
    tp = {}
    for n, a in params.items():
        tp[n] = torch.nn.Parameter(torch.tensor(a, dtype=tdt))
        tp[n].param_name = n
    kw = dict(learning_rate=1e-2, beta1=0.9, beta2=0.95, epsilon=1e-8,
              weight_decay=0.1, multi_precision=multi_precision,
              apply_decay_param_fun=decay_fun)
    jopt = JaxAdamW(parameters=list(jp.values()), **kw)
    topt = AdamW(parameters=list(tp.values()), **kw)
    for g in grads:
        for n in SHAPES:
            jp[n].grad = Tensor(jnp.asarray(g[n]).astype(jdt))
            tp[n].grad = torch.tensor(g[n], dtype=tdt)
        jopt.step()
        topt.step()
        jopt.clear_grad()
        topt.clear_grad()
        assert all(p.grad is None for p in tp.values())

    def f32(x):
        return np.asarray(jnp.asarray(x).astype(jnp.float32))

    jstate = {k: f32(v._data if isinstance(v, Tensor) else v)
              for k, v in jopt.state_dict().items()}
    tstate = {k: (v.float().numpy() if isinstance(v, torch.Tensor) else
                  np.asarray(v)) for k, v in topt.state_dict().items()}
    return ({n: f32(p._data) for n, p in jp.items()},
            {n: p.detach().float().numpy() for n, p in tp.items()},
            jstate, tstate)


@pytest.mark.parametrize("dtype,multi_precision", [
    ("float32", False), ("bfloat16", True), ("bfloat16", False)])
@pytest.mark.parametrize("decay", [None, "not_norm"])
def test_adamw_steps_match_jax(dtype, multi_precision, decay):
    fun = None if decay is None else (lambda n: "norm" not in n)
    jparams, tparams, jstate, tstate = _run_adamw(dtype, multi_precision,
                                                  fun)
    assert sorted(jstate) == sorted(tstate)
    if multi_precision:
        assert any(k.endswith("_master") for k in tstate)
    for n in SHAPES:
        want, got = jparams[n], tparams[n]
        if dtype == "float32":
            np.testing.assert_allclose(got, want, rtol=1e-7, atol=1e-7,
                                       err_msg=n)
        else:
            ulp = 2.0 ** (np.floor(np.log2(np.maximum(np.abs(want),
                                                      2.0 ** -126))) - 7)
            assert (np.abs(got - want) <= ulp).all(), n
    for k in jstate:
        np.testing.assert_allclose(tstate[k], jstate[k], rtol=1e-7,
                                   atol=1e-7, err_msg=k)


def test_adamw_decay_order_under_multi_precision():
    """Without `multi_precision` the bf16 decay `p * (1 - lr * wd)` at
    lr 3e-4, wd 0.1 rounds away; with it the f32 master carries it."""
    p = torch.nn.Parameter(torch.ones(4, dtype=torch.bfloat16))
    for mp in (False, True):
        q = torch.nn.Parameter(p.detach().clone())
        opt = AdamW(3e-4, 0.9, 0.95, 1e-8, parameters=[q], weight_decay=0.1,
                    multi_precision=mp)
        q.grad = torch.zeros_like(q)
        opt.step()
        sd = opt.state_dict()
        assert torch.equal(q.detach(), p.detach())
        if mp:
            master = sd["param_0_master"]
            assert master.dtype == torch.float32
            assert float(master[0]) == pytest.approx(1 - 3e-4 * 0.1,
                                                     abs=1e-7)


def test_adamw_get_set_lr_and_refusals():
    """A float learning rate is set and read back; an LRScheduler's is
    read from it and cannot be set; a clip runs inside the step; a
    SelectedRows gradient is clipped as the JAX package clips it (its
    merged rows' square sum in the global norm, its values scaled)."""
    from paddle_tpu.core.selected_rows import SelectedRows as JRows
    from paddle_tpu.nn import ClipGradByGlobalNorm as JClip
    from paddle_tpu_torch.core.selected_rows import SelectedRows
    from paddle_tpu_torch.nn import ClipGradByGlobalNorm
    from paddle_tpu_torch.optimizer.lr import StepDecay

    p = torch.nn.Parameter(torch.zeros(3))
    opt = AdamW(0.5, parameters=[p])
    assert opt.get_lr() == 0.5
    opt.set_lr(0.25)
    assert opt.get_lr() == 0.25
    sched = StepDecay(0.1, step_size=1, gamma=0.5)
    opt = AdamW(sched, parameters=[p], weight_decay=0.0,
                grad_clip=ClipGradByGlobalNorm(1.0))
    assert opt.get_lr() == 0.1
    sched.step()
    assert opt.get_lr() == 0.05
    with pytest.raises(RuntimeError, match="LRScheduler"):
        opt.set_lr(0.2)
    p.grad = torch.full((3,), 10.0)
    opt.step()
    assert torch.isfinite(p).all() and (p < 0).all()

    rows = np.array([2, 0, 2], np.int32)
    vals = np.random.default_rng(0).standard_normal((3, 4)).astype(
        np.float32)
    (_, got), = ClipGradByGlobalNorm(1.0)(
        [(p, SelectedRows(torch.from_numpy(rows), torch.from_numpy(vals),
                          5))])
    (_, want), = JClip(1.0)([(p, JRows(jnp.asarray(rows),
                                       jnp.asarray(vals), 5))])
    np.testing.assert_array_equal(got.rows.numpy(), np.asarray(want.rows))
    np.testing.assert_allclose(got.values.numpy(), np.asarray(want.values),
                               rtol=1e-6, atol=1e-7)


def test_functional_options_not_ported_raise():
    """The options the model does not call now run on plain tensors too:
    the sum and unreduced cross entropy agree with the mean, and a masked
    attention with a causal bool mask equals the causal attention."""
    from paddle_tpu_torch.nn.functional import (cross_entropy,
                                                scaled_dot_product_attention)

    logits = torch.zeros((2, 3, 5))
    label = torch.zeros((2, 3), dtype=torch.int64)
    assert float(cross_entropy(logits, label)) == pytest.approx(np.log(5))
    assert float(cross_entropy(logits, label, reduction="sum")) \
        == pytest.approx(6 * np.log(5))
    assert tuple(cross_entropy(logits, label, reduction="none").shape) \
        == (2, 3)
    q = torch.randn((1, 4, 2, 16))
    masked = scaled_dot_product_attention(q, q, q, attn_mask=torch.ones(
        (4, 4), dtype=torch.bool).tril())
    torch.testing.assert_close(masked, scaled_dot_product_attention(
        q, q, q, is_causal=True))


def test_adamw_state_dict_round_trip():
    _jp, _tp, _js, tstate = _run_adamw("bfloat16", True, None)
    p = {n: torch.nn.Parameter(torch.zeros(s, dtype=torch.bfloat16))
         for n, s in SHAPES.items()}
    for n, t in p.items():
        t.param_name = n
    opt = AdamW(parameters=list(p.values()), multi_precision=True)
    opt.set_state_dict({k: (torch.from_numpy(v) if k != "global_step"
                            else int(v)) for k, v in tstate.items()})
    sd = opt.state_dict()
    assert sorted(sd) == sorted(tstate) and sd["global_step"] == 3
    for k, v in sd.items():
        if k != "global_step":
            np.testing.assert_array_equal(v.float().numpy(), tstate[k])


# -- the whole loop ----------------------------------------------------------

@pytest.mark.parametrize("interpret", [False, True],
                         ids=["plain", "interpret"])
def test_three_step_trajectory_matches_jax_eager(interpret):
    """`loss.backward(); opt.step(); opt.clear_grad()` three times on both
    packages at lr 1e-2 (JAX with its kernels off, and on in interpret
    mode): losses within 1e-5, parameters within 1e-5.

    Adam divides each gradient element by its own running RMS, so its
    update carries the gradient element's RELATIVE error times lr. The
    gradients agree within 1e-5 of their tensor's largest (the test
    above), which for an element of gradient g is a relative error up to
    r = 1e-5 * max|g| / |g|; an element is therefore held to
    1e-5 + 3 steps * lr * min(1, r), and at most one element in ten
    thousand may be off by more than 1e-5."""
    flags.set_flags({"pallas_interpret": interpret})
    try:
        m = _jax_model(8, num_key_value_heads=2)
        tm = _port(m)
        kw = dict(learning_rate=1e-2, beta1=0.9, beta2=0.95, epsilon=1e-8,
                  weight_decay=0.1)
        jopt = JaxAdamW(parameters=m.parameters(), **kw)
        topt = AdamW(parameters=tm.parameters(), **kw)
        ids, labels = _batch(9)
        losses = []
        rel = {n: np.zeros(p.shape) for n, p in m.named_parameters()}
        for _ in range(3):
            jl, _ = m(paddle.to_tensor(ids), labels=paddle.to_tensor(labels))
            jl.backward()
            for n, p in m.named_parameters():
                g = np.abs(np.asarray(p.grad.numpy(), np.float64))
                rel[n] = np.maximum(rel[n], np.minimum(
                    1.0, 1e-5 * g.max() / np.maximum(g, 1e-30)))
            jopt.step()
            jopt.clear_grad()
            tl, _ = tm(torch.from_numpy(ids),
                       labels=torch.from_numpy(labels))
            tl.backward()
            topt.step()
            topt.clear_grad()
            losses.append((float(jl), float(tl)))
    finally:
        flags.set_flags({"pallas_interpret": False})
    for jl, tl in losses:
        assert abs(jl - tl) <= 1e-5
    assert losses[-1][1] < losses[0][1]
    tparams = dict(tm.named_parameters())
    n_loose = n_all = 0
    for name, p in m.named_parameters():
        want = np.asarray(p.numpy())
        err = np.abs(tparams[name].detach().numpy() - want)
        tol = 1e-5 + 3 * kw["learning_rate"] * rel[name]
        assert (err <= tol).all(), (name, float(err.max()))
        n_loose += int((err > 1e-5).sum())
        n_all += want.size
    assert n_loose <= 1e-4 * n_all, (n_loose, n_all)


def test_serving_a_trained_model():
    """One set of JAX weights goes into a trainer and, through
    `from_jax_state(model=...)`, into an existing model; an engine built
    from a trainable model holds no graph, and training the model after
    the engine is built is what the engine serves only if it shares the
    weights (same device and dtype), never through autograd."""
    m = _jax_model(10)
    trainer = _port(m)
    frozen = llama_tiny(vocab=V, layers=2, hidden=64, heads=4, seq=S,
                        device="cpu")
    _port(m, model=frozen)
    for (n, a), (_, b) in zip(trainer.named_parameters(),
                              frozen.named_parameters()):
        assert torch.equal(a, b), n
    geo = dict(max_batch_size=2, num_blocks=16, block_size=4,
               max_blocks_per_seq=8, device="cpu")
    engine = LlamaInferenceEngine(trainer, **geo)
    tables = np.zeros((2, 8), np.int32)
    tables[0, :3] = [1, 2, 3]
    tokens = np.zeros((12,), np.int32)
    tokens[:9] = np.arange(1, 10)
    out = engine.ragged_step(tokens, [9, 0], [9, 0], tables)
    assert not out.requires_grad and out.grad_fn is None
    ref = LlamaInferenceEngine(frozen, **geo).ragged_step(
        tokens, [9, 0], [9, 0], tables)
    torch.testing.assert_close(out, ref, rtol=0, atol=0)
