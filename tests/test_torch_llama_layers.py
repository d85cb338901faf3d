"""The JAX package's Llama in paddle Layers (`paddle_tpu_torch/models/
llama_layers.py`) against `paddle_tpu/models/llama.py`: the cases of
`tests/test_llama.py:19-123` (forward shapes, GQA, loss and gradients,
causality, KV-cache decode, the rotary op, `functional_call` and its
gradient) on both packages, the port's model holding the JAX model's
weights (`convert.layers_from_jax_state`), with f32 results within
rtol 1e-5 / atol 1e-5 (2e-5 for the decode step, as the JAX test). Then
the carriers of those weights: `paddle.load` of a JAX checkpoint, and
`convert.from_jax_state` into the `nn.Module` Llama, which gives the same
loss and gradients as the Layer model; tied embeddings; and
`flops_per_token`. The graft cases (`test_llama.py:125-139`) wait for
the pipeline engine (Queue A item 5)."""
import numpy as np
import pytest
import torch

from torch_eager_common import (fresh, jpaddle, port_on_cpu,  # noqa: F401
                                tpaddle)

from paddle_tpu_torch.convert import from_jax_state, layers_from_jax_state
from paddle_tpu_torch.models import llama_layers as tl
from torch_threads import one_thread  # noqa: F401

TOL = dict(rtol=1e-5, atol=1e-5)
# one tiny configuration for most cases: the JAX package compiles each
# op once per shape, so shared shapes keep the file quick
TINY = dict(vocab=60, layers=2, hidden=32, heads=4, seq=16)
V = TINY["vocab"]


def _pair(make, seed=0):
    """(JAX model, port model) over the same weights: the JAX model from
    `paddle.seed(seed)`, its state carried into the port's."""
    jpaddle.seed(seed)
    jm = make(jpaddle.models)
    state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
    tpaddle.seed(seed)
    tm = layers_from_jax_state(state, make(tl))
    return jm, tm, state


def _ids(shape, hi, seed=0):
    return np.random.default_rng(seed).integers(0, hi, shape)


def _both(jm, tm, fn):
    return fn(jpaddle, jm), fn(tpaddle, tm)


def test_parameter_names_and_shapes_match():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    assert [(n, p.shape) for n, p in jm.named_parameters()] \
        == [(n, p.shape) for n, p in tm.named_parameters()]
    assert [n for n, _ in jm.named_buffers()] \
        == [n for n, _ in tm.named_buffers()]
    assert set(jm.state_dict()) == set(tm.state_dict())


def test_initial_weights_from_one_seed_are_the_jax_packages():
    jpaddle.seed(3)
    jm = jpaddle.models.llama_tiny(**TINY)
    tpaddle.seed(3)
    tm = tl.llama_tiny(**TINY)
    for (n, a), (_, b) in zip(jm.named_parameters(), tm.named_parameters()):
        np.testing.assert_array_equal(b.numpy(), a.numpy(), err_msg=n)


def test_forward_shapes():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    ids = _ids((2, 16), V)
    a, b = _both(jm, tm, lambda p, m: m(p.to_tensor(fresh(ids))))
    assert b.shape == [2, 16, V]
    np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def _gqa_config(paddle_models):
    return paddle_models.LlamaConfig(
        vocab_size=50, hidden_size=32, intermediate_size=64,
        num_hidden_layers=1, num_attention_heads=4, num_key_value_heads=2,
        max_position_embeddings=16)


def test_gqa():
    jm, tm, _ = _pair(lambda m: m.LlamaForCausalLM(_gqa_config(m)))
    ids = _ids((1, 8), 50, 1)
    a, b = _both(jm, tm, lambda p, m: m(p.to_tensor(fresh(ids))))
    assert b.shape == [1, 8, 50]
    assert tm.llama.layers[0].self_attn.k_proj.weight.shape == [32, 16]
    np.testing.assert_allclose(b.numpy(), a.numpy(), **TOL)


def _loss_and_grads(paddle, m, ids, labels):
    loss, logits = m(paddle.to_tensor(fresh(ids)),
                     labels=paddle.to_tensor(fresh(labels)))
    loss.backward()
    grads = {n: p.grad.numpy() for n, p in m.named_parameters()}
    return float(loss), logits.numpy(), loss.shape, grads


def test_loss_and_grads():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    ids, labels = _ids((2, 16), V, 2), _ids((2, 16), V, 3)
    (la, lga, sa, ga), (lb, lgb, sb, gb) = _both(
        jm, tm, lambda p, m: _loss_and_grads(p, m, ids, labels))
    assert sb == [] and np.isfinite(lb) and lb < 10
    np.testing.assert_allclose(lb, la, **TOL)
    np.testing.assert_allclose(lgb, lga, **TOL)
    assert set(gb) == set(ga)
    for n in ga:
        np.testing.assert_allclose(gb[n], ga[n], rtol=1e-4, atol=1e-6,
                                   err_msg=n)


def test_causality():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    jm.eval()
    tm.eval()
    a = _ids((2, 16), V, 4)
    b = a.copy()
    b[0, -1] = (b[0, -1] + 1) % V
    for paddle, m in ((jpaddle, jm), (tpaddle, tm)):
        la = m(paddle.to_tensor(fresh(a))).numpy()
        lb = m(paddle.to_tensor(fresh(b))).numpy()
        np.testing.assert_allclose(la[0, :-1], lb[0, :-1], atol=1e-5)
        assert not np.allclose(la[0, -1], lb[0, -1])
    np.testing.assert_allclose(tm(tpaddle.to_tensor(fresh(b))).numpy(),
                               jm(jpaddle.to_tensor(fresh(b))).numpy(), **TOL)


def _decode(paddle, m, ids):
    full = m(paddle.to_tensor(fresh(ids))).numpy()
    caches = [(None, None)] * 2
    _, caches = m(paddle.to_tensor(fresh(ids[:, :5])), kv_caches=caches)
    step, caches = m(paddle.to_tensor(fresh(ids[:, 5:6])), position_offset=5,
                     kv_caches=caches)
    return full, step.numpy(), [c[0].shape for c in caches]


def test_kv_cache_decode_matches_full():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    jm.eval()
    tm.eval()
    ids = _ids((1, 6), V, 5)
    (fa, sa, ca), (fb, sb, cb) = _both(jm, tm, lambda p, m: _decode(p, m,
                                                                   ids))
    np.testing.assert_allclose(sb[0, 0], fb[0, 5], rtol=2e-4, atol=2e-5)
    np.testing.assert_allclose(sb, sa, rtol=2e-5, atol=2e-5)
    assert cb == ca == [[1, 6, 4, 8]] * 2


def test_rope_rotation_invariants():
    rng = np.random.default_rng(6)
    q = rng.standard_normal((1, 4, 2, 8)).astype("float32")
    cos = np.cos(rng.standard_normal((16, 4))).astype("float32")
    sin = np.sin(rng.standard_normal((16, 4))).astype("float32")
    from paddle_tpu.models.llama import fused_rotary_position_embedding

    outs = []
    for paddle, fn in ((jpaddle, fused_rotary_position_embedding),
                       (tpaddle, tl.fused_rotary_position_embedding)):
        t = [paddle.to_tensor(fresh(a)) for a in (q, cos, sin)]
        q2, k2 = fn(t[0], t[0], t[1], t[2], offset=3)
        assert q2.shape == [1, 4, 2, 8]
        outs.append((q2.numpy(), k2.numpy()))
    for a, b in zip(*outs):
        np.testing.assert_allclose(b, a, **TOL)


def test_functional_call_pure_and_restores_weights():
    from paddle_tpu_torch.jit import functional_call, state_arrays

    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    tm.eval()
    jm.eval()
    params = {k: v.clone() for k, v in state_arrays(tm).items()}
    ids = _ids((2, 16), V, 7)
    eager = tm(tpaddle.to_tensor(fresh(ids))).numpy()
    pure = functional_call(tm, params, tpaddle.to_tensor(fresh(ids))).numpy()
    np.testing.assert_allclose(pure, eager, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(pure, jm(jpaddle.to_tensor(fresh(ids)))
                               .numpy(), **TOL)
    live = dict(tm.named_parameters())
    assert all(live[k]._data is not params[k] for k in params)


def test_functional_call_grad():
    """The gradient of the loss in the weights given to `functional_call`
    (torch autograd over them) equals the JAX model's gradient."""
    from paddle_tpu_torch.jit import functional_call, state_arrays

    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    ids, labels = _ids((2, 16), V, 8), _ids((2, 16), V, 9)
    params = {k: v.detach().clone().requires_grad_()
              for k, v in state_arrays(tm).items()}
    loss, _ = functional_call(tm, params, tpaddle.Tensor(fresh(ids)),
                              labels=tpaddle.Tensor(fresh(labels)))
    grads = dict(zip(params, torch.autograd.grad(loss._data,
                                                 list(params.values()))))
    assert all(p.grad is None for p in tm.parameters())
    jl, _lg, _s, jg = _loss_and_grads(jpaddle, jm, ids, labels)
    np.testing.assert_allclose(float(loss.detach()), jl, **TOL)
    assert set(grads) == set(jg)
    for n in jg:
        np.testing.assert_allclose(grads[n].numpy(), jg[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_tied_embeddings():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY,
                                             tie_word_embeddings=True))
    assert tm.lm_head is None
    ids, labels = _ids((2, 16), V, 10), _ids((2, 16), V, 11)
    (la, _a, _s, ga), (lb, _b, _t, gb) = _both(
        jm, tm, lambda p, m: _loss_and_grads(p, m, ids, labels))
    np.testing.assert_allclose(lb, la, **TOL)
    np.testing.assert_allclose(gb["llama.embed_tokens.weight"],
                               ga["llama.embed_tokens.weight"], rtol=1e-4,
                               atol=1e-6)
    assert tm.flops_per_token(16) == jm.flops_per_token(16)


def test_flops_per_token_matches():
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    assert tm.flops_per_token(16) == jm.flops_per_token(16)


def test_jax_checkpoint_loads_through_paddle_load(tmp_path):
    jm, _tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    path = str(tmp_path / "llama.pdparams")
    jpaddle.save(jm.state_dict(), path)
    tpaddle.seed(1)
    tm = tl.llama_tiny(**TINY)
    missing, unexpected = tm.set_state_dict(tpaddle.load(path))
    assert missing == [] and unexpected == []
    ids = _ids((2, 16), V, 12)
    np.testing.assert_allclose(tm(tpaddle.to_tensor(fresh(ids))).numpy(),
                               jm(jpaddle.to_tensor(fresh(ids))).numpy(),
                               **TOL)


def test_layer_model_and_module_model_give_the_same_loss():
    """One JAX state into the Layer Llama and (`convert.from_jax_state`)
    the `nn.Module` Llama that training and serving use: the same loss
    and gradients, the same weights by name."""
    jm, tm, state = _pair(lambda m: m.llama_tiny(**TINY))
    cfg = tm.config
    module = from_jax_state(state, cfg, device="cpu")
    ids, labels = _ids((2, 16), V, 13), _ids((2, 16), V, 14)
    loss_l, _logits, _s, grads_l = _loss_and_grads(tpaddle, tm, ids, labels)
    loss_m, _ = module(torch.from_numpy(fresh(ids)),
                       labels=torch.from_numpy(fresh(labels)))
    loss_m.backward()
    np.testing.assert_allclose(float(loss_m.detach()), loss_l, **TOL)
    for n, p in module.named_parameters():
        np.testing.assert_allclose(p.grad.numpy(), grads_l[n], rtol=1e-4,
                                   atol=1e-6, err_msg=n)


def test_remat_keeps_the_eager_meaning():
    """JAX recomputes under a trace only: an eager step with remat on is
    the step with it off, in both packages."""
    jm, tm, _ = _pair(lambda m: m.llama_tiny(**TINY))
    ids, labels = _ids((2, 16), V, 15), _ids((2, 16), V, 16)
    off = _loss_and_grads(tpaddle, tm, ids, labels)
    tm.clear_gradients()
    tm.llama.remat = jm.llama.remat = True
    on, jon = _both(jm, tm, lambda p, m: _loss_and_grads(p, m, ids, labels))
    assert jon[0] == pytest.approx(on[0], rel=1e-5)
    np.testing.assert_allclose(on[0], off[0], **TOL)
    for n in off[3]:
        np.testing.assert_allclose(on[3][n], off[3][n], rtol=1e-5,
                                   atol=1e-6, err_msg=n)
