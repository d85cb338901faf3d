"""The transformer layers of the port (`nn/layer/transformer.py`) held to
the JAX package: every case of `tests/test_nn.py` `TestTransformer` and
`TestMultiHeadAttention.test_mha_cache`, each with its own assertions on
both packages; an encoder stack in training (attention, residual and
activation dropout masks bit-equal) with its gradients; the
encoder-decoder `Transformer` with `generate_square_subsequent_mask`, and
pre-norm; incremental decoding through `MultiHeadAttention.Cache` and the
decoder's `StaticCache`, each step equal to the full masked pass's row;
and `bert_tiny` (`tools/encoder_workload.py`: 2 layers, hidden 64, 4
heads, FFN 128, vocab 128, S 32, dropout on) two AdamW steps from the
JAX package's state (`convert.layers_from_jax_state`): losses within
1e-5 relative, every parameter within 1e-5 norm-relative. The key
projections' biases get no gradient in exact arithmetic (softmax ignores
a per-query shift); Adam turns their rounding noise into updates of
about 1e-8, so they are held within 1e-6 absolute (2 % of one step's
learning rate) instead."""
import numpy as np
import pytest  # noqa: F401

from torch_nn_common import (cotangent_grads, jpaddle,  # noqa: F401
                             norm_rel, one_thread, param_grads, port_on_cpu,
                             rng, scenario_test, t, tpaddle)


def _x(shape, seed=0):
    return rng(seed).standard_normal(shape).astype("float32")


# -- TestTransformer, test_mha_cache ----------------------------------------

# The encoder stacks and the Transformers take `bert_tiny`'s widths and
# batch (hidden 64, 4 heads, FFN 128, B 2 x S 32), so that the JAX package
# compiles their layers' ops once for them all and
# `test_bert_tiny_two_adamw_steps_match_jax`.

def encoder_stack(paddle):
    paddle.seed(0)
    layer = paddle.nn.TransformerEncoderLayer(64, 4, 128, dropout=0.0)
    enc = paddle.nn.TransformerEncoder(layer, 2)
    out = enc(t(paddle, _x((2, 32, 64))))
    assert out.shape == [2, 32, 64]
    return {"out": out, "names": [n for n, _ in enc.named_parameters()]}


def full_transformer(paddle):
    paddle.seed(0)
    m = paddle.nn.Transformer(d_model=64, nhead=4, num_encoder_layers=1,
                              num_decoder_layers=1, dim_feedforward=128,
                              dropout=0.0)
    out = m(t(paddle, _x((2, 32, 64))), t(paddle, _x((2, 32, 64), 1)))
    assert out.shape == [2, 32, 64]
    return {"out": out}


def mha_cache(paddle):
    paddle.seed(0)
    mha = paddle.nn.MultiHeadAttention(8, 2)
    mha.eval()
    x = t(paddle, _x((1, 3, 8)))
    cache = mha.gen_cache(x)
    step1, cache = mha(x[:, :1], x[:, :1], x[:, :1], cache=cache)
    step2, cache = mha(x[:, 1:2], x[:, 1:2], x[:, 1:2], cache=cache)
    full = mha(x[:, :2], attn_mask=None)
    assert cache.k.shape[1] == 2
    return {"step1": step1, "step2": step2, "full": full, "k": cache.k}


# -- training, masks, caches ------------------------------------------------

def encoder_training_dropout(paddle):
    """A post-norm gelu encoder stack in training: every dropout draws
    the JAX package's bits; gradients of input and parameters."""
    nn = paddle.nn
    paddle.seed(2)
    post = nn.TransformerEncoder(nn.TransformerEncoderLayer(
        64, 4, 128, dropout=0.1, activation="gelu", attn_dropout=0.1,
        act_dropout=0.2), 2)
    x = t(paddle, _x((2, 32, 64)), sg=False)
    a = post(x)
    # a random cotangent: a post-norm output's sum of squares is nearly
    # constant, and its gradient mostly cancellation
    grads = cotangent_grads(paddle, [a], {"x": x})
    grads.update(param_grads(post))
    return {"a": a, "grads": grads}


def transformer_masks(paddle):
    """`Transformer` (pre-norm, so its stacks end in a LayerNorm) with a
    square subsequent mask on the target and a float memory mask."""
    nn = paddle.nn
    paddle.seed(4)
    m = nn.Transformer(d_model=64, nhead=4, num_encoder_layers=2,
                       num_decoder_layers=2, dim_feedforward=128,
                       dropout=0.0, normalize_before=True)
    mask = nn.Transformer.generate_square_subsequent_mask(32)
    src = t(paddle, _x((2, 32, 64)))
    tgt = t(paddle, _x((2, 32, 64), 1), sg=False)
    mem_mask = t(paddle, np.where(rng(2).random((32, 32)) < 0.2, -1e9,
                                  0.0).astype("float32"))
    out = m(src, tgt, tgt_mask=mask, memory_mask=mem_mask)
    grads = cotangent_grads(paddle, [out], {"tgt": tgt})
    return {"mask": mask, "out": out, "grads": grads}


def incremental_decode(paddle):
    """Decoding through `Cache` / `StaticCache` one token at a time (under
    `no_grad`, as inference runs) gives each row of the full causal
    pass."""
    nn = paddle.nn
    paddle.seed(6)
    dec = nn.TransformerDecoder(nn.TransformerDecoderLayer(
        16, 4, 32, dropout=0.0), 2)
    dec.eval()
    mem = t(paddle, _x((2, 4, 16)))
    tgt = t(paddle, _x((2, 3, 16), 1))
    with paddle.no_grad():
        full = dec(tgt, mem, tgt_mask=nn.Transformer
                   .generate_square_subsequent_mask(3))
        cache = dec.gen_cache(mem)
        steps = []
        for i in range(3):
            y, cache = dec(tgt[:, i:i + 1], mem, cache=cache)
            steps.append(y)
        np.testing.assert_allclose(
            np.concatenate([s.numpy() for s in steps], axis=1),
            full.numpy(), rtol=1e-4, atol=1e-5)
        mha = nn.MultiHeadAttention(16, 4)
        static = mha.gen_cache(mem, mem, nn.MultiHeadAttention.StaticCache)
        cross = mha(tgt, mem, mem, cache=static)
    return {"full": full, "steps": steps, "k": cache[0][0].k,
            "static_k": static.k, "cross": cross}


SCENARIOS = [encoder_stack, full_transformer, mha_cache,
             encoder_training_dropout, transformer_masks, incremental_decode]

test_scenario = scenario_test(SCENARIOS)


_BERT = {}


def _bert_tiny_runs():
    """`bert_tiny`'s two AdamW steps on the JAX package (from its seed)
    and on the port from the JAX package's state, run once a module:
    (the JAX run, the JAX state, the port's model from it, the port's
    run)."""
    if not _BERT:
        from paddle_tpu_torch.convert import layers_from_jax_state
        from paddle_tpu_torch.tools import encoder_workload as ew

        want = ew.tiny_steps(jpaddle)
        jpaddle.seed(ew.SEED)
        jm = ew.build(jpaddle, "bert_tiny")
        state = {n: np.asarray(p.numpy()) for n, p in jm.named_parameters()}
        tpaddle.seed(ew.SEED)
        tm = layers_from_jax_state(state, ew.build(tpaddle, "bert_tiny"))
        _BERT.update(want=want, state=state, model=tm,
                     got=ew.tiny_steps(tpaddle, state=state))
    return _BERT


def test_bert_tiny_two_adamw_steps_match_jax():
    b = _bert_tiny_runs()
    want, got, state = b["want"], b["got"], b["state"]
    for n, p in b["model"].named_parameters():   # one seed, the same weights
        np.testing.assert_array_equal(p.numpy(), state[n], err_msg=n)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=1e-5)
    assert got["lrs"] == want["lrs"]
    assert set(got["params"]) == set(want["params"])
    for n, w in want["params"].items():
        g = got["params"][n]
        if n.endswith("k_proj.bias"):
            np.testing.assert_allclose(g, w, rtol=0, atol=1e-6, err_msg=n)
        else:
            assert norm_rel(g, w) <= 1e-5, (n, norm_rel(g, w))


def test_nn_reference_rehearsed_on_the_cpu():
    """The smoke run's `nn_reference` body on the CPU (the card is held to
    it): every result finite."""
    from paddle_tpu_torch.tools import encoder_workload as ew

    a = ew.reference_run(tpaddle)

    def walk(x, path):
        if isinstance(x, dict):
            for k in x:
                walk(x[k], f"{path}.{k}")
        elif isinstance(x, list):
            for i, u in enumerate(x):
                walk(u, f"{path}[{i}]")
        else:
            x = np.asarray(x)
            assert x.dtype.kind != "f" or np.isfinite(x).all(), path

    walk(a, "reference_run")
    assert set(a) == {"conv", "rnn", "transformer", "masks", "bert"}
    # the CPU's bert part is the JAX-held `tiny_steps` (the port's weights
    # from the seed are the JAX package's), bit for bit
    assert a["bert"]["losses"] == _bert_tiny_runs()["got"]["losses"]


_ENC_RUNS = {}


@pytest.mark.parametrize("lazy_on", [False, True], ids=["eager", "lazy"])
def test_encoder_train_rehearsed_on_the_cpu(lazy_on):
    """The smoke run's `encoder_train` steps on `bert_tiny` (bf16 by O2
    decorate, B 1 x S 16, 2 warm-up and 4 timed steps), eagerly and under
    lazy mode: the scheduled learning rates, finite falling losses, and
    the lazy run bit-equal to the eager one (dropout on)."""
    from paddle_tpu_torch.tools import encoder_workload as ew

    def run(lazy):
        if lazy not in _ENC_RUNS:
            _ENC_RUNS[lazy] = ew.run_encoder(
                tpaddle, ew.encoder_workload(tpaddle, "bert_tiny", 1, 16),
                lazy, lambda: None, dict, None)
        return _ENC_RUNS[lazy]

    r = run(lazy_on)
    np.testing.assert_allclose(r["lrs"], [ew.lr_at(i) for i in range(6)],
                               rtol=0, atol=1e-7)
    assert np.isfinite(r["losses"]).all()
    assert r["losses"][-1] < r["losses"][ew.WARMUP_STEPS]
    if lazy_on:
        eager = run(False)
        assert r["losses"] == eager["losses"]
        assert r["norms"] == eager["norms"]
