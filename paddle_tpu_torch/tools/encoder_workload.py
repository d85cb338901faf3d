"""The encoder workload: BERT pre-training steps built from
`paddle.nn.TransformerEncoder`, for `chip_smoke.py`'s `encoder_train`
and `nn_reference` phases and the tests that rehearse them on the CPU.
Every function takes the package (`paddle`), so the same code builds the
model in the port and in the JAX package.

The model is built the way PaddleNLP's `BertModel` builds it
(`google-bert/bert-base-uncased`'s `config.json` gives the widths):
- word, position and token-type `nn.Embedding`s, summed, then a
  `LayerNorm` (eps 1e-12) and a `Dropout(0.1)`;
- one `nn.TransformerEncoderLayer(hidden, heads, intermediate,
  dropout=0.1, activation="gelu", attn_dropout=0.1, act_dropout=0)`
  (post-norm, its norms at the layer's default eps) stacked `layers`
  times by `nn.TransformerEncoder`. With no mask its attention reaches
  `F.scaled_dot_product_attention`'s flash route;
- the MLM head: `Linear` + exact gelu + `LayerNorm` (eps 1e-12), then a
  decoder tied to the word embedding (`matmul(h, word_emb.weight,
  transpose_y=True)` + a bias);
- `F.cross_entropy(ignore_index=-100)` over the 15 % of positions that
  carry a label, chosen from the seed with numpy (their inputs replaced
  by the `[MASK]` id).
Cut: the NSP head and its pooler are left out. Nothing is cut in depth
or width.

Training is the Trainer's loop (`loop_workload`'s pieces): AdamW(1e-4,
beta 0.9 / 0.999, eps 1e-6, weight decay 0.01 off biases and norms,
`multi_precision`) with `ClipGradByGlobalNorm(1.0)` over
`LinearWarmup(PolynomialDecay(1e-4, DECAY_STEPS, 0, power 1), WARMUP)`,
on one batch of B x S ids (full length, no padding: packed pre-training
sequences); on the card bf16 by `amp.decorate(level="O2")` (the norms
stay float32).

- `CONFIGS`: `bert_base` (the chip run) and `bert_tiny` (the CPU
  rehearsal and the `nn_reference` phase);
- `build(paddle, name)`: the model on the expected place;
- `batch(cfg, b, s)`: numpy ids (from `SEED`), token types and labels;
- `tiny_steps(paddle, state=None)`: `bert_tiny` two AdamW steps in f32,
  dropout on, from `paddle.seed(SEED)` (optionally from a state dict);
  losses and parameters after, on either package;
- `reference_run(paddle)`: the `nn_reference` phase's body on the
  expected place: a conv net with `BatchNorm2D` and pools two AdamW
  steps (the running statistics after), bidirectional `LSTM` and `GRU`
  stacks with inter-layer dropout (outputs, states, gradients), the
  encoder-decoder `Transformer` in training (a square subsequent mask on
  the target), dropout masks, and `tiny_steps`;
- `encoder_workload(paddle)` / `run_encoder`: the `encoder_train`
  phase, `WARMUP_STEPS` + `TIMED_STEPS` steps eagerly or under lazy mode
  (`loop_workload.run_loop` with this model's step).
"""
from __future__ import annotations

import numpy as np

from . import loop_workload as lw

__all__ = ["CONFIGS", "SEED", "BATCH", "SEQ", "MLM_RATE", "IGNORE",
           "BASE_LR", "WARMUP", "DECAY_STEPS", "WARMUP_STEPS",
           "TIMED_STEPS", "build", "batch", "build_optimizer", "loss_of",
           "tiny_steps", "reference_run", "encoder_workload",
           "run_encoder", "lr_at"]

CONFIGS = {
    "bert_base": dict(vocab=30522, hidden=768, layers=12, heads=12,
                      intermediate=3072, positions=512, type_vocab=2,
                      dropout=0.1, eps=1e-12, mask_id=103),
    "bert_tiny": dict(vocab=128, hidden=64, layers=2, heads=4,
                      intermediate=128, positions=64, type_vocab=2,
                      dropout=0.1, eps=1e-12, mask_id=103),
}
SEED = 0
BATCH, SEQ = 32, 512
TINY_BATCH, TINY_SEQ = 2, 32
MLM_RATE, IGNORE = 0.15, -100
BASE_LR, WARMUP, DECAY_STEPS = 1e-4, 2, 8
WARMUP_STEPS, TIMED_STEPS = lw.WARMUP_STEPS, lw.TIMED_STEPS

_CLASSES = {}


def _classes(paddle):
    """The model's Layer classes over `paddle.nn` (one set a package)."""
    key = paddle.__name__
    if key in _CLASSES:
        return _CLASSES[key]
    nn, F = paddle.nn, paddle.nn.functional

    class BertEmbeddings(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.word_embeddings = nn.Embedding(c["vocab"], c["hidden"])
            self.position_embeddings = nn.Embedding(c["positions"],
                                                    c["hidden"])
            self.token_type_embeddings = nn.Embedding(c["type_vocab"],
                                                      c["hidden"])
            self.layer_norm = nn.LayerNorm(c["hidden"], epsilon=c["eps"])
            self.dropout = nn.Dropout(c["dropout"])

        def forward(self, ids, token_types, positions):
            x = self.word_embeddings(ids) \
                + self.position_embeddings(positions) \
                + self.token_type_embeddings(token_types)
            return self.dropout(self.layer_norm(x))

    class BertForPretraining(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.config = dict(c)
            self.embeddings = BertEmbeddings(c)
            layer = nn.TransformerEncoderLayer(
                c["hidden"], c["heads"], c["intermediate"],
                dropout=c["dropout"], activation="gelu",
                attn_dropout=c["dropout"], act_dropout=0)
            self.encoder = nn.TransformerEncoder(layer, c["layers"])
            self.transform = nn.Linear(c["hidden"], c["hidden"])
            self.transform_norm = nn.LayerNorm(c["hidden"],
                                               epsilon=c["eps"])
            self.decoder_bias = self.create_parameter(
                [c["vocab"]], is_bias=True)

        def forward(self, ids, token_types, positions):
            h = self.encoder(self.embeddings(ids, token_types, positions))
            h = self.transform_norm(F.gelu(self.transform(h)))
            return paddle.matmul(
                h, self.embeddings.word_embeddings.weight,
                transpose_y=True) + self.decoder_bias

    _CLASSES[key] = BertForPretraining
    return BertForPretraining


def build(paddle, name="bert_base"):
    """The model of `CONFIGS[name]` on the expected place, weights from
    the current seed."""
    return _classes(paddle)(CONFIGS[name])


def batch(cfg, b, s):
    """(ids, token_types, positions, labels) as int64 numpy arrays: ids
    uniform over the vocabulary, a sentence pair split at s / 2, and
    round(MLM_RATE * s) labelled positions a row (their inputs set to the
    mask id), the rest IGNORE."""
    rng = np.random.default_rng(SEED)
    ids = rng.integers(0, cfg["vocab"], (b, s))
    types = np.zeros((b, s), np.int64)
    types[:, s // 2:] = 1
    labels = np.full((b, s), IGNORE, np.int64)
    n = int(round(MLM_RATE * s))
    for row in range(b):
        pos = rng.permutation(s)[:n]
        labels[row, pos] = ids[row, pos]
        ids[row, pos] = min(cfg["mask_id"], cfg["vocab"] - 1)
    positions = np.broadcast_to(np.arange(s), (b, s)).copy()
    return ids, types, positions, labels


def lr_at(step: int) -> float:
    """The schedule's closed form at scheduler step `step`."""
    if step < WARMUP:
        return BASE_LR * step / WARMUP
    t = min(step - WARMUP, DECAY_STEPS)
    return BASE_LR * (1 - t / DECAY_STEPS)


def build_optimizer(paddle, model, clip=None):
    """`(optimizer, scheduler)` as the Trainer builds them for BERT."""
    sched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.PolynomialDecay(BASE_LR, DECAY_STEPS,
                                            end_lr=0.0, power=1.0),
        warmup_steps=WARMUP, start_lr=0.0, end_lr=BASE_LR)
    names = lw.decay_names(model)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(), beta1=0.9,
        beta2=0.999, epsilon=1e-6, weight_decay=0.01, multi_precision=True,
        apply_decay_param_fun=lambda n: n in names,
        grad_clip=clip if clip is not None
        else paddle.nn.ClipGradByGlobalNorm(1.0))
    return opt, sched


def loss_of(paddle, logits, labels, vocab):
    return paddle.nn.functional.cross_entropy(
        logits.reshape([-1, vocab]).astype("float32"), labels.reshape([-1]),
        ignore_index=IGNORE)


def _inputs(paddle, cfg, b, s):
    ids, types, positions, labels = batch(cfg, b, s)
    return ((paddle.to_tensor(ids), paddle.to_tensor(types),
             paddle.to_tensor(positions)), paddle.to_tensor(labels))


def tiny_steps(paddle, state=None):
    """`bert_tiny` (f32, dropout on) two AdamW steps on one batch of
    TINY_BATCH x TINY_SEQ, from `paddle.seed(SEED)`; with `state` (name ->
    array) the weights are loaded before the steps. Returns the losses,
    the learning rates and the parameters after."""
    paddle.seed(SEED)
    model = build(paddle, "bert_tiny")
    if state is not None:
        model.set_state_dict(state)
    model.train()
    opt, sched = build_optimizer(paddle, model)
    cfg = CONFIGS["bert_tiny"]
    inputs, labels = _inputs(paddle, cfg, TINY_BATCH, TINY_SEQ)
    paddle.seed(SEED + 1)
    out = {"losses": [], "lrs": []}
    for _ in range(2):
        out["lrs"].append(opt.get_lr())
        loss = loss_of(paddle, model(*inputs), labels, cfg["vocab"])
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        out["losses"].append(float(loss.numpy()))
    out["params"] = {n: p.numpy() for n, p in model.named_parameters()}
    return out


def _np_tree(x):
    """Tensors (nested in dicts / lists) as numpy arrays."""
    if isinstance(x, dict):
        return {k: _np_tree(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [_np_tree(v) for v in x]
    return x.numpy() if hasattr(x, "numpy") else x


def _grads(layer):
    return {n: p.grad for n, p in layer.named_parameters()
            if p.grad is not None}


def _conv_net(paddle, rng):
    nn, F = paddle.nn, paddle.nn.functional
    paddle.seed(31)
    # no conv bias before a batch norm: its gradient is zero, and Adam
    # would turn the rounding noise into learning-rate-sized steps
    net = nn.Sequential(
        nn.Conv2D(3, 8, 3, padding=1, bias_attr=False), nn.BatchNorm2D(8),
        nn.ReLU(), nn.MaxPool2D(2, 2),
        nn.Conv2D(8, 16, 3, stride=2, padding="SAME", bias_attr=False),
        nn.BatchNorm2D(16), nn.ReLU(), nn.AvgPool2D(2, ceil_mode=True),
        nn.AdaptiveMaxPool2D(1), nn.Flatten(), nn.Linear(16, 10))
    opt = paddle.optimizer.AdamW(learning_rate=1e-2,
                                 parameters=net.parameters())
    x = paddle.to_tensor(rng.standard_normal((8, 3, 16, 16))
                         .astype("float32"))
    y = paddle.to_tensor(rng.integers(0, 10, (8,)))
    losses = []
    for _ in range(2):
        loss = F.cross_entropy(net(x), y)
        loss.backward()
        opt.step()
        opt.clear_grad()
        losses.append(loss)
    net.eval()
    return {"losses": losses, "buffers": dict(net.named_buffers()),
            "params": dict(net.named_parameters()), "eval": net(x)}


def _rnn_stacks(paddle, rng):
    nn = paddle.nn
    paddle.seed(32)
    out = {}
    x = rng.standard_normal((4, 12, 16)).astype("float32")
    w = rng.standard_normal((4, 12, 64)).astype("float32")
    for name, cls in (("lstm", nn.LSTM), ("gru", nn.GRU)):
        m = cls(16, 32, num_layers=2, direction="bidirect", dropout=0.2)
        xs = paddle.to_tensor(x, stop_gradient=False)
        y, states = m(xs)
        (y * paddle.to_tensor(w)).sum().backward()
        out[name] = {"out": y, "states": states,
                     "grads": {"x": xs.grad, **_grads(m)}}
    return out


def _transformer(paddle, rng):
    nn = paddle.nn
    paddle.seed(33)
    m = nn.Transformer(d_model=64, nhead=4, num_encoder_layers=2,
                       num_decoder_layers=2, dim_feedforward=128,
                       dropout=0.1)
    src = paddle.to_tensor(rng.standard_normal((2, 16, 64))
                           .astype("float32"))
    tgt = paddle.to_tensor(rng.standard_normal((2, 8, 64))
                           .astype("float32"), stop_gradient=False)
    y = m(src, tgt, tgt_mask=nn.Transformer
          .generate_square_subsequent_mask(8))
    (y * paddle.to_tensor(rng.standard_normal((2, 8, 64))
                          .astype("float32"))).sum().backward()
    return {"out": y, "grads": {"tgt": tgt.grad, **_grads(m)}}


def _masks(paddle):
    F = paddle.nn.functional
    paddle.seed(34)
    ones = paddle.ones([64, 96])
    return {"dropout": F.dropout(ones, 0.3),
            "alpha": F.alpha_dropout(ones, 0.2),
            "feature_alpha": F.feature_alpha_dropout(
                paddle.ones([8, 16, 4]), 0.5),
            "dropout2d": F.dropout2d(paddle.ones([4, 8, 3, 3]), 0.5)}


def reference_run(paddle):
    """The `nn_reference` phase's body on the expected place (f32):
    numpy results by part."""
    rng = np.random.default_rng(35)
    return _np_tree({"conv": _conv_net(paddle, rng),
                     "rnn": _rnn_stacks(paddle, rng),
                     "transformer": _transformer(paddle, rng),
                     "masks": _masks(paddle),
                     "bert": tiny_steps(paddle)})


def encoder_workload(paddle, name="bert_base", b=BATCH, s=SEQ):
    """`(model, opt, sched, clip, inputs, labels)` on the expected place:
    `CONFIGS[name]` bf16 by `amp.decorate(level="O2")`, one batch of
    b x s."""
    paddle.seed(SEED)
    model = build(paddle, name)
    model.train()
    clip = lw._recording_clip(paddle)
    opt, sched = build_optimizer(paddle, model, clip)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    inputs, labels = _inputs(paddle, CONFIGS[name], b, s)
    return model, opt, sched, clip, inputs, labels


def _step(paddle, model, opt, sched, inputs, labels, events=None):
    with paddle.amp.auto_cast(level="O2", dtype="bfloat16"):
        logits = model(*inputs)
    loss = loss_of(paddle, logits, labels, model.config["vocab"])
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


def run_encoder(paddle, work, lazy_on, sync, launches, event=None):
    """`loop_workload.run_loop` over `encoder_workload`'s steps (its
    return value)."""
    return lw.run_loop(paddle, work, lazy_on, sync, launches, event,
                       step=_step)
