"""The FNet workload: FNet pre-training steps through `paddle.fft`, for
`chip_smoke.py`'s `fnet_train` and `fnet_reference` phases and the tests
that rehearse them on the CPU. Every function takes the package
(`paddle`), so the same code builds the model in the port and in the JAX
package.

FNet (Lee-Thorp et al., 2021, "FNet: Mixing Tokens with Fourier
Transforms") is a BERT encoder whose attention sublayers are the real
part of a 2-D DFT over the sequence and hidden axes. The model is built
as PaddleNLP's `FNetModel` / `FNetForPreTraining` build it
(`paddlenlp/transformers/fnet/modeling.py`; widths from
`google/fnet-base`'s config: vocab 32000, hidden 768, 12 layers,
intermediate 3072, `gelu_new`, dropout 0.1, 512 positions, 4 token
types, layer-norm eps 1e-12):
- word, position and token-type `nn.Embedding`s, summed, then
  `LayerNorm`, a `Linear(hidden, hidden)` projection and `Dropout`;
- per layer: `paddle.fft.fftn(h, axes=(1, 2)).real()` (the basic Fourier
  transform), `LayerNorm(h + fourier)`, `Linear(hidden, intermediate)`
  with the tanh gelu, `Linear(intermediate, hidden)`, `Dropout`, and
  `LayerNorm(+ the Fourier output)`;
- the MLM head: `Linear` + tanh gelu + `LayerNorm`, then a decoder tied
  to the word embedding plus a bias;
- `F.cross_entropy(ignore_index=-100)` over the 15 % of positions that
  carry a label, chosen from the seed with numpy
  (`encoder_workload.batch`).
Cuts: the NSP head and its pooler are left out; the weights are random
from `paddle.seed`. Nothing is cut in depth or width.

Training is `encoder_workload`'s loop: AdamW(1e-4, eps 1e-6, weight
decay 0.01 off biases and norms, `multi_precision`) with
`ClipGradByGlobalNorm(1.0)` over a linear warm-up and a linear decay; on
the card bf16 by `amp.decorate(level="O2")` (the norms stay float32).
The transform widens its bf16 input to float32 and returns complex64,
as JAX's dtype rule gives.

- `CONFIGS`: `fnet_base` (the chip run, B 32 x S 512) and `fnet_tiny`
  (2 layers, hidden 64, intermediate 128, S 32, f32: the CPU tests and
  `fnet_reference`);
- `build(paddle, name)`: the model on the expected place;
- `tiny_steps(paddle, state=None)`: `fnet_tiny` two AdamW steps in f32,
  dropout on, from `paddle.seed(SEED)`; losses, learning rates and the
  parameters after, on either package;
- `reference_run(paddle)`: the `fnet_reference` phase's body (dropout
  masks and `tiny_steps`);
- `fnet_workload(paddle)` / `run_fnet`: the `fnet_train` phase,
  `WARMUP_STEPS` + `TIMED_STEPS` steps eagerly or under lazy mode.
"""
from __future__ import annotations

from . import encoder_workload as ew
from . import loop_workload as lw

__all__ = ["CONFIGS", "SEED", "BATCH", "SEQ", "TINY_BATCH", "TINY_SEQ",
           "WARMUP_STEPS", "TIMED_STEPS", "build", "fourier", "tiny_inputs",
           "tiny_steps", "reference_run", "fnet_workload", "run_fnet",
           "lr_at"]

CONFIGS = {
    "fnet_base": dict(vocab=32000, hidden=768, layers=12,
                      intermediate=3072, positions=512, type_vocab=4,
                      dropout=0.1, eps=1e-12, mask_id=6),
    "fnet_tiny": dict(vocab=128, hidden=64, layers=2, intermediate=128,
                      positions=64, type_vocab=4, dropout=0.1, eps=1e-12,
                      mask_id=6),
}
SEED = ew.SEED
BATCH, SEQ = 32, 512
TINY_BATCH, TINY_SEQ = 2, 32
WARMUP_STEPS, TIMED_STEPS = lw.WARMUP_STEPS, lw.TIMED_STEPS
lr_at = ew.lr_at

_CLASSES = {}


def fourier(paddle, h):
    """FNet's basic Fourier transform: the real part of the 2-D DFT over
    the sequence and hidden axes."""
    return paddle.fft.fftn(h, axes=(1, 2)).real()


def _classes(paddle):
    """The model's Layer classes over `paddle.nn` (one set a package)."""
    key = paddle.__name__
    if key in _CLASSES:
        return _CLASSES[key]
    nn, F = paddle.nn, paddle.nn.functional

    class FNetEmbeddings(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.word_embeddings = nn.Embedding(c["vocab"], c["hidden"])
            self.position_embeddings = nn.Embedding(c["positions"],
                                                    c["hidden"])
            self.token_type_embeddings = nn.Embedding(c["type_vocab"],
                                                      c["hidden"])
            self.layer_norm = nn.LayerNorm(c["hidden"], epsilon=c["eps"])
            self.projection = nn.Linear(c["hidden"], c["hidden"])
            self.dropout = nn.Dropout(c["dropout"])

        def forward(self, ids, token_types, positions):
            x = self.word_embeddings(ids) \
                + self.position_embeddings(positions) \
                + self.token_type_embeddings(token_types)
            return self.dropout(self.projection(self.layer_norm(x)))

    class FNetLayer(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.fourier_norm = nn.LayerNorm(c["hidden"], epsilon=c["eps"])
            self.intermediate = nn.Linear(c["hidden"], c["intermediate"])
            self.output = nn.Linear(c["intermediate"], c["hidden"])
            self.dropout = nn.Dropout(c["dropout"])
            self.output_norm = nn.LayerNorm(c["hidden"], epsilon=c["eps"])

        def forward(self, h):
            f = self.fourier_norm(h + fourier(paddle, h))
            y = self.output(F.gelu(self.intermediate(f), approximate=True))
            return self.output_norm(self.dropout(y) + f)

    class FNetForPretraining(nn.Layer):
        def __init__(self, c):
            super().__init__()
            self.config = dict(c)
            self.embeddings = FNetEmbeddings(c)
            self.layers = nn.LayerList([FNetLayer(c)
                                        for _ in range(c["layers"])])
            self.transform = nn.Linear(c["hidden"], c["hidden"])
            self.transform_norm = nn.LayerNorm(c["hidden"],
                                               epsilon=c["eps"])
            self.decoder_bias = self.create_parameter(
                [c["vocab"]], is_bias=True)

        def forward(self, ids, token_types, positions):
            h = self.embeddings(ids, token_types, positions)
            for layer in self.layers:
                h = layer(h)
            h = self.transform_norm(F.gelu(self.transform(h),
                                           approximate=True))
            return paddle.matmul(
                h, self.embeddings.word_embeddings.weight,
                transpose_y=True) + self.decoder_bias

    _CLASSES[key] = FNetForPretraining
    return FNetForPretraining


def build(paddle, name="fnet_base"):
    """The model of `CONFIGS[name]` on the expected place, weights from
    the current seed."""
    return _classes(paddle)(CONFIGS[name])


def tiny_inputs(paddle):
    """`fnet_tiny`'s batch of TINY_BATCH x TINY_SEQ: ((ids, token types,
    positions), labels) as Tensors."""
    return ew._inputs(paddle, CONFIGS["fnet_tiny"], TINY_BATCH, TINY_SEQ)


def tiny_steps(paddle, state=None):
    """`fnet_tiny` (f32, dropout on) two AdamW steps on one batch, from
    `paddle.seed(SEED)`; with `state` (name -> array) the weights are
    loaded first. Returns the losses, the learning rates and the
    parameters after."""
    paddle.seed(SEED)
    model = build(paddle, "fnet_tiny")
    if state is not None:
        model.set_state_dict(state)
    model.train()
    opt, sched = ew.build_optimizer(paddle, model)
    inputs, labels = tiny_inputs(paddle)
    paddle.seed(SEED + 1)
    out = {"losses": [], "lrs": []}
    for _ in range(2):
        out["lrs"].append(opt.get_lr())
        loss = ew.loss_of(paddle, model(*inputs), labels,
                          CONFIGS["fnet_tiny"]["vocab"])
        loss.backward()
        opt.step()
        opt.clear_grad()
        sched.step()
        out["losses"].append(float(loss.numpy()))
    out["params"] = {n: p.numpy() for n, p in model.named_parameters()}
    return out


def reference_run(paddle):
    """The `fnet_reference` phase's body on the expected place (f32):
    dropout masks at FNet's rate and `fnet_tiny`'s two AdamW steps, as
    numpy."""
    paddle.seed(SEED + 2)
    masks = {"dropout": paddle.nn.functional.dropout(
        paddle.ones([TINY_BATCH, TINY_SEQ, 64]), 0.1).numpy()}
    return {"masks": masks, "fnet": tiny_steps(paddle)}


def fnet_workload(paddle, name="fnet_base", b=BATCH, s=SEQ):
    """`(model, opt, sched, clip, inputs, labels)` on the expected place:
    `CONFIGS[name]` bf16 by `amp.decorate(level="O2")`, one batch of
    b x s."""
    paddle.seed(SEED)
    model = build(paddle, name)
    model.train()
    clip = lw._recording_clip(paddle)
    opt, sched = ew.build_optimizer(paddle, model, clip)
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    inputs, labels = ew._inputs(paddle, CONFIGS[name], b, s)
    return model, opt, sched, clip, inputs, labels


def run_fnet(paddle, work, lazy_on, sync, launches, event=None):
    """`loop_workload.run_loop` over `fnet_workload`'s steps (the
    encoder's step: O2 forward, f32 loss, AdamW)."""
    return lw.run_loop(paddle, work, lazy_on, sync, launches, event,
                       step=ew._step)
