"""The workloads of sparse embeddings, quantization and guarded training,
in one place for `chip_smoke.py` (its `resilience_reference`,
`sparse_train` and `resilient_train` phases) and the tests that rehearse
them on the CPU.

- `reference_run(paddle)`: the small cases the card is held to the CPU
  on: the Layer Llama (`llama_tiny`, f32) with a sparse embedding,
  `STEPS` steps of each optimizer of `SPARSE_CONFIGS` under
  `ClipGradByGlobalNorm(1.0)` and once with a `GradScaler`;
  `weight_only_linear` in int8, fp8 and int4, `llm_int8_linear` and the
  int8 gemm's gradient to x; QAT (Linear and Conv2D) two steps; PTQ in
  the simulation and the weight-only convert forms. Each result is a
  float32 numpy array (or a list of them), keyed by case.
- `sparse_workload(paddle, sparse, layers)`: Llama-2-7B width at `layers`
  layers as paddle Layers, bf16 by `amp.decorate(level="O2")`, the word
  embedding sparse or dense, and the Trainer loop's optimizer
  (`loop_workload.build_optimizer`'s AdamW, clip and schedule) with
  `lazy_mode=True`; one sequence of `loop_workload.SEQ` tokens.
  `train_step` is one step of it (`loop_workload._step`).
- `guarded_run(...)`: the `resilient_train` phase's loop: `StepGuard`
  over a `CheckpointManager`, the step function returning NaN once.
"""
from __future__ import annotations

import numpy as np

from . import loop_workload as lw

__all__ = ["SPARSE_CONFIGS", "STEPS", "sparse_embedding", "name_parameters",
           "reference_run", "tiny_trained", "checkpoint_state",
           "sparse_workload", "train_step", "f32", "model_state",
           "guarded_run"]

# the optimizer configurations of the sparse reference: (name, options)
SPARSE_CONFIGS = [("SGD", {}), ("Adam", {"lazy_mode": True}),
                  ("Adam", {"lazy_mode": False}),
                  ("AdamW", {"lazy_mode": True, "multi_precision": True}),
                  ("Momentum", {"momentum": 0.9})]
STEPS = 3


def f32(t) -> np.ndarray:
    """A Tensor (bf16 included) or torch tensor as a float32 numpy
    array."""
    d = t._data if hasattr(t, "_data") else t
    return d.detach().float().cpu().numpy()


def sparse_embedding(model):
    """The Layer Llama with its word embedding's gradient made sparse
    (`Embedding(sparse=True)`)."""
    model.llama.embed_tokens._sparse = True
    return model


def name_parameters(model):
    """Name each parameter by its structured name, so that two builds of
    one model key the optimizer's state (and its checkpoints) alike."""
    for n, p in model.named_parameters():
        p.name = n
    return model


def _tiny_batch(paddle, vocab):
    rng = np.random.default_rng(5)
    return (paddle.to_tensor(rng.integers(0, vocab, (2, 16))),
            paddle.to_tensor(rng.integers(0, vocab, (2, 16))))


def _sparse_case(paddle, name, kw, scaled):
    paddle.seed(7)
    model = sparse_embedding(paddle.models.llama_layers.llama_tiny(seq=16))
    opt = getattr(paddle.optimizer, name)(
        learning_rate=0.01, parameters=model.parameters(),
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0), **kw)
    scaler = paddle.amp.GradScaler(init_loss_scaling=1024.0) \
        if scaled else None
    ids, labels = _tiny_batch(paddle, model.config.vocab_size)
    losses, rows = [], []
    for _ in range(STEPS):
        loss, _ = model(ids, labels=labels)
        (scaler.scale(loss) if scaled else loss).backward()
        g = model.llama.embed_tokens.weight.grad
        if not getattr(g, "is_selected_rows", False):
            raise AssertionError(f"{name}: the embedding's gradient is "
                                 f"{type(g).__name__}")
        rows.append(g.rows.cpu().numpy())
        if scaled:
            scaler.step(opt)
            scaler.update()
        else:
            opt.step()
        opt.clear_grad()
        losses.append(float(f32(loss)))
    return {"losses": np.asarray(losses, np.float32), "rows": rows,
            "params": {n: f32(p) for n, p in model.named_parameters()}}


def _quant_cases(paddle):
    Q = paddle.nn.quant
    rng = np.random.default_rng(6)
    x = rng.normal(size=(16, 256)).astype(np.float32)
    x[:, 3] *= 50.0                      # an outlier feature column
    w = rng.normal(size=(256, 128)).astype(np.float32)
    b = rng.normal(size=(128,)).astype(np.float32)
    out = {}
    for algo, wd in (("weight_only_int8", "int8"), ("fp8", "fp8"),
                     ("weight_only_int4", "int4")):
        wq, s = Q.weight_quantize(paddle.to_tensor(w), algo=algo)
        out[wd] = f32(Q.weight_only_linear(
            paddle.to_tensor(x), wq, bias=paddle.to_tensor(b),
            weight_scale=s, weight_dtype=wd))
    wq, s = Q.weight_quantize(paddle.to_tensor(w))
    out["llm_int8"] = f32(Q.llm_int8_linear(paddle.to_tensor(x), wq,
                                            weight_scale=s, threshold=6.0))
    xt = paddle.to_tensor(x)
    xt.stop_gradient = False
    (Q.weight_only_linear(xt, wq, weight_scale=s) ** 2).sum().backward()
    out["int8_grad_x"] = f32(xt.grad)
    return out


def _qat_cases(paddle):
    nn, q = paddle.nn, paddle.quantization
    rng = np.random.default_rng(7)
    out = {}
    for kind in ("linear", "conv2d"):
        paddle.seed(3)
        if kind == "linear":
            model = nn.Sequential(nn.Linear(12, 16), nn.ReLU(),
                                  nn.Linear(16, 4))
            x = rng.normal(size=(6, 12)).astype(np.float32)
        else:
            model = nn.Sequential(nn.Conv2D(3, 4, 3, padding=1), nn.ReLU(),
                                  nn.Conv2D(4, 2, 1))
            x = rng.normal(size=(2, 3, 8, 8)).astype(np.float32)
        qm = q.QAT(q.QuantConfig()).quantize(model)
        opt = paddle.optimizer.SGD(learning_rate=0.05,
                                   parameters=qm.parameters())
        losses = []
        for _ in range(2):
            loss = (qm(paddle.to_tensor(x)) ** 2).mean()
            loss.backward()
            opt.step()
            opt.clear_grad()
            losses.append(float(f32(loss)))
        out[f"qat_{kind}"] = {
            "losses": np.asarray(losses, np.float32),
            "params": [f32(p) for p in qm.parameters()]}
    x = rng.normal(size=(16, 32)).astype(np.float32)
    for backend in (None, "weight_only_int8"):
        paddle.seed(0)
        model = nn.Sequential(nn.Linear(32, 64), nn.ReLU(), nn.Linear(64, 8))
        ptq = q.PTQ(q.QuantConfig())
        observed = ptq.quantize(model)
        observed(paddle.to_tensor(x))
        deployed = ptq.convert(observed, deploy_backend=backend)
        out[f"ptq_{backend or 'simulation'}"] = f32(
            deployed(paddle.to_tensor(x)))
    return out


def reference_run(paddle):
    """The `resilience_reference` phase's body on the expected place."""
    sparse = {}
    for name, kw in SPARSE_CONFIGS:
        key = name + "".join(f"_{k}={v}" for k, v in kw.items())
        sparse[key] = _sparse_case(paddle, name, kw, scaled=False)
    sparse["Adam_lazy_mode=True_scaled"] = _sparse_case(
        paddle, "Adam", {"lazy_mode": True}, scaled=True)
    return {"sparse": sparse, "quant": _quant_cases(paddle),
            "qat_ptq": _qat_cases(paddle)}


def tiny_trained(paddle, seed=7, steps=2):
    """`(model, opt, scaler)`: the sparse tiny Llama after `steps` steps
    of AdamW(lazy_mode, multi_precision) under a GradScaler, and a draw
    that moves the RNG counter: every kind of state a checkpoint
    carries."""
    paddle.seed(seed)
    model = name_parameters(sparse_embedding(
        paddle.models.llama_layers.llama_tiny(seq=16)))
    opt = paddle.optimizer.AdamW(learning_rate=0.01, lazy_mode=True,
                                 multi_precision=True,
                                 parameters=model.parameters())
    scaler = paddle.amp.GradScaler(init_loss_scaling=512.0,
                                   incr_every_n_steps=1)
    ids, labels = _tiny_batch(paddle, model.config.vocab_size)
    for _ in range(steps):
        loss, _ = model(ids, labels=labels)
        scaler.scale(loss).backward()
        scaler.step(opt)
        scaler.update()
        opt.clear_grad()
    paddle.rand([3])
    return model, opt, scaler


def checkpoint_state(paddle, model, opt, scaler):
    """What a checkpoint of (model, opt, scaler) restores, as numpy arrays
    and Python values: the tensors of `model_state`, the optimizer's
    scalars, the scaler's state and the RNG state."""
    out = {k: f32(t) if t.dtype.is_floating_point else t.cpu().numpy()
           for k, t in model_state(model, opt).items()}
    out["global_step"] = opt.state_dict()["global_step"]
    out["scaler"] = {k: float(np.asarray(v)) for k, v in
                     scaler.state_dict().items()}
    out["rng"] = [tuple(s) for s in paddle.get_rng_state()]
    return out


# ---- Llama-2-7B width: sparse_train, resilient_train, quant_deploy ---------


def sparse_workload(paddle, sparse, layers=lw.LAYERS, seed=0, tiny=False):
    """`(model, opt, sched, ids, labels)`: the Trainer loop's model and
    optimizer (`loop_workload`), AdamW with `lazy_mode=True`, the word
    embedding sparse or dense; `tiny` is `llama_tiny(seq=16)` for the CPU
    rehearsal."""
    paddle.seed(seed)
    layer_mod = paddle.models.llama_layers
    model = name_parameters(layer_mod.llama_tiny(seq=16) if tiny
                            else layer_mod.llama_7b_shaped(
                                num_layers=layers))
    if sparse:
        sparse_embedding(model)
    sched = paddle.optimizer.lr.LinearWarmup(
        paddle.optimizer.lr.CosineAnnealingDecay(lw.BASE_LR, T_max=lw.T_MAX),
        warmup_steps=lw.WARMUP, start_lr=0.0, end_lr=lw.BASE_LR)
    names = lw.decay_names(model)
    opt = paddle.optimizer.AdamW(
        learning_rate=sched, parameters=model.parameters(), beta2=0.95,
        weight_decay=0.01, multi_precision=True, lazy_mode=True,
        apply_decay_param_fun=lambda n: n in names,
        grad_clip=paddle.nn.ClipGradByGlobalNorm(1.0))
    model, opt = paddle.amp.decorate(model, opt, level="O2",
                                     dtype="bfloat16")
    vocab, seq, ignored = (model.config.vocab_size, 16, 4) if tiny \
        else (lw.VOCAB, lw.SEQ, lw.IGNORED)
    rng = np.random.default_rng(0)
    ids = rng.integers(0, vocab, (lw.BATCH, seq))
    labels = rng.integers(0, vocab, (lw.BATCH, seq))
    labels[:, -ignored:] = lw.IGNORE
    return model, opt, sched, paddle.to_tensor(ids), \
        paddle.to_tensor(labels)


def train_step(paddle, work, events=None):
    """One Trainer step of `sparse_workload`'s work; returns the loss."""
    model, opt, sched, ids, labels = work
    return lw._step(paddle, model, opt, sched, ids, labels, events)


def model_state(model, opt):
    """Every tensor a checkpoint of (model, opt) holds, keyed by the
    parameters' structured names (two builds of one model name their
    parameters alike): the parameters, the optimizer's accumulators and
    f32 masters (live torch tensors)."""
    out = {}
    for name, p in model.named_parameters():
        out[f"param.{name}"] = p._data
        for acc, by_param in opt._accumulators.items():
            if id(p) in by_param:
                out[f"{acc}.{name}"] = by_param[id(p)]
        if id(p) in opt._master_weights:
            out[f"master.{name}"] = opt._master_weights[id(p)]
    return out


def guarded_run(paddle, work, manager, steps, nan_at, save_every):
    """`steps` steps of `work` under `StepGuard(save_every=save_every)`;
    the step function returns NaN the first time it runs step `nan_at`.
    Returns the losses by step (the last run of each), the steps the
    guard rolled back to, and the guard."""
    from ..resilience import StepGuard

    model, opt = work[0], work[1]
    fired = []

    def step_fn(i):
        loss = float(f32(train_step(paddle, work)))
        if i == nan_at and not fired:
            fired.append(i)
            return float("nan")
        return loss

    guard = StepGuard(step_fn, manager, model=model, optimizer=opt,
                      save_every=save_every)
    losses, rollbacks, i = {}, [], 0
    while i < steps:
        loss = guard.step(i)
        if loss is None:
            rollbacks.append(guard.last_restored_step)
            i = guard.last_step + 1
            continue
        losses[i] = loss
        i += 1
    manager.wait()
    return losses, rollbacks, guard
