"""The paddle-style model path's workloads, in one place for
`chip_smoke.py` (its `jit_reference` and `jit_layer` phases) and the
tests that rehearse them on the CPU.

- `reference_models(paddle)`: small f32 Layers (an MLP `Sequential`, the
  attention half of `eager_workload.decoder_layer` and a whole decoder
  layer, head dim 32) built from `paddle.seed`.
- `reference_run(paddle, models, path)`: each model's eager forward, its
  `jit.to_static` forward and gradients, the `jit.save` -> `jit.load`
  round trip and the inference `Predictor` at batch 1, 3 and 7 (one
  program with a dynamic batch), on the expected place; it returns the
  results as numpy arrays by name, so a card run can be held to a CPU
  run.
- `layer_run(paddle, cfg, dtype, path, ...)`: the `jit_layer` phase's
  body. Two copies of `decoder_layer` from one seed take `steps`
  `optimizer.AdamW` steps each (the training workload's settings, f32
  masters), one eagerly and
  one through `jit.to_static`, on the same input; then the eager layer
  is exported (`jit.save` with `InputSpec([None, seq, hidden])`, eval
  mode) and served by `inference.create_predictor` at batch 1 and 2. It
  returns the losses, the gradients of both runs and the outputs of the
  Predictor beside the eager eval forward, with host times and the
  counts `launches()` gives after each part.
"""
from __future__ import annotations

import os
import time

import numpy as np
import torch

from .eager_workload import decoder_layer
from .train_workload import ADAMW

__all__ = ["reference_models", "reference_run", "layer_run", "program_ops"]
# the reference models' widths: hidden 64, 2 heads of 32, MLP 96, S 16
REF = dict(hidden=64, heads=2, ffn=96, seq=16)


def reference_models(paddle):
    """{name: Layer} of small f32 models from `paddle.seed(21)`."""
    nn = paddle.nn
    paddle.seed(21)
    return {"mlp": nn.Sequential(nn.Linear(8, 16), nn.GELU(),
                                 nn.Linear(16, 4)),
            "attention": decoder_layer(paddle, REF["hidden"], REF["heads"],
                                       REF["ffn"], REF["seq"], mlp=False),
            "decoder": decoder_layer(paddle, REF["hidden"], REF["heads"],
                                     REF["ffn"], REF["seq"])}


def _input_shape(name, batch):
    return [batch, 8] if name == "mlp" else [batch, REF["seq"],
                                              REF["hidden"]]


def reference_run(paddle, models, path):
    """The models through eager, to_static, jit.save / jit.load and the
    Predictor on the expected place; numpy results by name."""
    rng = np.random.default_rng(22)
    out = {}
    for name, layer in models.items():
        xs = {b: rng.standard_normal(_input_shape(name, b)).astype(
            "float32") for b in (1, 3, 7)}
        x = paddle.to_tensor(xs[3], stop_gradient=False)
        eager = layer(x)
        (eager ** 2).mean().backward()
        out[f"{name}.eager"] = eager.numpy()
        out[f"{name}.eager_dx"] = x.grad.numpy()
        grads = {n: p.grad.numpy() for n, p in layer.named_parameters()}
        layer.clear_gradients()
        static = paddle.jit.to_static(layer)
        x2 = paddle.to_tensor(xs[3], stop_gradient=False)
        y = static(x2)
        (y ** 2).mean().backward()
        out[f"{name}.static"] = y.numpy()
        out[f"{name}.static_dx"] = x2.grad.numpy()
        for n, p in layer.named_parameters():
            out[f"{name}.eager_grad.{n}"] = grads[n]
            out[f"{name}.static_grad.{n}"] = p.grad.numpy()
        layer.clear_gradients()
        prefix = os.path.join(path, name)
        spec = _input_shape(name, None)
        paddle.jit.save(layer, prefix, input_spec=[
            paddle.jit.InputSpec(spec, "float32")])
        loaded = paddle.jit.load(prefix)
        config = paddle.inference.Config(prefix + ".pdmodel",
                                         prefix + ".pdiparams")
        if paddle.get_device() == "cpu:0":
            config.disable_gpu()
        predictor = paddle.inference.create_predictor(config)
        layer.eval()
        for b, xb in xs.items():
            out[f"{name}.eval.b{b}"] = layer(paddle.to_tensor(xb)).numpy()
            out[f"{name}.loaded.b{b}"] = loaded(paddle.to_tensor(xb)).numpy()
            out[f"{name}.predictor.b{b}"] = predictor.run([xb])[0]
        layer.train()
    return out


def program_ops(graph_module):
    """{op: count} of the port's custom ops (the kernels) and of softmax
    (the plain attention) in a captured program's graph."""
    ops = {}
    for node in graph_module.graph.nodes:
        name = str(node.target)
        if "paddle_tpu_torch" in name or "softmax" in name:
            ops[name] = ops.get(name, 0) + 1
    return ops


def _norm_rel(a, b):
    a, b = a.detach().float(), b.detach().float()
    return float((a - b).norm() / b.norm().clamp_min(1e-30))


def layer_run(paddle, cfg, dtype, path, steps=2, seed=17,
              sync=lambda: None, launches=dict):
    """The `jit_layer` body (see the module docstring) on the expected
    place. `launches()` gives the kernel launches since its last call."""
    F32 = "float32"
    b, s, h = cfg["batch"], cfg["seq"], cfg["hidden"]
    rng = np.random.default_rng(seed)
    x_np = rng.standard_normal((2 * b, s, h)).astype(F32)
    x = paddle.to_tensor(x_np[:b]).astype(dtype)
    layers, opts = [], []
    for _ in range(2):
        paddle.seed(seed)
        layer = decoder_layer(paddle, h, cfg["heads"], cfg["ffn"], s)
        layer.astype(dtype)
        layers.append(layer)
        opts.append(paddle.optimizer.AdamW(parameters=layer.parameters(),
                                           **ADAMW))
    eager, static_layer = layers
    static = paddle.jit.to_static(static_layer)
    r = {"launches": {}, "ms": {}, "loss": {}, "grads": {}}

    def step(name, fwd, layer, opt, i):
        sync()
        t0 = time.perf_counter()
        loss = (fwd(x).astype(F32) ** 2).mean()
        loss.backward()
        sync()
        r["ms"][f"{name}{i}"] = (time.perf_counter() - t0) * 1e3
        r["launches"][f"{name}{i}"] = launches()
        r["loss"][f"{name}{i}"] = loss._data.detach().clone()
        r["grads"][f"{name}{i}"] = {n: p.grad._data.clone()
                                    for n, p in layer.named_parameters()}
        opt.step()
        opt.clear_grad()
        launches()

    launches()
    for i in range(steps):
        step("eager", eager, eager, opts[0], i)
        step("static", static, static_layer, opts[1], i)
    r["static_vs_eager"] = {
        f"step{i}": {"loss": _norm_rel(r["loss"][f"static{i}"],
                                       r["loss"][f"eager{i}"]),
                     **{n: _norm_rel(g, r["grads"][f"eager{i}"][n])
                        for n, g in r["grads"][f"static{i}"].items()}}
        for i in range(steps)}
    r["bit_equal"] = all(
        torch.equal(r["loss"][f"static{i}"], r["loss"][f"eager{i}"])
        and all(torch.equal(g, r["grads"][f"eager{i}"][n])
                for n, g in r["grads"][f"static{i}"].items())
        for i in range(steps))
    del r["grads"]
    # export the eager layer (eval mode) with a dynamic batch
    os.makedirs(os.path.dirname(path) or ".", exist_ok=True)
    sync()
    t0 = time.perf_counter()
    paddle.jit.save(eager, path, input_spec=[
        paddle.jit.InputSpec([None, s, h], dtype)])
    r["export_s"] = time.perf_counter() - t0
    r["pdiparams_bytes"] = os.path.getsize(path + ".pdiparams")
    r["pdmodel_bytes"] = os.path.getsize(path + ".pdmodel")
    launches()
    t0 = time.perf_counter()
    config = paddle.inference.Config(path + ".pdmodel", path + ".pdiparams")
    if paddle.get_device() == "cpu:0":
        config.disable_gpu()
    predictor = paddle.inference.create_predictor(config)
    sync()
    r["load_s"] = time.perf_counter() - t0
    r["program_ops"] = program_ops(predictor._layer._program)
    eager.eval()
    r["serve"] = {}
    for batch in (b, 2 * b):
        xb = paddle.to_tensor(x_np[:batch]).astype(dtype)
        with paddle.no_grad():
            ref = eager(xb)
        sync()
        launches()
        walls = []
        for _ in range(3):
            sync()
            t0 = time.perf_counter()
            (got,) = predictor.run([xb])
            sync()
            walls.append((time.perf_counter() - t0) * 1e3)
        r["serve"][f"b{batch}"] = {
            "launches_per_run": {k: v / 3 for k, v in launches().items()},
            "norm_rel_err": _norm_rel(got._data, ref._data),
            "ms": sorted(walls)[1], "shape": got.shape}
    eager.train()
    return r
