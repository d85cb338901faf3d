"""Carry weights from the JAX package into the port.

The two packages name and lay out their parameters alike (paddle names,
Linear weights `[in, out]`), so the state exported by
`paddle_tpu.jit.state_arrays` as numpy arrays loads as it is: a Llama
model with `from_jax_state`, an MoE layer with `moe_from_jax_state`. A
JAX `MLPLMEngine`'s `params` (embed, w1, b1, w2, b2) load into the port's
`MLPLMEngine` with `mlp_from_jax_params`. A Layer model loads the JAX
model's `state_dict()` with `layers_from_jax_state`, buffers included:
a quantized model's `WeightOnlyLinear`s carry their int8 / packed int4
/ fp8 `weight` and f32 `weight_scale` under the JAX package's names.
JAX state whose arrays are sharded (DistTensors over a mesh, or arrays
with a `NamedSharding`) becomes port DistTensors with the same mesh and
placements with `dist_from_jax_state`, read by duck typing: the port
imports no JAX.
"""
from __future__ import annotations

from typing import Dict, Optional

import numpy as np
import torch

from .models.llama import LlamaConfig, LlamaForCausalLM

__all__ = ["from_jax_state", "layers_from_jax_state", "moe_from_jax_state",
           "mlp_from_jax_params", "dist_from_jax_state"]


@torch.no_grad()
def from_jax_state(state: Dict[str, np.ndarray], config: LlamaConfig,
                   device=None,
                   model: Optional[LlamaForCausalLM] = None
                   ) -> LlamaForCausalLM:
    """Build a trainable `LlamaForCausalLM` holding `state` (name -> numpy
    array, e.g. `{k: np.asarray(v) for k, v in
    state_arrays(jax_model).items()}`), or load `state` into `model` in
    place (its device and dtype stay) and return it. Tied embeddings (no
    `lm_head.weight`) and GQA follow from `config`. `device=None` means
    the CUDA card, as everywhere in the port. Every parameter must be
    present with its exact shape."""
    if model is None:
        model = LlamaForCausalLM(config, device=device)
    params = dict(model.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the config: missing "
                       f"{missing}, unexpected {extra}")
    for name, p in params.items():
        arr = np.asarray(state[name])
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return model


def layers_from_jax_state(state: Dict[str, np.ndarray], model):
    """Load `state` (name -> numpy array, as for `from_jax_state`) into a
    Layer model (`models.llama_layers.LlamaForCausalLM`, or any Layer) in
    place, each value in its tensor's dtype and on its device, and return
    it. The state is the model's `state_dict`: every parameter and
    persistable buffer (BatchNorm's `_mean` / `_variance`, a
    `WeightOnlyLinear`'s quantized `weight` and `weight_scale`) must be
    present with its exact shape, and nothing else."""
    missing, unexpected = model.set_state_dict(
        {k: np.asarray(v) for k, v in state.items()})
    if missing or unexpected:
        raise KeyError(f"state does not match the model: missing "
                       f"{sorted(missing)}, unexpected {sorted(unexpected)}")
    return model


@torch.no_grad()
def moe_from_jax_state(state: Dict[str, np.ndarray], layer):
    """Load `state` (name -> numpy array, as `state_arrays` gives it for a
    JAX `MoELayer`: `gate.gate_proj.weight` `[d, E]`, `experts.w1`, `b1`,
    `w2`, `b2`, or an expert list's `expert_{i}.*`) into the port's
    `MoELayer` in place, and return it. An expert-parallel layer takes its
    rank's `E / n` slice of each stacked expert tensor. Every parameter
    must be present with its exact shape."""
    params = dict(layer.named_parameters())
    missing = sorted(set(params) - set(state))
    extra = sorted(set(state) - set(params))
    if missing or extra:
        raise KeyError(f"state does not match the layer: missing {missing}, "
                       f"unexpected {extra}")
    shard = layer.ep_shard
    for name, p in params.items():
        arr = np.asarray(state[name])
        if shard is not None and name.startswith("experts."):
            rank, n = shard
            per = arr.shape[0] // n
            if arr.shape[0] != per * n:
                raise ValueError(f"{name}: {arr.shape[0]} experts do not "
                                 f"split over {n} ranks")
            arr = arr[rank * per:(rank + 1) * per]
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return layer


@torch.no_grad()
def mlp_from_jax_params(params: Dict[str, np.ndarray], engine):
    """Load a JAX `MLPLMEngine`'s `params` (name -> array: `embed`
    `[V, D]`, `w1` `[2D, 2D]`, `b1`, `w2` `[2D, V]`, `b2`; e.g.
    `{k: np.asarray(v) for k, v in jax_engine.params.items()}`) into the
    port's `MLPLMEngine` in place (its device stays), and return it. The
    weights must be dense f32 arrays of the engine's exact shapes (a
    weight-only quantized JAX head has no counterpart in the port)."""
    mine = engine.params
    missing = sorted(set(mine) - set(params))
    extra = sorted(set(params) - set(mine))
    if missing or extra:
        raise KeyError(f"params do not match the engine: missing "
                       f"{missing}, unexpected {extra}")
    for name, p in mine.items():
        if isinstance(params[name], dict):
            raise ValueError(f"{name}: a quantized weight; the port's "
                             "MLPLMEngine holds dense f32 weights")
        arr = np.asarray(params[name], np.float32)
        if tuple(arr.shape) != tuple(p.shape):
            raise ValueError(f"{name}: shape {arr.shape} != {tuple(p.shape)}")
        p.copy_(torch.tensor(arr))
    return engine


def _jax_meta(t):
    """The port's `DistMeta` of a JAX package Tensor (its `_dist_meta`,
    Partial included) or of a jax.Array with a `NamedSharding` (its mesh
    and spec, as the JAX package's `infer_meta_from_array` reads them);
    None for an array on one device."""
    from .distributed import placement as pl
    from .distributed.auto_parallel.sharding_bridge import DistMeta
    from .distributed.process_mesh import ProcessMesh

    meta = getattr(t, "_dist_meta", None)
    if meta is not None:
        mesh = ProcessMesh(np.asarray(meta.mesh.mesh), list(
            meta.mesh.dim_names))
        out = []
        for p in meta.placements:
            kind = type(p).__name__
            out.append(pl.Shard(p.dim) if kind == "Shard" else
                       pl.Partial(p.reduce_type) if kind == "Partial"
                       else pl.Replicate())
        return DistMeta(mesh, out)
    arr = getattr(t, "_data", t)
    sh = getattr(arr, "sharding", None)
    jm = getattr(sh, "mesh", None)
    if jm is None or not hasattr(sh, "spec"):
        return None
    ids = np.vectorize(lambda d: d.id)(jm.devices)
    mesh = ProcessMesh(ids, list(jm.axis_names))
    out = [pl.Replicate() for _ in range(mesh.ndim)]
    for d, entry in enumerate(sh.spec):
        if entry is None:
            continue
        for ax in (entry if isinstance(entry, tuple) else (entry,)):
            out[mesh.dim_names.index(ax)] = pl.Shard(d)
    return DistMeta(mesh, out)


def dist_from_jax_state(state: Dict[str, object], device=None) -> dict:
    """`{name: Tensor}` of `state` (name -> JAX package Tensor or
    jax.Array): each value copied to `device` (None: the card), and a
    sharded one a DistTensor with its mesh and placements, so every
    rank's shard is the JAX device's of the same id."""
    from .core.tensor import Tensor
    from .distributed.auto_parallel.sharding_bridge import set_meta

    out = {}
    for name, t in state.items():
        t_out = Tensor(np.asarray(getattr(t, "_data", t)), place=device)
        set_meta(t_out, _jax_meta(t))
        out[name] = t_out
    return out
