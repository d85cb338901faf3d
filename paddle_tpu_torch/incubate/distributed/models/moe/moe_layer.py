"""Mixture-of-Experts with expert parallelism.

The port of `paddle_tpu/incubate/distributed/models/moe/moe_layer.py`, as
`torch.nn.Module`s: the gates `NaiveGate` / `SwitchGate` / `GShardGate`,
`StackedExperts`, and `MoELayer` with its two routes:

- the dense GShard path: dispatch and combine are products with a
  `[T, E, C]` one-hot, the experts run as stacked batched gemms;
- the expert-parallel path (`_ep_local_fn` / `_ep_moe_fn`): routing is a
  scatter of token rows into `[E, C, H]` capacity slots
  (`ops/kernels/fused_moe.py`: the hand-written dispatch and gather
  kernels with `FLAGS_fused_moe_kernels` on, the index-op route with it
  off), the device exchange an all-to-all over the ep process group.

Weights keep paddle's layouts, so they move between the packages
unchanged: the gate weight is `[d_model, E]`, the experts `w1 [E, H, F]`,
`b1 [E, 1, F]`, `w2 [E, F, H]`, `b2 [E, 1, H]`.

Expert parallelism maps the JAX mesh onto `torch.distributed`: the ep
axis is `moe_group`, a process group of the ep ranks, each rank running
the same program on its own shard of the tokens (JAX's `P("ep")` input)
and holding its `E / n` experts (the `Shard(0)` placement); the gate
weight is replicated (`P()`). With a group of `n > 1` ranks, `E % n == 0`,
stacked experts, a `NaiveGate`-family gate and `use_alltoall`,
`MoELayer.forward` takes the EP path on the rank's tokens. The global
token count is `n` times the local one, so JAX's `T % n == 0` holds by
construction. Otherwise the experts stay whole and the layer takes the
dense path, as JAX does when the ep axis has one device. Gradients are
those of the global loss `sum over ranks of the rank's outputs' loss +
aux` (aux counted once): the gate weight's gradient is summed over the
group, the aux mean's backward gives each rank 1/n of the cotangent, and
the all-to-all's backward is the all-to-all of the cotangent.

Semantics kept from the JAX package (ROADMAP Queue C):
- `jax.nn.gelu` is the tanh approximation by default, so "gelu" is
  `F.gelu(approximate="tanh")`;
- top-k breaks ties the `lax.top_k` way, lower index first (a stable
  descending sort), on both devices;
- the capacities differ: dense `max(1, int(cf * T / E)) * max(1, k)`, EP
  `max(1, int(cf * T_local * k / E))`;
- every token's top-1 claims a slot before any top-2 on both routes;
- the dense route's top-k weights are renormalised in the probabilities'
  dtype (when k > 1); the EP route casts them to x's dtype first;
- the EP gate's logits are f32, the dense gate's in x's dtype, so in
  bf16 the two routes may route differently.
"""
from __future__ import annotations

import math
from typing import Optional

import torch
import torch.distributed as dist
import torch.nn.functional as TF
from torch import nn

from .....ops.kernels import fused_moe as _fmoe
from .....ops.kernels._support import resolve_device

__all__ = ["MoELayer", "NaiveGate", "SwitchGate", "GShardGate",
           "StackedExperts"]


def _group_size(group) -> int:
    return 1 if group is None else dist.get_world_size(group)


def _factory(device, dtype):
    return {"device": resolve_device(device),
            "dtype": dtype or torch.float32}


def _uniform_(t, bound, generator):
    """`Uniform(-bound, bound)` drawn from `generator` on t's device."""
    with torch.no_grad():
        u = torch.rand(t.shape, generator=generator, device=t.device,
                       dtype=torch.float32)
        t.copy_((2 * u - 1) * bound)
    return t


# ---------------------------------------------------------------------------
# gates
# ---------------------------------------------------------------------------

class _Weight(nn.Module):
    """A bias-free paddle `Linear`: `weight` `[in, out]`, `x @ weight`."""

    def __init__(self, in_features, out_features, generator=None,
                 **factory):
        super().__init__()
        self.weight = nn.Parameter(torch.empty((in_features, out_features),
                                               **factory))
        # paddle's Linear default, XavierUniform
        _uniform_(self.weight.data,
                  math.sqrt(6.0 / (in_features + out_features)), generator)

    def forward(self, x):
        return x @ self.weight


class BaseGate(nn.Module):
    def __init__(self, d_model: int, num_experts: int, device=None,
                 dtype=None, generator=None):
        super().__init__()
        self.d_model = d_model
        self.num_experts = num_experts
        self.gate_proj = _Weight(d_model, num_experts, generator=generator,
                                 **_factory(device, dtype))
        self.loss = None


class NaiveGate(BaseGate):
    """top-k softmax gate, no capacity dropping (reference
    `gate/naive_gate.py`): returns the probabilities `[T, E]`, softmax in
    x's dtype."""

    def __init__(self, d_model, num_experts, top_k=2, **factory):
        super().__init__(d_model, num_experts, **factory)
        self.top_k = top_k

    def forward(self, x):
        return torch.softmax(self.gate_proj(x), dim=-1)


class SwitchGate(NaiveGate):
    """top-1 gate with load-balancing loss (reference `gate/switch_gate.py`;
    the aux loss is set on `.loss` by MoELayer.forward). switch_eps is
    accepted for API parity."""

    def __init__(self, d_model, num_experts, top_k=1, switch_eps=0.1,
                 capacity_factor=1.25, **factory):
        super().__init__(d_model, num_experts, top_k=1, **factory)
        self.capacity_factor = capacity_factor


class GShardGate(NaiveGate):
    """top-2 gate with GShard aux loss (reference `gate/gshard_gate.py`;
    aux loss = E * sum_e fraction_e * mean_prob_e, set on `.loss` by
    MoELayer.forward). random_routing is accepted for API parity."""

    def __init__(self, d_model, num_experts, top_k=2, capacity_factor=2.0,
                 random_routing=True, **factory):
        super().__init__(d_model, num_experts, top_k=2, **factory)
        self.capacity_factor = capacity_factor


def _aux_loss_fn(probs):
    """GShard load-balancing loss: E * sum_e f_e * P_e (f_e the
    non-differentiable share of tokens whose top-1 is e, P_e the mean gate
    probability); argmax takes the first maximum, as `jnp.argmax`."""
    e = probs.shape[-1]
    me = probs.mean(dim=0)
    top1 = probs.argmax(dim=-1)
    ce = TF.one_hot(top1, e).to(probs.dtype).mean(dim=0)
    return e * (me * ce.detach()).sum()


def _top_k(probs, k):
    """`jax.lax.top_k`: the k largest, descending, the lower index first
    on ties (`torch.topk` promises no order among ties)."""
    vals, idx = torch.sort(probs, dim=-1, descending=True, stable=True)
    return vals[..., :k], idx[..., :k]


# ---------------------------------------------------------------------------
# stacked experts
# ---------------------------------------------------------------------------

def _act(name):
    return {"gelu": lambda v: TF.gelu(v, approximate="tanh"),
            "relu": lambda v: torch.maximum(v, torch.zeros_like(v)),
            "silu": TF.silu}[name]


def _experts_fn(x, w1, b1, w2, b2, activation):
    """`[E, C, H] -> [E, C, H]`: two batched gemms, each accumulated in f32
    and rounded to x's dtype before its bias (cuBLAS accumulates 16-bit
    products in f32, as the einsum with `preferred_element_type=f32` then
    `astype` does)."""
    h = _act(activation)(torch.bmm(x, w1) + b1)
    return torch.bmm(h, w2) + b2


class StackedExperts(nn.Module):
    """num_experts FFNs as stacked weights `[E, ...]`; an expert-parallel
    MoELayer keeps the rank's `E / n` of them (the Shard(0) placement)."""

    def __init__(self, num_experts, d_model, d_hidden, activation="gelu",
                 device=None, dtype=None, generator=None):
        super().__init__()
        factory = _factory(device, dtype)
        self.w1 = nn.Parameter(_uniform_(
            torch.empty((num_experts, d_model, d_hidden), **factory),
            1.0 / math.sqrt(d_model), generator))
        self.b1 = nn.Parameter(torch.zeros((num_experts, 1, d_hidden),
                                           **factory))
        self.w2 = nn.Parameter(_uniform_(
            torch.empty((num_experts, d_hidden, d_model), **factory),
            1.0 / math.sqrt(d_hidden), generator))
        self.b2 = nn.Parameter(torch.zeros((num_experts, 1, d_model),
                                           **factory))
        self.activation = activation

    def forward(self, expert_inputs):
        """expert_inputs: `[E, C, H] -> [E, C, H]`."""
        return _experts_fn(expert_inputs, self.w1, self.b1, self.w2,
                           self.b2, self.activation)


# ---------------------------------------------------------------------------
# the dense GShard route
# ---------------------------------------------------------------------------

def _dispatch_combine_fn(x, probs, capacity, top_k):
    """GShard dense dispatch (`moe_layer.py:156-186`): returns (combine
    `[T, E, C]`, dispatch `[T, E, C]`), both in x's dtype."""
    t, e = probs.shape
    topv, topi = _top_k(probs, top_k)                      # [T, k]
    # combine weights are the top-k probs renormalised over the selected
    # experts (top-1 gates keep the raw prob)
    if top_k > 1:
        topv = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    # position of each token within its expert's queue, per k-slot in
    # turn, so every top-1 fills before any top-2 (GShard's priority)
    combine = torch.zeros((t, e, capacity), dtype=probs.dtype,
                          device=probs.device)
    counts = torch.zeros((e,), dtype=torch.int32, device=probs.device)
    slots = torch.arange(capacity, device=probs.device)
    for k in range(top_k):
        sel = TF.one_hot(topi[:, k], e).to(torch.int32)        # [T, E]
        pos_in_expert = (torch.cumsum(sel, dim=0, dtype=torch.int32) - 1) \
            + counts[None, :]
        within = pos_in_expert < capacity
        pos = pos_in_expert.clamp(0, capacity - 1)
        onehot_pos = (pos[:, :, None] == slots).to(probs.dtype)
        mask = sel.to(probs.dtype) * within.to(probs.dtype)
        combine = combine + topv[:, k, None, None] * mask[:, :, None] * \
            onehot_pos
        counts = counts + sel.sum(dim=0, dtype=torch.int32)
    dispatch_mask = (combine > 0).to(x.dtype)
    return combine.to(x.dtype), dispatch_mask


def _einsum_dispatch_fn(disp, x):
    """`tec,th->ech`: one gemm over the tokens."""
    t, e, c = disp.shape
    return (disp.reshape(t, e * c).t() @ x).reshape(e, c, x.shape[-1])


def _einsum_combine_fn(combine, expert_out):
    """`tec,ech->th`: one gemm over the (expert, slot) pairs."""
    t, e, c = combine.shape
    return combine.reshape(t, e * c) @ expert_out.reshape(e * c, -1)


# ---------------------------------------------------------------------------
# the expert-parallel all-to-all route
# ---------------------------------------------------------------------------

class _AllToAll(torch.autograd.Function):
    """`all_to_all_single` with equal splits over `group`: chunk j of the
    leading dim goes to rank j, and the chunk from rank i lands at i. It
    is its own transpose, so the backward exchanges the cotangent the
    same way."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        x = x.contiguous()
        out = torch.empty_like(x)
        dist.all_to_all_single(out, x, group=group)
        return out

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous()
        out = torch.empty_like(g)
        dist.all_to_all_single(out, g, group=ctx.group)
        return out, None


class _ReplicatedInput(torch.autograd.Function):
    """Identity on a weight every rank holds whole (shard_map's `P()`
    input); the backward sums its gradient over the group."""

    @staticmethod
    def forward(ctx, w, group):
        ctx.group = group
        return w.view_as(w)

    @staticmethod
    def backward(ctx, g):
        g = g.clone()
        dist.all_reduce(g, group=ctx.group)
        return g, None


class _Mean(torch.autograd.Function):
    """`lax.pmean` of a value every rank computes: the mean over the
    group. The output is replicated and its loss counted once, so each
    rank's input receives 1/n of the cotangent."""

    @staticmethod
    def forward(ctx, v, group):
        ctx.n = _group_size(group)
        out = v.clone()
        dist.all_reduce(out, group=group)
        return out / ctx.n

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def _exchange(send, group):
    """`lax.all_to_all(send, split_axis=0, concat_axis=1, tiled=True)`:
    `[E, C, H] -> [E/n, n*C, H]`, the rank's experts with every rank's
    capacity slots for them, in rank order. The identity for
    `group=None` (an ep axis of one device)."""
    if group is None:
        return send
    n = _group_size(group)
    e, c, h = send.shape
    recv = _AllToAll.apply(send, group)              # [n * E/n, C, H]
    return recv.reshape(n, e // n, c, h).permute(1, 0, 2, 3) \
        .reshape(e // n, n * c, h)


def _exchange_back(out, group):
    """`lax.all_to_all(out, split_axis=1, concat_axis=0, tiled=True)`:
    `[E/n, n*C, H] -> [E, C, H]`, back to the tokens' owners."""
    if group is None:
        return out
    n = _group_size(group)
    el, nc, h = out.shape
    c = nc // n
    send = out.reshape(el, n, c, h).permute(1, 0, 2, 3)
    return _AllToAll.apply(send, group).reshape(n * el, c, h)


def _ep_routing(x, gate_w, top_k, capacity):
    """The EP route's gate and slots (`moe_layer.py:369-393`): returns
    (probs `[t, E]` f32, topi `[t, k]`, the rows' weights tv `[k*t]` in x's
    dtype, their experts `[k*t]` and slots `[k*t]` int32, -1 = dropped).
    Row `j*t + i` is token i's j-th choice, so every token's top-1 claims
    a slot before any top-2 (GShard's priority)."""
    e_total = gate_w.shape[1]
    # f32 logits (`preferred_element_type`): 16-bit products are exact in
    # f32, and the f32 product sums in f32
    logits = x.float() @ gate_w.float()
    probs = torch.softmax(logits, dim=-1)
    topv, topi = _top_k(probs, top_k)                          # [t, k]
    topv = topv.to(x.dtype)
    if top_k > 1:
        topv = topv / topv.sum(dim=-1, keepdim=True).clamp_min(1e-9)
    ti = topi.t().reshape(-1)                                  # [k*t]
    tv = topv.t().reshape(-1)
    sel = TF.one_hot(ti, e_total).to(torch.int32)              # [k*t, E]
    pos_all = torch.cumsum(sel, dim=0, dtype=torch.int32) - 1
    pos = pos_all.gather(1, ti[:, None])[:, 0]
    keep = pos < capacity
    slot = torch.where(keep, pos.clamp(0, capacity - 1), -1)
    return probs, topi, tv, ti.to(torch.int32), slot.to(torch.int32)


def _ep_local_fn(x, gate_w, w1, b1, w2, b2, *, top_k, capacity, group,
                 activation):
    """One rank's MoE (`moe_layer.py:351-423`): gate -> scatter into an
    `[E, C, H]` send buffer -> all-to-all -> the local experts ->
    all-to-all back -> gather and combine. Per-rank memory is
    `O(E * C * H)`, never the dense `[T, E, C]` one-hot."""
    t, hdim = x.shape
    e_total = gate_w.shape[1]
    if group is not None:
        gate_w = _ReplicatedInput.apply(gate_w, group)
    probs, topi, tv, ti32, slot = _ep_routing(x, gate_w, top_k, capacity)
    keep = slot >= 0
    tok = torch.arange(t, device=x.device).repeat(top_k)
    xs = x[tok] * keep[:, None].to(x.dtype)
    # the dispatch: the hand-written kernel with the flag on, the index
    # ops otherwise
    if _fmoe.kernels_available():
        send = _fmoe.moe_dispatch(xs, ti32, slot, e_total, capacity)
    else:
        send = _fmoe.xla_dispatch(xs, ti32, slot, e_total, capacity)
    recv = _exchange(send, group)                    # [E/n, n*C, H]
    out = _experts_fn(recv, w1, b1, w2, b2, activation)
    back = _exchange_back(out, group)                # [E, C, H]
    if _fmoe.kernels_available():
        rows = _fmoe.moe_gather(back, ti32, slot)
    else:
        rows = _fmoe.xla_gather(back, ti32, slot)
    gathered = rows * (tv * keep.to(x.dtype))[:, None]
    y = gathered.reshape(top_k, t, hdim).sum(dim=0)
    # GShard aux loss on the local tokens, averaged over the ep group
    me = probs.mean(dim=0)
    ce = TF.one_hot(topi[:, 0], e_total).to(probs.dtype).mean(dim=0)
    aux = e_total * (me * ce.detach()).sum()
    if group is not None:
        aux = _Mean.apply(aux, group)
    return y, aux


def _ep_moe_fn(x, gate_w, w1, b1, w2, b2, *, top_k, capacity, activation,
               group=None):
    """The EP route on this rank (`moe_layer.py:426-441`, whose shard_map
    runs `_ep_local_fn` on every device): x `[T_local, H]` is the rank's
    tokens, w1..b2 its `E / n` experts, gate_w `[H, E]` whole.
    `group=None` is an ep axis of one device: the exchanges are the
    identity, as `lax.all_to_all` over one device is. Returns
    (y `[T_local, H]`, aux)."""
    n = _group_size(group)
    e_total = gate_w.shape[1]
    if e_total % n or w1.shape[0] != e_total // n:
        raise ValueError(f"_ep_moe_fn: {e_total} experts over {n} ranks "
                         f"need {e_total // n} local experts, got "
                         f"{w1.shape[0]}")
    return _ep_local_fn(x, gate_w, w1, b1, w2, b2, top_k=top_k,
                        capacity=capacity, group=group,
                        activation=activation)


# ---------------------------------------------------------------------------
# the layer
# ---------------------------------------------------------------------------

class MoELayer(nn.Module):
    """reference `MoELayer` (`incubate/distributed/models/moe/moe_layer.py:
    263`): gate -> dispatch -> experts (EP) -> combine.

    experts: a StackedExperts, OR a list of per-expert modules (reference
    style; run one by one on the dense path), OR None with (d_model,
    d_hidden) given. gate: None / "gshard", "switch", "naive", a dict with
    "type" and "top_k", or a module. moe_group: the ep process group
    (module docstring). device / dtype / generator make the weights a
    layer builds itself (`device=None` is the CUDA card; with experts
    given, their device and dtype); recompute_interval and other keyword
    arguments are accepted for API parity.
    """

    def __init__(self, d_model=None, experts=None, gate=None, top_k=2,
                 num_experts=None, d_hidden=None, capacity_factor=2.0,
                 moe_group=None, recompute_interval=0, device=None,
                 dtype=None, generator: Optional[torch.Generator] = None,
                 **kwargs):
        super().__init__()
        if isinstance(gate, dict):
            top_k = gate.get("top_k", top_k)
            gate = gate.get("type", "gshard")
        if device is None and isinstance(experts, (list, tuple,
                                                   StackedExperts)):
            mods = experts if isinstance(experts, (list, tuple)) \
                else [experts]
            first = next(p for m in mods for p in m.parameters())
            device, dtype = first.device, dtype or first.dtype
        factory = {"device": device, "dtype": dtype, "generator": generator}
        if isinstance(experts, (list, tuple)):
            self.experts_list = list(experts)
            for i, ex in enumerate(self.experts_list):
                self.add_module(f"expert_{i}", ex)
            self.experts = None
            num_experts = len(self.experts_list)
            if d_model is None:
                raise ValueError("d_model is required with an expert list")
        elif isinstance(experts, StackedExperts):
            self.experts = experts
            self.experts_list = None
            num_experts = experts.w1.shape[0]
            if d_model is None:
                d_model = experts.w1.shape[1]
        else:
            if num_experts is None or d_model is None:
                raise ValueError("need experts or (num_experts, d_model)")
            self.experts = StackedExperts(num_experts, d_model,
                                          d_hidden or 4 * d_model,
                                          **factory)
            self.experts_list = None
        self.num_experts = num_experts
        self.top_k = top_k
        self.capacity_factor = capacity_factor
        if gate is None or gate == "gshard":
            self.gate = GShardGate(d_model, num_experts, top_k=min(top_k, 2),
                                   capacity_factor=capacity_factor,
                                   **factory)
        elif gate == "switch":
            self.gate = SwitchGate(d_model, num_experts, **factory)
            self.top_k = 1
        elif gate == "naive":
            self.gate = NaiveGate(d_model, num_experts, top_k=top_k,
                                  **factory)
        elif isinstance(gate, nn.Module):
            self.gate = gate
        else:
            raise ValueError(f"unknown gate {gate}")
        self.moe_group = moe_group
        self.use_alltoall = True
        self.aux_loss = None
        # (rank, n) once this rank holds only its E / n experts
        self.ep_shard = None
        self._place_experts()

    @torch.no_grad()
    def _place_experts(self):
        """Keep this rank's `E / n` stacked experts (the JAX `Shard(0)`
        placement over ep) and make the gate weight the group's rank 0's,
        when the EP route applies: a group of n > 1 ranks, `E % n == 0`,
        stacked experts and a `NaiveGate`-family gate."""
        g = self.moe_group
        n = _group_size(g)
        if g is None or n <= 1 or self.num_experts % n \
                or self.experts is None \
                or not isinstance(self.gate, NaiveGate):
            return
        rank = dist.get_rank(g)
        per = self.num_experts // n
        for name in ("w1", "b1", "w2", "b2"):
            full = getattr(self.experts, name)
            setattr(self.experts, name, nn.Parameter(
                full[rank * per:(rank + 1) * per].clone()))
        self.ep_shard = (rank, n)
        for p in self.gate.parameters():
            dist.broadcast(p.data, src=dist.get_global_rank(g, 0), group=g)

    def _ep_group(self):
        """The ep group when the all-to-all route applies."""
        if not self.use_alltoall or self.ep_shard is None:
            return None
        return self.moe_group

    def forward(self, x):
        """x: `[..., H]`, this rank's tokens, flattened internally. With an
        ep group the layer routes through the all-to-all dispatch and
        combine; otherwise the dense GShard formulation."""
        orig_shape = x.shape
        xt = x.reshape(-1, orig_shape[-1])              # [T, H]
        t = xt.shape[0]

        group = self._ep_group()
        if group is not None:
            cap = max(1, int(self.capacity_factor * t * max(1, self.top_k)
                             / self.num_experts))
            ex = self.experts
            y, aux = _ep_moe_fn(xt, self.gate.gate_proj.weight, ex.w1,
                                ex.b1, ex.w2, ex.b2, top_k=self.top_k,
                                capacity=cap, activation=ex.activation,
                                group=group)
            self.gate.loss = aux
            self.aux_loss = aux
            return y.reshape(orig_shape)
        if self.ep_shard is not None:
            raise NotImplementedError(
                "MoELayer: this rank holds only its experts of an "
                "expert-parallel layer; the dense path needs all of them "
                "(set use_alltoall back to True)")

        probs = self.gate(xt)                           # [T, E]
        if isinstance(self.gate, (SwitchGate, GShardGate)):
            aux = _aux_loss_fn(probs)
            self.gate.loss = aux
            self.aux_loss = aux
        else:
            self.aux_loss = None
        capacity = max(1, int(self.capacity_factor * t / self.num_experts)) \
            * max(1, self.top_k)
        combine, disp = _dispatch_combine_fn(xt, probs, capacity, self.top_k)
        # dispatch: [T,E,C] x [T,H] -> [E,C,H]
        expert_in = _einsum_dispatch_fn(disp, xt)
        if self.experts is not None:
            expert_out = self.experts(expert_in)
        else:
            expert_out = torch.stack([layer(expert_in[e]) for e, layer in
                                      enumerate(self.experts_list)], dim=0)
        # combine: [T,E,C] x [E,C,H] -> [T,H]
        out = _einsum_combine_fn(combine, expert_out)
        return out.reshape(orig_shape)
