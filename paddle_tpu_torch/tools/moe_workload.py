"""The MoE workload, in one place: both `chip_smoke.py` (which checks and
times it) and `paddle_tpu_torch.tools.moe_profile` (which profiles it)
build it here, so the two always measure the same thing.

One `MoELayer` at Mixtral-8x7B's width (`hidden_size` 4096,
`intermediate_size` 14336, `num_local_experts` 8, `num_experts_per_tok`
2, from its published `config.json`) in the JAX layer's expert form:
`StackedExperts` with tanh-gelu and biases (not Mixtral's SwiGLU
experts), the default `GShardGate`, capacity factor 2.0, bf16 weights
from a seeded `torch.Generator` on the card, and B 4 x S 2048 = 8,192
tokens (the train workload's). A step is one forward and one backward of
`y.sum() + aux` from fresh gradients, in one of three runs:
- "ep_kernels": the expert-parallel route (`_ep_moe_fn` on the layer's
  weights over `group`) with `FLAGS_fused_moe_kernels` on: the
  hand-written dispatch and gather kernels;
- "ep_index": the same with the flag off: the index-op route;
- "dense": the layer's dense GShard route (`MoELayer.forward`).

With one card, `group` is a one-rank process group (or None, an ep axis
of one device): every expert is local and the exchange moves the whole
send buffer to itself.
"""
from __future__ import annotations

import torch

D_MODEL, D_HIDDEN, EXPERTS, TOP_K = 4096, 14336, 8, 2
BATCH, SEQ = 4, 2048
TOKENS = BATCH * SEQ
CAPACITY_FACTOR = 2.0
RUNS = ("ep_kernels", "ep_index", "dense")


def one_rank_group(backend="nccl"):
    """A one-rank process group (TCP store on 127.0.0.1, a free port): the
    ep group of a one-card expert-parallel run. The caller destroys it
    (`torch.distributed.destroy_process_group()`)."""
    import socket

    import torch.distributed as dist

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]
    dist.init_process_group(backend, init_method=f"tcp://127.0.0.1:{port}",
                            rank=0, world_size=1)
    return dist.group.WORLD


def expert_flops(capacity, experts=EXPERTS, d=D_MODEL, f=D_HIDDEN):
    """Forward FLOPs of the two expert gemms over every capacity slot,
    empty ones included (the JAX design computes them all)."""
    return 2 * 2 * experts * capacity * d * f


class MoEWorkload:
    """The layer (`layer`), one input batch `x0 [T, H]` and the EP
    capacity `ep_capacity` (`max(1, int(cf * T_local * k / E))` with
    T_local = T on one rank)."""

    def __init__(self, device="cuda", seed=61, group=None):
        from ..incubate.distributed.models.moe import MoELayer

        dev = torch.device(device)
        gen = torch.Generator(device=dev).manual_seed(seed)
        self.layer = MoELayer(d_model=D_MODEL, num_experts=EXPERTS,
                              d_hidden=D_HIDDEN, top_k=TOP_K,
                              capacity_factor=CAPACITY_FACTOR, device=dev,
                              dtype=torch.bfloat16, generator=gen)
        self.x0 = torch.randn((TOKENS, D_MODEL), generator=gen,
                              device=dev).to(torch.bfloat16)
        self.group = group
        self.ep_capacity = max(1, int(CAPACITY_FACTOR * TOKENS * TOP_K
                                      / EXPERTS))
        self.dense_capacity = max(1, int(CAPACITY_FACTOR * TOKENS
                                         / EXPERTS)) * TOP_K

    def forward(self, run, x):
        """`(y, aux)` of `run` on x."""
        from ..framework import flags
        from ..incubate.distributed.models.moe import moe_layer

        if run == "dense":
            y = self.layer(x)
            return y, self.layer.aux_loss
        flags.set_flags({"FLAGS_fused_moe_kernels": run == "ep_kernels"})
        try:
            lay = self.layer
            ex = lay.experts
            return moe_layer._ep_moe_fn(
                x, lay.gate.gate_proj.weight, ex.w1, ex.b1, ex.w2, ex.b2,
                top_k=lay.top_k, capacity=self.ep_capacity,
                activation=ex.activation, group=self.group)
        finally:
            flags.set_flags({"FLAGS_fused_moe_kernels": False})

    def step(self, run, keep=False):
        """One forward and backward of `run` from fresh gradients. With
        `keep`, returns `{"y", "aux", "x", <parameter name>: gradient}`."""
        for p in self.layer.parameters():
            p.grad = None
        x = self.x0.clone().requires_grad_()
        y, aux = self.forward(run, x)
        (y.sum() + aux).backward()
        if not keep:
            return None
        out = {"y": y.detach(), "aux": aux.detach(), "x": x.grad}
        out.update({n: p.grad for n, p in self.layer.named_parameters()})
        return out
