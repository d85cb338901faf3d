"""Tiled tensor-parallel matmul decomposition — compute/collective overlap
(the port of `paddle_tpu/distributed/tp_overlap.py`).

A row-parallel TP matmul followed by ONE big all-reduce serializes the
step: the whole gemm must finish before the first byte moves. The fix is
decomposition: split the gemm's output (N) axis into tiles and reduce
each tile as soon as it is produced. Here each tile's partial sum goes to
`torch.distributed.all_reduce(..., async_op=True)`, so tile k's reduction
runs while tile k+1's gemm is computed; the handles are waited on in tile
order and the tiles concatenated. The JAX package gets the same overlap
from XLA's scheduler, with one `psum` per tile inside `shard_map`.

The serving engines (`serving/tp.py`) run one process per rank; the
collectives run over the tensor-parallel process group `TPInfo.group`,
with whatever backend the caller initialized. A group of None is a tp
axis of one with no collective at all.

Weights may be dense `[..., K, N]` tensors or the weight-only-quantized
`{"q"|"q4" [..., N, K(/2)], "s" [..., N]}` dicts both engines' matmul
helpers route through `nn.quant.dequant_matmul`: tiles slice the
output-channel axis of either layout (a quantized tile is a view of whole
weight rows, so int4 packing never splits a byte), so quantized TP
engines overlap exactly like full-precision ones.
"""
from __future__ import annotations

from typing import Any, Callable, NamedTuple, Optional

import torch
import torch.distributed as dist

__all__ = ["TPInfo", "axis_index", "row_parallel_matmul", "gather_columns",
           "out_features", "slice_out_channels"]


class TPInfo(NamedTuple):
    """The TP execution config threaded through the engines' step cfg.

    - ``group``: the `torch.distributed` process group of the tp axis
      (None: a tp axis of one, no collective);
    - ``size``: number of shards on that axis (tp degree);
    - ``tiles``: row-parallel gemm decomposition factor (1 = the
      sequential single-collective baseline);
    - ``gather_logits``: True finishes the step with an all-gather of
      the vocab-sharded logit shard on the device (the sampler sees
      replicated logits); False returns the shard and the caller
      assembles it on the host — the fully-exposed baseline.
    """

    group: Any
    size: int
    tiles: int
    gather_logits: bool


def axis_index(tp: TPInfo) -> int:
    """This process's shard index on the tp axis (`jax.lax.axis_index`'s
    counterpart): its rank in the tp group, 0 without a group."""
    return 0 if tp.group is None else dist.get_rank(tp.group)


def out_features(w) -> int:
    """Output-channel count of a dense `[..., K, N]` weight or a
    quantized `{"q"|"q4", "s" [..., N]}` dict."""
    if isinstance(w, dict):
        return int(w["s"].shape[-1])
    return int(w.shape[-1])


def slice_out_channels(w, lo: int, hi: int):
    """One output-channel tile of `w` (dense column slice; quantized
    dicts slice the N axis of q/q4 and s — the K/packed axis is left
    whole, so int4 packing never splits a byte). Views, not copies."""
    if isinstance(w, dict):
        out = {"s": w["s"][..., lo:hi]}
        key = "q4" if "q4" in w else "q"
        out[key] = w[key][..., lo:hi, :]
        return out
    return w[..., :, lo:hi]


def _default_mm(x, w):
    return torch.matmul(x, w)


def row_parallel_matmul(x, w, *, group=None, ntiles: int = 1,
                        mm: Optional[Callable] = None):
    """`x [..., K_local] @ w [..., K_local, N]` with the partial sums
    all-reduced over `group`, decomposed into `ntiles` output tiles so
    tile k's reduction overlaps tile k+1's gemm (module docstring).

    `group=None` skips the reduction (a tp axis of one). `ntiles` is
    clamped to the largest divisor of N at or below the request, so an
    awkward N takes fewer tiles instead of failing. One tile is one
    blocking all-reduce. `mm` is the caller's matmul helper (the engines
    pass their quant-routing `_mm`)."""
    mm = mm or _default_mm
    n = out_features(w)
    tiles = max(1, min(int(ntiles), n))
    while n % tiles:
        tiles -= 1
    if tiles == 1:
        y = mm(x, w)
        if group is not None:
            dist.all_reduce(y, group=group)
        return y
    step = n // tiles
    outs, works = [], []
    for k in range(tiles):
        yk = mm(x, slice_out_channels(w, k * step, (k + 1) * step))
        if group is not None:
            works.append(dist.all_reduce(yk, group=group, async_op=True))
        outs.append(yk)
    for work in works:
        work.wait()
    return torch.cat(outs, dim=-1)


def gather_columns(y, group):
    """All-gather a column-parallel result's shards along the last axis:
    shard s's columns land at `[s*N_local, (s+1)*N_local)`, the
    contiguous layout the column split produced them from. A group of
    None returns `y`."""
    if group is None:
        return y
    y = y.contiguous()
    parts = [torch.empty_like(y) for _ in range(dist.get_world_size(group))]
    dist.all_gather(parts, y, group=group)
    return torch.cat(parts, dim=-1)
