"""MoE dispatch into capacity slots and the gather back, with hand-written
kernels.

The port of `paddle_tpu/ops/pallas/fused_moe.py`:
- `moe_dispatch(x_rows, e_idx, p_idx, n_experts, capacity)`: token rows
  `[N, H]` to capacity slots `[E, C, H]`, row i at `(e_idx[i], p_idx[i])`,
  `p_idx < 0` dropped, slots no row routes to zero;
- `moe_gather(buf, e_idx, p_idx)`: `[E, C, H]` back to `[N, H]`, dropped
  rows zero.

Each is a `torch.autograd.Function` whose backward is the other (the JAX
custom VJPs). On CUDA tensors both directions launch the hand-written
Hopper kernels (`csrc/fused_moe.cu`) or raise; on CPU tensors they run the
kernels' plain versions `moe_dispatch_ref` / `moe_gather_ref`, which
transcribe `_scatter_call` / `_gather_call`. The contract is the JAX
docstring's: the slots of the kept rows are unique per expert,
`0 <= e < E` and `p < C`.

One deliberate difference from the JAX kernel (ROADMAP Queue C): a
dropped row gathers exact zeros, where `_gather_call` multiplies the
clipped slot's row by 0 and so turns a NaN or inf there into NaN.

`xla_dispatch` / `xla_gather` are the JAX package's route with the flag
off, ported as written (index ops with a clipped slot and a multiply by
`keep`); they are no stand-in for the kernels. `FLAGS_fused_moe_kernels`
chooses between the two routes in the expert-parallel MoE path; it
defaults to False, as in JAX, and `kernels_available()` is its value.
"""
from __future__ import annotations

import ctypes

import torch

from ...framework import flags as _flags
from . import _support

__all__ = ["moe_dispatch", "moe_gather", "moe_dispatch_ref",
           "moe_gather_ref", "xla_dispatch", "xla_gather",
           "kernels_available", "LAUNCHES_DISPATCH", "LAUNCHES_GATHER"]

# launches of the CUDA kernels (one per call on CUDA tensors, forward or
# backward)
LAUNCHES_DISPATCH = _support.launch_counter("moe_dispatch")
LAUNCHES_GATHER = _support.launch_counter("moe_gather")

_flags.define_flag("fused_moe_kernels", False,
                   "use the hand-written MoE dispatch/gather kernels in the "
                   "EP path (default: the index-op route, as in the JAX "
                   "package)")


def kernels_available() -> bool:
    """`FLAGS_fused_moe_kernels`: with it on, CPU tensors run the plain
    versions and CUDA tensors launch the kernels or raise."""
    return bool(_flags.flag_value("fused_moe_kernels"))


# ---------------------------------------------------------------------------
# plain versions of the kernels
# ---------------------------------------------------------------------------

def moe_dispatch_ref(x_rows, e_idx, p_idx, n_experts, capacity):
    """`_scatter_call` (`fused_moe.py:50-79`): rows to an `[E, C + 1, H]`
    buffer of zeros, a dropped row (`p_idx < 0`) to the sacrificial slot
    C, which is sliced off."""
    hdim = x_rows.shape[-1]
    e = e_idx.long()
    slot = torch.where(p_idx >= 0, p_idx, capacity).long()
    out = torch.zeros((n_experts, capacity + 1, hdim), dtype=x_rows.dtype,
                      device=x_rows.device)
    out[e, slot] = x_rows
    return out[:, :capacity].contiguous()


def moe_gather_ref(buf, e_idx, p_idx):
    """`_gather_call` (`fused_moe.py:82-103`): the row of the slot
    `(e, clip(p, 0, C - 1))`, and exact zeros for a dropped row (the JAX
    kernel multiplies by `keep` instead; see the module docstring)."""
    n_experts, capacity, hdim = buf.shape
    keep = p_idx >= 0
    flat = e_idx.long() * capacity + p_idx.clamp(0, capacity - 1).long()
    rows = buf.reshape(n_experts * capacity, hdim)[flat]
    return torch.where(keep[:, None], rows, torch.zeros_like(rows))


# ---------------------------------------------------------------------------
# the JAX package's flag-off route
# ---------------------------------------------------------------------------

def xla_dispatch(x_rows, e_idx, p_idx, n_experts, capacity):
    """`fused_moe.py:149-155`: a scatter-add of `x * keep` at the clipped
    slot into zeros."""
    hdim = x_rows.shape[-1]
    keep = p_idx >= 0
    pc = p_idx.clamp(0, capacity - 1).long()
    out = torch.zeros((n_experts, capacity, hdim), dtype=x_rows.dtype,
                      device=x_rows.device)
    return out.index_put((e_idx.long(), pc),
                         x_rows * keep[:, None].to(x_rows.dtype),
                         accumulate=True)


def xla_gather(buf, e_idx, p_idx):
    """`fused_moe.py:158-161`: the clipped slot's row times `keep`."""
    keep = p_idx >= 0
    pc = p_idx.clamp(0, buf.shape[1] - 1).long()
    return buf[e_idx.long(), pc] * keep[:, None].to(buf.dtype)


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _lib(name):
    fn = getattr(_support.load_library("fused_moe"), name)
    if fn.argtypes is None:
        p, i, ll = ctypes.c_void_p, ctypes.c_int, ctypes.c_longlong
        fn.argtypes = ([p, p, p, p, p, i, i, i, ll, i, p]
                       if name == "moe_dispatch"
                       else [p, p, p, p, i, i, i, ll, i, p])
        fn.restype = ctypes.c_int
    return fn


def _unit(row_bytes, *ptrs):
    """The widest copy unit (16, 8, 4, 2 or 1 bytes) dividing the row's
    bytes and every base address."""
    unit = 16
    while unit > 1 and (row_bytes % unit
                        or any(ptr % unit for ptr in ptrs)):
        unit //= 2
    return unit


def _check(name, data, e_idx, p_idx, n_rows):
    if data.device.type != "cuda" or e_idx.device != data.device \
            or p_idx.device != data.device:
        raise ValueError(f"{name}: tensors must be on one CUDA device, got "
                         f"{data.device}, {e_idx.device}, {p_idx.device}")
    if not data.is_contiguous():
        raise ValueError(f"{name}: the data must be contiguous")
    for t, what in ((e_idx, "e_idx"), (p_idx, "p_idx")):
        if t.dtype != torch.int32 or t.dim() != 1 or t.shape[0] != n_rows \
                or not t.is_contiguous():
            raise ValueError(f"{name}: {what} must be a contiguous int32 "
                             f"[{n_rows}], got {t.dtype} {tuple(t.shape)}")


def _launch_dispatch(x_rows, e_idx, p_idx, n_experts, capacity):
    if x_rows.dim() != 2:
        raise ValueError(f"moe_dispatch: x_rows must be [N, H], got "
                         f"{tuple(x_rows.shape)}")
    n_rows, hdim = x_rows.shape
    _check("moe_dispatch", x_rows, e_idx, p_idx, n_rows)
    out = torch.empty((n_experts, capacity, hdim), dtype=x_rows.dtype,
                      device=x_rows.device)
    if out.numel() == 0:            # nothing to write: no launch, no count
        return out
    slot_map = torch.empty((n_experts * capacity,), dtype=torch.int32,
                           device=x_rows.device)
    row_bytes = hdim * x_rows.element_size()
    unit = _unit(row_bytes, x_rows.data_ptr(), out.data_ptr())
    with torch.cuda.device(x_rows.device):
        stream = torch.cuda.current_stream(x_rows.device).cuda_stream
        rc = _lib("moe_dispatch")(
            x_rows.data_ptr(), e_idx.data_ptr(), p_idx.data_ptr(),
            out.data_ptr(), slot_map.data_ptr(), n_rows, n_experts,
            capacity, row_bytes, unit, stream)
    if rc != 0:
        raise RuntimeError(f"moe_dispatch launch failed: CUDA error {rc}")
    LAUNCHES_DISPATCH.add()
    return out


def _launch_gather(buf, e_idx, p_idx):
    if buf.dim() != 3:
        raise ValueError(f"moe_gather: buf must be [E, C, H], got "
                         f"{tuple(buf.shape)}")
    n_experts, capacity, hdim = buf.shape
    n_rows = e_idx.shape[0]
    _check("moe_gather", buf, e_idx, p_idx, n_rows)
    out = torch.empty((n_rows, hdim), dtype=buf.dtype, device=buf.device)
    if out.numel() == 0:
        return out
    row_bytes = hdim * buf.element_size()
    unit = _unit(row_bytes, buf.data_ptr(), out.data_ptr())
    with torch.cuda.device(buf.device):
        stream = torch.cuda.current_stream(buf.device).cuda_stream
        rc = _lib("moe_gather")(
            buf.data_ptr(), e_idx.data_ptr(), p_idx.data_ptr(),
            out.data_ptr(), n_rows, n_experts, capacity, row_bytes, unit,
            stream)
    if rc != 0:
        raise RuntimeError(f"moe_gather launch failed: CUDA error {rc}")
    LAUNCHES_GATHER.add()
    return out


def _dispatch(x_rows, e_idx, p_idx, n_experts, capacity):
    if x_rows.device.type == "cpu":
        return moe_dispatch_ref(x_rows, e_idx, p_idx, n_experts, capacity)
    return _launch_dispatch(x_rows, e_idx, p_idx, n_experts, capacity)


def _gather(buf, e_idx, p_idx):
    if buf.device.type == "cpu":
        return moe_gather_ref(buf, e_idx, p_idx)
    return _launch_gather(buf, e_idx, p_idx)


class _Dispatch(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x_rows, e_idx, p_idx, n_experts, capacity):
        ctx.save_for_backward(e_idx, p_idx)
        return _dispatch(x_rows, e_idx, p_idx, n_experts, capacity)

    @staticmethod
    def backward(ctx, g):
        e_idx, p_idx = ctx.saved_tensors
        return _gather(g.contiguous(), e_idx, p_idx), None, None, None, None


class _Gather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, buf, e_idx, p_idx):
        ctx.save_for_backward(e_idx, p_idx)
        ctx.n_experts, ctx.capacity = buf.shape[0], buf.shape[1]
        return _gather(buf, e_idx, p_idx)

    @staticmethod
    def backward(ctx, g):
        e_idx, p_idx = ctx.saved_tensors
        return _dispatch(g.contiguous(), e_idx, p_idx, ctx.n_experts,
                         ctx.capacity), None, None


def moe_dispatch(x_rows, e_idx, p_idx, n_experts, capacity):
    """Scatter token rows `[N, H]` into `[E, C, H]` capacity slots
    (`fused_moe.py:107-113`); e_idx / p_idx `[N]` int32, p_idx < 0 =
    dropped. Differentiable in x_rows: the backward is `moe_gather`."""
    return _Dispatch.apply(x_rows.contiguous(), e_idx, p_idx,
                           int(n_experts), int(capacity))


def moe_gather(buf, e_idx, p_idx):
    """Gather rows back from `[E, C, H]` capacity slots to `[N, H]`
    (dropped rows give zeros; `fused_moe.py:130-133`). Differentiable in
    buf: the backward is `moe_dispatch`."""
    return _Gather.apply(buf.contiguous(), e_idx, p_idx)
