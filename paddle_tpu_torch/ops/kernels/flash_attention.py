"""Flash attention with a hand-written forward, dQ and dK/dV kernel.

The port of `paddle_tpu/ops/pallas/flash_attention.py`, in paddle's
`[B, S, H, D]` layout throughout (the JAX wrapper's swaps to `[B, H, S, D]`
are not carried over: the kernels read every tensor through its strides).
`flash_attention_bshd` calls the custom op
`paddle_tpu_torch::flash_attention` (`torch.ops.paddle_tpu_torch`), whose
forward launches `flash_attention_fwd` (out and lse) and whose autograd
formula calls `paddle_tpu_torch::flash_attention_backward`: it computes
`delta = sum(dO * out)` in f32, as JAX does outside its kernels, then
launches `flash_attention_dq` and `flash_attention_dkv`. A captured
program records both ops by name (`jit.to_static`, `jit.save`), so it
launches the kernels wherever it runs on CUDA tensors. The three kernels
(`csrc/flash_attention.cu`) also cover the JAX package's K/V-streamed
variants, which it takes past `2 * Sk * D * itemsize > 8 MiB`: they stream
K/V through shared memory at any length.

On CPU tensors the plain versions run instead (`flash_attention_fwd_ref`,
`flash_attention_bwd_ref`); a CUDA tensor always launches the kernels or
raises. Semantics are `_fwd_kernel`'s, `_dq_kernel`'s and `_dkv_kernel`'s:
a finite -1e30 mask, top-left causal alignment, `kv_lens` masking columns
`>= kv_lens[b]`, an empty row giving out 0 and lse -1e30, p = 0 on masked
columns in the backward, and native GQA (query head h reads kv head
h // (H / KVH)).
"""
from __future__ import annotations

import ctypes
import math
from typing import Optional, Tuple

import torch

from . import _support

__all__ = ["flash_attention_bshd", "flash_attention_fwd",
           "flash_attention_bwd", "flash_attention_dq", "flash_attention_dkv",
           "flash_attention_fwd_ref",
           "flash_attention_bwd_ref", "supported", "jax_supported",
           "MAX_HEAD_DIM",
           "LAUNCHES_FWD", "LAUNCHES_DQ", "LAUNCHES_DKV"]

NEG_INF = -1e30
MAX_HEAD_DIM = 128

# launches of the CUDA kernels (one per call on CUDA tensors)
LAUNCHES_FWD = _support.launch_counter("flash_attention_fwd")
LAUNCHES_DQ = _support.launch_counter("flash_attention_dq")
LAUNCHES_DKV = _support.launch_counter("flash_attention_dkv")

_DTYPE_CODE = {torch.bfloat16: 0, torch.float32: 1, torch.float16: 2}


def _pick_block(n: int, preferred: int = 128) -> int:
    """`ops/pallas/_support.py` `pick_block`: the largest power-of-two
    block <= preferred dividing n (n itself below 8, else 0)."""
    b = preferred
    while b >= 8:
        if n % b == 0:
            return b
        b //= 2
    return n if n < 8 else 0


def supported(q_shape, k_shape, dtype) -> bool:
    """`flash_attention.py:378-391` (4-D `[B, S, H, D]`, H % KVH == 0,
    float32/bfloat16/float16, both lengths tiled by a block >= 8),
    narrowed to the kernels' head dims: D a multiple of 16, at most 128
    (the JAX rule admits D <= 256)."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    _b, sq, h, d = q_shape
    sk, hk = k_shape[1], k_shape[2]
    if hk == 0 or h % hk != 0:
        return False
    if d <= 0 or d % 16 or d > MAX_HEAD_DIM:
        return False
    if dtype not in _DTYPE_CODE:
        return False
    return _pick_block(sq) >= 8 and _pick_block(sk) >= 8


def jax_supported(q_shape, k_shape, dtype) -> bool:
    """The JAX package's rule itself (`flash_attention.py:378-391`): 4-D,
    H % KVH == 0, D <= 256, float32/bfloat16/float16, both lengths tiled
    by a block >= 8. What it admits and `supported()` does not, a CUDA
    tensor cannot run: `nn.functional.scaled_dot_product_attention`
    raises there instead of running the plain attention."""
    if len(q_shape) != 4 or len(k_shape) != 4:
        return False
    _b, sq, h, d = q_shape
    sk, hk = k_shape[1], k_shape[2]
    if hk == 0 or h % hk != 0 or d > 256 or dtype not in _DTYPE_CODE:
        return False
    return _pick_block(sq) >= 8 and _pick_block(sk) >= 8


# ---------------------------------------------------------------------------
# plain versions
# ---------------------------------------------------------------------------

def _heads(x, group):
    """[B, S, KVH, D] -> f32 [B, H, S, D], kv head h // group for query
    head h."""
    x = x.float().transpose(1, 2)
    return x.repeat_interleave(group, dim=1) if group > 1 else x


def _live(sq, sk, causal, kv_lens, device):
    """[B or 1, 1, Sq, Sk] bool: the columns a row attends to."""
    rows = torch.arange(sq, device=device)[:, None]
    cols = torch.arange(sk, device=device)[None, :]
    live = (rows >= cols) if causal else torch.ones(
        (sq, sk), dtype=torch.bool, device=device)
    live = live[None, None]
    if kv_lens is not None:
        live = live & (cols[None, None] <
                       kv_lens.to(device).long()[:, None, None, None])
    return live


def flash_attention_fwd_ref(q, k, v, causal=False, sm_scale=None,
                            kv_lens=None):
    """Plain version of the forward kernel: q `[B, Sq, H, D]`, k/v
    `[B, Sk, KVH, D]` -> (out `[B, Sq, H, D]` in q's dtype, lse
    `[B, H, Sq]` f32), f32 math."""
    d = q.shape[-1]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    group = q.shape[2] // k.shape[2]
    qf = q.float().transpose(1, 2) * sm_scale
    kf, vf = _heads(k, group), _heads(v, group)
    s = qf @ kf.transpose(-1, -2)
    live = _live(q.shape[1], k.shape[1], causal, kv_lens, q.device)
    s = s.masked_fill(~live, NEG_INF)
    m = s.amax(dim=-1, keepdim=True)
    p = torch.where(live, torch.exp(s - m), 0.0)
    l = p.sum(dim=-1, keepdim=True)
    l_safe = torch.where(l == 0, 1.0, l)
    out = (p @ vf) / l_safe
    lse = (m + torch.log(l_safe)).squeeze(-1)
    return out.transpose(1, 2).to(q.dtype), lse


def flash_attention_bwd_ref(q, k, v, do, lse, delta, causal=False,
                            sm_scale=None, kv_lens=None):
    """Plain version of the dQ and dK/dV kernels on the forward's lse and
    the wrapper's delta (`[B, H, Sq]` f32): -> (dq, dk, dv), dk/dv summed
    over each kv head's group, each in its input's dtype."""
    b, sq, h, d = q.shape
    sk, kvh = k.shape[1], k.shape[2]
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(d)
    group = h // kvh
    qf, dof = q.float().transpose(1, 2), do.float().transpose(1, 2)
    kf, vf = _heads(k, group), _heads(v, group)
    s = sm_scale * (qf @ kf.transpose(-1, -2))
    live = _live(sq, sk, causal, kv_lens, q.device)
    p = torch.where(live, torch.exp(s - lse.float()[..., None]), 0.0)
    dp = dof @ vf.transpose(-1, -2)
    ds = p * (dp - delta.float()[..., None])
    dq = sm_scale * (ds @ kf)
    dk = sm_scale * (ds.transpose(-1, -2) @ qf)
    dv = p.transpose(-1, -2) @ dof
    if group > 1:
        dk = dk.reshape(b, kvh, group, sk, d).sum(dim=2)
        dv = dv.reshape(b, kvh, group, sk, d).sum(dim=2)
    return (dq.transpose(1, 2).to(q.dtype), dk.transpose(1, 2).to(k.dtype),
            dv.transpose(1, 2).to(v.dtype))


# ---------------------------------------------------------------------------
# the kernels
# ---------------------------------------------------------------------------

def _check(q, k, v, causal, kv_lens, *more):
    dev = q.device
    if dev.type != "cuda":
        raise ValueError(f"flash_attention: unsupported device {dev}")
    for name, t in (("k", k), ("v", v)) + more:
        if t.device != dev:
            raise ValueError(f"flash_attention: {name} is on {t.device}, q "
                             f"on {dev}")
        if t.dtype != q.dtype:
            raise ValueError(f"flash_attention: {name} is {t.dtype}, q is "
                             f"{q.dtype}")
    if q.dtype not in _DTYPE_CODE:
        raise ValueError(f"flash_attention: q must be bf16/f32/f16, got "
                         f"{q.dtype}")
    if q.dim() != 4 or k.dim() != 4 or k.shape != v.shape:
        raise ValueError(f"flash_attention: q [B, S, H, D] and k = v "
                         f"[B, S, KVH, D] expected, got {tuple(q.shape)}, "
                         f"{tuple(k.shape)}, {tuple(v.shape)}")
    b, sq, h, d = q.shape
    if k.shape[0] != b or k.shape[3] != d:
        raise ValueError(f"flash_attention: k {tuple(k.shape)} does not "
                         f"match q {tuple(q.shape)}")
    kvh = k.shape[2]
    if kvh == 0 or h % kvh:
        raise ValueError(f"flash_attention: {h} query heads do not group "
                         f"over {kvh} kv heads")
    if d <= 0 or d % 16 or d > MAX_HEAD_DIM:
        raise ValueError(f"flash_attention: head_dim {d} is not a multiple "
                         f"of 16 up to {MAX_HEAD_DIM}")
    if causal and sq != k.shape[1]:
        raise ValueError(f"flash_attention: causal needs Sq == Sk, got "
                         f"{sq} and {k.shape[1]}")
    for name, t in (("q", q), ("k", k), ("v", v)) + more:
        if t.stride(-1) != 1:
            raise ValueError(f"flash_attention: {name} needs a unit "
                             f"head_dim stride, got {t.stride()}")
        if q.dtype != torch.float32 and (
                t.data_ptr() % 16 or any(s % 8 for s in t.stride()[:3])):
            raise ValueError(f"flash_attention: {name} rows must be 16-byte"
                             f" aligned, got strides {t.stride()}")
    if kv_lens is not None and (
            kv_lens.device != dev or kv_lens.dtype != torch.int32
            or kv_lens.shape != (b,) or not kv_lens.is_contiguous()):
        raise ValueError(f"flash_attention: kv_lens must be a contiguous "
                         f"int32 [{b}] on {dev}, got {kv_lens.dtype} "
                         f"{tuple(kv_lens.shape)} on {kv_lens.device}")


_ARGTYPES = {"flash_attention_fwd": 6, "flash_attention_dq": 8,
             "flash_attention_dkv": 9}


def _fn(name):
    fn = getattr(_support.load_library("flash_attention"), name)
    if fn.argtypes is None:
        p = ctypes.c_void_p
        fn.argtypes = [p] * _ARGTYPES[name] + [p, p, ctypes.c_float, p]
        fn.restype = ctypes.c_int
    return fn


def _call(name, counter, q, k, causal, sm_scale, ptrs, strided, kv_lens):
    if strided[4].numel() == 0:     # an empty output: no launch, no count
        return
    b, sq, h, d = q.shape
    dims = (ctypes.c_int * 8)(b, h, k.shape[2], sq, k.shape[1], d,
                              int(causal), _DTYPE_CODE[q.dtype])
    st = []
    for t in strided:
        st += [0, 0, 0] if t is None else list(t.stride()[:3])
    strides = (ctypes.c_longlong * 18)(*st)
    lens = None if kv_lens is None else kv_lens.data_ptr()
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream(q.device).cuda_stream
        rc = _fn(name)(*ptrs, lens, dims, strides, float(sm_scale), stream)
    if rc != 0:
        raise RuntimeError(f"{name} launch failed: CUDA error {rc}")
    counter.add()


def flash_attention_fwd(q, k, v, causal=False, sm_scale=None, kv_lens=None):
    """(out, lse): the forward kernel on CUDA tensors, the plain version on
    CPU tensors."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if q.device.type == "cpu":
        return flash_attention_fwd_ref(q, k, v, causal, sm_scale, kv_lens)
    _check(q, k, v, causal, kv_lens)
    b, sq, h, _d = q.shape
    out = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    lse = torch.empty((b, h, sq), dtype=torch.float32, device=q.device)
    _call("flash_attention_fwd", LAUNCHES_FWD, q, k, causal, sm_scale,
          (q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(),
           lse.data_ptr()), (q, k, v, None, out, None), kv_lens)
    return out, lse


def _bwd_prep(q, k, v, do, lse, delta, causal, kv_lens):
    _check(q, k, v, causal, kv_lens, ("do", do))
    b, sq, h, _d = q.shape
    for name, t in (("lse", lse), ("delta", delta)):
        if t.dtype != torch.float32 or t.shape != (b, h, sq) \
                or not t.is_contiguous() or t.device != q.device:
            raise ValueError(f"flash_attention: {name} must be a contiguous "
                             f"f32 [{b}, {h}, {sq}] on {q.device}")
    return (q.data_ptr(), k.data_ptr(), v.data_ptr(), do.data_ptr(),
            lse.data_ptr(), delta.data_ptr())


def flash_attention_dq(q, k, v, do, lse, delta, causal=False, sm_scale=None,
                       kv_lens=None):
    """dq alone: the dQ kernel (CUDA tensors only)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    common = _bwd_prep(q, k, v, do, lse, delta, causal, kv_lens)
    dq = torch.empty(q.shape, dtype=q.dtype, device=q.device)
    _call("flash_attention_dq", LAUNCHES_DQ, q, k, causal, sm_scale,
          common + (dq.data_ptr(),), (q, k, v, do, dq, None), kv_lens)
    return dq


def flash_attention_dkv(q, k, v, do, lse, delta, causal=False,
                        sm_scale=None, kv_lens=None):
    """(dk, dv) alone: the dK/dV kernel (CUDA tensors only)."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    common = _bwd_prep(q, k, v, do, lse, delta, causal, kv_lens)
    dk = torch.empty(k.shape, dtype=k.dtype, device=q.device)
    dv = torch.empty(v.shape, dtype=v.dtype, device=q.device)
    _call("flash_attention_dkv", LAUNCHES_DKV, q, k, causal, sm_scale,
          common + (dk.data_ptr(), dv.data_ptr()), (q, k, v, do, dk, dv),
          kv_lens)
    return dk, dv


def flash_attention_bwd(q, k, v, do, lse, delta, causal=False,
                        sm_scale=None, kv_lens=None):
    """(dq, dk, dv) from the forward's lse and delta = sum(dO * out)
    (`[B, H, Sq]` f32): the dQ and dK/dV kernels on CUDA tensors, the
    plain version on CPU tensors."""
    if q.device.type == "cpu":
        return flash_attention_bwd_ref(q, k, v, do, lse, delta, causal,
                                       sm_scale, kv_lens)
    dq = flash_attention_dq(q, k, v, do, lse, delta, causal, sm_scale,
                            kv_lens)
    return (dq,) + flash_attention_dkv(q, k, v, do, lse, delta, causal,
                                       sm_scale, kv_lens)


# The forward and the backward are `torch.library` custom ops, so a
# captured program (`jit.to_static`, `jit.save`) records them by name and
# chooses the route where it runs: the kernels on CUDA tensors, the plain
# versions on CPU tensors. Their fake implementations give the shapes a
# capture needs; the launch counters move only in the real ones.

@torch.library.custom_op("paddle_tpu_torch::flash_attention",
                         mutates_args=())
def _flash_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
              kv_lens: Optional[torch.Tensor], causal: bool,
              sm_scale: float) -> Tuple[torch.Tensor, torch.Tensor]:
    return flash_attention_fwd(q, k, v, causal, sm_scale, kv_lens)


@_flash_op.register_fake
def _(q, k, v, kv_lens, causal, sm_scale):
    b, sq, h, _d = q.shape
    return (q.new_empty(q.shape),
            q.new_empty((b, h, sq), dtype=torch.float32))


@torch.library.custom_op("paddle_tpu_torch::flash_attention_backward",
                         mutates_args=())
def _flash_bwd_op(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
                  out: torch.Tensor, do: torch.Tensor, lse: torch.Tensor,
                  kv_lens: Optional[torch.Tensor], causal: bool,
                  sm_scale: float
                  ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """delta = sum(dO * out) in f32, as JAX computes it outside its
    kernels, then the dQ and dK/dV kernels (their plain version on CPU
    tensors)."""
    if do.stride(-1) != 1 or do.data_ptr() % 16 \
            or any(s % 8 for s in do.stride()[:3]):
        do = do.contiguous()
    delta = (do.float() * out.float()).sum(dim=-1).transpose(1, 2) \
        .contiguous()
    return flash_attention_bwd(q, k, v, do, lse, delta, causal, sm_scale,
                               kv_lens)


@_flash_bwd_op.register_fake
def _(q, k, v, out, do, lse, kv_lens, causal, sm_scale):
    return q.new_empty(q.shape), k.new_empty(k.shape), v.new_empty(v.shape)


def _flash_setup(ctx, inputs, output):
    q, k, v, kv_lens, causal, sm_scale = inputs
    out, lse = output
    ctx.mark_non_differentiable(lse)
    ctx.save_for_backward(q, k, v, out, lse, kv_lens)
    ctx.causal, ctx.sm_scale = causal, sm_scale


def _flash_backward(ctx, do, _dlse):
    q, k, v, out, lse, kv_lens = ctx.saved_tensors
    if torch.is_grad_enabled():
        # create_graph: the gradient must itself be differentiable
        return _differentiable_bwd(ctx, q, k, v, kv_lens, do)
    dq, dk, dv = _flash_bwd_op(q, k, v, out, do, lse, kv_lens, ctx.causal,
                               ctx.sm_scale)
    return dq, dk, dv, None, None, None


_flash_op.register_autograd(_flash_backward, setup_context=_flash_setup)


def _differentiable_bwd(ctx, q, k, v, kv_lens, do):
    """The backward under `create_graph=True`. The dQ and dK/dV kernels
    have no derivative, so a CUDA tensor raises
    `KernelNotDifferentiableError`; on CPU tensors the gradient is that of
    the plain forward, taken on the tape, so it differentiates again (the
    saved lse would otherwise enter as a constant)."""
    if q.device.type != "cpu":
        raise _support.KernelNotDifferentiableError(
            "flash_attention_dq / flash_attention_dkv")
    need = ctx.needs_input_grad[:3]
    wrt = [t for t, n in zip((q, k, v), need) if n]
    ref, _ = flash_attention_fwd_ref(q, k, v, ctx.causal, ctx.sm_scale,
                                     kv_lens)
    gs = iter(torch.autograd.grad(ref, wrt, do, create_graph=True))
    return (*(next(gs) if n else None for n in need), None, None, None)


def flash_attention_bshd(q, k, v, causal=False, sm_scale=None, kv_lens=None):
    """Flash attention in `[B, S, H, D]`: q `[B, Sq, H, D]`, k/v
    `[B, Sk, KVH, D]` (H % KVH == 0) -> out `[B, Sq, H, D]`, differentiable
    in q, k and v. `kv_lens [B]` masks key positions >= kv_lens[b]."""
    if sm_scale is None:
        sm_scale = 1.0 / math.sqrt(q.shape[-1])
    if kv_lens is not None:
        kv_lens = kv_lens.to(device=q.device, dtype=torch.int32).contiguous()
    out, _lse = _flash_op(q, k, v, kv_lens, bool(causal), float(sm_scale))
    return out
