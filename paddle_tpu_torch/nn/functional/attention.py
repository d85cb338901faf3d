"""The attention functionals in paddle's `[B, S, H, D]` layout: the port
of `paddle_tpu/nn/functional/attention.py`.

`scaled_dot_product_attention` without a mask is routed as
`attention.py:94-118` and `flash_attention.maybe_flash` route it
(`_route`): the flash kernels (`ops/kernels/flash_attention.py`) when
`sdp_kernel` leaves the flash backend on, their `supported()` holds and
not (causal with Sq != Sk); the plain composite `_sdpa_fn` for what the
JAX rule itself refuses (`jax_supported()`: D > 256, causal with Sq !=
Sk), with the flash backend off, and for CPU tensors. A CUDA tensor
that the JAX rule gives to its kernel and the port's kernels do not take
(D of 144-256, or D not a multiple of 16) raises `NotImplementedError`:
it never runs the plain attention where the JAX package runs its kernel.
With `attn_mask` it is JAX's composite `sdpa_mask` (a bool mask keeps
where True, a float mask is added to the scores), never the kernel.
Dropout (`dropout_p` while `training`) follows, with the JAX package's
mask bits (`common.dropout`).

`flash_attention` and `flash_attn_qkvpacked` take the same route and
return `(out, softmax)`, the softmax (`fa_probs`: f32 scores over a
float64 scale, so float64, as JAX's) only with `return_softmax`. `flash_attn_unpadded` / `flash_attn_varlen_qkvpacked`
(packed `[total, H, D]` tokens cut by `cu_seqlens`), `flashmask_attention`
(column-wise start / end rows expanded to a dense mask) and
`sparse_attention` (a CSR pattern expanded to a dense mask) are the JAX
package's composites; it has no kernel for them either.

Eager `Tensor` inputs go through `dispatch.apply` and come back as
`Tensor`s; plain `torch.Tensor` inputs to `scaled_dot_product_attention`
without a mask give a plain `torch.Tensor`."""
from __future__ import annotations

import math

import torch

from ...core import dispatch
from ...core.tensor import Tensor
from ...ops._helpers import as_tensor
from ...ops.kernels import flash_attention as _flash

__all__ = ["scaled_dot_product_attention", "flash_attention",
           "flash_attn_qkvpacked", "flash_attn_unpadded",
           "flash_attn_varlen_qkvpacked", "flashmask_attention",
           "sparse_attention", "sdp_kernel"]

NEG_INF = -1e30

_sdp_backend = {"flash": True, "mem_efficient": True, "math": True}


def sdp_kernel(enable_flash=True, enable_math=True,
               enable_mem_efficient=True):
    """A context that selects the attention backends, as paddle's sdp
    selector does; with `enable_flash=False` the unmasked attention takes
    the plain composite."""

    class _Ctx:
        def __enter__(self):
            self._prev = dict(_sdp_backend)
            _sdp_backend.update(flash=enable_flash, math=enable_math,
                                mem_efficient=enable_mem_efficient)

        def __exit__(self, *a):
            _sdp_backend.update(self._prev)
            return False

    return _Ctx()


def _sdpa_fn(q, k, v, causal, scale=None, mask=None):
    """`attention.py:43-75`: f32 scores, a -1e30 mask (causal aligned to
    the bottom right; a bool `mask` keeps where True, a float one is
    added), GQA by repeating K/V heads, probabilities cast to q's dtype
    before the product with V."""
    q, k, v = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    if k.shape[1] != q.shape[1]:
        rep = q.shape[1] // k.shape[1]
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)
    if scale is None:
        scale = 1.0 / math.sqrt(q.shape[-1])
    scores = (q.float() @ k.float().transpose(-1, -2)) * scale
    sq, skv = q.shape[2], k.shape[2]
    if causal:
        keep = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        scores = scores.masked_fill(~keep, NEG_INF)
    if mask is not None:
        if mask.dtype == torch.bool:
            scores = scores.masked_fill(~mask, NEG_INF)
        else:
            scores = scores + mask.to(scores.dtype)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return (probs @ v).transpose(1, 2)


def _route(q_shape, k_shape, dtype, is_causal, device_type,
           flash=True) -> str:
    """"flash" (the kernels; their plain versions on CPU tensors),
    "plain" (`_sdpa_fn`) or "raise". With the flash backend off
    (`sdp_kernel`) every shape is "plain", as the JAX package then skips
    its kernel. Inside a capture (`jit.to_static`, `jit.save`) a shape the
    JAX rule gives to its kernel takes "flash" whatever the capture's
    device: the recorded op then runs the plain version on CPU tensors
    and, on CUDA tensors, the kernel or its typed refusal (`ValueError`),
    never the plain attention."""
    if not flash or (is_causal and q_shape[1] != k_shape[1]):
        return "plain"
    if _flash.supported(q_shape, k_shape, dtype):
        return "flash"
    if _flash.jax_supported(q_shape, k_shape, dtype):
        if torch.compiler.is_exporting():
            return "flash"
        if device_type == "cuda":
            return "raise"
    return "plain"


def _sdpa(query, key, value, *, is_causal, flash=True):
    route = _route(tuple(query.shape), tuple(key.shape), query.dtype,
                   is_causal, query.device.type, flash)
    if route == "flash":
        return _flash.flash_attention_bshd(query, key, value,
                                           causal=is_causal)
    if route == "raise":
        raise NotImplementedError(
            f"scaled_dot_product_attention: head dim {query.shape[-1]} is "
            f"not taken by the port's flash kernels (D a multiple of 16, at "
            f"most {_flash.MAX_HEAD_DIM}), and the JAX package runs its "
            f"kernel there (D <= 256)")
    return _sdpa_fn(query, key, value, is_causal)


dispatch.register_op("sdpa", _sdpa)
dispatch.register_op("sdpa_mask", lambda q, k, v, mask, *, causal, scale:
                     _sdpa_fn(q, k, v, causal, scale, mask))


def _dropout(out, p, training):
    if p and training:
        from .common import dropout

        out = dropout(out, p=p, training=training)
    return out


def scaled_dot_product_attention(query, key, value, attn_mask=None,
                                 dropout_p=0.0, is_causal=False,
                                 training=True, name=None):
    """q `[B, Sq, H, D]`, k/v `[B, Sk, KVH, D]` -> `[B, Sq, H, D]`."""
    if not any(isinstance(t, Tensor)
               for t in (query, key, value, attn_mask)):
        if attn_mask is None:
            out = _sdpa(query, key, value, is_causal=is_causal,
                        flash=_sdp_backend["flash"])
        else:
            out = _sdpa_fn(query, key, value, is_causal, None, attn_mask)
        return _dropout(Tensor._wrap(out), dropout_p, training)._data
    q, k, v = as_tensor(query), as_tensor(key), as_tensor(value)
    if attn_mask is None:
        attrs = {"is_causal": bool(is_causal)}
        if not _sdp_backend["flash"]:
            attrs["flash"] = False
        out = dispatch.apply("sdpa", [q, k, v], attrs)
    else:
        out = dispatch.apply("sdpa_mask", [q, k, v, as_tensor(attn_mask)],
                             {"causal": bool(is_causal), "scale": None})
    return _dropout(out, dropout_p, training)


def _fa_probs(q, k, v, *, causal):
    qq, kk = q.transpose(1, 2), k.transpose(1, 2)
    # f32 products divided by a numpy float64 in JAX: float64 scores
    scores = (qq.float() @ kk.float().transpose(-1, -2)).double() \
        / math.sqrt(q.shape[-1])
    if causal:
        sq, skv = qq.shape[2], kk.shape[2]
        keep = torch.ones((sq, skv), dtype=torch.bool,
                          device=q.device).tril(diagonal=skv - sq)
        scores = scores.masked_fill(~keep, NEG_INF)
    return torch.softmax(scores, dim=-1)


dispatch.register_op("fa_probs", _fa_probs)


def flash_attention(query, key, value, dropout=0.0, causal=False,
                    return_softmax=False, fixed_seed_offset=None,
                    rng_name="", training=True, name=None):
    """`(out, softmax)`; the softmax (float64 `[B, H, Sq, Sk]`) is None
    unless `return_softmax`."""
    out = scaled_dot_product_attention(query, key, value, None, dropout,
                                       causal, training)
    if return_softmax:
        return out, dispatch.apply("fa_probs", [as_tensor(query),
                                                as_tensor(key),
                                                as_tensor(value)],
                                   {"causal": bool(causal)})
    return out, None


def _unpadded_fn(q, k, v, cq, ck, *, scale, causal):
    tq, tk, d = q.shape[0], k.shape[0], q.shape[-1]
    if scale is None:
        scale = 1.0 / math.sqrt(d)
    pos_q = torch.arange(tq, device=q.device)
    pos_k = torch.arange(tk, device=q.device)
    seg_q = torch.searchsorted(cq[1:].contiguous(), pos_q, right=True)
    seg_k = torch.searchsorted(ck[1:].contiguous(), pos_k, right=True)
    scores = torch.einsum("qhd,khd->hqk", q.float(), k.float()) * scale
    same = seg_q[:, None] == seg_k[None, :]
    if causal:
        rel_q = pos_q - cq[seg_q]
        rel_k = pos_k - ck[seg_k]
        same = same & (rel_q[:, None] >= rel_k[None, :])
    scores = scores.masked_fill(~same[None], NEG_INF)
    probs = torch.softmax(scores, dim=-1).to(q.dtype)
    return torch.einsum("hqk,khd->qhd", probs, v)


dispatch.register_op("flash_attn_unpadded", _unpadded_fn)


def flash_attn_unpadded(query, key, value, cu_seqlens_q, cu_seqlens_k,
                        max_seqlen_q, max_seqlen_k, scale=None, dropout=0.0,
                        causal=False, return_softmax=False,
                        fixed_seed_offset=None, rng_name="", training=True,
                        name=None):
    """Variable-length attention over packed `[total, H, D]` tokens: each
    token attends within its own `cu_seqlens` segment (causal from the
    segment's start)."""
    out = dispatch.apply("flash_attn_unpadded",
                         [as_tensor(query), as_tensor(key), as_tensor(value),
                          as_tensor(cu_seqlens_q), as_tensor(cu_seqlens_k)],
                         {"scale": scale, "causal": bool(causal)})
    return _dropout(out, dropout, training), None


def flash_attn_qkvpacked(qkv, dropout=0.0, causal=False, return_softmax=False,
                         fixed_seed_offset=None, rng_name="", training=True,
                         name=None):
    """qkv `[B, S, 3, H, D]` unpacked, then `flash_attention`."""
    from ...ops.manipulation import split, squeeze

    q, k, v = (squeeze(t, 2) for t in split(as_tensor(qkv), 3, axis=2))
    return flash_attention(q, k, v, dropout=dropout, causal=causal,
                           return_softmax=return_softmax, training=training)


def flash_attn_varlen_qkvpacked(qkv, cu_seqlens_q, cu_seqlens_k,
                                max_seqlen_q, max_seqlen_k, scale=None,
                                dropout=0.0, causal=False,
                                return_softmax=False, training=True,
                                name=None):
    """qkv `[total, 3, H, D]` unpacked, then `flash_attn_unpadded`."""
    from ...ops.manipulation import split, squeeze

    q, k, v = (squeeze(t, 1) for t in split(as_tensor(qkv), 3, axis=1))
    return flash_attn_unpadded(q, k, v, cu_seqlens_q, cu_seqlens_k,
                               max_seqlen_q, max_seqlen_k, scale=scale,
                               dropout=dropout, causal=causal,
                               return_softmax=return_softmax,
                               training=training)


def flashmask_attention(query, key, value, startend_row_indices=None,
                        dropout=0.0, causal=False, window_size=None,
                        name=None):
    """FlashMask attention: `startend_row_indices` `[B, H|1, S, 1|2|4]`
    gives, per key column, the rows masked out (from start, or start to
    end; two bands with 4), expanded to a dense bool mask for the masked
    composite; without it the plain (causal) attention."""
    query = as_tensor(query)
    if startend_row_indices is None:
        return scaled_dot_product_attention(query, key, value,
                                            is_causal=causal,
                                            dropout_p=dropout)
    idx = as_tensor(startend_row_indices)._data
    nidx, s = idx.shape[-1], idx.shape[2]
    rows = torch.arange(s, device=idx.device)[:, None]
    cols = torch.arange(s, device=idx.device)[None, :]

    def band(lo_col, hi_col):
        m = rows[None, None] >= idx[..., lo_col][:, :, None, :]
        if hi_col is not None and nidx > hi_col:
            m = m & (rows[None, None] < idx[..., hi_col][:, :, None, :])
        return m

    masked = band(0, 1 if nidx >= 2 else None)
    if causal:
        allow = (rows >= cols)[None, None] & ~masked
    else:
        if nidx >= 4:
            masked = masked | band(2, 3)
        allow = ~masked
    return scaled_dot_product_attention(query, key, value,
                                        attn_mask=Tensor._wrap(allow),
                                        dropout_p=dropout)


def sparse_attention(query, key, value, sparse_csr_offset,
                     sparse_csr_columns, key_padding_mask=None,
                     attn_mask=None, name=None):
    """Attention over a CSR pattern (`offset` `[B, H, S+1]`, `columns`
    `[B, H, nnz]`) in the reference's `[B, H, S, D]` layout, expanded to a
    dense bool mask for the masked composite."""
    from ...ops.manipulation import transpose

    query = as_tensor(query)
    off = as_tensor(sparse_csr_offset)._data
    cols = as_tensor(sparse_csr_columns)._data
    b, h, s, _ = query._data.shape
    e = torch.arange(cols.shape[-1], device=cols.device)
    # entry e belongs to row r iff off[r] <= e < off[r + 1]
    in_row = (e[None, None, None, :] >= off[..., :-1, None]) \
        & (e[None, None, None, :] < off[..., 1:, None])
    rows_for_e = in_row.to(torch.int32).argmax(dim=2)
    allow = torch.zeros((b, h, s, s), dtype=torch.bool, device=cols.device)
    allow = allow.index_put(
        (torch.arange(b, device=cols.device)[:, None, None],
         torch.arange(h, device=cols.device)[None, :, None],
         rows_for_e, cols.long()), torch.ones((), dtype=torch.bool,
                                              device=cols.device))
    perm = [0, 2, 1, 3]
    out = scaled_dot_product_attention(
        transpose(query, perm), transpose(as_tensor(key), perm),
        transpose(as_tensor(value), perm), attn_mask=Tensor._wrap(allow))
    return transpose(out, perm)
