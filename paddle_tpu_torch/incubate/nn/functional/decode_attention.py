"""Decode-time attention functionals: masked MHA and block (paged) MHA.

The port of `paddle_tpu/incubate/nn/functional/decode_attention.py`
(reference `masked_multihead_attention.py`,
`block_multihead_attention.py:34`, `blha_get_max_len.py`).
`masked_multihead_attention` and `blha_get_max_len` are plain.
`block_multihead_attention`'s decode writes K/V into the block pool with
`ops/kernels/paged_attention.write_kv_to_cache` and attends with
`paged_attention` (the hand-written decode kernel on CUDA tensors, its
plain version on CPU tensors; it raises on a CUDA input the kernel does
not take, where JAX's runs its plain reference); its prefill writes the
same way and attends with the plain composite
`nn.functional.attention._sdpa_fn`, as JAX's calls its composite.

The block pools are written in place and returned (the JAX package
returns updated copies). Cache quantization, and mixed prefill + decode
batches, raise as in JAX.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from ....nn.functional.attention import NEG_INF, _sdpa_fn
from ....ops.kernels import paged_attention as _pa

__all__ = ["masked_multihead_attention", "block_multihead_attention",
           "blha_get_max_len"]


def _refuse(fn, **is_set):
    """Raise NotImplementedError naming the arguments of `fn` that are
    set: the JAX package accepts them and ignores them, and the port
    refuses rather than answer otherwise than the reference would."""
    bad = sorted(name for name, on in is_set.items() if on)
    if bad:
        raise NotImplementedError(
            f"{fn}: {', '.join(bad)} not implemented (the JAX package "
            f"accepts and ignores them)")


def _host(x):
    """An index tensor (or array) as a flat int64 numpy array."""
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x).reshape(-1).astype(np.int64)


def blha_get_max_len(seq_lens_encoder, seq_lens_decoder, batch_size=None):
    """The largest encoder and decoder lengths this step, each `[1]`."""
    enc = torch.as_tensor(seq_lens_encoder)
    dec = torch.as_tensor(seq_lens_decoder)
    return enc.max().reshape(1), dec.max().reshape(1)


def masked_multihead_attention(x, cache_kv=None, bias=None, src_mask=None,
                               cum_offsets=None, sequence_lengths=None,
                               rotary_tensor=None, beam_cache_offset=None,
                               qkv_out_scale=None, out_shift=None,
                               out_smooth=None, seq_len=1, rotary_emb_dims=0,
                               use_neox_rotary_style=False,
                               compute_dtype="default", out_scale=-1,
                               quant_round_type=1, quant_max_bound=127.0,
                               quant_min_bound=-127.0):
    """Single-token decode attention over a dense KV cache, plain.

    x `[B, 3*H*D]` packed qkv of each sequence's newest token; cache_kv
    `[2, B, H, max_seq, D]`; sequence_lengths `[B]` tokens already cached.
    Returns `(out [B, H*D], new cache)`, the reference contract. The new
    token's K/V land at position `sequence_lengths[b]` and the query
    attends to positions `<= sequence_lengths[b]`; scores in f32 (the
    JAX package's division by a numpy float64 promotes them to f64 under
    x64)."""
    if qkv_out_scale is not None or out_scale != -1:
        raise NotImplementedError(
            "int8 qkv/out quantization is not implemented")
    _refuse("masked_multihead_attention",
            beam_cache_offset=beam_cache_offset is not None,
            out_shift=out_shift is not None,
            out_smooth=out_smooth is not None)
    cache = cache_kv
    _, b, h, max_seq, d = cache.shape
    qkv = x.reshape(b, 3, h, d)
    if bias is not None:
        qkv = qkv + bias.reshape(1, 3, h, d)
    q, k, v = qkv[:, 0], qkv[:, 1], qkv[:, 2]          # [B, H, D]
    if sequence_lengths is None:
        raise ValueError("sequence_lengths is required")
    lens = torch.as_tensor(sequence_lengths, device=x.device) \
        .reshape(-1).to(torch.int64)

    if rotary_tensor is not None and rotary_emb_dims > 0:
        # rotary_tensor [2, B, 1, max_seq, D] (cos; sin): each sequence's
        # row at its position lens[b]
        rot = rotary_tensor
        idx = lens[:, None, None].expand(b, 1, rot.shape[-1])
        cos = torch.gather(rot[0][:, 0], 1, idx)        # [B, 1, D]
        sin = torch.gather(rot[1][:, 0], 1, idx)

        def rope(t):
            if use_neox_rotary_style:
                t1, t2 = torch.chunk(t, 2, dim=-1)
                c, s = cos[..., :d // 2], sin[..., :d // 2]
                return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], -1)
            te, to = t[..., 0::2], t[..., 1::2]
            c, s = cos[..., 0::2], sin[..., 0::2]
            return torch.stack([te * c - to * s, to * c + te * s],
                               dim=-1).reshape(t.shape)

        q, k = rope(q), rope(k)

    # write k/v at position lens[b] (none past the cache, as one_hot's)
    pos = torch.arange(max_seq, device=x.device)
    write = (pos[None, :] == lens[:, None]).to(cache.dtype)[:, None, :, None]
    new_k = cache[0] * (1 - write) + k[:, :, None, :] * write
    new_v = cache[1] * (1 - write) + v[:, :, None, :] * write
    new_cache = torch.stack([new_k, new_v])

    scores = torch.einsum("bhd,bhsd->bhs", q.float(), new_k.float()) \
        / math.sqrt(d)
    keep = (pos[None, :] <= lens[:, None])[:, None, :]  # incl. the new token
    scores = torch.where(keep, scores, torch.full_like(scores, NEG_INF))
    if src_mask is not None:
        scores = scores + src_mask.reshape(b, 1, -1)[:, :, :max_seq] \
            .to(scores.dtype)
    probs = torch.softmax(scores, dim=-1)
    out = torch.einsum("bhs,bhsd->bhd", probs, new_v.float())
    return out.to(x.dtype).reshape(b, h * d), new_cache


def _rope_rows(t, cos, sin, neox):
    """`rope_fn` of `decode_attention.py:197-205`: t `[T, heads, D]`,
    cos/sin `[T, D/2]` cast to t's dtype; `neox` rotates the halves,
    otherwise the adjacent pairs (the reverse of
    `fused_rotary_position_embedding`'s flag, as in the reference)."""
    c = cos[:, None, :].to(t.dtype)
    s = sin[:, None, :].to(t.dtype)
    if neox:
        t1, t2 = torch.chunk(t, 2, dim=-1)
        return torch.cat([t1 * c - t2 * s, t2 * c + t1 * s], -1)
    te, to = t[..., 0::2], t[..., 1::2]
    return torch.stack([te * c - to * s, to * c + te * s],
                       dim=-1).reshape(t.shape)


def block_multihead_attention(
        qkv, key_cache, value_cache, seq_lens_encoder, seq_lens_decoder,
        seq_lens_this_time, padding_offsets=None, cum_offsets=None,
        cu_seqlens_q=None, cu_seqlens_k=None, block_tables=None,
        pre_key_cache=None, pre_value_cache=None, cache_k_quant_scales=None,
        cache_v_quant_scales=None, cache_k_dequant_scales=None,
        cache_v_dequant_scales=None, qkv_out_scale=None, qkv_bias=None,
        out_shift=None, out_smooth=None, max_enc_len_this_time=None,
        max_dec_len_this_time=None, rope_emb=None, mask=None, tgt_mask=None,
        max_seq_len=-1, block_size=64, use_neox_style=False,
        use_dynamic_cachekv_quant=False, quant_round_type=1,
        quant_max_bound=127.0, quant_min_bound=-127.0, out_scale=-1,
        compute_dtype="default", num_heads=None, num_kv_heads=None):
    """Paged-cache attention (prefill or decode), `decode_attention.py:
    128-254`.

    qkv `[token_num, (H + 2*KVH) * D]` packed ragged tokens in sequence
    order; key/value_cache `[max_block_num, KVH, block_size, D]`, written
    IN PLACE; block_tables `[B, W]` int32. A call is pure prefill (every
    seq_lens_decoder 0) or pure decode (one token per sequence); a mixed
    batch raises. rope_emb `[2, B, max_seq, 1, D/2]` (cos; sin) rotates q
    and k at each token's absolute position (decoder length + offset in
    this step); `use_neox_style` rotates halves, otherwise adjacent pairs.

    Returns `(fmha_out [token_num, H*D], qkv_out, key_cache,
    value_cache)`, qkv_out being qkv plus `qkv_bias`."""
    if use_dynamic_cachekv_quant or cache_k_quant_scales is not None:
        raise NotImplementedError("cache-kv quantization not implemented")
    _refuse("block_multihead_attention",
            pre_key_cache=pre_key_cache is not None,
            pre_value_cache=pre_value_cache is not None,
            cache_v_quant_scales=cache_v_quant_scales is not None,
            cache_k_dequant_scales=cache_k_dequant_scales is not None,
            cache_v_dequant_scales=cache_v_dequant_scales is not None,
            qkv_out_scale=qkv_out_scale is not None,
            out_shift=out_shift is not None,
            out_smooth=out_smooth is not None, mask=mask is not None,
            tgt_mask=tgt_mask is not None, out_scale=out_scale != -1)
    kc, vc = key_cache, value_cache
    dev = qkv.device
    tables = torch.as_tensor(block_tables, device=dev).to(torch.int32)
    enc = _host(seq_lens_encoder)
    dec = _host(seq_lens_decoder)
    this_time = _host(seq_lens_this_time)
    b = enc.shape[0]
    _nb, kv_h, bs, d = kc.shape
    if bs != block_size and block_size != 64:
        raise ValueError("block_size mismatch with cache shape")
    total = qkv.shape[0]
    width = qkv.shape[1] // d
    if num_kv_heads is not None:
        h = num_heads if num_heads is not None else width - 2 * num_kv_heads
        if h + 2 * num_kv_heads != width:
            raise ValueError(f"qkv holds {width} heads, not {h} + 2 x "
                             f"{num_kv_heads}")
        kv_h_q = num_kv_heads
    else:
        kv_h_q = kv_h
        h = width - 2 * kv_h
    qkva = qkv
    if qkv_bias is not None:
        qkva = qkva + qkv_bias.reshape(1, -1)
    qkvr = qkva.reshape(total, width, d)
    q = qkvr[:, :h]
    k = qkvr[:, h:h + kv_h_q]
    v = qkvr[:, h + kv_h_q:]

    if rope_emb is not None:
        seq_ids = np.repeat(np.arange(b), this_time)
        pos_in = np.concatenate([np.arange(n) for n in this_time]) \
            if total else np.zeros((0,), np.int64)
        sid = torch.from_numpy(seq_ids).to(dev)
        abs_pos = torch.from_numpy(dec[seq_ids] + pos_in).to(dev)
        cos = rope_emb[0][sid, abs_pos, 0]               # [T, D/2]
        sin = rope_emb[1][sid, abs_pos, 0]
        q = _rope_rows(q, cos, sin, use_neox_style)
        k = _rope_rows(k, cos, sin, use_neox_style)

    is_decode = bool((dec > 0).any()) or bool((this_time == 1).all()
                                              and (enc == 0).all())
    if bool((enc > 0).any()) and bool((dec > 0).any()):
        raise NotImplementedError(
            "mixed prefill+decode batches: split the call per phase "
            "(the reference kernel also runs enc and dec token groups "
            "through separate paths)")

    if is_decode:
        # one token per sequence: q is [B, H, D]
        start = torch.from_numpy(dec).to(device=dev, dtype=torch.int32)
        _pa.write_kv_to_cache(k.reshape(b, 1, kv_h_q, d),
                              v.reshape(b, 1, kv_h_q, d), kc, vc, tables,
                              start)
        out = _pa.paged_attention(q.reshape(b, h, d), kc, vc, tables,
                                  start + 1)
        out = out.reshape(total, h * d)
    else:
        # prefill: per-sequence causal attention + cache write
        outs = []
        off = 0
        zero = torch.zeros((1,), dtype=torch.int32, device=dev)
        for i in range(b):
            n = int(this_time[i])
            qi = q[off:off + n][None]                   # [1, S, H, D]
            ki = k[off:off + n][None]
            vi = v[off:off + n][None]
            if n:               # (the writer takes at least one token)
                _pa.write_kv_to_cache(ki, vi, kc, vc, tables[i:i + 1], zero)
            oi = _sdpa_fn(qi, ki, vi, True)   # repeats GQA K/V heads
            outs.append(oi[0].reshape(n, h * d))
            off += n
        out = torch.cat(outs, dim=0)
    return out.to(qkva.dtype), qkva, kc, vc
