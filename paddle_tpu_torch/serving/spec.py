"""Speculative decoding: draft-token proposers and their configuration
(the port of `paddle_tpu/serving/spec.py`).

A cheap PROPOSER guesses K draft tokens per lane, the target engine
scores all of them in ONE `verify_step`, and the scheduler keeps the
longest prefix of drafts that match what the target itself samples, plus
one bonus/correction token. Greedy speculative decoding therefore gives
the same tokens as plain decoding, and seeded sampling does too (each
window slot draws with the counter plain decoding would use).

Two proposers:

- `NGramProposer`: prompt lookup. Match the context's suffix n-gram
  against its own history and propose the tokens that followed last
  time. Host only, no weights, no device work.
- `DraftEngineProposer`: a second `EngineCore` (same vocab) decodes K
  tokens greedily per step against its own paged cache, kept in sync
  with the verified context by catch-up `decode_step`s and `trim`
  rollback.

Proposals are best-effort: fewer than K (or no) drafts is a valid
answer, and the scheduler pads the fixed-K verify window around it.
"""
from __future__ import annotations

from typing import Dict, List, Protocol, runtime_checkable

import numpy as np
import torch

from ..inference.cache import KVCacheExhausted, SequenceTooLong

__all__ = ["Proposer", "NGramProposer", "DraftEngineProposer",
           "SpecDecodeConfig"]


@runtime_checkable
class Proposer(Protocol):
    """Draft-token source for speculative decoding."""

    def propose(self, seq_id: int, context: np.ndarray,
                k: int) -> List[int]:
        """Return up to `k` draft tokens continuing `context` (the full
        committed token stream INCLUDING the pending last token). May
        return fewer, or none, when it has no guess."""
        ...

    def release(self, seq_id: int) -> None:
        """Drop any per-sequence state (request finished or preempted)."""
        ...


class SpecDecodeConfig:
    """Speculative-decoding knobs for the scheduler.

    `num_draft_tokens` (K) is fixed for the scheduler's lifetime: every
    verify pass scores K + 1 tokens per lane."""

    def __init__(self, proposer: Proposer, num_draft_tokens: int = 4):
        if num_draft_tokens < 1:
            raise ValueError(
                f"num_draft_tokens must be >= 1, got {num_draft_tokens}")
        self.proposer = proposer
        self.num_draft_tokens = int(num_draft_tokens)


class NGramProposer:
    """Prompt-lookup proposer: longest-suffix n-gram self-match.

    For n-gram sizes `max_ngram` down to `min_ngram`, find the RIGHTMOST
    earlier occurrence of the context's trailing n-gram and propose the
    tokens that followed it. Host bookkeeping only, no per-sequence
    state."""

    def __init__(self, max_ngram: int = 3, min_ngram: int = 1):
        if not 1 <= min_ngram <= max_ngram:
            raise ValueError(f"need 1 <= min_ngram <= max_ngram, got "
                             f"({min_ngram}, {max_ngram})")
        self.max_ngram = max_ngram
        self.min_ngram = min_ngram

    def propose(self, seq_id: int, context: np.ndarray,
                k: int) -> List[int]:
        ext = [int(t) for t in np.asarray(context).reshape(-1)]
        props: List[int] = []
        # self-extending lookup: append each match's continuation to the
        # (virtual) context and match again, so a context ending in a
        # cycle keeps yielding drafts instead of stopping at the rightmost
        # match, which for a constant tail sits one token from the end
        while len(props) < k:
            taken = self._match_one(ext, k - len(props))
            if not taken:
                break
            props.extend(taken)
            ext.extend(taken)
        return props

    def _match_one(self, ext: List[int], k: int) -> List[int]:
        """Tokens following the rightmost history match of the longest
        suffix n-gram (a byte-level rfind over the int32 stream, with an
        alignment walk for a hit that straddles two tokens)."""
        n = len(ext)
        if n < 2:
            return []
        blob = np.asarray(ext, np.int32).tobytes()
        for m in range(min(self.max_ngram, n - 1), self.min_ngram - 1, -1):
            pat = blob[4 * (n - m):]
            # window start j needs j + m <= n - 1 (a match inside the
            # history, strictly before the suffix itself)
            idx = blob.rfind(pat, 0, 4 * (n - 1))
            while idx >= 0 and idx % 4:
                idx = blob.rfind(pat, 0, idx + len(pat) - 1)
            if idx >= 0:
                start = idx // 4 + m
                return ext[start:start + k]
        return []

    def release(self, seq_id: int) -> None:
        pass


class DraftEngineProposer:
    """Draft-model proposer over a second `EngineCore` with a
    full-precision pool (it drives `prefill` and `decode_step`).

    The draft engine keeps its own paged cache in sync with each verified
    context: catch-up tokens go through single-token `decode_step` calls
    (writing their KV), then K proposals are decoded greedily and the
    cache is `trim`med back to the verified length, so rejected
    speculation never stays in the draft state. Draft pool exhaustion and
    a context past the draft's length cap degrade to "no proposal"; any
    other draft-engine error (a kernel that fails to build or launch)
    frees the sequence's draft lease and propagates. (The JAX copy turns
    every exception into "no proposal".)"""

    def __init__(self, engine):
        self.engine = engine
        self._synced: Dict[int, int] = {}   # seq_id -> tokens in draft cache

    def _decode_one(self, token: int, seq_id: int):
        mgr = self.engine.manager
        tables = mgr.block_table_array([seq_id])
        lens = np.asarray([mgr.seq_len(seq_id)], np.int32)
        return self.engine.decode_step(np.asarray([token], np.int32), lens,
                                       tables)

    def _prefill(self, seq_id: int, ctx: np.ndarray):
        """Prefill right-padded to a power-of-two multiple of the block
        size (capped at the sequence cap), then trim to the context."""
        mgr = self.engine.manager
        n = len(ctx)
        cap = mgr.max_blocks_per_seq * mgr.block_size
        if n > cap:
            # the context outgrew the draft cache's per-sequence cap:
            # raise so propose() degrades to "no proposal"
            raise SequenceTooLong(mgr.blocks_needed(n),
                                  mgr.max_blocks_per_seq)
        bucket = mgr.block_size
        while bucket < n:
            bucket = min(bucket * 2, cap)
        mgr.allocate(seq_id, bucket)
        padded = np.zeros((1, bucket), np.int32)
        padded[0, :n] = ctx
        tables = mgr.block_table_array([seq_id])
        logits = self.engine.prefill(padded, tables,
                                     lens=np.asarray([n], np.int32))
        mgr.trim(seq_id, n)
        self._synced[seq_id] = n
        return logits

    def propose(self, seq_id: int, context: np.ndarray,
                k: int) -> List[int]:
        mgr = self.engine.manager
        ctx = np.asarray(context, np.int32).reshape(-1)
        n = len(ctx)
        if n == 0:
            return []
        try:
            if seq_id not in self._synced:
                logits = self._prefill(seq_id, ctx)
            else:
                m = self._synced[seq_id]
                if m > n:          # stale state past the verified context
                    mgr.trim(seq_id, n)
                    m = n
                if m == n:         # re-score the last token (no growth)
                    logits = self._decode_one(int(ctx[-1]), seq_id)
                else:              # catch-up: write KV for ctx[m:n]
                    for j in range(m, n):
                        mgr.append_token(seq_id)
                        logits = self._decode_one(int(ctx[j]), seq_id)
                    self._synced[seq_id] = n
            # greedy draft rollout; the proposals' KV is trimmed below
            props = [int(torch.argmax(logits[0]))]
            while len(props) < k:
                try:
                    mgr.append_token(seq_id)
                except (KVCacheExhausted, SequenceTooLong):
                    break
                logits = self._decode_one(props[-1], seq_id)
                props.append(int(torch.argmax(logits[0])))
            mgr.trim(seq_id, n)
            return props
        except (KVCacheExhausted, SequenceTooLong):
            # draft pool or length pressure: propose nothing and drop the
            # lease, so the next call starts clean (the scheduler never
            # sees this lease)
            self.release(seq_id)
            return []
        except Exception:
            self.release(seq_id)
            raise

    def release(self, seq_id: int) -> None:
        """Forget the sequence and free its draft lease, also one taken by
        a prefill that raised before the sequence was synced."""
        self._synced.pop(seq_id, None)
        try:
            self.engine.manager.free(seq_id)
        except KeyError:
            pass
