"""Continuous-batching scheduler over an `EngineCore` (the core of
`paddle_tpu/serving/scheduler.py`).

Policy:
- admission: FIFO from the waiting queue into free slots. Admission
  leases only the sequence id (one block); the prompt's KV enters the
  cache chunk by chunk through the ragged step. A request is admitted
  only when its whole context could lease now, after the prefill debt of
  lanes still mid-chunking; pool exhaustion leaves it queued.
- chunked prefill: every step packs the decode lanes (one token each)
  plus at most `prefill_chunk_tokens` pending-prompt tokens into ONE
  `engine.ragged_step` over a packed buffer of `max_batch_size +
  prefill_chunk_tokens` slots. The first token samples when the final
  chunk completes.
- preemption: when a running sequence cannot grow (pool exhausted), the
  most recently admitted other sequence goes back to the FRONT of the
  queue (LIFO victim, FIFO service), keeping its tokens; they are
  re-prefilled on re-admission.
- eviction: finished, cancelled and expired sequences free their blocks
  at once; the slot admits a new request on the same step.
- padding: empty lanes point their block table at a dedicated guard
  block, never at a sequence's block.
- fault isolation: a lane whose logits are not finite fails alone (its
  request is FAILED, `nan_logits`); a typed `EngineStepError` naming
  lanes fails those lanes and rolls the others back to replay next
  round. Any other engine exception propagates.
- speculative decoding (optional, `spec=SpecDecodeConfig`): each round a
  proposer drafts up to K tokens per decode lane, and ONE
  `engine.verify_step` scores every lane's fixed window of K + 1 tokens
  (pending token + drafts, or the next prompt tokens of a prefilling
  lane); the longest matching draft prefix plus one bonus/correction
  token commit, and rejected speculation rolls back with
  `BlockCacheManager.trim`. A proposer out of pool or past its length
  cap drafts nothing; any other proposer error rolls the round back and
  propagates. Greedy and seeded-stochastic streams equal
  plain decoding's, token for token.

Sampling is `ops/sampling.py` on the logits' device: logits stay on the
card, and only the [B] token ids and the [T] finite mask cross to the
host each step.
"""
from __future__ import annotations

import enum
import itertools
import time
from collections import deque
from typing import Callable, Deque, List, Optional

import numpy as np
import torch

from ..framework import monitor
from ..inference.cache import KVCacheExhausted, SequenceTooLong
from ..ops.sampling import sample_tokens
from .engine import EngineCore
from .fault_tolerance import EngineStepError
from .metrics import ServingMetrics
from .spec import SpecDecodeConfig

__all__ = ["SamplingParams", "RequestStatus", "Request", "Scheduler"]

_PAD_SEQ_ID = -1


class SamplingParams:
    """Per-request decoding knobs (greedy by default)."""

    def __init__(self, max_new_tokens: int = 16, temperature: float = 0.0,
                 top_k: int = 0, eos_token_id: Optional[int] = None,
                 seed: int = 0):
        self.max_new_tokens = max_new_tokens
        self.temperature = temperature
        self.top_k = top_k
        self.eos_token_id = eos_token_id
        self.seed = seed


class RequestStatus(enum.Enum):
    QUEUED = "queued"
    RUNNING = "running"
    PREEMPTED = "preempted"     # back in queue, tokens-so-far kept
    FINISHED = "finished"
    CANCELLED = "cancelled"
    REJECTED = "rejected"
    FAILED = "failed"           # engine fault isolated to this request
    TIMED_OUT = "timed_out"

    @property
    def terminal(self) -> bool:
        return self in (RequestStatus.FINISHED, RequestStatus.CANCELLED,
                        RequestStatus.REJECTED, RequestStatus.FAILED,
                        RequestStatus.TIMED_OUT)


class Request:
    """One generation request and its lifecycle bookkeeping."""

    _ids = itertools.count()

    def __init__(self, prompt_ids, sampling: Optional[SamplingParams] = None,
                 deadline: Optional[float] = None,
                 stream_cb: Optional[Callable[["Request", int], None]] = None):
        self.req_id = next(Request._ids)
        self.prompt = np.asarray(prompt_ids, np.int32).reshape(-1)
        self.sampling = sampling or SamplingParams()
        self.deadline = deadline              # absolute, scheduler's clock
        self.stream_cb = stream_cb
        self.generated: List[int] = []
        self.status = RequestStatus.QUEUED
        self.finish_reason: Optional[str] = None
        self.num_preemptions = 0
        self.t_submit: Optional[float] = None
        self.t_first_token: Optional[float] = None
        self.t_finish: Optional[float] = None
        self._last: Optional[int] = None      # sampled, KV not yet written
        self._admit_seq = -1                  # admission order (victim pick)
        # chunked-prefill cursor: context tokens whose KV is already in
        # cache; the target snapshot is taken at every (re-)admission, so
        # a re-prefill after preemption replays prompt + kept tokens
        self._prefill_ctx = np.zeros((0,), np.int32)
        self._prefill_pos = 0

    @property
    def prefilling(self) -> bool:
        """True while context KV is still entering the cache chunk-wise."""
        return self._prefill_pos < len(self._prefill_ctx)

    @property
    def seq_id(self) -> int:
        return self.req_id

    def all_tokens(self) -> np.ndarray:
        """Prompt + every generated token INCLUDING the pending last one:
        the stream a speculative proposer continues from."""
        return np.concatenate([
            self.prompt, np.asarray(self.generated, np.int32)]).astype(
                np.int32)

    def context_tokens(self) -> np.ndarray:
        """Tokens whose KV must be in cache before the next decode: the
        prompt plus every generated token EXCEPT the pending last one
        (the decode step itself writes the pending token's KV)."""
        gen = self.generated[:-1] if self._last is not None else self.generated
        return np.concatenate([self.prompt,
                               np.asarray(gen, np.int32)]).astype(np.int32)

    def ttft(self) -> Optional[float]:
        if self.t_first_token is None or self.t_submit is None:
            return None
        return self.t_first_token - self.t_submit

    def tpot(self) -> Optional[float]:
        """Mean time-per-output-token after the first."""
        if (self.t_finish is None or self.t_first_token is None
                or len(self.generated) < 2):
            return None
        return (self.t_finish - self.t_first_token) / (len(self.generated) - 1)


class Scheduler:
    """Admits requests into decode slots and drives ragged steps."""

    def __init__(self, engine: EngineCore,
                 metrics: Optional[ServingMetrics] = None,
                 max_queue: int = 256, prefill_chunk_tokens: int = 32,
                 spec: Optional[SpecDecodeConfig] = None,
                 clock: Callable[[], float] = time.perf_counter):
        """`prefill_chunk_tokens`: per-step token budget for pending
        prompts; the packed ragged dispatch holds `max_batch_size +
        prefill_chunk_tokens` token slots. `spec`: optional
        `SpecDecodeConfig`; every round is then one `verify_step`."""
        if prefill_chunk_tokens < 1:
            raise ValueError("prefill_chunk_tokens must be >= 1, got "
                             f"{prefill_chunk_tokens}")
        self.engine = engine
        self.metrics = metrics or ServingMetrics()
        self.max_queue = max_queue
        self.spec = spec
        self.prefill_chunk_tokens = int(prefill_chunk_tokens)
        self.ragged_tokens = engine.max_batch_size + self.prefill_chunk_tokens
        self._clock = clock
        self.slots: List[Optional[Request]] = [None] * engine.max_batch_size
        self.waiting: Deque[Request] = deque()
        self._admit_counter = itertools.count()
        self._zero_progress = 0        # consecutive no-progress steps
        self._finish_events = 0        # terminal transitions, monotonic
        self._chunk_progress = 0       # prefill tokens last round
        self._bind_manager(engine.manager)

    def _bind_manager(self, mgr):
        """Lease the guard block, derive pool geometry, and publish the
        engine's quantization mode."""
        # Guard block for padded lanes: empty slots point their block
        # table at this block. Negative ids keep it out of the request id
        # space; probe downward in case another scheduler already leases
        # -1 on a shared engine.
        pad_id = _PAD_SEQ_ID
        while True:
            try:
                self._pad_block = mgr.allocate(pad_id, 1)[0]
                break
            except ValueError:
                pad_id -= 1
        self._pad_seq_id = pad_id
        # what one sequence can ever hold: pool minus the guard (and minus
        # blocks other users of a shared engine already lease)
        self._usable_blocks = min(mgr.free_blocks, mgr.max_blocks_per_seq)
        # the wbits / kv_bits / kv_bytes_per_token gauges: bind-time, not
        # per step
        info = getattr(self.engine, "quant_info", None)
        if info is not None:
            try:
                self.metrics.on_quant(info())
            except Exception:
                # bind must survive a broken hook, but not silently: the
                # unset gauges and this counter point at the cause
                monitor.inc("serving.quant_info_errors")

    # ---- submission / cancellation ----
    def submit(self, req: Request, now: Optional[float] = None) -> Request:
        """Admission control. Rejects (with `finish_reason`) instead of
        raising: empty and over-long prompts and a full queue are load
        conditions, not bugs."""
        now = self._clock() if now is None else now
        req.t_submit = now
        self.metrics.on_submit()
        mgr = self.engine.manager
        if len(req.prompt) == 0:
            return self._reject(req, "empty_prompt")
        # +1: the sequence must be able to hold at least one generated token
        if mgr.blocks_needed(len(req.prompt) + 1) > self._usable_blocks:
            return self._reject(req, "prompt_too_long")
        if len(self.waiting) >= self.max_queue:
            return self._reject(req, "queue_full")
        self.waiting.append(req)
        self.metrics.gauge_queue(len(self.waiting))
        return req

    def _reject(self, req: Request, reason: str) -> Request:
        req.status = RequestStatus.REJECTED
        req.finish_reason = reason
        req.t_finish = self._clock()
        self.metrics.on_reject(reason)
        return req

    def cancel(self, req: Request) -> bool:
        if req.status.terminal:
            return False
        if req in self.waiting:
            self.waiting.remove(req)
            self._finish(req, RequestStatus.CANCELLED, "cancelled",
                         in_slot=False)
            return True
        for i, r in enumerate(self.slots):
            if r is req:
                self._finish(req, RequestStatus.CANCELLED, "cancelled",
                             slot=i)
                return True
        return False

    # ---- the step ----
    def step(self, now: Optional[float] = None) -> int:
        """One scheduling round: expire deadlines, admit into free slots,
        run one ragged step over the occupied slots. Returns the number of
        decode tokens produced."""
        now = self._clock() if now is None else now
        finish_mark = self._finish_events
        self._expire(now)
        admitted = self._admit()
        produced = self._decode()
        if produced > 0 or admitted > 0 or self._chunk_progress > 0 \
                or self._finish_events > finish_mark:
            self._zero_progress = 0
        else:
            self._zero_progress += 1
        self.metrics.on_step(
            occupancy=produced / len(self.slots),
            kv_utilization=self.engine.manager.utilization(),
            queue_depth=len(self.waiting),
            decoded=produced > 0)
        return produced

    @property
    def num_running(self) -> int:
        return sum(r is not None for r in self.slots)

    @property
    def idle(self) -> bool:
        return self.num_running == 0 and not self.waiting

    @property
    def zero_progress_steps(self) -> int:
        """Consecutive steps with no token, prefill chunk, admission or
        finish — the frontend raises `EngineStalled` off this."""
        return self._zero_progress

    def _finite_rows(self, logits) -> np.ndarray:
        """Row-finiteness mask reduced on the logits' device: only [T]
        bools cross to the host, never the [T, V] logits."""
        return torch.isfinite(logits).all(dim=-1).cpu().numpy()

    def _isolated(self, req: Request, reason: str, phase: str,
                  slot: Optional[int] = None, in_slot: bool = True):
        """Fail ONE request at the fault boundary; everyone else keeps
        serving."""
        self.metrics.on_isolated_fault(phase)
        self._finish(req, RequestStatus.FAILED, reason, slot=slot,
                     in_slot=in_slot)

    # ---- phases ----
    def _expire(self, now: float):
        for req in [r for r in self.waiting
                    if r.deadline is not None and now > r.deadline]:
            self.waiting.remove(req)
            self._finish(req, RequestStatus.TIMED_OUT, "deadline_in_queue",
                         in_slot=False)
        for i, req in enumerate(self.slots):
            if req is not None and req.deadline is not None \
                    and now > req.deadline:
                self._finish(req, RequestStatus.TIMED_OUT,
                             "deadline_while_running", slot=i)

    def _admit(self) -> int:
        """Place queued requests into free slots, FIFO. Admission leases
        only the sequence id (a zero-token allocation = one block); the
        context KV enters the cache chunk by chunk through the ragged
        step."""
        mgr = self.engine.manager
        admitted = 0
        while self.waiting and None in self.slots:
            req = self.waiting[0]
            ctx = req.context_tokens()
            # admit only when the WHOLE context could lease right now,
            # after the prefill DEBT of admitted lanes still mid-chunking
            # (else two large prompts admit against the same free count
            # and preempt-churn mid-prefill)
            debt = sum(
                max(0, mgr.blocks_needed(len(r._prefill_ctx))
                    - mgr.seq_blocks(r.seq_id))
                for r in self.slots if r is not None and r.prefilling)
            need = mgr.blocks_needed(len(ctx))
            if need > mgr.free_blocks - debt:
                break                  # blocks return as runners finish
            try:
                mgr.allocate(req.seq_id, 0)
            except (KVCacheExhausted, SequenceTooLong):
                break
            self.waiting.popleft()
            self.metrics.gauge_queue(len(self.waiting))
            slot = self.slots.index(None)
            # snapshot the prefill target HERE: for a preempted
            # re-admission it includes the kept tokens, so the replay is
            # token-deterministic; the pending `_last` (when present)
            # decodes after the chunks complete
            req._prefill_ctx = ctx
            req._prefill_pos = 0
            req.status = RequestStatus.RUNNING
            req._admit_seq = next(self._admit_counter)
            self.slots[slot] = req
            admitted += 1
        return admitted

    def _grow_chunk(self, req: Request, slot: int, want: int) -> int:
        """Reserve cache slots for the next `want` prefill-chunk tokens.
        Under pool pressure the chunk shrinks to what the free pool (plus
        the last leased block's slack) holds before anyone is preempted.
        Returns tokens reserved (0 = nothing this round, or the request
        left the batch)."""
        mgr = self.engine.manager
        while True:
            try:
                mgr.append_tokens(req.seq_id, want)
                return want
            except SequenceTooLong:
                cap = mgr.max_blocks_per_seq * mgr.block_size \
                    - mgr.seq_len(req.seq_id)
                if cap >= 1:
                    want = min(want, cap)
                    continue
                self._finish(req, RequestStatus.FINISHED, "length_cap",
                             slot=slot)
                return 0
            except KVCacheExhausted:
                # capacity already in hand: the leased blocks' unused
                # tail, plus whatever the free pool still has
                slack = mgr.seq_blocks(req.seq_id) * mgr.block_size \
                    - mgr.seq_len(req.seq_id)
                fit = mgr.free_blocks * mgr.block_size + slack
                if 1 <= fit < want:
                    want = fit
                    continue
                if not self._preempt_one(exclude=req):
                    return 0           # sole lane over a held pool: wait

    def _grow(self, req: Request, slot: int) -> bool:
        """Account the pending token's cache slot; preempt on exhaustion.
        Returns False if the request left the batch instead. `_grow_n`
        with one token, so the plain and speculative paths share one
        length_cap / kv_capacity / preemption policy."""
        return self._grow_n(req, slot, 1) == 1

    def _grow_n(self, req: Request, slot: int, want: int) -> int:
        """Reserve cache slots for the pending token plus `want - 1` draft
        tokens. Degrades before it preempts: under pool pressure the
        drafts go first (want -> 1), THEN the preempt / finish policy
        applies. Returns the slots reserved (0 if the request left the
        batch)."""
        mgr = self.engine.manager
        while True:
            try:
                mgr.append_tokens(req.seq_id, want)
                return want
            except SequenceTooLong:
                cap = mgr.max_blocks_per_seq * mgr.block_size \
                    - mgr.seq_len(req.seq_id)
                if cap >= 1:
                    want = min(want, cap)
                    continue
                self._finish(req, RequestStatus.FINISHED, "length_cap",
                             slot=slot)
                return 0
            except KVCacheExhausted:
                if want > 1:
                    want = 1
                    continue
                if not self._preempt_one(exclude=req):
                    self._finish(req, RequestStatus.FINISHED, "kv_capacity",
                                 slot=slot)
                    return 0

    @staticmethod
    def _sampling_arrays(reqs):
        """Per-lane (temperature, top_k, seed, draw_idx) vectors for the
        sampler; `None` entries (padded lanes) sample greedy. `draw_idx`
        is tokens drawn so far, so draws are reproducible across
        preemption and slot churn. User ints are masked to 31 bits."""
        temps = np.asarray([0.0 if r is None else r.sampling.temperature
                            for r in reqs], np.float32)
        topks = np.asarray([0 if r is None else
                            int(r.sampling.top_k) & 0x7FFFFFFF
                            for r in reqs], np.int32)
        seeds = np.asarray([0 if r is None else
                            int(r.sampling.seed) & 0x7FFFFFFF
                            for r in reqs], np.int32)
        draws = np.asarray([0 if r is None else len(r.generated)
                            for r in reqs], np.int32)
        return temps, topks, seeds, draws

    def _preempt_one(self, exclude: Request) -> bool:
        """Evict the most-recently-admitted running request (≠ exclude)
        back to the FRONT of the queue, keeping its tokens so far."""
        victims = [(r._admit_seq, i) for i, r in enumerate(self.slots)
                   if r is not None and r is not exclude]
        if not victims:
            return False
        _, slot = max(victims)
        req = self.slots[slot]
        self.engine.manager.free(req.seq_id)
        self._release_spec(req)
        self.slots[slot] = None
        req.status = RequestStatus.PREEMPTED
        req.num_preemptions += 1
        self.waiting.appendleft(req)
        self.metrics.gauge_queue(len(self.waiting))
        self.metrics.on_preempt()
        return True

    @staticmethod
    def _gather_rows(logits, rows: np.ndarray):
        """Each lane's last packed row, gathered on the logits' device:
        [T, V] -> [B, V]."""
        return logits[torch.as_tensor(rows, dtype=torch.long,
                                      device=logits.device)]

    def _decode(self) -> int:
        """One ragged round: decode lanes (one token each) plus up to
        `prefill_chunk_tokens` pending-prompt tokens, packed into ONE
        `engine.ragged_step`. Returns decode tokens committed (prefill
        progress is tracked separately)."""
        self._chunk_progress = 0
        if self.spec is not None:
            return self._decode_spec()
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        mgr = self.engine.manager
        # grow (and possibly preempt) before building the batch arrays
        decode_lanes = []              # (slot, req)
        chunks = []                    # (slot, req, n_tokens, pre_len)
        budget = self.prefill_chunk_tokens
        for i, req in active:
            if self.slots[i] is not req:
                continue
            if req.prefilling:
                if budget <= 0:
                    continue           # next step's budget serves it
                rem = len(req._prefill_ctx) - req._prefill_pos
                pre_len = mgr.seq_len(req.seq_id)
                got = self._grow_chunk(req, i, min(rem, budget))
                if got:
                    budget -= got
                    chunks.append((i, req, got, pre_len))
            elif self._grow(req, i):
                decode_lanes.append((i, req))
        # growth-path preemptions may have evicted earlier entries
        decode_lanes = [(i, r) for i, r in decode_lanes
                        if self.slots[i] is r]
        chunks = [(i, r, n, p) for i, r, n, p in chunks
                  if self.slots[i] is r]
        if not decode_lanes and not chunks:
            return 0
        B = len(self.slots)
        T = self.ragged_tokens
        tokens = np.zeros((T,), np.int32)
        q_lens = np.zeros((B,), np.int32)
        kv_lens = np.zeros((B,), np.int32)
        tables = np.full((B, mgr.max_blocks_per_seq), self._pad_block,
                         np.int32)
        rows = np.zeros((B,), np.int32)   # last packed row per lane
        decode_set = {i for i, _r in decode_lanes}
        chunk_of = {i: (n, p) for i, _r, n, p in chunks}
        pre_lens = {}                     # seq_id -> pre-round cache len
        cursor = 0
        for i in range(B):                # slot order = packing order
            req = self.slots[i]
            if req is None:
                continue
            if i in decode_set:
                tokens[cursor] = req._last
                q_lens[i] = 1
                kv_lens[i] = mgr.seq_len(req.seq_id)
                pre_lens[req.seq_id] = int(kv_lens[i]) - 1
                rows[i] = cursor
                cursor += 1
            elif i in chunk_of:
                n, p = chunk_of[i]
                tokens[cursor:cursor + n] = req._prefill_ctx[
                    req._prefill_pos:req._prefill_pos + n]
                q_lens[i] = n
                kv_lens[i] = mgr.seq_len(req.seq_id)   # == p + n
                pre_lens[req.seq_id] = p
                rows[i] = cursor + n - 1
                cursor += n
            else:
                continue
            tables[i] = mgr.block_table_array([req.seq_id])[0]
        all_lanes = decode_lanes + [(i, r) for i, r, _n, _p in chunks]
        try:
            logits = self.engine.ragged_step(tokens, q_lens, kv_lens, tables)
        except EngineStepError as e:
            if not e.seq_ids:
                raise
            # the engine named the poisoned lanes: fail those, roll the
            # others back to their pre-round lengths to replay next round
            for i, r in all_lanes:
                if r.seq_id in e.seq_ids:
                    self._isolated(r, f"engine_fault:{e.phase}", e.phase,
                                   slot=i)
                else:
                    mgr.trim(r.seq_id, pre_lens[r.seq_id])
            return 0
        finite = self._finite_rows(logits)          # [T] bools to host
        for i, req in all_lanes:
            n = int(q_lens[i])
            start = int(rows[i]) - n + 1
            if not bool(finite[start:start + n].all()):
                # the garbage KV went into this lane's own blocks;
                # freeing the sequence discards it
                self._isolated(req, "nan_logits", "decode", slot=i)
        all_lanes = [(i, r) for i, r in all_lanes if self.slots[i] is r]
        if not all_lanes:
            return 0
        decode_lanes = [(i, r) for i, r in decode_lanes
                        if self.slots[i] is r]
        chunks = [(i, r, n, p) for i, r, n, p in chunks
                  if self.slots[i] is r]
        t_tok = self._clock()
        # sampling over every lane's LAST packed row: decode lanes commit
        # their token; a prefill lane samples only on the round its final
        # chunk completes (draw_idx 0 — exactly sequential decode's draw)
        lane_sample: List[Optional[Request]] = [None] * B
        for i, req in decode_lanes:
            lane_sample[i] = req
        for i, req, n, _p in chunks:
            if req._prefill_pos + n >= len(req._prefill_ctx) \
                    and req._last is None:
                lane_sample[i] = req
        picked = sample_tokens(self._gather_rows(logits, rows),
                               *self._sampling_arrays(lane_sample))
        produced = 0
        for i, req in decode_lanes:
            if self.slots[i] is not req:   # cancelled by a stream_cb
                continue                   # earlier in this very loop
            produced += 1
            self._commit_token(req, int(picked[i]), i, t_tok)
        chunk_tokens = 0
        for i, req, n, _p in chunks:
            if self.slots[i] is not req:   # cancelled mid-commit
                continue
            chunk_tokens += n
            self._commit_chunk(req, n, i, t_tok, picked[i])
        self._chunk_progress = chunk_tokens
        self.metrics.on_ragged_step(chunk_tokens, len(decode_lanes))
        if decode_lanes:
            self.metrics.on_decode(produced)
        return produced

    def _decode_spec(self) -> int:
        """One speculative round: propose -> ONE fixed-shape verify over
        all lanes -> sampling -> accept the longest matching draft prefix
        plus the bonus token -> `trim` rollback of rejected slots.

        The verify batch is always [B, K + 1] tokens. A lane with fewer
        than K drafts reserves only what it holds; the window's surplus
        KV writes land in guard-padded table entries, never in live
        blocks. Chunked prefill rides the same dispatch: a prefilling
        lane's window carries its next (up to K + 1) prompt tokens. A
        prompt never completes mid-window: the final chunk is held to
        one token, so the first token samples at window slot 0, whose
        draw counter (0) is the one plain decoding uses. Returns decode
        tokens committed."""
        active = [(i, r) for i, r in enumerate(self.slots) if r is not None]
        if not active:
            return 0
        mgr = self.engine.manager
        K = self.spec.num_draft_tokens
        S = K + 1
        proposer = self.spec.proposer
        lanes = []             # (slot, req, toks, pre_len, prefilling)
        for i, req in active:
            if self.slots[i] is not req:
                continue
            pre_len = mgr.seq_len(req.seq_id)
            if req.prefilling:
                rem = len(req._prefill_ctx) - req._prefill_pos
                want = min(S, rem)
                if want == rem and rem > 1:
                    want = rem - 1      # complete next round, at slot 0
                got = self._grow_chunk(req, i, want)
                if got == 0:
                    continue
                toks = list(req._prefill_ctx[
                    req._prefill_pos:req._prefill_pos + got])
                lanes.append((i, req, toks, pre_len, True))
                continue
            try:
                drafts = list(proposer.propose(
                    req.seq_id, req.all_tokens(), K))[:K]
            except (KVCacheExhausted, SequenceTooLong):
                drafts = []          # proposer pool or length pressure
            except Exception:
                # any other proposer error (a draft kernel that fails to
                # build or launch) leaves the round: the lanes grown so
                # far roll back and replay it
                self._rollback(lanes, {r.seq_id: p
                                       for _i, r, _t, p, _f in lanes})
                raise
            got = self._grow_n(req, i, 1 + len(drafts))
            if got == 0:
                continue
            lanes.append((i, req, [req._last] + drafts[:got - 1], pre_len,
                          False))
        # growth-path preemptions may have evicted earlier lanes
        lanes = [ln for ln in lanes if self.slots[ln[0]] is ln[1]]
        if not lanes:
            return 0
        B = len(self.slots)
        tokens = np.zeros((B, S), np.int32)
        ctx = np.full((B,), S, np.int32)      # pad lanes write the guard
        # a lane within S tokens of its length cap has a table full of
        # real blocks while ctx counts the whole window: trailing guard
        # columns take the window's positions past the cap
        width = mgr.max_blocks_per_seq + (S + mgr.block_size - 2) \
            // mgr.block_size
        tables = np.full((B, width), self._pad_block, np.int32)
        lane_reqs: List[Optional[Request]] = [None] * B
        pre_lens = {}
        for i, req, toks, pre_len, prefilling in lanes:
            tokens[i, :len(toks)] = toks
            # token j sits at position pre_len + j: ctx counts the whole
            # window even when the lane holds fewer than S real tokens
            ctx[i] = pre_len + S
            tables[i, :mgr.max_blocks_per_seq] = mgr.block_table_array(
                [req.seq_id], pad=self._pad_block)[0]
            # sampled rows: a decode lane's always, a prefill lane's only
            # on its completing (one-token) chunk
            if not prefilling:
                lane_reqs[i] = req
            elif req._prefill_pos + len(toks) >= len(req._prefill_ctx) \
                    and req._last is None:
                lane_reqs[i] = req
            pre_lens[req.seq_id] = pre_len
        try:
            logits = self.engine.verify_step(tokens, ctx, tables)
        except EngineStepError as e:
            if not e.seq_ids:
                self._rollback(lanes, pre_lens)
                raise
            # the engine named the poisoned lanes: fail those, roll the
            # others back to their pre-round lengths to replay next round
            for i, req, _t, _p, _f in lanes:
                if req.seq_id in e.seq_ids:
                    self._isolated(req, f"engine_fault:{e.phase}", e.phase,
                                   slot=i)
                else:
                    mgr.trim(req.seq_id, pre_lens[req.seq_id])
            return 0
        except Exception:
            self._rollback(lanes, pre_lens)
            raise
        finite = torch.isfinite(logits).all(dim=-1).all(dim=-1) \
            .cpu().numpy()                          # [B] bools to host
        for i, req, _t, _p, _f in lanes:
            if not finite[i]:
                # the garbage KV went into this lane's own blocks (and the
                # guard); freeing the sequence discards it
                self._isolated(req, "nan_logits", "verify", slot=i)
                lane_reqs[i] = None
        lanes = [ln for ln in lanes if self.slots[ln[0]] is ln[1]]
        if not lanes:
            return 0
        t_tok = self._clock()
        picked = sample_tokens(logits, *self._sampling_arrays(lane_reqs))
        produced = proposed = accepted = 0
        chunk_tokens = decode_lanes = 0
        for i, req, toks, pre_len, prefilling in lanes:
            if self.slots[i] is not req:   # cancelled by a stream_cb
                continue                   # earlier in this very loop
            if prefilling:
                got = len(toks)
                chunk_tokens += got
                # a completing chunk has got == 1: window slot 0, the
                # draw counter plain decoding would use
                self._commit_chunk(req, got, i, t_tok, picked[i, got - 1])
                continue
            decode_lanes += 1
            drafts = toks[1:]
            a = 0
            while a < len(drafts) and drafts[a] == int(picked[i, a]):
                a += 1
            proposed += len(drafts)
            accepted += a
            # the accepted drafts (== the sampled tokens) plus the bonus /
            # correction token from the first unmatched position
            for j in range(a + 1):
                produced += 1
                self._commit_token(req, int(picked[i, j]), i, t_tok)
                if req.status.terminal:
                    break
            if not req.status.terminal:
                # roll back rejected speculation: keep pending + accepted
                mgr.trim(req.seq_id, pre_len + 1 + a)
        self._chunk_progress = chunk_tokens
        self.metrics.on_ragged_step(chunk_tokens, decode_lanes)
        if decode_lanes:
            self.metrics.on_decode(produced)
            self.metrics.on_spec(proposed=proposed, accepted=accepted,
                                 produced=produced, lanes=decode_lanes)
        return produced

    def _rollback(self, lanes, pre_lens):
        """Trim every lane still in its slot back to its pre-round length
        (an exception leaves the round; the lanes replay it)."""
        mgr = self.engine.manager
        for i, req, *_rest in lanes:
            if self.slots[i] is req:
                mgr.trim(req.seq_id, pre_lens[req.seq_id])

    def _commit_chunk(self, req: Request, n: int, slot: int, t_tok: float,
                      first_tok) -> None:
        """Advance a lane's chunked prefill by `n` committed tokens; on
        the round the FINAL chunk completes, commit the request's first
        token (ignored on a preempted re-admission whose pending token
        already exists)."""
        req._prefill_pos += n
        self.metrics.on_prefill_chunk(n)
        if req.prefilling:
            return                         # more chunks next round
        self.metrics.on_prefill_done()
        if req._last is None:              # fresh: the FIRST token
            self._commit_token(req, int(first_tok), slot, t_tok)

    def _commit_token(self, req: Request, tok: int, slot: int,
                      t_tok: float):
        """Commit one sampled token: the ONE place the generated stream,
        pending token, TTFT stamp, stream callback and finish check
        advance together."""
        req.generated.append(tok)
        req._last = tok
        if req.t_first_token is None:
            req.t_first_token = t_tok
            self.metrics.on_first_token(req)
        if req.stream_cb is not None:
            req.stream_cb(req, tok)
        self._maybe_finish_on_token(req, tok, slot)

    def _maybe_finish_on_token(self, req: Request, tok: int, slot: int):
        if req.status.terminal:
            # a stream callback may cancel mid-commit: the slot and
            # blocks are already released — don't finish twice
            return
        sp = req.sampling
        if sp.eos_token_id is not None and tok == sp.eos_token_id:
            self._finish(req, RequestStatus.FINISHED, "eos", slot=slot)
        elif len(req.generated) >= sp.max_new_tokens:
            self._finish(req, RequestStatus.FINISHED, "max_new_tokens",
                         slot=slot)

    def _finish(self, req: Request, status: RequestStatus, reason: str,
                slot: Optional[int] = None, in_slot: bool = True):
        if in_slot:
            if slot is None:
                slot = self.slots.index(req)
            self.slots[slot] = None
            self.engine.manager.free(req.seq_id)
        self._release_spec(req)
        req.status = status
        req.finish_reason = reason
        req.t_finish = self._clock()
        self._finish_events += 1
        self.metrics.on_finish(req)

    def _release_spec(self, req: Request):
        """Drop any speculative-proposer state for a request leaving the
        batch (finish, cancel, preempt). Idempotent; a failing proposer
        never raises into the serving path."""
        if self.spec is None:
            return
        try:
            self.spec.proposer.release(req.seq_id)
        except Exception:
            monitor.inc("serving.spec_release_errors")
