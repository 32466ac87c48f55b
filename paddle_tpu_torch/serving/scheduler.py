"""Iteration-level continuous-batching scheduler (host-only).

Counterpart of the continuous-batching core of
``paddle_tpu/serving/scheduler.py``. One scheduler iteration is one fused
prefill/decode step over a FIXED number of decode slots (S) x a FIXED
chunk width (C): prefilling slots feed up to C prompt tokens, decoding
slots feed their one in-flight token, idle lanes are masked. Shapes never
change, so requests of any length mix in one step.

Host-side state machine only (Python and numpy): admission from a
FIFO-within-priority queue gated by block-pool watermark backpressure
(admission reserves blocks for the whole prompt + output up front, so a
running request never runs out of blocks mid-flight), retirement of
EOS/length-finished lanes, per-request deadlines and client cancels that
reclaim blocks. Time comes from an injectable `clock` (seconds,
monotonic). Fork groups, beam search, prefix caching, speculative
decoding, preemption, the host tier and telemetry wait for later slices.
"""

import heapq
import threading
import time
from concurrent.futures import InvalidStateError

import numpy as np

from .decode_strategies import fold_key

__all__ = ["ContinuousBatchingScheduler", "GenerationResult",
           "DeadlineExceeded", "RequestCancelled", "IterationPlan"]


class DeadlineExceeded(TimeoutError):
    """The request's deadline passed before generation finished; its
    slot and blocks were reclaimed."""


class RequestCancelled(RuntimeError):
    """The request was cancelled (client cancel or server shutdown)."""


class GenerationResult:
    """What a finished request's future resolves to."""

    __slots__ = ("request_id", "token_ids", "score", "finish_reason",
                 "prompt_len", "ttft_ms")

    def __init__(self, request_id, token_ids, score, finish_reason,
                 prompt_len, ttft_ms):
        self.request_id = request_id
        self.token_ids = token_ids          # np.int32 (n_generated,)
        self.score = score                  # sum of chosen-token logprobs
        self.finish_reason = finish_reason  # "eos" | "length"
        self.prompt_len = prompt_len
        self.ttft_ms = ttft_ms              # submit -> first token

    def __repr__(self):
        return (f"GenerationResult(id={self.request_id}, "
                f"n={len(self.token_ids)}, reason={self.finish_reason!r}, "
                f"score={self.score:.3f})")


class _Request:
    __slots__ = ("rid", "prompt", "max_new_tokens", "eos_id", "priority",
                 "deadline", "stream", "future", "submitted_at",
                 "generated", "score", "first_token_at", "sampling")

    def __init__(self, rid, prompt, max_new_tokens, eos_id, priority,
                 deadline, stream, future, submitted_at, sampling=None):
        self.rid = rid
        self.prompt = prompt                # np.int32 (P,)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.priority = priority
        self.deadline = deadline            # absolute clock seconds or None
        self.stream = stream                # callable(rid, token) or None
        self.future = future
        self.submitted_at = submitted_at
        self.generated = []
        self.score = 0.0
        self.first_token_at = None
        self.sampling = sampling            # SamplingParams or None


class _Slot:
    __slots__ = ("req", "blocks", "table", "pos")

    def __init__(self, req, blocks, table):
        self.req = req
        self.blocks = blocks                # every block to release
        self.table = table                  # np.int32 (max_blocks,)
        self.pos = 0                        # next logical position to feed

    @property
    def prefilling(self):
        return self.pos < len(self.req.prompt)


class IterationPlan:
    """One fused step's host-built inputs + what commit() needs.
    `emitting` holds the slots whose step output IS a generated token
    (decode slots, and prefill slots finishing their prompt this
    iteration); `decode_cols[s]` is 1 for a decode lane and 0 for a
    prefill lane. `sample_ctl` = (do_sample (S,) bool, temperature (S,)
    f32, top_k (S,) i32 0=off, top_p (S,) f32 2.0=off, keys (S, 2) u32)."""

    __slots__ = ("tokens", "positions", "valid", "tables", "slot_ids",
                 "emitting", "prefill_tokens", "decode_cols", "sample_ctl")

    def __init__(self, tokens, positions, valid, tables, slot_ids,
                 emitting, prefill_tokens, decode_cols, sample_ctl):
        self.tokens = tokens                # (S, C) int32
        self.positions = positions          # (S, C) int32
        self.valid = valid                  # (S, C) bool
        self.tables = tables                # (S, M) int32
        self.slot_ids = slot_ids            # slots with work this iter
        self.emitting = emitting            # set of slot ids
        self.prefill_tokens = prefill_tokens
        self.decode_cols = decode_cols      # (S,) int32
        self.sample_ctl = sample_ctl


class ContinuousBatchingScheduler:
    """Owns the request queue, the slot map, and the block accounting.
    Thread-safe: submits/cancels may come from any thread; plan() and
    commit() are called by the single engine loop."""

    def __init__(self, cache, num_slots=4, chunk=4, max_context=None,
                 clock=None, watermark_blocks=0):
        self._cache = cache
        self.num_slots = int(num_slots)
        self.chunk = int(chunk)
        self.max_context = int(max_context or
                               cache.usable_blocks * cache.block_size)
        self.max_blocks = cache.blocks_for_tokens(self.max_context)
        self._clock = clock or time.monotonic
        self.watermark_blocks = int(watermark_blocks)
        self._lock = threading.RLock()
        self._queue = []                # heap of (priority, seq, req)
        self._seq = 0
        self._slots = [None] * self.num_slots
        self._cancel_rids = set()
        self.iteration = 0
        self.counts = {"admitted": 0, "retired": 0, "cancelled": 0,
                       "deadline_cancels": 0, "generated_tokens": 0,
                       "prefill_tokens": 0}

    # -- client side -------------------------------------------------------
    def now(self):
        return self._clock()

    def enqueue(self, req):
        with self._lock:
            heapq.heappush(self._queue, (req.priority, self._seq, req))
            self._seq += 1

    def request_cancel(self, rid):
        with self._lock:
            self._cancel_rids.add(rid)

    @property
    def queue_depth(self):
        with self._lock:
            return len(self._queue)

    @property
    def active_count(self):
        with self._lock:
            return sum(s is not None for s in self._slots)

    def has_work(self):
        with self._lock:
            return bool(self._queue) or any(
                s is not None for s in self._slots)

    # -- retirement --------------------------------------------------------
    def _finish(self, req, reason):
        ttft = None
        if req.first_token_at is not None:
            ttft = (req.first_token_at - req.submitted_at) * 1e3
        res = GenerationResult(req.rid,
                               np.asarray(req.generated, np.int32),
                               req.score, reason, len(req.prompt), ttft)
        try:
            if not req.future.cancelled():
                req.future.set_result(res)
        except InvalidStateError:
            pass        # client cancelled between the check and the set
        self.counts["retired"] += 1
        return res

    def _fail(self, req, exc, count_key):
        try:
            if not req.future.cancelled():
                req.future.set_exception(exc)
        except InvalidStateError:
            pass        # client cancelled between the check and the set
        self.counts[count_key] += 1

    def _release_slot(self, sid):
        slot = self._slots[sid]
        self._slots[sid] = None
        self._cache.free(slot.blocks)

    def _drop_queued(self, pred, exc_fn, count_key):
        kept = []
        for item in self._queue:
            req = item[2]
            if pred(req):
                self._fail(req, exc_fn(req), count_key)
            else:
                kept.append(item)
        if len(kept) != len(self._queue):
            self._queue = kept
            heapq.heapify(self._queue)

    def drop_queued_request(self, rid, exc):
        """Remove ONE queued request and fail its future (submit()'s
        lost-the-race-with-close sweep); if it was already admitted,
        mark it cancelled for the next iteration instead. Returns True
        if it was still queued."""
        with self._lock:
            before = len(self._queue)
            self._drop_queued(lambda r: r.rid == rid, lambda r: exc,
                              "cancelled")
            if len(self._queue) != before:
                return True
            self._cancel_rids.add(rid)
            return False

    def cancel_all(self, exc=None):
        """Server shutdown without drain: fail everything outstanding."""
        with self._lock:
            exc = exc or RequestCancelled("server closed")
            self._drop_queued(lambda r: True, lambda r: exc, "cancelled")
            for sid, slot in enumerate(self._slots):
                if slot is not None:
                    self._fail(slot.req, exc, "cancelled")
                    self._release_slot(sid)

    # -- one iteration -----------------------------------------------------
    def _apply_cancels_and_deadlines(self, now):
        if self._cancel_rids:
            rids = self._cancel_rids
            self._cancel_rids = set()
            self._drop_queued(lambda r: r.rid in rids,
                              lambda r: RequestCancelled(
                                  f"request {r.rid} cancelled"),
                              "cancelled")
            for sid, slot in enumerate(self._slots):
                if slot is not None and slot.req.rid in rids:
                    self._fail(slot.req, RequestCancelled(
                        f"request {slot.req.rid} cancelled"), "cancelled")
                    self._release_slot(sid)
        self._drop_queued(
            lambda r: r.deadline is not None and now > r.deadline,
            lambda r: DeadlineExceeded(
                f"request {r.rid} deadline passed while queued"),
            "deadline_cancels")
        for sid, slot in enumerate(self._slots):
            if slot is None:
                continue
            dl = slot.req.deadline
            if dl is not None and now > dl:
                self._fail(slot.req, DeadlineExceeded(
                    f"request {slot.req.rid} deadline passed after "
                    f"{len(slot.req.generated)} tokens"),
                    "deadline_cancels")
                self._release_slot(sid)

    def _admit(self):
        while self._queue:
            free_sid = next((i for i, s in enumerate(self._slots)
                             if s is None), None)
            if free_sid is None:
                return
            req = self._queue[0][2]
            need = self._cache.blocks_for_tokens(
                len(req.prompt) + req.max_new_tokens)
            # watermark backpressure: keep headroom unless the pool is
            # otherwise idle (an idle pool must admit or deadlock)
            floor = self.watermark_blocks if self.active_count else 0
            if self._cache.num_free - need < floor:
                return
            blocks = self._cache.allocate(need)
            if blocks is None:
                return
            heapq.heappop(self._queue)
            table = self._cache.make_table(blocks, self.max_blocks)
            self._slots[free_sid] = _Slot(req, blocks, table)
            self.counts["admitted"] += 1

    def plan(self):
        """Build one iteration's fused-step inputs, or None when idle.
        Admission, cancels, and deadlines are resolved first, so the
        arrays describe live lanes only. A truly idle call does not
        count an iteration."""
        with self._lock:
            if not (self._queue or self._cancel_rids
                    or any(s is not None for s in self._slots)):
                return None
            self.iteration += 1
            now = self.now()
            self._apply_cancels_and_deadlines(now)
            self._admit()
            s, c = self.num_slots, self.chunk
            tokens = np.zeros((s, c), np.int32)
            positions = np.zeros((s, c), np.int32)
            valid = np.zeros((s, c), bool)
            tables = np.zeros((s, self.max_blocks), np.int32)
            decode_cols = np.zeros((s,), np.int32)
            do_sample = np.zeros((s,), bool)
            temperature = np.ones((s,), np.float32)
            top_k = np.zeros((s,), np.int32)
            top_p = np.full((s,), 2.0, np.float32)
            rng_keys = np.zeros((s, 2), np.uint32)
            slot_ids, emitting = [], set()
            prefill_tokens = 0
            for sid, slot in enumerate(self._slots):
                if slot is None:
                    continue
                slot_ids.append(sid)
                req = slot.req
                if slot.prefilling:
                    n = min(c, len(req.prompt) - slot.pos)
                    tokens[sid, :n] = req.prompt[slot.pos:slot.pos + n]
                    prefill_tokens += n
                    if slot.pos + n == len(req.prompt):
                        emitting.add(sid)
                else:
                    n = 1
                    decode_cols[sid] = 1
                    tokens[sid, 0] = req.generated[-1]
                    emitting.add(sid)
                sp = req.sampling
                if sp is not None and sp.do_sample and sid in emitting:
                    # the RNG key is a pure fold of (seed, lane rank,
                    # emit position), so a replay resamples identically;
                    # an n=1 request is lane rank 0
                    do_sample[sid] = True
                    temperature[sid] = sp.temperature
                    top_k[sid] = sp.top_k or 0
                    top_p[sid] = sp.top_p if sp.top_p is not None else 2.0
                    rng_keys[sid] = fold_key(sp.seed, 0, slot.pos + n - 1)
                tables[sid] = slot.table
                positions[sid, :n] = np.arange(slot.pos, slot.pos + n)
                valid[sid, :n] = True
            if not slot_ids:
                return None
            self.counts["prefill_tokens"] += prefill_tokens
            return IterationPlan(
                tokens, positions, valid, tables, slot_ids, emitting,
                prefill_tokens, decode_cols,
                (do_sample, temperature, top_k, top_p, rng_keys))

    def commit(self, plan, next_ids, next_logps):
        """Apply one fused step's outputs: advance positions, record
        emitted tokens (stream callbacks fire here), retire finished
        lanes. `next_ids`/`next_logps` are per-column (S, C); a prefill
        lane reads its last valid column, a decode lane column 0.
        Returns the GenerationResults retired this iteration."""
        retired = []
        with self._lock:
            now = self.now()
            for sid in plan.slot_ids:
                slot = self._slots[sid]
                if slot is None:        # raced with a cancel mid-step
                    continue
                req = slot.req
                if int(plan.decode_cols[sid]) == 0:
                    n = int(plan.valid[sid].sum())
                    slot.pos += n
                    if sid not in plan.emitting:
                        continue
                    col = n - 1
                else:
                    slot.pos += 1
                    col = 0
                finished = self._emit_token(
                    req, int(next_ids[sid, col]),
                    float(next_logps[sid, col]), now)
                if finished is not None:
                    retired.append(self._finish(req, finished))
                    self._release_slot(sid)
        return retired

    def _emit_token(self, req, tok, lp, now):
        """Record ONE committed token on `req`. Returns the finish
        reason ("eos" | "length") or None."""
        req.score += lp
        req.generated.append(tok)
        self.counts["generated_tokens"] += 1
        if req.first_token_at is None:
            req.first_token_at = now
        if req.stream is not None:
            try:
                req.stream(req.rid, tok)
            except Exception:  # noqa: BLE001 - a client
                pass    # callback must never kill the loop
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.generated) >= req.max_new_tokens:
            return "length"
        return None

    # -- introspection -----------------------------------------------------
    def stats(self):
        with self._lock:
            return {
                "iteration": self.iteration,
                "queue_depth": len(self._queue),
                "active_slots": sum(s is not None for s in self._slots),
                "num_slots": self.num_slots,
                "blocks_total": self._cache.usable_blocks,
                "blocks_free": self._cache.num_free,
                "block_utilization": round(self._cache.utilization(), 4),
                "watermark_blocks": self.watermark_blocks,
                **dict(self.counts),
            }
