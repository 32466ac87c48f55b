"""Iteration-level continuous-batching scheduler (host-only).

Counterpart of ``paddle_tpu/serving/scheduler.py``. One scheduler
iteration is one fused prefill/decode step over a FIXED number of decode
slots (S) x a FIXED chunk width (C): prefilling slots feed up to C prompt
tokens, decoding slots feed their one in-flight token, idle lanes are
masked. Shapes never change, so requests of any length mix in one step.

Host-side state machine only (Python and numpy, apart from the block
copies that copy-on-write and the host tier ask the cache for):
admission from a FIFO-within-priority queue gated by block-pool
watermark backpressure (admission reserves blocks for the whole prompt +
output up front, so a running request never runs out of blocks
mid-flight), retirement of EOS/length-finished lanes, per-request
deadlines and client cancels that reclaim blocks. Time comes from an
injectable `clock` (seconds, monotonic). On top of that core:

- Prefix caching (`prefix_cache=PrefixCacheIndex(...)`): admission
  matches the prompt's full chunks in the hash-chain index, reserves only
  the unshared suffix (+1 copy-on-write spare when the whole prompt
  matched), starts prefill past the shared positions, registers freshly
  prefilled full chunks at commit, and retirement unrefs instead of
  freeing. Under pool pressure admission evicts idle cached blocks (LRU,
  leaf-first) before it backpressures.
- Speculative decoding (`spec_k=k`): decode lanes plan q = min(k+1,
  chunk, remaining) columns; the engine fills columns 1..q-1 with draft
  proposals, the fused step verifies all q in one call, and commit()
  accepts the longest matching draft prefix plus the target's own next
  token (greedy: ids identical to plain decode), or draws acceptance
  with `spec_mode="rejection"`.
- Fork groups (n > 1 sampling, beam search): one prefill, K lanes whose
  tables alias the prompt's blocks; beam reorders are table remaps.
- Guided decoding: each emission of a constrained lane is masked by its
  automaton, which advances on committed tokens.
- The host KV tier (``cache.enable_host_tier``): admission turns lazy. A
  request reserves blocks for its prompt + the first decode write and
  pledges its whole worst case against the host pool; its table grows
  block by block as it decodes (`_ensure_blocks`). When the device pool
  runs dry, the decode lane with the longest tail left is preempted: its
  written blocks spill to the host, its slot frees, and it resumes (swap
  in, same position, same stream) before any new admission once blocks
  free up. A request whose worst case exceeds the host tier, or that
  finds the pledges spent, falls back to full reservation. Fork-group
  lanes are never preempted.
- Chaos hooks (`chaos=ChaosInjector`): cancels, clock advances, forced
  evictions and spills, preemption of a named request and copy-on-write
  storms at exact iterations.
- Telemetry (`telemetry=ServingTelemetry`): admission, prefill chunk,
  token and finish hooks, and the per-lane tuples of the flight
  recorder (`_lane_tuple`, `lane_snapshot`). The ``serving.*`` counters
  and the TTFT/ITL histograms are recorded either way.
"""

import heapq
import threading
import time
from concurrent.futures import InvalidStateError

import numpy as np

from ..observability import _help
from ..observability.metrics import global_registry
from .decode_strategies import (BeamHypothesis, GroupResult, beam_step,
                                finalize_beam, fold_key, host_sample)
from .kv_cache import NEG_INF

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
                 "deadline", "stream", "future", "submitted_at", "tenant",
                 "generated", "score", "first_token_at", "last_token_at",
                 "chain_keys", "group", "lane", "sampling", "guided",
                 "guided_state")

    def __init__(self, rid, prompt, max_new_tokens, eos_id, priority,
                 deadline, stream, future, submitted_at, tenant=None,
                 group=None, lane=0, sampling=None, guided=None):
        self.rid = rid
        self.prompt = prompt                # np.int32 (P,)
        self.max_new_tokens = max_new_tokens
        self.eos_id = eos_id
        self.priority = priority
        self.deadline = deadline            # absolute clock seconds or None
        self.stream = stream                # callable(rid, token) or None
        self.future = future
        self.submitted_at = submitted_at
        self.tenant = tenant                # cost-attribution identity
        self.generated = []
        self.score = 0.0
        self.first_token_at = None
        self.last_token_at = None
        self.chain_keys = None      # prefix chunk hashes, computed once
        self.group = group          # RequestGroup when forked (n>1/beam)
        self.lane = lane            # rank within the group (0 = leader)
        self.sampling = sampling    # SamplingParams or None
        self.guided = guided        # guided.Constraint or None
        self.guided_state = None    # current automaton state


class _Slot:
    __slots__ = ("req", "blocks", "table", "pos", "admit_seq", "shared",
                 "keys", "registered", "cow_spares", "cow_copies", "tier",
                 "hold")

    def __init__(self, req, blocks, table, admit_seq, shared=(), keys=(),
                 registered=0, cow_spares=(), tier="device"):
        self.req = req
        self.blocks = blocks                # every block to release
        self.table = table                  # np.int32 (max_blocks,)
        self.pos = 0                        # next logical position to feed
        self.admit_seq = admit_seq          # admission order
        self.shared = list(shared)          # prefix-cache blocks in table
        self.keys = list(keys)              # chunk chain keys computed
        self.registered = registered        # prompt chunks in the index
        self.cow_spares = list(cow_spares)  # reserved copy-on-write blocks
        self.cow_copies = 0
        # "host" when this lane's KV crossed the host tier (admitted over
        # swapped-in spilled chains, or resumed from a preemption): the
        # flight recorder's tier tag
        self.tier = tier
        # a held slot is a fork-group follower waiting for its leader's
        # prefill: it owns its suffix blocks but plans no work until
        # commit's _fork_group clears the hold
        self.hold = False

    @property
    def prefilling(self):
        return self.pos < len(self.req.prompt)


class _Preempted:
    """A preempted request parked off the device: its KV in host-tier
    blocks (its reservation), its position and stream state on the
    _Request untouched, so the resumed slot continues where it stopped.
    `not_before` is the earliest iteration it may resume at."""

    __slots__ = ("req", "pos", "host_blocks", "keys", "registered",
                 "not_before")

    def __init__(self, req, pos, host_blocks, keys, registered,
                 not_before):
        self.req = req
        self.pos = pos
        self.host_blocks = host_blocks
        self.keys = keys
        self.registered = registered
        self.not_before = not_before


def _lane_tuple(sid, slot):
    """One lane's flight-recorder tuple, in exactly
    serving_telemetry.LANE_FIELDS order (the flight dump zips them
    against that schema): plan()'s slot loop and lane_snapshot() both
    build them here."""
    group = slot.req.group
    return (sid, slot.req.rid, int(slot.pos), bool(slot.prefilling),
            int(slot.admit_seq), len(slot.req.generated),
            int(slot.blocks[0]) if slot.blocks else None,
            len(slot.shared), int(slot.cow_copies), slot.tier,
            group.gid if group is not None else None,
            int(slot.req.lane) if group is not None else None)


class IterationPlan:
    """One fused step's host-built inputs + what commit() needs.
    `emitting` holds the slots whose step output IS a generated token
    (decode slots, and prefill slots finishing their prompt this
    iteration). `decode_cols[s]` is the number of verify columns a decode
    lane plans (1 in plain mode, up to spec_k+1 in speculative mode, whose
    columns 1..q-1 the engine fills with draft proposals); 0 marks a
    prefill lane. `limits[s]` is the lane's reserved token horizon
    (prompt + max_new_tokens), past which the draft never writes.
    `prev_tokens[s]` (speculative mode) is the token at position
    pos - 1 of a decode lane fed at pos, which the draft's sync pass
    re-feeds (see engine._run_draft). `sample_ctl` = (do_sample (S,)
    bool, temperature (S,) f32, top_k (S,) i32 0=off, top_p (S,) f32
    2.0=off, keys (S, 2) u32). `guided_lanes`
    lists the (slot, request) pairs whose emission needs a constraint
    mask; `needs_rows` says commit() reads the full logp rows (a beam
    step or a group's fork). With telemetry on, `lanes_detail` holds the
    pre-step lane tuples (LANE_FIELDS order) and `queue_depth` the queue
    after admission, both taken inside plan()'s slot loop; None
    otherwise."""

    __slots__ = ("tokens", "positions", "valid", "tables", "slot_ids",
                 "emitting", "prefill_tokens", "decode_cols", "limits",
                 "prev_tokens", "sample_ctl", "guided_lanes", "needs_rows",
                 "lanes_detail", "queue_depth")

    def __init__(self, tokens, positions, valid, tables, slot_ids,
                 emitting, prefill_tokens, decode_cols, limits=None,
                 prev_tokens=None, sample_ctl=None, guided_lanes=(),
                 needs_rows=False, lanes_detail=None, queue_depth=None):
        self.tokens = tokens                # (S, C) int32
        self.positions = positions          # (S, C) int32
        self.valid = valid                  # (S, C) bool
        self.tables = tables                # (S, M) int32
        self.slot_ids = slot_ids            # slots with work this iter
        self.emitting = emitting            # set of slot ids
        self.prefill_tokens = prefill_tokens
        self.decode_cols = decode_cols      # (S,) int32
        self.limits = limits                # (S,) int32
        self.prev_tokens = prev_tokens      # (S,) int32
        self.sample_ctl = sample_ctl
        self.guided_lanes = guided_lanes
        self.needs_rows = needs_rows
        self.lanes_detail = lanes_detail
        self.queue_depth = queue_depth


class ContinuousBatchingScheduler:
    """Owns the request queue, the slot map, and the block accounting.
    Thread-safe: submits/cancels may come from any thread; plan() and
    commit() are called by the single engine loop."""

    def __init__(self, cache, num_slots=4, chunk=4, max_context=None,
                 clock=None, watermark_blocks=0, chaos=None, telemetry=None,
                 prefix_cache=None, spec_k=0, spec_mode="greedy",
                 spec_seed=0):
        self._cache = cache
        self._tel = telemetry       # ServingTelemetry or None (its hooks
        #                             are host bookkeeping, called under
        #                             self._lock)
        self.num_slots = int(num_slots)
        self.chunk = int(chunk)
        self._prefix = prefix_cache     # PrefixCacheIndex or None
        self.spec_k = int(spec_k)
        self.spec_mode = spec_mode
        if self.spec_k:
            if spec_mode not in ("greedy", "rejection"):
                raise ValueError(
                    f"spec_mode {spec_mode!r}: expected 'greedy' or "
                    f"'rejection'")
            if self.chunk < self.spec_k + 1:
                raise ValueError(
                    f"spec_k={self.spec_k} needs chunk >= spec_k+1 (the "
                    f"verify step feeds the committed token plus k drafts "
                    f"in one chunked call); got chunk={self.chunk}")
        self._spec_rng = np.random.default_rng(spec_seed)
        self.max_context = int(max_context or
                               cache.usable_blocks * cache.block_size)
        self.max_blocks = cache.blocks_for_tokens(self.max_context)
        self._clock = clock or time.monotonic
        self.watermark_blocks = int(watermark_blocks)
        self._chaos = chaos
        self._lock = threading.RLock()
        self._queue = []                # heap of (priority, seq, req)
        self._seq = 0
        self._slots = [None] * self.num_slots
        self._cancel_rids = set()
        self._admit_seq = 0
        self.iteration = 0
        # preemption and resume (host KV tier): a FIFO of _Preempted
        # records and the host-block pledges of lazily admitted requests
        # (each pledges its whole worst-case block count, so it can
        # always park). Plain attributes, not counts: those publish as
        # serving.<key> counters, these as the serving.kv.tier.* gauges
        self._preempted = []
        self._host_pledged = 0
        self._pledges = {}          # rid -> pledged block count
        self.preempts = 0
        self.resumes = 0
        self.counts = {"admitted": 0, "retired": 0, "cancelled": 0,
                       "deadline_cancels": 0, "generated_tokens": 0,
                       "prefill_tokens": 0, "spec.proposed": 0,
                       "spec.accepted": 0, "group.requests": 0,
                       "group.lanes": 0, "group.forks": 0,
                       "group.cow_copies": 0, "beam.reorders": 0,
                       "guided.masked_steps": 0, "guided.violations": 0}
        reg = global_registry()
        self._mc = {k: reg.counter(f"serving.{k}", _help(f"serving.{k}"))
                    for k in self.counts}
        self._ttft = reg.histogram("serving.ttft_ms",
                                   _help("serving.ttft_ms"))
        self._itl = reg.histogram("serving.itl_ms", _help("serving.itl_ms"))
        self._g_accept = reg.gauge("serving.spec.accept_rate",
                                   _help("serving.spec.accept_rate"))

    def _count(self, key, n=1):
        self.counts[key] += n
        self._mc[key].inc(n)

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
            return bool(self._queue) or bool(self._preempted) or any(
                s is not None for s in self._slots)

    def load_snapshot(self):
        """(queue depth, active slots, free blocks) under one lock hold.
        Preempted requests count as queued: admitted work waiting for
        blocks."""
        with self._lock:
            return (len(self._queue) + len(self._preempted),
                    sum(s is not None for s in self._slots),
                    self._cache.num_free)

    # -- retirement --------------------------------------------------------
    def _unpledge(self, req):
        m = self._pledges.pop(req.rid, None)
        if m:
            self._host_pledged -= m

    def _finish(self, req, reason):
        self._unpledge(req)
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
        self._count("retired")
        if ttft is not None:
            self._ttft.observe(ttft)
        if self._tel is not None:
            self._tel.on_finish(
                req.rid, self.iteration, "retire", reason=reason,
                e2e_ms=(self.now() - req.submitted_at) * 1e3,
                prompt_len=len(req.prompt), generated=len(req.generated))
        if req.group is not None:
            self._on_group_finish(req, res)
        return res

    def _fail(self, req, exc, count_key):
        self._unpledge(req)
        try:
            if not req.future.cancelled():
                req.future.set_exception(exc)
        except InvalidStateError:
            pass        # client cancelled between the check and the set
        self._count(count_key)
        if self._tel is not None:
            outcome = ("deadline" if count_key == "deadline_cancels"
                       else "cancel")
            if outcome == "deadline":
                self._tel.on_deadline_cancel(req.rid, self.iteration)
            self._tel.on_finish(req.rid, self.iteration, outcome,
                                reason=type(exc).__name__,
                                prompt_len=len(req.prompt),
                                generated=len(req.generated))
        if req.group is not None:
            self._on_group_fail(req, exc, count_key)

    # -- fork groups: finish/fail as a unit --------------------------------
    def _on_group_finish(self, req, res):
        group = req.group
        group.results[req.lane] = res
        group.lane_sids.pop(req.lane, None)
        if group.failed or len(group.results) < group.k:
            return
        if group.kind == "beam":
            # lane r's generated list IS hypothesis r (eos-padded: done
            # lanes keep committing eos at zero cost, as the dense scan's
            # masked emissions do)
            hist = np.stack([
                np.asarray(group.results[r].token_ids, np.int32)
                for r in range(group.k)])
            ids, norm, order = finalize_beam(
                hist, group.scores, group.eos_id,
                group.beam.length_penalty)
            hyps = [BeamHypothesis(ids[i],
                                   float(group.scores[int(order[i])]),
                                   float(norm[i]))
                    for i in range(group.k)]
            out = GroupResult(group.gid, "beam", hypotheses=hyps,
                              prompt_len=len(req.prompt))
        else:
            out = GroupResult(
                group.gid, "sample",
                lanes=[group.results[r] for r in range(group.k)],
                prompt_len=len(req.prompt))
        try:
            if not group.future.cancelled():
                group.future.set_result(out)
        except InvalidStateError:
            pass

    def _on_group_fail(self, req, exc, count_key):
        group = req.group
        group.lane_sids.pop(req.lane, None)
        if group.failed:
            return
        group.failed = True
        try:
            if not group.future.cancelled():
                group.future.set_exception(exc)
        except InvalidStateError:
            pass
        # the group fails as a unit: siblings in slots are marked
        # cancelled (their slots release in the next iteration's sweep);
        # siblings that never reached a slot fail here
        for lane in group.lanes:
            if lane is req or lane.future.done():
                continue
            if lane.lane in group.lane_sids:
                self._cancel_rids.add(lane.rid)
            else:
                self._fail(lane, RequestCancelled(
                    f"request {lane.rid} cancelled with its group"),
                    "cancelled")

    def _release_slot(self, sid):
        slot = self._slots[sid]
        self._slots[sid] = None
        group = slot.req.group
        if group is not None:
            # a forked lane's table mixes private blocks with blocks its
            # siblings (and maybe the index) hold: unref each block
            if self._prefix is not None:
                self._prefix.release(slot.blocks)
            else:
                self._cache.unref_blocks(slot.blocks)
            group.lane_sids.pop(slot.req.lane, None)
            group.released += 1
            if group.released >= group.k and group.spares:
                # last lane out: the pooled copy-on-write reserve goes home
                self._cache.free(group.spares)
                group.spares = []
            return
        if self._prefix is not None:
            # retirement unrefs: a block this request registered into (or
            # matched from) the index keeps the index's ref and becomes
            # an evictable cached block; private blocks free
            self._prefix.release(slot.blocks)
        else:
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

    def _drop_preempted(self, pred, exc_fn, count_key):
        """_drop_queued for parked requests: a cancel or deadline reaches
        a preempted request too, and its host blocks (its reservation)
        go back to the host pool."""
        kept = []
        for rec in self._preempted:
            if pred(rec.req):
                self._cache.host.free(rec.host_blocks)
                self._fail(rec.req, exc_fn(rec.req), count_key)
            else:
                kept.append(rec)
        self._preempted = kept

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
            self._drop_preempted(lambda r: True, lambda r: exc,
                                 "cancelled")
            for sid, slot in enumerate(self._slots):
                if slot is not None:
                    self._fail(slot.req, exc, "cancelled")
                    self._release_slot(sid)

    # -- one iteration -----------------------------------------------------
    def _apply_cancels_and_deadlines(self, now):
        # chaos cancels name the n-th oldest active request (admission
        # order, not slot order: freed slots are reused)
        if self._chaos is not None:
            for idx in self._chaos.serving_cancels_at(self.iteration):
                active = [s.req.rid for s in sorted(
                    (s for s in self._slots if s is not None),
                    key=lambda s: s.admit_seq)]
                if idx < len(active):
                    self._cancel_rids.add(active[idx])
        if self._cancel_rids:
            rids = self._cancel_rids
            self._cancel_rids = set()
            self._drop_queued(lambda r: r.rid in rids,
                              lambda r: RequestCancelled(
                                  f"request {r.rid} cancelled"),
                              "cancelled")
            self._drop_preempted(lambda r: r.rid in rids,
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
        self._drop_preempted(
            lambda r: r.deadline is not None and now > r.deadline,
            lambda r: DeadlineExceeded(
                f"request {r.rid} deadline passed while preempted"),
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

    def _prefix_probe(self, req, n_full):
        """(shared blocks, chain keys, protected keys) of a pure prefix
        match: no refs, recency or counters move, since a backpressured
        admission retries every iteration. The chain is hashed once per
        request. A spilled (host-tier) entry matches as None: claim()
        swaps it into a fresh device block."""
        if self._prefix is None:
            return [], (), frozenset()
        if req.chain_keys is None:
            req.chain_keys = self._prefix.chain_keys(req.prompt, n_full)
        keys = req.chain_keys
        shared = self._prefix.match(req.prompt, keys)
        return shared, keys, frozenset(keys[:len(shared)])

    def _reserve(self, need, shared, protect):
        """Allocate `need` fresh blocks under watermark backpressure, or
        None. Evictable cached blocks count as supply (eviction runs
        before backpressure), except the entries this match protects.
        Each spilled entry of the match (a None) needs one more free
        block for claim() to swap it into."""
        need_free = need + sum(1 for b in shared if b is None)
        floor = self.watermark_blocks if self.active_count else 0
        avail = self._cache.num_free
        if self._prefix is not None:
            protected_idle = sum(1 for b in shared if b is not None
                                 and self._cache.refcount(b) == 1)
            avail += self._prefix.evictable_total() - protected_idle
        if avail - need_free < floor:
            return None
        if self._prefix is not None and self._cache.num_free < need_free:
            self._prefix.evict_for(need_free, protect)
        if self._cache.num_free < need_free:
            return None
        return self._cache.allocate(need)

    def _admit(self):
        now = self.now()
        self._try_resume(now)
        while self._queue:
            free_sid = next((i for i, s in enumerate(self._slots)
                             if s is None), None)
            if free_sid is None:
                return
            req = self._queue[0][2]
            if req.group is not None:
                if not self._admit_group(req, now):
                    return
                continue
            p_len = len(req.prompt)
            n_full = p_len // self._cache.block_size
            m_total = self._cache.blocks_for_tokens(
                p_len + req.max_new_tokens)
            # lazy admission (host tier on): blocks for the prompt and
            # the first decode write only, and a pledge of the whole
            # worst case against the host pool, where the request parks
            # if it must give its blocks back. The pledge keeps a lazy
            # lane preemptible, so a mid-flight allocation can always be
            # met by preempting someone. A worst case beyond the whole
            # host tier, or a spent pledge pool, takes full reservation
            # (such a lane never grows mid-flight)
            host = self._cache.host
            lazy = host is not None and m_total <= host.num_blocks
            if lazy:
                host_avail = host.num_free - self._host_pledged
                if self._prefix is not None:
                    host_avail += self._prefix.host_entry_count()
                lazy = host_avail >= m_total
            m_admit = (self._cache.blocks_for_tokens(p_len + 1) if lazy
                       else m_total)
            # only the unshared suffix is newly reserved. When the WHOLE
            # prompt matched, prefill restarts at the last prompt token
            # (its logits seed generation): that write lands in the last
            # shared block, so one extra block is reserved up front as
            # the copy-on-write target
            shared, keys, protect = self._prefix_probe(req, n_full)
            shared_tokens = len(shared) * self._cache.block_size
            full_cover = shared_tokens == p_len and shared_tokens > 0
            n_spilled = sum(1 for b in shared if b is None)
            need = m_admit - len(shared) + (1 if full_cover else 0)
            blocks = self._reserve(need, shared, protect)
            if blocks is None:
                return
            if self._prefix is not None:
                # the match commits: refs, recency and counters move once
                # per admission, and spilled entries swap in here
                shared = self._prefix.claim(keys, shared, n_full)
            heapq.heappop(self._queue)
            cow_spares = [blocks.pop()] if full_cover else []
            table = self._cache.make_table(shared + blocks,
                                           self.max_blocks)
            slot = _Slot(req, shared + blocks + cow_spares, table,
                         self._admit_seq, shared=shared, keys=keys,
                         registered=len(shared), cow_spares=cow_spares,
                         tier="host" if n_spilled else "device")
            if lazy:
                self._host_pledged += m_total
                self._pledges[req.rid] = m_total
            # shared positions skip prefill: their KV is already in the
            # pool, what this request would have written
            slot.pos = p_len - 1 if full_cover else shared_tokens
            self._slots[free_sid] = slot
            self._admit_seq += 1
            self._count("admitted")
            if self._tel is not None:
                self._tel.on_admit(req.rid, free_sid, self.iteration,
                                   (now - req.submitted_at) * 1e3,
                                   blocks=len(slot.blocks))

    def _admit_group(self, leader, now):
        """Group-atomic admission: the leader's queue entry stands for
        all K lanes, and either every lane gets its slot and its whole
        reservation, or nothing moves. The reservation covers the worst
        case exactly:

            leader prompt+output blocks        (prefix-shared part free)
          + (K-1) per-lane suffix extras       (each lane's divergence)
          + K pooled copy-on-write spares      (one boundary-block copy a
                                               lane; lanes never write
                                               below the prompt's last
                                               block)

        The reservation is always full (no lazy pledge: forked lanes are
        never preempted, see _preempt_victim).

        Followers are admitted held: they own their suffix blocks but
        plan no work until the leader's prefill completes and commit's
        _fork_group aliases the prompt table into them (the refs are
        taken then, so the leader's own prefill writes do not look
        shared)."""
        group = leader.group
        k = group.k
        free_sids = [i for i, s in enumerate(self._slots) if s is None]
        if len(free_sids) < k:
            return False
        bs = self._cache.block_size
        p_len = len(leader.prompt)
        n_full = p_len // bs
        m_prompt = self._cache.blocks_for_tokens(p_len)
        m_total = self._cache.blocks_for_tokens(
            p_len + leader.max_new_tokens)
        extra = m_total - m_prompt
        shared, keys, protect = self._prefix_probe(leader, n_full)
        shared_tokens = len(shared) * bs
        full_cover = shared_tokens == p_len and shared_tokens > 0
        n_spilled = sum(1 for b in shared if b is None)
        need = (m_total - len(shared)) + (k - 1) * extra + k
        blocks = self._reserve(need, shared, protect)
        if blocks is None:
            return False
        if self._prefix is not None:
            shared = self._prefix.claim(keys, shared, n_full)
        heapq.heappop(self._queue)
        group.spares = [blocks.pop() for _ in range(k)]
        lane_extras = [[blocks.pop() for _ in range(extra)]
                       for _ in range(k - 1)]
        # the remaining blocks are the leader's unshared prompt + suffix
        table = self._cache.make_table(shared + blocks, self.max_blocks)
        slot = _Slot(leader, shared + blocks, table, self._admit_seq,
                     shared=shared, keys=keys, registered=len(shared),
                     tier="host" if n_spilled else "device")
        slot.pos = p_len - 1 if full_cover else shared_tokens
        self._slots[free_sids[0]] = slot
        group.lane_sids[0] = free_sids[0]
        self._admit_seq += 1
        for r in range(1, k):
            ftable = np.zeros((self.max_blocks,), np.int32)
            ext = lane_extras[r - 1]
            ftable[m_prompt:m_prompt + len(ext)] = ext
            # registered = n_full: the leader registers the shared prompt
            # chunks once for the whole group
            fslot = _Slot(group.lanes[r], list(ext), ftable,
                          self._admit_seq, registered=n_full,
                          tier=slot.tier)
            fslot.hold = True
            self._slots[free_sids[r]] = fslot
            group.lane_sids[r] = free_sids[r]
            self._admit_seq += 1
        self._count("admitted", k)
        self._count("group.requests")
        self._count("group.lanes", k)
        if self._tel is not None:
            for r in range(k):
                self._tel.on_admit(
                    group.lanes[r].rid, free_sids[r], self.iteration,
                    (now - group.lanes[r].submitted_at) * 1e3,
                    blocks=len(self._slots[free_sids[r]].blocks))
        return True

    # -- preemption and resume (host KV tier) -----------------------------
    def _try_resume(self, now):
        """Swap parked requests back in, oldest first, before any new
        admission: a preempted request has already paid its queueing and
        prefill. Stops at the first one that cannot resume (FIFO: a
        small request must not starve a big one)."""
        while self._preempted:
            rec = self._preempted[0]
            if rec.not_before > self.iteration:
                return
            free_sid = next((i for i, s in enumerate(self._slots)
                             if s is None), None)
            if free_sid is None:
                return
            need = len(rec.host_blocks)
            floor = self.watermark_blocks if self.active_count else 0
            avail = self._cache.num_free
            if self._prefix is not None:
                avail += self._prefix.evictable_total()
            if avail - need < floor:
                return
            if self._prefix is not None and self._cache.num_free < need:
                self._prefix.evict_for(need)
            blocks = self._cache.allocate(need)
            if blocks is None:
                return
            self._preempted.pop(0)
            for hb, db in zip(rec.host_blocks, blocks):
                self._cache.swap_in_block(hb, db)
            self._cache.host.free(rec.host_blocks)
            table = self._cache.make_table(blocks, self.max_blocks)
            slot = _Slot(rec.req, list(blocks), table, self._admit_seq,
                         keys=rec.keys, registered=rec.registered,
                         tier="host")
            slot.pos = rec.pos
            self._slots[free_sid] = slot
            self._admit_seq += 1
            self.resumes += 1
            if self._tel is not None:
                self._tel.on_admit(rec.req.rid, free_sid, self.iteration,
                                   (now - rec.req.submitted_at) * 1e3,
                                   blocks=len(blocks))

    def _preempt_victim(self, exclude=None):
        """The slot to preempt under block pressure: the decode lane
        with the most tokens left to generate (it would hold its blocks
        longest). Prefilling lanes are never victims, and neither are
        fork-group lanes: a group was admitted with its full reservation,
        parking one lane would strand its siblings' shared blocks, and
        the beam commit steps every lane together."""
        best, best_rem = None, -1
        for sid, slot in enumerate(self._slots):
            if slot is None or sid == exclude or slot.prefilling:
                continue
            if slot.req.group is not None:
                continue
            rem = slot.req.max_new_tokens - len(slot.req.generated)
            if rem > best_rem:
                best_rem, best = rem, sid
        return best

    def _preempt_slot(self, sid):
        """Park slot `sid`'s request in the host tier: spill every
        written block, release the slot (shared prefix blocks keep the
        index's device copy; the spill wrote a private host copy, so a
        resume never depends on the index) and queue a _Preempted record.
        Generated tokens, score and stream state ride the _Request, so
        the resumed stream is the uninterrupted one. `not_before` keeps
        the request parked across at least one step. Returns False, with
        nothing changed, when the host pool cannot hold the blocks."""
        slot = self._slots[sid]
        used = self._cache.blocks_for_tokens(slot.pos)
        host_blocks = []
        for i in range(used):
            b = int(slot.table[i])
            hb = self._cache.spill_block(b)
            while hb is None and self._prefix is not None \
                    and self._prefix._drop_host_lru() is not None:
                hb = self._cache.spill_block(b)
            if hb is None:
                if host_blocks:
                    self._cache.host.free(host_blocks)
                return False
            host_blocks.append(hb)
        rec = _Preempted(slot.req, slot.pos, host_blocks, slot.keys,
                         len(slot.req.prompt) // self._cache.block_size,
                         self.iteration + 1)
        self._release_slot(sid)
        self._preempted.append(rec)
        self.preempts += 1
        return True

    def _ensure_blocks(self, sid, slot, n):
        """Lazy-mode growth: make the table cover this iteration's writes
        [pos, pos + n) before the plan captures it. Under pressure: the
        free list, then prefix eviction, then preempting the longest-tail
        other decode lane, then parking this lane itself. Returns False
        when the lane sits this iteration out (or was itself
        preempted)."""
        bs = self._cache.block_size
        for bi in range((slot.pos + n - 1) // bs + 1):
            if int(slot.table[bi]) != 0:        # NULL-padded tail
                continue
            got = self._cache.allocate(1)
            if got is None and self._prefix is not None:
                self._prefix.evict_for(1)
                got = self._cache.allocate(1)
            while got is None:
                victim = self._preempt_victim(exclude=sid)
                if victim is None or not self._preempt_slot(victim):
                    break
                got = self._cache.allocate(1)
            if got is None:
                # last resort: park this lane (its pledge guarantees the
                # host space; parked beats wedged)
                if not slot.prefilling:
                    self._preempt_slot(sid)
                return False
            slot.table[bi] = got[0]
            slot.blocks.append(got[0])
        return True

    # -- copy-on-write -----------------------------------------------------
    def _cow_block(self, slot, bi):
        """Copy slot's table[bi] to a fresh block and repoint. Spare
        priority: the group's pooled reserve, the slot's own admission
        spare, then a defensive allocate (after eviction). The abandoned
        block's ref goes by who else holds it: index-owned -> drop_block
        (the index keeps it); a group block whose refcount would drop to
        0 is kept in the group's spares (the group's worst case stays
        inside its own reservation); otherwise a plain unref."""
        b = int(slot.table[bi])
        group = slot.req.group
        if group is not None and group.spares:
            nb = group.spares.pop()
            slot.blocks.append(nb)
        elif slot.cow_spares:
            nb = slot.cow_spares.pop()
        else:
            got = self._cache.allocate(1)
            if got is None and self._prefix is not None:
                self._prefix.evict_for(1)
                got = self._cache.allocate(1)
            if got is None:
                raise MemoryError(
                    f"copy-on-write of block {b} found no free block "
                    f"(pool exhausted)")
            nb = got[0]
            slot.blocks.append(nb)
        self._cache.cow_copy(b, nb)
        slot.table[bi] = nb
        if b in slot.blocks:
            slot.blocks.remove(b)
        if b in slot.shared:
            slot.shared.remove(b)
        if self._prefix is not None and self._prefix.owns_block(b):
            self._prefix.drop_block(b)      # this request's ref moves on
        elif group is not None and self._cache.refcount(b) == 1:
            group.spares.append(b)          # retained in the reservation
        else:
            self._cache.unref(b)
        slot.cow_copies += 1
        if group is not None:
            group.cow_copies += 1
            self._count("group.cow_copies")
        return nb

    def _maybe_cow(self, slot, pos, n):
        """Copy-on-write guard over the blocks this lane writes this
        iteration ([pos, pos+n)): a shared block in range is copied to a
        reserved block and the table repointed first; the other holders
        keep the original. A shared block is never written in place."""
        if self._prefix is None and slot.req.group is None:
            return
        bs = self._cache.block_size
        for bi in range(pos // bs, (pos + n - 1) // bs + 1):
            b = int(slot.table[bi])
            if b == 0 or not self._cache.is_shared(b):
                continue
            self._cow_block(slot, bi)

    def _force_cow(self, slot):
        """Copy the block this lane writes next, shared or not (the
        divergence burst the tests drive without arranging real
        divergence). Returns True when a copy happened."""
        bi = slot.pos // self._cache.block_size
        if bi >= slot.table.size or int(slot.table[bi]) == 0:
            return False
        group = slot.req.group
        if group is not None and not group.spares \
                and not self._cache.num_free:
            return False
        self._cow_block(slot, bi)
        return True

    def _plan_cols(self, slot):
        if slot.prefilling:
            return min(self.chunk, len(slot.req.prompt) - slot.pos)
        sp = slot.req.sampling
        if self.spec_k and not (sp is not None and sp.do_sample):
            # sampled lanes stay 1-column: acceptance is defined against
            # the target's deterministic choice
            return max(1, min(self.spec_k + 1, self.chunk,
                              slot.req.max_new_tokens
                              - len(slot.req.generated)))
        return 1

    def plan(self):
        """Build one iteration's fused-step inputs, or None when idle.
        Admission, cancels, and deadlines are resolved first, so the
        arrays describe live lanes only. A truly idle call does not
        count an iteration."""
        with self._lock:
            if not (self._queue or self._cancel_rids or self._preempted
                    or any(s is not None for s in self._slots)):
                return None
            self.iteration += 1
            if self._chaos is not None:
                self._chaos_before_admission()
            self._apply_cancels_and_deadlines(self.now())
            self._admit()
            if self._preempted and not any(s is not None
                                           for s in self._slots):
                # a parked request is the only live work (a chaos preempt
                # can park the sole decode): an empty plan would read as
                # idle, so advance one iteration (past not_before) and
                # resume now
                self.iteration += 1
                self._admit()
            if self._chaos is not None:
                self._chaos_fork_storm()
            # lazy-mode growth first: every lane's blocks are settled
            # before any table row is captured below (a preemption in
            # the row loop would leave earlier rows naming spilled and
            # freed blocks)
            starved = set()
            if self._cache.host is not None:
                for sid, slot in enumerate(self._slots):
                    if slot is None or slot.hold:
                        continue
                    if not self._ensure_blocks(sid, slot,
                                               self._plan_cols(slot)):
                        starved.add(sid)
            s, c = self.num_slots, self.chunk
            tokens = np.zeros((s, c), np.int32)
            positions = np.zeros((s, c), np.int32)
            valid = np.zeros((s, c), bool)
            tables = np.zeros((s, self.max_blocks), np.int32)
            decode_cols = np.zeros((s,), np.int32)
            limits = np.zeros((s,), np.int32)
            prev_tokens = np.zeros((s,), np.int32)
            do_sample = np.zeros((s,), bool)
            temperature = np.ones((s,), np.float32)
            top_k = np.zeros((s,), np.int32)
            top_p = np.full((s,), 2.0, np.float32)
            rng_keys = np.zeros((s, 2), np.uint32)
            slot_ids, emitting, guided_lanes = [], set(), []
            prefill_tokens = 0
            needs_rows = False
            lanes = [] if self._tel is not None else None
            for sid, slot in enumerate(self._slots):
                # held slots are fork-group followers parked until the
                # leader's prefill completes
                if slot is None or sid in starved or slot.hold:
                    continue
                slot_ids.append(sid)
                req = slot.req
                limits[sid] = len(req.prompt) + req.max_new_tokens
                if lanes is not None:
                    lanes.append(_lane_tuple(sid, slot))
                n = self._plan_cols(slot)
                if slot.prefilling:
                    tokens[sid, :n] = req.prompt[slot.pos:slot.pos + n]
                    prefill_tokens += n
                    if self._tel is not None:
                        self._tel.on_prefill_chunk(req.rid, self.iteration,
                                                   n)
                    if slot.pos + n == len(req.prompt):
                        emitting.add(sid)
                else:
                    # decode lane: 1 column, or in spec mode q verify
                    # columns whose 1..q-1 the engine fills with drafts
                    decode_cols[sid] = n
                    tokens[sid, 0] = req.generated[-1]
                    prev_tokens[sid] = (req.generated[-2]
                                        if len(req.generated) > 1
                                        else req.prompt[-1])
                    emitting.add(sid)
                group = req.group
                sp = req.sampling
                if (sp is not None and sp.do_sample and sid in emitting
                        and (group is None or group.prefilled)):
                    # the RNG key is a pure fold of (seed, lane rank,
                    # emit position), so a replay resamples identically
                    do_sample[sid] = True
                    temperature[sid] = sp.temperature
                    top_k[sid] = sp.top_k or 0
                    top_p[sid] = sp.top_p if sp.top_p is not None else 2.0
                    rng_keys[sid] = fold_key(sp.seed, req.lane,
                                             slot.pos + n - 1)
                if req.guided is not None and sid in emitting:
                    guided_lanes.append((sid, req))
                    self._count("guided.masked_steps")
                if group is not None:
                    if group.kind == "beam" and not slot.prefilling:
                        needs_rows = True
                    if not group.prefilled and sid in emitting:
                        needs_rows = True
                # a shared block is never written in place: copy and
                # repoint before the table row is captured
                self._maybe_cow(slot, slot.pos, n)
                tables[sid] = slot.table
                positions[sid, :n] = np.arange(slot.pos, slot.pos + n)
                valid[sid, :n] = True
            if not slot_ids:
                return None
            self._count("prefill_tokens", prefill_tokens)
            return IterationPlan(
                tokens, positions, valid, tables, slot_ids, emitting,
                prefill_tokens, decode_cols, limits=limits,
                prev_tokens=prev_tokens,
                sample_ctl=(do_sample, temperature, top_k, top_p,
                            rng_keys),
                guided_lanes=tuple(guided_lanes), needs_rows=needs_rows,
                lanes_detail=tuple(lanes) if lanes is not None else None,
                queue_depth=len(self._queue) if lanes is not None
                else None)

    def _chaos_before_admission(self):
        """The chaos plan of this iteration that runs before admission:
        the clock advance, forced prefix evictions and spills (each
        counted only when it happened: a spill only when the eviction
        took the host path), and the preemption of named decode lanes
        (resumed by _try_resume, from the next iteration on)."""
        chaos = self._chaos
        chaos.on_serving_iteration(self.iteration)
        if self._prefix is not None:
            for _ in range(chaos.serving_evictions_at(self.iteration)):
                if self._prefix.evict_lru() is not None:
                    chaos.serving_eviction_applied()
            for _ in range(chaos.serving_spills_at(self.iteration)):
                before = self._prefix.counts["spills"]
                if (self._prefix.evict_lru() is not None
                        and self._prefix.counts["spills"] > before):
                    chaos.serving_spill_applied()
        if self._cache.host is not None:
            for rid in chaos.serving_preempts_at(self.iteration):
                for sid, slot in enumerate(self._slots):
                    if (slot is not None and slot.req.rid == rid
                            and slot.req.group is None
                            and not slot.prefilling):
                        if self._preempt_slot(sid):
                            chaos.serving_preempt_applied()
                        break

    def _chaos_fork_storm(self):
        """Chaos fork storm: force copy-on-write of the next written
        block on up to k live forked lanes at this iteration."""
        k_storm = self._chaos.fork_storms_at(self.iteration)
        if not k_storm:
            return
        forced = 0
        for slot in self._slots:
            if forced >= k_storm:
                break
            if slot is None or slot.hold or slot.req.group is None \
                    or slot.prefilling:
                continue
            if self._force_cow(slot):
                forced += 1
        if forced:
            self._chaos.fork_storm_applied(forced)

    def _accept(self, plan, sid, ids, logps, fed_logps, draft_logps):
        """One decode lane's committed (token, logp) list + position
        advance. Column i's output is the target's next-token choice
        after fed column i; fed columns 1..q-1 are the drafts.

        greedy: accept the longest prefix of drafts matching the target's
        own per-column argmax, then commit the target's next token after
        it: every committed id is the target's greedy choice, so the
        stream equals plain decode's.

        rejection: accept draft i with probability min(1, p_target(d_i) /
        p_draft(d_i)); an accepted draft is committed AS the draft (the
        KV at its position is the draft's), and the first rejection
        commits the target argmax as the correction token (greedy
        correction in place of residual resampling, as the JAX package
        does)."""
        q = int(plan.decode_cols[sid])
        if q == 1:
            return [(int(ids[sid, 0]), float(logps[sid, 0]))], 1
        toks = plan.tokens[sid]
        j = 0
        if self.spec_mode == "greedy":
            while j < q - 1 and int(toks[j + 1]) == int(ids[sid, j]):
                j += 1
            commits = [(int(ids[sid, i]), float(logps[sid, i]))
                       for i in range(j + 1)]
        else:
            commits = []
            while j < q - 1:
                ratio = float(fed_logps[sid, j]) - float(
                    draft_logps[sid, j])
                if self._spec_rng.random() >= min(1.0, np.exp(ratio)):
                    break
                commits.append((int(toks[j + 1]),
                                float(fed_logps[sid, j])))
                j += 1
            commits.append((int(ids[sid, j]), float(logps[sid, j])))
        self._count("spec.proposed", q - 1)
        self._count("spec.accepted", j)
        self._g_accept.set(self.counts["spec.accepted"]
                           / max(self.counts["spec.proposed"], 1))
        return commits, j + 1

    def commit(self, plan, next_ids, next_logps, fed_logps=None,
               draft_logps=None, rows=None):
        """Apply one fused step's outputs: advance positions, record
        emitted tokens (stream callbacks fire here), retire finished
        lanes. `next_ids`/`next_logps` are per-column (S, C); a prefill
        lane reads its last valid column, a decode lane accepts 1..q
        columns (see _accept). `rows` (only when plan.needs_rows) carries
        the full logp rows, (S, V) or per-column (S, C, V), that the host
        group strategies read. Returns the GenerationResults retired this
        iteration."""
        retired = []
        next_ids = np.asarray(next_ids)
        next_logps = np.asarray(next_logps)
        with self._lock:
            now = self.now()
            # beam groups re-rank across their K lanes first: divergence
            # remaps block tables and rewrites lane streams, so the loop
            # below only applies the precomputed per-lane commits
            beam_overrides = self._commit_beam_groups(plan, rows)
            for sid in plan.slot_ids:
                slot = self._slots[sid]
                if slot is None:        # raced with a cancel mid-step
                    continue
                req = slot.req
                group = req.group
                if int(plan.decode_cols[sid]) == 0:
                    # prefill lane: advance by the chunk fed; register
                    # freshly completed full prompt chunks; emit only
                    # when the prompt finished
                    n = int(plan.valid[sid].sum())
                    slot.pos += n
                    self._register_chunks(slot)
                    if sid not in plan.emitting:
                        continue
                    if group is not None and not group.prefilled:
                        # leader prefill complete: fork the group and
                        # emit every lane's first token on the host
                        retired.extend(self._fork_group(
                            group, sid, slot, rows, next_ids, next_logps,
                            n, now))
                        continue
                    commits = [(int(next_ids[sid, n - 1]),
                                float(next_logps[sid, n - 1]))]
                elif group is not None and group.kind == "beam":
                    override = beam_overrides.get(sid)
                    if override is None:
                        continue    # group skipped this step
                    commits, advance = override
                    slot.pos += advance
                else:
                    commits, advance = self._accept(
                        plan, sid, next_ids, next_logps, fed_logps,
                        draft_logps)
                    slot.pos += advance
                finished = None
                for tok, lp in commits:
                    finished = self._emit_token(req, tok, lp, now)
                    if finished is not None:
                        break       # later accepted tokens discarded
                if finished is not None:
                    retired.append(self._finish(req, finished))
                    self._release_slot(sid)
        return retired

    def _emit_token(self, req, tok, lp, now):
        """Record ONE committed token on `req` and advance its guided
        automaton. Returns the finish reason ("eos" | "length") or
        None."""
        req.score += lp
        req.generated.append(tok)
        self._count("generated_tokens")
        if req.first_token_at is None:
            req.first_token_at = now
            if self._tel is not None:
                self._tel.on_first_token(req.rid, self.iteration,
                                         (now - req.submitted_at) * 1e3)
        else:
            itl = (now - req.last_token_at) * 1e3
            self._itl.observe(itl)
            if self._tel is not None:
                self._tel.on_token(req.rid, self.iteration, itl)
        req.last_token_at = now
        if req.stream is not None:
            try:
                req.stream(req.rid, tok)
            except Exception:  # noqa: BLE001 - a client
                pass    # callback must never kill the loop
        if req.guided is not None and req.guided_state is not None:
            # beam lanes carry eos on the group (a lane never eos-retires)
            eos = req.eos_id if req.group is None else req.group.eos_id
            if eos is None or tok != eos:
                nxt_state = req.guided.advance(req.guided_state, tok)
                if nxt_state is None:
                    # the in-step mask makes this unreachable; counted,
                    # not raised, so the serving loop survives
                    self._count("guided.violations")
                    req.guided_state = None
                else:
                    req.guided_state = nxt_state
        if req.eos_id is not None and tok == req.eos_id:
            return "eos"
        if len(req.generated) >= req.max_new_tokens:
            return "length"
        return None

    def _fork_group(self, group, sid, slot, rows, next_ids, next_logps, n,
                    now):
        """The group leader's prefill just finished: fan out into K
        lanes. Every follower's table adopts the leader's prompt blocks
        by reference (fork_table: one ref a block, no copies), each
        lane's first token is chosen on the host from the leader's last
        logp row (per-lane folded RNG for sampling, one K-way beam_step
        for beam), and followers leave `hold`. Later divergence goes
        through _maybe_cow. Returns the GenerationResults retired at the
        fork (only when max_new_tokens == 1)."""
        retired = []
        if group.failed:
            return retired      # the cancel sweep reclaims the slots
        req = slot.req
        p_len = len(req.prompt)
        m_prompt = self._cache.blocks_for_tokens(p_len)
        k = group.k
        row = None
        if rows is not None:
            row = np.asarray(rows[sid] if rows.ndim == 2
                             else rows[sid, n - 1], np.float32)
        # fork the tables BEFORE emitting: a lane retiring on its first
        # token releases through the group path, which unrefs the prompt
        # blocks it must therefore already hold
        src = [int(slot.table[i]) for i in range(m_prompt)]
        for rank in range(1, k):
            fsid = group.lane_sids.get(rank)
            if fsid is None:
                continue
            fslot = self._slots[fsid]
            forked = self._cache.fork_table(src)
            fslot.table[:m_prompt] = forked
            fslot.blocks = forked + fslot.blocks
            fslot.pos = p_len
            fslot.hold = False
        group.prefilled = True
        self._count("group.forks", k - 1)
        if group.kind == "beam":
            # seeded as the dense reference: lane 0 at score 0, lanes
            # 1..K-1 at NEG_INF, so the first step takes the top K tokens
            # of one distribution
            rows_k = np.tile(row[None, :], (k, 1))
            scores0 = np.full((k,), NEG_INF, np.float32)
            scores0[0] = 0.0
            toks, _parents, scores, done = beam_step(
                rows_k, scores0, np.zeros((k,), bool), group.eos_id)
            group.scores = scores
            group.done = done
            lane_toks = [(int(toks[r]), float(scores[r]))
                         for r in range(k)]
        else:
            sp = group.sampling
            lane_toks = []
            for rank in range(k):
                if sp is not None and sp.do_sample:
                    key = fold_key(sp.seed, rank, p_len - 1)
                    tok, lp = host_sample(row, key, sp.temperature,
                                          sp.top_k, sp.top_p)
                else:
                    tok = int(next_ids[sid, n - 1])
                    lp = float(next_logps[sid, n - 1])
                lane_toks.append((int(tok), float(lp)))
        for rank in range(k):
            fsid = group.lane_sids.get(rank)
            if fsid is None:
                continue
            lane_req = self._slots[fsid].req
            tok, lp = lane_toks[rank]
            finished = self._emit_token(lane_req, tok, lp, now)
            if finished is not None:
                retired.append(self._finish(lane_req, finished))
                self._release_slot(fsid)
        return retired

    def _commit_beam_groups(self, plan, rows):
        """Pre-pass over decode-phase beam groups: the dense reference's
        top-K selection (`beam_step`, once per verify column), diverging
        lanes' streams and tables rewritten from their parents. Returns
        {sid: (commits, advance)} for commit()'s loop."""
        overrides = {}
        by_group = {}
        for sid in plan.slot_ids:
            slot = self._slots[sid]
            if slot is None or int(plan.decode_cols[sid]) == 0:
                continue
            g = slot.req.group
            if g is not None and g.kind == "beam" and g.prefilled:
                by_group.setdefault(g.gid, (g, []))[1].append(sid)
        for g, sids in by_group.values():
            if len(sids) != g.k or g.failed:
                continue    # a lane raced with a cancel: skip the step
            sids.sort(key=lambda s: self._slots[s].req.lane)
            k = g.k
            lane_reqs = [self._slots[s].req for s in sids]
            q = int(plan.decode_cols[sids[0]])
            sc = np.asarray(g.scores, np.float32)
            done = np.asarray(g.done, bool)
            ident = np.arange(k)
            steps = []      # (toks, parents, sc_after, sc_before)
            for j in range(q):
                rows_j = np.stack(
                    [np.asarray(rows[s] if rows.ndim == 2 else rows[s, j],
                                np.float32) for s in sids])
                toks, parents, sc_new, done_new = beam_step(
                    rows_j, sc, done, g.eos_id)
                steps.append((toks, parents, sc_new, sc))
                sc, done = sc_new, done_new
                if not bool(np.all(parents == ident)):
                    break   # divergence: later verify columns are
                    # conditioned on the wrong parent hypotheses
                if j + 1 < q and not all(
                        int(toks[i]) == int(plan.tokens[sids[i], j + 1])
                        for i in range(k)):
                    break   # a chosen token differs from the fed draft
            g.scores, g.done = sc, done
            n_steps = len(steps)
            if q > 1:
                self._count("spec.proposed", (q - 1) * k)
                self._count("spec.accepted", (n_steps - 1) * k)
            # snapshots before any mutation: a lane may adopt a parent
            # that itself adopts another parent this same step
            snaps = [(list(r.generated), r.score, r.guided_state)
                     for r in lane_reqs]
            last_toks, last_parents, last_sc, last_prev = steps[-1]
            commits_by_lane = []
            for i in range(k):
                p = int(last_parents[i])
                if p != i:
                    # adopt the parent's pre-step stream and state, then
                    # commit the parent's identity-step tokens
                    lane_reqs[i].generated = list(snaps[p][0])
                    lane_reqs[i].score = snaps[p][1]
                    lane_reqs[i].guided_state = snaps[p][2]
                commits = [(int(st_t[p]), float(st_a[p] - st_b[p]))
                           for st_t, _, st_a, st_b in steps[:-1]]
                commits.append((int(last_toks[i]),
                                float(last_sc[i] - last_prev[p])))
                commits_by_lane.append(commits)
            if not bool(np.all(last_parents == ident)):
                self._reorder_beam_tables(g, sids, last_parents)
            for i, s in enumerate(sids):
                overrides[s] = (commits_by_lane[i], n_steps)
        return overrides

    def _reorder_beam_tables(self, group, sids, parents):
        """Apply a beam reorder to the K lanes' block tables: lane i
        whose parent p != i adopts a copy of p's pre-step table, taking
        one ref on every live block first, then dropping its old refs
        (blocks whose last ref that would be are kept as group spares).
        The next write into a now-shared block copies it (_maybe_cow)."""
        old = [(self._slots[s].table.copy(), list(self._slots[s].blocks))
               for s in sids]
        moved = [i for i in range(group.k) if int(parents[i]) != i]
        for i in moved:
            new_tbl = old[int(parents[i])][0]
            live = [int(b) for b in new_tbl if b != 0]
            for b in live:
                self._cache.ref(b)
            sl = self._slots[sids[i]]
            sl.table = new_tbl.copy()
            sl.blocks = list(live)
            sl.shared = [b for b in sl.shared if b in live]
        for i in moved:
            for b in old[i][1]:
                if self._cache.refcount(b) == 1:
                    group.spares.append(b)
                else:
                    self._cache.unref(b)
        group.reorders += 1
        self._count("beam.reorders")

    def _register_chunks(self, slot):
        """Offer every freshly prefilled FULL prompt chunk to the prefix
        index (the chain keys were computed at admission)."""
        if self._prefix is None:
            return
        bs = self._cache.block_size
        done = min(slot.pos, len(slot.req.prompt)) // bs
        if done <= slot.registered:
            return
        for i in range(slot.registered, done):
            parent = slot.keys[i - 1] if i else None
            if self._prefix.register(
                    slot.keys[i], parent,
                    slot.req.prompt[i * bs:(i + 1) * bs],
                    int(slot.table[i])):
                if int(slot.table[i]) not in slot.shared:
                    slot.shared.append(int(slot.table[i]))
        slot.registered = done

    def lane_block_for_prompt(self, prompt):
        """The first table block of the active lane whose prompt equals
        `prompt` and has advanced past position 0, or None."""
        with self._lock:
            for slot in self._slots:
                if slot is None or slot.pos < 1:
                    continue
                if np.array_equal(slot.req.prompt, prompt):
                    return int(slot.table[0])
        return None

    # -- introspection -----------------------------------------------------
    def lane_snapshot(self):
        """One tuple per active slot in serving_telemetry.LANE_FIELDS
        order. Cold path: the engine's per-iteration flight entry takes
        plan.lanes_detail; this serves callers without a plan (the
        chaos poison with telemetry off, fault triage)."""
        with self._lock:
            return tuple(_lane_tuple(sid, slot)
                         for sid, slot in enumerate(self._slots)
                         if slot is not None)

    def stats(self):
        with self._lock:
            # watermark headroom in the unit it protects: the bytes ONE
            # device keeps free (a block costs shard_pool_bytes() /
            # num_blocks there under a head-sharded mesh)
            shard_block_bytes = (self._cache.shard_pool_bytes()
                                 // self._cache.num_blocks)
            return {
                "iteration": self.iteration,
                "queue_depth": len(self._queue),
                "active_slots": sum(s is not None for s in self._slots),
                "num_slots": self.num_slots,
                "blocks_total": self._cache.usable_blocks,
                "blocks_free": self._cache.num_free,
                "block_utilization": round(self._cache.utilization(), 4),
                "watermark_blocks": self.watermark_blocks,
                "watermark_shard_bytes": self.watermark_blocks
                * shard_block_bytes,
                "free_shard_bytes": self._cache.num_free
                * shard_block_bytes,
                "prefix": self._prefix.stats()
                if self._prefix is not None else None,
                "preempts": self.preempts,
                "resumes": self.resumes,
                "preempted_depth": len(self._preempted),
                "host_blocks_free": self._cache.host.num_free
                if self._cache.host is not None else None,
                "spec_k": self.spec_k,
                "spec_mode": self.spec_mode if self.spec_k else None,
                **dict(self.counts),
            }
