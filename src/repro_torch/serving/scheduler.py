"""Phase-aware request scheduler: prefill/decode disaggregation + priority
admission + preemption by page pressure.

Replaces the seed engine's FIFO slot round-robin with three explicit
phases per request:

  WAITING  -> admission by (priority desc, arrival asc); a request is only
              admitted when a slot is free AND the block pool can map its
              whole prompt (plus one decode page of headroom).  Admission
              CONSULTS THE PREFIX CACHE (``serving.prefix``) when one is
              wired in: the longest cached prefix of the prompt is mapped
              as read-only shared pages (plus an optional copy-on-write
              page when the match ends mid-page), the slot's length starts
              at the matched token count, and prefill covers only the
              SUFFIX — a cache-hit request skips straight past its
              matched prefix into chunked prefill of the rest.
  PREFILL  -> the prompt is consumed in fixed-size CHUNKS, budgeted per
              tick (``prefill_token_budget``), so one long prompt cannot
              starve the decode pool — the serving analogue of
              prefill/decode disaggregation.  Chunks of different requests
              interleave across ticks.
  DECODE   -> the whole slot pool advances one token per tick (one jitted
              SPMD step regardless of occupancy, as before).

Preemption: when the pool runs dry — either a high-priority arrival can't
be admitted or a decoding slot needs its next page — cold prefix-cache
pages are reclaimed FIRST (``BlockPoolKV.reserve`` runs the trie's
leaf-first LRU eviction hook); only then is the LOWEST-priority active
request evicted: its page REFERENCES are dropped (shared prefix pages
only decref — pages still held by the trie or a peer request survive; see
``BlockPoolKV.free_slot``) and the request re-enters WAITING with its
generated tokens folded into the prompt (vLLM-style recompute on
re-admission).  Eviction never targets ANOTHER
request with priority >= the one that needs the pages; when no strictly
lower-priority victim exists, a decoding slot that cannot grow evicts
ITSELF (equal-priority peers keep their progress).

Graceful degradation (all off by default — the seed behaviour is the
zero-config path):

  * deadlines — a request may carry ``deadline_tick``;
    :meth:`PhaseScheduler.expire_deadlines` evicts it (waiting OR active)
    once the engine's tick clock passes it, returning pages to the pool so
    one stuck request cannot hold capacity forever;
  * bounded admission retry with backoff — when ``admission_backoff`` is
    set, a request that fails admission stops blocking the queue head
    (lower-priority work behind it may fit) and retries after an
    exponentially growing hold-off; after ``max_admission_retries``
    failures it is SHED (``drain_shed``) instead of waiting forever;
  * load shedding — :meth:`shed_waiting` drops queued sub-priority work
    wholesale; the engine invokes it when pool pressure stays critical.

Owners: over a pool split among the data ranks of processes
(``BlockPoolKV.owners`` > 1) a request goes to a slot of one owner and
maps only that owner's pages (:meth:`PhaseScheduler._place` gives
the rule); every rank runs this scheduler on the same requests and takes
the same decisions.

The scheduler is host-side control logic over :class:`~repro_torch.serving.kv.
BlockPoolKV` — no tensor imports — so policies are unit-testable in
microseconds.  The engine executes the plans it returns.
"""
from __future__ import annotations

import dataclasses
import enum
import heapq
import itertools

import numpy as np

from .kv import BlockPoolKV


class Phase(enum.Enum):
    WAITING = "waiting"
    PREFILL = "prefill"
    DECODE = "decode"
    FINISHED = "finished"


@dataclasses.dataclass
class Request:
    rid: int
    prompt: np.ndarray                 # int32 tokens, may grow on eviction
    priority: int = 0                  # larger = more urgent
    arrival: int = 0                   # submit order (FIFO tie-break)
    phase: Phase = Phase.WAITING
    slot: int = -1
    prefill_pos: int = 0               # tokens of prompt already cached
    generated: list[int] = dataclasses.field(default_factory=list)
    history: list[int] = dataclasses.field(default_factory=list)
    # ^ tokens generated before a preemption (folded into the prompt for
    #   recompute; still part of the request's output)
    max_new_tokens: int = 0
    preemptions: int = 0
    deadline_tick: int | None = None   # evict once engine tick passes this
    admit_attempts: int = 0            # failed admission tries so far
    next_admit_tick: int = 0           # backoff: don't retry before this
    cow: tuple[int, int, int] | None = None
    # ^ pending copy-on-write from a mid-page prefix-cache match:
    #   (src page, dst page, valid tokens) — the ENGINE executes the
    #   device copy before the request's first prefill chunk
    matched_tokens: int = 0            # prefix-cache tokens served for free

    @property
    def n_generated(self) -> int:
        return len(self.history) + len(self.generated)

    @property
    def output(self) -> list[int]:
        return self.history + self.generated

    @property
    def total_len(self) -> int:
        return len(self.prompt) + self.max_new_tokens - len(self.history)


@dataclasses.dataclass(frozen=True)
class SchedulerConfig:
    num_slots: int
    prefill_chunk: int = 32            # tokens per prefill call
    prefill_token_budget: int = 64     # prefill tokens per tick, all reqs
    decode_headroom_pages: int = 1     # reserved beyond the prompt at admit
    max_admission_retries: int = 0     # 0 = retry forever (seed behaviour)
    admission_backoff: int = 0         # base hold-off ticks; 0 = no backoff


@dataclasses.dataclass
class PrefillJob:
    req: Request
    start: int                         # chunk start within req.prompt
    count: int                         # valid tokens in this chunk


class PhaseScheduler:
    """Owns the request lifecycle; the engine owns the device arrays."""

    def __init__(self, cfg: SchedulerConfig):
        self.cfg = cfg
        self._waiting: list[tuple[int, int, Request]] = []   # priority heap
        self._active: dict[int, Request] = {}                # slot -> req
        self._tie = itertools.count()
        self._shed: list[Request] = []     # retry budget blown / load shed

    # -- intake -------------------------------------------------------------

    def submit(self, req: Request) -> None:
        req.phase = Phase.WAITING
        heapq.heappush(self._waiting, (-req.priority, next(self._tie), req))

    @property
    def has_work(self) -> bool:
        return bool(self._waiting or self._active)

    def active(self) -> list[Request]:
        return list(self._active.values())

    def decoding(self) -> list[Request]:
        return [r for r in self._active.values() if r.phase is Phase.DECODE]

    # -- admission + preemption ---------------------------------------------

    def _evictable_below(self, priority: int,
                         slots=None) -> Request | None:
        """Lowest-priority active request strictly below ``priority``
        (latest arrival breaks ties — it has the least sunk work), among
        the requests in ``slots`` when given."""
        cands = [r for r in self._active.values() if r.priority < priority
                 and (slots is None or r.slot in slots)]
        if not cands:
            return None
        return min(cands, key=lambda r: (r.priority, -r.arrival))

    def _evict(self, kv: BlockPoolKV, req: Request) -> None:
        self._drop_cow(kv, req)
        kv.free_slot(req.slot, evicted=True)
        del self._active[req.slot]
        # recompute-on-readmission: generated tokens become prompt suffix
        if req.generated:
            req.prompt = np.concatenate(
                [req.prompt,
                 np.asarray(req.generated, req.prompt.dtype)])
            req.history.extend(req.generated)
            req.generated = []
        req.slot = -1
        req.prefill_pos = 0
        req.matched_tokens = 0
        req.preemptions += 1
        self.submit(req)

    def admit(self, kv: BlockPoolKV, *, now: int = 0,
              prefix=None) -> list[Request]:
        """Admit waiting requests in priority order; may evict lower-
        priority active requests when the pool is the binding constraint.
        Returns the newly admitted requests (now in PREFILL phase).

        ``prefix`` (a :class:`~repro_torch.serving.prefix.RadixPrefixCache`)
        lets admission skip cached work: matched full pages are mapped
        shared, only the suffix needs private pages, and the request's
        ``prefill_pos``/slot length start at the matched token count.  A
        mid-page match is planned as a COW job on ``req.cow`` for the
        engine.  Page pressure drains cold cache pages (``kv.reserve``'s
        reclaim hook) before any live request is preempted.

        With ``admission_backoff``/``max_admission_retries`` configured, a
        request that fails admission no longer blocks the queue head: it is
        held off for ``admission_backoff * 2**(attempts-1)`` ticks (so the
        next-priority request gets a try) and shed outright once its retry
        budget is exhausted.  With both at 0 the seed head-of-line
        behaviour is preserved exactly."""
        retrying = (self.cfg.admission_backoff > 0
                    or self.cfg.max_admission_retries > 0)
        admitted: list[Request] = []
        deferred: list[tuple[int, int, Request]] = []
        while self._waiting:
            item = heapq.heappop(self._waiting)
            _, _, req = item
            if req.phase is not Phase.WAITING:   # expired while queued
                continue
            if req.next_admit_tick > now:        # backing off
                deferred.append(item)
                continue
            placed = self._place(kv, req, prefix)
            if placed is None:
                if not retrying:
                    deferred.append(item)
                    break                        # seed: head blocks
                req.admit_attempts += 1
                if 0 < self.cfg.max_admission_retries < req.admit_attempts:
                    req.phase = Phase.FINISHED   # retry budget blown: shed
                    self._shed.append(req)
                else:
                    req.next_admit_tick = now + max(
                        1, self.cfg.admission_backoff) * \
                        2 ** (req.admit_attempts - 1)
                    deferred.append(item)
                continue
            slot, match, pinned = placed
            shared = list(match.full_pages) if match is not None else []
            if shared:
                kv.map_shared(slot, shared)
            kv.ensure(slot, len(req.prompt) +
                      self.cfg.decode_headroom_pages * kv.cfg.page_size)
            matched = match.matched if match is not None else 0
            kv.set_length(slot, matched)
            req.matched_tokens = matched
            if match is not None and match.cow is not None:
                # the COW source keeps ITS pin until the engine copies it
                # (consume_cow / _drop_cow release); the destination is
                # the request's first private page
                src, n_valid = match.cow
                dst = int(kv.page_table[slot, len(shared)])
                req.cow = (src, dst, n_valid)
                pinned.remove(src)
            for p in pinned:
                kv.release(p)        # slot mapping holds its own reference
            req.slot = slot
            req.phase = Phase.PREFILL
            req.prefill_pos = matched
            req.admit_attempts = 0
            self._active[slot] = req
            admitted.append(req)
        for item in deferred:
            heapq.heappush(self._waiting, item)
        return admitted

    @staticmethod
    def _pin(kv: BlockPoolKV, match) -> list[int]:
        """PIN the matched pages (and a COW source) for the duration of an
        admission attempt: the reclaim hook must not evict the very pages
        the match promised.  Returns the pinned pages."""
        pinned = list(match.full_pages) if match is not None else []
        if match is not None and match.cow is not None:
            pinned.append(match.cow[0])
        for p in pinned:
            kv.retain(p)
        return pinned

    def _need(self, kv: BlockPoolKV, req: Request, match) -> int:
        shared = len(match.full_pages) if match is not None else 0
        return kv.pages_for(len(req.prompt)) - shared + \
            self.cfg.decode_headroom_pages

    def _place(self, kv: BlockPoolKV, req: Request, prefix):
        """(slot, prefix match or None, pinned pages) for ``req``, or None
        when it cannot be admitted now (nothing left pinned), by a rule
        every rank computes alike: the owners with a free slot are ranked
        by the longest cached prefix among their pages, then the most free
        slots, the most free pages and the lowest index, and the first
        whose pages can take the request (its cold cache pages reclaimed
        first: ``reserve``'s hook) gets it, in its lowest free slot.  When
        none can, the lowest-priority active request below ``req``'s is
        evicted, wherever it is, and the owners are ranked again.  With
        one owner that is the lowest free slot, reclaiming, then evicting
        strictly-lower-priority work.  The trie counts a lookup (and
        refreshes the match's recency) only for the attempt that admits
        (``peek`` before)."""
        while True:
            ranked = []
            for o in range(kv.owners):
                free = [s for s in kv.owner_slots(o) if s not in self._active]
                if free:
                    m = prefix.peek(req.prompt, o) \
                        if prefix is not None else None
                    ranked.append(((-(m.matched if m else 0), -len(free),
                                    -kv.free_pages_of(o), o), free[0]))
            for key, slot in sorted(ranked):
                o = key[-1]
                match = prefix.peek(req.prompt, o) \
                    if prefix is not None else None
                pinned = self._pin(kv, match)
                if kv.reserve(self._need(kv, req, match), o):
                    # the pinned match is the one counted
                    if prefix is not None:
                        match = prefix.match(req.prompt, o)
                    return slot, match, pinned
                for p in pinned:
                    kv.release(p)
            victim = self._evictable_below(req.priority)
            if victim is None:
                return None
            self._evict(kv, victim)

    @staticmethod
    def _drop_cow(kv: BlockPoolKV, req: Request) -> None:
        """Release a pending COW job's pin on its source page (the job is
        consumed by the engine's copy, or abandoned on evict/expiry)."""
        if req.cow is not None:
            kv.release(req.cow[0])
            req.cow = None

    # -- degradation: deadlines, shedding -----------------------------------

    def expire_deadlines(self, kv: BlockPoolKV, now: int) -> list[Request]:
        """Evict every request whose deadline has passed — active slots
        release their pages immediately (a stuck request must not hold
        capacity), waiting entries are dropped from the queue.  Returns the
        expired requests; the engine records their partial output."""
        expired: list[Request] = []
        for req in list(self._active.values()):
            if req.deadline_tick is not None and now >= req.deadline_tick:
                self._drop_cow(kv, req)
                kv.free_slot(req.slot, evicted=True)
                del self._active[req.slot]
                req.slot = -1
                req.phase = Phase.FINISHED
                expired.append(req)
        for _, _, req in self._waiting:
            if req.phase is Phase.WAITING and req.deadline_tick is not None \
                    and now >= req.deadline_tick:
                req.phase = Phase.FINISHED
                expired.append(req)
        if expired:
            self._waiting = [it for it in self._waiting
                             if it[2].phase is Phase.WAITING]
            heapq.heapify(self._waiting)
        return expired

    def cancel(self, kv: BlockPoolKV, rid: int) -> Request | None:
        """Withdraw one request wherever it lives: an active slot releases
        its pages (shared prefix pages only decref — the trie and peer
        slots keep theirs), a waiting entry leaves the queue.  The fleet's
        hedged dispatch uses this to retire the losing twin once the first
        copy finishes.  Returns the cancelled request, or None when the
        rid is unknown or already finished."""
        for req in list(self._active.values()):
            if req.rid == rid:
                self._drop_cow(kv, req)
                kv.free_slot(req.slot, evicted=True)
                del self._active[req.slot]
                req.slot = -1
                req.phase = Phase.FINISHED
                return req
        for _, _, req in self._waiting:
            if req.rid == rid and req.phase is Phase.WAITING:
                req.phase = Phase.FINISHED
                self._waiting = [it for it in self._waiting
                                 if it[2].phase is Phase.WAITING]
                heapq.heapify(self._waiting)
                return req
        return None

    def shed_waiting(self, *, below_priority: int) -> list[Request]:
        """Load-shed mode: drop every WAITING request with priority below
        the floor (admitted work keeps running — shedding protects the
        requests already holding pages)."""
        dropped = [req for _, _, req in self._waiting
                   if req.phase is Phase.WAITING
                   and req.priority < below_priority]
        for req in dropped:
            req.phase = Phase.FINISHED
        if dropped:
            self._waiting = [it for it in self._waiting
                             if it[2].phase is Phase.WAITING]
            heapq.heapify(self._waiting)
        self._shed.extend(dropped)
        return dropped

    def drain_shed(self) -> list[Request]:
        """Requests shed since the last drain (retry budget or load shed)."""
        out, self._shed = self._shed, []
        return out

    # -- prefill phase ------------------------------------------------------

    def prefill_jobs(self) -> list[PrefillJob]:
        """This tick's chunked prefill work, oldest-admission first, capped
        by the token budget.  One chunk per request per tick keeps a long
        prompt from monopolizing the budget."""
        jobs, budget = [], self.cfg.prefill_token_budget
        for req in sorted((r for r in self._active.values()
                           if r.phase is Phase.PREFILL),
                          key=lambda r: r.arrival):
            if budget <= 0:
                break
            count = min(self.cfg.prefill_chunk,
                        len(req.prompt) - req.prefill_pos, budget)
            if count <= 0:
                continue
            jobs.append(PrefillJob(req=req, start=req.prefill_pos,
                                   count=count))
            budget -= count
        return jobs

    def finish_prefill_chunk(self, req: Request, count: int) -> None:
        req.prefill_pos += count
        if req.prefill_pos >= len(req.prompt):
            req.phase = Phase.DECODE

    # -- decode phase -------------------------------------------------------

    def ensure_decode_pages(self, kv: BlockPoolKV) -> list[Request]:
        """Map the next page for every decoding slot about to cross a page
        boundary; evicts lowest-priority work under page pressure (the
        needy slot itself evicts when IT is the lowest).  Returns evicted
        requests."""
        evicted = []
        for req in sorted(self.decoding(),
                          key=lambda r: (-r.priority, r.arrival)):
            if req.slot not in self._active:      # already evicted this tick
                continue
            target = int(kv.lengths[req.slot]) + 1
            while True:
                try:
                    kv.ensure(req.slot, target)
                    break
                except MemoryError:
                    # strictly-lower-priority work goes first; when none
                    # exists the needy slot evicts ITSELF (equal-priority
                    # peers are never targeted, per the admission contract)
                    victim = self._evictable_below(
                        req.priority,
                        kv.owner_slots(kv.slot_owner(req.slot))) or req
                    self._evict(kv, victim)
                    evicted.append(victim)
                    if victim is req:
                        break
        return evicted

    def finish(self, kv: BlockPoolKV, req: Request) -> None:
        kv.free_slot(req.slot)
        del self._active[req.slot]
        req.phase = Phase.FINISHED
        req.slot = -1
