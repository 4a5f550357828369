"""Serving engine: continuous batching over a dense OR paged KV cache.

Counterpart of ``repro.serving.engine``.  Given a mesh of local rings
(``mesh=``), every model step runs under it (``parallel.set_mesh``), so a
MoE layer takes its expert-parallel, token-split or TP-in-expert branch;
the paged pool's page count rounds up to a multiple of the data axes'
ranks, and its sharding specs are recorded (``pool_specs``).  Given
params placed by ``parallel.sharding.shard_tree`` (on local rings or on
processes), the paged pool is placed too, by ``pool_specs`` over
``model`` (the dense slot pool by the family's rule,
``parallel.sharding.store_specs``): each model rank holds its kv heads
(or, where they do not divide the axis, its head_dim slice; a recurrent
family's states as its placed body cuts them) as its own contiguous
tensor and runs the paged decode on them.

Over data axes of processes (d data ranks: ``pod`` x ``data``) ownership
is fixed, where the reference's GSPMD moves pages to whichever rank reads
them: slot ``s`` belongs to data rank ``s // (batch / d)`` and page ``p``
to rank ``p // (pages / d)`` (``serving.kv.BlockPoolKV``'s owners), and
each rank holds only its shard, ``pages / d`` pages of every layer (the
dense mode: its ``batch / d`` slots).  The host state (scheduler,
allocator, prefix tries, rng) is replicated: every rank runs it on the
same requests and takes the same decisions.  A rank runs only its own
slots' rows, its page-table entries turned into shard-local ids, and the
picked tokens (greedy) or logit rows (sampling) are all-gathered over the
data axes, so every rank's host state advances alike.  Tokens equal the
unsharded engine's; which pages hold them, and which prefix hits occur,
may differ.  The page axis and slot axis are otherwise whole.  The fleet
surface (``inflight``, ``cancel``, and the page export / import of a
cached prefix, the last not over data processes) lets
``serving.fleet.LocalFleet`` route, hedge and migrate between engines.
Three KV modes behind one interface (``ServeConfig.kv_mode``):

``dense``
    A fixed pool of ``batch`` slots, each reserving ``max_len`` KV up
    front; decode ticks run the whole pool.  Prefill is length-BUCKETED
    (power-of-two buckets + ``true_lengths``) and reuses one single-slot
    cache template; slot writes follow the bundle's declared per-entry
    batch axes (``cache_batch_axes``).

``paged`` / ``paged_int8``
    K/V live in fixed-size refcounted pages of a global pool
    (``serving.kv.BlockPoolKV``); a radix prefix cache
    (``serving.prefix.RadixPrefixCache``, on by default) maps shared
    prompt prefixes read-only, copy-on-write covers mid-page divergence,
    and the phase-aware scheduler (``serving.scheduler.PhaseScheduler``)
    admits and evicts per tick.  Each tick runs ``paged_step`` over the
    active rows grouped by padded length — wide prefill chunks in one
    call, decode rows (and single-token cache-hit suffixes) in a ``T == 1``
    call that takes the paged decode kernel.  The page-table view is
    sliced to a power-of-two page bucket covering the longest active slot.
    ``paged_int8`` keeps the pool quantized with per-(token, head) scales.

All cache and pool updates happen IN PLACE on the device tensors (slot
writes, page writes, COW page copies): a functional copy of a 1.2 GB pool
per layer and tick would dominate the step.

The loop is exposed three ways: :meth:`run` drains everything,
:meth:`step` / :meth:`pending` advance one tick, and :meth:`stream`
returns a per-request token generator that pulls ticks on demand.

Sampling: greedy by default (``temperature == 0``); ``temperature`` plus
optional ``top_k`` switch decode to seeded host-side softmax sampling.
"""
from __future__ import annotations

import contextlib
import dataclasses
import math
from typing import Any, Iterator

import numpy as np
import torch

from repro_torch.obs import get_telemetry
from repro_torch.optim.adamw import tree_leaves
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.mesh import LocalRing, set_mesh
from repro_torch.parallel.sharding import (Placed, _data_axes,
                                           gather_leaf, is_placed,
                                           paged_pool_specs, shard_tree,
                                           tree_mesh)

from .kv import BlockPoolKV, PagedKVConfig
from .prefix import RadixPrefixCache
from .scheduler import Phase, PhaseScheduler, Request, SchedulerConfig

KV_MODES = ("dense", "paged", "paged_int8")


class _TracedPrefix:
    """Engine-side proxy around the radix prefix cache: times ``match``
    as a ``prefix_match`` span without the host-side scheduler/prefix
    modules ever importing telemetry.  Every other attribute forwards to
    the wrapped cache."""

    def __init__(self, prefix: RadixPrefixCache, obs):
        self._prefix = prefix
        self._obs = obs

    def match(self, tokens, owner: int = 0):
        h = self._obs.begin("prefix_match", tokens=int(len(tokens)))
        m = self._prefix.match(tokens, owner)
        self._obs.finish(h, matched=int(m.matched), hit=bool(m.hit))
        return m

    def __getattr__(self, name):
        return getattr(self._prefix, name)


@dataclasses.dataclass
class ServeConfig:
    batch: int              # slot pool size
    max_len: int
    max_new_tokens: int = 32
    eos_id: int = -1        # -1: never stop early
    temperature: float = 0.0        # 0: greedy; > 0: sampled decode
    top_k: int = 0                  # 0: full vocab; else sample top-k only
    sample_seed: int = 0            # host RNG seed (deterministic traces)
    kv_mode: str = "dense"          # dense | paged | paged_int8
    page_size: int = 16             # paged: tokens per page
    num_pages: int | None = None    # paged: pool size (None = dense capacity)
    prefill_chunk: int = 32         # paged: tokens per prefill call
    prefill_token_budget: int = 64  # paged: prefill tokens per tick
    prefix_cache: bool = True       # paged: radix prefix sharing + COW
    min_prefill_bucket: int = 8     # dense: smallest padded prompt bucket
    # graceful degradation (all off by default):
    max_admission_retries: int = 0  # shed a request after N failed admits
    admission_backoff: int = 0      # base hold-off ticks between admits
    shed_pressure: float = 1.0      # pool-used fraction counted as critical
    shed_patience: int = 0          # critical ticks before load-shed (0=off)
    shed_min_priority: int = 1      # load-shed drops waiting prio < this


@dataclasses.dataclass
class _Slot:
    request_id: int | None = None
    generated: list[int] = dataclasses.field(default_factory=list)
    remaining: int = 0
    deadline_tick: int | None = None


def _pow2_at_least(n: int, lo: int = 1) -> int:
    b = lo
    while b < n:
        b *= 2
    return b


def pick_step(step, params, tokens, pool, pt, lens, counts):
    """paged_step plus the per-row next-token gather (each row's logits sit
    at ``counts[b] - 1``) and the greedy argmax, on the device: only the
    picked ids (or, when sampling, the rows) cross to the host."""
    logits, pool, _ = step(params, tokens, pool, pt, lens, counts)
    idx = torch.clamp(counts.long(), min=1) - 1
    rows = logits[torch.arange(logits.shape[0], device=logits.device), idx]
    return rows, rows.argmax(-1), pool


class ServingEngine:
    """bundle must provide: init_cache(batch, max_len, device=...),
    prefill(params, tokens, cache, true_lengths=...), decode_step(params,
    tokens, cache); the paged modes additionally need init_paged_pool /
    paged_step / supports_paged_kv (the transformer family; see
    configs/base.py).  Every tensor lives on ``device``, the device of the
    params.  ``mesh``: a ``parallel.Mesh`` that every model step runs
    under: local rings, or axes of processes when the params are placed;
    over data axes of processes each data rank owns its slots and their
    pages (module docstring), and ``slots`` must divide over them."""

    # consecutive ticks with work queued but nothing executed before the
    # engine declares the scheduler wedged
    STALL_LIMIT = 4096

    def __init__(self, bundle: Any, params: Any, cfg: ServeConfig,
                 device: torch.device, telemetry: Any = None,
                 mesh: Any = None):
        if cfg.kv_mode not in KV_MODES:
            raise ValueError(f"kv_mode {cfg.kv_mode!r} not in {KV_MODES}")
        self.placed = is_placed(params)
        if self.placed:
            mesh = mesh or tree_mesh(params)
        if mesh is not None:
            for axis, t in mesh.transports.items():
                if isinstance(t, LocalRing) or t.size == 1:
                    continue
                if axis not in ("model", *tp.DATA_AXES):
                    raise NotImplementedError(
                        f"{mesh}: an engine over a {axis} axis of processes")
                if not self.placed:
                    why = "" if axis == "model" else \
                        "; each data rank then owns its slots and holds " \
                        "their pages (per-rank page ownership)"
                    raise NotImplementedError(
                        f"{mesh}: an engine over a {axis} axis of processes "
                        f"takes params placed by parallel.sharding."
                        f"shard_tree (the sharded-state slice){why}")
        self.mesh = mesh
        # this process's data rank among ``owners`` data processes
        self.owner, self.owners = tp.data_index(mesh) if mesh is not None \
            else (0, 1)
        if cfg.batch % self.owners:
            raise ValueError(f"{cfg.batch} slots do not split over "
                             f"{self.owners} data processes")
        # the slots this process runs (all of them on one data process)
        self._per = cfg.batch // self.owners
        self._own = slice(self.owner * self._per,
                          (self.owner + 1) * self._per)
        self.bundle = bundle
        # bound here: a wrapper set on ``self.bundle`` later need not
        # forward it
        self._store_specs = bundle.store_specs if self.placed else None
        self.params = params
        self.cfg = cfg
        self.device = torch.device(device)
        self.obs = telemetry if telemetry is not None else get_telemetry()
        self.results: dict[int, list[int]] = {}
        self.outcomes: dict[int, str] = {}   # rid -> ok | timeout | shed
        self._next_id = 0
        self._pressure_ticks = 0             # consecutive critical ticks
        self._shed_mode_ticks = 0
        self._stall_ticks = 0
        self._rng = np.random.default_rng(cfg.sample_seed)
        if cfg.kv_mode == "dense":
            self._init_dense()
        else:
            self._init_paged()

    def _dev(self, a: np.ndarray) -> torch.Tensor:
        return torch.as_tensor(a, device=self.device)

    def _place_kv(self, store: dict) -> dict:
        """A dense cache or paged pool placed over ``model`` as the placed
        params need it (the bundle's ``store_specs``, its family's rule:
        ``parallel.sharding.store_specs``); as it is otherwise."""
        if not self.placed:
            return store
        return shard_tree(store, self._store_specs(store, self.mesh),
                          self.mesh)

    def _share(self, local: torch.Tensor) -> np.ndarray:
        """The picked ids or logit rows of the slots this process runs (all
        of them, or over data processes its own), with the other data
        processes' gathered in slot order, on the host: what every rank's
        host state advances by."""
        if self.owners > 1:
            local = tp.gather_data(local, self.mesh)
        return local.cpu().numpy()

    def _mesh_ctx(self):
        """The engine's mesh made active for a model step (the reference's
        ``_mesh_ctx``); no change of the active mesh without one."""
        return set_mesh(self.mesh) if self.mesh is not None else \
            contextlib.nullcontext()

    # ------------------------------------------------------------------
    # sampling
    # ------------------------------------------------------------------

    @property
    def _greedy(self) -> bool:
        return self.cfg.temperature <= 0.0

    def _pick(self, row) -> int:
        """Next token from one vocab-sized logit row (tensor or numpy):
        greedy at ``temperature == 0``, else temperature-scaled softmax
        sampling from the engine's seeded RNG, optionally restricted to
        the ``top_k`` highest logits."""
        cfg = self.cfg
        if self._greedy:
            return int(torch.as_tensor(row).argmax())
        if isinstance(row, torch.Tensor):
            row = row.float().cpu().numpy()
        z = np.asarray(row, np.float64) / cfg.temperature
        if 0 < cfg.top_k < z.size:
            kth = np.partition(z, -cfg.top_k)[-cfg.top_k]
            z = np.where(z >= kth, z, -np.inf)
        z = z - z.max()
        p = np.exp(z)
        return int(self._rng.choice(z.size, p=p / p.sum()))

    # ------------------------------------------------------------------
    # intake + the three loop surfaces (run / step / stream)
    # ------------------------------------------------------------------

    def submit(self, prompt_tokens: np.ndarray, priority: int = 0,
               deadline: int | None = None) -> int:
        """Queue a request.  ``priority`` (larger = more urgent) drives
        paged admission/preemption; the dense path keeps FIFO.
        ``deadline`` is a tick budget counted from NOW."""
        rid = self._next_id
        self._next_id += 1
        prompt = np.asarray(prompt_tokens, np.int32)
        total = len(prompt) + self.cfg.max_new_tokens
        if total > self.cfg.max_len:
            raise ValueError(f"request {rid}: prompt+max_new {total} "
                             f"exceeds max_len {self.cfg.max_len}")
        if self.cfg.kv_mode == "dense":
            dl = None if deadline is None else self._dense_tick + deadline
            self.queue.append((rid, prompt, priority, dl))
            return rid
        req = Request(rid=rid, prompt=prompt, priority=priority,
                      arrival=rid, max_new_tokens=self.cfg.max_new_tokens,
                      deadline_tick=None if deadline is None
                      else self.ticks + deadline)
        need = self.kv.pages_for(total) + 1     # +1 decode headroom
        if need > self.kv.cfg.pages_per_owner - 1:
            raise ValueError(f"request {rid}: needs {need} pages, pool has "
                             f"{self.kv.cfg.pages_per_owner - 1}")
        self._requests[rid] = req
        self.sched.submit(req)
        return rid

    def reset_serving_state(self) -> None:
        """Drop all serving state — pool, scheduler, prefix trie, results,
        tick/pressure counters — keeping params and config."""
        self.results = {}
        self.outcomes = {}
        self._pressure_ticks = 0
        self._shed_mode_ticks = 0
        self._stall_ticks = 0
        self._rng = np.random.default_rng(self.cfg.sample_seed)
        if self.cfg.kv_mode == "dense":
            self._init_dense()
        else:
            self._init_paged()

    def pending(self) -> bool:
        """Whether any submitted request is still queued or in flight."""
        if self.cfg.kv_mode == "dense":
            return bool(self.queue) or \
                any(s.request_id is not None for s in self.slots)
        return self.sched.has_work

    def step(self) -> None:
        """Advance the engine ONE tick: expire deadlines, admit/evict, then
        one device step over the whole slot pool."""
        if self.cfg.kv_mode == "dense":
            self._step_dense()
        else:
            self._step_paged()

    def run(self) -> dict[int, list[int]]:
        """Drain every queued/active request to completion."""
        while self.pending():
            self.step()
        return self.results

    def stream(self, rid: int) -> Iterator[int]:
        """Per-request token generator: yields ``rid``'s tokens as the
        continuous-batching loop produces them, driving :meth:`step` on
        demand when no new tokens are buffered."""
        sent = 0
        while True:
            done = rid in self.results
            toks = self.results[rid] if done else self._partial_output(rid)
            while sent < len(toks):
                yield toks[sent]
                sent += 1
            if done:
                return
            if not self.pending():      # rid unknown / already reaped
                return
            self.step()

    def _partial_output(self, rid: int) -> list[int]:
        if self.cfg.kv_mode == "dense":
            for s in self.slots:
                if s.request_id == rid:
                    return list(s.generated)
            return []
        req = self._requests.get(rid)
        return req.output if req is not None else []

    # ------------------------------------------------------------------
    # dense path
    # ------------------------------------------------------------------

    def _init_dense(self) -> None:
        cfg = self.cfg
        self.slots = [_Slot() for _ in range(cfg.batch)]
        self.queue: list[tuple[int, np.ndarray, int, int | None]] = []
        self._dense_tick = 0
        self._dense_cache = None
        self._cache_axes: dict | None = None
        self._prefill_template = None       # built lazily, reused forever
        self._bucketed = bool(getattr(self.bundle,
                                      "prefill_supports_true_lengths", False))

    def _free_slots(self) -> list[int]:
        return [i for i, s in enumerate(self.slots) if s.request_id is None]

    def _prompt_bucket(self, n: int) -> int:
        return min(self.cfg.max_len,
                   _pow2_at_least(n, self.cfg.min_prefill_bucket))

    def _admit(self, cache):
        """Prefill queued requests into free slots (per-slot batch=1,
        length-bucketed); over data processes only a slot's owner
        prefills it, and the first tokens are shared after the last
        admission."""
        firsts = []
        for slot_idx in self._free_slots():
            if not self.queue:
                break
            rid, prompt, _, deadline = self.queue.pop(0)
            s = self.slots[slot_idx]
            s.request_id = rid
            s.remaining = self.cfg.max_new_tokens - 1
            s.deadline_tick = deadline
            if not self._own.start <= slot_idx < self._own.stop:
                firsts.append((slot_idx, None))
                continue
            if self._prefill_template is None:
                self._prefill_template = self._place_kv(
                    self.bundle.init_cache(1, self.cfg.max_len,
                                           device=self.device))
            S = len(prompt)
            with self.obs.span("prefill", rid=rid, tokens=int(S)), \
                    self._mesh_ctx():
                if self._bucketed:
                    toks = np.zeros((1, self._prompt_bucket(S)), np.int32)
                    toks[0, :S] = prompt
                    logits, c1 = self.bundle.prefill(
                        self.params, self._dev(toks), self._prefill_template,
                        true_lengths=self._dev(np.asarray([S], np.int32)))
                else:
                    logits, c1 = self.bundle.prefill(
                        self.params, self._dev(prompt[None]),
                        self._prefill_template)
            self._write_slot(cache, c1, slot_idx - self._own.start)
            firsts.append((slot_idx, logits[0, -1]))
        if self.owners == 1:
            for slot_idx, row in firsts:
                self.slots[slot_idx].generated = [self._pick(row)]
        elif firsts:
            # every rank takes part: the admissions are the same on each
            local = torch.zeros((self._per,) if self._greedy else
                                (self._per, self.bundle.cfg.vocab),
                                dtype=torch.long if self._greedy else
                                torch.float32, device=self.device)
            for slot_idx, row in firsts:
                if row is not None:
                    local[slot_idx - self._own.start] = row.argmax() \
                        if self._greedy else row.float()
            shared = self._share(local)
            for slot_idx, _ in firsts:
                self.slots[slot_idx].generated = [
                    int(shared[slot_idx]) if self._greedy
                    else self._pick(shared[slot_idx])]
        return cache

    def _write_slot(self, cache, one, idx):
        """Copy a batch=1 cache into slot ``idx`` of the pooled cache, in
        place.  The batch axis of each entry comes from the bundle's
        declared layout (``cache_batch_axes``), with axis 0 for 1-D
        entries and axis 1 otherwise for bundles that declare nothing."""
        if self._cache_axes is None:
            declare = getattr(self.bundle, "cache_batch_axes", None)
            if declare is not None:
                self._cache_axes = dict(declare(cache))
            else:
                self._cache_axes = {k: 0 if v.dim() == 1 else 1
                                    for k, v in cache.items()}
        for k, v in cache.items():
            ax = self._cache_axes[k]
            pairs = zip(v.tensors(), one[k].tensors()) \
                if isinstance(v, Placed) else [(v, one[k])]
            for dst, src in pairs:
                dst.select(ax, idx).copy_(src.select(ax, 0))
        return cache

    def _expire_dense(self) -> None:
        """Timeout eviction, dense flavour: queued requests past deadline
        never start; decoding slots past deadline free up with whatever
        they generated."""
        now = self._dense_tick
        kept = []
        for rid, prompt, prio, dl in self.queue:
            if dl is not None and now >= dl:
                self.results[rid] = []
                self.outcomes[rid] = "timeout"
            else:
                kept.append((rid, prompt, prio, dl))
        self.queue = kept
        for i, s in enumerate(self.slots):
            if s.request_id is not None and s.deadline_tick is not None \
                    and now >= s.deadline_tick:
                self.results[s.request_id] = s.generated
                self.outcomes[s.request_id] = "timeout"
                self.slots[i] = _Slot()

    def _step_dense(self) -> None:
        cfg = self.cfg
        if self._dense_cache is None:
            self._dense_cache = self._place_kv(self.bundle.init_cache(
                self._per, cfg.max_len,
                device=self.device))
        self._dense_tick += 1
        obs = self.obs
        self._expire_dense()
        with obs.span("admission", tick=self._dense_tick):
            self._dense_cache = self._admit(self._dense_cache)
        if not any(s.request_id is not None for s in self.slots):
            return
        with obs.span("decode", tick=self._dense_tick), self._mesh_ctx():
            # one decode tick for the whole pool (over data processes,
            # this rank's slots)
            last = np.zeros((cfg.batch, 1), np.int32)
            for i, s in enumerate(self.slots):
                if s.request_id is not None:
                    last[i, 0] = s.generated[-1]
            logits, self._dense_cache = self.bundle.decode_step(
                self.params, self._dev(last[self._own]), self._dense_cache)
            # greedy: batch argmax on the device, ints cross to the host;
            # sampled: one host copy of the rows feeds the seeded picker
            nxt = self._share(logits[:, 0].argmax(-1) if self._greedy
                              else logits[:, 0].float())
        for i, s in enumerate(self.slots):
            if s.request_id is None:
                continue
            tok = int(nxt[i]) if self._greedy else self._pick(nxt[i])
            s.generated.append(tok)
            s.remaining -= 1
            if s.remaining <= 0 or tok == cfg.eos_id:
                self.results[s.request_id] = s.generated
                self.outcomes[s.request_id] = "ok"
                obs.counter("serve_requests", outcome="ok")
                obs.instant("complete", rid=s.request_id,
                            generated=len(s.generated))
                self.slots[i] = _Slot()

    # ------------------------------------------------------------------
    # paged path (block pool + prefix cache + continuous batching)
    # ------------------------------------------------------------------

    def _init_paged(self) -> None:
        cfg = self.cfg
        if not getattr(self.bundle, "supports_paged_kv", False):
            raise ValueError("bundle does not support the paged KV path "
                             "(needs init_paged_pool/paged_step)")
        mcfg = self.bundle.cfg
        quant = cfg.kv_mode == "paged_int8"
        kv_dtype = torch.int8 if quant else None
        kv_bytes = 1 if quant else torch.empty((), dtype=mcfg.dtype) \
            .element_size()
        pages_per_slot = -(-cfg.max_len // cfg.page_size)
        num_pages = cfg.num_pages or cfg.batch * pages_per_slot + 1
        self.pool_specs = None
        if self.mesh is not None:
            # the page axis shards over the data axes: every shard gets
            # whole pages (the axes the pool specs name)
            dsz = math.prod(self.mesh.shape[a]
                            for a in _data_axes(self.mesh))
            num_pages = -(-num_pages // dsz) * dsz
            self.pool_specs = paged_pool_specs(
                self.mesh, kv_heads=mcfg.n_kv_heads, head_dim=mcfg.dh)
        self.kv = BlockPoolKV(PagedKVConfig(
            num_slots=cfg.batch, max_len=cfg.max_len,
            page_size=cfg.page_size, num_pages=num_pages,
            n_layers=mcfg.n_layers, kv_heads=mcfg.n_kv_heads,
            head_dim=mcfg.dh, kv_bytes=kv_bytes, quantize=quant,
            owners=self.owners))
        # the radix prefix cache registers itself as the pool's reclaim
        # hook: page pressure drains cold cached prefixes before anyone
        # preempts a live request
        self.prefix = RadixPrefixCache(self.kv) if cfg.prefix_cache else None
        self.sched = PhaseScheduler(SchedulerConfig(
            num_slots=cfg.batch, prefill_chunk=cfg.prefill_chunk,
            prefill_token_budget=cfg.prefill_token_budget,
            max_admission_retries=cfg.max_admission_retries,
            admission_backoff=cfg.admission_backoff))
        # this rank's shard of the pages (all of them on one data
        # process), placed over model
        self.pool = self.bundle.init_paged_pool(
            self.kv.cfg.pages_per_owner, cfg.page_size, kv_dtype=kv_dtype,
            device=self.device)
        self.pool = self._place_kv(self.pool)
        self._requests: dict[int, Request] = {}
        self.cow_copies = 0
        self.ticks = 0
        # live KV traffic: token-exact attended context and page-granular
        # pool reads, accumulated in _exec_rows (plain int adds)
        self._traffic = {"gb_read_tokens": 0, "dram_read_tokens": 0,
                         "written_tokens": 0}

    def _pages_view(self, max_tokens: int) -> int:
        """Power-of-two page-table slice covering ``max_tokens``."""
        per_slot = self.kv.cfg.pages_per_slot
        return min(per_slot, _pow2_at_least(self.kv.pages_for(max_tokens)))

    def _exec_step(self, tokens: np.ndarray, counts: np.ndarray, mp: int):
        """Run one paged_step + row-gather + argmax over the slots this
        process runs: the whole pool, or over data processes its own slots
        on its shard (page ids made shard-local).  ``tokens`` and
        ``counts`` cover every slot.  Returns ``(rows, picked)`` of those
        slots on the device."""
        pt, lens = self.kv.page_table[:, :mp], self.kv.lengths
        if self.owners > 1:
            own = self._own
            tokens, counts, lens = tokens[own], counts[own], lens[own]
            pt = pt[own] - self.kv.trash(self.owner)
        pt = self._dev(np.ascontiguousarray(pt, np.int32))
        lens = self._dev(lens.astype(np.int32))
        with self._mesh_ctx():
            rows, picked, self.pool = pick_step(
                self.bundle.paged_step, self.params, self._dev(tokens),
                self.pool, pt, lens, self._dev(counts.astype(np.int32)))
        return rows, picked

    def _exec_cow(self, req: Request) -> None:
        """Execute a pending copy-on-write: duplicate the matched page's KV
        (all layers, K+V+scales) into the request's first private page,
        in place, then release the pin admission held on the source."""
        src, dst, _ = req.cow
        if self.kv.slot_owner(req.slot) == self.owner:  # its rank's shard
            base = self.kv.trash(self.owner)
            for v in tree_leaves(self.pool):
                v[:, dst - base].copy_(v[:, src - base])
        self.cow_copies += 1
        self.sched._drop_cow(self.kv, req)

    def _finish(self, req: Request) -> None:
        """Reap a completed request: adopt its cached pages into the prefix
        trie, then release the slot."""
        if self.prefix is not None:
            n_cached = int(self.kv.lengths[req.slot])
            seq = np.concatenate(
                [req.prompt, np.asarray(req.generated, np.int32)])[:n_cached]
            self.prefix.insert(seq, self.kv.slot_pages(req.slot), n_cached)
        self.results[req.rid] = req.output
        self.outcomes[req.rid] = "ok"
        self.obs.counter("serve_requests", outcome="ok")
        self.obs.instant("complete", rid=req.rid,
                         generated=req.n_generated)
        self.sched.finish(self.kv, req)

    def _degrade_tick(self) -> None:
        """Deadline eviction, shed collection, and load-shed mode when
        page-pool pressure stays critical for ``shed_patience`` ticks."""
        cfg = self.cfg
        for req in self.sched.expire_deadlines(self.kv, self.ticks):
            self.results[req.rid] = req.output
            self.outcomes[req.rid] = "timeout"
            self.obs.counter("serve_requests", outcome="timeout")
            self.obs.instant("timeout", rid=req.rid)
        if cfg.shed_patience > 0:
            st = self.kv.stats()
            frac = st["pages_used"] / max(1, st["pages_total"] - 1)
            if frac >= cfg.shed_pressure:
                self._pressure_ticks += 1
            else:
                self._pressure_ticks = 0
            if self._pressure_ticks >= cfg.shed_patience:
                self._shed_mode_ticks += 1
                self.sched.shed_waiting(
                    below_priority=cfg.shed_min_priority)

    def _step_paged(self) -> None:
        """One continuous-batching tick: admit (consulting the prefix
        cache), execute pending COW copies, grow decode pages, then run
        ``paged_step`` over the tick's active rows grouped by padded
        length."""
        if not self.sched.has_work:
            return
        self.ticks += 1
        obs = self.obs
        self._degrade_tick()
        with obs.span("admission", tick=self.ticks):
            prefix = self.prefix
            if obs.enabled and prefix is not None:
                prefix = _TracedPrefix(prefix, obs)
            admitted = self.sched.admit(self.kv, now=self.ticks,
                                        prefix=prefix)
            for req in admitted:
                if obs.enabled:
                    obs.instant("admit", rid=req.rid,
                                prompt=int(len(req.prompt)),
                                matched=int(req.matched_tokens))
                if req.cow is not None:
                    self._exec_cow(req)
        shed = self.sched.drain_shed()
        for req in shed:
            self.results[req.rid] = req.output
            self.outcomes[req.rid] = "shed"
            obs.counter("serve_requests", outcome="shed")
            obs.instant("shed", rid=req.rid)

        # decode rows claim their next page BEFORE the batch is built —
        # under page pressure this may evict actives, so jobs are
        # selected afterwards
        with obs.span("reclaim", tick=self.ticks):
            preempted = self.sched.ensure_decode_pages(self.kv)
        for req in preempted or ():
            obs.counter("serve_preemptions")
            obs.instant("preempt", rid=req.rid,
                        preemptions=req.preemptions)
        jobs = self.sched.prefill_jobs()
        decoding = self.sched.decoding()
        if not jobs and not decoding:
            # stall valve: work is queued but nothing ran this tick
            self._stall_ticks = 0 if (admitted or shed) else \
                self._stall_ticks + 1
            if self._stall_ticks > self.STALL_LIMIT:
                raise RuntimeError("paged scheduler made no progress")
            return
        self._stall_ticks = 0

        # group rows by padded length: decode only shares a call with
        # prefills that are themselves single-token, so it keeps the
        # T == 1 kernel path
        chunk_t = _pow2_at_least(max((j.count for j in jobs), default=1))
        if chunk_t == 1:
            groups = [(jobs, decoding)]
        else:
            groups = [(jobs, []), ([], decoding)]
        for g_jobs, g_decode in groups:
            if g_jobs or g_decode:
                with obs.span("prefill" if g_jobs else "decode",
                              tick=self.ticks, prefill_rows=len(g_jobs),
                              decode_rows=len(g_decode)):
                    self._exec_rows(g_jobs, g_decode)

    def _exec_rows(self, jobs, decoding) -> None:
        """Build one padded (B, T) batch from the given prefill jobs +
        decode rows, run it through ``paged_step``, and harvest: advance
        lengths, sample next tokens, finish completed requests."""
        cfg = self.cfg
        B = cfg.batch
        T = _pow2_at_least(max([j.count for j in jobs], default=1))
        tokens = np.zeros((B, T), np.int32)
        counts = np.zeros((B,), np.int32)
        for j in jobs:
            tokens[j.req.slot, :j.count] = \
                j.req.prompt[j.start:j.start + j.count]
            counts[j.req.slot] = j.count
        for r in decoding:
            tokens[r.slot, 0] = r.generated[-1]
            counts[r.slot] = 1
        mp = self._pages_view(max(
            int(self.kv.lengths[s]) + int(counts[s])
            for s in range(B) if counts[s] > 0))
        rows_dev, picked_dev = self._exec_step(tokens, counts, mp)
        picked = self._share(picked_dev if self._greedy
                             else rows_dev.float())

        by_slot = {j.req.slot: j for j in jobs}
        tr, page = self._traffic, self.kv.cfg.page_size
        for slot in range(B):
            if counts[slot] == 0:
                continue
            job = by_slot.get(slot)
            if job is not None:                      # prefill chunk
                req = job.req
                self.kv.advance(slot, job.count)
                ctx = int(self.kv.lengths[slot])     # attended context
                tr["gb_read_tokens"] += ctx
                tr["dram_read_tokens"] += self.kv.pages_for(ctx) * page
                tr["written_tokens"] += job.count
                self.sched.finish_prefill_chunk(req, job.count)
                if req.phase is not Phase.DECODE:
                    continue                         # more chunks to go
            else:                                    # decode row
                req = next(r for r in decoding if r.slot == slot)
                self.kv.advance(slot, 1)
                ctx = int(self.kv.lengths[slot])
                tr["gb_read_tokens"] += ctx
                tr["dram_read_tokens"] += self.kv.pages_for(ctx) * page
                tr["written_tokens"] += 1
            tok = int(picked[slot]) if self._greedy \
                else self._pick(picked[slot])
            req.generated.append(tok)
            if req.n_generated >= req.max_new_tokens or tok == cfg.eos_id:
                self._finish(req)

    # ------------------------------------------------------------------
    # fleet surface (serving.fleet): cancel, in-flight audit, migration
    # ------------------------------------------------------------------

    def inflight(self) -> list[int]:
        """rids submitted but not yet reaped into ``results`` — on host
        loss the router re-admits exactly these on the survivors."""
        if self.cfg.kv_mode == "dense":
            live = [item[0] for item in self.queue]
            live += [s.request_id for s in self.slots
                     if s.request_id is not None]
            return [rid for rid in live if rid not in self.results]
        return [rid for rid in self._requests if rid not in self.results]

    def cancel(self, rid: int) -> bool:
        """Withdraw one unfinished request, releasing its pages (shared
        prefix pages only decref).  The fleet retires the losing twin of
        a hedged dispatch this way.  Returns True when something was
        actually cancelled."""
        if rid in self.results:
            return False
        if self.cfg.kv_mode == "dense":
            for i, item in enumerate(self.queue):
                if item[0] == rid:
                    del self.queue[i]
                    self.results[rid] = []
                    self.outcomes[rid] = "cancelled"
                    return True
            for i, s in enumerate(self.slots):
                if s.request_id == rid:
                    self.results[rid] = list(s.generated)
                    self.outcomes[rid] = "cancelled"
                    self.slots[i] = _Slot()
                    return True
            return False
        req = self._requests.get(rid)
        if req is None or self.sched.cancel(self.kv, rid) is None:
            return False
        self.results[rid] = req.output
        self.outcomes[rid] = "cancelled"
        self.obs.counter("serve_requests", outcome="cancelled")
        return True

    def export_prefix_pages(self, tokens, n_tokens: int):
        """Migration SOURCE: the KV payloads of the full-page cached
        prefix of ``tokens[:n_tokens]``, as (segment tokens, {pool entry:
        CPU tensor}) pairs in path order.  Stops at the first uncached or
        partial page — callers migrate what exists and recompute the
        rest.  Each pool entry's pages are gathered on the device (the
        (L, P, page, Hkv, Dh) layout strides a page across L) and cross
        to the host in one copy, which waits for the device."""
        self._single_data_process("export_prefix_pages")
        if getattr(self, "prefix", None) is None:
            return []
        nodes = self.prefix.path_nodes(tokens, n_tokens)
        if not nodes:
            return []
        idx = torch.tensor([n.page for n in nodes], dtype=torch.long,
                           device=self.device)
        host = {k: (gather_leaf(v) if isinstance(v, Placed) else v)
                .index_select(1, idx).cpu() for k, v in self.pool.items()}
        return [(node.tokens, {k: h[:, i] for k, h in host.items()})
                for i, node in enumerate(nodes)]

    def import_prefix_pages(self, segments) -> int:
        """Migration TARGET: graft exported page payloads into this
        host's pool + trie so the next lookup serves them locally —
        the page is TRANSFERRED, never re-prefilled.  Each payload lands
        in place in its adopted pool page.  Segments already cached here
        are skipped; a dry pool ends the import early (partial import is
        fine, the remainder is recomputed).  Returns the prefix tokens
        now cached locally."""
        self._single_data_process("import_prefix_pages")
        if getattr(self, "prefix", None) is None:
            return 0
        node, matched = self.prefix.root, 0
        ps = self.kv.cfg.page_size
        for seg, vals in segments:
            seg = tuple(int(t) for t in seg)
            if len(seg) != ps:
                break                        # only full pages migrate
            child = node.children.get(seg)
            if child is not None and child.n_tokens == ps:
                node, matched = child, matched + ps
                continue
            try:
                page = self.kv.adopt_page()
            except MemoryError:
                break
            for k, v in self.pool.items():
                val = torch.as_tensor(vals[k])
                if not isinstance(v, Placed):
                    v[:, page].copy_(val)
                    continue
                for key, shard in v.shards.items():
                    shard[:, page:page + 1].copy_(v.piece(val[:, None], key))
            node = self.prefix.adopt_segment(node, seg, page)
            matched += ps
        return matched

    def _single_data_process(self, what: str) -> None:
        if self.owners > 1:
            raise NotImplementedError(
                f"{what} over {self.owners} data processes: each rank "
                f"holds only its own pages, and a fleet over such engines "
                f"is not in the reference either")

    def drop_prefix_path(self, tokens, n_tokens: int) -> int:
        """Migration SOURCE, after a successful transfer: drop the local
        trie path for the migrated prefix (ownership moved — pages are
        owned once).  Pages still feeding live slots survive."""
        if getattr(self, "prefix", None) is None:
            return 0
        return self.prefix.drop_path(tokens, n_tokens)

    # ------------------------------------------------------------------
    # accounting
    # ------------------------------------------------------------------

    def degradation_stats(self) -> dict:
        """Outcome counters + load-shed bookkeeping (all modes)."""
        counts = {"ok": 0, "timeout": 0, "shed": 0}
        for v in self.outcomes.values():
            counts[v] = counts.get(v, 0) + 1
        counts["shed_mode_ticks"] = self._shed_mode_ticks
        return counts

    def prefix_stats(self) -> dict:
        """Radix-cache counters; empty when the cache is off or the mode
        dense."""
        if getattr(self, "prefix", None) is None:
            return {}
        st = self.prefix.stats()
        st["cow_copies"] = self.cow_copies
        return st

    def check_kv(self) -> None:
        """Full pool + trie invariant audit (tests)."""
        if getattr(self, "prefix", None) is not None:
            self.prefix.check_invariants()
        else:
            self.kv.check_invariants()

    def traffic_stats(self) -> dict:
        """Observed KV traffic (tokens + bytes): ``gb_*`` is token-exact
        attended context, ``dram_*`` page-granular pool reads.  Paged
        modes only; dense reports zeros."""
        tr = dict(self._traffic) if self.cfg.kv_mode != "dense" else \
            {"gb_read_tokens": 0, "dram_read_tokens": 0, "written_tokens": 0}
        bpt = self.kv.cfg.page_bytes / self.kv.cfg.page_size \
            if self.cfg.kv_mode != "dense" else 0.0
        tr["gb_read_bytes"] = tr["gb_read_tokens"] * bpt
        tr["dram_read_bytes"] = tr["dram_read_tokens"] * bpt
        tr["written_bytes"] = tr["written_tokens"] * bpt
        return tr

    def telemetry(self) -> dict:
        """One structured snapshot — request outcomes, KV-pool use,
        prefix-cache hit rate, observed traffic — mirrored into the
        metrics registry as ``serve.*`` gauges and returned as a dict."""
        snap = {
            "mode": self.cfg.kv_mode,
            "ticks": getattr(self, "ticks", None) if
            self.cfg.kv_mode != "dense" else self._dense_tick,
            "outcomes": self.degradation_stats(),
            "kv": self.kv_stats(),
            "prefix": self.prefix_stats(),
            "traffic": self.traffic_stats(),
        }
        m = self.obs.metrics
        m.absorb(snap["outcomes"], prefix="serve.outcomes.")
        m.absorb(snap["kv"], prefix="serve.kv.")
        m.absorb(snap["prefix"], prefix="serve.prefix.")
        m.absorb(snap["traffic"], prefix="serve.traffic.")
        return snap

    def kv_stats(self) -> dict:
        """Resident-KV accounting: paged modes report pool counters; dense
        reports the up-front reservation."""
        if self.cfg.kv_mode != "dense":
            return self.kv.stats()
        if self._dense_cache is None:         # the first tick builds it
            self._dense_cache = self._place_kv(self.bundle.init_cache(
                self._per, self.cfg.max_len,
                device=self.device))
        total = sum(t.numel() * t.element_size()
                    for t in tree_leaves(self._dense_cache))
        return {"bytes_resident": total, "peak_bytes": total,
                "pages_total": 0, "pages_used": 0, "utilization": 1.0,
                "fragmentation": 0.0, "evictions": 0}
