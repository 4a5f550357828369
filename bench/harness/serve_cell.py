"""A serving cell: the port's paged ``ServingEngine`` under a closed loop
of clients with zero think time, built by ``launch.serve.build_engine``
on the benchmark's weights.

Set-up builds the engine and ramps the clients in one by one, a
request's lifetime spread over them, until completions flow; the window
then measures.  Each client sends its next request at the tick its last
one completed.  A request's tokens are stamped at the end of the tick
that produced them (the tick ends after its picked ids reach the host).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from . import work
from .checks import logit_gaps
from .spec import Cell, model_sizes, port_bundle
from .stats import percentile, rate
from .traffic import Requests, rng
from .util import log
from .weights import make_weights


def progress_adapter(engine, rid: int) -> int:
    """Tokens request ``rid`` has produced so far.  The engine has no
    public per-request progress reading (``results`` holds finished
    requests only), so this one function reads its request table."""
    done = engine.results.get(rid)
    if done is not None:
        return len(done)
    req = engine._requests.get(rid)
    return 0 if req is None else req.n_generated


@dataclasses.dataclass
class Req:
    rid: int
    prompt: np.ndarray
    sent: float
    times: list = dataclasses.field(default_factory=list)
    done: bool = False


def _engine(cell: Cell, bundle, params, load: Requests, device, tel):
    from repro_torch.launch.serve import build_engine
    e = cell.workload["engine"]
    page = int(e["page_size"])
    # admission reserves the prompt and a page of decode headroom
    max_len = load.max_prompt + max(load.output_len, 2 * page)
    pages = -(-int(e["pool_tokens"]) // page) + 1       # + the trash page
    engine, _ = build_engine(
        bundle, smoke=False, slots=int(e["slots"]), max_len=max_len,
        max_new=load.output_len, kv_mode=e["kv_mode"], page_size=page,
        num_pages=pages, prefill_chunk=int(e["prefill_chunk"]),
        prefix_cache=bool(e["prefix_cache"]), params=params, device=device,
        telemetry=tel,
        prefill_token_budget=int(e["prefill_token_budget"]))
    return engine


class Clients:
    """The closed loop's bookkeeping: the requests in flight and every
    request's send and token times.  A client sends its next request at
    the tick its last one completed."""

    def __init__(self, engine, load: Requests, clock):
        self.engine, self.load, self.clock = engine, load, clock
        self.live: dict = {}                 # client -> request
        self.reqs: list[Req] = []
        self.failed = 0

    def send(self, client) -> None:
        _, prompt = self.load.next()
        rid = self.engine.submit(prompt)
        r = Req(rid, prompt, self.clock())
        self.live[client] = r
        self.reqs.append(r)

    def tick(self, hook=None) -> int:
        """One engine tick, then every live request's new tokens stamped
        and each finished client's next request sent.  ``hook(req,
        before, after)`` sees each request that moved.  -> tokens
        produced."""
        self.engine.step()
        now = self.clock()
        made = 0
        for client, r in list(self.live.items()):
            before = len(r.times)
            after = progress_adapter(self.engine, r.rid)
            if after > before:
                r.times.extend([now] * (after - before))
                made += after - before
                if hook is not None:
                    hook(r, before, after)
            if r.rid in self.engine.results:
                r.done = True
                if self.engine.outcomes.get(r.rid) != "ok":
                    self.failed += 1
                del self.live[client]
                self.send(client)
        return made


def _ramp(cl: Clients, load: Requests) -> int:
    """Set-up's ramp to steady occupancy: the clients start ``stagger``
    ticks apart, until each has a request in flight and completions have
    begun."""
    ticks, stagger, started = 0, load.stagger(), 0
    while started < load.clients or not any(r.done for r in cl.reqs):
        if started < load.clients and ticks % stagger == 0:
            cl.send(started)
            started += 1
        cl.tick()
        ticks += 1
    return ticks


def run(cell: Cell, seed: int, seconds: float, trace: bool, device,
        *, break_tokens=None) -> dict:
    """One run.  ``break_tokens(engine)`` plants a fault in the timed path
    (the tests' negative controls)."""
    from repro_torch.obs import Telemetry

    cfg = cell.config
    s = model_sizes(cfg)
    bundle = port_bundle(cfg)
    params = make_weights(cfg, seed, device)
    log("weights made")
    load = Requests(cell.traffic, s["vocab"], seed)
    tel = Telemetry(enabled=False)
    engine = _engine(cell, bundle, params, load, device, tel)
    log("engine built")
    if break_tokens is not None:
        break_tokens(engine)
    clock = time.perf_counter
    cl = Clients(engine, load, clock)
    ticks = _ramp(cl, load)
    log(f"ramp: {ticks} ticks, {len(cl.reqs)} requests sent")

    # the window (telemetry spans on in a traced run: its end-to-end
    # numbers are not reported)
    tel.enabled = bool(trace)
    t0 = clock()
    while clock() - t0 < seconds:
        cl.tick()
    t1 = clock()
    tel.enabled = False
    window_s = t1 - t0

    sent = [r for r in cl.reqs if t0 <= r.sent < t1]
    ttft = [(r.times[0] if r.times and r.times[0] <= t1 else t1) - r.sent
            for r in sent]
    itl, out_tokens, flops = [], 0, 0.0
    for r in cl.reqs:
        P = len(r.prompt)
        for j, t in enumerate(r.times):
            if not t0 <= t <= t1:
                continue
            out_tokens += 1
            if j == 0:      # the prompt's prefill, landed in the window
                flops += work.forward_flops(
                    s, P, work.attended_pairs(P, P))
            else:           # a decode token at position P + j - 1
                flops += work.forward_flops(s, 1, P + j)
            if j and t0 <= r.times[j - 1]:
                itl.append(t - r.times[j - 1])
    rec = {
        "window_start": t0,
        "window_s": window_s,
        "attempted": len(sent),
        "failed": cl.failed,
        "end_to_end": {
            "serve_tok_s": rate(out_tokens, window_s),
            "ttft_p95_ms": percentile(ttft, 95) * 1e3 if ttft else None,
            "itl_p95_ms": percentile(itl, 95) * 1e3 if itl else None},
        "window": {"output_tokens": out_tokens, "model_flops": flops,
                   "requests_sent": len(sent), "ttft_n": len(ttft),
                   "itl_n": len(itl), "ramp_ticks": ticks,
                   "kv": _kv_reading(engine),
                   "spans": {n: sum(sp["dur"] for sp in tel.tracer.spans(n))
                             for n in ("prefill", "decode")} if trace
                   else {},
                   "calls": {n: len(tel.tracer.spans(n))
                             for n in ("prefill", "decode")} if trace
                   else {}},
    }
    if device.type == "cuda":
        rec["memory_peak_bytes"] = torch.cuda.max_memory_allocated(device)
    if trace:
        rec["slice"] = _traced_slice(cell, cl, s)

    finished = [r for r in cl.reqs if r.done and t0 <= r.times[-1] <= t1]
    results = {r.rid: list(engine.results[r.rid]) for r in finished}
    del engine, cl.engine, params
    if device.type == "cuda":
        torch.cuda.empty_cache()
    rec["check_inputs"] = {
        "requests": [(r.prompt, np.asarray(results[r.rid], np.int64))
                     for r in finished],
        "output_len": load.output_len}
    return rec


def _kv_reading(engine) -> dict:
    """The pool at the window's close: tokens the live requests hold,
    pages in use (the prefix cache's included) and at their peak, and the
    pool's size."""
    st = engine.kv_stats()
    return {k: st[k] for k in ("tokens_resident", "pages_used",
                               "peak_pages", "pages_total")}


def _traced_slice(cell: Cell, cl: Clients, s: dict):
    """A profiled slice of ``trace_ticks`` more ticks of the same loop,
    with each tick's decode rows and their attended tokens."""
    from .trace import profile_slice
    n = int(cell.workload.get("trace_ticks", 24))
    counts = {"ticks": n, "output_tokens": 0, "decode_live": [],
              "decode_rows": []}

    def body(annotate):
        for _ in range(n):
            live, rows = 0, 0

            def hook(r, before, after):
                nonlocal live, rows
                if before >= 1:     # a decode row: it attends P + before
                    live += len(r.prompt) + before
                    rows += 1
            with annotate("tick"):
                counts["output_tokens"] += cl.tick(hook)
            if rows:
                counts["decode_live"].append(live)
                counts["decode_rows"].append(rows)
    sl = profile_slice(body)
    sl.counts = counts
    return sl


def sample_requests(requests: list, seed: int, n: int) -> list:
    """The checked sample: the request with the longest prompt, and
    ``n - 1`` more drawn from the seed."""
    if not requests:
        return []
    order = sorted(range(len(requests)),
                   key=lambda i: -len(requests[i][0]))
    rest = order[1:]
    g = rng(seed, 0xC4E)
    pick = [order[0]] + list(g.choice(rest, size=min(n - 1, len(rest)),
                                      replace=False))
    return [requests[i] for i in pick]


def reference_gaps(cell: Cell, seed: int, device, sample: list,
                   precs=("f32",)) -> dict:
    """For each precision, every position's gap over ``sample`` by which a
    picked token's f32 reference logit lies below the reference's best:
    the served tokens for ``f32``, and for a lower precision the token it
    puts first at each position of the same prompts and served tokens."""
    from ..reference import transformer as ref
    s = model_sizes(cell.config)
    ref.exact_f32()
    params = make_weights(cell.config, seed, device)
    out: dict = {p: [] for p in precs}
    for prompt, served in sample:
        seq = torch.from_numpy(np.concatenate([prompt, served[:-1]])
                               .astype(np.int64)).to(device)
        P = len(prompt)
        z = ref.logits(params, seq, s)[P - 1:]
        for p in precs:
            if p == "f32":
                picked = torch.from_numpy(served).to(device)
            else:
                picked = ref.logits(params, seq, s, p)[P - 1:].argmax(-1)
            out[p] += logit_gaps(z, picked)
        del z
    del params
    return out


def gap_numbers(gaps: list) -> dict:
    """The mean gap over the sample's served tokens (the number compared),
    and the widest (reported)."""
    if not gaps:
        return {"mean_logit_gap": float("nan"), "widest": float("nan")}
    return {"mean_logit_gap": sum(gaps) / len(gaps), "widest": max(gaps)}


def check(cell: Cell, seed: int, device, rec: dict) -> dict:
    ci = rec["check_inputs"]
    n = int(cell.workload["check"].get("sample", 8))
    reqs = ci["requests"]
    short = sum(len(t) != ci["output_len"] for _, t in reqs)
    sample = sample_requests(reqs, seed, n)
    g = gap_numbers(reference_gaps(cell, seed, device, sample)["f32"])
    where = (f"{len(sample)} requests, {sum(len(t) for _, t in sample)} "
             f"tokens, widest gap {g['widest']!r}")
    return {"mean_logit_gap": (g["mean_logit_gap"], where),
            "short_requests": (float(short), f"of {len(reqs)} finished")}
