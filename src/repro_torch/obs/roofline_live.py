"""Live roofline/traffic accountant: observed vs predicted bytes + FLOPs.

Counterpart of ``repro.obs.roofline_live``.  The paper's headline numbers
(2-22x fewer global-buffer fetches, up to 5x fewer DRAM fetches) are
PREDICTIONS from ``analysis/roofline.py``, the tile-search engine and
``sim/``.  This module closes the loop at runtime: it derives OBSERVED
bytes-moved and FLOPs from what the live system actually did — the serving
engine's per-tick KV-traffic counters, the prefix-cache/page-pool stats,
and the op cost counter's count of a run (``analysis.op_cost``) — and lines
them up against the analytic prediction as ``observed vs predicted`` rows
with a documented tolerance.  A regression that silently changes the
traffic a subsystem generates (scheduler chunking, COW explosion, a kernel
reading the padded page view) breaks the tolerance instead of hiding in a
wall-time.

Two traffic LEVELS mirror the paper's memory hierarchy:

``gb``    (global buffer) — token-exact bytes the COMPUTE consumed:
          per decode/prefill row, the attended context length x the
          per-token KV byte cost.  Predicted and observed use independent
          derivations (a closed-form sum over the request trace vs the
          engine's per-tick accumulation), so equality is an invariant
          of the scheduler/engine bookkeeping, not a tautology.
``dram``  — page-granular bytes the POOL served: the kernel streams whole
          pages, so observed reads round each context up to its page
          boundary.  observed/predicted(gb) quantifies the paging
          overhead and is bounded by ``1 + page_size / min_context``.

For a kernel call (conv2d here) the observed side is the op cost counter's
count of the call through ``kernels.ops`` (on the card, the hand-written
kernel: its entry reports its work) and the predicted side is the analytic
floor (exact MACs, operand+output bytes) plus the paper scheduler's
global-buffer fetch plan.

torch is imported inside the functions that run something, so the
serving-side accounting stays import-light.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, Sequence

LEVELS = ("gb", "dram")

# Documented tolerances (ratio bands, observed / predicted) asserted by
# tests/test_obs.py and the port's tests, and reported by
# ``TrafficRow.row()``:
#   * gb   — the two derivations must agree to float rounding; the band
#            allows scheduler-edge slack (budget-split chunks).
#   * dram — page-granularity overhead: every context rounds up to a page
#            boundary, so observed >= predicted(gb) but bounded by one
#            page per row read.
#   * hlo_flops — the counter counts the same MACs the NDRange does (2
#            flops per MAC).
#   * hlo_bytes — the counter's bytes of a call (the kernel's own touch-
#            once bytes here; an aten op's operands and outputs elsewhere)
#            within a small factor of the touch-once floor.
TOLERANCES = {"gb": 1.02, "dram": 1.75, "hlo_flops": 1.25, "hlo_bytes": 4.0}


@dataclasses.dataclass(frozen=True)
class TrafficRow:
    """One observed-vs-predicted comparison."""
    workload: str                  # e.g. "paged_decode", "conv2d"
    level: str                     # "gb" | "dram" | "hlo_flops" | ...
    observed: float
    predicted: float
    unit: str = "bytes"
    tolerance: float = 0.0         # ratio band; 0 -> TOLERANCES[level]
    bound: bool = False            # one-sided: only observed <= pred * tol

    @property
    def ratio(self) -> float:
        return self.observed / self.predicted if self.predicted else \
            float("inf")

    @property
    def tol(self) -> float:
        return self.tolerance or TOLERANCES.get(self.level, 1.5)

    @property
    def within(self) -> bool:
        if self.predicted <= 0:
            return False
        if self.bound:
            return self.ratio <= self.tol
        return 1.0 / self.tol <= self.ratio <= self.tol

    def row(self) -> dict:
        return {"workload": self.workload, "level": self.level,
                "observed": self.observed, "predicted": self.predicted,
                "unit": self.unit, "ratio": round(self.ratio, 4),
                "tolerance": self.tol, "within": self.within}


# ---------------------------------------------------------------------------
# Paged-decode serving traffic
# ---------------------------------------------------------------------------

def predict_paged_decode_traffic(
        prompt_lens: Sequence[int], max_new: int, *, page_size: int,
        page_bytes: int, prefill_chunk: int,
        matched: Sequence[int] | None = None) -> dict[str, float]:
    """Closed-form KV traffic for serving ``prompt_lens`` to completion.

    Mirrors the engine's tick accounting from the OUTSIDE: each prefill
    chunk attends over the context cached so far, each decode tick writes
    the previous token and attends over the grown context, and the final
    sampled token is never written back.  ``matched`` gives per-request
    prefix-cache hits (tokens served for free; default all-cold).

    Assumes chunks are never split by the per-tick token budget (size the
    engine's ``prefill_token_budget`` >= ``prefill_chunk`` x concurrent
    prefills when comparing against this) and greedy decode runs the full
    ``max_new`` (``eos_id = -1``).
    """
    bpt = page_bytes / page_size          # per-token KV bytes (K+V+scales)
    gb_tokens = 0                         # token-exact attended context
    dram_tokens = 0                       # page-granular pool reads
    written = 0
    for j, prompt_len in enumerate(prompt_lens):
        start = matched[j] if matched is not None else 0
        pos = start
        while pos < prompt_len:
            pos = min(prompt_len, pos + prefill_chunk)
            gb_tokens += pos
            dram_tokens += -(-pos // page_size) * page_size
        for i in range(1, max_new):
            ctx = prompt_len + i
            gb_tokens += ctx
            dram_tokens += -(-ctx // page_size) * page_size
        written += (prompt_len - start) + (max_new - 1)
    return {
        "gb_read_bytes": gb_tokens * bpt,
        "dram_read_bytes": dram_tokens * bpt,
        "written_bytes": written * bpt,
        "gb_read_tokens": gb_tokens,
        "dram_read_tokens": dram_tokens,
        "written_tokens": written,
    }


def paged_decode_rows(observed: Mapping[str, float],
                      predicted: Mapping[str, float]) -> list[TrafficRow]:
    """Line the engine's observed traffic (``engine.telemetry()
    ["traffic"]``) up against :func:`predict_paged_decode_traffic`."""
    return [
        TrafficRow("paged_decode", "gb", observed["gb_read_bytes"],
                   predicted["gb_read_bytes"]),
        TrafficRow("paged_decode", "dram", observed["dram_read_bytes"],
                   predicted["dram_read_bytes"]),
        TrafficRow("paged_decode", "gb", observed["written_bytes"],
                   predicted["written_bytes"], unit="bytes_written",
                   tolerance=TOLERANCES["gb"]),
    ]


# ---------------------------------------------------------------------------
# Kernel-call traffic (the op cost counter as the observer)
# ---------------------------------------------------------------------------

def observe(fn, *args) -> dict[str, float]:
    """Run ``fn(*args)`` once under the op cost counter: observed FLOPs and
    bytes, plus peak bytes — on the card ``torch.cuda.max_memory_allocated``
    over the call (everything the card holds), elsewhere the arguments'
    bytes plus the counter's peak of the storages the call created.  The
    counterpart of the reference's ``observe_compiled``."""
    import torch

    from repro_torch.analysis.op_cost import CostMode

    tensors = [a for a in args if isinstance(a, torch.Tensor)]
    on_card = bool(tensors) and tensors[0].is_cuda
    if on_card:
        torch.cuda.synchronize(tensors[0].device)
        torch.cuda.reset_peak_memory_stats(tensors[0].device)
    with CostMode() as m:
        fn(*args)
    if on_card:
        torch.cuda.synchronize(tensors[0].device)
        peak = torch.cuda.max_memory_allocated(tensors[0].device)
    else:
        peak = sum(t.numel() * t.element_size() for t in tensors) + \
            m.peak_bytes
    return {"flops": float(m.cost.flops), "bytes": float(m.cost.bytes),
            "peak_bytes": float(peak)}


def conv2d_rows(N: int, H: int, W: int, CI: int, CO: int, KH: int, KW: int,
                *, dtype_bytes: int = 4, stride: int = 1, dilation: int = 1,
                device=None) -> list[TrafficRow]:
    """Observed-vs-predicted rows for one NHWC VALID conv2d through
    ``kernels.ops.conv2d`` on ``device`` (default the card: the
    hand-written conv2d kernel, bf16 at ``dtype_bytes=2``; ``"cpu"`` runs
    its plain version).

    Observed: the op cost counter's count of the call (:func:`observe`).
    Predicted: exact MAC count (2 FLOPs/MAC) and the touch-once DRAM
    floor (input + weights + output bytes); the paper scheduler's
    global-buffer fetch plan for the same op is attached as a gauge-style
    extra row so the analytic GB prediction rides along with every
    comparison.  ``stride`` and ``dilation`` extend the reference's
    stride-1 conv to the catalog's (e.g. DL_ATROUS4).
    """
    import torch

    from repro_torch.core import (TEU_BUFFER, conv2d_op,
                                  order_grid_for_sharing, search_tiles)
    from repro_torch.device import resolve_device
    from repro_torch.kernels import ops

    OH = (H - dilation * (KH - 1) - 1) // stride + 1
    OW = (W - dilation * (KW - 1) - 1) // stride + 1
    macs = N * OH * OW * CO * CI * KH * KW
    floor_bytes = dtype_bytes * (N * H * W * CI + KH * KW * CI * CO +
                                 N * OH * OW * CO)

    dev = resolve_device(device)
    dtype = {2: torch.bfloat16, 4: torch.float32}[dtype_bytes]
    x = torch.zeros((N, H, W, CI), dtype=dtype, device=dev)
    w = torch.zeros((KH, KW, CI, CO), dtype=dtype, device=dev)
    obs = observe(lambda a, b: ops.conv2d(a, b, stride=stride,
                                          dilation=dilation), x, w)

    # the paper's §II-B prediction for the same op: tile schedule + grid
    # order -> HBM->global-buffer fetch bytes on the TEU arch
    op = conv2d_op(CO, CI, OH, OW, KH, KW, stride=stride, dilation=dilation,
                   bytes_per_elem=dtype_bytes)
    sched = search_tiles(op, TEU_BUFFER)
    plan = order_grid_for_sharing(op, sched.tile)
    return [
        TrafficRow("conv2d", "hlo_flops", obs["flops"], 2.0 * macs,
                   unit="flops"),
        TrafficRow("conv2d", "hlo_bytes", obs["bytes"], floor_bytes),
        # the scheduler's own GB fetch plan vs the refetch-everything
        # bound: the paper's fetch-reduction claim as a runtime row (the
        # plan must never exceed the naive bound)
        TrafficRow("conv2d", "gb", plan.total_fetch_bytes,
                   plan.total_fetch_bytes + plan.resident_bytes_saved,
                   tolerance=1.0 + 1e-9, bound=True),
    ]


def report(rows: Sequence[TrafficRow], *, registry=None) -> list[dict]:
    """Render rows as dicts and mirror them into a metrics registry
    (``obs.REGISTRY`` by default) as gauges keyed by workload/level."""
    if registry is None:
        from . import metrics
        registry = metrics.REGISTRY
    out = []
    for r in rows:
        registry.gauge("traffic_observed", r.observed,
                       workload=r.workload, level=r.level, unit=r.unit)
        registry.gauge("traffic_predicted", r.predicted,
                       workload=r.workload, level=r.level, unit=r.unit)
        registry.gauge("traffic_ratio", r.ratio,
                       workload=r.workload, level=r.level, unit=r.unit)
        out.append(r.row())
    return out
