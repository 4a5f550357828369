"""Cycle-approximate dataflow simulator (paper §III-B/C): a copy of the
JAX package's ``sim/simulator.py`` on ``repro_torch.core``.

Counts GLB and DRAM traffic and models execution time for the three
architectures on any ``TensorOp`` workload, reusing the SAME tiling/exchange
machinery from ``repro_torch.core`` (the copied scheduler) — the paper's
Table III and Figs. 3-4 fall out of this model rather than being hard-coded.

Conventions (matching the paper's Table III semantics):
  * GLB bytes  = input words units read from the global buffer (+ PSum spills
    through the GLB, where the dataflow forces them);
  * DRAM bytes = unique input fetches from DRAM (with a GLB-capacity refetch
    factor when the working set exceeds the GLB) + one write per output.
  * normalized access = bytes per 1,000 MACs (Table III).
  * time = max(compute, GLB-bandwidth, DRAM-bandwidth) — bandwidth/compute
    overlap, so the binding resource sets the time (roofline-consistent).
"""
from __future__ import annotations

import dataclasses
import math

from repro_torch.core.ndrange import TensorOp
from repro_torch.core.tiling import BufferSpec, search_tiles
from repro_torch.core.exchange import (grid_fetch_bytes,
                                      order_grid_for_sharing,
                                      plan_mesh_exchange)
from .archs import ArchConfig
from .workloads import Workload


@dataclasses.dataclass(frozen=True)
class SimResult:
    workload: str
    arch: str
    macs: int
    glb_bytes: int
    dram_bytes: int
    time_s: float
    gmacs: float                 # achieved GMAC/s (paper's "performance P")
    roofline_gmacs: float        # paper's black line
    norm_glb: float              # bytes / 1000 MACs (Table III)
    norm_dram: float

    @property
    def roofline_frac(self) -> float:
        return self.gmacs / max(1e-12, self.roofline_gmacs)


def _unique_bytes(op: TensorOp) -> int:
    full = op.full_tile()
    b = sum(v.footprint_bytes(full) for v in op.inputs)
    return b + op.output.footprint_bytes(full)


def roofline_gmacs(arch: ArchConfig, op: TensorOp) -> float:
    """min(PE rate, DRAM bw / unique-data intensity) — paper's roofline."""
    peak = arch.peak_macs_per_s
    intensity = op.total_macs() / _unique_bytes(op)  # MACs per DRAM byte
    return min(peak, arch.dram_bw * intensity) / 1e9


def _glb_level_dram(op: TensorOp, arch: ArchConfig, glb_inflow: int) -> int:
    """DRAM input bytes given GLB capacity (refetch when working set spills).

    If the GLB can hold a tile footprint, each GLB-tile is fetched once per
    sweep dictated by the best grid order; if the GLB is a pass-through
    (VectorMesh's 2 KB), DRAM inflow equals GLB inflow.

    Both the GLB-level tile search and the grid-order search go through the
    memoized engine (``repro_torch.core.autotune``), so every repeated
    (glb_bytes, op) query across archs, PE counts and benchmark files after
    the first is a cache hit rather than a fresh lattice scan.
    """
    unique_in = sum(v.footprint_bytes(op.full_tile()) for v in op.inputs)
    if unique_in <= arch.glb_bytes:
        return unique_in  # everything cached after first fetch
    try:
        glb_tile = search_tiles(
            op, BufferSpec(input_bytes=max(1, int(arch.glb_bytes * 0.75)),
                           psum_bytes=max(1, int(arch.glb_bytes * 0.25))))
    except ValueError:
        return glb_inflow  # pass-through GLB: no reuse capture
    order = order_grid_for_sharing(op, glb_tile.tile)
    dram_in = grid_fetch_bytes(op, glb_tile.tile, order.order)
    # The GLB can never cause MORE traffic than the stream it serves, nor less
    # than one fetch of the unique data.
    return max(min(dram_in, glb_inflow), unique_in)


# ---------------------------------------------------------------------------
# Tiled architectures: VectorMesh (fifo) and Eyeriss (multicast).
# ---------------------------------------------------------------------------

def _simulate_tiled(arch: ArchConfig, op: TensorOp) -> tuple[int, int, float]:
    # The unit-level search here and the GLB-level search inside
    # _glb_level_dram are the simulator's two hot lattice scans per
    # (arch, workload); both resolve through the memoized autotune engine,
    # so sweeping PE counts or re-running a benchmark pays for each distinct
    # (BufferSpec, op) pair exactly once.
    buf = BufferSpec(input_bytes=arch.unit_input_buffer,
                     psum_bytes=arch.unit_psum_buffer,
                     lanes=arch.pes_per_unit)
    sched = search_tiles(op, buf)
    # Eyeriss' horizontal multicast shares input rows along one full array
    # axis; its second-axis reuse comes from inter-PE PSum accumulation, whose
    # span is physically the filter height (kh PEs chain one column of partial
    # sums) — and the shared data is still DUPLICATED into each PE's local
    # buffer, so the effective tile stays tiny (0.3 KB). VectorMesh shares
    # along both mesh axes without duplication (full 37 KB TEU tile).
    if arch.sharing == "fifo":
        col_cap = None
    else:
        kh = next((d.size for d in op.temporal_dims if d.name == "m"), 1)
        col_cap = max(1, kh)
    plan = plan_mesh_exchange(
        op, sched.tile, arch.mesh,
        share_rows=True,
        share_cols=True,
        col_span_cap=col_cap,
    )
    out_bytes = op.output.footprint_bytes(op.full_tile())
    glb_bytes = plan.fetch_bytes                       # inputs read from GLB
    dram_in = _glb_level_dram(op, arch, plan.fetch_bytes)
    dram_bytes = dram_in + out_bytes

    # compute time: waves of units; lane under-utilization when the tile's
    # parallel extent is below the unit's vector width; row-stationary mapping
    # inefficiency when the filter height does not pack the array rows.
    par_pts = math.prod(sched.tile[d.name] for d in op.parallel_dims)
    lane_util = min(1.0, par_pts / arch.pes_per_unit)
    n_units = arch.mesh[0] * arch.mesh[1]
    tiles = sched.num_tiles
    occupancy = tiles / (math.ceil(tiles / n_units) * n_units)
    map_util = 1.0
    if arch.sharing == "multicast":
        kh = next((d.size for d in op.temporal_dims if d.name == "m"), 1)
        rows = arch.mesh[0]
        if kh <= rows:
            map_util = (rows // kh) * kh / rows
        else:
            map_util = kh / (math.ceil(kh / rows) * rows)
    eff = max(1e-3, lane_util * occupancy * map_util * PE_EFFICIENCY)
    compute_t = op.total_macs() / (arch.peak_macs_per_s * eff)
    return glb_bytes, dram_bytes, compute_t


# ---------------------------------------------------------------------------
# TPU: weight-stationary systolic array, no local tiling buffers.
# ---------------------------------------------------------------------------

def _split_systolic(op: TensorOp):
    """Map an op onto (stationary, moving) operands and (K_red, Co, T) sizes.

    The stationary operand is the one with the smaller footprint (weights for
    conv/GEMM). Its parallel dims feed the array columns; the reduction feeds
    the rows; remaining parallel dims are streamed output points T.
    """
    full = op.full_tile()
    ins = sorted(op.inputs, key=lambda v: v.footprint_bytes(full))
    stationary, moving = ins[0], ins[-1]
    k_red = math.prod(d.size for d in op.temporal_dims) or 1
    stat_par = [d for d in op.parallel_dims
                if any(e.depends_on(d.name) for e in stationary.index_exprs)]
    co = math.prod(d.size for d in stat_par) or 1
    t = math.prod(d.size for d in op.parallel_dims) // co or 1
    return stationary, moving, k_red, co, t


def _simulate_systolic(arch: ArchConfig, op: TensorOp) -> tuple[int, int, float]:
    R, C = arch.array
    stationary, moving, k_red, co, t = _split_systolic(op)
    bpe = arch.bytes_per_elem
    k_passes = math.ceil(k_red / R)
    c_passes = math.ceil(co / C)
    full = op.full_tile()

    w_bytes = stationary.footprint_bytes(full)            # loaded once/tile
    mov_unique = moving.footprint_bytes(full)
    mov_stream = t * k_red * bpe                          # one c-pass stream
    mov_bytes = mov_stream * c_passes                     # restreamed per c-pass
    # PSums leave the array every pass; accumulation across k-passes spills
    # through the GLB accumulators (read+write per revisit).
    psum_spill = 2 * t * co * arch.psum_bytes * max(0, k_passes - 1)
    out_bytes = op.output.footprint_bytes(full)
    glb_bytes = w_bytes + mov_bytes + psum_spill

    # DRAM: weight tiles stream from DRAM once (each used for its whole pass);
    # if the moving operand's working window fits the GLB it is fetched once,
    # otherwise the on-the-fly expansion (im2col for conv) must re-stream the
    # overlapping window from DRAM — the full t*k_red stream, per column-pass.
    if mov_unique <= arch.glb_bytes:
        dram_mov = mov_unique
    else:
        dram_mov = mov_stream * c_passes
    dram_bytes = w_bytes + dram_mov + out_bytes

    # time: each pass streams T points + pipeline fill/drain (R + C cycles);
    # array utilization suffers when K_red < R or Co < C (paper §III: bubbles
    # when running smaller tiles in larger TPUs).
    cycles = k_passes * c_passes * (t + R + C)
    compute_t = cycles / arch.freq_hz / PE_EFFICIENCY
    return glb_bytes, dram_bytes, compute_t


# ---------------------------------------------------------------------------

# The paper evaluates DRAM with ramulator (real DDR4 timing); sustained DDR4
# efficiency under mixed-stride streams is ~65-75% of nominal. We use 0.7 and
# model imperfect compute/IO overlap with the standard "max + epsilon*min"
# serialization term (double-buffering hides most but not all transfers).
DRAM_EFFICIENCY = 0.70
SERIALIZATION = 0.15
# Pipeline stalls, ragged edge tiles, and control overhead in the cycle-level
# design — calibrated so VectorMesh's absolute GMAC/s matches the paper's
# Table III (20 / 68 GOPS at 128 / 512 PEs).
PE_EFFICIENCY = 0.80


def simulate(arch: ArchConfig, wl: Workload) -> SimResult:
    op = wl.op
    if arch.sharing == "systolic":
        glb, dram, compute_t = _simulate_systolic(arch, op)
    else:
        glb, dram, compute_t = _simulate_tiled(arch, op)
    glb_t = glb / arch.glb_bw
    dram_t = dram / (arch.dram_bw * DRAM_EFFICIENCY)
    time_s = max(compute_t, glb_t, dram_t) + SERIALIZATION * min(
        compute_t, max(glb_t, dram_t))
    macs = op.total_macs()
    return SimResult(
        workload=wl.name,
        arch=arch.name,
        macs=macs,
        glb_bytes=glb,
        dram_bytes=dram,
        time_s=time_s,
        gmacs=macs / time_s / 1e9,
        roofline_gmacs=roofline_gmacs(arch, op),
        norm_glb=glb * 1000 / macs,
        norm_dram=dram * 1000 / macs,
    )


def summarize(results: list[SimResult]) -> dict[str, float]:
    """Aggregate Table III row for one architecture (sum-bytes / sum-MACs)."""
    macs = sum(r.macs for r in results)
    time = sum(r.time_s for r in results)
    return {
        "norm_glb": sum(r.glb_bytes for r in results) * 1000 / macs,
        "norm_dram": sum(r.dram_bytes for r in results) * 1000 / macs,
        "gmacs": macs / time / 1e9,
        "roofline_frac": (
            sum(r.roofline_frac for r in results) / len(results)),
    }
