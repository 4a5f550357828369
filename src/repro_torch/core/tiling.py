"""Bandwidth-minimizing output-stationary tiling (paper §II-B, Eq. 4).

A tile of a ``TensorOp`` keeps its PSums (output footprint) stationary in the
TEU's PSum buffer, streams its input footprints through the input buffers, and
costs ``tile_input_bytes / tile_macs`` bytes of external bandwidth per MAC —
the paper's objective.  ``search_tiles`` enumerates candidate tiles under the
buffer-capacity constraints and returns the Pareto-best schedule.

The same search serves two hardware targets:
  * the paper's TEU (16 KB input buffers, 5 KB PSum, 32 PEs)  — used by sim/;
  * a TPU TensorCore (VMEM budget, 128x128 MXU alignment) — kept equal to
    the JAX package's plans; the port's kernels take the H100 budget of
    ``cuda_bridge`` instead.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Mapping, Sequence

from .ndrange import TensorOp, PARALLEL, TEMPORAL, enumerate_tiles


@dataclasses.dataclass(frozen=True)
class BufferSpec:
    """Capacity constraints of one execution tile (TEU or TensorCore)."""

    input_bytes: int           # input operand buffer capacity
    psum_bytes: int            # accumulator buffer capacity
    psum_bytes_per_elem: int = 4   # PSums accumulate in wider precision (f32)
    # Vector/matrix-unit shape constraints: every PARALLEL tile dim that maps to
    # a compute lane must be a multiple of `align.get(dim)` (1 = unconstrained).
    align: Mapping[str, int] = dataclasses.field(default_factory=dict)
    # Number of parallel lanes consumed per cycle (32 PEs for a TEU). Used by
    # the perf model, not the capacity check.
    lanes: int = 32


# Paper TEU: two 32-bank 16 KB input buffers, 5 KB PSum buffer, 32 PEs.
TEU_BUFFER = BufferSpec(input_bytes=2 * 16 * 1024, psum_bytes=5 * 1024, lanes=32)

# TPU v5e TensorCore: ~128 MiB VMEM; leave headroom for double buffering (/2)
# and the accumulator. MXU wants 128-multiples on the two matmul lanes.
VMEM_BUFFER = BufferSpec(input_bytes=64 * 1024 * 1024,
                         psum_bytes=32 * 1024 * 1024,
                         lanes=128 * 128)


@dataclasses.dataclass(frozen=True)
class TileSchedule:
    """A chosen tile + derived traffic/compute statistics."""

    op_name: str
    tile: dict[str, int]
    macs: int
    input_bytes: int
    psum_bytes: int
    bytes_per_mac: float
    num_tiles: int
    grid: dict[str, int]

    def __str__(self) -> str:  # pragma: no cover - debugging aid
        t = ",".join(f"{k}={v}" for k, v in self.tile.items())
        return (f"TileSchedule({self.op_name}: [{t}] "
                f"{self.bytes_per_mac:.4f} B/MAC, {self.num_tiles} tiles)")


def tile_fits(op: TensorOp, tile: Mapping[str, int], buf: BufferSpec) -> bool:
    if op.tile_input_bytes(tile) > buf.input_bytes:
        return False
    if op.tile_psum_elems(tile) * buf.psum_bytes_per_elem > buf.psum_bytes:
        return False
    for dim, a in buf.align.items():
        if dim in tile and tile[dim] % a != 0 and tile[dim] != op.dim_map[dim].size:
            return False
    return True


def schedule_for(op: TensorOp, tile: Mapping[str, int]) -> TileSchedule:
    op.validate_tile(tile)
    return TileSchedule(
        op_name=op.name,
        tile=dict(tile),
        macs=op.tile_macs(tile),
        input_bytes=op.tile_input_bytes(tile),
        psum_bytes=op.tile_psum_elems(tile) * 4,
        bytes_per_mac=op.tile_bytes_per_mac(tile),
        num_tiles=op.num_tiles(tile),
        grid=op.grid_shape(tile),
    )


def search_tiles(op: TensorOp, buf: BufferSpec = TEU_BUFFER, *,
                 caps: Mapping[str, int] | None = None,
                 prefer_large: bool = True) -> TileSchedule:
    """Paper §II-B: pick the valid tile minimizing external bytes/MAC.

    Ties (common when several tiles hit the same footprint ratio) break toward
    larger tiles (fewer tiles => fewer PSum drains and less control overhead),
    then toward fuller temporal extent (fewer partial-sum revisits).

    Delegates to the vectorized + pruned + memoized engine in
    ``repro_torch.core.autotune`` (result-identical to the brute force below;
    ~100x faster on conv-style 6-dim lattices and free on repeats).  Use
    ``search_tiles_reference`` to run the original O(lattice) scan.
    """
    from .autotune import search_tiles_engine  # lazy: avoids import cycle
    return search_tiles_engine(op, buf, caps=caps, prefer_large=prefer_large)


def search_tiles_reference(op: TensorOp, buf: BufferSpec = TEU_BUFFER, *,
                           caps: Mapping[str, int] | None = None,
                           prefer_large: bool = True) -> TileSchedule:
    """Brute-force reference for ``search_tiles`` (kept for equivalence
    tests and ``benchmarks/bench_scheduler.py --reference`` timing)."""
    best: TileSchedule | None = None
    best_key = None
    for tile in enumerate_tiles(op, caps=caps):
        if not tile_fits(op, tile, buf):
            continue
        s = schedule_for(op, tile)
        # Larger temporal tile => output written once per full reduction pass.
        temporal_cov = math.prod(
            tile[d.name] / d.size for d in op.temporal_dims) if op.temporal_dims else 1.0
        key = (s.bytes_per_mac, -temporal_cov, -s.macs if prefer_large else s.macs)
        if best is None or key < best_key:
            best, best_key = s, key
    if best is None:
        raise ValueError(
            f"no tile of {op.name} fits buffers "
            f"(input<= {buf.input_bytes}B, psum<={buf.psum_bytes}B)")
    return best


# ---------------------------------------------------------------------------
# Whole-workload traffic model (used by sim/ and by the DRAM-traffic tests).
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class TrafficReport:
    """External traffic for executing the full op under a tile schedule."""

    input_fetch_bytes: int     # bytes fetched from the next memory level
    output_write_bytes: int    # PSum drains (exactly one per output elem here)
    total_macs: int

    @property
    def total_bytes(self) -> int:
        return self.input_fetch_bytes + self.output_write_bytes

    def normalized_access(self, per: int = 1000) -> float:
        """Paper Table III metric: bytes per `per` MAC operations."""
        return self.total_bytes * per / max(1, self.total_macs)


def traffic(op: TensorOp, tile: Mapping[str, int], *,
            shared_axes: Sequence[str] = ()) -> TrafficReport:
    """Count external fetches for the whole NDRange under a tiling.

    Without sharing, each tile fetches its full input footprint: operands are
    re-fetched once per tile even when a neighbouring tile just used them.
    ``shared_axes`` lists NDRange dims along which the FIFO mesh shares data:
    an operand invariant to a shared axis is fetched only once per *group* of
    tiles spanning that axis (paper Fig. 2 — E fetched once for P and Q).
    """
    op.validate_tile(tile)
    grid = op.grid_shape(tile)
    n_tiles = math.prod(grid.values())
    fetch = 0
    for v in op.inputs:
        inv = set(v.invariant_dims(op.dims))
        # Tiles that differ only along shared+invariant axes fetch once.
        group = 1
        for ax in shared_axes:
            if ax in inv:
                group *= grid[ax]
        fetch += v.footprint_bytes(tile) * (n_tiles // max(1, group))
        # note: footprint over the tile is per-tile unique data; groups share it.
    out_bytes = op.output.footprint_bytes(op.full_tile())
    return TrafficReport(
        input_fetch_bytes=fetch,
        output_write_bytes=out_bytes,
        total_macs=op.total_macs(),
    )
