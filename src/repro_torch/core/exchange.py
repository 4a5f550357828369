"""Data-exchange mesh analysis (paper §II-B, Fig. 2).

Two tiles share an input operand iff the operand's affine index map has zero
partial derivative against every NDRange axis on which the tiles differ
(``d(i,k)/dj = 0``  =>  tiles differing only in j share A).  In hardware the
share travels over the FIFO mesh between neighbouring TEUs; the operand is
fetched from the global buffer exactly once per sharing group.

Two consumers of this analysis:

* ``plan_mesh_exchange`` — TEU-mesh granularity (used by sim/): tiles are
  mapped wave-by-wave onto an R x C TEU mesh; operands invariant along the
  mesh-row/col axis are fetched once per row/col and forwarded over FIFOs.

* ``order_grid_for_sharing`` — Pallas granularity (used by kernels/): choose
  the grid-dimension order so operands whose block index is invariant along
  the innermost grid dims stay resident in VMEM across consecutive grid steps
  (Mosaic skips re-fetching a block whose index_map output is unchanged) —
  the single-core analogue of the FIFO hand-off.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Mapping, Sequence

from .ndrange import TensorOp


@dataclasses.dataclass(frozen=True)
class ExchangePlan:
    """Result of mapping a tiled op onto an R x C TEU mesh with FIFO sharing."""

    mesh_shape: tuple[int, int]
    row_axis: str | None            # NDRange dim laid along mesh rows
    col_axis: str | None            # NDRange dim laid along mesh cols
    fetch_bytes: int                # unique bytes fetched from global memory
    fetch_bytes_unshared: int       # bytes if every TEU fetched privately
    fifo_hop_bytes: int             # bytes moved over FIFOs instead
    waves: int

    @property
    def sharing_factor(self) -> float:
        return self.fetch_bytes_unshared / max(1, self.fetch_bytes)


def _axis_choices(op: TensorOp, grid: Mapping[str, int]) -> list[str | None]:
    axes: list[str | None] = [None]
    axes += [d.name for d in op.parallel_dims if grid[d.name] > 1]
    return axes


def plan_mesh_exchange(op: TensorOp, tile: Mapping[str, int],
                       mesh_shape: tuple[int, int], *,
                       share_rows: bool = True,
                       share_cols: bool = True,
                       row_span_cap: int | None = None,
                       col_span_cap: int | None = None) -> ExchangePlan:
    """Memoized front door for mesh-exchange planning (see the reference
    below for the semantics; repeated (op, tile, mesh) queries — e.g. the
    simulator's PE sweeps — hit the ``repro_torch.core.autotune`` cache)."""
    from .autotune import plan_mesh_exchange_engine  # lazy: import cycle
    return plan_mesh_exchange_engine(
        op, tile, mesh_shape, share_rows=share_rows, share_cols=share_cols,
        row_span_cap=row_span_cap, col_span_cap=col_span_cap)


def plan_mesh_exchange_reference(op: TensorOp, tile: Mapping[str, int],
                                 mesh_shape: tuple[int, int], *,
                                 share_rows: bool = True,
                                 share_cols: bool = True,
                                 row_span_cap: int | None = None,
                                 col_span_cap: int | None = None
                                 ) -> ExchangePlan:
    """Pick the (row_axis, col_axis) mesh layout minimizing global fetches.

    Execution proceeds in waves of R*C tiles. Within a wave, an operand that is
    invariant to the row axis is fetched by one TEU per column and forwarded
    down the column FIFOs (and symmetrically for columns). Operands invariant
    to both axes are fetched once per wave.

    ``share_rows``/``share_cols`` model restricted interconnects: Eyeriss'
    horizontal multicast shares along one axis only (the other axis still
    *executes* tiles concurrently but each unit fetches privately).
    """
    R, C = mesh_shape
    grid = op.grid_shape(tile)
    n_tiles = math.prod(grid.values())
    inv = {v.tensor_name: set(v.invariant_dims(op.dims)) for v in op.inputs}
    fp = {v.tensor_name: v.footprint_bytes(tile) for v in op.inputs}
    unshared = sum(fp.values()) * n_tiles

    best: ExchangePlan | None = None
    for row_axis, col_axis in itertools.product(_axis_choices(op, grid),
                                                _axis_choices(op, grid)):
        if row_axis is not None and row_axis == col_axis:
            continue
        # tiles concurrently resident along each mesh dimension
        r_span = min(R, grid[row_axis]) if row_axis else 1
        c_span = min(C, grid[col_axis]) if col_axis else 1
        wave = r_span * c_span
        waves = -(-n_tiles // wave)
        fetch = 0
        hops = 0
        for v in op.inputs:
            group = 1
            if share_rows and row_axis and row_axis in inv[v.tensor_name]:
                group *= min(r_span, row_span_cap or r_span)
            if share_cols and col_axis and col_axis in inv[v.tensor_name]:
                group *= min(c_span, col_span_cap or c_span)
            per_wave_fetch = fp[v.tensor_name] * (wave // group)
            fetch += per_wave_fetch * waves
            hops += fp[v.tensor_name] * (wave - wave // group) * waves
        plan = ExchangePlan((R, C), row_axis, col_axis, fetch, unshared,
                            hops, waves)
        if best is None or plan.fetch_bytes < best.fetch_bytes:
            best = plan
    assert best is not None
    return best


# ---------------------------------------------------------------------------
# Pallas-grid ordering: VMEM residency as the intra-chip FIFO analogue.
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GridOrder:
    """A permutation of grid dims, outermost first, with its reuse score."""

    order: tuple[str, ...]
    resident_bytes_saved: int   # HBM bytes NOT refetched thanks to residency
    total_fetch_bytes: int      # HBM bytes fetched under this order


def grid_fetch_bytes(op: TensorOp, tile: Mapping[str, int],
                     order: Sequence[str]) -> int:
    """HBM bytes fetched over the whole grid for a given dim order.

    A block of operand V is (re)fetched whenever a grid dim V depends on
    changes. With `order` outermost-first, V is fetched
    prod_{d in order, V depends on d} grid[d] times per full sweep *of the dims
    inside its innermost dependent dim* — i.e. exactly
    prod_{d: V depends on d} grid[d] x prod_{d outer than innermost dep} 1.
    Standard result: fetches(V) = prod over dims d of grid[d] if V depends on d
    else (grid[d] if d is OUTER than V's innermost dependent dim else 1).
    """
    grid = op.grid_shape(tile)
    total = 0
    for v in op.inputs:
        deps = {d.name for d in op.dims
                if any(e.depends_on(d.name) for e in v.index_exprs)}
        # position of the innermost dim v depends on
        innermost_dep = -1
        for pos, name in enumerate(order):
            if name in deps:
                innermost_dep = pos
        fetches = 1
        for pos, name in enumerate(order):
            if name in deps or pos < innermost_dep:
                fetches *= grid[name]
        total += v.footprint_bytes(tile) * fetches
    return total


def order_grid_for_sharing(op: TensorOp,
                           tile: Mapping[str, int]) -> GridOrder:
    """Choose the grid order minimizing HBM refetches (max VMEM residency).

    Reduction dims always stay innermost so the f32 accumulator drains
    exactly once per output block (paper's PSum-stationary rule); only the
    relative order of parallel dims is searched.

    Delegates to ``repro_torch.core.autotune.order_grid_engine``: all parallel-dim
    permutations are scored in one NumPy reduction and the result is
    memoized.  ``order_grid_for_sharing_reference`` keeps the original
    per-permutation Python scan for equivalence testing.
    """
    from .autotune import order_grid_engine  # lazy: avoids import cycle
    return order_grid_engine(op, tile)


def order_grid_for_sharing_reference(op: TensorOp,
                                     tile: Mapping[str, int]) -> GridOrder:
    """Brute-force reference for ``order_grid_for_sharing``."""
    par = [d.name for d in op.parallel_dims]
    tmp = [d.name for d in op.temporal_dims]
    best: GridOrder | None = None
    for perm in itertools.permutations(par):
        order = tuple(perm) + tuple(tmp)
        fetch = grid_fetch_bytes(op, tile, order)
        naive = sum(v.footprint_bytes(tile) for v in op.inputs) * op.num_tiles(tile)
        g = GridOrder(order, naive - fetch, fetch)
        if best is None or g.total_fetch_bytes < best.total_fetch_bytes:
            best = g
    assert best is not None
    return best
