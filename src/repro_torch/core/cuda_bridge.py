"""Bridge: VectorMesh tile schedules -> tiles of the hand-written Hopper
kernels (sm_90a).

Counterpart of the JAX package's ``core/pallas_bridge.py``.  ``plan_kernel``
is the same planner with the same arguments: the paper's tile search under
a buffer budget and alignment, then the grid order that keeps invariant
operands resident (``core.exchange.order_grid_for_sharing``).  Called with
the JAX package's arguments it returns the JAX package's plan.

``matmul_block_shapes`` re-targets the GEMM search to one H100 CTA, whose
scarce resources are not a TPU core's:

* the A and B tiles are staged in shared memory as f32
  (``STAGE_BYTES``), under ``SMEM_BUDGET`` of the 227 KB a CTA may hold;
* the f32 accumulator lives in registers, not shared memory: its budget
  ``ACC_BUDGET`` is 256 threads x 64 registers;
* alignment and caps confine the search to the tiles ``csrc/matmul.cu``
  is built for (``MATMUL_TILES``): the problem is first rounded onto that
  lattice (M to a power of two below 64 and to 64s above, N to 64s, K to
  32s), so the full-size exemption of the alignment can only name a tile
  the kernel has.  The kernel masks the ragged edges; nothing is padded.

Both searches resolve through the memoized engine
(``repro_torch.core.autotune``), so a repeated shape is a cache lookup.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping

from .exchange import GridOrder, order_grid_for_sharing
from .ndrange import TensorOp, matmul_op
from .tiling import BufferSpec, TileSchedule, search_tiles

# Shared memory one CTA may use on an H100 (232,448 bytes), and the part
# the matmul search may give to its A and B tiles.
SMEM_PER_CTA = 227 * 1024
SMEM_BUDGET = 192 * 1024
# Registers for the f32 accumulator: 256 threads x 64 registers x 4 bytes.
ACC_BUDGET = 64 * 1024
STAGE_BYTES = 4                      # A and B tiles are staged as f32
MATMUL_ALIGN = {"i": 64, "j": 64, "k": 32}
MATMUL_CAPS = {"i": 128, "j": 128, "k": 64}
# Every (bm, bn, bk) that csrc/matmul.cu instantiates.
MATMUL_TILES = frozenset((bm, bn, bk) for bm in (8, 16, 32, 64, 128)
                         for bn in (64, 128) for bk in (32, 64))


def round_up(x: int, m: int) -> int:
    return -(-x // m) * m


def pow2_floor(n: int) -> int:
    return 1 << (max(1, int(n)).bit_length() - 1)


def pow2_ceil(n: int) -> int:
    return 1 << (max(1, int(n)) - 1).bit_length()


@dataclasses.dataclass(frozen=True)
class KernelPlan:
    """Everything a kernel launch needs: block shapes, grid, order."""

    schedule: TileSchedule
    grid_order: GridOrder
    block: dict[str, int]          # tile sizes, aligned
    grid: tuple[int, ...]          # grid extents in grid_order
    dims_order: tuple[str, ...]


def plan_kernel(op: TensorOp, *, vmem_budget_bytes: int = 64 * 1024 * 1024,
                psum_budget_bytes: int = 32 * 1024 * 1024,
                align: Mapping[str, int] | None = None,
                caps: Mapping[str, int] | None = None) -> KernelPlan:
    """Run the paper's tile search under a buffer budget and order the
    grid.  The arguments and their defaults are the JAX package's (its
    TPU budget); ``matmul_block_shapes`` passes the H100's.

    ``align`` maps NDRange dim name -> required multiple.  Dims equal to
    their full size are exempt (ragged final blocks are masked in the
    kernels)."""
    buf = BufferSpec(input_bytes=vmem_budget_bytes,
                     psum_bytes=psum_budget_bytes,
                     align=dict(align or {}))
    sched = search_tiles(op, buf, caps=caps)
    order = order_grid_for_sharing(op, sched.tile)
    grid_shape = op.grid_shape(sched.tile)
    grid = tuple(grid_shape[name] for name in order.order)
    return KernelPlan(schedule=sched, grid_order=order, block=dict(sched.tile),
                      grid=grid, dims_order=order.order)


def matmul_lattice(M: int, N: int, K: int) -> tuple[int, int, int]:
    """The problem rounded onto the lattice of built tiles (see module
    docstring): the search runs on this shape."""
    Mq = pow2_ceil(max(M, 8)) if M < 64 else round_up(M, 64)
    return Mq, round_up(max(N, 64), 64), round_up(max(K, 32), 32)


def matmul_block_shapes(M: int, N: int, K: int) -> tuple[int, int, int]:
    """(bm, bn, bk) for an MxK @ KxN matmul on one H100 CTA.

    The paper's objective ((bm+bn)*bk bytes per bm*bn*bk MACs) under the
    shared-memory budget for the f32-staged A and B tiles and the register
    budget for the f32 accumulator.  The result is always one of
    ``MATMUL_TILES``; anything else raises, it is never replaced."""
    op = matmul_op(*matmul_lattice(M, N, K), bytes_per_elem=STAGE_BYTES)
    plan = plan_kernel(op, vmem_budget_bytes=SMEM_BUDGET,
                       psum_budget_bytes=ACC_BUDGET, align=MATMUL_ALIGN,
                       caps=MATMUL_CAPS)
    tile = plan.block["i"], plan.block["j"], plan.block["k"]
    if tile not in MATMUL_TILES:
        raise ValueError(f"tile search gave {tile} for {(M, N, K)}, which "
                         f"csrc/matmul.cu is not built for")
    return tile
