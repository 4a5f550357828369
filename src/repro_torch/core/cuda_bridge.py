"""Bridge: VectorMesh tile schedules -> tiles of the hand-written Hopper
kernels (sm_90a).

Counterpart of the JAX package's ``core/pallas_bridge.py``.  ``plan_kernel``
is the same planner with the same arguments: the paper's tile search under
a buffer budget and alignment, then the grid order that keeps invariant
operands resident (``core.exchange.order_grid_for_sharing``).  Called with
the JAX package's arguments it returns the JAX package's plan.

``matmul_block_shapes`` re-targets the GEMM search to one H100 CTA, whose
scarce resources are not a TPU core's.  It keeps the paper's objective (the
Eq. 4 search: fewest input bytes per MAC under the buffer budgets) on the
lattice of the route the tile is for:

* route ``"matmul"`` (bf16 ``wgmma``): the A and B tiles are staged in bf16
  in a ring of ``STAGES`` shared-memory stages, so an element costs
  ``STAGE_BYTES`` = 2 x ``STAGES`` bytes under ``SMEM_BUDGET`` of the
  227 KB a CTA may hold; the f32 accumulator lives in the registers of the
  consumer warpgroups (``WGMMA_ACC_BUDGET``: two warpgroups x 128 threads x
  128 registers); bm is 64 or 128 (one or two warpgroups), bn 64, 128 or
  256, bk 64 (one 128-byte swizzle row of bf16) — ``WGMMA_TILES``;
* route ``"matmul_simt"`` (the CUDA-core kernel, for f32 and for operands
  TMA cannot take): A and B staged as f32 (``SIMT_STAGE_BYTES``), a 64 KB
  accumulator budget (256 threads x 64 registers), the tiles
  ``MATMUL_TILES``.

On both, the problem is first rounded onto the route's lattice (M to 64s
on the wgmma route; on the CUDA-core one to a power of two below 64 and to
64s above; N to 64s; K to the lattice's bk),
so the alignment's full-size exemption can only name a tile the kernel has.
The kernels mask the ragged edges; nothing is padded.

Where the TPU search stops, the card's 132 SMs add one rule for the wgmma
route.  A TPU core runs the grid in order, so the largest tile (fewest
bytes per MAC) is the whole answer there; on the card, CTAs run side by
side, and GEMM_1K's largest tile (128 x 256) gives 32 CTAs and leaves 100
SMs idle.  So while the grid has fewer than one CTA per SM (``SM_COUNT``)
and the tile is larger than 64 x 64, the search is run again with the
larger tile side capped at half its size.  A problem with at least 132
64 x 64 tiles thus always fills the card, a smaller one gets as many CTAs
as it can, and among the tiles that fill the card the objective still
picks the one with the fewest bytes per MAC.

bf16 at M <= ``GEMV_MAX_M`` with no tile named takes no tile:
:func:`gemv_plan` splits K for the GEMV kernel instead.

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
SM_COUNT = 132                       # SMs of an H100 SXM

# route "matmul": bf16 tiles in a ring of STAGES stages, wgmma accumulators
STAGES = 4
STAGE_BYTES = 2 * STAGES
WGMMA_ACC_BUDGET = 2 * 128 * 128 * 4
WGMMA_ALIGN = {"i": 64, "j": 64, "k": 64}
WGMMA_CAPS = {"i": 128, "j": 256, "k": 64}
# Every (bm, bn, bk) that csrc/matmul.cu's wgmma kernel instantiates.
WGMMA_TILES = frozenset((bm, bn, 64) for bm in (64, 128)
                        for bn in (64, 128, 256))

# route "matmul_simt": f32-staged tiles, a 256-thread x 64-register
# accumulator
SIMT_STAGE_BYTES = 4
ACC_BUDGET = 64 * 1024
MATMUL_ALIGN = {"i": 64, "j": 64, "k": 32}
MATMUL_CAPS = {"i": 128, "j": 128, "k": 64}
# Every (bm, bn, bk) that csrc/matmul.cu's CUDA-core kernel instantiates.
MATMUL_TILES = frozenset((bm, bn, bk) for bm in (8, 16, 32, 64, 128)
                         for bn in (64, 128) for bk in (32, 64))

# route "matmul_gemv": 64-column strips, K split until the grid has about
# GEMV_CTAS CTAs (several per SM, to keep enough loads in flight)
GEMV_COLS = 64
GEMV_ROWS = 8                        # rows of A a CTA takes at once
GEMV_CTAS = 512
GEMV_MIN_SPLIT_K = 256
# The largest M the route sends to the GEMV.  The kernel takes any M < 64,
# in 8-row groups that each read all of B, but on an H100 at GEMM_FC's
# N 4096 and K 9216 (``chip_smoke.py``, phase ``skinny_matmul``) it beats
# the wgmma kernel's 64-row tile only at M = 1: 0.047 vs 0.059 ms; at M 2
# it is 0.066, at M 8 0.089, at M 63 0.51, while the wgmma tile stays at
# 0.058-0.059 ms for every M.
GEMV_MAX_M = 1


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


def matmul_lattice(M: int, N: int, K: int, *, route: str = "matmul_simt"
                   ) -> tuple[int, int, int]:
    """The problem rounded onto the lattice of a route's built tiles (see
    module docstring): the search runs on this shape."""
    if route == "matmul":
        return (round_up(max(M, 64), 64), round_up(max(N, 64), 64),
                round_up(max(K, 64), 64))
    Mq = pow2_ceil(max(M, 8)) if M < 64 else round_up(M, 64)
    return Mq, round_up(max(N, 64), 64), round_up(max(K, 32), 32)


def _search(M: int, N: int, K: int, *, route: str,
            caps: Mapping[str, int]) -> tuple[int, int, int]:
    if route == "matmul":
        op = matmul_op(*matmul_lattice(M, N, K, route=route),
                       bytes_per_elem=STAGE_BYTES)
        plan = plan_kernel(op, vmem_budget_bytes=SMEM_BUDGET,
                           psum_budget_bytes=WGMMA_ACC_BUDGET,
                           align=WGMMA_ALIGN, caps=caps)
    else:
        op = matmul_op(*matmul_lattice(M, N, K),
                       bytes_per_elem=SIMT_STAGE_BYTES)
        plan = plan_kernel(op, vmem_budget_bytes=SMEM_BUDGET,
                           psum_budget_bytes=ACC_BUDGET, align=MATMUL_ALIGN,
                           caps=caps)
    return plan.block["i"], plan.block["j"], plan.block["k"]


def grid_ctas(M: int, N: int, bm: int, bn: int) -> int:
    return -(-M // bm) * -(-N // bn)


def matmul_block_shapes(M: int, N: int, K: int, *, route: str = "matmul"
                        ) -> tuple[int, int, int]:
    """(bm, bn, bk) for an MxK @ KxN matmul on one H100 CTA, for the
    ``"matmul"`` (wgmma) or ``"matmul_simt"`` route.

    The paper's objective ((bm+bn)*bk bytes per bm*bn*bk MACs) under the
    shared-memory budget for the staged A and B tiles and the register
    budget for the f32 accumulator; on the wgmma route, capped until the
    grid fills the card's SMs where the problem allows (module docstring).
    The result is always one of the route's built tiles (``WGMMA_TILES``,
    ``MATMUL_TILES``); anything else raises, it is never replaced."""
    if route == "matmul":
        built, caps = WGMMA_TILES, dict(WGMMA_CAPS)
    elif route == "matmul_simt":
        built, caps = MATMUL_TILES, dict(MATMUL_CAPS)
    else:
        raise ValueError(f"no tile search for route {route!r}")
    tile = _search(M, N, K, route=route, caps=caps)
    if route == "matmul":
        while grid_ctas(M, N, *tile[:2]) < SM_COUNT and tile[:2] != (64, 64):
            bm, bn = tile[:2]
            if bn >= bm:
                caps["j"] = bn // 2
            else:
                caps["i"] = bm // 2
            tile = _search(M, N, K, route=route, caps=caps)
    if tile not in built:
        raise ValueError(f"tile search gave {tile} for {(M, N, K)}, which "
                         f"csrc/matmul.cu is not built for ({route})")
    return tile


def gemv_plan(M: int, N: int, K: int) -> tuple[int, int]:
    """(splits, kchunk) of the GEMV route: K is cut into ``splits`` chunks
    of ``kchunk`` (a multiple of 8; the last may be short), enough for about
    ``GEMV_CTAS`` CTAs over the 64-column strips and 8-row groups of A, and
    no chunk shorter than ``GEMV_MIN_SPLIT_K``.  GEMM_FC (1 x 4096 x 9216):
    64 strips x 8 splits of 1152 = 512 CTAs."""
    ctas = -(-N // GEMV_COLS) * -(-M // GEMV_ROWS)
    want = max(1, min(-(-GEMV_CTAS // ctas), K // GEMV_MIN_SPLIT_K))
    kchunk = round_up(-(-K // want), 8)
    return -(-K // kchunk), kchunk
