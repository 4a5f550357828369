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

:func:`conv2d_plan` plans the conv2d ``wgmma`` route's implicit GEMM
(``csrc/conv2d.cu``): the pixel tile (``block_oh`` x ``block_ow`` output
pixels, 64 or 128 of them), the output-channel tile and the K split.  It
keeps the same card rule (large tiles, smaller while the grid has fewer
CTAs than SMs, then the K steps split over CTAs), with the box width and
split threshold measured on the card.
"""
from __future__ import annotations

import dataclasses
from typing import Mapping, NamedTuple

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


def attention_block_shapes(q_len: int, kv_len: int, head_dim: int
                           ) -> tuple[int, int]:
    """(block_q, block_k) of a flash-attention score tile: the blocks of
    the forward route bf16 q/k/v at ``head_dim`` take on the card
    (``kernels.attention.flash_fwd_blocks``: 128 x 128 at head_dim 64 or
    128, 128 x 64 at 256, the CUDA-core kernel's 64 x 64 otherwise),
    clamped to the problem rounded up to a power of two (the kernels pad
    ragged tails and mask them).  The paper's tile search, which the
    reference runs here on the QK^T NDRange, does not apply: each flash
    kernel is built for its fixed blocks and the card runs only those.
    ``parallel.ring_attention`` snaps these to divisors of the local shard
    to decide between the fused and the einsum fold, and the plain versions
    on the CPU run the snapped blocks."""
    from ..kernels.attention import flash_fwd_blocks
    route = {64: "flash_fwd", 128: "flash_fwd", 256: "flash_fwd_d256"} \
        .get(head_dim, "flash_fwd_simt")
    bq, bk = flash_fwd_blocks(route)
    return min(bq, pow2_ceil(q_len)), min(bk, pow2_ceil(kv_len))


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


# route "conv2d" (csrc/conv2d.cu's wgmma implicit GEMM): a tile of BM
# output pixels (one or two consumer warpgroups of 64) as block_oh rows x
# block_ow columns of one image, block_co output channels (one or two
# 64-wide swizzle atoms of B), the (kh, kw, ci) reduction in 64-wide steps
CONV_BM = (128, 64)
CONV_BLOCK_OW = (64, 32, 16, 8)
CONV_BLOCK_CO = (128, 64)
# Every (block_oh, block_ow, block_co) the wgmma conv kernel instantiates.
CONV_TILES = frozenset((bm // bow, bow, bco) for bm in CONV_BM
                       for bow in CONV_BLOCK_OW for bco in CONV_BLOCK_CO)
CONV_BLOCK_OH = frozenset(t[0] for t in CONV_TILES)


class ConvPlan(NamedTuple):
    """A launch of the conv2d wgmma route: its tile, its K split, the K
    steps of 64 it walks and its CTAs (pixel tiles x channel tiles x
    splits)."""

    block_oh: int
    block_ow: int
    block_co: int
    splits: int
    k_steps: int
    ctas: int


def conv2d_a_tma(CI: int, stride: int, block_ow: int) -> bool:
    """Whether the kernel loads the input pixels by TMA (tap by tap, 64
    channels a step): rows of 16-byte multiples, and a box of block_ow
    outputs that steps the W axis by the stride spans at most 256
    elements; otherwise its producers gather the flattened (kh, kw, ci)
    reduction."""
    return CI % 8 == 0 and stride <= 8 and block_ow * stride <= 256


def conv2d_k_steps(CI: int, KH: int, KW: int, *, stride: int = 1,
                   block_ow: int = 64) -> int:
    """64-wide reduction steps of the wgmma conv: KH KW ceil(CI / 64) tap
    by tap, or ceil(KH KW CI / 64) over the flattened reduction."""
    if conv2d_a_tma(CI, stride, block_ow):
        return KH * KW * -(-CI // 64)
    return -(-(KH * KW * CI) // 64)


def conv2d_blocks_built(block_oh: int | None, block_co: int | None) -> bool:
    """Whether blocks a caller names (None: not named) are ones the wgmma
    conv kernel instantiates."""
    return ((block_oh is None or block_oh in CONV_BLOCK_OH) and
            (block_co is None or block_co in CONV_BLOCK_CO))


def conv2d_plan(N: int, OH: int, OW: int, CI: int, CO: int, KH: int,
                KW: int, *, stride: int = 1, block_oh: int | None = None,
                block_co: int | None = None) -> ConvPlan:
    """The tile and K split of the conv2d ``wgmma`` route for an (N, OH,
    OW, CO) output over a (KH, KW, CI) reduction, by rules measured on one
    H100 (``chip_smoke.py``'s catalog convs, every built tile and split):

    * block_ow: the smallest power of two that covers an output row, at
      most 64.  Each tile row is one TMA box, and few large boxes beat
      many small ones even where they pad more (DL_ATROUS4: 0.033 ms at
      1 x 64 pixels, 0.045 ms at 8 x 8, by device time);
    * BM (block_oh x block_ow pixels): 128 where that grid reaches
      ``SM_COUNT`` CTAs, else 64; always 64 where the producers gather A
      (CI = 3: TY_CONV1 0.067 ms at 64 pixels, 0.086 ms at 128);
    * block_co: 128 where CO > 64 and that grid reaches ``SM_COUNT``
      CTAs, else 64;
    * a K split only while the grid has fewer than ``SM_COUNT // 2`` CTAs
      (it adds the reduction pass: MBN_PW 0.0085 ms unsplit at 112 CTAs,
      0.0132 ms split in two), then splits until the grid reaches
      ``SM_COUNT`` or every split is one K step, none empty.

    Blocks a caller names are kept (block_ow then follows from block_oh
    and BM); blocks the kernel is not built for raise."""
    if not conv2d_blocks_built(block_oh, block_co):
        raise ValueError(
            f"conv2d: blocks (block_oh {block_oh}, block_co {block_co}) are "
            f"not ones csrc/conv2d.cu is built for on route conv2d "
            f"(block_oh {sorted(CONV_BLOCK_OH)}, block_co "
            f"{sorted(CONV_BLOCK_CO)})")
    nat = min(64, max(8, pow2_ceil(OW)))
    # the row-covering width first, then wider, then narrower ones
    bows = sorted(CONV_BLOCK_OW, key=lambda b: (b < nat, abs(b - nat)))

    def tile(bm: int):
        for bow in bows:
            if block_oh is None or bm // bow == block_oh:
                return bm // bow, bow
        return None

    def ctas(boh: int, bow: int, bco: int) -> int:
        return N * -(-OH // boh) * -(-OW // bow) * -(-CO // bco)

    wide = block_co or (128 if CO > 64 else 64)
    gather = not conv2d_a_tma(CI, stride, nat)
    shapes = [t for t in (tile(bm) for bm in
                          ((64, 128) if gather else CONV_BM)) if t]
    boh, bow = shapes[0]
    if not gather and len(shapes) > 1 and \
            ctas(boh, bow, wide) < SM_COUNT:
        boh, bow = shapes[1]
    bco = block_co or (128 if wide == 128 and
                       ctas(boh, bow, 128) >= SM_COUNT else 64)
    n = ctas(boh, bow, bco)
    steps = conv2d_k_steps(CI, KH, KW, stride=stride, block_ow=bow)
    splits = 1
    if n < SM_COUNT // 2:
        per = -(-steps // min(steps, -(-SM_COUNT // n)))
        splits = -(-steps // per)
    return ConvPlan(boh, bow, bco, splits, steps, n * splits)


# route "correlation" (csrc/correlation.cu's wgmma kernel): a tile of
# CORR_TX output columns (wgmma's M), the band of an I2 row window
# block_n = 64 + 2R rounded up to 8 wide (the N the kernel instantiates,
# CORR_BLOCK_N), channels in 64-wide chunks (one 128-byte swizzle row)
CORR_TX = 64
CORR_MAX_RADIUS = 31
CORR_BLOCK_N = frozenset(range(64, 129, 8))
CORR_ROWS = (1, 2)                   # consumer warpgroups: one I1 row each
CORR_MAX_STAGES = 8
# the kernel keeps 3 wgmma groups in flight a warpgroup, each holding a
# ring stage: the ring needs at least that many
CORR_MIN_STAGES = 3
CORR_A_BYTES = CORR_TX * 128         # one I1 row's 64-channel chunk


class CorrPlan(NamedTuple):
    """A launch of the correlation wgmma route: output rows a CTA (one
    consumer warpgroup each), the dy values a CTA (``dy_group``), the band
    width N, the ring's stages of 64-channel I2 chunks, the chunks of a
    channel pass and the passes, the CTAs, and the shared memory a CTA
    takes."""

    rows: int
    dy_group: int
    block_n: int
    stages: int
    chunks: int
    passes: int
    ctas: int
    smem: int


def correlation_block_n(radius: int) -> int:
    """The narrowest band width the kernel is built for: the 64 + 2R I2
    columns a 64-column tile's D displacements read, rounded up to 8."""
    return round_up(CORR_TX + 2 * radius, 8)


def correlation_smem(radius: int, rows: int, dy_group: int, block_n: int,
                     stages: int, chunks: int) -> int:
    """Shared memory of one CTA, as ``csrc/correlation.cu``'s
    ``corr_layout`` sums it: the I1 rows' chunks, the ring of I2 chunks,
    the f32 staging block of the CTA's outputs, the mbarriers (two a
    stage, one an I1 chunk, one for I1's release) and 1024 bytes to align
    the base."""
    D = 2 * radius + 1
    tiles = rows * chunks * CORR_A_BYTES + stages * block_n * 128
    bars = round_up(tiles + rows * CORR_TX * dy_group * D * 4, 8)
    return bars + (2 * stages + chunks + 1) * 8 + 1024


def correlation_plan(H: int, W: int, C: int, radius: int, *,
                     rows: int | None = None, dy_group: int | None = None,
                     block_n: int | None = None,
                     stages: int | None = None) -> CorrPlan:
    """The tiling of the correlation ``wgmma`` route for (H, W, C) maps at
    ``radius``, from shapes only:

    * block_n: :func:`correlation_block_n` (FLOWNET_CORR 88, EVA2_MATCH 80);
    * rows: 2 (an I2 row staged once serves both resident I1 rows), 1 for a
      one-row map;
    * dy_group: the dy values split into as many groups as keep the grid
      (64-column tiles x row blocks x groups) within one wave of
      ``SM_COUNT`` CTAs, at least one group (EVA2_MATCH: 13 row blocks x 9
      groups of 2 = 117 CTAs).  A group one smaller is taken where only
      its full groups fit one wave and the remainder group is at most half
      a group: the remainder's CTAs come last in the grid and are cheap,
      so they run as a short second wave (FLOWNET_CORR: 24 x 5 groups of 4
      and 24 of 1 = 144 CTAs, 0.0264 ms against 0.0306 at 5 groups of 5,
      ``scripts/sweep_correlation_torch.py``);
    * stages: as many 64-channel I2 chunks in flight as ``SMEM_BUDGET``
      leaves room for, at most ``CORR_MAX_STAGES`` and at least
      ``CORR_MIN_STAGES``;
    * while fewer stages fit: the dy group halves where the staged
      outputs outweigh the I1 rows, else the channels are cut into passes
      of fewer chunks (the I1 rows are reloaded each pass and the passes
      add up in the staging block), then the dy group halves.

    Values a caller names are kept; ones the kernel is not built for, a
    radius above ``CORR_MAX_RADIUS`` and a plan that cannot fit raise."""
    if not 0 <= radius <= CORR_MAX_RADIUS:
        raise ValueError(f"correlation: radius {radius} not built (0.."
                         f"{CORR_MAX_RADIUS})")
    D = 2 * radius + 1
    n = block_n or correlation_block_n(radius)
    if n not in CORR_BLOCK_N or n < CORR_TX + 2 * radius:
        raise ValueError(f"correlation: block_n {n} is not one "
                         f"csrc/correlation.cu is built for at radius "
                         f"{radius} (a multiple of 8 in "
                         f"[{CORR_TX + 2 * radius}, 128])")
    r = rows or (2 if H >= 2 else 1)
    if r not in CORR_ROWS:
        raise ValueError(f"correlation: rows {r} not built {CORR_ROWS}")
    if dy_group is not None and not 1 <= dy_group <= D:
        raise ValueError(f"correlation: dy_group {dy_group} not in 1..{D}")
    if stages is not None and \
            not CORR_MIN_STAGES <= stages <= CORR_MAX_STAGES:
        raise ValueError(f"correlation: stages {stages} not in "
                         f"{CORR_MIN_STAGES}..{CORR_MAX_STAGES}")
    kc = -(-C // 64)
    tiles = -(-W // CORR_TX) * -(-H // r)
    g = dy_group or -(-D // max(1, min(D, SM_COUNT // tiles)))
    if dy_group is None and g > 1 and (D // (g - 1)) * tiles <= SM_COUNT \
            and 2 * (D % (g - 1)) <= g - 1:
        g -= 1
    kb = kc

    def fit(g: int, kb: int) -> int:
        if stages is not None:
            return stages if correlation_smem(
                radius, r, g, n, stages, kb) <= SMEM_BUDGET else 0
        spare = SMEM_BUDGET - correlation_smem(radius, r, g, n, 0, kb)
        return max(0, min(CORR_MAX_STAGES, spare // (n * 128 + 16)))

    while fit(g, kb) < CORR_MIN_STAGES:
        out_bytes = r * CORR_TX * g * D * 4
        if dy_group is None and g > 1 and out_bytes >= r * kb * CORR_A_BYTES:
            g = -(-g // 2)
        elif kb > 1:
            kb = -(-kb // 2)
        elif dy_group is None and g > 1:
            g = -(-g // 2)
        else:
            raise ValueError(f"correlation: no plan fits {SMEM_BUDGET} bytes "
                             f"of shared memory at (H {H}, W {W}, C {C}, "
                             f"radius {radius}, rows {r}, dy_group {g}, "
                             f"block_n {n})")
    s = fit(g, kb)
    groups = -(-D // g)
    return CorrPlan(r, g, n, s, kb, -(-kc // kb), tiles * groups,
                    correlation_smem(radius, r, g, n, s, kb))
