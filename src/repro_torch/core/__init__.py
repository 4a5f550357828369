# The paper's primary contribution: the VectorMesh scheduling methodology as a
# composable library — NDRange tensor-op formulation (Eq. 1-3), bandwidth-
# minimizing output-stationary tiling (Eq. 4), FIFO-mesh data-exchange analysis
# (Fig. 2), and the BFN conflict-free access condition (§II-C) — plus the
# bridge that turns schedules into the tiles and grid orders of the
# hand-written Hopper kernels (``cuda_bridge``).
from .ndrange import (
    AffineExpr,
    Dim,
    OperandView,
    TensorOp,
    PARALLEL,
    TEMPORAL,
    attention_scores_op,
    conv2d_op,
    correlation_op,
    depthwise_conv2d_op,
    matmul_op,
)
from .tiling import (
    BufferSpec,
    TEU_BUFFER,
    VMEM_BUFFER,
    TileSchedule,
    TrafficReport,
    schedule_for,
    search_tiles,
    search_tiles_reference,
    tile_fits,
    traffic,
)
from .exchange import (
    ExchangePlan,
    GridOrder,
    grid_fetch_bytes,
    order_grid_for_sharing,
    order_grid_for_sharing_reference,
    plan_mesh_exchange,
    plan_mesh_exchange_reference,
)
from .autotune import cache_stats, clear_cache, op_signature
from . import bfn, cuda_bridge
from .cuda_bridge import KernelPlan, matmul_block_shapes, plan_kernel

__all__ = [
    "AffineExpr", "Dim", "OperandView", "TensorOp", "PARALLEL", "TEMPORAL",
    "attention_scores_op", "conv2d_op", "correlation_op",
    "depthwise_conv2d_op", "matmul_op",
    "BufferSpec", "TEU_BUFFER", "VMEM_BUFFER", "TileSchedule",
    "TrafficReport", "schedule_for", "search_tiles",
    "search_tiles_reference", "tile_fits", "traffic",
    "ExchangePlan", "GridOrder", "grid_fetch_bytes", "order_grid_for_sharing",
    "order_grid_for_sharing_reference", "plan_mesh_exchange",
    "plan_mesh_exchange_reference",
    "cache_stats", "clear_cache", "op_signature",
    "bfn", "cuda_bridge", "KernelPlan", "matmul_block_shapes", "plan_kernel",
]
