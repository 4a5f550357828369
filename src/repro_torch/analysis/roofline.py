"""Roofline analysis of counted steps and kernels (NVIDIA H100 targets).

Counterpart of ``repro.analysis.roofline``.  The card's constants live here
once for the whole port: datasheet figures of one NVIDIA H100 80GB HBM3
(SXM) at its 700 W power limit, dense rates without sparsity.  A card set
below 700 W (``nvidia-smi --query-gpu=power.limit``) runs slower under
load, so every share of these peaks is stated beside the card's limit.

Three terms per (arch x shape x mesh), as the reference's:
    compute    = flops / (cards * 989e12 bf16 FLOP/s)
    memory     = bytes / (cards * 3.35e12 B/s HBM3)
    collective = collective_bytes / (cards * 450e9 B/s NVLink, each way)

Flops, bytes and collective bytes come from the op cost counter
(``analysis.op_cost``), which counts each aten op by its operands and each
hand-written kernel by its own work (``analysis.kernel_work``).
MODEL_FLOPS = 6*N*D (dense) or 6*N_active*D (MoE) per step gives the
useful-compute ratio (catches recompute and redundancy).
"""
from __future__ import annotations

import dataclasses
from collections.abc import Mapping

import torch

PEAK_FLOPS = 989e12          # bf16 (and fp16) tensor cores, per card
PEAK_INT8_OPS = 1979e12      # int8 tensor cores, per card
PEAK_F32_FLOPS = 67e12       # f32 outside the tensor cores, per card
HBM_BW = 3.35e12             # bytes/s per card
NVLINK_BW = 450e9            # bytes/s per card, one direction

COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
               "collective-permute")


def peak_ops(dtype: torch.dtype | str) -> float:
    """The card's peak rate for products of ``dtype``: the bf16 tensor
    cores for bf16 (and fp16), int8's for int8, and the CUDA cores' f32
    rate for anything else."""
    name = str(dtype).split(".")[-1]
    if name in ("bfloat16", "float16", "bf16", "fp16"):
        return PEAK_FLOPS
    if name in ("int8", "i8"):
        return PEAK_INT8_OPS
    return PEAK_F32_FLOPS


def bound(bytes_: float, ops: float, peak: float) -> tuple[float, str]:
    """(ms, "bytes" | "operations"): the least time one card takes to move
    ``bytes_`` at the HBM rate and to do ``ops`` at ``peak``, the larger
    of the two, with the term that sets it."""
    t_bytes, t_ops = bytes_ / HBM_BW * 1e3, ops / peak * 1e3
    return (t_bytes, "bytes") if t_bytes >= t_ops else (t_ops, "operations")


def collective_bytes(collectives: Mapping[str, float] | object
                     ) -> dict[str, int]:
    """Bytes of each collective kind (the reference's five, plus any other
    kind counted) from the counter's ``collectives`` (a ``Cost`` or its
    dict): the bytes each collective delivers, summed over the ranks."""
    counted = getattr(collectives, "collectives", collectives)
    out = {c: 0 for c in COLLECTIVES}
    for k, v in counted.items():
        out[k] = out.get(k, 0) + int(v)
    return out


@dataclasses.dataclass(frozen=True)
class RooflineReport:
    arch: str
    shape: str
    mesh: str
    chips: int
    hlo_flops: float
    hlo_bytes: float
    coll_bytes: float
    coll_breakdown: dict[str, int]
    model_flops: float
    bytes_per_device: float     # peak device memory of the step
    model_bytes: float = 0.0    # analytic HBM traffic floor (global)

    @property
    def t_compute(self) -> float:
        return self.hlo_flops / (self.chips * PEAK_FLOPS)

    @property
    def t_memory(self) -> float:
        return self.hlo_bytes / (self.chips * HBM_BW)

    @property
    def t_collective(self) -> float:
        return self.coll_bytes / (self.chips * NVLINK_BW)

    @property
    def dominant(self) -> str:
        terms = {"compute": self.t_compute, "memory": self.t_memory,
                 "collective": self.t_collective}
        return max(terms, key=terms.get)

    @property
    def useful_flops_ratio(self) -> float:
        return self.model_flops / max(1.0, self.hlo_flops)

    @property
    def t_model_min(self) -> float:
        """Theoretical floor: max of the model's compute time at peak and
        its minimum HBM traffic at full bandwidth (decode shapes are
        memory-floor-bound; train shapes compute-floor-bound)."""
        return max(self.model_flops / (self.chips * PEAK_FLOPS),
                   self.model_bytes / (self.chips * HBM_BW))

    @property
    def roofline_frac(self) -> float:
        """useful work / the time the dominant term implies at peak."""
        t = max(self.t_compute, self.t_memory, self.t_collective)
        if t <= 0:
            return 0.0
        return self.t_model_min / t

    def row(self) -> dict:
        return {
            "arch": self.arch, "shape": self.shape, "mesh": self.mesh,
            "chips": self.chips,
            "hlo_gflops": self.hlo_flops / 1e9,
            "hlo_gbytes": self.hlo_bytes / 1e9,
            "coll_gbytes": self.coll_bytes / 1e9,
            "t_compute_ms": self.t_compute * 1e3,
            "t_memory_ms": self.t_memory * 1e3,
            "t_collective_ms": self.t_collective * 1e3,
            "dominant": self.dominant,
            "model_gflops": self.model_flops / 1e9,
            "useful_ratio": self.useful_flops_ratio,
            "roofline_frac": self.roofline_frac,
            "hbm_gb_per_device": self.bytes_per_device / 1e9,
            "coll_breakdown": {k: v for k, v in
                               self.coll_breakdown.items() if v},
        }


def model_flops_train(n_active_params: int, tokens: int) -> float:
    return 6.0 * n_active_params * tokens


def model_flops_decode(n_active_params: int, tokens: int,
                       kv_read_flops: float = 0.0) -> float:
    return 2.0 * n_active_params * tokens + kv_read_flops
