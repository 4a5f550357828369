"""Analysis of the port's work: the card's roofline constants and
reports (``roofline``), each hand-written kernel's work
(``kernel_work``) and the op cost counter (``op_cost``).  Counterpart of
``repro.analysis``; ``op_cost`` takes the place of ``hlo_cost``."""
from .kernel_work import Work, attended_pairs
from .op_cost import Cost, CostMode, count
from .roofline import (HBM_BW, NVLINK_BW, PEAK_F32_FLOPS, PEAK_FLOPS,
                       PEAK_INT8_OPS, RooflineReport, bound,
                       collective_bytes, model_flops_decode,
                       model_flops_train, peak_ops)

__all__ = ["HBM_BW", "NVLINK_BW", "PEAK_FLOPS", "PEAK_INT8_OPS",
           "PEAK_F32_FLOPS", "RooflineReport", "bound", "collective_bytes",
           "model_flops_decode", "model_flops_train", "peak_ops", "Work",
           "attended_pairs", "Cost", "CostMode", "count"]
