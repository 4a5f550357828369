"""The paper's workload catalog (Table I + modern + spatial matching + GEMM)
at its own shapes, as NDRange tensor ops: a copy of the JAX package's
``sim/workloads.py``.  ``chip_smoke.py`` runs every catalog workload that a
kernel computes through ``repro_torch.kernels.ops`` on the card.  The cycle
models (``simulator.py``, ``archs.py``) are not ported yet."""
from . import workloads
from .workloads import ALL, CLASSIC, GEMM, MODERN, SPATIAL, Workload, by_name

__all__ = ["workloads", "ALL", "CLASSIC", "GEMM", "MODERN", "SPATIAL",
           "Workload", "by_name"]
