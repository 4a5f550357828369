"""Faithful reproduction of the paper's evaluation: cycle-approximate models
of VectorMesh / TPU / Eyeriss on the paper's workloads (Table I + modern +
spatial matching), producing Table III traffic numbers and Fig. 3/4
rooflines from the copied scheduler (``repro_torch.core``).  Copies of the
JAX package's ``sim/archs.py``, ``sim/simulator.py`` and
``sim/workloads.py``; ``chip_smoke.py`` runs every catalog workload that a
kernel computes through ``repro_torch.kernels.ops`` on the card."""
from . import archs, simulator, workloads
from .archs import ArchConfig, eyeriss, tpu, vectormesh
from .simulator import SimResult, roofline_gmacs, simulate, summarize
from .workloads import ALL, CLASSIC, GEMM, MODERN, SPATIAL, Workload, by_name

__all__ = [
    "archs", "simulator", "workloads",
    "ArchConfig", "eyeriss", "tpu", "vectormesh",
    "SimResult", "roofline_gmacs", "simulate", "summarize",
    "ALL", "CLASSIC", "GEMM", "MODERN", "SPATIAL", "Workload", "by_name",
]
