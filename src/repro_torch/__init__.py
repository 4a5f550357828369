"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (sm_90a).

Mirrors the layout of the JAX reference package, module for module, and
imports nothing from it.  This slice covers the serving path:
``launch.serve`` -> ``serving.engine`` -> ``models.transformer``
(``prefill`` / ``decode_step`` / ``paged_step``) -> the two hand-written
CUDA kernels in ``kernels/csrc`` (flash forward, paged decode).

Entry points run on the CUDA card unless the caller passes
``device="cpu"`` (see :mod:`repro_torch.device`).
"""
from .device import resolve_device

__all__ = ["resolve_device"]
