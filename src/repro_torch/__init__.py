"""PyTorch / CUDA port of ``repro`` for NVIDIA Hopper (sm_90a).

Mirrors the layout of the JAX reference package, module for module, and
imports nothing from it.  Entry points run on the CUDA card unless the
caller passes ``device="cpu"`` (see :mod:`repro_torch.device`).

Importing the package loads no tensor library: the host-side control
modules (``launch.supervisor``, ``runtime.supervisor``, ``runtime.chaos``)
stay torch-free, and ``resolve_device`` is loaded on first use.
"""
__all__ = ["resolve_device"]


def __getattr__(name):
    if name == "resolve_device":
        from .device import resolve_device
        return resolve_device
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
