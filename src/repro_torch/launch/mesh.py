"""Meshes for the launchers: functions, not module constants, so importing
this file touches no device and no process group.  Counterpart of
``repro.launch.mesh``."""
from __future__ import annotations

import math

from repro_torch.parallel.mesh import Mesh, make_mesh, make_process_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over the ranks of the
    initialised process group (a state placed on it trains and serves
    through ``parallel.sharding.shard_tree``).  Refuses unless the group
    has exactly those ranks (256 or 512): the multi-host launch that
    starts them, one a card, is not ported yet."""
    import torch.distributed as dist
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise RuntimeError(
            f"the production mesh {shape} {axes} needs a process group of "
            f"{need} ranks, one a card; this process has "
            f"{have or 'no process group'}. Start the processes with "
            f"torch.distributed first (the multi-host launch is not "
            f"ported yet), or use make_local_mesh / a mesh of local rings")
    return make_process_mesh(shape, axes)


def make_local_mesh() -> Mesh:
    """A (1, 1) ("data", "model") mesh (CPU tests, one card)."""
    return make_mesh((1, 1), ("data", "model"))


def make_worker_mesh() -> Mesh:
    """A (1, 1) ("data", "model") mesh for THIS process's work, on its own
    card: with a process group up and cards present, card ``rank %
    device_count`` becomes the current one (``torch.cuda.set_device``), so
    the entry points' default device (``device.resolve_device``: the
    current card) lands there.  A fleet worker must not take process 0's
    card."""
    import torch
    import torch.distributed as dist
    if dist.is_initialized() and torch.cuda.is_available():
        torch.cuda.set_device(dist.get_rank() % torch.cuda.device_count())
    return make_local_mesh()
