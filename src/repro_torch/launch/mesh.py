"""Meshes for the launchers: functions, not module constants, so importing
this file touches no device and no process group.  Counterpart of
``repro.launch.mesh``.

A production mesh is one process a rank, as PyTorch runs a multi-card
job (``torchrun --nproc-per-node N``): where the reference's single
controller sees every chip, each process here holds its rank's shards and
drives its own card, ``LOCAL_RANK % device_count``
(:func:`set_local_card`).  The process group's backend follows one rule,
decided before the group forms (:func:`process_group_backend`): ``nccl``
where every local rank has a card of its own, ``gloo`` on the CPU and on
a card that several local ranks share."""
from __future__ import annotations

import datetime
import math
import os

from repro_torch.parallel.mesh import Mesh, make_mesh, make_process_mesh

PRODUCTION_SHAPES = {False: ((16, 16), ("data", "model")),
                     True: ((2, 16, 16), ("pod", "data", "model"))}
# what torchrun sets in each process it starts (``env://``)
TORCHRUN_ENV = ("RANK", "WORLD_SIZE", "LOCAL_RANK", "LOCAL_WORLD_SIZE",
                "MASTER_ADDR", "MASTER_PORT")
JOIN_TIMEOUT_S = 300.0


def process_group_backend(device, local_world_size: int,
                          device_count: int) -> str:
    """``nccl`` when the run's device is a CUDA card and each of the
    ``local_world_size`` ranks on this host has a card of its own
    (``local_world_size <= device_count``); ``gloo`` on the CPU, and on a
    card shared by several local ranks (NCCL refuses two ranks of one
    communicator on one card)."""
    import torch
    if torch.device(device).type == "cuda" and \
            local_world_size <= device_count:
        return "nccl"
    return "gloo"


def set_local_card(local_rank: int) -> int | None:
    """Make card ``local_rank % device_count`` the current one (before the
    process group forms, so NCCL and the entry points' default device
    land there); None without a card."""
    import torch
    if not torch.cuda.is_available():
        return None
    card = local_rank % torch.cuda.device_count()
    torch.cuda.set_device(card)
    return card


def _production_error(shape, axes, need: int, have) -> RuntimeError:
    return RuntimeError(
        f"the production mesh {shape} {axes} needs a process group of "
        f"{need} ranks, one a card; this process has "
        f"{have or 'no process group'}. Start one process a rank with "
        f"torchrun (e.g. torchrun --nnodes H --nproc-per-node N -m "
        f"repro_torch.launch.train --mesh single), or use make_local_mesh "
        f"/ a mesh of local rings")


def join_production_group(device, *, multi_pod: bool = False) -> str:
    """Join the process group from torchrun's environment
    (:data:`TORCHRUN_ENV`, ``init_method="env://"``), on the backend
    :func:`process_group_backend` picks for ``device`` (``"cpu"`` or
    ``"cuda"``), after making this rank's card current; returns the
    backend.  Without those variables it raises the production mesh's
    error.  A failure to join is fatal: a production run never falls back
    to a local mesh or another backend."""
    import torch
    import torch.distributed as dist
    missing = [k for k in TORCHRUN_ENV if k not in os.environ]
    if missing:
        shape, axes = PRODUCTION_SHAPES[multi_pod]
        raise _production_error(shape, axes, math.prod(shape), None)
    if torch.device(device).type == "cuda":
        set_local_card(int(os.environ["LOCAL_RANK"]))
    backend = process_group_backend(
        device, int(os.environ["LOCAL_WORLD_SIZE"]),
        torch.cuda.device_count() if torch.cuda.is_available() else 0)
    dist.init_process_group(
        backend, init_method="env://",
        timeout=datetime.timedelta(seconds=JOIN_TIMEOUT_S))
    return backend


def make_production_mesh(*, multi_pod: bool = False) -> Mesh:
    """The (16, 16) ("data", "model") mesh, or with ``multi_pod`` the
    (2, 16, 16) ("pod", "data", "model") one, over the ranks of the
    initialised process group (a state placed on it trains and serves
    through ``parallel.sharding.shard_tree``).  Refuses unless the group
    has exactly those ranks (256 or 512), and names them."""
    import torch.distributed as dist
    shape, axes = PRODUCTION_SHAPES[multi_pod]
    need = math.prod(shape)
    have = dist.get_world_size() if dist.is_initialized() else 0
    if have != need:
        raise _production_error(shape, axes, need, have)
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
