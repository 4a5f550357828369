"""Pipeline parallelism over the ``pod`` axis (GPipe microbatching).
Counterpart of ``repro.parallel.pipeline``.

When training is layer-bound rather than data-bound, the ``pod`` axis can
carry pipeline STAGES: the layer stack is split into ``n_stages``
contiguous stages, microbatches stream through, and activations hop stage
to stage with ``Transport.shift``, one more form of the paper's neighbour
FIFO (the stage handoff).  The GPipe schedule runs ``n_micro + n_stages -
1`` ticks; the bubble is (n_stages - 1) / (n_micro + n_stages - 1).
"""
from __future__ import annotations

from typing import Any, Callable

import torch

from ..optim.adamw import tree_map
from .mesh import Mesh

__all__ = ["pipeline_forward"]


def _split_stages(ring, stage_params) -> list:
    """One params tree per stage this process holds: each leaf's leading
    axis runs over the stages held (all of them under a ``LocalRing``, one
    under a ``ProcessRing``)."""
    return [tree_map(lambda a, j=j: ring.split(a, 0)[j][0], stage_params)
            for j in range(len(ring.index()))]


def pipeline_forward(stage_fn: Callable[[Any, torch.Tensor], torch.Tensor],
                     stage_params: Any, x_micro: torch.Tensor, mesh: Mesh,
                     axis: str = "pod") -> torch.Tensor:
    """Run microbatches through the pipeline stages laid along ``axis``.

    stage_fn(params_for_stage, x) -> x: one stage's computation.
    stage_params: a dict tree whose leaves have a leading axis over the
        stages this process holds (``n_stages`` under a ``LocalRing``, 1
        under a ``ProcessRing``).
    x_micro: (n_micro, mb, ...) microbatched input, the same on every
        stage.

    Returns the (n_micro, mb, ...) outputs of the last stage, summed over
    the axis (``all_sum``) so that every stage holds them."""
    ring = mesh.transport(axis)
    n_stages = ring.size
    params = _split_stages(ring, stage_params)
    n_micro = x_micro.shape[0]
    inflight = [torch.zeros_like(x_micro[0]) for _ in params]
    emitted: list[list] = [[] for _ in params]
    for t in range(n_micro + n_stages - 1):
        ys = []
        for j, stage in enumerate(ring.index()):
            # stage 0 consumes fresh input; the others the handoff
            x_in = x_micro[min(t, n_micro - 1)] if stage == 0 \
                else inflight[j]
            y = stage_fn(params[j], x_in)
            # the last stage emits a finished microbatch from tick S - 1
            if t >= n_stages - 1 and stage == n_stages - 1:
                emitted[j].append(y.to(x_micro.dtype))
            ys.append(y)
        (inflight,) = ring.shift(ys)     # the FIFO hop to the next stage
    outs = [torch.stack(e) if e else torch.zeros_like(x_micro)
            for e in emitted]
    return ring.all_sum(outs)[0]
