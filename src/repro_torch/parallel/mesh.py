"""Named device meshes and their rings: the port's counterpart of the
reference's ``compat.make_mesh`` / ``compat.set_mesh`` /
``compat.get_abstract_mesh`` and of the collectives its shard_map bodies
call (``jax.lax.ppermute``, ``psum``, ``axis_index``).

A :class:`Mesh` names its axes (``"pod"``, ``"data"``, ``"model"``) and
gives each a *transport*, the ring its ranks form, with three operations:

  * ``shift(*xs)``: the ``ppermute`` hop, rank ``i`` -> rank ``i + 1``
    (mod the axis size), of one or more values at once;
  * ``all_sum(x)``: the ``psum`` over the axis;
  * ``index()``: the ``axis_index`` of each rank this process holds.

A ring body is written once over these.  Its state is a list with one
entry for each rank this process holds, so the same body runs on both
transports:

  * :class:`LocalRing` holds all ``m`` ranks of the axis in one process,
    on one device: an entry per rank.  A hop rotates the list, so on one
    card a hop moves no bytes; the ranks run one after another.
  * :class:`ProcessRing` holds one rank per process: a one-entry list, and
    a hop sends to rank ``r + 1`` and receives from rank ``r - 1`` of the
    axis's process group (``torch.distributed`` point-to-point: gloo on
    the CPU, NCCL on the card).

``split(x, dim)`` turns a tensor into that list and ``join(xs, dim)`` back:
a :class:`LocalRing` cuts a global tensor into its ``m`` shards along
``dim`` and concatenates them again; a :class:`ProcessRing` is handed this
rank's shard and returns it as it is.  A value that is per rank rather
than a shard of one tensor (a pipeline stage's parameters, a rank's
gradient) carries a leading axis over the ranks held, which ``split(x,
0)`` cuts.

``set_mesh(mesh)`` makes a mesh the active one for a ``with`` block and
:func:`get_mesh` reads it (a context variable: each thread, and each
autograd recompute, sees the mesh it was given; ``models.layers.remat_call``
carries the forward's mesh into its recompute).
"""
from __future__ import annotations

import contextlib
import contextvars
import math
from collections.abc import Iterator, Sequence

import torch

__all__ = ["Mesh", "LocalRing", "ProcessRing", "make_mesh",
           "make_process_mesh", "set_mesh", "get_mesh"]


class LocalRing:
    """An axis of ``size`` ranks held by one process on one device.  Each
    rank's state is an entry of a list; :meth:`shift` rotates the list (no
    copy: on one card a hop moves no bytes), :meth:`all_sum` adds the
    entries in rank order.  ``hops`` counts the shifts."""

    def __init__(self, size: int):
        if size < 1:
            raise ValueError(f"a ring needs at least one rank, got {size}")
        self.size = size
        self.hops = 0

    def index(self) -> list[int]:
        return list(range(self.size))

    def split(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks")
        return list(x.chunk(self.size, dim))

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0] if len(xs) == 1 else torch.cat(list(xs), dim)

    def shift(self, *xs: list) -> tuple[list, ...]:
        """Each argument is a per-rank list; rank i's entry moves to rank
        i + 1."""
        self.hops += 1
        return tuple([x[-1], *x[:-1]] for x in xs)

    def all_sum(self, xs: list) -> list:
        total = xs[0]
        for x in xs[1:]:
            total = total + x
        return [total] * self.size


class ProcessRing:
    """An axis whose ranks are processes: this process holds one rank of
    ``group`` (default: the whole world).  :meth:`shift` sends this rank's
    entries to rank ``r + 1`` of the group and receives rank ``r - 1``'s
    into fresh buffers (``dist.batch_isend_irecv``; group ranks translated
    to global ranks with ``dist.get_global_rank``); :meth:`all_sum` is
    ``dist.all_reduce``.  ``hops`` counts the shifts."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessRing needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.hops = 0

    def _global(self, r: int) -> int:
        import torch.distributed as dist
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    def index(self) -> list[int]:
        return [self.rank]

    def split(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [x]

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def shift(self, *xs: list) -> tuple[list, ...]:
        import torch.distributed as dist
        self.hops += 1
        if self.size == 1:
            return xs
        dst = self._global((self.rank + 1) % self.size)
        src = self._global((self.rank - 1) % self.size)
        sends = [x[0].contiguous() for x in xs]
        outs = [torch.empty_like(s) for s in sends]
        ops = [dist.P2POp(dist.isend, s, dst, self.group) for s in sends]
        ops += [dist.P2POp(dist.irecv, o, src, self.group) for o in outs]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        return tuple([o] for o in outs)

    def all_sum(self, xs: list) -> list:
        import torch.distributed as dist
        total = xs[0].clone()
        dist.all_reduce(total, group=self.group)
        return [total]


class Mesh:
    """Named axes with their sizes (``shape``, a dict as the reference's
    ``mesh.shape``) and a transport each (a :class:`LocalRing` unless
    ``transports`` names another).  A mesh places nothing: a local ring's
    shards live wherever its tensors are."""

    def __init__(self, shape: Sequence[int], axis_names: Sequence[str],
                 transports: dict | None = None):
        if len(shape) != len(axis_names):
            raise ValueError(f"mesh shape {tuple(shape)} and axes "
                             f"{tuple(axis_names)} differ in length")
        self.axis_names = tuple(axis_names)
        self.shape = dict(zip(self.axis_names, (int(n) for n in shape)))
        self.transports = {a: LocalRing(n) for a, n in self.shape.items()}
        self.transports.update(transports or {})
        for a, t in self.transports.items():
            if t.size != self.shape[a]:
                raise ValueError(f"axis {a!r} has {self.shape[a]} ranks, "
                                 f"its transport {t.size}")

    def transport(self, axis: str):
        return self.transports[axis]

    def __repr__(self) -> str:
        kinds = {a: type(t).__name__ for a, t in self.transports.items()}
        return f"Mesh({self.shape}, {kinds})"


def make_mesh(shape: Sequence[int], axis_names: Sequence[str]) -> Mesh:
    """A mesh of local rings: every rank of every axis in this process."""
    return Mesh(shape, axis_names)


def make_process_mesh(shape: Sequence[int],
                      axis_names: Sequence[str]) -> Mesh:
    """A mesh over the ranks of the initialised process group, laid out
    row-major over ``shape`` (which must multiply to the world size): each
    axis of more than one rank gets a :class:`ProcessRing` over the ranks
    that differ only in that axis's coordinate.  Every process must call
    this, in the same order (``dist.new_group`` is collective)."""
    import torch.distributed as dist
    world = dist.get_world_size()
    if math.prod(shape) != world:
        raise ValueError(f"mesh shape {tuple(shape)} needs "
                         f"{math.prod(shape)} processes, the group has "
                         f"{world}")
    me = dist.get_rank()
    grid = torch.arange(world).reshape(tuple(shape))
    transports = {}
    for ax, (name, n) in enumerate(zip(axis_names, shape)):
        if n == 1:
            continue
        mine = None
        # one group per line of ranks along the axis
        for ranks in grid.movedim(ax, -1).reshape(-1, n).tolist():
            g = dist.new_group(ranks)
            if me in ranks:
                mine = g
        transports[name] = ProcessRing(mine)
    return Mesh(shape, axis_names, transports)


_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_mesh", default=None)


@contextlib.contextmanager
def set_mesh(mesh: Mesh | None) -> Iterator[Mesh | None]:
    """Make ``mesh`` the active mesh inside the ``with`` block."""
    token = _ACTIVE.set(mesh)
    try:
        yield mesh
    finally:
        _ACTIVE.reset(token)


def get_mesh() -> Mesh | None:
    """The active mesh (:func:`set_mesh`), or None."""
    return _ACTIVE.get()
