"""Named device meshes and their rings: the port's counterpart of the
reference's ``compat.make_mesh`` / ``compat.set_mesh`` /
``compat.get_abstract_mesh`` and of the collectives its shard_map bodies
call (``jax.lax.ppermute``, ``psum``, ``all_to_all``, ``axis_index``).

A :class:`Mesh` names its axes (``"pod"``, ``"data"``, ``"model"``) and
gives each a *transport*, the ring its ranks form, with four operations:

  * ``shift(*xs)``: the ``ppermute`` hop, rank ``i`` -> rank ``i + 1``
    (mod the axis size), of one or more values at once;
  * ``all_sum(x)``: the ``psum`` over the axis;
  * ``all_to_all(xs)``: the tiled ``all_to_all`` on dim 0 (``split_axis=0,
    concat_axis=0``): each rank cuts its entry into ``size`` chunks, and
    rank ``j`` receives chunk ``j`` of every rank in rank order (the MoE's
    expert exchange, ``models.layers.moe_ep_local``);
  * ``all_gather(xs, dim)``: every rank's entry, concatenated along
    ``dim`` in rank order, for every rank (the tiled ``all_gather``: the
    head-split attention's projections, a sequence-sharded residual
    gathered at a block's entry, a placed tree gathered whole); its
    backward is the reduce-scatter of the ranks' cotangents;
  * ``reduce_scatter(xs, dim)``: the entries' sum, each rank receiving
    its chunk along ``dim`` (``psum_scatter``: a row-parallel partial sum
    landing on a sequence-sharded residual); its backward is the
    all-gather of the chunks' cotangents;
  * ``index()``: the ``axis_index`` of each rank this process holds.

A ring body is written once over these.  Its state is a list with one
entry for each rank this process holds, so the same body runs on both
transports:

  * :class:`LocalRing` holds all ``m`` ranks of the axis in one process,
    on one device: an entry per rank.  A hop rotates the list and an
    all-to-all transposes it, so on one card neither moves bytes between
    ranks; the ranks run one after another.
  * :class:`ProcessRing` holds one rank per process: a one-entry list, and
    a hop sends to rank ``r + 1`` and receives from rank ``r - 1`` of the
    axis's process group (``torch.distributed`` point-to-point); an
    all-to-all is ``dist.all_to_all_single``, an all-gather
    ``dist.all_gather_into_tensor``, a reduce-scatter
    ``dist.reduce_scatter_tensor``.  On NCCL (a card a rank) every op
    carries CUDA tensors as they are.  On gloo (the CPU, or a card that
    several ranks share) the collectives do too, but gloo refuses a
    point-to-point send of a CUDA tensor, so the hop is *staged*: the ring
    copies each CUDA tensor to pinned host memory, sends it from there and
    copies what it receives back.  Whether the hop is staged is fixed by
    the group's backend when the ring is built, and its bytes are counted
    (``ProcessRing.staged``, and ``op_cost.collective("host-staging")``).

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

from ..analysis.op_cost import collective

__all__ = ["Mesh", "LocalRing", "ProcessRing", "make_mesh",
           "make_process_mesh", "set_mesh", "get_mesh"]


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


def _narrow(dtype: torch.dtype) -> bool:
    """A float of fewer than 32 bits, which a sum takes in f32."""
    return dtype.is_floating_point and torch.finfo(dtype).bits < 32


class _LocalCopy(torch.autograd.Function):
    """``n`` views of ``x``, one for each rank a local ring holds, whose
    cotangents are summed in rank order (a 16-bit float in f32, rounded
    once) as a process ring's ``all_reduce`` sums them: each rank's own
    uses of its view accumulate first, so a local ring's gradients equal
    a process ring's bit for bit (a 2-rank sum is order-free).  The
    backward counts as the all-reduce it would be between cards."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, n: int):
        return tuple(x.view_as(x) for _ in range(n))

    @staticmethod
    def backward(ctx, *gs):
        collective("all-reduce", len(gs) * _nbytes(gs[0]))
        return _sum_in_order(gs).to(gs[0].dtype), None


def local_copies(x: torch.Tensor, n: int) -> list[torch.Tensor]:
    """``x`` for each of the ``n`` ranks of a local ring
    (:class:`_LocalCopy`: their cotangents summed as a process ring's)."""
    return [x] if n == 1 else list(_LocalCopy.apply(x, n))


class LocalRing:
    """An axis of ``size`` ranks held by one process on one device.  Each
    rank's state is an entry of a list; :meth:`shift` rotates the list (no
    copy: on one card a hop moves no bytes), :meth:`all_sum` adds the
    entries in rank order, :meth:`all_to_all` transposes it.  ``hops``
    counts the shifts."""

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
        i + 1.  An op cost counter counts the hop as the
        ``collective-permute`` it would be between cards: every entry's
        bytes (none on a ring of one)."""
        self.hops += 1
        if self.size > 1:
            collective("collective-permute",
                       sum(_nbytes(t) for x in xs for t in x))
        return tuple([x[-1], *x[:-1]] for x in xs)

    def all_sum(self, xs: list) -> list:
        """The entries' sum, for every rank, added in rank order (a 16-bit
        float in f32, rounded once: the reference's ``psum`` of bf16
        gives that); counted as the ``all-reduce`` it would be between
        cards (the sum's bytes at every rank)."""
        if self.size > 1:
            collective("all-reduce", self.size * _nbytes(xs[0]))
        return [_sum_in_order(xs).to(xs[0].dtype)] * self.size

    def all_to_all(self, xs: list) -> list:
        """Rank ``j``'s entry becomes chunk ``j`` (of ``size`` along dim 0)
        of every rank's entry, concatenated in rank order: a transpose of
        the list, which autograd carries.  Counted as the ``all-to-all`` it
        would be between cards: every rank's received bytes, as the
        reference's cost model counts an all-to-all's output."""
        n = self.size
        if xs[0].shape[0] % n:
            raise ValueError(f"dim 0 of {tuple(xs[0].shape)} does not split "
                             f"over {n} ranks")
        if n == 1:
            return list(xs)
        collective("all-to-all", sum(_nbytes(t) for t in xs))
        parts = [x.chunk(n, 0) for x in xs]
        return [torch.cat([p[j] for p in parts], 0) for j in range(n)]

    def all_gather(self, xs: list, dim: int) -> list:
        """The entries concatenated along ``dim`` in rank order, for every
        rank: views of one tensor (:class:`_LocalGather`), each rank's
        entry getting its slice of the cotangents summed over the ranks
        (the reduce-scatter a process ring's backward runs).  Counted as
        the ``all-gather`` it would be between cards: the gathered bytes
        at every rank."""
        if self.size == 1:
            return list(xs)
        return list(_LocalGather.apply(dim, *xs))

    def reduce_scatter(self, xs: list, dim: int) -> list:
        """The entries' sum, added in rank order (a 16-bit float in f32,
        rounded once, as :meth:`all_sum`), rank ``j`` receiving chunk
        ``j`` of ``size`` along ``dim`` as a tensor of its own; each
        entry's cotangent is the chunks' cotangents joined
        (:class:`_LocalReduceScatter`).  Counted as the
        ``reduce-scatter`` it would be between cards: each rank's chunk."""
        if xs[0].shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(xs[0].shape)} does not "
                             f"split over {self.size} ranks")
        if self.size == 1:
            return list(xs)
        return list(_LocalReduceScatter.apply(dim, *xs))


def _sum_in_order(xs) -> torch.Tensor:
    """The tensors' sum in list order, a 16-bit float in f32 (not rounded:
    the caller rounds once)."""
    total = xs[0].float() if _narrow(xs[0].dtype) else xs[0]
    for x in xs[1:]:
        total = total + x
    return total


class _LocalGather(torch.autograd.Function):
    """A local ring's all-gather: the entries joined along ``dim``, one
    view of the joined tensor for each rank.  The backward is the
    reduce-scatter: the ranks' cotangents summed in rank order (a 16-bit
    float in f32, rounded once, as a process ring sums them), each entry
    its chunk; counted as the ``reduce-scatter`` it would be between
    cards."""

    @staticmethod
    def forward(ctx, dim: int, *xs):
        ctx.dim, ctx.n = dim, len(xs)
        total = torch.cat(xs, dim)
        collective("all-gather", ctx.n * _nbytes(total))
        return tuple(total.view_as(total) for _ in xs)

    @staticmethod
    def backward(ctx, *gs):
        collective("reduce-scatter", _nbytes(gs[0]))
        total = _sum_in_order(gs).to(gs[0].dtype)
        return (None, *total.chunk(ctx.n, ctx.dim))


class _LocalReduceScatter(torch.autograd.Function):
    """A local ring's reduce-scatter along ``dim``: the entries' sum (a
    16-bit float in f32, rounded once), each rank its chunk, contiguous.
    The backward is the all-gather: every entry's cotangent is the chunks'
    cotangents joined; counted as the ``all-gather`` it would be between
    cards."""

    @staticmethod
    def forward(ctx, dim: int, *xs):
        ctx.dim, ctx.n = dim, len(xs)
        collective("reduce-scatter", _nbytes(xs[0]))
        total = _sum_in_order(xs).to(xs[0].dtype)
        return tuple(c.contiguous() for c in total.chunk(ctx.n, dim))

    @staticmethod
    def backward(ctx, *gs):
        g = torch.cat(gs, ctx.dim)
        collective("all-gather", ctx.n * _nbytes(g))
        return (None, *([g] * ctx.n))


# gloo on CUDA tensors, by the card's probe (scripts/probe_gloo_cuda_torch.py;
# torch 2.11, one H100): all-reduce, all-gather and all-to-all give the
# right bf16 and f32 results; a point-to-point send of a device pointer
# ends the process (gloo::IoException, "writev: Bad address"), so a gloo
# ring stages its hop through pinned host memory (ProcessRing._send_recv);
# reduce_scatter_tensor gives the right bf16 and f32 results too (the
# probe's reduce_scatter_tensor rows)


class _AllSum(torch.autograd.Function):
    """``all_reduce`` into a copy (of a 16-bit float, in f32, rounded
    once, as the local ring sums; the c10d op then moves f32 bytes).  Its
    result is the same on every rank, and each rank's loss takes that
    replica with the same cotangent, so the backward hands this rank's
    gradient through unchanged: the transpose of the reference's ``psum``
    into a replicated value.  (A local ring's sum gives each entry that
    one gradient too.)"""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ring: "ProcessRing") -> torch.Tensor:
        total = x.float() if _narrow(x.dtype) else x.clone()
        ring.reduce_(total)
        return total.to(x.dtype)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g, None


class _AllToAll(torch.autograd.Function):
    """``all_to_all_single`` with equal splits on dim 0.  The exchange is
    its own inverse, so the backward sends the gradient the same way.
    The op cost counter sees the c10d op itself (``alltoall_base_``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ring: "ProcessRing") -> torch.Tensor:
        ctx.ring = ring
        out = torch.empty_like(x)
        ring.exchange_(out, x.contiguous())
        return out

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return _AllToAll.apply(g.contiguous(), ctx.ring), None


def _gather_fn(dist):
    """``dist.all_gather_into_tensor``, under the name a newer release
    gives it where it has one."""
    return getattr(dist, "all_gather_single", None) or \
        dist.all_gather_into_tensor


class _AllGather(torch.autograd.Function):
    """``all_gather_into_tensor`` of equal shards along ``dim``.  The
    gathered tensor feeds this rank's own computation, so the cotangent
    each rank holds is its part of the whole: the backward is the
    reduce-scatter of them (a 16-bit float in f32, rounded once), this
    rank's chunk of their sum, as the local ring's autograd does."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int,
                ring: "ProcessRing") -> torch.Tensor:
        ctx.dim, ctx.ring = dim, ring
        return ring.gather(x, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.ring.scatter_sum(g, ctx.dim), None, None


class _ReduceScatter(torch.autograd.Function):
    """``reduce_scatter_tensor`` along ``dim`` (a 16-bit float in f32,
    rounded once): this rank's chunk of the ranks' sum.  The chunk's
    cotangent is this rank's part of the whole, which every rank's
    partial fed: the backward is the all-gather of the chunks'
    cotangents."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int,
                ring: "ProcessRing") -> torch.Tensor:
        ctx.dim, ctx.ring = dim, ring
        return ring.scatter_sum(x, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.ring.gather(g, ctx.dim), None, None


class ProcessRing:
    """An axis whose ranks are processes: this process holds one rank of
    ``group`` (default: the whole world).  :meth:`shift` sends this rank's
    entries to rank ``r + 1`` of the group and receives rank ``r - 1``'s
    into fresh buffers (``dist.batch_isend_irecv``; group ranks translated
    to global ranks with ``dist.get_global_rank``); :meth:`all_sum` is
    ``dist.all_reduce``, :meth:`all_to_all` ``dist.all_to_all_single``,
    :meth:`all_gather` ``dist.all_gather_into_tensor``,
    :meth:`reduce_scatter` ``dist.reduce_scatter_tensor``.  Every c10d
    call of the port's mesh code goes through :meth:`reduce_`,
    :meth:`gather`, :meth:`scatter_sum`, :meth:`exchange_` or
    :meth:`shift`.  On gloo (``stages_hop``) the
    shift stages a CUDA tensor through pinned host memory; ``staged``
    counts the bytes it copied between the card and the host (both ways),
    ``hops`` the shifts."""

    def __init__(self, group=None):
        import torch.distributed as dist
        if not dist.is_initialized():
            raise RuntimeError("ProcessRing needs an initialised "
                               "torch.distributed process group")
        self.group = group
        self.size = dist.get_world_size(group)
        self.rank = dist.get_rank(group)
        self.backend = str(dist.get_backend(group))
        self.stages_hop = self.backend == "gloo"
        self.staged = 0
        self.hops = 0

    def _global(self, r: int) -> int:
        import torch.distributed as dist
        if self.group is None or self.group is dist.group.WORLD:
            return r
        return dist.get_global_rank(self.group, r)

    # -- the c10d calls

    def reduce_(self, t: torch.Tensor, op: str = "sum") -> torch.Tensor:
        """``t`` reduced over the group in place (``dist.all_reduce``;
        ``op`` 'sum', 'max' or 'min')."""
        import torch.distributed as dist
        red = {"sum": dist.ReduceOp.SUM, "max": dist.ReduceOp.MAX,
               "min": dist.ReduceOp.MIN}[op]
        dist.all_reduce(t, op=red, group=self.group)
        return t

    def gather(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """Every rank's ``x`` (of one shape) concatenated along ``dim`` in
        rank order (``dist.all_gather_into_tensor``), outside autograd."""
        import torch.distributed as dist
        moved = x.movedim(dim, 0).contiguous()
        out = moved.new_empty((self.size * moved.shape[0], *moved.shape[1:]))
        _gather_fn(dist)(out, moved, group=self.group)
        return out.movedim(0, dim)

    def scatter_sum(self, x: torch.Tensor, dim: int) -> torch.Tensor:
        """This rank's chunk along ``dim`` of the ranks' ``x`` (of one
        shape) summed, outside autograd: ``dist.reduce_scatter_tensor``
        (a 16-bit float summed in f32 and rounded once, as
        :meth:`LocalRing.all_sum`)."""
        import torch.distributed as dist
        if x.shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                             f"over {self.size} ranks")
        dt = x.dtype
        acc = x.float() if _narrow(dt) else x
        moved = acc.movedim(dim, 0).contiguous()
        out = moved.new_empty((moved.shape[0] // self.size,
                               *moved.shape[1:]))
        fn = getattr(dist, "reduce_scatter_single", None) or \
            dist.reduce_scatter_tensor
        fn(out, moved, group=self.group)
        return out.movedim(0, dim).to(dt).contiguous()

    def exchange_(self, out: torch.Tensor, x: torch.Tensor) -> torch.Tensor:
        """``dist.all_to_all_single`` of ``x`` into ``out`` (equal splits
        on dim 0)."""
        import torch.distributed as dist
        dist.all_to_all_single(out, x, group=self.group)
        return out

    def _stage(self, t: torch.Tensor) -> torch.Tensor:
        """A pinned host copy of the CUDA tensor ``t`` (its bytes counted
        as staged)."""
        h = torch.empty(t.shape, dtype=t.dtype, pin_memory=True)
        h.copy_(t)
        self._count(_nbytes(t))
        return h

    def _count(self, nbytes: int) -> None:
        self.staged += nbytes
        collective("host-staging", nbytes)

    def _send_recv(self, sends: list, outs: list, dst: int,
                   src: int) -> None:
        """Send ``sends`` to global rank ``dst`` and receive ``outs`` from
        ``src`` (``dist.batch_isend_irecv``), through pinned host copies
        on gloo."""
        import torch.distributed as dist
        stage = self.stages_hop and any(t.is_cuda for t in sends + outs)
        wire = [self._stage(s) for s in sends] if stage else sends
        recv = [torch.empty(o.shape, dtype=o.dtype, pin_memory=True)
                for o in outs] if stage else outs
        ops = [dist.P2POp(dist.isend, s, dst, self.group) for s in wire]
        ops += [dist.P2POp(dist.irecv, o, src, self.group) for o in recv]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
        if stage:
            for o, h in zip(outs, recv):
                o.copy_(h)
                self._count(_nbytes(h))

    # -- the transport's operations

    def index(self) -> list[int]:
        return [self.rank]

    def split(self, x: torch.Tensor, dim: int) -> list[torch.Tensor]:
        return [x]

    def join(self, xs: Sequence[torch.Tensor], dim: int) -> torch.Tensor:
        return xs[0]

    def shift(self, *xs: list) -> tuple[list, ...]:
        self.hops += 1
        if self.size == 1:
            return xs
        dst = self._global((self.rank + 1) % self.size)
        src = self._global((self.rank - 1) % self.size)
        sends = [x[0].contiguous() for x in xs]
        outs = [torch.empty_like(s) for s in sends]
        self._send_recv(sends, outs, dst, src)
        return tuple([o] for o in outs)

    def all_sum(self, xs: list) -> list:
        return [_AllSum.apply(xs[0], self)]

    def all_to_all(self, xs: list) -> list:
        """This rank's entry cut into ``size`` chunks on dim 0, chunk ``j``
        sent to rank ``j``; returns the chunks received, in rank order
        (``dist.all_to_all_single``; differentiable)."""
        if xs[0].shape[0] % self.size:
            raise ValueError(f"dim 0 of {tuple(xs[0].shape)} does not split "
                             f"over {self.size} ranks")
        if self.size == 1:
            return list(xs)
        return [_AllToAll.apply(xs[0], self)]

    def all_gather(self, xs: list, dim: int) -> list:
        """Every rank's entry (of one shape) concatenated along ``dim`` in
        rank order (``dist.all_gather_into_tensor``; differentiable: the
        backward is this rank's chunk of the cotangents summed over the
        ranks, a reduce-scatter).  The op cost counter sees the c10d op
        itself."""
        if self.size == 1:
            return list(xs)
        return [_AllGather.apply(xs[0], dim, self)]

    def reduce_scatter(self, xs: list, dim: int) -> list:
        """This rank's chunk along ``dim`` of the ranks' entries summed
        (:meth:`scatter_sum`; differentiable: the backward is the
        all-gather of the chunks' cotangents)."""
        if xs[0].shape[dim] % self.size:
            raise ValueError(f"dim {dim} of {tuple(xs[0].shape)} does not "
                             f"split over {self.size} ranks")
        if self.size == 1:
            return list(xs)
        return [_ReduceScatter.apply(xs[0], dim, self)]


class Mesh:
    """Named axes with their sizes (``shape``, a dict as the reference's
    ``mesh.shape``) and a transport each (a :class:`LocalRing` unless
    ``transports`` names another).  A mesh places nothing itself
    (``parallel.sharding.shard_tree`` places a tree on it): a local ring's
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
