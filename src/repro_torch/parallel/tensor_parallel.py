"""Megatron's conjugate operations over a mesh axis's transport, the
vocabulary-parallel embedding and loss terms, and the data axes' sums:
what a step on a placed state (``parallel.sharding.shard_tree``) needs
around its per-rank matmuls.

A ring body keeps two kinds of value.  A *replicated* one is a single
tensor, the same on every rank of the axis (the residual stream, the
loss); a *per-rank* one is a list with an entry for each rank the
process holds (``ring.index()``).  On a process ring every rank computes
the replicated values itself and holds the whole cotangent of each; a
per-rank value's cotangent is that rank's part.  The conjugates convert
between the two:

  * :func:`copy_to_model`: replicated -> per-rank; identity forward, the
    per-rank cotangents summed over the axis backward;
  * :func:`reduce_from_model`: per-rank partial sums -> replicated; the
    sum forward (a 16-bit float in f32, rounded once), identity backward;
  * :func:`gather_from_model`: per-rank pieces -> the replicated whole;
    gathered forward, each rank's slice of the cotangent backward;
  * :func:`gather_to_model`: per-rank pieces -> the whole for every rank's
    own use; gathered forward, the reduce-scatter of the cotangents
    backward (``ring.all_gather``; Megatron-SP's all-gather of sequence
    shards at a block's entry);
  * :func:`reduce_scatter_to_model`: per-rank partial sums -> each rank's
    chunk of the sum; reduce-scattered forward, the chunks' cotangents
    all-gathered backward (``ring.reduce_scatter``; Megatron-SP's
    row-parallel sum landing on the sequence-sharded residual);
  * :func:`scatter_to_model`: replicated -> each rank's chunk; cut
    forward, the chunks' cotangents all-gathered backward (a replicated
    input joining a sequence-sharded residual).

On a :class:`LocalRing` the ranks share the process and its autograd
graph: a replicated value is held once, and each rank uses its own view
of it (``mesh.local_copies``), whose cotangents are summed in f32 in rank
order, rounded once, as a process ring's all-reduce sums them, so a
local ring's bf16 gradients equal a process ring's bit for bit; the
other conjugates are the entries summed or joined.  Any replicated tensor
a rank uses for its own part (a normed activation, a router, a qk-norm
weight) passes :func:`copy_to_model` first, so on a process ring its
gradient is the whole too.
"""
from __future__ import annotations

import math
from collections.abc import Sequence

import torch

from ..analysis.op_cost import collective
from .mesh import LocalRing, _narrow, _nbytes, local_copies

DATA_AXES = ("pod", "data")


def model_ring(mesh):
    """The ``model`` axis's transport, or a ring of one rank."""
    if mesh is None or "model" not in mesh.axis_names:
        return LocalRing(1)
    return mesh.transport("model")


def _local(ring) -> bool:
    return isinstance(ring, LocalRing)


class _CopyToModel(torch.autograd.Function):
    """Identity forward; ``all_reduce`` of the cotangent backward (in f32
    for a 16-bit float, rounded once; ``ProcessRing.reduce_``)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, ring) -> torch.Tensor:
        ctx.ring = ring
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        total = g.float() if _narrow(g.dtype) else g.clone()
        ctx.ring.reduce_(total)
        return total.to(g.dtype), None


class _GatherFromModel(torch.autograd.Function):
    """``all_gather_into_tensor`` along ``dim`` forward; this rank's slice
    of the (whole, replicated) cotangent backward."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, ring) -> torch.Tensor:
        ctx.dim, ctx.rank, ctx.n = dim, ring.rank, x.shape[dim]
        return ring.gather(x, dim)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return g.narrow(ctx.dim, ctx.rank * ctx.n, ctx.n), None, None


def copy_to_model(x: torch.Tensor, ring) -> list[torch.Tensor]:
    """A replicated tensor as a per-rank list (on a local ring, views
    whose cotangents are summed as a process ring's: ``local_copies``)."""
    if ring.size == 1:
        return [x] * len(ring.index())
    if _local(ring):
        return local_copies(x, ring.size)
    return [_CopyToModel.apply(x, ring)]


def reduce_from_model(xs: Sequence[torch.Tensor], ring) -> torch.Tensor:
    """The per-rank partials' sum, replicated."""
    if len(xs) == 1 and ring.size == 1:
        return xs[0]
    return ring.all_sum(list(xs))[0]


def gather_from_model(xs: Sequence[torch.Tensor], ring,
                      dim: int) -> torch.Tensor:
    """The per-rank pieces joined along ``dim`` in rank order, replicated
    (a replicated consumer follows)."""
    if ring.size == 1:
        return xs[0]
    if _local(ring):
        out = torch.cat(list(xs), dim)
        collective("all-gather", ring.size * _nbytes(out))
        return out
    return _GatherFromModel.apply(xs[0], dim, ring)


def gather_to_model(xs: Sequence[torch.Tensor], ring,
                    dim: int) -> list[torch.Tensor]:
    """The per-rank pieces joined along ``dim``, for each rank's own use
    (``ring.all_gather``)."""
    return ring.all_gather(list(xs), dim)


def reduce_scatter_to_model(xs: Sequence[torch.Tensor], ring,
                            dim: int) -> list[torch.Tensor]:
    """The per-rank partials' sum, each held rank its chunk along ``dim``
    (``ring.reduce_scatter``: a chunk is bit-equal to the same rows of
    :func:`reduce_from_model`'s sum)."""
    return ring.reduce_scatter(list(xs), dim)


class _LocalScatter(torch.autograd.Function):
    """A replicated tensor's ``n`` chunks along ``dim`` on a local ring,
    each a tensor of its own; the backward joins the chunks' cotangents,
    counted as the ``all-gather`` it would be between cards."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, n: int):
        ctx.dim, ctx.n = dim, n
        return tuple(c.contiguous() for c in x.chunk(n, dim))

    @staticmethod
    def backward(ctx, *gs):
        g = torch.cat(gs, ctx.dim)
        collective("all-gather", ctx.n * _nbytes(g))
        return g, None, None


class _ScatterToModel(torch.autograd.Function):
    """This process's chunk along ``dim`` of a replicated tensor; the
    backward all-gathers the chunks' cotangents, so every process holds
    the replicated value's whole cotangent."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, dim: int, ring) -> torch.Tensor:
        ctx.dim, ctx.ring = dim, ring
        n = x.shape[dim] // ring.size
        return x.narrow(dim, ring.rank * n, n).contiguous()

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        return ctx.ring.gather(g, ctx.dim), None, None


def scatter_to_model(x: torch.Tensor, ring, dim: int) -> list[torch.Tensor]:
    """A replicated tensor cut along ``dim``: each held rank its chunk
    (the conjugate of :func:`gather_to_model`: its backward all-gathers
    the chunks' cotangents)."""
    if x.shape[dim] % ring.size:
        raise ValueError(f"dim {dim} of {tuple(x.shape)} does not split "
                         f"over {ring.size} ranks")
    if ring.size == 1:
        return [x]
    if _local(ring):
        return list(_LocalScatter.apply(x, dim, ring.size))
    return [_ScatterToModel.apply(x, dim, ring)]


def all_max(xs: Sequence[torch.Tensor], ring) -> torch.Tensor:
    """The elementwise maximum over the axis, replicated, outside
    autograd (a stabiliser: any constant gives the same logsumexp)."""
    xs = [x.detach() for x in xs]
    if ring.size == 1:
        return xs[0]
    if _local(ring):
        collective("all-reduce", ring.size * _nbytes(xs[0]))
        return torch.stack(xs).amax(0)
    return ring.reduce_(xs[0].clone(), "max")


class VocabShards:
    """Logits cut over the vocabulary: ``shards[i]`` is rank
    ``ring.index()[i]``'s (..., its vocab range) of a ``vocab``-wide
    output (what a placed model's forward returns; the loss takes its
    terms from them with :func:`vocab_loss_terms`)."""

    def __init__(self, shards: list, ring, vocab: int):
        self.shards = list(shards)
        self.ring = ring
        self.vocab = vocab


def vocab_range(V: int, m: int, r: int) -> tuple[int, int]:
    """The rows [lo, hi) of a V-row vocabulary that model rank ``r`` of
    ``m`` holds (the spec's cut: chunks of ceil(V / m))."""
    step = -(-V // m)
    lo = min(r * step, V)
    return lo, min(lo + step, V)


def vocab_embed_parts(tokens: torch.Tensor, embed, ring
                      ) -> list[torch.Tensor]:
    """The vocabulary-parallel embedding's partials: each held rank looks
    up the tokens of its vocab range in its rows of ``embed`` (a placed
    (V, D) table cut on V) and zeros the others (their sum is exact: one
    rank's row is non-zero)."""
    V = embed.shape[0]
    parts = []
    for r in ring.index():
        lo, hi = vocab_range(V, ring.size, r)
        own = (tokens >= lo) & (tokens < hi)
        rows = embed.at(model=r)
        e = torch.nn.functional.embedding(
            torch.where(own, tokens - lo, 0), rows)
        parts.append(e * own[..., None].to(e.dtype))
    return parts


def vocab_embed(tokens: torch.Tensor, embed, ring) -> torch.Tensor:
    """The vocabulary-parallel embedding lookup, replicated: the sum of
    :func:`vocab_embed_parts`."""
    return reduce_from_model(vocab_embed_parts(tokens, embed, ring), ring)


def vocab_loss_terms(logits: Sequence[torch.Tensor], labels: torch.Tensor,
                     ring, V: int) -> tuple[torch.Tensor, torch.Tensor]:
    """``training.step.loss_fn``'s ``logz`` and ``at_label`` from each
    rank's f32 logits over its vocab range (``logits[i]`` of rank
    ``ring.index()[i]``): the logsumexp from the ranks' maximum and their
    summed exponentials, the label's logit from the rank that holds it.
    Both replicated, (B, T)."""
    mx = all_max([z.amax(-1) for z in logits], ring)
    sums, picks = [], []
    for r, z in zip(ring.index(), logits):
        lo, hi = vocab_range(V, ring.size, r)
        sums.append(torch.exp(z - mx[..., None]).sum(-1))
        own = (labels >= lo) & (labels < hi)
        at = z.gather(-1, torch.where(own, labels - lo, 0)[..., None]
                      .long())[..., 0]
        picks.append(torch.where(own, at, 0.0))
    logz = mx + torch.log(reduce_from_model(sums, ring))
    return logz, reduce_from_model(picks, ring)


# ---------------------------------------------------------------------------
# the data axes
# ---------------------------------------------------------------------------

def data_axes(mesh) -> list[str]:
    """The mesh's data axes of more than one rank."""
    return [a for a in DATA_AXES
            if a in mesh.axis_names and mesh.shape[a] > 1]


def local_data_ranks(mesh) -> int:
    """The data ranks this process holds (its local rings' product)."""
    return math.prod(mesh.shape[a] for a in data_axes(mesh)
                     if _local(mesh.transport(a)))


def data_index(mesh) -> tuple[int, int]:
    """(index, count) of this process among the data ranks of the mesh's
    process axes (row-major over ``pod``, ``data``); (0, 1) when the data
    axes are local rings."""
    idx, n = 0, 1
    for ring in process_rings(mesh, data_axes(mesh)):
        idx, n = idx * ring.size + ring.rank, n * ring.size
    return idx, n


def gather_data(x: torch.Tensor, mesh) -> torch.Tensor:
    """Every data process's ``x`` (of one shape) concatenated on dim 0 in
    the order of :func:`data_index`, outside autograd (the inner axis
    first, then the outer)."""
    for ring in reversed(process_rings(mesh, data_axes(mesh))):
        x = ring.gather(x, 0)
    return x


def process_rings(mesh, axes: Sequence[str] | None = None) -> list:
    """The process rings among ``axes`` (default: every axis)."""
    axes = mesh.axis_names if axes is None else axes
    return [mesh.transport(a) for a in axes
            if mesh.shape[a] > 1 and not _local(mesh.transport(a))]


@torch.no_grad()
def all_reduce_(t: torch.Tensor, rings: Sequence, op: str = "sum"
                ) -> torch.Tensor:
    """``t`` reduced in place over the ranks of each process ring in turn
    (a 16-bit float summed in f32, rounded once); ``op`` 'sum' or
    'min'."""
    if not rings:
        return t
    if op not in ("sum", "min"):
        raise ValueError(f"op {op!r} not in ('sum', 'min')")
    acc = t.float() if op == "sum" and _narrow(t.dtype) else t
    for ring in rings:
        ring.reduce_(acc, op)
    if acc is not t:
        t.copy_(acc)
    return t
