"""Ring collective matmul: the paper's FIFO data-exchange mesh at chip
scale.  Counterpart of ``repro.parallel.ring_matmul``.

The baseline the paper criticizes gathers the whole operand into every
tile: at chip scale, all-gather(B) and then a local GEMM, which holds the
full B on every rank before any compute starts (:func:`allgather_matmul`).
:func:`ring_matmul` keeps outputs stationary instead: A is split by rows
(stationary, like PSums), B by columns; each of the ``m`` steps multiplies
the local rows by the B shard it holds and hands that shard to the
neighbour (``Transport.shift``), so no rank holds more than its own B shard
and the visiting one.

The backward is an autograd Function with the same stationarity: dA stays
output-stationary (each rank folds ``g[:, cols_j] @ B_j^T`` as shard j
visits) and the f32 dB accumulators circulate alongside the B shards, so
each shard's gradient arrives home after ``m`` hops with no all-reduce and
no saved per-step residual.

The per-shard products are ``torch.matmul`` (the reference's ``jnp.dot``
outside any Pallas kernel): the forward in the operands' dtype (f32
accumulation, rounded to it), the backward's in f32.  Under a
``LocalRing`` mesh ``a`` and ``b`` are the global operands on one device
and the result is global; under a ``ProcessRing`` they are this rank's row
shard of A and column shard of B, and the result is this rank's rows.
"""
from __future__ import annotations

import torch

from .mesh import Mesh

__all__ = ["ring_matmul", "ring_matmul_ref", "allgather_matmul"]


def _ring_body(ring, a_s, b_s, outs):
    """Per-rank lists: a (m_local, K) rows and b (K, n_local) columns,
    written into outs (m_local, N) rows of the output."""
    m = ring.size
    n_local = b_s[0].shape[1]
    b_c = b_s
    for i in range(m):
        for j, idx in enumerate(ring.index()):
            # which column block of the OUTPUT the visiting shard makes
            col = (idx - i) % m
            outs[j][:, col * n_local:(col + 1) * n_local] = \
                torch.matmul(a_s[j], b_c[j])
        if i < m - 1:               # the last shift feeds nothing
            (b_c,) = ring.shift(b_c)


def _ring_bwd_body(ring, a_s, b_s, g_s):
    """Backward ring pass over per-rank lists: dA output-stationary, the
    dB accumulators ride the ring with the B shards and are home after m
    hops.  Returns f32 (dA, dB) lists."""
    m = ring.size
    n_local = b_s[0].shape[1]
    da = [torch.zeros(a.shape, device=a.device) for a in a_s]
    db_c = [torch.zeros(b.shape, device=b.device) for b in b_s]
    b_c = b_s
    for i in range(m):
        for j, idx in enumerate(ring.index()):
            col = (idx - i) % m
            g_c = g_s[j][:, col * n_local:(col + 1) * n_local].float()
            da[j] = da[j] + g_c @ b_c[j].float().T
            db_c[j] = db_c[j] + a_s[j].float().T @ g_c
        # the shard and its gradient accumulator take the hop together
        b_c, db_c = ring.shift(b_c, db_c)
    return da, db_c


class RingMatmul(torch.autograd.Function):
    """A (M, K) split by rows x B (K, N) split by columns -> C (M, N) split
    by rows, forward and backward output-stationary."""

    @staticmethod
    def forward(ctx, ring, out_dtype, a, b):
        b_s = ring.split(b, 1)
        # this process's rows of C, written in place shard by shard
        out = torch.empty((a.shape[0], b_s[0].shape[1] * ring.size),
                          dtype=out_dtype, device=a.device)
        _ring_body(ring, ring.split(a, 0), b_s, ring.split(out, 0))
        ctx.save_for_backward(a, b)
        ctx.ring = ring
        return out

    @staticmethod
    def backward(ctx, g):
        ring = ctx.ring
        a, b = ctx.saved_tensors
        da, db = _ring_bwd_body(ring, ring.split(a, 0), ring.split(b, 1),
                                ring.split(g, 0))
        return (None, None, ring.join(da, 0).to(a.dtype),
                ring.join(db, 1).to(b.dtype))


def ring_matmul(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                axis: str = "model", out_dtype=None) -> torch.Tensor:
    """C = A @ B on the ring of ``axis`` (module docstring for the
    operands under each transport), differentiable in A and B."""
    return RingMatmul.apply(mesh.transport(axis), out_dtype or a.dtype, a, b)


def ring_matmul_ref(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    return torch.matmul(a.float(), b.float()).to(a.dtype)


def allgather_matmul(a: torch.Tensor, b: torch.Tensor, mesh: Mesh,
                     axis: str = "model", out_dtype=None) -> torch.Tensor:
    """The baseline: every rank gathers all of B (``m - 1`` hops), then one
    local GEMM; each rank holds the full B at once.  Operands as
    :func:`ring_matmul`."""
    ring = mesh.transport(axis)
    out_dtype = out_dtype or a.dtype
    m = ring.size
    a_s, b_s = ring.split(a, 0), ring.split(b, 1)
    gathered = [[None] * m for _ in b_s]
    b_c = b_s
    for i in range(m):
        for j, idx in enumerate(ring.index()):
            gathered[j][(idx - i) % m] = b_c[j]
        if i < m - 1:
            (b_c,) = ring.shift(b_c)
    b_full = [torch.cat(row, 1) for row in gathered]
    return ring.join([torch.matmul(a_j, b_j).to(out_dtype)
                      for a_j, b_j in zip(a_s, b_full)], 0)
