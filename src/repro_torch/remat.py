"""Named residuals of a checkpointed unit: the port's counterpart of the
reference's ``jax.ad_checkpoint.checkpoint_name`` and
``jax.checkpoint_policies.save_only_these_names``.

``models.layers.remat_call`` runs a unit under ``torch.utils.checkpoint``:
the unit keeps its inputs, and its backward runs it again.  A unit
called with ``save=("attn_out",)`` also keeps the values its
:func:`keep` calls of that name computed: the forward records them in
call order, and the recompute gets them back in the same order instead
of computing them again (a unit's recompute runs the same code on the
same inputs, so the n-th call is the n-th value).  Outside such a unit,
or under another name, :func:`keep` just computes.

The flash attention's autograd Function (``kernels.attention.
FlashAttention``) and the ring's (``parallel.ring_attention.
RingAttention``) name their forward's ``(o, lse)`` ``"attn_out"``: a
transformer layer's recompute then launches no flash forward, and the
backward kernels read the kept ``o`` and ``lse``.
"""
from __future__ import annotations

import contextlib
import contextvars
from collections.abc import Callable, Iterator

import torch

_ACTIVE: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_remat_saved", default=None)


class Saved:
    """The values one unit keeps under ``names``: recorded by its forward,
    handed back in order by its recompute (:meth:`active`)."""

    def __init__(self, names):
        self.names = frozenset(names)
        self._values: list[tuple[torch.Tensor, ...]] = []
        self._next: int | None = None          # None while recording

    def take(self, compute: Callable[[], tuple]) -> tuple:
        if self._next is None:
            out = compute()
            self._values.append(tuple(t.detach() for t in out))
            return out
        kept = self._values[self._next]
        self._next += 1
        return tuple(t.detach() for t in kept)

    @contextlib.contextmanager
    def active(self, replay: bool) -> Iterator[None]:
        """The unit's forward (recording) or, with ``replay``, its
        recompute (handing back what the forward recorded)."""
        self._next = 0 if replay else None
        token = _ACTIVE.set(self if self.names else None)
        try:
            yield
        finally:
            _ACTIVE.reset(token)


def keep(name: str, compute: Callable[[], tuple]) -> tuple:
    """``compute()`` (a tuple of tensors), or, in the recompute of a unit
    that saves ``name``, what its forward computed here."""
    saved = _ACTIVE.get()
    if saved is None or name not in saved.names:
        return compute()
    return saved.take(compute)
