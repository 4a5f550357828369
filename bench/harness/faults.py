"""Faults planted underneath a run's timed path, for the negative controls:
each must turn ``correct`` false.  ``train_cell.run(break_step=...)`` and
``serve_cell.run(break_tokens=...)`` take them."""
from __future__ import annotations

import torch


def unchanged_state(step_fn):
    """A step that computes its loss but returns its state unchanged."""
    def step(params, state, batch, *a):
        keep = [(t, t.detach().clone()) for t in _tensors((params, state))]
        params, state, m = step_fn(params, state, batch, *a)
        with torch.no_grad():
            for t, old in keep:
                t.copy_(old)
        return params, state, m
    return step


def half_batch(step_fn):
    """Half of the batch left out, the mean taken over the rest: the first
    half of the rows, or of the positions of a one-row batch."""
    def step(params, state, batch, *a):
        B, S = batch["tokens"].shape
        cut = {k: (v[:B // 2] if B > 1 else v[:, :S // 2])
               for k, v in batch.items()}
        return step_fn(params, state, cut, *a)
    return step


def altered_tokens(every: int = 5):
    """A served token altered where it is produced: every ``every``-th
    model call's picked ids moved to the next id."""
    def plant(engine):
        share, calls = engine._share, [0]
        vocab = engine.bundle.cfg.vocab

        def altered(local):
            out = share(local)
            calls[0] += 1
            if calls[0] % every == 0 and out.ndim == 1:
                out = (out + 1) % vocab
            return out
        engine._share = altered
    return plant


def _tensors(tree):
    if isinstance(tree, torch.Tensor):
        yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _tensors(v)
