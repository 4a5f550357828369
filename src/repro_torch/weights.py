"""Weights across the two packages: a param tree of numpy arrays (for
example the reference's ``init_params`` output passed through
``np.asarray``) -> the port's dict of tensors, same key names and the same
layer-stacked leading axis.  Imports no JAX: it only sees numpy arrays."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


BF16 = "bfloat16"     # numpy's (ml_dtypes') name, as the reference records it


def bf16_from_words(words: np.ndarray) -> torch.Tensor:
    """Raw 16-bit bfloat16 words -> a CPU bf16 tensor on the same memory,
    bit for bit.  ``words`` is an ml_dtypes ``bfloat16`` array, which
    ``torch.from_numpy`` does not take, or the ``V2`` array ``np.load``
    gives for one; either is reinterpreted, never converted."""
    return torch.from_numpy(words.view(np.int16)).view(torch.bfloat16)


def to_numpy(t: torch.Tensor) -> tuple[np.ndarray, str]:
    """A CPU tensor -> (a numpy array on its memory, the numpy dtype name
    the reference records for it).  A bf16 tensor becomes its raw 16-bit
    words under the name ``bfloat16``: the bytes an ml_dtypes array
    holds."""
    if t.dtype == torch.bfloat16:
        return t.view(torch.int16).numpy(), BF16
    a = t.numpy()
    return a, a.dtype.name


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.array(a, order="C")         # a writable copy the tensor owns
    if a.dtype.name == BF16:
        t = bf16_from_words(a)
    else:
        t = torch.from_numpy(a)
    return t.to(device)


def from_jax_params(tree: Any, device="cpu") -> Any:
    """Nested dicts of numpy arrays -> the same nesting of torch tensors
    on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)
