"""Weights across the two packages: a param tree of numpy arrays (for
example the reference's ``init_params`` output passed through
``np.asarray``) -> the port's dict of tensors, same key names and the same
layer-stacked leading axis.  Imports no JAX: it only sees numpy arrays."""
from __future__ import annotations

from typing import Any

import numpy as np
import torch


def _to_tensor(a: np.ndarray, device) -> torch.Tensor:
    a = np.asarray(a)
    if a.dtype.name == "bfloat16":
        # ml_dtypes' bfloat16 is not a dtype torch.from_numpy takes: move
        # the raw 16-bit words and reinterpret them
        words = np.ascontiguousarray(a).view(np.uint16).view(np.int16)
        t = torch.from_numpy(words.copy()).view(torch.bfloat16)
    else:
        t = torch.from_numpy(np.ascontiguousarray(a).copy())
    return t.to(device)


def from_jax_params(tree: Any, device="cpu") -> Any:
    """Nested dicts of numpy arrays -> the same nesting of torch tensors
    on ``device``."""
    if isinstance(tree, dict):
        return {k: from_jax_params(v, device) for k, v in tree.items()}
    return _to_tensor(tree, device)
