"""Weights made on the device from the seed, in the type they are served
in: one ``torch.Generator`` on the device for each leaf, seeded from
(seed, leaf), so any leaf can be made again alone (the reference makes the
starting weights again after the program has trained them in place).

The tree is the port's layout for a decoder-only transformer: ``embed``,
``layers`` (every leaf stacked over the layers), ``ln_f``, ``lm_head``.
Matrices are normal with the configuration's ``initializer_range`` as
std, norms ones.
"""
from __future__ import annotations

import numpy as np
import torch

from .spec import model_sizes
from .traffic import seed_words


def leaf_shapes(config: dict) -> dict[str, tuple[tuple[int, ...], str]]:
    """Every leaf's shape and kind (``normal`` | ``ones`` | ``zeros``),
    keyed by its path (``layers.wq``), in a fixed order."""
    s = model_sizes(config)
    L, D, H, Kv, Dh, V = (s["n_layers"], s["d_model"], s["n_heads"],
                          s["n_kv_heads"], s["head_dim"], s["vocab"])
    out = {"embed": ((V, D), "normal"),
           "layers.ln1": ((L, D), "ones"),
           "layers.ln2": ((L, D), "ones"),
           "layers.wq": ((L, D, H * Dh), "normal"),
           "layers.wk": ((L, D, Kv * Dh), "normal"),
           "layers.wv": ((L, D, Kv * Dh), "normal"),
           "layers.wo": ((L, H * Dh, D), "normal")}
    if s["qkv_bias"]:
        out["layers.bq"] = ((L, H * Dh), "zeros")
        out["layers.bk"] = ((L, Kv * Dh), "zeros")
        out["layers.bv"] = ((L, Kv * Dh), "zeros")
    if s["qk_norm"]:
        out["layers.q_norm"] = ((L, Dh), "ones")
        out["layers.k_norm"] = ((L, Dh), "ones")
    if s["n_experts"]:
        E, F = s["n_experts"], s["d_ff"]
        out["layers.router"] = ((L, D, E), "normal")
        out["layers.w_gate"] = ((L, E, D, F), "normal")
        out["layers.w_up"] = ((L, E, D, F), "normal")
        out["layers.w_down"] = ((L, E, F, D), "normal")
    else:
        F = s["d_ff"]
        out["layers.w_gate"] = ((L, D, F), "normal")
        out["layers.w_up"] = ((L, D, F), "normal")
        out["layers.w_down"] = ((L, F, D), "normal")
    out["ln_f"] = ((D,), "ones")
    out["lm_head"] = ((D, V), "normal")
    return out


def _leaf_seed(seed: int, index: int) -> int:
    ss = np.random.SeedSequence(seed_words(seed, 0x3E1, index))
    lo, hi = ss.generate_state(2, np.uint32)
    return (int(hi) << 32 | int(lo)) & ((1 << 63) - 1)


def make_leaf(config: dict, name: str, seed: int, device) -> torch.Tensor:
    """Leaf ``name`` made from ``seed`` on ``device``, in the
    configuration's dtype.  A normal leaf is drawn in f32 one slab of its
    leading axis at a time (one f32 temporary the size of a layer)."""
    shapes = leaf_shapes(config)
    shape, kind = shapes[name]
    s = model_sizes(config)
    dt = getattr(torch, s["dtype"])
    if kind == "ones":
        return torch.ones(shape, dtype=dt, device=device)
    if kind == "zeros":
        return torch.zeros(shape, dtype=dt, device=device)
    gen = torch.Generator(device=device)
    gen.manual_seed(_leaf_seed(seed, list(shapes).index(name)))
    out = torch.empty(shape, dtype=dt, device=device)
    for i in range(shape[0] if len(shape) > 2 else 1):
        dst = out[i] if len(shape) > 2 else out
        x = torch.randn(dst.shape, generator=gen, device=device,
                        dtype=torch.float32)
        dst.copy_(x.mul_(s["init_std"]))
        del x
    return out


def make_weights(config: dict, seed: int, device) -> dict:
    """The whole tree, made on ``device`` from ``seed``."""
    tree: dict = {"layers": {}}
    for name in leaf_shapes(config):
        t = make_leaf(config, name, seed, device)
        if name.startswith("layers."):
            tree["layers"][name.split(".", 1)[1]] = t
        else:
            tree[name] = t
    return tree


def leaf_of(tree: dict, name: str) -> torch.Tensor:
    if name.startswith("layers."):
        return tree["layers"][name.split(".", 1)[1]]
    return tree[name]
