"""Input specs of every step function (the dry run and the launchers).

Counterpart of ``repro.launch.specs``, with the reference's rules: batch on
the data axes (pod+data), features on `model`, vocab on `model` (configs
pad vocab to a multiple of 256), caches batch-on-data + (kv-heads |
head-dim | seq) on `model` by divisibility, and the long-context batch=1
shapes shard the SEQUENCE on data (SP).  Specs are the tuples of
``parallel.sharding``; the arguments are meta tensors (``ArchBundle``'s
``abstract_params`` and ``input_specs``).
"""
from __future__ import annotations

from typing import Any

import torch

from repro_torch.parallel.sharding import param_specs


def data_axes(mesh):
    axes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    return axes if len(axes) > 1 else axes[0]


def _dsize(mesh) -> int:
    n = 1
    for a in ("pod", "data"):
        if a in mesh.axis_names:
            n *= mesh.shape[a]
    return n


def _msize(mesh) -> int:
    return mesh.shape["model"]


def batch_spec_tree(specs: dict, mesh, *, long: bool) -> dict:
    """Specs for the input batch dict (tokens/labels/vision/frames)."""
    d = data_axes(mesh)
    out = {}
    for k, v in specs.items():
        if k == "cache":
            continue
        spec = [None] * v.dim()
        if long:
            # batch=1: replicate tokens (1,1); shard long seq dims on data
            for i, s in enumerate(v.shape[1:], start=1):
                if s % _dsize(mesh) == 0 and s > 1:
                    spec[i] = d
                    break
        elif v.shape[0] % _dsize(mesh) == 0:
            spec[0] = d
        out[k] = tuple(spec)
    return out


def cache_spec_tree(cache_shapes: Any, mesh, *, long: bool) -> Any:
    """Specs for a cache dict, keyed by leaf name + divisibility."""
    d = data_axes(mesh)
    ms = _msize(mesh)
    ds = _dsize(mesh)

    def leaf_spec(key: str, leaf) -> tuple:
        shape = tuple(leaf.shape)
        nd = len(shape)
        if key == "length":
            return (d,) if shape[0] % ds == 0 else (None,)
        spec = [None] * nd
        if key in ("k", "v", "xk", "xv"):
            # (L|G, B, S, Kv, Dh)
            if not long and shape[1] % ds == 0:
                spec[1] = d
            if long and shape[2] % ds == 0:
                spec[2] = d          # SP: shard cache sequence
            if shape[3] % ms == 0:
                spec[3] = "model"    # kv heads
            elif shape[4] % ms == 0:
                spec[4] = "model"    # head dim
            elif not long and shape[2] % ms == 0:
                spec[2] = "model"    # cache sequence on model
            return tuple(spec)
        if key in ("k_scale", "v_scale"):
            # (L, B, S, Kv)
            if not long and shape[1] % ds == 0:
                spec[1] = d
            if long and shape[2] % ds == 0:
                spec[2] = d
            if shape[3] % ms == 0:
                spec[3] = "model"
            elif not long and shape[2] % ms == 0:
                spec[2] = "model"
            return tuple(spec)
        if key in ("conv", "ssm"):
            # mamba: (L, B, w, dxbc) / (L, B, H, Pd, N)
            if shape[1] % ds == 0:
                spec[1] = d
            if shape[-1] % ms == 0 and key == "conv":
                spec[-1] = "model"
            if key == "ssm" and shape[2] % ms == 0:
                spec[2] = "model"
            return tuple(spec)
        if key in ("conv_g", "lru_g", "conv_t", "lru_t"):
            # rg: (G, 2, B, w, W) / (G, 2, B, W) / (Tr, B, w, W) / (Tr, B, W)
            bidx = 2 if key.endswith("_g") else 1
            if shape[bidx] % ds == 0:
                spec[bidx] = d
            if shape[-1] % ms == 0:
                spec[-1] = "model"
            return tuple(spec)
        return tuple(spec)

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return leaf_spec(key, tree)

    return walk(cache_shapes, None)


def step_in_shardings(bundle, shape_name: str, mesh):
    """(meta args, their specs, step_fn, donated argument indices) for one
    cell: the train step (``training.make_train_step`` over AdamW state),
    or a prefill or decode step of the bundle under ``torch.no_grad()``."""
    from repro_torch.optim import adamw_init
    from repro_torch.training import TrainHyper, make_train_step

    kind = bundle.step_kind(shape_name)
    long = shape_name == "long_500k"
    specs = bundle.input_specs(shape_name)
    aparams = bundle.abstract_params()
    pspecs = param_specs(bundle.kind, aparams, mesh)

    if kind == "train":
        step = make_train_step(bundle.forward, TrainHyper())
        aopt = adamw_init(aparams)
        opt_specs = {"mu": pspecs, "nu": pspecs, "step": ()}
        bspec = batch_spec_tree(specs, mesh, long=long)
        args = (aparams, aopt, specs)
        return args, (pspecs, opt_specs, bspec), step, (0, 1)

    cache_specs = cache_spec_tree(specs["cache"], mesh, long=long)
    bspec = batch_spec_tree(specs, mesh, long=long)

    if kind == "prefill":
        extras_keys = [k for k in specs if k not in ("tokens", "cache")]

        @torch.no_grad()
        def step(params, tokens, cache, extras):
            return bundle.prefill(params, tokens, cache, extras)

        args = (aparams, specs["tokens"], specs["cache"],
                {k: specs[k] for k in extras_keys})
        shardings = (pspecs, bspec["tokens"], cache_specs,
                     {k: bspec[k] for k in extras_keys})
        return args, shardings, step, (2,)      # donate the cache

    @torch.no_grad()
    def step(params, tokens, cache):
        return bundle.decode_step(params, tokens, cache)

    args = (aparams, specs["tokens"], specs["cache"])
    shardings = (pspecs, bspec["tokens"], cache_specs)
    return args, shardings, step, (2,)          # donate the cache
