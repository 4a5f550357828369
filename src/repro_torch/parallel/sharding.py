"""Per-architecture sharding rules (DP / TP / EP / SP on the 2-3D mesh).

Counterpart of ``repro.parallel.sharding``, with the reference's rules.
Megatron-style tensor parallelism on hidden dims — robust to head counts
that do not divide the mesh (qwen2.5/qwen1.5 have 40 heads on a 16-wide
model axis; hidden dims are all multiples of 16):
  * embed / lm_head: vocab on `model`
  * attention qkv: output features on `model`; wo: input features on `model`
  * mlp: w_gate/w_up features on `model`; w_down input on `model`
  * MoE: experts on `model` when divisible (EP), else per-expert ffn on
    `model` (TP-in-expert) — granite's 40 experts use the latter
  * activations / tokens: batch on `data` (+`pod` when multi-pod); the
    long-context batch=1 shapes shard sequence on `data` instead (SP)
  * KV caches: batch on `data`, head-dim features on `model` when the kv
    head count divides, else sequence on `model`

A spec is the ``PartitionSpec`` counterpart: a tuple with one entry per
tensor dim, each None (replicated), a mesh axis name, or a tuple of names
(major first) — a one-name tuple is written as the name, as
``PartitionSpec`` normalises it.  :func:`placements` turns one into
DTensor placements over a mesh's axes, and :func:`local_shape` gives the
shard a rank holds, by DTensor's uneven chunking.  A mesh is anything with
``axis_names`` and a ``shape`` dict (``parallel.mesh.Mesh``).
"""
from __future__ import annotations

import math
from typing import Any

Spec = tuple


def _model_axis(mesh) -> str:
    return "model"


def _axes(names: tuple[str, ...]):
    """One mesh-axis entry of a spec: a single name as itself, several as
    their tuple (``PartitionSpec``'s normal form)."""
    return names[0] if len(names) == 1 else names


def _data_axes(mesh) -> tuple[str, ...]:
    return tuple(a for a in ("pod", "data") if a in mesh.axis_names)


def _div(n: int, mesh, axis: str) -> bool:
    return n % mesh.shape[axis] == 0


def param_specs(arch_kind: str, params_shape: Any, mesh) -> Any:
    """A spec tree matching the param tree (a nested dict of tensors,
    meta tensors included), leaf by leaf, keyed by each leaf's name."""
    m = _model_axis(mesh)

    def spec_for(key: str, leaf) -> Spec:
        shape = tuple(leaf.shape)
        nd = len(shape)

        def last_on_model():
            return (None,) * (nd - 1) + (m,)

        def secondlast_on_model():
            return (None,) * (nd - 2) + (m, None)

        if key in ("embed", "lm_head"):
            # embed (V, D): vocab on model; lm_head (D, V): vocab on model
            return (m, None) if key == "embed" else (None, m)
        if key in ("pos_dec",):
            return (None, None)
        if key in ("wq", "wk", "wv", "w_x", "w_y", "in_proj",
                   "mlp_gate", "mlp_up", "mlp_w1"):
            return last_on_model()       # (..., D, F): F on model
        if key in ("bq", "bk", "bv", "mlp_b1", "b_in"):
            return last_on_model()
        if key == "w_down" and nd == 4:
            # moe (L, E, F, D): experts on model when divisible (EP),
            # else per-expert F on model (TP-in-expert)
            if _div(shape[1], mesh, m):
                return (None, m, None, None)
            return (None, None, m, None)
        if key in ("wo", "w_down", "mlp_down", "mlp_w2", "out_proj",
                   "w_out"):
            return secondlast_on_model()  # (..., F, D): F on model
        if key in ("w_gate", "w_up"):
            # dense mlp (L, D, F) -> F on model;
            # moe (L, E, D, F) -> E on model if divisible else F on model
            if nd == 4:
                if _div(shape[1], mesh, m):
                    return (None, m, None, None)
                return (None, None, None, m)
            return last_on_model()
        if key == "router":
            return (None, None, None) if nd == 3 else (None, None)
        if key in ("w_a", "w_i"):
            return last_on_model()       # (L, W, W) second W on model
        # conv and SSM parameters, norms, biases, scalars: replicated
        return (None,) * nd

    def walk(tree, key):
        if isinstance(tree, dict):
            return {k: walk(v, k) for k, v in tree.items()}
        return None if tree is None else spec_for(key, tree)

    return walk(params_shape, None)


def batch_specs(shape_kind: str, mesh) -> dict[str, Spec]:
    """Input specs for the train/serve step batches."""
    d = _axes(_data_axes(mesh))
    if shape_kind == "long":        # global_batch=1: shard sequence (SP)
        return {"tokens": (None, d), "labels": (None, d)}
    return {"tokens": (d, None), "labels": (d, None)}


def cache_specs(mesh, *, kv_heads: int, head_dim: int,
                long_context: bool = False) -> dict[str, Spec]:
    """KV cache (L, B, S, Hkv, Dh) specs."""
    m = _model_axis(mesh)
    d = _axes(_data_axes(mesh))
    if long_context:
        # batch=1: shard the cache sequence over data, features over model
        kv = (None, None, d, None,
              m if head_dim % mesh.shape[m] == 0 else None)
    elif kv_heads % mesh.shape[m] == 0:
        kv = (None, d, None, m, None)
    else:
        kv = (None, d, None, None,
              m if head_dim % mesh.shape[m] == 0 else None)
    return {"k": kv, "v": kv, "length": (d,)}


def paged_pool_specs(mesh, *, kv_heads: int,
                     head_dim: int) -> dict[str, Spec]:
    """Paged KV pool specs (serving/kv.py block pool).

    Pool pages (L, P, page, Hkv, Dh) have no batch axis — the PAGE axis is
    the global one (any slot's table may point anywhere), so it shards over
    the data axes like the dense cache's batch does, while head structure
    follows the dense-cache rule: kv heads on `model` when divisible, else
    head_dim on `model` when divisible.  Page tables and lengths are tiny
    host-managed index state and stay replicated."""
    m = _model_axis(mesh)
    d = _axes(_data_axes(mesh))
    if kv_heads % mesh.shape[m] == 0:
        pages = (None, d, None, m, None)
        scales = (None, d, None, m)
    else:
        feat = m if head_dim % mesh.shape[m] == 0 else None
        pages = (None, d, None, None, feat)
        scales = (None, d, None, None)
    return {"k": pages, "v": pages, "k_scale": scales, "v_scale": scales,
            "page_table": (None, None), "lengths": (None,)}


def _names(entry) -> tuple[str, ...]:
    if entry is None:
        return ()
    return (entry,) if isinstance(entry, str) else tuple(entry)


def placements(spec: Spec, mesh) -> list:
    """DTensor placements of ``spec`` over ``mesh``'s axes, in axis order:
    ``Shard(d)`` on each axis that dim ``d`` is split over, ``Replicate()``
    on the others.  A dim over several axes is split by the first (major)
    axis, then the next, as ``PartitionSpec`` splits it."""
    from torch.distributed.tensor import Replicate, Shard
    out = []
    for axis in mesh.axis_names:
        dims = [d for d, e in enumerate(spec) if axis in _names(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    return out


def make_shardings(tree_of_specs: Any, mesh) -> Any:
    """Each spec of a (nested dict) spec tree as its DTensor placements."""
    if isinstance(tree_of_specs, dict):
        return {k: make_shardings(v, mesh) for k, v in tree_of_specs.items()}
    return None if tree_of_specs is None else placements(tree_of_specs, mesh)


def _chunk(size: int, n: int, rank: int) -> int:
    """Rows of ``size`` that rank ``rank`` of ``n`` holds, by ``torch.chunk``
    (DTensor's uneven sharding): chunks of ceil(size / n), the last ones
    short or empty."""
    step = -(-size // n) if size else 0
    return max(0, min(step, size - rank * step))


def local_shape(shape, spec: Spec, mesh, coords: dict | None = None
                ) -> tuple[int, ...]:
    """The shard of a ``shape`` tensor laid out by ``spec`` that the rank at
    ``coords`` (axis name -> index; default 0 on every axis, which holds
    the largest shard) holds, splitting each dim over its axes in order as
    DTensor does."""
    coords = coords or {}
    out = list(shape)
    for d, entry in enumerate(spec):
        for axis in _names(entry):
            out[d] = _chunk(out[d], mesh.shape[axis], coords.get(axis, 0))
    return tuple(out)


def local_nbytes(tree, specs, mesh) -> int:
    """Bytes of the largest shard of every leaf of a (nested dict) tree of
    tensors laid out by the matching spec tree."""
    if isinstance(tree, dict):
        return sum(local_nbytes(tree[k], specs[k], mesh) for k in tree)
    if tree is None:
        return 0
    return math.prod(local_shape(tuple(tree.shape), specs, mesh)) * \
        tree.element_size()
