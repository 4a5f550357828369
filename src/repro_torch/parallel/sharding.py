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

:func:`shard_tree` places a tree by its specs, the counterpart of
``jax.device_put(tree, NamedSharding)``: each leaf becomes a
:class:`Placed`, the shards of it that this process holds (on a local
ring every rank's; on a process ring this rank's), each its own
contiguous tensor.  A leaf, or the part of a shard, that the spec
replicates over an axis is held once: the ranks of a local ring share
that one tensor, so a (2, 4) mesh on one card holds the state once.
:func:`gather_tree` is the way back, the global tree on every rank.
"""
from __future__ import annotations

import math
from typing import Any

import torch

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


def kv_store_specs(store: dict, mesh, *, kv_heads: int,
                   head_dim: int) -> dict:
    """The specs a dense cache (L, B, S, Hkv, Dh) or a paged pool (L, P,
    page, Hkv, Dh) is placed by on a placed state: over ``model`` alone,
    as :func:`cache_specs` / :func:`paged_pool_specs` cut the heads: kv
    heads on ``model`` when they divide it, else head_dim when it divides,
    else replicated (``k`` / ``v``, and an encoder-decoder's cross ``xk`` /
    ``xv``); the scales (..., Hkv) follow the heads; lengths, tables, the
    batch or page axis and any other entry stay whole."""
    m = _model_axis(mesh)
    heads = kv_heads % mesh.shape[m] == 0
    feat = not heads and head_dim % mesh.shape[m] == 0
    out = {}
    for k, v in store.items():
        spec = [None] * v.dim()
        if k in ("k", "v", "xk", "xv"):
            spec[3 if heads else 4] = m if heads or feat else None
        elif k in ("k_scale", "v_scale") and heads:
            spec[3] = m
        out[k] = tuple(spec)
    return out


# the recurrent states of the hybrid kind, cut on their last dim (W) as
# the block's w_x columns are
RECURRENT_STATES = ("conv_g", "lru_g", "conv_t", "lru_t")


def store_specs(kind: str, store: dict, mesh, cfg) -> dict:
    """The specs a ``kind`` family's serving cache or paged pool is placed
    by on a placed state, over ``model`` alone: each model rank's shard
    holds what its placed body reads and writes.

      * the transformer kinds (``dense``, ``moe``, ``vlm``): their K/V by
        :func:`kv_store_specs`;
      * ``audio`` (whisper): self and cross K/V alike, over its heads;
      * ``hybrid`` (recurrentgemma): the window ring's one kv head alike
        (head_dim on ``model`` where it divides), the recurrent states
        (:data:`RECURRENT_STATES`) on W;
      * ``ssm`` (mamba2): the SSM state (L, B, H, P, N) on its heads where
        the axis divides them, the conv window whole (a rank's channels
        are its heads' x and the whole B and C: no even cut).

    Raises ValueError for a kind without a rule."""
    m = _model_axis(mesh)
    if kind in ("dense", "moe", "vlm"):
        return kv_store_specs(store, mesh, kv_heads=cfg.n_kv_heads,
                              head_dim=cfg.dh)
    if kind == "audio":
        return kv_store_specs(store, mesh, kv_heads=cfg.n_heads,
                              head_dim=cfg.dh)
    if kind == "hybrid":
        out = kv_store_specs(store, mesh, kv_heads=cfg.n_kv_heads,
                             head_dim=cfg.dh)
        for k in RECURRENT_STATES:
            if k in store:
                out[k] = (None,) * (store[k].dim() - 1) + (m,)
        return out
    if kind == "ssm":
        heads = cfg.n_heads % mesh.shape[m] == 0
        out = {k: (None,) * v.dim() for k, v in store.items()}
        if heads and "ssm" in store:
            out["ssm"] = (None, None, m, None, None)
        return out
    raise ValueError(f"no cache placement rule for kind {kind!r}")


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


# ---------------------------------------------------------------------------
# placed trees
# ---------------------------------------------------------------------------

def _cuts(spec: Spec, mesh) -> list[tuple[int, str]]:
    """(dim, axis) in the order ``spec`` cuts a tensor: dim by dim, each
    dim's axes major first; axes of one rank cut nothing."""
    return [(d, a) for d, e in enumerate(spec) for a in _names(e)
            if mesh.shape[a] > 1]


def _held(mesh, axis: str) -> list[int]:
    """The ranks of ``axis`` this process holds: all of a local ring's,
    this rank of a process ring."""
    return list(mesh.transport(axis).index())


def _cut(x: torch.Tensor, cuts, mesh, coords: tuple) -> torch.Tensor:
    """The shard of ``x`` at ``coords`` (one index a cut), as
    :func:`local_shape` sizes it: a view."""
    for (d, a), i in zip(cuts, coords):
        n = mesh.shape[a]
        size = x.shape[d]
        step = -(-size // n) if size else 0
        x = x.narrow(d, min(i * step, size), _chunk(size, n, i))
    return x


class Placed:
    """One tensor of a placed tree: the global ``shape`` and ``dtype``, its
    ``spec`` over ``mesh``, and ``shards``, the pieces this process holds,
    keyed by their coordinates on ``axes`` (the mesh axes the spec cuts,
    in cut order; () for a replicated tensor, held once).  A rank's shard
    is :meth:`at` its coordinates."""

    __slots__ = ("shape", "dtype", "spec", "mesh", "cuts", "axes", "shards")

    def __init__(self, shape, dtype, spec: Spec, mesh, shards: dict):
        self.shape = torch.Size(shape)
        self.dtype = dtype
        self.spec = tuple(spec)
        self.mesh = mesh
        self.cuts = _cuts(self.spec, mesh)
        self.axes = tuple(a for _, a in self.cuts)
        self.shards = shards

    @classmethod
    def place(cls, x: torch.Tensor, spec: Spec, mesh) -> "Placed":
        """``x`` cut by ``spec``: a contiguous copy of each shard held."""
        cuts = _cuts(tuple(spec), mesh)
        keys = [()]
        for _, a in cuts:
            keys = [k + (i,) for k in keys for i in _held(mesh, a)]
        shards = {k: _cut(x, cuts, mesh, k).clone(
            memory_format=torch.contiguous_format) for k in keys}
        return cls(x.shape, x.dtype, spec, mesh, shards)

    def piece(self, x: torch.Tensor, key: tuple) -> torch.Tensor:
        """The shard at ``key`` of a global tensor ``x`` laid out as this
        one (a view)."""
        return _cut(x, self.cuts, self.mesh, key)

    def at(self, **coords: int) -> torch.Tensor:
        """The shard of the rank at ``coords`` (axis name -> index; axes
        the spec does not cut are ignored)."""
        return self.shards[tuple(coords[a] for a in self.axes)]

    def tensors(self) -> list[torch.Tensor]:
        """The shards held, in coordinate order."""
        return [self.shards[k] for k in sorted(self.shards)]

    def map(self, fn) -> "Placed":
        """``fn`` of every shard, placed as this tensor is."""
        shards = {k: fn(v) for k, v in self.shards.items()}
        dtype = next(iter(shards.values())).dtype
        return Placed(self.shape, dtype, self.spec, self.mesh, shards)

    def unbind(self, dim: int = 0) -> list["Placed"]:
        """The layers of a stacked tensor (an uncut dim 0), each placed as
        the rest of the spec says; each shard unbound once."""
        if dim != 0 or self.spec[0] is not None and any(
                self.mesh.shape[a] > 1 for a in _names(self.spec[0])):
            raise ValueError(f"unbind of dim {dim} of spec {self.spec}")
        cols = {k: v.unbind(0) for k, v in self.shards.items()}
        return [Placed(self.shape[1:], self.dtype, self.spec[1:], self.mesh,
                       {k: c[i] for k, c in cols.items()})
                for i in range(self.shape[0])]

    def dim(self) -> int:
        return len(self.shape)

    @property
    def device(self) -> torch.device:
        return next(iter(self.shards.values())).device

    def nbytes(self) -> int:
        """Bytes of the shards this process holds."""
        return sum(t.numel() * t.element_size()
                   for t in self.shards.values())

    def __repr__(self) -> str:
        return (f"Placed({tuple(self.shape)}, {self.dtype}, spec="
                f"{self.spec}, {len(self.shards)} shard(s))")


def _walk(fn, tree, specs=None):
    if isinstance(tree, dict):
        return {k: _walk(fn, v, None if specs is None else specs[k])
                for k, v in tree.items()}
    return None if tree is None else fn(tree, specs)


def shard_tree(tree: Any, specs: Any, mesh) -> Any:
    """A (nested dict) tree of global tensors placed by the matching spec
    tree: each leaf a :class:`Placed` holding copies of the shards this
    process holds (every rank's on local rings, this rank's on process
    rings), a replicated leaf or part once."""
    return _walk(lambda x, s: Placed.place(x, s, mesh), tree, specs)


def _merge(parts: dict, d: int, axis: str, mesh, pos: int) -> dict:
    """Join the pieces along dim ``d`` over ``axis`` (coordinate ``pos``
    of each key): concatenated in rank order on a local ring, gathered
    from the ranks of a process ring."""
    ring = mesh.transport(axis)
    out: dict = {}
    for k in sorted(parts):
        rest = k[:pos] + k[pos + 1:]
        out.setdefault(rest, []).append(parts[k])
    if len(ring.index()) == ring.size:
        return {k: torch.cat(v, d) for k, v in out.items()}
    return {k: ring.all_gather(v, d)[0] for k, v in out.items()}


def gather_leaf(leaf: Placed) -> torch.Tensor:
    """The global tensor of a placed one, on every rank (a process ring
    gathers it: every rank of the axis must call this, in the same order;
    its shards must be equal in size)."""
    parts = dict(leaf.shards)
    for pos in reversed(range(len(leaf.cuts))):
        d, a = leaf.cuts[pos]
        parts = _merge(parts, d, a, leaf.mesh, pos)
    out = parts[()]
    if tuple(out.shape) != tuple(leaf.shape):
        raise ValueError(f"gathered {tuple(out.shape)}, placed "
                         f"{tuple(leaf.shape)}: uneven shards on a process "
                         f"axis")
    return out if leaf.cuts else out.clone()


def gather_tree(tree: Any, device=None) -> Any:
    """The global tree of a placed one (leaves that are not placed are
    kept as they are), on every rank: the tree the unsharded step holds.
    Collective on a process mesh.  With ``device`` each gathered leaf
    moves there as it is made (a checkpoint's host copy, one leaf on the
    card at a time)."""
    def one(x, _):
        if not isinstance(x, Placed):
            return x
        g = gather_leaf(x)
        return g if device is None else g.to(device)
    return _walk(one, tree)


@torch.no_grad()
def load_tree_(placed: Any, host: Any) -> Any:
    """Copy a global tree (e.g. a restored host tree) into a placed tree
    of the same structure, in place: each shard gets its cut, a leaf that
    is not placed the whole.  Returns ``placed``."""
    if isinstance(placed, dict):
        for k in placed:
            load_tree_(placed[k], host[k])
    elif isinstance(placed, Placed):
        for key, shard in placed.shards.items():
            shard.copy_(placed.piece(host, key))
    elif placed is not None:
        placed.copy_(host)
    return placed


def host_like(tree: Any) -> Any:
    """Empty CPU tensors of a (placed or plain) tree's global shapes and
    dtypes: what a checkpoint restores before it is placed."""
    def one(x, _):
        return torch.empty(tuple(x.shape), dtype=x.dtype)
    return _walk(one, tree)


def is_placed(tree: Any) -> bool:
    """Whether any leaf of a (nested dict) tree is :class:`Placed`."""
    if isinstance(tree, dict):
        return any(is_placed(v) for v in tree.values())
    return isinstance(tree, Placed)


def tree_mesh(tree: Any):
    """The mesh of a placed tree's first placed leaf (None if none)."""
    if isinstance(tree, dict):
        for v in tree.values():
            m = tree_mesh(v)
            if m is not None:
                return m
        return None
    return tree.mesh if isinstance(tree, Placed) else None


def held_nbytes(tree: Any) -> int:
    """Bytes this process holds of a (nested dict) tree, placed or not."""
    if isinstance(tree, dict):
        return sum(held_nbytes(v) for v in tree.values())
    if isinstance(tree, Placed):
        return tree.nbytes()
    return 0 if tree is None else tree.numel() * tree.element_size()
