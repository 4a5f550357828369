"""Op cost counter: the flops, bytes and collective bytes of what a
function runs, whatever runs it.

Counterpart of ``repro.analysis.hlo_cost``, whose HLO parser has no
meaning here: PyTorch runs eagerly, so the counter watches the ops as they
run.  :func:`count` runs ``fn`` under a ``TorchDispatchMode`` and returns a
:class:`Cost` of three totals:

  * flops — ``torch.utils.flop_counter``'s formulas for the aten ops
    (matmuls, convolutions, attention ops), the ops decomposed first where
    ``FlopCounterMode`` decomposes them, so the two agree op for op;
  * bytes — operands plus outputs of each aten op, each tensor at its
    logical size; views, reshapes, metadata queries, allocations without a
    write, ``arange`` and host reads of a scalar move nothing and count
    nothing (as ``hlo_cost._SKIP_BYTES`` skips bitcasts, reshapes,
    broadcasts, iotas and parameters);
  * collectives — bytes each collective delivers, by kind (the reference's
    HLO kinds): every ``torch.distributed`` collective and point-to-point
    op (a send counts at its receiver), and every ``LocalRing.shift`` as a
    ``collective-permute`` of what its hop would move between cards.

The hand-written kernels are ``ctypes`` calls the dispatch mode never
sees.  Each kernel entry therefore reports its call's work
(``analysis.kernel_work``) through :func:`kernel`, and the aten ops inside
the entry (its outputs' allocation on the card, its plain version's whole
arithmetic on the CPU, its meta route's shapes) are not counted.  A step
thus counts the same on the card, the CPU and the meta device.  The
"inside a kernel" state is the mode's own, not a thread's: autograd runs
the flash backward on its device thread, where the mode is active too.

The mode also tracks the bytes of live storages it sees created, for the
peak of a run's intermediates (:attr:`CostMode.peak_bytes`).
"""
from __future__ import annotations

import dataclasses
import weakref
from collections.abc import Callable

import torch
from torch.utils._python_dispatch import (TorchDispatchMode,
                                          _get_current_dispatch_mode_stack)
from torch.utils._pytree import tree_leaves
from torch.utils.flop_counter import flop_registry

from .kernel_work import Work

aten = torch.ops.aten

# metadata queries: FlopCounterMode hands them back (subclass dispatch)
_METADATA = {aten.sym_is_contiguous.default, aten.is_contiguous.default,
             aten.is_contiguous.memory_format,
             aten.is_strides_like_format.default,
             aten.is_non_overlapping_and_dense.default, aten.size.default,
             aten.sym_size.default, aten.stride.default,
             aten.sym_stride.default, aten.storage_offset.default,
             aten.sym_storage_offset.default, aten.numel.default,
             aten.sym_numel.default, aten.dim.default,
             torch.ops.prim.layout.default}

# ops that move no bytes: views and reshapes are caught by ``is_view``
_SKIP_BYTES = {aten._unsafe_view, aten.alias, aten.detach, aten.lift_fresh,
               aten.empty, aten.empty_like, aten.empty_strided,
               aten.new_empty, aten.new_empty_strided, aten.arange,
               aten._local_scalar_dense, aten.set_}

# torch.distributed's ops by the HLO collective kind they are; the bytes
# are those of the first argument's tensors (the in-place outputs)
_C10D = {"allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
         "allgather_": "all-gather", "_allgather_base_": "all-gather",
         "allgather_coalesced_": "all-gather",
         "allgather_into_tensor_coalesced_": "all-gather",
         "reduce_scatter_": "reduce-scatter",
         "_reduce_scatter_base_": "reduce-scatter",
         "reduce_scatter_tensor_coalesced_": "reduce-scatter",
         "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
         "recv_": "collective-permute",
         "recv_any_source_": "collective-permute",
         "broadcast_": "broadcast", "reduce_": "reduce",
         "gather_": "gather", "scatter_": "scatter", "send": None,
         "barrier": None, "monitored_barrier_": None}
# the functional collectives: the bytes are those of their outputs
_FUNCTIONAL = {"all_reduce": "all-reduce", "all_reduce_": "all-reduce",
               "all_reduce_coalesced": "all-reduce",
               "all_gather_into_tensor": "all-gather",
               "all_gather_into_tensor_coalesced": "all-gather",
               "reduce_scatter_tensor": "reduce-scatter",
               "reduce_scatter_tensor_coalesced": "reduce-scatter",
               "all_to_all_single": "all-to-all", "broadcast": "broadcast",
               "wait_tensor": None}


def _nbytes(x) -> int:
    return x.numel() * x.element_size() if isinstance(x, torch.Tensor) \
        else 0


@dataclasses.dataclass
class Cost:
    """A run's totals: ``flops``, HBM ``bytes``, ``collectives`` (bytes by
    kind), and ``kernels`` (each hand-written kernel's calls, flops and
    bytes, which the totals include)."""
    flops: float = 0.0
    bytes: float = 0.0
    collectives: dict[str, float] = dataclasses.field(default_factory=dict)
    kernels: dict[str, dict[str, float]] = dataclasses.field(
        default_factory=dict)

    def totals(self) -> tuple[float, float, dict[str, float]]:
        """(flops, bytes, collectives): what two counts of one step must
        agree on."""
        return self.flops, self.bytes, dict(self.collectives)


@dataclasses.dataclass(frozen=True)
class _OpInfo:
    """What the mode needs to know of one op overload, worked out once."""
    decomposes: bool        # FlopCounterMode would decompose it first
    view: bool              # a view: no bytes, no flops, no new storage
    memo: bool              # functional: its meta outputs depend on shapes
    flops: Callable | None  # flop_counter's formula
    moves_bytes: bool
    collective: str | None  # "c10d" | "_c10d_functional" | None


def _op_info(func) -> _OpInfo | None:
    """None for a metadata query (handed back, as FlopCounterMode does)."""
    if func in _METADATA:
        return None
    dk = torch._C.DispatchKey.CompositeImplicitAutograd
    schema = func._schema
    decomposes = dk in func.py_kernels or \
        torch._C._dispatch_has_kernel_for_dispatch_key(func.name(), dk)
    memo = not (schema.is_mutable or func.is_view or
                any(r.alias_info is not None for r in schema.returns))
    packet = func._overloadpacket
    coll = func.namespace if func.namespace in ("c10d",
                                                "_c10d_functional") else None
    return _OpInfo(decomposes, func.is_view and not decomposes,
                   memo and coll is None,
                   flop_registry.get(packet),
                   not (func.is_view or packet in _SKIP_BYTES), coll)


def _leaves(tree, out: list) -> list:
    """The leaves of an op's (args, kwargs), tensors and scalars alike."""
    for x in tree:
        if type(x) in (list, tuple):
            _leaves(x, out)
        else:
            out.append(x)
    return out


_PLAIN = (int, float, bool, str, type(None), torch.dtype, torch.device,
          torch.memory_format, torch.layout)


def _meta_key(leaves: list):
    """A hashable description of an op's arguments when they hold a
    tensor and every tensor among them lies on the meta device (a
    functional op's outputs then depend on their shapes, strides and dtypes
    and on the other arguments alone), else None."""
    key = []
    meta = False
    for x in leaves:
        if isinstance(x, torch.Tensor):
            if not x.is_meta:
                return None
            meta = True
            key.append((x.shape, x.stride(), x.dtype))
        elif isinstance(x, _PLAIN):
            key.append(x)
        else:
            try:
                hash(x)
            except TypeError:
                return None
            key.append(x)
    return tuple(key) if meta else None


def _out_spec(out):
    """(structure, [(shape, stride, dtype)]) of a functional op's output,
    or None when it holds anything but meta tensors."""
    flat = out if isinstance(out, (list, tuple)) else (out,)
    if not all(isinstance(t, torch.Tensor) and t.is_meta for t in flat):
        return None
    return (type(out) if isinstance(out, (list, tuple)) else None,
            [(t.shape, t.stride(), t.dtype) for t in flat])


def _rebuild(spec):
    kind, parts = spec
    ts = [torch.empty_strided(shape, stride, dtype=dtype, device="meta")
          for shape, stride, dtype in parts]
    return ts[0] if kind is None else kind(ts)


class CostMode(TorchDispatchMode):
    """Counts every aten op run inside the ``with`` block into
    :attr:`cost`; the kernel entries report into it through
    :func:`kernel`, the rings through :func:`collective`.  ``peak_bytes``:
    the most bytes held at once by storages created inside the block
    (views share their base's storage; storages that existed before are
    not counted).

    On the meta device a functional op's outputs depend only on its
    arguments' shapes, strides and dtypes, so the mode runs each such
    signature's meta kernel once and hands later calls fresh outputs of
    the recorded layouts: the same ops are counted, at a fraction of the
    host time PyTorch's Python meta kernels take (``memo=False`` runs every
    meta kernel: the tests' check that the counts agree)."""

    def __init__(self, memo: bool = True):
        super().__init__()
        self.memo = memo
        self.cost = Cost()
        self.peak_bytes = 0
        self._live_bytes = 0
        self._inside = 0            # depth of kernel entries being run
        self._refs: dict[int, weakref.ref] = {}
        self._info: dict = {}
        self._memo: dict = {}

    # -- memory -----------------------------------------------------------
    def _track(self, ins, outs) -> None:
        refs = self._refs
        for t in ins:
            st = t.untyped_storage()
            key = st._cdata
            if key not in refs:
                # existed before the block: forgotten when freed, so a new
                # storage at its address counts
                refs[key] = weakref.ref(st, self._forgetter(key, 0))
        for t in outs:
            st = t.untyped_storage()
            key = st._cdata
            if key in refs:
                continue
            n = st.nbytes()
            refs[key] = weakref.ref(st, self._forgetter(key, n))
            self._live_bytes += n
            if self._live_bytes > self.peak_bytes:
                self.peak_bytes = self._live_bytes

    def _forgetter(self, key: int, nbytes: int):
        def forget(ref):
            if self._refs.get(key) is ref:
                del self._refs[key]
                self._live_bytes -= nbytes
        return forget

    # -- counting ---------------------------------------------------------
    def _op_cost(self, func, info: _OpInfo, args, kwargs, out, ins,
                 outs) -> tuple[float, float]:
        """(flops, bytes) of one aten op; a collective's bytes go to
        ``collectives`` instead (when not inside a kernel entry)."""
        if info.collective is not None:
            table = _C10D if info.collective == "c10d" else _FUNCTIONAL
            kind = table.get(func._opname, func._opname)
            if kind is not None and not self._inside:
                src = (tree_leaves(args[0]) if info.collective == "c10d"
                       else outs)
                self._collective(kind, sum(_nbytes(t) for t in src))
            return 0.0, 0.0
        flops = info.flops(*args, **kwargs, out_val=out) \
            if info.flops is not None else 0.0
        nbytes = sum(t.nbytes for t in ins) + sum(t.nbytes for t in outs) \
            if info.moves_bytes else 0.0
        return flops, nbytes

    def _collective(self, kind: str, nbytes: float) -> None:
        c = self.cost.collectives
        c[kind] = c.get(kind, 0) + nbytes

    def _kernel(self, work: Work) -> None:
        cost = self.cost
        cost.flops += work.flops
        cost.bytes += work.bytes
        k = cost.kernels.setdefault(work.name,
                                    {"calls": 0, "flops": 0.0, "bytes": 0.0})
        k["calls"] += 1
        k["flops"] += work.flops
        k["bytes"] += work.bytes

    def _add(self, flops: float, nbytes: float) -> None:
        if not self._inside:
            self.cost.flops += flops
            self.cost.bytes += nbytes

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        info = self._info.get(func, self)
        if info is self:
            info = self._info[func] = _op_info(func)
        if info is None:
            return NotImplemented
        if info.view:
            return func(*args, **kwargs)
        if info.decomposes and not self._inside:
            # decompose where FlopCounterMode does, so both count the same
            # ops
            with self:
                r = func.decompose(*args, **kwargs)
            if r is not NotImplemented:
                return r
        leaves = _leaves(args, [])
        if kwargs:
            _leaves(kwargs.values(), leaves)
        key = None
        if info.memo and self.memo:
            mk = _meta_key(leaves)
            if mk is not None:
                key = (func, mk)
                hit = self._memo.get(key)
                if hit is not None:
                    # the same signature ran before: its outputs' layouts
                    # and its cost are known (its inputs were tracked then)
                    spec, flops, nbytes = hit
                    out = _rebuild(spec)
                    self._track((), out if isinstance(out, (list, tuple))
                                else (out,))
                    self._add(flops, nbytes)
                    return out
        out = func(*args, **kwargs)
        ins = [t for t in leaves if isinstance(t, torch.Tensor)]
        outs = [t for t in (out if isinstance(out, (list, tuple))
                            else (out,)) if isinstance(t, torch.Tensor)]
        self._track(ins, outs)
        flops, nbytes = self._op_cost(func, info, args, kwargs, out, ins,
                                      outs)
        self._add(flops, nbytes)
        if key is not None:
            spec = _out_spec(out)
            if spec is not None:
                self._memo[key] = (spec, flops, nbytes)
        return out


class CollectiveMode(CostMode):
    """A :class:`CostMode` that counts the collectives alone (``cost.
    collectives``; the rings' reports through :func:`collective`, and the
    ``torch.distributed`` ops), every other op running as it is: a
    step's collective bytes by kind on the card at a small part of the
    full count's host time."""

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ns = func.namespace
        if ns in ("c10d", "_c10d_functional") and not self._inside:
            table = _C10D if ns == "c10d" else _FUNCTIONAL
            kind = table.get(func._opname, func._opname)
            if kind is not None:
                src = tree_leaves(args[0] if ns == "c10d" else out)
                self._collective(kind, sum(_nbytes(t) for t in src))
        return out


def active() -> CostMode | None:
    """The innermost active :class:`CostMode`, or None."""
    for m in reversed(_get_current_dispatch_mode_stack()):
        if isinstance(m, CostMode):
            return m
    return None


class kernel:
    """``with kernel(*works):`` around a kernel entry's call: report each of
    ``works`` (a :class:`Work`, or a function giving one or a tuple of
    them, called only when a counter is active: a data-dependent work may
    read its data) and count none of the aten ops run inside.  A kernel
    entry inside another reports nothing."""

    __slots__ = ("works", "mode")

    def __init__(self, *works: Work | Callable[[], Work | tuple[Work, ...]]):
        self.works = works
        self.mode = None

    def __enter__(self) -> None:
        m = active()
        if m is None or m._inside:
            return
        m._inside += 1        # a work's own reads are not counted either
        self.mode = m
        try:
            for w in self.works:
                w = w() if callable(w) else w
                for one in w if isinstance(w, tuple) else (w,):
                    m._kernel(one)
        except BaseException:
            self.__exit__()
            raise

    def __exit__(self, *exc) -> None:
        if self.mode is not None:
            self.mode._inside -= 1
            self.mode = None


def collective(kind: str, nbytes: float) -> None:
    """Report a collective that no ``torch.distributed`` op carries (a
    ``LocalRing`` hop or sum): ``nbytes`` delivered, summed over the
    ranks."""
    m = active()
    if m is not None and not m._inside:
        m._collective(kind, nbytes)


def count(fn: Callable, *args, **kwargs) -> Cost:
    """Run ``fn(*args, **kwargs)`` under a :class:`CostMode` and return its
    :class:`Cost`."""
    with CostMode() as m:
        fn(*args, **kwargs)
    return m.cost

