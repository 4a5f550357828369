"""NDRange tensor-op formulation (paper §II-A, Eq. 1-3).

Every VectorMesh target workload is written as

    C(parallel idxs) = sum_{temporal idxs} R_A(...) * R_B(...)

where each operand R_X is an *affine view* of a stored tensor: every stored-tensor
dimension is an affine combination of NDRange indices (e.g. for conv,
``R_I(i,j,k,l,m,n) = I(l, j+m, k+n)``).  The parallel/temporal split plus these
affine index maps are the entire scheduling interface: tiling (paper Eq. 4), the
data-exchange partial-derivative test (paper Fig. 2), and the bandwidth model all
derive from them.
"""
from __future__ import annotations

import dataclasses
import itertools
import math
from typing import Mapping, Sequence

PARALLEL = "parallel"
TEMPORAL = "temporal"


@dataclasses.dataclass(frozen=True)
class Dim:
    """One NDRange dimension."""

    name: str
    size: int
    kind: str  # PARALLEL | TEMPORAL

    def __post_init__(self):
        if self.kind not in (PARALLEL, TEMPORAL):
            raise ValueError(f"bad dim kind {self.kind!r}")
        if self.size <= 0:
            raise ValueError(f"dim {self.name} has non-positive size {self.size}")


@dataclasses.dataclass(frozen=True)
class AffineExpr:
    """sum_i coeff[dim_i] * dim_i + const — one stored-tensor axis index."""

    coeffs: tuple[tuple[str, int], ...]  # ((dim_name, coeff), ...) sorted
    const: int = 0

    @staticmethod
    def of(coeffs: Mapping[str, int], const: int = 0) -> "AffineExpr":
        items = tuple(sorted((k, v) for k, v in coeffs.items() if v != 0))
        return AffineExpr(items, const)

    def depends_on(self, dim_name: str) -> bool:
        """The paper's partial-derivative test: d(expr)/d(dim) != 0."""
        return any(k == dim_name for k, _ in self.coeffs)

    def coeff(self, dim_name: str) -> int:
        for k, v in self.coeffs:
            if k == dim_name:
                return v
        return 0

    def extent(self, tile: Mapping[str, int]) -> int:
        """Number of distinct values this expression takes over a tile.

        For an affine expression the exact count over a box is the range span
        (affine maps over boxes hit a contiguous-ish set; we use the standard
        footprint bound  1 + sum |c_i| (t_i - 1)  which is exact for conv-style
        stride-1 maps and for single-dim maps).
        """
        span = 1
        for k, c in self.coeffs:
            span += abs(c) * (tile[k] - 1)
        return span


@dataclasses.dataclass(frozen=True)
class OperandView:
    """R_X: an affine view of stored tensor `tensor_name` with dtype-size bytes."""

    tensor_name: str
    index_exprs: tuple[AffineExpr, ...]  # one per stored-tensor axis
    bytes_per_elem: int = 2  # bf16 default

    def footprint_elems(self, tile: Mapping[str, int]) -> int:
        """Unique stored elements touched by a tile (product of per-axis extents)."""
        n = 1
        for e in self.index_exprs:
            n *= e.extent(tile)
        return n

    def footprint_bytes(self, tile: Mapping[str, int]) -> int:
        return self.footprint_elems(tile) * self.bytes_per_elem

    def invariant_dims(self, dims: Sequence[Dim]) -> tuple[str, ...]:
        """NDRange dims this operand does NOT depend on (zero partial derivative).

        These are exactly the axes along which neighbouring tiles can SHARE this
        operand over the FIFO mesh (paper §II-B: ``d(i,k)/dj = 0`` => share A).
        """
        out = []
        for d in dims:
            if not any(e.depends_on(d.name) for e in self.index_exprs):
                out.append(d.name)
        return tuple(out)


@dataclasses.dataclass(frozen=True)
class TensorOp:
    """C(parallel) = sum_{temporal} prod_k R_k(...) — the paper's workload form."""

    name: str
    dims: tuple[Dim, ...]
    inputs: tuple[OperandView, ...]
    output: OperandView  # indexed by parallel dims only
    macs_per_point: int = 1

    def __post_init__(self):
        names = [d.name for d in self.dims]
        if len(set(names)) != len(names):
            raise ValueError("duplicate dim names")
        # Output must not depend on temporal dims (PSum-stationary property).
        for d in self.dims:
            if d.kind == TEMPORAL:
                for e in self.output.index_exprs:
                    if e.depends_on(d.name):
                        raise ValueError(
                            f"output depends on temporal dim {d.name}; "
                            "not expressible as a reduction"
                        )

    # -- basic quantities -------------------------------------------------
    @property
    def dim_map(self) -> dict[str, Dim]:
        return {d.name: d for d in self.dims}

    @property
    def parallel_dims(self) -> tuple[Dim, ...]:
        return tuple(d for d in self.dims if d.kind == PARALLEL)

    @property
    def temporal_dims(self) -> tuple[Dim, ...]:
        return tuple(d for d in self.dims if d.kind == TEMPORAL)

    def total_points(self) -> int:
        return math.prod(d.size for d in self.dims)

    def total_macs(self) -> int:
        return self.total_points() * self.macs_per_point

    def full_tile(self) -> dict[str, int]:
        return {d.name: d.size for d in self.dims}

    # -- tiling quantities (paper Eq. 4 analysis) -------------------------
    def tile_macs(self, tile: Mapping[str, int]) -> int:
        return math.prod(tile[d.name] for d in self.dims) * self.macs_per_point

    def tile_psum_elems(self, tile: Mapping[str, int]) -> int:
        return self.output.footprint_elems(tile)

    def tile_input_bytes(self, tile: Mapping[str, int]) -> int:
        return sum(v.footprint_bytes(tile) for v in self.inputs)

    def tile_bytes_per_mac(self, tile: Mapping[str, int]) -> float:
        """Paper's objective: (t_i+t_j)t_k / (t_i t_j t_k) generalized."""
        return self.tile_input_bytes(tile) / max(1, self.tile_macs(tile))

    def num_tiles(self, tile: Mapping[str, int]) -> int:
        return math.prod(
            -(-d.size // tile[d.name]) for d in self.dims  # ceil-div
        )

    def grid_shape(self, tile: Mapping[str, int]) -> dict[str, int]:
        return {d.name: -(-d.size // tile[d.name]) for d in self.dims}

    def validate_tile(self, tile: Mapping[str, int]) -> None:
        for d in self.dims:
            t = tile.get(d.name)
            if t is None or t < 1 or t > d.size:
                raise ValueError(f"tile for {d.name} out of range: {t}")


# ---------------------------------------------------------------------------
# Constructors for the paper's three workload families (Eq. 1, 2, 3).
# ---------------------------------------------------------------------------

def matmul_op(M: int, N: int, K: int, *, bytes_per_elem: int = 2,
              name: str = "matmul") -> TensorOp:
    """Eq. (1): C(i,j) = sum_k A(i,k) B(k,j)."""
    dims = (
        Dim("i", M, PARALLEL),
        Dim("j", N, PARALLEL),
        Dim("k", K, TEMPORAL),
    )
    A = OperandView("A", (AffineExpr.of({"i": 1}), AffineExpr.of({"k": 1})),
                    bytes_per_elem)
    B = OperandView("B", (AffineExpr.of({"k": 1}), AffineExpr.of({"j": 1})),
                    bytes_per_elem)
    C = OperandView("C", (AffineExpr.of({"i": 1}), AffineExpr.of({"j": 1})),
                    bytes_per_elem)
    return TensorOp(name, dims, (A, B), C)


def conv2d_op(Co: int, Ci: int, oh: int, ow: int, kh: int, kw: int, *,
              stride: int = 1, dilation: int = 1, bytes_per_elem: int = 2,
              name: str = "conv2d") -> TensorOp:
    """Eq. (2): C(co,y,x) = sum_{ci,m,n} I(ci, y*s+m*d, x*s+n*d) K(co,ci,m,n)."""
    dims = (
        Dim("co", Co, PARALLEL),
        Dim("y", oh, PARALLEL),
        Dim("x", ow, PARALLEL),
        Dim("ci", Ci, TEMPORAL),
        Dim("m", kh, TEMPORAL),
        Dim("n", kw, TEMPORAL),
    )
    I = OperandView(
        "I",
        (
            AffineExpr.of({"ci": 1}),
            AffineExpr.of({"y": stride, "m": dilation}),
            AffineExpr.of({"x": stride, "n": dilation}),
        ),
        bytes_per_elem,
    )
    Kv = OperandView(
        "K",
        (
            AffineExpr.of({"co": 1}),
            AffineExpr.of({"ci": 1}),
            AffineExpr.of({"m": 1}),
            AffineExpr.of({"n": 1}),
        ),
        bytes_per_elem,
    )
    C = OperandView(
        "C",
        (AffineExpr.of({"co": 1}), AffineExpr.of({"y": 1}), AffineExpr.of({"x": 1})),
        bytes_per_elem,
    )
    return TensorOp(name, dims, (I, Kv), C)


def depthwise_conv2d_op(C_: int, oh: int, ow: int, kh: int, kw: int, *,
                        stride: int = 1, bytes_per_elem: int = 2,
                        name: str = "dwconv2d") -> TensorOp:
    """MobileNet depthwise conv: no channel reduction; C(c,y,x)=sum_{m,n}."""
    dims = (
        Dim("c", C_, PARALLEL),
        Dim("y", oh, PARALLEL),
        Dim("x", ow, PARALLEL),
        Dim("m", kh, TEMPORAL),
        Dim("n", kw, TEMPORAL),
    )
    I = OperandView(
        "I",
        (
            AffineExpr.of({"c": 1}),
            AffineExpr.of({"y": stride, "m": 1}),
            AffineExpr.of({"x": stride, "n": 1}),
        ),
        bytes_per_elem,
    )
    Kv = OperandView(
        "K",
        (AffineExpr.of({"c": 1}), AffineExpr.of({"m": 1}), AffineExpr.of({"n": 1})),
        bytes_per_elem,
    )
    C = OperandView(
        "C",
        (AffineExpr.of({"c": 1}), AffineExpr.of({"y": 1}), AffineExpr.of({"x": 1})),
        bytes_per_elem,
    )
    return TensorOp(name, dims, (I, Kv), C)


def correlation_op(sw: int, sh: int, ow: int, oh: int, Ci: int, *,
                   bytes_per_elem: int = 2, name: str = "correlation") -> TensorOp:
    """Eq. (3): C(i,j,k,l) = sum_m I1(m,i,j) I2(m,i+k,j+l) — spatial matching."""
    dims = (
        Dim("i", sw, PARALLEL),
        Dim("j", sh, PARALLEL),
        Dim("k", ow, PARALLEL),
        Dim("l", oh, PARALLEL),
        Dim("m", Ci, TEMPORAL),
    )
    I1 = OperandView(
        "I1",
        (AffineExpr.of({"m": 1}), AffineExpr.of({"i": 1}), AffineExpr.of({"j": 1})),
        bytes_per_elem,
    )
    I2 = OperandView(
        "I2",
        (
            AffineExpr.of({"m": 1}),
            AffineExpr.of({"i": 1, "k": 1}),
            AffineExpr.of({"j": 1, "l": 1}),
        ),
        bytes_per_elem,
    )
    C = OperandView(
        "C",
        (
            AffineExpr.of({"i": 1}),
            AffineExpr.of({"j": 1}),
            AffineExpr.of({"k": 1}),
            AffineExpr.of({"l": 1}),
        ),
        bytes_per_elem,
    )
    return TensorOp(name, dims, (I1, I2), C)


def attention_scores_op(heads: int, q_len: int, kv_len: int, head_dim: int, *,
                        bytes_per_elem: int = 2,
                        name: str = "attn_qk") -> TensorOp:
    """QK^T as a batched matmul — the LM-scale 'spatial matching' analogue."""
    dims = (
        Dim("h", heads, PARALLEL),
        Dim("q", q_len, PARALLEL),
        Dim("s", kv_len, PARALLEL),
        Dim("d", head_dim, TEMPORAL),
    )
    Q = OperandView(
        "Q",
        (AffineExpr.of({"h": 1}), AffineExpr.of({"q": 1}), AffineExpr.of({"d": 1})),
        bytes_per_elem,
    )
    Kv = OperandView(
        "K",
        (AffineExpr.of({"h": 1}), AffineExpr.of({"s": 1}), AffineExpr.of({"d": 1})),
        bytes_per_elem,
    )
    C = OperandView(
        "S",
        (AffineExpr.of({"h": 1}), AffineExpr.of({"q": 1}), AffineExpr.of({"s": 1})),
        bytes_per_elem,
    )
    return TensorOp(name, dims, (Q, Kv), C)


def tile_candidates(op: TensorOp, *, caps: Mapping[str, int] | None = None,
                    pow2: bool = True) -> list[list[int]]:
    """Per-dim candidate tile sizes, sorted ascending, one list per op dim.

    ``pow2=True`` (default): powers of two up to the (possibly capped) dim
    size, plus the capped size itself.  ``pow2=False``: a denser ladder that
    also includes the 1.5x midpoints (1, 2, 3, 4, 6, 8, 12, 16, 24, ...).
    This is the single source of truth for the candidate lattice — both the
    brute-force ``enumerate_tiles`` and the vectorized engine in
    ``repro_torch.core.autotune`` draw from it, which is what makes their results
    provably identical.
    """
    axes = []
    for d in op.dims:
        cap = min(d.size, (caps or {}).get(d.name, d.size))
        vals = set()
        v = 1
        while v <= cap:
            vals.add(v)
            if not pow2 and v > 1 and v + v // 2 <= cap:
                vals.add(v + v // 2)
            v *= 2
        vals.add(cap)
        axes.append(sorted(vals))
    return axes


def enumerate_tiles(op: TensorOp, *, caps: Mapping[str, int] | None = None,
                    pow2: bool = True) -> "itertools.product":
    """Candidate tile iterator: powers of two (and the full size) per dim."""
    axes = tile_candidates(op, caps=caps, pow2=pow2)
    names = [d.name for d in op.dims]
    for combo in itertools.product(*axes):
        yield dict(zip(names, combo))
