"""The port's copy of the paper's scheduler (``repro_torch.core``) and its
workload catalog (``repro_torch.sim``) against the JAX package's: the same
integer arithmetic, so every result is held equal exactly.  Also the Hopper
re-target of the GEMM search (``cuda_bridge.matmul_block_shapes``): every
tile it returns, on the wgmma route and on the CUDA-core one, is one that
``csrc/matmul.cu`` is built for, fits one CTA's shared memory and
registers, and (wgmma) fills the card's 132 SMs wherever the problem has
that many 64 x 64 tiles; and the two packages keep their disk caches
apart."""
import dataclasses
import itertools

import pytest

pytest.importorskip("torch")

from repro import core as ref_core  # noqa: E402
from repro import sim as ref_sim  # noqa: E402
from repro.core import pallas_bridge as ref_bridge  # noqa: E402
from repro_torch import core as pt_core  # noqa: E402
from repro_torch import sim as pt_sim  # noqa: E402
from repro_torch.core import autotune as pt_autotune  # noqa: E402
from repro_torch.core import cuda_bridge  # noqa: E402

NAMES = [w.name for w in ref_sim.ALL]
GEMMS = [w.name for w in ref_sim.GEMM]


def _pair(name):
    return ref_sim.by_name(name).op, pt_sim.by_name(name).op


def _d(x):
    return dataclasses.asdict(x)


def test_catalog_is_the_reference_catalog():
    assert [w.name for w in pt_sim.ALL] == NAMES and len(NAMES) == 25
    for name in NAMES:
        r, p = ref_sim.by_name(name), pt_sim.by_name(name)
        assert r.family == p.family
        # two packages, two AffineExpr classes: compare their reprs
        assert repr(pt_autotune.op_signature(p.op)) == \
            repr(ref_core.op_signature(r.op))
        assert p.op.total_macs() == r.op.total_macs()


@pytest.mark.parametrize("name", NAMES)
def test_search_tiles_equal(name):
    r, p = _pair(name)
    rs = ref_core.search_tiles(r, ref_core.TEU_BUFFER)
    ps = pt_core.search_tiles(p, pt_core.TEU_BUFFER)
    assert ps.tile == rs.tile and ps.bytes_per_mac == rs.bytes_per_mac
    assert _d(ps) == _d(rs)


@pytest.mark.parametrize("name", NAMES)
def test_grid_order_and_mesh_exchange_equal(name):
    r, p = _pair(name)
    tile = ref_core.search_tiles(r, ref_core.TEU_BUFFER).tile
    assert _d(pt_core.order_grid_for_sharing(p, tile)) == \
        _d(ref_core.order_grid_for_sharing(r, tile))
    assert _d(pt_core.plan_mesh_exchange(p, tile, (4, 4))) == \
        _d(ref_core.plan_mesh_exchange(r, tile, (4, 4)))


@pytest.mark.parametrize("name", GEMMS)
def test_traffic_with_shared_axes_equal(name):
    r, p = _pair(name)
    tile = ref_core.search_tiles(r, ref_core.TEU_BUFFER).tile
    for shared in ((), ("i",), ("j",), ("i", "j")):
        rt = ref_core.traffic(r, tile, shared_axes=shared)
        pt = pt_core.traffic(p, tile, shared_axes=shared)
        assert _d(pt) == _d(rt)
        assert pt.normalized_access() == rt.normalized_access()


GEMM_SWEEP = [(1, 256, 96), (8, 4096, 9216), (70, 50, 130), (128, 64, 32),
              (256, 512, 1024), (1024, 1024, 1024), (1000, 3000, 200),
              (4096, 4096, 4096), (33, 129, 257)]


@pytest.mark.parametrize("M,N,K", GEMM_SWEEP)
def test_plan_kernel_with_reference_arguments_equals_reference(M, N, K):
    """The reference's own call (``pallas_bridge.matmul_block_shapes``):
    the same budget, alignment and op give the same plan."""
    kw = dict(vmem_budget_bytes=8 * 1024 * 1024,
              psum_budget_bytes=4 * 1024 * 1024,
              align={"i": 128 if M >= 128 else 1,
                     "j": 128 if N >= 128 else 1,
                     "k": 128 if K >= 128 else 1})
    rp = ref_bridge.plan_kernel(ref_core.matmul_op(M, N, K), **kw)
    pp = cuda_bridge.plan_kernel(pt_core.matmul_op(M, N, K), **kw)
    assert _d(pp) == _d(rp)
    assert (pp.block["i"], pp.block["j"], pp.block["k"]) == \
        ref_bridge.matmul_block_shapes(M, N, K)
    # and with the reference's defaults (its TPU budget)
    assert _d(cuda_bridge.plan_kernel(pt_core.conv2d_op(16, 8, 9, 9, 3, 3))) \
        == _d(ref_bridge.plan_kernel(ref_core.conv2d_op(16, 8, 9, 9, 3, 3)))


def test_quickstart_flow_gives_the_same_numbers():
    """``examples/quickstart.py`` steps 1-3 (NDRange form, TEU tile, 4x4
    mesh exchange) and its grid order, through both packages."""
    out = []
    for core in (ref_core, pt_core):
        op = core.matmul_op(1024, 1024, 1024)
        sched = core.search_tiles(op, core.TEU_BUFFER)
        plan = core.plan_mesh_exchange(op, sched.tile, (4, 4))
        order = core.order_grid_for_sharing(op, sched.tile)
        out.append((op.total_macs(), sched.tile, sched.bytes_per_mac,
                    plan.row_axis, plan.col_axis, plan.sharing_factor,
                    plan.fifo_hop_bytes, order.order))
    assert out[0] == out[1]


HOPPER_SWEEP = sorted(set(itertools.product(
    (1, 2, 7, 8, 9, 31, 33, 63, 64, 65, 100, 128, 130, 512, 1000, 4096),
    (1, 27, 64, 65, 125, 128, 192, 1000, 4096),
    (1, 3, 31, 32, 33, 64, 96, 100, 1024, 9216))))


def _check_hopper_tile(M, N, K, route="matmul"):
    cb = cuda_bridge
    bm, bn, bk = cb.matmul_block_shapes(M, N, K, route=route)
    if route == "matmul":
        assert (bm, bn, bk) in cb.WGMMA_TILES
        # bf16 tiles in a ring of STAGES stages
        assert (bm + bn) * bk * 2 * cb.STAGES <= cb.SMEM_BUDGET
        # the accumulator: bn / 2 f32 registers per consumer thread, at
        # most 128, over bm / 64 warpgroups
        assert bm * bn * 4 <= cb.WGMMA_ACC_BUDGET and bn // 2 <= 128
        ctas = cb.grid_ctas(M, N, bm, bn)
        if cb.grid_ctas(M, N, 64, 64) >= cb.SM_COUNT:
            assert ctas >= cb.SM_COUNT == 132
        else:                       # as many CTAs as the problem allows
            assert (bm, bn) == (64, 64)
    else:
        assert (bm, bn, bk) in cb.MATMUL_TILES
        assert (bm + bn) * bk * cb.SIMT_STAGE_BYTES <= cb.SMEM_BUDGET
        assert bm * bn * 4 <= cb.ACC_BUDGET
    assert cb.SMEM_BUDGET <= cb.SMEM_PER_CTA == 232448
    return bm, bn, bk


def test_hopper_tiles_of_the_catalog_gemms():
    """GEMM_1K (bf16, M 1024) takes the wgmma route, on the 64 x 64 tile
    that gives 256 CTAs for 132 SMs (the largest, 128 x 256, gives 32);
    GEMM_FC (M 1) takes the split-K GEMV route: 64 strips x 8 splits of
    1,152 = 512 CTAs."""
    import torch
    from repro_torch.kernels import matmul as kmm
    got = {}
    for w in pt_sim.GEMM:
        M, N, K = (w.op.dim_map[d].size for d in "ijk")
        a = torch.empty((M, K), dtype=torch.bfloat16)
        b = torch.empty((K, N), dtype=torch.bfloat16)
        route = kmm.matmul_route(a, b)
        got[w.name] = (route, _check_hopper_tile(M, N, K) if
                       route == "matmul" else cuda_bridge.gemv_plan(M, N, K))
    assert got == {"GEMM_1K": ("matmul", (64, 64, 64)),
                   "GEMM_FC": ("matmul_gemv", (8, 1152))}
    # the CUDA-core route keeps its lattice (M raised to 8, as before)
    assert _check_hopper_tile(1024, 1024, 1024, "matmul_simt") == \
        (128, 128, 64)
    assert _check_hopper_tile(8, 4096, 9216, "matmul_simt") == (8, 128, 64)


@pytest.mark.parametrize("M", sorted({m for m, _, _ in HOPPER_SWEEP}))
def test_hopper_tiles_are_built_and_fit(M):
    for m, n, k in HOPPER_SWEEP:
        if m == M:
            _check_hopper_tile(m, n, k, "matmul")
            _check_hopper_tile(m, n, k, "matmul_simt")


def test_hopper_search_refuses_to_substitute(monkeypatch):
    monkeypatch.setattr(cuda_bridge, "MATMUL_TILES", frozenset())
    with pytest.raises(ValueError, match="not built for"):
        cuda_bridge.matmul_block_shapes(640, 640, 640, route="matmul_simt")
    monkeypatch.setattr(cuda_bridge, "WGMMA_TILES", frozenset())
    with pytest.raises(ValueError, match="not built for"):
        cuda_bridge.matmul_block_shapes(640, 640, 640)
    with pytest.raises(ValueError, match="no tile search"):
        cuda_bridge.matmul_block_shapes(1, 640, 640, route="matmul_gemv")


def test_disk_caches_are_kept_apart(monkeypatch, tmp_path):
    """With the disk tier on, each package writes under its own directory,
    and the reference's directory variable does not move the port's."""
    from repro.core import autotune as ref_autotune
    monkeypatch.chdir(tmp_path)
    monkeypatch.setenv("REPRO_SCHED_DISK_CACHE", "1")
    monkeypatch.delenv("REPRO_CACHE_DIR", raising=False)
    monkeypatch.delenv("REPRO_TORCH_CACHE_DIR", raising=False)
    assert ref_autotune._disk_cache_dir() != pt_autotune._disk_cache_dir()
    # a shape no other test searches, so both engines compute and write
    ref_core.search_tiles(ref_core.matmul_op(321, 123, 77), ref_core.TEU_BUFFER)
    pt_core.search_tiles(pt_core.matmul_op(321, 123, 77), pt_core.TEU_BUFFER)
    ref_dir = tmp_path / ".cache" / "repro_scheduler"
    pt_dir = tmp_path / ".cache" / "repro_torch_scheduler"
    assert len(list(ref_dir.glob("*.json"))) == 1
    assert len(list(pt_dir.glob("*.json"))) == 1
    monkeypatch.setenv("REPRO_CACHE_DIR", str(tmp_path / "shared"))
    assert pt_autotune._disk_cache_dir() == str(pt_dir.relative_to(tmp_path))
