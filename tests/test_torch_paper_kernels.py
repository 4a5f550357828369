"""The paper-workload path of the port on the CPU: ``repro_torch.kernels.ops``
``matmul``, ``conv2d``, ``correlation`` and ``flash_decode`` (their plain
versions, in f32 unless a case says bf16) against ``repro.kernels.ops``,
whose Pallas kernels run in interpret mode as the reference's own tests run
them.  Shapes and tolerances are those of ``tests/test_kernels.py``, plus
small cases of the catalog's edges: M = 1, CO not a multiple of
``block_co``, stride 4 with an 11x11 kernel, dilation 4, radius 8 on a
10x10 map, a cache that is not a multiple of ``block_k``.  Also the
dispatch rules of the four wrappers (no launch counted on the CPU; the CUDA
launchers refuse CPU tensors and tiles they are not built for) and the
catalog shapes ``chip_smoke.py`` runs on the card."""
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import ops as ref_ops  # noqa: E402
from repro.kernels import ref as ref_oracles  # noqa: E402
from repro_torch.kernels import attention as pt_att  # noqa: E402
from repro_torch.kernels import conv2d as pt_conv  # noqa: E402
from repro_torch.kernels import correlation as pt_corr  # noqa: E402
from repro_torch.kernels import matmul as pt_mm  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402

RNG = np.random.default_rng(42)
ROOT = Path(__file__).resolve().parents[1]


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


def _close(got: torch.Tensor, want, **tol):
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(want, np.float32), **tol)


# reference tests' tolerances (tests/test_kernels.py)
MM_TOL = {"f32": dict(rtol=2e-4, atol=2e-4), "bf16": dict(rtol=5e-2,
                                                          atol=5e-2)}
TOL = dict(rtol=1e-3, atol=1e-3)


# ---------------------------------------------------------------------------
# matmul
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", ["f32", "bf16"])
@pytest.mark.parametrize("shape", [(16, 16, 16), (70, 50, 130), (128, 64, 32),
                                   (1, 256, 96)])
def test_matmul_matches_reference(shape, dtype):
    M, N, K = shape
    a, b = _normal(M, K), _normal(K, N)
    jdt, tdt = ((jnp.float32, torch.float32) if dtype == "f32"
                else (jnp.bfloat16, torch.bfloat16))
    want = ref_ops.matmul(jnp.asarray(a, jdt), jnp.asarray(b, jdt),
                          block_m=32, block_n=32, block_k=64)
    got = pt_ops.matmul(torch.from_numpy(a).to(tdt),
                        torch.from_numpy(b).to(tdt),
                        block_m=32, block_n=32, block_k=64)
    assert got.dtype == tdt and got.shape == (M, N)
    _close(got, want, **MM_TOL[dtype])


@pytest.mark.parametrize("shape", [(1, 300, 200), (70, 130, 260)])
def test_matmul_default_blocks_match_reference(shape):
    """No blocks given: the port takes the H100 tile search's, the
    reference its TPU search's; the product is the same (M = 1 is
    GEMM_FC's GEMV)."""
    M, N, K = shape
    a, b = _normal(M, K), _normal(K, N)
    want = ref_ops.matmul(jnp.asarray(a), jnp.asarray(b))
    got = pt_ops.matmul(torch.from_numpy(a), torch.from_numpy(b))
    _close(got, want, **MM_TOL["f32"])
    _close(got, ref_oracles.matmul_ref(jnp.asarray(a), jnp.asarray(b)),
           **MM_TOL["f32"])


# ---------------------------------------------------------------------------
# conv2d
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("stride,dilation", [(1, 1), (2, 1), (1, 2), (2, 2)])
@pytest.mark.parametrize("kh,kw", [(3, 3), (1, 7), (5, 5), (1, 1)])
def test_conv2d_matches_reference(stride, dilation, kh, kw):
    """CO 10 with block_co 8: a ragged last channel block."""
    x, w = _normal(2, 18, 17, 6), _normal(kh, kw, 6, 10)
    want = ref_ops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                          dilation=dilation, block_oh=4, block_co=8)
    got = pt_ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                        stride=stride, dilation=dilation, block_oh=4,
                        block_co=8)
    assert got.shape == tuple(want.shape)
    _close(got, want, **TOL)


@pytest.mark.parametrize("case", [
    # (x shape, w shape, stride, dilation): AL_CONV1's stride 4 and 11x11
    # kernel, DL_ATROUS4's dilation 4, TY_CONV8's odd CO at default blocks
    ((1, 27, 30, 3), (11, 11, 3, 5), 4, 1),
    ((1, 20, 19, 4), (3, 3, 4, 6), 1, 4),
    ((1, 9, 9, 12), (1, 1, 12, 13), 1, 1),
], ids=["stride4_11x11", "dilation4", "odd_co_1x1"])
def test_conv2d_catalog_edges_match_reference(case):
    xs, ws, stride, dilation = case
    x, w = _normal(*xs), _normal(*ws)
    want = ref_ops.conv2d(jnp.asarray(x), jnp.asarray(w), stride=stride,
                          dilation=dilation)
    got = pt_ops.conv2d(torch.from_numpy(x), torch.from_numpy(w),
                        stride=stride, dilation=dilation)
    _close(got, want, **TOL)
    _close(got, ref_oracles.conv2d_ref(jnp.asarray(x), jnp.asarray(w),
                                       stride=stride, dilation=dilation),
           **TOL)


# ---------------------------------------------------------------------------
# correlation
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("radius", [1, 2, 4])
@pytest.mark.parametrize("H,W,C", [(12, 10, 8), (8, 8, 16), (16, 6, 4)])
def test_correlation_matches_reference(radius, H, W, C):
    i1, i2 = _normal(H, W, C), _normal(H, W, C)
    want = ref_ops.correlation(jnp.asarray(i1), jnp.asarray(i2),
                               radius=radius, block_y=4)
    got = pt_ops.correlation(torch.from_numpy(i1), torch.from_numpy(i2),
                             radius=radius, block_y=4)
    assert got.shape == (H, W, 2 * radius + 1, 2 * radius + 1)
    _close(got, want, **TOL)


def test_correlation_radius_8_on_a_10x10_map():
    """EVA2_MATCH's radius: most displacements leave the map and read 0."""
    i1, i2 = _normal(10, 10, 4), _normal(10, 10, 4)
    want = ref_ops.correlation(jnp.asarray(i1), jnp.asarray(i2), radius=8)
    got = pt_ops.correlation(torch.from_numpy(i1), torch.from_numpy(i2),
                             radius=8)
    _close(got, want, **TOL)
    _close(got, ref_oracles.correlation_ref(jnp.asarray(i1),
                                            jnp.asarray(i2), radius=8),
           **TOL)


# ---------------------------------------------------------------------------
# flash_decode
# ---------------------------------------------------------------------------

def _decode_inputs(B, H, Hkv, S, Dh, lens):
    return (_normal(B, H, Dh), _normal(B, Hkv, S, Dh), _normal(B, Hkv, S, Dh),
            np.asarray(lens, np.int32))


@pytest.mark.parametrize("S,block_k,lens", [
    (32, 8, [32, 10, 1]), (32, 8, [5, 5, 5]),
    (40, 16, [40, 17, 3]),          # S not a multiple: block_k -> 32, ragged
    (24, 512, [24, 1, 13]),         # default-size block clamped to S
])
def test_flash_decode_matches_reference(S, block_k, lens):
    q, kc, vc, ln = _decode_inputs(3, 8, 2, S, 16, lens)
    want = ref_ops.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(ln),
                                block_k=block_k)
    got = pt_ops.flash_decode(*(torch.from_numpy(a) for a in (q, kc, vc, ln)),
                              block_k=block_k)
    assert got.shape == (3, 8, 16)
    _close(got, want, **TOL)


def test_flash_decode_length_zero_gives_zero():
    """A length of 0: the port's plain version returns 0, as the
    reference's oracle ``decode_ref`` does (the reference's Pallas kernel
    returns the mean of V there; see ROADMAP's reference caveats).  The
    other sequences are untouched by it."""
    q, kc, vc, ln = _decode_inputs(3, 8, 2, 32, 16, [0, 7, 32])
    got = pt_ops.flash_decode(*(torch.from_numpy(a) for a in (q, kc, vc, ln)),
                              block_k=8)
    assert torch.equal(got[0], torch.zeros_like(got[0]))
    G = 4
    want = ref_oracles.decode_ref(
        jnp.asarray(q.reshape(3 * 2, G, 16)), jnp.asarray(kc.reshape(6, 32, 16)),
        jnp.asarray(vc.reshape(6, 32, 16)), jnp.repeat(jnp.asarray(ln), 2))
    _close(got, np.asarray(want).reshape(3, 8, 16), **TOL)


def test_decode_block_k_is_the_reference_clamp():
    from repro.core.pallas_bridge import pow2_floor
    for S in (1, 7, 24, 32, 40, 100, 512, 513, 2048, 3000):
        for bk in (8, 16, 64, 512):
            want = min(bk, S)
            if S % want:
                want = min(want, pow2_floor(S))
            assert pt_att.decode_block_k(S, bk) == want


# ---------------------------------------------------------------------------
# dispatch rules
# ---------------------------------------------------------------------------

def test_cpu_calls_count_no_launch():
    pt_ops.reset_launches()
    x = torch.from_numpy(_normal(16, 16))
    pt_ops.matmul(x, x)
    pt_ops.conv2d(torch.from_numpy(_normal(1, 6, 6, 2)),
                  torch.from_numpy(_normal(3, 3, 2, 4)))
    i = torch.from_numpy(_normal(4, 4, 2))
    pt_ops.correlation(i, i, radius=1)
    q, kc, vc, ln = _decode_inputs(1, 4, 2, 8, 16, [5])
    pt_ops.flash_decode(*(torch.from_numpy(a) for a in (q, kc, vc, ln)))
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())
    assert {"matmul", "matmul_gemv", "matmul_simt", "conv2d", "correlation",
            "flash_decode"} <= set(pt_ops.LAUNCHES)


def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pt_mm.matmul_cuda(x, x, block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError, match="CUDA"):
        pt_mm.matmul_simt_cuda(x, x, block_m=64, block_n=64, block_k=32)
    with pytest.raises(ValueError, match="CUDA"):
        pt_mm.matmul_gemv_cuda(x[:1], x)
    with pytest.raises(ValueError, match="CUDA"):
        pt_conv.conv2d_cuda(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8),
                            block_oh=8, block_co=8)
    i = torch.zeros(8, 8, 4)
    with pytest.raises(ValueError, match="CUDA"):
        pt_corr.correlation_cuda(i, i, radius=2, block_y=8)
    q, kc, vc, ln = _decode_inputs(1, 4, 2, 8, 16, [5])
    with pytest.raises(ValueError, match="CUDA"):
        pt_att.flash_decode_cuda(*(torch.from_numpy(a)
                                   for a in (q, kc, vc, ln)))


@pytest.mark.parametrize("tile", [(32, 32, 64), (48, 64, 32), (128, 256, 64),
                                  (8, 128, 128)])
def test_matmul_launcher_refuses_tiles_it_is_not_built_for(tile):
    """The tile is checked first: an unbuilt tile raises, and is never
    replaced by another (the reference tests' 32 x 32 x 64 among them).
    Each tiled launcher holds the tile to its own kernel's set: 128 x 256 x
    64 is a wgmma tile, not a CUDA-core one."""
    from repro_torch.core.cuda_bridge import MATMUL_TILES, WGMMA_TILES
    x = torch.zeros(64, 64)
    bm, bn, bk = tile
    refused = 0
    for launch, built in ((pt_mm.matmul_cuda, WGMMA_TILES),
                          (pt_mm.matmul_simt_cuda, MATMUL_TILES)):
        if tile in built:
            continue
        with pytest.raises(ValueError, match="not one csrc/matmul.cu"):
            launch(x, x, block_m=bm, block_n=bn, block_k=bk)
        refused += 1
    assert refused >= 1


@pytest.mark.parametrize("blocks", [(0, 8), (65, 8), (8, 0), (8, 129)])
def test_conv2d_launcher_refuses_blocks_it_is_not_built_for(blocks):
    block_oh, block_co = blocks
    with pytest.raises(ValueError, match="not ones csrc/conv2d.cu"):
        pt_conv.conv2d_cuda(torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8),
                            block_oh=block_oh, block_co=block_co)


# ---------------------------------------------------------------------------
# the catalog shapes chip_smoke.py runs on the card
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_chip_smoke_runs_every_catalog_workload_a_kernel_computes():
    from repro import sim as ref_sim
    cases = _chip_smoke().catalog_cases()
    names = [c["name"] for c in cases]
    want = [w.name for w in ref_sim.ALL if w.name != "MBN_DW_S1"]
    assert names == want and len(names) == 24
    by = {c["name"]: c for c in cases}
    assert by["AL_CONV1"]["shapes"] == dict(x=(1, 227, 227, 3),
                                            w=(11, 11, 3, 48), stride=4,
                                            dilation=1)
    assert by["DL_ATROUS4"]["shapes"]["x"] == (1, 73, 73, 256)
    assert by["ESPCN_CONV2"]["shapes"]["x"] == (1, 362, 642, 64)
    assert by["FLOWNET_CORR"]["shapes"] == dict(H=48, W=64, C=256, radius=10)
    assert by["EVA2_MATCH"]["shapes"] == dict(H=26, W=26, C=64, radius=8)
    assert by["GEMM_FC"]["shapes"] == dict(M=1, N=4096, K=9216)
    for c in cases:
        w = ref_sim.by_name(c["name"])
        assert c["macs"] == w.op.total_macs()
