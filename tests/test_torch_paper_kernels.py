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
from repro_torch import sim as pt_sim  # noqa: E402
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


# The wgmma route's schedule on the CPU (``correlation_band_plain``: per
# 64-column tile, row and dy the full row-pair product over the plan's band
# width N, then its band) against the Pallas kernel in interpret mode.
CORR_BAND = [
    # (H, W, C, radius)
    (3, 45, 8, 0),       # radius 0 (N 64); W not a multiple of 64; C 8
    (2, 2, 8, 1),        # radius 1 on a 2 x 2 map, narrower than D 3
    (10, 12, 72, 8),     # radius 8 (EVA2_MATCH's) narrower than D 17; C 72
    (5, 33, 8, 31),      # radius 31 (N 128) narrower than D 63
    (4, 70, 256, 2),     # two column tiles, the last ragged; C 256
    (4, 20, 16, 6),      # the first and last dy rows wholly outside the map
]


@pytest.mark.parametrize("case", CORR_BAND,
                         ids=lambda c: "-".join(map(str, c)))
def test_correlation_band_schedule_matches_reference(case):
    """The band schedule at the plan's N and at the widest built (128)."""
    from repro_torch.core.cuda_bridge import correlation_plan
    H, W, C, R = case
    i1, i2 = _normal(H, W, C), _normal(H, W, C)
    want = ref_ops.correlation(jnp.asarray(i1), jnp.asarray(i2), radius=R,
                               block_y=4)
    plan = correlation_plan(H, W, C, R)
    for n in sorted({plan.block_n, 128}):
        got = pt_corr.correlation_band_plain(torch.from_numpy(i1),
                                             torch.from_numpy(i2), radius=R,
                                             block_n=n)
        assert got.shape == (H, W, 2 * R + 1, 2 * R + 1)
        _close(got, want, **TOL)


def test_correlation_band_schedule_zeros_out_of_image_rows():
    """H 4 at radius 6: the dy whose I2 rows lie above or below the map for
    every output row are exactly 0."""
    H, W, C, R = 4, 20, 16, 6
    got = pt_corr.correlation_band_plain(
        torch.from_numpy(_normal(H, W, C)), torch.from_numpy(_normal(H, W, C)),
        radius=R)
    assert not got[:, :, :R - H + 1].any() and not got[:, :, H + R:].any()
    assert got[:, :, R, R].abs().min() > 0     # no displacement: I1 . I2


def test_correlation_bf16_cpu_path_matches_the_oracle():
    """``ops.correlation`` on bf16 CPU maps of the wgmma route runs the plain
    version, as on every route; it agrees with the reference's oracle
    within one bf16 rounding of the output."""
    H, W, C, R = 6, 70, 16, 3
    i1, i2 = _normal(H, W, C), _normal(H, W, C)
    t1, t2 = (torch.from_numpy(a).to(torch.bfloat16) for a in (i1, i2))
    assert pt_corr.correlation_route(t1, t2, R) == "correlation"
    got = pt_ops.correlation(t1, t2, radius=R)
    assert got.dtype == torch.bfloat16 and got.shape == (H, W, 7, 7)
    torch.testing.assert_close(
        got, pt_corr.correlation_plain(t1, t2, radius=R), rtol=0, atol=0)
    want = ref_oracles.correlation_ref(
        jnp.asarray(t1.float().numpy()), jnp.asarray(t2.float().numpy()),
        radius=R)
    _close(got, want, rtol=2.0 ** -7, atol=1e-3)


def _unaligned(shape, dtype):
    flat = torch.zeros(int(np.prod(shape)) + 1, dtype=dtype)
    return flat[1:].view(shape)


@pytest.mark.parametrize("dtype,C,radius,aligned,route", [
    (torch.bfloat16, 8, 2, True, "correlation"),
    (torch.bfloat16, 256, 10, True, "correlation"),
    (torch.bfloat16, 64, 31, True, "correlation"),
    (torch.float32, 256, 10, True, "correlation_simt"),
    (torch.bfloat16, 5, 2, True, "correlation_simt"),
    (torch.bfloat16, 12, 2, True, "correlation_simt"),
    (torch.bfloat16, 64, 32, True, "correlation_simt"),
    (torch.bfloat16, 64, 2, False, "correlation_simt"),
])
def test_correlation_route(dtype, C, radius, aligned, route):
    """bf16 with C % 8 == 0, 16-byte aligned bases and radius <= 31 take the
    wgmma kernel; f32, other C, a larger radius or an unaligned base the
    CUDA-core one."""
    shape = (4, 6, C)
    i = torch.zeros(shape, dtype=dtype) if aligned else _unaligned(shape,
                                                                   dtype)
    assert pt_corr.correlation_route(i, i, radius) == route


CATALOG_CORR_PLANS = {
    # (H, W, C, radius): (rows, dy_group, block_n, ctas)
    (48, 64, 256, 10): (2, 4, 88, 144),     # FLOWNET_CORR: 5 x 4 dy + 1
    (26, 26, 64, 8): (2, 2, 80, 117),       # EVA2_MATCH: 8 x 2 dy + 1
}


@pytest.mark.parametrize("shape", sorted(CATALOG_CORR_PLANS))
def test_correlation_plan_at_the_catalog_shapes(shape):
    """The full dy groups' CTAs in one wave on 132 SMs (FLOWNET_CORR's
    one-dy remainder group runs as a short second wave), both I1 rows of a
    CTA sharing each staged I2 row, the narrowest band, the ring under the
    budget."""
    from repro_torch.core.cuda_bridge import (SM_COUNT, SMEM_BUDGET,
                                              correlation_plan)
    H, W, C, R = shape
    p = correlation_plan(*shape)
    assert (p.rows, p.dy_group, p.block_n, p.ctas) == \
        CATALOG_CORR_PLANS[shape]
    tiles = -(-H // p.rows)
    assert (2 * R + 1) // p.dy_group * tiles <= SM_COUNT
    assert p.smem <= SMEM_BUDGET and p.passes == 1 and p.stages >= 3


@pytest.mark.parametrize("shape", [c for c in CORR_BAND] + [
    (64, 64, 1024, 31), (1, 10, 8, 3), (300, 300, 64, 4),
    (48, 64, 2048, 10), (6, 20, 1024, 4), (200, 8, 8, 0)])
def test_correlation_plan_fits_and_covers_the_band(shape):
    """Every plan fits ``SMEM_BUDGET`` with at least three ring stages, takes
    a band of at least 64 + 2R built columns, covers all C in its passes
    and all D dy in its groups, and counts its CTAs; where shared memory
    does not force smaller groups, the full groups' CTAs stay within one
    wave unless the row blocks alone exceed it, the remainder group is at
    most half a group where it spills past the wave, and a group one
    smaller would not fit the wave."""
    from repro_torch.core.cuda_bridge import (CORR_BLOCK_N, SM_COUNT,
                                              SMEM_BUDGET, correlation_plan,
                                              correlation_smem)
    H, W, C, R = shape
    D = 2 * R + 1
    p = correlation_plan(H, W, C, R)
    assert p.smem == correlation_smem(R, p.rows, p.dy_group, p.block_n,
                                      p.stages, p.chunks) <= SMEM_BUDGET
    assert p.block_n in CORR_BLOCK_N and p.block_n >= 64 + 2 * R
    assert p.stages >= 3 and p.chunks * p.passes >= -(-C // 64)
    assert 1 <= p.dy_group <= D
    tiles = -(-W // 64) * -(-H // p.rows)
    assert p.ctas == tiles * -(-D // p.dy_group)
    g = p.dy_group
    unforced = correlation_plan(H, W, 64, R).dy_group == g
    if unforced and tiles <= SM_COUNT:
        assert tiles * (D // g) <= SM_COUNT
        assert p.ctas <= SM_COUNT or 2 * (D % g) <= g
        assert g == 1 or tiles * (D // (g - 1)) > SM_COUNT or \
            2 * (D % (g - 1)) > g - 1


def test_correlation_plan_smem_at_flownet():
    """The shared-memory sum the kernel's ``corr_layout`` takes: two I1
    rows of four chunks, seven 88-column ring stages, the f32 staging of 2 x
    64 pixels x 4 dy x 21 dx, 19 mbarriers (two a stage, one an I1 chunk,
    one for I1's release) and 1024 bytes of alignment."""
    from repro_torch.core.cuda_bridge import correlation_plan
    p = correlation_plan(48, 64, 256, 10)
    assert p.stages == 7
    assert p.smem == 2 * 4 * 8192 + 7 * 88 * 128 + 2 * 64 * 4 * 21 * 4 + \
        19 * 8 + 1024


@pytest.mark.parametrize("kw", [dict(radius=32), dict(radius=-1),
                                dict(radius=10, block_n=80),
                                dict(radius=10, block_n=130),
                                dict(radius=10, block_n=92),
                                dict(radius=10, rows=3),
                                dict(radius=10, dy_group=22),
                                dict(radius=10, stages=2),
                                dict(radius=10, stages=9)])
def test_correlation_plan_refuses_what_is_not_built(kw):
    """Radius 32 and above (D > 63), a band narrower than 64 + 2R or not a
    built width, rows other than 1 or 2, a dy group past D, a ring shorter
    than the wgmma groups a warpgroup keeps in flight (each holds its
    stage) or more stages than built."""
    from repro_torch.core.cuda_bridge import correlation_plan
    with pytest.raises(ValueError, match="correlation"):
        correlation_plan(48, 64, 256, **kw)


@pytest.mark.parametrize("no_math", [False, True],
                         ids=["stamps", "no_math"])
def test_correlation_probe_anchors_match_the_kernel(no_math):
    """``scripts/probe_correlation_torch.py`` stamps the wgmma kernel at
    lines of ``csrc/correlation.cu`` that must each occur once: a kernel
    change that moves one must move the probe with it."""
    spec = importlib.util.spec_from_file_location(
        "probe_correlation_torch",
        ROOT / "scripts" / "probe_correlation_torch.py")
    probe = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(probe)
    src = (ROOT / "src" / "repro_torch" / "kernels" / "csrc" /
           "correlation.cu").read_text()
    out = probe.instrument(src, no_math)
    assert "corr_probe_buf" in out and "corr_probe_trace_read" in out
    assert ("if (false) Mma<N>" in out) == no_math


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


@pytest.mark.parametrize("block_k,S", [(8, 37), (32, 101), (512, 601)])
def test_flash_decode_splits_match_reference(block_k, S):
    """The split history of ``flash_decode_plain`` (the kernel's
    arithmetic: one softmax partial per ``block_k`` split, combined by
    their lse) at a split's edges, lengths 0, 1, block_k - 1, block_k,
    block_k + 1 and S, on a ragged S: the reference's Pallas decode at
    lengths >= 1, its oracle ``decode_ref`` (0) at length 0."""
    lens = [0, 1, block_k - 1, block_k, block_k + 1, S]
    B, G, Hkv, D = len(lens), 2, 2, 16
    q, kc, vc, ln = _decode_inputs(B, Hkv * G, Hkv, S, D, lens)
    got = pt_ops.flash_decode(*(torch.from_numpy(a) for a in (q, kc, vc, ln)),
                              block_k=block_k)
    assert pt_att.decode_splits(S, block_k) == -(-S // pt_att.decode_block_k(
        S, block_k)) > 1
    want = ref_ops.flash_decode(jnp.asarray(q), jnp.asarray(kc),
                                jnp.asarray(vc), jnp.asarray(ln),
                                block_k=block_k)
    _close(got[1:], np.asarray(want)[1:], **TOL)
    oracle = ref_oracles.decode_ref(
        jnp.asarray(q.reshape(B * Hkv, G, D)),
        jnp.asarray(kc.reshape(B * Hkv, S, D)),
        jnp.asarray(vc.reshape(B * Hkv, S, D)), jnp.repeat(jnp.asarray(ln),
                                                           Hkv))
    _close(got, np.asarray(oracle).reshape(B, Hkv * G, D), **TOL)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


# the 20 catalog convs chip_smoke.py runs (the depthwise MBN_DW_S1 has no
# kernel)
CONV_NAMES = [w.name for w in pt_sim.ALL if w.family not in ("gemm", "spatial")
              and "ci" in {d.name for d in w.op.dims}]


def _conv_case(name):
    """(N, OH, OW, CI, CO, KH, KW, stride, x shape, w shape) of catalog
    conv ``name`` as ``chip_smoke.py`` runs it."""
    c = {c["name"]: c for c in _chip_smoke().catalog_cases()}[name]
    sh = c["shapes"]
    (N, IH, IW, CI), (KH, KW, _, CO) = sh["x"], sh["w"]
    OH, OW = pt_conv.out_hw(IH, IW, KH, KW, sh["stride"], sh["dilation"])
    return N, OH, OW, CI, CO, KH, KW, sh["stride"], sh["x"], sh["w"]


@pytest.mark.parametrize("dtype", ["bf16", "f32"])
@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv2d_route_on_every_catalog_shape(name, dtype):
    """bf16 takes the wgmma route and f32 the CUDA-core one, at every
    catalog conv's own shapes (CPU tensors: the route is a pure function
    of dtype and alignment); a bf16 input whose base is not 16-byte
    aligned takes the CUDA-core route."""
    tdt = torch.bfloat16 if dtype == "bf16" else torch.float32
    *_, xs, ws = _conv_case(name)
    x, w = torch.empty(xs, dtype=tdt), torch.empty(ws, dtype=tdt)
    want = "conv2d" if dtype == "bf16" else "conv2d_simt"
    assert pt_conv.conv2d_route(x, w) == want
    shifted = torch.empty(x.numel() + 1, dtype=tdt)[1:].view(x.shape)
    assert pt_conv.conv2d_route(shifted, w) == "conv2d_simt"


@pytest.mark.parametrize("name", CONV_NAMES)
def test_conv2d_plan_fills_the_card_with_built_tiles(name):
    """``conv2d_plan`` on every catalog conv: a tile the kernel is built
    for, a K split with no empty split, the CTA count of its grid, and a
    grid of at least half the SMs (below that a split pays for its
    reduction pass) unless every split is one K step; producers that
    gather A (CI 3) take 64-pixel tiles."""
    from repro_torch.core.cuda_bridge import (CONV_TILES, SM_COUNT,
                                              conv2d_a_tma, conv2d_k_steps,
                                              conv2d_plan)
    assert len(CONV_NAMES) == 20
    N, OH, OW, CI, CO, KH, KW, stride, _, _ = _conv_case(name)
    p = conv2d_plan(N, OH, OW, CI, CO, KH, KW, stride=stride)
    assert (p.block_oh, p.block_ow, p.block_co) in CONV_TILES
    assert p.k_steps == conv2d_k_steps(CI, KH, KW, stride=stride,
                                       block_ow=p.block_ow)
    per = -(-p.k_steps // p.splits)
    assert -(-p.k_steps // per) == p.splits        # no split is empty
    grid = N * -(-OH // p.block_oh) * -(-OW // p.block_ow) * \
        -(-CO // p.block_co)
    assert p.ctas == grid * p.splits
    assert p.ctas >= SM_COUNT // 2 or p.splits == p.k_steps
    assert p.splits == 1 or grid < SM_COUNT // 2
    if not conv2d_a_tma(CI, stride, p.block_ow):
        assert p.block_oh * p.block_ow == 64
    assert conv2d_plan(N, OH, OW, CI, CO, KH, KW, stride=stride) == p


def test_conv2d_plan_keeps_named_blocks_and_refuses_unbuilt_ones():
    from repro_torch.core.cuda_bridge import conv2d_plan
    for boh in (1, 2, 4, 8, 16):
        for bco in (64, 128):
            p = conv2d_plan(1, 13, 13, 128, 192, 3, 3, block_oh=boh,
                            block_co=bco)
            assert (p.block_oh, p.block_co) == (boh, bco)
    for blocks in (dict(block_oh=3), dict(block_oh=32), dict(block_co=48),
                   dict(block_co=256)):
        with pytest.raises(ValueError, match="route conv2d "):
            conv2d_plan(1, 13, 13, 128, 192, 3, 3, **blocks)


@pytest.mark.parametrize("case", [
    ((1, 27, 30, 3), (11, 11, 3, 5), 4, 1),
    ((1, 20, 19, 16), (3, 3, 16, 6), 1, 4),
], ids=["stride4_11x11", "dilation4"])
def test_conv2d_bf16_takes_the_wgmma_route_on_cpu(case):
    """bf16 CPU tensors take the wgmma route: ``ops.conv2d`` plans it and
    runs the plain version, which matches the reference's oracle on the
    same bf16 values (summed in f32), and counts no launch; blocks the
    route is not built for give the plain version on the CPU."""
    from repro_torch.obs import REGISTRY
    xs, ws, stride, dilation = case
    x = torch.from_numpy(_normal(*xs)).to(torch.bfloat16)
    w = torch.from_numpy(_normal(*ws)).to(torch.bfloat16)
    assert pt_conv.conv2d_route(x, w) == "conv2d"
    before = REGISTRY.get_counter("kernel_dispatch", kernel="conv2d",
                                  impl="plain")
    pt_ops.reset_launches()
    got = pt_ops.conv2d(x, w, stride=stride, dilation=dilation)
    again = pt_ops.conv2d(x, w, stride=stride, dilation=dilation,
                          block_oh=3, block_co=5)
    assert torch.equal(got, again) and got.dtype == torch.bfloat16
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())
    assert REGISTRY.get_counter("kernel_dispatch", kernel="conv2d",
                                impl="plain") == before + 2
    want = ref_oracles.conv2d_ref(jnp.asarray(x.float().numpy()),
                                  jnp.asarray(w.float().numpy()),
                                  stride=stride, dilation=dilation)
    _close(got, want, rtol=2 ** -7, atol=2e-2)


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
    j = torch.ones(4, 4, 8, dtype=torch.bfloat16)    # the wgmma route's
    pt_ops.correlation(j, j, radius=1)
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())
    assert {"matmul", "matmul_gemv", "matmul_simt", "conv2d", "correlation",
            "correlation_simt", "flash_decode"} <= set(pt_ops.LAUNCHES)


def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros(64, 64, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pt_mm.matmul_cuda(x, x, block_m=64, block_n=64, block_k=64)
    with pytest.raises(ValueError, match="CUDA"):
        pt_mm.matmul_simt_cuda(x, x, block_m=64, block_n=64, block_k=32)
    with pytest.raises(ValueError, match="CUDA"):
        pt_mm.matmul_gemv_cuda(x[:1], x)
    bf = dict(dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pt_conv.conv2d_cuda(torch.zeros(1, 8, 8, 4, **bf),
                            torch.zeros(3, 3, 4, 8, **bf), block_oh=8,
                            block_ow=8, block_co=64)
    with pytest.raises(ValueError, match="CUDA"):
        pt_conv.conv2d_simt_cuda(torch.zeros(1, 8, 8, 4),
                                 torch.zeros(3, 3, 4, 8), block_oh=8,
                                 block_co=8)
    i = torch.zeros(8, 8, 8)
    with pytest.raises(ValueError, match="CUDA"):
        pt_corr.correlation_simt_cuda(i, i, radius=2, block_y=8)
    with pytest.raises(ValueError, match="CUDA"):
        pt_corr.correlation_cuda(i.bfloat16(), i.bfloat16(), radius=2)
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
    """Both launchers check their blocks first: the CUDA-core one's
    (1..64, 1..128) and the wgmma one's tiles (``CONV_TILES``), which take
    none of these."""
    block_oh, block_co = blocks
    x, w = torch.zeros(1, 8, 8, 4), torch.zeros(3, 3, 4, 8)
    with pytest.raises(ValueError, match="not ones csrc/conv2d.cu"):
        pt_conv.conv2d_simt_cuda(x, w, block_oh=block_oh, block_co=block_co)
    with pytest.raises(ValueError, match="not ones csrc/conv2d.cu"):
        pt_conv.conv2d_cuda(x.bfloat16(), w.bfloat16(), block_oh=block_oh,
                            block_ow=8, block_co=block_co)


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
