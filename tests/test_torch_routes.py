"""The kernel routes of the port's matmul and flash attention, on the CPU:
the route functions (``kernels.matmul.matmul_route``,
``kernels.attention.flash_fwd_route``, ``flash_bwd_route``) that pick the
tensor-core, GEMV or CUDA-core kernel before a launch; the plain versions
of the new schedules against the reference's Pallas kernels in interpret
mode (the split-K GEMV at M 1-7, within the reference test's 2e-4 in f32;
the flash forward at the wgmma kernel's 128 x 128 blocks and the backward
at the wgmma pair's 128 x 64 / 64 x 128, within the present 1e-5, and the
backward with p and ds rounded to bf16 within a bound derived from that
rounding); the pruned ranges at those blocks against the reference's
``_row_range``; the CPU wrappers following the routes; and the build's
hash of included headers and its ``ptxas`` report."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as ref_att  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.core import cuda_bridge  # noqa: E402
from repro_torch.kernels import _build  # noqa: E402
from repro_torch.kernels import attention as pt_att  # noqa: E402
from repro_torch.kernels import matmul as pt_mm  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402

RNG = np.random.default_rng(17)
BF16 = torch.bfloat16


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# matmul routes
# ---------------------------------------------------------------------------

def _t(shape, dtype=BF16):
    return torch.empty(shape, dtype=dtype)


MATMUL_ROUTES = [
    # (id, operands, route): built in the test, not at collection
    ("bf16 M 64", lambda: (_t((64, 96)), _t((96, 128))), "matmul"),
    ("bf16 M 1024", lambda: (_t((1024, 1024)), _t((1024, 1024))), "matmul"),
    ("bf16 M 63", lambda: (_t((63, 96)), _t((96, 128))), "matmul"),
    ("bf16 M 2", lambda: (_t((2, 9216)), _t((9216, 4096))), "matmul"),
    ("bf16 M 2, A row stride 100", lambda: (_t((2, 100)), _t((100, 64))),
     "matmul_simt"),
    ("bf16 M 1", lambda: (_t((1, 9216)), _t((9216, 4096))), "matmul_gemv"),
    ("bf16 M 1, odd K", lambda: (_t((1, 77)), _t((77, 64))), "matmul_gemv"),
    ("f32 M 128", lambda: (_t((128, 64), torch.float32),
                           _t((64, 64), torch.float32)), "matmul_simt"),
    ("f32 M 1", lambda: (_t((1, 64), torch.float32),
                         _t((64, 64), torch.float32)), "matmul_simt"),
    ("bf16, B row stride 130", lambda: (_t((128, 64)), _t((64, 130))),
     "matmul_simt"),
    ("bf16 M 1, B row stride 70", lambda: (_t((1, 64)), _t((64, 70))),
     "matmul_simt"),
    ("bf16, A row stride 90", lambda: (_t((100, 90)), _t((90, 64))),
     "matmul_simt"),
    ("bf16, A base not 16-byte aligned",
     lambda: (_t((100, 160))[:, 10:90], _t((80, 64))), "matmul_simt"),
    ("bf16 M 1, A unaligned", lambda: (_t((1, 100))[:, 3:], _t((97, 64))),
     "matmul_gemv"),
    ("bf16, B padded rows", lambda: (_t((128, 200)), _t((200, 136))[:, :130]),
     "matmul"),
]


@pytest.mark.parametrize("case", MATMUL_ROUTES, ids=[c[0] for c in
                                                     MATMUL_ROUTES])
def test_matmul_route(case):
    """bf16 with M > 1 and TMA-readable operands -> the wgmma kernel;
    bf16 with M = 1 (``GEMV_MAX_M``, the one M where the GEMV beat the
    wgmma tile on the card) and a B readable by 16-byte loads -> the GEMV
    (it reads A by scalar loads, so A's alignment does not matter); f32,
    or an operand whose row stride or base is not a 16-byte multiple -> the
    CUDA-core kernel."""
    assert cuda_bridge.GEMV_MAX_M == 1
    _, operands, want = case
    assert pt_mm.matmul_route(*operands()) == want


@pytest.mark.parametrize("M", [1, 5, 63])
def test_named_tile_takes_the_tiled_route_below_64_rows(M):
    """A tile named for bf16 M < 64: the GEMV takes none, so the route is
    the wgmma kernel's also at M 1, as the reference's ``ops.matmul``
    honours its blocks; on the CPU ``ops.matmul`` then runs the tiled
    schedule at the given block_k and counts no launch.  f32 stays on the
    CUDA-core route."""
    a = torch.from_numpy(_normal(M, 320)).to(BF16)
    b = torch.from_numpy(_normal(320, 136)).to(BF16)[:, :130]
    assert pt_mm.matmul_route(a, b) == ("matmul_gemv" if M == 1 else
                                        "matmul")
    assert pt_mm.matmul_route(a, b, tiled=True) == "matmul"
    assert pt_mm.matmul_route(a.float(), b.float(),
                              tiled=True) == "matmul_simt"
    pt_ops.reset_launches()
    got = pt_ops.matmul(a, b, block_m=64, block_n=64, block_k=64)
    assert torch.equal(got, pt_mm.matmul_plain(a, b, block_k=64))
    got = pt_ops.matmul(a, b, block_k=32)
    assert torch.equal(got, pt_mm.matmul_plain(a, b, block_k=32))
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


@pytest.mark.parametrize("M,N,K", [(1, 300, 1000), (3, 200, 2000),
                                   (5, 64, 777), (7, 130, 1500)])
def test_gemv_plain_matches_reference(M, N, K):
    """The GEMV's plain version (one f32 partial per K split, summed in split
    order) against the reference's Pallas matmul in interpret mode, f32,
    within the reference test's 2e-4; every case has a ragged last split."""
    splits, kchunk = cuda_bridge.gemv_plan(M, N, K)
    assert splits >= 2 and K % kchunk and kchunk % 8 == 0
    a, b = _normal(M, K), _normal(K, N)
    want = ref_ops.matmul(jnp.asarray(a), jnp.asarray(b))
    got = pt_mm.matmul_gemv_plain(torch.from_numpy(a), torch.from_numpy(b))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=2e-4,
                               atol=2e-4)
    # the fixed order: the partials summed one split after another
    ta, tb = torch.from_numpy(a), torch.from_numpy(b)
    parts = [ta[:, k0:k0 + kchunk] @ tb[k0:k0 + kchunk]
             for k0 in range(0, K, kchunk)]
    acc = parts[0]
    for p in parts[1:]:
        acc = acc + p
    assert torch.equal(got, acc)


def test_gemv_plan_fills_the_card():
    """GEMM_FC: 64 strips x 8 splits = 512 CTAs; a short K is not split
    below 256; every plan covers K exactly once."""
    assert cuda_bridge.gemv_plan(1, 4096, 9216) == (8, 1152)
    assert cuda_bridge.gemv_plan(1, 64, 300) == (1, 304)
    for M, N, K in [(1, 4096, 9216), (7, 130, 1500), (63, 64, 100),
                    (33, 5000, 70000)]:
        splits, kchunk = cuda_bridge.gemv_plan(M, N, K)
        assert (splits - 1) * kchunk < K <= splits * kchunk


@pytest.mark.parametrize("shape", [(1, 300, 200), (70, 130, 260),
                                   (128, 64, 96), (7, 64, 1000)])
def test_ops_matmul_follows_the_route_on_cpu(shape):
    """bf16 on the CPU takes the route's plain version: the GEMV schedule
    for M 1, the tiled schedule (block_k 64 on the wgmma route, the
    CUDA-core search's otherwise); no launch is counted."""
    M, N, K = shape
    a = torch.from_numpy(_normal(M, K)).to(BF16)
    b = torch.from_numpy(_normal(K, N)).to(BF16)
    pt_ops.reset_launches()
    got = pt_ops.matmul(a, b)
    route = pt_mm.matmul_route(a, b)
    if route == "matmul_gemv":
        want = pt_mm.matmul_gemv_plain(a, b)
    else:
        bk = cuda_bridge.matmul_block_shapes(max(M, 8), N, K,
                                             route=route)[2]
        want = pt_mm.matmul_plain(a, b, block_k=bk)
    assert torch.equal(got, want)
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# flash forward routes, schedule and plain version at the new blocks
# ---------------------------------------------------------------------------

def _bshd(B, S, H, D, dtype=BF16):
    """(B, H, S, D) view of a (B, S, H, D) tensor, as the model hands it."""
    return _t((B, S, H, D), dtype).transpose(1, 2)


FLASH_ROUTES = [
    ("bf16 D 128", lambda: (_bshd(2, 256, 32, 128), _bshd(2, 256, 8, 128)),
     "flash_fwd"),
    ("bf16 D 64", lambda: (_bshd(1, 300, 8, 64), _bshd(1, 300, 8, 64)),
     "flash_fwd"),
    ("bf16 contiguous (B, H, S, D)",
     lambda: (_t((1, 4, 128, 64)), _t((1, 4, 128, 64))[:, :2]), "flash_fwd"),
    ("f32", lambda: (_bshd(1, 64, 4, 64, torch.float32),
                     _bshd(1, 64, 2, 64, torch.float32)), "flash_fwd_simt"),
    ("bf16 D 16", lambda: (_bshd(1, 64, 4, 16), _bshd(1, 64, 2, 16)),
     "flash_fwd_simt"),
    ("bf16 seq stride 68",
     lambda: (_t((1, 64, 68))[..., :64].unsqueeze(1), _bshd(1, 64, 1, 64)),
     "flash_fwd_simt"),
]


@pytest.mark.parametrize("case", FLASH_ROUTES,
                         ids=[c[0] for c in FLASH_ROUTES])
def test_flash_fwd_route(case):
    """bf16 at head_dim 64 or 128 with (batch, head, seq) strides that are
    16-byte multiples -> the wgmma kernel, with 128 x 128 blocks; anything
    else -> the CUDA-core kernel, with 64 x 64 blocks."""
    _, operands, want = case
    q, kv = operands()
    assert pt_att.flash_fwd_route(q, kv, kv) == want
    assert pt_att.flash_fwd_blocks(want) == \
        ((128, 128) if want == "flash_fwd" else (64, 64))


def test_tma_strides_of_size_one_dims():
    """A dim of size 1 is never stepped: its stride is replaced by the
    tensor's extent rounded to 8, so a (1, S, H, D) view still routes."""
    q = torch.zeros((1, 100, 4, 64), dtype=BF16).transpose(1, 2)
    assert pt_att._tma_strides(q) == [100 * 4 * 64, 64, 4 * 64]
    x = torch.zeros((1, 1, 100, 64), dtype=BF16).as_strided(
        (1, 1, 100, 64), (7, 3, 64, 1))
    assert pt_att._tma_strides(x) == [6400, 6400, 64]
    assert pt_att.flash_fwd_route(x, x, x) == "flash_fwd"


RANGE_SWEEP = [(Sq, Sk, causal, window)
               for Sq, Sk in [(128, 128), (200, 200), (2048, 2048),
                              (1000, 1000), (130, 190), (256, 64),
                              (1536, 1536)]
               for causal in (True, False)
               for window in (None, 100, 300)]


@pytest.mark.parametrize("Sq,Sk,causal,window", RANGE_SWEEP)
def test_wgmma_row_ranges_equal_reference_row_range(Sq, Sk, causal, window):
    """The wgmma kernel's per-CTA k-block ranges at 128 x 128 blocks are the
    reference's ``_row_range`` table at the same blocks (a fully masked
    row: the empty range)."""
    bq, bk = pt_att.WGMMA_BLOCK_Q, pt_att.WGMMA_BLOCK_K
    r = pt_att.row_block_ranges(Sq, Sk, block_q=bq, block_k=bk,
                                causal=causal, window=window)
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    assert r.shape == (nq, 2)
    for iq in range(nq):
        lo, hi = ref_att._row_range(iq, nk=nk, block_q=bq, block_k=bk,
                                    causal=causal, window=window, kv_len=Sk,
                                    q_len=Sq)
        assert tuple(r[iq]) == ((lo, hi) if hi >= lo else (0, -1))


FWD_CASES = {
    # (BH, BHkv, S, D, causal, window, q_len, kv_len): padded to 128s for
    # the reference, which needs whole blocks; the port masks the rest
    "gqa_causal_ragged": (8, 2, 384, 64, True, None, 300, 300),
    "window": (4, 4, 256, 64, True, 100, 256, 256),
    "noncausal_sq_ne_sk": (4, 1, 256, 32, False, None, 130, 190),
    "window_past_keys": (4, 2, 256, 32, False, 100, 256, 64),
}


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_plain_at_wgmma_blocks_matches_pallas(case):
    """The plain forward at the wgmma kernel's 128 x 128 blocks against the
    reference's Pallas forward (interpret mode) at the same blocks, f32:
    o and lse within 1e-5, as at 64 x 64 blocks."""
    BH, BHkv, S, D, causal, window, q_len, kv_len = FWD_CASES[case]
    q, k, v = _normal(BH, S, D), _normal(BHkv, S, D), _normal(BHkv, S, D)
    kw = dict(causal=causal, window=window, q_len=q_len, kv_len=kv_len,
              block_q=128, block_k=128)
    o_ref, lse_ref = ref_att.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), interpret=True, **kw)
    o, lse = pt_att.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v), **kw)
    np.testing.assert_allclose(o[:, :q_len].numpy(),
                               np.asarray(o_ref)[:, :q_len], atol=1e-5)
    np.testing.assert_allclose(lse[:, :q_len].numpy(),
                               np.asarray(lse_ref)[:, :q_len], atol=1e-5)


def test_ops_flash_attention_takes_the_route_blocks_on_cpu():
    """bf16 at head_dim 64 on the CPU runs the plain forward at the wgmma
    route's 128 x 128 blocks, f32 at 64 x 64: each equals the plain version
    at its blocks, bit for bit."""
    B, H, Hkv, S, D = 1, 4, 2, 200, 64
    for dt, blocks in ((BF16, (128, 128)), (torch.float32, (64, 64))):
        q = torch.from_numpy(_normal(B, S, H, D)).to(dt).transpose(1, 2)
        k = torch.from_numpy(_normal(B, S, Hkv, D)).to(dt).transpose(1, 2)
        got = pt_ops.flash_attention(q, k, k, causal=True)
        want, _ = pt_att.flash_attention_fwd_plain(
            q.reshape(B * H, S, D), k.reshape(B * Hkv, S, D),
            k.reshape(B * Hkv, S, D), causal=True, block_q=blocks[0],
            block_k=blocks[1])
        assert torch.equal(got, want.reshape(B, H, S, D))


# ---------------------------------------------------------------------------
# flash backward routes and the plain backward at the wgmma pair's blocks
# ---------------------------------------------------------------------------

def _unaligned_base(B, S, H, D):
    """A (B, H, S, D) view of (B, S, H, D) bf16 whose base is 8 bytes past
    a 16-byte boundary."""
    flat = _t((B * S * H * D + 4,))[4:]
    return flat.view(B, S, H, D).transpose(1, 2)


FLASH_BWD_ROUTES = [
    # (id, (q, kv, do) built in the test, route)
    ("bf16 D 128", lambda: (_bshd(2, 256, 32, 128), _bshd(2, 256, 8, 128),
                            _bshd(2, 256, 32, 128)), "flash_bwd"),
    ("bf16 D 64", lambda: (_bshd(1, 300, 8, 64), _bshd(1, 300, 8, 64),
                           _bshd(1, 300, 8, 64)), "flash_bwd"),
    ("bf16 size-1 batch and heads",
     lambda: (_bshd(1, 200, 1, 64), _bshd(1, 200, 1, 64),
              _bshd(1, 200, 1, 64)), "flash_bwd"),
    ("bf16 contiguous (B, H, S, D)",
     lambda: (_t((1, 4, 128, 64)), _t((1, 4, 128, 64))[:, :2],
              _t((1, 4, 128, 64))), "flash_bwd"),
    ("f32", lambda: (_bshd(1, 64, 4, 64, torch.float32),
                     _bshd(1, 64, 2, 64, torch.float32),
                     _bshd(1, 64, 4, 64, torch.float32)), "flash_bwd_simt"),
    ("bf16 D 32", lambda: (_bshd(1, 64, 4, 32), _bshd(1, 64, 2, 32),
                           _bshd(1, 64, 4, 32)), "flash_bwd_simt"),
    ("bf16 do seq stride 68",
     lambda: (_bshd(1, 64, 1, 64), _bshd(1, 64, 1, 64),
              _t((1, 64, 68))[..., :64].unsqueeze(1)), "flash_bwd_simt"),
    ("bf16 q base 8 bytes off 16",
     lambda: (_unaligned_base(1, 64, 4, 64), _bshd(1, 64, 2, 64),
              _bshd(1, 64, 4, 64)), "flash_bwd_simt"),
    ("bf16 do expanded over heads",
     lambda: (_bshd(1, 64, 4, 64), _bshd(1, 64, 2, 64),
              _t((1, 1, 64, 64)).expand(1, 4, 64, 64)), "flash_bwd_simt"),
]


@pytest.mark.parametrize("case", FLASH_BWD_ROUTES,
                         ids=[c[0] for c in FLASH_BWD_ROUTES])
def test_flash_bwd_route(case):
    """bf16 q, k, v and do at head_dim 64 or 128 that TMA can read (16-byte
    bases, positive (batch, head, seq) strides in multiples of 8 elements)
    -> the wgmma pair, dq at 128 x 64 and dk/dv at 64 x 128 with p and ds
    rounded to bf16; anything else -> the CUDA-core pair at 64 x 64,
    unrounded."""
    _, operands, want = case
    q, kv, do = operands()
    assert pt_att.flash_bwd_route(q, kv, kv, do) == want
    kw = pt_att.flash_bwd_plain_kw(want)
    if want == "flash_bwd":
        assert kw == dict(block_q=128, block_k=64, dkv_blocks=(64, 128),
                          rounded=True)
    else:
        assert kw == dict(block_q=64, block_k=64, dkv_blocks=(64, 64),
                          rounded=False)


def _bf16_values(rng, *shape):
    """Normal f32 values that bf16 holds exactly."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(BF16).float().numpy()


@functools.lru_cache(maxsize=None)
def _bwd_reference(case: str):
    """Inputs, residuals and the reference's Pallas backward (interpret
    mode, f32) of one ``FWD_CASES`` case: dq at the wgmma dq kernel's
    128 x 64 blocks, dk/dv at the dk/dv kernel's 64 x 128."""
    BH, BHkv, S, D, causal, window, q_len, kv_len = FWD_CASES[case]
    rng = np.random.default_rng(sorted(FWD_CASES).index(case))
    q, do = _bf16_values(rng, BH, S, D), _bf16_values(rng, BH, S, D)
    k, v = _bf16_values(rng, BHkv, S, D), _bf16_values(rng, BHkv, S, D)
    kw = dict(causal=causal, window=window, q_len=q_len, kv_len=kv_len)
    o, lse = pt_att.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), block_q=128, block_k=128, **kw)
    lse = lse.numpy()
    delta = (o.numpy() * do).sum(-1)
    args = tuple(map(jnp.asarray, (q, k, v, do, lse, delta)))
    dq = ref_att.flash_attention_bwd_pallas(
        *args, block_q=128, block_k=64, interpret=True, **kw)[0]
    _, dk, dv = ref_att.flash_attention_bwd_pallas(
        *args, block_q=64, block_k=128, interpret=True, **kw)
    want = tuple(np.asarray(x) for x in (dq, dk, dv))
    return (q, k, v, do, lse, delta), kw, want


def _cut(case, dq, dk, dv):
    """The rows the reference defines: q rows below q_len, keys below
    kv_len."""
    q_len, kv_len = FWD_CASES[case][6:]
    return dq[:, :q_len], dk[:, :kv_len], dv[:, :kv_len]


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_bwd_plain_at_wgmma_blocks_matches_pallas(case):
    """The plain backward at the wgmma pair's blocks, unrounded (f32),
    against the reference's Pallas backward at the same blocks: dq, dk and
    dv within 1e-5, as at 64 x 64."""
    inputs, kw, want = _bwd_reference(case)
    got = pt_att.flash_attention_bwd_plain(
        *map(torch.from_numpy, inputs), **kw,
        **dict(pt_att.flash_bwd_plain_kw("flash_bwd"), rounded=False))
    for g, w in zip(_cut(case, *got), _cut(case, *want)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)


def _abs_products(case, inputs):
    """sum |ds| |k| (dq), sum |ds| |q| (dk) and sum |p| |do| (dv) over
    every unmasked pair of the case, the GQA group folded, in f32 numpy:
    the scale of the error that rounding p and ds brings."""
    q, k, v, do, lse, delta = inputs
    BH, BHkv, S, D, causal, window, q_len, kv_len = FWD_CASES[case]
    g = BH // BHkv
    kr, vr = np.repeat(k, g, axis=0), np.repeat(v, g, axis=0)
    qpos, kpos = np.arange(S)[:, None], np.arange(S)[None, :]
    mask = kpos < kv_len
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = np.einsum("hqd,hkd->hqk", q, kr) / np.sqrt(D)
    p = np.where(mask, np.exp(np.minimum(s - lse[..., None], 0.0)), 0.0)
    dp = np.einsum("hqd,hkd->hqk", do, vr)
    ds = np.abs(p * (dp - delta[..., None]) / np.sqrt(D))
    fold = lambda a: a.reshape(BHkv, g, *a.shape[1:]).sum(1)  # noqa: E731
    return (np.einsum("hqk,hkd->hqd", ds, np.abs(kr)),
            fold(np.einsum("hqk,hqd->hkd", ds, np.abs(q))),
            fold(np.einsum("hqk,hqd->hkd", p, np.abs(do))))


@pytest.mark.parametrize("case", sorted(FWD_CASES))
def test_flash_bwd_rounded_plain_matches_pallas_within_bf16_rounding(case):
    """The wgmma route's plain version (p and ds rounded to bf16 before
    their second products) on bf16 inputs against the reference's f32
    Pallas backward at the same blocks.  Rounding to bf16 moves a value by
    at most 2^-8 of itself (8 significant bits), so each output element
    lies within 2^-8 of the sum of its terms' magnitudes
    (sum |ds| |k| for dq, sum |ds| |q| for dk, sum |p| |do| for dv), plus
    1e-5 for the f32 sums' order."""
    inputs, kw, want = _bwd_reference(case)
    q, k, v, do, lse, delta = (torch.from_numpy(x) for x in inputs)
    got = pt_att.flash_attention_bwd_plain(
        q.to(BF16), k.to(BF16), v.to(BF16), do.to(BF16), lse, delta, **kw,
        **pt_att.flash_bwd_plain_kw("flash_bwd"))
    bounds = _cut(case, *_abs_products(case, inputs))
    moved = False
    for g, w, b in zip(_cut(case, *got), _cut(case, *want), bounds):
        err = np.abs(g.numpy() - w)
        assert (err <= 2.0 ** -8 * b + 1e-5).all(), \
            (err - 2.0 ** -8 * b).max()
        moved |= bool((err > 1e-5).any())
    assert moved          # the rounding is there: the f32 test's 1e-5 fails


def test_flash_attention_bf16_backward_on_cpu_is_the_routes_plain_version():
    """bf16 at head_dim 64 on the CPU: FlashAttention's backward runs the
    plain backward at the wgmma route's blocks and rounding, so the
    autograd grads equal its f32 results cast, bit for bit."""
    B, H, Hkv, S, D = 1, 4, 2, 200, 64
    q, do = (torch.from_numpy(_normal(B, H, S, D)).to(BF16)
             for _ in range(2))
    k, v = (torch.from_numpy(_normal(B, Hkv, S, D)).to(BF16)
            for _ in range(2))
    route = pt_att.flash_bwd_route(q, k, v, do)
    assert route == "flash_bwd"
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = pt_att.flash_attention_train(*leaves, causal=True)
    grads = torch.autograd.grad(o, leaves, do)
    o_ref, lse = pt_att.flash_attention_fwd_plain(
        q.reshape(B * H, S, D), k.reshape(B * Hkv, S, D),
        v.reshape(B * Hkv, S, D), causal=True, block_q=128, block_k=128)
    o_ref = o_ref.reshape(q.shape)
    assert torch.equal(o.detach(), o_ref)
    delta = (o_ref.float() * do.float()).sum(-1).reshape(B * H, S) \
        .contiguous()
    want = pt_att.flash_attention_bwd_plain(
        q.reshape(B * H, S, D), k.reshape(B * Hkv, S, D),
        v.reshape(B * Hkv, S, D), do.reshape(B * H, S, D), lse, delta,
        causal=True, **pt_att.flash_bwd_plain_kw(route))
    for gr, w, x in zip(grads, want, (q, k, v)):
        assert gr.dtype == BF16
        assert torch.equal(gr, w.reshape(x.shape).to(BF16))
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


# ---------------------------------------------------------------------------
# the build: headers in the hash, the ptxas report
# ---------------------------------------------------------------------------

def test_build_hash_covers_included_headers(tmp_path, monkeypatch):
    (tmp_path / "k.cu").write_text('#include "a.cuh"\n#include <cuda.h>\n')
    (tmp_path / "a.cuh").write_text('#include "b.cuh"\n')
    (tmp_path / "b.cuh").write_text("// b\n")
    monkeypatch.setattr(_build, "CSRC", tmp_path)
    assert _build._headers(tmp_path / "k.cu") == [tmp_path / "a.cuh",
                                                  tmp_path / "b.cuh"]
    first = _build._target("k")
    (tmp_path / "b.cuh").write_text("// b, edited\n")
    assert _build._target("k") != first
    # the port's sources: the tensor-core kernels include hopper.cuh
    monkeypatch.undo()
    for name in ("matmul", "flash_fwd"):
        assert _build._headers(_build.CSRC / f"{name}.cu") == \
            [_build.CSRC / "hopper.cuh"]


def test_ptxas_report_reads_each_kernel():
    log = """ptxas info    : 0 bytes gmem
ptxas info    : Compiling entry function '_Z1ai' for 'sm_90a'
ptxas info    : Function properties for _Z1ai
    0 bytes stack frame, 0 bytes spill stores, 0 bytes spill loads
ptxas info    : Used 168 registers, used 1 barriers
ptxas info    : Compiling entry function '_Z1bi' for 'sm_90a'
ptxas info    : Function properties for _Z1bi
    16 bytes stack frame, 12 bytes spill stores, 8 bytes spill loads
ptxas info    : Used 255 registers, used 1 barriers, 16384 bytes smem
"""
    assert _build.ptxas_report(log) == [
        dict(kernel="_Z1ai", registers=168, spill_stores=0, spill_loads=0,
             stack=0, smem=0),
        dict(kernel="_Z1bi", registers=255, spill_stores=12, spill_loads=8,
             stack=16, smem=16384)]
