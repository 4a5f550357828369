"""The port's CUDA kernels against their plain PyTorch versions on the
card, over the shapes and options the serving and training runs do not
reach: ragged lengths, sliding windows, non-causal masks, GQA groups,
head_dim 64 and 16, f32 and int8, the engine's smoke config on the card,
one train step of a small config on the card against the CPU, and the
paper-workload kernels (matmul, conv2d, correlation, dense flash decode)
over every built tile with ragged edges.  The flash forward and the matmul
have several routes (the wgmma kernels, the split-K GEMV, the CUDA-core
kernels); the launch counts show which one each case took.  Every
test needs an sm_90 card and skips elsewhere; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: a bf16 output element may differ by one bf16 ulp of its value
(f32 sums in another order, then rounded) plus an absolute term: 2e-3 for
flash forward, whose p is rounded to bf16 before PV, 1e-4 for paged decode,
which keeps p in f32; each row's relative L2 error stays under 2^-6.  f32
outputs may differ by 1e-4.  The backward kernels' outputs are f32 sums in
another order than the plain version's.  On the CUDA-core route
(``flash_bwd_simt``: f32, head_dim 256, unaligned views) nothing is
rounded: each element within 2^-10 |want| + 1e-5 max|want|, each row's
relative L2 error under 2^-10.  The wgmma routes (``flash_bwd`` and, at
head_dim 256, ``flash_bwd_d256``) round p and ds to bf16 before their
second products, and so does the plain version they are held against; the
two form p and ds in f32 in other orders (and with exp2 in the kernel), so
where a value lies at a bf16 rounding boundary one of them rounds up and
the other down: that term of a sum moves by one bf16 ulp, at most 2^-7 of
itself.  Flips are rare (the f32 values differ by ~1e-6 relative, an ulp
is 2^-8) and unbiased, so the whole tensor's relative L2 error stays under
2^-10; but a row dominated by one term (the last keys of a causal dk / dv
see one q row per head) can move by 2^-7 of its norm, and one element by
2^-7 of its largest term, which may exceed the element itself.  So
(``chip_smoke.closeness_rounded``): each element within
2^-7 (|want| + the RMS of its row + T), T the largest magnitude of a
rounded term of its sum (``attention.flash_bwd_term_max``: |ds| |k| for
dq, |ds| |q| for dk, |p| |do| for dv), each row's L2 error under 2^-7 of
its norm, the tensor's under 2^-10, and each with an absolute floor of
1e-5 max|want| (per element; times sqrt(D) a row) for rows that cancel
to 0 (a causal first q row, whose ds is p (dp - delta) with delta = dp in
exact arithmetic).
The paper-workload kernels' inputs are scaled to unit-variance outputs;
their f32 sums run in another order than the plain version's (atol 1e-3
in bf16, 1e-4 in f32; decode 1e-4 as paged decode)."""
import functools
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

pytestmark = pytest.mark.cuda


@pytest.fixture
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    if torch.cuda.get_device_capability() != (9, 0):
        pytest.skip("needs an sm_90 (Hopper) card")
    return torch.device("cuda")


def _ulp_close(got, want, dtype, atol):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * want.abs() + atol
        row_rel = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        assert row_rel.max().item() <= 2.0 ** -6, \
            f"max row rel L2 err {row_rel.max().item()}"
    else:
        tol = torch.full_like(want, 1e-4)
    bad = diff > tol
    assert not bad.any(), f"max err {diff.max().item()}"


FLASH = [
    # (B, S, Sk, H, Hkv, D, causal, window, dtype)
    (1, 2048, 2048, 32, 8, 128, True, None, torch.bfloat16),
    (2, 200, 200, 8, 2, 128, True, None, torch.bfloat16),
    (1, 300, 300, 8, 8, 64, True, 100, torch.bfloat16),
    (2, 130, 190, 4, 1, 128, False, None, torch.bfloat16),
    # Sq not a multiple of the wgmma kernel's 128 rows, window edges inside
    # its 128-key blocks
    (1, 1000, 1000, 16, 2, 128, True, 300, torch.bfloat16),
    (1, 64, 64, 4, 2, 64, True, 3, torch.float32),
    (1, 257, 257, 16, 4, 128, True, None, torch.float32),
    # olmoe-1b-7b's MHA (16/16 heads, G 1, D 128) and granite-moe's
    # (24/8 heads, G 3, D 64) at the serve phase's prefill lengths
    (1, 1900, 1900, 16, 16, 128, True, None, torch.bfloat16),
    (1, 1900, 1900, 24, 8, 64, True, None, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(dev, case):
    """bf16 takes the wgmma kernel (launch key ``flash_fwd``, 128 x 128
    blocks), f32 the CUDA-core one (``flash_fwd_simt``, 64 x 64); each is
    held against the plain version at its own blocks."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    B, S, Sk, H, Hkv, D, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    route = katt.flash_fwd_route(qt, kt, vt)
    assert route == ("flash_fwd" if dt == torch.bfloat16
                     else "flash_fwd_simt")
    ops.reset_launches()
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, causal=causal,
                                           window=window)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {route: 1}
    bq, bk = katt.flash_fwd_blocks(route)
    o_ref, lse_ref = katt.flash_attention_fwd_plain(
        qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
        vt.reshape(B * Hkv, Sk, D), causal=causal, window=window,
        block_q=bq, block_k=bk)
    assert o.stride() == qt.stride()        # written in q's (B, S, H, D)
    _ulp_close(o.reshape(B * H, S, D), o_ref, dt, atol=2e-3)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


# the model zoo's prefill shapes (bf16): internvl2-26b's G 6 (48 / 8
# heads, D 128); recurrentgemma-9b's local MQA (16 / 1 heads, D 256,
# window 2048 at full width, the head_dim-256 wgmma route; in f32 the
# CUDA-core route); whisper's
# non-causal encoder (1500 x 1500, 16 / 16 heads, D 64) and its cross
# attention from a prompt of 1024 or 16 tokens to 1500 frames
FLASH_ZOO = [
    (1, 1100, 1100, 48, 8, 128, True, None, torch.bfloat16),
    (1, 2600, 2600, 16, 1, 256, True, 2048, torch.bfloat16),
    (1, 700, 700, 16, 1, 256, True, 300, torch.bfloat16),
    (1, 500, 500, 4, 1, 256, True, 200, torch.float32),
    (1, 1500, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (1, 1024, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (1, 16, 1500, 16, 16, 64, False, None, torch.bfloat16),
]


@pytest.mark.parametrize("case", FLASH_ZOO,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_at_zoo_shapes_matches_plain(dev, case):
    """bf16 at head_dim 64 or 128 takes the wgmma kernel ``flash_fwd``, at
    head_dim 256 the wgmma kernel ``flash_fwd_d256`` (128 x 64 blocks); f32
    the CUDA-core one.  Each launches its kernel (no fallback to the plain
    version) and is held against the plain version at its own blocks."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    B, S, Sk, H, Hkv, D, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    route = katt.flash_fwd_route(qt, kt, vt)
    assert route == ("flash_fwd_simt" if dt != torch.bfloat16 else
                     "flash_fwd_d256" if D == 256 else "flash_fwd")
    ops.reset_launches()
    with torch.no_grad():
        o = ops.flash_attention(qt, kt, vt, causal=causal, window=window)
        o2, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, causal=causal,
                                                window=window)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {route: 2}
    assert torch.equal(o, o2)
    bq, bk = katt.flash_fwd_blocks(route)
    o_ref, lse_ref = katt.flash_attention_fwd_plain(
        qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
        vt.reshape(B * Hkv, Sk, D), causal=causal, window=window,
        block_q=bq, block_k=bk)
    _ulp_close(o.reshape(B * H, S, D), o_ref, dt, atol=2e-3)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)


def test_flash_backward_trains_head_dim_256(dev):
    """Head dim 256 trains: the forward and the backward take their
    head_dim-256 wgmma routes, one launch each."""
    from repro_torch.kernels import ops
    q, k, v = (torch.randn((1, h, 128, 256), device=dev,
                           dtype=torch.bfloat16).requires_grad_(True)
               for h in (4, 1, 1))
    ops.reset_launches()
    o = ops.flash_attention(q, k, v, causal=True, window=64)
    o.float().sum().backward()
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {
        "flash_fwd_d256": 1, "flash_bwd_dq_d256": 1, "flash_bwd_dkv_d256": 1}
    assert all(bool(torch.isfinite(x.grad).all()) for x in (q, k, v))


def test_flash_backward_refuses_unbuilt_head_dim(dev):
    """A head dim the backward kernels are not built for (32 here) a
    launch refuses, naming the head dims it takes."""
    from repro_torch.kernels import attention as katt
    q, k, v = (torch.randn((1, h, 128, 32), device=dev, dtype=torch.bfloat16)
               for h in (4, 1, 1))
    lse = torch.zeros((4, 128), device=dev)
    with pytest.raises(ValueError,
                       match=r"head_dim one of \(64, 128, 256\)"):
        katt.flash_bwd_dq_cuda(q, k, v, q, lse, lse)


@pytest.mark.parametrize("arch", ["internvl2-26b", "mamba2-370m",
                                  "recurrentgemma-9b", "whisper-medium"])
def test_zoo_smoke_engine_on_the_card_matches_cpu(dev, arch):
    """The vlm, ssm, hybrid and audio smoke configs (f32) serve the CPU's
    greedy tokens on the card, recurrentgemma past its 64-token window."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import build_engine, make_prompts
    params = get_bundle(arch, smoke=True).init_params(0, device="cpu")
    prompts = make_prompts(256, n_requests=4, prompt_len=40, seed=3) + \
        make_prompts(256, n_requests=2, prompt_len=90, seed=4)
    out = {}
    for device in ("cpu", "cuda"):
        # max_len holds internvl2's 8-token prefix before a 128 bucket
        engine, _ = build_engine(arch, slots=2, max_len=256, max_new=6,
                                 params=params, device=device)
        for p in prompts:
            engine.submit(p)
        out[device] = engine.run()
    assert out["cuda"] == out["cpu"]


def _bwd_close(got, want):
    diff = (got - want).abs()
    tol = 2.0 ** -10 * want.abs() + 1e-5 * want.abs().max()
    row_rel = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert row_rel.max().item() <= 2.0 ** -10, \
        f"max row rel L2 err {row_rel.max().item()}"
    assert not (diff > tol).any(), f"max err {diff.max().item()}"


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _bwd_close_rounded(got, want, terms):
    """A wgmma route against its rounded plain version (module docstring);
    ``terms``: the output's ``flash_bwd_term_max``."""
    close = _chip_smoke().closeness_rounded(got, want, terms)
    assert close["within_tol"], close


# the forward's cases; head_dim 64 at GQA groups 1, 4 and 8; and
# non-causal with a window past the keys: q rows from 163 on see no key,
# so their lse is -1e30 and their dq must be 0
FLASH_BWD = FLASH + [
    (1, 512, 512, 8, 8, 64, True, None, torch.bfloat16),
    (2, 384, 384, 16, 4, 64, True, 200, torch.bfloat16),
    (1, 300, 300, 16, 2, 64, False, None, torch.bfloat16),
    (1, 256, 64, 8, 1, 64, False, 100, torch.bfloat16),
    (1, 256, 64, 4, 2, 64, False, 100, torch.float32),
    # recurrentgemma-9b's local MQA at head_dim 256 (16 / 1 heads, a
    # window): the head_dim-256 wgmma pair in bf16 (dk/dv in 16 parts),
    # the CUDA-core pair in f32, ragged S, Sq != Sk
    (1, 1100, 1100, 16, 1, 256, True, 700, torch.bfloat16),
    (1, 300, 430, 16, 1, 256, True, 200, torch.bfloat16),
    (1, 500, 500, 4, 1, 256, True, 200, torch.float32),
    (1, 200, 330, 4, 1, 256, False, 150, torch.float32),
    # whisper-medium's non-causal encoder (1500 x 1500) and its cross
    # attention (1024 x 1500) at 16 / 16 heads, D 64; internvl2-26b's
    # 48 / 8 heads (G 6), D 128, over its 2304 positions
    (1, 1500, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (1, 1024, 1500, 16, 16, 64, False, None, torch.bfloat16),
    (1, 2304, 2304, 48, 8, 128, True, None, torch.bfloat16),
]


def _bwd_route(dt, D):
    """The backward route a case must take: bf16 at head_dim 64 or 128
    the wgmma pair, at 256 the head_dim-256 wgmma pair, f32 the CUDA-core
    pair."""
    if dt != torch.bfloat16:
        return "flash_bwd_simt"
    return "flash_bwd" if D in (64, 128) else "flash_bwd_d256"


# the launch keys of each backward route
BWD_KEYS = {"flash_bwd": ("flash_bwd_dq", "flash_bwd_dkv"),
            "flash_bwd_d256": ("flash_bwd_dq_d256", "flash_bwd_dkv_d256"),
            "flash_bwd_simt": ("flash_bwd_dq_simt", "flash_bwd_dkv_simt")}


def _bwd_inputs(dev, case, seed=3):
    B, S, Sk, H, Hkv, D, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    return tuple(x.transpose(1, 2) for x in (q, k, v, do))


def _bwd_check(qt, kt, vt, dot, causal, window, route, q_offset=0,
               k_offset=0, parts=None):
    """The backward kernels fed the forward kernel's own o and lse, as
    ``FlashAttention`` feeds them, against the plain backward on the same
    residuals at the route's blocks and rounding (and offsets); ``parts``
    overrides the head_dim-256 dk/dv split."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    B, H, S, D = qt.shape
    Hkv, Sk = kt.shape[1], kt.shape[2]
    assert katt.flash_bwd_route(qt, kt, vt, dot) == route
    kw = dict(causal=causal, window=window, q_offset=q_offset,
              k_offset=k_offset)
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
    o = o.reshape(B * H, S, D)
    delta = (o.float() * dot.reshape(B * H, S, D).float()).sum(-1)
    ops.reset_launches()
    got = (katt.flash_bwd_dq_cuda(qt, kt, vt, dot, lse, delta, **kw),
           *katt.flash_bwd_dkv_cuda(qt, kt, vt, dot, lse, delta, **kw,
                                    parts=parts))
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == \
        dict.fromkeys(BWD_KEYS[route], 1)
    flat = (qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
            vt.reshape(B * Hkv, Sk, D), dot.reshape(B * H, S, D), lse, delta)
    plain_kw = dict(kw, **katt.flash_bwd_plain_kw(route))
    want = katt.flash_attention_bwd_plain(*flat, **plain_kw)
    # written in q's and k's memory layouts (dense views: their own strides)
    assert got[0].stride() == torch.empty_like(qt).stride()
    assert got[1].stride() == torch.empty_like(kt).stride()
    if route == "flash_bwd_simt":
        terms = (None,) * 3
    else:
        terms = katt.flash_bwd_term_max(*flat, **plain_kw)
    for x, w, t in zip(got, want, terms):
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
        if t is None:
            _bwd_close(x.reshape(w.shape), w)
        else:
            _bwd_close_rounded(x.reshape(w.shape), w, t)
    if not causal and window is not None and S > Sk - 1 + window:
        dead = (lse == -1e30)        # q rows that see no key: dq is 0
        assert dead.any() and (got[0].reshape(want[0].shape)[dead] == 0).all()
    dead = (lse == -1e30)
    assert (got[0].reshape(want[0].shape)[dead] == 0).all()
    return got


@pytest.mark.parametrize("case", FLASH_BWD,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernels_match_plain(dev, case):
    """bf16 takes a wgmma pair (head_dim 64 or 128, or the head_dim-256
    one; held against the rounded plain version at its blocks), f32 the
    CUDA-core pair (the unrounded one at 64 x 64)."""
    route = _bwd_route(case[-1], case[5])
    _bwd_check(*_bwd_inputs(dev, case), case[6], case[7], route)


@pytest.mark.parametrize("case", [
    (1, 200, 200, 8, 2, 128, True, None),
    (2, 130, 190, 4, 1, 64, False, 50),
    # recurrentgemma's 16 / 1 heads at head_dim 256, Sq != Sk, a window:
    # the CUDA-core pair stays covered in bf16
    (1, 300, 430, 16, 1, 256, True, 200)],
    ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_simt_route_takes_unaligned_bf16(dev, case):
    """bf16 whose seq stride is not a multiple of 8 elements (a slice of a
    wider buffer) takes the CUDA-core pair, held against the unrounded
    plain version at 64 x 64."""
    B, S, Sk, H, Hkv, D, causal, window = case
    g = torch.Generator(device=dev).manual_seed(4)

    def view(s, h):
        wide = torch.randn((B, s, h * D + 4), generator=g, device=dev)
        return wide.to(torch.bfloat16)[..., :h * D].unflatten(
            -1, (h, D)).transpose(1, 2)

    qt, kt, vt, dot = view(S, H), view(Sk, Hkv), view(Sk, Hkv), view(S, H)
    _bwd_check(qt, kt, vt, dot, causal, window, "flash_bwd_simt")


def test_flash_bwd_wgmma_is_deterministic(dev):
    """No atomics: two launches of the wgmma pair on the same inputs give
    the same bits (the per-layer recompute relies on it)."""
    from repro_torch.kernels import attention as katt
    qt, kt, vt, dot = _bwd_inputs(dev, FLASH_BWD[0], seed=9)
    B, H, S, D = qt.shape
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, causal=True)
    delta = (o.float() * dot.float()).sum(-1).reshape(B * H, S)
    first = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse, delta)
    second = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse, delta)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


# q / k position offsets (the ring's per-hop fold) on every route: shifts
# of +100 and +348 inside a window, -256 (q rows 0-255 see no key), -512
# (a future shard: every row sees none), +300 against a window of 100, and
# -200 non-causal
FLASH_OFFSETS = [
    # (B, S, Sk, H, Hkv, D, causal, window, dtype, q_offset, k_offset)
    (1, 1000, 1000, 16, 2, 128, True, 300, torch.bfloat16, 1000, 900),
    (2, 300, 500, 8, 2, 128, True, None, torch.bfloat16, 0, 256),
    (1, 700, 700, 16, 1, 256, True, 300, torch.bfloat16, 2048, 1700),
    (1, 512, 512, 8, 1, 256, True, None, torch.bfloat16, 512, 1024),
    (1, 300, 300, 8, 2, 128, True, 100, torch.float32, 300, 0),
    (1, 400, 400, 4, 1, 64, False, 150, torch.bfloat16, 100, 300),
    (1, 500, 500, 8, 1, 256, True, 200, torch.float32, 700, 600),
]


def _padded_view(g, dev, B, S, h, D, dt):
    """A (B, h, S, D) view of a (B, S, h * D + 4) buffer: a seq stride
    that is not a multiple of 8 elements, which TMA cannot read."""
    wide = torch.randn((B, S, h * D + 4), generator=g, device=dev).to(dt)
    return wide[..., :h * D].unflatten(-1, (h, D)).transpose(1, 2)


@pytest.mark.parametrize("padded", [False, True], ids=["tma", "padded"])
@pytest.mark.parametrize("case", FLASH_OFFSETS,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_fwd_routes_at_offsets_match_plain(dev, case, padded):
    """Each forward route at nonzero offsets (bf16 views TMA can read: the
    wgmma kernels; f32, or a padded seq stride: the CUDA-core one) against
    the plain version at the route's blocks and the same offsets; rows
    that see no key drain o = 0, lse = -1e30."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    B, S, Sk, H, Hkv, D, causal, window, dt, qo, ko = case
    g = torch.Generator(device=dev).manual_seed(11)
    if padded:
        qt, kt, vt = (_padded_view(g, dev, B, n, h, D, dt)
                      for n, h in ((S, H), (Sk, Hkv), (Sk, Hkv)))
    else:
        qt, kt, vt = (torch.randn((B, n, h, D), generator=g, device=dev)
                      .to(dt).transpose(1, 2)
                      for n, h in ((S, H), (Sk, Hkv), (Sk, Hkv)))
    route = katt.flash_fwd_route(qt, kt, vt)
    assert route == ("flash_fwd_simt" if padded or dt != torch.bfloat16 else
                     "flash_fwd_d256" if D == 256 else "flash_fwd")
    kw = dict(causal=causal, window=window, q_offset=qo, k_offset=ko)
    ops.reset_launches()
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {route: 1}
    bq, bk = katt.flash_fwd_blocks(route)
    o_ref, lse_ref = katt.flash_attention_fwd_plain(
        qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
        vt.reshape(B * Hkv, Sk, D), block_q=bq, block_k=bk, **kw)
    _ulp_close(o.reshape(B * H, S, D), o_ref, dt, atol=2e-3)
    torch.testing.assert_close(lse, lse_ref, atol=1e-4, rtol=0)
    dead = lse_ref == -1e30
    if causal and qo < ko:
        assert dead.any()
    assert (o.reshape(B * H, S, D)[dead] == 0).all() and \
        (lse[dead] == -1e30).all()


FLASH_BWD_OFFSETS = [
    # (B, S, Sk, H, Hkv, D, causal, window, dtype, q_offset, k_offset)
    (1, 1000, 1000, 16, 2, 128, True, 300, torch.bfloat16, 1000, 900),
    (2, 300, 500, 8, 2, 128, True, None, torch.bfloat16, 0, 256),
    (1, 384, 384, 16, 4, 64, True, 200, torch.bfloat16, 512, 256),
    (1, 300, 300, 8, 2, 128, True, 100, torch.float32, 300, 0),
    (1, 256, 256, 4, 2, 64, False, 100, torch.float32, 64, 128),
    (1, 700, 700, 16, 1, 256, True, 300, torch.bfloat16, 2048, 1700),
    # head_dim 256 with q behind k: q rows 0-255 see no key (dq 0)
    (1, 512, 512, 8, 1, 256, True, None, torch.bfloat16, 512, 768),
]


@pytest.mark.parametrize("case", FLASH_BWD_OFFSETS,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_routes_at_offsets_match_plain(dev, case):
    """Every backward route at nonzero offsets (bf16: a wgmma pair, the
    head_dim-256 one at D 256, against the rounded plain version; f32: the
    CUDA-core pair against the unrounded one), fed the forward kernel's o
    and lse at the same offsets; rows that see no key get dq = 0."""
    B, S, Sk, H, Hkv, D, causal, window, dt, qo, ko = case
    route = _bwd_route(dt, D)
    _bwd_check(*_bwd_inputs(dev, case[:9]), causal, window, route,
               q_offset=qo, k_offset=ko)


def _twice_same_bits(qt, kt, vt, dot, route):
    """Two launches of ``route``'s backward pair on the same inputs (a
    window of 700) give the same bits: no atomics, and the head_dim-256
    dk/dv partials add in one order."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    B, H, S, D = qt.shape
    assert katt.flash_bwd_route(qt, kt, vt, dot) == route
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, window=700)
    delta = (o.float() * dot.float()).sum(-1).reshape(B * H, S) \
        .contiguous()
    ops.reset_launches()
    first = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse, delta,
                                          window=700)
    second = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse, delta,
                                           window=700)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == \
        dict.fromkeys(BWD_KEYS[route], 2)
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_bwd_d256_is_deterministic(dev):
    """No atomics at head_dim 256 either: two launches of the
    head_dim-256 wgmma pair (dk/dv in 16 parts here, added in order) on
    the same inputs give the same bits."""
    from repro_torch.kernels import attention as katt
    case = (1, 1100, 1100, 16, 1, 256, True, 700, torch.bfloat16)
    assert katt.flash_bwd_dkv_plan(1, 1, 16, 1100).parts == 16
    _twice_same_bits(*_bwd_inputs(dev, case, seed=10), "flash_bwd_d256")


def test_flash_bwd_d256_simt_is_deterministic(dev):
    """... and of the CUDA-core pair at head_dim 256, in bf16 through a
    padded seq stride."""
    g = torch.Generator(device=dev).manual_seed(10)
    qt, kt, vt, dot = (_padded_view(g, dev, 1, 1100, h, 256, torch.bfloat16)
                       for h in (16, 1, 1, 16))
    _twice_same_bits(qt, kt, vt, dot, "flash_bwd_simt")


@pytest.mark.parametrize("parts", [1, 2, 8, 16])
def test_flash_bwd_dkv_d256_parts_match_plain(dev, parts):
    """Splits of the head_dim-256 dk/dv (one part writes dk / dv itself;
    more write partials that a second kernel adds) against the rounded
    plain version, at recurrentgemma's 16 / 1 heads."""
    case = (1, 700, 700, 16, 1, 256, True, 300, torch.bfloat16)
    _bwd_check(*_bwd_inputs(dev, case, seed=12), True, 300, "flash_bwd_d256",
               parts=parts)


def test_flash_bwd_d256_wgmma_kernels_build_without_spills(dev):
    """``ptxas`` reports no spill for the head_dim-256 wgmma backward
    kernels: dq holds a 64 x 256 f32 dQ and 64 x 32 S and dP a thread's
    warpgroup, dk/dv a 64 x 256 dK (or dV) beside S^T and dP^T, within the
    255 registers of a 256-thread CTA."""
    from repro_torch.kernels import _build
    _build.load("flash_bwd")
    report = _build.ptxas_report(_build.build_log("flash_bwd"))
    d256 = [r for r in report if "flash_bwd_dq_d256_kernel" in r["kernel"]
            or "flash_bwd_dkv_d256_kernel" in r["kernel"]]
    assert len(d256) == 2, report
    for r in d256:
        assert r["registers"] <= 255, r
        assert r["spill_stores"] == r["spill_loads"] == 0, r


def test_flash_bwd_d256_kernels_build_without_spills(dev):
    """``ptxas`` reports no spill for the head_dim-256 CUDA-core backward
    kernels (dq and dk/dv, bf16 and f32): dk/dv holds 2 x 4 x 16 f32
    accumulators a thread beside its S and dP tiles, within 255
    registers."""
    from repro_torch.kernels import _build
    _build.load("flash_bwd")
    report = _build.ptxas_report(_build.build_log("flash_bwd"))
    d256 = [r for r in report if "Li256E" in r["kernel"] and
            ("flash_bwd_dq_kernel" in r["kernel"] or
             "flash_bwd_dkv_kernel" in r["kernel"])]
    assert len(d256) == 4, report
    for r in d256:
        assert r["registers"] <= 255, r
        assert r["spill_stores"] == r["spill_loads"] == 0, r


def test_flash_fwd_d256_is_deterministic(dev):
    """Two launches of the head_dim-256 wgmma kernel on the same inputs
    give the same bits."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(21)
    qt, kt, vt = (torch.randn((1, 1100, h, 256), generator=g, device=dev)
                  .to(torch.bfloat16).transpose(1, 2) for h in (16, 1, 1))
    ops.reset_launches()
    first = katt.flash_attention_fwd_cuda(qt, kt, vt, window=700)
    second = katt.flash_attention_fwd_cuda(qt, kt, vt, window=700)
    assert ops.LAUNCHES["flash_fwd_d256"] == 2
    assert all(torch.equal(a, b) for a, b in zip(first, second))


def test_flash_fwd_wgmma_kernels_build_without_spills(dev):
    """``ptxas`` reports no spill for the wgmma kernels of
    csrc/flash_fwd.cu: the head_dim-256 kernel holds a 64 x 256 f32 O
    accumulator a warpgroup, 128 registers a thread of its 255."""
    from repro_torch.kernels import _build
    _build.load("flash_fwd")
    report = _build.ptxas_report(_build.build_log("flash_fwd"))
    d256 = [r for r in report if "flash_fwd_d256_kernel" in r["kernel"]]
    assert len(d256) == 1 and d256[0]["registers"] <= 255, report
    wgmma = [r for r in report if "wgmma_kernel" in r["kernel"]] + d256
    assert len(wgmma) == 3
    for r in wgmma:
        assert r["spill_stores"] == r["spill_loads"] == 0, r


PAGED = [
    # (B, H, Hkv, D, page, max_pages, form)
    (4, 32, 8, 128, 16, 128, "bf16"),
    (4, 32, 8, 128, 16, 128, "int8"),
    (3, 16, 2, 64, 32, 9, "bf16"),
    (5, 8, 8, 128, 8, 7, "f32"),
    (2, 4, 2, 16, 16, 4, "f32"),
    (2, 4, 2, 16, 16, 4, "int8"),
    # G 1 and G 8, bf16 and int8 (int8 at G 8 takes 8-byte loads)
    (4, 8, 8, 128, 16, 64, "bf16"),
    (4, 8, 8, 128, 16, 64, "int8"),
    (4, 64, 8, 128, 16, 40, "bf16"),
    (4, 64, 8, 128, 16, 40, "int8"),
    # D 64; pages of 8, 16 and 32 at the serving shape
    (4, 32, 8, 64, 16, 33, "bf16"),
    (4, 32, 8, 64, 16, 33, "int8"),
    (4, 32, 8, 128, 8, 100, "bf16"),
    (4, 32, 8, 128, 32, 24, "int8"),
    # f32 D 20 (five float4 vectors a row) and D 256 (two a lane); bf16 and
    # int8 D 20, whose rows are no 16-byte multiple: scalar loads
    (3, 8, 2, 20, 16, 10, "f32"),
    (2, 8, 2, 256, 16, 6, "f32"),
    (3, 8, 2, 20, 16, 10, "bf16"),
    (3, 8, 2, 20, 16, 10, "int8"),
    # olmoe-1b-7b (16 kv heads, G 1, D 128) and granite-moe (8 kv heads,
    # G 3, D 64) at the serve phase's 4 slots and 2048-token view
    (4, 16, 16, 128, 16, 128, "bf16"),
    (4, 16, 16, 128, 16, 128, "int8"),
    (4, 24, 8, 64, 16, 128, "bf16"),
    (4, 24, 8, 64, 16, 128, "int8"),
]


def _paged_inputs(dev, case, seed=1, pps=None):
    """q, pools (int8 with scales for ``int8``), a table of distinct pages
    and lengths: one live token, a full table, and the rest at the edges
    of the splits (``pps`` pages, default the kernel's plan) and between
    them."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models.layers import quantize_kv
    B, H, Hkv, D, page, MP, form = case
    P = B * MP + 1
    g = torch.Generator(device="cpu").manual_seed(seed)
    split = page * (pps or kpa.paged_decode_plan(B, Hkv, MP, page)[0])
    edges = [n for e in range(split, MP * page, split)
             for n in (e - 1, e, e + 1)]
    lens = torch.randint(1, MP * page + 1, (B,), generator=g)
    for b in range(1, B - 1):
        if edges:
            lens[b] = edges[(b - 1) % len(edges)]
    lens[0] = 1                                    # one live token
    lens[-1] = MP * page                           # a full table
    table = torch.zeros((B, MP), dtype=torch.int32)
    perm = torch.randperm(P - 1, generator=g)[:B * MP].reshape(B, MP) + 1
    for b in range(B):
        n = -(-int(lens[b]) // page)
        table[b, :n] = perm[b, :n]
    qdt = torch.float32 if form == "f32" else torch.bfloat16
    q = torch.randn((B, H, D), generator=g).to(dev, qdt)
    kf = torch.randn((P, page, Hkv, D), generator=g).to(dev)
    vf = torch.randn((P, page, Hkv, D), generator=g).to(dev)
    if form == "int8":
        (k, ks), (v, vs) = quantize_kv(kf), quantize_kv(vf)
    else:
        k, v, ks, vs = kf.to(qdt), vf.to(qdt), None, None
    return q, k, v, table.to(dev), lens.to(dev, torch.int32), ks, vs


@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(map(str, c)))
def test_paged_kernel_matches_plain(dev, case):
    from repro_torch.kernels import paged_attention as kpa
    args = _paged_inputs(dev, case)
    qdt = args[0].dtype
    _ulp_close(kpa.paged_flash_decode_cuda(*args),
               kpa.paged_flash_decode_plain(*args), qdt, atol=1e-4)


@pytest.mark.parametrize("pps", (1, 2, 4, 7, 128))
@pytest.mark.parametrize("form", ("bf16", "int8"))
def test_paged_kernel_splits_match_plain(dev, form, pps):
    """Every split length, from one page to the whole table (one split,
    no combine), against the plain version at the same split."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import ops
    args = _paged_inputs(dev, (4, 32, 8, 128, 16, 128, form), seed=3,
                         pps=pps)
    ops.reset_launches()
    got = kpa.paged_flash_decode_cuda(*args, pages_per_split=pps)
    assert ops.LAUNCHES["paged_decode_int8" if form == "int8" else
                        "paged_decode_bf16"] == 1
    _ulp_close(got, kpa.paged_flash_decode_plain(*args, pages_per_split=pps),
               torch.bfloat16, atol=1e-4)


@pytest.mark.parametrize("form", ("bf16", "int8"))
def test_paged_kernel_gives_the_same_bits_twice(dev, form):
    """No atomics: the splits combine in a fixed order."""
    from repro_torch.kernels import paged_attention as kpa
    args = _paged_inputs(dev, (4, 32, 8, 128, 16, 128, form), seed=4)
    assert torch.equal(kpa.paged_flash_decode_cuda(*args),
                       kpa.paged_flash_decode_cuda(*args))


def test_paged_launchers_make_no_host_sync(dev):
    """The split plan reads shapes only, and the workspace is allocated
    without a sync: a launch through the launcher or ``ops`` never waits
    for the card (the serving tick makes 36 of them)."""
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.kernels import ops
    calls = []
    for form in ("bf16", "int8"):
        args = _paged_inputs(dev, (4, 32, 8, 128, 16, 128, form), seed=5)
        kpa.paged_flash_decode_cuda(*args)          # build and load first
        calls.append(args)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        for args in calls:
            kpa.paged_flash_decode_cuda(*args)
            ops.paged_flash_decode(*args)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()


def test_paged_kernel_reads_a_layer_slice_in_place(dev):
    """The engine hands the kernel pool["k"][layer]: a strided slice."""
    from repro_torch.kernels import paged_attention as kpa
    L, P, page, Hkv, D, B, H = 3, 9, 16, 2, 128, 2, 8
    g = torch.Generator(device="cpu").manual_seed(2)
    pool = torch.randn((L, P, page, Hkv, D), generator=g).to(dev,
                                                              torch.bfloat16)
    q = torch.randn((B, H, D), generator=g).to(dev, torch.bfloat16)
    table = torch.tensor([[1, 2, 3, 4], [5, 6, 7, 8]], dtype=torch.int32,
                         device=dev)
    lens = torch.tensor([50, 64], dtype=torch.int32, device=dev)
    got = kpa.paged_flash_decode_cuda(q, pool[1], pool[2], table, lens)
    want = kpa.paged_flash_decode_plain(q, pool[1].clone(), pool[2].clone(),
                                        table, lens)
    _ulp_close(got, want, torch.bfloat16, atol=1e-4)


def test_launchers_count_launches_and_forward_launch_refuses_autograd(dev):
    """Each kernel's launcher counts its own launches, whichever entry
    point called it.  A forward-only call counts one flash_fwd launch; the
    forward-only launcher refuses inputs that want a gradient; under
    autograd the call goes through FlashAttention, whose backward counts
    one launch of each backward kernel."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    ops.reset_launches()
    x = torch.randn((1, 4, 128, 64), device=dev, dtype=torch.bfloat16)
    ops.flash_attention(x, x[:, :2], x[:, :2])
    assert ops.LAUNCHES["flash_fwd"] == 1
    xr = x.clone().requires_grad_(True)
    with torch.no_grad():
        ops.flash_attention(xr, x[:, :2], x[:, :2])
    assert ops.LAUNCHES["flash_fwd"] == 2
    with pytest.raises(RuntimeError, match="forward-only"):
        katt.flash_attention_fwd_cuda(xr, x[:, :2], x[:, :2])
    assert ops.LAUNCHES["flash_fwd"] == 2
    o = ops.flash_attention(xr, x[:, :2], x[:, :2])
    assert ops.LAUNCHES["flash_fwd"] == 3
    o.float().sum().backward()
    assert xr.grad.dtype == torch.bfloat16 and torch.isfinite(xr.grad).all()
    assert ops.LAUNCHES["flash_bwd_dq"] == ops.LAUNCHES["flash_bwd_dkv"] == 1
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(x, x[:, :2], x[:, :2])
        katt.flash_attention_bwd(x, x[:, :2], x[:, :2], o, lse, x)
    assert ops.LAUNCHES["flash_fwd"] == 4
    assert ops.LAUNCHES["flash_bwd_dq"] == ops.LAUNCHES["flash_bwd_dkv"] == 2
    assert ops.LAUNCHES["flash_bwd_dq_simt"] == \
        ops.LAUNCHES["flash_bwd_dkv_simt"] == 0


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_flash_attention_takes_the_reference_arguments(dev, dt):
    """``ops.flash_attention`` takes the reference's ``block_q``,
    ``block_k``, ``trainable`` and ``prune``.  Blocks other than the
    route's raise, naming the route; ``prune=False`` hands the forward and
    both backward kernels the dense grid and gives ``prune=True``'s output
    and gradients bit for bit (the extra blocks are masked to exactly 0);
    ``trainable=False`` is the forward-only launch, with no gradient."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(17)
    q = _randn(g, (1, 4, 300, 128), dev, dt)
    k, v, do = (_randn(g, s, dev, dt) for s in
                ((1, 2, 300, 128), (1, 2, 300, 128), (1, 4, 300, 128)))
    route = katt.flash_fwd_route(q, k, v)
    assert route == ("flash_fwd" if dt == torch.bfloat16
                     else "flash_fwd_simt")
    bq, bk = katt.flash_fwd_blocks(route)
    other = 64 if bq == 128 else 128
    with pytest.raises(ValueError, match=f"route {route} "):
        ops.flash_attention(q, k, v, block_q=other)
    with pytest.raises(ValueError, match=f"route {route} "):
        ops.flash_attention(q, k, v, block_q=bq, block_k=other)
    for causal, window in ((True, None), (True, 100), (False, 100)):
        kw = dict(causal=causal, window=window, block_q=bq, block_k=bk)
        outs = {}
        for prune in (True, False):
            leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
            o = ops.flash_attention(*leaves, prune=prune, **kw)
            outs[prune] = (o, *torch.autograd.grad(o, leaves, do))
        for a, b in zip(outs[True], outs[False]):
            assert torch.equal(a, b), (causal, window)
    leaves = [x.detach().requires_grad_(True) for x in (q, k, v)]
    with torch.no_grad():
        want = ops.flash_attention(q, k, v)
    ops.reset_launches()
    o = ops.flash_attention(*leaves, trainable=False)
    assert not o.requires_grad and torch.equal(o, want)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {route: 1}


@pytest.mark.parametrize("kv_mode", ["dense", "paged", "paged_int8"])
def test_smoke_engine_on_the_card_matches_cpu(dev, kv_mode):
    """The smoke config (f32) serves on the card through the kernels and
    gives the CPU run's greedy tokens."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_prompts
    params = get_bundle("qwen3-4b", smoke=True).init_params(0, device="cpu")
    prompts = make_prompts(256, n_requests=4, prompt_len=20,
                           prefix_share=0.5, seed=3)
    out = {}
    for device in ("cpu", "cuda"):
        engine, _ = build_engine("qwen3-4b", slots=2, max_len=64, max_new=6,
                                 kv_mode=kv_mode, page_size=8, params=params,
                                 device=device)
        for p in prompts:
            engine.submit(p)
        ops.reset_launches()
        out[device] = engine.run()
    assert out["cuda"] == out["cpu"]
    if kv_mode != "dense":
        key = "paged_decode_int8" if kv_mode == "paged_int8" \
            else "paged_decode_bf16"
        assert ops.LAUNCHES[key] > 0


@pytest.mark.parametrize("kv_mode", ["dense", "paged", "paged_int8"])
@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_smoke_engine_on_the_card_matches_cpu(dev, arch, kv_mode):
    """The MoE smoke configs (f32; MHA and G 3) likewise: the routing's
    stable sort and the dispatch give the CPU's tokens on the card."""
    from repro_torch.configs import get_bundle
    from repro_torch.kernels import ops
    from repro_torch.launch.serve import build_engine, make_prompts
    params = get_bundle(arch, smoke=True).init_params(0, device="cpu")
    prompts = make_prompts(256, n_requests=4, prompt_len=20,
                           prefix_share=0.5, seed=3)
    out = {}
    for device in ("cpu", "cuda"):
        engine, _ = build_engine(arch, slots=2, max_len=64, max_new=6,
                                 kv_mode=kv_mode, page_size=8, params=params,
                                 device=device)
        for p in prompts:
            engine.submit(p)
        ops.reset_launches()
        out[device] = engine.run()
    assert out["cuda"] == out["cpu"]
    if kv_mode != "dense":
        key = "paged_decode_int8" if kv_mode == "paged_int8" \
            else "paged_decode_bf16"
        assert ops.LAUNCHES[key] > 0


@pytest.mark.parametrize("kv_mode", ["paged", "paged_int8"])
def test_moe_paged_engine_at_capacity_1_25_repeats_on_the_card(dev,
                                                               kv_mode):
    """At capacity 1.25 a decode tick's assignments collide and its pad
    and idle rows, which read trash page 0, take capacity: the card must
    serve the same tokens twice, and the CPU's."""
    import dataclasses

    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import make_prompts
    from repro_torch.serving import ServeConfig, ServingEngine
    bundle = get_bundle("olmoe-1b-7b", smoke=True)
    bundle = dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, moe=dataclasses.replace(bundle.cfg.moe,
                                            capacity_factor=1.25)))
    params = bundle.init_params(0, device="cpu")
    prompts = make_prompts(256, n_requests=4, prompt_len=20,
                           prefix_share=0.5, seed=3)
    out = []
    for device in ("cpu", "cuda", "cuda"):
        p = {k: ({n: t.to(device) for n, t in v.items()}
                 if isinstance(v, dict) else v.to(device))
             for k, v in params.items()}
        engine = ServingEngine(bundle, p, ServeConfig(
            batch=2, max_len=64, max_new_tokens=6, kv_mode=kv_mode,
            page_size=8), device=torch.device(device))
        for q in prompts:
            engine.submit(q)
        out.append(engine.run())
    assert out[1] == out[2] == out[0]


def test_train_step_on_the_card_matches_cpu(dev):
    """One AdamW step of a small config the kernels take (2 layers, d 256,
    4/2 heads, head_dim 64, S 256, bf16, attn_impl 'pallas') on the card,
    through the flash forward and backward kernels, against the same step
    on the CPU through their plain versions: loss within 1e-2 relative
    (bf16 activations summed in other orders), every grad leaf at cosine
    > 0.999 and its norm within 1% of the CPU's."""
    from repro_torch.kernels import ops
    from repro_torch.models import TransformerConfig, transformer
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves, tree_map
    from repro_torch.training import TrainHyper, loss_fn, make_train_step
    cfg = TransformerConfig(name="card-train", n_layers=2, d_model=256,
                            n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                            head_dim=64, qk_norm=True, attn_impl="pallas")
    host = transformer.init_params(
        cfg, torch.Generator().manual_seed(0), torch.device("cpu"))
    toks = torch.randint(0, 512, (2, 257),
                         generator=torch.Generator().manual_seed(1))
    batch = {"tokens": toks[:, :-1], "labels": toks[:, 1:]}

    def forward(params, b):
        return transformer.forward(cfg, params, b["tokens"])

    out = {}
    for device in ("cpu", "cuda"):
        # a copy on either device: the step below updates it in place
        params = tree_map(lambda t: t.to(device, copy=True), host)
        b = {k: v.to(device) for k, v in batch.items()}
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        ops.reset_launches()
        loss, _ = loss_fn(forward, params, b)
        grads = torch.autograd.grad(loss, leaves)
        launches = dict(ops.LAUNCHES)
        for p in leaves:
            p.requires_grad_(False)
        step = make_train_step(forward, TrainHyper(
            optimizer=AdamWConfig(warmup_steps=5, total_steps=10)))
        _, _, m = step(params, adamw_init(params), b)
        out[device] = (loss.item(), [g.float().cpu() for g in grads],
                       float(m["loss"]), float(m["finite"]), launches)
    (l_cpu, g_cpu, m_cpu, _, _), (l_gpu, g_gpu, m_gpu, fin, n) = \
        out["cpu"], out["cuda"]
    assert abs(l_gpu - l_cpu) <= 1e-2 * abs(l_cpu)
    assert abs(m_gpu - m_cpu) <= 1e-2 * abs(m_cpu) and fin == 1.0
    cos = [torch.nn.functional.cosine_similarity(a.flatten(), b.flatten(),
                                                 dim=0).item()
           for a, b in zip(g_gpu, g_cpu)]
    assert min(cos) > 0.999, cos
    # the cosine is blind to a wrong scale (a factor applied twice, a GQA
    # group summed G times): hold each leaf's norm to the CPU's within 1%
    ratio = [(a.norm() / b.norm()).item() for a, b in zip(g_gpu, g_cpu)]
    assert max(abs(r - 1.0) for r in ratio) < 1e-2, ratio
    # remat: each layer's flash forward runs again in the backward
    assert n["flash_fwd"] == 2 * cfg.n_layers
    assert n["flash_bwd_dq"] == n["flash_bwd_dkv"] == cfg.n_layers
    assert n["flash_bwd_dq_simt"] == n["flash_bwd_dkv_simt"] == 0


# ---------------------------------------------------------------------------
# paper-workload kernels: matmul, conv2d, correlation, dense flash decode
# ---------------------------------------------------------------------------

def _paper_close(got, want, dtype, atol):
    got, want = got.float(), want.float()
    diff = (got - want).abs()
    if dtype == torch.bfloat16:
        tol = 2.0 ** -7 * want.abs() + atol
        row_rel = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
        assert row_rel.max().item() <= 2.0 ** -6, \
            f"max row rel L2 err {row_rel.max().item()}"
    else:
        tol = torch.full_like(want, 1e-4)
    assert not (diff > tol).any(), f"max err {diff.max().item()}"


def _randn(g, shape, dev, dt, scale=1.0):
    return (torch.randn(shape, generator=g, device=dev) * scale).to(dt)


@pytest.mark.parametrize("dt", [torch.bfloat16, torch.float32],
                         ids=["bf16", "f32"])
def test_matmul_kernel_matches_plain_on_every_built_tile(dev, dt):
    """The CUDA-core kernel (route ``matmul_simt``) on every tile its tile
    search can return, on ragged M, N and K."""
    from repro_torch.core.cuda_bridge import MATMUL_TILES
    from repro_torch.kernels import matmul as kmm
    g = torch.Generator(device=dev).manual_seed(7)
    for M, N, K in ((1, 200, 300), (130, 70, 97), (257, 129, 64)):
        a = _randn(g, (M, K), dev, dt)
        b = _randn(g, (K, N), dev, dt, K ** -0.5)
        want = kmm.matmul_plain(a, b, block_k=64)
        for bm, bn, bk in sorted(MATMUL_TILES):
            got = kmm.matmul_simt_cuda(a, b, block_m=bm, block_n=bn,
                                       block_k=bk)
            assert got.dtype == dt and got.shape == (M, N)
            _paper_close(got, want, dt, atol=1e-3)


def _padded(g, rows, cols, pitch, dev, scale=1.0):
    """A (rows, cols) bf16 view with row stride ``pitch``: a ragged width
    that TMA and 16-byte loads can still read."""
    return _randn(g, (rows, pitch), dev, torch.bfloat16, scale)[:, :cols]


def test_matmul_wgmma_matches_plain_on_every_built_tile(dev):
    """The wgmma kernel (route ``matmul``) on every tile it is built for,
    on ragged M, N and K: 193 x 130 x 200 (B's rows padded to 136), a K
    shorter than one 64-deep stage, M exactly 64, and the GEMM_1K shape."""
    from repro_torch.core.cuda_bridge import WGMMA_TILES
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(14)
    for M, N, K, pitch in ((193, 130, 200, 136), (300, 64, 40, 64),
                           (64, 520, 1000, 520), (1024, 1024, 1024, 1024)):
        a = _randn(g, (M, K), dev, torch.bfloat16)
        b = _padded(g, K, N, pitch, dev, K ** -0.5)
        assert kmm.matmul_route(a, b) == "matmul"
        want = kmm.matmul_plain(a, b, block_k=64)
        ops.reset_launches()
        for bm, bn, bk in sorted(WGMMA_TILES):
            got = kmm.matmul_cuda(a, b, block_m=bm, block_n=bn, block_k=bk)
            assert got.dtype == torch.bfloat16 and got.shape == (M, N)
            _paper_close(got, want, torch.bfloat16, atol=1e-3)
        assert ops.LAUNCHES["matmul"] == len(WGMMA_TILES)


@pytest.mark.parametrize("M", [1, 3, 7, 40])
def test_matmul_gemv_matches_plain(dev, M):
    """The split-K GEMV kernel at M 1, 3, 7 and 40 (five 8-row groups), on
    a ragged N (200: a partial 64-column strip; 130 with rows padded to
    136: a partial 8-column vector) and K that no split divides; and the
    GEMM_FC shape.  Two runs give the same bits (the splits are summed in a
    fixed order, no atomics).  The route (``matmul_gemv``) sends the kernel
    only M <= ``GEMV_MAX_M`` (1), and ``ops.matmul`` must take it there;
    the other M are launched directly."""
    from repro_torch.core.cuda_bridge import GEMV_MAX_M, gemv_plan
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(15)
    for N, K, pitch in ((200, 1000, 200), (130, 3001, 136),
                        (4096, 9216, 4096)):
        a = _randn(g, (M, K), dev, torch.bfloat16)
        b = _padded(g, K, N, pitch, dev, K ** -0.5)
        splits, kchunk = gemv_plan(M, N, K)
        ops.reset_launches()
        got = kmm.matmul_gemv_cuda(a, b)
        assert ops.LAUNCHES["matmul_gemv"] == 1 and got.shape == (M, N)
        _paper_close(got, kmm.matmul_gemv_plain(a, b), torch.bfloat16,
                     atol=1e-3)
        assert torch.equal(got, kmm.matmul_gemv_cuda(a, b))
        if M <= GEMV_MAX_M:
            assert kmm.matmul_route(a, b) == "matmul_gemv"
            assert torch.equal(got, ops.matmul(a, b))
            assert ops.LAUNCHES["matmul_gemv"] == 3
        else:
            assert kmm.matmul_route(a, b) != "matmul_gemv"
        if N == 200:
            assert splits > 1 and K % kchunk


@pytest.mark.parametrize("M", [1, 5, 40])
def test_ops_matmul_named_tile_below_64_rows_takes_wgmma(dev, M):
    """bf16 M < 64 with a tile named: the GEMV takes no tile, so
    ``ops.matmul`` honours it on the wgmma route (TMA zero-fills the rows
    past M), also at M 1, the GEMV's M, with one ``matmul`` launch a call
    and none of the GEMV; a tile the kernel is not built for raises."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(16)
    a = _randn(g, (M, 200), dev, torch.bfloat16)
    b = _padded(g, 200, 130, 136, dev, 200 ** -0.5)
    assert kmm.matmul_route(a, b) == ("matmul_gemv" if M == 1 else
                                      "matmul")
    assert kmm.matmul_route(a, b, tiled=True) == "matmul"
    want = kmm.matmul_plain(a, b, block_k=64)
    ops.reset_launches()
    for bm, bn in ((64, 64), (128, 256)):
        got = ops.matmul(a, b, block_m=bm, block_n=bn, block_k=64)
        assert got.dtype == torch.bfloat16 and got.shape == (M, 130)
        _paper_close(got, want, torch.bfloat16, atol=1e-3)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {"matmul": 2}
    with pytest.raises(ValueError, match="not one csrc/matmul.cu"):
        ops.matmul(a, b, block_m=32, block_n=32, block_k=64)
    assert ops.LAUNCHES["matmul_gemv"] == 0


def test_matmul_reads_a_row_strided_operand(dev):
    """A row-strided A whose base is not 16-byte aligned: ``ops.matmul``
    routes it to the CUDA-core kernel, which reads it in place."""
    from repro_torch.kernels import matmul as kmm
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(8)
    big = _randn(g, (100, 160), dev, torch.bfloat16)
    a = big[:, 10:90]                          # row stride 160, K 80
    b = _randn(g, (80, 96), dev, torch.bfloat16, 80 ** -0.5)
    assert kmm.matmul_route(a, b) == "matmul_simt"
    ops.reset_launches()
    got = ops.matmul(a, b)
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == {"matmul_simt": 1}
    _paper_close(got, kmm.matmul_plain(a.contiguous(), b, block_k=32),
                 torch.bfloat16, atol=1e-3)
    with pytest.raises(ValueError, match="16-byte row stride"):
        kmm.matmul_cuda(a, b, block_m=64, block_n=64, block_k=64)


CONV = [
    # (x shape, w shape, stride, dilation, block_oh, block_co, dtype)
    ((1, 31, 35, 3), (11, 11, 3, 48), 4, 1, 8, 48, torch.bfloat16),
    ((2, 20, 19, 40), (3, 3, 40, 125), 1, 1, 8, 128, torch.bfloat16),
    ((1, 23, 23, 64), (3, 3, 64, 27), 1, 4, 3, 27, torch.bfloat16),
    ((1, 17, 17, 33), (1, 7, 33, 64), 2, 2, 1, 16, torch.float32),
    ((1, 9, 70, 8), (1, 1, 8, 70), 1, 1, 64, 100, torch.float32),
]


@pytest.mark.parametrize("case", CONV, ids=lambda c: "-".join(map(str, c)))
def test_conv2d_kernel_matches_plain(dev, case):
    """The CUDA-core kernel (route ``conv2d_simt``): stride 4 with 11x11,
    CO 125 and 27 (ragged channel blocks), CI past one 32-channel chunk,
    dilation, odd block_oh, a 64-row tile."""
    from repro_torch.kernels import conv2d as kconv
    xs, ws, stride, dil, boh, bco, dt = case
    g = torch.Generator(device=dev).manual_seed(9)
    x = _randn(g, xs, dev, dt)
    w = _randn(g, ws, dev, dt, (ws[0] * ws[1] * ws[2]) ** -0.5)
    got = kconv.conv2d_simt_cuda(x, w, stride=stride, dilation=dil,
                                 block_oh=boh, block_co=bco)
    want = kconv.conv2d_plain(x, w, stride=stride, dilation=dil)
    assert got.shape == want.shape and got.dtype == dt
    _paper_close(got, want, dt, atol=1e-3)


CONV_WGMMA = [
    # (x shape, w shape, stride, dilation): the wgmma route's hard cases
    ((1, 63, 67, 3), (11, 11, 3, 48), 4, 1),    # CI 3 gathered, stride 4
    ((1, 20, 21, 3), (3, 3, 3, 16), 1, 1),      # CI 3, CO 16
    ((1, 34, 40, 16), (3, 3, 16, 32), 1, 1),    # CI 16: box past CI
    ((1, 31, 31, 48), (5, 5, 48, 128), 1, 1),   # CI 48: rows of next tap
    ((1, 22, 70, 32), (3, 3, 32, 27), 1, 1),    # CO 27 gathered, OW 68
    ((1, 13, 13, 256), (1, 1, 256, 125), 1, 1),  # CO 125, 13x13, split K
    ((1, 15, 15, 192), (3, 3, 192, 192), 1, 1),  # AL_CONV4: split K
    ((1, 30, 30, 64), (3, 3, 64, 64), 1, 4),    # dilation 4
    ((2, 33, 41, 64), (3, 3, 64, 128), 2, 1),   # stride 2 by TMA, N 2
    ((1, 40, 40, 16), (2, 2, 16, 64), 9, 1),    # stride 9: 16-byte gather
]


def _conv_inputs(dev, xs, ws, seed):
    g = torch.Generator(device=dev).manual_seed(seed)
    x = _randn(g, xs, dev, torch.bfloat16)
    w = _randn(g, ws, dev, torch.bfloat16, (ws[0] * ws[1] * ws[2]) ** -0.5)
    return x, w


@pytest.mark.parametrize("case", CONV_WGMMA,
                         ids=lambda c: "-".join(map(str, c)))
def test_conv2d_wgmma_matches_plain(dev, case):
    """The wgmma implicit GEMM (route ``conv2d``) through ``ops.conv2d``
    (the tile and K split of ``conv2d_plan``: one launch), then on every
    tile it is built for, unsplit and split into one K step a CTA."""
    from repro_torch.core.cuda_bridge import CONV_TILES, conv2d_k_steps
    from repro_torch.kernels import conv2d as kconv
    from repro_torch.kernels import ops
    xs, ws, stride, dil = case
    x, w = _conv_inputs(dev, xs, ws, 14)
    want = kconv.conv2d_plain(x, w, stride=stride, dilation=dil)
    ops.reset_launches()
    got = ops.conv2d(x, w, stride=stride, dilation=dil)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {"conv2d": 1}
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _paper_close(got, want, torch.bfloat16, atol=1e-3)
    for boh, bow, bco in sorted(CONV_TILES):
        steps = conv2d_k_steps(xs[3], ws[0], ws[1], stride=stride,
                               block_ow=bow)
        for splits in sorted({1, steps}):
            got = kconv.conv2d_cuda(x, w, stride=stride, dilation=dil,
                                    block_oh=boh, block_ow=bow,
                                    block_co=bco, splits=splits)
            _paper_close(got, want, torch.bfloat16, atol=1e-3)


def test_conv2d_wgmma_split_k_is_deterministic(dev):
    """Split K sums its f32 partials in split order, with no atomics: two
    runs give the same bits, and a split run stays within tolerance of the
    unsplit one."""
    from repro_torch.core.cuda_bridge import conv2d_plan
    from repro_torch.kernels import conv2d as kconv
    x, w = _conv_inputs(dev, (1, 15, 15, 256), (3, 3, 256, 512), 15)
    plan = conv2d_plan(1, 13, 13, 256, 512, 3, 3)
    assert plan.splits > 1
    tile = dict(block_oh=plan.block_oh, block_ow=plan.block_ow,
                block_co=plan.block_co)
    a = kconv.conv2d_cuda(x, w, **tile, splits=plan.splits)
    b = kconv.conv2d_cuda(x, w, **tile, splits=plan.splits)
    assert torch.equal(a, b)
    one = kconv.conv2d_cuda(x, w, **tile, splits=1)
    _paper_close(a, one, torch.bfloat16, atol=1e-3)


CORR = [
    # (H, W, C, radius, block_y, dtype)
    (48, 64, 256, 10, 8, torch.bfloat16),
    (26, 26, 64, 8, 8, torch.bfloat16),
    (10, 10, 40, 8, 3, torch.float32),
    (7, 45, 5, 0, 4, torch.float32),
    (5, 33, 16, 31, 8, torch.bfloat16),
]


@pytest.mark.parametrize("case", CORR, ids=lambda c: "-".join(map(str, c)))
def test_correlation_kernel_matches_plain(dev, case):
    """The CUDA-core kernel (route ``correlation_simt``): FLOWNET_CORR and
    EVA2_MATCH, ragged strips and channel chunks, radius 0 and the largest
    built (31) on a map narrower than D."""
    from repro_torch.kernels import correlation as kcorr
    H, W, C, R, by, dt = case
    g = torch.Generator(device=dev).manual_seed(10)
    i1, i2 = (_randn(g, (H, W, C), dev, dt, C ** -0.25) for _ in range(2))
    got = kcorr.correlation_simt_cuda(i1, i2, radius=R, block_y=by)
    want = kcorr.correlation_plain(i1, i2, radius=R)
    assert got.shape == (H, W, 2 * R + 1, 2 * R + 1)
    _paper_close(got, want, dt, atol=1e-3)


CORR_WGMMA = [
    # (H, W, C, radius): the wgmma route's cases
    (48, 64, 256, 10),   # FLOWNET_CORR
    (26, 26, 64, 8),     # EVA2_MATCH: one ragged 64-column tile
    (7, 45, 8, 0),       # radius 0 (N 64), W 45, C 8 (box past C)
    (5, 33, 16, 31),     # radius 31 (N 128) on a map narrower than D
    (9, 130, 72, 3),     # three column tiles, the last ragged; C 72
    (1, 20, 8, 2),       # one row: rows 1
    (6, 20, 1024, 4),    # channels in passes
]


@pytest.mark.parametrize("case", CORR_WGMMA,
                         ids=lambda c: "-".join(map(str, c)))
def test_correlation_wgmma_matches_plain(dev, case):
    """The wgmma kernel (route ``correlation``) through ``ops.correlation``
    (``correlation_plan``'s tiling: one launch), then at other plans: one
    row a CTA, all dy in one group, one dy a CTA, the widest band (N 128)
    and the shortest ring (3 stages)."""
    from repro_torch.core.cuda_bridge import SMEM_BUDGET, correlation_plan
    from repro_torch.kernels import correlation as kcorr
    from repro_torch.kernels import ops
    H, W, C, R = case
    g = torch.Generator(device=dev).manual_seed(17)
    i1, i2 = (_randn(g, (H, W, C), dev, torch.bfloat16, C ** -0.25)
              for _ in range(2))
    want = kcorr.correlation_plain(i1, i2, radius=R)
    assert kcorr.correlation_route(i1, i2, R) == "correlation"
    ops.reset_launches()
    got = ops.correlation(i1, i2, radius=R)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {"correlation": 1}
    assert got.shape == want.shape and got.dtype == torch.bfloat16
    _paper_close(got, want, torch.bfloat16, atol=1e-3)
    D = 2 * R + 1
    for kw in (dict(rows=1), dict(dy_group=D), dict(dy_group=1),
               dict(block_n=128), dict(stages=3)):
        try:
            other = correlation_plan(H, W, C, R, **kw)
        except ValueError:          # does not fit the budget
            continue
        assert other.smem <= SMEM_BUDGET
        got = kcorr.correlation_cuda(i1, i2, radius=R, plan=other)
        _paper_close(got, want, torch.bfloat16, atol=1e-3)


def test_correlation_wgmma_writes_zeros_into_poisoned_memory(dev):
    """A map whose first and last dy rows lie wholly outside the image (H 4
    at radius 6): those outputs are written as zeros.  The output is
    ``torch.empty``, so a same-size block is filled with NaN and freed
    first: the caching allocator hands that block to the kernel, and a
    skipped zero-write would leave NaN."""
    from repro_torch.kernels import correlation as kcorr
    H, W, C, R = 4, 40, 64, 6
    D = 2 * R + 1
    g = torch.Generator(device=dev).manual_seed(18)
    i1, i2 = (_randn(g, (H, W, C), dev, torch.bfloat16, C ** -0.25)
              for _ in range(2))
    want = kcorr.correlation_plain(i1, i2, radius=R)
    torch.cuda.synchronize()
    poison = torch.full((H, W, D, D), float("nan"), dtype=torch.bfloat16,
                        device=dev)
    ptr = poison.data_ptr()
    del poison
    got = kcorr.correlation_cuda(i1, i2, radius=R)
    assert got.data_ptr() == ptr          # the poisoned block, reused
    assert torch.isfinite(got).all()
    # the dy whose I2 rows lie above (dy < R - H + 1) or below (dy >= H + R)
    # the image for every output row
    for out_of_image in (got[:, :, :R - H + 1], got[:, :, H + R:]):
        assert out_of_image.numel() and not out_of_image.any()
    _paper_close(got, want, torch.bfloat16, atol=1e-3)


DECODE = [
    # (B, H, Hkv, S, D, lengths, dtype)
    (4, 32, 8, 2048, 128, [1783, 1592, 1480, 1264], torch.bfloat16),
    (3, 8, 2, 100, 64, [100, 33, 1], torch.bfloat16),
    (2, 16, 2, 70, 128, [0, 70], torch.float32),
    (2, 4, 4, 40, 16, [31, 32], torch.float32),
    (2, 6, 2, 50, 20, [50, 7], torch.bfloat16),   # D 20: scalar loads
]


@pytest.mark.parametrize("case", DECODE, ids=lambda c: "-".join(map(str, c)))
def test_flash_decode_kernel_matches_plain(dev, case):
    """The qwen3-4b decode shape, ragged splits, G 8, 3 and 1, a head_dim
    whose rows 16-byte loads cannot take, and a length of 0, where kernel
    and plain version both give 0."""
    from repro_torch.kernels import attention as katt
    B, H, Hkv, S, D, lens, dt = case
    g = torch.Generator(device=dev).manual_seed(11)
    q = _randn(g, (B, H, D), dev, dt)
    kc, vc = (_randn(g, (B, Hkv, S, D), dev, dt) for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    got = katt.flash_decode_cuda(q, kc, vc, ln)
    want = katt.flash_decode_plain(q, kc, vc, ln)
    _paper_close(got, want, dt, atol=1e-4)
    for b, n in enumerate(lens):
        if n == 0:
            assert torch.equal(got[b], torch.zeros_like(got[b]))


@pytest.mark.parametrize("G", [1, 2, 4, 8])
@pytest.mark.parametrize("D", [64, 128])
@pytest.mark.parametrize("block_k", [8, 32, 512])
def test_flash_decode_splits_match_plain(dev, G, D, block_k):
    """The split history at a block_k's edges: lengths 0, 1, block_k - 1,
    block_k, block_k + 1 and S over a ragged S, through ``ops`` (one
    launch), against the plain version at the same block_k."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    S, Hkv = 1100, 2
    lens = [0, 1, block_k - 1, block_k, block_k + 1, S]
    B = len(lens)
    g = torch.Generator(device=dev).manual_seed(16)
    q = _randn(g, (B, Hkv * G, D), dev, torch.bfloat16)
    kc, vc = (_randn(g, (B, Hkv, S, D), dev, torch.bfloat16)
              for _ in range(2))
    ln = torch.tensor(lens, dtype=torch.int32, device=dev)
    ops.reset_launches()
    got = ops.flash_decode(q, kc, vc, ln, block_k=block_k)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == \
        {"flash_decode": 1}
    want = katt.flash_decode_plain(q, kc, vc, ln, block_k=block_k)
    _paper_close(got, want, torch.bfloat16, atol=1e-4)
    assert torch.equal(got[0], torch.zeros_like(got[0]))


def test_flash_decode_reads_a_strided_cache_in_place(dev):
    """A (B, S, Hkv, D) cache seen as (B, Hkv, S, D) through a transpose."""
    from repro_torch.kernels import attention as katt
    g = torch.Generator(device=dev).manual_seed(12)
    q = _randn(g, (2, 8, 128), dev, torch.bfloat16)
    kc, vc = (_randn(g, (2, 300, 2, 128), dev, torch.bfloat16).transpose(1, 2)
              for _ in range(2))
    ln = torch.tensor([300, 77], dtype=torch.int32, device=dev)
    got = katt.flash_decode_cuda(q, kc, vc, ln)
    want = katt.flash_decode_plain(q, kc.contiguous(), vc.contiguous(), ln)
    _paper_close(got, want, torch.bfloat16, atol=1e-4)


def test_paper_wrappers_launch_count_and_refuse_unbuilt_tiles(dev):
    """Each ``ops`` wrapper launches its kernel once on the card (tiles from
    the tile search), and raises on a tile its kernel is not built for."""
    from repro_torch.kernels import ops
    g = torch.Generator(device=dev).manual_seed(13)
    a = _randn(g, (70, 90), dev, torch.bfloat16)
    x = _randn(g, (1, 12, 12, 8), dev, torch.bfloat16)
    w = _randn(g, (3, 3, 8, 16), dev, torch.bfloat16)
    i = _randn(g, (9, 9, 8), dev, torch.bfloat16)
    q = _randn(g, (1, 4, 64), dev, torch.bfloat16)
    kc = _randn(g, (1, 2, 40, 64), dev, torch.bfloat16)
    ln = torch.tensor([30], dtype=torch.int32, device=dev)
    a8 = _randn(g, (96, 64), dev, torch.bfloat16)     # 16-byte rows
    ops.reset_launches()
    ops.matmul(a, a.t().contiguous())        # B's rows are 140 bytes
    ops.matmul(a8, a8.t().contiguous())      # M 96: wgmma
    ops.matmul(a8[:1], a8.t().contiguous())  # M 1: the GEMV
    ops.conv2d(x, w)                         # bf16: wgmma
    ops.conv2d(x.float(), w.float())         # f32: CUDA cores
    ops.correlation(i, i, radius=2)          # bf16, C 8: wgmma
    ops.correlation(i.float(), i.float(), radius=2)   # f32: CUDA cores
    ops.flash_decode(q, kc, kc, ln)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "matmul_simt": 1, "matmul": 1, "matmul_gemv": 1, "conv2d": 1,
        "conv2d_simt": 1, "correlation": 1, "correlation_simt": 1,
        "flash_decode": 1}
    with pytest.raises(ValueError, match="not one csrc/matmul.cu"):
        ops.matmul(a, a.t().contiguous(), block_m=32, block_n=32, block_k=64)
    with pytest.raises(ValueError, match="not one csrc/matmul.cu"):
        ops.matmul(a8, a8.t().contiguous(), block_m=64, block_n=64,
                   block_k=32)
    with pytest.raises(ValueError, match="not ones csrc/conv2d.cu"):
        ops.conv2d(x, _randn(g, (3, 3, 8, 200), dev, torch.bfloat16),
                   block_co=200)
    with pytest.raises(ValueError, match="route conv2d "):
        ops.conv2d(x, w, block_oh=3)
    assert ops.LAUNCHES["matmul_simt"] == ops.LAUNCHES["conv2d"] == \
        ops.LAUNCHES["matmul"] == ops.LAUNCHES["conv2d_simt"] == 1


# ---------------------------------------------------------------------------
# checkpoints and the recovery loop on the card
# ---------------------------------------------------------------------------

def _card_state(dev, scale=1):
    """A train state of the card's kind: bf16 params, f32 moments beside
    them on the card, the int32 step on the host."""
    from repro_torch.optim.adamw import tree_map
    g = torch.Generator(device=dev).manual_seed(scale)
    params = {"embed": torch.randn(512 * scale, 256, generator=g,
                                   device=dev).bfloat16(),
              "layers": {"wq": torch.randn(2, 256, 256 * scale, generator=g,
                                           device=dev).bfloat16(),
                         "ln1": torch.randn(2, 256, generator=g,
                                            device=dev).bfloat16()}}
    return {"params": params,
            "opt": {"mu": tree_map(lambda t: torch.randn(
                        t.shape, generator=g, device=dev), params),
                    "nu": tree_map(lambda t: torch.rand(
                        t.shape, generator=g, device=dev), params),
                    "step": torch.tensor(5, dtype=torch.int32)}}


def _same_bits(a, b):
    from repro_torch.checkpoint.manager import flatten_with_paths
    fa, fb = flatten_with_paths(a), flatten_with_paths(b)
    return len(fa) == len(fb) and all(
        pa == pb and x.dtype == y.dtype and x.device == y.device
        and torch.equal(x.view(torch.int16) if x.dtype == torch.bfloat16
                        else x, y.view(torch.int16)
                        if y.dtype == torch.bfloat16 else y)
        for (pa, x), (pb, y) in zip(fa, fb))


def test_checkpoint_round_trips_a_bf16_card_state(dev, tmp_path):
    from repro_torch.checkpoint import restore_checkpoint, save_checkpoint
    from repro_torch.optim.adamw import tree_map
    from repro_torch.runtime import tree_fingerprint
    state = _card_state(dev)
    save_checkpoint(str(tmp_path), 3, state)
    like = tree_map(torch.zeros_like, state)
    assert restore_checkpoint(str(tmp_path), 3, like) is like
    assert like["params"]["embed"].is_cuda and _same_bits(like, state)
    assert tree_fingerprint(like) == tree_fingerprint(state)


def test_in_place_update_after_save_async_does_not_reach_the_file(
        dev, tmp_path):
    """The train step's in-place updates are queued on the card right
    after ``save_async`` returns: the file holds the state at the save."""
    from repro_torch.checkpoint import CheckpointManager, restore_checkpoint
    from repro_torch.optim.adamw import tree_leaves, tree_map
    state = _card_state(dev)
    want = tree_map(torch.clone, state)
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(2, state)
    for t in tree_leaves(state):
        t.add_(1)
    mgr.wait()
    got = restore_checkpoint(str(tmp_path), 2, tree_map(torch.zeros_like,
                                                        state))
    assert _same_bits(got, want) and not _same_bits(got, state)


def test_restore_copies_into_the_existing_cuda_tensors(dev, tmp_path):
    """Restore writes each leaf into the tensor already on the card: the
    tensors keep their storage and the card's peak memory does not grow
    by the state's size (here ~84 MB)."""
    from repro_torch.checkpoint import CheckpointManager
    from repro_torch.checkpoint.manager import flatten_with_paths
    from repro_torch.optim.adamw import tree_leaves, tree_map
    state = _card_state(dev, scale=32)
    nbytes = sum(t.numel() * t.element_size() for t in tree_leaves(state))
    mgr = CheckpointManager(str(tmp_path))
    mgr.save_async(4, state)
    mgr.wait()
    like = tree_map(torch.zeros_like, state)
    ptrs = [t.data_ptr() for _, t in flatten_with_paths(like)]
    torch.cuda.synchronize()
    before = torch.cuda.memory_allocated()
    torch.cuda.reset_peak_memory_stats()
    step, out = mgr.restore(like)
    torch.cuda.synchronize()
    grew = torch.cuda.max_memory_allocated() - before
    assert step == 4 and out is like and _same_bits(like, state)
    assert [t.data_ptr() for _, t in flatten_with_paths(like)] == ptrs
    assert grew < nbytes // 8, (grew, nbytes)


def test_kill_restart_resumes_bitwise_on_the_card(dev, tmp_path,
                                                  monkeypatch):
    """A small bf16 config through the wgmma flash kernels (2 layers, d
    256, 4/2 heads, head_dim 64, S 256): 6 steps uninterrupted against a
    run killed entering step 3 (after the step-2 save) and restarted; the
    losses from step 2 on and the final states are equal bit for bit."""
    from repro_torch.configs.base import ArchBundle
    from repro_torch.kernels import ops
    from repro_torch.launch import train
    from repro_torch.models import TransformerConfig, transformer
    from repro_torch.runtime import ChaosKilled, tree_fingerprint
    cfg = TransformerConfig(name="card-train", n_layers=2, d_model=256,
                            n_heads=4, n_kv_heads=2, d_ff=512, vocab=512,
                            head_dim=64, qk_norm=True, attn_impl="pallas")
    monkeypatch.setattr(train, "get_bundle", lambda arch, smoke: ArchBundle(
        arch, "dense", cfg, transformer))
    kw = dict(seq_len=256, global_batch=2, log_every=100, device="cuda")
    ops.reset_launches()
    full = train.run("card-train", steps=6, chaos=["nan@1"], **kw)
    assert ops.LAUNCHES["flash_bwd_dq"] == 6 * cfg.n_layers
    with pytest.raises(ChaosKilled):
        train.run("card-train", steps=6, ckpt_dir=str(tmp_path),
                  ckpt_every=2, chaos=["nan@1", "kill@3"], **kw)
    resumed = train.run("card-train", steps=4, ckpt_dir=str(tmp_path),
                        ckpt_every=2, **kw)
    assert resumed["steps"] == [2, 3, 4, 5]
    assert resumed["losses"] == full["losses"][2:]
    assert tree_fingerprint({"params": resumed["params"],
                             "opt": resumed["opt"]}) == \
        tree_fingerprint({"params": full["params"], "opt": full["opt"]})


# ring attention on a (1, 4) local ring of the card, fused (the flash
# kernels each hop at the shard's offsets): (B, S, H, Hkv, D, window),
# causal; the last is recurrentgemma-9b's MQA at head_dim 256
RING = [
    (1, 1024, 8, 2, 128, None),
    (2, 512, 4, 4, 64, 200),
    (1, 1024, 16, 1, 256, 300),
]


@pytest.mark.parametrize("case", RING, ids=lambda c: "-".join(map(str, c)))
def test_ring_attention_fused_matches_unsharded_flash(dev, case):
    """``chip_smoke.check_ring_attention`` at small shapes: o against the
    unsharded flash forward by the element bound, the f32 dq / dk / dv
    against the unsharded backward kernels by the rounded bound, m x m
    launches of each kernel a call, and a wholly masked hop (rank 0 with
    rank 1's keys) writing o = 0, lse = -1e30 and zero grads into
    NaN-poisoned memory."""
    B, S, H, Hkv, D, window = case
    flush = torch.empty(16 * 2 ** 20, dtype=torch.float32, device=dev)
    row = _chip_smoke().check_ring_attention(
        flush, "card-test", dict(B=B, S=S, H=H, Hkv=Hkv, D=D, window=window))
    assert all(row["masked_hop"].values())
    assert all(row[f"{n}_close"]["within_tol"] for n in ("o", "dq", "dk",
                                                         "dv"))


def test_attention_under_a_mesh_keeps_the_flash_kernels(dev, monkeypatch):
    """``chip_smoke.check_mesh_routes`` at small heads: under a (1, 4)
    local mesh, attention() at S 2,048 launches the unsharded flash kernels
    once each, at S 3,072 once a q shard (the replicated mode), at S 4,096
    m x m times (the ring), each against the call with no mesh."""
    for name in ("REPRO_FLASH_ATTN", "REPRO_RING_ATTN",
                 "REPRO_RING_ATTN_THRESHOLD", "REPRO_RING_ATTN_MAX_SHARD"):
        monkeypatch.delenv(name, raising=False)
    rows = _chip_smoke().check_mesh_routes(
        "card-test", dict(B=1, H=8, Hkv=2, D=128, window=None))
    assert [r["path"] for r in rows.values()] == ["flash", "replicated",
                                                  "ring"]
    assert all(r["launches"] == r["want"] for r in rows.values())
