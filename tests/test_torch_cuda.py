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
(``flash_bwd_simt``: f32, unaligned views) nothing is rounded: each
element within 2^-10 |want| + 1e-5 max|want|, each row's relative L2 error
under 2^-10.  The wgmma route (``flash_bwd``) rounds p and ds to bf16
before their second products, and so does the plain version it is held
against; the two form p and ds in f32 in other orders (and with exp2 in
the kernel), so where a value lies at a bf16 rounding boundary one of them
rounds up and the other down: that term of a sum moves by one bf16 ulp, at
most 2^-7 of itself.  Flips are rare (the f32 values differ by ~1e-6
relative, an ulp is 2^-8) and unbiased, so the whole tensor's relative L2
error stays under 2^-10; but a row dominated by one term (the last keys of
a causal dk / dv see one q row per head) can move by 2^-7 of its norm.
So: each element within 2^-7 (|want| + the RMS of its row), each row's
L2 error under 2^-7 of its norm, the tensor's under 2^-10, and each with
an absolute floor of 1e-5 max|want| (per element; times sqrt(D) a row)
for rows that cancel to 0 (a causal first q row, whose ds is
p (dp - delta) with delta = dp in exact arithmetic).
The paper-workload kernels' inputs are scaled to unit-variance outputs;
their f32 sums run in another order than the plain version's (atol 1e-3
in bf16, 1e-4 in f32; decode 1e-4 as paged decode)."""
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


def _bwd_close(got, want):
    diff = (got - want).abs()
    tol = 2.0 ** -10 * want.abs() + 1e-5 * want.abs().max()
    row_rel = diff.norm(dim=-1) / want.norm(dim=-1).clamp_min(1e-30)
    assert row_rel.max().item() <= 2.0 ** -10, \
        f"max row rel L2 err {row_rel.max().item()}"
    assert not (diff > tol).any(), f"max err {diff.max().item()}"


def _bwd_close_rounded(got, want):
    """The wgmma route against its rounded plain version (module
    docstring)."""
    diff = (got - want).abs()
    atol = 1e-5 * want.abs().max()
    rms = want.pow(2).mean(-1, keepdim=True).sqrt()
    rel = (diff.norm() / want.norm().clamp_min(1e-30)).item()
    assert rel <= 2.0 ** -10, f"tensor rel L2 err {rel}"
    row_excess = diff.norm(dim=-1) - (2.0 ** -7 * want.norm(dim=-1) +
                                      atol * want.shape[-1] ** 0.5)
    assert row_excess.max().item() <= 0, \
        f"row L2 err over its bound by {row_excess.max().item()}"
    bad = diff > 2.0 ** -7 * (want.abs() + rms) + atol
    assert not bad.any(), f"max err {diff.max().item()}"


# the forward's cases; head_dim 64 at GQA groups 1, 4 and 8; and
# non-causal with a window past the keys: q rows from 163 on see no key,
# so their lse is -1e30 and their dq must be 0
FLASH_BWD = FLASH + [
    (1, 512, 512, 8, 8, 64, True, None, torch.bfloat16),
    (2, 384, 384, 16, 4, 64, True, 200, torch.bfloat16),
    (1, 300, 300, 16, 2, 64, False, None, torch.bfloat16),
    (1, 256, 64, 8, 1, 64, False, 100, torch.bfloat16),
    (1, 256, 64, 4, 2, 64, False, 100, torch.float32),
]


def _bwd_inputs(dev, case, seed=3):
    B, S, Sk, H, Hkv, D, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(seed)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    return tuple(x.transpose(1, 2) for x in (q, k, v, do))


def _bwd_check(qt, kt, vt, dot, causal, window, route):
    """The backward kernels fed the forward kernel's own o and lse, as
    ``FlashAttention`` feeds them, against the plain backward on the same
    residuals at the route's blocks and rounding."""
    from repro_torch.kernels import attention as katt
    from repro_torch.kernels import ops
    B, H, S, D = qt.shape
    Hkv, Sk = kt.shape[1], kt.shape[2]
    assert katt.flash_bwd_route(qt, kt, vt, dot) == route
    kw = dict(causal=causal, window=window)
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, **kw)
    o = o.reshape(B * H, S, D)
    delta = (o.float() * dot.reshape(B * H, S, D).float()).sum(-1)
    ops.reset_launches()
    got = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse, delta, **kw)
    keys = ("flash_bwd_dq", "flash_bwd_dkv") if route == "flash_bwd" else \
        ("flash_bwd_dq_simt", "flash_bwd_dkv_simt")
    assert {n: c for n, c in ops.LAUNCHES.items() if c} == \
        dict.fromkeys(keys, 1)
    want = katt.flash_attention_bwd_plain(
        qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
        vt.reshape(B * Hkv, Sk, D), dot.reshape(B * H, S, D), lse, delta,
        **kw, **katt.flash_bwd_plain_kw(route))
    # written in q's and k's memory layouts (dense views: their own strides)
    assert got[0].stride() == torch.empty_like(qt).stride()
    assert got[1].stride() == torch.empty_like(kt).stride()
    close = _bwd_close_rounded if route == "flash_bwd" else _bwd_close
    for x, w in zip(got, want):
        assert x.dtype == torch.float32 and torch.isfinite(x).all()
        close(x.reshape(w.shape), w)
    if not causal and window is not None and S > Sk - 1 + window:
        dead = (lse == -1e30)        # q rows that see no key: dq is 0
        assert dead.any() and (got[0].reshape(want[0].shape)[dead] == 0).all()
    return got


@pytest.mark.parametrize("case", FLASH_BWD,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernels_match_plain(dev, case):
    """bf16 takes the wgmma pair (held against the rounded plain version at
    its blocks), f32 the CUDA-core pair (the unrounded one at 64 x 64)."""
    route = "flash_bwd" if case[-1] == torch.bfloat16 else "flash_bwd_simt"
    _bwd_check(*_bwd_inputs(dev, case), case[6], case[7], route)


@pytest.mark.parametrize("case", [
    (1, 200, 200, 8, 2, 128, True, None),
    (2, 130, 190, 4, 1, 64, False, 50)], ids=lambda c: "-".join(map(str, c)))
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


PAGED = [
    # (B, H, Hkv, D, page, max_pages, form)
    (4, 32, 8, 128, 16, 128, "bf16"),
    (4, 32, 8, 128, 16, 128, "int8"),
    (3, 16, 2, 64, 32, 9, "bf16"),
    (5, 8, 8, 128, 8, 7, "f32"),
    (2, 4, 2, 16, 16, 4, "f32"),
    (2, 4, 2, 16, 16, 4, "int8"),
]


@pytest.mark.parametrize("case", PAGED, ids=lambda c: "-".join(map(str, c)))
def test_paged_kernel_matches_plain(dev, case):
    from repro_torch.kernels import paged_attention as kpa
    from repro_torch.models.layers import quantize_kv
    B, H, Hkv, D, page, MP, form = case
    P = B * MP + 1
    g = torch.Generator(device="cpu").manual_seed(1)
    lens = torch.randint(1, MP * page + 1, (B,), generator=g)
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
    args = (q, k, v, table.to(dev), lens.to(dev, torch.int32), ks, vs)
    _ulp_close(kpa.paged_flash_decode_cuda(*args),
               kpa.paged_flash_decode_plain(*args), qdt, atol=1e-4)


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
    """Stride 4 with 11x11, CO 125 and 27 (ragged channel blocks), CI past
    one 32-channel chunk, dilation, odd block_oh, a 64-row tile."""
    from repro_torch.kernels import conv2d as kconv
    xs, ws, stride, dil, boh, bco, dt = case
    g = torch.Generator(device=dev).manual_seed(9)
    x = _randn(g, xs, dev, dt)
    w = _randn(g, ws, dev, dt, (ws[0] * ws[1] * ws[2]) ** -0.5)
    got = kconv.conv2d_cuda(x, w, stride=stride, dilation=dil, block_oh=boh,
                            block_co=bco)
    want = kconv.conv2d_plain(x, w, stride=stride, dilation=dil)
    assert got.shape == want.shape and got.dtype == dt
    _paper_close(got, want, dt, atol=1e-3)


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
    """FLOWNET_CORR and EVA2_MATCH, ragged strips and channel chunks,
    radius 0 and the largest built (31) on a map narrower than D."""
    from repro_torch.kernels import correlation as kcorr
    H, W, C, R, by, dt = case
    g = torch.Generator(device=dev).manual_seed(10)
    i1, i2 = (_randn(g, (H, W, C), dev, dt, C ** -0.25) for _ in range(2))
    got = kcorr.correlation_cuda(i1, i2, radius=R, block_y=by)
    want = kcorr.correlation_plain(i1, i2, radius=R)
    assert got.shape == (H, W, 2 * R + 1, 2 * R + 1)
    _paper_close(got, want, dt, atol=1e-3)


DECODE = [
    # (B, H, Hkv, S, D, lengths, dtype)
    (4, 32, 8, 2048, 128, [1783, 1592, 1480, 1264], torch.bfloat16),
    (3, 8, 2, 100, 64, [100, 33, 1], torch.bfloat16),
    (2, 16, 2, 70, 128, [0, 70], torch.float32),
    (2, 4, 4, 40, 16, [31, 32], torch.float32),
]


@pytest.mark.parametrize("case", DECODE, ids=lambda c: "-".join(map(str, c)))
def test_flash_decode_kernel_matches_plain(dev, case):
    """The qwen3-4b decode shape, ragged 32-token steps, G 8 and 1, and a
    length of 0, where kernel and plain version both give 0."""
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
    ops.conv2d(x, w)
    ops.correlation(i, i, radius=2)
    ops.flash_decode(q, kc, kc, ln)
    assert {k: n for k, n in ops.LAUNCHES.items() if n} == {
        "matmul_simt": 1, "matmul": 1, "matmul_gemv": 1, "conv2d": 1,
        "correlation": 1, "flash_decode": 1}
    with pytest.raises(ValueError, match="not one csrc/matmul.cu"):
        ops.matmul(a, a.t().contiguous(), block_m=32, block_n=32, block_k=64)
    with pytest.raises(ValueError, match="not one csrc/matmul.cu"):
        ops.matmul(a8, a8.t().contiguous(), block_m=64, block_n=64,
                   block_k=32)
    with pytest.raises(ValueError, match="not ones csrc/conv2d.cu"):
        ops.conv2d(x, _randn(g, (3, 3, 8, 200), dev, torch.bfloat16),
                   block_co=200)
    assert ops.LAUNCHES["matmul_simt"] == ops.LAUNCHES["conv2d"] == \
        ops.LAUNCHES["matmul"] == 1
