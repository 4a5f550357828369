"""The port's CUDA kernels against their plain PyTorch versions on the
card, over the shapes and options the serving and training runs do not
reach: ragged lengths, sliding windows, non-causal masks, GQA groups,
head_dim 64 and 16, f32 and int8, the engine's smoke config on the card,
and one train step of a small config on the card against the CPU.  Every
test needs an sm_90 card and skips elsewhere; run them there with

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

Tolerances: a bf16 output element may differ by one bf16 ulp of its value
(f32 sums in another order, then rounded) plus an absolute term: 2e-3 for
flash forward, whose p is rounded to bf16 before PV, 1e-4 for paged decode,
which keeps p in f32; each row's relative L2 error stays under 2^-6.  f32
outputs may differ by 1e-4.  The backward kernels' outputs are f32 sums in
another order than the plain version's: each element within
2^-10 |want| + 1e-5 max|want|, each row's relative L2 error under 2^-10."""
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
    (1, 64, 64, 4, 2, 64, True, 3, torch.float32),
    (1, 257, 257, 16, 4, 128, True, None, torch.float32),
]


@pytest.mark.parametrize("case", FLASH, ids=lambda c: "-".join(map(str, c)))
def test_flash_kernel_matches_plain(dev, case):
    from repro_torch.kernels import attention as katt
    B, S, Sk, H, Hkv, D, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(0)
    q = torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
    k = torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
    v = torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
    qt, kt, vt = q.transpose(1, 2), k.transpose(1, 2), v.transpose(1, 2)
    o, lse = katt.flash_attention_fwd_cuda(qt, kt, vt, causal=causal,
                                           window=window)
    o_ref, lse_ref = katt.flash_attention_fwd_plain(
        qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
        vt.reshape(B * Hkv, Sk, D), causal=causal, window=window)
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


# the forward's cases, and non-causal with a window past the keys: q rows
# from 163 on see no key, so their lse is -1e30 and their dq must be 0
FLASH_BWD = FLASH + [(1, 256, 64, 4, 2, 64, False, 100, torch.float32)]


@pytest.mark.parametrize("case", FLASH_BWD,
                         ids=lambda c: "-".join(map(str, c)))
def test_flash_bwd_kernels_match_plain(dev, case):
    from repro_torch.kernels import attention as katt
    B, S, Sk, H, Hkv, D, causal, window, dt = case
    g = torch.Generator(device=dev).manual_seed(3)
    q, do = (torch.randn((B, S, H, D), generator=g, device=dev).to(dt)
             for _ in range(2))
    k, v = (torch.randn((B, Sk, Hkv, D), generator=g, device=dev).to(dt)
            for _ in range(2))
    qt, kt, vt, dot = (x.transpose(1, 2) for x in (q, k, v, do))
    flat = (qt.reshape(B * H, S, D), kt.reshape(B * Hkv, Sk, D),
            vt.reshape(B * Hkv, Sk, D))
    kw = dict(causal=causal, window=window)
    o, lse = katt.flash_attention_fwd_plain(*flat, **kw)
    delta = (o.float() * dot.reshape(B * H, S, D).float()).sum(-1)
    got = katt.flash_attention_bwd_cuda(qt, kt, vt, dot, lse, delta, **kw)
    want = katt.flash_attention_bwd_plain(*flat, dot.reshape(B * H, S, D),
                                          lse, delta, **kw)
    assert got[0].stride() == qt.stride() and got[1].stride() == kt.stride()
    for x, w in zip(got, want):
        assert x.dtype == torch.float32
        _bwd_close(x.reshape(w.shape), w)
    if not causal and window is not None:
        dead = (lse == -1e30)
        assert dead.any() and (got[0].reshape(want[0].shape)[dead] == 0).all()


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
