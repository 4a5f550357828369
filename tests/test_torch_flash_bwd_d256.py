"""The head_dim-256 wgmma backward (route ``flash_bwd_d256``) and the
rounded routes' tolerance, on the CPU.

* The route's plain version (dq at 128 x 32 blocks, dk/dv at 64 x 64, p
  and ds rounded to bf16 before their second products) on bf16-exact
  inputs against the reference's Pallas backward in interpret mode (f32)
  at the same blocks: recurrentgemma's 16 / 1 heads and 4 / 1, a window,
  ragged lengths, Sq != Sk and nonzero offsets, within 2^-8 of the sum of
  each element's term magnitudes plus 1e-5 (as the D-128 route's test in
  ``test_torch_routes.py``); unrounded, within 1e-5.
* ``flash_bwd_dkv_plan``: the dk/dv split of each GQA group's heads, and
  ``parts`` refused where it does not apply.
* ``flash_bwd_term_max`` against brute force, and
  ``chip_smoke.closeness_rounded`` (the card's check of both wgmma routes)
  accepting a result summed in another order while rejecting a dq with
  one key block of its band left out and a dk whose ds used a shifted
  delta, each by its per-element bound alone too."""
import functools
import importlib.util
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as ref_att  # noqa: E402
from repro_torch.core.cuda_bridge import SM_COUNT  # noqa: E402
from repro_torch.kernels import attention as pt_att  # noqa: E402

BF16 = torch.bfloat16
ROUTE = "flash_bwd_d256"


@functools.lru_cache(maxsize=None)
def _chip_smoke():
    root = Path(__file__).resolve().parents[1]
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  root / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod

# (BH, BHkv, Sq, Sk, causal, window, q_len, kv_len, q_offset, k_offset):
# Sq / Sk whole blocks for the reference, q_len / kv_len the valid rows
CASES = {
    # recurrentgemma's 16 / 1 heads, window, ragged q rows and keys
    "mqa16_window_ragged": (16, 1, 256, 256, True, 100, 200, 230, 0, 0),
    # 4 / 1 heads, Sq != Sk: 128 q rows at the end of 256 keys
    "mqa4_sq_ne_sk": (4, 1, 128, 256, True, 150, 128, 250, 128, 0),
    # q ahead of k by 100 inside a window of 64, non-square, ragged keys
    "mqa4_offsets": (4, 1, 256, 192, True, 64, 256, 180, 300, 200),
}


def _bf16_values(rng, *shape):
    """Normal f32 values that bf16 holds exactly."""
    x = torch.from_numpy(rng.normal(size=shape).astype(np.float32))
    return x.to(BF16).float().numpy()


def _kw(case):
    _, _, _, _, causal, window, q_len, kv_len, qo, ko = CASES[case]
    return dict(causal=causal, window=window, q_len=q_len, kv_len=kv_len,
                q_offset=qo, k_offset=ko)


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """Inputs, residuals (the plain forward's lse, delta) and the
    reference's Pallas backward (interpret mode, f32): dq at the route's
    128 x 32 blocks, dk / dv at its 64 x 64."""
    BH, BHkv, Sq, Sk = CASES[case][:4]
    rng = np.random.default_rng(sorted(CASES).index(case) + 256)
    q, do = _bf16_values(rng, BH, Sq, 256), _bf16_values(rng, BH, Sq, 256)
    k, v = _bf16_values(rng, BHkv, Sk, 256), _bf16_values(rng, BHkv, Sk, 256)
    kw = _kw(case)
    o, lse = pt_att.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), block_q=128, block_k=64, **kw)
    lse = lse.numpy()
    delta = (o.numpy() * do).sum(-1)
    args = tuple(map(jnp.asarray, (q, k, v, do, lse, delta)))
    bq, bk = pt_att.WGMMA_D256_BWD_DQ_BLOCKS
    dq = ref_att.flash_attention_bwd_pallas(
        *args, block_q=bq, block_k=bk, interpret=True, **kw)[0]
    bq, bk = pt_att.WGMMA_D256_BWD_DKV_BLOCKS
    _, dk, dv = ref_att.flash_attention_bwd_pallas(
        *args, block_q=bq, block_k=bk, interpret=True, **kw)
    return (q, k, v, do, lse, delta), tuple(np.asarray(x)
                                            for x in (dq, dk, dv))


def _cut(case, dq, dk, dv):
    """The rows the reference defines: q rows below q_len, keys below
    kv_len."""
    q_len, kv_len = CASES[case][6:8]
    return dq[:, :q_len], dk[:, :kv_len], dv[:, :kv_len]


def _abs_products(case, inputs):
    """sum |ds| |k| (dq), sum |ds| |q| (dk) and sum |p| |do| (dv) over
    every unmasked pair, the GQA group folded, in f32 numpy (q rows past
    q_len hold data and attend, as in the kernels' masks)."""
    q, k, v, do, lse, delta = inputs
    BH, BHkv, Sq, Sk, causal, window, _, kv_len, qo, ko = CASES[case]
    g = BH // BHkv
    kr, vr = np.repeat(k, g, axis=0), np.repeat(v, g, axis=0)
    qpos, kpos = qo + np.arange(Sq)[:, None], ko + np.arange(Sk)[None, :]
    mask = np.arange(Sk)[None, :] < kv_len
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & (qpos - kpos < window)
    s = np.einsum("hqd,hkd->hqk", q, kr) / 16.0
    p = np.where(mask, np.exp(np.minimum(s - lse[..., None], 0.0)), 0.0)
    dp = np.einsum("hqd,hkd->hqk", do, vr)
    ds = np.abs(p * (dp - delta[..., None]) / 16.0)
    fold = lambda a: a.reshape(BHkv, g, *a.shape[1:]).sum(1)  # noqa: E731
    return (np.einsum("hqk,hkd->hqd", ds, np.abs(kr)),
            fold(np.einsum("hqk,hqd->hkd", ds, np.abs(q))),
            fold(np.einsum("hqk,hqd->hkd", p, np.abs(do))))


@pytest.mark.parametrize("case", sorted(CASES))
def test_d256_plain_matches_pallas(case):
    """The route's plain version, unrounded on f32 inputs, against the
    Pallas backward at the same blocks within 1e-5 (sums in another
    order); rounded on bf16 inputs, each element within 2^-8 of the sum
    of its terms' magnitudes plus 1e-5, and the rounding shows."""
    inputs, want = _reference(case)
    t = [torch.from_numpy(x) for x in inputs]
    kw = dict(_kw(case), **pt_att.flash_bwd_plain_kw(ROUTE))
    assert kw["rounded"]
    f32 = pt_att.flash_attention_bwd_plain(*t, **dict(kw, rounded=False))
    for g, w in zip(_cut(case, *f32), _cut(case, *want)):
        np.testing.assert_allclose(g.numpy(), w, atol=1e-5)
    got = pt_att.flash_attention_bwd_plain(
        *[x.to(BF16) for x in t[:4]], *t[4:], **kw)
    bounds = _cut(case, *_abs_products(case, inputs))
    moved = False
    for g, w, b in zip(_cut(case, *got), _cut(case, *want), bounds):
        assert g.dtype == torch.float32
        err = np.abs(g.numpy() - w)
        assert (err <= 2.0 ** -8 * b + 1e-5).all(), \
            (err - 2.0 ** -8 * b).max()
        moved |= bool((err > 1e-5).any())
    assert moved


@pytest.mark.parametrize("B,Hkv,G,Sk,want", [
    (1, 1, 16, 4096, 8),     # recurrentgemma-9b: 64 key blocks -> 512 CTAs
    (1, 1, 16, 1100, 16),    # 18 key blocks -> 288 CTAs
    (2, 1, 16, 4096, 4),     # 128 key blocks -> 512 CTAs
    (1, 1, 4, 300, 4),       # 5 key blocks: no divisor fills, G parts
    (2, 8, 2, 4096, 1),      # 1,024 key blocks: no split
    (1, 2, 6, 2048, 6),      # 64 key blocks: 3 is short, 6 fills
    (1, 4, 6, 2048, 3),      # 128 key blocks: 2 is short, 3 fills
])
def test_dkv_plan_fills_two_waves(B, Hkv, G, Sk, want):
    """The fewest parts, a divisor of the group, whose CTAs give two to
    each of the card's 132 SMs; the group's size where none does.  One
    CTA a (part, kv head, 64-key block); f32 dk and dv partials of every
    part beyond one."""
    plan = pt_att.flash_bwd_dkv_plan(B, Hkv, G, Sk)
    assert plan.parts == want and G % want == 0
    blocks = B * Hkv * -(-Sk // 64)
    assert plan.ctas == blocks * want
    assert plan.ctas >= 2 * SM_COUNT or want == G
    assert all(pt_att.flash_bwd_dkv_plan(B, Hkv, G, Sk, p).ctas <
               2 * SM_COUNT for p in range(1, want) if G % p == 0)
    assert plan.scratch_bytes == (2 * want * B * Hkv * Sk * 256 * 4
                                  if want > 1 else 0)


def test_dkv_parts_must_divide_the_group_and_take_the_d256_route():
    """A split that does not divide the group, or one asked of a route
    that has none (the CUDA-core pair, f32 here), raises."""
    assert pt_att.flash_bwd_dkv_plan(1, 1, 16, 4096, 2) == \
        (2, 128, (2, 2, 1, 4096, 256))
    for parts in (0, 3):
        with pytest.raises(ValueError, match="does not divide"):
            pt_att.flash_bwd_dkv_plan(1, 1, 16, 4096, parts)
    q, do = torch.zeros(2, 1, 16, 64, 256).unbind(0)
    k, v = torch.zeros(2, 1, 1, 64, 256).unbind(0)
    lse, delta = torch.zeros(2, 16, 64).unbind(0)
    assert pt_att.flash_bwd_route(q, k, v, do) == "flash_bwd_simt"
    with pytest.raises(ValueError, match="flash_bwd_d256 only"):
        pt_att.flash_bwd_dkv_cuda(q, k, v, do, lse, delta, parts=2)


def _bf16_case(seed, BH=16, Sq=256, Sk=256, window=100):
    """bf16 q, k, v, do (16 / 1 heads, head_dim 256) and the plain
    forward's lse and delta."""
    rng = np.random.default_rng(seed)
    q, do = (torch.from_numpy(rng.normal(size=(BH, Sq, 256))
                              .astype(np.float32)).to(BF16)
             for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(1, Sk, 256))
                             .astype(np.float32)).to(BF16)
            for _ in range(2))
    o, lse = pt_att.flash_attention_fwd_plain(q, k, v, window=window,
                                              block_q=128, block_k=64)
    delta = (o.float() * do.float()).sum(-1)
    return (q, k, v, do, lse, delta), dict(causal=True, window=window)


def test_term_max_is_the_largest_rounded_term():
    """``flash_bwd_term_max`` equals the brute-force maximum over every
    term of each element's sum, from the rounded p and ds."""
    args, band = _bf16_case(3, BH=4, Sq=200, Sk=200)
    q, k, v, do, lse, delta = args
    kw = dict(band, **pt_att.flash_bwd_plain_kw(ROUTE))
    tdq, tdk, tdv = pt_att.flash_bwd_term_max(*args, **kw)
    kr, vr = (x.float().repeat_interleave(4, 0) for x in (k, v))
    s = torch.einsum("hqd,hkd->hqk", q.float(), kr) / 16.0
    pos = torch.arange(200)
    live = (pos[:, None] >= pos[None]) & (pos[:, None] - pos[None] < 100)
    p = torch.where(live, torch.exp(s - lse[..., None]), 0.0)
    dp = torch.einsum("hqd,hkd->hqk", do.float(), vr)
    ds = (p * (dp - delta[..., None]) / 16.0).to(BF16).float().abs()
    p = p.to(BF16).float()

    def term_max(a, b):                 # max over the middle axis
        return (a[..., None] * b.abs()[:, None]).amax(2)

    torch.testing.assert_close(tdq, term_max(ds, kr), rtol=0, atol=0)
    for t, a, b in ((tdk, ds, q), (tdv, p, do)):
        want = term_max(a.transpose(1, 2), b.float()).amax(0, keepdim=True)
        torch.testing.assert_close(t, want, rtol=0, atol=0)


FAULTS = ["another_sum_order", "dq_without_one_key_block",
          "dk_with_shifted_delta"]


@pytest.mark.parametrize("fault", FAULTS)
def test_rounded_bound_rejects_real_faults(fault):
    """The rounded routes' check (``chip_smoke.closeness_rounded``, with T
    from ``flash_bwd_term_max``) accepts the true result summed in another
    order (the plain version at the D-128 route's blocks, whose f32 p and
    ds differ in their last bits) and rejects a dq with one 32-key block of
    its band left out and a dk whose ds used delta shifted by one q row,
    each by the per-element bound (the one T widens) as well as by the
    row and tensor bounds."""
    closeness = _chip_smoke().closeness_rounded
    args, band = _bf16_case(5)
    q, k, v, do, lse, delta = args
    kw = dict(band, **pt_att.flash_bwd_plain_kw(ROUTE))
    want = pt_att.flash_attention_bwd_plain(*args, **kw)
    terms = pt_att.flash_bwd_term_max(*args, **kw)
    if fault == "another_sum_order":
        got = pt_att.flash_attention_bwd_plain(
            *args, **dict(kw, **pt_att.flash_bwd_plain_kw("flash_bwd")))
        assert not all(torch.equal(a, b) for a, b in zip(got, want))
        for g, w, t in zip(got, want, terms):
            close = closeness(g, w, t)
            assert close["within_tol"], close
        return
    if fault == "dq_without_one_key_block":
        w = pt_att._BwdPairs(*args, block_q=128, block_k=32, scale=None,
                             kv_len=None, q_len=None, rounded=True, **band)
        iq, ik = 1, 5                        # keys 160-191 of rows 128-255
        _, _, kb, _, ds = w.pair(iq, ik)
        assert ds.abs().max() > 0
        got = want[0].clone()
        got[:, 128:256] -= torch.einsum("hqk,hkd->hqd", ds, kb)
        close = closeness(got, want[0], terms[0])
    else:
        shifted = torch.roll(delta, 1, dims=1)
        got = pt_att.flash_bwd_dkv_plain(q, k, v, do, lse, shifted, **{
            key: kw[key] for key in ("causal", "window", "rounded")},
            block_q=64, block_k=64)[0]
        close = closeness(got, want[1], terms[1])
    assert not close["within_tol"], close
    assert close["worst_tol_ratio"] > 1, close
