"""The port's kernel modules on the CPU: the plain versions of the flash
forward and backward and paged decode kernels against the reference's
Pallas kernels in interpret mode, the trainable flash attention against
``jax.grad`` of the reference's, the copied pair schedule against the
reference's, and the wrappers' dispatch rules (no fallback for CUDA, no
launch counted on the CPU)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as ref_att  # noqa: E402
from repro.kernels import ops as ref_ops  # noqa: E402
from repro_torch.kernels import attention as pt_att  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402
from repro_torch.kernels import paged_attention as pt_paged  # noqa: E402

RNG = np.random.default_rng(11)


def _normal(*shape):
    return RNG.normal(size=shape).astype(np.float32)


# ---------------------------------------------------------------------------
# flash forward: plain version == Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

FLASH_CASES = {
    "gqa_causal": dict(BH=8, BHkv=2, causal=True, window=None),
    "gqa_window": dict(BH=8, BHkv=2, causal=True, window=8),
    "padded_noncausal": dict(BH=4, BHkv=4, causal=False, window=None,
                             kv_len=20, q_len=24),
    # q blocks 2-3 see no key inside their window below kv_len 8, and q
    # block 3 lies past q_len: both become fully masked sentinel rows
    "sentinel_rows": dict(BH=4, BHkv=2, causal=True, window=4, kv_len=8,
                          q_len=24),
}


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_plain_matches_pallas(case):
    c = dict(FLASH_CASES[case])
    BH, BHkv = c.pop("BH"), c.pop("BHkv")
    S, D, blk = 32, 16, 8
    q, k, v = _normal(BH, S, D), _normal(BHkv, S, D), _normal(BHkv, S, D)
    o_ref, lse_ref = ref_att.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=blk,
        block_k=blk, interpret=True, **c)
    o, lse = pt_att.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        block_q=blk, block_k=blk, **c)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5)
    if case == "sentinel_rows":
        assert (o[:, 16:].abs().max() == 0) and (lse[:, 16:] == -1e30).all()


@pytest.mark.parametrize("case", sorted(FLASH_CASES))
def test_flash_bwd_plain_matches_pallas(case):
    """dq, dk, dv of the plain backward against the reference's two Pallas
    backward kernels (interpret mode) on the same lse and delta, atol 1e-5
    (f32 on both sides, sums in another order)."""
    c = dict(FLASH_CASES[case])
    BH, BHkv = c.pop("BH"), c.pop("BHkv")
    S, D, blk = 32, 16, 8
    q, k, v = _normal(BH, S, D), _normal(BHkv, S, D), _normal(BHkv, S, D)
    do = _normal(BH, S, D)
    o, lse = ref_att.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), block_q=blk,
        block_k=blk, interpret=True, **c)
    lse = np.array(lse)
    delta = (np.asarray(o) * do).sum(-1)
    want = ref_att.flash_attention_bwd_pallas(
        *map(jnp.asarray, (q, k, v, do, lse, delta)), block_q=blk,
        block_k=blk, interpret=True, **c)
    got = pt_att.flash_attention_bwd_plain(
        *map(torch.from_numpy, (q, k, v, do, lse, delta)), block_q=blk,
        block_k=blk, **c)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5)
    if case == "sentinel_rows":
        # q blocks 2-3 and every key past kv_len 8 drain exactly 0
        dq, dk, dv = got
        assert dq[:, 16:].abs().max() == 0
        assert dk[:, 8:].abs().max() == 0 and dv[:, 8:].abs().max() == 0


@pytest.mark.parametrize("causal,window", [(True, None), (True, 8),
                                           (False, None)])
def test_flash_attention_train_grads_match_jax(causal, window):
    """The port's FlashAttention (plain halves on the CPU) against jax.grad
    through the reference's trainable wrapper (custom VJP over the Pallas
    kernels in interpret mode): output and dq/dk/dv of a weighted sum of
    the output, atol 1e-5 (f32)."""
    B, H, Hkv, S, D = 2, 4, 2, 40, 16
    q, k, v = _normal(B, H, S, D), _normal(B, Hkv, S, D), _normal(B, Hkv, S,
                                                                   D)
    w = _normal(B, H, S, D)

    def ref_loss(q, k, v):
        o = ref_ops.flash_attention(q, k, v, causal=causal, window=window,
                                    block_q=8, block_k=8)
        return (o * jnp.asarray(w)).sum(), o

    (_, o_ref), g_ref = jax.value_and_grad(ref_loss, argnums=(0, 1, 2),
                                           has_aux=True)(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v))
    qt, kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (q, k, v))
    o = pt_att.flash_attention_train(qt, kt, vt, causal=causal,
                                     window=window)
    (o * torch.from_numpy(w)).sum().backward()
    np.testing.assert_allclose(o.detach().numpy(), np.asarray(o_ref),
                               atol=1e-5)
    for t, g in zip((qt, kt, vt), g_ref):
        assert t.grad.dtype == torch.float32 and t.grad.shape == t.shape
        np.testing.assert_allclose(t.grad.numpy(), np.asarray(g), atol=1e-5)


def test_flash_wrapper_trains_through_the_function():
    """ops.flash_attention under autograd goes through FlashAttention (its
    plain halves here) and counts no launch; the bf16 grads come back in
    the inputs' dtype and layout."""
    pt_ops.reset_launches()
    x = torch.from_numpy(_normal(1, 24, 4, 16)).to(torch.bfloat16)
    q = x.clone().requires_grad_(True)
    kv = x[:, :, :2].clone().requires_grad_(True)
    o = pt_ops.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                               kv.transpose(1, 2))
    assert o.grad_fn is not None and o.dtype == torch.bfloat16
    o.float().sum().backward()
    assert q.grad.dtype == torch.bfloat16 and q.grad.shape == q.shape
    assert kv.grad.shape == kv.shape and torch.isfinite(kv.grad).all()
    with torch.no_grad():
        assert pt_ops.flash_attention(q.transpose(1, 2), kv.transpose(1, 2),
                                      kv.transpose(1, 2)).grad_fn is None
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


def test_flash_wrapper_matches_reference_ops():
    """ops.flash_attention on CPU tensors ((B, H, S, D), ragged S) against
    the reference's public wrapper."""
    B, H, Hkv, S, D = 2, 4, 2, 40, 16
    q, k, v = _normal(B, H, S, D), _normal(B, Hkv, S, D), _normal(B, Hkv, S,
                                                                   D)
    ref = ref_ops.flash_attention(jnp.asarray(q), jnp.asarray(k),
                                  jnp.asarray(v), causal=True,
                                  trainable=False, block_q=8, block_k=8)
    got = pt_ops.flash_attention(torch.from_numpy(q), torch.from_numpy(k),
                                 torch.from_numpy(v), causal=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)


# ---------------------------------------------------------------------------
# the copied pair schedule
# ---------------------------------------------------------------------------

SWEEP = [(Sq, Sk, bq, bk, causal, window)
         for Sq, Sk in [(64, 64), (128, 128), (96, 160), (2048, 2048),
                        (256, 64)]     # non-causal + window: sentinel rows
         for bq, bk in [(64, 64), (32, 64), (128, 128), (128, 64),
                        (64, 128)]
         for causal in (True, False)
         for window in (None, 100)
         if Sq % bq == 0 and Sk % bk == 0]


@pytest.mark.parametrize("Sq,Sk,bq,bk,causal,window", SWEEP)
def test_schedule_counts_and_tables_equal_reference(Sq, Sk, bq, bk, causal,
                                                    window):
    kw = dict(block_q=bq, block_k=bk, causal=causal, window=window)
    assert pt_att.scheduled_block_counts(Sq, Sk, **kw) == \
        ref_att.scheduled_block_counts(Sq, Sk, **kw)
    for order in ("row", "col"):
        args = (Sq // bq, Sk // bk, bq, bk, causal, window, Sk, Sq, order)
        t_pt, n_pt = pt_att._pair_schedule(*args)
        t_ref, n_ref = ref_att._pair_schedule(*args)
        np.testing.assert_array_equal(t_pt, t_ref)
        assert n_pt == n_ref
    # the kernel's per-CTA ranges are the row spans of the reference's
    # row-ordered table; a row the kernel skips (empty range) holds the
    # table's one fully masked sentinel pair
    r = pt_att.row_block_ranges(Sq, Sk, **kw)
    t_ref, _ = ref_att._pair_schedule(Sq // bq, Sk // bk, bq, bk, causal,
                                      window, Sk, Sq, "row")
    for iq in range(Sq // bq):
        row = t_ref[t_ref[:, 0] == iq]
        if r[iq, 1] < r[iq, 0]:
            assert tuple(r[iq]) == (0, -1) and len(row) == 1
        else:
            assert tuple(r[iq]) == (row[0, 1], row[-1, 1])
            assert row[0, 2] == 1 and row[-1, 3] == 1
    real, _ = ref_att.scheduled_block_counts(Sq, Sk, **kw)
    assert int(np.maximum(r[:, 1] - r[:, 0] + 1, 0).sum()) == real


@pytest.mark.parametrize("Sq,Sk,bq,bk,causal,window", SWEEP)
def test_col_ranges_are_the_reference_column_table(Sq, Sk, bq, bk, causal,
                                                   window):
    """The dk/dv kernel's per-CTA q-block ranges are the column spans of
    the reference's column-ordered table; a column the kernel drains as
    zeros holds the table's one sentinel pair, and it is fully masked."""
    kw = dict(block_q=bq, block_k=bk, causal=causal, window=window)
    c = pt_att.col_block_ranges(Sq, Sk, **kw)
    nq, nk = Sq // bq, Sk // bk
    assert c.shape == (nk, 2) and c.dtype == np.int32
    t_ref, real = ref_att._pair_schedule(nq, nk, bq, bk, causal, window, Sk,
                                         Sq, "col")
    for ik in range(nk):
        col = t_ref[t_ref[:, 1] == ik]
        assert col[0, 2] == 1 and col[-1, 3] == 1
        if c[ik, 1] < c[ik, 0]:
            assert tuple(c[ik]) == (0, -1) and len(col) == 1
            mask = pt_att._block_mask(int(col[0, 0]) * bq, ik * bk, bq, bk,
                                      causal, window, Sk, "cpu")
            assert not mask.any()
        else:
            np.testing.assert_array_equal(
                col[:, 0], np.arange(c[ik, 0], c[ik, 1] + 1))
    assert int(np.maximum(c[:, 1] - c[:, 0] + 1, 0).sum()) == real


# ---------------------------------------------------------------------------
# paged decode: plain version == Pallas kernel (interpret mode)
# ---------------------------------------------------------------------------

def _pool(quant: bool, dtype=np.float32):
    B, H, Hkv, D, P, pg = 3, 8, 2, 32, 12, 16
    q = _normal(B, H, D)
    pt = np.asarray([[1, 2, 3, 0], [4, 5, 0, 0], [6, 7, 8, 9]], np.int32)
    lens = np.asarray([40, 17, 64], np.int32)
    if quant:
        k = RNG.integers(-127, 127, (P, pg, Hkv, D)).astype(np.int8)
        v = RNG.integers(-127, 127, (P, pg, Hkv, D)).astype(np.int8)
        ks = RNG.uniform(0.01, 0.02, (P, pg, Hkv)).astype(np.float32)
        vs = RNG.uniform(0.01, 0.02, (P, pg, Hkv)).astype(np.float32)
        return q, k, v, pt, lens, ks, vs
    return q, _normal(P, pg, Hkv, D), _normal(P, pg, Hkv, D), pt, lens, \
        None, None


@pytest.mark.parametrize("form", ["bf16", "int8"])
def test_paged_plain_matches_pallas(form):
    q, k, v, pt, lens, ks, vs = _pool(form == "int8")
    jdt, tdt = (jnp.bfloat16, torch.bfloat16) if form == "bf16" else \
        (jnp.float32, torch.float32)
    jk = jnp.asarray(k) if form == "int8" else jnp.asarray(k, jdt)
    jv = jnp.asarray(v) if form == "int8" else jnp.asarray(v, jdt)
    ref = ref_ops.paged_flash_decode(
        jnp.asarray(q, jdt), jk, jv, jnp.asarray(pt), jnp.asarray(lens),
        None if ks is None else jnp.asarray(ks),
        None if vs is None else jnp.asarray(vs))

    def t(a, cast=True):
        x = torch.from_numpy(np.asarray(a))
        return x.to(tdt) if cast else x

    got = pt_paged.paged_flash_decode_plain(
        t(q), t(k, form == "bf16"), t(v, form == "bf16"), t(pt, False),
        t(lens, False), None if ks is None else t(ks, False),
        None if vs is None else t(vs, False))
    assert got.dtype == tdt
    # f32 arithmetic on both sides; bf16 outputs may round one ulp apart
    atol = 1e-2 if form == "bf16" else 1e-5
    np.testing.assert_allclose(got.float().numpy(),
                               np.asarray(ref, np.float32), atol=atol)


def test_paged_plain_ignores_trash_and_unmapped_pages():
    q, k, v, pt, lens, _, _ = _pool(False)
    args = [torch.from_numpy(a) for a in (q, k, v, pt, lens)]
    out1 = pt_paged.paged_flash_decode_plain(*args)
    k2, v2 = args[1].clone(), args[2].clone()
    k2[0] *= 2.0
    k2[10] += 7.0
    v2[0] *= -3.0
    v2[11] += 1.0
    out2 = pt_paged.paged_flash_decode_plain(args[0], k2, v2, *args[3:])
    torch.testing.assert_close(out1, out2, rtol=0, atol=0)


# ---------------------------------------------------------------------------
# dispatch: CPU tensors take the plain version and count no launch; the
# CUDA launchers refuse anything that is not on a CUDA device
# ---------------------------------------------------------------------------

def test_cpu_calls_count_no_launch():
    pt_ops.reset_launches()
    q, k, v, pt, lens, _, _ = _pool(False)
    pt_ops.paged_flash_decode(*[torch.from_numpy(a) for a in
                                (q, k, v, pt, lens)])
    x = torch.from_numpy(_normal(1, 4, 16, 16))
    pt_ops.flash_attention(x, x[:, :2], x[:, :2])
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


def test_cuda_launchers_refuse_cpu_tensors():
    x = torch.zeros(1, 4, 64, 128, dtype=torch.bfloat16)
    with pytest.raises(ValueError, match="CUDA"):
        pt_att.flash_attention_fwd_cuda(x, x[:, :2], x[:, :2])
    q, k, v, pt, lens, _, _ = _pool(False)
    with pytest.raises(ValueError, match="CUDA"):
        pt_paged.paged_flash_decode_cuda(
            *[torch.from_numpy(a) for a in (q, k, v, pt, lens)])
