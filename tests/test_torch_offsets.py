"""q / k position offsets in the port's flash attention, on the CPU.

The reference's flash kernels take ``q_offset`` / ``k_offset``, the global
positions of q row 0 and key 0 (ring attention's per-hop fold of a visiting
shard): their causal and window masks compare ``q_offset + q`` with
``k_offset + k``, and at nonzero offsets they walk the dense grid.  The
port prunes the band the offsets shift.  Here, on numpy inputs from a
fixed seed in f32:

* the plain forward and backward at nonzero offsets, pruned and dense,
  against the reference's Pallas kernels in interpret mode, within 1e-5
  (the f32 sums run in another order): causal and window, GQA, Sq != Sk,
  ragged lengths, q ahead of k, q behind k (rows that see no key drain
  o = 0, lse = -1e30, dq = 0) and a ring's hops (q_offset S_l against
  k_offset owner * S_l);
* pruned equals dense bit for bit (a pruned block is fully masked, and a
  fully masked block adds exactly 0);
* the kernels' per-CTA ranges at the offsets hold every block that has a
  live pair, by brute force over positions;
* the autograd entry forwards the offsets to both halves."""
import functools

import pytest

torch = pytest.importorskip("torch")

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.kernels import attention as ref_att  # noqa: E402
from repro_torch.kernels import attention as pt_att  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402

NEG_INF = -1e30

# (BH, BHkv, Sq, Sk, D, causal, window, q_len, kv_len, q_offset, k_offset,
#  (block_q, block_k)): Sq / Sk are whole blocks for the reference; q_len /
# kv_len bound the valid region where they are ragged
CASES = {
    # q ahead of k (shift 128): the window's lower edge inside the blocks
    "q_ahead_window_gqa": (8, 2, 256, 256, 32, True, 100, 256, 256, 192, 64,
                           (64, 64)),
    # q behind k (shift -96): rows 0-95 see no key
    "q_behind_causal_empty_rows": (4, 1, 256, 256, 32, True, None, 256, 256,
                                   0, 96, (64, 64)),
    # non-causal window, Sq != Sk, ragged q and keys, shift -70
    "noncausal_window_ragged": (4, 2, 256, 384, 32, False, 100, 200, 300, 50,
                                120, (64, 64)),
    # the wgmma forward's and dq's blocks, ragged, shift 100
    "causal_window_ragged_128": (8, 2, 384, 384, 64, True, 300, 300, 300,
                                 1000, 900, (128, 128)),
    "causal_gqa_128x64": (8, 4, 256, 256, 32, True, None, 256, 256, 640, 512,
                          (128, 64)),
    # a ring of 128-token shards seen from shard 1: owners 0 (the past,
    # shift 128), 1 (the diagonal) and 2 (the future: every key masked)
    "ring_hop_owner0": (4, 2, 128, 128, 32, True, 160, 128, 128, 128, 0,
                        (64, 64)),
    "ring_hop_owner1": (4, 2, 128, 128, 32, True, 160, 128, 128, 128, 128,
                        (64, 64)),
    "ring_hop_owner2": (4, 2, 128, 128, 32, True, 160, 128, 128, 128, 256,
                        (64, 64)),
    # head_dim 256 at the CUDA-core backward's 64 x 64 (recurrentgemma's
    # MQA, 4 / 1 heads, window 64): ragged q rows and keys at offset 0,
    # and whole blocks with q ahead by 100
    "d256_mqa_window_ragged": (4, 1, 256, 256, 256, True, 64, 200, 230, 0,
                               0, (64, 64)),
    "d256_mqa_window_q_ahead": (4, 1, 256, 256, 256, True, 64, 256, 256,
                                300, 200, (64, 64)),
    # ... and at the head_dim-256 wgmma dq's 128 x 32 blocks, ragged keys
    "d256_mqa_window_q_ahead_128x32": (4, 1, 256, 256, 256, True, 64, 256,
                                       230, 300, 200, (128, 32)),
}


def _live(case) -> np.ndarray:
    """(Sq, Sk) mask of the case's live pairs, by brute force."""
    _, _, Sq, Sk, _, causal, window, q_len, kv_len, qo, ko, _ = CASES[case]
    q = qo + np.arange(Sq)[:, None]
    k = ko + np.arange(Sk)[None, :]
    m = (np.arange(Sk)[None, :] < kv_len) & (np.arange(Sq)[:, None] < q_len)
    if causal:
        m = m & (q >= k)
    if window is not None:
        m = m & (q - k < window)
    return m


@functools.lru_cache(maxsize=None)
def _reference(case: str):
    """Inputs, the Pallas forward and backward (interpret mode, f32, at the
    case's blocks and offsets) and the keyword arguments both sides take."""
    BH, BHkv, Sq, Sk, D, causal, window, q_len, kv_len, qo, ko, blocks = \
        CASES[case]
    rng = np.random.default_rng(sorted(CASES).index(case))
    q, do = (rng.normal(size=(BH, Sq, D)).astype(np.float32)
             for _ in range(2))
    k, v = (rng.normal(size=(BHkv, Sk, D)).astype(np.float32)
            for _ in range(2))
    kw = dict(causal=causal, window=window, q_len=q_len, kv_len=kv_len,
              q_offset=qo, k_offset=ko, block_q=blocks[0],
              block_k=blocks[1])
    o, lse = ref_att.flash_attention_fwd_pallas(
        *map(jnp.asarray, (q, k, v)), interpret=True, **kw)
    o, lse = np.array(o), np.array(lse)
    delta = (o * do).sum(-1)
    grads = ref_att.flash_attention_bwd_pallas(
        *map(jnp.asarray, (q, k, v, do, lse, delta)), interpret=True, **kw)
    return (q, k, v, do, lse, delta), kw, (o, lse), \
        tuple(np.array(g) for g in grads)


def _rows(case, o, lse):
    q_len = CASES[case][7]
    return o[:, :q_len], lse[:, :q_len]


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_forward_at_offsets_matches_pallas(case, prune):
    """o and lse of the valid rows within 1e-5 of the Pallas forward."""
    (q, k, v, *_), kw, want, _ = _reference(case)
    o, lse = pt_att.flash_attention_fwd_plain(
        *map(torch.from_numpy, (q, k, v)), prune=prune, **kw)
    for g, w in zip(_rows(case, o.numpy(), lse.numpy()), _rows(case, *want)):
        np.testing.assert_allclose(g, w, atol=1e-5)


@pytest.mark.parametrize("prune", [True, False], ids=["pruned", "dense"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_plain_backward_at_offsets_matches_pallas(case, prune):
    """dq (valid rows), dk and dv (valid keys) within 1e-5 of the Pallas
    backward, from the reference's own lse and delta."""
    inputs, kw, _, want = _reference(case)
    q_len, kv_len = CASES[case][7:9]
    got = pt_att.flash_attention_bwd_plain(
        *map(torch.from_numpy, inputs), prune=prune, **kw)
    for g, w, n in zip(got, want, (q_len, kv_len, kv_len)):
        assert g.dtype == torch.float32
        np.testing.assert_allclose(g.numpy()[:, :n], w[:, :n], atol=1e-5)


@pytest.mark.parametrize("case", sorted(CASES))
def test_pruned_equals_dense_bit_for_bit(case):
    """The band pruned at the offsets drops only fully masked blocks, which
    add exactly 0: forward and backward equal the dense grid's."""
    inputs, kw, _, _ = _reference(case)
    t = [torch.from_numpy(x) for x in inputs]
    fwd = [pt_att.flash_attention_fwd_plain(*t[:3], prune=p, **kw)
           for p in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*fwd))
    bwd = [pt_att.flash_attention_bwd_plain(*t, prune=p, **kw)
           for p in (True, False)]
    assert all(torch.equal(a, b) for a, b in zip(*bwd))
    # the pruned table is no longer than the dense one
    BH, BHkv, Sq, Sk, D, causal, window, q_len, kv_len, qo, ko, (bq, bk) = \
        CASES[case]
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    pruned = pt_att._pair_schedule(nq, nk, bq, bk, causal, window, kv_len,
                                   q_len, "row", qo, ko)[1]
    dense = pt_att._pair_schedule(nq, nk, bq, bk, False, None, kv_len,
                                  q_len, "row")[1]
    assert pruned <= dense


@pytest.mark.parametrize("case", ["q_behind_causal_empty_rows",
                                  "ring_hop_owner2"])
def test_rows_that_see_no_key_drain_zero(case):
    """A row the shift leaves without a key: o = 0, lse = -1e30, dq = 0,
    as the reference drains it; its range is the empty one."""
    inputs, kw, _, _ = _reference(case)
    t = [torch.from_numpy(x) for x in inputs]
    dead = ~_live(case).any(1)
    assert dead.any()
    o, lse = pt_att.flash_attention_fwd_plain(*t[:3], **kw)
    assert (o[:, dead] == 0).all() and (lse[:, dead] == NEG_INF).all()
    dq, _, _ = pt_att.flash_attention_bwd_plain(*t[:4], lse, *t[5:], **kw)
    assert (dq[:, dead] == 0).all()
    bq = kw["block_q"]
    r = pt_att.row_block_ranges(o.shape[1], t[1].shape[1], block_q=bq,
                                block_k=kw["block_k"], causal=kw["causal"],
                                window=kw["window"], q_offset=kw["q_offset"],
                                k_offset=kw["k_offset"])
    for iq in range(r.shape[0]):
        if dead[iq * bq:(iq + 1) * bq].all():
            assert tuple(r[iq]) == (0, -1)


RANGE_SWEEP = [(Sq, Sk, bq, bk, causal, window, qo, ko)
               for Sq, Sk in [(256, 256), (200, 330), (384, 128)]
               for bq, bk in [(64, 64), (128, 128), (128, 64), (64, 128)]
               for causal, window in [(True, None), (True, 100),
                                      (False, 150)]
               for qo, ko in [(0, 0), (300, 100), (64, 320), (1000, 1000),
                              (5, 0), (0, 1000)]]


@pytest.mark.parametrize("Sq,Sk,bq,bk,causal,window,qo,ko", RANGE_SWEEP)
def test_ranges_at_offsets_hold_every_live_block(Sq, Sk, bq, bk, causal,
                                                 window, qo, ko):
    """Row ranges (forward, dq) and column ranges (dk/dv) at the offsets
    hold exactly the blocks with a live pair: brute force over positions.
    The reference once dropped live k blocks in its pruning
    (tests/test_attention_vjp.py); a dropped block here would show as a
    live block outside its range."""
    q = qo + np.arange(Sq)[:, None]
    k = ko + np.arange(Sk)[None, :]
    live = np.ones((Sq, Sk), bool)
    if causal:
        live &= q >= k
    if window is not None:
        live &= q - k < window
    nq, nk = -(-Sq // bq), -(-Sk // bk)
    blocks = np.zeros((nq, nk), bool)
    for iq in range(nq):
        for ik in range(nk):
            blocks[iq, ik] = live[iq * bq:(iq + 1) * bq,
                                  ik * bk:(ik + 1) * bk].any()
    kw = dict(block_q=bq, block_k=bk, causal=causal, window=window,
              q_offset=qo, k_offset=ko)
    rows = pt_att.row_block_ranges(Sq, Sk, **kw)
    cols = pt_att.col_block_ranges(Sq, Sk, **kw)
    for iq in range(nq):
        got = np.zeros(nk, bool)
        got[rows[iq, 0]:rows[iq, 1] + 1] = True
        np.testing.assert_array_equal(got, blocks[iq])
    for ik in range(nk):
        got = np.zeros(nq, bool)
        got[cols[ik, 0]:cols[ik, 1] + 1] = True
        np.testing.assert_array_equal(got, blocks[:, ik])
    # the reference's _row_range at zero offsets is the port's
    if qo == ko:
        for iq in range(nq):
            lo, hi = ref_att._row_range(iq, nk=nk, block_q=bq, block_k=bk,
                                        causal=causal, window=window,
                                        kv_len=Sk, q_len=Sq)
            assert tuple(rows[iq]) == ((lo, hi) if hi >= lo else (0, -1))


def test_ranges_on_caches_by_shift():
    """The kernels' device ranges are cached per band shift: two offset
    pairs of one shift share a table, another shift builds its own, and
    the dense grid ignores the offsets."""
    dev = torch.device("cpu")
    kw = dict(dev=dev, Sq=512, Sk=512, causal=True, window=200, order="row",
              block_q=128, block_k=128)
    a = pt_att._ranges_on(**kw, q_offset=512, k_offset=256)
    assert pt_att._ranges_on(**kw, q_offset=256, k_offset=0) is a
    b = pt_att._ranges_on(**kw, q_offset=0, k_offset=256)
    assert not torch.equal(a, b)
    assert torch.equal(b[:2], torch.tensor([[0, -1], [0, -1]],
                                           dtype=torch.int32))
    dense = pt_att._ranges_on(**kw, prune=False, q_offset=9, k_offset=0)
    assert (dense == torch.tensor([0, 3], dtype=torch.int32)).all()


def test_flash_attention_train_forwards_offsets_on_cpu():
    """The autograd entry passes the offsets to the forward and saves them
    for the backward: its output and grads equal the plain versions at the
    same offsets (bf16 inputs at head_dim 64: the wgmma route's blocks and
    rounding), and differ from those at offset 0."""
    rng = np.random.default_rng(7)
    B, H, Hkv, S, D = 1, 4, 2, 160, 64
    bf = torch.bfloat16
    q, do = (torch.from_numpy(rng.normal(size=(B, H, S, D))
                              .astype(np.float32)).to(bf) for _ in range(2))
    k, v = (torch.from_numpy(rng.normal(size=(B, Hkv, S, D))
                             .astype(np.float32)).to(bf) for _ in range(2))
    offs = dict(q_offset=200, k_offset=100)
    leaves = [x.clone().requires_grad_(True) for x in (q, k, v)]
    o = pt_att.flash_attention_train(*leaves, causal=True, window=120,
                                     **offs)
    grads = torch.autograd.grad(o, leaves, do)
    flat = (q.reshape(B * H, S, D), k.reshape(B * Hkv, S, D),
            v.reshape(B * Hkv, S, D))
    o_ref, lse = pt_att.flash_attention_fwd_plain(
        *flat, causal=True, window=120, block_q=128, block_k=128, **offs)
    assert torch.equal(o.detach(), o_ref.reshape(o.shape))
    delta = (o_ref.float() * do.reshape(B * H, S, D).float()).sum(-1)
    route = pt_att.flash_bwd_route(q, k, v, do)
    want = pt_att.flash_attention_bwd_plain(
        *flat, do.reshape(B * H, S, D), lse, delta, causal=True, window=120,
        **offs, **pt_att.flash_bwd_plain_kw(route))
    for gr, w, x in zip(grads, want, (q, k, v)):
        assert torch.equal(gr, w.reshape(x.shape).to(bf))
    o0 = pt_att.flash_attention_train(q, k, v, causal=True, window=120)
    assert not torch.equal(o0, o.detach())
    assert all(n == 0 for n in pt_ops.LAUNCHES.values())


@pytest.mark.parametrize("offs", [dict(q_offset=2 ** 30, k_offset=0),
                                  dict(q_offset=0, k_offset=-2 ** 30),
                                  dict(q_offset=1.5, k_offset=0)])
def test_offsets_past_int32_are_refused(offs):
    """The kernels form q + shift in 32-bit ints: the launchers' check
    refuses an offset that is not an int within 2^30 of 0."""
    with pytest.raises(ValueError, match=r"within 2\^30"):
        pt_att._check_offsets("flash_attention_fwd_cuda", **offs)
    pt_att._check_offsets("flash_attention_fwd_cuda", 2 ** 30 - 1,
                          -(2 ** 30 - 1))
