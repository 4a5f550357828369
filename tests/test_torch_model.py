"""The port's transformer (qwen3-4b smoke, f32, CPU) against the reference's
under plain ``jax.jit`` with no mesh, on shared converted weights: forward
logits, bucketed prefill with ``true_lengths``, dense decode, and the paged
step at T > 1 and T == 1 with an f32 pool and an int8 pool.
atol 1e-4: XLA and torch sum in different orders over two layers."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ATOL = 1e-4
ARCH = "qwen3-4b"


@pytest.fixture(scope="module")
def models():
    rb = ref_get_bundle(ARCH, smoke=True)
    rp = rb.init_params(jax.random.PRNGKey(0))
    pb = pt_get_bundle(ARCH, smoke=True)
    pp = from_jax_params(jax.tree.map(np.asarray, rp))
    return rb, rp, pb, pp


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


def test_forward_logits(models):
    rb, rp, pb, pp = models
    toks = _tokens(2, 24)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 24, 256) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_prefill_true_lengths_then_decode(models, kv):
    """A right-padded bucket with true lengths, then two decode steps."""
    rb, rp, pb, pp = models
    B, S, max_len = 2, 16, 32
    toks = _tokens(B, S, seed=1)
    true = np.asarray([11, 16], np.int32)
    kv_ref = jnp.int8 if kv == "int8" else None
    kv_pt = torch.int8 if kv == "int8" else None
    rc = rb.init_cache(B, max_len, kv_dtype=kv_ref)
    pc = pb.init_cache(B, max_len, kv_dtype=kv_pt, device="cpu")
    rl, rc = jax.jit(lambda p, t, c, tl: rb.prefill(p, t, c,
                                                    true_lengths=tl))(
        rp, jnp.asarray(toks), rc, jnp.asarray(true))
    pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc,
                         true_lengths=torch.from_numpy(true))
    _close(pl_, rl)
    for key in rc:
        # an int8 code may round one step apart
        _close(pc[key], rc[key],
               atol=1.0 if pc[key].dtype == torch.int8 else ATOL)
    step = jax.jit(rb.decode_step)
    nxt = np.asarray([[3], [7]], np.int32)
    for _ in range(2):
        rl, rc = step(rp, jnp.asarray(nxt), rc)
        pl_, pc = pb.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl_, rl)
        np.testing.assert_array_equal(pc["length"].numpy(),
                                      np.asarray(rc["length"]))
        nxt = np.asarray(rl[:, 0].argmax(-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_step_chunk_then_decode(models, kv):
    """A prefill chunk (T = 8, uneven counts, an idle row) and then a
    T == 1 decode step through the kernel path (its plain version here)
    and through the gather path, against the reference's paged_step."""
    rb, rp, pb, pp = models
    B, P, page, MP = 3, 12, 4, 4
    kv_ref = jnp.int8 if kv == "int8" else None
    kv_pt = torch.int8 if kv == "int8" else None
    rpool = rb.init_paged_pool(P, page, kv_dtype=kv_ref)
    ppool = pb.init_paged_pool(P, page, kv_dtype=kv_pt,
                               device="cpu")
    table = np.asarray([[1, 2, 3, 4], [5, 6, 0, 0], [7, 8, 9, 10]], np.int32)
    lens = np.asarray([0, 2, 0], np.int32)
    counts = np.asarray([8, 5, 0], np.int32)
    toks = _tokens(B, 8, seed=2)
    rstep = jax.jit(rb.paged_step)
    rl, rpool, rlen = rstep(rp, jnp.asarray(toks), rpool, jnp.asarray(table),
                            jnp.asarray(lens), jnp.asarray(counts))
    pl_, ppool, plen = pb.paged_step(
        pp, torch.from_numpy(toks).long(), ppool, torch.from_numpy(table),
        torch.from_numpy(lens), torch.from_numpy(counts))
    for b in range(B):      # rows past a row's count are padding
        _close(pl_[b, :counts[b]], rl[b, :counts[b]])
    np.testing.assert_array_equal(plen.numpy(), np.asarray(rlen))
    # decode: one token per live row
    nxt = np.asarray([[9], [4], [0]], np.int32)
    dcounts = np.asarray([1, 1, 0], np.int32)
    rl, _, _ = rstep(rp, jnp.asarray(nxt), rpool, jnp.asarray(table),
                     rlen, jnp.asarray(dcounts))
    for impl in ("pallas", "xla"):
        cfg = dataclasses.replace(pb.cfg, attn_impl=impl)
        pool = {k: v.clone() for k, v in ppool.items()}
        pl_, _, _ = pb.family.paged_step(
            cfg, pp, torch.from_numpy(nxt).long(), pool,
            torch.from_numpy(table), plen.to(torch.int32),
            torch.from_numpy(dcounts))
        for b in range(2):
            _close(pl_[b], rl[b])


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_init_params_match_reference_leaves(arch):
    """A MoE config draws the reference's leaves: router (L, D, E) and the
    experts' (L, E, D, Fe) / (L, E, Fe, D) products in place of the dense
    MLP, under the same names, shapes and dtypes."""
    want = jax.tree.map(np.asarray, ref_get_bundle(arch, smoke=True)
                        .init_params(jax.random.PRNGKey(0)))
    got = pt_get_bundle(arch, smoke=True).init_params(0, device="cpu")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    assert "['layers']['router']" in flat_g
    for k, w in flat_w.items():
        g = flat_g[k]
        assert tuple(g.shape) == w.shape, k
        assert str(g.dtype).split(".")[-1] == str(w.dtype), k


def test_weights_bf16_round_trip():
    """bf16 arrays (ml_dtypes) cross bit-exactly into torch.bfloat16."""
    x = jnp.asarray(np.random.default_rng(0).normal(size=(3, 5)),
                    jnp.bfloat16)
    t = from_jax_params({"a": {"b": np.asarray(x)}})["a"]["b"]
    assert t.dtype == torch.bfloat16
    np.testing.assert_array_equal(t.float().numpy(),
                                  np.asarray(x, np.float32))
