"""The port's RecurrentGemma (kind ``hybrid``: RG-LRU + local MQA
attention) against the reference on recurrentgemma-9b's smoke config (f32,
CPU; window 64): the same converted weights give forward logits and
prefill + decode logits within atol 1e-4 (rtol 0, as
``test_torch_configs.py``), at prompts shorter and longer than the window
(so the ring cache wraps and the window masks), and with ``n_layers % 3
== 0`` (``rec_tail`` is None); the log-depth RG-LRU scan equals the
reference's associative scan within 1e-5; ``geglu`` and the tanh GELU
equal the reference's in f32; the plain flash forward at head_dim 256
(the full-width MQA shape's, 4 heads over 1) equals the reference's Pallas
forward in interpret mode within 1e-5; and the port's engine on 2 slots
(the grouped states' batch at axis 2) serves the reference engine's greedy
tokens exactly."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.kernels import attention as ref_att  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import recurrentgemma as ref_rg  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.kernels import attention as pt_att  # noqa: E402
from repro_torch.kernels import ops as pt_ops  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import recurrentgemma as pt_rg  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "recurrentgemma-9b"
ATOL = 1e-4


def _models(n_layers=None):
    rb = ref_get_bundle(ARCH, smoke=True)
    pb = pt_get_bundle(ARCH, smoke=True)
    if n_layers is not None:
        rb = dataclasses.replace(rb, cfg=dataclasses.replace(
            rb.cfg, n_layers=n_layers))
        pb = dataclasses.replace(pb, cfg=dataclasses.replace(
            pb.cfg, n_layers=n_layers))
    rp = rb.init_params(jax.random.PRNGKey(0))
    return rb, rp, pb, from_jax_params(jax.tree.map(np.asarray, rp))


@pytest.fixture(scope="module")
def models():
    return _models()


@pytest.fixture(scope="module")
def models_no_tail():
    return _models(n_layers=6)


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


def test_bundle_is_the_reference_bundle(models):
    rb, _, pb, _ = models
    assert (pb.kind, pb.sub_quadratic) == ("hybrid", True) == \
        (rb.kind, rb.sub_quadratic)
    assert not pb.prefill_supports_true_lengths
    assert not pb.supports_paged_kv
    assert pt_rg.CACHE_BATCH_AXES == ref_rg.CACHE_BATCH_AXES
    assert pb.cfg.dh == rb.cfg.dh


@pytest.mark.parametrize("S", [24, 100])
def test_forward_logits(models, S):
    rb, rp, pb, pp = models
    toks = _tokens(2, S)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, S, 256) and aux == 0.0
    _close(got, want)


def _prefill_decode(models, S, max_len, steps=4):
    rb, rp, pb, pp = models
    B = 2
    toks = _tokens(B, S, seed=S)
    rc = rb.init_cache(B, max_len)
    pc = pb.init_cache(B, max_len, device="cpu")
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: v.shape for k, v in rc.items()}
    rl, rc = jax.jit(rb.prefill)(rp, jnp.asarray(toks), rc)
    pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc)
    _close(pl_, rl)
    for k in rc:
        _close(pc[k], rc[k])
    step = jax.jit(rb.decode_step)
    nxt = np.asarray([[3], [7]], np.int32)
    for _ in range(steps):
        rl, rc = step(rp, jnp.asarray(nxt), rc)
        pl_, pc = pb.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl_, rl)
        nxt = np.asarray(rl[:, 0].argmax(-1))[:, None].astype(np.int32)
    for k in rc:
        _close(pc[k], rc[k])


@pytest.mark.parametrize("S,max_len", [(20, 48), (20, 128), (100, 128),
                                       (62, 128)])
def test_prefill_then_decode(models, S, max_len):
    """max_len 48 < window: a 48-slot ring; S 100 > window 64: prefill
    scatters its last 64 keys into slots pos % 64 and decode wraps; S 62:
    the ring fills and wraps during decode."""
    _prefill_decode(models, S, max_len)


def test_no_tail_when_layers_divide(models_no_tail):
    """n_layers 6 = 2 full groups: ``rec_tail`` is None in both packages,
    the tail caches are empty, and forward / prefill / decode agree."""
    rb, rp, pb, pp = models_no_tail
    assert rp["rec_tail"] is None and pp["rec_tail"] is None
    assert pb.init_params(0, device="cpu")["rec_tail"] is None
    toks = _tokens(2, 30)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, _ = pb.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    _close(got, want)
    _prefill_decode(models_no_tail, 30, 64, steps=2)


@pytest.mark.parametrize("L", [1, 2, 37, 64])
def test_rg_lru_scan_matches_reference(L):
    rng = np.random.default_rng(L)
    x = rng.normal(size=(2, L, 8)).astype(np.float32)
    r = rng.uniform(0, 1, (2, L, 8)).astype(np.float32)
    i = rng.uniform(0, 1, (2, L, 8)).astype(np.float32)
    lam = rng.normal(size=(8,)).astype(np.float32)
    want = ref_rg._rg_lru_scan(*map(jnp.asarray, (x, r, i, lam)))
    got = pt_rg._rg_lru_scan(*map(torch.from_numpy, (x, r, i, lam)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_geglu_and_gelu_match_reference():
    """``jax.nn.gelu`` is the tanh approximation by default; the exact erf
    GELU differs from it by up to ~5e-4 here, so this tolerance tells the
    two apart."""
    rng = np.random.default_rng(0)
    x = rng.normal(size=(3, 5, 16)).astype(np.float32)
    wg, wu = (rng.normal(0, 0.5, (16, 24)).astype(np.float32)
              for _ in range(2))
    wd = rng.normal(0, 0.5, (24, 16)).astype(np.float32)
    want = ref_layers.geglu(*map(jnp.asarray, (x, wg, wu, wd)))
    got = pt_layers.geglu(*map(torch.from_numpy, (x, wg, wu, wd)))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    z = np.linspace(-6, 6, 97).astype(np.float32)
    np.testing.assert_allclose(pt_layers.gelu(torch.from_numpy(z)).numpy(),
                               np.asarray(jax.nn.gelu(jnp.asarray(z))),
                               atol=1e-6, rtol=0)


def _normal(*shape, seed=0):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


def test_flash_plain_at_head_dim_256_matches_pallas():
    """The simt route's plain version (64 x 64 blocks) on 4 q heads over 1
    kv head at head_dim 256, causal with a window of 64 over S 256,
    against the reference's Pallas forward in interpret mode."""
    S, D = 256, 256
    q, k, v = _normal(4, S, D), _normal(1, S, D, seed=1), \
        _normal(1, S, D, seed=2)
    o_ref, lse_ref = ref_att.flash_attention_fwd_pallas(
        jnp.asarray(q), jnp.asarray(k), jnp.asarray(v), causal=True,
        window=64, block_q=64, block_k=64, interpret=True)
    o, lse = pt_att.flash_attention_fwd_plain(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=True, window=64, block_q=pt_att.BLOCK_Q,
        block_k=pt_att.BLOCK_K)
    np.testing.assert_allclose(o.numpy(), np.asarray(o_ref), atol=1e-5)
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref), atol=1e-5)
    # the same call through the wrapper, at the (B, H, S, D) layout of
    # layers.attention: head_dim 256 in f32 takes the CUDA-core route, in
    # bf16 the head_dim-256 wgmma route at 128 x 64 blocks
    qt, kt, vt = (torch.from_numpy(a)[None] for a in (q, k, v))
    assert pt_att.flash_fwd_route(qt, kt, vt) == "flash_fwd_simt"
    assert pt_att.flash_fwd_route(*(t.bfloat16() for t in (qt, kt, vt))) \
        == "flash_fwd_d256"
    assert pt_att.flash_fwd_blocks("flash_fwd_d256") == (128, 64)
    got = pt_ops.flash_attention(qt, kt, vt, causal=True, window=64)
    np.testing.assert_allclose(got[0].numpy(), np.asarray(o_ref), atol=1e-5)


def test_init_params_match_reference_leaves():
    want = jax.tree.map(np.asarray, ref_get_bundle(ARCH, smoke=True)
                        .init_params(jax.random.PRNGKey(0)))
    got = pt_get_bundle(ARCH, smoke=True).init_params(0, device="cpu")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert str(flat_g[k].dtype).split(".")[-1] == str(w.dtype), k


def test_engine_tokens_equal_reference(models):
    """Five prompts of 10-100 tokens (some past the 64-token window) on 2
    slots, then 8 greedy tokens: each admission writes its conv / LRU
    states into the pooled cache at batch axis 2.  The smoke model's
    RG-LRU forgets fast (a ~ 2e-4), so tokens alone barely see a state
    written to the wrong slot: the two engines' pooled caches must agree
    too, entry by entry, after the run."""
    rp = models[1]
    rng = np.random.default_rng(5)
    prompts = [rng.integers(0, 256, int(m)).astype(np.int32)
               for m in (12, 90, 40, 70, 100)]

    def serve(build, **kw):
        engine, _ = build(ARCH, slots=2, max_len=128, max_new=8, **kw)
        for p in prompts:
            engine.submit(p)
        return engine.run(), engine._dense_cache

    want, want_cache = serve(ref_serve.build_engine)
    got, got_cache = serve(pt_serve.build_engine,
                           params=from_jax_params(
                               jax.tree.map(np.asarray, rp)),
                           device="cpu")
    assert got == want
    assert all(len(v) == 8 for v in got.values())
    assert sorted(got_cache) == sorted(want_cache)
    for k in want_cache:
        _close(got_cache[k], want_cache[k])
