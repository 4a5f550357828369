"""The port's internvl2-26b backbone (kind ``vlm``: the transformer with a
stub vision prefix) against the reference on its smoke config (f32, CPU):
the same converted weights and the same numpy ``vision`` embeddings give
forward logits and prefill + decode logits within atol 1e-4 (rtol 0, as
``test_torch_configs.py``), with and without the bucketed prefill whose
``true_lengths`` the bundle shifts by the prefix; the leaves ``init_params``
draws; and the port's engine serves the reference engine's greedy tokens
exactly, its zero vision extras bound by the launcher."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "internvl2-26b"
ATOL = 1e-4


@pytest.fixture(scope="module")
def models():
    rb = ref_get_bundle(ARCH, smoke=True)
    rp = rb.init_params(jax.random.PRNGKey(0))
    pb = pt_get_bundle(ARCH, smoke=True)
    return rb, rp, pb, from_jax_params(jax.tree.map(np.asarray, rp))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _inputs(B, S, P, D, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    vision = rng.normal(0, 1, (B, P, D)).astype(np.float32)
    return toks, vision


def test_bundle_is_the_reference_bundle(models):
    rb, _, pb, _ = models
    assert (pb.kind, pb.cfg.vision_tokens) == ("vlm", rb.cfg.vision_tokens)
    assert pb.prefill_supports_true_lengths and \
        rb.prefill_supports_true_lengths
    assert not pb.supports_paged_kv and not rb.supports_paged_kv


def test_forward_logits(models):
    rb, rp, pb, pp = models
    P, D = pb.cfg.vision_tokens, pb.cfg.d_model
    toks, vision = _inputs(2, 24, P, D)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks),
                                       "vision": jnp.asarray(vision)})
    got, aux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long(),
                               "vision": torch.from_numpy(vision)})
    assert got.shape == (2, P + 24, 256) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("bucketed", [False, True])
def test_prefill_then_decode(models, bucketed):
    """The prompt (after the 8-token prefix) through prefill — right-padded
    to a bucket with true lengths 11 and 16 when ``bucketed`` — then three
    decode steps."""
    rb, rp, pb, pp = models
    P, D = pb.cfg.vision_tokens, pb.cfg.d_model
    B, S, max_len = 2, 16, 32
    toks, vision = _inputs(B, S, P, D, seed=1)
    true = np.asarray([11, 16], np.int32)
    rc = rb.init_cache(B, max_len)
    pc = pb.init_cache(B, max_len, device="cpu")
    rx = {"vision": jnp.asarray(vision)}
    px = {"vision": torch.from_numpy(vision)}
    if bucketed:
        rl, rc = jax.jit(lambda p, t, c, tl: rb.prefill(
            p, t, c, batch_extras=rx, true_lengths=tl))(
            rp, jnp.asarray(toks), rc, jnp.asarray(true))
        pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc,
                             batch_extras=px,
                             true_lengths=torch.from_numpy(true))
        assert pc["length"].tolist() == (true + P).tolist()
    else:
        rl, rc = jax.jit(lambda p, t, c: rb.prefill(p, t, c,
                                                    batch_extras=rx))(
            rp, jnp.asarray(toks), rc)
        pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc,
                             batch_extras=px)
        assert pc["length"].tolist() == [P + S] * B
    _close(pl_, rl)
    step = jax.jit(rb.decode_step)
    nxt = np.asarray([[3], [7]], np.int32)
    for _ in range(3):
        rl, rc = step(rp, jnp.asarray(nxt), rc)
        pl_, pc = pb.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl_, rl)
        nxt = np.asarray(rl[:, 0].argmax(-1))[:, None].astype(np.int32)


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


def _prompts(n, lo, hi, seed):
    rng = np.random.default_rng(seed)
    return [rng.integers(0, 256, int(m)).astype(np.int32)
            for m in rng.integers(lo, hi + 1, n)]


@pytest.mark.parametrize("slots", [1, 2])
def test_engine_tokens_equal_reference(models, slots):
    """Five prompts of 3-30 tokens, each prefilled in its power-of-two
    bucket behind the 8-token prefix, then six greedy tokens."""
    rp = models[1]
    prompts = _prompts(5, 3, 30, seed=slots)

    def serve(build, **kw):
        engine, _ = build(ARCH, slots=slots, max_len=64, max_new=6, **kw)
        for p in prompts:
            engine.submit(p)
        return engine.run()

    want = serve(ref_serve.build_engine)
    got = serve(pt_serve.build_engine,
                params=from_jax_params(jax.tree.map(np.asarray, rp)),
                device="cpu")
    assert got == want
    assert all(len(v) == 6 for v in got.values())


def test_paged_modes_refuse_the_vision_prefix():
    with pytest.raises(ValueError, match="paged"):
        pt_serve.build_engine(ARCH, kv_mode="paged", device="cpu")
