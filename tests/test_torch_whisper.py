"""The port's Whisper encoder-decoder (kind ``audio``) against the
reference on whisper-medium's smoke config (f32, CPU): the same converted
weights and the same numpy ``frames`` give encoder outputs, forward logits
and prefill + decode logits within atol 1e-4 (rtol 0, as
``test_torch_configs.py``), the prefill's cross K/V over all frames
included; ``layer_norm``, ``gelu_mlp`` and the sinusoidal table equal the
reference's in f32; ``init_params`` draws the reference's nested leaves;
and the port's engine, its zero ``frames`` extras bound by the launcher,
serves the reference engine's greedy tokens exactly."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.models import whisper as ref_whisper  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import whisper as pt_whisper  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "whisper-medium"
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


def _inputs(cfg, B, S, seed=0):
    rng = np.random.default_rng(seed)
    toks = rng.integers(0, 256, (B, S)).astype(np.int32)
    frames = rng.normal(0, 1, (B, cfg.n_audio_ctx, cfg.d_model)) \
        .astype(np.float32)
    return toks, frames


def test_bundle_is_the_reference_bundle(models):
    rb, _, pb, _ = models
    assert pb.kind == rb.kind == "audio"
    assert not pb.prefill_supports_true_lengths
    assert not rb.prefill_supports_true_lengths
    assert not pb.supports_paged_kv
    assert pt_whisper.CACHE_BATCH_AXES == ref_whisper.CACHE_BATCH_AXES
    with pytest.raises(ValueError, match="true_lengths"):
        pb.prefill(None, None, None, true_lengths=torch.ones(1))


def test_encoder_matches_reference(models):
    rb, rp, pb, pp = models
    _, frames = _inputs(pb.cfg, 2, 1)
    want = ref_whisper.encode(rb.cfg, rp, jnp.asarray(frames))
    got = pt_whisper.encode(pb.cfg, pp, torch.from_numpy(frames))
    _close(got, want)


@pytest.mark.parametrize("S", [24, 64, 80])
def test_forward_logits(models, S):
    """S 80 runs past max_text_ctx 64: the learned positions wrap, as the
    reference's modulo does."""
    rb, rp, pb, pp = models
    toks, frames = _inputs(pb.cfg, 2, S)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks),
                                       "frames": jnp.asarray(frames)})
    got, aux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long(),
                               "frames": torch.from_numpy(frames)})
    assert got.shape == (2, S, 256) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("S", [1, 13])
def test_prefill_then_decode(models, S):
    rb, rp, pb, pp = models
    B, max_len = 2, 32
    toks, frames = _inputs(pb.cfg, B, S, seed=S)
    rc = rb.init_cache(B, max_len)
    pc = pb.init_cache(B, max_len, device="cpu")
    assert {k: tuple(v.shape) for k, v in pc.items()} == \
        {k: v.shape for k, v in rc.items()}
    rx = {"frames": jnp.asarray(frames)}
    px = {"frames": torch.from_numpy(frames)}
    rl, rc = jax.jit(lambda p, t, c: rb.prefill(p, t, c,
                                                batch_extras=rx))(
        rp, jnp.asarray(toks), rc)
    pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc,
                         batch_extras=px)
    _close(pl_, rl)
    for k in ("xk", "xv"):
        _close(pc[k], rc[k])
    step = jax.jit(rb.decode_step)
    nxt = np.asarray([[3], [7]], np.int32)
    for _ in range(4):
        rl, rc = step(rp, jnp.asarray(nxt), rc)
        pl_, pc = pb.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl_, rl)
        nxt = np.asarray(rl[:, 0].argmax(-1))[:, None].astype(np.int32)
    _close(pc["k"][:, :, :S + 4], rc["k"][:, :, :S + 4])


def test_layer_norm_gelu_mlp_and_sinusoidal_match_reference():
    rng = np.random.default_rng(0)
    x = rng.normal(1.0, 3.0, (3, 5, 16)).astype(np.float32)
    w, b = rng.normal(size=16).astype(np.float32), \
        rng.normal(size=16).astype(np.float32)
    np.testing.assert_allclose(
        pt_layers.layer_norm(*map(torch.from_numpy, (x, w, b))).numpy(),
        np.asarray(ref_layers.layer_norm(*map(jnp.asarray, (x, w, b)))),
        atol=1e-5, rtol=0)
    w1 = rng.normal(0, 0.5, (16, 24)).astype(np.float32)
    b1 = rng.normal(size=24).astype(np.float32)
    w2 = rng.normal(0, 0.5, (24, 16)).astype(np.float32)
    b2 = rng.normal(size=16).astype(np.float32)
    args = (x, w1, b1, w2, b2)
    np.testing.assert_allclose(
        pt_layers.gelu_mlp(*map(torch.from_numpy, args)).numpy(),
        np.asarray(ref_layers.gelu_mlp(*map(jnp.asarray, args))),
        atol=1e-5, rtol=0)
    np.testing.assert_allclose(
        pt_whisper._sinusoidal(32, 64, "cpu").numpy(),
        np.asarray(ref_whisper._sinusoidal(32, 64)), atol=1e-6, rtol=0)
    # full width: angles reach 1,499 rad, where one f32 ulp is 1.2e-4 and
    # the two libraries' pow and sin may round the last bits apart; allow
    # 4 ulps of the largest angle
    np.testing.assert_allclose(
        pt_whisper._sinusoidal(1500, 1024, "cpu").numpy(),
        np.asarray(ref_whisper._sinusoidal(1500, 1024)),
        atol=4 * np.spacing(np.float32(1499)), rtol=0)


def test_init_params_match_reference_leaves():
    want = jax.tree.map(np.asarray, ref_get_bundle(ARCH, smoke=True)
                        .init_params(jax.random.PRNGKey(0)))
    got = pt_get_bundle(ARCH, smoke=True).init_params(0, device="cpu")
    flat_w = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(want)[0]}
    flat_g = {jax.tree_util.keystr(k): v for k, v in
              jax.tree_util.tree_flatten_with_path(got)[0]}
    assert sorted(flat_g) == sorted(flat_w)
    assert "['dec']['cross']['wq']" in flat_g
    for k, w in flat_w.items():
        assert tuple(flat_g[k].shape) == w.shape, k
        assert str(flat_g[k].dtype).split(".")[-1] == str(w.dtype), k


@pytest.mark.parametrize("slots", [1, 3])
def test_engine_tokens_equal_reference(models, slots):
    rp = models[1]
    rng = np.random.default_rng(slots)
    prompts = [rng.integers(0, 256, int(m)).astype(np.int32)
               for m in rng.integers(1, 40, 5)]

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
