"""The port's Mamba-2 (kind ``ssm``) against the reference on mamba2-370m's
smoke config (f32, CPU): the same converted weights give forward logits
and prefill + decode logits within atol 1e-4 (rtol 0, as
``test_torch_configs.py``); the chunked SSD scan equals the reference's
within 1e-5 at a length the chunk does not divide, and its backward stays
finite where unmasked exponents would overflow (the reference's PR 2 fix);
``init_params`` draws the reference's leaves; and the port's engine serves
the reference engine's greedy tokens exactly (exact-length prefill: a
padded prompt would corrupt the SSM state)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import mamba2 as ref_mamba2  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.models import mamba2 as pt_mamba2  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "mamba2-370m"
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


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


def test_bundle_is_the_reference_bundle(models):
    rb, _, pb, _ = models
    assert (pb.kind, pb.sub_quadratic) == ("ssm", True) == \
        (rb.kind, rb.sub_quadratic)
    assert not pb.prefill_supports_true_lengths
    assert not pb.supports_paged_kv
    assert pt_mamba2.CACHE_BATCH_AXES == ref_mamba2.CACHE_BATCH_AXES


@pytest.mark.parametrize("S", [16, 40])
def test_forward_logits(models, S):
    """One chunk (16) and a length the chunk does not divide (40)."""
    rb, rp, pb, pp = models
    toks = _tokens(2, S)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, S, 256) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("S", [5, 37])
def test_prefill_then_decode(models, S):
    """Prefill leaves the conv window and the SSM state; four decode steps
    continue from them."""
    rb, rp, pb, pp = models
    B = 2
    toks = _tokens(B, S, seed=S)
    rc = rb.init_cache(B, 64)
    pc = pb.init_cache(B, 64, device="cpu")
    rl, rc = jax.jit(rb.prefill)(rp, jnp.asarray(toks), rc)
    pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc)
    _close(pl_, rl)
    for k in ("conv", "ssm"):
        _close(pc[k], rc[k])
    step = jax.jit(rb.decode_step)
    nxt = np.asarray([[3], [7]], np.int32)
    for _ in range(4):
        rl, rc = step(rp, jnp.asarray(nxt), rc)
        pl_, pc = pb.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl_, rl)
        nxt = np.asarray(rl[:, 0].argmax(-1))[:, None].astype(np.int32)
    assert pc["length"].tolist() == [S + 4] * B


def _ssd_inputs(B=2, L=50, H=3, P=4, N=5, dt_scale=1.0, seed=0):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(B, L, H, P)).astype(np.float32)
    dt = (dt_scale * rng.uniform(0.1, 1.0, (B, L, H))).astype(np.float32)
    A = -rng.uniform(0.5, 2.0, H).astype(np.float32)
    Bm = rng.normal(size=(B, L, N)).astype(np.float32)
    Cm = rng.normal(size=(B, L, N)).astype(np.float32)
    return x, dt, A, Bm, Cm


@pytest.mark.parametrize("chunk", [8, 16, 50])
def test_ssd_chunked_matches_reference(chunk):
    args = _ssd_inputs()
    want = ref_mamba2._ssd_chunked(*map(jnp.asarray, args), chunk)
    got = pt_mamba2._ssd_chunked(*map(torch.from_numpy, args), chunk)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)


def test_ssd_chunked_backward_is_finite():
    """Large steps make the non-causal log-decay sums exceed exp's f32
    range (~88): without the exponent mask the backward is NaN."""
    x, dt, A, Bm, Cm = map(torch.from_numpy, _ssd_inputs(dt_scale=60.0))
    dt.requires_grad_(True)
    y = pt_mamba2._ssd_chunked(x, dt, A, Bm, Cm, 16)
    y.square().sum().backward()
    assert torch.isfinite(y).all() and torch.isfinite(dt.grad).all()


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
    # the deterministic leaves equal the reference's
    for k in ("A_log", "dt_bias", "D_skip", "ln", "gnorm"):
        np.testing.assert_allclose(got["layers"][k].float().numpy(),
                                   want["layers"][k].astype(np.float32),
                                   rtol=1e-6)


def test_engine_tokens_equal_reference(models):
    rp = models[1]
    rng = np.random.default_rng(4)
    prompts = [rng.integers(0, 256, int(m)).astype(np.int32)
               for m in rng.integers(3, 40, 5)]

    def serve(build, **kw):
        engine, _ = build(ARCH, slots=2, max_len=64, max_new=6, **kw)
        for p in prompts:
            engine.submit(p)
        return engine.run()

    want = serve(ref_serve.build_engine)
    got = serve(pt_serve.build_engine,
                params=from_jax_params(jax.tree.map(np.asarray, rp)),
                device="cpu")
    assert got == want
    assert all(len(v) == 6 for v in got.values())
