"""The port's serving engine against the reference engine: same converted
weights, same prompts -> identical greedy tokens, in every KV mode, with
the prefix cache on and off (qwen3-4b smoke, f32, CPU)."""
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-4b"


def _params():
    p = ref_get_bundle(ARCH, smoke=True).init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


def _prompts(vocab=256, n=5, seed=3, prefix_len=16):
    """Prompts sharing a 16-token prefix (two pages at page_size 8) with
    random suffixes of uneven length."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, prefix_len)
    return [np.concatenate([common, rng.integers(0, vocab, int(n_))])
            .astype(np.int32) for n_ in rng.integers(3, 12, n)]


def _serve(build, prompts, **kw):
    engine, _ = build(ARCH, slots=2, max_len=64, max_new=6, page_size=8,
                      **kw)
    for p in prompts:
        engine.submit(p)
    return engine.run(), engine


@pytest.fixture(scope="module")
def weights():
    return _params()


@pytest.mark.parametrize("kv_mode,prefix_cache", [
    ("dense", False), ("paged", True), ("paged", False),
    ("paged_int8", True), ("paged_int8", False)])
def test_engine_tokens_equal_reference(weights, kv_mode, prefix_cache):
    prompts = _prompts()
    ref, _ = _serve(ref_serve.build_engine, prompts, kv_mode=kv_mode,
                    prefix_cache=prefix_cache)
    got, eng = _serve(pt_serve.build_engine, prompts, kv_mode=kv_mode,
                      prefix_cache=prefix_cache,
                      params=from_jax_params(weights), device="cpu")
    assert got == ref
    assert all(len(v) == 6 for v in got.values())
    if kv_mode != "dense":
        eng.check_kv()
        if prefix_cache:
            assert eng.prefix_stats()["hits"] >= 3


def test_cow_divergence_and_stream_match_reference(weights):
    """A prompt diverging mid-page from a cached one goes through
    copy-on-write in both engines, and the port's token streams equal the
    reference's batch results."""
    rng = np.random.default_rng(13)
    common = rng.integers(0, 256, 16)
    a = np.concatenate([common, rng.integers(0, 256, 6)]).astype(np.int32)
    b = np.concatenate([common[:10], rng.integers(0, 256, 8)]) \
        .astype(np.int32)

    def serve(build, **kw):
        engine, _ = build(ARCH, slots=2, max_len=64, max_new=6,
                          kv_mode="paged", page_size=8, **kw)
        engine.submit(a)
        engine.run()
        rid = engine.submit(b)
        return list(engine.stream(rid)), engine

    ref, ref_eng = serve(ref_serve.build_engine)
    got, eng = serve(pt_serve.build_engine,
                     params=from_jax_params(weights), device="cpu")
    assert got == ref
    assert eng.cow_copies == ref_eng.cow_copies >= 1
    eng.check_kv()


def test_launcher_run_matches_reference():
    """The launcher's seeded run (its own random init from the seed) serves
    every request to full length; the request trace is the reference's."""
    res = pt_serve.run(ARCH, n_requests=3, slots=2, prompt_len=10,
                       max_new=4, max_len=32, kv_mode="paged",
                       prefix_share=0.5, device="cpu")
    assert sorted(res) == [0, 1, 2]
    assert all(len(v) == 4 for v in res.values())
    ref_trace = ref_serve.fleet_trace(256, n_requests=3, prompt_len=10,
                                      prefix_share=0.5, seed=0)
    got_trace = pt_serve.fleet_trace(256, n_requests=3, prompt_len=10,
                                     prefix_share=0.5, seed=0)
    for r, g in zip(ref_trace, got_trace):
        np.testing.assert_array_equal(r, g)
