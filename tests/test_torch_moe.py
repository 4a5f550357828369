"""The port's top-k MoE layer and its MoE configs (olmoe-1b-7b and
granite-moe-3b-a800m smoke, f32, CPU) against the reference's, on the
same numpy inputs and converted weights: the routing (gate values and
probs within 1e-6 relative, indices equal, ties to the lower index), the
aux loss (1e-6), the local dispatch (outputs within 1e-5, aux 1e-6, the
same dropped assignments) at capacity factors 8.0 and 1.25, the model's
forward (logits atol 1e-5, aux 1e-5 relative), prefill / decode and
paged steps (atol 1e-4, as ``test_torch_model.py``: XLA and torch sum in
other orders over two layers), and the engines' greedy tokens in every KV
mode at both capacity factors."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.models import layers as ref_layers  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServingEngine as RefServingEngine  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.models import transformer as pt_transformer  # noqa: E402
from repro_torch.serving import ServeConfig, ServingEngine  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ATOL = 1e-4
MOE_ARCHS = ("olmoe-1b-7b", "granite-moe-3b-a800m")
CAPACITY = (8.0, 1.25)


def _rng(seed):
    return np.random.default_rng(seed)


# the router's logits have this std: within what the models' init gives
# (std 0.02 over rms-normed inputs: 0.16 at smoke width, 0.9 at olmoe's
# d 2048).  f32 logits of that size round the probs alike to within
# ~4e-7 relative on both sides; at std 1 they come within 9.3e-7 of 1e-6.
LOGIT_STD = 0.3


def _route_inputs(T, D, E, seed):
    rng = _rng(seed)
    xt = rng.normal(size=(T, D)).astype(np.float32)
    router = (rng.normal(size=(D, E)) * LOGIT_STD / np.sqrt(D)) \
        .astype(np.float32)
    return xt, router


def _ref_keep(gate_idx, E, C):
    """The reference's dropped-assignment rule (``_moe_local``'s lines),
    which it does not return."""
    T, K = gate_idx.shape
    onehot = jax.nn.one_hot(gate_idx, E, dtype=jnp.int32)
    flat = onehot.reshape(T * K, E)
    pos = ((jnp.cumsum(flat, axis=0) - flat).reshape(T, K, E)
           * onehot).sum(-1)
    return np.asarray(pos), np.asarray(pos < C)


@pytest.mark.parametrize("T,D,E,K", [(16, 32, 8, 2), (37, 48, 5, 2),
                                     (64, 64, 64, 8), (5, 16, 40, 8)])
def test_route_matches_reference(T, D, E, K):
    xt, router = _route_inputs(T, D, E, seed=T + E)
    rv, ri, rp = ref_layers._moe_route(jnp.asarray(xt), jnp.asarray(router),
                                       K)
    pv, pi, pp = pt_layers._moe_route(torch.from_numpy(xt),
                                      torch.from_numpy(router), K)
    np.testing.assert_array_equal(pi.numpy(), np.asarray(ri))
    np.testing.assert_allclose(pv.numpy(), np.asarray(rv), rtol=1e-6,
                               atol=0)
    np.testing.assert_allclose(pp.numpy(), np.asarray(rp), rtol=1e-6,
                               atol=0)


@pytest.mark.parametrize("E,K", [(8, 2), (64, 8), (40, 8)])
def test_route_breaks_ties_lower_index_first(E, K):
    """A zero router gives every expert 1/E; a router whose columns repeat
    in pairs ties each pair.  ``jax.lax.top_k`` takes the lower index
    first, and so must the port."""
    T, D = 6, 16
    xt, router = _route_inputs(T, D, E, seed=E)
    cases = {"zero": np.zeros_like(router),
             "pairs": np.repeat(router[:, :E // 2], 2, axis=1)}
    for name, r in cases.items():
        _, ri, _ = ref_layers._moe_route(jnp.asarray(xt), jnp.asarray(r), K)
        pv, pi, _ = pt_layers._moe_route(torch.from_numpy(xt),
                                         torch.from_numpy(r), K)
        np.testing.assert_array_equal(pi.numpy(), np.asarray(ri),
                                      err_msg=name)
    # the zero router's choice, pinned
    np.testing.assert_array_equal(
        pt_layers._moe_route(torch.from_numpy(xt),
                             torch.zeros((D, E)), K)[1].numpy(),
        np.broadcast_to(np.arange(K), (T, K)))


@pytest.mark.parametrize("T,E,K", [(16, 8, 2), (33, 64, 8), (4, 40, 8)])
def test_aux_matches_reference(T, E, K):
    xt, router = _route_inputs(T, 24, E, seed=3 * T)
    _, ri, rp = ref_layers._moe_route(jnp.asarray(xt), jnp.asarray(router),
                                      K)
    want = ref_layers._moe_aux(rp, ri, E, T, K)
    got = pt_layers._moe_aux(torch.from_numpy(np.array(rp)),
                             torch.from_numpy(np.array(ri)).long(), E, T, K)
    np.testing.assert_allclose(got.item(), float(want), rtol=1e-6)


def _moe_params(D, E, F, seed):
    rng = _rng(seed)
    return {"router": (rng.normal(size=(D, E)) * LOGIT_STD / np.sqrt(D))
            .astype(np.float32),
            "w_gate": (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            "w_up": (rng.normal(size=(E, D, F)) * 0.1).astype(np.float32),
            "w_down": (rng.normal(size=(E, F, D)) * 0.1).astype(np.float32)}


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("B,S,D,E,K,F", [
    (2, 12, 32, 8, 2, 48),       # olmoe smoke's expert shape
    (3, 7, 48, 5, 2, 64),        # granite smoke's
    (4, 1, 64, 64, 8, 32),       # a decode tick at olmoe's E and K: C = 1
    (2, 16, 32, 40, 8, 16),      # granite's E and K
])
def test_moe_local_matches_reference(B, S, D, E, K, F, capacity):
    """The local dispatch's output and aux, and its dropped assignments:
    none at capacity 8.0, some at 1.25 (where random routing overflows
    some experts), the same set in both."""
    cfg_kw = dict(n_experts=E, top_k=K, d_ff=F, capacity_factor=capacity)
    params = _moe_params(D, E, F, seed=B * S + E)
    x = _rng(B + S).normal(size=(B, S, D)).astype(np.float32)
    want, waux = ref_layers._moe_local(
        jnp.asarray(x), {k: jnp.asarray(v) for k, v in params.items()},
        ref_layers.MoEConfig(**cfg_kw))
    got, gaux = pt_layers.moe_layer(
        torch.from_numpy(x), {k: torch.from_numpy(v)
                              for k, v in params.items()},
        pt_layers.MoEConfig(**cfg_kw))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(gaux.item(), float(waux), rtol=1e-6)

    T = B * S
    C = max(1, int(capacity * T * K / E))
    _, ri, _ = ref_layers._moe_route(jnp.asarray(x.reshape(T, D)),
                                     jnp.asarray(params["router"]), K)
    rpos, rkeep = _ref_keep(ri, E, C)
    _, pi, _ = pt_layers._moe_route(torch.from_numpy(x.reshape(T, D)),
                                    torch.from_numpy(params["router"]), K)
    ppos, pkeep = pt_layers._moe_slots(pi, E, C)
    np.testing.assert_array_equal(ppos.numpy(), rpos)
    np.testing.assert_array_equal(pkeep.numpy(), rkeep)
    if capacity == 8.0:
        assert rkeep.all()
    else:
        assert not rkeep.all(), "the 1.25 case must drop assignments"


def test_trash_writes_carry_their_last_writers_value():
    """A paged step's colliding writes (every invalid token lands on trash
    page 0) each carry the value of the last write to the same slot, as an
    in-order scatter leaves it; live writes keep their own."""
    rng = _rng(11)
    B, T, page = 5, 7, 4
    phys = torch.from_numpy(rng.integers(0, 3, (B, T)))
    off = torch.from_numpy(rng.integers(0, page, (B, T)))
    src = pt_transformer._trash_last_writer(phys, off, page)
    flat_p, flat_o = phys.reshape(-1).tolist(), off.reshape(-1).tolist()
    want = []
    for i, (p_, o_) in enumerate(zip(flat_p, flat_o)):
        if p_ != 0:
            want.append(i)
        else:
            want.append(max(j for j, (q_, r_) in enumerate(zip(flat_p,
                                                               flat_o))
                            if q_ == 0 and r_ == o_))
    assert src.tolist() == want
    assert any(w != i for i, w in enumerate(want))


# ---------------------------------------------------------------------------
# the MoE smoke bundles: forward, serving steps, engines
# ---------------------------------------------------------------------------

def _bundles(arch, capacity=None):
    rb = ref_get_bundle(arch, smoke=True)
    pb = pt_get_bundle(arch, smoke=True)
    if capacity is not None:
        rb = dataclasses.replace(rb, cfg=dataclasses.replace(
            rb.cfg, moe=dataclasses.replace(rb.cfg.moe,
                                            capacity_factor=capacity)))
        pb = dataclasses.replace(pb, cfg=dataclasses.replace(
            pb.cfg, moe=dataclasses.replace(pb.cfg.moe,
                                            capacity_factor=capacity)))
    return rb, pb


@pytest.fixture(scope="module", params=MOE_ARCHS)
def models(request):
    rb, pb = _bundles(request.param)
    rp = rb.init_params(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, rp)
    return rb, rp, pb, from_jax_params(host), host


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _tokens(B, S, seed=0):
    return _rng(seed).integers(0, 256, (B, S)).astype(np.int32)


def test_forward_logits_and_aux(models):
    rb, rp, pb, pp, _ = models
    toks = _tokens(2, 24)
    want, waux = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, gaux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 24, 256)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-5,
                               rtol=0)
    np.testing.assert_allclose(float(gaux), float(waux), rtol=1e-5)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_prefill_then_decode(models, kv):
    rb, rp, pb, pp, _ = models
    B, S, max_len = 2, 16, 32
    toks = _tokens(B, S, seed=1)
    true = np.asarray([11, 16], np.int32)
    rc = rb.init_cache(B, max_len, kv_dtype=jnp.int8 if kv == "int8"
                       else None)
    pc = pb.init_cache(B, max_len, kv_dtype=torch.int8 if kv == "int8"
                       else None, device="cpu")
    rl, rc = jax.jit(lambda p, t, c, tl: rb.prefill(p, t, c,
                                                    true_lengths=tl))(
        rp, jnp.asarray(toks), rc, jnp.asarray(true))
    pl_, pc = pb.prefill(pp, torch.from_numpy(toks).long(), pc,
                         true_lengths=torch.from_numpy(true))
    _close(pl_, rl)
    step = jax.jit(rb.decode_step)
    nxt = np.asarray([[3], [7]], np.int32)
    for _ in range(2):
        rl, rc = step(rp, jnp.asarray(nxt), rc)
        pl_, pc = pb.decode_step(pp, torch.from_numpy(nxt).long(), pc)
        _close(pl_, rl)
        nxt = np.asarray(rl[:, 0].argmax(-1))[:, None].astype(np.int32)


@pytest.mark.parametrize("kv", ["f32", "int8"])
def test_paged_step_chunk_then_decode(models, kv):
    """A prefill chunk (T = 8, uneven counts, an idle row), then a T == 1
    step through the kernel path (its plain version here) and the gather
    path.  The idle row routes too: it shares the call's capacity."""
    rb, rp, pb, pp, _ = models
    B, P, page = 3, 12, 4
    rpool = rb.init_paged_pool(P, page, kv_dtype=jnp.int8 if kv == "int8"
                               else None)
    ppool = pb.init_paged_pool(P, page, kv_dtype=torch.int8 if kv == "int8"
                               else None, device="cpu")
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
    for b in range(B):
        _close(pl_[b, :counts[b]], rl[b, :counts[b]])
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


def _prompts(n=5, seed=3, prefix_len=16):
    """Prompts sharing a 16-token prefix with random suffixes of uneven
    length (``test_torch_serving.py``'s)."""
    rng = _rng(seed)
    common = rng.integers(0, 256, prefix_len)
    return [np.concatenate([common, rng.integers(0, 256, int(n_))])
            .astype(np.int32) for n_ in rng.integers(3, 12, n)]


@pytest.mark.parametrize("capacity", CAPACITY)
@pytest.mark.parametrize("kv_mode", ["dense", "paged", "paged_int8"])
@pytest.mark.parametrize("arch", MOE_ARCHS)
def test_engine_tokens_equal_reference(arch, kv_mode, capacity):
    """Both engines on one bundle (the smoke bundle, or its copy at
    capacity 1.25, where a decode tick's 2 slots x top 2 over E experts
    get C = 1 and collide) serve the same prompts to the same greedy
    tokens."""
    rb, pb = _bundles(arch, capacity)
    params = jax.tree.map(np.asarray, rb.init_params(jax.random.PRNGKey(0)))
    kw = dict(batch=2, max_len=64, max_new_tokens=6, kv_mode=kv_mode,
              page_size=8, prefill_chunk=32, prefix_cache=True)
    ref = RefServingEngine(ref_serve._BundleAdapter(rb), params,
                           RefServeConfig(**kw))
    eng = ServingEngine(pb, from_jax_params(params), ServeConfig(**kw),
                        device=torch.device("cpu"))
    prompts = _prompts()
    for e in (ref, eng):
        for p in prompts:
            e.submit(p)
    want, got = ref.run(), eng.run()
    assert got == want
    assert all(len(v) == 6 for v in got.values())
    if kv_mode != "dense":
        eng.check_kv()
