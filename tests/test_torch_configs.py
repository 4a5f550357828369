"""The port's transformer configs beyond qwen3-4b against the reference's:
parameter counts at full width for every ported arch id; the dense smoke
bundles that differ from qwen3-4b only in fields the port already had
(qwen2.5-14b: QKV bias; yi-9b: plain GQA; qwen1.5-32b: MHA with QKV bias
and an int8 decode cache) through forward and prefill + decode (atol 1e-4,
as ``test_torch_model.py``); and one MoE train step on olmoe smoke, aux
term included (within 1e-5, as ``test_torch_train.py``)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.training import TrainHyper as RefTrainHyper  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa
from repro_torch.configs import ARCH_IDS  # noqa: E402
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.training import TrainHyper, make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ATOL = 1e-4
DENSE = ("qwen2.5-14b", "yi-9b", "qwen1.5-32b")


def test_registry_is_the_reference_order():
    assert ARCH_IDS == ("qwen3-4b", "qwen2.5-14b", "qwen1.5-32b", "yi-9b",
                        "granite-moe-3b-a800m", "olmoe-1b-7b")


@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_counts_equal_reference_at_full_width(arch):
    rb, pb = ref_get_bundle(arch), pt_get_bundle(arch)
    assert pb.kind == rb.kind
    assert pb.param_count() == rb.param_count()
    assert pb.active_param_count() == rb.active_param_count()
    assert pb.extras == rb.extras
    assert (pb.kv_dtype_decode is None) == (rb.kv_dtype_decode is None)


def _models(arch):
    rb = ref_get_bundle(arch, smoke=True)
    rp = rb.init_params(jax.random.PRNGKey(0))
    pb = pt_get_bundle(arch, smoke=True)
    return rb, rp, pb, from_jax_params(jax.tree.map(np.asarray, rp))


def _close(got, want, atol=ATOL):
    np.testing.assert_allclose(got.detach().float().numpy(),
                               np.asarray(want, np.float32), atol=atol,
                               rtol=0)


def _tokens(B, S, seed=0):
    return np.random.default_rng(seed).integers(0, 256, (B, S)) \
        .astype(np.int32)


@pytest.mark.parametrize("arch", DENSE)
def test_dense_forward_logits(arch):
    rb, rp, pb, pp = _models(arch)
    toks = _tokens(2, 24)
    want, _ = jax.jit(rb.forward)(rp, {"tokens": jnp.asarray(toks)})
    got, aux = pb.forward(pp, {"tokens": torch.from_numpy(toks).long()})
    assert got.shape == (2, 24, 256) and aux == 0.0
    _close(got, want)


@pytest.mark.parametrize("arch,kv", [(a, "f32") for a in DENSE] +
                         [("qwen1.5-32b", "decode")])
def test_dense_prefill_then_decode(arch, kv):
    """A right-padded bucket with true lengths, then two decode steps;
    ``decode`` caches in the bundle's ``kv_dtype_decode`` (int8)."""
    rb, rp, pb, pp = _models(arch)
    kv_ref = rb.kv_dtype_decode if kv == "decode" else None
    kv_pt = pb.kv_dtype_decode if kv == "decode" else None
    assert (kv_ref is None) == (kv_pt is None)
    B, S, max_len = 2, 16, 32
    toks = _tokens(B, S, seed=1)
    true = np.asarray([11, 16], np.int32)
    rc = rb.init_cache(B, max_len, kv_dtype=kv_ref)
    pc = pb.init_cache(B, max_len, kv_dtype=kv_pt, device="cpu")
    assert pc["k"].dtype == (torch.int8 if kv_pt is not None
                             else torch.float32)
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


@pytest.mark.parametrize("microbatches", [1, 2])
def test_moe_train_step_matches_reference(microbatches):
    """Two AdamW steps of olmoe smoke through ``make_train_step`` on both
    sides (``attn_impl="pallas"``: the reference's flash kernels in
    interpret mode, the port's plain halves): loss, ce, aux, grad norm and
    lr within 1e-5 relative, params and moments within atol 1e-5.  The aux
    loss (weight 0.01) leaves each layer through the port's per-layer
    checkpoint, and its gradient comes back through it."""
    arch = "olmoe-1b-7b"
    rb = ref_get_bundle(arch, smoke=True)
    rb = dataclasses.replace(rb, cfg=dataclasses.replace(rb.cfg,
                                                         attn_impl="pallas"))
    pb = pt_get_bundle(arch, smoke=True)
    pb = dataclasses.replace(pb, cfg=dataclasses.replace(pb.cfg,
                                                         attn_impl="pallas"))
    rp = rb.init_params(jax.random.PRNGKey(0))
    pp = from_jax_params(jax.tree.map(np.asarray, rp))
    opt_cfg = dict(warmup_steps=5, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
        optimizer=RefAdamWConfig(**opt_cfg), microbatches=microbatches)))
    pt_step = make_train_step(pb.forward, TrainHyper(
        optimizer=AdamWConfig(**opt_cfg), microbatches=microbatches))
    ropt, popt = ref_adamw_init(rp), adamw_init(pp)
    rng = np.random.default_rng(microbatches)
    for i in range(2):
        t = rng.integers(0, 256, (2, 33)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        rp, ropt, rm = ref_step(rp, ropt, b, np.float32(1.0))
        pp, popt, pm = pt_step(pp, popt, {k: torch.from_numpy(v).long()
                                          for k, v in b.items()}, 1.0)
        for key in ("loss", "ce", "aux", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=1e-5, err_msg=key)
        assert float(pm["finite"]) == 1.0 and float(pm["aux"]) > 0.0
        for tree_p, tree_r in ((pp, rp), (popt["mu"], ropt["mu"]),
                               (popt["nu"], ropt["nu"])):
            got, want = tree_leaves(tree_p), jax.tree.leaves(tree_r)
            assert len(got) == len(want)
            for g, w in zip(got, want):
                np.testing.assert_allclose(g.numpy(), np.asarray(w),
                                           atol=1e-5, rtol=0)
