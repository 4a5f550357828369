"""The port's training slice for the model zoo (internvl2-26b, vlm;
recurrentgemma-9b, hybrid; whisper-medium, audio; mamba2-370m, ssm) on
their smoke configs (f32, CPU), against the reference on shared converted
weights: ``make_train_step`` under plain ``jax.jit`` with no mesh, zero
extras made with numpy, and ``attn_impl="pallas"`` on both sides where the
config attends (the reference's flash kernels in interpret mode, the
port's FlashAttention with its plain halves).  Tolerances as
``test_torch_train.py``: loss, ce, grad_norm and lr within 1e-5 relative;
params and moments within atol 1e-5 (f32, sums in another order).  The
per-layer recompute leaves the grads bit for bit as they are without it;
the launcher's zero extras and its losses; the vlm's loss over the text
positions only."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402
from torch.utils.checkpoint import checkpoint  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.training import TrainHyper as RefTrainHyper  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.data import DataConfig, make_train_iterator  # noqa: E402
from repro_torch.launch.train import make_extras, run  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.training import (TrainHyper, loss_fn,  # noqa: E402
                                  make_train_step)
from repro_torch.weights import from_jax_params  # noqa: E402

FAMILIES = ("internvl2-26b", "recurrentgemma-9b", "whisper-medium",
            "mamba2-370m")
RTOL = 1e-5
ATOL = 1e-5
OPT = dict(warmup_steps=5, total_steps=10)


def _pallas(bundle):
    """The bundle with the flash kernels forced where its config attends."""
    if not hasattr(bundle.cfg, "attn_impl"):
        return bundle
    return dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, attn_impl="pallas"))


@pytest.fixture(scope="module", params=FAMILIES)
def family(request):
    arch = request.param
    rb = _pallas(ref_get_bundle(arch, smoke=True))
    rp = rb.init_params(jax.random.PRNGKey(0))
    pb = _pallas(pt_get_bundle(arch, smoke=True))
    return arch, rb, rp, pb, jax.tree.map(np.asarray, rp)


def _np_extras(bundle, B):
    """The reference launcher's zero extras, made with numpy."""
    cfg = bundle.cfg
    if bundle.kind == "audio":
        return {"frames": np.zeros((B, cfg.n_audio_ctx, cfg.d_model),
                                   np.float32)}
    if bundle.kind == "vlm":
        return {"vision": np.zeros((B, cfg.vision_tokens, cfg.d_model),
                                   np.float32)}
    return {}


def _batches(bundle, n, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, bundle.cfg.vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:],
                    **_np_extras(bundle, B)})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
            torch.from_numpy(v) for k, v in b.items()}


def _leaves_close(got, want):
    got = tree_leaves(got)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(family, microbatches):
    """Three steps, metrics, params and moments after each."""
    arch, rb, rp, pb, host = family
    ref_step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
        optimizer=RefAdamWConfig(**OPT), microbatches=microbatches)))
    pt_step = make_train_step(pb.forward, TrainHyper(
        optimizer=AdamWConfig(**OPT), microbatches=microbatches))
    ropt = ref_adamw_init(rp)
    pp = from_jax_params(host)
    popt = adamw_init(pp)
    rp_i = rp
    for i, b in enumerate(_batches(pb, 3, seed=microbatches)):
        rp_i, ropt, rm = ref_step(rp_i, ropt, b, np.float32(1.0))
        pp, popt, pm = pt_step(pp, popt, _torch_batch(b), 1.0)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=RTOL, err_msg=f"{arch} {key}")
        assert float(pm["finite"]) == 1.0 and float(pm["aux"]) == 0.0
        _leaves_close(pp, rp_i)
        _leaves_close(popt["mu"], ropt["mu"])
        _leaves_close(popt["nu"], ropt["nu"])
        assert int(popt["step"]) == int(ropt["step"]) == i + 1


def test_recompute_leaves_grads_bit_identical(family, monkeypatch):
    """The grads of one batch under per-layer recompute (``remat_call``'s
    ``torch.utils.checkpoint``) equal those without it (``checkpoint``
    patched to a plain call), bit for bit (f32, CPU); the first run
    checkpoints each of the reference's units once."""
    arch, _, _, pb, host = family
    batch = _torch_batch(_batches(pb, 1, seed=5)[0])
    grads, calls = {}, []

    def counted(fn, *args, use_reentrant):
        calls.append(fn)
        return checkpoint(fn, *args, use_reentrant=use_reentrant)

    for remat in (True, False):
        monkeypatch.setattr(pt_layers, "checkpoint", counted if remat else
                            lambda fn, *args, use_reentrant: fn(*args))
        params = from_jax_params(host)
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        loss, _ = loss_fn(pb.forward, params, batch)
        grads[remat] = (loss.detach(), torch.autograd.grad(loss, leaves))
    # the reference's units: a (rec, rec, attn) group or a tail layer;
    # an encoder or a decoder layer; a layer
    cfg = pb.cfg
    units = (cfg.n_groups + cfg.n_tail_rec if pb.kind == "hybrid" else
             cfg.n_layers * (2 if pb.kind == "audio" else 1))
    assert len(calls) == units
    (la, ga), (lb, gb) = grads[True], grads[False]
    assert torch.equal(la, lb)
    assert len(ga) == len(gb) and all(torch.equal(a, b)
                                      for a, b in zip(ga, gb)), arch


def test_launcher_extras_are_the_references(family):
    """``make_extras`` gives the reference launcher's zero extras: the
    same keys, shapes and dtype, on the device asked for."""
    _, rb, _, pb, _ = family
    got = make_extras(pb, 3, "cpu")
    want = _np_extras(rb, 3)
    assert sorted(got) == sorted(want)
    for k, w in want.items():
        assert got[k].dtype == torch.float32 and got[k].device.type == "cpu"
        assert tuple(got[k].shape) == w.shape and not got[k].any()


def test_launcher_losses_equal_driving_the_step(family):
    """``run(arch, smoke=True, device="cpu", steps=2)`` trains the family:
    its losses equal those of ``make_train_step`` driven directly on the
    same stream's batches with the launcher's extras and schedule."""
    arch = family[0]
    pb = pt_get_bundle(arch, smoke=True)      # the launcher's own bundle
    kw = dict(seq_len=32, global_batch=4)
    out = run(arch, smoke=True, steps=2, log_every=10, device="cpu", **kw)
    assert out["steps"] == [0, 1] and out["events"] == []
    assert all(m["finite"] == 1.0 for m in out["metrics"])
    params = pb.init_params(0, device="cpu")
    opt = adamw_init(params)
    step = make_train_step(pb.forward, TrainHyper(optimizer=AdamWConfig(
        lr=3e-4, **OPT)))
    it = make_train_iterator(DataConfig(vocab=pb.cfg.vocab, **kw))
    extras = make_extras(pb, kw["global_batch"], "cpu")
    losses = []
    try:
        for i in range(2):
            idx, b = it.next()
            assert idx == i
            b = {**{k: torch.from_numpy(v).long() for k, v in b.items()},
                 **extras}
            params, opt, m = step(params, opt, b)
            losses.append(float(m["loss"]))
    finally:
        it.close()
    assert out["losses"] == losses and all(np.isfinite(losses))
    assert int(out["opt"]["step"]) == 2


def test_vlm_loss_covers_the_text_positions_only():
    """internvl2's logits span the vision prefix and the text; ``ce`` is
    the cross-entropy of the last T positions (the text) against the
    labels, as the reference's ``loss_fn`` takes them, and differs from
    one over the first T."""
    pb = _pallas(pt_get_bundle("internvl2-26b", smoke=True))
    params = pb.init_params(0, device="cpu")
    b = _torch_batch(_batches(pb, 1, seed=11)[0])
    P, T = pb.cfg.vision_tokens, b["labels"].shape[1]
    with torch.no_grad():
        logits, _ = pb.forward(params, b)
        _, (ce, _) = loss_fn(pb.forward, params, b)
    assert logits.shape[:2] == (2, P + T)

    def by_hand(lg):
        logp = torch.log_softmax(lg.float(), dim=-1)
        return -logp.gather(-1, b["labels"][..., None])[..., 0].mean()

    torch.testing.assert_close(ce, by_hand(logits[:, P:]), rtol=1e-6,
                               atol=0)
    assert not torch.allclose(ce, by_hand(logits[:, :T]), rtol=1e-3)
