"""The port's training slice (qwen3-4b smoke, f32, CPU) against the
reference's, on shared converted weights: ``make_train_step`` under plain
``jax.jit`` with no mesh and ``attn_impl="pallas"`` on both sides (the
reference's flash forward and backward kernels in interpret mode, the
port's FlashAttention with its plain halves), the nonfinite skip, the
GradGuard's actions, the synthetic data stream, and the launcher on the
CPU.  Tolerances: loss, ce, grad_norm and lr within 1e-5 relative; params
and moments within atol 1e-5 (f32, sums in another order)."""
import dataclasses

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
import torch  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.training import GradGuard as RefGradGuard  # noqa: E402
from repro.training import GuardPolicy as RefGuardPolicy  # noqa: E402
from repro.training import TrainHyper as RefTrainHyper  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa
from repro_torch.configs import get_bundle as pt_get_bundle  # noqa: E402
from repro_torch.data import DataConfig, SyntheticLM  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.training import (GradGuard, GuardPolicy,  # noqa: E402
                                  TrainHyper, make_train_step)
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-4b"
RTOL = 1e-5
ATOL = 1e-5


@pytest.fixture(scope="module")
def models():
    rb = ref_get_bundle(ARCH, smoke=True)
    rb = dataclasses.replace(rb, cfg=dataclasses.replace(rb.cfg,
                                                         attn_impl="pallas"))
    rp = rb.init_params(jax.random.PRNGKey(0))
    pb = pt_get_bundle(ARCH, smoke=True)
    pb = dataclasses.replace(pb, cfg=dataclasses.replace(pb.cfg,
                                                         attn_impl="pallas"))
    return rb, rp, pb, jax.tree.map(np.asarray, rp)


def _batches(n, B=2, S=32, seed=0):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, 256, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _torch_batch(b):
    return {k: torch.from_numpy(v).long() for k, v in b.items()}


def _leaves_close(got, want):
    got = tree_leaves(got)
    want = jax.tree.leaves(want)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=ATOL,
                                   rtol=0)


@pytest.mark.parametrize("microbatches", [1, 2])
def test_train_steps_match_reference(models, microbatches):
    """Three steps (the first one checked on its own), params and moments
    after each."""
    rb, rp, pb, host = models
    opt_cfg = dict(warmup_steps=5, total_steps=10)
    ref_step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
        optimizer=RefAdamWConfig(**opt_cfg), microbatches=microbatches)))
    pt_step = make_train_step(pb.forward, TrainHyper(
        optimizer=AdamWConfig(**opt_cfg), microbatches=microbatches))
    ropt = ref_adamw_init(rp)
    pp = from_jax_params(host)
    popt = adamw_init(pp)
    for i, b in enumerate(_batches(3, seed=microbatches)):
        rp_i, ropt, rm = ref_step(rp if i == 0 else rp_i, ropt, b,
                                  np.float32(1.0))
        pp, popt, pm = pt_step(pp, popt, _torch_batch(b), 1.0)
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                       rtol=RTOL, err_msg=key)
        assert float(pm["finite"]) == 1.0 and float(pm["aux"]) == 0.0
        _leaves_close(pp, rp_i)
        _leaves_close(popt["mu"], ropt["mu"])
        _leaves_close(popt["nu"], ropt["nu"])
        assert int(popt["step"]) == int(ropt["step"]) == i + 1


def test_nonfinite_step_leaves_state_byte_identical(models):
    _, _, pb, host = models
    step = make_train_step(pb.forward, TrainHyper(
        optimizer=AdamWConfig(warmup_steps=5, total_steps=10)))
    pp = from_jax_params(host)
    opt = adamw_init(pp)
    b0, b1 = map(_torch_batch, _batches(2, seed=7))
    pp, opt, _ = step(pp, opt, b0)          # non-zero moments first
    snap = [t.clone() for t in tree_leaves({"p": pp, "o": opt})]
    pp, opt, m = step(pp, opt, b1, float("nan"))
    assert float(m["finite"]) == 0.0 and not np.isfinite(
        float(m["grad_norm"]))
    after = tree_leaves({"p": pp, "o": opt})
    assert all(torch.equal(a, b) for a, b in zip(after, snap))
    assert int(opt["step"]) == 1


def test_gradguard_sequence_equals_reference():
    """The same (loss, finite) stream gives the same actions, triggers and
    EMA in both guards: warm-up, a NaN burst past the skip budget, a reset,
    and a sustained loss spike.  Each skip and rollback is counted in the
    port's own metrics registry."""
    from repro_torch.obs import REGISTRY
    kinds = (("skip", "nonfinite"), ("rollback", "skip_budget"),
             ("rollback", "loss_spike"))

    def counts():
        return [REGISTRY.get_counter("gradguard_events", kind=k, trigger=t)
                for k, t in kinds]
    before = counts()
    kw = dict(max_consecutive_skips=2, spike_factor=2.0, spike_patience=2,
              ema_beta=0.8, warmup_steps=3)
    ref, pt = RefGradGuard(RefGuardPolicy(**kw)), GradGuard(GuardPolicy(**kw))
    stream = ([(5.0, True), (4.8, True), (4.9, True), (4.7, True)]
              + [(float("nan"), False)] * 3
              + [(4.6, True), (4.5, True), (4.4, True), (4.4, True),
                 (20.0, True), (4.3, True), (30.0, True), (31.0, True),
                 (4.0, True), (float("inf"), True)])
    for n, (loss, finite) in enumerate(stream):
        a, b = ref.update(loss, finite), pt.update(loss, finite)
        assert a == b, (n, a, b)
        assert (ref.last_trigger, ref.ema, ref.consecutive_skips,
                ref.consecutive_spikes) == (pt.last_trigger, pt.ema,
                                            pt.consecutive_skips,
                                            pt.consecutive_spikes), n
        if a == "rollback":
            ref.reset()
            pt.reset()
    assert [x - y for x, y in zip(counts(), before)] == [3, 1, 1]


@pytest.mark.parametrize("vocab,seq_len,batch", [(256, 32, 4),
                                                 (151936, 64, 2)])
def test_synthetic_batches_equal_reference(vocab, seq_len, batch):
    ref = RefSyntheticLM(RefDataConfig(vocab=vocab, seq_len=seq_len,
                                       global_batch=batch, seed=3))
    pt = SyntheticLM(DataConfig(vocab=vocab, seq_len=seq_len,
                                global_batch=batch, seed=3))
    for index in (0, 1, 17):
        a, b = ref.batch(index, 0, batch), pt.batch(index, 0, batch)
        for key in ("tokens", "labels"):
            np.testing.assert_array_equal(a[key], b[key])


def test_launcher_trains_on_the_cpu():
    out = run(ARCH, smoke=True, steps=5, seq_len=32, global_batch=4,
              microbatches=2, log_every=10, device="cpu")
    assert out["steps"] == list(range(5)) and len(out["seconds"]) == 5
    assert all(np.isfinite(out["losses"]))
    assert all(m["finite"] == 1.0 for m in out["metrics"])
    assert out["events"] == [] and int(out["opt"]["step"]) == 5


def test_launcher_calls_on_step_after_each_step():
    """``on_step`` sees the weights, taken in place, after each step: they
    have moved from their start after the first step already."""
    params = pt_get_bundle(ARCH, smoke=True).init_params(0, device="cpu")
    start = {k: v.clone() for k, v in params["layers"].items()}
    seen = []

    def on_step(i, p, opt, m):
        moved = {k: not torch.equal(start[k], v)
                 for k, v in p["layers"].items()}
        seen.append((i, int(opt["step"]), all(moved.values()), m["finite"]))

    out = run(ARCH, smoke=True, steps=2, seq_len=32, global_batch=4,
              log_every=10, device="cpu", params=params, on_step=on_step)
    assert out["params"] is params
    assert seen == [(0, 1, True, 1.0), (1, 2, True, 1.0)]
