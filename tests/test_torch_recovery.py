"""The port's recovery loop (``repro_torch.launch.train.run``) at qwen3-4b
smoke on the CPU, through the reference's chaos scenarios
(``tests/test_chaos.py``, ``tests/test_system.py``), which the reference's
own loop cannot run on this jax (its mesh path raises): kill -> restart
resumes bit for bit, a corrupt newest checkpoint falls back, a NaN burst
is skipped, a silent host is evicted and the loop re-meshes, a full disk
costs a recovery point, a guard rollback restores a checkpoint, and the
loss falls.  Then the cross-package resume: the reference's
``make_train_step`` under plain ``jax.jit`` trains 2 steps, its state is
written by the reference's ``save_checkpoint``, and the port's loop
resumes from it within 1e-5 relative of the reference's own steps 2-3 (the
tolerance of ``tests/test_torch_train.py``).  Exact comparisons are exact:
losses as floats, states by ``tree_fingerprint``."""
import json
import os
import subprocess
import sys

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint as ref_ckpt  # noqa: E402
from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.data import DataConfig as RefDataConfig  # noqa: E402
from repro.data import SyntheticLM as RefSyntheticLM  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.training import TrainHyper as RefTrainHyper  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa
import repro_torch.obs as obs  # noqa: E402
from repro_torch.checkpoint import latest_step, verified_steps  # noqa: E402
from repro_torch.launch.train import run  # noqa: E402
from repro_torch.runtime import (KILL_EXIT_CODE, ChaosInjector,  # noqa: E402
                                 ChaosKilled, tree_fingerprint)
from repro_torch.training import GuardPolicy  # noqa: E402

ARCH = "qwen3-4b"
TRAIN_KW = dict(smoke=True, seq_len=32, global_batch=4, log_every=1000,
                device="cpu")
ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# The monitor judges stragglers by the step times the loop reports, which
# are host wall-clock seconds: a silenced peer's last time stays in the
# median, so a step slowed by the checkpoint writer (or a busy test host)
# can strike host 0 itself.  The silence scenarios test the heartbeat
# timeout on the virtual clock, so they switch the straggler verdict off.
STRAGGLER_OFF = 1e9


def _state(out):
    return {"params": out["params"], "opt": out["opt"]}


def test_kill_restart_bit_identical_resume(tmp_path):
    """An uninterrupted 8-step run and a run killed entering step 6 (after
    the step-4 save) then restarted give the same losses from step 4 on,
    bitwise, and the same final state (params, moments, step)."""
    full = run(ARCH, steps=8, **TRAIN_KW)
    kill_dir = str(tmp_path)
    with pytest.raises(ChaosKilled) as ei:
        run(ARCH, steps=8, ckpt_every=4, ckpt_dir=kill_dir,
            chaos=["kill@6"], **TRAIN_KW)
    assert ei.value.code == KILL_EXIT_CODE == 43
    assert latest_step(kill_dir) == 4              # newest committed save
    resumed = run(ARCH, steps=4, ckpt_every=4, ckpt_dir=kill_dir,
                  **TRAIN_KW)
    assert resumed["steps"] == list(range(4, 8))
    assert resumed["losses"] == full["losses"][4:]  # bitwise, not approx
    assert int(resumed["opt"]["step"]) == 8
    assert tree_fingerprint(_state(resumed)) == tree_fingerprint(_state(full))
    assert verified_steps(kill_dir) == [4, 8]       # the final save


def test_corrupt_checkpoint_restart_falls_back(tmp_path):
    """corrupt@8 damages the step-8 save as it lands; the restart's
    restore detects the CRC mismatch and resumes from step 4."""
    ckpt = str(tmp_path)
    run(ARCH, steps=8, ckpt_every=4, ckpt_dir=ckpt, chaos=["corrupt@8"],
        **TRAIN_KW)
    assert latest_step(ckpt) == 8                  # manifest committed...
    assert verified_steps(ckpt) == [4]             # ...but CRC rejects it
    out = run(ARCH, steps=2, ckpt_every=100, ckpt_dir=ckpt, **TRAIN_KW)
    assert out["steps"] == [4, 5]                  # fell back past step 8


def test_nan_injection_skips_update_and_stays_finite():
    out = run(ARCH, steps=8, chaos=["nan@3"], **TRAIN_KW)
    assert [e for e in out["events"] if e["kind"] == "skip"] == [
        {"kind": "skip", "step": 3}]
    assert all(np.isfinite(out["losses"])) and len(out["losses"]) == 8
    assert [m["finite"] for m in out["metrics"]] == [1.0] * 3 + [0.0] + \
        [1.0] * 4
    assert int(out["opt"]["step"]) == 7            # the skip did not count


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_silenced_host_evicted_and_loop_remeshes(tmp_path, with_ckpt):
    """silence@3:host=1 on a simulated 2-host fleet: the monitor evicts
    the dark host at step 6, the loop re-plans over the survivor and runs
    to the end.  With a checkpoint it restores the step-4 save; without
    one, and only then, it logs ``rollback_unavailable``."""
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=4) if with_ckpt else {}
    out = run(ARCH, steps=10, n_hosts=2, hb_timeout_steps=3.0,
              straggler_factor=STRAGGLER_OFF, chaos=["silence@3:host=1"],
              **kw, **TRAIN_KW)
    remesh = [e for e in out["events"] if e["kind"] == "remesh"]
    assert len(remesh) == 1 and remesh[0]["step"] == 6
    assert remesh[0]["failed"] == [1] and remesh[0]["survivors"] == [0]
    assert remesh[0]["plan"]["n_hosts"] == 1
    assert out["steps"][-1] == 9 and all(np.isfinite(out["losses"]))
    kinds = [e["kind"] for e in out["events"]]
    if with_ckpt:
        assert "rollback_unavailable" not in kinds
        assert {"kind": "restore", "step": 6, "restored_step": 4,
                "reason": "host failure"} in out["events"]
        assert out["steps"] == list(range(7)) + list(range(4, 10))
    else:
        assert kinds.count("rollback_unavailable") == 1
        assert out["steps"] == list(range(7)) + list(range(6, 10))


def test_diskfull_costs_a_recovery_point_not_the_run(tmp_path):
    ckpt = str(tmp_path)
    out = run(ARCH, steps=8, ckpt_every=2, ckpt_dir=ckpt,
              chaos=["diskfull@4"], **TRAIN_KW)
    fails = [e for e in out["events"] if e["kind"] == "ckpt_save_failed"]
    assert len(fails) == 1 and "disk full" in fails[0]["error"]
    steps = verified_steps(ckpt)
    assert 4 not in steps and 8 in steps           # the run went on


class _NanOnce(ChaosInjector):
    """NaN grads on the first visit of steps 5 and 6 only, so a rollback
    that replays them trains through (a spec is step-indexed and would
    fire again on the replay)."""

    def __init__(self):
        super().__init__([])
        self.seen = set()

    def grad_scale(self, step):
        first = step not in self.seen
        self.seen.add(step)
        return float("nan") if first and step in (5, 6) else 1.0


@pytest.mark.parametrize("with_ckpt", [False, True])
def test_guard_rollback_restores_a_checkpoint(tmp_path, with_ckpt):
    """Two NaN steps past a skip budget of 1: the guard rolls back.  With a
    checkpoint the loop restores the step-4 save and replays from there;
    without one it keeps the guarded state (``rollback_unavailable``), as
    the port did before it had checkpoints."""
    kw = dict(ckpt_dir=str(tmp_path), ckpt_every=4) if with_ckpt else {}
    out = run(ARCH, steps=8, chaos=_NanOnce(),
              guard_policy=GuardPolicy(max_consecutive_skips=1), **kw,
              **TRAIN_KW)
    kinds = [e["kind"] for e in out["events"]]
    if with_ckpt:
        assert "rollback_unavailable" not in kinds
        assert {"kind": "restore", "step": 6, "restored_step": 4,
                "reason": "divergence"} in out["events"]
        assert out["steps"] == list(range(7)) + list(range(4, 8))
        assert int(out["opt"]["step"]) == 8        # 0-3, then 4-7 replayed
    else:
        assert kinds.count("rollback_unavailable") == 1
        assert out["steps"] == list(range(7)) + list(range(6, 8))
        assert int(out["opt"]["step"]) == 7        # 5 and 6 skipped once
    assert all(np.isfinite(out["losses"]))


def test_train_loss_decreases(tmp_path):
    """As the reference's ``tests/test_system.py`` asserts of its loop."""
    out = run(ARCH, steps=15, seq_len=64, global_batch=4,
              ckpt_dir=str(tmp_path), ckpt_every=50, lr=1e-3,
              log_every=100, device="cpu")
    losses = out["losses"]
    assert np.mean(losses[-3:]) < np.mean(losses[:3]), losses


def test_port_resumes_the_references_checkpoint(tmp_path):
    """The reference trains 2 steps (``make_train_step`` under plain
    ``jax.jit``, the launcher's schedule for a 4-step horizon) and saves;
    the port's loop restores step 2 and its steps 2-3 give the reference's
    own losses within 1e-5 relative."""
    rb = ref_get_bundle(ARCH, smoke=True)
    params = rb.init_params(jax.random.PRNGKey(0))
    opt = ref_adamw_init(params)
    step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
        optimizer=RefAdamWConfig(lr=3e-4, warmup_steps=5, total_steps=10))))
    data = RefSyntheticLM(RefDataConfig(vocab=rb.cfg.vocab, seq_len=32,
                                        global_batch=4))
    losses = []
    for i in range(4):
        if i == 2:
            ref_ckpt.save_checkpoint(str(tmp_path), 2,
                                     {"params": params, "opt": opt})
        params, opt, m = step(params, opt, data.batch(i, 0, 4),
                              np.float32(1.0))
        losses.append(float(m["loss"]))
    out = run(ARCH, steps=2, ckpt_dir=str(tmp_path), ckpt_every=100,
              **TRAIN_KW)
    assert out["steps"] == [2, 3]
    np.testing.assert_allclose(out["losses"], losses[2:], rtol=1e-5)
    assert int(out["opt"]["step"]) == 4


def _cli(*args, timeout=180):
    env = dict(os.environ, PYTHONPATH=os.path.join(ROOT, "src"))
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "8", "--seq-len", "32", "--global-batch",
           "4", "--device", "cpu", *args]
    return subprocess.run(cmd, capture_output=True, text=True, env=env,
                          timeout=timeout)


def test_chaos_kill_exits_43_from_cli(tmp_path):
    """kill@6 exits the launcher with status 43, after diskfull@4 failed
    a save: that failure is logged, not fatal."""
    p = _cli("--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
             "--chaos", "diskfull@4", "--chaos", "kill@6")
    assert p.returncode == 43, p.stderr
    assert "disk full" in p.stdout
    assert latest_step(str(tmp_path)) == 6


def test_kill_survives_a_pending_save_error(tmp_path):
    """The step-6 save fails on the writer thread and kill@6 fires before
    anything waited on it: the preemption grace's wait must not let that
    OSError displace the kill (exit 43 is a restart harness's signal)."""
    with pytest.raises(ChaosKilled):
        run(ARCH, steps=8, ckpt_every=2, ckpt_dir=str(tmp_path),
            chaos=["diskfull@6", "kill@6"], **TRAIN_KW)
    assert verified_steps(str(tmp_path)) == [2, 4]


def _replay(tmp_path, tag):
    obs.REGISTRY.reset()
    trace = tmp_path / f"trace_{tag}.json"
    try:
        out = run(ARCH, steps=6, ckpt_dir=str(tmp_path / f"ckpt_{tag}"),
                  ckpt_every=4, n_hosts=2, hb_timeout_steps=2.0,
                  straggler_factor=STRAGGLER_OFF,
                  chaos=["nan@1", "silence@2:host=1"],
                  trace_out=str(trace),
                  metrics_out=str(tmp_path / f"m_{tag}.json"), **TRAIN_KW)
    finally:
        obs.set_telemetry(None)
    with open(trace) as f:
        return out, json.load(f)


def test_chaos_replay_trace_and_counters_deterministic(tmp_path):
    """Two replays of one chaos scenario give the same counters and the
    same trace timeline, timestamps included (spans run on the per-step
    virtual clock): RUN, REMESH and RESTORE spans, the chaos instants and
    the guard's skip."""
    out1, doc1 = _replay(tmp_path, "a")
    out2, doc2 = _replay(tmp_path, "b")
    assert out1["telemetry"]["counters"] == out2["telemetry"]["counters"]
    c = out1["telemetry"]["counters"]
    assert c["gradguard_events{kind=skip,trigger=nonfinite}"] == 1
    assert c["checkpoint_ops{op=save}"] >= 1

    def timeline(doc):
        return [(e["name"], e["ph"], e["ts"], e.get("dur"),
                 json.dumps(e["args"], sort_keys=True))
                for e in doc["traceEvents"] if e["ph"] in ("X", "i")]

    assert timeline(doc1) == timeline(doc2)
    names = {e["name"] for e in doc1["traceEvents"]}
    assert {"RUN", "REMESH", "RESTORE", "chaos", "guard_skip"} <= names
    assert run(ARCH, steps=1, **TRAIN_KW)["telemetry"] is None
