"""The port's chaos injector, heartbeat monitor, elastic plan and tree
fingerprint (``repro_torch.runtime``) against the reference's
(``repro.runtime``), on the same inputs: every decision and every damaged
byte must be equal, exactly (both are integer and string logic, and the
fingerprint a CRC)."""
import dataclasses
import errno
import os

import pytest

torch = pytest.importorskip("torch")

import ml_dtypes  # noqa: E402
import numpy as np  # noqa: E402

from repro.runtime import chaos as ref_chaos  # noqa: E402
from repro.runtime import fault as ref_fault  # noqa: E402
from repro.runtime.fleet import tree_fingerprint as ref_fingerprint  # noqa
from repro_torch.runtime import chaos, fault  # noqa: E402
from repro_torch.runtime import tree_fingerprint  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

SPECS = ["kill@12", "kill@5:host=1", "silence@3:host=2,duration=5",
         "slow@4:factor=8.0", "slow@2:host=2,factor=4.0,duration=3",
         "corrupt@8:mode=truncate", "corrupt@4", "nan@5", "nan@3:duration=2",
         "sigkill@9:host=2", "sigkill@9", "partition@4:host=1,duration=6",
         "partition@4", "diskfull@3", "die@7:host=2", "netsplit@2",
         "netsplit@3:host=0,duration=2", "pagecorrupt@6", " kill @4"]
BAD = ["kill", "kill@", "boom@3", "kill@3:wat=1", "kill@3:host", "@3",
       "nan@x", "slow@2:factor=fast"]

# (specs, seed) scenarios the injector grid walks
SCENARIOS = [
    (["nan@3:duration=2", "silence@5:host=1",
      "slow@2:host=2,factor=4.0,duration=3"], 0),
    (["kill@7", "corrupt@4:mode=truncate", "diskfull@6"], 1),
    (["kill@5:host=1", "partition@3:host=2,duration=2", "sigkill@4"], 2),
    (["die@2:host=1", "netsplit@3:host=2,duration=2", "pagecorrupt@4",
      "pagecorrupt@6", "slow@1:host=3,factor=2.5"], 3),
    (["silence@0:host=0", "nan@0:duration=100", "slow@0:host=1",
      "slow@1:host=1,factor=3.0"], 7),
]


def _outcome(fn):
    """What a fault point did: its value, or the exception it raised."""
    try:
        v = fn()
    except SystemExit as e:
        return ("exit", type(e).__name__, e.code, getattr(e, "step", None),
                str(e))
    except OSError as e:
        return ("oserror", e.errno, str(e))
    if isinstance(v, float) and np.isnan(v):
        return "nan"
    return v


@pytest.mark.parametrize("text", SPECS)
def test_parse_chaos_equals_reference(text):
    a, b = ref_chaos.parse_chaos(text), chaos.parse_chaos(text)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)
    assert a.active(a.step) == b.active(b.step)


@pytest.mark.parametrize("text", BAD)
def test_parse_chaos_rejects_what_the_reference_rejects(text):
    with pytest.raises(ValueError) as ra:
        ref_chaos.parse_chaos(text)
    with pytest.raises(ValueError) as pa:
        chaos.parse_chaos(text)
    assert str(ra.value) == str(pa.value)


def test_split_spec_strings_and_constants_equal_reference():
    specs = ["sigkill@7:host=1", "kill@3", "nan@2", "sigkill@2",
             "diskfull@4"]
    assert chaos.split_spec_strings(specs) == \
        ref_chaos.split_spec_strings(specs)
    assert chaos.KILL_EXIT_CODE == ref_chaos.KILL_EXIT_CODE == 43
    assert chaos.KINDS == ref_chaos.KINDS
    assert chaos.SUPERVISOR_KINDS == ref_chaos.SUPERVISOR_KINDS
    k = chaos.ChaosKilled(7)
    assert isinstance(k, SystemExit) and k.code == 43 and k.step == 7
    assert str(k) == str(ref_chaos.ChaosKilled(7))


@pytest.mark.parametrize("specs,seed", SCENARIOS)
def test_injector_decisions_equal_reference(specs, seed):
    """Every fault point over steps 0-12 and hosts 0-3 (ranks None, 0-3
    for kills): the same value or the same exception, and the same
    ``fired`` log in the same order."""
    ref = ref_chaos.ChaosInjector(specs, seed=seed)
    pt = chaos.ChaosInjector(specs, seed=seed)
    for step in range(13):
        for rank in (None, 0, 1, 2, 3):
            assert _outcome(lambda: pt.maybe_kill(step, rank=rank)) == \
                _outcome(lambda: ref.maybe_kill(step, rank=rank))
        assert _outcome(lambda: pt.checkpoint_write_hook(step)) == \
            _outcome(lambda: ref.checkpoint_write_hook(step))
        assert _outcome(lambda: pt.grad_scale(step)) == \
            _outcome(lambda: ref.grad_scale(step))
        assert pt.wants_corrupt(step) == ref.wants_corrupt(step)
        assert pt.corrupt_next_page(step) == ref.corrupt_next_page(step)
        for host in range(4):
            for name, args in (("partitioned", (step, host)),
                               ("heartbeat_silenced", (host, step)),
                               ("step_time_factor", (host, step)),
                               ("should_die", (step, host)),
                               ("netsplit_active", (step, host)),
                               ("maybe_die", (step, host))):
                a = _outcome(lambda: getattr(ref, name)(*args))
                b = _outcome(lambda: getattr(pt, name)(*args))
                assert a == b, (name, step, host)
    assert [dataclasses.asdict(s) for s in pt.supervisor_specs()] == \
        [dataclasses.asdict(s) for s in ref.supervisor_specs()]
    assert pt.fired == ref.fired and pt.fired


def test_diskfull_hook_raises_enospc_for_target_step_only():
    pt = chaos.ChaosInjector(["diskfull@4"])
    pt.checkpoint_write_hook(3)
    with pytest.raises(OSError) as ei:
        pt.checkpoint_write_hook(4)
    assert ei.value.errno == errno.ENOSPC and "diskfull@4" in pt.fired


def _shard(root, step, payload):
    d = os.path.join(root, f"step_{step:08d}")
    os.makedirs(d)
    with open(os.path.join(d, "shard_0.npz"), "wb") as f:
        f.write(payload)


@pytest.mark.parametrize("mode,seed", [("flip", 0), ("flip", 5),
                                       ("truncate", 0)])
def test_corrupt_checkpoint_damages_the_same_bytes(tmp_path, mode, seed):
    payload = np.random.default_rng(9).integers(
        0, 256, 10_007, dtype=np.uint8).tobytes()
    out = []
    for name, fn in (("ref", ref_chaos.corrupt_checkpoint),
                     ("pt", chaos.corrupt_checkpoint)):
        root = str(tmp_path / name)
        _shard(root, 8, payload)
        path = fn(root, 8, mode=mode, seed=seed)
        assert os.path.relpath(path, root) == os.path.join(
            "step_00000008", "shard_0.npz")
        with open(path, "rb") as f:
            out.append(f.read())
    assert out[0] == out[1] != payload
    # the injector's own hook damages as the function does
    root = str(tmp_path / "hook")
    _shard(root, 4, payload)
    inj = chaos.ChaosInjector([f"corrupt@4:mode={mode}"], seed=seed)
    inj.maybe_corrupt(root, 4)
    with open(os.path.join(root, "step_00000004", "shard_0.npz"), "rb") as f:
        assert f.read() == out[0]
    assert inj.fired == [f"corrupt@4:mode={mode}"]
    with pytest.raises(ValueError):
        chaos.corrupt_checkpoint(root, 4, mode="shred")


# ---------------------------------------------------------------------------
# heartbeat monitor, straggler policy, elastic plan
# ---------------------------------------------------------------------------

# scripted heartbeat sequences: per tick, {host: step time or None (a
# heartbeat without a time) }; a host absent from a tick is silent
def _two_host_straggler():
    return [{0: 1.0, 1: 10.0}] * 5


def _silence_then_straggle():
    ticks = []
    for t in range(14):
        beat = {0: 1.0, 1: 1.1, 2: 0.9 if t < 4 else None, 3: 1.0}
        if t >= 4:
            del beat[2]                      # host 2 goes dark at tick 4
        if t >= 6:
            beat[3] = 5.0                    # host 3 straggles from 6
        ticks.append(beat)
    return ticks


def _recovering_straggler():
    return [{0: 1.0, 1: 3.0, 2: 1.0}, {0: 1.0, 1: 3.0, 2: 1.0},
            {0: 1.0, 1: 1.0, 2: 1.0}, {0: 1.0, 1: 3.0, 2: None},
            {0: 1.0, 1: 3.0, 2: 1.2}, {0: 1.0, 1: 3.0, 2: 1.0},
            {0: 1.0, 1: 3.0, 2: 1.0}]


@pytest.mark.parametrize("hosts,script,policy", [
    ([0, 1], _two_host_straggler(),
     dict(heartbeat_timeout_s=100.0, straggler_factor=2.0, patience=3)),
    ([0, 1, 2, 3], _silence_then_straggle(),
     dict(heartbeat_timeout_s=3.0, straggler_factor=2.0, patience=3)),
    ([0, 1, 2], _recovering_straggler(),
     dict(heartbeat_timeout_s=2.0, straggler_factor=2.5, patience=2)),
], ids=["n2_straggler", "silence_then_straggle", "recovering"])
def test_heartbeat_monitor_equals_reference(hosts, script, policy):
    clocks = {"ref": [0.0], "pt": [0.0]}
    ref = ref_fault.HeartbeatMonitor(
        hosts, ref_fault.StragglerPolicy(**policy),
        clock=lambda: clocks["ref"][0])
    pt = fault.HeartbeatMonitor(hosts, fault.StragglerPolicy(**policy),
                                clock=lambda: clocks["pt"][0])
    failed = []
    for beats in script:
        for mon, key in ((ref, "ref"), (pt, "pt")):
            clocks[key][0] += 1.0
            for h, dt in beats.items():
                if mon.hosts[h].alive:
                    mon.heartbeat(h, dt)
        a, b = ref.check(), pt.check()
        assert a == b
        failed += a
        assert ref.alive_hosts() == pt.alive_hosts()
        assert [dataclasses.asdict(ref.hosts[h]) for h in hosts] == \
            [dataclasses.asdict(pt.hosts[h]) for h in hosts]
    assert failed                         # each script evicts someone
    if hosts == [0, 1]:
        # the n = 2 case: the fast host is judged against its peer only
        assert failed == [1] and pt.hosts[0].slow_strikes == 0


@pytest.mark.parametrize("env,kw", [
    ({"REPRO_HEARTBEAT_TIMEOUT": "9.5", "REPRO_STRAGGLER_PATIENCE": "7"},
     {}),
    ({"REPRO_HEARTBEAT_TIMEOUT": "9.5"}, {"heartbeat_timeout_s": 1.25}),
    ({"REPRO_STRAGGLER_FACTOR": ""}, {"patience": 2}),
    ({"REPRO_STRAGGLER_FACTOR": "3.5"}, {"straggler_factor": None}),
])
@pytest.mark.parametrize("with_default", [True, False])
def test_straggler_policy_from_env_equals_reference(monkeypatch, env, kw,
                                                    with_default):
    for name in ("REPRO_HEARTBEAT_TIMEOUT", "REPRO_STRAGGLER_FACTOR",
                 "REPRO_STRAGGLER_PATIENCE"):
        monkeypatch.delenv(name, raising=False)
    for k, v in env.items():
        monkeypatch.setenv(k, v)
    base = dict(heartbeat_timeout_s=4.0, straggler_factor=2.5, patience=3)
    a = ref_fault.StragglerPolicy.from_env(
        **kw, default=ref_fault.StragglerPolicy(**base)
        if with_default else None)
    b = fault.StragglerPolicy.from_env(
        **kw, default=fault.StragglerPolicy(**base) if with_default else None)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


@pytest.mark.parametrize("alive", [[0], [0, 2], [0, 1, 3], [1, 2, 4, 5, 7],
                                   list(range(8))])
@pytest.mark.parametrize("chips,mp", [(1, 1), (4, 2), (4, 8), (2, 1)])
def test_plan_elastic_remesh_equals_reference(alive, chips, mp):
    if len(alive) * chips < mp:
        with pytest.raises(AssertionError):
            ref_fault.plan_elastic_remesh(alive, chips_per_host=chips,
                                          model_parallel=mp)
        with pytest.raises(AssertionError):
            fault.plan_elastic_remesh(alive, chips_per_host=chips,
                                      model_parallel=mp)
        return
    a = ref_fault.plan_elastic_remesh(alive, chips_per_host=chips,
                                      model_parallel=mp)
    b = fault.plan_elastic_remesh(alive, chips_per_host=chips,
                                  model_parallel=mp)
    assert dataclasses.asdict(a) == dataclasses.asdict(b)


# ---------------------------------------------------------------------------
# tree fingerprint
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("dtype", [np.float32, ml_dtypes.bfloat16])
def test_tree_fingerprint_equals_reference(dtype):
    rng = np.random.default_rng(3)
    tree = {"params": {"w": rng.normal(size=(4, 3)).astype(dtype),
                       "layers": {"b": rng.normal(size=(2, 5)).astype(dtype)}},
            "opt": {"mu": {"w": rng.normal(size=(4, 3)).astype(np.float32)},
                    "step": np.array(5, np.int32)}}
    pt = from_jax_params(tree)
    assert tree_fingerprint(pt) == ref_fingerprint(tree)
    # one flipped word changes it
    if dtype == ml_dtypes.bfloat16:
        pt["params"]["w"].view(torch.int16)[0, 0] ^= 1
    else:
        pt["params"]["w"].view(torch.int32)[0, 0] ^= 1
    assert tree_fingerprint(pt) != ref_fingerprint(tree)
