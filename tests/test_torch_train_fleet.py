"""The train side of the port's fleet against the reference's, on the CPU
(qwen3-4b smoke, f32): ``checkpoint.restore_checkpoint_striped`` on the
reference's files, the train launcher's worker mode and exit-43 contract,
and ``repro_torch.launch.supervisor`` driving real worker processes.

* Striped restore: on a checkpoint the reference wrote, the port's striped
  restore equals the reference's and the full restore bit for bit, at
  world 2 and 3, over the local and TCP exchanges, with the same read and
  stripe byte counters; bf16 leaves; a flipped byte raises on every rank
  and leaves ``like`` untouched; a missing peer raises
  ``StripeExchangeTimeout`` and the manager does not fall back.
* Supervised drills: both packages' fleets (2 workers, 8 steps, a
  checkpoint every 4) start from the same step-0 checkpoint, the
  reference's initial state, with and without ``kill@5``.  The reports
  agree on outcome, final checkpoint step and every tag's exit history
  and attempts; the port's kill run ends bit-identical to its baseline;
  its step-8 state is within 1e-5 relative (atol 1e-5) of the
  reference's, the train-step parity of ``tests/test_torch_train.py``.
  Then the port's striped gang restart to 12 steps and a ``--distributed
  torch`` (gloo) run.
* The command builders, and the three ``examples/*_torch.py``.
"""
import argparse
import contextlib
import json
import os
import shutil
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402

import repro.checkpoint as ref_ckpt  # noqa: E402
import repro.runtime as ref_runtime  # noqa: E402
from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import supervisor as ref_sup  # noqa: E402
from repro.obs import REGISTRY as REF_REGISTRY  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro_torch.checkpoint import (CheckpointCorruptError,  # noqa: E402
                                    CheckpointManager, restore_checkpoint,
                                    restore_checkpoint_striped,
                                    save_checkpoint)
from repro_torch.checkpoint.manager import _PartsReader  # noqa: E402
from repro_torch.launch import supervisor as pt_sup  # noqa: E402
from repro_torch.obs import REGISTRY  # noqa: E402
from repro_torch.runtime import (FleetWorker, LaunchSpec,  # noqa: E402
                                 LocalStripeExchange, StripeExchangeTimeout,
                                 TcpStripeExchange, allocate_ports,
                                 corrupt_checkpoint)
from repro_torch.weights import from_jax_params  # noqa: E402

ARCH = "qwen3-4b"
ROOT = Path(__file__).resolve().parents[1]
SRC = str(ROOT / "src")
RTOL = ATOL = 1e-5
SUBPROCESS_TIMEOUT = 300


def _env(**extra) -> dict:
    env = dict(os.environ, JAX_PLATFORMS="cpu", OMP_NUM_THREADS="2",
               **extra)
    env["PYTHONPATH"] = SRC + os.pathsep + env.get("PYTHONPATH", "")
    return env


@contextlib.contextmanager
def _worker_env():
    """The environment the supervisors hand their workers: this checkout's
    ``src`` first, the CPU for JAX, two threads a worker."""
    with pytest.MonkeyPatch.context() as mp:
        for k, v in _env().items():
            if os.environ.get(k) != v:
                mp.setenv(k, v)
        yield


def _ref_state() -> dict:
    """The reference launcher's initial train state of the smoke bundle
    (``init_params(PRNGKey(0))``, ``adamw_init``), as host arrays."""
    rb = ref_get_bundle(ARCH, smoke=True)
    params = rb.init_params(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray,
                        {"params": params, "opt": ref_adamw_init(params)})


def _like(host: dict) -> dict:
    """Port tensors shaped and typed like ``host``, filled with a sentinel
    (so a restore that copies nothing shows)."""
    like = from_jax_params(host)

    def fill(t):
        if isinstance(t, dict):
            for v in t.values():
                fill(v)
        else:
            t.fill_(7)
    fill(like)
    return like


def _leaves(tree, prefix=""):
    if isinstance(tree, dict):
        return [x for k in sorted(tree)
                for x in _leaves(tree[k], f"{prefix}/{k}")]
    return [(prefix, tree.numpy() if hasattr(tree, "numpy")
             else np.asarray(tree))]


def _threads(world, fn):
    out, errs = [None] * world, [None] * world

    def go(r):
        try:
            out[r] = fn(r)
        except Exception as e:           # surfaced to the test thread
            errs[r] = e
    ts = [threading.Thread(target=go, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out, errs


def _delta(registry, before: dict) -> dict:
    after = registry.snapshot()["counters"]
    return {k: after[k] - before.get(k, 0) for k in after
            if k.startswith(("checkpoint_read_bytes", "checkpoint_stripe",
                             "checkpoint_ops{op=restore_striped}",
                             "checkpoint_crc"))
            and after[k] != before.get(k, 0)}


# ---------------------------------------------------------------------------
# striped restore
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def ref_checkpoint(tmp_path_factory):
    path = str(tmp_path_factory.mktemp("ref-ckpt"))
    host = _ref_state()
    ref_ckpt.save_checkpoint(path, 3, host)
    return path, host


@pytest.mark.parametrize("transport", ["local", "tcp"])
@pytest.mark.parametrize("world", [2, 3])
def test_striped_restore_equals_reference(ref_checkpoint, world, transport):
    """Every rank's striped restore equals the reference's striped restore
    and the port's full restore, bit for bit, and the read and stripe
    byte counters move as the reference's do for the same file."""
    path, host = ref_checkpoint
    if transport == "local":
        shared = LocalStripeExchange(world)
        exchanges = [shared] * world
    else:
        ports = allocate_ports(world)
        exchanges = [TcpStripeExchange(r, ports, timeout_s=30)
                     for r in range(world)]
    likes = [_like(host) for _ in range(world)]
    before = REGISTRY.snapshot()["counters"]
    try:
        out, errs = _threads(world, lambda r: restore_checkpoint_striped(
            path, 3, likes[r], rank=r, world=world, exchange=exchanges[r]))
    finally:
        for ex in set(exchanges):
            ex.close()
    assert errs == [None] * world
    ours = _delta(REGISTRY, before)

    ref_ex = ref_runtime.LocalStripeExchange(world)
    ref_before = REF_REGISTRY.snapshot()["counters"]
    ref_out, ref_errs = _threads(world, lambda r: (
        ref_ckpt.restore_checkpoint_striped(path, 3, host, rank=r,
                                            world=world, exchange=ref_ex)))
    assert ref_errs == [None] * world
    assert ours == _delta(REF_REGISTRY, ref_before)
    assert ours["checkpoint_ops{op=restore_striped}"] == world
    assert ours["checkpoint_stripe_bytes{dir=recv}"] > 0

    full = restore_checkpoint(path, 3, _like(host))
    want = _leaves(full)
    for r in range(world):
        assert out[r] is likes[r]                 # restored in place
        for (p, got), (_, w), (_, ref) in zip(_leaves(out[r]), want,
                                              _leaves(ref_out[r])):
            assert got.dtype == w.dtype and got.shape == w.shape, p
            assert got.tobytes() == w.tobytes() == \
                np.ascontiguousarray(ref).tobytes(), p


def test_striped_restore_bf16_leaves(tmp_path):
    """bf16 leaves (the card's params) restore bit for bit."""
    gen = torch.Generator().manual_seed(0)
    tree = {"w": torch.randn(33, 70, generator=gen).bfloat16(),
            "m": torch.randn(33, 70, generator=gen),
            "step": torch.tensor(5, dtype=torch.int32)}
    save_checkpoint(str(tmp_path), 2, tree)
    ex = LocalStripeExchange(2)
    likes = [{k: torch.zeros_like(v) for k, v in tree.items()}
             for _ in range(2)]
    out, errs = _threads(2, lambda r: restore_checkpoint_striped(
        str(tmp_path), 2, likes[r], rank=r, world=2, exchange=ex))
    assert errs == [None, None]
    def bits(t):
        return t.view(torch.int16) if t.dtype == torch.bfloat16 else t
    for got in out:
        for k, v in tree.items():
            assert got[k].dtype == v.dtype
            assert torch.equal(bits(got[k]), bits(v)), k


def test_striped_restore_flipped_byte_raises_on_every_rank(tmp_path):
    """One flipped byte: every rank raises ``CheckpointCorruptError`` from
    the assembled CRC, counts a CRC failure, and leaves ``like`` as it
    was."""
    tree = {"w": torch.arange(4096, dtype=torch.float32)}
    save_checkpoint(str(tmp_path), 3, tree)
    corrupt_checkpoint(str(tmp_path), 3, mode="flip")
    ex = LocalStripeExchange(2)
    likes = [{"w": torch.full((4096,), 7.0)} for _ in range(2)]
    before = REGISTRY.snapshot()["counters"]
    out, errs = _threads(2, lambda r: restore_checkpoint_striped(
        str(tmp_path), 3, likes[r], rank=r, world=2, exchange=ex))
    assert out == [None, None]
    for e in errs:
        assert isinstance(e, CheckpointCorruptError), e
        assert "CRC32" in str(e)
    assert _delta(REGISTRY, before)["checkpoint_crc_failures"] == 2
    for like in likes:
        assert torch.equal(like["w"], torch.full((4096,), 7.0))


def test_striped_restore_missing_peer_times_out_without_fallback(tmp_path):
    """A peer that never arrives is an exchange timeout, never corruption:
    the manager propagates it instead of walking to the older intact
    step, and ``like`` is untouched."""
    assert issubclass(StripeExchangeTimeout, TimeoutError)
    assert not issubclass(StripeExchangeTimeout, CheckpointCorruptError)
    for step in (1, 2):
        save_checkpoint(str(tmp_path), step,
                        {"w": torch.full((64,), float(step))})
    like = {"w": torch.zeros(64)}
    ex = LocalStripeExchange(2, timeout_s=0.3)
    with pytest.raises(StripeExchangeTimeout, match="ranks \\[1\\]"):
        CheckpointManager(str(tmp_path)).restore(like, stripe=(0, 2, ex))
    assert torch.equal(like["w"], torch.zeros(64))
    ports = allocate_ports(2)
    tcp = TcpStripeExchange(0, ports, timeout_s=0.5)
    try:
        with pytest.raises(StripeExchangeTimeout, match="peer 1"):
            restore_checkpoint_striped(str(tmp_path), 2, like, rank=0,
                                       world=2, exchange=tcp)
    finally:
        tcp.close()
    assert torch.equal(like["w"], torch.zeros(64))


def test_parts_reader_is_the_joined_bytes():
    """The seekable view over stripes reads what the joined buffer holds,
    across part boundaries, from any position, as zipfile seeks it."""
    rng = np.random.default_rng(0)
    parts = [rng.bytes(n) for n in (5, 1, 0, 17, 9)]
    joined = b"".join(parts)
    f = _PartsReader([bytearray(p) for p in parts])
    assert f.seek(0, 2) == len(joined)
    for _ in range(200):
        pos = int(rng.integers(0, len(joined) + 2))
        n = int(rng.integers(-1, 12))
        f.seek(pos)
        assert f.read(n) == (joined[pos:] if n < 0 else
                             joined[pos:pos + n])
        assert f.tell() == (len(joined) if n < 0 else
                            max(pos, min(len(joined), pos + n)))
    f.seek(-3, 2)
    assert f.read() == joined[-3:]
    with pytest.raises(ValueError):
        f.seek(-1)


def test_tcp_exchange_serves_views_and_receives_whole_buffers():
    """A bytearray payload travels as it is (a view, no joined copy) and
    arrives as one buffer of exactly the announced length."""
    ports = allocate_ports(2)
    exs = [TcpStripeExchange(r, ports, timeout_s=20) for r in range(2)]
    payloads = [bytearray(os.urandom(3 << 20)), bytearray(b"peer")]
    try:
        out, errs = _threads(2, lambda r: exs[r].allgather("k", r, 2,
                                                           payloads[r]))
    finally:
        for ex in exs:
            ex.close()
    assert errs == [None, None]
    for r, got in enumerate(out):
        assert got[r] is payloads[r]
        assert type(got[1 - r]) is bytearray
        assert got[1 - r] == payloads[1 - r]


# ---------------------------------------------------------------------------
# the launcher's exit-43 contract
# ---------------------------------------------------------------------------

def _train_cli(*extra):
    cmd = [sys.executable, "-m", "repro_torch.launch.train", "--arch", ARCH,
           "--smoke", "--steps", "8", "--seq-len", "32",
           "--global-batch", "4", "--device", "cpu", *extra]
    return subprocess.run(cmd, capture_output=True, text=True, env=_env(),
                          timeout=SUBPROCESS_TIMEOUT)


@pytest.mark.parametrize("mode", ["single", "worker"])
def test_chaos_kill_exits_43_from_cli(tmp_path, mode):
    """The reference's two exit-43 CLI drills: ``kill@4`` in the
    single-process launcher; and, as fleet worker rank 0 (the rank that
    saves), ``diskfull@4`` leaves a failed async save pending when
    ``kill@6:host=0`` fires — the preemption grace's wait must not let
    that OSError displace the kill, as the supervisor keys its restart
    policy on status 43."""
    if mode == "single":
        p = _train_cli("--chaos", "kill@4")
    else:
        p = _train_cli("--ckpt-dir", str(tmp_path), "--ckpt-every", "2",
                       "--chaos", "diskfull@4", "--chaos", "kill@6:host=0",
                       "--process-id", "0", "--num-processes", "2",
                       "--fleet-dir", str(tmp_path / "fleet"))
        assert "disk full" in p.stdout
        assert (tmp_path / "fleet" / "hb" / "rank_0.json").is_file()
    assert p.returncode == 43, p.stderr


# ---------------------------------------------------------------------------
# heartbeats while checkpoint I/O blocks a worker's loop
# ---------------------------------------------------------------------------

def test_keep_alive_beats_only_while_the_block_runs(tmp_path, monkeypatch):
    from repro_torch.runtime import fleet as fleet_mod
    monkeypatch.setattr(fleet_mod, "KEEPALIVE_S", 0.02)
    fw = FleetWorker(process_id=1, num_processes=2, fleet_dir=str(tmp_path))
    beats = []
    fw.heartbeat = beats.append
    with fw.keep_alive(7):
        time.sleep(0.3)
    n = len(beats)
    time.sleep(0.1)
    assert n >= 3 and set(beats) == {7} and len(beats) == n


@pytest.mark.parametrize("partition", [False, True])
def test_worker_beats_through_blocking_saves(tmp_path, monkeypatch,
                                             partition):
    """Rank 0's saves block its loop (each ``save_async`` here sleeps
    first, as a full-width snapshot does): the worker beats from its
    keep-alive thread through every save, so the supervisor's hang
    detector sees a busy worker; under ``partition@0`` it stays quiet."""
    from repro_torch.launch import train
    from repro_torch.runtime import fleet as fleet_mod
    monkeypatch.setattr(fleet_mod, "KEEPALIVE_S", 0.02)
    save = CheckpointManager.save_async

    def slow_save(self, *a, **kw):
        time.sleep(0.3)
        return save(self, *a, **kw)
    beats = []
    monkeypatch.setattr(CheckpointManager, "save_async", slow_save)
    monkeypatch.setattr(FleetWorker, "heartbeat", lambda self, step: beats
                        .append((step, threading.current_thread().name)))
    fw = FleetWorker(process_id=0, num_processes=2,
                     fleet_dir=str(tmp_path / "fleet"))
    train.run(ARCH, steps=4, seq_len=32, global_batch=4, device="cpu",
              ckpt_dir=str(tmp_path / "ckpt"), ckpt_every=2,
              chaos=["partition@0:host=0"] if partition else None,
              fleet=fw)
    if partition:
        assert beats == []
    else:
        loop = [s for s, name in beats if name != "fleet-keepalive"]
        kept = {s for s, name in beats if name == "fleet-keepalive"}
        assert loop == [0, 1, 2, 3] and kept >= {1, 3}


# ---------------------------------------------------------------------------
# supervised drills: real workers of both packages
# ---------------------------------------------------------------------------

def _fleet_args(ckpt_dir, fleet_dir, report, steps=8, **kw):
    args = ["--nprocs", 2, "--arch", ARCH, "--steps", steps,
            "--seq-len", 32, "--global-batch", 4,
            "--ckpt-dir", ckpt_dir, "--ckpt-every", 4,
            "--fleet-dir", fleet_dir, "--report-out", report]
    for k, v in kw.items():
        args += [f"--{k.replace('_', '-')}", v]
    return [str(a) for a in args]


def _results(fleet_dir, tags=(0, 1)):
    out = {}
    for t in tags:
        with open(os.path.join(fleet_dir, f"result_rank{t}.json")) as f:
            out[t] = json.load(f)
    return out


def _metrics(fleet_dir, tag):
    with open(os.path.join(fleet_dir, f"metrics_rank{tag}.json")) as f:
        return json.load(f)["counters"]


def _run_fleet(root: Path, package: str, step0: str, **kw) -> dict:
    """One supervised fleet of ``package`` from a copy of the step-0
    checkpoint ``step0``; returns its dirs, return code and report."""
    ckpt, fleet = root / "ckpt", root / "fleet"
    shutil.copytree(step0, ckpt)
    report = root / "report.json"
    args = _fleet_args(ckpt, fleet, report, **kw)
    if package == "port":
        rc = pt_sup.main(args + ["--device", "cpu"])
    else:
        rc = ref_sup.main(args)
    with open(report) as f:
        rep = json.load(f)
    return {"ckpt": str(ckpt), "fleet": str(fleet), "rc": rc,
            "report": rep}


@pytest.fixture(scope="module")
def fleets(tmp_path_factory):
    """Both packages' fleets from the reference's initial state, written
    as a step-0 checkpoint, without and with ``kill@5``; each pair of
    fleets runs side by side."""
    root = tmp_path_factory.mktemp("fleets")
    step0 = str(root / "step0")
    ref_ckpt.save_checkpoint(step0, 0, _ref_state())
    runs = {}
    with _worker_env():
        for name, kw in (("baseline", {}), ("kill", {"chaos": "kill@5"})):
            out, errs = _threads(2, lambda i: _run_fleet(
                root / f"{('ref', 'port')[i]}-{name}",
                ("ref", "port")[i], step0, **kw))
            assert errs == [None, None], errs
            runs["ref", name], runs["port", name] = out
    return runs


@pytest.mark.parametrize("name", ["baseline", "kill"])
def test_fleet_reports_equal_reference(fleets, name):
    ref, ours = fleets["ref", name], fleets["port", name]
    assert ours["rc"] == ref["rc"] == 0
    for key in ("outcome", "final_checkpoint_step", "nprocs"):
        assert ours["report"][key] == ref["report"][key], key
    assert ours["report"]["outcome"] == "completed"
    assert ours["report"]["final_checkpoint_step"] == 8

    def tags(rep):
        return {w["tag"]: (w["exit_history"], w["attempts"], w["state"])
                for w in rep["workers"]}
    assert tags(ours["report"]) == tags(ref["report"])
    if name == "kill":
        assert tags(ours["report"])[1][:2] == ([43, 0], 2)
        assert tags(ours["report"])[0][:2] == ([0], 1)


def test_fleet_kill_restart_resumes_bit_identical(fleets):
    """Every rank of the killed-and-restarted fleet ends on the baseline's
    state, bit for bit (``params_crc``: params and moments)."""
    base = _results(fleets["port", "baseline"]["fleet"])
    want = base[0]["params_crc"]
    assert base[1]["params_crc"] == want
    for t, res in _results(fleets["port", "kill"]["fleet"]).items():
        assert res["params_crc"] == want, (t, res)
        assert res["device"] == "cpu"


def test_fleet_state_matches_reference(fleets):
    """The port's step-8 checkpoint within 1e-5 relative (atol 1e-5) of
    the reference fleet's, both read through the port's restore; the
    first losses agree as closely."""
    host = _ref_state()
    ours = restore_checkpoint(fleets["port", "baseline"]["ckpt"], 8,
                              _like(host))
    ref = restore_checkpoint(fleets["ref", "baseline"]["ckpt"], 8,
                             _like(host))
    for (p, got), (_, want) in zip(_leaves(ours), _leaves(ref)):
        if p == "/opt/step":
            assert int(got) == int(want) == 8
            continue
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL,
                                   err_msg=p)
    a = _results(fleets["port", "baseline"]["fleet"])[0]
    b = _results(fleets["ref", "baseline"]["fleet"])[0]
    np.testing.assert_allclose([a["first_loss"], a["final_loss"]],
                               [b["first_loss"], b["final_loss"]],
                               rtol=RTOL)


def test_fleet_striped_gang_restart(fleets, tmp_path):
    """A gang restart over the baseline's checkpoint with striped restore:
    each rank restores striped once, reads fewer checkpoint bytes than
    the shard holds and receives stripes from its peer, both resume at
    step 8 and end on equal states."""
    ckpt = str(tmp_path / "ckpt")
    shutil.copytree(fleets["port", "baseline"]["ckpt"], ckpt)
    shard = os.path.join(ckpt, "step_00000008", "shard_0.npz")
    full_bytes = os.path.getsize(shard)
    fleet = str(tmp_path / "fleet")
    with _worker_env():
        rc = pt_sup.main(_fleet_args(ckpt, fleet, tmp_path / "r.json",
                                     steps=12, striped_restore="always")
                         + ["--device", "cpu"])
    assert rc == 0
    for t in (0, 1):
        c = _metrics(fleet, t)
        assert c.get("checkpoint_ops{op=restore_striped}") == 1
        striped = c.get("checkpoint_read_bytes{mode=striped}", 0)
        assert 0 < striped < full_bytes, (t, striped, full_bytes)
        assert c.get("checkpoint_stripe_bytes{dir=recv}", 0) > 0
        assert "checkpoint_read_bytes{mode=full}" not in c
    res = _results(fleet)
    assert res[0]["start_step"] == res[1]["start_step"] == 8
    assert res[0]["params_crc"] == res[1]["params_crc"]


def test_fleet_distributed_torch(tmp_path):
    """``--distributed torch``: the two workers form one gloo group."""
    fleet = str(tmp_path / "fleet")
    with _worker_env():
        rc = pt_sup.main(_fleet_args(tmp_path / "ckpt", fleet,
                                     tmp_path / "r.json", steps=4,
                                     distributed="torch")
                         + ["--device", "cpu"])
    assert rc == 0
    res = _results(fleet)
    assert res[0]["params_crc"] == res[1]["params_crc"]
    for r in res.values():
        assert r["dist_ok"] is True and r["process_count"] == 2, r


# ---------------------------------------------------------------------------
# command builders
# ---------------------------------------------------------------------------

SPECS = [LaunchSpec(rank=0, world=2, tag=0, attempt=1, with_chaos=True,
                    striped=False),
         LaunchSpec(rank=1, world=2, tag=1, attempt=2, with_chaos=False,
                    striped=True, stripe_ports=(4001, 4002)),
         LaunchSpec(rank=0, world=1, tag=3, attempt=1, with_chaos=True,
                    striped=True)]


def _namespace(**kw):
    base = dict(arch=ARCH, steps=8, seq_len=32, global_batch=4,
                ckpt_dir="/ckpt", ckpt_every=4, smoke=True, chaos_seed=3,
                distributed="none", device=None)
    return argparse.Namespace(**{**base, **kw})


def _strip_device(argv):
    out = list(argv)
    if "--device" in out:
        i = out.index("--device")
        del out[i:i + 2]
    return out


@pytest.mark.parametrize("spec", SPECS, ids=["chaos", "striped", "solo"])
@pytest.mark.parametrize("opts", [
    {}, {"smoke": False, "ckpt_dir": None},
    {"distributed": "torch", "device": "cpu"}],
    ids=["smoke", "full", "dist"])
def test_command_builder_equals_reference(spec, opts):
    """The port's worker argv is the reference's but for the module, the
    process-group backend's name and ``--device``."""
    coord = "127.0.0.1:5000"
    chaos = ["kill@5", "diskfull@3"]
    ours = pt_sup.make_cmd_builder(_namespace(**opts), "/fleet", chaos,
                                   coord)(spec)
    ref_opts = dict(opts, distributed={"torch": "jax"}.get(
        opts.get("distributed"), "none"))
    ref_opts.pop("device", None)
    ref = ref_sup.make_cmd_builder(_namespace(**ref_opts), "/fleet", chaos,
                                   coord)(spec)
    assert ours[:3] == [sys.executable, "-m", "repro_torch.launch.train"]
    assert ref[:3] == [sys.executable, "-m", "repro.launch.train"]
    want = [{"jax": "torch"}.get(x, x) for x in ref[3:]]
    assert _strip_device(ours[3:]) == want
    if opts.get("device"):
        assert ours[-2:] == ["--device", opts["device"]]
    else:
        assert "--device" not in ours


# ---------------------------------------------------------------------------
# the examples
# ---------------------------------------------------------------------------

def _example(name, *args, env=None):
    p = subprocess.run([sys.executable, str(ROOT / "examples" / name),
                        *args], capture_output=True, text=True,
                       env=env or _env(), timeout=SUBPROCESS_TIMEOUT)
    assert p.returncode == 0, p.stderr[-3000:]
    return p.stdout.splitlines()


def test_quickstart_prints_the_references_schedule():
    ours = _example("quickstart_torch.py", "--device", "cpu")
    ref = _example("quickstart.py")
    assert ours[:4] == ref[:4]
    assert [ln.split(":")[0] for ln in ref[:4]] == \
        ["workload", "TEU tile", "exchange", "grid order (VMEM residency)"]
    assert ours[4].startswith("Hopper wgmma tile")
    assert ours[-1].endswith("done.")


def test_serve_lm_prints_the_references_tokens(tmp_path):
    """Given the reference's own initial weights (its launcher's
    ``init_params(PRNGKey(0))``, as a checkpoint), the port's example
    prints the reference example's greedy tokens exactly."""
    rb = ref_get_bundle(ARCH, smoke=True)
    ref_ckpt.save_checkpoint(str(tmp_path), 0, {"params": jax.tree.map(
        np.asarray, rb.init_params(jax.random.PRNGKey(0)))})
    ours = [ln for ln in _example("serve_lm_torch.py", "--device", "cpu",
                                  "--params", str(tmp_path))
            if ln.startswith("request ")]
    ref = [ln for ln in _example("serve_lm.py")
           if ln.startswith("request ")]
    assert len(ref) == 8
    assert ours == ref


def test_train_lm_lowers_the_loss(tmp_path):
    out = _example("train_lm_torch.py", "--device", "cpu", "--steps", "24",
                   "--layers", "2", "--d-model", "128", "--seq-len", "32",
                   "--global-batch", "4", "--ckpt-dir", str(tmp_path))
    first, last = (float(x) for x in
                   out[-1].split("loss: ")[1].split(" over")[0]
                   .split(" -> "))
    assert last < first
