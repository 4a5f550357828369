"""The port's process supervisor against the reference's: the restart
policy's backoff, and the fake-worker scenarios of the reference's
``tests/test_supervisor.py`` (exit-43 restart, eviction with gang re-mesh,
the failure budget, the hang detector, supervisor-side ``sigkill``) run
under both supervisors, whose reports must be equal once wall times and
pids are left out.  Also the local stripe exchange and ``write_report``."""
import json
import sys
import textwrap
import threading

import pytest

torch = pytest.importorskip("torch")

from repro.runtime import RestartPolicy as RefPolicy  # noqa: E402
from repro.runtime import Supervisor as RefSupervisor  # noqa: E402
from repro_torch.checkpoint import save_checkpoint  # noqa: E402
from repro_torch.runtime import (LocalStripeExchange,  # noqa: E402
                                 RestartPolicy, StripeExchangeTimeout,
                                 Supervisor, split_spec_strings,
                                 write_report)

FAST = dict(max_restarts_per_rank=2, max_total_failures=6,
            backoff_base_s=0.05, backoff_max_s=0.2, hang_timeout_s=1.0,
            term_grace_s=2.0)


def test_backoff_equals_reference():
    kw = dict(backoff_base_s=0.25, backoff_max_s=2.0, backoff_jitter=0.25)
    ours, ref = RestartPolicy(**kw), RefPolicy(**kw)
    for attempt in range(1, 8):
        for seed in (0, 5):
            for rank in range(3):
                assert ours.backoff_s(attempt, seed=seed, rank=rank) == \
                    ref.backoff_s(attempt, seed=seed, rank=rank)
    a = ours.backoff_s(1, seed=0, rank=1)
    assert 0.25 <= a <= 0.25 * 1.25
    assert ours.backoff_s(10, seed=0, rank=1) <= 2.0 * 1.25
    assert split_spec_strings(["kill@5", "sigkill@9:host=2"]) == \
        (["sigkill@9:host=2"], ["kill@5"])


def _fake_builder(tmp_path, fleet_dir, body):
    """cmd_builder whose worker script runs `body` with rank/world/tag/
    attempt/fleet_dir bound and a heartbeat() helper in scope."""
    script = tmp_path / "worker.py"
    script.write_text(textwrap.dedent("""\
        import json, os, sys, time
        rank, world, tag, attempt = map(int, sys.argv[1:5])
        fleet_dir = sys.argv[5]

        def heartbeat(step):
            d = os.path.join(fleet_dir, "hb")
            os.makedirs(d, exist_ok=True)
            p = os.path.join(d, f"rank_{tag}.json")
            with open(p + ".tmp", "w") as f:
                json.dump({"rank": rank, "step": step,
                           "wall": time.time()}, f)
            os.replace(p + ".tmp", p)
    """) + textwrap.dedent(body))

    def build(spec):
        return [sys.executable, str(script), str(spec.rank),
                str(spec.world), str(spec.tag), str(spec.attempt),
                fleet_dir]

    return build


def _normal(report: dict, racy: bool = False) -> dict:
    """The report without wall times and pids (and the hang detector's
    measured quiet span); events compared as a multiset, since two
    workers' exits may land in either order within one poll (which also
    orders a failure event's running count: the report's total stays).
    ``racy``: two workers relaunch in the same backoff window, so which
    one fails first, and whether the other was relaunched before the
    budget ran out, is timing: keep each worker's state and restarts and
    each event's kind, launches left out."""
    out = {k: v for k, v in report.items() if k not in ("wall_s", "events")}
    events = [{k: v for k, v in e.items()
               if k not in ("t", "pid", "quiet_s", "total_failures")}
              for e in report["events"]]
    if racy:
        out["workers"] = [{k: v for k, v in w.items()
                           if k not in ("attempts", "exit_history")}
                          for w in report["workers"]]
        events = [{"kind": e["kind"]} for e in events
                  if e["kind"] != "launch"]
    out["events"] = sorted(json.dumps(e, sort_keys=True) for e in events)
    return json.loads(json.dumps(out))


SCENARIOS = {
    "exit_43": (2, """\
        heartbeat(attempt)
        sys.exit(43 if attempt == 1 else 0)
    """, FAST, ()),
    "evict_remesh": (2, """\
        if tag == 1:
            sys.exit(1)
        if world == 1:
            sys.exit(0)       # post-remesh solo gang: finish
        time.sleep(60)        # pre-remesh: stay up until SIGTERMed
    """, dict(max_restarts_per_rank=1, max_total_failures=10,
              backoff_base_s=0.05, backoff_max_s=0.1, term_grace_s=2.0), ()),
    "budget": (2, "sys.exit(2)\n",
               dict(max_restarts_per_rank=10, max_total_failures=2,
                    backoff_base_s=0.05, backoff_max_s=0.1), ()),
    "hang": (1, """\
        heartbeat(0)
        if attempt == 1:
            time.sleep(60)    # dark: no further heartbeats
        sys.exit(0)
    """, FAST, ()),
    "sigkill": (1, """\
        heartbeat(100)
        if attempt == 1:
            time.sleep(60)
        sys.exit(0)
    """, FAST, ("sigkill@50:host=0",)),
}


def _supervise(cls, policy_cls, tmp_path, name, ckpt_dir=None):
    nprocs, body, policy, specs = SCENARIOS[name]
    tmp_path.mkdir()
    fleet_dir = str(tmp_path / "fleet")
    build = _fake_builder(tmp_path, fleet_dir, body)
    return cls(nprocs, build, fleet_dir=fleet_dir,
               policy=policy_cls(**policy), chaos_specs=list(specs),
               ckpt_dir=ckpt_dir).run()


@pytest.mark.parametrize("name", list(SCENARIOS))
def test_supervisor_report_equals_reference(tmp_path, name):
    # one committed checkpoint (the port's format v2, which both read)
    # makes the gang launches striped and gives the report its step
    ckpt = str(tmp_path / "ckpt")
    save_checkpoint(ckpt, 7, {"w": torch.arange(6, dtype=torch.float32)})
    ours = _supervise(Supervisor, RestartPolicy, tmp_path / "port", name,
                      ckpt)
    ref = _supervise(RefSupervisor, RefPolicy, tmp_path / "ref", name, ckpt)
    racy = name == "budget"
    assert _normal(ours, racy) == _normal(ref, racy)
    assert ours["final_checkpoint_step"] == 7
    by_tag = {w["tag"]: w for w in ours["workers"]}
    kinds = [e["kind"] for e in ours["events"]]
    if name == "exit_43":
        assert ours["outcome"] == "completed"
        assert all(w["exit_history"] == [43, 0] for w in ours["workers"])
        launches = [e for e in ours["events"] if e["kind"] == "launch"]
        assert [e["striped"] for e in launches] == [True, True, False,
                                                    False]
    elif name == "evict_remesh":
        assert ours["outcome"] == "degraded"
        assert by_tag[1]["state"] == "evicted"
        assert by_tag[0]["state"] == "done"
        assert ours["plan"]["host_ranks"] == {0: 0}
        assert "remesh" in kinds
    elif name == "budget":
        assert ours["outcome"] == "budget_exhausted"
        assert ours["total_failures"] == 3
        assert all(w["state"] == "evicted" for w in ours["workers"])
    elif name == "hang":
        assert ours["outcome"] == "completed" and "hang_kill" in kinds
        assert by_tag[0]["exit_history"][0] == -9
    else:
        assert kinds.count("chaos_sigkill") == 1
        assert by_tag[0]["exit_history"] == [-9, 0]


def test_write_report_is_atomic_json(tmp_path):
    path = tmp_path / "sub" / "report.json"
    write_report(str(path), {"outcome": "completed", "workers": []})
    assert json.loads(path.read_text())["outcome"] == "completed"
    assert [p.name for p in path.parent.iterdir()] == ["report.json"]


def _threaded_allgather(ex, payloads, key="k"):
    world = len(payloads)
    out, errs = [None] * world, [None] * world

    def go(r):
        try:
            out[r] = ex.allgather(key, r, world, payloads[r])
        except Exception as e:           # surfaced to the test thread
            errs[r] = e

    ts = [threading.Thread(target=go, args=(r,)) for r in range(world)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    return out, errs


def test_local_stripe_exchange_allgather_and_timeout():
    payloads = [b"aaa", b"bb", b"c"]
    out, errs = _threaded_allgather(LocalStripeExchange(3), payloads)
    assert errs == [None, None, None]
    assert all(got == payloads for got in out)
    assert issubclass(StripeExchangeTimeout, TimeoutError)
    ex = LocalStripeExchange(2, timeout_s=0.2)
    with pytest.raises(StripeExchangeTimeout, match="ranks \\[1\\]"):
        ex.allgather("k", 0, 2, b"x")
