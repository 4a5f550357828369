"""The port's serving fleet against the reference's: the page frame byte for
byte, the page and stripe exchanges, the ownership directory, the engine's
page export / import, and ``LocalFleet`` under the migration, die,
netsplit, pagecorrupt, hedge and retry-exhaustion scenarios of the
reference's ``tests/test_serving_fleet.py`` — same converted weights,
same prompts, same chaos -> the same tokens, outcomes and ``stats()``
(qwen3-4b smoke, f32, CPU).  Last, the ``--fleet 2 --device cpu`` CLI
drill in a subprocess."""
import functools
import json
import os
import socket
import struct
import subprocess
import sys
import threading
import time
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch.serve import _BundleAdapter as RefAdapter  # noqa: E402
from repro.obs import Telemetry as RefTelemetry  # noqa: E402
from repro.obs.metrics import MetricsRegistry as RefRegistry  # noqa: E402
from repro.runtime import chaos as ref_chaos  # noqa: E402
from repro.runtime import fleet as ref_fleet  # noqa: E402
from repro.serving import FleetConfig as RefFleetConfig  # noqa: E402
from repro.serving import LocalFleet as RefLocalFleet  # noqa: E402
from repro.serving import PageOwnershipDirectory as RefDirectory  # noqa: E402
from repro.serving import ServeConfig as RefServeConfig  # noqa: E402
from repro.serving import ServingEngine as RefEngine  # noqa: E402
from repro_torch.configs import get_bundle  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.obs import Telemetry  # noqa: E402
from repro_torch.obs.metrics import MetricsRegistry  # noqa: E402
from repro_torch.runtime import chaos, fleet  # noqa: E402
from repro_torch.serving import (DirectoryMatch, FleetConfig,  # noqa: E402
                                 LocalFleet, PageOwnershipDirectory,
                                 ServeConfig, ServingEngine)
from repro_torch.weights import from_jax_params, to_numpy  # noqa: E402

ARCH = "qwen3-4b"
PAGE = 8
ROOT = Path(__file__).resolve().parents[1]


# ---------------------------------------------------------------------------
# page frames: the port's bytes are the reference's
# ---------------------------------------------------------------------------

def _arrays(kind: str, seed: int = 0) -> dict:
    """Pool-entry payloads of one page in a KV mode's dtypes (numpy; bf16
    as ml_dtypes arrays, which the reference encodes)."""
    rng = np.random.default_rng(seed)
    shape = (2, PAGE, 2, 4)
    if kind == "f32":
        return {"k": rng.normal(size=shape).astype(np.float32),
                "v": rng.normal(size=shape).astype(np.float32)}
    if kind == "int8":
        return {"k": rng.integers(-127, 127, shape).astype(np.int8),
                "v": rng.integers(-127, 127, shape).astype(np.int8),
                "k_scale": rng.random(shape[:-1]).astype(np.float32),
                "v_scale": rng.random(shape[:-1]).astype(np.float32)}
    bf16 = np.dtype(jnp.bfloat16)
    return {"k": rng.normal(size=shape).astype(bf16),
            "v": rng.normal(size=shape).astype(bf16)}


def _as_tensors(arrays: dict) -> dict:
    out = {}
    for k, a in arrays.items():
        if a.dtype.name == "bfloat16":
            out[k] = torch.from_numpy(a.view(np.int16).copy()) \
                .view(torch.bfloat16)
        else:
            out[k] = torch.from_numpy(a.copy())
    return out


def _words(a) -> np.ndarray:
    """Raw bytes of a tensor or numpy array, for bit-for-bit compares."""
    if isinstance(a, torch.Tensor):
        a = to_numpy(a.contiguous())[0]
    return np.ascontiguousarray(a).view(np.uint8)


TOKENS = tuple(range(100, 100 + PAGE))


@pytest.mark.parametrize("kind", ["f32", "int8", "bf16"])
def test_page_frame_bytes_equal_reference_both_ways(kind):
    arrays = _arrays(kind)
    ref_frame = ref_fleet.encode_page_frame(TOKENS, arrays)
    assert fleet.encode_page_frame(TOKENS, _as_tensors(arrays)) == ref_frame
    if kind != "bf16":           # plain numpy input encodes the same too
        assert fleet.encode_page_frame(TOKENS, arrays) == ref_frame
    # each side decodes the other's frame to the same values and dtypes
    toks, got = fleet.decode_page_frame(ref_frame)
    assert toks == TOKENS and set(got) == set(arrays)
    for k, a in arrays.items():
        assert to_numpy(got[k])[1] == a.dtype.name
        assert tuple(got[k].shape) == a.shape
        np.testing.assert_array_equal(_words(got[k]), _words(a))
    toks, back = ref_fleet.decode_page_frame(
        fleet.encode_page_frame(TOKENS, got))
    assert toks == TOKENS
    for k, a in arrays.items():
        assert back[k].dtype == a.dtype
        np.testing.assert_array_equal(_words(back[k]), _words(a))


def test_bf16_frame_decodes_without_ml_dtypes(tmp_path):
    """The card's machine has numpy but no ml_dtypes: the port reads a
    bf16 frame through a 16-bit integer view, with ml_dtypes unimportable
    in the decoding process."""
    arrays = _arrays("bf16")
    path = tmp_path / "frame.bin"
    path.write_bytes(ref_fleet.encode_page_frame(TOKENS, arrays))
    code = (
        "import sys; sys.modules['ml_dtypes'] = None\n"
        "import numpy as np, torch\n"
        "from repro_torch.runtime.fleet import decode_page_frame\n"
        f"toks, got = decode_page_frame(open({str(path)!r}, 'rb').read())\n"
        "assert 'ml_dtypes' not in sys.modules or "
        "sys.modules['ml_dtypes'] is None\n"
        "print(toks[0], got['k'].dtype, "
        "got['k'].view(torch.int16).sum().item())\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr
    want = int(arrays["k"].view(np.int16).astype(np.int64).sum())
    assert r.stdout.split() == [str(TOKENS[0]), "torch.bfloat16", str(want)]


def test_page_frame_crc_rejects_flip_truncation_and_bad_magic():
    frame = fleet.encode_page_frame(TOKENS, _as_tensors(_arrays("int8")))
    assert fleet.flip_frame_byte(frame) == ref_fleet.flip_frame_byte(frame)
    with pytest.raises(fleet.PageCorruptError, match="CRC"):
        fleet.decode_page_frame(fleet.flip_frame_byte(frame))
    with pytest.raises(fleet.PageCorruptError):
        fleet.decode_page_frame(frame[:len(frame) // 2])
    with pytest.raises(fleet.PageCorruptError, match="magic"):
        fleet.decode_page_frame(b"NOPE" + frame[4:])
    assert issubclass(fleet.PageExchangeTimeout, TimeoutError)
    assert not issubclass(fleet.PageCorruptError, TimeoutError)


def test_local_page_exchange_netsplit_and_corrupt_hooks():
    frame = fleet.encode_page_frame(TOKENS, _as_tensors(_arrays("f32")))
    ex = fleet.LocalPageExchange()
    out = ex.transfer(0, 1, [frame])
    assert out[0][0] == TOKENS and ex.bytes_sent == len(frame)
    ex.blackout = lambda h: h == 1
    with pytest.raises(fleet.PageExchangeTimeout, match="netsplit"):
        ex.transfer(0, 1, [frame])
    ex.blackout = None
    ex.corrupt_hook = lambda: True
    with pytest.raises(fleet.PageCorruptError):
        ex.transfer(0, 1, [frame])
    assert ex.frames_sent == 2          # the corrupt frame crossed the wire


# ---------------------------------------------------------------------------
# TCP exchanges: the port's wire is the reference's
# ---------------------------------------------------------------------------

def test_tcp_page_exchange_publish_fetch_across_packages():
    """A reference host publishes, a port host fetches (and the other way
    round): same framing, same frames."""
    arrays = _arrays("bf16")
    frames = [ref_fleet.encode_page_frame(TOKENS, arrays),
              ref_fleet.encode_page_frame(TOKENS[:4], {"k": arrays["k"]})]
    ports = fleet.allocate_ports(2)
    ref_ex = ref_fleet.TcpPageExchange(0, ports, timeout_s=20)
    pt_ex = fleet.TcpPageExchange(1, ports, timeout_s=20)
    try:
        ref_ex.publish("mig:0", frames)
        got = pt_ex.fetch(0, "mig:0")
        assert [g[0] for g in got] == [TOKENS, TOKENS[:4]]
        np.testing.assert_array_equal(_words(got[0][1]["v"]),
                                      _words(arrays["v"]))
        assert pt_ex.frames_sent == 2
        assert pt_ex.bytes_sent == sum(len(f) for f in frames)
        pt_ex.publish("mig:1", [fleet.encode_page_frame(
            TOKENS, got[0][1])])
        (back,) = ref_ex.fetch(1, "mig:1")
        np.testing.assert_array_equal(_words(back[1]["k"]),
                                      _words(arrays["k"]))
        with pytest.raises(fleet.PageExchangeTimeout):
            pt_ex.fetch(0, "never-published", timeout_s=0.3)
    finally:
        ref_ex.close()
        pt_ex.close()


def test_tcp_stripe_exchange_allgather_across_packages():
    ports = fleet.allocate_ports(2)
    exs = [ref_fleet.TcpStripeExchange(0, ports, timeout_s=20),
           fleet.TcpStripeExchange(1, ports, timeout_s=20)]
    payloads = [b"\x00" * 70000, b"peer-bytes"]      # > one recv chunk
    out = [None, None]

    def go(r):
        out[r] = exs[r].allgather("k", r, 2, payloads[r])

    try:
        ts = [threading.Thread(target=go, args=(r,)) for r in range(2)]
        for t in ts:
            t.start()
        for t in ts:
            t.join(timeout=30)
        assert out == [payloads, payloads]
    finally:
        for ex in exs:
            ex.close()


def _flaky_peer(port, payload, n_resets, stop):
    """A fake peer that RST-closes the first ``n_resets`` connections,
    then serves ``payload`` under any key — a supervisor-bounced rank."""
    srv = socket.socket()
    srv.setsockopt(socket.SOL_SOCKET, socket.SO_REUSEADDR, 1)
    srv.bind(("127.0.0.1", port))
    srv.listen(8)
    srv.settimeout(0.1)
    resets = 0
    while not stop.is_set():
        try:
            conn, _ = srv.accept()
        except socket.timeout:
            continue
        if resets < n_resets:
            resets += 1
            conn.setsockopt(socket.SOL_SOCKET, socket.SO_LINGER,
                            struct.pack("ii", 1, 0))   # close -> RST
            conn.close()
            continue
        buf = b""
        while not buf.endswith(b"\n"):
            buf += conn.recv(256)
        conn.sendall(struct.pack(">Q", len(payload)) + payload)
        conn.close()
        break
    srv.close()


def _with_flaky_peer(n_resets, timeout_s):
    ports = fleet.allocate_ports(2)
    ex = fleet.TcpStripeExchange(0, ports, timeout_s=timeout_s)
    stop = threading.Event()
    t = threading.Thread(target=_flaky_peer,
                         args=(ports[1], b"peer-bytes", n_resets, stop),
                         daemon=True)
    t.start()
    try:
        return ex, ex.allgather("k", 0, 2, b"mine")
    finally:
        stop.set()
        t.join(timeout=5)
        ex.close()


def test_stripe_exchange_reconnects_once_after_reset():
    ex, out = _with_flaky_peer(n_resets=1, timeout_s=10)
    assert out == [b"mine", b"peer-bytes"]
    assert ex.reconnects == 1


def test_stripe_exchange_reset_grace_is_granted_once():
    t0 = time.monotonic()
    with pytest.raises(fleet.StripeExchangeTimeout):
        _with_flaky_peer(n_resets=10_000, timeout_s=0.4)
    assert time.monotonic() - t0 < 5.0


# ---------------------------------------------------------------------------
# the ownership directory: a seeded operation sequence in both packages
# ---------------------------------------------------------------------------

def _seq(rng, n_pages):
    base = [int(t) for t in rng.integers(0, 4, 2 * PAGE)]   # few roots
    tail = [int(t) for t in rng.integers(0, 50, n_pages * PAGE)]
    return (base + tail)[:n_pages * PAGE + int(rng.integers(0, PAGE))]


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_directory_ops_equal_reference(seed):
    """Publish, lookup, tombstone and transfer in a seeded random order:
    every return value, every match and the stats agree."""
    rng = np.random.default_rng(seed)
    ours, ref = PageOwnershipDirectory(PAGE), RefDirectory(PAGE)
    dead: set[int] = set()
    seqs = [_seq(rng, int(rng.integers(1, 5))) for _ in range(6)]
    for _ in range(120):
        op = rng.choice(["publish", "lookup", "lookup", "tombstone",
                         "transfer"], p=[0.35, 0.3, 0.15, 0.05, 0.15])
        toks = seqs[int(rng.integers(len(seqs)))]
        host = int(rng.integers(0, 5))
        if op in ("publish", "transfer") and host in dead:
            for d in (ours, ref):
                fn = d.publish if op == "publish" else \
                    (lambda t, h: d.transfer(t, len(t), h))
                with pytest.raises(ValueError, match="tombstoned"):
                    fn(toks, host)
            continue
        if op == "publish":
            n = int(rng.integers(0, len(toks) + 1))
            assert ours.publish(toks, host, n) == ref.publish(toks, host, n)
        elif op == "lookup":
            a, b = ours.lookup(toks), ref.lookup(toks)
            assert (a.segments, a.owners, a.matched, a.hit) == \
                (b.segments, b.owners, b.matched, b.hit)
        elif op == "tombstone":
            dead.add(host)
            assert ours.tombstone_host(host) == ref.tombstone_host(host)
        else:
            n = int(rng.integers(0, len(toks) + 1))
            assert ours.transfer(toks, n, host) == \
                ref.transfer(toks, n, host)
        assert ours.owners() == ref.owners()
    assert ours.stats() == ref.stats()
    assert ours.stats()["lookups"] > 0
    m = DirectoryMatch()
    assert not m.hit and m.matched == 0


# ---------------------------------------------------------------------------
# engines and fleets over the same weights in both packages
# ---------------------------------------------------------------------------

@functools.lru_cache(maxsize=1)
def _models():
    """(reference adapter, reference params, port adapter, port params)."""
    ref_bundle = ref_get_bundle(ARCH, smoke=True)
    params = ref_bundle.init_params(jax.random.PRNGKey(0))
    weights = jax.tree.map(np.asarray, params)
    return (RefAdapter(ref_bundle, {}), params,
            pt_serve._BundleAdapter(get_bundle(ARCH, smoke=True), {}),
            from_jax_params(weights))


def _engines(n: int, port: bool, **kw) -> list:
    ref_adapter, ref_params, adapter, params = _models()
    base = dict(batch=2, max_len=64, max_new_tokens=4, kv_mode="paged",
                page_size=PAGE)
    base.update(kw)
    if port:
        return [ServingEngine(adapter, params, ServeConfig(**base),
                              device="cpu") for _ in range(n)]
    return [RefEngine(ref_adapter, ref_params, RefServeConfig(**base))
            for _ in range(n)]


@functools.lru_cache(maxsize=2)
def _canonical(kv_mode: str = "paged"):
    """4 prompts sharing a 3-page prefix + the port's single-engine
    baseline (the reference's tests' prompts)."""
    vocab = get_bundle(ARCH, smoke=True).cfg.vocab
    rng = np.random.default_rng(0)
    shared = rng.integers(1, vocab, 3 * PAGE)
    prompts = tuple(
        tuple(int(t) for t in np.concatenate(
            [shared, rng.integers(1, vocab, 6)]))
        for _ in range(4))
    (engine,) = _engines(1, True, kv_mode=kv_mode)
    rids = [engine.submit(np.asarray(p, np.int32)) for p in prompts]
    engine.run()
    return prompts, {i: engine.results[r] for i, r in enumerate(rids)}


def test_engine_export_import_round_trip_and_interop():
    """Pages exported by one port engine and imported into another give a
    real prefix hit with the baseline's tokens; the exported payloads
    equal the reference engine's within f32 rounding, and the reference's
    exported pages import into a port engine the same way."""
    prompts, baseline = _canonical()
    p0 = np.asarray(prompts[0], np.int32)
    (ref_src,) = _engines(1, False)
    src, dst, dst2 = _engines(3, True)
    for eng in (src, ref_src):
        rid = eng.submit(p0)
        eng.run()
        assert eng.results[rid] == baseline[0]
    exported = src.export_prefix_pages(p0, 3 * PAGE)
    ref_exported = ref_src.export_prefix_pages(p0, 3 * PAGE)
    assert len(exported) == len(ref_exported) == 3
    for (seg, vals), (rseg, rvals) in zip(exported, ref_exported):
        assert seg == rseg and set(vals) == set(rvals)
        for k in vals:
            np.testing.assert_allclose(vals[k].numpy(), rvals[k],
                                       rtol=1e-5, atol=1e-5)
    for eng, pages in ((dst, exported), (dst2, ref_exported)):
        frames = [fleet.encode_page_frame(t, a) for t, a in pages]
        decoded = [fleet.decode_page_frame(f) for f in frames]
        assert eng.import_prefix_pages(decoded) == 3 * PAGE
        # a second import finds every segment cached: nothing adopted
        used = eng.kv.stats()["pages_used"]
        assert eng.import_prefix_pages(decoded) == 3 * PAGE
        assert eng.kv.stats()["pages_used"] == used
        before = eng.prefix_stats()["matched_tokens"]
        rid = eng.submit(np.asarray(prompts[1], np.int32))
        eng.run()
        assert eng.results[rid] == baseline[1]
        assert eng.prefix_stats()["matched_tokens"] - before >= 3 * PAGE - 1
        eng.check_kv()
    # the imported pages are the exported ones, bit for bit
    idx = [n.page for n in dst.prefix.path_nodes(p0, 3 * PAGE)]
    for i, (_, vals) in enumerate(exported):
        for k, v in vals.items():
            assert torch.equal(dst.pool[k][:, idx[i]], v)
    assert src.drop_prefix_path(p0, 3 * PAGE) == \
        ref_src.drop_prefix_path(p0, 3 * PAGE)
    src.check_kv()


def test_engine_inflight_and_cancel_equal_reference():
    prompts, _ = _canonical()
    for kv_mode in ("paged", "dense"):
        got = []
        for port in (True, False):
            (eng,) = _engines(1, port, kv_mode=kv_mode)
            rids = [eng.submit(np.asarray(p, np.int32)) for p in prompts]
            eng.step()
            state = [sorted(eng.inflight()), eng.cancel(rids[0]),
                     eng.cancel(rids[3]), eng.cancel(rids[3]),
                     sorted(eng.inflight())]
            eng.run()
            state += [eng.outcomes, eng.degradation_stats(),
                      {r: eng.results[r] for r in rids}]
            if kv_mode != "dense":
                eng.check_kv()
            got.append(state)
        assert got[0] == got[1], kv_mode


def _submit_in_waves(fleet_, prompts, wave=2, settle_ticks=None):
    rids = []
    for i in range(0, len(prompts), wave):
        if rids:
            if settle_ticks is None:
                fleet_.run()
            else:
                for _ in range(settle_ticks):
                    fleet_.step()
        rids += [fleet_.submit(p) for p in prompts[i:i + wave]]
    fleet_.run()
    return rids


def _burst(fleet_, prompts):
    rids = [fleet_.submit(p) for p in prompts]
    fleet_.run()
    return rids


# name -> (chaos specs, FleetConfig keywords, how the trace arrives)
SCENARIOS = {
    "migrate": ([], {}, _submit_in_waves),
    "die": (["die@3:host=0"], {},
            functools.partial(_submit_in_waves, settle_ticks=2)),
    "netsplit": (["netsplit@1:host=1,duration=200"], {}, _submit_in_waves),
    "pagecorrupt": (["pagecorrupt@1"], {}, _submit_in_waves),
    "hedge": ([], dict(hedge_after=1, migrate=False), _burst),
    "retry_exhausted": (["die@2:host=0", "die@2:host=1"],
                        dict(max_retries=0), _burst),
}


def _run_fleet(port: bool, specs, cfg_kw, drive, prompts, kv_mode):
    kw = dict(placement="round_robin", **cfg_kw)
    if port:
        reg = MetricsRegistry()
        inj = chaos.ChaosInjector(specs, seed=0)
        f = LocalFleet(_engines(2, True, kv_mode=kv_mode), FleetConfig(**kw),
                       chaos=inj,
                       telemetry=Telemetry(enabled=True, registry=reg))
    else:
        reg = RefRegistry()
        inj = ref_chaos.ChaosInjector(specs, seed=0)
        f = RefLocalFleet(_engines(2, False, kv_mode=kv_mode),
                          RefFleetConfig(**kw), chaos=inj,
                          telemetry=RefTelemetry(enabled=True, registry=reg))
    rids = drive(f, prompts)
    f.telemetry()
    return f, rids, inj, reg.snapshot()


@pytest.mark.parametrize("kv_mode,scenario", [
    *(("paged", s) for s in SCENARIOS), ("paged_int8", "migrate")])
def test_local_fleet_equals_reference(kv_mode, scenario):
    """The same trace and chaos through both fleets: equal tokens and
    outcomes per request, equal ``stats()`` field for field, the same
    chaos fired, the same counters in each registry; every completed
    request's tokens equal one port engine's."""
    prompts, baseline = _canonical(kv_mode)
    specs, cfg_kw, drive = SCENARIOS[scenario]
    f, rids, inj, snap = _run_fleet(True, specs, cfg_kw, drive, prompts,
                                    kv_mode)
    rf, rrids, rinj, rsnap = _run_fleet(False, specs, cfg_kw, drive,
                                        prompts, kv_mode)
    assert rids == rrids
    assert f.results == rf.results and f.outcomes == rf.outcomes
    assert f.stats() == rf.stats()
    assert inj.fired == rinj.fired
    assert snap["counters"] == rsnap["counters"]
    for i, r in enumerate(rids):
        if f.outcomes[r] == "ok":
            assert f.results[r] == baseline[i], i
    st = f.stats()
    if scenario == "migrate":
        assert st["migrations"]["ok"] >= 1 and st["migrated_pages"] >= 1
        assert snap["counters"]["page_exchange_bytes"] > 0
        assert snap["gauges"]["fleet.directory.hit_rate"] > 0
        assert "fleet_migration_s" in snap["histograms"]
    elif scenario == "die":
        assert "die@3:host=0" in inj.fired and st["retries"] >= 1
        assert snap["histograms"]["fleet_recovery_ticks"]["count"] >= 1
    elif scenario == "netsplit":
        assert st["migrations"]["timeout"] >= 1
        assert st["page_exchange_bytes"] == 0
    elif scenario == "pagecorrupt":
        assert st["migrations"]["corrupt"] >= 1
    elif scenario == "hedge":
        assert st["hedges"] >= 1
    else:
        assert st["outcomes"]["failed"] == len(rids)
        assert all(f.results[r] == [] for r in rids)
    for h in f.live_hosts():
        f.engines[h].check_kv()


def test_fleet_rejects_dense_engines_and_mismatched_pages():
    (dense,) = _engines(1, True, kv_mode="dense", max_new_tokens=2)
    with pytest.raises(ValueError, match="paged"):
        LocalFleet([dense])
    with pytest.raises(ValueError, match="page_size"):
        LocalFleet(_engines(1, True) + _engines(1, True, page_size=16))
    with pytest.raises(ValueError, match="placement"):
        LocalFleet(_engines(1, True), FleetConfig(placement="nope"))


def test_build_fleet_affinity_serves_the_launcher_trace():
    """The launcher's in-process fleet (affinity placement, its own seeded
    weights) serves the seeded trace to the tokens of its own single
    engine."""
    f, vocab = pt_serve.build_fleet(ARCH, 3, max_new=4, page_size=PAGE,
                                    device="cpu")
    engine, _ = pt_serve.build_engine(ARCH, slots=2, max_new=4,
                                      kv_mode="paged", page_size=PAGE,
                                      device="cpu")
    trace = pt_serve.fleet_trace(vocab, n_requests=6, prompt_len=20,
                                 prefix_share=0.5)
    rids = _submit_in_waves(f, trace, wave=3)
    base = [engine.submit(p) for p in trace]
    engine.run()
    assert [f.results[r] for r in rids] == [engine.results[r] for r in base]
    assert f.stats()["directory"]["hits"] >= 1


# ---------------------------------------------------------------------------
# the real-process fleet CLI (supervisor + serve workers), on the CPU
# ---------------------------------------------------------------------------

def test_serve_fleet_cli_survives_worker_death(tmp_path):
    """``--fleet 2 --device cpu`` with die chaos: the targeted worker exits
    43, the supervisor restarts it without chaos, and the merged results
    cover every request with one engine's tokens for the same trace."""
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    out = subprocess.run(
        [sys.executable, "-m", "repro_torch.launch.serve", "--arch", ARCH,
         "--fleet", "2", "--requests", "4", "--kv-mode", "paged",
         "--page-size", "8", "--slots", "2", "--max-new", "4",
         "--prefix-share", "0.5", "--chaos", "die@2:host=1",
         "--fleet-dir", str(tmp_path), "--max-wall-s", "300",
         "--device", "cpu"],
        env=env, capture_output=True, text=True, timeout=420)
    assert out.returncode == 0, out.stderr[-2000:]
    assert "outcome=completed" in out.stdout
    assert "served=4/4" in out.stdout
    merged = {}
    for tag in range(2):
        with open(tmp_path / "results" / f"rank_{tag}.json") as f:
            res = json.load(f)
        assert res["device"] == "cpu"
        merged.update(res["results"])
    assert sorted(merged) == ["0", "1", "2", "3"]
    assert all(len(v) == 4 for v in merged.values())
    report = json.loads((tmp_path / "report.json").read_text())
    assert report["outcome"] == "completed"
    by_tag = {w["tag"]: w for w in report["workers"]}
    assert by_tag[1]["exit_history"] == [43, 0]
    assert by_tag[0]["exit_history"] == [0]
    engine, vocab = pt_serve.build_engine(ARCH, slots=2, max_new=4,
                                          kv_mode="paged", page_size=8,
                                          device="cpu")
    trace = pt_serve.fleet_trace(vocab, n_requests=4, prefix_share=0.5)
    rids = [engine.submit(p) for p in trace]
    engine.run()
    assert merged == {str(i): engine.results[r] for i, r in enumerate(rids)}
