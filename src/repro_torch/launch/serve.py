"""Serving launcher: continuous-batching engine (dense or paged KV) over a
bundle, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --kv-mode paged --page-size 16

Fleet modes (the serving fleet of ``serving/fleet.py``):

    # N REAL serve worker processes under runtime/supervisor.py; a worker
    # killed by --chaos die@T:host=H exits 43 and is restarted
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --kv-mode paged --fleet 2 --chaos die@4:host=1

    # one worker process (the supervisor builds this argv itself)
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --kv-mode paged --worker --process-id 0 --num-processes 2 ...

Every fleet member regenerates the same seeded request trace and serves
the slice ``rid % world == rank``, so the merged results are comparable
request-by-request against a single-engine run of the same trace.
:func:`build_fleet` is the in-process flavour (a
:class:`~repro_torch.serving.LocalFleet` over engines sharing one bundle
+ params).

Counterpart of ``repro.launch.serve``.  Every entry point runs on the
CUDA card unless the caller passes ``device="cpu"`` (``--device cpu``;
the supervisor forwards it to every worker), and raises when it finds no
card.  Paged modes need a transformer-family arch (attention KV, no
vision prefix); the SSM, hybrid, audio and VLM families serve on the
dense path.
"""
from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, ArchBundle, get_bundle
from repro_torch.device import resolve_device
from repro_torch.serving import LocalFleet, ServeConfig, ServingEngine


class _BundleAdapter:
    """Adapts an ArchBundle to the ServingEngine interface: binds the
    family's prefill extras (a VLM's ``vision`` prefix, an audio model's
    ``frames``), sized to each prefill's batch, and forwards the
    serving-capability surface."""

    def __init__(self, bundle, extras=None):
        self.bundle = bundle
        self.extras = extras or {}
        self.cfg = bundle.cfg
        self.supports_paged_kv = bundle.supports_paged_kv
        self.prefill_supports_true_lengths = \
            bundle.prefill_supports_true_lengths

    def init_cache(self, batch, max_len, device=None):
        return self.bundle.init_cache(batch, max_len, device=device)

    def prefill(self, params, tokens, cache, true_lengths=None):
        return self.bundle.prefill(params, tokens, cache,
                                   batch_extras=self._sized(tokens.shape[0]),
                                   true_lengths=true_lengths)

    def _sized(self, b):
        return {k: v[:b] for k, v in self.extras.items()} or None

    def decode_step(self, params, tokens, cache):
        return self.bundle.decode_step(params, tokens, cache)

    def cache_batch_axes(self, cache):
        return self.bundle.cache_batch_axes(cache)

    def init_paged_pool(self, num_pages, page_size, kv_dtype=None,
                        device=None):
        return self.bundle.init_paged_pool(num_pages, page_size,
                                           kv_dtype=kv_dtype, device=device)

    def paged_step(self, params, tokens, pool, page_table, lengths, counts):
        return self.bundle.paged_step(params, tokens, pool, page_table,
                                      lengths, counts)


def _bundle(arch, smoke: bool) -> ArchBundle:
    """``arch``'s bundle, or ``arch`` itself when it is one already (a
    config cut in depth, as the chip smoke test serves one)."""
    return arch if isinstance(arch, ArchBundle) else \
        get_bundle(arch, smoke=smoke)


def build_engine(arch, *, smoke: bool = True, slots: int = 4,
                 max_len: int = 64, max_new: int = 8, kv_mode: str = "dense",
                 page_size: int = 16, num_pages: int | None = None,
                 prefill_chunk: int = 32, prefix_cache: bool = True,
                 seed: int = 0, temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, telemetry=None, params=None,
                 device=None, **serve_kw):
    """(engine, vocab) ready for submit()/run().  ``params`` (a dict of
    tensors, e.g. converted reference weights from
    :func:`repro_torch.weights.from_jax_params`) replaces the seeded random
    init and is moved to ``device``; ``arch`` may be an ``ArchBundle`` in
    place of its name.  Extra keywords flow into :class:`ServeConfig`
    (``prefill_token_budget`` and the graceful-degradation knobs)."""
    dev = resolve_device(device)
    bundle = _bundle(arch, smoke)
    if params is None:
        params = bundle.init_params(seed, device=dev)
    else:
        params = _to(params, dev)
    extras = bundle.zero_extras(slots, bundle.cfg.dtype, dev)
    engine = ServingEngine(
        _BundleAdapter(bundle, extras), params,
        ServeConfig(batch=slots, max_len=max_len, max_new_tokens=max_new,
                    kv_mode=kv_mode, page_size=page_size,
                    num_pages=num_pages, prefill_chunk=prefill_chunk,
                    prefix_cache=prefix_cache, temperature=temperature,
                    top_k=top_k, sample_seed=sample_seed, **serve_kw),
        device=dev, telemetry=telemetry)
    return engine, bundle.cfg.vocab


def _to(tree, dev):
    if isinstance(tree, dict):
        return {k: _to(v, dev) for k, v in tree.items()}
    return None if tree is None else tree.to(dev)


def fleet_trace(vocab: int, *, n_requests: int, prompt_len: int = 12,
                prefix_share: float = 0.0, seed: int = 0
                ) -> list[np.ndarray]:
    """The launcher's seeded request trace (the reference's): random
    prompts, with a common half-length prefix on a ``prefix_share``
    fraction of them.  The fleet supervisor's parent, every worker
    process and a single-engine baseline regenerate it identically, so
    per-request outputs are comparable across all three."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size=max(1, prompt_len // 2))
    prompts = []
    for i in range(n_requests):
        prompt = rng.integers(0, vocab, size=prompt_len).astype(np.int32)
        if prefix_share > 0 and i % max(1, round(1 / prefix_share)) == 0:
            prompt[:len(common)] = common
        prompts.append(prompt)
    return prompts


def build_fleet(arch, n_hosts: int, *, smoke: bool = True,
                slots: int = 2, max_len: int = 64, max_new: int = 8,
                kv_mode: str = "paged", page_size: int = 16,
                num_pages: int | None = None, prefill_chunk: int = 32,
                seed: int = 0, fleet_cfg=None, chaos=None, telemetry=None,
                params=None, device=None, **serve_kw):
    """(fleet, vocab): ``n_hosts`` in-process serving engines sharing ONE
    bundle + params (identical weights on every host: the fleet's
    determinism contract) behind the
    :class:`~repro_torch.serving.LocalFleet` router.  ``chaos`` is a
    ChaosInjector consulted on the fleet tick clock (die / netsplit /
    pagecorrupt); ``params`` and ``device`` as in :func:`build_engine`,
    whose extra keywords flow into :class:`ServeConfig`."""
    dev = resolve_device(device)
    bundle = _bundle(arch, smoke)
    params = bundle.init_params(seed, device=dev) if params is None \
        else _to(params, dev)
    adapter = _BundleAdapter(bundle, {})
    cfg = ServeConfig(batch=slots, max_len=max_len, max_new_tokens=max_new,
                      kv_mode=kv_mode, page_size=page_size,
                      num_pages=num_pages, prefill_chunk=prefill_chunk,
                      **serve_kw)
    engines = [ServingEngine(adapter, params, cfg, device=dev,
                             telemetry=telemetry)
               for _ in range(n_hosts)]
    fleet = LocalFleet(engines, fleet_cfg, chaos=chaos, telemetry=telemetry)
    return fleet, bundle.cfg.vocab


def run_worker(a) -> None:
    """One serve worker process under the supervisor: serve the trace
    slice ``rid % world == rank``, heartbeat per tick, die on an active
    ``die`` chaos spec (exit 43 -> supervised restart without chaos)."""
    from repro_torch.runtime.chaos import ChaosInjector
    from repro_torch.runtime.fleet import FleetWorker
    worker = FleetWorker(process_id=a.process_id,
                         num_processes=a.num_processes,
                         fleet_dir=a.fleet_dir, tag=a.tag,
                         result_out=a.result_out)
    chaos = ChaosInjector(a.chaos or (), seed=a.seed)
    engine, vocab = build_engine(
        a.arch, slots=a.slots, max_len=a.max_len, max_new=a.max_new,
        kv_mode=a.kv_mode, page_size=a.page_size, seed=a.seed,
        device=a.device)
    prompts = fleet_trace(vocab, n_requests=a.requests,
                          prompt_len=a.prompt_len,
                          prefix_share=a.prefix_share, seed=a.seed)
    rids = {}
    for i, p in enumerate(prompts):
        if i % a.num_processes == a.process_id:
            rids[i] = engine.submit(p)
    tick = 0
    while engine.pending():
        tick += 1
        chaos.maybe_die(tick, worker.tag)   # ChaosKilled -> exit 43
        engine.step()
        worker.heartbeat(tick)
    worker.heartbeat(tick)
    worker.write_result({
        "results": {str(i): [int(t) for t in engine.results[r]]
                    for i, r in rids.items()},
        "outcomes": {str(i): engine.outcomes[r] for i, r in rids.items()},
        "ticks": tick, "device": str(engine.device)})
    print(f"[serve-worker {a.process_id}/{a.num_processes}] "
          f"{len(rids)} requests in {tick} ticks on {engine.device}")


def run_fleet_supervised(a) -> dict:
    """``--fleet N``: N real serve worker processes under the process
    supervisor.  A worker killed by ``die`` chaos exits 43, restarts
    WITHOUT chaos (the supervisor strips the flags), and re-serves its
    slice; the parent merges the per-rank result JSONs and writes the
    supervisor's report to ``<fleet dir>/report.json``."""
    import tempfile

    from repro_torch.runtime.chaos import split_spec_strings
    from repro_torch.runtime.supervisor import (RestartPolicy, Supervisor,
                                                write_report)
    fleet_dir = a.fleet_dir or tempfile.mkdtemp(prefix="serve_fleet_")
    results_dir = os.path.join(fleet_dir, "results")
    os.makedirs(results_dir, exist_ok=True)
    _, worker_chaos = split_spec_strings(a.chaos or ())

    def cmd(spec):
        argv = [sys.executable, "-m", "repro_torch.launch.serve",
                "--arch", a.arch, "--worker",
                "--process-id", str(spec.rank),
                "--num-processes", str(spec.world),
                "--tag", str(spec.tag),
                "--fleet-dir", fleet_dir,
                "--requests", str(a.requests),
                "--prompt-len", str(a.prompt_len),
                "--prefix-share", str(a.prefix_share),
                "--kv-mode", a.kv_mode,
                "--page-size", str(a.page_size),
                "--slots", str(a.slots),
                "--max-len", str(a.max_len),
                "--max-new", str(a.max_new),
                "--seed", str(a.seed),
                "--result-out",
                os.path.join(results_dir, f"rank_{spec.tag}.json")]
        if a.device is not None:
            argv += ["--device", a.device]
        if spec.with_chaos:
            for c in worker_chaos:
                argv += ["--chaos", c]
        return argv

    sup = Supervisor(a.fleet, cmd, fleet_dir=fleet_dir,
                     policy=RestartPolicy(hang_timeout_s=120.0,
                                          max_wall_s=a.max_wall_s),
                     chaos_specs=a.chaos or (), chaos_seed=a.seed)
    report = sup.run()
    write_report(os.path.join(fleet_dir, "report.json"), report)
    merged: dict[str, list[int]] = {}
    outcomes: dict[str, str] = {}
    for tag in range(a.fleet):
        path = os.path.join(results_dir, f"rank_{tag}.json")
        try:
            with open(path) as f:
                res = json.load(f)
        except (OSError, json.JSONDecodeError):
            continue
        merged.update(res.get("results", {}))
        outcomes.update(res.get("outcomes", {}))
    print(f"[serve-fleet] outcome={report['outcome']} "
          f"failures={report['total_failures']} "
          f"served={len(merged)}/{a.requests} "
          f"wall={report['wall_s']:.1f}s dir={fleet_dir}")
    return {"report": report, "results": merged, "outcomes": outcomes}


def run(arch: str, *, smoke: bool = True, n_requests: int = 6,
        slots: int = 4, prompt_len: int = 12, max_new: int = 8,
        max_len: int = 64, seed: int = 0, kv_mode: str = "dense",
        page_size: int = 16, num_pages: int | None = None,
        prefix_cache: bool = True, prefix_share: float = 0.0,
        temperature: float = 0.0, top_k: int = 0,
        stream: bool = False, trace_out: str | None = None,
        metrics_out: str | None = None, device=None) -> dict:
    """Serve ``n_requests`` random prompts and return {rid: tokens}.

    ``prefix_share`` > 0 gives that fraction of the requests a common
    prompt prefix (half the prompt length).  ``stream`` consumes request 0
    through the per-token generator API instead of the batch ``run()``."""
    tel = None
    if trace_out or metrics_out:
        import repro_torch.obs as obs
        tel = obs.enable(process_name=f"serve:{kv_mode}")
    engine, vocab = build_engine(
        arch, smoke=smoke, slots=slots, max_len=max_len, max_new=max_new,
        kv_mode=kv_mode, page_size=page_size, num_pages=num_pages,
        prefix_cache=prefix_cache, seed=seed, temperature=temperature,
        top_k=top_k, sample_seed=seed, telemetry=tel, device=device)
    for prompt in fleet_trace(vocab, n_requests=n_requests,
                              prompt_len=prompt_len,
                              prefix_share=prefix_share, seed=seed):
        engine.submit(prompt)
    t0 = time.time()
    if stream:
        first = [tok for tok in engine.stream(0)]
        print(f"[serve:{kv_mode}] streamed req 0: {first}")
    results = engine.run()
    dt = time.time() - t0
    total_tokens = sum(len(v) for v in results.values())
    stats = engine.kv_stats()
    line = (f"[serve:{kv_mode}] {n_requests} requests, {total_tokens} "
            f"tokens in {dt:.2f}s ({total_tokens/dt:.1f} tok/s, "
            f"kv_resident={stats['bytes_resident']/1e6:.2f}MB, "
            f"device={engine.device})")
    pstats = engine.prefix_stats() if kv_mode != "dense" else {}
    if pstats:
        line += (f" prefix_hits={pstats['hits']}/{pstats['lookups']} "
                 f"matched_tokens={pstats['matched_tokens']} "
                 f"cow={pstats['cow_copies']}")
    print(line)
    if tel is not None:
        snap = engine.telemetry()   # pull kv/prefix/traffic into registry
        if trace_out:
            print(f"[serve:{kv_mode}] trace -> "
                  f"{tel.write_trace(trace_out)}")
        if metrics_out:
            print(f"[serve:{kv_mode}] metrics -> "
                  f"{tel.write_metrics(metrics_out, extra={'serve': snap})}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", required=True, choices=ARCH_IDS)
    ap.add_argument("--requests", type=int, default=6)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=8)
    ap.add_argument("--kv-mode", default="dense",
                    choices=("dense", "paged", "paged_int8"))
    ap.add_argument("--page-size", type=int, default=16)
    ap.add_argument("--num-pages", type=int, default=None)
    ap.add_argument("--prefix-cache", dest="prefix_cache",
                    action="store_true", default=True,
                    help="radix prefix sharing across requests (default on)")
    ap.add_argument("--no-prefix-cache", dest="prefix_cache",
                    action="store_false")
    ap.add_argument("--prefix-share", type=float, default=0.0,
                    help="fraction of requests given a common prompt prefix")
    ap.add_argument("--stream", action="store_true",
                    help="consume request 0 via the token-streaming API")
    ap.add_argument("--temperature", type=float, default=0.0,
                    help="0 = greedy; > 0 samples from softmax(logits/T)")
    ap.add_argument("--top-k", type=int, default=0,
                    help="restrict sampling to the k highest logits")
    ap.add_argument("--trace-out", default=None, metavar="PATH",
                    help="write a Chrome trace JSON (perfetto-loadable) of "
                         "the serve")
    ap.add_argument("--metrics-out", default=None, metavar="PATH",
                    help="write the metrics snapshot (+ engine.telemetry()) "
                         "as JSON")
    # fleet modes (serving/fleet.py; see the module docstring)
    ap.add_argument("--fleet", type=int, default=0, metavar="N",
                    help="run N real serve worker processes under the "
                         "process supervisor (0 = single engine)")
    ap.add_argument("--worker", action="store_true",
                    help="run as one supervised serve worker (internal; "
                         "the supervisor builds this argv)")
    ap.add_argument("--process-id", type=int, default=0)
    ap.add_argument("--num-processes", type=int, default=1)
    ap.add_argument("--tag", type=int, default=None,
                    help="stable worker id across re-mesh renumbering")
    ap.add_argument("--fleet-dir", default=None)
    ap.add_argument("--result-out", default=None)
    ap.add_argument("--chaos", action="append", default=[],
                    metavar="SPEC", help="fault spec, e.g. die@4:host=1 "
                    "(repeatable; see runtime/chaos.py)")
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--max-wall-s", type=float, default=600.0,
                    help="fleet mode: whole-run wall-clock ceiling")
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu; fleet mode forwards it to "
                         "every worker")
    a = ap.parse_args(argv)
    if a.tag is None:
        a.tag = a.process_id
    if a.worker:
        run_worker(a)
        return
    if a.fleet > 1:
        run_fleet_supervised(a)
        return
    results = run(a.arch, n_requests=a.requests,
                  slots=a.slots, prompt_len=a.prompt_len,
                  max_new=a.max_new, max_len=a.max_len, seed=a.seed,
                  kv_mode=a.kv_mode, page_size=a.page_size,
                  num_pages=a.num_pages, prefix_cache=a.prefix_cache,
                  prefix_share=a.prefix_share, stream=a.stream,
                  temperature=a.temperature, top_k=a.top_k,
                  trace_out=a.trace_out, metrics_out=a.metrics_out,
                  device=a.device)
    for rid, toks in sorted(results.items()):
        print(f"  req {rid}: {toks}")


if __name__ == "__main__":
    main()
