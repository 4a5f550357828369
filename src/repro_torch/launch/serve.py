"""Serving launcher: continuous-batching engine (dense or paged KV) over a
bundle, on the CUDA card.

    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b
    PYTHONPATH=src python -m repro_torch.launch.serve --arch qwen3-4b \
        --kv-mode paged --page-size 16

Counterpart of ``repro.launch.serve`` for a single engine (the fleet,
worker and supervisor modes are not ported yet).  Every entry point runs
on the CUDA card unless the caller passes ``device="cpu"`` (``--device
cpu``), and raises when it finds no card.  Paged modes need a
transformer-family arch (attention KV, no vision prefix); the SSM, hybrid,
audio and VLM families serve on the dense path.
"""
from __future__ import annotations

import argparse
import time

import numpy as np

from repro_torch.configs import ARCH_IDS, get_bundle
from repro_torch.device import resolve_device
from repro_torch.serving import ServeConfig, ServingEngine


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


def build_engine(arch: str, *, smoke: bool = True, slots: int = 4,
                 max_len: int = 64, max_new: int = 8, kv_mode: str = "dense",
                 page_size: int = 16, num_pages: int | None = None,
                 prefill_chunk: int = 32, prefix_cache: bool = True,
                 seed: int = 0, temperature: float = 0.0, top_k: int = 0,
                 sample_seed: int = 0, telemetry=None, params=None,
                 device=None, **serve_kw):
    """(engine, vocab) ready for submit()/run().  ``params`` (a dict of
    tensors, e.g. converted reference weights from
    :func:`repro_torch.weights.from_jax_params`) replaces the seeded random
    init and is moved to ``device``.  Extra keywords flow into
    :class:`ServeConfig` (``prefill_token_budget`` and the graceful-
    degradation knobs)."""
    dev = resolve_device(device)
    bundle = get_bundle(arch, smoke=smoke)
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


def make_prompts(vocab: int, *, n_requests: int, prompt_len: int,
                 prefix_share: float = 0.0, seed: int = 0
                 ) -> list[np.ndarray]:
    """The launcher's seeded request trace (the reference's): random
    prompts, with a common half-length prefix on a ``prefix_share``
    fraction of them."""
    rng = np.random.default_rng(seed)
    common = rng.integers(0, vocab, size=max(1, prompt_len // 2))
    prompts = []
    for i in range(n_requests):
        prompt = rng.integers(0, vocab, size=prompt_len).astype(np.int32)
        if prefix_share > 0 and i % max(1, round(1 / prefix_share)) == 0:
            prompt[:len(common)] = common
        prompts.append(prompt)
    return prompts


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
    for prompt in make_prompts(vocab, n_requests=n_requests,
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
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--prompt-len", type=int, default=12)
    ap.add_argument("--max-len", type=int, default=64)
    ap.add_argument("--device", default=None,
                    help="cuda (default) or cpu")
    a = ap.parse_args(argv)
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
