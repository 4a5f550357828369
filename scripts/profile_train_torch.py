#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's training step, on one CUDA card.

    python3 scripts/profile_train_torch.py [--steps 3]

Takes the ``train`` phase of ``chip_smoke.py``: qwen3-4b at full width,
bf16, random weights from seed 0, AdamW steps of B 2 x S 2048 synthetic
tokens with one microbatch and per-layer recompute, through
``training.make_train_step`` as ``launch.train.run`` builds it.  After one
warm-up step it times ``--steps`` steps on the host clock (each ending in a
device synchronise) and profiles one more under ``torch.profiler``.
Prints one JSON line: the steps' seconds, tokens/s, peak memory, the
device-busy time of the profiled step (the union of kernel intervals), its
idle share, and device time by kernel group (the flash kernels, GEMMs,
everything else) and by kernel name.  The profiler adds host time, so the
idle share it gives is an upper bound; ``idle_share_unprofiled`` divides
the same busy time by the mean unprofiled step instead.
"""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / "scripts"))

import torch  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402
from profile_serve_torch import (_device_events, _group,  # noqa: E402
                                 _union_us)

B, S = 2, 2048


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--steps", type=int, default=3)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_train_torch: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.smi(), flush=True)
    from repro_torch.configs import get_bundle
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.training import TrainHyper, make_train_step
    bundle = get_bundle(chip_smoke.ARCH)
    params = bundle.init_params(chip_smoke.SEED, device="cuda")
    opt = adamw_init(params)
    n = a.steps + 2
    step_fn = make_train_step(bundle.forward, TrainHyper(
        optimizer=AdamWConfig(warmup_steps=5, total_steps=max(n, 10))))
    data = SyntheticLM(DataConfig(vocab=bundle.cfg.vocab, seq_len=S,
                                  global_batch=B))
    batches = [{k: torch.from_numpy(v).to("cuda", torch.long)
                for k, v in data.batch(i, 0, B).items()} for i in range(n)]

    def step(i):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        _, _, m = step_fn(params, opt, batches[i])
        loss = float(m["loss"])
        torch.cuda.synchronize()
        return time.perf_counter() - t0, loss

    step(0)                                   # warm-up (cuBLAS plans etc.)
    torch.cuda.reset_peak_memory_stats()
    timed = [step(i) for i in range(1, n - 1)]
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        prof_wall, _ = step(n - 1)
    evts = _device_events(prof)
    busy_ms = _union_us(evts) / 1e3
    by_name: dict[str, list] = {}
    for e in evts:
        slot = by_name.setdefault(e.name, [0, 0.0])
        slot[0] += 1
        slot[1] += (e.time_range.end - e.time_range.start) / 1e3
    groups: dict[str, list] = {}
    for name, (c, ms) in by_name.items():
        g = groups.setdefault(_group(name), [0, 0.0])
        g[0] += c
        g[1] += ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:15]
    secs = [t for t, _ in timed]
    mean_s = sum(secs) / len(secs)
    row = dict(batch=B, seq_len=S, step_s=secs,
               losses=[loss for _, loss in timed],
               tok_per_s=B * S / mean_s,
               max_memory_allocated=torch.cuda.max_memory_allocated(),
               profiled_step_s=prof_wall, device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / (prof_wall * 1e3),
               idle_share_unprofiled=1.0 - busy_ms / (mean_s * 1e3),
               device_launches=len(evts),
               device_by_group={g: dict(launches=c, ms=ms)
                                for g, (c, ms) in groups.items()},
               top_kernels=[dict(name=k[:120], launches=c, ms=ms)
                            for k, (c, ms) in top])
    print(json.dumps(row), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
