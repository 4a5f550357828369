#!/usr/bin/env python3
"""Where the time goes in the PyTorch port's serving run, on one CUDA card.

    python3 scripts/profile_serve_torch.py [--modes dense,paged,paged_int8]
        [--arch qwen3-4b | olmoe-1b-7b | ...]
    python3 scripts/profile_serve_torch.py --modes dense \
        --arch internvl2-26b | recurrentgemma-9b | whisper-medium | mamba2-370m

Serves the workload of ``chip_smoke.py`` (``--arch`` at full width,
default qwen3-4b; bf16, random weights from seed 0; for the vlm, hybrid,
audio and ssm families, ``serve_families``'s dense workload) once per KV
mode to warm up, then serves it
again with the same engine state reset: once on the host clock alone
(``wall_s``, ``tok_per_s``) and once under ``torch.profiler`` for the
device's kernels.  Prints one JSON line per mode: the device-busy time
(the union of kernel intervals), the idle share of the profiled wall
time, device launches per generated token, and device time by kernel
group (the flash kernels, the paged decode kernel with its split combine,
GEMMs, everything else; ``paged_decode_share`` is that group's share of
the device-busy time) and by kernel name.  The profiler adds host time, so
the idle share it gives is an upper bound; ``idle_share_unprofiled``
divides the same device-busy time by the unprofiled wall instead.
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

import torch  # noqa: E402
from torch.autograd import DeviceType  # noqa: E402
from torch.profiler import ProfilerActivity, profile  # noqa: E402

import chip_smoke  # noqa: E402  (the workload is defined there)

GROUPS = (("flash_fwd", "flash_fwd_"),
          ("flash_bwd", "flash_bwd_"),
          # the paged kernel's split pass and the combine it shares with
          # dense flash_decode (which no serving mode runs: dense decode
          # takes the plain path)
          ("paged_decode", ("paged_decode_", "decode_combine")),
          # cuBLAS's GEMM / GEMV kernels (nvjet_* on Hopper, sm80_xmma_*,
          # cutlass_*, gemmSN_*, gemv*)
          ("gemm", ("nvjet", "gemm", "gemv", "xmma", "cutlass", "cublas")))


def _group(name: str) -> str:
    low = name.lower()
    for g, keys in GROUPS:
        keys = (keys,) if isinstance(keys, str) else keys
        if any(k in low for k in keys):
            return g
    return "other"


def _device_events(prof):
    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _union_us(evts) -> float:
    spans = sorted((e.time_range.start, e.time_range.end) for e in evts)
    total, cur_s, cur_e = 0.0, None, None
    for s, e in spans:
        if cur_e is None or s > cur_e:
            if cur_e is not None:
                total += cur_e - cur_s
            cur_s, cur_e = s, e
        else:
            cur_e = max(cur_e, e)
    if cur_e is not None:
        total += cur_e - cur_s
    return total


def profile_mode(mode: str, params, arch: str) -> dict:
    from repro_torch.configs import get_bundle
    from repro_torch.launch.serve import build_engine
    if arch in chip_smoke.FAMILIES:
        reqs, kw = chip_smoke.family_workload(arch)
    else:
        reqs, kw = chip_smoke.workload(mode, get_bundle(arch).cfg.vocab)
        kw["max_len"] = 2048
    engine, _ = build_engine(arch, smoke=False, kv_mode=mode, params=params,
                             device="cuda", **kw)

    def serve():
        engine.reset_serving_state()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for p in reqs:
            engine.submit(p)
        res = engine.run()
        torch.cuda.synchronize()
        return res, time.perf_counter() - t0

    serve()                                   # warm-up (cuBLAS plans etc.)
    res, wall = serve()
    n_tok = sum(len(v) for v in res.values())
    with profile(activities=[ProfilerActivity.CPU,
                             ProfilerActivity.CUDA]) as prof:
        _, prof_wall = serve()
    evts = _device_events(prof)
    busy_ms = _union_us(evts) / 1e3
    by_name: dict[str, list] = {}
    for e in evts:
        slot = by_name.setdefault(e.name, [0, 0.0])
        slot[0] += 1
        slot[1] += (e.time_range.end - e.time_range.start) / 1e3
    groups: dict[str, float] = {}
    for name, (_, ms) in by_name.items():
        groups[_group(name)] = groups.get(_group(name), 0.0) + ms
    top = sorted(by_name.items(), key=lambda kv: -kv[1][1])[:12]
    row = dict(arch=arch, mode=mode, wall_s=wall, tok_per_s=n_tok / wall,
               generated_tokens=n_tok, profiled_wall_s=prof_wall,
               device_busy_ms=busy_ms,
               idle_share=1.0 - busy_ms / (prof_wall * 1e3),
               idle_share_unprofiled=1.0 - busy_ms / (wall * 1e3),
               device_launches=len(evts),
               launches_per_token=len(evts) / n_tok,
               device_ms_by_group=groups,
               paged_decode_share=groups.get("paged_decode", 0.0) / busy_ms,
               top_kernels=[dict(name=n[:120], launches=c, ms=ms)
                            for n, (c, ms) in top])
    del engine
    torch.cuda.empty_cache()
    return row


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--modes", default="dense,paged,paged_int8")
    ap.add_argument("--arch", default=chip_smoke.ARCH)
    a = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("profile_serve_torch: no CUDA device", file=sys.stderr)
        return 2
    print(chip_smoke.smi(), flush=True)
    from repro_torch.configs import get_bundle
    params = get_bundle(a.arch).init_params(chip_smoke.SEED, device="cuda")
    with torch.no_grad():
        for mode in a.modes.split(","):
            print(json.dumps(profile_mode(mode, params, a.arch)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
