#!/usr/bin/env python3
"""Sweep the head_dim-256 dk/dv kernel's split on one H100, from the
repository root:

    python3 scripts/sweep_flash_bwd_d256_torch.py [--iters 20]

At recurrentgemma-9b's train shape (``chip_smoke.FLASH_D256_SHAPE``: B 1,
S 4096, 16 q heads over one kv head, head_dim 256, causal, window 2048,
bf16), times ``flash_bwd_dkv_cuda`` at every split of the 16-head group
(1, 2, 4, 8, 16 parts: one CTA a (part, 64-key block); more than one part
writes f32 partials that a second kernel adds) beside the split
``attention.flash_bwd_dkv_plan`` picks, and the dq kernel once.  Each
point is held against the rounded plain version first
(``chip_smoke.closeness_rounded``), then timed by device time
(``chip_smoke.device_ms``: CUDA events after an L2 flush, the wrapper's
host work covered), ``--iters`` launches a point.  One JSON line per
point, then the card's name and power limit.  These are the readings
behind ``flash_bwd_dkv_plan``'s rule (PERF.md §6).
"""
from __future__ import annotations

import argparse
import importlib.util
import json
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--iters", type=int, default=20)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_flash_bwd_d256_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from repro_torch.kernels import attention as katt
    sh = cs.FLASH_D256_SHAPE
    B, S, H, Hkv, D, window = (sh[k] for k in ("B", "S", "H", "Hkv", "D",
                                               "window"))
    G = H // Hkv
    g = torch.Generator(device="cuda").manual_seed(cs.SEED + 5)
    q, do = (torch.randn((B, S, H, D), generator=g, device="cuda")
             .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    k, v = (torch.randn((B, S, Hkv, D), generator=g, device="cuda")
            .to(torch.bfloat16).transpose(1, 2) for _ in range(2))
    band = dict(causal=True, window=window)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        o, lse = katt.flash_attention_fwd_cuda(q, k, v, **band)
        delta = (o.float() * do.float()).sum(-1).reshape(B * H, S) \
            .contiguous()
        flat = (q.reshape(B * H, S, D), k.reshape(B * Hkv, S, D),
                v.reshape(B * Hkv, S, D), do.reshape(B * H, S, D), lse,
                delta)
        plain_kw = dict(band, **katt.flash_bwd_plain_kw("flash_bwd_d256"))
        _, dk_ref, dv_ref = katt.flash_attention_bwd_plain(*flat, **plain_kw)
        _, tdk, tdv = katt.flash_bwd_term_max(*flat, **plain_kw)
        args_ = (q, k, v, do, lse, delta)
        dq_ms = cs.device_ms(lambda: katt.flash_bwd_dq_cuda(*args_, **band),
                             args.iters, flush)
        print(json.dumps(dict(kernel="flash_bwd_dq_d256", device_ms=dq_ms)),
              flush=True)
        plan = katt.flash_bwd_dkv_plan(B, Hkv, G, S).parts
        for parts in [p for p in range(1, G + 1) if G % p == 0]:
            dk, dv = katt.flash_bwd_dkv_cuda(*args_, **band, parts=parts)
            torch.cuda.synchronize()
            ck = cs.closeness_rounded(dk.reshape(dk_ref.shape), dk_ref, tdk)
            cv = cs.closeness_rounded(dv.reshape(dv_ref.shape), dv_ref, tdv)
            ms = cs.device_ms(lambda: katt.flash_bwd_dkv_cuda(
                *args_, **band, parts=parts), args.iters, flush)
            print(json.dumps(dict(
                kernel="flash_bwd_dkv_d256", parts=parts, plan=parts == plan,
                ctas=katt.flash_bwd_dkv_plan(B, Hkv, G, S, parts).ctas,
                device_ms=ms,
                within_tol=ck["within_tol"] and cv["within_tol"],
                worst_tol_ratio=max(ck["worst_tol_ratio"],
                                    cv["worst_tol_ratio"]))), flush=True)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
