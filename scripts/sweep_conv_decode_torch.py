#!/usr/bin/env python3
"""Sweep the two PR-16 kernels' launch choices on one H100, from the
repository root:

    python3 scripts/sweep_conv_decode_torch.py [--convs DL_ATROUS4,TY_CONV1]

* dense ``flash_decode`` at qwen3-4b's decode shape (``chip_smoke.py``'s
  ``decode_case``) for ``block_k`` 2048 down to 64 (1 to 32 splits), with
  SDPA's time beside it;
* the conv2d wgmma route on catalog convs: every tile of
  ``cuda_bridge.CONV_TILES`` with every K split in {1, 2, 3, 4, 6, 9} that
  leaves no split empty, beside the tile and split ``conv2d_plan`` picks.

Times are device time (``chip_smoke.device_ms``: CUDA events after an L2
flush, the wrapper's host work covered), 10 launches a point.  One JSON
line per point group, then the card's name and power limit.  These are
the readings behind ``conv2d_plan``'s rules (PERF.md, PR 16).
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
import torch.nn.functional as F  # noqa: E402

CONVS = ("DL_ATROUS4", "TY_CONV1", "ESPCN_SUBPIX", "TY_CONV2", "ESPCN_CONV2",
         "AL_CONV3", "TY_CONV8", "MBN_PW")
SPLITS = (1, 2, 3, 4, 6, 9)


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def decode_sweep(cs, flush, iters: int) -> None:
    from repro_torch.kernels import attention as katt
    sh = cs.decode_case()["shapes"]
    B, H, Hkv, D, S = (sh[k] for k in ("B", "H", "Hkv", "D", "S"))
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    q = torch.randn((B, H, D), generator=g, device="cuda").bfloat16()
    kc, vc = (torch.randn((B, Hkv, S, D), generator=g, device="cuda")
              .bfloat16() for _ in range(2))
    lens = torch.tensor(sh["lengths"], dtype=torch.int32, device="cuda")
    mask = (torch.arange(S, device="cuda")[None, :] <
            lens[:, None].long())[:, None, None, :]
    sdpa = lambda: F.scaled_dot_product_attention(  # noqa: E731
        q[:, :, None], kc, vc, attn_mask=mask, enable_gqa=True)
    rows = []
    for bk in (2048, 1024, 512, 256, 128, 64):
        f = lambda: katt.flash_decode_cuda(q, kc, vc, lens,  # noqa: E731
                                           block_k=bk)
        close = cs.closeness(f(), katt.flash_decode_plain(
            q, kc, vc, lens, block_k=bk), atol=cs.PAPER_ATOL["flash_decode"])
        cs.require(close["within_tol"], f"decode block_k {bk}: {close}")
        rows.append(dict(block_k=bk, splits=katt.decode_splits(S, bk),
                         device_ms=cs.device_ms(f, iters, flush)))
    print(json.dumps(dict(sweep="flash_decode", shape=sh, points=rows,
                          sdpa_device_ms=cs.device_ms(sdpa, iters, flush))),
          flush=True)


def conv_sweep(cs, name: str, flush, iters: int) -> None:
    from repro_torch.core.cuda_bridge import (CONV_TILES, conv2d_k_steps,
                                              conv2d_plan)
    from repro_torch.kernels import conv2d as kconv
    case = {c["name"]: c for c in cs.catalog_cases()}[name]
    sh = case["shapes"]
    (_, IH, IW, CI), (KH, KW, _, CO) = sh["x"], sh["w"]
    s, dil = sh["stride"], sh["dilation"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    x = torch.randn(sh["x"], generator=g, device="cuda").bfloat16()
    w = (torch.randn(sh["w"], generator=g, device="cuda") *
         (KH * KW * CI) ** -0.5).bfloat16()
    OH, OW = kconv.out_hw(IH, IW, KH, KW, s, dil)
    plan = conv2d_plan(1, OH, OW, CI, CO, KH, KW, stride=s)

    def run(boh, bow, bco, splits):
        return lambda: kconv.conv2d_cuda(x, w, stride=s, dilation=dil,
                                         block_oh=boh, block_ow=bow,
                                         block_co=bco, splits=splits)
    points = []
    for boh, bow, bco in sorted(CONV_TILES):
        steps = conv2d_k_steps(CI, KH, KW, stride=s, block_ow=bow)
        for sp in SPLITS:
            if sp > steps or -(-steps // -(-steps // sp)) != sp:
                continue
            points.append((cs.device_ms(run(boh, bow, bco, sp), iters,
                                        flush), boh, bow, bco, sp))
    points.sort()
    tile = plan[:4]
    print(json.dumps(dict(
        sweep="conv2d", workload=name, plan=plan._asdict(),
        plan_device_ms=cs.device_ms(run(*tile), iters, flush),
        best=[dict(device_ms=t, block_oh=a, block_ow=b, block_co=c,
                   splits=d) for t, a, b, c, d in points[:6]],
        worst=[dict(device_ms=t, block_oh=a, block_ow=b, block_co=c,
                    splits=d) for t, a, b, c, d in points[-2:]],
        points=len(points))), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--convs", default=",".join(CONVS))
    ap.add_argument("--iters", type=int, default=10)
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("sweep_conv_decode_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    torch.backends.cudnn.allow_tf32 = False
    from repro_torch.kernels import _build
    _build.build_all(("flash_decode", "conv2d"))
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        decode_sweep(cs, flush, args.iters)
        for name in args.convs.split(","):
            conv_sweep(cs, name, flush, args.iters)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
