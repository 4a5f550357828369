#!/usr/bin/env python3
"""Why the first paged decode kernel (one CTA per slot and kv head, as of
commit 03034fe) ran slower on the int8 pool than on bf16 although it reads
half the bytes, on one H100, from the repository root:

    git show 03034fe:src/repro_torch/kernels/csrc/paged_decode.cu \\
        > build/paged_decode_old.cu
    python3 scripts/probe_paged_int8_torch.py build/paged_decode_old.cu

Builds that source twice with the port's nvcc flags: as it is, and with
the int8 load's two scale multiplies taken out (``noscale``: the same
1-byte loads and conversions, no scale loads).  Times bf16, int8 and int8
without scales at ``chip_smoke.py``'s ``check_paged`` shape and lengths
(the same tokens for all three) by device time (``chip_smoke.device_ms``),
and prints, for each kernel of the old source and of the current
``csrc/paged_decode.cu``, ptxas's registers and the SASS instructions of
the kinds that differ between the forms (global loads by width, shared
stores, int-to-float conversions, shuffles), counted by ``cuobjdump``.  One
JSON line each, then the card's name and power limit.  The readings answer
PERF.md §7's question about the int8 form.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import math
import re
import shutil
import subprocess
import sys
from collections import Counter
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import numpy as np  # noqa: E402
import torch  # noqa: E402

# the old int8 load's scale multiplies, taken out for ``noscale``
SCALE_LINES = ("kx *= k_scale[so];", "vx *= v_scale[so];")
OPCODES = re.compile(r"^\s+/\*[0-9a-f]+\*/\s+(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)",
                     re.M)
KINDS = ("LDG", "STS", "LDS", "I2F", "I2FP", "F2F", "PRMT", "SHFL", "FFMA",
         "BAR")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(src: Path, out: Path) -> tuple[ctypes.CDLL, str]:
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out),
                          str(src)], capture_output=True, text=True,
                         check=True)
    return ctypes.CDLL(str(out)), res.stdout + res.stderr


def sass_counts(lib: Path) -> dict[str, dict]:
    """Per kernel (mangled name): SASS instructions by kind, the global
    loads also by width (``LDG.E.U8`` etc.)."""
    tool = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out = {}
    for block in text.split("Function : ")[1:]:
        name = block.split("\n", 1)[0].strip()
        ops = OPCODES.findall(block)
        kinds = Counter(op.split(".")[0] for op in ops)
        out[name] = dict(total=len(ops),
                         **{k: kinds.get(k, 0) for k in KINDS},
                         ldg_forms=dict(Counter(op for op in ops
                                                if op.startswith("LDG"))))
    return out


def old_call(lib: ctypes.CDLL, args: tuple):
    """The old C entry: paged_decode(8 pointers, q_dtype, quant, B, Hkv, G,
    D, page, max_pages, 11 strides, scale, stream)."""
    q, k, v, table, lens, ks, vs = args
    fn = lib.paged_decode
    fn.argtypes = ([ctypes.c_void_p] * 8 + [ctypes.c_int] * 8 +
                   [ctypes.c_longlong] * 11 + [ctypes.c_float,
                                               ctypes.c_void_p])
    fn.restype = ctypes.c_int
    B, H, D = q.shape
    _, page, Hkv, _ = k.shape
    quant = ks is not None
    out = torch.empty_like(q)
    sc = ks.stride() if quant else (0, 0, 0)
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = fn(q.data_ptr(), k.data_ptr(), v.data_ptr(),
                 ks.data_ptr() if quant else None,
                 vs.data_ptr() if quant else None, table.data_ptr(),
                 lens.data_ptr(), out.data_ptr(), 0, int(quant), B, Hkv,
                 H // Hkv, D, page, table.shape[1], q.stride(0), q.stride(1),
                 *k.stride()[:3], *sc, table.stride(0), out.stride(0),
                 out.stride(1), 1.0 / math.sqrt(D), stream)
        if err:
            raise RuntimeError(f"old paged_decode: CUDA error {err}")
        return out
    return call


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("source", type=Path, help="the old paged_decode.cu")
    ap.add_argument("--iters", type=int, default=20)
    a = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_paged_int8_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from repro_torch.kernels import _build
    from repro_torch.kernels import paged_attention as kpa
    work = ROOT / "build" / "probe"
    text = a.source.read_text()
    if not all(s in text for s in SCALE_LINES):
        raise SystemExit(f"{a.source}: not the old paged decode kernel")
    noscale = work / "paged_decode_noscale.cu"
    work.mkdir(parents=True, exist_ok=True)
    noscale.write_text(text.replace(SCALE_LINES[0], "").replace(
        SCALE_LINES[1], ""))
    libs = {}
    for tag, src in (("old", a.source), ("old_noscale", noscale)):
        lib, log = build(src, work / f"paged_decode_{tag}.so")
        libs[tag] = lib
        print(json.dumps(dict(probe="build", source=tag,
                              ptxas=_build.ptxas_report(log),
                              sass=sass_counts(work /
                                               f"paged_decode_{tag}.so"))),
              flush=True)
    _build.build_all(("paged_decode",))
    print(json.dumps(dict(probe="build", source="current",
                          ptxas=_build.ptxas_report(
                              _build.build_log("paged_decode")),
                          sass=sass_counts(_build._target("paged_decode")))),
          flush=True)

    sh = cs.PAGED_SHAPE
    MP, page = sh["max_pages"], sh["page"]
    lens_np = np.random.default_rng(cs.SEED + 1).integers(
        1, MP * page + 1, sh["B"]).astype(np.int32)
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    rows = {}
    with torch.no_grad():
        for form, quant, tag in (("bf16", False, "old"),
                                 ("int8", True, "old"),
                                 ("int8_noscale", True, "old_noscale"),
                                 ("bf16", False, "current"),
                                 ("int8", True, "current")):
            args = cs.paged_inputs(quant, lens_np, MP, cs.SEED + 2)
            f = (old_call(libs[tag], args) if tag != "current" else
                 lambda: kpa.paged_flash_decode_cuda(*args))  # noqa: E731
            if form != "int8_noscale":
                close = cs.closeness(f(), kpa.paged_flash_decode_plain(*args),
                                     atol=1e-4)
                cs.require(close["within_tol"], f"{tag} {form}: {close}")
            rows[f"{tag}:{form}"] = cs.device_ms(f, a.iters, flush)
    print(json.dumps(dict(probe="device_ms", lengths=lens_np.tolist(),
                          tokens=int(lens_np.sum()), **rows)), flush=True)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
