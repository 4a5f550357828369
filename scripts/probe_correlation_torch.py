#!/usr/bin/env python3
"""Where a CTA of the correlation wgmma kernel spends its time, on one
H100, from the repository root:

    python3 scripts/probe_correlation_torch.py [--no-math]

Builds ``src/repro_torch/kernels/csrc/correlation.cu`` with the port's nvcc
flags and clock stamps inserted at fixed lines of the wgmma kernel: each
CTA's start on the global timer and its SM, and, in SM clock cycles from
the CTA's start, when its I1 rows had arrived, the cycles its consumer
warpgroups waited on full ring stages and on their wgmma groups, spent in
the band epilogue, when the main loop and the staging barrier ended, when
the copy-out ended, and the cycles the producer waited on empty stages.
One CTA's ring is also traced use by use: the producer's wait for each
stage, each load's latency (issue to full), the interval between loads
arriving, and the producer's lag from a stage's hand-back to its reuse.
Runs the catalog correlations (FLOWNET_CORR, EVA2_MATCH) at
``correlation_plan``'s tiling, checks each output against the plain
version, and prints per shape the medians and maxima over CTAs, the CTAs'
start spread and their span on the global timer, for a call after the L2
flush (cold) and for a call right after another (warm); and the kernel's
device time with and without the stamps, beside one tiny kernel's
(``chip_smoke.device_ms``: the measurement's floor).  ``--no-math`` builds
the kernel without its wgmma instructions and band epilogue (timing only:
its outputs are wrong and not checked), so the stamps show what streaming
the rows alone costs.  One JSON line per shape, then the card's name and
power limit.

The stamps are inserted at anchors, lines of the kernel that must each
occur once: the probe stops when one has moved, and moves with the kernel.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT / "src"))

import torch  # noqa: E402

SLOTS = 28
WG_SLOTS = 11
# ring uses traced, in one CTA (the middle row block's first dy group): when
# the producer started waiting for the stage and issued the load, and when
# each consumer warpgroup saw it full and handed it back
TRACE_USES = 64
MAX_CTAS = 4096
# (anchor, replacement): the stamps, each anchor a line of the wgmma kernel
# that must occur once.  Slot 0: global time at entry; 1: SM id; 2: the
# producer's cycles waiting on empty stages; 3: when its last TMA issued;
# 4 + 11 w ..: consumer warpgroup w's first I1 chunk's arrival, cycles
# waiting on full stages, on the groups before an epilogue, in the band
# epilogue, its loop's end, its staging barrier's end, cycles issuing
# chunks (waits included), waiting there on the older groups, on I1's
# chunks, and passing rows through, and its copy-out's end; 26: global
# time at warpgroup 0's copy-out's end and 27 its cycle
DECLS = """__device__ unsigned long long corr_probe_buf[%d * %d];
__device__ __forceinline__ unsigned long long probe_gtime() {
  unsigned long long t;
  asm volatile("mov.u64 %%0, %%%%globaltimer;" : "=l"(t));
  return t;
}
__device__ __forceinline__ unsigned probe_smid() {
  unsigned s;
  asm volatile("mov.u32 %%0, %%%%smid;" : "=r"(s));
  return s;
}
constexpr int NTRACE = %d;
__device__ unsigned long long corr_probe_trace[NTRACE * 6];
""" % (MAX_CTAS, SLOTS, TRACE_USES)
EMPTY = "        mbar_wait(&empty[s], ((u / stages) & 1) ^ 1);\n"
A_FULL = "        mbar_wait(&a_full[k], p & 1);\n"
FULL = ("        mbar_wait(&full[s], (u / stages) & 1);\n"
        "        wgmma_fence();\n")
LAST_TMA = "          for (int k = 0; k < nk; ++k) load_b(j, c0 + k);\n      }\n"
WG_WAIT = ("      if (first == 1)  // the next product's one chunk may be all in "
           "flight\n        wgmma_wait<1>();\n      else if (!more)\n"
           "        wgmma_wait<0>();\n")
CHUNK_WAIT = ("        wgmma_wait<TC_GROUPS - 1>();\n"
              "        for (; rel + TC_GROUPS - 1 <= u; ++rel)\n"
              "          mbar_arrive(&empty[rel % stages]);\n")
MMA_LOOP = "      for (int k = k0; k < k1; ++k, ++u) {\n"
MMA_LOOP_END = "      }\n    };\n    // product r is done"
PASS = "      for (int i = 0; i < n_rows * nk; ++i, ++u, ++rel) {\n"
PASS_END = "        mbar_arrive(&empty[u % stages]);\n      }\n"
BAND_END = "        band_to_smem<N, true>(cur, o_d, pix, D, R, warp, lane);\n"
COPY_END = "                o_w + x * pix, gl * D, l8);\n  }\n"
ACC = "  float acc0[N / 2], acc1[N / 2];  // products alternate between the two\n"
PROBES = [
    ("namespace {\n", "namespace {\n" + DECLS),
    ("  const int consumers = rows * 128;\n",
     "  const int consumers = rows * 128;\n"
     "  unsigned long long* PB = corr_probe_buf + (blockIdx.x + gridDim.x *\n"
     "      (blockIdx.y + gridDim.y * blockIdx.z)) * %d;\n"
     "  const long long T0 = clock64();\n"
     "  if (threadIdx.x == 0) { PB[0] = probe_gtime(); PB[1] = probe_smid(); }"
     "\n  const bool TR = blockIdx.x == 0 && blockIdx.y == gridDim.y / 2 &&\n"
     "      blockIdx.z == 0;\n"
     "  unsigned long long* TRB = corr_probe_trace;\n" % SLOTS),
    ("      int u = 0;\n", "      int u = 0;\n      long long pw = 0;\n"),
    (EMPTY, "        { const long long q0 = clock64();\n"
     "        if (TR && u < NTRACE) TRB[u * 6 + 1] = q0 - T0;\n" +
     EMPTY + "        pw += clock64() - q0; }\n"),
    ("                    j_lo + j);\n",
     "                    j_lo + j);\n"
     "        if (TR && u < NTRACE) TRB[u * 6] = clock64() - T0;\n"),
    (LAST_TMA, LAST_TMA + "      PB[2] = pw; PB[3] = clock64() - T0;\n"),
    (ACC, ACC + "  long long fw = 0, ww = 0, ep = 0, is = 0, cw = 0, aw = 0,"
     " pt = 0;\n"
     "  unsigned long long* PW = PB + 4 + %d * w;\n" % WG_SLOTS +
     "  const bool lead = threadIdx.x % 128 == 0;\n  bool got_a = false;\n"),
    (A_FULL, "        const long long a0 = clock64();\n" + A_FULL +
     "        aw += clock64() - a0;\n        if (lead && !got_a) {\n"
     "          got_a = true;\n          PW[0] = clock64() - T0;\n        }\n"),
    (CHUNK_WAIT, "        const long long c0 = clock64();\n"
     "        wgmma_wait<TC_GROUPS - 1>();\n"
     "        for (; rel + TC_GROUPS - 1 <= u; ++rel) {\n"
     "          mbar_arrive(&empty[rel % stages]);\n"
     "          if (TR && lead && rel < NTRACE)\n"
     "            TRB[rel * 6 + 3 + 2 * w] = clock64() - T0;\n        }\n"
     "        cw += clock64() - c0;\n"),
    ("      for (; rel < u - first; ++rel) mbar_arrive(&empty[rel % stages]);\n",
     "      for (; rel < u - first; ++rel) {\n"
     "        mbar_arrive(&empty[rel % stages]);\n"
     "        if (TR && lead && rel < NTRACE)\n"
     "          TRB[rel * 6 + 3 + 2 * w] = clock64() - T0;\n      }\n"),
    (MMA_LOOP, "      const long long i0 = clock64();\n" + MMA_LOOP),
    (MMA_LOOP_END, "      }\n      is += clock64() - i0;\n    };\n"
     "    // product r is done"),
    (PASS, "      const long long t0 = clock64();\n" + PASS),
    (PASS_END, PASS_END + "      pt += clock64() - t0;\n"),
    ("        mbar_wait(&full[u % stages], (u / stages) & 1);\n"
     "        mbar_arrive(&empty[u % stages]);\n",
     "        mbar_wait(&full[u % stages], (u / stages) & 1);\n"
     "        if (TR && lead && u < NTRACE)\n"
     "          TRB[u * 6 + 2 + 2 * w] = clock64() - T0;\n"
     "        mbar_arrive(&empty[u % stages]);\n"
     "        if (TR && lead && u < NTRACE)\n"
     "          TRB[u * 6 + 3 + 2 * w] = clock64() - T0;\n"),
    (FULL, "        const long long f0 = clock64();\n"
     "        mbar_wait(&full[s], (u / stages) & 1);\n"
     "        if (TR && lead && u < NTRACE)\n"
     "          TRB[u * 6 + 2 + 2 * w] = clock64() - T0;\n"
     "        fw += clock64() - f0;\n        wgmma_fence();\n"),
    (WG_WAIT, "      {\n      const long long w0 = clock64();\n" + WG_WAIT +
     "      ww += clock64() - w0;\n      }\n"),
    ("      fence_regs(cur);\n",
     "      fence_regs(cur);\n      const long long e0 = clock64();\n"),
    (BAND_END, BAND_END + "      ep += clock64() - e0;\n"),
    ("  named_bar_sync(1 + w, 128);\n",
     "  if (lead) { PW[1] = fw; PW[2] = ww; PW[3] = ep; PW[6] = is;\n"
     "    PW[7] = cw; PW[8] = aw; PW[9] = pt;\n"
     "    PW[4] = clock64() - T0; }\n"
     "  named_bar_sync(1 + w, 128);\n"
     "  if (lead) PW[5] = clock64() - T0;\n"),
    (COPY_END, COPY_END + "  if (lead) PW[10] = clock64() - T0;\n"
     "  if (threadIdx.x == 0) {\n"
     "    PB[27] = clock64() - T0;\n    PB[26] = probe_gtime();\n  }\n"),
]


# ``--no-math``: the kernel without its wgmma instructions and its band
# epilogue, timing only (its outputs are wrong and not checked), so that the
# stamps show what streaming the rows alone costs
NO_MATH = [
    ("          Mma<N>::template ss<0>(",
     "          if (false) Mma<N>::template ss<0>("),
    ("      if (p == 0)\n        band_to_smem",
     "      if (false)\n        band_to_smem"),
    ("      else\n        band_to_smem<N, true>",
     "      else if (false)\n        band_to_smem<N, true>"),
]


def instrument(src: str, no_math: bool = False) -> str:
    for anchor, repl in (NO_MATH if no_math else []) + PROBES:
        if src.count(anchor) != 1:
            raise SystemExit(f"probe anchor not found once: {anchor!r}")
        src = src.replace(anchor, repl)
    return src + ('\nextern "C" int corr_probe_read(void* dst, int n) {\n'
                  "  return (int)cudaMemcpyFromSymbol(dst, corr_probe_buf,\n"
                  "                                   (size_t)n * %d * 8);\n}\n"
                  % SLOTS) + (
        'extern "C" int corr_probe_trace_read(void* dst) {\n'
        "  return (int)cudaMemcpyFromSymbol(dst, corr_probe_trace,\n"
        "                                   sizeof(corr_probe_trace));\n}\n"
        'extern "C" int corr_probe_trace_clear() {\n'
        "  static unsigned long long z[NTRACE * 6];\n"
        "  return (int)cudaMemcpyToSymbol(corr_probe_trace, z, sizeof(z));\n}\n")


def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def build(src: Path, out: Path) -> ctypes.CDLL:
    from repro_torch.kernels import _build
    out.parent.mkdir(parents=True, exist_ok=True)
    res = subprocess.run([_build._nvcc(), *_build.NVCC_FLAGS, "-I",
                          str(_build.CSRC), "-o", str(out), str(src)],
                         capture_output=True, text=True)
    if res.returncode:
        raise SystemExit(f"nvcc failed for {src}:\n{res.stdout}{res.stderr}")
    return ctypes.CDLL(str(out))


def launcher(lib: ctypes.CDLL):
    fn = lib.correlation_wgmma
    fn.argtypes = [ctypes.c_void_p] * 3 + [ctypes.c_int] * 9 + \
        [ctypes.c_void_p]
    fn.restype = ctypes.c_int

    def run(i1, i2, R, p):
        H, W, C = i1.shape
        D = 2 * R + 1
        out = torch.empty((H, W, D, D), dtype=i1.dtype, device=i1.device)
        err = fn(i1.data_ptr(), i2.data_ptr(), out.data_ptr(), H, W, C, R,
                 p.rows, p.dy_group, p.block_n, p.chunks, p.stages,
                 torch.cuda.current_stream().cuda_stream)
        if err:
            raise RuntimeError(f"correlation probe: CUDA error {err}")
        return out
    return run


def stats(x: torch.Tensor) -> dict:
    x = x.double()
    return dict(median=x.median().item(), max=x.max().item())


def trace_summary(t: torch.Tensor, stages: int) -> dict:
    """The traced CTA's ring, in cycles from its start: per use, the
    producer's wait for the stage, the load's latency (issue to the first
    warpgroup seeing it full), and the producer's lag from the stage's last
    hand-back to the load that reuses it; with the raw rows."""
    used = t[t[:, 0] > 0]
    full = [used[:, c] for c in (2, 4) if bool((used[:, c] > 0).any())]
    first = torch.stack(full).clamp_min(1).min(0).values if full else None
    lag = [(used[u, 0] - used[u - stages][[3, 5]].max()).item()
           for u in range(stages, len(used))]
    return dict(uses=len(used),
                load_latency=stats(first - used[:, 0]) if full else None,
                arrival_interval=(stats(first.diff()) if full and
                                  len(used) > 1 else None),
                producer_wait=stats(used[:, 0] - used[:, 1]),
                reuse_lag=stats(torch.tensor(lag)) if lag else None,
                rows=used.tolist())


def probe(cs, name: str, run, lib, flush, base, iters: int,
          no_math: bool) -> None:
    read = lib.corr_probe_read
    read.argtypes = [ctypes.c_void_p, ctypes.c_int]
    read.restype = ctypes.c_int
    from repro_torch.core.cuda_bridge import correlation_plan
    from repro_torch.kernels import correlation as kcorr
    case = {c["name"]: c for c in cs.catalog_cases()}[name]
    sh = case["shapes"]
    H, W, C, R = sh["H"], sh["W"], sh["C"], sh["radius"]
    g = torch.Generator(device="cuda").manual_seed(cs.SEED)
    i1, i2 = ((torch.randn((H, W, C), generator=g, device="cuda") *
               C ** -0.25).bfloat16() for _ in range(2))
    p = correlation_plan(H, W, C, R)
    want = kcorr.correlation_plain(i1, i2, radius=R)
    if not no_math:
        close = cs.closeness(run(i1, i2, R, p), want,
                             atol=cs.PAPER_ATOL["correlation"])
        cs.require(close["within_tol"], f"{name} probe build: {close}")
    stamped = cs.device_ms(lambda: run(i1, i2, R, p), iters, flush)
    plain = cs.device_ms(lambda: base(i1, i2, radius=R, plan=p), iters,
                         flush)
    tiny = torch.zeros(1, device="cuda")
    row = dict(probe="correlation", no_math=no_math, workload=name,
               plan=p._asdict(),
               device_ms=plain, device_ms_stamped=stamped,
               one_tiny_kernel_device_ms=cs.device_ms(tiny.zero_, iters,
                                                      flush),
               warm_device_ms=cs.time_ms(
                   lambda: base(i1, i2, radius=R, plan=p), iters, None,
                   covered=True)[0],
               warm_one_tiny_kernel_device_ms=cs.time_ms(
                   tiny.zero_, iters, None, covered=True)[0])
    # the stamps of one call after the flush (cold), and of a call right
    # after another (warm: inputs and code in L2)
    for key, cold in (("cold", True), ("warm", False)):
        if cold:
            flush.zero_()
        else:
            run(i1, i2, R, p)
        torch.cuda.synchronize()
        cs.require(lib.corr_probe_trace_clear() == 0, "probe trace clear")
        run(i1, i2, R, p)
        torch.cuda.synchronize()
        trace = torch.zeros(TRACE_USES * 6, dtype=torch.int64)
        cs.require(lib.corr_probe_trace_read(
            ctypes.c_void_p(trace.data_ptr())) == 0, "probe trace read")
        buf = torch.zeros(p.ctas * SLOTS, dtype=torch.int64)
        cs.require(read(ctypes.c_void_p(buf.data_ptr()), p.ctas) == 0,
                   "probe read failed")
        b = buf.view(p.ctas, SLOTS)
        wg = {}
        for w in range(p.rows):
            c = b[:, 4 + WG_SLOTS * w: 4 + WG_SLOTS * (w + 1)]
            wg[f"wg{w}"] = {k: stats(c[:, i]) for i, k in enumerate(
                ("i1_arrived", "full_wait", "wgmma_wait", "epilogue",
                 "loop_end", "barrier_end", "issue", "issue_group_wait",
                 "i1_wait", "pass_through", "copy_end"))}
        row[key] = dict(
            trace=trace_summary(trace.view(TRACE_USES, 6), p.stages),
            start_ns=stats(b[:, 0] - b[:, 0].min()),
            span_ns=(b[:, 26].max() - b[:, 0].min()).item(),
            cta_ns=stats(b[:, 26] - b[:, 0]), sms=len(set(b[:, 1].tolist())),
            cycles=dict(producer_empty_wait=stats(b[:, 2]),
                        producer_last_tma=stats(b[:, 3]),
                        copy_end=stats(b[:, 27]), **wg))
    print(json.dumps(row), flush=True)


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--no-math", action="store_true",
                    help="without the wgmma instructions and band epilogue "
                    "(timing only)")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("probe_correlation_torch: no CUDA device", file=sys.stderr)
        return 2
    cs = _chip_smoke()
    from repro_torch.kernels import _build
    from repro_torch.kernels import correlation as kcorr
    _build.build_all(("correlation",))
    src = ROOT / "build" / ("corr_probe" + "_no_math" * args.no_math) / \
        "correlation.cu"
    src.parent.mkdir(parents=True, exist_ok=True)
    src.write_text(instrument((_build.CSRC / "correlation.cu").read_text(),
                              args.no_math))
    lib = build(src, src.parent / "probe.so")
    lib.corr_probe_trace_read.argtypes = [ctypes.c_void_p]
    flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
    with torch.no_grad():
        for name in ("FLOWNET_CORR", "EVA2_MATCH"):
            probe(cs, name, launcher(lib), lib, flush,
                  kcorr.correlation_cuda, args.iters, args.no_math)
    print(cs.smi(), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
