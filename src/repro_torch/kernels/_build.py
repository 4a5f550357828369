"""Build and load the hand-written CUDA kernels of ``kernels/csrc``.

Each ``csrc/<name>.cu`` compiles on first use into its own shared library
with a plain C interface, loaded through ``ctypes``:

    nvcc -gencode arch=compute_90a,code=sm_90a -std=c++17 -O3 -shared \
        -Xcompiler -fPIC -Xptxas=-v \
        -o build/kernels/<name>-<hash>.so csrc/<name>.cu

The output lands in ``build/kernels/`` at the root of the checkout (git
ignores it), named by a hash of the source, of every ``csrc/*.cuh`` header
it includes (``hopper.cuh``: the mbarrier, TMA and ``wgmma`` helpers) and
of the flags, so an edited source or header rebuilds and an unchanged one
loads at once.  ``ptxas``'s report of registers, shared memory and spills
goes to ``<name>-<hash>.log`` beside it (:func:`ptxas_report` reads it).
TMA descriptors are encoded on the host inside the C entry points, through
``cuTensorMapEncodeTiled`` taken from the driver with
``cudaGetDriverEntryPoint``: nothing links ``-lcuda``.  ``build_all``
starts one ``nvcc`` per source, all at the same time.
Nothing here runs when the module is imported.

Every C entry point takes pointers and the CUDA stream as ``void*``, launches
on that stream and returns ``cudaGetLastError()``; :func:`check` raises on a
non-zero value.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import threading
from pathlib import Path

import torch

CSRC = Path(__file__).resolve().parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[3] / "build" / "kernels"
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17",
              "-O3", "-shared", "-Xcompiler", "-fPIC", "-Xptxas=-v")
SOURCES = ("flash_fwd", "flash_bwd", "paged_decode", "flash_decode",
           "matmul", "conv2d", "correlation")

# Launches of each CUDA kernel route since the last reset
# (``ops.reset_launches``): a plain integer per route, incremented by the
# route's launcher (``*_cuda``) right after the launch is checked, and
# nowhere else.  ``flash_fwd``, ``flash_bwd_dq``, ``flash_bwd_dkv`` and
# ``matmul`` are the tensor-core (wgmma) routes; the ``*_simt`` keys the
# CUDA-core kernels kept for f32 and for operands TMA cannot take;
# ``matmul_gemv`` the split-K kernel pair for M = 1.
LAUNCHES = {"flash_fwd": 0, "flash_fwd_simt": 0, "flash_bwd_dq": 0,
            "flash_bwd_dkv": 0, "flash_bwd_dq_simt": 0,
            "flash_bwd_dkv_simt": 0, "paged_decode_bf16": 0,
            "paged_decode_int8": 0, "flash_decode": 0, "matmul": 0,
            "matmul_gemv": 0, "matmul_simt": 0, "conv2d": 0,
            "correlation": 0}

_LIBS: dict[str, ctypes.CDLL] = {}
_LOCK = threading.Lock()


def _nvcc() -> str:
    path = shutil.which("nvcc") or "/usr/local/cuda/bin/nvcc"
    if not os.path.exists(path):
        raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                           "build only on a machine with the CUDA toolkit")
    return path


_INCLUDE = re.compile(rb'^\s*#\s*include\s+"([^"]+)"', re.M)


def _headers(path: Path) -> list[Path]:
    """Every header of ``csrc`` that ``path`` includes, directly or not."""
    out: list[Path] = []
    for m in _INCLUDE.finditer(path.read_bytes()):
        h = CSRC / m.group(1).decode()
        if h not in out:
            out += [h, *(x for x in _headers(h) if x not in out)]
    return out


def _target(name: str) -> Path:
    src = CSRC / f"{name}.cu"
    blob = b"".join(p.read_bytes() for p in (src, *_headers(src)))
    h = hashlib.sha256(blob + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return BUILD_DIR / f"{name}-{h}.so"


def _start(name: str) -> tuple[Path, Path, subprocess.Popen] | None:
    out = _target(name)
    if out.exists():
        return None
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    tmp = out.with_suffix(f".{os.getpid()}.tmp.so")
    cmd = [_nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
    proc = subprocess.Popen(cmd, stdout=subprocess.PIPE,
                            stderr=subprocess.STDOUT, text=True)
    return out, tmp, proc


def _finish(name: str, job) -> None:
    if job is None:
        return
    out, tmp, proc = job
    log, _ = proc.communicate()
    if proc.returncode != 0:
        tmp.unlink(missing_ok=True)
        raise RuntimeError(f"nvcc failed for csrc/{name}.cu "
                           f"(exit {proc.returncode}):\n{log}")
    out.with_suffix(".log").write_text(log)
    os.replace(tmp, out)


def build_all(names=SOURCES) -> None:
    """Compile every named source that has no up-to-date library yet, one
    ``nvcc`` process per source, all started together."""
    with _LOCK:
        jobs = [(n, _start(n)) for n in names]
        errors = []
        for n, job in jobs:
            try:
                _finish(n, job)
            except RuntimeError as e:       # wait for every nvcc first
                errors.append(str(e))
        if errors:
            raise RuntimeError("\n".join(errors))


def build_log(name: str) -> str:
    """What ``nvcc`` printed for the current build of ``name``."""
    return _target(name).with_suffix(".log").read_text()


_PTXAS_ENTRY = re.compile(r"Compiling entry function '(\S+)'")
_PTXAS_NUM = {"registers": re.compile(r"Used (\d+) registers"),
              "spill_stores": re.compile(r"(\d+) bytes spill stores"),
              "spill_loads": re.compile(r"(\d+) bytes spill loads"),
              "stack": re.compile(r"(\d+) bytes stack frame"),
              "smem": re.compile(r"(\d+) bytes smem")}


def ptxas_report(log: str) -> list[dict]:
    """One record per kernel of a ``ptxas -v`` log: its (mangled) name, and
    its registers, stack frame, spill stores and loads and static shared
    memory in bytes (0 where ptxas prints none)."""
    out: list[dict] = []
    for line in log.splitlines():
        m = _PTXAS_ENTRY.search(line)
        if m:
            out.append({"kernel": m.group(1), **dict.fromkeys(_PTXAS_NUM, 0)})
            continue
        if out:
            for key, rx in _PTXAS_NUM.items():
                hit = rx.search(line)
                if hit:
                    out[-1][key] = int(hit.group(1))
    return out


def check_device(t: torch.Tensor) -> None:
    """The kernels are built for sm_90a: refuse any other card."""
    cap = torch.cuda.get_device_capability(t.device)
    if cap != (9, 0):
        raise RuntimeError(f"repro_torch CUDA kernels need an sm_90 (Hopper) "
                           f"device; {t.device} has capability {cap}")


def load(name: str) -> ctypes.CDLL:
    """The loaded library for ``csrc/<name>.cu``, built on first use."""
    lib = _LIBS.get(name)
    if lib is None:
        build_all((name,))
        lib = ctypes.CDLL(str(_target(name)))
        _LIBS[name] = lib
    return lib


def bind(name: str, fn: str, *argtypes) -> ctypes._CFuncPtr:
    """C entry ``fn`` of ``csrc/<name>.cu``, with ``argtypes`` followed by
    the stream (``void*``); it returns an int (the CUDA error code)."""
    f = getattr(load(name), fn)
    if f.argtypes is None:
        f.argtypes = [*argtypes, ctypes.c_void_p]
        f.restype = ctypes.c_int
    return f


def stream_ptr(t: torch.Tensor) -> int:
    return torch.cuda.current_stream(t.device).cuda_stream


def check(err: int, what: str) -> None:
    if err != 0:
        raise RuntimeError(f"{what}: CUDA error {err} at launch")
