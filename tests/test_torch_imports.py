"""The port stands alone: importing it loads no JAX, no file of it (or of
chip_smoke.py) imports ``jax``, ``ml_dtypes`` or the reference package, and
its entry points refuse to run on a machine without a CUDA card unless
asked for the CPU."""
import ast
import os
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

ROOT = Path(__file__).resolve().parents[1]
PORT = ROOT / "src" / "repro_torch"
MODULES = ["repro_torch", "repro_torch.launch.serve", "repro_torch.weights",
           "repro_torch.kernels.ops", "repro_torch.kernels._build",
           "repro_torch.models.transformer", "repro_torch.serving",
           "repro_torch.configs", "repro_torch.obs",
           "repro_torch.models.layers", "repro_torch.configs.olmoe_1b_7b",
           "repro_torch.configs.granite_moe_3b",
           "repro_torch.configs.qwen2_5_14b", "repro_torch.configs.yi_9b",
           "repro_torch.configs.qwen1_5_32b",
           "repro_torch.configs.internvl2_26b",
           "repro_torch.configs.mamba2_370m",
           "repro_torch.configs.recurrentgemma_9b",
           "repro_torch.configs.whisper_medium",
           "repro_torch.models.mamba2", "repro_torch.models.recurrentgemma",
           "repro_torch.models.whisper", "repro_torch.sim.archs",
           "repro_torch.sim.simulator",
           "repro_torch.launch.train", "repro_torch.training",
           "repro_torch.optim", "repro_torch.data", "repro_torch.core",
           "repro_torch.sim", "repro_torch.checkpoint",
           "repro_torch.runtime", "repro_torch.runtime.chaos",
           "repro_torch.runtime.fault", "repro_torch.runtime.fleet",
           "repro_torch.parallel", "repro_torch.parallel.mesh",
           "repro_torch.parallel.ring_attention",
           "repro_torch.parallel.ring_matmul",
           "repro_torch.parallel.pipeline", "repro_torch.launch.mesh",
           "repro_torch.optim.compression"]


def test_import_leaves_jax_out():
    code = ("import sys\n" + "".join(f"import {m}\n" for m in MODULES) +
            "bad = sorted(m for m in sys.modules if m == 'jax' or "
            "m.startswith('jax.') or m == 'repro' or "
            "m.startswith('repro.'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def _imports(path: Path):
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            yield from (a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", sorted(PORT.rglob("*.py")) +
                         [ROOT / "chip_smoke.py"],
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_entry_points_refuse_without_a_card(monkeypatch):
    """No device given and no card: raise, never drop to the CPU."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch import train
    from repro_torch.launch.serve import build_engine, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        run("qwen3-4b", n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run("qwen3-4b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_bundle("qwen3-4b", smoke=True).init_params(0)
    engine, _ = build_engine("qwen3-4b", device="cpu")
    assert engine.device.type == "cpu"
