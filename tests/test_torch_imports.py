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
           "repro_torch.optim.compression", "repro_torch.serving.fleet",
           "repro_torch.serving.prefix", "repro_torch.runtime.supervisor",
           "repro_torch.launch.supervisor", "repro_torch.analysis",
           "repro_torch.analysis.roofline", "repro_torch.analysis.op_cost",
           "repro_torch.analysis.kernel_work", "repro_torch.parallel.sharding",
           "repro_torch.launch.specs", "repro_torch.launch.dryrun",
           "repro_torch.obs.roofline_live", "repro_torch.serving.engine"]


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


def test_dryrun_loads_neither_jax_nor_the_reference():
    """The dry run counts on the meta device with the port alone."""
    code = ("import sys\n"
            "import repro_torch.launch.dryrun\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
            "assert not bad, bad\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))
    r = subprocess.run([sys.executable, "-c", code], env=env,
                       capture_output=True, text=True, timeout=120)
    assert r.returncode == 0, r.stderr


def test_moe_mesh_path_loads_neither_jax_nor_the_reference():
    """The MoE layer's four mesh branches and a paged engine under a mesh
    of local rings run with the port alone."""
    code = ("import sys, torch, numpy as np\n"
            "from repro_torch.models import layers as L\n"
            "from repro_torch.parallel import make_mesh, set_mesh\n"
            "from repro_torch.launch.serve import build_engine\n"
            "mesh = make_mesh((2, 4), ('data', 'model'))\n"
            "for E, S in ((8, 8), (8, 1), (6, 8), (6, 1)):\n"
            "    cfg = L.MoEConfig(n_experts=E, top_k=2, d_ff=8)\n"
            "    p = {'router': torch.randn(4, E),\n"
            "         'w_gate': torch.randn(E, 4, 8),\n"
            "         'w_up': torch.randn(E, 4, 8),\n"
            "         'w_down': torch.randn(E, 8, 4)}\n"
            "    with set_mesh(mesh):\n"
            "        L.moe_layer(torch.randn(2, S, 4), p, cfg)\n"
            "e, _ = build_engine('olmoe-1b-7b', slots=2, max_len=32,\n"
            "                    max_new=2, kv_mode='paged', page_size=8,\n"
            "                    mesh=mesh, device='cpu')\n"
            "e.submit(np.arange(5, dtype=np.int32))\n"
            "assert len(e.run()[0]) == 2\n"
            "bad = sorted(m for m in sys.modules if m.split('.')[0] in "
            "('jax', 'jaxlib', 'repro'))\n"
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
                         [ROOT / "chip_smoke.py"] +
                         sorted((ROOT / "examples").glob("*_torch.py")),
                         ids=lambda p: str(p.relative_to(ROOT)))
def test_no_jax_or_reference_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "ml_dtypes", "repro")]
    assert not bad, f"{path}: imports {bad}"


def test_entry_points_refuse_without_a_card(monkeypatch):
    """No device given and no card: raise, never drop to the CPU."""
    from repro_torch.configs import get_bundle
    from repro_torch.launch import train
    from repro_torch.launch.serve import build_engine, build_fleet, main, run
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        build_engine("qwen3-4b")
    with pytest.raises(RuntimeError, match="CUDA"):
        build_fleet("qwen3-4b", 2)
    with pytest.raises(RuntimeError, match="CUDA"):      # a worker
        main(["--arch", "qwen3-4b", "--kv-mode", "paged", "--worker"])
    with pytest.raises(RuntimeError, match="CUDA"):
        run("qwen3-4b", n_requests=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.run("qwen3-4b", steps=1)
    with pytest.raises(RuntimeError, match="CUDA"):
        get_bundle("qwen3-4b", smoke=True).init_params(0)
    engine, _ = build_engine("qwen3-4b", device="cpu")
    assert engine.device.type == "cpu"


def test_train_worker_refuses_without_a_card(monkeypatch):
    """A fleet worker given no device takes the card and raises without
    one, before it joins anything."""
    from repro_torch.launch import train
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        train.main(["--arch", "qwen3-4b", "--steps", "1",
                    "--process-id", "0", "--num-processes", "2"])


def test_supervisor_is_torch_free_and_its_workers_need_a_card(tmp_path):
    """The train supervisor imports no torch; its workers, given no
    device on a machine that shows no card, raise (the supervisor reports
    the failed fleet), and with ``--device cpu`` they train."""
    code = ("import sys\n"
            "from repro_torch.launch.supervisor import main\n"
            "rc = main(sys.argv[1:])\n"
            "assert 'torch' not in sys.modules, 'supervisor imported torch'\n"
            "sys.exit(rc)\n")
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"),
               CUDA_VISIBLE_DEVICES="", OMP_NUM_THREADS="2")
    base = ["--nprocs", "2", "--steps", "2", "--seq-len", "16",
            "--global-batch", "2", "--max-restarts-per-rank", "0",
            "--max-total-failures", "0"]
    fleet = tmp_path / "no-card"
    r = subprocess.run([sys.executable, "-c", code, *base, "--fleet-dir",
                        str(fleet)], env=env, capture_output=True,
                       text=True, timeout=180)
    assert r.returncode == 1, r.stderr
    assert '"outcome": "budget_exhausted"' in r.stdout
    logs = "".join(p.read_text() for p in fleet.glob("log_rank*.log"))
    assert "needs a CUDA device" in logs
    fleet = tmp_path / "cpu"
    r = subprocess.run([sys.executable, "-c", code, *base, "--fleet-dir",
                        str(fleet), "--device", "cpu"], env=env,
                       capture_output=True, text=True, timeout=180)
    assert r.returncode == 0, r.stderr
    assert '"outcome": "completed"' in r.stdout
