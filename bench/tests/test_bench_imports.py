"""Nothing a measured run loads is JAX or the JAX package (top-level
names compared whole: the port's name begins with the JAX package's), and
the reference imports nothing of the program."""
import ast
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[2]

PROBE = r'''
import sys
sys.path[:0] = [{src!r}, {root!r}]
import runpy
run = runpy.run_path({run!r}, run_name="bench_run")
from bench.harness import cell, serve_cell, train_cell, trace, faults
from bench.reference import transformer
import repro_torch.launch.serve, repro_torch.training, repro_torch.optim
import repro_torch.kernels._build, repro_torch.kernels.ops
import repro_torch.models.transformer, repro_torch.obs
print("forbidden:" + ",".join(cell.forbidden_modules()))
'''


def test_no_jax_and_no_reference_package_loaded():
    code = PROBE.format(src=str(ROOT / "src"), root=str(ROOT),
                        run=str(ROOT / "bench" / "run.py"))
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, timeout=120, cwd=ROOT)
    assert out.returncode == 0, out.stderr[-2000:]
    assert out.stdout.strip().splitlines()[-1] == "forbidden:"


def test_forbidden_names_compared_whole():
    from bench.harness import cell
    assert cell.forbidden_modules(["repro_torch", "repro_torch.models",
                                   "jaxtyping", "reproducible", "os"]) == []
    assert cell.forbidden_modules(["repro.sub", "jax", "flax.linen",
                                   "jaxlib"]) == ["flax", "jax", "jaxlib",
                                                  "repro"]


def _imports(path: Path) -> set:
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            names.add(node.module.split(".")[0])
    return names


def test_reference_imports_nothing_of_the_program():
    for path in (ROOT / "bench" / "reference").glob("*.py"):
        assert not _imports(path) & {"repro_torch", "repro", "jax",
                                     "bench"}, path
