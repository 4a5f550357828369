"""A later change adds a cell, a traffic mix and a per-layer metric as new
files and new BENCHMARK.json entries only: the harness finds them by
name."""
import json
import shutil
from pathlib import Path

import torch

from bench.harness.cell import run_cell
from bench.harness.spec import load_cell
from bench.harness.tiny import shrink

ROOT = Path(__file__).resolve().parents[2]

READER = '''"""Output tokens of the window (a dummy reader)."""
SOURCE = "program_counter"
LAYER = "engine tick loop"
UNIT = "tokens"
MOVES = "serve_tok_s"


def read(rec):
    return rec.window.get("output_tokens") or None
'''


def test_a_cell_mix_and_metric_added_as_files(tmp_path, tick_clock):
    bench = tmp_path / "bench"
    shutil.copytree(ROOT / "bench", bench,
                    ignore=shutil.ignore_patterns("__pycache__", "tests"))
    shutil.copy(ROOT / "BENCHMARK.json", tmp_path / "BENCHMARK.json")
    spec = json.loads((tmp_path / "BENCHMARK.json").read_text())
    # the new files
    mix = json.loads((bench / "traffic" / "azure-conv-c64.json")
                     .read_text())
    mix.update(clients=2, output_len=3)
    (bench / "traffic" / "chat-short.json").write_text(json.dumps(mix))
    (bench / "workloads" / "olmoe-1b-7b.serve.short.json").write_text(
        (bench / "workloads" / "olmoe-1b-7b.serve.c64.json").read_text())
    (bench / "metrics" / "window_tokens.serve.py").write_text(READER)
    # the new entries
    spec["workloads"].append({
        "name": "olmoe-1b-7b.serve.short", "config": "olmoe-1b-7b",
        "traffic": "chat-short", "chips": 1, "why": "a dummy cell"})
    for m in spec["end_to_end"]:
        if "olmoe-1b-7b.serve.c64" in m.get("workloads", []):
            m["workloads"].append("olmoe-1b-7b.serve.short")
    spec["per_layer"].append({
        "name": "window_tokens.serve", "unit": "tokens", "better": "higher",
        "source": "program_counter", "layer": "engine tick loop",
        "moves": "serve_tok_s", "workloads": ["olmoe-1b-7b.serve.short"]})
    (tmp_path / "BENCHMARK.json").write_text(json.dumps(spec))

    cell = load_cell(tmp_path, "olmoe-1b-7b.serve.short", bench)
    assert cell.traffic["clients"] == 2
    assert [m["name"] for m in cell.per_layer] == ["window_tokens.serve"]
    cell = shrink(cell)
    cell.traffic.update(clients=2, output_len=3)
    out = run_cell(cell, 5, 1.5, True, torch.device("cpu"), t_start=0.0,
                   bench_dir=bench)
    assert out["correct"], out["checks"]
    assert out["metrics"]["window_tokens.serve"]["value"] > 0
