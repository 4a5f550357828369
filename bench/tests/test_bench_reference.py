"""The plain reference against the port on the CPU at a tiny size, and
the harness's whole run (set-up, window, check) on a tiny cell."""
from pathlib import Path

import pytest
import torch

from bench.harness.cell import run_cell
from bench.harness.spec import BENCH, load_cell, model_sizes, port_bundle
from bench.harness.tiny import shrink
from bench.harness.weights import make_weights
from bench.reference import transformer as ref

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
TRAIN, SERVE = "qwen3-4b.train.s4k", "olmoe-1b-7b.serve.c64"


def _f32(cell):
    cell.config["torch_dtype"] = "float32"
    return cell


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_reference_logits_equal_the_port_forward(name):
    cell = _f32(shrink(load_cell(ROOT, name)))
    s = model_sizes(cell.config)
    params = make_weights(cell.config, 2 ** 33 + 1, CPU)
    tokens = torch.randint(0, s["vocab"], (1, 24),
                           generator=torch.Generator().manual_seed(0))
    with torch.no_grad():
        got, _ = port_bundle(cell.config).forward(params, {"tokens": tokens})
    want = ref.logits(params, tokens[0], s)
    torch.testing.assert_close(got[0], want, atol=2e-5, rtol=0)


@pytest.mark.parametrize("name", [TRAIN, SERVE])
def test_whole_run_is_correct_on_a_tiny_cell(name, tick_clock):
    cell = shrink(load_cell(ROOT, name))
    out = run_cell(cell, 2 ** 31 + 7, 1.5, False, CPU, t_start=0.0,
                   bench_dir=BENCH)
    assert out["correct"], out["checks"]
    assert list(out)[-1] == "checks"
    assert out["attempted"] > 0 and out["failed"] == 0
    assert {m["name"] for m in cell.end_to_end} >= set(out["metrics"])
    assert "setup_s" in out["metrics"]
    for c in out["checks"].values():
        assert c["value"] <= c["limit"]
