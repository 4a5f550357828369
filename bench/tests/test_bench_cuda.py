"""The harness's whole run on the card at a tiny size, through the port's
CUDA kernels (``-m cuda``; skips without a card)."""
from pathlib import Path

import pytest
import torch

from bench.harness.cell import run_cell
from bench.harness.spec import BENCH, load_cell
from bench.harness.tiny import shrink

ROOT = Path(__file__).resolve().parents[2]


@pytest.fixture
def card():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA H100 (runs with -m cuda on the card)")
    from repro_torch.kernels import _build
    _build.build_all()
    return torch.device("cuda", 0)


@pytest.mark.cuda
@pytest.mark.parametrize("name", ["qwen3-4b.train.s4k",
                                  "olmoe-1b-7b.serve.c64"])
def test_tiny_cell_on_the_card(card, name):
    cell = shrink(load_cell(ROOT, name))
    out = run_cell(cell, 2 ** 31 + 99, 0.2, True, card, t_start=0.0,
                   bench_dir=BENCH)
    assert out["correct"], out["checks"]
    assert out["device"]["platform"] == "gpu"
    assert out["device"]["busy_s"] > 0
