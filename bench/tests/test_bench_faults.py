"""Negative controls: a run with its timed path broken underneath comes
out not correct, once for each fault the cell can have; and the control,
the reference in the precision below bfloat16 put in the program's place,
fails the cell's limits (at the size a test can hold; the readings on the
card are in PERF.md)."""
from pathlib import Path

import pytest
import torch

from bench.harness import faults, train_cell
from bench.harness.cell import run_cell
from bench.harness.checks import train_numbers, verdict
from bench.harness.spec import BENCH, load_cell
from bench.harness.tiny import shrink

ROOT = Path(__file__).resolve().parents[2]
CPU = torch.device("cpu")
SEED = 2 ** 31 + 12_345


def _run(name, seconds=0.05, **fault):
    cell = shrink(load_cell(ROOT, name))
    return run_cell(cell, SEED, seconds, False, CPU, t_start=0.0,
                    bench_dir=BENCH, fault=fault)


@pytest.mark.parametrize("fault", ["unchanged_state", "half_batch"])
def test_training_fault_is_not_correct(fault):
    out = _run("qwen3-4b.train.s4k", break_step=getattr(faults, fault))
    assert not out["correct"], out["checks"]


def test_altered_token_is_not_correct(tick_clock):
    out = _run("olmoe-1b-7b.serve.c64", seconds=1.5,
               break_tokens=faults.altered_tokens(every=2))
    assert not out["correct"], out["checks"]
    assert out["checks"]["mean_logit_gap"]["value"] > \
        out["checks"]["mean_logit_gap"]["limit"]


def test_training_control_fails_the_limits():
    cell = shrink(load_cell(ROOT, "qwen3-4b.train.s4k"))
    rec = train_cell.run(cell, SEED, 0.0, False, CPU)
    rows = rec["check_inputs"]["rows"]
    ref = train_cell.reference_readings(cell, SEED, CPU, rows)
    ctl = train_cell.reference_readings(cell, SEED, CPU, rows, "fp8")
    ok, _ = verdict(train_numbers(ctl, ref), cell.workload["check"]["limits"])
    assert not ok
    ok, checks = verdict(train_numbers(rec["check_inputs"]["prog"], ref),
                         cell.workload["check"]["limits"])
    assert ok, checks
