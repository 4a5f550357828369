"""The benchmark's data files, found by the names in ``BENCHMARK.json``.

One item, one file:

  * a configuration: ``bench/configs/<config>.json`` (the published sizes
    as run, with their cuts and departures);
  * a traffic mix: ``bench/traffic/<mix>.json`` (parameters for the one
    generator in :mod:`harness.traffic`);
  * a cell: ``bench/workloads/<cell>.json`` (the runner it takes, the
    engine or optimizer settings, and the limits of its correctness check);
  * a per-layer metric: ``bench/metrics/<metric>.py`` (a reader with its
    source, layer, unit and the end-to-end metric it moves).

A later change adds a configuration, mix, cell or metric by adding its
file and its ``BENCHMARK.json`` entry; nothing here names one.
"""
from __future__ import annotations

import dataclasses
import importlib.util
import json
from pathlib import Path
from types import ModuleType
from typing import Any

BENCH = Path(__file__).resolve().parents[1]


@dataclasses.dataclass
class Cell:
    """Everything one run of one cell reads, resolved from the files."""
    name: str
    entry: dict             # the cell's BENCHMARK.json entry
    workload: dict          # bench/workloads/<cell>.json
    config: dict            # bench/configs/<config>.json
    traffic: dict           # bench/traffic/<mix>.json
    end_to_end: list        # BENCHMARK.json metrics this cell reports
    per_layer: list

    @property
    def runner(self) -> str:
        return self.workload["runner"]


def load_benchmark(root: Path) -> dict:
    with open(root / "BENCHMARK.json") as f:
        return json.load(f)


def _json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def _reports(metric: dict, cell: str) -> bool:
    """Whether ``cell`` reports ``metric``: every cell, unless the metric
    names its cells."""
    return cell in metric.get("workloads", [cell])


def load_cell(root: Path, name: str, bench_dir: Path = BENCH) -> Cell:
    """The cell ``name`` of ``root``'s BENCHMARK.json with its files, read
    from ``bench_dir`` (the folder this module lies in, unless a test
    points at another)."""
    spec = load_benchmark(root)
    entries = {w["name"]: w for w in spec["workloads"]}
    if name not in entries:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json "
                       f"(known: {sorted(entries)})")
    entry = entries[name]
    configs = {c["name"]: c for c in spec["configs"]}
    cfg_entry = configs[entry["config"]]
    config = _json(root / cfg_entry["file"])
    return Cell(
        name=name, entry=entry,
        workload=_json(bench_dir / "workloads" / f"{name}.json"),
        config=config,
        traffic=_json(bench_dir / "traffic" / f"{entry['traffic']}.json"),
        end_to_end=[m for m in spec["end_to_end"] if _reports(m, name)],
        per_layer=[m for m in spec["per_layer"] if _reports(m, name)])


def load_metric(name: str, bench_dir: Path = BENCH) -> ModuleType:
    """The reader module of per-layer metric ``name``
    (``bench/metrics/<name>.py``; a name may hold dots)."""
    path = bench_dir / "metrics" / f"{name}.py"
    mod_name = "bench_metric_" + name.replace(".", "_").replace("-", "_")
    spec = importlib.util.spec_from_file_location(mod_name, path)
    if spec is None or spec.loader is None:
        raise FileNotFoundError(path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    for attr in ("SOURCE", "LAYER", "UNIT", "MOVES", "read"):
        if not hasattr(mod, attr):
            raise AttributeError(f"metric reader {path} lacks {attr}")
    return mod


# ---------------------------------------------------------------------------
# the port's model from a configuration file
# ---------------------------------------------------------------------------

def model_sizes(config: dict) -> dict[str, Any]:
    """The sizes of a decoder-only transformer configuration (dense or
    MoE), under the published config's key names, as one flat dict the
    harness, the work arithmetic and the reference share."""
    c = config
    d = {
        "n_layers": c["num_hidden_layers"],
        "d_model": c["hidden_size"],
        "n_heads": c["num_attention_heads"],
        "n_kv_heads": c["num_key_value_heads"],
        "head_dim": c.get("head_dim") or
        c["hidden_size"] // c["num_attention_heads"],
        "d_ff": c["intermediate_size"],
        "vocab": c["vocab_size"],
        "rope_theta": float(c["rope_theta"]),
        "norm_eps": float(c["rms_norm_eps"]),
        "qk_norm": bool(c["qk_norm"]),
        "qkv_bias": bool(c.get("attention_bias", False)),
        "dtype": c["torch_dtype"],
        "init_std": float(c["initializer_range"]),
        "n_experts": c.get("num_experts", 0) or 0,
        "top_k": c.get("num_experts_per_tok", 0) or 0,
        "norm_topk_prob": bool(c.get("norm_topk_prob", True)),
        "capacity_factor": float(c.get("capacity_factor", 1.25)),
    }
    return d


def port_bundle(config: dict):
    """The port's ``ArchBundle`` for ``config``: a ``TransformerConfig``
    built from the file's sizes, run through the port's own entry points
    (``forward``, ``paged_step``)."""
    import torch

    from repro_torch.configs.base import ArchBundle
    from repro_torch.models import MoEConfig, TransformerConfig, transformer

    s = model_sizes(config)
    if not s["norm_topk_prob"] and s["n_experts"]:
        raise ValueError("the port's MoE layer renormalises the top-k "
                         "probabilities: a configuration must state "
                         "norm_topk_prob true")
    moe = MoEConfig(n_experts=s["n_experts"], top_k=s["top_k"],
                    d_ff=s["d_ff"], capacity_factor=s["capacity_factor"]) \
        if s["n_experts"] else None
    cfg = TransformerConfig(
        name=config["name"], n_layers=s["n_layers"], d_model=s["d_model"],
        n_heads=s["n_heads"], n_kv_heads=s["n_kv_heads"], d_ff=s["d_ff"],
        vocab=s["vocab"], head_dim=s["head_dim"], qk_norm=s["qk_norm"],
        qkv_bias=s["qkv_bias"], rope_theta=s["rope_theta"],
        norm_eps=s["norm_eps"], moe=moe,
        dtype=getattr(torch, s["dtype"]))
    return ArchBundle(config["name"], "moe" if moe else "dense", cfg,
                      transformer)
