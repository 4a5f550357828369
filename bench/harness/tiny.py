"""A cell cut to a size the CPU tests can hold: every width and count
shrunk, the mixes shortened, the limits kept."""
from __future__ import annotations

import copy

from .spec import Cell


def shrink(cell: Cell) -> Cell:
    cell = copy.deepcopy(cell)
    c = cell.config
    c.update(num_hidden_layers=2, hidden_size=64, num_attention_heads=4,
             num_key_value_heads=2, head_dim=16, intermediate_size=96,
             vocab_size=256)
    if c.get("num_experts"):
        c.update(num_experts=8, num_experts_per_tok=2,
                 capacity_factor=8 / 2)
    t = cell.traffic
    if cell.runner == "train":
        t.update(seq_len=32, rows=6)
        t["doc_len"] = dict(t["doc_len"], median=12, min=2, max=64)
    else:
        t.update(clients=3, output_len=5, pool=16,
                 prompt_len={"dist": "lognormal", "median": 10,
                             "sigma": 0.5, "min": 4, "max": 20})
        cell.workload["engine"].update(
            slots=3, prefill_chunk=8, prefill_token_budget=16,
            pool_tokens=3 * 40)
        cell.workload["trace_ticks"] = 2
    return cell
