"""The training window's model flops over its seconds, as a share of the
card's bf16 peak: 6 flops a parameter a token (forward and backward; the
lm_head, not the embedding lookup) and 12 head_dim flops a head a layer
for each (q, k) pair under the causal mask; the recompute is not counted.
Counted by the benchmark from the configuration's shapes."""
from bench.harness.work import PEAK_BF16_FLOPS

SOURCE = "host_clock"
LAYER = "model step"
UNIT = "%"
MOVES = "train_tok_s"


def read(rec):
    flops = rec.window.get("model_flops")
    if not flops or rec.window_s <= 0:
        return None
    return 100.0 * flops / (rec.window_s * PEAK_BF16_FLOPS)
