"""The serving window's model flops over its seconds, as a share of the
card's bf16 peak: 2 flops a parameter a token for every prompt token
prefilled and every output token decoded in the window (the experts a
token is routed to, not all of them; the lm_head; not the embedding
lookup), plus 4 head_dim flops a head a layer for each (q, k) pair
attended under the causal mask.  Counted by the benchmark from the
configuration's shapes and the requests' lengths."""
from bench.harness.work import PEAK_BF16_FLOPS

SOURCE = "host_clock"
LAYER = "model step"
UNIT = "%"
MOVES = "serve_tok_s"


def read(rec):
    flops = rec.window.get("model_flops")
    if not flops or rec.window_s <= 0:
        return None
    return 100.0 * flops / (rec.window_s * PEAK_BF16_FLOPS)
