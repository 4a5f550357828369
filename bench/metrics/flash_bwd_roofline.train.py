"""The attention backward's share of its roofline in the traced training
slice: for every backward (one dq launch each), the products the
gradients need over the causal pairs (10 head_dim flops a pair) and its
inputs and gradients moved once, over the device time of the kernels
named here (dq, dk/dv and its partial sum), against the bf16 peak and HBM
bandwidth."""
from bench.harness import work

SOURCE = "device_trace"
LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("flash_bwd_",)
CALLS = "flash_bwd_dq"


def read(rec):
    sl = rec.slice
    if sl is None:
        return None
    t, _ = sl.kernel_time(lambda name: any(k in name for k in KERNELS))
    _, n = sl.kernel_time(lambda name: CALLS in name)
    if not n or t <= 0:
        return None
    s, c = rec.sizes, sl.counts
    f, b = work.flash_bwd(c["batch"], s["n_heads"], s["n_kv_heads"],
                          c["seq"], c["seq"], s["head_dim"])
    return 100.0 * work.roofline_s(n * f, n * b) / t
