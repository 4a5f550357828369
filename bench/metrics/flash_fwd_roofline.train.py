"""The attention forward's share of its roofline in the traced training
slice: the work the layer's shapes need (causal (q, k) pairs, 4 head_dim
flops each; q, k, v read and o written once) for every launch, over the
device time of the kernels named here, against the bf16 peak and HBM
bandwidth."""
from bench.harness import work

SOURCE = "device_trace"
LAYER = "kernels"
UNIT = "%"
MOVES = "train_tok_s"
KERNELS = ("flash_fwd",)


def read(rec):
    sl = rec.slice
    if sl is None:
        return None
    t, n = sl.kernel_time(lambda name: any(k in name for k in KERNELS))
    if not n or t <= 0:
        return None
    s, c = rec.sizes, sl.counts
    f, b = work.flash_fwd(c["batch"], s["n_heads"], s["n_kv_heads"],
                          c["seq"], c["seq"], s["head_dim"])
    return 100.0 * work.roofline_s(n * f, n * b) / t
