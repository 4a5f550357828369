"""The paged decode attention's share of its roofline in the traced
serving slice: the bytes each decode row needs (its attended K and V
rows, from the benchmark's own record of each request's context, plus q
and o), in every layer of every decode call, over the device time of the
kernels named here (the split pass and its combine), against HBM
bandwidth."""
from bench.harness import work

SOURCE = "device_trace"
LAYER = "kernels"
UNIT = "%"
MOVES = "serve_tok_s"
KERNELS = ("paged_decode", "decode_combine")


def read(rec):
    sl = rec.slice
    if sl is None:
        return None
    t, n = sl.kernel_time(lambda name: any(k in name for k in KERNELS))
    live, rows = sl.counts.get("decode_live"), sl.counts.get("decode_rows")
    if not n or t <= 0 or not live:
        return None
    s = rec.sizes
    nbytes = s["n_layers"] * sum(
        work.paged_decode_bytes(lv, r, s["n_heads"], s["n_kv_heads"],
                                s["head_dim"]) for lv, r in zip(live, rows))
    return 100.0 * work.roofline_s(0.0, nbytes) / t
