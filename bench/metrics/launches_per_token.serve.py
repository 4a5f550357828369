"""Device operations (kernels, copies, fills) launched in the traced
slice, over the output tokens the slice produced."""
SOURCE = "device_trace"
LAYER = "engine tick loop"
UNIT = "launches/token"
MOVES = "itl_p95_ms"


def read(rec):
    sl = rec.slice
    if sl is None or not sl.device or not sl.counts.get("output_tokens"):
        return None
    return len(sl.device) / sl.counts["output_tokens"]
