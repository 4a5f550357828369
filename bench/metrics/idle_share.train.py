"""Share of the traced slice in which no operation ran on the device:
one less the union of the device events' intervals over the slice."""
SOURCE = "device_trace"
LAYER = "device"
UNIT = "%"
MOVES = "train_tok_s"


def read(rec):
    sl = rec.slice
    if sl is None or not sl.device or sl.window_s <= 0:
        return None
    return 100.0 * (1.0 - sl.busy_s / sl.window_s)
