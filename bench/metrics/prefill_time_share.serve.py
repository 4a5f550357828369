"""Share of the serving window's model-call time spent in prefill calls:
the engine's own ``prefill`` and ``decode`` spans (telemetry on in the
traced run's window; each ends after the tick's picked ids reach the
host, so it covers the call's device work)."""
SOURCE = "program_span"
LAYER = "engine tick loop"
UNIT = "%"
MOVES = "ttft_p95_ms"


def read(rec):
    spans = rec.window.get("spans") or {}
    pre, dec = spans.get("prefill", 0.0), spans.get("decode", 0.0)
    if pre + dec <= 0:
        return None
    return 100.0 * pre / (pre + dec)
