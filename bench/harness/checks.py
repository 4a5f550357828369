"""The numbers that decide ``correct``, each against the limit its cell's
file states (``check`` in ``bench/workloads/<cell>.json``)."""
from __future__ import annotations

import statistics


def norm_gaps(prog: dict[str, float], ref: dict[str, float],
              keep=None) -> tuple[float, str]:
    """The worst leaf's gap between the program's norm and the
    reference's, over the reference's norm of that leaf or of the median
    leaf, whichever is larger.  ``keep``: the leaves compared (all).
    -> (gap, leaf)."""
    med = statistics.median(ref.values())
    worst, at = 0.0, ""
    for k in (keep if keep is not None else ref):
        g = abs(prog[k] - ref[k]) / max(ref[k], med, 1e-30)
        if g >= worst:
            worst, at = g, k
    return worst, at


def moved_leaves(ref_grad: dict[str, float], rule: float = 1e-3) -> list:
    """The leaves whose change is compared: those whose reference
    gradient is at least ``rule`` of the median leaf's (a leaf whose
    gradient is nought to rounding moves under Adam by round-off
    alone)."""
    med = statistics.median(ref_grad.values())
    return [k for k, v in ref_grad.items() if v >= rule * med]


def train_numbers(prog: dict, ref: dict) -> dict:
    """``prog`` / ``ref``: {"losses", "grad_norms", "change_norms"} ->
    {name: (value, where)}."""
    loss = max(abs(a - b) / abs(b) for a, b in
               zip(prog["losses"], ref["losses"], strict=True))
    grad, g_at = norm_gaps(prog["grad_norms"], ref["grad_norms"])
    keep = moved_leaves(ref["grad_norms"])
    change, c_at = norm_gaps(prog["change_norms"], ref["change_norms"],
                             keep)
    return {"loss_gap": (loss, "steps 1-%d" % len(ref["losses"])),
            "grad_norm_gap": (grad, g_at),
            "update_norm_gap": (change, c_at)}


def logit_gaps(ref_logits, picked) -> list[float]:
    """At each position, the gap by which the picked token's reference
    logit lies below the reference's best.  ``ref_logits``: (n, vocab)
    float32, ``picked``: (n,) ids."""
    best = ref_logits.max(-1).values
    got = ref_logits.gather(-1, picked.long()[:, None])[:, 0]
    return (best - got).tolist()


def verdict(numbers: dict, limits: dict) -> tuple[bool, dict]:
    """-> (every number within its limit, {name: {"value", "limit"}}).
    A number with no limit, or that is not finite, fails."""
    out, ok = {}, True
    for name, (value, _) in numbers.items():
        lim = limits.get(name)
        good = lim is not None and value == value and value <= lim
        ok &= good
        out[name] = {"value": value, "limit": lim}
    return ok, out
