"""Batched serving example on the PyTorch / H100 port: continuous
batching over a small model (``examples/serve_lm.py``'s run).

``--params DIR`` serves the ``params`` of the newest format-v2 checkpoint
in DIR (written by either package) in place of the port's seeded random
weights: given the reference's own initial weights, it prints the
reference example's greedy tokens.

Run:  PYTHONPATH=src python examples/serve_lm_torch.py --requests 8 \\
          --slots 4 [--device cpu] [--params DIR]
"""
import argparse

from repro_torch.checkpoint import CheckpointManager
from repro_torch.configs import get_bundle
from repro_torch.device import resolve_device
from repro_torch.launch.serve import run


def load_params(arch: str, path: str, device) -> dict:
    """The smoke bundle's params restored in place from the newest intact
    checkpoint under ``path`` (a tree ``{"params": ...}``)."""
    like = {"params": get_bundle(arch, smoke=True).init_params(
        0, device=resolve_device(device))}
    restored = CheckpointManager(path).restore(like)
    if restored is None:
        raise FileNotFoundError(f"no intact checkpoint under {path}")
    return like["params"]


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="qwen3-4b")
    ap.add_argument("--requests", type=int, default=8)
    ap.add_argument("--slots", type=int, default=4)
    ap.add_argument("--max-new", type=int, default=12)
    ap.add_argument("--kv-mode", default="dense",
                    choices=("dense", "paged", "paged_int8"))
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu")
    ap.add_argument("--params", default=None, metavar="DIR",
                    help="serve the params of the newest checkpoint in DIR")
    a = ap.parse_args(argv)
    params = load_params(a.arch, a.params, a.device) if a.params else None
    results = run(a.arch, smoke=True, n_requests=a.requests, slots=a.slots,
                  max_new=a.max_new, prompt_len=10, max_len=48,
                  kv_mode=a.kv_mode, device=a.device, params=params)
    for rid, toks in sorted(results.items()):
        print(f"request {rid}: generated {toks}")


if __name__ == "__main__":
    main()
