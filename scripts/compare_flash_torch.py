#!/usr/bin/env python3
"""Time the flash forward and backward kernels of one checkout on the card,
so that two checkouts can be compared within one machine's run:

    python3 scripts/compare_flash_torch.py ROOT [ROOT ...]

Each ROOT is the root of a checkout (its ``chip_smoke.py`` and ``src/``).
For each ROOT in the order given, a fresh process imports that checkout's
``chip_smoke`` and runs its ``check_flash`` (the wgmma forward at the train
phase's B 2, S 2048, 32/8 heads) and ``check_flash_bwd`` (the wgmma dq and
dk/dv kernels at the same shape), which hold each kernel against its plain
version and time it after an L2 flush; the kernels build into that
checkout's own ``build/``.  Give the roots in turns (parent, change,
change, parent) to see the spread.  Prints one JSON line per (root,
kernel) with ``ms`` and ``device_ms``, then the card's name and power
limit."""
from __future__ import annotations

import json
import subprocess
import sys
from pathlib import Path

CHILD = """
import json, sys, torch
root = sys.argv[1]
sys.path[:0] = [root, root + "/src"]
import chip_smoke as cs
torch.backends.cuda.matmul.allow_tf32 = False
flush = torch.empty(64 * 2 ** 20, dtype=torch.float32, device="cuda")
for row in (cs.check_flash(flush), *cs.check_flash_bwd(flush)):
    print("ROW " + json.dumps({k: row[k] for k in
                               ("name", "ms", "device_ms", "max_abs_err")}))
"""


def main(argv: list[str]) -> int:
    if not argv:
        print(__doc__, file=sys.stderr)
        return 2
    for i, root in enumerate(argv):
        root = str(Path(root).resolve())
        out = subprocess.run([sys.executable, "-c", CHILD, root],
                             capture_output=True, text=True)
        if out.returncode != 0:
            print(out.stdout[-4000:], out.stderr[-4000:], file=sys.stderr)
            return out.returncode
        for line in out.stdout.splitlines():
            if line.startswith("ROW "):
                print(json.dumps({"turn": i, "root": root,
                                  **json.loads(line[4:])}), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True)
    print(smi.stdout.strip().splitlines()[0])
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
