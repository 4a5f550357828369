"""Fleet helpers of the port.  Only :func:`tree_fingerprint` so far: the
reference's worker mode, heartbeat files and stripe / page exchanges are
not ported yet."""
from __future__ import annotations

import zlib

from repro_torch.checkpoint.manager import flatten_with_paths
from repro_torch.weights import to_numpy


def tree_fingerprint(tree) -> str:
    """Order-stable CRC32 over leaf (path, dtype, shape, bytes) — cheap
    cross-process bit-identity evidence.  The same CRC as the reference's
    ``repro.runtime.fleet.tree_fingerprint`` of the same values: a bf16
    leaf hashes the dtype name ``bfloat16`` and its raw 16-bit words."""
    crc = 0
    for path, leaf in flatten_with_paths(tree):
        arr, name = to_numpy(leaf.detach().cpu().contiguous())
        # the reference hashes np.ascontiguousarray's shape, which makes a
        # 0-d leaf (1,)
        head = f"{path}|{name}|{tuple(leaf.shape) or (1,)}|"
        crc = zlib.crc32(head.encode(), crc)
        crc = zlib.crc32(arr.tobytes(), crc)
    return f"{crc:08x}"
