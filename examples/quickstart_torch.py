"""Quickstart on the PyTorch / H100 port: the paper's scheduling
methodology end to end on one GEMM.

1. Formulate C = A @ B as an NDRange tensor op (paper Eq. 1).
2. Search the bandwidth-minimizing TEU tile (Eq. 4).
3. Plan FIFO-mesh data exchange on a 4x4 TEU mesh (Fig. 2).
4. Order the grid for operand sharing, take the Hopper tile of the H100
   tile search, and run ``ops.matmul`` (the hand-written wgmma kernel on
   the card) against its plain PyTorch version.

Steps 1-3 and the grid order print what ``examples/quickstart.py`` prints.

Run:  PYTHONPATH=src python examples/quickstart_torch.py [--device cpu]
"""
import argparse

import torch

from repro_torch.core import (TEU_BUFFER, matmul_block_shapes, matmul_op,
                              order_grid_for_sharing, plan_mesh_exchange,
                              search_tiles)
from repro_torch.device import resolve_device
from repro_torch.kernels import matmul as matmul_kernel
from repro_torch.kernels import ops


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None,
                    help="cuda (default; raises without a card) or cpu "
                         "(the kernel's plain version)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    # 1. NDRange form
    op = matmul_op(1024, 1024, 1024)
    print(f"workload: {op.name}, {op.total_macs()/1e6:.0f} MMACs")

    # 2. TEU tile (paper hardware: 2x16KB inputs, 5KB PSums, 32 PEs)
    sched = search_tiles(op, TEU_BUFFER)
    print(f"TEU tile: {sched.tile}  -> {sched.bytes_per_mac:.4f} bytes/MAC")

    # 3. FIFO-mesh exchange on a 4x4 mesh of TEUs
    plan = plan_mesh_exchange(op, sched.tile, (4, 4))
    print(f"exchange: share A along '{plan.row_axis}', B along "
          f"'{plan.col_axis}' -> {plan.sharing_factor:.1f}x fewer GLB "
          f"fetches, {plan.fifo_hop_bytes/1e6:.1f} MB over FIFOs instead")

    # 4. The same schedule on the H100: the grid's residency order, the
    # wgmma tile from the shared-memory / register-budget tile search, and
    # the kernel on the card against its plain version
    order = order_grid_for_sharing(op, sched.tile)
    print(f"grid order (VMEM residency): {order.order}")
    bm, bn, bk = matmul_block_shapes(1024, 1024, 1024)
    print(f"Hopper wgmma tile (H100 tile search): ({bm}, {bn}, {bk})")

    dtype = torch.bfloat16 if dev.type == "cuda" else torch.float32
    gen = torch.Generator().manual_seed(0)
    a = torch.randn(1024, 1024, generator=gen).to(dev, dtype)
    b = torch.randn(1024, 1024, generator=gen).to(dev, dtype)
    ops.reset_launches()
    out = ops.matmul(a, b)
    launches = dict(ops.LAUNCHES)
    want = matmul_kernel.matmul_plain(a, b, block_k=bk)
    # chip_smoke.py's matmul check: one bf16 ulp of the value plus 1e-3
    # of the outputs' scale (std 32 here: 1024 unit products summed), for
    # f32 sums taken in another order
    tol = 2.0 ** -7 * want.float().abs() + 1e-3 * 32
    err = (out.float() - want.float()).abs()
    assert bool((err <= tol).all()), f"max |err| {err.max().item()}"
    if dev.type == "cuda":
        assert launches.get("matmul", 0) == 1, launches
        print(f"ops.matmul on {torch.cuda.get_device_name(dev)}: the wgmma "
              f"kernel (1 launch) matches its plain version, max |err| "
              f"{err.max().item():.3g} — done.")
    else:
        print(f"ops.matmul on the CPU (its plain version) matches, max "
              f"|err| {err.max().item():.3g} — done.")


if __name__ == "__main__":
    main()
