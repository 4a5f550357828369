"""Reproduce the paper's evaluation: Table III + Fig. 3/4 numbers, on the
PyTorch port's copy of the simulator (``repro_torch.sim``); it
prints the same numbers as ``examples/vectormesh_sim.py``.

Run:  PYTHONPATH=src python examples/vectormesh_sim_torch.py
"""
from repro_torch.sim import (CLASSIC, MODERN, SPATIAL, eyeriss, simulate,
                             summarize, tpu, vectormesh)


def main():
    print("=== Table III (normalized access = bytes / 1000 MACs) ===")
    print(f"{'arch':18s} {'GLB':>8s} {'DRAM':>8s} {'GMAC/s':>8s} "
          f"{'rf':>5s}")
    for n_pe in (128, 512):
        for name, mk in (("tpu", tpu), ("eyeriss", eyeriss),
                         ("vectormesh", vectormesh)):
            s = summarize([simulate(mk(n_pe), w) for w in CLASSIC])
            print(f"{name+'-'+str(n_pe):18s} {s['norm_glb']:8.1f} "
                  f"{s['norm_dram']:8.1f} {s['gmacs']:8.1f} "
                  f"{s['roofline_frac']:5.2f}")

    print("\n=== Fig. 4: VectorMesh-exclusive workloads (512 PE) ===")
    for w in MODERN + SPATIAL:
        r = simulate(vectormesh(512), w)
        print(f"{w.name:16s} {r.gmacs:7.2f} / {r.roofline_gmacs:7.2f} GMAC/s "
              f"({r.roofline_frac:.2f} of roofline)")


if __name__ == "__main__":
    main()
