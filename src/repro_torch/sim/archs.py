"""Architecture models for the paper's evaluation (§III-B): a copy of the
JAX package's ``sim/archs.py``.

Three architectures, parameterized exactly as the paper's simulation setup:
200 MHz, 6.4 GB/s DRAM (2x DDR4-1600 x16), 25.6 GB/s global buffer; per-PE
local/global buffer allocations of (0 / 0.3 / 0.6) KB and
(1.0*N_PE / 0.5*N_PE / 2) KB for TPU / Eyeriss / VectorMesh, matching the
PE-to-memory ratio of the source publications. Area factors from Table II.
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ArchConfig:
    name: str
    n_pe: int
    freq_hz: float = 200e6
    dram_bw: float = 6.4e9        # bytes/s
    glb_bw: float = 25.6e9       # bytes/s
    bytes_per_elem: int = 2      # 16-bit words
    psum_bytes: int = 4

    # local (per execution unit) organization
    pes_per_unit: int = 1
    unit_input_buffer: int = 0   # bytes per unit available for input tiles
    unit_psum_buffer: int = 0    # bytes per unit available for PSums
    mesh: tuple[int, int] = (1, 1)  # arrangement of units

    # data movement style between GLB and units
    #   fifo      — VectorMesh: share along both mesh axes, no duplication
    #   multicast — Eyeriss: share along one axis (horizontal multicast),
    #               duplicated in local buffers (capacity already tiny)
    #   systolic  — TPU: no local tiling buffers; weight-stationary array
    sharing: str = "fifo"

    glb_bytes: int = 0           # global buffer capacity
    area_factor: float = 1.0

    # systolic array shape (TPU only): (rows=reduction, cols=output-channels)
    array: tuple[int, int] = (0, 0)

    @property
    def peak_macs_per_s(self) -> float:
        return self.n_pe * self.freq_hz

    @property
    def n_units(self) -> int:
        return self.n_pe // self.pes_per_unit


def tpu(n_pe: int) -> ArchConfig:
    # 128 PE -> 8x16 array; 512 PE -> 16x32 (paper §III-B).
    array = (8, 16) if n_pe == 128 else (16, 32)
    assert array[0] * array[1] == n_pe
    return ArchConfig(
        name=f"tpu-{n_pe}",
        n_pe=n_pe,
        pes_per_unit=n_pe,
        unit_input_buffer=0,
        unit_psum_buffer=0,
        mesh=(1, 1),
        sharing="systolic",
        glb_bytes=int(1.0 * 1024) * n_pe,
        area_factor=0.46,
        array=array,
    )


def eyeriss(n_pe: int) -> ArchConfig:
    mesh = (8, 16) if n_pe == 128 else (16, 32)
    return ArchConfig(
        name=f"eyeriss-{n_pe}",
        n_pe=n_pe,
        pes_per_unit=1,
        # 0.3 KB local per PE, split input/psum (row-stationary keeps a filter
        # row + input sliver + a psum row).
        unit_input_buffer=int(0.2 * 1024),
        unit_psum_buffer=int(0.1 * 1024),
        mesh=mesh,
        sharing="multicast",
        glb_bytes=int(0.5 * 1024) * n_pe,
        area_factor=1.00,
    )


def vectormesh(n_pe: int) -> ArchConfig:
    # 128 PE -> 2x2 TEUs of 32 PEs; 512 -> 4x4 (paper §III-B).
    mesh = (2, 2) if n_pe == 128 else (4, 4)
    assert mesh[0] * mesh[1] * 32 == n_pe
    return ArchConfig(
        name=f"vectormesh-{n_pe}",
        n_pe=n_pe,
        pes_per_unit=32,
        unit_input_buffer=2 * 16 * 1024,   # two 16 KB input buffers
        unit_psum_buffer=5 * 1024,         # 5 KB PSum buffer
        mesh=mesh,
        sharing="fifo",
        glb_bytes=2 * 1024,                # does not grow with N_PE (§III-B)
        area_factor=1.04,
    )


ARCHS = {
    "tpu": tpu,
    "eyeriss": eyeriss,
    "vectormesh": vectormesh,
}
