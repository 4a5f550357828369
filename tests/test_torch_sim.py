"""The port's copy of the paper's simulator (``repro_torch.sim``: archs and
the cycle-approximate dataflow model) against the JAX package's: every
``SimResult`` field equal, exactly, for every architecture, PE count and
catalog workload, computed in the same run (the two run the same integer
and float arithmetic on copies of one scheduler); the eight Table III /
Fig. 3-4 assertions of ``tests/test_sim.py`` on the port; and the
example script printing what the reference's prints."""
import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest

pytest.importorskip("torch")

from repro import sim as ref_sim  # noqa: E402
from repro_torch import sim as pt_sim  # noqa: E402
from repro_torch.sim import (CLASSIC, MODERN, SPATIAL, by_name,  # noqa: E402
                             eyeriss, simulate, summarize, tpu, vectormesh)

ROOT = Path(__file__).resolve().parents[1]
ARCHS = ("tpu", "eyeriss", "vectormesh")
PES = (128, 512)
NAMES = [w.name for w in ref_sim.ALL]


def test_exports_are_the_reference_exports():
    assert pt_sim.__all__ == ref_sim.__all__
    assert list(pt_sim.archs.ARCHS) == list(ref_sim.archs.ARCHS)


@pytest.mark.parametrize("n_pe", PES)
@pytest.mark.parametrize("arch", ARCHS)
def test_arch_configs_equal_reference(arch, n_pe):
    got = getattr(pt_sim, arch)(n_pe)
    want = getattr(ref_sim, arch)(n_pe)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.peak_macs_per_s == want.peak_macs_per_s
    assert got.n_units == want.n_units


@pytest.mark.parametrize("name", NAMES)
@pytest.mark.parametrize("n_pe", PES)
@pytest.mark.parametrize("arch", ARCHS)
def test_sim_result_equals_reference(arch, n_pe, name):
    got = pt_sim.simulate(getattr(pt_sim, arch)(n_pe), pt_sim.by_name(name))
    want = ref_sim.simulate(getattr(ref_sim, arch)(n_pe),
                            ref_sim.by_name(name))
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
    assert got.roofline_frac == want.roofline_frac
    op_p, op_r = pt_sim.by_name(name).op, ref_sim.by_name(name).op
    assert pt_sim.roofline_gmacs(getattr(pt_sim, arch)(n_pe), op_p) == \
        ref_sim.roofline_gmacs(getattr(ref_sim, arch)(n_pe), op_r)


@pytest.mark.parametrize("n_pe", PES)
@pytest.mark.parametrize("arch", ARCHS)
def test_summary_equals_reference(arch, n_pe):
    got = summarize([simulate(getattr(pt_sim, arch)(n_pe), w)
                     for w in CLASSIC])
    want = ref_sim.summarize([ref_sim.simulate(getattr(ref_sim, arch)(n_pe),
                                               w) for w in ref_sim.CLASSIC])
    assert got == want


# ---------------------------------------------------------------------------
# tests/test_sim.py's assertions, on the port
# ---------------------------------------------------------------------------

@pytest.fixture(scope="module")
def table3():
    out = {}
    for n_pe in PES:
        for name, mk in (("tpu", tpu), ("eyeriss", eyeriss),
                         ("vectormesh", vectormesh)):
            rs = [simulate(mk(n_pe), w) for w in CLASSIC]
            out[(n_pe, name)] = summarize(rs)
    return out


def test_glb_reduction_vs_tpu(table3):
    """Abstract: 'reduce global buffer fetches by 2-22x' (TPU is the 22x
    end; paper Table III: 935/42=22.3 at 128 PE, 534/29=18.4 at 512)."""
    for n_pe in PES:
        ratio = table3[(n_pe, "tpu")]["norm_glb"] / \
            table3[(n_pe, "vectormesh")]["norm_glb"]
        assert 10 <= ratio <= 40, ratio


def test_glb_reduction_vs_eyeriss(table3):
    """Paper: VectorMesh consumes 2-4x less GLB bandwidth than Eyeriss."""
    ratio = table3[(128, "eyeriss")]["norm_glb"] / \
        table3[(128, "vectormesh")]["norm_glb"]
    assert 1.5 <= ratio <= 8, ratio


def test_dram_reduction_vs_tpu(table3):
    """Paper: 2-5x DRAM bandwidth reduction vs TPU."""
    ratio = table3[(128, "tpu")]["norm_dram"] / \
        table3[(128, "vectormesh")]["norm_dram"]
    assert 1.8 <= ratio <= 6, ratio


def test_dram_competitive_with_eyeriss(table3):
    """Paper: -14%..+44% DRAM vs Eyeriss (i.e. roughly comparable)."""
    for n_pe in PES:
        ratio = table3[(n_pe, "eyeriss")]["norm_dram"] / \
            table3[(n_pe, "vectormesh")]["norm_dram"]
        assert 0.6 <= ratio <= 2.5, ratio


def test_vectormesh_closest_to_roofline(table3):
    """Fig. 3: VectorMesh performs closest to the roofline."""
    for n_pe in PES:
        vm = table3[(n_pe, "vectormesh")]["roofline_frac"]
        assert vm >= table3[(n_pe, "tpu")]["roofline_frac"]
        assert vm >= table3[(n_pe, "eyeriss")]["roofline_frac"]
        assert vm > 0.6


def test_absolute_performance_band(table3):
    """Paper Table III: VM performance 20 GOPS @128PE, 68 @512PE (+-30%)."""
    assert 14 <= table3[(128, "vectormesh")]["gmacs"] <= 26
    assert 48 <= table3[(512, "vectormesh")]["gmacs"] <= 88


def test_vm_supports_modern_and_spatial():
    """Fig. 4: modern CNN + spatial matching run (exclusive workloads)."""
    arch = vectormesh(512)
    for w in MODERN + SPATIAL:
        r = simulate(arch, w)
        assert r.gmacs > 0
        assert r.roofline_frac <= 1.01


def test_mobilenet_depthwise_reaches_low_roofline():
    """Fig. 4: MobileNet layers are memory-bound: low absolute perf but at
    (or near) their own roofline."""
    r = simulate(vectormesh(512), by_name("MBN_DW_S1"))
    assert r.roofline_gmacs < 30          # memory-bound roofline
    assert r.roofline_frac > 0.4


def test_example_prints_the_reference_example():
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"))

    def run(script):
        return subprocess.run([sys.executable, str(ROOT / "examples" /
                                                   script)],
                              env=env, capture_output=True, text=True,
                              timeout=300, check=True).stdout
    got = run("vectormesh_sim_torch.py")
    assert "Table III" in got and got == run("vectormesh_sim.py")
