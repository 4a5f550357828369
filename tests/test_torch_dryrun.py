"""The port's dry run (``repro_torch.launch.dryrun``) on the meta device:
full-size cells counted under the production mesh of local rings, with
the reference's keys, the reference's skips, exact per-device argument
bytes, and ``roofline_from_cell`` reading them (CPU, no card)."""
import math

import pytest

torch = pytest.importorskip("torch")

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro_torch.configs import get_bundle  # noqa: E402
from repro_torch.launch import dryrun  # noqa: E402
from repro_torch.launch.mesh import PRODUCTION_SHAPES  # noqa: E402
from repro_torch.launch.specs import step_in_shardings  # noqa: E402
from repro_torch.parallel.mesh import make_mesh  # noqa: E402
from repro_torch.parallel.sharding import local_shape  # noqa: E402

# the keys the reference's run_cell writes for a cell that compiled
REF_KEYS = {"arch", "shape", "mesh", "status", "chips", "compile_s", "flops",
            "hlo_bytes", "collective_bytes", "collectives",
            "xla_flops_unscaled", "model_flops", "model_bytes",
            "memory_analysis"}
REF_MEMORY_KEYS = {"argument_size_gb", "output_size_gb", "temp_size_gb",
                   "peak_gb_per_device"}


@pytest.fixture
def results(tmp_path, monkeypatch):
    monkeypatch.setattr(dryrun, "RESULTS_DIR", str(tmp_path))
    return tmp_path


def _leaf_bytes(tree, specs, mesh):
    """Per-device bytes, leaf by leaf, from the specs (independent of
    ``local_nbytes``)."""
    if isinstance(tree, dict):
        return sum(_leaf_bytes(tree[k], specs[k], mesh) for k in tree)
    return math.prod(local_shape(tuple(tree.shape), specs, mesh)) * \
        tree.element_size()


def test_dense_train_cell_counts_the_placed_step(results):
    """qwen3-4b x train_4k x single on the placed state: the step counted
    on a (2, 4) mesh of local rings (``counted_on``; (16, 16) costs ~130 s
    of CPU), within 15 s of CPU time: L x 2 x 4 launches of each flash
    kernel (the forward once: the layer's recompute keeps its o and lse,
    ``transformer.SAVED``), the tensor-parallel collectives issued (the
    residual sequence-sharded: reduce-scatter and all-gather) and no ring
    hop, ``collectives_complete``, each rank's temporaries
    (divided by the model axis, not the data axis), the production
    mesh's argument bytes."""
    cell = dryrun.run_cell("qwen3-4b", "train_4k", "single", force=True)
    assert cell["status"] == "ok", cell.get("traceback")
    assert REF_KEYS <= set(cell) and "note" not in cell
    assert cell["cpu_s"] < 15.0 and cell["chips"] == 256
    assert cell["counted_on"] == dict(zip(*reversed(
        dryrun.PLACED_TRAIN_MESH)))
    L = get_bundle("qwen3-4b").cfg.n_layers
    n = L * 2 * 4
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == {
        "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    assert cell["collectives"]["all-reduce"] > 0
    assert cell["collectives"]["reduce-scatter"] > 0
    assert cell["collectives"]["all-gather"] > 0
    assert cell["collectives"]["collective-permute"] == 0
    assert cell["collectives_complete"] is True
    assert cell["temp_sharded_by"] == "model"
    assert cell["model_flops"] == 6.0 * get_bundle(
        "qwen3-4b").active_param_count() * 4096 * 256
    # the arguments are the production mesh's shards
    mesh = make_mesh(*PRODUCTION_SHAPES[False])
    args, specs, _, _ = step_in_shardings(get_bundle("qwen3-4b"),
                                          "train_4k", mesh)
    assert cell["memory_analysis"]["argument_size_gb"] == sum(
        _leaf_bytes(a, sp, mesh) for a, sp in zip(args, specs)) / 1e9


def test_other_families_keep_the_whole_state(results):
    """``state="whole"`` keeps a family's state whole on every rank (every
    family has a placed body now, so it is the one way to the whole
    state): no tensor-parallel collective, the note says why."""
    cell = dryrun.run_cell("mamba2-370m", "decode_32k", "single",
                           force=True, state="whole")
    assert cell["status"] == "ok"
    assert cell["collectives_complete"] is False
    assert cell["note"] == dryrun.WHOLE_NOTE
    assert cell["temp_sharded_by"] == "data"
    assert cell["collective_bytes"] == 0


def test_mamba2_cell_counts_the_placed_step(results):
    """mamba2-370m x decode_32k x single on the placed state (its params
    by ``param_specs``, its cache by the family's rule): the in_proj
    output's all-gather and the partial sums issued,
    ``collectives_complete``, no note, the temporaries divided by data x
    model, the production mesh's argument bytes."""
    cell = dryrun.run_cell("mamba2-370m", "decode_32k", "single",
                           force=True)
    assert cell["status"] == "ok", cell.get("traceback")
    assert REF_KEYS <= set(cell) and "note" not in cell
    assert cell["collectives_complete"] is True
    assert cell["collectives"]["all-gather"] > 0
    assert cell["collectives"]["all-reduce"] > 0
    assert cell["collectives"]["collective-permute"] == 0
    assert cell["temp_sharded_by"] == "data, model"
    assert "counted_on" not in cell
    mesh = make_mesh(*PRODUCTION_SHAPES[False])
    args, specs, _, _ = step_in_shardings(get_bundle("mamba2-370m"),
                                          "decode_32k", mesh)
    assert cell["memory_analysis"]["argument_size_gb"] == sum(
        _leaf_bytes(a, sp, mesh) for a, sp in zip(args, specs)) / 1e9


def test_whisper_train_cell_counts_the_placed_step(results):
    """whisper-medium x train_4k x single on the placed state, counted on
    the (2, 4) mesh: its 3 attention calls a layer pair (encoder self,
    decoder self and cross) through each data and model rank, L x 3 x 2
    x 4 launches of each flash backward kernel (the forward twice: the
    reference's whisper layers save nothing across their recompute), the
    tensor-parallel sums issued, no ring hop."""
    cell = dryrun.run_cell("whisper-medium", "train_4k", "single",
                           force=True)
    assert cell["status"] == "ok", cell.get("traceback")
    assert "note" not in cell and cell["collectives_complete"] is True
    assert cell["cpu_s"] < 15.0
    assert cell["counted_on"] == dict(zip(*reversed(
        dryrun.PLACED_TRAIN_MESH)))
    n = get_bundle("whisper-medium").cfg.n_layers * 3 * 2 * 4
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == {
        "flash_fwd": 2 * n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
    assert cell["collectives"]["all-reduce"] > 0
    assert cell["collectives"]["collective-permute"] == 0
    assert cell["temp_sharded_by"] == "model"


def test_qwen3_train_cell_counts_the_ring_on_meta(results):
    """qwen3-4b x train_4k x single: the step counted on meta under a (16,
    16) mesh of local rings (the ring over the model axis at S 4,096: each
    hop the flash kernels' meta route), within 15 s of the cell's own CPU
    time (``cpu_s``: the counting thread's CPU time at one intra-op thread,
    which the other workers' load does not move; its wall time,
    ``compile_s``, also holds the waits for a core when the tests run in
    parallel), with the reference's keys and
    the partial terms named, on the whole state (``state="whole"``; the
    placed state is ``test_dense_train_cell_counts_the_placed_step``)."""
    threads = torch.get_num_threads()
    cell = dryrun.run_cell("qwen3-4b", "train_4k", "single", force=True,
                           state="whole")
    assert torch.get_num_threads() == threads
    assert cell["status"] == "ok", cell.get("traceback")
    assert REF_KEYS <= set(cell)
    assert REF_MEMORY_KEYS <= set(cell["memory_analysis"])
    assert cell["cpu_s"] < 15.0
    assert cell["chips"] == 256
    bundle = get_bundle("qwen3-4b")
    L = bundle.cfg.n_layers
    m = PRODUCTION_SHAPES[False][0][1]
    # the forward's m x m hops (the recompute keeps the ring's o and lse);
    # the backward's m x m
    assert {k: v["calls"] for k, v in cell["kernels"].items()} == {
        "flash_fwd": L * m * m, "flash_bwd_dq": L * m * m,
        "flash_bwd_dkv": L * m * m}
    assert cell["collectives"]["collective-permute"] > 0
    assert cell["collectives_complete"] is False
    assert cell["temp_sharded_by"] == "data"
    assert cell["model_flops"] == 6.0 * bundle.active_param_count() * \
        4096 * 256
    assert cell["model_bytes"] == ref_get_bundle(
        "qwen3-4b").min_hbm_bytes("train_4k")
    assert cell["flops"] > cell["model_flops"]
    # the argument bytes: params, two f32 moments and the step, the batch
    mesh = make_mesh(*PRODUCTION_SHAPES[False])
    args, specs, _, donate = step_in_shardings(bundle, "train_4k", mesh)
    want = (_leaf_bytes(args[0], specs[0], mesh) +
            _leaf_bytes(args[1], specs[1], mesh) +
            _leaf_bytes(args[2], specs[2], mesh))
    assert cell["memory_analysis"]["argument_size_gb"] == want / 1e9
    assert donate == (0, 1)
    mem = cell["memory_analysis"]
    assert mem["peak_gb_per_device"] == pytest.approx(
        mem["argument_size_gb"] + mem["temp_size_gb"])
    report = dryrun.roofline_from_cell(cell)
    assert report.chips == 256 and report.hlo_flops == cell["flops"]
    assert report.row()["coll_breakdown"] == {
        "collective-permute": cell["collectives"]["collective-permute"]}


def test_mamba2_long_context_cell(results):
    """The one-token decode at a 524,288 context on the placed state: no
    kernel (mamba2 attends nowhere), the tensor-parallel collectives only
    (no ring hop), memory-bound."""
    cell = dryrun.run_cell("mamba2-370m", "long_500k", "single", force=True)
    assert cell["status"] == "ok", cell.get("traceback")
    assert REF_KEYS <= set(cell)
    assert cell["cpu_s"] < 15.0
    assert cell["kernels"] == {} and cell["collectives_complete"] is True
    assert cell["collective_bytes"] == cell["collectives"]["all-gather"] + \
        cell["collectives"]["all-reduce"] > 0
    assert cell["model_flops"] == 2.0 * get_bundle(
        "mamba2-370m").active_param_count()
    assert dryrun.roofline_from_cell(cell).dominant == "memory"


def test_quadratic_long_context_is_skipped_as_the_reference(results):
    cell = dryrun.run_cell("qwen3-4b", "long_500k", "multi", force=True)
    ok, why = ref_get_bundle("qwen3-4b").supports("long_500k")
    assert not ok
    assert cell == {"arch": "qwen3-4b", "shape": "long_500k",
                    "mesh": "multi", "status": "skipped", "reason": why}
    assert dryrun.roofline_from_cell(cell) is None


def test_cells_are_cached_and_errors_recorded(results, monkeypatch):
    first = dryrun.run_cell("mamba2-370m", "decode_32k", "multi",
                            ring="off")
    assert first["status"] == "ok" and first["ring"] == "off"
    assert first["chips"] == 512
    assert (results / "mamba2-370m__decode_32k__multi__ring-off.json") \
        .exists()
    assert dryrun.run_cell("mamba2-370m", "decode_32k", "multi",
                           ring="off") == first

    def broken(*a, **kw):
        raise RuntimeError("no spec")
    monkeypatch.setattr(dryrun, "step_in_shardings", broken)
    cell = dryrun.run_cell("yi-9b", "decode_32k", "single", force=True)
    assert cell["status"] == "error"
    assert cell["error"] == "RuntimeError: no spec"


def test_main_sweeps_and_reports(results, monkeypatch, capsys):
    monkeypatch.setattr("sys.argv", ["dryrun", "--arch", "qwen3-4b",
                                     "--shape", "long_500k"])
    dryrun.main()
    assert "0 ok, 2 skipped, 0 errors" in capsys.readouterr().out
