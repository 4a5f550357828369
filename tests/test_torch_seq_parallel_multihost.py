"""Megatron-style sequence parallelism over processes, on the CPU: the
placed bodies of ``tests/test_torch_seq_parallel.py`` under a (2, 2) mesh
of 4 gloo processes (``parallel.make_process_mesh``: a ``ProcessRing`` on
each axis), where the reduce-scatter is ``dist.reduce_scatter_tensor``
and the all-gather ``dist.all_gather_into_tensor``.

One group of 4 processes serves the module (a module-scoped fixture).
Each process runs one step of every case (qwen3-4b, olmoe-1b-7b,
recurrentgemma-9b, whisper-medium, mamba2-370m with ``sp=True``; B 4, S
16, aux weight 0) on its data rank's rows and its model rank's shards.
The step holds the reference's unsharded step (``make_train_step`` under
plain ``jax.jit``) within 1e-5 (the same meshes of local rings hold it in
``tests/test_torch_seq_parallel.py``).  Each process's remat units keep its
own rows of the residual: exactly B/2 x S/2 x D elements a unit, never the
whole (B/2, S, D); the model axis's all-reduces stay below one such
tensor, and its reduce-scatters and all-gathers are counted."""
import dataclasses
import socket
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_bundle  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel.sharding import (gather_tree, param_specs,  # noqa
                                           shard_tree)
from repro_torch.training import TrainHyper, make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

RTOL = ATOL = 1e-5
OPT = dict(warmup_steps=5, total_steps=10)
AXES = ("data", "model")
SHAPE = (2, 2)
WORLD = 4
B, S = 4, 16
CASES = {"qwen3-4b": {}, "olmoe-1b-7b": {}, "recurrentgemma-9b": {},
         "whisper-medium": {}, "mamba2-370m": {"sp": True}}


def _bundle(arch):
    b = get_bundle(arch, smoke=True)
    return dataclasses.replace(b, cfg=dataclasses.replace(b.cfg,
                                                          **CASES[arch]))


def _batch(cfg, kind: str) -> dict:
    rng = np.random.default_rng(0)
    t = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if kind == "audio":
        b["frames"] = rng.normal(0, 1, (B, cfg.n_audio_ctx, cfg.d_model)) \
            .astype(np.float32)
    return b


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
            torch.from_numpy(v) for k, v in batch.items()}


def _step(arch, host, mesh):
    """One placed step on this process's data rank's rows: (metrics, the
    gathered params and moments, the counter's collectives, each remat
    unit's saved inputs)."""
    from repro_torch.analysis.op_cost import CostMode
    from repro_torch.models import layers
    from repro_torch.parallel import tensor_parallel as tp
    b = _bundle(arch)
    p = from_jax_params(host)
    p = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
    step = make_train_step(b.forward, TrainHyper(
        optimizer=AdamWConfig(**OPT), aux_weight=0.0))
    d, n = tp.data_index(mesh)
    rows = {k: v[d * B // n:(d + 1) * B // n]
            for k, v in _t(_batch(b.cfg, b.kind)).items()}
    with CostMode() as cm, layers.unit_inputs() as units:
        p, opt, m = step(p, adamw_init(p), rows)
    g = gather_tree({"p": p, "o": opt})
    tree = ([t.numpy() for t in tree_leaves(g["p"])],
            [t.numpy() for t in tree_leaves(g["o"]["mu"])] +
            [t.numpy() for t in tree_leaves(g["o"]["nu"])])
    return ({k: float(v) for k, v in m.items()}, tree,
            dict(cm.cost.collectives), units)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def _rank_main(rank: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.parallel import ProcessRing, make_process_mesh
    torch.set_num_threads(1)        # 4 ranks share the test's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    try:
        mesh = make_process_mesh(SHAPE, AXES)
        model = mesh.transport("model")
        assert isinstance(model, ProcessRing)
        sums = []
        real = ProcessRing.reduce_

        def reduce_(self, t, op="sum"):
            if self is model:
                sums.append(t.numel() * t.element_size())
            return real(self, t, op)
        ProcessRing.reduce_ = reduce_
        hosts = torch.load(Path(out_dir) / "hosts.pt", weights_only=False)
        out = {}
        for arch in CASES:
            sums.clear()
            metrics, tree, coll, units = _step(arch, hosts[arch], mesh)
            out[arch] = {"metrics": metrics,
                         "tree": tree if rank == 0 else None,
                         "collectives": coll, "units": units,
                         "model_all_reduce_max": max(sums, default=0)}
        torch.save(out, Path(out_dir) / f"r{rank}.pt")
    finally:
        dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """arch -> (init params as numpy, the reference's unsharded step:
    metrics, params and moments after it)."""
    import jax

    from repro.configs import get_bundle as ref_get_bundle
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import adamw_init as ref_adamw_init
    from repro.training import TrainHyper as RefTrainHyper
    from repro.training import make_train_step as ref_make_train_step
    out = {}
    for arch, over in CASES.items():
        rb = ref_get_bundle(arch, smoke=True)
        rb = dataclasses.replace(rb, cfg=dataclasses.replace(rb.cfg, **over))
        rp = rb.init_params(jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, rp)
        step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
            optimizer=RefAdamWConfig(**OPT), aux_weight=0.0)))
        rp, opt, m = step(rp, ref_adamw_init(rp), _batch(rb.cfg, rb.kind),
                          np.float32(1.0))
        out[arch] = (host, ({k: float(v) for k, v in m.items()},
                            ([np.asarray(x) for x in jax.tree.leaves(rp)],
                             [np.asarray(x)
                              for x in jax.tree.leaves(opt["mu"])] +
                             [np.asarray(x)
                              for x in jax.tree.leaves(opt["nu"])])))
    return out


@pytest.fixture(scope="module")
def ranks(reference):
    """The 4 processes' results, by rank."""
    with tempfile.TemporaryDirectory() as tmp:
        torch.save({a: h for a, (h, _) in reference.items()},
                   Path(tmp) / "hosts.pt")
        ctx = torch.multiprocessing.get_context("spawn")
        init = f"tcp://localhost:{_free_port()}"
        procs = [ctx.Process(target=_rank_main, args=(r, init, tmp))
                 for r in range(WORLD)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=300)
        alive = [pr.is_alive() for pr in procs]
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=30)
        assert not any(alive), "a process hung"
        assert [pr.exitcode for pr in procs] == [0] * WORLD
        return [torch.load(Path(tmp) / f"r{r}.pt", weights_only=False)
                for r in range(WORLD)]


def _close(got, want, rtol, atol):
    (gm, (gp, go)), (wm, (wp, wo)) = got, want
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(gm[key], wm[key], rtol=rtol, err_msg=key)
    assert gm["finite"] == 1.0
    assert len(gp) == len(wp) and len(go) == len(wo)
    for n, (a, b) in enumerate(zip(gp + go, wp + wo)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {n}")


@pytest.mark.parametrize("arch", list(CASES))
def test_process_sp_step_matches_reference(reference, ranks, arch):
    """Every process's metrics and rank 0's gathered state hold the
    reference's unsharded step within 1e-5."""
    _, want = reference[arch]
    for r in ranks:
        _close((r[arch]["metrics"], ranks[0][arch]["tree"]), want, RTOL,
               ATOL)


@pytest.mark.parametrize("arch", list(CASES))
def test_each_process_keeps_its_rows_of_the_residual(ranks, arch):
    """Each process's remat units keep exactly its B/2 x S/2 x D rows of
    the residual (whisper's encoder units S_enc/2 rows), never a whole
    (B/2, S, D) one."""
    cfg = _bundle(arch).cfg
    D, Bd, m = cfg.d_model, B // SHAPE[0], SHAPE[1]
    enc = getattr(cfg, "n_audio_ctx", None)
    rows = {S // m} | ({enc // m} if enc else set())
    for r in ranks:
        units = r[arch]["units"]
        assert units
        for seen in units:
            res = [s for s, dt in seen if dt.is_floating_point and
                   len(s) == 3 and s[0] == Bd and s[2] == D and s[1] in rows]
            assert len(res) == 1, seen
            assert int(np.prod(res[0])) == Bd * res[0][1] * D
            assert (Bd, res[0][1] * m, D) not in [s for s, _ in seen]


@pytest.mark.parametrize("arch", list(CASES))
def test_process_model_axis_reduce_scatters(ranks, arch):
    """The model axis's collectives are Megatron-SP's on every process:
    reduce-scatters and all-gathers counted, and its largest all-reduce
    smaller than one (B/2, S, D) f32 tensor (no delta is all-reduced)."""
    cfg = _bundle(arch).cfg
    for r in ranks:
        coll = r[arch]["collectives"]
        assert coll["reduce-scatter"] > 0 and coll["all-gather"] > 0
        assert 0 < r[arch]["model_all_reduce_max"] < \
            B // SHAPE[0] * S * cfg.d_model * 4
