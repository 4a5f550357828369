"""The multi-process slice of the port on the CPU: ``--mesh single|multi``
over a process group joined from torchrun's environment, the backend
rule, and the engine over data axes of processes with per-rank slot and
page ownership.

One group of 4 gloo processes serves the whole module (a module-scoped
fixture).  Each process sets torchrun's variables (``RANK``,
``WORLD_SIZE``, ``LOCAL_RANK``, ``LOCAL_WORLD_SIZE``, ``MASTER_ADDR``,
``MASTER_PORT``), first asks for the production meshes at their real
shapes (it joins the group, then is refused: 256 and 512 ranks), then
stands in the small shapes for them in its own process
(``launch.mesh.PRODUCTION_SHAPES``: (2, 2) and (2, 1, 2)) and runs:

  * ``launch.train.run("qwen3-4b", smoke=True, mesh_kind=...)`` for 3
    steps under both meshes, held against the reference's
    ``make_train_step`` under plain ``jax.jit`` (loss, ce, grad_norm and
    lr within 1e-5 relative, params and moments within 1e-5, as
    ``tests/test_torch_sharded.py`` holds them) and against the (2, 2)
    mesh of local rings in this process within 1e-6;
  * placed ``dense``, ``paged`` and ``paged_int8`` engines on the (2, 2)
    mesh, on the reference's weights, with the reference's own sharded
    engine test's prompts (``tests/test_distributed.py``) plus prompts
    sharing a prefix: greedy tokens equal the reference's unsharded dense
    engine's exactly (that test's bar), each rank holds half the pages,
    and the pool's invariants, slot-page ownership included, hold after
    every tick.

Host-only tests cover per-owner allocation, the owner-checked invariants,
owner-restricted prefix matches and admission, and the backend rule."""
import os
import socket
import tempfile
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.serving.kv import BlockPoolKV, PagedKVConfig  # noqa: E402
from repro_torch.serving.prefix import RadixPrefixCache  # noqa: E402
from repro_torch.serving.scheduler import (PhaseScheduler,  # noqa: E402
                                           Request, SchedulerConfig)

RTOL = ATOL = 1e-5
PROC_TOL = 1e-6
WORLD = 4
STANDINS = {False: ((2, 2), ("data", "model")),
            True: ((2, 1, 2), ("pod", "data", "model"))}
TRAIN = dict(smoke=True, steps=3, seq_len=32, global_batch=4, lr=3e-4,
             device="cpu", log_every=100)
SERVE = dict(slots=4, max_len=48, max_new=4)
SAMPLED = dict(temperature=0.8, top_k=20, sample_seed=3)
MODES = ("dense", "paged", "paged_int8")


def _prompts():
    """The reference's sharded engine test's four prompts, then six that
    share a 16-token prefix (two pages at page size 8)."""
    out = [np.arange(4 + 3 * i, dtype=np.int32) % 96 for i in range(4)]
    rng = np.random.default_rng(7)
    common = rng.integers(0, 256, 16)
    out += [np.concatenate([common, rng.integers(0, 256, int(n))])
            .astype(np.int32) for n in rng.integers(2, 9, 6)]
    return out


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


# ---------------------------------------------------------------------------
# the 4 processes
# ---------------------------------------------------------------------------

def _rank_main(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel.sharding import gather_tree, tree_mesh
    torch.set_num_threads(1)        # 4 ranks share the test's cores
    os.environ.update(RANK=str(rank), WORLD_SIZE=str(WORLD),
                      LOCAL_RANK=str(rank), LOCAL_WORLD_SIZE=str(WORLD),
                      MASTER_ADDR="localhost", MASTER_PORT=str(port))
    out = {"refused": {}}
    try:
        # the real shapes: the first call joins the group, both refuse
        for kind in ("single", "multi"):
            try:
                train.resolve_mesh(kind, "cpu")
            except RuntimeError as e:
                out["refused"][kind] = str(e)
        lmesh.PRODUCTION_SHAPES.update(STANDINS)
        params = torch.load(Path(out_dir) / "params.pt")
        for kind in ("single", "multi"):
            r = train.run("qwen3-4b", mesh_kind=kind, params=params, **TRAIN)
            mesh = tree_mesh(r["params"])
            g = gather_tree({"p": r["params"], "o": r["opt"]})
            out[kind] = {
                "metrics": r["metrics"], "backend": r["backend"],
                "shape": dict(mesh.shape),
                "rings": {a: (type(t).__name__, getattr(t, "backend", None),
                              getattr(t, "stages_hop", None),
                              getattr(t, "staged", None))
                          for a, t in mesh.transports.items()},
                "tree": g if rank == 0 else None}
        mesh = lmesh.make_production_mesh()
        for mode in MODES:
            eng, _ = build_engine("qwen3-4b", kv_mode=mode, page_size=8,
                                  params=params, device="cpu", mesh=mesh,
                                  place=True, **SERVE)
            for p in _prompts():
                eng.submit(p)
            audits = 0
            while eng.pending():
                eng.step()
                if mode != "dense":
                    eng.check_kv()
                    audits += 1
            row = {"tokens": eng.results, "owner": (eng.owner, eng.owners),
                   "audits": audits}
            if mode == "dense":
                row["cache_batch"] = eng._dense_cache["k"].shape[1]
            else:
                row.update(pages_held=eng.pool["k"].shape[1],
                           pages_total=eng.kv.cfg.total_pages,
                           shard=tuple(eng.pool["k"].tensors()[0].shape),
                           prefix=eng.prefix_stats())
            out[mode] = row
        # sampled: the rows cross, so every rank draws alike in slot order
        for mode in ("dense", "paged"):
            eng, _ = build_engine("qwen3-4b", kv_mode=mode, page_size=8,
                                  params=params, device="cpu", mesh=mesh,
                                  place=True, **SERVE, **SAMPLED)
            for p in _prompts():
                eng.submit(p)
            out[f"sampled_{mode}"] = eng.run()
        torch.save(out, Path(out_dir) / f"r{rank}.pt")
    finally:
        if dist.is_initialized():
            dist.destroy_process_group()


@pytest.fixture(scope="module")
def reference():
    """The reference's init params (numpy), its unsharded 3-step
    trajectory on the launcher's global batches (metrics, params, moments
    after each step) and its unsharded dense engine's greedy tokens."""
    import jax

    from repro.configs import get_bundle as ref_get_bundle
    from repro.data import DataConfig as RefDataConfig
    from repro.data import SyntheticLM as RefSyntheticLM
    from repro.data.pipeline import ShardedLoader as RefShardedLoader
    from repro.launch import serve as ref_serve
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import adamw_init as ref_adamw_init
    from repro.training import TrainHyper as RefTrainHyper
    from repro.training import make_train_step as ref_make_train_step
    rb = ref_get_bundle("qwen3-4b", smoke=True)
    rp = rb.init_params(jax.random.PRNGKey(0))
    host = jax.tree.map(np.asarray, rp)
    step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
        optimizer=RefAdamWConfig(lr=TRAIN["lr"], warmup_steps=5,
                                 total_steps=10))))
    loader = RefShardedLoader(RefSyntheticLM(RefDataConfig(
        vocab=rb.cfg.vocab, seq_len=TRAIN["seq_len"],
        global_batch=TRAIN["global_batch"])), 0, 1)
    opt = ref_adamw_init(rp)
    traj = []
    for i in range(TRAIN["steps"]):
        rp, opt, m = step(rp, opt, loader.batch(i), np.float32(1.0))
        traj.append(({k: float(v) for k, v in m.items()},
                     [np.asarray(x) for x in jax.tree.leaves(rp)],
                     [np.asarray(x) for x in jax.tree.leaves(opt["mu"])]
                     + [np.asarray(x) for x in jax.tree.leaves(opt["nu"])]))
    dense, _ = ref_serve.build_engine("qwen3-4b", **SERVE)
    for p in _prompts():
        dense.submit(p)
    return host, traj, dense.run()


@pytest.fixture(scope="module")
def ranks(reference):
    """The 4 processes' results, by rank."""
    from repro_torch.weights import from_jax_params
    with tempfile.TemporaryDirectory() as tmp:
        torch.save(from_jax_params(reference[0]), Path(tmp) / "params.pt")
        ctx = torch.multiprocessing.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_rank_main, args=(r, port, tmp))
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


def _close(metrics, tree, want, rtol, atol):
    for i, (gm, (wm, _, _)) in enumerate(zip(metrics, want)):
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(gm[key], wm[key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
        assert gm["finite"] == 1.0
    _, wp, wo = want[-1]
    gp = [t.numpy() for t in tree_leaves(tree["p"])]
    go = [t.numpy() for t in tree_leaves(tree["o"]["mu"])] + \
        [t.numpy() for t in tree_leaves(tree["o"]["nu"])]
    assert len(gp) == len(wp) and len(go) == len(wo)
    for n, (a, b) in enumerate(zip(gp + go, wp + wo)):
        np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                   err_msg=f"leaf {n}")


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_train_matches_reference(reference, ranks, kind):
    """3 smoke steps under the stand-in of ``--mesh single`` (2, 2) or
    ``multi`` (2, 1, 2) on 4 gloo processes: every rank's metrics, and
    rank 0's gathered params and moments, against the reference's
    unsharded step."""
    _, want, _ = reference
    shape = dict(zip(STANDINS[kind == "multi"][1],
                     STANDINS[kind == "multi"][0]))
    for rank, got in enumerate(ranks):
        g = got[kind]
        assert g["backend"] == "gloo" and g["shape"] == shape
        for a, (cls, backend, stages_hop, staged) in g["rings"].items():
            if shape[a] > 1:
                # gloo on the CPU: nothing is staged through the host
                assert (cls, backend) == ("ProcessRing", "gloo"), a
                assert stages_hop is True and staged == 0, a
        _close(g["metrics"], ranks[0][kind]["tree"], want, RTOL, ATOL)


@pytest.mark.parametrize("kind", ["single", "multi"])
def test_production_mesh_train_equals_the_local_mesh(reference, ranks, kind):
    """The process ranks against the same shape of local rings in this
    process, on the same weights and batches, within 1e-6."""
    from repro_torch.launch import train
    from repro_torch.parallel import make_mesh
    from repro_torch.parallel.sharding import gather_tree
    from repro_torch.weights import from_jax_params
    shape, axes = STANDINS[kind == "multi"]
    r = train.run("qwen3-4b", mesh_kind=make_mesh(shape, axes),
                  params=from_jax_params(reference[0]), **TRAIN)
    g = gather_tree({"p": r["params"], "o": r["opt"]})
    want = [(m, None, None) for m in r["metrics"]]
    want[-1] = (r["metrics"][-1],
                [t.numpy() for t in tree_leaves(g["p"])],
                [t.numpy() for t in tree_leaves(g["o"]["mu"])]
                + [t.numpy() for t in tree_leaves(g["o"]["nu"])])
    assert r["backend"] is None
    for got in ranks:
        _close(got[kind]["metrics"], ranks[0][kind]["tree"], want,
               PROC_TOL, PROC_TOL)


def test_production_meshes_refused_at_their_real_shapes(ranks):
    """In a group of 4 the real production meshes name the ranks they
    need."""
    for got in ranks:
        assert "needs a process group of 256 ranks" in \
            got["refused"]["single"] and "has 4" in got["refused"]["single"]
        assert "512 ranks" in got["refused"]["multi"]


@pytest.mark.parametrize("mode", MODES)
def test_data_process_engine_gives_reference_tokens(reference, ranks, mode):
    """Placed engines over the (2, 2) mesh of processes: each data rank
    owns two of the four slots and half the pages, and every rank's
    greedy tokens equal the reference's unsharded dense engine's."""
    want = reference[2]
    for rank, got in enumerate(ranks):
        row = got[mode]
        assert row["tokens"] == want, (rank, mode)
        assert row["owner"] == (rank // 2, 2)
        if mode == "dense":
            assert row["cache_batch"] == SERVE["slots"] // 2
            continue
        assert row["pages_held"] * 2 == row["pages_total"]
        assert row["shard"][1] == row["pages_held"]
        assert row["audits"] > 0
    if mode != "dense":
        # the shared prefix is matched within its owner's pages
        assert ranks[0][mode]["prefix"]["hits"] > 0
        assert all(g[mode]["prefix"] == ranks[0][mode]["prefix"]
                   for g in ranks)


@pytest.mark.parametrize("mode", ["dense", "paged"])
def test_data_process_engine_samples_alike_on_every_rank(reference, ranks,
                                                         mode):
    """Sampled decode over data processes: each rank gathers the logit
    rows and draws from its one seeded RNG in slot order, so every rank
    takes the same tokens.  The dense engine keeps the unsharded engine's
    slots, so its draws, and tokens, equal the port's unsharded engine's
    on the same seed; the paged engine places requests by the owners'
    rule, and draws in another slot order."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.weights import from_jax_params
    eng, _ = build_engine("qwen3-4b", kv_mode=mode, page_size=8,
                          params=from_jax_params(reference[0]),
                          device="cpu", **SERVE, **SAMPLED)
    for p in _prompts():
        eng.submit(p)
    want = eng.run()
    got = ranks[0][f"sampled_{mode}"]
    assert got != reference[2]          # sampling, not greedy
    assert sorted(got) == sorted(want)
    assert all(len(v) == SERVE["max_new"] for v in got.values())
    assert all(r[f"sampled_{mode}"] == got for r in ranks)
    if mode == "dense":
        assert got == want


# ---------------------------------------------------------------------------
# 2 gloo processes at (1, 2) against a local ring, in bf16
# ---------------------------------------------------------------------------

RING_SPECS = {"a": (None, "model"), "b": (None, "model"),
              "c": ("model", None), "n": (None,)}


def _bf16_ring_case(mesh) -> dict:
    """A bf16 body over the model axis in which every rank uses each of
    its replicated and gathered values twice: ``copy_to_model`` of an
    activation and of a replicated weight, a column-parallel pair, the
    pieces joined by ``gather_to_model``, a row-parallel product summed
    by ``reduce_from_model``; then the backward and the global norm of
    the placed grads.  Returns the output, the grads (the placed ones by
    shard coordinate) and the norm."""
    from repro_torch.optim.adamw import clip_by_global_norm
    from repro_torch.parallel import tensor_parallel as tp
    from repro_torch.parallel.sharding import shard_tree
    rng = np.random.default_rng(17)

    def bf(*shape):
        return torch.from_numpy(rng.standard_normal(shape).astype(
            np.float32)).bfloat16()
    x = bf(6, 16).requires_grad_()
    p = shard_tree({"a": bf(16, 8), "b": bf(16, 8), "c": bf(8, 16),
                    "n": bf(16)}, RING_SPECS, mesh)
    leaves = tree_leaves(p)
    for t in leaves:
        t.requires_grad_()
    ring = mesh.transport("model")
    idx = ring.index()
    xs = tp.copy_to_model(x, ring)
    ns = tp.copy_to_model(p["n"].tensors()[0], ring)
    hs = [(xs[i] * ns[i]) @ p["a"].at(model=r) + xs[i] @ p["b"].at(model=r)
          for i, r in enumerate(idx)]
    gs = tp.gather_to_model(hs, ring, -1)
    parts = [hs[i] @ p["c"].at(model=r) +
             gs[i].sum(-1, keepdim=True) * gs[i][:, :1]
             for i, r in enumerate(idx)]
    y = tp.reduce_from_model(parts, ring)
    (y.float() ** 2).mean().backward()
    _, norm = clip_by_global_norm([t.grad for t in leaves], 1.0, params=p)
    return {"y": y.detach(), "x": x.grad, "norm": norm,
            "grads": {k: {key: t.grad for key, t in v.shards.items()}
                      for k, v in p.items()}}


def _bf16_ring_rank(rank: int, port: int, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.parallel import make_process_mesh
    torch.set_num_threads(1)
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            rank=rank, world_size=2)
    try:
        got = _bf16_ring_case(make_process_mesh((1, 2), ("data", "model")))
        torch.save(got, Path(out_dir) / f"ring{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_bf16_local_ring_sums_as_the_process_ring():
    """A local ring's bf16 cotangent sums and global norm equal two gloo
    processes' bit for bit: a replicated value's rank cotangents (each
    rank's own uses first) summed in f32 in rank order and rounded once,
    as the process ring's all-reduce sums them, and the norm's squares
    grouped by the axes that cut them and each rank's shards."""
    from repro_torch.parallel import make_mesh
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.get_context("spawn")
        port = _free_port()
        procs = [ctx.Process(target=_bf16_ring_rank, args=(r, port, tmp))
                 for r in range(2)]
        for pr in procs:
            pr.start()
        for pr in procs:
            pr.join(timeout=120)
        for pr in procs:
            if pr.is_alive():
                pr.kill()
                pr.join(timeout=30)
        assert [pr.exitcode for pr in procs] == [0, 0]
        got = [torch.load(Path(tmp) / f"ring{r}.pt") for r in range(2)]
    want = _bf16_ring_case(make_mesh((1, 2), ("data", "model")))
    for r, g in enumerate(got):
        for k in ("y", "x", "norm"):
            assert g[k].dtype == want[k].dtype, (r, k)
            assert torch.equal(g[k], want[k]), (r, k)
        for k, shards in g["grads"].items():
            for key, t in shards.items():
                w = want["grads"][k][key]
                assert t.dtype == torch.bfloat16 and torch.equal(t, w), \
                    (r, k, key)
        assert set(g["grads"]["a"]) == {(r,)} and \
            set(g["grads"]["n"]) == {()}


# ---------------------------------------------------------------------------
# host-only
# ---------------------------------------------------------------------------

def _pool(owners=2, slots=4, pages=10, max_len=32, page=4):
    return BlockPoolKV(PagedKVConfig(num_slots=slots, max_len=max_len,
                                     page_size=page, num_pages=pages,
                                     owners=owners))


def test_per_owner_allocation():
    kv = _pool()
    assert [kv.slot_owner(s) for s in range(4)] == [0, 0, 1, 1]
    assert [kv.trash(o) for o in range(2)] == [0, 5]
    assert kv.free_pages == 8 and kv.free_pages_of(1) == 4
    assert (kv.page_table[2:] == 5).all() and (kv.page_table[:2] == 0).all()
    kv.ensure(2, 12)                    # three of owner 1's pages
    assert all(kv.page_owner(p) == 1 for p in kv.slot_pages(2))
    assert kv.free_pages_of(0) == 4 and kv.free_pages_of(1) == 1
    # owner 1 is dry while owner 0 has pages: its slot cannot grow
    with pytest.raises(MemoryError):
        kv.ensure(3, 8)
    assert not kv.can_alloc(2, 1) and kv.can_alloc(2, 0)
    kv.ensure(0, 16)
    assert all(kv.page_owner(p) == 0 for p in kv.slot_pages(0))
    kv.check_invariants()
    kv.free_slot(2)
    assert kv.free_pages_of(1) == 4 and (kv.page_table[2] == 5).all()
    assert kv.stats()["pages_total"] == 8
    kv.check_invariants()
    with pytest.raises(ValueError):
        BlockPoolKV(PagedKVConfig(num_slots=3, max_len=8, page_size=4,
                                  num_pages=10, owners=2))


def test_owner_checked_invariants():
    kv = _pool()
    kv.ensure(0, 4)
    with pytest.raises(ValueError, match="owner"):
        kv.map_shared(2, list(kv.slot_pages(0)))
    with pytest.raises(ValueError, match="trash"):
        kv.retain(5)
    # a table that maps another owner's page fails the audit
    kv.ensure(2, 4)
    kv._slot_pages[0][0], kv._slot_pages[2][0] = \
        kv._slot_pages[2][0], kv._slot_pages[0][0]
    kv.page_table[0, 0], kv.page_table[2, 0] = \
        kv.page_table[2, 0], kv.page_table[0, 0]
    with pytest.raises(AssertionError, match="owner"):
        kv.check_invariants()


def test_prefix_matches_stay_within_an_owner():
    kv = _pool(pages=20, max_len=32)
    trie = RadixPrefixCache(kv)
    seq = np.arange(1, 11, dtype=np.int32)
    kv.ensure(2, 10)                    # owner 1's slot
    kv.set_length(2, 10)
    assert trie.insert(seq, kv.slot_pages(2), 10) == 3
    kv.free_slot(2)                     # the trie keeps its pages
    prompt = np.concatenate([seq[:8], [99, 98]]).astype(np.int32)
    assert trie.peek(prompt, 0).matched == 0
    m = trie.peek(prompt, 1)
    assert m.matched_full == 8 and all(kv.page_owner(p) == 1
                                       for p in m.full_pages)
    assert trie.lookups == 0            # peeks count nothing
    trie.check_invariants()
    # eviction drains only the owner asked for
    assert trie.evict(5, owner=0) == 0 and trie.evict(5, owner=1) == 3
    trie.check_invariants()


def test_admission_prefers_the_owner_holding_the_prefix():
    """Two owners of two slots: a prompt whose prefix owner 1 caches goes
    to owner 1 while it has a free slot, and maps its pages; without a
    match (or once owner 1 is full) the owner with more free slots, then
    more free pages, wins; with no free slot the request waits."""
    kv = _pool(pages=20, max_len=32)
    trie = RadixPrefixCache(kv)
    sched = PhaseScheduler(SchedulerConfig(num_slots=4))
    seq = np.arange(1, 11, dtype=np.int32)
    kv.ensure(3, 10)
    kv.set_length(3, 10)
    trie.insert(seq, kv.slot_pages(3), 10)
    kv.free_slot(3)

    def submit(rid, prompt):
        req = Request(rid=rid, prompt=np.asarray(prompt, np.int32),
                      arrival=rid, max_new_tokens=4)
        sched.submit(req)
        return req

    a = submit(0, [50, 51, 52])
    b = submit(1, np.concatenate([seq[:8], [7, 7]]))
    c = submit(2, np.concatenate([seq[:8], [8]]))
    d = submit(3, np.concatenate([seq[:8], [9, 9, 9]]))
    e = submit(4, [70])
    admitted = sched.admit(kv, prefix=trie)
    assert [r.rid for r in admitted] == [0, 1, 2, 3]
    assert a.slot == 0                  # no match: more free pages
    assert (b.slot, b.matched_tokens) == (2, 8)    # owner 1's prefix
    assert (c.slot, c.matched_tokens) == (3, 8)
    assert (d.slot, d.matched_tokens) == (1, 0)    # owner 1 is full
    assert e.phase.value == "waiting"
    assert kv.slot_pages(2)[:2] == kv.slot_pages(3)[:2] == \
        trie.peek(b.prompt, 1).full_pages
    for slot in range(4):
        assert all(kv.page_owner(p) == kv.slot_owner(slot)
                   for p in kv.slot_pages(slot))
    trie.check_invariants()
    assert trie.lookups == 4 and trie.hits == 2


@pytest.mark.parametrize("device,local_world,cards,want", [
    ("cuda", 1, 1, "nccl"), ("cuda", 8, 8, "nccl"), ("cuda", 4, 1, "gloo"),
    ("cuda", 2, 1, "gloo"), ("cpu", 1, 8, "gloo"), ("cpu", 4, 0, "gloo")])
def test_backend_rule(device, local_world, cards, want):
    from repro_torch.launch.mesh import process_group_backend
    assert process_group_backend(device, local_world, cards) == want


def test_production_mesh_without_a_group_raises(monkeypatch):
    """No group and no torchrun environment: ``single`` raises the
    production mesh's error (256 ranks) and ``multi`` (512); neither ever
    gives a local mesh."""
    import torch.distributed as dist

    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    assert not dist.is_initialized()
    for k in lmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    with pytest.raises(RuntimeError, match="256 ranks"):
        train.resolve_mesh("single", "cpu")
    with pytest.raises(RuntimeError, match="512 ranks"):
        train.resolve_mesh("multi", "cpu")
    with pytest.raises(RuntimeError, match="256 ranks"):
        lmesh.make_production_mesh()
    assert not dist.is_initialized()


def test_cli_takes_the_production_meshes(monkeypatch):
    """``--mesh single`` and ``multi`` pass the CLI and reach the mesh
    (which raises here, with no group); another name does not parse."""
    from repro_torch.launch import mesh as lmesh
    from repro_torch.launch import train
    for k in lmesh.TORCHRUN_ENV:
        monkeypatch.delenv(k, raising=False)
    for kind, ranks_ in (("single", 256), ("multi", 512)):
        with pytest.raises(RuntimeError, match=f"{ranks_} ranks"):
            train.main(["--arch", "qwen3-4b", "--mesh", kind,
                        "--device", "cpu", "--steps", "1"])
    with pytest.raises(SystemExit):
        train.main(["--arch", "qwen3-4b", "--mesh", "pods",
                    "--device", "cpu"])
