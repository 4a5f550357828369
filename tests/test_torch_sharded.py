"""The sharded-state slice of the port on the CPU: params and AdamW
moments placed by ``param_specs`` (``parallel.sharding.shard_tree`` /
``gather_tree``), the decoder's tensor-parallel body, the data-parallel
gradient sum, the placed checkpoints, ``ShardedLoader.reshard``, the
placed paged engine and the transports' all-gather.

The step on a placed state is held against the reference's UNSHARDED
step (``make_train_step`` under plain ``jax.jit``, no mesh), on the same
numpy inputs and weights carried across by ``weights.from_jax_params``:
the reference's own sharded test (``tests/test_distributed.py``) builds
a device mesh that this container's jax refuses.  Smoke configs in f32.

Tolerances: loss, ce, grad_norm and lr within 1e-5 relative; params and
moments within 1e-5 relative and 1e-5 absolute, over 3 steps (sums in
another order: the model axis's partials, the data ranks' gradients).
A gloo process rank equals the same mesh of local rings within 1e-6 (the
same arithmetic, the all-reduces may sum in another order).  Placing and
gathering are exact, and the placed engines' greedy tokens equal the
unsharded dense engine's exactly."""
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_bundle  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel import make_mesh, tensor_parallel as tp  # noqa
from repro_torch.parallel.mesh import LocalRing  # noqa: E402
from repro_torch.parallel.sharding import (Placed, gather_tree,  # noqa
                                           local_shape, param_specs,
                                           shard_tree)
from repro_torch.training import TrainHyper, make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

RTOL = ATOL = 1e-5
PROC_TOL = 1e-6
OPT = dict(warmup_steps=5, total_steps=10)
AXES = ("data", "model")
WORLD = 4


def _batches(n=3, B=4, S=32, seed=0, vocab=256):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, vocab, (B, S + 1)).astype(np.int32)
        out.append({"tokens": t[:, :-1], "labels": t[:, 1:]})
    return out


def _t(batch):
    return {k: torch.from_numpy(v).long() for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """arch -> (the reference's init params as numpy, its 3-step
    trajectory: metrics, params, moments after each step), at aux weight
    0 (under a mesh the port's aux is the mean of the ranks' own terms)."""
    import jax

    from repro.configs import get_bundle as ref_get_bundle
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import adamw_init as ref_adamw_init
    from repro.training import TrainHyper as RefTrainHyper
    from repro.training import make_train_step as ref_make_train_step
    cache = {}

    def get(arch):
        if arch in cache:
            return cache[arch]
        rb = ref_get_bundle(arch, smoke=True)
        rp = rb.init_params(jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, rp)
        step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
            optimizer=RefAdamWConfig(**OPT), aux_weight=0.0)))
        opt = ref_adamw_init(rp)
        traj = []
        for b in _batches():
            rp, opt, m = step(rp, opt, b, np.float32(1.0))
            traj.append(({k: float(v) for k, v in m.items()},
                         [np.asarray(x) for x in jax.tree.leaves(rp)],
                         [np.asarray(x) for x in jax.tree.leaves(opt["mu"])]
                         + [np.asarray(x)
                            for x in jax.tree.leaves(opt["nu"])]))
        cache[arch] = (host, traj)
        return cache[arch]
    return get


def _placed_run(arch, host, mesh, batches=None):
    """3 steps of the port's step on the state placed on ``mesh``: the
    metrics, gathered params and moments after each step."""
    b = get_bundle(arch, smoke=True)
    p = from_jax_params(host)
    p = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
    opt = adamw_init(p)
    step = make_train_step(b.forward, TrainHyper(
        optimizer=AdamWConfig(**OPT), aux_weight=0.0))
    out = []
    for batch in batches or [_t(x) for x in _batches()]:
        p, opt, m = step(p, opt, batch)
        g = gather_tree({"p": p, "o": opt})
        out.append(({k: float(v) for k, v in m.items()},
                    [t.numpy() for t in tree_leaves(g["p"])],
                    [t.numpy() for t in tree_leaves(g["o"]["mu"])]
                    + [t.numpy() for t in tree_leaves(g["o"]["nu"])]))
    assert isinstance(p["embed"], Placed) and int(opt["step"]) == 3
    return out


def _close(got, want, rtol, atol):
    for i, ((gm, gp, go), (wm, wp, wo)) in enumerate(zip(got, want)):
        for key in ("loss", "ce", "grad_norm", "lr"):
            np.testing.assert_allclose(gm[key], wm[key], rtol=rtol,
                                       err_msg=f"step {i} {key}")
        assert gm["finite"] == 1.0
        assert len(gp) == len(wp) and len(go) == len(wo)
        for n, (a, b) in enumerate(zip(gp + go, wp + wo)):
            np.testing.assert_allclose(a, b, rtol=rtol, atol=atol,
                                       err_msg=f"step {i} leaf {n}")


@pytest.mark.parametrize("shape", [(1, 2), (2, 2), (2, 4)])
def test_qwen3_placed_step_matches_reference(reference, shape):
    """qwen3-4b's smoke step (4 heads, 2 kv heads of 16) on a placed
    state: (1, 2) splits whole heads, (2, 4) half a kv head a rank (the
    k / v projections all-gathered over model) and two data ranks."""
    host, want = reference("qwen3-4b")
    _close(_placed_run("qwen3-4b", host, make_mesh(shape, AXES)), want,
           RTOL, ATOL)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_moe_placed_step_matches_reference(reference, arch):
    """The MoE smoke steps under (1, 4) at aux weight 0: olmoe's 8 experts
    by expert parallelism, granite's 5 by TP in expert (its 3 heads of 16
    split mid-head, one kv head)."""
    host, want = reference(arch)
    _close(_placed_run(arch, host, make_mesh((1, 4), AXES)), want, RTOL,
           ATOL)


def test_shard_then_gather_is_exact_and_replicas_held_once():
    b = get_bundle("qwen3-4b", smoke=True)
    p = b.init_params(0, device="cpu")
    mesh = make_mesh((2, 4), AXES)
    specs = param_specs(b.kind, p, mesh)
    placed = shard_tree(p, specs, mesh)
    back = gather_tree(placed)
    for a, c in zip(tree_leaves(p), tree_leaves(back)):
        assert torch.equal(a, c)
    # the data axis cuts nothing: a replicated leaf is one tensor, a cut
    # one its 4 model shards, each its own contiguous storage
    for name, leaf in [("ln_f", placed["ln_f"]),
                       ("ln1", placed["layers"]["ln1"])]:
        assert len(leaf.shards) == 1 and leaf.axes == (), name
    ptrs = set()
    for key in ("wq", "wk", "wo", "w_down"):
        leaf = placed["layers"][key]
        assert leaf.axes == ("model",) and len(leaf.shards) == 4
        for (r,), t in leaf.shards.items():
            assert t.is_contiguous()
            assert tuple(t.shape) == local_shape(leaf.shape, leaf.spec, mesh,
                                                 {"model": r})
            ptrs.add(t.untyped_storage().data_ptr())
    assert len(ptrs) == 16
    held = sum(t.numel() for t in tree_leaves(placed))
    assert held == sum(t.numel() for t in tree_leaves(p))
    # the moments are placed alike, their step replicated
    opt = adamw_init(placed)
    assert opt["mu"]["layers"]["wq"].spec == placed["layers"]["wq"].spec
    assert opt["step"].shape == ()


def test_head_plan_covers_each_feature_once():
    from repro_torch.models.layers import head_plan
    for (H, Kv, Dh, m), gq, gkv in [((4, 2, 16, 2), False, False),
                                    ((4, 2, 16, 4), False, True),
                                    ((3, 1, 16, 4), True, True),
                                    ((32, 8, 128, 4), False, False),
                                    ((40, 8, 128, 16), True, True)]:
        plan = head_plan(H, Kv, Dh, m)
        assert (plan.gather_q, plan.gather_kv) == (gq, gkv), (H, Kv, m)
        G = H // Kv
        cover = np.zeros(H * Dh, int)
        for sh in plan.shards:
            cover[sh.q_lo:sh.q_hi] += 1
            assert sh.h0 * Dh <= sh.q_lo and sh.q_hi <= sh.h1 * Dh
            assert sh.kv0 == sh.h0 // G and sh.kv1 == (sh.h1 - 1) // G + 1
        assert (cover == 1).all()


def test_vocab_parallel_terms_equal_the_loss_terms():
    """logsumexp and the label's logit from uneven vocab ranges (10 over
    4 ranks: 3, 3, 3, 1) equal ``loss_fn``'s, values and grads."""
    torch.manual_seed(0)
    z = torch.randn(2, 5, 10, dtype=torch.float64, requires_grad=True)
    labels = torch.randint(0, 10, (2, 5))
    ring = LocalRing(4)
    parts = [z[..., lo:hi] for lo, hi in
             (tp.vocab_range(10, 4, r) for r in range(4))]
    logz, at = tp.vocab_loss_terms(parts, labels, ring, 10)
    (g,) = torch.autograd.grad((logz ** 2 - 3 * at).sum(), z)
    want_z = torch.logsumexp(z, -1)
    want_at = z.gather(-1, labels[..., None])[..., 0]
    (gw,) = torch.autograd.grad((want_z ** 2 - 3 * want_at).sum(), z)
    torch.testing.assert_close(logz, want_z)
    torch.testing.assert_close(at, want_at)
    torch.testing.assert_close(g, gw)


def test_local_all_gather_joins_in_rank_order_and_counts():
    from repro_torch.analysis.op_cost import CostMode
    ring = LocalRing(4)
    xs = [torch.full((2, 3), float(r)) for r in range(4)]
    with CostMode() as m:
        out = ring.all_gather(xs, 1)
    # one gathered tensor held once: each rank's entry a view of it (its
    # cotangents are summed as a process ring's backward sums them)
    assert len(out) == 4 and all(
        o.untyped_storage().data_ptr() ==
        out[0].untyped_storage().data_ptr() for o in out)
    assert all(torch.equal(o, torch.cat(xs, 1)) for o in out)
    # the gathered (2, 12) f32 bytes at each of the 4 ranks
    assert m.cost.collectives["all-gather"] == 4 * 2 * 12 * 4


def test_checkpoints_cross_between_sharded_and_unsharded(tmp_path):
    """A run under (2, 2) saves the global tree: equal to an unsharded
    run's checkpoint leaf for leaf; each run's checkpoint then restores
    into the other kind of run (the sharded one through ``sharding_fn``
    onto a (1, 4) mesh), and both continue alike."""
    from repro_torch.checkpoint import restore_checkpoint
    from repro_torch.launch import train
    kw = dict(smoke=True, seq_len=32, global_batch=4, device="cpu",
              log_every=100, ckpt_every=2)
    plain, sharded = tmp_path / "plain", tmp_path / "sharded"
    a = train.run("qwen3-4b", steps=2, ckpt_dir=str(plain), **kw)
    b = train.run("qwen3-4b", steps=2, ckpt_dir=str(sharded),
                  mesh_kind=make_mesh((2, 2), AXES), **kw)
    np.testing.assert_allclose(b["losses"], a["losses"], rtol=RTOL)
    like = {"params": a["params"], "opt": a["opt"]}
    ca = restore_checkpoint(str(plain), 2, _zeros_like(like))
    cb = restore_checkpoint(str(sharded), 2, _zeros_like(like))
    for x, y in zip(tree_leaves(ca), tree_leaves(cb)):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL)
    c = train.run("qwen3-4b", total_steps=3, ckpt_dir=str(sharded), **kw)
    d = train.run("qwen3-4b", total_steps=3, ckpt_dir=str(plain),
                  mesh_kind=make_mesh((1, 4), AXES), **kw)
    assert c["steps"] == d["steps"] == [2]
    np.testing.assert_allclose(d["losses"], c["losses"], rtol=RTOL)
    assert isinstance(d["params"]["embed"], Placed)
    for x, y in zip(tree_leaves(gather_tree(d["params"])),
                    tree_leaves(c["params"])):
        np.testing.assert_allclose(x.numpy(), y.numpy(), rtol=RTOL,
                                   atol=ATOL)


def _zeros_like(tree):
    if isinstance(tree, dict):
        return {k: _zeros_like(v) for k, v in tree.items()}
    return torch.zeros_like(tree)


def test_reshard_batches_equal_reference():
    from repro.data import DataConfig as RefDataConfig
    from repro.data import SyntheticLM as RefSyntheticLM
    from repro.data.pipeline import ShardedLoader as RefShardedLoader
    from repro_torch.data import DataConfig, SyntheticLM
    from repro_torch.data.pipeline import ShardedLoader
    cfg = dict(vocab=256, seq_len=16, global_batch=12, seed=5)
    ref = RefShardedLoader(RefSyntheticLM(RefDataConfig(**cfg)), 1, 4)
    pt = ShardedLoader(SyntheticLM(DataConfig(**cfg)), 1, 4)
    for host, n in ((1, 4), (0, 3), (2, 3), (1, 2)):
        ref, pt = ref.reshard(host, n), pt.reshard(host, n)
        assert pt.per_host == ref.per_host == 12 // n
        for index in (0, 7):
            a, b = ref.batch(index), pt.batch(index)
            for key in ("tokens", "labels"):
                np.testing.assert_array_equal(a[key], b[key])


@pytest.mark.parametrize("arch,shape,mode", [
    ("qwen3-4b", (1, 2), "paged"), ("qwen3-4b", (1, 4), "paged"),
    ("qwen3-4b", (1, 4), "paged_int8"), ("olmoe-1b-7b", (1, 4), "paged"),
    ("granite-moe-3b-a800m", (1, 4), "dense")])
def test_placed_paged_engine_gives_dense_tokens(arch, shape, mode):
    """The reference's ``test_paged_pool_sharded_across_mesh`` on a placed
    state: the pool's shards are ``local_shape`` of its specs over model
    (qwen3's 2 kv heads: a head a rank at m 2, a head_dim quarter at m 4,
    its page view all-gathered), and greedy tokens equal the unsharded
    dense engine's exactly; the dense slot pool is placed alike, by the
    cache's specs (granite's one kv head: a head_dim quarter a rank)."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel import cache_specs, paged_pool_specs
    prompts = [np.arange(4 + 3 * i, dtype=np.int32) % 96 for i in range(4)]
    dense, _ = build_engine(arch, slots=2, max_len=48, max_new=4,
                            device="cpu")
    for p in prompts:
        dense.submit(p)
    want = dense.run()
    mesh = make_mesh(shape, AXES)
    placed, _ = build_engine(arch, slots=2, max_len=48, max_new=4,
                             kv_mode=mode, page_size=8, mesh=mesh,
                             device="cpu", place=True)
    for p in prompts:
        placed.submit(p)
    assert placed.run() == want
    cfg = placed.bundle.cfg
    kw = dict(kv_heads=cfg.n_kv_heads, head_dim=cfg.dh)
    if mode == "dense":
        store, specs = placed._dense_cache, cache_specs(mesh, **kw)
    else:
        store, specs = placed.pool, paged_pool_specs(mesh, **kw)
    m = shape[1]
    for k, leaf in store.items():
        assert isinstance(leaf, Placed)
        cut = leaf.axes == ("model",)
        assert len(leaf.shards) == (m if cut else 1), k
        # the specs' batch and page axes stay whole (the host state owns
        # every slot and page)
        spec = tuple(e if e == "model" else None for e in specs.get(
            k, specs["k"][:4]))
        for key, t in leaf.shards.items():
            assert t.is_contiguous()
            assert tuple(t.shape) == local_shape(
                leaf.shape, spec, mesh, dict(zip(leaf.axes, key))), k

def test_placed_pool_exports_and_imports_prefix_pages():
    """A placed engine's prefix pages export whole (gathered over model)
    and land in another placed engine's shards: its pool then holds the
    source's pages, shard for shard."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel.sharding import gather_leaf
    mesh = make_mesh((1, 4), AXES)
    kw = dict(slots=2, max_len=64, max_new=2, kv_mode="paged_int8",
              page_size=8, mesh=mesh, device="cpu", place=True)
    src, _ = build_engine("qwen3-4b", **kw)
    prompt = np.arange(3, 27, dtype=np.int32)
    src.submit(prompt)
    src.run()
    segments = src.export_prefix_pages(prompt, 24)
    assert len(segments) == 3
    dst, _ = build_engine("qwen3-4b", **kw)
    assert dst.import_prefix_pages(segments) == 24
    nodes = dst.prefix.path_nodes(prompt, 24)
    assert len(nodes) == 3
    for k in src.pool:
        whole = gather_leaf(dst.pool[k])
        for (_, vals), node in zip(segments, nodes):
            assert torch.equal(whole[:, node.page], vals[k]), k


@pytest.mark.parametrize("kv_dtype", [None, torch.int8])
def test_placed_prefill_and_decode_equal_unsharded(kv_dtype):
    """prefill and three decode steps on a placed state and dense cache
    (granite's one kv head at m 4: the cache holds a head_dim quarter a
    rank) give the unsharded logits within 1e-5."""
    from repro_torch.parallel.sharding import kv_store_specs
    b = get_bundle("granite-moe-3b-a800m", smoke=True)
    p = b.init_params(0, device="cpu")
    toks = torch.randint(0, 256, (2, 12), generator=torch.Generator()
                         .manual_seed(1))
    nxt = torch.tensor([[5], [7]])
    mesh = make_mesh((1, 4), AXES)
    pp = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
    cache = b.init_cache(2, 24, kv_dtype=kv_dtype, device="cpu")
    placed = shard_tree(cache, kv_store_specs(
        cache, mesh, kv_heads=b.cfg.n_kv_heads, head_dim=b.cfg.dh), mesh)
    with torch.no_grad():
        outs = [[b.prefill(params, toks, c)[0]] for params, c in
                ((p, cache), (pp, placed))]
        for _ in range(3):
            for o, params, c in ((outs[0], p, cache), (outs[1], pp, placed)):
                o.append(b.decode_step(params, nxt, c)[0])
    for a, c in zip(*outs):
        torch.testing.assert_close(c, a, rtol=RTOL, atol=ATOL)
    assert placed["k"].axes == ("model",) and \
        placed["k"].tensors()[0].shape[-1] == b.cfg.dh // 4


# ---------------------------------------------------------------------------
# 4 gloo processes at (2, 2)
# ---------------------------------------------------------------------------

def _rank_main(rank: int, init: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.parallel import ProcessRing, make_process_mesh
    torch.set_num_threads(1)        # 4 ranks share the test's cores
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    try:
        mesh = make_process_mesh((2, 2), AXES)
        assert all(isinstance(t, ProcessRing)
                   for t in mesh.transports.values())
        d, r = divmod(rank, 2)
        b = get_bundle("qwen3-4b", smoke=True)
        p = b.init_params(0, device="cpu")
        p = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
        shapes = {k: (tuple(v.tensors()[0].shape), len(v.shards))
                  for k, v in p["layers"].items()}
        opt = adamw_init(p)
        step = make_train_step(b.forward, TrainHyper(
            optimizer=AdamWConfig(**OPT), aux_weight=0.0))
        ms = []
        for batch in _batches():
            rows = {k: torch.from_numpy(v).long().chunk(2, 0)[d]
                    for k, v in batch.items()}
            p, opt, m = step(p, opt, rows)
            ms.append({k: float(v) for k, v in m.items()})
        g = gather_tree({"p": p, "o": opt})
        ring = mesh.transport("model")
        gathered = ring.all_gather([torch.full((2,), float(r))], 0)[0]
        torch.save({"ms": ms, "tree": g, "shapes": shapes,
                    "gathered": gathered}, Path(out_dir) / f"r{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_process_ranks_equal_the_local_mesh():
    """qwen3-4b's 3 smoke steps on 4 gloo processes at (2, 2): each rank
    holds only its model shard (``local_shape``), loads its data rank's
    rows, and its metrics and gathered state equal the (2, 2) mesh of
    local rings' within 1e-6 (which the reference holds above)."""
    with tempfile.TemporaryDirectory() as tmp:
        ctx = torch.multiprocessing.get_context("spawn")
        procs = [ctx.Process(target=_rank_main,
                             args=(r, f"file://{tmp}/store", tmp))
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
        got = [torch.load(Path(tmp) / f"r{r}.pt") for r in range(WORLD)]

    mesh = make_mesh((2, 2), AXES)
    b = get_bundle("qwen3-4b", smoke=True)
    p = b.init_params(0, device="cpu")
    specs = param_specs(b.kind, p, mesh)
    host = {k: v.numpy() if not isinstance(v, dict) else
            {kk: vv.numpy() for kk, vv in v.items()} for k, v in p.items()}
    want = _placed_run("qwen3-4b", host, mesh)
    for rank, g in enumerate(got):
        assert torch.equal(g["gathered"], torch.tensor([0., 0., 1., 1.]))
        for k, (shape, n) in g["shapes"].items():
            assert n == 1 and shape == local_shape(
                p["layers"][k].shape, specs["layers"][k], mesh,
                {"model": rank % 2}), k
        for gm, (wm, _, _) in zip(g["ms"], want):
            for key in ("loss", "ce", "grad_norm"):
                np.testing.assert_allclose(gm[key], wm[key],
                                           rtol=PROC_TOL, err_msg=key)
        mine = [t.numpy() for t in tree_leaves(g["tree"]["p"])]
        for a, w in zip(mine, want[-1][1]):
            np.testing.assert_allclose(a, w, rtol=PROC_TOL, atol=PROC_TOL)
        mine = [t.numpy() for t in tree_leaves(g["tree"]["o"]["mu"])] + \
            [t.numpy() for t in tree_leaves(g["tree"]["o"]["nu"])]
        for a, w in zip(mine, want[-1][2]):
            np.testing.assert_allclose(a, w, rtol=PROC_TOL, atol=PROC_TOL)


def test_engine_takes_a_model_axis_of_processes_only_placed():
    """An engine refuses global tensors on a model or a data axis of
    processes: both take params placed by ``shard_tree`` (over data
    processes each rank then owns its slots' pages,
    ``tests/test_torch_multihost.py``)."""
    from repro_torch.launch.serve import build_engine

    class FakeProcessRing:
        size = 2
    mesh = make_mesh((1, 2), AXES)
    mesh.transports["model"] = FakeProcessRing()
    with pytest.raises(NotImplementedError, match="shard_tree"):
        build_engine("qwen3-4b", kv_mode="paged", mesh=mesh, device="cpu")
    mesh = make_mesh((2, 1), AXES)
    mesh.transports["data"] = FakeProcessRing()
    with pytest.raises(NotImplementedError, match="page ownership"):
        build_engine("qwen3-4b", kv_mode="paged", mesh=mesh, device="cpu")

