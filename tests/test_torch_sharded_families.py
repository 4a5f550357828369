"""The placed state for the other families on the CPU: mamba2-370m (ssm),
recurrentgemma-9b (hybrid) and whisper-medium (audio), their params and
AdamW moments placed by ``param_specs`` and their tensor-parallel bodies
(``models/{mamba2,recurrentgemma,whisper}.py``), the family rule that
places their caches (``parallel.sharding.store_specs``), and the refusal
of a kind without a placed body.

As ``tests/test_torch_sharded.py`` does for the decoder, the step on a
placed state is held against the reference's UNSHARDED step
(``make_train_step`` under plain ``jax.jit``, no mesh) on the same numpy
inputs (whisper's ``frames`` random, from the seed) and weights carried
across by ``weights.from_jax_params``.  Smoke configs in f32.

Tolerances (that file's): loss, ce, grad_norm and lr within 1e-5
relative; params and moments within 1e-5 relative and 1e-5 absolute over
3 steps (sums in another order: the model axis's partials, mamba2's
per-rank sums of squares, the data ranks' gradients).  Placed prefill and
decode logits within 1e-5 of the unsharded ones; placed dense engines'
greedy tokens equal the unsharded engine's exactly; a gloo process rank
within 1e-6 of the same mesh of local rings."""
import dataclasses
import tempfile
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.configs import get_bundle  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel import make_mesh  # noqa: E402
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
FAMILIES = ("mamba2-370m", "recurrentgemma-9b", "whisper-medium")


def _batches(cfg, kind: str, n=3, B=4, S=32, seed=0):
    """n batches of (B, S) tokens and labels, with random ``frames`` for
    the audio kind, made with numpy."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        t = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
        b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
        if kind == "audio":
            b["frames"] = rng.normal(0, 1, (B, cfg.n_audio_ctx, cfg.d_model)) \
                .astype(np.float32)
        out.append(b)
    return out


def _t(batch):
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
            torch.from_numpy(v) for k, v in batch.items()}


@pytest.fixture(scope="module")
def reference():
    """arch -> (the reference's init params as numpy, its 3-step
    trajectory: metrics, params, moments after each step)."""
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
            optimizer=RefAdamWConfig(**OPT))))
        opt = ref_adamw_init(rp)
        traj = []
        for b in _batches(rb.cfg, rb.kind):
            rp, opt, m = step(rp, opt, b, np.float32(1.0))
            traj.append(({k: float(v) for k, v in m.items()},
                         [np.asarray(x) for x in jax.tree.leaves(rp)],
                         [np.asarray(x) for x in jax.tree.leaves(opt["mu"])]
                         + [np.asarray(x)
                            for x in jax.tree.leaves(opt["nu"])]))
        cache[arch] = (host, traj)
        return cache[arch]
    return get


def _placed_run(arch, host, mesh):
    """3 steps of the port's step on the state placed on ``mesh``: the
    metrics, gathered params and moments after each step."""
    b = get_bundle(arch, smoke=True)
    p = from_jax_params(host)
    p = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
    opt = adamw_init(p)
    step = make_train_step(b.forward, TrainHyper(
        optimizer=AdamWConfig(**OPT)))
    out = []
    for batch in _batches(b.cfg, b.kind):
        p, opt, m = step(p, opt, _t(batch))
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
@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_step_matches_reference(reference, arch, shape):
    """3 AdamW steps on the placed state against the reference's unsharded
    step.  At m 4: mamba2's 296 in_proj columns cut 74 a rank across the
    z | xBC | dt boundaries (its 8 heads two a rank); recurrentgemma's W 64
    16 a rank, its one kv head's 16 features 4 a rank (k / v gathered);
    whisper's 4 heads one a rank."""
    mesh = make_mesh(shape, AXES)
    print(f"{arch} mesh {mesh}")
    host, want = reference(arch)
    _close(_placed_run(arch, host, mesh), want, RTOL, ATOL)


def _serve_inputs(b, B=2, S=12, seed=1):
    g = torch.Generator().manual_seed(seed)
    toks = torch.randint(0, b.cfg.vocab, (B, S), generator=g)
    extras = {k: torch.randn(v.shape, generator=g)
              for k, v in b.zero_extras(B, torch.float32, "cpu").items()}
    return toks, extras or None


@pytest.mark.parametrize("shape", [(1, 4), (1, 3)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_prefill_and_decode_equal_unsharded(arch, shape):
    """prefill and three decode steps on a placed state and cache give
    the unsharded logits within 1e-5, the cache's shards as the family's
    rule places them.  recurrentgemma's 12-token prompt overruns its
    10-slot window ring, so its decode wraps.  m 3 divides no head count
    of the smoke configs: heads straddle ranks (the projections gathered)
    and the caches stay whole (mamba2's SSM state, whisper's K/V,
    recurrentgemma's ring)."""
    b = get_bundle(arch, smoke=True)
    mesh = make_mesh(shape, AXES)
    print(f"{arch} mesh {mesh}")
    p = b.init_params(0, device="cpu")
    pp = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
    toks, extras = _serve_inputs(b)
    max_len = 10 if b.kind == "hybrid" else 24
    cache = b.init_cache(2, max_len, device="cpu")
    specs = b.store_specs(cache, mesh)
    placed = shard_tree(b.init_cache(2, max_len, device="cpu"), specs, mesh)
    nxt = torch.tensor([[5], [7]])
    with torch.no_grad():
        outs = [[b.prefill(params, toks, c, extras)[0]]
                for params, c in ((p, cache), (pp, placed))]
        for _ in range(3):
            for o, params, c in ((outs[0], p, cache), (outs[1], pp, placed)):
                o.append(b.decode_step(params, nxt, c)[0])
    for a, c in zip(*outs):
        torch.testing.assert_close(c, a, rtol=RTOL, atol=ATOL)
    for k, leaf in placed.items():
        for key, t in leaf.shards.items():
            assert tuple(t.shape) == local_shape(
                leaf.shape, specs[k], mesh, dict(zip(leaf.axes, key))), k
    # the placed cache holds the unsharded one's states
    whole = gather_tree(placed)
    for k in cache:
        torch.testing.assert_close(whole[k], cache[k], rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_dense_engine_gives_unsharded_tokens(arch, shape):
    """A dense-mode engine on a placed state (its slot pool placed by the
    family's rule) serves the unsharded engine's greedy tokens exactly."""
    from repro_torch.launch.serve import build_engine
    mesh = make_mesh(shape, AXES)
    print(f"{arch} mesh {mesh}")
    prompts = [np.arange(4 + 3 * i, dtype=np.int32) % 96 for i in range(4)]
    dense, _ = build_engine(arch, slots=2, max_len=48, max_new=4,
                            device="cpu")
    for q in prompts:
        dense.submit(q)
    want = dense.run()
    placed, _ = build_engine(arch, slots=2, max_len=48, max_new=4,
                             device="cpu", mesh=mesh, place=True)
    for q in prompts:
        placed.submit(q)
    assert placed.run() == want
    m = shape[1]
    cut = {"ssm": ("ssm",), "hybrid": ("k", "v", "conv_g", "lru_g", "conv_t",
                                       "lru_t"),
           "audio": ("k", "v", "xk", "xv")}[placed.bundle.bundle.kind]
    for k, leaf in placed._dense_cache.items():
        assert isinstance(leaf, Placed)
        assert len(leaf.shards) == (m if k in cut else 1), k


@pytest.mark.parametrize("arch", FAMILIES)
def test_placed_run_under_a_mesh_completes(arch):
    """``launch.train.run`` under a (2, 2) local mesh places the state and
    trains it (before the placed bodies these families raised there), its
    losses within 1e-5 of the unsharded run's."""
    from repro_torch.launch.train import run
    mesh = make_mesh((2, 2), AXES)
    print(f"{arch} mesh {mesh}")
    kw = dict(steps=2, seq_len=32, global_batch=4, device="cpu",
              log_every=100)
    got = run(arch, mesh_kind=mesh, **kw)
    want = run(arch, **kw)
    assert isinstance(got["params"]["embed"], Placed)
    np.testing.assert_allclose(got["losses"], want["losses"], rtol=RTOL)


def test_a_kind_without_a_placed_body_is_refused():
    """``run`` and ``build_engine(place=True)`` check the bundle's module
    for a placed body before placing anything: a module without
    ``placed`` raises ValueError naming the kind, and nothing falls back
    to the whole state; ``place=False`` keeps the whole state and runs."""
    import types

    from repro_torch.launch.serve import build_engine
    from repro_torch.launch.train import run
    from repro_torch.models import mamba2
    base = get_bundle("mamba2-370m", smoke=True)
    family = types.SimpleNamespace(**{k: getattr(mamba2, k)
                                      for k in dir(mamba2)
                                      if not k.startswith("__")})
    del family.placed
    stub = dataclasses.replace(base, kind="stub", family=family)
    assert base.has_placed_body and not stub.has_placed_body
    mesh = make_mesh((1, 2), AXES)
    print(f"stub mesh {mesh}")
    with pytest.raises(ValueError, match="kind 'stub'.*place=False"):
        run(stub, steps=1, seq_len=16, global_batch=2, mesh_kind=mesh,
            device="cpu")
    with pytest.raises(ValueError, match="kind 'stub'.*place=False"):
        build_engine(stub, device="cpu", mesh=mesh, place=True)
    out = run(stub, steps=1, seq_len=16, global_batch=2, mesh_kind=mesh,
              device="cpu", place=False, log_every=100)
    assert not isinstance(out["params"]["embed"], Placed)
    assert np.isfinite(out["losses"]).all()


def test_store_specs_refuses_a_kind_without_a_rule():
    from repro_torch.parallel.sharding import store_specs
    cfg = get_bundle("mamba2-370m", smoke=True).cfg
    with pytest.raises(ValueError, match="'stub'"):
        store_specs("stub", {}, make_mesh((1, 2), AXES), cfg)


# ---------------------------------------------------------------------------
# 4 gloo processes at (2, 2)
# ---------------------------------------------------------------------------

PROC_ARCH = "recurrentgemma-9b"


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
        d = rank // 2
        b = get_bundle(PROC_ARCH, smoke=True)
        p = b.init_params(0, device="cpu")
        p = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
        opt = adamw_init(p)
        step = make_train_step(b.forward, TrainHyper(
            optimizer=AdamWConfig(**OPT)))
        ms = []
        for batch in _batches(b.cfg, b.kind):
            rows = {k: v.chunk(2, 0)[d] for k, v in _t(batch).items()}
            p, opt, m = step(p, opt, rows)
            ms.append({k: float(v) for k, v in m.items()})
        g = gather_tree({"p": p, "o": opt})
        torch.save({"ms": ms, "tree": g}, Path(out_dir) / f"r{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_process_ranks_equal_the_local_mesh():
    """recurrentgemma-9b's 3 smoke steps on 4 gloo processes at (2, 2)
    (the conv output's all-gather before the gates, the kv head's
    gathered projections, the replicated ``lam`` and ``conv_w`` used per
    rank through ``copy_to_model``): each rank's metrics and gathered
    state equal the (2, 2) mesh of local rings' within 1e-6 (which the
    reference holds above)."""
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
    print(f"{PROC_ARCH} mesh {mesh} against 4 gloo processes at (2, 2)")
    b = get_bundle(PROC_ARCH, smoke=True)
    p = b.init_params(0, device="cpu")
    host = _numpy_tree(p)
    want = _placed_run(PROC_ARCH, host, mesh)
    for g in got:
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


def _numpy_tree(tree):
    if isinstance(tree, dict):
        return {k: _numpy_tree(v) for k, v in tree.items()}
    return None if tree is None else tree.numpy()
