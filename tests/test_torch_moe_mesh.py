"""The expert-parallel slice of the port (``LocalRing.all_to_all`` /
``ProcessRing.all_to_all``, ``models.layers.moe_ep_local`` and
``moe_layer``'s four mesh branches, the engine's mesh) against the
reference on the CPU.

The reference's ``moe_layer`` under a (2, 4) ("data", "model") mesh needs
8 virtual devices, fixed before jax starts: one subprocess
(``XLA_FLAGS=--xla_force_host_platform_device_count=8``, as
``tests/test_distributed.py`` runs it) computes, for E in {8, 6} x S in
{8, 1} (expert parallel over a split sequence, expert parallel on
replicated tokens, token split, TP in expert) at capacity factors 8.0 and
1.25, its output, aux loss and ``jax.grad`` of ``sum(out * g) + aux``
under the mesh, and each rank's dropped assignments by its own routing
(``_moe_route``, slots as its dispatch counts them).  The port runs the
same inputs under a (2, 4) mesh of local rings, and, in one spawn of 4
gloo processes, ``moe_ep_local`` on a process ring.

Tolerances: the reference test's own 2e-4 (``test_moe_distribution_
modes``) on out and aux, and on the grads (f32 sums in another order);
drops exactly equal.  A process rank equals the local ring within 1e-6
(f32: the same arithmetic; the all-reduce may sum in another order).
The smoke train steps under a (1, 4) mesh equal the steps with no mesh
within 1e-5 relative (params atol 1e-5), as ``tests/test_torch_train.py``
holds a step against the reference's."""
import functools
import math
import os
import subprocess
import sys
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from repro_torch.analysis.op_cost import CostMode  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.parallel import make_mesh, set_mesh  # noqa: E402
from repro_torch.parallel.mesh import LocalRing  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
D, F, K, B = 12, 16, 2, 4
CASES = [(E, S, cap) for E in (8, 6) for S in (8, 1) for cap in (8.0, 1.25)]
TOL = 2e-4
WEIGHTS = ("router", "w_gate", "w_up", "w_down")

REF_CODE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from repro.runtime import compat
from repro.models.layers import MoEConfig, _moe_route, moe_layer

CASES = %(cases)r
D, F, K, B = %(dims)r
rng = np.random.default_rng(0)
def nrm(*shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)

def drops(x, router, E, cap, m, nd, split):
    # each (data, model) rank's dropped assignments, data-major
    out = []
    for xd in np.split(x, nd, 0):
        for xs in (np.split(xd, m, 1) if split else [xd] * m):
            T = xs.shape[0] * xs.shape[1]
            _, gi, _ = _moe_route(jnp.asarray(xs.reshape(T, D)), router, K)
            gi = np.asarray(gi).reshape(-1)
            C = max(1, int(cap * T * K / E))
            oh = np.eye(E, dtype=np.int64)[gi]
            pos = ((np.cumsum(oh, 0) - oh) * oh).sum(-1)
            out.append(int((pos >= C).sum()))
    return np.asarray(out)

mesh = compat.make_mesh((2, 4), ("data", "model"))
out = {}
for i, (E, S, cap) in enumerate(CASES):
    cfg = MoEConfig(n_experts=E, top_k=K, d_ff=F, capacity_factor=cap)
    p = {"router": nrm(D, E, scale=0.5), "w_gate": nrm(E, D, F, scale=0.3),
         "w_up": nrm(E, D, F, scale=0.3), "w_down": nrm(E, F, D, scale=0.3)}
    x, g = nrm(B, S, D), nrm(B, S, D)
    def loss(x, p):
        o, a = moe_layer(x, p, cfg)
        return jnp.sum(o * g) + a
    with compat.set_mesh(mesh):
        o, a = jax.jit(lambda x, p: moe_layer(x, p, cfg))(x, p)
        gx, gp = jax.jit(jax.grad(loss, argnums=(0, 1)))(x, p)
    out.update({f"c{i}_x": x, f"c{i}_g": g, f"c{i}_out": np.asarray(o),
                f"c{i}_aux": np.asarray(a), f"c{i}_dx": np.asarray(gx),
                f"c{i}_drops": drops(x, p["router"], E, cap, 4, 2,
                                     S %% 4 == 0)})
    for k in p:
        out[f"c{i}_{k}"] = p[k]
        out[f"c{i}_d{k}"] = np.asarray(gp[k])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("moe_mesh_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    code = REF_CODE % {"cases": CASES, "dims": (D, F, K, B)}
    p = subprocess.run([sys.executable, "-c", code, str(path)],
                       capture_output=True, text=True, timeout=600, env=env)
    assert p.returncode == 0, p.stdout + "\n" + p.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def T(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol, what=""):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol, err_msg=what)


class _Drops:
    """Records each ``_moe_slots`` call's dropped assignments, in order
    (the body looks the function up through its module at call time)."""

    def __init__(self, monkeypatch):
        self.calls = []
        inner = pt_layers._moe_slots

        def counted(gate_idx, E, C):
            pos, keep = inner(gate_idx, E, C)
            self.calls.append(int((~keep).sum()))
            return pos, keep
        monkeypatch.setattr(pt_layers, "_moe_slots", counted)


def _branch(E, S, m=4):
    if E % m == 0:
        return "ep" if S % m == 0 else "ep_replicated"
    return "token_split" if S % m == 0 else "tp"


# ---------------------------------------------------------------------------
# the transports' all-to-all
# ---------------------------------------------------------------------------

def test_local_all_to_all_transposes_and_is_its_own_inverse():
    ring = LocalRing(4)
    xs = [torch.arange(8.).reshape(8, 1) + 100 * r for r in range(4)]
    ys = ring.all_to_all(xs)
    for j, y in enumerate(ys):
        want = torch.cat([xs[i][2 * j:2 * j + 2] for i in range(4)])
        assert torch.equal(y, want)
    assert all(torch.equal(a, b) for a, b in zip(ring.all_to_all(ys), xs))
    with pytest.raises(ValueError, match="does not split"):
        ring.all_to_all([torch.zeros(6, 1)] * 4)


def test_local_all_to_all_counts_every_rank_and_carries_grads():
    """Counted as the all-to-all it would be between cards (each rank's
    received bytes; none on a ring of one); autograd sends each chunk's
    gradient back to where it came from."""
    xs = [torch.randn(8, 3, requires_grad=True) for _ in range(4)]
    with CostMode() as m:
        ys = LocalRing(4).all_to_all(xs)
    assert m.cost.collectives == {"all-to-all": 4 * 8 * 3 * 4}
    ws = [torch.randn(8, 3) for _ in range(4)]
    grads = torch.autograd.grad(sum((y * w).sum() for y, w in zip(ys, ws)),
                                xs)
    for g, w in zip(grads, LocalRing(4).all_to_all(ws)):
        assert torch.equal(g, w)
    with CostMode() as m:
        LocalRing(1).all_to_all(xs[:1])
    assert m.cost.collectives == {}


# ---------------------------------------------------------------------------
# moe_layer under a (2, 4) mesh of local rings against the reference's
# ---------------------------------------------------------------------------

def _params(ref, i, grad=False):
    return {k: T(ref[f"c{i}_{k}"], grad) for k in WEIGHTS}


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"E{E}S{S}cap{cap}-{_branch(E, S)}"
                              for E, S, cap in CASES])
def test_moe_layer_under_mesh_matches_reference(ref, i, monkeypatch):
    """Out and aux at 2e-4, each rank's drops equal the reference
    routing's, and some drop at capacity 1.25 where the tokens split."""
    E, S, cap = CASES[i]
    cfg = pt_layers.MoEConfig(n_experts=E, top_k=K, d_ff=F,
                              capacity_factor=cap)
    drops = _Drops(monkeypatch)
    with set_mesh(make_mesh((2, 4), ("data", "model"))):
        out, aux = pt_layers.moe_layer(T(ref[f"c{i}_x"]), _params(ref, i),
                                       cfg)
    _close(out, ref[f"c{i}_out"], TOL, "out")
    _close(aux, ref[f"c{i}_aux"], TOL, "aux")
    assert drops.calls == ref[f"c{i}_drops"].tolist()
    if cap == 1.25 and S % 4 == 0:
        assert sum(drops.calls) > 0
    if cap == 8.0:
        assert sum(drops.calls) == 0


@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"E{E}S{S}cap{cap}-{_branch(E, S)}"
                              for E, S, cap in CASES])
def test_moe_layer_under_mesh_grads_match_reference(ref, i):
    """The port's autograd against ``jax.grad`` of the reference under its
    mesh: d/dx and d/d of the four weights of sum(out * g) + aux, 2e-4."""
    E, S, cap = CASES[i]
    cfg = pt_layers.MoEConfig(n_experts=E, top_k=K, d_ff=F,
                              capacity_factor=cap)
    x, p = T(ref[f"c{i}_x"], True), _params(ref, i, True)
    with set_mesh(make_mesh((2, 4), ("data", "model"))):
        out, aux = pt_layers.moe_layer(x, p, cfg)
        loss = (out * T(ref[f"c{i}_g"])).sum() + aux
        grads = torch.autograd.grad(loss, [x, *p.values()])
    _close(grads[0], ref[f"c{i}_dx"], TOL, "dx")
    for k, g in zip(p, grads[1:]):
        _close(g, ref[f"c{i}_d{k}"], TOL, f"d{k}")


def test_moe_layer_refuses_a_process_model_axis():
    """A model axis of processes takes shards: ``moe_layer`` raises rather
    than compute unsharded, and names the per-rank body."""
    class FakeProcessRing:
        size = 4
    mesh = make_mesh((1, 4), ("data", "model"))
    mesh.transports["model"] = FakeProcessRing()
    cfg = pt_layers.MoEConfig(n_experts=8, top_k=2, d_ff=F)
    p = {"router": torch.zeros(D, 8), "w_gate": torch.zeros(8, D, F),
         "w_up": torch.zeros(8, D, F), "w_down": torch.zeros(8, F, D)}
    with set_mesh(mesh), pytest.raises(NotImplementedError,
                                       match="moe_ep_local"):
        pt_layers.moe_layer(torch.zeros(1, 8, D), p, cfg)


def test_moe_layer_branches_count_their_collectives():
    """EP exchanges over all-to-all (twice a data rank); the token split
    and TP in expert send no token; TP sums its partial outputs."""
    for E, S, want_a2a, want_out_sum in ((8, 8, True, False),
                                         (8, 1, True, True),
                                         (6, 8, False, False),
                                         (6, 1, False, True)):
        cfg = pt_layers.MoEConfig(n_experts=E, top_k=K, d_ff=F)
        p = {"router": torch.randn(D, E), "w_gate": torch.randn(E, D, F),
             "w_up": torch.randn(E, D, F), "w_down": torch.randn(E, F, D)}
        with set_mesh(make_mesh((2, 4), ("data", "model"))), \
                CostMode() as m:
            pt_layers.moe_layer(torch.randn(B, S, D), p, cfg)
        coll = m.cost.collectives
        assert ("all-to-all" in coll) == want_a2a, (E, S, coll)
        # the aux means: one scalar over 4 model ranks a data rank, then
        # over 2 data ranks; the outputs' sum over model adds B/2 x S x D
        aux_bytes = 2 * 4 * 4 + 2 * 4
        out_bytes = 2 * 4 * (B // 2) * S * D * 4 if want_out_sum else 0
        assert coll["all-reduce"] == aux_bytes + out_bytes, (E, S, coll)


def test_olmoe_ep_all_to_all_bytes_on_meta():
    """``op_cost.count`` of one olmoe-1b-7b MoE layer at full width (E 64,
    top 8, D 2,048, F 1,024, bf16) under a (16, 16) mesh of local rings on
    the meta device: the all-to-all bytes are 2 exchanges x 256 ranks x
    n_groups x e_per x c x D x 2 bytes, by the reference's cost model
    (each rank's received bytes)."""
    from repro_torch.analysis import op_cost
    E, Kf, Dm, Fe = 64, 8, 2048, 1024
    Bg, S = 16, 256                 # a rank: B 1 x S 16 tokens
    cfg = pt_layers.MoEConfig(n_experts=E, top_k=Kf, d_ff=Fe)
    meta = dict(device="meta", dtype=torch.bfloat16)
    p = {"router": torch.empty(Dm, E, **meta),
         "w_gate": torch.empty(E, Dm, Fe, **meta),
         "w_up": torch.empty(E, Dm, Fe, **meta),
         "w_down": torch.empty(E, Fe, Dm, **meta)}
    x = torch.empty(Bg, S, Dm, **meta)

    def layer():
        with set_mesh(make_mesh((16, 16), ("data", "model"))):
            return pt_layers.moe_layer(x, p, cfg)
    cost = op_cost.count(layer)
    ranks, n_groups, e_per = 256, 16, E // 16
    c = max(1, int(1.25 * (Bg // 16) * (S // 16) * Kf / E))
    assert c == 2
    assert cost.collectives["all-to-all"] == \
        2 * ranks * n_groups * e_per * c * Dm * 2


# ---------------------------------------------------------------------------
# moe_ep_local on 4 gloo processes against the local ring
# ---------------------------------------------------------------------------

WORLD = 4
EP_CASES = ((8, 8, 1.25), (8, 1, 1.25))     # split and replicated tokens


def _ep_cases(x: dict, ring, shard, rank_parts) -> dict:
    """``moe_ep_local`` on ``ring`` for each EP case (``shard(t, dim)``:
    the part of a global tensor the transport takes), its output, aux and
    grads of sum(out * g) + aux; then the all-to-all alone and twice."""
    res = {}
    for i, (E, S, cap) in enumerate(EP_CASES):
        cfg = pt_layers.MoEConfig(n_experts=E, top_k=K, d_ff=F,
                                  capacity_factor=cap)
        rep = S % ring.size != 0
        xs = (T(x[f"e{i}_x"]) if rep else shard(T(x[f"e{i}_x"]), 1)) \
            .requires_grad_(True)
        g = T(x[f"e{i}_g"]) if rep else shard(T(x[f"e{i}_g"]), 1)
        router = T(x[f"e{i}_router"]).requires_grad_(True)
        ws = [shard(T(x[f"e{i}_{k}"]), 0).requires_grad_(True)
              for k in WEIGHTS[1:]]
        out, aux = pt_layers.moe_ep_local(xs, router, *ws, cfg=cfg,
                                          ring=ring, replicated=rep)
        grads = torch.autograd.grad((out * g).sum() + aux, [xs, router, *ws])
        res.update({f"e{i}_out": out.detach(), f"e{i}_aux": aux.detach()})
        for k, gr in zip(("x", *WEIGHTS), grads):
            res[f"e{i}_d{k}"] = gr
    a = rank_parts(T(x["a2a"]))
    once = ring.all_to_all(a)
    res["a2a_once"] = torch.stack(once)
    res["a2a_twice"] = torch.stack(ring.all_to_all(once))
    return res


def _ep_inputs() -> dict:
    rng = np.random.default_rng(3)
    x = {"a2a": rng.normal(size=(WORLD, 8, 5)).astype(np.float32)}
    for i, (E, S, _) in enumerate(EP_CASES):
        x.update({f"e{i}_x": rng.normal(size=(B, S, D)),
                  f"e{i}_g": rng.normal(size=(B, S, D)),
                  f"e{i}_router": rng.normal(size=(D, E)) * 0.5,
                  f"e{i}_w_gate": rng.normal(size=(E, D, F)) * 0.3,
                  f"e{i}_w_up": rng.normal(size=(E, D, F)) * 0.3,
                  f"e{i}_w_down": rng.normal(size=(E, F, D)) * 0.3})
    return {k: np.asarray(v, np.float32) for k, v in x.items()}


def _rank_main(rank: int, init: str, inputs: str, out_dir: str) -> None:
    import torch.distributed as dist

    from repro_torch.parallel import ProcessRing, make_process_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    try:
        ring = make_process_mesh((1, WORLD), ("data", "model")) \
            .transport("model")
        assert isinstance(ring, ProcessRing) and ring.index() == [rank]
        with np.load(inputs) as z:
            x = {k: z[k] for k in z.files}
        res = _ep_cases(x, ring, lambda t, dim: t.chunk(WORLD, dim)[rank],
                        lambda t: [t[rank]])
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_process_ring_moe_ep_equals_local_ring(tmp_path):
    """Each gloo rank's ``moe_ep_local`` on its tokens and E/4 experts
    against its part of the local ring's, forward and grads, within 1e-6:
    the split case's dx and experts' grads are the rank's chunk, the
    router's grad (every rank's routing) and, on replicated tokens, dx sum
    over the ranks.  The all-to-all alone equals the local ring's, and
    twice is the identity on both."""
    x = _ep_inputs()
    np.savez(tmp_path / "inputs.npz", **x)
    ctx = torch.multiprocessing.get_context("spawn")
    procs = [ctx.Process(target=_rank_main,
                         args=(r, f"file://{tmp_path / 'store'}",
                               str(tmp_path / "inputs.npz"), str(tmp_path)))
             for r in range(WORLD)]
    for p in procs:
        p.start()
    for p in procs:
        p.join(timeout=300)
    alive = [p.is_alive() for p in procs]
    for p in procs:
        if p.is_alive():
            p.kill()
            p.join(timeout=30)
    assert not any(alive), "a process hung"
    assert [p.exitcode for p in procs] == [0] * WORLD

    want = _ep_cases(x, LocalRing(WORLD), lambda t, dim: t,
                     lambda t: list(t))
    got = [torch.load(tmp_path / f"rank{r}.pt") for r in range(WORLD)]
    assert torch.equal(want["a2a_twice"], T(x["a2a"]))
    for r in range(WORLD):
        assert torch.equal(got[r]["a2a_once"][0], want["a2a_once"][r])
        assert torch.equal(got[r]["a2a_twice"][0], T(x["a2a"])[r])
    for i, (E, S, _) in enumerate(EP_CASES):
        rep = S % WORLD != 0
        summed = ["e%d_drouter" % i] + (["e%d_dx" % i] if rep else [])
        for key in (k for k in want if k.startswith(f"e{i}_")):
            w = want[key]
            if key in summed:
                part = sum(g[key] for g in got)
                np.testing.assert_allclose(part.numpy(), w.numpy(),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=key)
                continue
            for r in range(WORLD):
                if key.endswith("_aux") or (rep and key.endswith("_out")):
                    p_w = w
                else:
                    dim = 1 if key.endswith(("_out", "_dx")) else 0
                    p_w = w.chunk(WORLD, dim)[r]
                np.testing.assert_allclose(got[r][key].numpy(), p_w.numpy(),
                                           rtol=1e-6, atol=1e-6,
                                           err_msg=f"{key} rank {r}")


# ---------------------------------------------------------------------------
# the smoke train steps and the engines under a mesh
# ---------------------------------------------------------------------------

def _leaves(tree, pre=""):
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _leaves(v, pre + k + ".")
        else:
            yield pre + k, v


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "granite-moe-3b-a800m"])
def test_smoke_train_steps_under_mesh_equal_no_mesh(arch, monkeypatch):
    """Two steps of the smoke config (f32, capacity 8.0: nothing drops)
    through ``launch.train.run`` under a (1, 4) local mesh on a whole
    state (``place=False``), olmoe's 8 experts by expert parallelism and
    granite's 5 by the token split, against the same steps with no mesh.

    Under a mesh the aux loss is the mean of each rank's own balance term
    (the reference's ``psum(aux) / n``), not the term of all tokens, so
    the steps are held equal at aux weight 0: losses within 1e-5 relative,
    params within 1e-5.  At the default weight the first step's CE and
    z-loss terms are equal within 1e-5 of the loss and the loss is CE +
    0.01 aux + the z term, the mesh's aux in the same place as the
    unmeshed one."""
    from repro_torch.launch import train as train_mod
    seen = []
    for name in ("moe_ep_local", "_moe_token_split", "_moe_tp"):
        fn = getattr(pt_layers, name)
        monkeypatch.setattr(pt_layers, name,
                            lambda *a, _f=fn, _n=name, **k:
                            (seen.append(_n), _f(*a, **k))[1])
    kw = dict(smoke=True, steps=2, seq_len=32, global_batch=4,
              device="cpu", log_every=100)

    def both():
        base = train_mod.run(arch, mesh_kind="local", **kw)
        meshed = train_mod.run(arch, mesh_kind=make_mesh(
            (1, 4), ("data", "model")), place=False, **kw)
        return base, meshed

    base, meshed = both()
    assert set(seen) == {"moe_ep_local" if arch == "olmoe-1b-7b"
                         else "_moe_token_split"}
    (b0, m0) = (base["metrics"][0], meshed["metrics"][0])
    np.testing.assert_allclose(float(m0["ce"]), float(b0["ce"]), rtol=1e-5)
    z_base = float(b0["loss"]) - float(b0["ce"]) - 0.01 * float(b0["aux"])
    z_mesh = float(m0["loss"]) - float(m0["ce"]) - 0.01 * float(m0["aux"])
    # the z term by subtraction: within 1e-5 of the loss it came from
    np.testing.assert_allclose(z_mesh, z_base, rtol=0,
                               atol=1e-5 * float(b0["loss"]))
    assert float(m0["aux"]) != float(b0["aux"])

    monkeypatch.setattr(train_mod, "TrainHyper", functools.partial(
        train_mod.TrainHyper, aux_weight=0.0))
    base, meshed = both()
    np.testing.assert_allclose(meshed["losses"], base["losses"], rtol=1e-5)
    assert all(math.isfinite(v) for v in meshed["losses"])
    for (k, a), (_, b) in zip(_leaves(meshed["params"]),
                              _leaves(base["params"])):
        np.testing.assert_allclose(a.detach().numpy(), b.detach().numpy(),
                                   rtol=1e-5, atol=1e-5, err_msg=k)


@pytest.mark.parametrize("arch", ["olmoe-1b-7b", "qwen3-4b"])
def test_paged_engine_under_mesh_gives_dense_tokens(arch):
    """The reference's ``test_paged_pool_sharded_across_mesh`` on the
    port: a paged engine under a (2, 4) local mesh gives the dense
    engine's greedy tokens with no mesh; its page count is rounded up to
    the data axis's 2 ranks, its ``pool_specs`` are ``paged_pool_specs``,
    and olmoe's experts exchange tokens over the mesh."""
    from repro_torch.launch.serve import build_engine
    from repro_torch.parallel import paged_pool_specs
    mesh = make_mesh((2, 4), ("data", "model"))
    prompts = [np.arange(4 + 3 * i, dtype=np.int32) % 96 for i in range(4)]
    dense, _ = build_engine(arch, slots=2, max_len=48, max_new=4,
                            device="cpu")
    for p in prompts:
        dense.submit(p)
    want = dense.run()
    paged, _ = build_engine(arch, slots=2, max_len=48, max_new=4,
                            kv_mode="paged", page_size=8, mesh=mesh,
                            device="cpu")
    for p in prompts:
        paged.submit(p)
    with CostMode() as m:
        got = paged.run()
    assert got == want
    assert paged.kv.cfg.num_pages == 14            # 2 x 6 + 1, rounded up
    cfg = paged.bundle.cfg
    assert paged.pool_specs == paged_pool_specs(
        mesh, kv_heads=cfg.n_kv_heads, head_dim=cfg.dh)
    assert ("all-to-all" in m.cost.collectives) == (arch == "olmoe-1b-7b")


def test_engine_refuses_a_process_axis():
    from repro_torch.launch.serve import build_engine

    class FakeProcessRing:
        size = 2
    mesh = make_mesh((2, 1), ("data", "model"))
    mesh.transports["data"] = FakeProcessRing()
    with pytest.raises(NotImplementedError, match="sharded-state"):
        build_engine("olmoe-1b-7b", kv_mode="paged", mesh=mesh,
                     device="cpu")
