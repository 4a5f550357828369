"""Megatron-style sequence parallelism on the placed bodies, and the remat
switch, on the CPU over meshes of local rings.

The reference cuts the residual carried between blocks over the
``model`` axis along the sequence (``models/layers.py:24-57``,
``shard_seq`` / ``gather_seq``): the normed input is all-gathered at a
block's entry and the row-parallel partial sums land on the rows by a
reduce-scatter.  The port's placed bodies do the same where the axis has
more than one rank and divides S (``layers.shard_seq``), and keep the
replicated residual with all-reduced deltas elsewhere.

Every case is held against the reference's UNSHARDED step
(``make_train_step`` under plain ``jax.jit``, no mesh: the container's jax
refuses the reference's own device meshes), built at the same config
(mamba2 with ``sp=True``, the same ``remat``), on numpy inputs from a seed
and weights carried across by ``weights.from_jax_params``; smoke configs
in f32, aux weight 0 (under a mesh the port's MoE aux is the mean of the
ranks' own terms).  Tolerances: loss, ce, grad_norm within 1e-5 relative,
params and moments after the step within 1e-5 relative and absolute;
prefill logits within 1e-5; greedy tokens exact.  The op cost counter's
collectives (every LocalRing event recorded) show the reduce-scatter and
the all-gather and no all-reduce of a (B, S, D) tensor where the rule
holds (the other families: ``tests/test_torch_seq_parallel_families.py``,
on this file's helpers).  The remat switch: ``remat=False`` and ``True``
give bit-equal moments (so gradients) and each holds the reference; under
``True`` a transformer step runs the flash forward once a layer (its
recompute keeps ``attn_out``)."""
import dataclasses

import numpy as np
import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402

from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.models import transformer as ref_transformer  # noqa: E402
from repro.optim import AdamWConfig as RefAdamWConfig  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.training import TrainHyper as RefTrainHyper  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa
from repro_torch.analysis.op_cost import CostMode  # noqa: E402
from repro_torch.configs import get_bundle  # noqa: E402
from repro_torch.models import layers, transformer  # noqa: E402
from repro_torch.optim import AdamWConfig, adamw_init  # noqa: E402
from repro_torch.optim.adamw import tree_leaves  # noqa: E402
from repro_torch.parallel import make_mesh, mesh as pmesh  # noqa: E402
from repro_torch.parallel import tensor_parallel as tp  # noqa: E402
from repro_torch.parallel.sharding import (gather_tree, param_specs,  # noqa
                                           shard_tree)
from repro_torch.training import TrainHyper, make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

RTOL = ATOL = 1e-5
OPT = dict(warmup_steps=5, total_steps=10)
AXES = ("data", "model")
B = 4
S = 16          # divides 2 and 4; whisper's encoder runs its 32 frames
# each family's config for these tests (mamba2's sp is off by default);
# the other families' cases are tests/test_torch_seq_parallel_families.py
CASES = {"qwen3-4b": {}, "olmoe-1b-7b": {}, "recurrentgemma-9b": {},
         "whisper-medium": {}, "mamba2-370m": {"sp": True}}
DECODERS = ("qwen3-4b", "olmoe-1b-7b")


def _batch(cfg, kind: str, S: int = S, seed: int = 0) -> dict:
    rng = np.random.default_rng(seed)
    t = rng.integers(0, cfg.vocab, (B, S + 1)).astype(np.int32)
    b = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    if kind == "audio":
        b["frames"] = rng.normal(0, 1, (B, cfg.n_audio_ctx, cfg.d_model)) \
            .astype(np.float32)
    return b


def _t(batch: dict) -> dict:
    return {k: torch.from_numpy(v).long() if v.dtype == np.int32 else
            torch.from_numpy(v) for k, v in batch.items()}


def _with(bundle, **over):
    return dataclasses.replace(bundle, cfg=dataclasses.replace(bundle.cfg,
                                                               **over))


@pytest.fixture(scope="module")
def reference():
    """(arch, S, remat) -> (init params as numpy, the batch, the
    reference's unsharded step: metrics, params and moments after it)."""
    cache = {}

    def get(arch, S=S, remat=True):
        key = (arch, S, remat)
        if key in cache:
            return cache[key]
        rb = _with(ref_get_bundle(arch, smoke=True), remat=remat,
                   **CASES[arch])
        rp = rb.init_params(jax.random.PRNGKey(0))
        host = jax.tree.map(np.asarray, rp)
        batch = _batch(rb.cfg, rb.kind, S)
        step = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
            optimizer=RefAdamWConfig(**OPT), aux_weight=0.0)))
        rp, opt, m = step(rp, ref_adamw_init(rp), batch, np.float32(1.0))
        cache[key] = (host, batch, (
            {k: float(v) for k, v in m.items()},
            [np.asarray(x) for x in jax.tree.leaves(rp)],
            [np.asarray(x) for x in jax.tree.leaves(opt["mu"])] +
            [np.asarray(x) for x in jax.tree.leaves(opt["nu"])]))
        return cache[key]
    return get


class _Events:
    """Every collective a local ring or a conjugate reports, as (kind,
    bytes)."""

    def __init__(self, monkeypatch):
        self.seen = []
        real = pmesh.collective

        def record(kind, nbytes):
            self.seen.append((kind, nbytes))
            real(kind, nbytes)
        monkeypatch.setattr(pmesh, "collective", record)
        monkeypatch.setattr(tp, "collective", record)

    def kinds(self) -> set:
        return {k for k, _ in self.seen}

    def largest(self, kind: str) -> int:
        return max([n for k, n in self.seen if k == kind], default=0)


def _step(bundle, host, batch, mesh):
    """One placed (or whole, ``mesh`` None) step of the port: (metrics,
    params and moments after it, the op cost counter, each remat unit's
    saved inputs)."""
    p = from_jax_params(host)
    if mesh is not None:
        p = shard_tree(p, param_specs(bundle.kind, p, mesh), mesh)
    step = make_train_step(bundle.forward, TrainHyper(
        optimizer=AdamWConfig(**OPT), aux_weight=0.0))
    with CostMode() as cm, layers.unit_inputs() as units:
        p, opt, m = step(p, adamw_init(p), _t(batch))
    g = gather_tree({"p": p, "o": opt}) if mesh is not None else \
        {"p": p, "o": opt}
    got = ({k: float(v) for k, v in m.items()},
           [t.numpy() for t in tree_leaves(g["p"])],
           [t.numpy() for t in tree_leaves(g["o"]["mu"])] +
           [t.numpy() for t in tree_leaves(g["o"]["nu"])])
    return got, cm.cost, units


def _close(got, want):
    (gm, gp, go), (wm, wp, wo) = got, want
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(gm[key], wm[key], rtol=RTOL, err_msg=key)
    assert gm["finite"] == 1.0
    assert len(gp) == len(wp) and len(go) == len(wo)
    for n, (a, b) in enumerate(zip(gp + go, wp + wo)):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL,
                                   err_msg=f"leaf {n}")


def _residuals(units, rows: set, Bd: int, D: int) -> list:
    """Each unit's saved (Bd, r, D) float inputs with r in ``rows``."""
    return [[s for s, dt in seen if dt.is_floating_point and len(s) == 3
             and s[0] == Bd and s[2] == D and s[1] in rows]
            for seen in units]


def check_sp_step(reference, monkeypatch, arch, shape):
    """The placed step with the residual sequence-sharded holds the
    reference's unsharded step; the collectives are Megatron-SP's (the
    reduce-scatter and the all-gather, no all-reduce of a (B / d, S, D)
    tensor: the largest all-reduce is smaller than one); each remat unit
    keeps its m ranks' (B / d, S / m, D) rows, never the whole
    residual."""
    host, batch, want = reference(arch)
    bundle = _with(get_bundle(arch, smoke=True), **CASES[arch])
    events = _Events(monkeypatch)
    got, cost, units = _step(bundle, host, batch, make_mesh(shape, AXES))
    _close(got, want)
    d, m = shape
    cfg = bundle.cfg
    Bd, D = B // d, cfg.d_model
    assert {"reduce-scatter", "all-gather"} <= events.kinds()
    assert cost.collectives["reduce-scatter"] > 0
    delta = m * Bd * S * D * 4          # a local ring's count of one
    assert events.largest("all-reduce") < delta
    enc = getattr(cfg, "n_audio_ctx", None)      # whisper's encoder
    rows = {S // m} | ({enc // m} if enc else set())
    res = _residuals(units, rows, Bd, D)
    assert units and all(len(r) == m and len(set(r)) == 1 for r in res)
    for r, seen in zip(res, units):
        assert (Bd, r[0][1] * m, D) not in [s for s, _ in seen]


@pytest.mark.parametrize("shape", [(1, 2), (2, 2)])
@pytest.mark.parametrize("arch", DECODERS)
def test_sp_step_matches_reference(reference, monkeypatch, arch, shape):
    """qwen3-4b (dense) and olmoe-1b-7b (MoE: expert parallelism, each
    rank's tokens its rows) under :func:`check_sp_step`."""
    check_sp_step(reference, monkeypatch, arch, shape)


def check_indivisible(reference, monkeypatch, arch):
    """At S 15 over a 2-rank model axis the rule does not hold: the
    residual stays replicated (each unit keeps one (B, S, D) tensor) and
    the deltas are all-reduced; qwen3 reduce-scatters nothing (mamba2's
    one reduce-scatter is its gathered in_proj output's backward)."""
    host, batch, want = reference(arch, S=15)
    bundle = _with(get_bundle(arch, smoke=True), **CASES[arch])
    events = _Events(monkeypatch)
    got, cost, units = _step(bundle, host, batch, make_mesh((1, 2), AXES))
    _close(got, want)
    D = bundle.cfg.d_model
    assert events.largest("all-reduce") >= 2 * B * 15 * D * 4
    assert all(len(r) == 1 for r in _residuals(units, {15}, B, D))
    if arch == "qwen3-4b":
        assert "reduce-scatter" not in events.kinds()


def test_indivisible_sequence_takes_the_all_reduce_path(reference,
                                                        monkeypatch):
    check_indivisible(reference, monkeypatch, "qwen3-4b")


def test_shard_and_gather_seq_follow_the_reference_rules():
    """``shard_seq`` cuts a replicated (B, S, D) tensor or reduce-scatters
    partials where the axis has more than one rank and divides S, and is
    the identity (or the partials' sum) otherwise; ``gather_seq`` joins
    the rows for every rank; each conjugate's gradient is the one of the
    unsharded computation."""
    ring = pmesh.LocalRing(2)
    g = torch.Generator().manual_seed(0)
    x = torch.randn(2, 6, 4, generator=g, requires_grad=True)
    parts = [torch.randn(2, 6, 4, generator=g, requires_grad=True)
             for _ in range(2)]
    rows = layers.shard_seq(x, ring)
    assert [tuple(r.shape) for r in rows] == [(2, 3, 4)] * 2
    assert torch.equal(torch.cat(rows, 1), x)
    summed = layers.shard_seq(parts, ring)
    assert torch.equal(torch.cat(summed, 1), parts[0] + parts[1])
    whole = layers.gather_seq(summed, ring)
    assert len(whole) == 2 and all(torch.equal(w, parts[0] + parts[1])
                                   for w in whole)
    # no-ops: one rank, S indivisible, not 3-D
    assert layers.shard_seq(x, pmesh.LocalRing(1)) is x
    odd = torch.randn(2, 5, 4)
    assert layers.shard_seq(odd, ring) is odd
    assert torch.equal(layers.shard_seq([odd, odd], ring), odd + odd)
    flat = torch.randn(6, 4)
    assert layers.shard_seq(flat, ring) is flat
    # gradients: rank r's use of every gathered copy, through the conjugates
    w = torch.randn(2, 6, 4, generator=g)
    loss = sum((h * w * (i + 1)).sum() for i, h in enumerate(
        layers.gather_seq(layers.shard_seq(parts, ring), ring)))
    gs = torch.autograd.grad(loss, parts)
    for gp in gs:
        torch.testing.assert_close(gp, 3 * w)
    (gx,) = torch.autograd.grad(sum((r * r).sum() for r in rows), x)
    torch.testing.assert_close(gx, 2 * x.detach())


def test_collective_mode_counts_what_the_full_counter_counts():
    """``op_cost.CollectiveMode`` (the card phases' cheap count of a
    step's collectives) gives the full counter's collectives by kind on a
    sequence-sharded placed step."""
    from repro_torch.analysis.op_cost import CollectiveMode
    b = get_bundle("qwen3-4b", smoke=True)
    batch = _t(_batch(b.cfg, b.kind))
    mesh = make_mesh((2, 2), AXES)
    step = make_train_step(b.forward, TrainHyper())
    got = []
    for mode in (CostMode, CollectiveMode):
        p = b.init_params(0, device="cpu")
        p = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
        with mode() as m:
            step(p, adamw_init(p), batch)
        got.append(dict(m.cost.collectives))
    assert got[0] == got[1] and got[0]["reduce-scatter"] > 0


@pytest.mark.parametrize("mesh_shape", [None, (1, 2)])
def test_remat_switch_keeps_grads_bit_equal(reference, mesh_shape):
    """qwen3-4b on the flash path (``attn_impl="pallas"``: the kernels'
    plain halves on the CPU): ``remat=False`` builds and trains, its
    moments after a step (so its gradients) equal ``remat=True``'s bit for
    bit, both hold the reference built at the same ``remat``, and under
    ``True`` the flash forward runs once a layer and rank: the recompute
    keeps ``attn_out`` (``transformer.SAVED``)."""
    got = {}
    for remat in (True, False):
        host, batch, want = reference("qwen3-4b", remat=remat)
        bundle = _with(get_bundle("qwen3-4b", smoke=True), remat=remat,
                       attn_impl="pallas")
        mesh = None if mesh_shape is None else make_mesh(mesh_shape, AXES)
        got[remat], cost, units = _step(bundle, host, batch, mesh)
        _close(got[remat], want)
        L = bundle.cfg.n_layers
        n = L * (1 if mesh_shape is None else mesh_shape[1])
        assert {k: v["calls"] for k, v in cost.kernels.items()} == {
            "flash_fwd": n, "flash_bwd_dq": n, "flash_bwd_dkv": n}
        assert len(units) == (L if remat else 0)
    (ma, pa, oa), (mb, pb, ob) = got[True], got[False]
    assert ma == mb
    assert all(np.array_equal(a, b) for a, b in zip(pa + oa, pb + ob))
    assert transformer.SAVED == ("attn_out",)


@pytest.mark.parametrize("shape", [(1, 2), (1, 4)])
def test_sp_prefill_matches_reference(shape):
    """The placed prefill (S 12 divides both axes: the residual
    sequence-sharded between layers, each rank's K/V from the gathered
    sequence) gives the reference's last-position logits within 1e-5,
    and three greedy decode steps after it the reference's tokens."""
    import jax.numpy as jnp

    from repro_torch.parallel import cache_specs
    rb = ref_get_bundle("qwen3-4b", smoke=True)
    rp = rb.init_params(jax.random.PRNGKey(0))
    toks = np.random.default_rng(3).integers(0, 256, (2, 12)) \
        .astype(np.int32)
    rcache = ref_transformer.init_cache(rb.cfg, 2, 24)
    logits, rcache = jax.jit(lambda p, t, c: ref_transformer.prefill(
        rb.cfg, p, t, c))(rp, toks, rcache)
    want = [np.asarray(logits)]
    step = jax.jit(lambda p, t, c: ref_transformer.decode_step(
        rb.cfg, p, t, c))
    for _ in range(3):
        nxt = jnp.argmax(logits[:, -1], -1)[:, None].astype(jnp.int32)
        logits, rcache = step(rp, nxt, rcache)
        want.append(np.asarray(logits))
    b = get_bundle("qwen3-4b", smoke=True)
    mesh = make_mesh(shape, AXES)
    p = from_jax_params(jax.tree.map(np.asarray, rp))
    pp = shard_tree(p, param_specs(b.kind, p, mesh), mesh)
    cfg = b.cfg
    cache = shard_tree(b.init_cache(2, 24, device="cpu"), cache_specs(
        mesh, kv_heads=cfg.n_kv_heads, head_dim=cfg.dh), mesh)
    with torch.no_grad():
        out = b.prefill(pp, torch.from_numpy(toks).long(), cache)[0]
        got = [out]
        for _ in range(3):
            nxt = out[:, -1].argmax(-1)[:, None]
            out = b.decode_step(pp, nxt, cache)[0]
            got.append(out)
    np.testing.assert_allclose(got[0].numpy(), want[0], rtol=RTOL,
                               atol=ATOL)
    for a, w in zip(got, want):
        np.testing.assert_array_equal(a[:, -1].argmax(-1).numpy(),
                                      w[:, -1].argmax(-1))
