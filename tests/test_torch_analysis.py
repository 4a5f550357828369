"""The port's analysis slice against the reference (CPU): the sharding rules
and the bundles' abstract shapes equal the reference's, leaf for leaf; the
op cost counter (``analysis.op_cost``) against the reference's HLO cost
parser (``repro.analysis.hlo_cost.module_cost``) and ``FlopCounterMode``;
each hand-written kernel's work formula against the dense computation;
a step counted on the CPU and on the meta device; the kernels' meta
routes; the card bounds ``chip_smoke.py`` prints; and the live roofline's
rows (``obs.roofline_live``) against the reference's.

Flops are compared exactly: both counters count 2 per multiply-add of a
matmul or convolution and nothing else.  Bytes are the port's own (aten
operands and outputs, where XLA fuses), so they are held only to the
rules the counter states."""
import dataclasses
import functools
import importlib.util
import math
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402
from jax.sharding import AbstractMesh  # noqa: E402

from repro.analysis.hlo_cost import module_cost  # noqa: E402
from repro.configs import ARCH_IDS as REF_ARCHS  # noqa: E402
from repro.configs import SHAPES as REF_SHAPES  # noqa: E402
from repro.configs import get_bundle as ref_get_bundle  # noqa: E402
from repro.launch import serve as ref_serve  # noqa: E402
from repro.launch import specs as ref_specs  # noqa: E402
from repro.obs import roofline_live as ref_live  # noqa: E402
from repro.optim import adamw_init as ref_adamw_init  # noqa: E402
from repro.parallel import sharding as ref_sharding  # noqa: E402
from repro.training import TrainHyper as RefTrainHyper  # noqa: E402
from repro.training import make_train_step as ref_make_train_step  # noqa
from repro_torch.analysis import kernel_work, op_cost  # noqa: E402
from repro_torch.analysis.op_cost import CostMode, count  # noqa: E402
from repro_torch.configs import ARCH_IDS, SHAPES, get_bundle  # noqa: E402
from repro_torch.kernels import ops  # noqa: E402
from repro_torch.launch import serve as pt_serve  # noqa: E402
from repro_torch.launch import specs  # noqa: E402
from repro_torch.obs import roofline_live as live  # noqa: E402
from repro_torch.optim import adamw_init  # noqa: E402
from repro_torch.parallel import sharding  # noqa: E402
from repro_torch.parallel.mesh import make_mesh, set_mesh  # noqa: E402
from repro_torch.training import TrainHyper, make_train_step  # noqa: E402
from repro_torch.weights import from_jax_params  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
MESHES = [((16, 16), ("data", "model")),
          ((2, 16, 16), ("pod", "data", "model")),
          ((2, 4), ("data", "model")), ((1, 1), ("data", "model"))]
DTYPES = {jnp.int32: torch.int32, jnp.bfloat16: torch.bfloat16,
          jnp.float32: torch.float32, jnp.int8: torch.int8}


def _flat(tree, prefix=()):
    """{path: leaf} of a nested dict (the reference's trees are dicts)."""
    if isinstance(tree, dict):
        out = {}
        for k, v in tree.items():
            out.update(_flat(v, prefix + (k,)))
        return out
    return {prefix: tree}


def _ref_spec(p):
    return tuple(p)


@functools.lru_cache(maxsize=None)
def _ref_abstract(arch):
    return ref_get_bundle(arch).abstract_params()


@functools.lru_cache(maxsize=None)
def _ref_inputs(arch, shape):
    return ref_get_bundle(arch).input_specs(shape)


def _ref_is_spec(x):
    return isinstance(x, jax.sharding.PartitionSpec)


# ---------------------------------------------------------------------------
# the sharding rules and the abstract shapes
# ---------------------------------------------------------------------------

def test_the_port_has_the_reference_archs_and_shapes():
    assert ARCH_IDS == tuple(REF_ARCHS)
    assert SHAPES == REF_SHAPES


@pytest.mark.parametrize("mesh_shape,axes", MESHES,
                         ids=lambda m: "x".join(map(str, m))
                         if isinstance(m[0], int) else "-".join(m))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_param_specs_equal_the_reference(arch, mesh_shape, axes):
    ref_mesh = AbstractMesh(mesh_shape, axes)
    mesh = make_mesh(mesh_shape, axes)
    ref_params = _ref_abstract(arch)
    want = _flat(jax.tree.map(_ref_spec, ref_sharding.param_specs(
        ref_get_bundle(arch).kind, ref_params, ref_mesh),
        is_leaf=_ref_is_spec))
    params = get_bundle(arch).abstract_params()
    got = _flat(sharding.param_specs(get_bundle(arch).kind, params, mesh))
    assert got == want
    # the leaves themselves: shapes and dtypes on the meta device
    ref_leaves, leaves = _flat(ref_params), _flat(params)
    assert set(leaves) == set(ref_leaves)
    for k, leaf in leaves.items():
        assert leaf.is_meta
        assert tuple(leaf.shape) == tuple(ref_leaves[k].shape), k
        assert leaf.dtype == DTYPES[ref_leaves[k].dtype.type], k


@pytest.mark.parametrize("mesh_shape,axes", MESHES[:2],
                         ids=["single", "multi"])
def test_batch_cache_and_pool_specs_equal_the_reference(mesh_shape, axes):
    ref_mesh, mesh = AbstractMesh(mesh_shape, axes), make_mesh(mesh_shape,
                                                               axes)
    for kind in ("long", "train"):
        assert sharding.batch_specs(kind, mesh) == {
            k: tuple(v) for k, v in
            ref_sharding.batch_specs(kind, ref_mesh).items()}
    for kv, dh, long in ((8, 128, False), (40, 128, False), (1, 256, True),
                         (16, 64, False), (5, 100, True)):
        assert sharding.cache_specs(mesh, kv_heads=kv, head_dim=dh,
                                    long_context=long) == {
            k: tuple(v) for k, v in ref_sharding.cache_specs(
                ref_mesh, kv_heads=kv, head_dim=dh,
                long_context=long).items()}
        assert sharding.paged_pool_specs(mesh, kv_heads=kv,
                                         head_dim=dh) == {
            k: tuple(v) for k, v in ref_sharding.paged_pool_specs(
                ref_mesh, kv_heads=kv, head_dim=dh).items()}


@pytest.mark.parametrize("shape", list(SHAPES))
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_input_specs_and_spec_trees_equal_the_reference(arch, shape):
    """input_specs' shapes and dtypes, step_kind and min_hbm_bytes, and the
    batch and cache spec trees on the (16, 16) and (2, 16, 16) meshes."""
    bundle, ref = get_bundle(arch), ref_get_bundle(arch)
    assert bundle.step_kind(shape) == ref.step_kind(shape)
    assert bundle.min_hbm_bytes(shape) == ref.min_hbm_bytes(shape)
    assert bundle.supports(shape) == ref.supports(shape)
    got, want = bundle.input_specs(shape), _ref_inputs(arch, shape)
    flat_got, flat_want = _flat(got), _flat(want)
    assert set(flat_got) == set(flat_want)
    for k, leaf in flat_got.items():
        assert leaf.is_meta
        assert tuple(leaf.shape) == tuple(flat_want[k].shape), k
        assert leaf.dtype == DTYPES[flat_want[k].dtype.type], k
    long = shape == "long_500k"
    for mesh_shape, axes in MESHES[:2]:
        ref_mesh, mesh = AbstractMesh(mesh_shape, axes), make_mesh(
            mesh_shape, axes)
        assert specs.data_axes(mesh) == ref_specs.data_axes(ref_mesh)
        assert specs.batch_spec_tree(got, mesh, long=long) == {
            k: tuple(v) for k, v in ref_specs.batch_spec_tree(
                want, ref_mesh, long=long).items()}
        if "cache" in got:
            assert _flat(specs.cache_spec_tree(
                got["cache"], mesh, long=long)) == _flat(jax.tree.map(
                    _ref_spec, ref_specs.cache_spec_tree(
                        want["cache"], ref_mesh, long=long),
                    is_leaf=_ref_is_spec))


def test_placements_and_local_shapes_follow_dtensor():
    """A spec's DTensor placements over the mesh axes, and each rank's
    local shape by DTensor's own uneven chunking."""
    from torch.distributed.tensor import Replicate, Shard
    mesh = make_mesh((2, 16, 16), ("pod", "data", "model"))
    assert sharding.placements((("pod", "data"), None, "model"), mesh) == \
        [Shard(0), Shard(0), Shard(2)]
    assert sharding.placements((None, "model"), mesh) == \
        [Replicate(), Replicate(), Shard(1)]
    tree = {"a": ((None, "model")), "b": {"c": (("pod", "data"),)}}
    assert sharding.make_shardings(tree, mesh) == {
        "a": [Replicate(), Replicate(), Shard(1)],
        "b": {"c": [Shard(0), Shard(0), Replicate()]}}
    for size in (0, 1, 5, 16, 40, 151936, 1000):
        for n in (1, 2, 16):
            for rank in range(n):
                want = Shard(0)._local_shard_size_and_offset(size, n, rank)[0]
                got = sharding.local_shape(
                    (size,), ("model",), make_mesh((1, n), ("data", "model")),
                    {"model": rank})
                assert got == (want,)
    # two axes on one dim: split by pod, then by data
    assert sharding.local_shape((40, 7), (("pod", "data"), None), mesh) == \
        (2, 7)
    assert sharding.local_shape((40, 7), (("pod", "data"), None), mesh,
                                {"pod": 1, "data": 15}) == (0, 7)


# ---------------------------------------------------------------------------
# the op cost counter against the reference's HLO cost parser
# ---------------------------------------------------------------------------

def _module_cost(fn, *args):
    return module_cost(jax.jit(fn).lower(*args).compile().as_text())


def test_plain_matmul_counts_as_the_reference():
    a = np.random.default_rng(0).standard_normal((256, 512), np.float32)
    b = np.random.default_rng(1).standard_normal((512, 128), np.float32)
    want = _module_cost(lambda x, y: x @ y, a, b).flops
    got = count(lambda x, y: x @ y, torch.from_numpy(a), torch.from_numpy(b))
    assert got.flops == want == 2 * 256 * 512 * 128
    assert got.bytes == 4 * (256 * 512 + 512 * 128 + 256 * 128)


def test_smoke_forward_counts_as_the_reference():
    """qwen3-4b's smoke forward at B 2 x S 16: 6,029,312 flops in both,
    and in ``FlopCounterMode``."""
    from torch.utils.flop_counter import FlopCounterMode
    ref = ref_get_bundle("qwen3-4b", smoke=True)
    rp = ref.init_params(jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, 256, (2, 16)).astype(np.int32)
    want = _module_cost(lambda p, t: ref.forward(p, {"tokens": t}), rp,
                        tok).flops
    bundle = get_bundle("qwen3-4b", smoke=True)
    params = from_jax_params(jax.tree.map(np.asarray, rp))
    batch = {"tokens": torch.from_numpy(tok)}
    with torch.no_grad():
        got = count(bundle.forward, params, batch)
        with FlopCounterMode(display=False) as fc:
            bundle.forward(params, batch)
    assert got.flops == want == fc.get_total_flops() == 6_029_312


def test_a_layer_loop_counts_its_body_times_the_layers():
    """The port runs layers as a Python loop: 12 layers count 12 x one
    body, flops equal to the reference's scan-aware count of the scan."""
    x = torch.randn(128, 128)

    def body(c):
        return torch.tanh(c @ c)

    def loop(c):
        for _ in range(12):
            c = body(c)
        return c
    one, twelve = count(body, x), count(loop, x)
    assert (twelve.flops, twelve.bytes) == (12 * one.flops, 12 * one.bytes)

    def scan(c):
        out, _ = jax.lax.scan(lambda c, _: (jnp.tanh(c @ c), None), c, None,
                              length=12)
        return out
    assert twelve.flops == _module_cost(scan, x.numpy()).flops


def test_elementwise_bytes_are_inputs_plus_output():
    x = torch.randn(1024, 1024)
    y = torch.randn(1024, 1024)
    assert count(lambda a: a + 1.0, x).bytes == 2 * 4 * 1024 * 1024
    assert count(torch.add, x, y).bytes == 3 * 4 * 1024 * 1024
    # views, reshapes and allocations move nothing
    assert count(lambda a: a.reshape(-1)[:10].unsqueeze(0).t(), x).bytes == 0
    # a reshape that must copy reads and writes the tensor
    assert count(lambda a: a.t().reshape(-1), x).bytes == 2 * 4 * 1024 * 1024
    assert count(lambda: torch.empty(4096, 4096)).bytes == 0


@pytest.mark.parametrize("impl", ["xla", "pallas"])
def test_smoke_train_step_counts_as_the_reference_but_the_attention_terms(
        impl):
    """The port's smoke train step against the reference's under plain
    ``jax.jit`` (its XLA attention).  The reference saves ``attn_out``
    across its recompute (``models/transformer.py:148-151``), so its
    recompute forms the scores again but not P V: each layer's attention
    counts 7 products of 2 B H S S D flops (QK^T and P V forward, QK^T
    again, four in the backward).

      * ``xla``: the port's plain attention saves nothing across the
        recompute, which forms P V again too: one product a layer more;
      * ``pallas``: the flash kernels' plain halves, counted by their work
        formulas.  The port's unit keeps the flash forward's o and lse
        (``transformer.SAVED``), so a layer counts one forward, the dq and
        the dk/dv kernels' work: a recompute that ran the forward again
        would count L x the forward's work more."""
    ref = ref_get_bundle("qwen3-4b", smoke=True)
    rp = ref.init_params(jax.random.PRNGKey(0))
    tok = np.random.default_rng(0).integers(0, 256, (2, 17)).astype(np.int32)
    b = {"tokens": tok[:, :-1], "labels": tok[:, 1:]}
    want = _module_cost(ref_make_train_step(ref.forward, RefTrainHyper()),
                        rp, ref_adamw_init(rp), b, np.float32(1.0)).flops
    bundle = get_bundle("qwen3-4b", smoke=True)
    bundle = dataclasses.replace(bundle, cfg=dataclasses.replace(
        bundle.cfg, attn_impl=impl))
    params = from_jax_params(jax.tree.map(np.asarray, rp))
    got = count(make_train_step(bundle.forward, TrainHyper()), params,
                adamw_init(params),
                {k: torch.from_numpy(v).long() for k, v in b.items()})
    cfg = bundle.cfg
    B, S = tok.shape[0], tok.shape[1] - 1
    L, H, Kv, D = cfg.n_layers, cfg.n_heads, cfg.n_kv_heads, cfg.dh
    prod = 2 * B * H * S * S * D
    if impl == "xla":
        assert got.flops - want == L * prod
        assert got.kernels == {}
        return
    kw = dict(itemsize=4, causal=True, window=None, dtype="float32")
    fwd = kernel_work.flash_fwd(B, H, Kv, S, S, D, **kw).flops
    dq = kernel_work.flash_bwd_dq(B, H, Kv, S, S, D, **kw).flops
    dkv = kernel_work.flash_bwd_dkv(B, H, Kv, S, S, D, **kw).flops
    assert got.flops - want == L * (fwd + dq + dkv - 7 * prod)
    assert {k: v["calls"] for k, v in got.kernels.items()} == {
        "flash_fwd": L, "flash_bwd_dq": L, "flash_bwd_dkv": L}


# ---------------------------------------------------------------------------
# each kernel's work formula against the dense computation
# ---------------------------------------------------------------------------

def _flop_counter(fn, *args):
    from torch.utils.flop_counter import FlopCounterMode
    with FlopCounterMode(display=False) as fc:
        fn(*args)
    return fc.get_total_flops()


def test_kernel_formulas_equal_the_dense_products():
    """Where a kernel and the dense computation do the same products (no
    mask: non-causal flash, matmul, conv2d, correlation's D^2 products of
    C channels) ``FlopCounterMode`` counts what the formula says."""
    B, H, Hkv, S, Sk, D = 2, 4, 2, 48, 40, 16
    q, k, v = (torch.randn(B, h, n, D) for h, n in ((H, S), (Hkv, Sk),
                                                    (Hkv, Sk)))

    def dense_fwd(q, k, v):
        kk, vv = (x.repeat_interleave(H // Hkv, 1) for x in (k, v))
        p = torch.softmax(q @ kk.transpose(-1, -2), -1)
        return p @ vv

    def dense_bwd(q, k, v, do):
        kk, vv = (x.repeat_interleave(H // Hkv, 1) for x in (k, v))
        p = torch.softmax(q @ kk.transpose(-1, -2), -1)       # 2D a pair
        dp = do @ vv.transpose(-1, -2)                        # 2D
        ds = p * (dp - (dp * p).sum(-1, keepdim=True))
        return ds @ kk, p.transpose(-1, -2) @ do, \
            ds.transpose(-1, -2) @ q                          # 2D each

    fwd = kernel_work.flash_fwd_of(q, k, causal=False, window=None)
    dq, dkv = kernel_work.flash_bwd_of(q, k, causal=False, window=None)
    assert fwd.flops == _flop_counter(dense_fwd, q, k, v)
    assert dq.flops + dkv.flops == \
        _flop_counter(dense_bwd, q, k, v, torch.randn_like(q)) + \
        2 * 2 * B * H * S * Sk * D       # both kernels form S and dP again
    a, b = torch.randn(96, 80), torch.randn(80, 48)
    assert kernel_work.matmul(96, 48, 80, itemsize=4).flops == \
        _flop_counter(torch.matmul, a, b)
    x, w = torch.randn(1, 3, 20, 24), torch.randn(16, 3, 3, 5)
    y = torch.nn.functional.conv2d(x, w, stride=2, dilation=2)
    assert kernel_work.conv2d(1, 20, 24, 3, 3, 5, 16, y.shape[2], y.shape[3],
                              itemsize=4).flops == \
        _flop_counter(lambda a, b: torch.nn.functional.conv2d(
            a, b, stride=2, dilation=2), x, w)
    # the band: causal pairs against brute force, at offsets
    for Sq, Sk_, causal, window, shift in ((64, 64, True, None, 0),
                                           (64, 80, True, 24, 16),
                                           (32, 96, True, 40, -8),
                                           (48, 48, False, None, 5)):
        qp = np.arange(Sq)[:, None] + shift
        kp = np.arange(Sk_)[None, :]
        m = np.ones((Sq, Sk_), bool)
        if causal:
            m &= kp <= qp
        if window:
            m &= qp - kp < window
        assert kernel_work.attended_pairs(Sq, Sk_, causal, window,
                                          shift) == int(m.sum())


def test_kernel_entries_report_their_work_and_hide_their_ops():
    """Each ``ops`` wrapper reports its kernel's work on the CPU (its plain
    version's aten ops count nothing), the same on meta tensors."""
    g = torch.Generator().manual_seed(0)
    a, b = torch.randn(64, 96, generator=g), torch.randn(96, 32, generator=g)
    for args in ((a, b), (a.to("meta"), b.to("meta"))):
        c = count(ops.matmul, *args)
        assert (c.flops, c.bytes) == (2 * 64 * 32 * 96,
                                      4 * (64 * 96 + 96 * 32 + 64 * 32))
        assert c.kernels == {"matmul": {"calls": 1, "flops": c.flops,
                                        "bytes": c.bytes}}
    x, w = torch.randn(1, 12, 12, 8), torch.randn(3, 3, 8, 16)
    want = kernel_work.conv2d(1, 12, 12, 8, 3, 3, 16, 10, 10, itemsize=4)
    for args in ((x, w), (x.to("meta"), w.to("meta"))):
        c = count(ops.conv2d, *args)
        assert (c.flops, c.bytes) == (want.flops, want.bytes)
    i1, i2 = torch.randn(8, 10, 16), torch.randn(8, 10, 16)
    want = kernel_work.correlation(8, 10, 16, 2, itemsize=4)
    for args in ((i1, i2), (i1.to("meta"), i2.to("meta"))):
        c = count(functools.partial(ops.correlation, radius=2), *args)
        assert (c.flops, c.bytes) == (want.flops, want.bytes)
    q = torch.randn(2, 4, 64)
    kc, vc = torch.randn(2, 2, 96, 64), torch.randn(2, 2, 96, 64)
    lens = torch.tensor([50, 96], dtype=torch.int32)
    c = count(ops.flash_decode, q, kc, vc, lens)
    assert c.flops == 4 * 4 * 64 * 146
    c_meta = count(ops.flash_decode, *(t.to("meta") for t in (q, kc, vc)),
                   lens.to("meta"))
    assert c_meta.flops == 4 * 4 * 64 * 2 * 96      # no lengths: the view


def test_meta_routes_give_the_kernels_outputs_and_refuse_what_the_card_does():
    """On meta tensors every wrapper returns its kernel's outputs' shapes
    and dtypes, launches nothing, and refuses what the launcher refuses."""
    from repro_torch.kernels import attention as katt
    ops.reset_launches()
    m = "meta"
    bf = torch.bfloat16
    q = torch.empty(2, 8, 256, 128, dtype=bf, device=m)
    k = torch.empty(2, 2, 256, 128, dtype=bf, device=m)
    o = ops.flash_attention(q, k, k, trainable=False)
    assert o.shape == q.shape and o.dtype == bf and o.is_meta
    o, lse = katt.flash_attention_fwd_cuda(q, k, k)
    assert lse.shape == (16, 256) and lse.dtype == torch.float32
    assert ops.matmul(torch.empty(64, 32, dtype=bf, device=m),
                      torch.empty(32, 48, dtype=bf, device=m)).shape == \
        (64, 48)
    y = ops.conv2d(torch.empty(1, 9, 9, 8, dtype=bf, device=m),
                   torch.empty(3, 3, 8, 16, dtype=bf, device=m))
    assert y.shape == (1, 7, 7, 16) and y.dtype == bf
    assert ops.correlation(torch.empty(8, 8, 16, dtype=bf, device=m),
                           torch.empty(8, 8, 16, dtype=bf, device=m),
                           radius=3).shape == (8, 8, 7, 7)
    pages = torch.empty(9, 16, 2, 128, dtype=bf, device=m)
    out = ops.paged_flash_decode(
        torch.empty(2, 8, 128, dtype=bf, device=m), pages, pages,
        torch.empty(2, 4, dtype=torch.int32, device=m),
        torch.empty(2, dtype=torch.int32, device=m))
    assert out.shape == (2, 8, 128)
    assert all(n == 0 for n in ops.LAUNCHES.values())
    # what the card refuses, meta refuses
    with pytest.raises(ValueError, match="head_dim"):
        ops.flash_attention(q[..., :16], k[..., :16], k[..., :16],
                            trainable=False)
    with pytest.raises(ValueError, match="blocks"):
        ops.flash_attention(q, k, k, block_q=32, trainable=False)
    with pytest.raises(TypeError):
        ops.paged_flash_decode(
            torch.empty(2, 8, 128, dtype=bf, device=m), pages, pages,
            torch.empty(2, 4, dtype=torch.int64, device=m),
            torch.empty(2, dtype=torch.int32, device=m))
    with pytest.raises(ValueError, match="device"):
        katt.flash_attention_fwd_cuda(q, torch.empty(k.shape, dtype=bf), k)


@pytest.mark.parametrize("case", ["auto", "flash", "ring"])
def test_a_smoke_step_counts_the_same_on_the_cpu_and_on_meta(case,
                                                             monkeypatch):
    """A train step counts the same flops, bytes and collectives on CPU
    tensors as on meta tensors of the same shapes: the plain attention
    (``auto`` at S 16), the flash kernels (head_dim 64, forced: their plain
    versions on the CPU, their meta routes on meta) and the ring of the
    flash kernels on a (1, 4) mesh of local rings (S 2,560)."""
    bundle = get_bundle("qwen3-4b", smoke=True)
    cfg, S, B, mesh = bundle.cfg, 16, 2, None
    if case != "auto":
        cfg = dataclasses.replace(cfg, head_dim=64, d_model=128, n_heads=4,
                                  n_kv_heads=2, attn_impl="pallas")
        S = 64
    if case == "ring":
        monkeypatch.setenv("REPRO_FLASH_ATTN", "pallas")
        cfg = dataclasses.replace(cfg, n_layers=1, ring_attn="ring")
        S, B, mesh = 2560, 1, make_mesh((1, 4), ("data", "model"))
    bundle = dataclasses.replace(bundle, cfg=cfg)
    tok = torch.from_numpy(np.random.default_rng(0).integers(
        0, 256, (B, S + 1)))
    counts = []
    for params in (bundle.init_params(0, device="cpu"),
                   bundle.abstract_params()):
        dev = next(iter(params["layers"].values())).device
        batch = {"tokens": tok[:, :-1].to(dev), "labels": tok[:, 1:].to(dev)}
        step = make_train_step(bundle.forward, TrainHyper())
        with set_mesh(mesh), CostMode() as m:
            step(params, adamw_init(params), batch)
        counts.append(m.cost)
    assert counts[0].totals() == counts[1].totals()
    assert counts[0].kernels == counts[1].kernels
    if case != "auto":
        # once a layer (the recompute keeps attn_out); the ring m x m hops
        assert counts[0].kernels["flash_fwd"]["calls"] == \
            (16 if case == "ring" else 1) * cfg.n_layers
    if case == "ring":
        assert counts[0].collectives["collective-permute"] > 0


def test_the_meta_memo_changes_no_count():
    """The counter runs each functional op's meta kernel once per
    signature; without that shortcut the count is the same."""
    bundle = get_bundle("qwen3-4b", smoke=True)
    tok = torch.empty((2, 64), dtype=torch.long, device="meta")
    got = []
    for memo in (True, False):
        params = bundle.abstract_params()
        with CostMode(memo=memo) as m:
            make_train_step(bundle.forward, TrainHyper())(
                params, adamw_init(params), {"tokens": tok, "labels": tok})
        got.append(m.cost)
    assert got[0] == got[1]


def test_collectives_count_torch_distributed_and_local_rings():
    """A LocalRing hop counts as the collective-permute it would be (every
    entry's bytes), a LocalRing sum as an all-reduce; a torch.distributed
    all_reduce by its tensors' bytes."""
    import torch.distributed as dist
    from repro_torch.parallel.mesh import LocalRing
    ring = LocalRing(4)
    xs = [torch.zeros(8, 16) for _ in range(4)]
    with CostMode() as m:
        ring.shift(xs, xs)
        ring.all_sum(xs)
    assert m.cost.collectives == {"collective-permute": 2 * 4 * 8 * 16 * 4,
                                  "all-reduce": 4 * 8 * 16 * 4}
    with CostMode() as m:
        LocalRing(1).shift(xs[:1])
    assert m.cost.collectives == {}
    if not dist.is_available():
        return
    import socket
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}",
                            world_size=1, rank=0)
    try:
        t = torch.ones(1000)
        with CostMode() as m:
            dist.all_reduce(t)
        assert m.cost.collectives == {"all-reduce": 4000}
    finally:
        dist.destroy_process_group()


# ---------------------------------------------------------------------------
# the card's bounds, one definition (chip_smoke.py prints them)
# ---------------------------------------------------------------------------

def _chip_smoke():
    spec = importlib.util.spec_from_file_location("chip_smoke",
                                                  ROOT / "chip_smoke.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def test_bounds_at_the_kernels_line_shapes_are_the_recorded_ones():
    """The bound of every row of the kernels line, from the package's one
    definition of each kernel's work and of the card's peaks, at the
    shapes ``chip_smoke.py`` runs: the bounds PERF.md records, to 4
    significant digits."""
    cs = _chip_smoke()

    def flash(fn, sh):
        return fn(sh["B"], sh["H"], sh["Hkv"], sh["S"], sh.get("Sk", sh["S"]),
                  sh["D"], itemsize=2, causal=sh.get("causal", True),
                  window=sh.get("window")).bound()[0]
    sh = cs.PAGED_SHAPE
    lens = np.random.default_rng(cs.SEED + 1).integers(
        1, sh["max_pages"] * sh["page"] + 1, sh["B"])
    paged = [kernel_work.paged_decode(
        sh["B"], sh["H"], sh["Hkv"], sh["D"], live_tokens=int(lens.sum()),
        max_pages=sh["max_pages"], kv_itemsize=1 if quant else 2,
        q_itemsize=2, quant=quant).bound()[0] for quant in (False, True)]
    by = {c["name"]: c for c in cs.catalog_cases()}
    got = [flash(kernel_work.flash_fwd, cs.FLASH_SHAPE),
           flash(kernel_work.flash_fwd, cs.FLASH_D256_SHAPE),
           flash(kernel_work.flash_bwd_dq, cs.FLASH_BWD_SHAPE),
           flash(kernel_work.flash_bwd_dq, cs.FLASH_D256_SHAPE),
           flash(kernel_work.flash_bwd_dkv, cs.FLASH_BWD_SHAPE),
           flash(kernel_work.flash_bwd_dkv, cs.FLASH_D256_SHAPE), *paged,
           *(cs.case_work(c).bound()[0] for c in (
               cs.decode_case(), by["GEMM_1K"], by["GEMM_FC"],
               by["DL_ATROUS4"], by["FLOWNET_CORR"]))]
    recorded = [0.06952, 0.10424, 0.10428, 0.15636, 0.13904, 0.20849,
                0.006761, 0.003496, 0.007501, 0.002171, 0.02254, 0.005039,
                0.001748]
    assert [float(f"{x:.4g}") for x in got] == \
        [float(f"{x:.4g}") for x in recorded]


# ---------------------------------------------------------------------------
# the live roofline
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("lens,max_new,page,chunk,matched", [
    ([11, 11, 11], 5, 8, 8, None), ([16], 5, 8, 8, [8]),
    ([300, 1000, 257], 32, 16, 256, [0, 128, 16]), ([1], 1, 16, 4, None)])
def test_paged_decode_prediction_equals_the_reference(lens, max_new, page,
                                                      chunk, matched):
    kw = dict(page_size=page, page_bytes=page * 4096, prefill_chunk=chunk,
              matched=matched)
    assert live.predict_paged_decode_traffic(lens, max_new, **kw) == \
        ref_live.predict_paged_decode_traffic(lens, max_new, **kw)


@pytest.fixture(scope="module")
def weights():
    p = ref_get_bundle("qwen3-4b", smoke=True).init_params(
        jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, p)


@pytest.mark.parametrize("kv_mode", ["paged", "paged_int8"])
def test_engine_traffic_equals_the_reference_engine(weights, kv_mode):
    """The port's engine and the reference's, on the same weights and
    prompts (a shared prefix, the prefix cache on), observe the same KV
    traffic, byte for byte; the prediction with each request's prefix hit
    as ``matched`` gives ratio 1 at the gb level, and the dram level is
    within its tolerance."""
    rng = np.random.default_rng(3)
    common = rng.integers(0, 256, 16)
    prompts = [np.concatenate([common, rng.integers(0, 256, int(n))])
               .astype(np.int32) for n in (5, 9, 3, 12)]
    kw = dict(slots=2, max_len=64, max_new=6, page_size=8, prefill_chunk=8,
              kv_mode=kv_mode, prefix_cache=True, prefill_token_budget=16)

    def serve(build, **extra):
        engine, _ = build("qwen3-4b", **kw, **extra)
        for p in prompts:
            engine.submit(p)
        engine.run()
        return engine
    ref = serve(ref_serve.build_engine)
    got = serve(pt_serve.build_engine, params=from_jax_params(weights),
                device="cpu")
    assert got.telemetry()["traffic"] == ref.telemetry()["traffic"]
    matched = [got._requests[r].matched_tokens for r in range(len(prompts))]
    assert any(matched)
    predicted = live.predict_paged_decode_traffic(
        [len(p) for p in prompts], 6, page_size=8,
        page_bytes=got.kv.cfg.page_bytes, prefill_chunk=8, matched=matched)
    rows = live.paged_decode_rows(got.traffic_stats(), predicted)
    assert all(r.within for r in rows)
    assert all(r.ratio == 1.0 for r in rows if r.level == "gb")


def test_conv2d_rows_predict_as_the_reference_and_observe_the_kernel():
    """The predicted side of ``conv2d_rows`` equals the reference's; the
    observed side is the counter's count of ``ops.conv2d`` (the kernel's
    own work), on the CPU its plain version."""
    args = (1, 16, 16, 8, 16, 3, 3)
    want = ref_live.conv2d_rows(*args)
    got = live.conv2d_rows(*args, device="cpu")
    assert [(r.workload, r.level, r.predicted, r.unit) for r in got] == \
        [(r.workload, r.level, r.predicted, r.unit) for r in want]
    by = {r.level: r for r in got}
    assert by["gb"].observed == {r.level: r for r in want}["gb"].observed
    assert by["hlo_flops"].ratio == 1.0 and by["hlo_bytes"].ratio == 1.0
    assert all(r.within for r in got)
    # a strided, dilated conv (the catalog's DL_ATROUS4 is dilation 4)
    rows = live.conv2d_rows(1, 21, 21, 8, 8, 3, 3, stride=2, dilation=4,
                            device="cpu")
    assert all(r.within for r in rows)
    assert rows[0].predicted == 2 * 7 * 7 * 8 * 8 * 9


def test_report_mirrors_gauges_and_the_tolerances_are_the_reference():
    from repro_torch.obs import MetricsRegistry
    m = MetricsRegistry()
    out = live.report([live.TrafficRow("w", "gb", 100.0, 100.0)],
                      registry=m)
    assert out[0]["within"] is True and out[0]["ratio"] == 1.0
    g = m.snapshot()["gauges"]
    assert g["traffic_observed{level=gb,unit=bytes,workload=w}"] == 100.0
    assert live.TOLERANCES == ref_live.TOLERANCES


def test_observe_counts_a_call_and_its_peak():
    x = torch.randn(256, 256)
    obs = live.observe(lambda a: (a @ a).sum(), x)
    assert obs["flops"] == 2 * 256 ** 3
    # the argument, the product, the 0-d sum
    assert obs["peak_bytes"] >= 2 * 4 * 256 * 256
    assert math.isfinite(obs["bytes"])


def test_op_cost_reports_through_the_mode_object():
    """A kernel entry inside another reports nothing, and nothing is
    reported without an active counter."""
    w = kernel_work.matmul(8, 8, 8, itemsize=4)
    with op_cost.kernel(w):
        pass
    with CostMode() as m:
        with op_cost.kernel(w):
            with op_cost.kernel(w):
                torch.ones(3) + 1
    assert m.cost.kernels["matmul"]["calls"] == 1
    assert (m.cost.flops, m.cost.bytes) == (w.flops, w.bytes)
