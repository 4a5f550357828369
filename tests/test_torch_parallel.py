"""The context-parallel slice of the port (``repro_torch.parallel``, the
ring policy, ``layers._attention_ring``, the launcher's mesh) against the
reference on the CPU.

The reference's mesh paths need a mesh of virtual devices, fixed before
jax starts: one subprocess (``XLA_FLAGS=--xla_force_host_platform_
device_count=8``, as ``tests/test_distributed.py`` runs them) computes all
of them on numpy inputs it draws from a seed and writes inputs and outputs
to an npz that a module fixture reads: the reference's einsum-fold
``ring_attention`` (its custom VJP) and dense ``_grouped_scores_full`` on
the cases of ``test_ring_vjp_grads_match_dense`` and
``test_ring_fused_pallas_hop_matches_einsum`` over a (2, 4) mesh, its
``_attention_ring`` in both modes, ``ring_matmul`` / ``allgather_matmul``,
``pipeline_forward`` and ``ef_compressed_psum``.  The port runs each on a
local ring (every rank in this process) and, in one spawn of 4 gloo
processes, on a process ring.

Tolerances: the reference tests' own (ring attention outputs 3e-4, grads
5e-4; matmul and pipeline 1e-4; the compressed psum's error bound and
1e-5 / 1e-6 on its residual); a process rank's results equal the local
ring's within 1e-6 (f32: the same arithmetic, the all-reduce may sum in
another order); the qwen3-4b smoke train step through the ring within
1e-5 relative of the reference's unsharded ``make_train_step`` (params
atol 1e-5), as ``tests/test_torch_train.py``."""
import dataclasses
import os
import subprocess
import sys
import threading
import weakref
from datetime import timedelta
from pathlib import Path

import numpy as np
import pytest

torch = pytest.importorskip("torch")

from torch.utils._python_dispatch import TorchDispatchMode  # noqa: E402
from torch.utils._pytree import tree_leaves  # noqa: E402

from repro_torch.configs import base as cbase  # noqa: E402
from repro_torch.models import layers as pt_layers  # noqa: E402
from repro_torch.optim.compression import (ef_compressed_psum,  # noqa: E402
                                           init_error_feedback)
from repro_torch.parallel import (allgather_matmul, make_mesh,  # noqa: E402
                                  pipeline_forward, ring_attention,
                                  ring_attention_local, ring_matmul,
                                  ring_matmul_ref, set_mesh)
from repro_torch.parallel.ring_attention import \
    record_ring_passes  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]

# (B, S, H, Hkv, Dh, causal, window): test_ring_vjp_grads_match_dense's
# four cases, then test_ring_fused_pallas_hop_matches_einsum's three
VJP_CASES = [
    (4, 32, 8, 2, 16, True, None),    # GQA (G=4), causal
    (4, 32, 8, 8, 16, True, 8),       # MHA, sliding window
    (2, 64, 4, 2, 8, True, 12),       # GQA + window
    (2, 64, 4, 4, 8, False, None),    # non-causal, unmasked
]
FUSED_CASES = [
    (2, 64, 4, 4, 16, True, None),    # MHA causal
    (2, 64, 8, 2, 16, True, 24),      # GQA + sliding window
    (2, 64, 4, 2, 8, False, None),    # non-causal GQA
]
CASES = VJP_CASES + FUSED_CASES
O_TOL, G_TOL = 3e-4, 5e-4

REF_CODE = r"""
import sys
import jax, jax.numpy as jnp, numpy as np
from jax.sharding import PartitionSpec as P
from repro.runtime import compat
from repro.parallel.ring_attention import ring_attention
from repro.parallel.ring_matmul import ring_matmul, ring_matmul_ref, allgather_matmul
from repro.parallel.pipeline import pipeline_forward
from repro.optim.compression import ef_compressed_psum, init_error_feedback
from repro.models.layers import _attention_ring, _grouped_scores_full

CASES = %(cases)r
rng = np.random.default_rng(0)
out = {}
def nrm(*shape, scale=1.0):
    return (rng.normal(size=shape) * scale).astype(np.float32)

mesh = compat.make_mesh((2, 4), ("data", "model"))
for i, (B, S, H, Hkv, Dh, causal, window) in enumerate(CASES):
    q, k, v = nrm(B, S, H, Dh), nrm(B, S, Hkv, Dh), nrm(B, S, Hkv, Dh)
    out.update({f"a{i}_q": q, f"a{i}_k": k, f"a{i}_v": v})
    def loss(q, k, v):
        return (ring_attention(q, k, v, causal=causal, window=window, fused=False) ** 2).sum()
    def loss_ref(q, k, v):
        return (_grouped_scores_full(q, k, v, causal=causal, window=window) ** 2).sum()
    with compat.set_mesh(mesh):
        o = jax.jit(lambda q, k, v: ring_attention(q, k, v, causal=causal, window=window, fused=False))(q, k, v)
        g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
    out[f"a{i}_o"] = np.asarray(o)
    out[f"a{i}_dense"] = np.asarray(_grouped_scores_full(q, k, v, causal=causal, window=window))
    for nm, a in zip("qkv", g):
        out[f"a{i}_d{nm}"] = np.asarray(a)
    for nm, a in zip("qkv", jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)):
        out[f"a{i}_dense_d{nm}"] = np.asarray(a)

# test_ring_attention_matches_reference: both modes of _attention_ring
B, S, H, Dh = 4, 32, 8, 16
q, k, v = nrm(B, S, H, Dh), nrm(B, S, 2, Dh), nrm(B, S, 2, Dh)
out.update(lr_q=q, lr_k=k, lr_v=v)
out["lr_full"] = np.asarray(_grouped_scores_full(q, k, v, causal=True, window=None))
for mode in ("replicated", "ring"):
    with compat.set_mesh(mesh):
        o = jax.jit(lambda q, k, v: _attention_ring(q, k, v, causal=True, window=None, ring=mode))(q, k, v)
    out[f"lr_{mode}"] = np.asarray(o)
def loss(q, k, v):
    return (_attention_ring(q, k, v, causal=True, window=None, ring="replicated") ** 2).sum()
def loss_ref(q, k, v):
    return (_grouped_scores_full(q, k, v, causal=True, window=None) ** 2).sum()
with compat.set_mesh(mesh):
    g = jax.jit(jax.grad(loss, argnums=(0, 1, 2)))(q, k, v)
for nm, a, r in zip("qkv", g, jax.grad(loss_ref, argnums=(0, 1, 2))(q, k, v)):
    out[f"lr_replicated_d{nm}"] = np.asarray(a)
    out[f"lr_full_d{nm}"] = np.asarray(r)

# test_ring_matmul_and_baseline
a, b = nrm(16, 32), nrm(32, 24)
out.update(mm_a=a, mm_b=b)
with compat.set_mesh(mesh):
    out["mm_ring"] = np.asarray(ring_matmul(a, b, mesh, axis="model"))
    out["mm_ag"] = np.asarray(allgather_matmul(a, b, mesh, axis="model"))
    da, db = jax.jit(jax.grad(lambda a, b: (ring_matmul(a, b, mesh, axis="model") ** 2).sum(), argnums=(0, 1)))(a, b)
out["mm_ref"] = np.asarray(ring_matmul_ref(a, b))
out["mm_da"], out["mm_db"] = np.asarray(da), np.asarray(db)
ra, rb = jax.grad(lambda a, b: (ring_matmul_ref(a, b) ** 2).sum(), argnums=(0, 1))(a, b)
out["mm_ref_da"], out["mm_ref_db"] = np.asarray(ra), np.asarray(rb)

# test_pipeline_parallel_forward
mesh3 = compat.make_mesh((2, 2, 2), ("pod", "data", "model"))
w, xm = nrm(2, 8, 8, scale=0.5), nrm(4, 3, 8)
out.update(pp_w=w, pp_x=xm)
with compat.set_mesh(mesh3):
    out["pp_out"] = np.asarray(jax.jit(lambda p, x: pipeline_forward(
        lambda p, x: jnp.tanh(x @ p["w"]), p, x, mesh3))({"w": w}, xm))

# test_compressed_gradient_psum
gw = nrm(8, 8)
out["ef_g"] = gw
fn = compat.shard_map(lambda g, e: ef_compressed_psum(g, e, "pod"), mesh=mesh3,
                      in_specs=(P(), P()), out_specs=(P(), P()))
with compat.set_mesh(mesh3):
    rg, re = jax.jit(fn)({"w": gw}, init_error_feedback({"w": gw}))
out["ef_reduced"], out["ef_err"] = np.asarray(rg["w"]), np.asarray(re["w"])
np.savez(sys.argv[1], **out)
"""


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    path = tmp_path_factory.mktemp("parallel_ref") / "ref.npz"
    env = dict(os.environ, PYTHONPATH=str(ROOT / "src"), JAX_PLATFORMS="cpu",
               XLA_FLAGS="--xla_force_host_platform_device_count=8")
    p = subprocess.run([sys.executable, "-c", REF_CODE % {"cases": CASES},
                        str(path)], capture_output=True, text=True,
                       timeout=600, env=env)
    assert p.returncode == 0, p.stdout + "\n" + p.stderr
    with np.load(path) as z:
        return {k: z[k] for k in z.files}


def T(a, grad=False):
    return torch.from_numpy(np.array(a)).requires_grad_(grad)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().numpy(), want, rtol=tol,
                               atol=tol)


def _case_inputs(ref, i):
    return [T(ref[f"a{i}_{n}"], True) for n in "qkv"]


def _local_ring_attention(q, k, v, case, **kw):
    """The port's local ring on a (2, 4) mesh: output and grads of
    sum(o ** 2)."""
    _, _, _, _, _, causal, window = case
    o = ring_attention(q, k, v, causal=causal, window=window,
                       mesh=make_mesh((2, 4), ("data", "model")), **kw)
    return o, torch.autograd.grad((o ** 2).sum(), (q, k, v))


# ---------------------------------------------------------------------------
# ring attention on a local ring
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("engine", ["einsum", "fused", "naive"])
@pytest.mark.parametrize("i", range(len(CASES)),
                         ids=[f"B{c[0]}S{c[1]}H{c[2]}kv{c[3]}D{c[4]}"
                              f"{'c' if c[5] else 'nc'}w{c[6]}"
                              for c in CASES])
def test_ring_attention_matches_reference(ref, i, engine):
    """The port's einsum fold, fused fold (the flash kernels' plain
    versions each hop, at the shard's offsets) and naive impl against the
    reference's einsum ring and its dense attention."""
    kw = dict(fused=engine == "fused",
              impl="naive" if engine == "naive" else "vjp")
    o, grads = _local_ring_attention(*_case_inputs(ref, i), CASES[i], **kw)
    _close(o, ref[f"a{i}_o"], O_TOL)
    _close(o, ref[f"a{i}_dense"], O_TOL)
    for nm, g in zip("qkv", grads):
        _close(g, ref[f"a{i}_d{nm}"], G_TOL)
        _close(g, ref[f"a{i}_dense_d{nm}"], G_TOL)


def test_fused_blocks_follow_the_reference_rule():
    """Snapped to divisors of the shard; the einsum fold below 8."""
    from repro_torch.core.cuda_bridge import attention_block_shapes
    from repro_torch.parallel.ring_attention import _fused_blocks
    assert attention_block_shapes(4096, 4096, 128) == (128, 128)
    assert attention_block_shapes(2048, 2048, 256) == (128, 64)
    assert attention_block_shapes(16, 16, 16) == (16, 16)
    assert _fused_blocks(1024, 128) == (128, 128)
    assert _fused_blocks(16, 8) == (16, 16)
    assert _fused_blocks(24, 16) == (8, 8)
    assert _fused_blocks(12, 16) is None
    assert _fused_blocks(4, 16) is None


def test_ring_vjp_saves_no_score_tiles():
    """The autograd Function saves (q, k, v, o, lse) and no (S_l x S_l)
    tile; the naive fold keeps one per hop (the detector's control)."""
    B, S, H, Hkv, Dh, m = 4, 64, 4, 2, 8, 4
    S_l = S // m
    g = torch.Generator().manual_seed(0)
    q = torch.randn(B, S, H, Dh, generator=g, requires_grad=True)
    k, v = (torch.randn(B, S, Hkv, Dh, generator=g, requires_grad=True)
            for _ in range(2))
    saved = {}
    for impl in ("naive", "vjp"):
        shapes = []

        def pack(t):
            shapes.append(tuple(t.shape))
            return t

        with torch.autograd.graph.saved_tensors_hooks(pack, lambda t: t):
            o = ring_attention(q, k, v, causal=True, impl=impl,
                               mesh=make_mesh((2, m), ("data", "model")))
        saved[impl] = shapes
        torch.autograd.grad((o ** 2).sum(), (q, k, v))
    tiles = {impl: [s for s in shapes if s[-2:] == (S_l, S_l)]
             for impl, shapes in saved.items()}
    assert len(tiles["naive"]) >= m, saved["naive"]
    assert not tiles["vjp"], saved["vjp"]
    assert sorted(saved["vjp"]) == sorted([(B, S, H, Dh), (B, S, Hkv, Dh),
                                           (B, S, Hkv, Dh), (B, S, H, Dh),
                                           (B, H, S)])


# ---------------------------------------------------------------------------
# _attention_ring, the policy and the routing of attention()
# ---------------------------------------------------------------------------

def test_attention_ring_modes_match_reference(ref):
    """Both modes against the reference's (2, 4)-mesh outputs and its
    unsharded ``_grouped_scores_full``; the replicated mode's grads too."""
    q, k, v = (T(ref[f"lr_{n}"], True) for n in "qkv")
    with set_mesh(make_mesh((2, 4), ("data", "model"))):
        for mode in ("replicated", "ring"):
            o = pt_layers._attention_ring(q, k, v, causal=True, window=None,
                                          ring=mode)
            _close(o, ref[f"lr_{mode}"], O_TOL)
            _close(o, ref["lr_full"], O_TOL)
        o = pt_layers._attention_ring(q, k, v, causal=True, window=None,
                                      ring="replicated")
        grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
    for nm, g in zip("qkv", grads):
        _close(g, ref[f"lr_replicated_d{nm}"], G_TOL)
        _close(g, ref[f"lr_full_d{nm}"], G_TOL)


def test_replicated_mode_on_the_flash_kernels_matches_reference(
        ref, monkeypatch):
    """The replicated mode with ``flash`` (the flash policy picked the
    kernels): the trainable flash Function on each q shard at its global
    offset (its plain halves on the CPU), against the reference's (2, 4)
    mesh outputs and grads and its unsharded attention."""
    offsets = []
    flash = pt_layers._flash_pallas

    def spy(*args, **kw):
        offsets.append(kw["q_offset"])
        return flash(*args, **kw)

    monkeypatch.setattr(pt_layers, "_flash_pallas", spy)
    q, k, v = (T(ref[f"lr_{n}"], True) for n in "qkv")
    with set_mesh(make_mesh((2, 4), ("data", "model"))):
        o = pt_layers._attention_ring(q, k, v, causal=True, window=None,
                                      ring="replicated", flash=True)
        grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
    S_l = q.shape[1] // 4
    assert offsets == [0, S_l, 2 * S_l, 3 * S_l]
    _close(o, ref["lr_replicated"], O_TOL)
    _close(o, ref["lr_full"], O_TOL)
    for nm, g in zip("qkv", grads):
        _close(g, ref[f"lr_replicated_d{nm}"], G_TOL)
        _close(g, ref[f"lr_full_d{nm}"], G_TOL)


@pytest.mark.parametrize("S, route", [(32, "flash"), (48, "replicated"),
                                      (64, "ring")])
def test_flash_gives_way_only_to_the_ring(monkeypatch, S, route):
    """attention() under a (1, 4) mesh with the flash kernels forced (their
    plain halves on the CPU), full_threshold 32 and the ring's threshold
    64: S 32 is one unsharded flash call, S 48 the replicated mode's four
    (a q shard each, at its offset), S 64 the ring's hops and no flash call
    of attention()'s own; each within the ring tolerances of the unsharded
    full-mask attention, grads too.  The CPU twin of the card's
    ``chip_smoke.check_mesh_routes``."""
    monkeypatch.setenv("REPRO_FLASH_ATTN", "pallas")
    monkeypatch.delenv("REPRO_RING_ATTN", raising=False)
    monkeypatch.setenv("REPRO_RING_ATTN_THRESHOLD", "64")
    offsets = []
    flash = pt_layers._flash_pallas

    def spy(*args, **kw):
        offsets.append(kw.get("q_offset", 0))
        return flash(*args, **kw)

    monkeypatch.setattr(pt_layers, "_flash_pallas", spy)
    g = torch.Generator().manual_seed(S)
    q = torch.randn(2, S, 4, 16, generator=g, requires_grad=True)
    k, v = (torch.randn(2, S, 2, 16, generator=g, requires_grad=True)
            for _ in range(2))
    mesh = make_mesh((1, 4), ("data", "model"))
    with set_mesh(mesh):
        o = pt_layers.attention(q, k, v, causal=True, full_threshold=32)
        grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
    want = {"flash": [0], "replicated": [0, S // 4, S // 2, 3 * S // 4],
            "ring": []}[route]
    assert offsets == want
    assert (mesh.transport("model").hops > 0) == (route == "ring")
    o_ref = pt_layers._grouped_scores_full(q, k, v, causal=True,
                                           window=None)
    g_ref = torch.autograd.grad((o_ref ** 2).sum(), (q, k, v))
    _close(o, o_ref.detach().numpy(), O_TOL)
    for got, want_ in zip(grads, g_ref):
        _close(got, want_.numpy(), G_TOL)


def test_auto_policy_thresholds():
    pol = cbase.DEFAULT_RING_POLICY
    assert cbase.decide_ring(pol, seq_len=4096, ring_size=8) == "ring"
    assert cbase.decide_ring(pol, seq_len=32768, ring_size=16) == "ring"
    assert cbase.decide_ring(pol, seq_len=2048, ring_size=8) == "replicated"
    assert cbase.decide_ring(pol, seq_len=65536, ring_size=8) == \
        "replicated"
    for mode in ("ring", "replicated", "off"):
        assert cbase.decide_ring(cbase.RingAttnPolicy(mode=mode), seq_len=1,
                                 ring_size=2) == mode


def test_policy_resolution_order(monkeypatch):
    monkeypatch.delenv("REPRO_RING_ATTN", raising=False)
    assert cbase.ring_attn_policy().mode == "auto"
    monkeypatch.setenv("REPRO_RING_ATTN", "replicated")
    assert cbase.ring_attn_policy().mode == "replicated"
    assert cbase.ring_attn_policy("ring").mode == "ring"
    monkeypatch.setenv("REPRO_RING_ATTN_THRESHOLD", "128")
    monkeypatch.setenv("REPRO_RING_ATTN_MAX_SHARD", "256")
    pol = cbase.ring_attn_policy("auto")
    assert pol.seq_threshold == 128 and pol.max_seq_per_device == 256
    monkeypatch.setenv("REPRO_RING_ATTN", "bogus")
    with pytest.raises(ValueError):
        cbase.ring_attn_policy()


def test_data_axes_spec():
    from repro_torch.parallel.ring_attention import data_axes_spec
    assert data_axes_spec(make_mesh((2, 4), ("data", "model")), 4) == "data"
    assert data_axes_spec(make_mesh((2, 4), ("data", "model")), 3) is None
    assert data_axes_spec(make_mesh((2, 2, 2), ("pod", "data", "model")),
                          4) == ("pod", "data")
    assert data_axes_spec(make_mesh((4,), ("model",)), 4) is None


def test_ring_attention_inapplicable_returns_none():
    q = torch.zeros((1, 8, 2, 4))
    kv = torch.zeros((1, 8, 2, 4))
    assert ring_attention(q, kv, kv) is None                # no mesh
    one = make_mesh((1, 1), ("data", "model"))
    assert ring_attention(q, kv, kv, mesh=one) is None      # 1-wide axis
    four = make_mesh((1, 4), ("data", "model"))
    assert ring_attention(q, kv[:, :4], kv[:, :4], mesh=four) is None
    assert ring_attention(q[:, :6], kv[:, :6], kv[:, :6], mesh=four) is None
    assert ring_attention(q, kv, kv, mesh=four, axis="pod") is None


@pytest.mark.parametrize("flash", ["auto", "pallas"])
def test_ring_is_default_long_seq_path(monkeypatch, flash):
    """attention() under a (2, 4) mesh: ``auto`` at S >= the threshold
    hops the ring, below it the replicated mode does not, a forced
    ``ring`` hops, ``off`` never does; the flash kernel path (forced or
    auto) gives way to them (the hop count in place of the reference's
    "ppermute in the jaxpr")."""
    monkeypatch.setenv("REPRO_FLASH_ATTN", flash)
    monkeypatch.delenv("REPRO_RING_ATTN", raising=False)
    g = torch.Generator().manual_seed(0)
    q = torch.randn(4, 64, 8, 16, generator=g)
    k, v = (torch.randn(4, 64, 2, 16, generator=g) for _ in range(2))
    full = pt_layers._grouped_scores_full(q, k, v, causal=True, window=None)

    def hops(thr, mode=None):
        monkeypatch.setenv("REPRO_RING_ATTN_THRESHOLD", str(thr))
        if mode:
            monkeypatch.setenv("REPRO_RING_ATTN", mode)
        mesh = make_mesh((2, 4), ("data", "model"))
        with set_mesh(mesh):
            o = pt_layers.attention(q, k, v, causal=True, full_threshold=32)
        _close(o, full.numpy(), O_TOL)
        return mesh.transport("model").hops

    assert hops(64) > 0                 # default auto -> ring
    assert hops(128) == 0               # below the threshold -> replicated
    assert hops(128, "ring") > 0        # forced ring beats the threshold
    assert hops(64, "off") == 0


def test_record_ring_passes_reads_the_function_backward():
    """``record_ring_passes`` keeps the forward's global f32 lse (B, H, S)
    and the backward's f32 dq / dk / dv, of which the grads autograd
    returns are the cast, bit for bit (bf16 inputs); outside the block
    nothing is kept."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(2, 32, 4, 16, generator=g).bfloat16().requires_grad_()
    k, v = (torch.randn(2, 32, 2, 16, generator=g).bfloat16()
            .requires_grad_() for _ in range(2))
    mesh = make_mesh((1, 4), ("data", "model"))
    with record_ring_passes() as record:
        o = ring_attention(q, k, v, mesh=mesh, fused=False)
        grads = torch.autograd.grad(o.float().sum(), (q, k, v))
    o = ring_attention(q, k, v, mesh=mesh, fused=False)
    torch.autograd.grad(o.float().sum(), (q, k, v))
    (passes,) = record
    for got, n in zip(grads, ("dq", "dk", "dv")):
        assert passes[n].dtype == torch.float32
        assert torch.equal(got, passes[n].to(got.dtype))
    s = torch.einsum("bqhd,bkhd->bhqk", q.float(),
                     k.float().repeat_interleave(2, dim=2)) / 4.0
    s = s.masked_fill(torch.ones(32, 32, dtype=torch.bool).triu(1),
                      float("-inf"))
    torch.testing.assert_close(passes["lse"], torch.logsumexp(s, -1),
                               rtol=0, atol=1e-5)


def test_remat_recompute_keeps_the_mesh():
    """The per-layer recompute runs under the forward's mesh even when
    autograd runs it on another thread (as the CUDA engine does), where
    no mesh was set: the ring hops in the backward too."""
    g = torch.Generator().manual_seed(1)
    q = torch.randn(1, 64, 4, 8, generator=g, requires_grad=True)
    k, v = (torch.randn(1, 64, 2, 8, generator=g, requires_grad=True)
            for _ in range(2))
    mesh = make_mesh((1, 4), ("data", "model"))

    def layer(q, k, v):
        return pt_layers.attention(q, k, v, causal=True, full_threshold=32,
                                   ring="ring") * 2.0

    with set_mesh(mesh):
        o = pt_layers.remat_call(layer, q, k, v)
    fwd_hops = mesh.transport("model").hops
    err = []

    def backward():
        try:
            (o ** 2).sum().backward()
        except Exception as e:       # surfaced below, on the test thread
            err.append(e)

    t = threading.Thread(target=backward)
    t.start()
    t.join(timeout=60)
    assert not t.is_alive() and not err, err
    # the recompute's forward hops (m - 1) and the backward pass's (m)
    assert mesh.transport("model").hops == fwd_hops + 3 + 4


def test_process_axis_refuses_global_tensors():
    """A model axis of processes takes shards: ``_attention_ring`` raises
    rather than compute unsharded."""
    class FakeProcessRing:
        size = 4
    mesh = make_mesh((1, 4), ("data", "model"))
    mesh.transports["model"] = FakeProcessRing()
    q = torch.zeros((1, 64, 2, 8))
    with set_mesh(mesh), pytest.raises(NotImplementedError,
                                       match="sharding slice"):
        pt_layers._attention_ring(q, q, q, causal=True, window=None)


# ---------------------------------------------------------------------------
# ring matmul, pipeline, compressed psum on a local ring
# ---------------------------------------------------------------------------

def test_ring_matmul_and_baseline(ref):
    mesh = make_mesh((2, 4), ("data", "model"))
    a, b = T(ref["mm_a"], True), T(ref["mm_b"], True)
    out = ring_matmul(a, b, mesh, axis="model")
    _close(out, ref["mm_ring"], 1e-4)
    _close(out, ref["mm_ref"], 1e-4)
    _close(allgather_matmul(a, b, mesh, axis="model"), ref["mm_ag"], 1e-4)
    _close(ring_matmul_ref(a, b), ref["mm_ref"], 1e-4)
    da, db = torch.autograd.grad((out ** 2).sum(), (a, b))
    for got, n in ((da, "da"), (db, "db")):
        _close(got, ref[f"mm_{n}"], 1e-4)
        _close(got, ref[f"mm_ref_{n}"], 1e-4)


class _LiveBytes(TorchDispatchMode):
    """Bytes of the tensors each op allocates that are alive at once, and
    their peak: an output that owns its storage counts until it is freed;
    views and in-place results count nothing new."""

    def __init__(self):
        super().__init__()
        self.live = self.peak = 0

    def _free(self, n: int) -> None:
        self.live -= n

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        out = func(*args, **(kwargs or {}))
        ins = {a.untyped_storage().data_ptr()
               for a in tree_leaves((args, kwargs))
               if isinstance(a, torch.Tensor)}
        for t in tree_leaves(out):
            if isinstance(t, torch.Tensor) and not t._is_view() and \
                    t.untyped_storage().data_ptr() not in ins:
                n = t.untyped_storage().nbytes()
                self.live += n
                self.peak = max(self.peak, self.live)
                weakref.finalize(t, self._free, n)
        return out


def test_ring_matmul_fewer_resident_bytes():
    """The paper's claim: the ring never holds all of B on a rank, the
    all-gather baseline holds it on every rank (the reference test's
    compiled temp sizes, here the bytes alive at the peak)."""
    mesh = make_mesh((1, 8), ("data", "model"))
    a, b = torch.randn(256, 512), torch.randn(512, 1024)
    peaks = {}
    for fn in (ring_matmul, allgather_matmul):
        with torch.no_grad(), _LiveBytes() as mode:
            fn(a, b, mesh, axis="model")
        peaks[fn.__name__] = mode.peak
    out_bytes = 256 * 1024 * 4
    assert peaks["ring_matmul"] < out_bytes + b.nbytes // 8, peaks
    assert peaks["allgather_matmul"] > 8 * b.nbytes, peaks


def test_pipeline_parallel_forward(ref):
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    out = pipeline_forward(lambda p, x: torch.tanh(x @ p["w"]),
                           {"w": T(ref["pp_w"])}, T(ref["pp_x"]), mesh)
    _close(out, ref["pp_out"], 1e-4)
    want = T(ref["pp_x"])
    for s in range(2):
        want = torch.tanh(want @ T(ref["pp_w"])[s])
    _close(out, want.numpy(), 1e-4)


def test_compressed_gradient_psum(ref):
    """The reference test's checks on the port, and its outputs: every
    pod holds the same gradient (the reference's replicated input)."""
    mesh = make_mesh((2, 2, 2), ("pod", "data", "model"))
    g = T(ref["ef_g"])
    stacked = {"w": g.expand(2, *g.shape).clone()}
    rg, re = ef_compressed_psum(stacked, init_error_feedback(stacked), "pod",
                                mesh)
    amax = g.abs().max().item()
    for r in range(2):
        assert (rg["w"][r] - g).abs().max().item() <= amax / 127 + 1e-6
        np.testing.assert_allclose(re["w"][r].numpy(),
                                   (g - rg["w"][r]).numpy(), rtol=1e-5,
                                   atol=1e-6)
        _close(rg["w"][r], ref["ef_reduced"], 1e-6)
        _close(re["w"][r], ref["ef_err"], 1e-6)


# ---------------------------------------------------------------------------
# the process ring: 4 gloo processes against the local ring
# ---------------------------------------------------------------------------

WORLD = 4


def _process_inputs(ref) -> dict:
    """Every case's global inputs: the reference's ring attention and
    matmul inputs, 4 pipeline stages, and a gradient per rank."""
    rng = np.random.default_rng(7)
    x = {k: ref[k] for k in ref if k.endswith(("_q", "_k", "_v"))
         and k.startswith("a")}
    x.update(mm_a=ref["mm_a"], mm_b=ref["mm_b"], pp_x=ref["pp_x"],
             pp_w=(rng.normal(size=(WORLD, 8, 8)) * 0.5).astype(np.float32),
             ef_g=rng.normal(size=(WORLD, 8, 8)).astype(np.float32))
    return x


def _ring_cases(x: dict, ring, mesh, shard) -> dict:
    """Every ring body on ``ring`` (a LocalRing of a (1, 4) mesh on
    global tensors, or this process's ProcessRing on its shards):
    ``shard(t, dim)`` gives the operand the transport takes."""
    res = {}
    for i, (_, _, _, _, _, causal, window) in enumerate(CASES):
        for fused in (False, True):
            q, k, v = (shard(T(x[f"a{i}_{n}"]), 1).requires_grad_(True)
                       for n in "qkv")
            o = ring_attention_local(q, k, v, ring=ring, causal=causal,
                                     window=window, fused=fused)
            grads = torch.autograd.grad((o ** 2).sum(), (q, k, v))
            for n, t in zip(("o", "dq", "dk", "dv"), (o, *grads)):
                res[f"a{i}_{int(fused)}_{n}"] = t.detach()
    a = shard(T(x["mm_a"]), 0).requires_grad_(True)
    b = shard(T(x["mm_b"]), 1).requires_grad_(True)
    out = ring_matmul(a, b, mesh, axis="model")
    da, db = torch.autograd.grad((out ** 2).sum(), (a, b))
    res.update(mm_out=out.detach(), mm_da=da, mm_db=db,
               mm_ag=allgather_matmul(a, b, mesh, axis="model").detach())
    res["pp_out"] = pipeline_forward(
        lambda p, h: torch.tanh(h @ p["w"]), {"w": shard(T(x["pp_w"]), 0)},
        T(x["pp_x"]), mesh, axis="model")
    g = {"w": shard(T(x["ef_g"]), 0)}
    rg, re = ef_compressed_psum(g, init_error_feedback(g), "model", mesh)
    res.update(ef_reduced=rg["w"], ef_err=re["w"])
    return res


def _rank_main(rank: int, init: str, inputs: str, out_dir: str) -> None:
    """One process of the ring: its shards through every case."""
    import torch.distributed as dist

    from repro_torch.parallel import ProcessRing, make_process_mesh
    dist.init_process_group("gloo", init_method=init, rank=rank,
                            world_size=WORLD, timeout=timedelta(seconds=60))
    try:
        mesh = make_process_mesh((1, WORLD), ("data", "model"))
        ring = mesh.transport("model")
        assert isinstance(ring, ProcessRing) and ring.index() == [rank]
        with np.load(inputs) as z:
            x = {k: z[k] for k in z.files}
        res = _ring_cases(x, ring, mesh,
                          lambda t, dim: t.chunk(WORLD, dim)[rank])
        torch.save(res, Path(out_dir) / f"rank{rank}.pt")
    finally:
        dist.destroy_process_group()


def test_process_ring_equals_local_ring(ref, tmp_path):
    """Ring attention (both folds, output and grads), ring matmul (and its
    grads), the all-gather baseline, the pipeline and the compressed psum
    on 4 gloo processes, each rank's results against its part of the
    local ring's within 1e-6."""
    x = _process_inputs(ref)
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
    assert not any(alive), "a ring process hung"
    assert [p.exitcode for p in procs] == [0] * WORLD

    mesh = make_mesh((1, WORLD), ("data", "model"))
    want = _ring_cases(x, mesh.transport("model"), mesh, lambda t, dim: t)
    # where each output's rank part lies: rows of the sequence (attention),
    # rows of C and A, columns of B; the pipeline's output is every rank's;
    # the per-rank gradients stack on dim 0
    dims = {"mm_db": 1, "pp_out": None}
    for r in range(WORLD):
        got = torch.load(tmp_path / f"rank{r}.pt")
        assert got.keys() == want.keys()
        for key, w in want.items():
            d = dims.get(key, 1 if key.startswith("a") else 0)
            part = w if d is None else w.chunk(WORLD, d)[r]
            np.testing.assert_allclose(got[key].numpy(), part.numpy(),
                                       rtol=1e-6, atol=1e-6, err_msg=key)


# ---------------------------------------------------------------------------
# the qwen3-4b smoke train step through the ring
# ---------------------------------------------------------------------------

TRAIN_S = 2560          # above attention()'s full_threshold (2048): S_l 640


def test_train_step_through_the_ring_matches_reference(monkeypatch):
    """One step of the qwen3-4b smoke model (f32) under a (1, 4) local mesh
    with the ring forced (``TransformerConfig.ring_attn``), against the
    reference's ``make_train_step`` with no mesh under plain ``jax.jit``
    (its attention: the blocked XLA path), on converted weights; the ring
    hopped in the forward, the recompute and the backward."""
    import jax

    from repro.configs import get_bundle as ref_get_bundle
    from repro.optim import AdamWConfig as RefAdamWConfig
    from repro.optim import adamw_init as ref_adamw_init
    from repro.training import TrainHyper as RefTrainHyper
    from repro.training import make_train_step as ref_make_train_step
    from repro_torch.configs import get_bundle
    from repro_torch.optim import AdamWConfig, adamw_init
    from repro_torch.optim.adamw import tree_leaves as pt_leaves
    from repro_torch.training import TrainHyper, make_train_step
    from repro_torch.weights import from_jax_params
    monkeypatch.delenv("REPRO_FLASH_ATTN", raising=False)
    opt_cfg = dict(warmup_steps=5, total_steps=10)
    rb = ref_get_bundle("qwen3-4b", smoke=True)
    rp = rb.init_params(jax.random.PRNGKey(0))
    t = np.random.default_rng(3).integers(0, 256, (1, TRAIN_S + 1)) \
        .astype(np.int32)
    batch = {"tokens": t[:, :-1], "labels": t[:, 1:]}
    rp1, ropt, rm = jax.jit(ref_make_train_step(rb.forward, RefTrainHyper(
        optimizer=RefAdamWConfig(**opt_cfg))))(rp, ref_adamw_init(rp),
                                               batch, np.float32(1.0))
    pb = get_bundle("qwen3-4b", smoke=True)
    pb = dataclasses.replace(pb, cfg=dataclasses.replace(pb.cfg,
                                                         ring_attn="ring"))
    pp = from_jax_params(jax.tree.map(np.asarray, rp))
    step = make_train_step(pb.forward, TrainHyper(
        optimizer=AdamWConfig(**opt_cfg)))
    mesh = make_mesh((1, 4), ("data", "model"))
    with set_mesh(mesh):
        pp, popt, pm = step(pp, adamw_init(pp),
                            {k: torch.from_numpy(v).long()
                             for k, v in batch.items()}, 1.0)
    L = pb.cfg.n_layers
    # per layer: forward and recompute 3 hops each, backward 4
    assert mesh.transport("model").hops == L * (3 + 3 + 4)
    for key in ("loss", "ce", "grad_norm", "lr"):
        np.testing.assert_allclose(float(pm[key]), float(rm[key]),
                                   rtol=1e-5, err_msg=key)
    got, want = pt_leaves(pp), jax.tree.leaves(rp1)
    assert len(got) == len(want)
    for g, w in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), atol=1e-5,
                                   rtol=0)


def test_train_run_takes_a_mesh(monkeypatch):
    """``launch.train.run`` trains under a ready mesh (its steps hop the
    ring) and under ``mesh_kind="local"``; the production meshes refuse
    without their process group."""
    from repro_torch.launch import train
    from repro_torch.launch.mesh import make_production_mesh
    monkeypatch.setenv("REPRO_RING_ATTN", "ring")
    mesh = make_mesh((1, 4), ("data", "model"))
    out = train.run("qwen3-4b", steps=1, seq_len=TRAIN_S, global_batch=1,
                    mesh_kind=mesh, device="cpu", log_every=10)
    assert np.isfinite(out["losses"]).all()
    assert mesh.transport("model").hops > 0
    with pytest.raises(RuntimeError, match="process group"):
        make_production_mesh()
    with pytest.raises(ValueError, match="multi-host"):
        train.run("qwen3-4b", steps=1, mesh_kind="single", device="cpu")


def test_worker_mesh_takes_its_ranks_card(monkeypatch):
    """``make_worker_mesh`` makes card ``rank % device_count`` the current
    one when a process group is up, and touches no card without one."""
    import torch.distributed as dist

    from repro_torch.launch.mesh import make_worker_mesh
    picked = []
    monkeypatch.setattr(torch.cuda, "set_device", picked.append)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: True)
    monkeypatch.setattr(torch.cuda, "device_count", lambda: 4)
    monkeypatch.setattr(dist, "is_initialized", lambda: False)
    assert make_worker_mesh().shape == {"data": 1, "model": 1}
    assert picked == []
    monkeypatch.setattr(dist, "is_initialized", lambda: True)
    monkeypatch.setattr(dist, "get_rank", lambda group=None: 5)
    make_worker_mesh()
    assert picked == [1]
