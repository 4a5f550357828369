"""Shared neural layers (plain functions over tensors and param dicts).

Counterpart of ``repro.models.layers`` for the model zoo (the GQA decoder
and its top-k MoE MLP, Mamba-2, RecurrentGemma, Whisper):

  * params are plain dicts of tensors; layer stacks carry a leading layer
    axis.
  * activations default to bf16; params bf16; accumulations f32.
  * attention is grouped (GQA) with causal and sliding-window masks.  The
    plain PyTorch paths mirror the reference's XLA paths; the hand-written
    CUDA kernels (:mod:`repro_torch.kernels`) are the card's path, chosen
    by the flash policy (``configs.base``).
  * under a mesh (``parallel.mesh.set_mesh``) with a ``model`` axis of more
    than one rank, long sequences take the context-parallel paths the ring
    policy picks (``_attention_ring``: the ring of
    ``parallel.ring_attention``, or q shards against replicated k/v, on
    the flash kernels where the flash policy picks them), and the MoE MLP
    takes the reference's expert-parallel, token-split or TP-in-expert
    branch (``moe_layer``).  Only local rings take global tensors there.
  * on a state placed by ``parallel.sharding.shard_tree`` the model axis
    splits heads and features instead (Megatron's tensor parallelism,
    ``parallel.tensor_parallel``): :func:`head_plan` says which heads each
    rank computes, :func:`moe_layer_placed` takes the branch the param
    specs imply, and every family's placed body shares
    :func:`project_placed`, :func:`logits_placed` and the placed caches'
    helpers (:func:`kv_cut`, :func:`kv_values`, :func:`kv_views`) and
    :func:`attn_out_parts`.
  * the placed train bodies carry the reference's Megatron-SP residual
    stream (:func:`shard_seq` / :func:`gather_seq`): where the model axis
    has more than one rank and divides the sequence, the residual between
    blocks is each rank's rows (a list, one entry a held rank), the
    normed rows are all-gathered before the projections, and the
    row-parallel partial sums are reduce-scattered onto the rows
    (:func:`add_partials`); elsewhere the residual is one replicated
    tensor and the partials are all-reduced.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math

import torch
import torch.nn.functional as F
import torch.utils.checkpoint

from repro_torch import remat as _remat
from repro_torch.device import card_like
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.mesh import LocalRing, get_mesh, set_mesh
from repro_torch.parallel.sharding import Placed
from repro_torch.parallel.ring_attention import ring_attention

NEG_INF = -1e30


def unstack(tree: dict | None) -> list[dict]:
    """A stacked param dict (leaves with a leading layer axis, nested dicts
    allowed) -> one dict per layer; ``None`` (an absent stack) -> [].  Each
    leaf is unbound ONCE: indexing it per layer would give each layer a
    full-size zero gradient of the whole stack under autograd."""
    if tree is None:
        return []
    cols = {k: unstack(v) if isinstance(v, dict) else v.unbind(0)
            for k, v in tree.items()}
    n = len(next(iter(cols.values())))
    return [{k: c[i] for k, c in cols.items()} for i in range(n)]


def checkpoint(fn, *args, use_reentrant: bool, **kw):
    """``torch.utils.checkpoint.checkpoint`` keeping no RNG state: the
    recomputed units draw no random numbers, and on the card the state's
    restore is a copy a unit (a step would then run other ops there than
    on the meta device)."""
    return torch.utils.checkpoint.checkpoint(
        fn, *args, use_reentrant=use_reentrant, preserve_rng_state=False,
        **kw)


_UNIT_INPUTS: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_unit_inputs", default=None)


def _flatten(args: tuple) -> tuple[list, list]:
    """``args`` with each list of tensors spread into its tensors, and the
    list lengths (None for an argument kept whole) to rebuild them."""
    flat, sizes = [], []
    for a in args:
        if isinstance(a, list) and a and all(isinstance(t, torch.Tensor)
                                             for t in a):
            flat.extend(a)
            sizes.append(len(a))
        else:
            flat.append(a)
            sizes.append(None)
    return flat, sizes


def _rebuild(flat: tuple, sizes: list) -> list:
    out, i = [], 0
    for n in sizes:
        if n is None:
            out.append(flat[i])
            i += 1
        else:
            out.append(list(flat[i:i + n]))
            i += n
    return out


def remat_call(fn, *args, remat: bool = True, save: tuple[str, ...] = ()):
    """``fn(*args)``; with grad enabled and ``remat`` (the config's switch,
    the reference's per-layer ``remat``, on by default), under
    ``torch.utils.checkpoint``: the unit keeps its inputs (a list of
    tensors in ``args``, a sequence-sharded residual, is handed to the
    checkpoint tensor by tensor, so autograd's saved-tensor hooks see what
    is kept) and the values of the :func:`repro_torch.remat.keep` calls
    named in ``save`` (the reference's ``save_only_these_names``; none:
    ``nothing_saveable``), and the backward runs ``fn`` again under the
    mesh the forward saw (autograd may recompute on another thread,
    where the active mesh is not set), keeping no RNG state
    (:func:`checkpoint`).  Serving paths run under ``torch.no_grad()``
    and call ``fn`` plainly, as ``remat=False`` does."""
    if not (remat and torch.is_grad_enabled()):
        return fn(*args)
    mesh = get_mesh()
    kept = _remat.Saved(save)
    flat, sizes = _flatten(args)

    def unit(*flat):
        return fn(*_rebuild(flat, sizes))

    @contextlib.contextmanager
    def under(replay: bool):
        with set_mesh(mesh), kept.active(replay):
            yield

    def contexts():
        return under(False), under(True)

    record, seen = _UNIT_INPUTS.get(), []
    hooks = contextlib.nullcontext() if record is None else \
        torch.autograd.graph.saved_tensors_hooks(
            lambda t: seen.append((tuple(t.shape), t.dtype)) or t,
            lambda t: t)
    with hooks:
        out = checkpoint(unit, *flat, use_reentrant=False,
                         context_fn=contexts)
    if record is not None:
        record.append(seen)
    return out


@contextlib.contextmanager
def unit_inputs():
    """Inside the ``with`` block, each :func:`remat_call` under autograd
    appends to the list this yields the (shape, dtype) of every tensor
    autograd saved as the unit's inputs (through
    ``torch.autograd.graph.saved_tensors_hooks``): what a checkpointed
    layer keeps for its backward, a sequence-sharded residual's rows
    among them."""
    record: list[list] = []
    token = _UNIT_INPUTS.set(record)
    try:
        yield record
    finally:
        _UNIT_INPUTS.reset(token)


# ---------------------------------------------------------------------------
# Megatron-SP: the sequence-sharded residual of the placed bodies
# ---------------------------------------------------------------------------

def shard_seq(x, ring):
    """The reference's ``shard_seq`` on the port's explicit layout: the
    residual cut over the ``model`` axis along the sequence, where the
    axis (``ring``) has more than one rank and divides S of a (B, S, D)
    value.  ``x`` is a replicated tensor (cut to each held rank's rows,
    ``tensor_parallel.scatter_to_model``) or a list of per-rank partial
    sums (reduce-scattered, each rank receiving its rows of the sum,
    ``tensor_parallel.reduce_scatter_to_model``).  Returns the rows as a
    list (one entry a held rank) or, where the rule does not hold, the
    value replicated: ``x`` itself, or the partials' sum."""
    parts = isinstance(x, list)
    t = x[0] if parts else x
    if ring.size == 1 or t.dim() != 3 or t.shape[1] % ring.size:
        return tp.reduce_from_model(x, ring) if parts else x
    if parts:
        return tp.reduce_scatter_to_model(x, ring, 1)
    return tp.scatter_to_model(x, ring, 1)


def gather_seq(x, ring) -> list:
    """The reference's ``gather_seq``: each held rank's input to a block's
    projections, the whole sequence.  A sequence-sharded ``x`` (a list of
    rows) is all-gathered (``tensor_parallel.gather_to_model``: the
    backward reduce-scatters); a replicated one is each rank's copy
    (``tensor_parallel.copy_to_model``)."""
    if isinstance(x, list):
        return tp.gather_to_model(x, ring, 1)
    return tp.copy_to_model(x, ring)


def seq_map(fn, x, ring, *replicated):
    """``fn(x, *replicated)`` on a replicated ``x``, or on each rank's rows
    of a sequence-sharded one with that rank's copy of each replicated
    tensor (a norm's weight: on a process ring its cotangent is then
    summed over the axis, ``tensor_parallel.copy_to_model``)."""
    if not isinstance(x, list):
        return fn(x, *replicated)
    copies = [tp.copy_to_model(w, ring) for w in replicated]
    return [fn(t, *(c[i] for c in copies)) for i, t in enumerate(x)]


def rms_norm_seq(x, weight, ring, eps: float):
    """rms_norm of a replicated or sequence-sharded ``x`` by a placed,
    replicated ``weight`` (:func:`seq_map`)."""
    return seq_map(lambda t, w: rms_norm(t, w, eps), x, ring, weight.at())


def add_partials(x, parts: list, ring, bias=None):
    """The residual ``x`` plus the row-parallel partials' sum (plus a
    replicated ``bias``, added once after the sum), in ``x``'s layout: on
    sequence-sharded rows the sum reduce-scattered (the reference's
    ``x + shard_seq(delta)``), on a replicated ``x`` all-reduced."""
    if not isinstance(x, list):
        d = tp.reduce_from_model(parts, ring)
        return x + (d if bias is None else d + bias)
    ds = tp.reduce_scatter_to_model(parts, ring, 1)
    if bias is not None:
        ds = [d + b for d, b in zip(ds, tp.copy_to_model(bias, ring))]
    return [a + d for a, d in zip(x, ds)]


def add_rows(x, t: torch.Tensor, ring):
    """``x`` plus a replicated (.., S, D) ``t`` broadcast over the batch,
    in ``x``'s layout (each rank adding its rows of ``t``)."""
    if not isinstance(x, list):
        return x + t
    return [a + b for a, b in zip(x, tp.scatter_to_model(t, ring, 1))]


def seq_positions(S: int, device) -> torch.Tensor:
    """(1, S) int32 positions 0 .. S - 1."""
    return torch.arange(S, dtype=torch.int32, device=device)[None, :]


def rms_norm(x: torch.Tensor, weight: torch.Tensor,
             eps: float = 1e-6) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    x = x * torch.rsqrt((x * x).mean(-1, keepdim=True) + eps)
    return (x * weight.float()).to(dt)


def layer_norm(x: torch.Tensor, weight: torch.Tensor, bias: torch.Tensor,
               eps: float = 1e-5) -> torch.Tensor:
    dt = x.dtype
    x = x.float()
    mu = x.mean(-1, keepdim=True)
    var = ((x - mu) ** 2).mean(-1, keepdim=True)
    y = (x - mu) * torch.rsqrt(var + eps)
    return (y * weight.float() + bias.float()).to(dt)


# ---------------------------------------------------------------------------
# Rotary position embedding
# ---------------------------------------------------------------------------

def rope_freqs(head_dim: int, theta: float = 1e6,
               device: torch.device | str | None = None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., S, H, Dh); positions: (..., S)."""
    dh = x.shape[-1]
    freqs = rope_freqs(dh, theta, device=x.device)       # (dh/2,)
    ang = positions[..., None].float() * freqs           # (..., S, dh/2)
    cos = torch.cos(ang)[..., None, :]                   # (..., S, 1, dh/2)
    sin = torch.sin(ang)[..., None, :]
    x1, x2 = x.float().chunk(2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)
    return out.to(x.dtype)


# ---------------------------------------------------------------------------
# Attention (GQA)
# ---------------------------------------------------------------------------

def _flash_mode(S: int, Sk: int, override: str | None, on_cuda: bool) -> str:
    """Resolve the attention engine ('pallas' = the hand-written CUDA
    kernel | 'xla' = the plain PyTorch paths) for one call; the policy
    lives in ``configs.base`` (explicit override > REPRO_FLASH_ATTN env >
    default)."""
    from repro_torch.configs import base as cbase
    pol = cbase.flash_attn_policy(override)
    return cbase.decide_flash(pol, seq_len=S, kv_len=Sk, on_cuda=on_cuda)


def _model_mesh():
    """The active mesh when it has a ``model`` axis of more than one rank
    (the context-parallel paths own long sequences there), else None."""
    mesh = get_mesh()
    if mesh is None or "model" not in mesh.axis_names or \
            mesh.shape["model"] == 1:
        return None
    return mesh


def _flash_pallas(q, k, v, *, causal, window, q_offset=0):
    """The trainable flash kernels on (B, S, H, D) activations, q's rows
    at global positions ``q_offset`` on: the transposes are views, read by
    the kernels through their strides.  Under autograd the call goes
    through ``FlashAttention`` (forward kernel, then the dq and dk/dv
    kernels in backward); on the CPU, through the same Function's plain
    halves."""
    from repro_torch.kernels import ops as kops
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window,
                             q_offset=q_offset)
    return o.transpose(1, 2)


def _ring_mode(S: int, m: int, override: str | None = None) -> str:
    """The context-parallel mode ('ring' | 'replicated' | 'off') for a
    global sequence of S on an m-wide model axis; the policy lives in
    ``configs.base`` (explicit override > REPRO_RING_ATTN env >
    default)."""
    from repro_torch.configs import base as cbase
    return cbase.decide_ring(cbase.ring_attn_policy(override),
                             seq_len=S, ring_size=m)


def _grouped_scores_full(q, k, v, *, causal, window, q_offset=0):
    """Full-mask attention. q: (B, S, H, Dh); k/v: (B, Sk, Hkv, Dh)."""
    B, S, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    qg = q.reshape(B, S, Hkv, G, Dh)
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), k.float()) / \
        math.sqrt(Dh)
    qpos = q_offset + torch.arange(S, device=q.device)[:, None]
    kpos = torch.arange(Sk, device=q.device)[None, :]
    mask = torch.ones((S, Sk), dtype=torch.bool, device=q.device)
    if causal:
        mask &= qpos >= kpos
    if window is not None:
        mask &= (qpos - kpos) < window
    s = torch.where(mask, s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgqs,bskd->bqkgd", p, v.float())
    return o.reshape(B, S, H, Dh).to(q.dtype)


def _grouped_scores_chunked(q, k, v, *, causal, window, chunk: int = 1024,
                            q_offset=0):
    """Online-softmax loop over kv chunks for ONE q block (the flash inner
    loop); the (Sq, Sk) score matrix is never materialized."""
    B, S, H, Dh = q.shape
    Sk, Hkv = k.shape[1], k.shape[2]
    G = H // Hkv
    assert Sk % chunk == 0, (Sk, chunk)
    qg = q.reshape(B, S, Hkv, G, Dh)
    scale = 1.0 / math.sqrt(Dh)
    qpos = q_offset + torch.arange(S, device=q.device)[:, None]
    m = torch.full((B, Hkv, G, S), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G, S), device=q.device)
    acc = torch.zeros((B, Hkv, G, S, Dh), device=q.device)
    for ci in range(Sk // chunk):
        kb = k[:, ci * chunk:(ci + 1) * chunk]
        vb = v[:, ci * chunk:(ci + 1) * chunk]
        # bf16 operands with f32 products, p stored in v's dtype, as the
        # reference's MXU einsums with preferred_element_type=f32
        s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kb.float()) * scale
        kpos = ci * chunk + torch.arange(chunk, device=q.device)[None, :]
        mask = torch.ones((S, chunk), dtype=torch.bool, device=q.device)
        if causal:
            mask &= qpos >= kpos
        if window is not None:
            mask &= (qpos - kpos) < window
        s = torch.where(mask, s, NEG_INF)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgqs,bskd->bkgqd", p.to(v.dtype).float(), vb.float())
        m = m_new
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    return o.permute(0, 3, 1, 2, 4).reshape(B, S, H, Dh).to(q.dtype)


def _attention_blocked(q, k, v, *, causal, window, q_chunk=2048,
                       k_chunk=4096, base_offset=0):
    """Flash-style double blocking in plain PyTorch: outer loop over q
    blocks, inner online-softmax loop over kv blocks; peak temp is one
    (q_chunk x k_chunk) tile per (batch, head)."""
    B, S, H, Dh = q.shape
    q_chunk = min(q_chunk, S)
    while S % q_chunk:          # largest block size that divides S
        q_chunk -= 1
    Sk = k.shape[1]
    k_chunk = min(k_chunk, Sk)
    while Sk % k_chunk:
        k_chunk -= 1
    outs = [_grouped_scores_chunked(
        q[:, qi * q_chunk:(qi + 1) * q_chunk], k, v, causal=causal,
        window=window, chunk=k_chunk, q_offset=base_offset + qi * q_chunk)
        for qi in range(S // q_chunk)]
    return torch.cat(outs, dim=1)


def _attention_ring(q, k, v, *, causal, window, ring: str | None = None,
                    flash: bool = False):
    """Context-parallel attention over the ``model`` axis of the active
    mesh, on global tensors; two schedules behind one policy
    (``configs.base.ring_attn_policy``; ``ring`` overrides the mode):

    * ``ring`` — ``parallel.ring_attention``: k/v stay sequence-sharded and
      hop neighbour to neighbour while each rank folds the visiting shard
      into its rows' online softmax (the paper's FIFO mesh), with the
      memory-flat backward;
    * ``replicated`` — each rank's q shard against the whole k/v at the
      shard's global offset: the flash kernels with ``flash`` (the flash
      policy picked them), else ``_attention_blocked``; autograd sums the
      k/v gradients over the ranks.  The fallback below the ring's
      sequence threshold.

    Returns None when inapplicable (no mesh or model axis, indivisible
    shapes, mode 'off').  Global tensors on a model axis whose ranks are
    processes raise rather than compute unsharded: such a mesh takes a
    state placed by the sharding slice's ``shard_tree`` (heads split over
    the axis), or this rank's sequence shards through
    ``parallel.ring_attention_local``."""
    mesh = _model_mesh()
    if mesh is None:
        return None
    transport = mesh.transport("model")
    m = transport.size
    S = q.shape[1]
    mode = _ring_mode(S, m, ring)
    if mode == "off":
        return None
    if not isinstance(transport, LocalRing):
        raise NotImplementedError(
            "attention on global tensors over a model axis of processes: "
            "place the state with parallel.sharding.shard_tree (the "
            "sharding slice splits heads over the axis), or call "
            "parallel.ring_attention_local with this rank's sequence "
            "shards")
    if S % m != 0 or k.shape[1] != S:
        return None
    if mode == "ring":
        out = ring_attention(q, k, v, causal=causal, window=window,
                             mesh=mesh)
        if out is not None:
            return out
    S_l = S // m

    def shard(idx, q_l):
        if flash:
            return _flash_pallas(q_l, k, v, causal=causal, window=window,
                                 q_offset=idx * S_l)
        return _attention_blocked(q_l, k, v, causal=causal, window=window,
                                  base_offset=idx * S_l)

    outs = [shard(idx, q_l)
            for idx, q_l in zip(transport.index(), transport.split(q, 1))]
    return transport.join(outs, 1)


def attention(q, k, v, *, causal=True, window=None, impl=None,
              full_threshold: int = 2048, q_offset: int = 0,
              ring: str | None = None):
    """Dispatch: under a mesh with a ``model`` axis of more than one rank,
    sequences above ``full_threshold`` take the context-parallel paths of
    the ring policy (``_attention_ring``); otherwise the trainable
    hand-written flash kernels when the flash policy picks them (on CUDA:
    ``auto`` at max(S, Sk) >= min_seq, or forced), else the full-mask path
    for short sequences and the double-blocked online softmax for long
    ones.  The flash kernels give way only to the ring itself: the
    replicated mode runs them on each q shard.  ``impl`` overrides the
    flash policy ('pallas' | 'xla'; None / 'auto' resolves via
    REPRO_FLASH_ATTN), ``ring`` the ring policy's mode.  q: (B, S, H, D);
    k/v: (B, Sk, Hkv, D)."""
    if impl not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"attention impl {impl!r} not in "
                         "(None, 'auto', 'pallas', 'xla')")
    mode = _flash_mode(q.shape[1], k.shape[1],
                       None if impl in (None, "auto") else impl,
                       on_cuda=card_like(q))
    # the ring's masks start its shards at global position 0, and offset
    # callers (chunked q against a longer kv) stay on the plain paths, as
    # the reference's kernel wrapper masks in local positions
    flash = mode == "pallas" and q_offset == 0
    long = max(q.shape[1], k.shape[1]) > full_threshold
    if long and q_offset == 0:
        out = _attention_ring(q, k, v, causal=causal, window=window,
                              ring=ring, flash=flash)
        if out is not None:
            return out
    if flash:
        return _flash_pallas(q, k, v, causal=causal, window=window)
    if long:
        return _attention_blocked(q, k, v, causal=causal, window=window,
                                  base_offset=q_offset)
    return _grouped_scores_full(q, k, v, causal=causal, window=window,
                                q_offset=q_offset)


def quantize_kv(x: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """Per-(token, head) symmetric int8 KV quantization.

    x: (..., Dh) -> (int8 same shape, f32 scale (...,))."""
    xf = x.float()
    amax = xf.abs().amax(-1)
    scale = torch.clamp(amax / 127.0, min=1e-8)
    q = torch.clamp(torch.round(xf / scale[..., None]), -127, 127)
    return q.to(torch.int8), scale


def dequantize_kv(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.float() * scale[..., None]


def decode_attention(q, k_cache, v_cache, lengths, k_scale=None,
                     v_scale=None, chunk: int = 4096):
    """One-token attention against a cache. q: (B, 1, H, Dh); caches:
    (B, S, Hkv, Dh) (bf16, or int8 + (B, S, Hkv) scales); lengths: (B,).

    Long caches process in chunks with an online softmax so quantized
    caches dequantize ONE chunk at a time."""
    B, _, H, Dh = q.shape
    S, Hkv = k_cache.shape[1], k_cache.shape[2]
    G = H // Hkv
    qg = q.reshape(B, Hkv, G, Dh).float()
    scale = 1.0 / math.sqrt(Dh)

    def deq(c, sc):
        return dequantize_kv(c, sc) if sc is not None and \
            c.dtype == torch.int8 else c.float()

    def scores(kc, pos0):
        s = torch.einsum("bkgd,bskd->bkgs", qg, kc) * scale
        pos = pos0 + torch.arange(kc.shape[1], device=q.device)
        mask = pos[None, :] < lengths[:, None]
        return torch.where(mask[:, None, None, :], s, NEG_INF)

    if S <= chunk or S % chunk != 0:
        s = scores(deq(k_cache, k_scale), 0)
        p = torch.softmax(s, dim=-1)
        o = torch.einsum("bkgs,bskd->bkgd", p, deq(v_cache, v_scale))
        return o.reshape(B, 1, H, Dh).to(q.dtype)

    m = torch.full((B, Hkv, G), NEG_INF, device=q.device)
    l = torch.zeros((B, Hkv, G), device=q.device)
    acc = torch.zeros((B, Hkv, G, Dh), device=q.device)
    for ci in range(S // chunk):
        sl = slice(ci * chunk, (ci + 1) * chunk)
        ks = k_scale[:, sl] if k_scale is not None else None
        vs = v_scale[:, sl] if v_scale is not None else None
        s = scores(deq(k_cache[:, sl], ks), ci * chunk)
        m_new = torch.maximum(m, s.amax(-1))
        p = torch.exp(s - m_new[..., None])
        alpha = torch.exp(m - m_new)
        l = l * alpha + p.sum(-1)
        acc = acc * alpha[..., None] + torch.einsum(
            "bkgs,bskd->bkgd", p, deq(v_cache[:, sl], vs))
        m = m_new
    o = acc / torch.where(l == 0, 1.0, l)[..., None]
    return o.reshape(B, 1, H, Dh).to(q.dtype)


def paged_decode_attention(q, k_pages, v_pages, page_table, lengths,
                           k_scale=None, v_scale=None, *, impl="xla"):
    """Attention of freshly written tokens against a paged KV pool.

    q: (B, T, H, Dh) — token t of row b sits at position ``lengths[b] + t``
    and its K/V have already been written into the pool, so it attends
    every position <= its own.  k_pages/v_pages: (P, page, Hkv, Dh) ONE
    layer's global pool; page_table: (B, max_pages) int32 physical ids (0 =
    trash, always masked by the position bound); lengths: (B,) int32
    tokens cached BEFORE this step's writes.  Scales (int8 pools): (P,
    page, Hkv) f32.

    ``impl='pallas'`` (T == 1 only) dispatches to the paged decode kernel,
    which walks the page table itself — no gathered contiguous cache ever
    materializes.  The plain path gathers the mapped pages (bounded by the
    page-table slice the engine passes) and runs a masked softmax."""
    B, T, H, Dh = q.shape
    P, page, Hkv, _ = k_pages.shape
    if impl in (None, "auto"):
        # decode q is one token; the flash policy's min-seq threshold is a
        # prefill knob, so auto here is purely a device question
        impl = "pallas" if card_like(q) else "xla"
    from repro_torch.kernels import ops as kops
    if impl == "pallas" and T == 1:
        # the kernel wrapper records this dispatch itself
        o = kops.paged_flash_decode(q[:, 0], k_pages, v_pages, page_table,
                                    lengths + 1, k_scale, v_scale)
        return o[:, None].to(q.dtype)
    kops._record_dispatch("paged_decode_attention", impl="xla", t=T,
                          page_size=page, pages=P)
    G = H // Hkv
    S = page_table.shape[1] * page
    scale = 1.0 / math.sqrt(Dh)
    pt = page_table.long()

    def gather(pages, scales):
        x = pages[pt].float()                  # (B, MP, page, Hkv, D)
        if scales is not None:
            x = x * scales[pt][..., None]
        return x.reshape(B, S, Hkv, Dh)

    k = gather(k_pages, k_scale)
    v = gather(v_pages, v_scale)
    qg = q.reshape(B, T, Hkv, G, Dh).float()
    s = torch.einsum("btkgd,bskd->bkgts", qg, k) * scale
    ar_t = torch.arange(T, device=q.device)
    limit = lengths[:, None].long() + ar_t[None, :]              # (B, T)
    mask = torch.arange(S, device=q.device)[None, None, :] <= \
        limit[:, :, None]                                        # (B, T, S)
    s = torch.where(mask[:, None, None, :, :], s, NEG_INF)
    p = torch.softmax(s, dim=-1)
    o = torch.einsum("bkgts,bskd->btkgd", p, v)
    return o.reshape(B, T, H, Dh).to(q.dtype)


# ---------------------------------------------------------------------------
# MLPs
# ---------------------------------------------------------------------------

def gelu(x: torch.Tensor) -> torch.Tensor:
    """``jax.nn.gelu``'s default: the tanh approximation."""
    return F.gelu(x, approximate="tanh")


def swiglu(x, w_gate, w_up, w_down):
    h = F.silu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def geglu(x, w_gate, w_up, w_down):
    h = gelu(x @ w_gate) * (x @ w_up)
    return h @ w_down


def gelu_mlp(x, w_in, b_in, w_out, b_out):
    return gelu(x @ w_in + b_in) @ w_out + b_out


# ---------------------------------------------------------------------------
# Mixture of Experts (token-choice top-k, capacity-bounded dispatch)
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class MoEConfig:
    n_experts: int
    top_k: int
    d_ff: int                    # per-expert hidden
    capacity_factor: float = 1.25


def _moe_route(xt, router, K):
    """Shared routing math. xt: (T, D) -> gate_vals/gate_idx (T, K), probs.

    The top k by a stable descending sort: on ties the lower expert index
    comes first, as ``jax.lax.top_k`` gives it (``torch.topk`` promises no
    order), and a zero router ties every expert."""
    logits = xt.float() @ router.float()
    probs = torch.softmax(logits, dim=-1)
    gate_vals, gate_idx = torch.sort(probs, dim=-1, descending=True,
                                     stable=True)
    gate_vals, gate_idx = gate_vals[:, :K], gate_idx[:, :K]
    gate_vals = gate_vals / torch.clamp(gate_vals.sum(-1, keepdim=True),
                                        min=1e-9)
    return gate_vals, gate_idx, probs


def _moe_aux(probs, gate_idx, E, T, K):
    """The load-balance loss.  The expert counts are a scatter-add, not
    ``torch.bincount``, which reads its input's maximum back to the host
    on the card."""
    me = probs.mean(0)
    idx = gate_idx.reshape(-1)
    counts = torch.zeros(E, dtype=torch.float32, device=probs.device) \
        .index_add_(0, idx, torch.ones(idx.shape, device=probs.device))
    return E * torch.sum(me * counts / (T * K))


def _moe_slots(gate_idx, E: int, C: int):
    """Each assignment's slot in its expert: the exclusive cumsum of the
    (T*K, E) one-hot in token-major, then k, order.  An assignment whose
    slot is >= C is dropped.  -> (pos (T, K), keep (T, K))."""
    T, K = gate_idx.shape
    onehot = F.one_hot(gate_idx, E)                          # (T, K, E)
    flat = onehot.reshape(T * K, E)
    pos = ((flat.cumsum(0) - flat).reshape(T, K, E) * onehot).sum(-1)
    return pos, pos < C


def _moe_local(x, params, cfg: MoEConfig):
    """Single-device MoE: capacity-bounded scatter dispatch.  C counts
    every row of the call (pads and idle slots included), so which
    assignments drop depends on the rows a call batches together."""
    B, S, D = x.shape
    E, K = cfg.n_experts, cfg.top_k
    T = B * S
    xt = x.reshape(T, D)
    gate_vals, gate_idx, probs = _moe_route(xt, params["router"], K)

    C = max(1, int(cfg.capacity_factor * T * K / E))
    pos, keep = _moe_slots(gate_idx, E, C)
    gate_vals = gate_vals * keep

    e_idx = gate_idx.reshape(-1)
    keep_f = keep.reshape(-1)
    c_idx = torch.where(keep_f, pos.reshape(-1), 0)
    t_idx = torch.arange(T * K, device=x.device) // K       # token of each
    contrib = torch.where(keep_f[:, None], xt[t_idx], 0)
    disp = torch.zeros((E, C, D), dtype=x.dtype, device=x.device)
    disp.index_put_((e_idx, c_idx), contrib, accumulate=True)

    h = F.silu(torch.bmm(disp, params["w_gate"])) * \
        torch.bmm(disp, params["w_up"])
    eo = torch.bmm(h, params["w_down"])                      # (E, C, D)

    gathered = eo[e_idx, c_idx].float() * gate_vals.reshape(-1)[:, None]
    # the scatter-add over t_idx: its rows are token t's K assignments in
    # k order, so it is a sum over K, in a fixed order (no atomics)
    out = gathered.reshape(T, K, D).sum(1)
    aux = _moe_aux(probs, gate_idx, E, T, K)
    return out.reshape(B, S, D).to(x.dtype), aux


def moe_ep_local(x, router, w_gate, w_up, w_down, *, cfg: MoEConfig, ring,
                 replicated: bool = False):
    """The expert-parallel body over the ranks of ``ring`` (the reference's
    ``_moe_ep_body``, with its ``psum`` and mean over the axis): experts
    live on ranks, ``E / n`` each, and tokens travel to their experts and
    back over :meth:`all_to_all` (the paper's FIFO mesh).

    Each rank routes its own tokens with per-rank capacity ``c`` (its
    token count), and fills a send buffer of deterministic layout: the
    block to destination group g is ``e_per`` runs of ``c`` slots, one
    per expert g owns, so after the exchange a reshape and a transpose
    line the tokens up per local expert.  The way back is the same
    exchange, and each token's K outputs are summed in k order.

    ``x`` and the weights are what this process holds, cut by
    ``ring.split``: on a :class:`ProcessRing`, this rank's (B, S_l, D)
    tokens and its (E / n, ...) experts; on a :class:`LocalRing`, the
    global (B, S, D) tokens (each rank's S / n of them) and all E experts.
    With ``replicated`` every rank routes all of ``x`` (decode: S does not
    split) and the ranks' equal outputs are summed (``all_sum``: in f32,
    rounded once to their dtype) and divided by n, as the reference's
    ``psum(out) / m``.  Returns (out, aux): out as ``x`` is laid out, aux
    the mean over the axis's ranks."""
    n = ring.size
    if cfg.n_experts % n:
        raise ValueError(f"{cfg.n_experts} experts do not split over {n} "
                         f"ranks")
    held = len(ring.index())
    xs = [x] * held if replicated else ring.split(x, 1)
    outs, auxs = moe_ep_ranks(xs, [router] * held,
                              *(ring.split(w, 0)
                                for w in (w_gate, w_up, w_down)),
                              cfg=cfg, ring=ring)
    aux = ring.all_sum(auxs)[0] / n
    if replicated:
        return ring.all_sum(outs)[0] / n, aux
    return ring.join(outs, 1), aux


def moe_ep_ranks(xs, routers, wgs, wus, wds, *, cfg: MoEConfig, ring):
    """:func:`moe_ep_local`'s per-rank body: lists with an entry for each
    rank this process holds of its (B, S_r, D) tokens, its router and its
    (E / n, ...) experts.  Returns the ranks' outputs and aux terms, as
    lists."""
    n = ring.size
    E, K = cfg.n_experts, cfg.top_k
    e_per = E // n
    sends, plans, auxs = [], [], []
    for x_r, router in zip(xs, routers):
        B, S, D = x_r.shape
        T = B * S
        xt = x_r.reshape(T, D)
        gate_vals, gate_idx, probs = _moe_route(xt, router, K)
        c = max(1, int(cfg.capacity_factor * T * K / E))   # per expert
        pos, keep = _moe_slots(gate_idx, E, c)
        keep_f = keep.reshape(-1)
        # each assignment's row of the (n * e_per * c, D) send buffer:
        # destination group g = e // e_per, then its expert e % e_per, then
        # the slot, which is row e * c + slot
        dst = (gate_idx * c + torch.where(keep, pos, 0)).reshape(-1)
        t_idx = torch.arange(T * K, device=x_r.device) // K
        contrib = torch.where(keep_f[:, None], xt[t_idx], 0)
        send = torch.zeros((E * c, D), dtype=x_r.dtype, device=x_r.device)
        send.index_put_((dst,), contrib, accumulate=True)
        sends.append(send)
        plans.append((B, S, T, c, dst, gate_vals * keep))
        auxs.append(_moe_aux(probs, gate_idx, E, T, K))

    recvs = ring.all_to_all(sends)
    backs = []
    for recv, wg, wu, wd, (_, _, _, c, _, _) in zip(recvs, wgs, wus, wds,
                                                    plans):
        D = recv.shape[-1]
        # (n (source), e_per, c, D) -> (e_per, n * c, D)
        h_in = recv.reshape(n, e_per, c, D).transpose(0, 1) \
            .reshape(e_per, n * c, D)
        h = F.silu(torch.bmm(h_in, wg)) * torch.bmm(h_in, wu)
        eo = torch.bmm(h, wd)
        backs.append(eo.reshape(e_per, n, c, D).transpose(0, 1)
                     .reshape(E * c, D))
    backs = ring.all_to_all(backs)

    outs = []
    for back, x_r, (B, S, T, _, dst, gates) in zip(backs, xs, plans):
        D = back.shape[-1]
        gathered = back[dst].float() * gates.reshape(-1)[:, None]
        # the scatter-add over tokens as a fixed-order sum over K
        outs.append(gathered.reshape(T, K, D).sum(1).reshape(B, S, D)
                    .to(x_r.dtype))
    return outs, auxs


def _moe_token_split(x, params, cfg: MoEConfig, ring):
    """Each rank of ``ring`` runs :func:`_moe_local` on its S / m tokens
    against all the experts."""
    outs, auxs = [], []
    for x_r in ring.split(x, 1):
        o, a = _moe_local(x_r, params, cfg)
        outs.append(o)
        auxs.append(a)
    return ring.join(outs, 1), ring.all_sum(auxs)[0] / ring.size


def _moe_tp(x, params, cfg: MoEConfig, ring):
    """TP in expert: every rank routes all tokens against all experts with
    1/m of each expert's FFN (F of ``w_gate`` / ``w_up`` and of
    ``w_down``), and the partial outputs, each rounded to x's dtype as the
    reference's per-shard ``_moe_local`` returns it, are summed."""
    outs, auxs = [], []
    for wg, wu, wd in zip(ring.split(params["w_gate"], 2),
                          ring.split(params["w_up"], 2),
                          ring.split(params["w_down"], 1)):
        o, a = _moe_local(x, {"router": params["router"], "w_gate": wg,
                              "w_up": wu, "w_down": wd}, cfg)
        outs.append(o)
        auxs.append(a)
    return ring.all_sum(outs)[0], ring.all_sum(auxs)[0] / ring.size


def moe_layer(x: torch.Tensor, params: dict,
              cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); params: router (D, E), w_gate/w_up (E, D, F),
    w_down (E, F, D). Returns (out, aux_loss).

    Distribution dispatch, on the active mesh (``parallel.set_mesh``), as
    the reference's:

      * no mesh, or a ``model`` axis of one rank: the local capacity
        dispatch (:func:`_moe_local`);
      * E divisible by the model axis's m: expert parallelism
        (:func:`moe_ep_local`; capacities per rank).  Tokens split over
        ``model`` on S when m divides it; otherwise (decode) every rank
        routes all of them and the duplicates are summed and divided by m;
      * otherwise (granite's 40 experts on a 16-wide axis), with S divisible
        by m: each rank runs the local dispatch on its S / m tokens against
        all the experts;
      * otherwise: TP in expert, each rank with 1/m of every expert's FFN
        and the partial outputs summed.

    B splits over the data axes (``pod``, ``data``) first, so capacities
    count each data rank's tokens; the aux loss is the mean over all data
    x model ranks.  The mesh's axes must be local rings (global tensors,
    every rank in this process): on an axis of processes the state is
    placed (``parallel.sharding.shard_tree``; :func:`moe_layer_placed`),
    or its ranks call :func:`moe_ep_local` with their shards, and global
    tensors raise."""
    mesh = _model_mesh()
    if mesh is None:
        return _moe_local(x, params, cfg)
    daxes = [a for a in ("pod", "data") if a in mesh.axis_names]
    if not all(isinstance(mesh.transport(a), LocalRing)
               for a in ("model", *daxes)):
        raise NotImplementedError(
            "the MoE layer on global tensors over an axis of processes: "
            "place the state with parallel.sharding.shard_tree "
            "(moe_layer_placed), or call models.layers.moe_ep_local with "
            "this rank's shards")
    nd = math.prod(mesh.shape[a] for a in daxes)
    ring = mesh.transport("model")
    m = ring.size
    if x.shape[0] % nd:
        raise ValueError(f"batch {x.shape[0]} does not split over the data "
                         f"axes {daxes} ({nd} ranks)")
    E = cfg.n_experts
    seq_split = x.shape[1] % m == 0
    if E % m == 0:
        def body(xd):
            return moe_ep_local(xd, params["router"], params["w_gate"],
                                params["w_up"], params["w_down"], cfg=cfg,
                                ring=ring, replicated=not seq_split)
    elif seq_split:
        def body(xd):
            return _moe_token_split(xd, params, cfg, ring)
    else:
        def body(xd):
            return _moe_tp(xd, params, cfg, ring)
    runs = [body(xd) for xd in x.chunk(nd, 0)]
    out = torch.cat([o for o, _ in runs], 0) if nd > 1 else runs[0][0]
    aux = LocalRing(nd).all_sum([a for _, a in runs])[0] / nd
    return out, aux


# ---------------------------------------------------------------------------
# Tensor parallelism on a placed state
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeadShard:
    """What one model rank computes of a GQA attention whose q / k / v
    output features are cut over the ``model`` axis: it holds q features
    [``q_lo``, ``q_hi``) and k / v features [``k_lo``, ``k_hi``), computes
    q heads [``h0``, ``h1``) and reads kv heads [``kv0``, ``kv1``);
    ``kv_index`` (None when the kv heads serve the q heads by GQA
    grouping) picks, among those, each q head's own."""
    q_lo: int
    q_hi: int
    k_lo: int
    k_hi: int
    h0: int
    h1: int
    kv0: int
    kv1: int
    kv_index: tuple | None


@dataclasses.dataclass(frozen=True)
class HeadPlan:
    """Every rank's :class:`HeadShard`, and whether the ranks must
    all-gather the q or the k / v projections over ``model`` first (some
    rank holds part of a head it computes: H or Kv does not divide the
    axis)."""
    shards: tuple
    gather_q: bool
    gather_kv: bool
    head_dim: int


def _chunk_range(size: int, n: int, r: int) -> tuple[int, int]:
    step = -(-size // n)
    lo = min(r * step, size)
    return lo, min(lo + step, size)


def head_plan(H: int, Kv: int, Dh: int, m: int) -> HeadPlan:
    """The head split of an (H, Kv, Dh) attention over m model ranks whose
    q / k / v features the param specs cut evenly: each rank computes the
    q heads its q features (and ``wo``'s rows) touch, a head that straddles
    two ranks on both, against the kv heads those q heads read."""
    G = H // Kv
    shards = []
    for r in range(m):
        a, b = _chunk_range(H * Dh, m, r)
        c, d = _chunk_range(Kv * Dh, m, r)
        if a == b:
            raise ValueError(f"model rank {r} of {m} holds no q feature of "
                             f"{H} x {Dh}")
        h0, h1 = a // Dh, -(-b // Dh)
        kvs = [h // G for h in range(h0, h1)]
        kv0, kv1 = kvs[0], kvs[-1] + 1
        nq, nk = h1 - h0, kv1 - kv0
        grouped = nq % nk == 0 and all(
            kv - kv0 == j // (nq // nk) for j, kv in enumerate(kvs))
        shards.append(HeadShard(a, b, c, d, h0, h1, kv0, kv1,
                                None if grouped else
                                tuple(kv - kv0 for kv in kvs)))
    return HeadPlan(
        tuple(shards),
        gather_q=any(s.q_lo != s.h0 * Dh or s.q_hi != s.h1 * Dh
                     for s in shards),
        gather_kv=any(s.k_lo != s.kv0 * Dh or s.k_hi != s.kv1 * Dh
                      for s in shards),
        head_dim=Dh)


def heads_of(plan: HeadPlan, r: int, q: torch.Tensor,
             gathered: bool) -> torch.Tensor:
    """Rank ``r``'s q heads (B, S, h1 - h0, Dh) from its projection:
    its own features, or the gathered whole's slice."""
    sh, Dh = plan.shards[r], plan.head_dim
    if gathered:
        q = q[..., sh.h0 * Dh:sh.h1 * Dh]
    return q.reshape(*q.shape[:-1], sh.h1 - sh.h0, Dh)


def kv_heads_of(plan: HeadPlan, r: int, k: torch.Tensor, gathered: bool,
                all_kv: bool = False) -> torch.Tensor:
    """Rank ``r``'s kv heads (B, S, kv1 - kv0, Dh) from its projection
    (the gathered whole's slice when ``gathered``); with ``all_kv`` a
    gathered projection keeps every kv head (a placed cache's writes, where
    a rank's shard holds a head_dim slice of each)."""
    sh, Dh = plan.shards[r], plan.head_dim
    if all_kv and gathered:
        return k.reshape(*k.shape[:-1], -1, Dh)
    if gathered:
        k = k[..., sh.kv0 * Dh:sh.kv1 * Dh]
    return k.reshape(*k.shape[:-1], sh.kv1 - sh.kv0, Dh)


def expand_kv(plan: HeadPlan, r: int, k: torch.Tensor) -> torch.Tensor:
    """Rank ``r``'s kv heads as its attention reads them: as they are when
    they serve its q heads by GQA grouping, else one for each q head."""
    idx = plan.shards[r].kv_index
    if idx is None:
        return k
    return k.index_select(-2, torch.tensor(idx, device=k.device))


def out_features(plan: HeadPlan, r: int, o: torch.Tensor) -> torch.Tensor:
    """The (B, S, q_hi - q_lo) features of rank ``r``'s attention output
    (B, S, h1 - h0, Dh) that its rows of ``wo`` take."""
    sh, Dh = plan.shards[r], plan.head_dim
    o = o.reshape(*o.shape[:-2], -1)
    return o[..., sh.q_lo - sh.h0 * Dh:sh.q_hi - sh.h0 * Dh]


def kv_cut(pool_leaf: Placed) -> str:
    """How the model ranks' shards of a cache or pool leaf cut the kv heads:
    'heads' (its heads, its plan's kv range), 'head_dim' (a slice of every
    head's features) or 'none' (every head, replicated)."""
    spec = pool_leaf.spec
    if spec[3] is not None and "model" in pool_leaf.axes:
        return "heads"
    if len(spec) > 4 and spec[4] is not None and "model" in pool_leaf.axes:
        return "head_dim"
    return "none"


def _own(t: torch.Tensor, r: int, cut: str, ring) -> torch.Tensor:
    """Rank ``r``'s part, as its cache or pool shard holds it, of its
    new K/V (B, T, heads, Dh) or scales (B, T, heads): a slice of the
    features in the head_dim cut, else as they are."""
    if cut == "head_dim" and t.dim() == 4:
        lo, hi = tp.vocab_range(t.shape[-1], ring.size, r)
        return t[..., lo:hi]
    return t


def kv_values(store: dict, k: torch.Tensor, v: torch.Tensor, r: int,
               cut: str, ring) -> dict:
    """Rank ``r``'s part of new K/V (B, T, heads, Dh) as its cache or pool
    shard stores it: quantized with scales for an int8 store, a slice of
    the features in the head_dim cut."""
    if store["k"].dtype == torch.int8:
        (kq, ks), (vq, vs) = quantize_kv(k), quantize_kv(v)
        vals = {"k": kq, "v": vq, "k_scale": ks, "v_scale": vs}
    else:
        vals = {"k": k.to(store["k"].dtype), "v": v.to(store["v"].dtype)}
    return {n: _own(t, r, cut, ring) for n, t in vals.items()}


def kv_views(store: dict, i: int, ring, plan, cut: str) -> list[dict]:
    """Each held rank's layer-i view of a placed cache or pool (k, v and
    any scales) over the kv heads its q heads read: its shard, or the
    shards gathered whole over the axis (head_dim cut), narrowed to its
    plan's kv heads as contiguous tensors (the paged kernel takes a
    contiguous pool)."""
    idx = ring.index()
    names = [n for n in ("k", "v", "k_scale", "v_scale") if n in store]
    out = [{} for _ in idx]
    for n in names:
        ts = [store[n].at(model=r)[i] for r in idx]
        if cut == "head_dim" and n in ("k", "v"):
            ts = tp.gather_to_model(ts, ring, -1)
        for j, (r, t) in enumerate(zip(idx, ts)):
            if cut != "heads":
                sh = plan.shards[r]
                # (.., S or page, Kv[, Dh]): heads are dim 2 of a layer
                t = t.narrow(2, sh.kv0, sh.kv1 - sh.kv0).contiguous()
            out[j][n] = t
    return out


def expand_views(plan, r: int, pg: dict) -> dict:
    """A rank's views with one kv head for each of its q heads, where its
    split breaks the GQA groups (``HeadShard.kv_index``)."""
    if plan.shards[r].kv_index is None:
        return pg
    return {n: expand_kv(plan, r, t if t.dim() == 4 else t[..., None])
            .reshape(*t.shape[:2], -1, *t.shape[3:]) for n, t in pg.items()}


def kv_of(plan, r: int, t: torch.Tensor, all_kv: bool) -> torch.Tensor:
    """The kv heads rank ``r``'s attention reads of new K/V that hold
    every head (``all_kv``) or its own already; expanded as
    :func:`expand_kv` says."""
    if all_kv:
        sh = plan.shards[r]
        t = t.narrow(2, sh.kv0, sh.kv1 - sh.kv0)
    return expand_kv(plan, r, t)


def project_placed(hs: list, w, ring, gather: bool, bias=None) -> list:
    """Each model rank's output features of ``h @ w (+ bias)`` (``w`` and
    ``bias`` placed, cut on their last dim; ``hs`` the per-rank input,
    :func:`tensor_parallel.copy_to_model`), all-gathered whole over the
    axis where ``gather`` (a head straddles ranks)."""
    out = []
    for r, h_r in zip(ring.index(), hs):
        y = h_r @ w.at(model=r)
        if bias is not None:
            y = y + bias.at(model=r)
        out.append(y)
    return tp.gather_to_model(out, ring, -1) if gather else out


def attn_out_parts(wo, plan: HeadPlan, ring, outs: list) -> list:
    """The ranks' attention outputs (B, S, heads, Dh) through their rows
    of ``wo`` (placed, cut on its rows): each rank's partial sum."""
    return [out_features(plan, r, o) @ wo.at(model=r)
            for r, o in zip(ring.index(), outs)]


def logits_placed(x, w, ring, tied: bool = False) -> list[torch.Tensor]:
    """Each model rank's logits over its vocab range from the final
    activations ``x`` (replicated, or sequence-sharded rows gathered
    first, :func:`gather_seq`): ``x @ w`` of its (D, V / m) columns of an
    output head, or, ``tied``, ``x @ w.T`` of its (V / m, D) rows of the
    embedding."""
    return [x_r @ (w.at(model=r).T if tied else w.at(model=r))
            for r, x_r in zip(ring.index(), gather_seq(x, ring))]


def moe_layer_placed(hs: list, params: dict, cfg: MoEConfig, ring,
                     shard: bool = False) -> tuple[object, torch.Tensor]:
    """The MoE MLP on a placed state, over the ranks of ``ring`` (the
    ``model`` axis): the branch the param specs imply.  ``hs`` is each
    held rank's whole (B, S, D) input (:func:`gather_seq`); ``params`` are
    placed (router replicated, the experts cut by
    ``parallel.sharding.param_specs``).

      * E divisible by the axis (experts on ``model``): expert
        parallelism, :func:`moe_ep_ranks`; each rank routes its S / m
        tokens and the outputs are gathered, or, where S does not split
        (decode), every rank routes all of them and the outputs are
        summed and divided by m;
      * otherwise (the experts' F on ``model``): TP in expert, each rank
        routing all tokens against its F / m of every expert, the partial
        outputs (rounded to x's dtype, as the reference's per-shard
        ``_moe_local``) summed.

    With ``shard`` (a sequence-sharded residual, :func:`shard_seq`'s rule
    holds) the output is each held rank's rows: the expert-parallel
    ranks' own tokens as they are, the TP partials reduce-scattered.
    Returns (out, aux): aux the mean of the ranks' own terms."""
    n = ring.size
    E = cfg.n_experts
    xs = list(hs)
    routers = tp.copy_to_model(params["router"].at(), ring)
    idx = ring.index()
    wgs, wus, wds = ([params[k].at(model=r) for r in idx]
                     for k in ("w_gate", "w_up", "w_down"))
    if E % n == 0:
        S = xs[0].shape[1]
        split = S % n == 0
        if split:
            xs = [x_r.narrow(1, r * (S // n), S // n)
                  for r, x_r in zip(idx, xs)]
        outs, auxs = moe_ep_ranks(xs, routers, wgs, wus, wds, cfg=cfg,
                                  ring=ring)
        if shard:
            out = outs
        else:
            out = tp.gather_from_model(outs, ring, 1) if split else \
                tp.reduce_from_model(outs, ring) / n
    else:
        outs, auxs = [], []
        for x_r, router, wg, wu, wd in zip(xs, routers, wgs, wus, wds):
            o, a = _moe_local(x_r, {"router": router, "w_gate": wg,
                                    "w_up": wu, "w_down": wd}, cfg)
            outs.append(o)
            auxs.append(a)
        out = tp.reduce_scatter_to_model(outs, ring, 1) if shard else \
            tp.reduce_from_model(outs, ring)
    return out, tp.reduce_from_model(auxs, ring) / n
