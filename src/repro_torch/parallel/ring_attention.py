"""Ring attention over a mesh axis, with a memory-flat backward.

Counterpart of ``repro.parallel.ring_attention``: the paper's FIFO
data-exchange mesh applied to context-parallel attention.  Queries stay
home (output-stationary, like the paper's stationary PSums), k/v sequence
shards hop neighbour to neighbour (the FIFO hop, ``Transport.shift``), and
each rank folds the visiting shard into its rows' online softmax: no rank
ever holds the whole k/v.

Forward (per rank of a ring of ``m``): q_l (B, S/m, H, D) are the rank's
rows, k_l / v_l its own sequence shard; ``m`` hops of fold-then-shift.
The autograd Function saves only ``(q, k, v, o, lse)``.

Backward (a second ring pass on the same hop schedule): each hop
recomputes the visiting shard's scores from ``(q, k_hop, lse)`` with the
ring's global lse, folds ``dq`` into a local accumulator, and circulates
the f32 ``dk`` / ``dv`` accumulators alongside the k/v shards, so a
shard's gradient arrives home when the loop ends: no all-reduce and no
saved per-hop activation.  ``impl="naive"`` runs autograd through the
fold loop instead, which keeps one (S/m x S/m) score tile per hop: the
baseline.

Each hop's fold is one of two engines:

  * the einsum fold (``_fwd_body`` / ``_bwd_body``): masked f32 score
    tiles, as the reference's XLA einsum chain;
  * the fused fold: each hop is the hand-written flash kernels
    (``kernels.attention``) at the hop's global offsets ``q_offset =
    idx * S_l`` and ``k_offset = owner * S_l`` with their pruned block
    ranges, the forward's per-hop (o, lse) combined by logsumexp algebra
    and the backward's dq / dk / dv kernels fed the ring's global lse.
    On CUDA tensors the kernels launch (or raise); on CPU tensors their
    plain versions run at the blocks ``_fused_blocks`` snaps to the local
    shard.  A hop whose keys are all masked (a later shard under a causal
    mask, one outside the window) still launches: its ranges are empty,
    the forward drains o = 0 and lse = -1e30 and the backward 0, which
    the combine weighs by exp(-1e30 - lse) = 0.

The bodies are written once over the axis's transport
(``parallel.mesh``): :func:`ring_attention` takes global (B, S, H, D)
tensors under a ``LocalRing`` mesh (all ranks in this process, one after
another, on one device) and :func:`ring_attention_local` takes this
rank's shards under a ``ProcessRing`` (one rank a process), as the
reference's shard_map body does.
"""
from __future__ import annotations

import contextlib
import contextvars
import dataclasses
import math
from collections.abc import Iterator

import torch

from ..analysis import kernel_work
from ..analysis.op_cost import kernel as kernel_cost
from ..device import card_like
from ..remat import keep
from .mesh import LocalRing, Mesh, get_mesh

__all__ = ["ring_attention", "ring_attention_local", "record_ring_passes",
           "data_axes_spec"]

NEG_INF = -1e30

_RECORD: contextvars.ContextVar = contextvars.ContextVar(
    "repro_torch_ring_record", default=None)


def data_axes_spec(mesh: Mesh, batch: int):
    """The data-ish mesh axes ("pod", "data") a batch dim of ``batch``
    splits over: their tuple (or the one name) when ``batch`` divides their
    product, else None (replicate).  Attention has no cross-batch terms, so
    a local ring computes every batch shard the same way."""
    daxes = tuple(a for a in ("pod", "data") if a in mesh.axis_names)
    dsz = math.prod(mesh.shape[a] for a in daxes)
    if not daxes or batch % dsz != 0:
        return None
    return daxes if len(daxes) > 1 else daxes[0]


@dataclasses.dataclass(frozen=True)
class _RingSpec:
    """One ring-attention call.  ``fused`` folds each visiting shard with
    the flash kernels (``block_q`` / ``block_k``: the plain versions'
    blocks on the CPU; the card runs each route's own)."""
    ring: object
    m: int
    causal: bool
    window: int | None
    fused: bool = False
    block_q: int = 0
    block_k: int = 0

    @property
    def needs_pos(self) -> bool:
        return self.causal or self.window is not None


def _fused_blocks(S_l: int, Dh: int) -> tuple[int, int] | None:
    """The card's (block_q, block_k) snapped down to divisors of the local
    shard, or None when the shard is too ragged to tile (-> einsum fold):
    the reference's rule."""
    from ..core.cuda_bridge import attention_block_shapes
    bq, bk = attention_block_shapes(S_l, S_l, Dh)
    while bq > 1 and S_l % bq:
        bq //= 2
    while bk > 1 and S_l % bk:
        bk //= 2
    if bq < 8 or bk < 8:
        return None
    return bq, bk


def _masked_scores(qg, kb, *, scale, q_off, k_off, causal, window):
    """(B, Hkv, G, Sq, Sk) f32 scores of local q rows against ONE visiting
    shard, the band mask in global positions."""
    S_q, S_k = qg.shape[1], kb.shape[1]
    s = torch.einsum("bqkgd,bskd->bkgqs", qg.float(), kb.float()) * scale
    if not causal and window is None:
        return s
    qpos = q_off + torch.arange(S_q, device=qg.device)[:, None]
    kpos = k_off + torch.arange(S_k, device=qg.device)[None, :]
    mask = torch.ones((S_q, S_k), dtype=torch.bool, device=qg.device)
    if causal:
        mask = mask & (qpos >= kpos)
    if window is not None:
        mask = mask & ((qpos - kpos) < window)
    return torch.where(mask, s, NEG_INF)


def _offsets(spec: _RingSpec, idx: int, t: int, S_l: int) -> tuple[int, int]:
    """(q_offset, k_offset) of rank ``idx`` at hop ``t``: the visiting
    shard is rank ``idx - t``'s.  Without a band nothing depends on them."""
    if not spec.needs_pos:
        return 0, 0
    return idx * S_l, (idx - t) % spec.m * S_l


# ---------------------------------------------------------------------------
# the fused fold: one flash kernel launch per (rank, hop)
# ---------------------------------------------------------------------------

def _heads(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> the kernels' (B, H, S, D) view."""
    return x.transpose(1, 2)


def _flat(x: torch.Tensor) -> torch.Tensor:
    """(B, S, H, D) -> the plain versions' (B * H, S, D)."""
    B, S, H, D = x.shape
    return _heads(x).reshape(B * H, S, D)


def _hop_fwd(spec: _RingSpec, q, k, v, q_off: int, k_off: int):
    """One hop's flash forward: o (B, S_l, H, D) in q's dtype and lse f32
    (B, H, S_l) of q's rows against the visiting k/v."""
    from ..kernels import attention as katt
    B, S_l, H, D = q.shape
    kw = dict(causal=spec.causal, window=spec.window, q_offset=q_off,
              k_offset=k_off)
    with kernel_cost(lambda: kernel_work.flash_fwd_of(_heads(q), _heads(k),
                                                      **kw)):
        if card_like(q):
            o, lse = katt.flash_attention_fwd_cuda(
                _heads(q), _heads(k), _heads(v), prune=True, **kw)
            return o.transpose(1, 2), lse.view(B, H, S_l)
        o, lse = katt.flash_attention_fwd_plain(
            _flat(q), _flat(k), _flat(v), block_q=spec.block_q,
            block_k=spec.block_k, **kw)
        return o.view(B, H, S_l, D).transpose(1, 2), lse.view(B, H, S_l)


def _hop_bwd(spec: _RingSpec, q, k, v, do, lse, delta, q_off: int,
             k_off: int):
    """One hop's flash backward with the ring's global ``lse`` and
    ``delta`` (f32 (B * H, S_l), contiguous): f32 (dq, dk, dv) in the
    (B, S, H, D) layout.  Each hop reports the pair's work to an active
    op cost counter, as the kernel entries do."""
    with kernel_cost(lambda: kernel_work.flash_bwd_of(
            _heads(q), _heads(k), causal=spec.causal, window=spec.window,
            q_offset=q_off, k_offset=k_off)):
        return _hop_bwd_run(spec, q, k, v, do, lse, delta, q_off, k_off)


def _hop_bwd_run(spec: _RingSpec, q, k, v, do, lse, delta, q_off: int,
                 k_off: int):
    from ..kernels import attention as katt
    kw = dict(causal=spec.causal, window=spec.window, q_offset=q_off,
              k_offset=k_off)
    if card_like(q):
        args = (_heads(q), _heads(k), _heads(v), _heads(do), lse, delta)
        dq = katt.flash_bwd_dq_cuda(*args, prune=True, **kw)
        dk, dv = katt.flash_bwd_dkv_cuda(*args, prune=True, **kw)
        return dq.transpose(1, 2), dk.transpose(1, 2), dv.transpose(1, 2)
    rounded = katt.flash_bwd_plain_kw(katt.flash_bwd_route(
        _heads(q), _heads(k), _heads(v), _heads(do)))["rounded"]
    args = (_flat(q), _flat(k), _flat(v), _flat(do), lse, delta)
    blk = dict(block_q=spec.block_q, block_k=spec.block_k, rounded=rounded)
    dq = katt.flash_bwd_dq_plain(*args, **blk, **kw)
    dk, dv = katt.flash_bwd_dkv_plain(*args, **blk, **kw)

    def unflat(x, like):
        B, S, H, D = like.shape
        return x.view(B, H, S, D).transpose(1, 2)
    return unflat(dq, q), unflat(dk, k), unflat(dv, v)


def _fused_fwd_body(spec: _RingSpec, qs, ks, vs):
    ring = spec.ring
    B, S_l, H, D = qs[0].shape
    n = len(qs)
    dev = qs[0].device
    acc = [torch.zeros((B, S_l, H, D), device=dev) for _ in range(n)]
    lse = [torch.full((B, H, S_l), NEG_INF, device=dev) for _ in range(n)]
    k_c, v_c = ks, vs
    for t in range(spec.m):
        for j, idx in enumerate(ring.index()):
            o_h, lse_h = _hop_fwd(spec, qs[j], k_c[j], v_c[j],
                                  *_offsets(spec, idx, t, S_l))
            lse_new = torch.logaddexp(lse[j], lse_h)
            w_old = torch.exp(lse[j] - lse_new).transpose(1, 2)[..., None]
            w_hop = torch.exp(lse_h - lse_new).transpose(1, 2)[..., None]
            acc[j] = acc[j] * w_old + o_h.float() * w_hop
            lse[j] = lse_new
        if t < spec.m - 1:          # the last hop's shift feeds nothing
            k_c, v_c = ring.shift(k_c, v_c)
    return [a.to(q.dtype) for a, q in zip(acc, qs)], lse


def _fused_bwd_body(spec: _RingSpec, qs, ks, vs, os_, lses, dos):
    ring = spec.ring
    B, S_l, H, D = qs[0].shape
    n = len(qs)
    dev = qs[0].device
    delta = [(o.float() * do.float()).sum(-1).transpose(1, 2)
             .reshape(B * H, S_l).contiguous() for o, do in zip(os_, dos)]
    lse = [x.reshape(B * H, S_l).contiguous() for x in lses]
    dq = [torch.zeros((B, S_l, H, D), device=dev) for _ in range(n)]
    dk_c = [torch.zeros(k.shape, device=dev) for k in ks]
    dv_c = [torch.zeros(k.shape, device=dev) for k in ks]
    k_c, v_c = ks, vs
    for t in range(spec.m):
        for j, idx in enumerate(ring.index()):
            dq_h, dk_h, dv_h = _hop_bwd(spec, qs[j], k_c[j], v_c[j], dos[j],
                                        lse[j], delta[j],
                                        *_offsets(spec, idx, t, S_l))
            dq[j] = dq[j] + dq_h
            dk_c[j] = dk_c[j] + dk_h
            dv_c[j] = dv_c[j] + dv_h
        # the shard and its gradient accumulators hop together; after m
        # hops both are home
        k_c, v_c, dk_c, dv_c = ring.shift(k_c, v_c, dk_c, dv_c)
    return dq, dk_c, dv_c


# ---------------------------------------------------------------------------
# the einsum fold
# ---------------------------------------------------------------------------

def _fwd_body(spec: _RingSpec, qs, ks, vs):
    """Fold-then-shift forward over per-rank lists.  Returns (o, lse)
    lists: o (B, S_l, H, D) in q's dtype, lse f32 (B, H, S_l)."""
    if spec.fused:
        return _fused_fwd_body(spec, qs, ks, vs)
    ring = spec.ring
    B, S_l, H, Dh = qs[0].shape
    Hkv = ks[0].shape[2]
    G = H // Hkv
    n = len(qs)
    dev = qs[0].device
    qg = [q.reshape(B, S_l, Hkv, G, Dh) for q in qs]
    scale = 1.0 / math.sqrt(Dh)
    mx = [torch.full((B, Hkv, G, S_l), NEG_INF, device=dev)
          for _ in range(n)]
    l = [torch.zeros((B, Hkv, G, S_l), device=dev) for _ in range(n)]
    acc = [torch.zeros((B, Hkv, G, S_l, Dh), device=dev) for _ in range(n)]
    k_c, v_c = ks, vs
    for t in range(spec.m):
        for j, idx in enumerate(ring.index()):
            q_off, k_off = _offsets(spec, idx, t, S_l)
            s = _masked_scores(qg[j], k_c[j], scale=scale, q_off=q_off,
                               k_off=k_off, causal=spec.causal,
                               window=spec.window)
            m_new = torch.maximum(mx[j], s.amax(-1))
            p = torch.exp(s - m_new[..., None])
            alpha = torch.exp(mx[j] - m_new)
            l[j] = l[j] * alpha + p.sum(-1)
            # p stored in v's dtype, products summed in f32 (the MXU einsum
            # with preferred_element_type=f32)
            acc[j] = acc[j] * alpha[..., None] + torch.einsum(
                "bkgqs,bskd->bkgqd", p.to(v_c[j].dtype).float(),
                v_c[j].float())
            mx[j] = m_new
        if t < spec.m - 1:
            k_c, v_c = ring.shift(k_c, v_c)
    os_, lses = [], []
    for j, q in enumerate(qs):
        l_safe = torch.where(l[j] == 0, 1.0, l[j])
        os_.append((acc[j] / l_safe[..., None]).permute(0, 3, 1, 2, 4)
                   .reshape(B, S_l, H, Dh).to(q.dtype))
        lses.append((mx[j] + torch.log(l_safe)).reshape(B, H, S_l))
    return os_, lses


def _bwd_body(spec: _RingSpec, qs, ks, vs, os_, lses, dos):
    """Second ring pass over per-rank lists: recompute each visiting
    shard's scores, fold dq locally, circulate dk/dv with the shards.
    Returns f32 (dq, dk, dv) lists."""
    if spec.fused:
        return _fused_bwd_body(spec, qs, ks, vs, os_, lses, dos)
    ring = spec.ring
    B, S_l, H, Dh = qs[0].shape
    Hkv = ks[0].shape[2]
    G = H // Hkv
    dev = qs[0].device
    qg = [q.reshape(B, S_l, Hkv, G, Dh).float() for q in qs]
    dog = [do.reshape(B, S_l, Hkv, G, Dh).float() for do in dos]
    # delta = rowsum(do * o), shared by the dq and dk products
    delta = [torch.einsum("bqkgd,bqkgd->bkgq", d,
                          o.reshape(B, S_l, Hkv, G, Dh).float())
             for d, o in zip(dog, os_)]
    lse = [x.reshape(B, Hkv, G, S_l) for x in lses]
    scale = 1.0 / math.sqrt(Dh)
    dq = [torch.zeros((B, S_l, Hkv, G, Dh), device=dev) for _ in qs]
    dk_c = [torch.zeros(k.shape, device=dev) for k in ks]
    dv_c = [torch.zeros(k.shape, device=dev) for k in ks]
    k_c, v_c = ks, vs
    for t in range(spec.m):
        for j, idx in enumerate(ring.index()):
            q_off, k_off = _offsets(spec, idx, t, S_l)
            s = _masked_scores(qg[j], k_c[j], scale=scale, q_off=q_off,
                               k_off=k_off, causal=spec.causal,
                               window=spec.window)
            p = torch.exp(s - lse[j][..., None])   # masked: exp(-1e30) = 0
            dv_c[j] = dv_c[j] + torch.einsum("bkgqs,bqkgd->bskd", p, dog[j])
            dp = torch.einsum("bqkgd,bskd->bkgqs", dog[j], v_c[j].float())
            ds = p * (dp - delta[j][..., None]) * scale
            dq[j] = dq[j] + torch.einsum("bkgqs,bskd->bqkgd", ds,
                                         k_c[j].float())
            dk_c[j] = dk_c[j] + torch.einsum("bkgqs,bqkgd->bskd", ds, qg[j])
        k_c, v_c, dk_c, dv_c = ring.shift(k_c, v_c, dk_c, dv_c)
    return [g.reshape(B, S_l, H, Dh) for g in dq], dk_c, dv_c


# ---------------------------------------------------------------------------
# the memory-flat backward
# ---------------------------------------------------------------------------

class RingAttention(torch.autograd.Function):
    """Ring attention with the second ring pass as its backward: saves
    ``(q, k, v, o, lse)`` and nothing per hop, and names ``(o, lse)``
    ``"attn_out"`` (``repro_torch.remat.keep``).  q/k/v are the transport's
    operands (global tensors under a ``LocalRing``, this rank's shards
    under a ``ProcessRing``), split along the sequence and joined back."""

    @staticmethod
    def forward(ctx, spec: _RingSpec, q, k, v):
        ring = spec.ring

        def run():
            os_, lses = _fwd_body(spec, *(ring.split(x, 1)
                                          for x in (q, k, v)))
            return ring.join(os_, 1), ring.join(lses, -1)
        # a remat unit that saves "attn_out" hands its recompute the
        # forward's o and lse: the ring pass does not run again
        o, lse = keep("attn_out", run)
        ctx.save_for_backward(q, k, v, o, lse)
        ctx.spec = spec
        record = _RECORD.get()
        ctx.record = None if record is None else {"lse": lse}
        if record is not None:
            record.append(ctx.record)
        return o

    @staticmethod
    def backward(ctx, do):
        q, k, v, o, lse = ctx.saved_tensors
        ring = ctx.spec.ring
        parts = [ring.split(x, 1) for x in (q, k, v, o)]
        dq, dk, dv = (ring.join(g, 1) for g in _bwd_body(
            ctx.spec, *parts, ring.split(lse, -1),
            ring.split(do.contiguous(), 1)))
        if ctx.record is not None:
            ctx.record.update(dq=dq, dk=dk, dv=dv)
        return None, dq.to(q.dtype), dk.to(k.dtype), dv.to(v.dtype)


@contextlib.contextmanager
def record_ring_passes() -> Iterator[list[dict]]:
    """Inside the ``with`` block, each :class:`RingAttention` forward
    appends a dict to the list this yields: ``lse``, the ring's global f32
    lse (B, H, S); its backward (on whichever thread autograd runs it)
    adds the f32 ``dq``, ``dk`` and ``dv`` before the cast to the inputs'
    dtypes, which the card's checks hold against the unsharded kernels.
    Outside such a block nothing is kept."""
    record: list[dict] = []
    token = _RECORD.set(record)
    try:
        yield record
    finally:
        _RECORD.reset(token)


def _naive(spec: _RingSpec, q, k, v):
    """The fold loop under autograd (its backward keeps one score tile per
    hop): the baseline.  Always the einsum fold: the fused hop's launches
    carry no gradient of their own."""
    spec = dataclasses.replace(spec, fused=False)
    ring = spec.ring
    os_, _ = _fwd_body(spec, *(ring.split(x, 1) for x in (q, k, v)))
    return ring.join(os_, 1)


# ---------------------------------------------------------------------------
# public entry
# ---------------------------------------------------------------------------

def _decide_fused(fused: bool | None, S_global: int, S_local: int, Dh: int,
                  on_cuda: bool) -> tuple[bool, int, int]:
    """Resolve the per-hop fold engine: explicit ``fused`` wins, else the
    flash policy (REPRO_FLASH_ATTN; the card for ``auto``) judged on the
    GLOBAL sequence.  Returns (fused, block_q, block_k); fused falls off
    when the local shard will not tile."""
    if fused is None:
        from ..configs import base as cbase
        fused = cbase.decide_flash(cbase.flash_attn_policy(None),
                                   seq_len=S_global, kv_len=S_global,
                                   on_cuda=on_cuda) == "pallas"
    if not fused:
        return False, 0, 0
    blocks = _fused_blocks(S_local, Dh)
    if blocks is None:
        return False, 0, 0
    return True, blocks[0], blocks[1]


def _spec(ring, q, S_local: int, *, causal, window, fused) -> _RingSpec:
    use_fused, bq, bk = _decide_fused(fused, S_local * ring.size, S_local,
                                      q.shape[-1], card_like(q))
    return _RingSpec(ring=ring, m=ring.size, causal=bool(causal),
                     window=None if window is None else int(window),
                     fused=use_fused, block_q=bq, block_k=bk)


def _apply(ring, q, k, v, S_local: int, *, causal, window, impl, fused):
    spec = _spec(ring, q, S_local, causal=causal, window=window, fused=fused)
    if impl == "naive":
        if not isinstance(ring, LocalRing):
            raise ValueError("impl='naive' differentiates through the "
                             "hops, which only a LocalRing can")
        return _naive(spec, q, k, v)
    if impl != "vjp":
        raise ValueError(f"ring_attention impl {impl!r} not in "
                         "('vjp', 'naive')")
    return RingAttention.apply(spec, q, k, v)


def _local_ring(mesh: Mesh | None, axis: str, q, k):
    """The axis's LocalRing where :func:`ring_attention` applies, else
    None."""
    if mesh is None:
        mesh = get_mesh()
    if mesh is None or axis not in mesh.axis_names or mesh.shape[axis] == 1:
        return None
    ring = mesh.transport(axis)
    if not isinstance(ring, LocalRing):
        raise NotImplementedError(
            f"ring_attention takes global tensors on a local ring; axis "
            f"{axis!r} is a {type(ring).__name__}: pass this rank's shards "
            f"to ring_attention_local")
    S = q.shape[1]
    if S % ring.size != 0 or k.shape[1] != S:
        return None
    return ring


def ring_attention(q, k, v, *, causal=True, window=None,
                   mesh: Mesh | None = None, axis: str = "model",
                   impl: str = "vjp", fused: bool | None = None):
    """Context-parallel attention on the ring of ``axis`` of ``mesh`` (the
    active mesh by default).

    q: (B, S, H, D); k/v: (B, S, Hkv, D) with H % Hkv == 0 (GQA), global
    tensors on one device.  Returns the (B, S, H, D) output, or None where
    the ring does not apply (no mesh, axis absent or of size 1, S does not
    divide the ring, cross-attention).  ``impl``: "vjp" (the memory-flat
    backward, the default) or "naive" (autograd through the fold: the
    baseline).  ``fused`` picks the flash kernels for each hop's fold in
    both passes (None: the flash policy; on the card by default).  An axis
    whose ranks are processes takes its shards through
    :func:`ring_attention_local`."""
    ring = _local_ring(mesh, axis, q, k)
    if ring is None:
        return None
    return _apply(ring, q, k, v, q.shape[1] // ring.size, causal=causal,
                  window=window, impl=impl, fused=fused)


def ring_attention_local(q_l, k_l, v_l, *, ring, causal=True, window=None,
                         impl: str = "vjp", fused: bool | None = None):
    """The per-rank body of :func:`ring_attention` under a ``ProcessRing``
    (the reference's shard_map body): q_l (B, S/m, H, D) and k_l / v_l
    (B, S/m, Hkv, D) are this rank's sequence shard; returns its rows of
    the output, differentiable through the same memory-flat backward."""
    return _apply(ring, q_l, k_l, v_l, q_l.shape[1], causal=causal,
                  window=window, impl=impl, fused=fused)
