"""Shared neural layers (plain functions over tensors and param dicts).

Counterpart of ``repro.models.layers`` for the model zoo (the GQA decoder
and its top-k MoE MLP, Mamba-2, RecurrentGemma, Whisper), on one device
(no mesh):

  * params are plain dicts of tensors; layer stacks carry a leading layer
    axis.
  * activations default to bf16; params bf16; accumulations f32.
  * attention is grouped (GQA) with causal and sliding-window masks.  The
    plain PyTorch paths mirror the reference's XLA paths; the hand-written
    CUDA kernels (:mod:`repro_torch.kernels`) are the card's path, chosen
    by the flash policy (``configs.base``).

No ring path yet; ``shard_seq`` / ``gather_seq`` are left out because
they are no-ops without a mesh.
"""
from __future__ import annotations

import dataclasses
import math

import torch
import torch.nn.functional as F

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


def _flash_pallas(q, k, v, *, causal, window):
    """The trainable flash kernels on (B, S, H, D) activations: the
    transposes are views, read by the kernels through their strides.  Under
    autograd the call goes through ``FlashAttention`` (forward kernel, then
    the dq and dk/dv kernels in backward); on the CPU, through the same
    Function's plain halves."""
    from repro_torch.kernels import ops as kops
    o = kops.flash_attention(q.transpose(1, 2), k.transpose(1, 2),
                             v.transpose(1, 2), causal=causal, window=window)
    return o.transpose(1, 2)


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


def attention(q, k, v, *, causal=True, window=None, impl=None,
              full_threshold: int = 2048, q_offset: int = 0):
    """Dispatch: the trainable hand-written flash kernels when the flash
    policy picks them (on CUDA: ``auto`` at max(S, Sk) >= min_seq, or
    forced), else the full-mask path for short sequences and the
    double-blocked online softmax for long ones.  ``impl`` overrides the
    policy ('pallas' | 'xla'; None / 'auto' resolves via
    REPRO_FLASH_ATTN).  q: (B, S, H, D); k/v: (B, Sk, Hkv, D)."""
    if impl not in (None, "auto", "pallas", "xla"):
        raise ValueError(f"attention impl {impl!r} not in "
                         "(None, 'auto', 'pallas', 'xla')")
    mode = _flash_mode(q.shape[1], k.shape[1],
                       None if impl in (None, "auto") else impl,
                       on_cuda=q.is_cuda)
    # the kernel masks in local positions; offset callers (chunked q
    # against a longer kv) stay on the plain paths, which honor q_offset
    if mode == "pallas" and q_offset == 0:
        return _flash_pallas(q, k, v, causal=causal, window=window)
    if max(q.shape[1], k.shape[1]) > full_threshold:
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
        impl = "pallas" if q.is_cuda else "xla"
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


def moe_layer(x: torch.Tensor, params: dict,
              cfg: MoEConfig) -> tuple[torch.Tensor, torch.Tensor]:
    """x: (B, S, D); params: router (D, E), w_gate/w_up (E, D, F),
    w_down (E, F, D). Returns (out, aux_loss).

    Always the local capacity dispatch: the port has no mesh.  The
    reference's expert-parallel and TP-in-expert branches come with the
    multi-card slice (ROADMAP queue 1, item 8)."""
    return _moe_local(x, params, cfg)
