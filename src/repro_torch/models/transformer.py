"""Decoder-only transformer (dense GQA and top-k MoE MLPs): training
forward and serving.

Counterpart of ``repro.models.transformer`` on one device, for qwen3-4b
(qk_norm), qwen2.5-14b / qwen1.5-32b (QKV bias), yi-9b, internvl2-26b
(vision-prefix backbone; the ViT frontend is a stub — ``vision_embeds``
arrive precomputed), and granite-moe and olmoe (MoE MLPs).  Layers are stacked on a leading axis, as in the
reference, unbound once per call and traversed with a Python loop.  Under
autograd ``forward`` checkpoints each layer, as the reference's default
``remat=True`` does: the backward recomputes the layer, flash forward
kernel included.

The caches and the page pool are written IN PLACE (``index_put_`` /
slice assignment): a functional copy of a 1.2 GB pool per layer and tick
would dominate a serving step on the card.  ``prefill``, ``decode_step``
and ``paged_step`` therefore return the very cache or pool they were
given, updated.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from repro_torch.device import resolve_device

from .layers import (MoEConfig, apply_rope, attention, decode_attention,
                     moe_layer, paged_decode_attention, seq_positions,
                     quantize_kv, rms_norm, swiglu, unstack)

# Serving-engine capability flags (see configs/base.py and
# serving/engine.py): prefill accepts ``true_lengths`` for length-bucketed
# padded prompts, the KV cache pages cleanly, and the pooled-cache slot
# layout is declared instead of assumed.
PREFILL_TRUE_LENGTHS = True
SUPPORTS_PAGED_KV = True
CACHE_BATCH_AXES = {"k": 1, "v": 1, "k_scale": 1, "v_scale": 1, "length": 0}


@dataclasses.dataclass(frozen=True)
class TransformerConfig:
    name: str
    n_layers: int
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    head_dim: int | None = None
    qk_norm: bool = False
    qkv_bias: bool = False
    rope_theta: float = 1e6
    norm_eps: float = 1e-6
    moe: MoEConfig | None = None
    window: int | None = None         # sliding-window attention (None = full)
    vision_tokens: int = 0            # VLM prefix length (stub frontend)
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"           # auto | xla | pallas (flash policy)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    def param_count(self) -> int:
        D, H, Kv, Dh, F, V, L = (self.d_model, self.n_heads, self.n_kv_heads,
                                 self.dh, self.d_ff, self.vocab, self.n_layers)
        attn = D * H * Dh + 2 * D * Kv * Dh + H * Dh * D
        if self.moe:
            mlp = D * self.moe.n_experts + \
                3 * self.moe.n_experts * D * self.moe.d_ff
        else:
            mlp = 3 * D * F
        return L * (attn + mlp + 2 * D) + 2 * V * D + D

    def active_param_count(self) -> int:
        """Per-token active params (MoE uses top_k experts)."""
        if not self.moe:
            return self.param_count()
        D, H, Kv, Dh, L = (self.d_model, self.n_heads, self.n_kv_heads,
                           self.dh, self.n_layers)
        attn = D * H * Dh + 2 * D * Kv * Dh + H * Dh * D
        mlp = D * self.moe.n_experts + 3 * self.moe.top_k * D * self.moe.d_ff
        return L * (attn + mlp + 2 * D) + 2 * self.vocab * D + D


def init_params(cfg: TransformerConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random weights (normal, std 0.02) drawn on ``device`` from
    ``generator`` (which must live on that device), in the reference's
    key names and stacked layout."""
    D, H, Kv, Dh, F, V, L = (cfg.d_model, cfg.n_heads, cfg.n_kv_heads, cfg.dh,
                             cfg.d_ff, cfg.vocab, cfg.n_layers)
    dt = cfg.dtype

    def nrm(shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)     # one f32 temporary, not two

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    layers: dict[str, torch.Tensor] = {
        "ln1": ones((L, D)),
        "ln2": ones((L, D)),
        "wq": nrm((L, D, H * Dh)),
        "wk": nrm((L, D, Kv * Dh)),
        "wv": nrm((L, D, Kv * Dh)),
        "wo": nrm((L, H * Dh, D)),
    }
    if cfg.qkv_bias:
        layers["bq"] = zeros((L, H * Dh))
        layers["bk"] = zeros((L, Kv * Dh))
        layers["bv"] = zeros((L, Kv * Dh))
    if cfg.qk_norm:
        layers["q_norm"] = ones((L, Dh))
        layers["k_norm"] = ones((L, Dh))
    if cfg.moe:
        E, Fe = cfg.moe.n_experts, cfg.moe.d_ff
        layers["router"] = nrm((L, D, E))
        layers["w_gate"] = nrm((L, E, D, Fe))
        layers["w_up"] = nrm((L, E, D, Fe))
        layers["w_down"] = nrm((L, E, Fe, D))
    else:
        layers["w_gate"] = nrm((L, D, F))
        layers["w_up"] = nrm((L, D, F))
        layers["w_down"] = nrm((L, F, D))
    return {
        "embed": nrm((V, D)),
        "layers": layers,
        "ln_f": ones((D,)),
        "lm_head": nrm((D, V)),
    }


def _qkv(cfg: TransformerConfig, lp: dict, x: torch.Tensor, positions):
    B, S, D = x.shape
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = x @ lp["wq"]
    k = x @ lp["wk"]
    v = x @ lp["wv"]
    if cfg.qkv_bias:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q = q.reshape(B, S, H, Dh)
    k = k.reshape(B, S, Kv, Dh)
    v = v.reshape(B, S, Kv, Dh)
    if cfg.qk_norm:
        q = rms_norm(q, lp["q_norm"], cfg.norm_eps)
        k = rms_norm(k, lp["k_norm"], cfg.norm_eps)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _mlp(cfg: TransformerConfig, lp: dict, x: torch.Tensor):
    """-> (the MLP's output, its aux loss: 0.0 for a dense MLP)."""
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    if cfg.moe:
        return moe_layer(h, lp, cfg.moe)
    return swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"]), 0.0


def _block_train(cfg: TransformerConfig, x: torch.Tensor, lp: dict,
                 positions: torch.Tensor):
    """-> (the layer's output, its MLP's aux loss)."""
    B, S, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    o = attention(q, k, v, causal=True, window=cfg.window,
                  impl=cfg.attn_impl)
    x = x + o.reshape(B, S, -1) @ lp["wo"]
    mo, aux = _mlp(cfg, lp, x)
    return x + mo, aux


def _embed(params: dict, tokens: torch.Tensor,
           vision_embeds: torch.Tensor | None) -> torch.Tensor:
    """Token embeddings, with a VLM's ``vision_embeds`` (B, P, D)
    prepended in the activations' dtype (the stub ViT)."""
    x = F.embedding(tokens, params["embed"])
    if vision_embeds is not None:
        x = torch.cat([vision_embeds.to(x.dtype), x], dim=1)
    return x


def forward(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            vision_embeds: torch.Tensor | None = None):
    """tokens: (B, S_text) int -> (logits (B, S, vocab), aux_loss): the MoE
    layers' aux losses summed (0.0 for a dense config).  For VLM configs,
    ``vision_embeds`` (B, P, D) is prepended (S = P + S_text).

    With grad enabled each layer runs under ``torch.utils.checkpoint``
    (the reference's ``remat``): only its input is kept, and the backward
    recomputes it, aux included; at full width nothing else fits beside
    the optimizer state.  (The reference also saves the attention output
    across the recompute; here the flash forward runs again.)"""
    x = _embed(params, tokens, vision_embeds)
    positions = seq_positions(x.shape[1], x.device)
    remat = torch.is_grad_enabled()
    aux = 0.0
    for lp in unstack(params["layers"]):
        if remat:
            x, a = checkpoint(_block_train, cfg, x, lp, positions,
                              use_reentrant=False)
        else:
            x, a = _block_train(cfg, x, lp, positions)
        aux = aux + a
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], aux


# ---------------------------------------------------------------------------
# KV-cache serving
# ---------------------------------------------------------------------------

def init_cache(cfg: TransformerConfig, batch: int, max_len: int,
               kv_dtype: torch.dtype | None = None,
               device: torch.device | str | None = None) -> dict:
    """Dense KV cache on ``device`` (default: the CUDA card; raises when
    there is none — pass ``device='cpu'``)."""
    device = resolve_device(device)
    kv_dtype = kv_dtype or cfg.dtype
    L, Kv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    cache = {
        "k": torch.zeros((L, batch, max_len, Kv, Dh), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((L, batch, max_len, Kv, Dh), dtype=kv_dtype,
                         device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }
    if kv_dtype == torch.int8:
        cache["k_scale"] = torch.zeros((L, batch, max_len, Kv),
                                       dtype=torch.float32, device=device)
        cache["v_scale"] = torch.zeros((L, batch, max_len, Kv),
                                       dtype=torch.float32, device=device)
    return cache


def prefill(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
            cache: dict, vision_embeds: torch.Tensor | None = None,
            true_lengths: torch.Tensor | None = None):
    """Run the prompt (after a VLM's ``vision_embeds`` prefix, when given)
    through the model, writing its K/V into ``cache`` in place.  Returns
    (logits_last (B, 1, vocab), cache).

    ``true_lengths`` (B,) supports length-BUCKETED prompts: tokens may be
    right-padded to a bucket size, and causality guarantees every position
    < true_lengths[b] is unaffected by the padding.  The cache length is
    set to the true length and the returned logits are taken at position
    ``true_lengths - 1`` (lengths that count the prefix)."""
    x = _embed(params, tokens, vision_embeds)
    B, S, _ = x.shape
    positions = seq_positions(S, x.device)
    quantized = cache["k"].dtype == torch.int8
    for i, lp in enumerate(unstack(params["layers"])):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        o = attention(q, k, v, causal=True, window=cfg.window,
                      impl=cfg.attn_impl)
        x = x + o.reshape(B, S, -1) @ lp["wo"]
        x = x + _mlp(cfg, lp, x)[0]
        if quantized:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            cache["k"][i, :, :S] = kq
            cache["v"][i, :, :S] = vq
            cache["k_scale"][i, :, :S] = ks
            cache["v_scale"][i, :, :S] = vs
        else:
            cache["k"][i, :, :S] = k.to(cache["k"].dtype)
            cache["v"][i, :, :S] = v.to(cache["v"].dtype)
    if true_lengths is None:
        cache["length"].fill_(S)
    else:
        cache["length"].copy_(true_lengths.to(torch.int32))
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    if true_lengths is None:
        last = x[:, -1:]
    else:
        idx = true_lengths.long() - 1
        last = x[torch.arange(B, device=x.device), idx][:, None]
    return last @ params["lm_head"], cache


def decode_step(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
                cache: dict):
    """tokens: (B, 1) -> (logits (B, 1, V), cache): one serving step that
    writes each slot's new K/V at its own length, in place."""
    x = F.embedding(tokens, params["embed"])
    B = x.shape[0]
    length = cache["length"]
    positions = length[:, None]
    rows = torch.arange(B, device=x.device)
    # idle slots keep counting past the end; their writes clamp to the last
    # row, as the reference's dynamic_update_slice does
    pos = torch.clamp(length.long(), max=cache["k"].shape[2] - 1)
    quantized = "k_scale" in cache
    for i, lp in enumerate(unstack(params["layers"])):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        kc, vc = cache["k"][i], cache["v"][i]
        if quantized:
            kq, ks = quantize_kv(k[:, 0])
            vq, vs = quantize_kv(v[:, 0])
            ksc, vsc = cache["k_scale"][i], cache["v_scale"][i]
            kc[rows, pos] = kq
            vc[rows, pos] = vq
            ksc[rows, pos] = ks
            vsc[rows, pos] = vs
            o = decode_attention(q, kc, vc, length + 1, ksc, vsc)
        else:
            kc[rows, pos] = k[:, 0].to(kc.dtype)
            vc[rows, pos] = v[:, 0].to(vc.dtype)
            o = decode_attention(q, kc, vc, length + 1)
        x = x + o.reshape(B, 1, -1) @ lp["wo"]
        x = x + _mlp(cfg, lp, x)[0]
    cache["length"] += 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], cache


# ---------------------------------------------------------------------------
# Paged KV serving (block-pool cache; see repro_torch.serving.kv)
# ---------------------------------------------------------------------------

def init_paged_pool(cfg: TransformerConfig, num_pages: int, page_size: int,
                    kv_dtype: torch.dtype | None = None,
                    device: torch.device | str | None = None) -> dict:
    """Global page-pool tensors for the paged serving path, on ``device``
    (resolved as in :func:`init_cache`).  Page 0 is the TRASH page
    (pad-token writes land there; never mapped to a slot)."""
    device = resolve_device(device)
    kv_dtype = kv_dtype or cfg.dtype
    L, Kv, Dh = cfg.n_layers, cfg.n_kv_heads, cfg.dh
    pool = {
        "k": torch.zeros((L, num_pages, page_size, Kv, Dh), dtype=kv_dtype,
                         device=device),
        "v": torch.zeros((L, num_pages, page_size, Kv, Dh), dtype=kv_dtype,
                         device=device),
    }
    if kv_dtype == torch.int8:
        pool["k_scale"] = torch.zeros((L, num_pages, page_size, Kv),
                                      dtype=torch.float32, device=device)
        pool["v_scale"] = torch.zeros((L, num_pages, page_size, Kv),
                                      dtype=torch.float32, device=device)
    return pool


def _trash_last_writer(phys: torch.Tensor, off: torch.Tensor,
                       page: int) -> torch.Tensor:
    """For each of a paged step's (B, T) K/V writes, the row-major index
    of the write whose value it stores: its own, or, on trash page 0, the
    last write to the same slot.  -> (B * T,) long."""
    phys, off = phys.reshape(-1), off.reshape(-1)
    order = torch.arange(phys.numel(), device=phys.device)
    trash = phys == 0
    key = torch.where(trash, off, page)        # live writes share slot page
    last = torch.full((page + 1,), -1, dtype=torch.long, device=phys.device)
    last.scatter_reduce_(0, key, order, reduce="amax")
    return torch.where(trash, last[key], order)


def paged_step(cfg: TransformerConfig, params: dict, tokens: torch.Tensor,
               pool: dict, page_table: torch.Tensor, lengths: torch.Tensor,
               counts: torch.Tensor):
    """One paged serving step: write T new tokens' K/V into the pool (in
    place) and attend against each slot's paged history.

    tokens: (B, T); counts: (B,) valid tokens per row (<= T; rows with
    count 0 are idle slots riding the step).  Rows are INDEPENDENT, so one
    call may mix prefill chunks and decode rows.  page_table: (B,
    max_pages_view) int32 physical page ids — a power-of-two slice of the
    engine's table covering the longest active slot.  lengths: (B,) int32
    tokens cached before this call; a row whose leading pages were mapped
    read-only from the prefix cache starts with lengths[b] == matched
    tokens and writes land in its first private page.  Pad/idle writes are
    routed to trash page 0.

    Returns (logits (B, T, vocab), pool, lengths + counts)."""
    x = F.embedding(tokens, params["embed"])
    B, T, _ = x.shape
    page = pool["k"].shape[2]
    MP = page_table.shape[1]
    ar_t = torch.arange(T, device=x.device)
    positions = lengths[:, None] + ar_t[None, :]                  # (B, T)
    valid = ar_t[None, :] < counts[:, None]
    lp_idx = torch.clamp(positions // page, 0, MP - 1).long()
    phys = torch.where(valid, torch.gather(page_table, 1, lp_idx), 0).long()
    off = (positions % page).long()
    quantized = "k_scale" in pool
    # the kernel path is decode-only; chunked prefill stays on the gather
    # path (its q block is the whole chunk, a different schedule)
    impl = cfg.attn_impl if T == 1 else "xla"
    # rows of one slot never collide (consecutive positions), distinct
    # slots own distinct pages, and every invalid token lands on trash
    # page 0, where writes collide.  The card stores colliding writes in
    # racing order.  No live row of a dense model reads the trash page,
    # but a MoE's capacity couples a call's rows, and pad and idle rows do
    # read it: there each colliding write carries its last writer's value,
    # so any order stores what an in-order scatter (the CPU's) stores.
    src = _trash_last_writer(phys, off, page) if cfg.moe else None

    def put(dst, val):
        if src is not None:
            val = val.reshape(B * T, *val.shape[2:])[src].reshape(val.shape)
        dst[phys, off] = val

    for i, lp in enumerate(unstack(params["layers"])):
        h = rms_norm(x, lp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, lp, h, positions)
        kc, vc = pool["k"][i], pool["v"][i]
        if quantized:
            kq, ks = quantize_kv(k)
            vq, vs = quantize_kv(v)
            ksc, vsc = pool["k_scale"][i], pool["v_scale"][i]
            put(kc, kq)
            put(vc, vq)
            put(ksc, ks)
            put(vsc, vs)
            o = paged_decode_attention(q, kc, vc, page_table, lengths,
                                       ksc, vsc, impl=impl)
        else:
            put(kc, k.to(kc.dtype))
            put(vc, v.to(vc.dtype))
            o = paged_decode_attention(q, kc, vc, page_table, lengths,
                                       impl=impl)
        x = x + o.reshape(B, T, -1) @ lp["wo"]
        x = x + _mlp(cfg, lp, x)[0]
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], pool, lengths + counts
