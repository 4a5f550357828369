"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local attention,
1:2.  Counterpart of ``repro.models.recurrentgemma`` on one device.

The block pattern repeats (recurrent, recurrent, local-attention); 38
layers = 12 full groups + 2 trailing recurrent blocks.  The RG-LRU is a
gated linear recurrence: the reference evaluates it with
``jax.lax.associative_scan`` over the sequence, the port with a log-depth
scan of the same combine (doubling passes over L), and decode takes one
state update.  Local attention is MQA (kv = 1, head_dim 256 at full width)
with a 2048-token sliding window: prefill goes through
``layers.attention`` (the flash forward kernel on the card, its CUDA-core
route at head_dim 256), decode through the plain ``decode_attention``
over a window-bounded ring cache.

``prefill`` and ``decode_step`` write the states and the ring cache into
the cache they are given, in place, and return it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from .layers import (apply_rope, attention, decode_attention, geglu, gelu,
                     rms_norm, seq_positions, unstack)

RG_LRU_C = 8.0

# Pooled-serving slot layout (see serving/engine.py _write_slot).  The
# grouped recurrent states carry batch at axis 2 — (G, 2, batch, ...).
CACHE_BATCH_AXES = {"conv_g": 2, "lru_g": 2, "k": 1, "v": 1,
                    "conv_t": 1, "lru_t": 1, "length": 0}


@dataclasses.dataclass(frozen=True)
class RGConfig:
    name: str
    n_layers: int                  # total blocks (38)
    d_model: int
    n_heads: int
    n_kv_heads: int
    d_ff: int
    vocab: int
    window: int = 2048
    conv_width: int = 4
    rope_theta: float = 1e4
    norm_eps: float = 1e-6
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"           # auto | xla | pallas (flash policy)

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads

    @property
    def lru_width(self) -> int:
        return self.d_model

    @property
    def n_groups(self) -> int:
        return self.n_layers // 3

    @property
    def n_tail_rec(self) -> int:
        return self.n_layers - 3 * self.n_groups

    def param_count(self) -> int:
        D, W, F_ = self.d_model, self.lru_width, self.d_ff
        H, Kv, Dh = self.n_heads, self.n_kv_heads, self.dh
        rec = 2 * D * W + self.conv_width * W + 2 * W * W + W + W * D + 2 * D
        attn = D * H * Dh + 2 * D * Kv * Dh + H * Dh * D + 2 * D
        mlp = 3 * D * F_
        n_rec = 2 * self.n_groups + self.n_tail_rec
        n_attn = self.n_groups
        return (n_rec * (rec + mlp) + n_attn * (attn + mlp)
                + 2 * self.vocab * D + D)


def init_params(cfg: RGConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random weights drawn on ``device`` from ``generator``, in the
    reference's key names and layout: ``rec_groups`` (G, 2, ...),
    ``attn_groups`` (G, ...), ``rec_tail`` (Tr, ...) or None when
    ``n_layers % 3 == 0``."""
    D, W, Ff = cfg.d_model, cfg.lru_width, cfg.d_ff
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    dt = cfg.dtype

    def nrm(shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)     # one f32 temporary, not two

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    def rec(lead):
        return {
            "ln1": ones((*lead, D)),
            "ln2": ones((*lead, D)),
            "w_x": nrm((*lead, D, W)),         # branch into conv + LRU
            "w_y": nrm((*lead, D, W)),         # gate branch (GeLU)
            "conv_w": nrm((*lead, cfg.conv_width, W), 0.2),
            "w_a": nrm((*lead, W, W)),         # recurrence gate
            "w_i": nrm((*lead, W, W)),         # input gate
            "lam": torch.full((*lead, W), 2.0, dtype=torch.float32,
                              device=device),  # Lambda (pre-softplus)
            "w_out": nrm((*lead, W, D)),
            "mlp_gate": nrm((*lead, D, Ff)),
            "mlp_up": nrm((*lead, D, Ff)),
            "mlp_down": nrm((*lead, Ff, D)),
        }

    G, Tr = cfg.n_groups, cfg.n_tail_rec
    return {
        "embed": nrm((cfg.vocab, D)),
        "rec_groups": rec((G, 2)),
        "attn_groups": {
            "ln1": ones((G, D)),
            "ln2": ones((G, D)),
            "wq": nrm((G, D, H * Dh)),
            "wk": nrm((G, D, Kv * Dh)),
            "wv": nrm((G, D, Kv * Dh)),
            "wo": nrm((G, H * Dh, D)),
            "mlp_gate": nrm((G, D, Ff)),
            "mlp_up": nrm((G, D, Ff)),
            "mlp_down": nrm((G, Ff, D)),
        },
        "rec_tail": rec((Tr,)) if Tr else None,
        "ln_f": ones((D,)),
        "lm_head": nrm((D, cfg.vocab)),
    }


def _groups(params: dict) -> list[tuple[list[dict], dict]]:
    """[(the two recurrent blocks' params, the attention block's)] per
    group."""
    return [(unstack(rec2), attn) for rec2, attn in
            zip(unstack(params["rec_groups"]),
                unstack(params["attn_groups"]))]


# ---------------------------------------------------------------------------
# RG-LRU
# ---------------------------------------------------------------------------

def _rg_lru_scan(x, r, i, lam):
    """x, r, i: (B, L, W); lam: (W,). h_t = a_t h_{t-1} + sqrt(1-a_t^2) i x.

    A log-depth (Hillis-Steele) scan of the reference's associative combine
    ``(a1, b1) . (a2, b2) = (a1 a2, a2 b1 + b2)``: after the pass of
    stride d, position t holds the combine of the 2d positions ending at t
    (fewer at the start), so ceil(log2 L) passes leave h_t in b."""
    log_a = -RG_LRU_C * F.softplus(lam) * r               # (B, L, W)
    a = torch.exp(log_a)
    b = torch.sqrt(torch.clamp(1.0 - a * a, min=0.0)) * (i * x)
    L, d = a.shape[1], 1
    while d < L:
        b = torch.cat([b[:, :d], a[:, d:] * b[:, :-d] + b[:, d:]], dim=1)
        a = torch.cat([a[:, :d], a[:, d:] * a[:, :-d]], dim=1)
        d *= 2
    return b


def _rec_mixer(cfg: RGConfig, lp: dict, x, conv_state=None, lru_state=None):
    """Griffin recurrent block mixer. x: (B, L, D); with ``conv_state`` /
    ``lru_state`` given, one decode step (L == 1).  -> (out, new conv
    state (B, cw - 1, W), new LRU state (B, W))."""
    B, L, _ = x.shape
    W = cfg.lru_width
    u = x @ lp["w_x"]                                  # (B, L, W)
    gate = gelu((x @ lp["w_y"]).float())
    conv_w = lp["conv_w"].float()                      # (cw, W)
    single_step = conv_state is not None

    if single_step:
        win = torch.cat([conv_state, u.float()], dim=1)
        new_conv = win[:, 1:]
        u = (win * conv_w[None]).sum(1)[:, None]       # (B, 1, W)
    else:
        pad = torch.zeros((B, cfg.conv_width - 1, W), dtype=torch.float32,
                          device=x.device)
        seq = torch.cat([pad, u.float()], dim=1)
        u = sum(seq[:, j:j + L] * conv_w[j][None, None]
                for j in range(cfg.conv_width))
        new_conv = seq[:, L:]

    uf = u.float()
    r = torch.sigmoid(torch.einsum("blw,wv->blv", uf, lp["w_a"].float()))
    ig = torch.sigmoid(torch.einsum("blw,wv->blv", uf, lp["w_i"].float()))
    lam = lp["lam"].float()

    if single_step:
        a = torch.exp(-RG_LRU_C * F.softplus(lam) * r[:, 0])
        h = a * lru_state + torch.sqrt(torch.clamp(1 - a * a, min=0.0)) * \
            (ig[:, 0] * uf[:, 0])
        new_lru = h
        h = h[:, None]
    else:
        h = _rg_lru_scan(uf, r, ig, lam)
        new_lru = h[:, -1]

    out = (h * gate).to(cfg.dtype) @ lp["w_out"]
    return out, new_conv, new_lru


def _mlp(cfg: RGConfig, lp: dict, x):
    h = rms_norm(x, lp["ln2"], cfg.norm_eps)
    return x + geglu(h, lp["mlp_gate"], lp["mlp_up"], lp["mlp_down"])


def _rec_block(cfg: RGConfig, lp: dict, x, conv_state=None, lru_state=None):
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    o, conv_s, lru_s = _rec_mixer(cfg, lp, h, conv_state, lru_state)
    return _mlp(cfg, lp, x + o), conv_s, lru_s


def _qkv(cfg: RGConfig, lp: dict, h, positions):
    B, L, _ = h.shape
    H, Kv, Dh = cfg.n_heads, cfg.n_kv_heads, cfg.dh
    q = (h @ lp["wq"]).reshape(B, L, H, Dh)
    k = (h @ lp["wk"]).reshape(B, L, Kv, Dh)
    v = (h @ lp["wv"]).reshape(B, L, Kv, Dh)
    q = apply_rope(q, positions, cfg.rope_theta)
    k = apply_rope(k, positions, cfg.rope_theta)
    return q, k, v


def _attn_block(cfg: RGConfig, lp: dict, x, positions):
    """The local-attention block over a whole sequence. -> (out, k, v)."""
    B, L, _ = x.shape
    h = rms_norm(x, lp["ln1"], cfg.norm_eps)
    q, k, v = _qkv(cfg, lp, h, positions)
    o = attention(q, k, v, causal=True, window=cfg.window,
                  impl=cfg.attn_impl)
    x = x + o.reshape(B, L, -1) @ lp["wo"]
    return _mlp(cfg, lp, x), k, v


def forward(cfg: RGConfig, params: dict, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, vocab), 0.0)."""
    x = F.embedding(tokens, params["embed"])
    positions = seq_positions(tokens.shape[1], x.device)
    for rec2, attnp in _groups(params):
        for lp in rec2:
            x = _rec_block(cfg, lp, x)[0]
        x = _attn_block(cfg, attnp, x, positions)[0]
    for lp in unstack(params["rec_tail"]):
        x = _rec_block(cfg, lp, x)[0]
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], 0.0


# ---------------------------------------------------------------------------
# Serving: window-bounded attention caches + O(1) recurrent state.
# ---------------------------------------------------------------------------

def init_cache(cfg: RGConfig, batch: int, max_len: int,
               kv_dtype: torch.dtype | None = None,
               device: torch.device | str | None = None) -> dict:
    """Recurrent states and a ring K/V cache of ``min(window, max_len)``
    slots on ``device`` (default: the CUDA card; raises when there is none
    — pass ``device='cpu'``)."""
    device = resolve_device(device)
    kv_dtype = kv_dtype or cfg.dtype
    G, Tr, W = cfg.n_groups, cfg.n_tail_rec, cfg.lru_width
    wlen = min(cfg.window, max_len)
    f32, cw = torch.float32, cfg.conv_width

    def zeros(shape, dtype=f32):
        return torch.zeros(shape, dtype=dtype, device=device)

    return {
        "conv_g": zeros((G, 2, batch, cw - 1, W)),
        "lru_g": zeros((G, 2, batch, W)),
        "k": zeros((G, batch, wlen, cfg.n_kv_heads, cfg.dh), kv_dtype),
        "v": zeros((G, batch, wlen, cfg.n_kv_heads, cfg.dh), kv_dtype),
        "conv_t": zeros((Tr, batch, cw - 1, W)),
        "lru_t": zeros((Tr, batch, W)),
        "length": zeros((batch,), torch.int32),
    }


def decode_step(cfg: RGConfig, params: dict, tokens: torch.Tensor,
                cache: dict):
    """tokens: (B, 1) -> (logits (B, 1, V), cache updated in place).  Each
    slot writes its new K/V at ring slot ``length % wlen`` and attends
    over ``min(length + 1, wlen)`` slots."""
    x = F.embedding(tokens, params["embed"])
    B = x.shape[0]
    length = cache["length"]
    positions = length[:, None]
    wlen = cache["k"].shape[2]
    rows = torch.arange(B, device=x.device)
    slots = (length % wlen).long()                     # per-slot ring write
    n_valid = torch.clamp(length + 1, max=wlen)
    for g, (rec2, attnp) in enumerate(_groups(params)):
        for j, lp in enumerate(rec2):
            x, cs, ls = _rec_block(cfg, lp, x, cache["conv_g"][g, j],
                                   cache["lru_g"][g, j])
            cache["conv_g"][g, j] = cs
            cache["lru_g"][g, j] = ls
        h = rms_norm(x, attnp["ln1"], cfg.norm_eps)
        q, k, v = _qkv(cfg, attnp, h, positions)
        kc, vc = cache["k"][g], cache["v"][g]
        kc[rows, slots] = k[:, 0].to(kc.dtype)
        vc[rows, slots] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, n_valid)
        x = _mlp(cfg, attnp, x + o.reshape(B, 1, -1) @ attnp["wo"])
    for t, lp in enumerate(unstack(params["rec_tail"])):
        x, cs, ls = _rec_block(cfg, lp, x, cache["conv_t"][t],
                               cache["lru_t"][t])
        cache["conv_t"][t] = cs
        cache["lru_t"][t] = ls
    cache["length"] += 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], cache


def prefill(cfg: RGConfig, params: dict, tokens: torch.Tensor, cache: dict):
    """The forward pass, leaving each recurrent block's final states and
    each attention block's last ``wlen`` keys (in their ring slots, ``pos %
    wlen``, the rest zero) in ``cache``, in place.  Returns (last-token
    logits (B, 1, V), cache)."""
    x = F.embedding(tokens, params["embed"])
    L = tokens.shape[1]
    positions = seq_positions(L, x.device)
    wlen = cache["k"].shape[2]
    take = min(L, wlen)
    slots = (torch.arange(take, device=x.device) + max(0, L - take)) % wlen
    for g, (rec2, attnp) in enumerate(_groups(params)):
        for j, lp in enumerate(rec2):
            x, cs, ls = _rec_block(cfg, lp, x)
            cache["conv_g"][g, j] = cs
            cache["lru_g"][g, j] = ls
        x, k, v = _attn_block(cfg, attnp, x, positions)
        for name, new in (("k", k), ("v", v)):
            ring = cache[name][g]
            ring.zero_()
            ring[:, slots] = new[:, -take:].to(ring.dtype)
    for t, lp in enumerate(unstack(params["rec_tail"])):
        x, cs, ls = _rec_block(cfg, lp, x)
        cache["conv_t"][t] = cs
        cache["lru_t"][t] = ls
    cache["length"].fill_(L)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x[:, -1:] @ params["lm_head"], cache
