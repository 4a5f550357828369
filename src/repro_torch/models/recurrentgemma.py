"""RecurrentGemma / Griffin (arXiv:2402.19427): RG-LRU + local attention,
1:2.  Counterpart of ``repro.models.recurrentgemma`` on one device.

The block pattern repeats (recurrent, recurrent, local-attention); 38
layers = 12 full groups + 2 trailing recurrent blocks.  The RG-LRU is a
gated linear recurrence: the reference evaluates it with
``jax.lax.associative_scan`` over the sequence, the port with a log-depth
scan of the same combine (doubling passes over L), and decode takes one
state update.  Local attention is MQA (kv = 1, head_dim 256 at full width)
with a 2048-token sliding window: prefill and training go through
``layers.attention`` (on the card the flash forward's head_dim-256 wgmma
route, and the CUDA-core backward pair at head_dim 256), decode through
the plain ``decode_attention`` over a window-bounded ring cache.  Under
autograd ``forward`` checkpoints each (rec, rec, attn) group and each tail
layer, as the reference does.

``prefill`` and ``decode_step`` write the states and the ring cache into
the cache they are given, in place, and return it.

On a state placed by ``parallel.sharding.shard_tree`` (``param_specs``:
``w_x`` / ``w_y`` cut on W, ``w_a`` / ``w_i`` on their output W, ``w_out``
on its rows, the MLPs column / column / row, the attention as the
transformer's, ``lam`` and ``conv_w`` replicated) the same entry points run
tensor parallelism over the ``model`` axis (``parallel.tensor_parallel``).
The RG-LRU is elementwise over W, so a rank owns a W / m slice: it
convolves its slice of u with its slice of ``conv_w``, but its slices of
the gates r and i take the whole conv output (``w_a`` and ``w_i`` keep
every input row), which is all-gathered over the axis first; it runs the
scan on its slice, gates it with its slice of the GeLU branch and
multiplies its rows of ``w_out``, and the partials are summed.  The local
attention is MQA: the one kv head does not split, so the ranks gather the
k / v projections (``layers.head_plan``) and each attends with its q heads.
The vocabulary-parallel embedding; ``forward`` returns
``tensor_parallel.VocabShards``, the serving steps the logits gathered
whole.  A placed cache holds the recurrent states cut on W and the window
ring cut as the transformer's cache (its one kv head's head_dim over the
axis where it divides; decode gathers it, ``layers.kv_views``).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import Placed

from .layers import (add_partials, apply_rope, attention, attn_out_parts,
                     decode_attention, expand_views, gather_seq, geglu,
                     gelu, head_plan, heads_of, kv_cut, kv_heads_of, kv_of,
                     kv_values, kv_views, logits_placed, project_placed,
                     remat_call, rms_norm, rms_norm_seq, seq_positions,
                     shard_seq, unstack)

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
    remat: bool = True                # per-unit activation checkpointing
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
    u = x @ lp["w_x"]                                  # (B, L, W)
    gate = gelu((x @ lp["w_y"]).float())
    uf, new_conv = _conv(cfg, lp["conv_w"], u, conv_state)
    r = torch.sigmoid(torch.einsum("blw,wv->blv", uf, lp["w_a"].float()))
    ig = torch.sigmoid(torch.einsum("blw,wv->blv", uf, lp["w_i"].float()))
    h, new_lru = _lru(uf, r, ig, lp["lam"], lru_state)
    out = (h * gate).to(cfg.dtype) @ lp["w_out"]
    return out, new_conv, new_lru


def _conv(cfg: RGConfig, conv_w, u, conv_state=None):
    """The causal depthwise conv of u (B, L, C) over its C channels
    (``conv_w`` (cw, C)); with ``conv_state`` one decode step.  -> (the
    conv output f32, the new conv state (B, cw - 1, C))."""
    B, L, C = u.shape
    conv_w = conv_w.float()                            # (cw, C)
    if conv_state is not None:
        win = torch.cat([conv_state, u.float()], dim=1)
        return (win * conv_w[None]).sum(1)[:, None], win[:, 1:]
    pad = torch.zeros((B, cfg.conv_width - 1, C), dtype=torch.float32,
                      device=u.device)
    seq = torch.cat([pad, u.float()], dim=1)
    out = sum(seq[:, j:j + L] * conv_w[j][None, None]
              for j in range(cfg.conv_width))
    return out, seq[:, L:]


def _lru(uf, r, ig, lam, lru_state=None):
    """The RG-LRU over the channels of uf, r, ig (B, L, C) with ``lam``
    (C,); with ``lru_state`` one decode step.  -> (h (B, L, C), the new
    state (B, C))."""
    lam = lam.float()
    if lru_state is None:
        h = _rg_lru_scan(uf, r, ig, lam)
        return h, h[:, -1]
    a = torch.exp(-RG_LRU_C * F.softplus(lam) * r[:, 0])
    h = a * lru_state + torch.sqrt(torch.clamp(1 - a * a, min=0.0)) * \
        (ig[:, 0] * uf[:, 0])
    return h[:, None], h


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


def _group_train(cfg: RGConfig, x, rec2: list[dict], attnp: dict,
                 positions):
    """One (rec, rec, attn) group over a whole sequence."""
    for lp in rec2:
        x = _rec_block(cfg, lp, x)[0]
    return _attn_block(cfg, attnp, x, positions)[0]


def _tail_train(cfg: RGConfig, x, lp: dict):
    return _rec_block(cfg, lp, x)[0]


def forward(cfg: RGConfig, params: dict, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, vocab), 0.0).  With grad enabled
    each group and each tail layer runs under ``torch.utils.checkpoint``
    (:func:`layers.remat_call`), the reference's units.  On a placed state
    the logits come back as each model rank's vocab range (module
    docstring)."""
    if placed(params):
        return _forward_placed(cfg, params, tokens)
    x = F.embedding(tokens, params["embed"])
    positions = seq_positions(tokens.shape[1], x.device)
    for rec2, attnp in _groups(params):
        x = remat_call(_group_train, cfg, x, rec2, attnp,
                       positions, remat=cfg.remat)
    for lp in unstack(params["rec_tail"]):
        x = remat_call(_tail_train, cfg, x, lp, remat=cfg.remat)
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
    over ``min(length + 1, wlen)`` slots.  A placed cache on a placed
    state (module docstring)."""
    if placed(params):
        return _decode_step_placed(cfg, params, tokens, cache)
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
    logits (B, 1, V), cache).  A placed cache on a placed state (module
    docstring)."""
    if placed(params):
        return _prefill_placed(cfg, params, tokens, cache)
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


# ---------------------------------------------------------------------------
# Tensor parallelism on a placed state (module docstring)
# ---------------------------------------------------------------------------

def placed(params: dict) -> bool:
    """Whether ``params`` were placed by ``parallel.sharding.shard_tree``."""
    return isinstance(params.get("embed"), Placed)


def _tp(cfg: RGConfig, params: dict):
    """(the model axis's ring, the attention's head plan over it)."""
    ring = tp.model_ring(params["embed"].mesh)
    return ring, head_plan(cfg.n_heads, cfg.n_kv_heads, cfg.dh, ring.size)


def _rec_mixer_placed(cfg: RGConfig, lp: dict, xs: list, ring,
                      conv_states=None, lru_states=None):
    """:func:`_rec_mixer` on a placed block from each rank's input ``xs``
    (:func:`layers.gather_seq`): each rank's W slice (module docstring);
    ``conv_states`` / ``lru_states`` each rank's (decode).  -> (each
    rank's partial output, its new conv state, its new LRU state)."""
    idx = ring.index()
    W = cfg.lru_width
    cws = tp.copy_to_model(lp["conv_w"].at(), ring)
    lams = tp.copy_to_model(lp["lam"].at(), ring)
    cuts = [tp.vocab_range(W, ring.size, r) for r in idx]
    us, gates, convs = [], [], []
    for i, (r, (lo, hi)) in enumerate(zip(idx, cuts)):
        u = xs[i] @ lp["w_x"].at(model=r)
        gates.append(gelu((xs[i] @ lp["w_y"].at(model=r)).float()))
        uf, conv = _conv(cfg, cws[i][:, lo:hi], u,
                         None if conv_states is None else conv_states[i])
        us.append(uf)
        convs.append(conv)
    whole = tp.gather_to_model(us, ring, -1)
    outs, lrus = [], []
    for i, (r, (lo, hi)) in enumerate(zip(idx, cuts)):
        r_ = torch.sigmoid(torch.einsum("blw,wv->blv", whole[i],
                                        lp["w_a"].at(model=r).float()))
        ig = torch.sigmoid(torch.einsum("blw,wv->blv", whole[i],
                                        lp["w_i"].at(model=r).float()))
        h, lru = _lru(us[i], r_, ig, lams[i][lo:hi],
                      None if lru_states is None else lru_states[i])
        outs.append((h * gates[i]).to(cfg.dtype) @ lp["w_out"].at(model=r))
        lrus.append(lru)
    return outs, convs, lrus


def _mlp_placed(cfg: RGConfig, lp: dict, x, ring):
    """:func:`_mlp` column- then row-parallel, in ``x``'s layout."""
    hs = gather_seq(rms_norm_seq(x, lp["ln2"], ring, cfg.norm_eps), ring)
    parts = [geglu(h_r, lp["mlp_gate"].at(model=r), lp["mlp_up"].at(model=r),
                   lp["mlp_down"].at(model=r))
             for r, h_r in zip(ring.index(), hs)]
    return add_partials(x, parts, ring)


def _rec_block_placed(cfg: RGConfig, lp: dict, x, ring, conv_states=None,
                      lru_states=None):
    """:func:`_rec_block` on a placed block, in ``x``'s layout: the
    normed input all-gathered at the block's entry (the reference's
    ``gather_seq``), each row-parallel sum reduce-scattered onto a
    sequence-sharded ``x``."""
    hs = gather_seq(rms_norm_seq(x, lp["ln1"], ring, cfg.norm_eps), ring)
    outs, convs, lrus = _rec_mixer_placed(cfg, lp, hs, ring, conv_states,
                                          lru_states)
    return _mlp_placed(cfg, lp, add_partials(x, outs, ring), ring), \
        convs, lrus


def _qkv_placed(cfg: RGConfig, lp: dict, hs: list, positions, ring, plan,
                all_kv: bool = False):
    """Each rank's (q, k, v), rotated, from its input ``hs``: q its heads,
    k / v its kv heads (or every kv head with ``all_kv``, the serving
    writes), from the projections all-gathered where a head straddles
    ranks."""
    q = project_placed(hs, lp["wq"], ring, plan.gather_q)
    k = project_placed(hs, lp["wk"], ring, plan.gather_kv)
    v = project_placed(hs, lp["wv"], ring, plan.gather_kv)
    res = []
    for i, r in enumerate(ring.index()):
        qr = heads_of(plan, r, q[i], plan.gather_q)
        kr, vr = (kv_heads_of(plan, r, t[i], plan.gather_kv, all_kv)
                  for t in (k, v))
        res.append((apply_rope(qr, positions, cfg.rope_theta),
                    apply_rope(kr, positions, cfg.rope_theta), vr))
    return res


def _attn_block_placed(cfg: RGConfig, lp: dict, x, positions, ring, plan,
                       all_kv: bool = False):
    """:func:`_attn_block` on a placed block, in ``x``'s layout: each
    rank's q heads through the flash path (``ring="off"``: the ranks
    split heads) over the gathered whole sequence.  -> (out, each rank's
    k, v: its kv heads, or every kv head with ``all_kv``)."""
    hs = gather_seq(rms_norm_seq(x, lp["ln1"], ring, cfg.norm_eps), ring)
    qkv = _qkv_placed(cfg, lp, hs, positions, ring, plan, all_kv)
    outs = [attention(q, kv_of(plan, r, k, all_kv), kv_of(plan, r, v, all_kv),
                      causal=True, window=cfg.window, impl=cfg.attn_impl,
                      ring="off")
            for r, (q, k, v) in zip(ring.index(), qkv)]
    x = add_partials(x, attn_out_parts(lp["wo"], plan, ring, outs), ring)
    return _mlp_placed(cfg, lp, x, ring), [(k, v) for _, k, v in qkv]


def _group_train_placed(cfg: RGConfig, x, rec2: list[dict], attnp: dict,
                        positions, ring, plan):
    for lp in rec2:
        x = _rec_block_placed(cfg, lp, x, ring)[0]
    return _attn_block_placed(cfg, attnp, x, positions, ring, plan)[0]


def _tail_train_placed(cfg: RGConfig, x, lp: dict, ring):
    return _rec_block_placed(cfg, lp, x, ring)[0]


def _logits(cfg: RGConfig, params: dict, x, ring) -> list:
    return logits_placed(rms_norm_seq(x, params["ln_f"], ring, cfg.norm_eps),
                         params["lm_head"], ring)


def _forward_placed(cfg: RGConfig, params: dict, tokens: torch.Tensor):
    """:func:`forward` on a placed state: the residual between the units
    each rank's rows of the sequence where the model axis divides it
    (``layers.shard_seq``), as the reference's groups and tail layers
    return it."""
    ring, plan = _tp(cfg, params)
    x = shard_seq(tp.vocab_embed_parts(tokens, params["embed"], ring), ring)
    positions = seq_positions(tokens.shape[1], tokens.device)
    for rec2, attnp in _groups(params):
        x = remat_call(_group_train_placed, cfg, x, rec2, attnp, positions,
                       ring, plan, remat=cfg.remat)
    for lp in unstack(params["rec_tail"]):
        x = remat_call(_tail_train_placed, cfg, x, lp, ring,
                       remat=cfg.remat)
    return tp.VocabShards(_logits(cfg, params, x, ring), ring,
                          cfg.vocab), 0.0


def _state_shards(cache: dict, name: str, ring, *index) -> list:
    """Each held rank's shard of a placed recurrent state at ``index``."""
    return [cache[name].at(model=r)[index] for r in ring.index()]


def _rec_step_placed(cfg: RGConfig, lp: dict, x, cache: dict, ring,
                     conv: str, lru: str, index: tuple, decode: bool):
    """A placed recurrent block over the sequence (``decode``: one step
    from the states) whose new states land in the cache's ``conv`` /
    ``lru`` shards at ``index``."""
    cs = _state_shards(cache, conv, ring, *index)
    ls = _state_shards(cache, lru, ring, *index)
    x, convs, lrus = _rec_block_placed(cfg, lp, x, ring,
                                       cs if decode else None,
                                       ls if decode else None)
    for dst, src in zip(cs + ls, convs + lrus):
        dst.copy_(src)
    return x


def _prefill_placed(cfg: RGConfig, params: dict, tokens: torch.Tensor,
                    cache: dict):
    """:func:`prefill` on a placed state and cache."""
    ring, plan = _tp(cfg, params)
    idx = ring.index()
    cut = kv_cut(cache["k"])
    x = tp.vocab_embed(tokens, params["embed"], ring)
    L = tokens.shape[1]
    positions = seq_positions(L, x.device)
    wlen = cache["k"].shape[2]
    take = min(L, wlen)
    slots = (torch.arange(take, device=x.device) + max(0, L - take)) % wlen
    for g, (rec2, attnp) in enumerate(_groups(params)):
        for j, lp in enumerate(rec2):
            x = _rec_step_placed(cfg, lp, x, cache, ring, "conv_g", "lru_g",
                                 (g, j), decode=False)
        x, kvs = _attn_block_placed(cfg, attnp, x, positions, ring, plan,
                                    all_kv=cut != "heads")
        for r, (k, v) in zip(idx, kvs):
            for n, new in kv_values(cache, k, v, r, cut, ring).items():
                dst = cache[n].at(model=r)[g]
                dst.zero_()
                dst[:, slots] = new[:, -take:]
    for t, lp in enumerate(unstack(params["rec_tail"])):
        x = _rec_step_placed(cfg, lp, x, cache, ring, "conv_t", "lru_t",
                             (t,), decode=False)
    cache["length"].at().fill_(L)
    logits = _logits(cfg, params, x[:, -1:], ring)
    return tp.gather_from_model(logits, ring, -1), cache


def _decode_step_placed(cfg: RGConfig, params: dict, tokens: torch.Tensor,
                        cache: dict):
    """:func:`decode_step` on a placed state and cache."""
    ring, plan = _tp(cfg, params)
    idx = ring.index()
    cut = kv_cut(cache["k"])
    x = tp.vocab_embed(tokens, params["embed"], ring)
    B = x.shape[0]
    length = cache["length"].at()
    positions = length[:, None]
    wlen = cache["k"].shape[2]
    rows = torch.arange(B, device=x.device)
    slots = (length % wlen).long()
    n_valid = torch.clamp(length + 1, max=wlen)
    for g, (rec2, attnp) in enumerate(_groups(params)):
        for j, lp in enumerate(rec2):
            x = _rec_step_placed(cfg, lp, x, cache, ring, "conv_g", "lru_g",
                                 (g, j), decode=True)
        hs = gather_seq(rms_norm_seq(x, attnp["ln1"], ring, cfg.norm_eps),
                        ring)
        qkv = _qkv_placed(cfg, attnp, hs, positions, ring, plan,
                          all_kv=cut != "heads")
        for r, (_, k, v) in zip(idx, qkv):
            for n, new in kv_values(cache, k, v, r, cut, ring).items():
                cache[n].at(model=r)[g][rows, slots] = new[:, 0]
        outs = []
        for r, (q, _, _), pg in zip(idx, qkv, kv_views(cache, g, ring, plan,
                                                      cut)):
            pg = expand_views(plan, r, pg)
            outs.append(decode_attention(q, pg["k"], pg["v"], n_valid))
        x = add_partials(x, attn_out_parts(attnp["wo"], plan, ring, outs),
                         ring)
        x = _mlp_placed(cfg, attnp, x, ring)
    for t, lp in enumerate(unstack(params["rec_tail"])):
        x = _rec_step_placed(cfg, lp, x, cache, ring, "conv_t", "lru_t",
                             (t,), decode=True)
    length += 1
    logits = _logits(cfg, params, x, ring)
    return tp.gather_from_model(logits, ring, -1), cache
