"""Mamba-2 (SSD — state-space duality, arXiv:2405.21060): counterpart of
``repro.models.mamba2`` on one device.

The SSD chunked form is a chain of dense GEMMs (the intra-chunk quadratic
block and the low-rank inter-chunk state passing); the reference scans
over chunks with ``jax.lax.scan``, the port loops over the chunks (never
over positions).  Sub-quadratic in sequence length.  Decode keeps O(1)
state (conv window + SSM state).  Every op here is plain PyTorch, as the
reference's is XLA code: no Pallas kernel runs in this family.

``prefill`` and ``decode_step`` write the states into the cache they are
given, in place, and return it (as the transformer's serving steps do).

On a state placed by ``parallel.sharding.shard_tree`` (``param_specs``:
``in_proj`` cut on its output columns, ``out_proj`` on its rows, the conv
and SSM parameters and ``gnorm`` replicated) the same entry points run
tensor parallelism over the ``model`` axis (``parallel.tensor_parallel``),
a rank owning the heads its rows of ``out_proj`` touch
(``layers.head_plan`` over Din = H x P: whole heads when the axis divides
H).  The even column cut of ``in_proj`` does not line up with its z | xBC
| dt boundaries, so its output is all-gathered over the axis first
(``gather_to_model``); each rank then takes its heads' z, x and dt and the
whole B and C, runs the depthwise conv on those channels (B and C on
every rank) and the SSD scan over its heads.  ``gnorm``'s RMS is over the
whole Din: each rank's sum of squares over its own features, summed over
the axis (``reduce_from_model``, f32).  Each rank multiplies its rows of
``out_proj`` and the partials are summed.  The vocabulary-parallel
embedding; ``forward`` returns ``tensor_parallel.VocabShards``, the serving
steps the logits gathered whole.  A placed cache holds the SSM state cut
on its heads where the axis divides H (else whole, each rank reading and
writing its heads), the conv window whole (each rank its channels).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import Placed

from .layers import (add_partials, gather_seq, head_plan, logits_placed,
                     remat_call, rms_norm, rms_norm_seq, shard_seq, unstack)

# Pooled-serving slot layout (see serving/engine.py _write_slot): batch axis
# of every cache entry.  SSM state caches are position-free, so padded
# prefill would corrupt them — no PREFILL_TRUE_LENGTHS here.
CACHE_BATCH_AXES = {"conv": 1, "ssm": 1, "length": 0}


@dataclasses.dataclass(frozen=True)
class Mamba2Config:
    name: str
    n_layers: int
    d_model: int
    vocab: int
    d_state: int = 128
    d_conv: int = 4
    expand: int = 2
    headdim: int = 64
    chunk: int = 128
    remat: bool = True                # per-layer activation checkpointing
    # the reference's sequence parallelism (placed state only), off by
    # default as there: d_model 1024 leaves small per-rank shards
    sp: bool = False
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16

    @property
    def d_inner(self) -> int:
        return self.expand * self.d_model

    @property
    def n_heads(self) -> int:
        return self.d_inner // self.headdim

    @property
    def d_xbc(self) -> int:
        return self.d_inner + 2 * self.d_state

    def param_count(self) -> int:
        D, Din, N, L = self.d_model, self.d_inner, self.d_state, self.n_layers
        in_proj = D * (2 * Din + 2 * N + self.n_heads)
        conv = self.d_xbc * self.d_conv
        out = Din * D
        per_layer = in_proj + conv + out + 2 * self.n_heads + Din + 2 * D
        return L * per_layer + 2 * self.vocab * D + D


def init_params(cfg: Mamba2Config, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random weights drawn on ``device`` from ``generator``, in the
    reference's key names and stacked layout."""
    D, Din, N, H, L = (cfg.d_model, cfg.d_inner, cfg.d_state, cfg.n_heads,
                       cfg.n_layers)
    dt = cfg.dtype

    def nrm(shape, scale=0.02):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(scale).to(dt)     # one f32 temporary, not two

    def full(shape, value, dtype=dt):
        return torch.full(shape, value, dtype=dtype, device=device)

    a_log = torch.log(torch.arange(1, H + 1, dtype=torch.float32,
                                   device=device))
    layers = {
        "ln": full((L, D), 1.0),
        "in_proj": nrm((L, D, 2 * Din + 2 * N + H)),
        "conv_w": nrm((L, cfg.d_conv, cfg.d_xbc), 0.2),
        "conv_b": full((L, cfg.d_xbc), 0.0),
        "A_log": a_log.repeat(L, 1),
        "dt_bias": full((L, H), 0.0, torch.float32),
        "D_skip": full((L, H), 1.0, torch.float32),
        "gnorm": full((L, Din), 1.0),
        "out_proj": nrm((L, Din, D)),
    }
    return {
        "embed": nrm((cfg.vocab, D)),
        "layers": layers,
        "ln_f": full((D,), 1.0),
        "lm_head": nrm((D, cfg.vocab)),
    }


def _ssd_chunked(x, dt, A, Bm, Cm, chunk: int):
    """Chunked SSD scan.

    x: (B, L, H, P); dt: (B, L, H) (post-softplus); A: (H,) negative;
    Bm, Cm: (B, L, N). Returns y: (B, L, H, P) in f32.
    """
    B, L, H, P = x.shape
    N = Bm.shape[-1]
    if L % chunk:
        # pad with dt=0 steps: decay exp(0)=1 and zero state contribution,
        # so padding is exact; the padded rows are sliced off below.
        pad = chunk - L % chunk
        x = F.pad(x, (0, 0, 0, 0, 0, pad))
        dt = F.pad(dt, (0, 0, 0, pad))
        Bm = F.pad(Bm, (0, 0, 0, pad))
        Cm = F.pad(Cm, (0, 0, 0, pad))
    Lp = x.shape[1]
    T = Lp // chunk
    xc = x.float().reshape(B, T, chunk, H, P)
    dtc = dt.reshape(B, T, chunk, H)
    Bc = Bm.float().reshape(B, T, chunk, N)
    Cc = Cm.float().reshape(B, T, chunk, N)

    a_cum = torch.cumsum(dtc * A, dim=2)            # within-chunk cumsum
    a_tot = a_cum[:, :, -1]                         # (B, T, H)
    idx = torch.arange(chunk, device=x.device)
    causal = (idx[:, None] >= idx[None, :])[None, :, :, None]

    S = torch.zeros((B, H, P, N), dtype=torch.float32, device=x.device)
    ys = []
    for t in range(T):
        xq, dtq, Bq, Cq = xc[:, t], dtc[:, t], Bc[:, t], Cc[:, t]
        acum, atot = a_cum[:, t], a_tot[:, t]
        # intra-chunk (the "diag block" GEMM of SSD).  Mask the EXPONENT,
        # not just the product: non-causal entries have positive log-decay
        # sums that overflow exp to inf, and where(causal, inf, 0)
        # back-propagates inf * 0 = NaN into acum.
        diff = acum[:, :, None, :] - acum[:, None, :, :]           # (B,Q,Q,H)
        Lmat = torch.where(causal, torch.exp(torch.where(causal, diff, 0.0)),
                           0.0)
        scores = torch.einsum("bin,bjn->bij", Cq, Bq)               # (B,Q,Q)
        w = scores[..., None] * Lmat * dtq[:, None, :, :]           # (B,Q,Q,H)
        y_diag = torch.einsum("bijh,bjhp->bihp", w, xq)
        # contribution of the carried state (the "low-rank" block):
        y_off = torch.einsum("bin,bhpn->bihp", Cq, S) * \
            torch.exp(acum)[..., None]
        # new chunk-final state
        decay_to_end = torch.exp(atot[:, None, :] - acum)           # (B,Q,H)
        Sc = torch.einsum("bjn,bjh,bjhp->bhpn", Bq, decay_to_end * dtq, xq)
        S = torch.exp(atot)[..., None, None] * S + Sc
        ys.append(y_diag + y_off)
    y = torch.stack(ys, dim=1).reshape(B, Lp, H, P)
    return y[:, :L]


def _split_proj(cfg: Mamba2Config, zxbcdt):
    Din = cfg.d_inner
    z = zxbcdt[..., :Din]
    xbc = zxbcdt[..., Din:Din + cfg.d_xbc]
    dt = zxbcdt[..., Din + cfg.d_xbc:]
    return z, xbc, dt


def _conv_seq(cfg: Mamba2Config, conv_w: torch.Tensor,
              conv_b: torch.Tensor, xbc: torch.Tensor):
    """Causal depthwise conv over a whole sequence of C channels (``conv_w``
    (d_conv, C), ``conv_b`` (C,)), then SiLU.  -> (activations (B, L, C)
    f32, the last d_conv - 1 inputs)."""
    B, L, C = xbc.shape
    pad = torch.zeros((B, cfg.d_conv - 1, C), dtype=torch.float32,
                      device=xbc.device)
    seq = torch.cat([pad, xbc.float()], dim=1)
    conv_w = conv_w.float()
    out = sum(seq[:, i:i + L] * conv_w[i][None, None]
              for i in range(cfg.d_conv))
    return F.silu(out + conv_b.float()), seq[:, L:]


def _heads(cfg: Mamba2Config, lp: dict, xc: torch.Tensor, dt: torch.Tensor):
    """-> xs (B, L, H, P), Bm, Cm (B, L, N), A (H,), dt (B, L, H) f32."""
    B = xc.shape[0]
    Din, N, H, P = cfg.d_inner, cfg.d_state, cfg.n_heads, cfg.headdim
    xs = xc[..., :Din].reshape(B, -1, H, P)
    Bm = xc[..., Din:Din + N]
    Cm = xc[..., Din + N:]
    A = -torch.exp(lp["A_log"].float())
    dt = F.softplus(dt.float() + lp["dt_bias"].float())
    return xs, Bm, Cm, A, dt


def _out(cfg: Mamba2Config, lp: dict, y, xs, z):
    B = xs.shape[0]
    y = y + lp["D_skip"].float()[None, None, :, None] * xs
    y = y.reshape(B, -1, cfg.d_inner) * F.silu(z.float())
    y = rms_norm(y.to(cfg.dtype), lp["gnorm"], cfg.norm_eps)
    return y @ lp["out_proj"]


def _mix_seq(cfg: Mamba2Config, lp: dict, h: torch.Tensor,
             states: bool = False):
    """One mixer over a whole sequence. -> out, or with ``states`` (out,
    conv state (B, d_conv - 1, d_xbc), final SSM state (B, H, P, N))."""
    L = h.shape[1]
    z, xbc, dt = _split_proj(cfg, h @ lp["in_proj"])
    xc, conv_state = _conv_seq(cfg, lp["conv_w"], lp["conv_b"], xbc)
    xs, Bm, Cm, A, dtv = _heads(cfg, lp, xc, dt)
    y = _ssd_chunked(xs, dtv, A, Bm, Cm, min(cfg.chunk, L))
    out = _out(cfg, lp, y, xs, z)
    if not states:
        return out
    return out, conv_state, _final_state(dtv, A, Bm, xs)


def _final_state(dtv, A, Bm, xs):
    """The SSM state after a whole sequence: S = sum_j exp(sum_{k>j} a_k)
    dt_j B_j x_j.  -> (B, H, P, N)."""
    a = dtv * A
    a_rev = torch.cumsum(a.flip(1), dim=1).flip(1) - a
    return torch.einsum("bjn,bjh,bjhp->bhpn", Bm, torch.exp(a_rev) * dtv, xs)


def _layer_train(cfg: Mamba2Config, lp: dict, x):
    return x + _mix_seq(cfg, lp, rms_norm(x, lp["ln"], cfg.norm_eps))


def forward(cfg: Mamba2Config, params: dict, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, vocab), 0.0).  With grad enabled
    each layer runs under ``torch.utils.checkpoint``
    (:func:`layers.remat_call`), as the reference does.  On a placed state
    the logits come back as each model rank's vocab range (module
    docstring)."""
    if placed(params):
        return _forward_placed(cfg, params, tokens)
    x = F.embedding(tokens, params["embed"])
    for lp in unstack(params["layers"]):
        x = remat_call(_layer_train, cfg, lp, x, remat=cfg.remat)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], 0.0


def init_cache(cfg: Mamba2Config, batch: int, max_len: int = 0,
               kv_dtype: torch.dtype | None = None,
               device: torch.device | str | None = None) -> dict:
    """Conv-window and SSM states on ``device`` (default: the CUDA card;
    raises when there is none — pass ``device='cpu'``).  ``max_len`` and
    ``kv_dtype`` are the cache interface's: the states do not grow."""
    device = resolve_device(device)
    L, H, P, N = cfg.n_layers, cfg.n_heads, cfg.headdim, cfg.d_state
    f32 = torch.float32
    return {
        "conv": torch.zeros((L, batch, cfg.d_conv - 1, cfg.d_xbc),
                            dtype=f32, device=device),
        "ssm": torch.zeros((L, batch, H, P, N), dtype=f32, device=device),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: Mamba2Config, params: dict, tokens: torch.Tensor,
            cache: dict):
    """The forward pass, leaving each layer's final (conv, ssm) states in
    ``cache`` (in place).  Returns (last-token logits (B, 1, V), cache).
    On a placed state the cache is placed too (module docstring)."""
    if placed(params):
        return _prefill_placed(cfg, params, tokens, cache)
    x = F.embedding(tokens, params["embed"])
    L = x.shape[1]
    for i, lp in enumerate(unstack(params["layers"])):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        o, conv_state, S = _mix_seq(cfg, lp, h, states=True)
        x = x + o
        cache["conv"][i] = conv_state
        cache["ssm"][i] = S
    cache["length"].fill_(L)
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x[:, -1:] @ params["lm_head"], cache


def _mix_step(cfg: Mamba2Config, lp: dict, h, conv_state, ssm_state):
    """One mixer for one token. h: (B, 1, D) -> (out, new conv state, new
    SSM state)."""
    z, xbc, dt = _split_proj(cfg, h @ lp["in_proj"])
    win = torch.cat([conv_state, xbc.float()], dim=1)
    conv_w = lp["conv_w"].float()                       # (d_conv, d_xbc)
    xc = F.silu((win * conv_w[None]).sum(1) + lp["conv_b"].float())[:, None]
    xs, Bm, Cm, A, dtv = _heads(cfg, lp, xc, dt)
    dA = torch.exp(dtv[:, 0] * A)                       # (B, H)
    Sc = torch.einsum("bn,bh,bhp->bhpn", Bm[:, 0], dtv[:, 0], xs[:, 0])
    ssm_state = dA[..., None, None] * ssm_state + Sc
    y = torch.einsum("bn,bhpn->bhp", Cm[:, 0], ssm_state)[:, None]
    return _out(cfg, lp, y, xs, z), win[:, 1:], ssm_state


def decode_step(cfg: Mamba2Config, params: dict, tokens: torch.Tensor,
                cache: dict):
    """tokens: (B, 1) -> (logits (B, 1, V), cache updated in place; a
    placed cache on a placed state)."""
    if placed(params):
        return _decode_step_placed(cfg, params, tokens, cache)
    x = F.embedding(tokens, params["embed"])
    for i, lp in enumerate(unstack(params["layers"])):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        o, conv_s, ssm_s = _mix_step(cfg, lp, h, cache["conv"][i],
                                     cache["ssm"][i])
        x = x + o
        cache["conv"][i] = conv_s
        cache["ssm"][i] = ssm_s
    cache["length"] += 1
    x = rms_norm(x, params["ln_f"], cfg.norm_eps)
    return x @ params["lm_head"], cache


# ---------------------------------------------------------------------------
# Tensor parallelism on a placed state (module docstring)
# ---------------------------------------------------------------------------

def placed(params: dict) -> bool:
    """Whether ``params`` were placed by ``parallel.sharding.shard_tree``."""
    return isinstance(params.get("embed"), Placed)


def _tp(cfg: Mamba2Config, params: dict):
    """(the model axis's ring, the head plan of Din = H x P over it)."""
    ring = tp.model_ring(params["embed"].mesh)
    return ring, head_plan(cfg.n_heads, cfg.n_heads, cfg.headdim, ring.size)


def _channels(cfg: Mamba2Config, t: torch.Tensor, sh) -> torch.Tensor:
    """A rank's xBC channels (its heads' x, then the whole B and C) of a
    (..., d_xbc) tensor."""
    P, Din = cfg.headdim, cfg.d_inner
    return torch.cat([t[..., sh.h0 * P:sh.h1 * P], t[..., Din:]], -1)


class _RankMix:
    """One model rank's share of a mixer: its z, xBC channels and dt
    from the gathered ``in_proj`` output, and its slices of the replicated
    conv and SSM parameters."""

    def __init__(self, cfg: Mamba2Config, sh, zxbcdt: torch.Tensor,
                 rep: dict):
        P, Din, H0, H1 = cfg.headdim, cfg.d_inner, sh.h0, sh.h1
        self.sh = sh
        self.z = zxbcdt[..., H0 * P:H1 * P]
        self.xbc = _channels(cfg, zxbcdt[..., Din:Din + cfg.d_xbc], sh)
        dt0 = Din + cfg.d_xbc
        self.dt = zxbcdt[..., dt0 + H0:dt0 + H1]
        self.conv_w = _channels(cfg, rep["conv_w"], sh)
        self.conv_b = _channels(cfg, rep["conv_b"], sh)
        self.A = -torch.exp(rep["A_log"][H0:H1].float())
        self.dt_bias = rep["dt_bias"][H0:H1]
        self.d_skip = rep["D_skip"][H0:H1]
        self.gnorm = rep["gnorm"]

    def heads(self, cfg: Mamba2Config, xc: torch.Tensor):
        """-> xs (B, L, h, P), Bm, Cm (B, L, N), dt (B, L, h) f32 of the
        rank's heads from its conv output."""
        nx = (self.sh.h1 - self.sh.h0) * cfg.headdim
        N = cfg.d_state
        xs = xc[..., :nx].reshape(*xc.shape[:2], -1, cfg.headdim)
        dt = F.softplus(self.dt.float() + self.dt_bias.float())
        return xs, xc[..., nx:nx + N], xc[..., nx + N:], dt


_REPLICATED = ("conv_w", "conv_b", "A_log", "dt_bias", "D_skip", "gnorm")


def _ranks(cfg: Mamba2Config, lp: dict, hs: list, ring, plan):
    """Every held rank's :class:`_RankMix` of a layer for its input ``hs``
    (:func:`layers.gather_seq`): the ``in_proj`` output all-gathered over
    the axis."""
    idx = ring.index()
    proj = tp.gather_to_model([h_r @ lp["in_proj"].at(model=r)
                               for r, h_r in zip(idx, hs)], ring, -1)
    reps = {n: tp.copy_to_model(lp[n].at(), ring) for n in _REPLICATED}
    return [_RankMix(cfg, plan.shards[r], proj[i],
                     {n: reps[n][i] for n in _REPLICATED})
            for i, r in enumerate(idx)]


def _out_placed(cfg: Mamba2Config, lp: dict, ranks: list, ys: list,
                xss: list, ring) -> list:
    """The ranks' SSM outputs (B, L, h, P) f32 through the skip, the gate,
    ``gnorm`` over the whole Din (each rank's sum of squares over its own
    features, summed over the axis) and their rows of ``out_proj``: each
    rank's partial sum."""
    own, sums = [], []
    for rk, y, xs in zip(ranks, ys, xss):
        sh = rk.sh
        y = y + rk.d_skip.float()[None, None, :, None] * xs
        y = y.reshape(*xs.shape[:2], -1) * F.silu(rk.z.float())
        base = sh.h0 * cfg.headdim
        y = y.to(cfg.dtype)[..., sh.q_lo - base:sh.q_hi - base].float()
        own.append(y)
        sums.append((y * y).sum(-1, keepdim=True))
    total = tp.copy_to_model(tp.reduce_from_model(sums, ring), ring)
    parts = []
    for i, (r, rk, y) in enumerate(zip(ring.index(), ranks, own)):
        sh = rk.sh
        inv = torch.rsqrt(total[i] / cfg.d_inner + cfg.norm_eps)
        y = (y * inv * rk.gnorm[sh.q_lo:sh.q_hi].float()).to(cfg.dtype)
        parts.append(y @ lp["out_proj"].at(model=r))
    return parts


def _mix_seq_placed(cfg: Mamba2Config, lp: dict, hs: list, ring,
                    plan, states: bool = False):
    """:func:`_mix_seq` on a placed layer from each rank's input ``hs``.
    -> each rank's partial output, or with ``states`` (those, each rank's
    conv state (B, d_conv - 1, its channels) and final SSM state (B, its
    heads, P, N))."""
    L = hs[0].shape[1]
    ranks = _ranks(cfg, lp, hs, ring, plan)
    ys, xss, convs, finals = [], [], [], []
    for rk in ranks:
        xc, conv_state = _conv_seq(cfg, rk.conv_w, rk.conv_b, rk.xbc)
        xs, Bm, Cm, dtv = rk.heads(cfg, xc)
        ys.append(_ssd_chunked(xs, dtv, rk.A, Bm, Cm, min(cfg.chunk, L)))
        xss.append(xs)
        if states:
            convs.append(conv_state)
            finals.append(_final_state(dtv, rk.A, Bm, xs))
    out = _out_placed(cfg, lp, ranks, ys, xss, ring)
    return (out, convs, finals) if states else out


def _layer_train_placed(cfg: Mamba2Config, lp: dict, x, ring, plan):
    """A placed layer in ``x``'s layout: with ``cfg.sp`` the normed rows
    all-gathered at its entry and ``out_proj``'s sum reduce-scattered onto
    them (the reference's ``gather_seq`` / ``shard_seq``)."""
    hs = gather_seq(rms_norm_seq(x, lp["ln"], ring, cfg.norm_eps), ring)
    return add_partials(x, _mix_seq_placed(cfg, lp, hs, ring, plan), ring)


def _logits(cfg: Mamba2Config, params: dict, x, ring) -> list:
    return logits_placed(rms_norm_seq(x, params["ln_f"], ring, cfg.norm_eps),
                         params["lm_head"], ring)


def _forward_placed(cfg: Mamba2Config, params: dict, tokens: torch.Tensor):
    """:func:`forward` on a placed state: with ``cfg.sp`` the residual
    between layers each rank's rows of the sequence where the model axis
    divides it (``layers.shard_seq``)."""
    ring, plan = _tp(cfg, params)
    parts = tp.vocab_embed_parts(tokens, params["embed"], ring)
    x = shard_seq(parts, ring) if cfg.sp else \
        tp.reduce_from_model(parts, ring)
    for lp in unstack(params["layers"]):
        x = remat_call(_layer_train_placed, cfg, lp, x, ring, plan,
                       remat=cfg.remat)
    return tp.VocabShards(_logits(cfg, params, x, ring), ring,
                          cfg.vocab), 0.0


def _ssm_view(cache: dict, i: int, r: int, sh) -> torch.Tensor:
    """Rank ``r``'s layer-i SSM state (B, its heads, P, N): its shard, or
    its heads of the whole state."""
    leaf = cache["ssm"]
    t = leaf.at(model=r)[i]
    return t if "model" in leaf.axes else t[:, sh.h0:sh.h1]


def _conv_put(cfg: Mamba2Config, cache: dict, i: int, sh,
              state: torch.Tensor) -> None:
    """Write a rank's conv window (B, d_conv - 1, its channels) into its
    channels of the whole layer-i window."""
    conv = cache["conv"].at()[i]
    P, Din, nx = cfg.headdim, cfg.d_inner, (sh.h1 - sh.h0) * cfg.headdim
    conv[..., sh.h0 * P:sh.h1 * P] = state[..., :nx]
    conv[..., Din:] = state[..., nx:]


def _prefill_placed(cfg: Mamba2Config, params: dict, tokens: torch.Tensor,
                    cache: dict):
    """:func:`prefill` on a placed state and cache."""
    ring, plan = _tp(cfg, params)
    x = tp.vocab_embed(tokens, params["embed"], ring)
    for i, lp in enumerate(unstack(params["layers"])):
        hs = gather_seq(rms_norm_seq(x, lp["ln"], ring, cfg.norm_eps), ring)
        parts, convs, finals = _mix_seq_placed(cfg, lp, hs, ring, plan,
                                               states=True)
        x = add_partials(x, parts, ring)
        for r, conv_s, S in zip(ring.index(), convs, finals):
            sh = plan.shards[r]
            _conv_put(cfg, cache, i, sh, conv_s)
            _ssm_view(cache, i, r, sh).copy_(S)
    cache["length"].at().fill_(tokens.shape[1])
    logits = _logits(cfg, params, x[:, -1:], ring)
    return tp.gather_from_model(logits, ring, -1), cache


def _decode_step_placed(cfg: Mamba2Config, params: dict,
                        tokens: torch.Tensor, cache: dict):
    """:func:`decode_step` on a placed state and cache."""
    ring, plan = _tp(cfg, params)
    x = tp.vocab_embed(tokens, params["embed"], ring)
    for i, lp in enumerate(unstack(params["layers"])):
        hs = gather_seq(rms_norm_seq(x, lp["ln"], ring, cfg.norm_eps), ring)
        ranks = _ranks(cfg, lp, hs, ring, plan)
        ys, xss, puts = [], [], []
        for r, rk in zip(ring.index(), ranks):
            sh = rk.sh
            conv = _channels(cfg, cache["conv"].at()[i], sh)
            win = torch.cat([conv, rk.xbc.float()], dim=1)
            xc = F.silu((win * rk.conv_w.float()[None]).sum(1) +
                        rk.conv_b.float())[:, None]
            xs, Bm, Cm, dtv = rk.heads(cfg, xc)
            state = _ssm_view(cache, i, r, sh)
            dA = torch.exp(dtv[:, 0] * rk.A)
            Sc = torch.einsum("bn,bh,bhp->bhpn", Bm[:, 0], dtv[:, 0],
                              xs[:, 0])
            new = dA[..., None, None] * state + Sc
            ys.append(torch.einsum("bn,bhpn->bhp", Cm[:, 0], new)[:, None])
            xss.append(xs)
            puts.append((sh, win[:, 1:], state, new))
        # the ranks of a local ring share the whole conv window (and the
        # SSM state where it is whole): every rank reads before any writes
        for sh, win, state, new in puts:
            _conv_put(cfg, cache, i, sh, win)
            state.copy_(new)
        x = add_partials(x, _out_placed(cfg, lp, ranks, ys, xss, ring), ring)
    cache["length"].at().add_(1)
    logits = _logits(cfg, params, x, ring)
    return tp.gather_from_model(logits, ring, -1), cache
