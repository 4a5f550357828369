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
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from .layers import rms_norm, unstack

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


def _conv_seq(cfg: Mamba2Config, lp: dict, xbc: torch.Tensor):
    """Causal depthwise conv over a whole sequence, then SiLU.
    -> (activations (B, L, d_xbc) f32, the last d_conv - 1 inputs)."""
    B, L, _ = xbc.shape
    pad = torch.zeros((B, cfg.d_conv - 1, cfg.d_xbc), dtype=torch.float32,
                      device=xbc.device)
    seq = torch.cat([pad, xbc.float()], dim=1)
    conv_w = lp["conv_w"].float()
    out = sum(seq[:, i:i + L] * conv_w[i][None, None]
              for i in range(cfg.d_conv))
    return F.silu(out + lp["conv_b"].float()), seq[:, L:]


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
    xc, conv_state = _conv_seq(cfg, lp, xbc)
    xs, Bm, Cm, A, dtv = _heads(cfg, lp, xc, dt)
    y = _ssd_chunked(xs, dtv, A, Bm, Cm, min(cfg.chunk, L))
    out = _out(cfg, lp, y, xs, z)
    if not states:
        return out
    # final state: S = sum_j exp(sum_{k>j} a_k) dt_j B_j x_j over the
    # whole sequence
    a = dtv * A
    a_rev = torch.cumsum(a.flip(1), dim=1).flip(1) - a
    S = torch.einsum("bjn,bjh,bjhp->bhpn", Bm, torch.exp(a_rev) * dtv, xs)
    return out, conv_state, S


def forward(cfg: Mamba2Config, params: dict, tokens: torch.Tensor):
    """tokens: (B, S) -> (logits (B, S, vocab), 0.0)."""
    x = F.embedding(tokens, params["embed"])
    for lp in unstack(params["layers"]):
        h = rms_norm(x, lp["ln"], cfg.norm_eps)
        x = x + _mix_seq(cfg, lp, h)
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
    ``cache`` (in place).  Returns (last-token logits (B, 1, V), cache)."""
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
    """tokens: (B, 1) -> (logits (B, 1, V), cache updated in place)."""
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
