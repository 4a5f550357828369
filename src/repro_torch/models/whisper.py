"""Whisper-medium style encoder-decoder (arXiv:2212.04356): counterpart of
``repro.models.whisper`` on one device.

The conv audio frontend is a STUB: the caller supplies precomputed frame
embeddings (B, S_enc, D) directly to the encoder.  Encoder: bidirectional
MHA + GELU MLP, sinusoidal positions.  Decoder: causal self-attention +
cross-attention over the encoder output, learned positions, tied output
embedding.  LayerNorm (with bias) throughout, pre-norm.  The encoder's
self-attention and the decoder's prefill attention (causal self, non-causal
cross with Sq != Sk) and the training forward go through
``layers.attention`` (on the card the flash forward kernel, and under
autograd the backward pair); decode attends through the plain
``decode_attention``, the cross-attention over all ``n_audio_ctx`` frames.

``prefill`` and ``decode_step`` write into the cache they are given, in
place, and return it.
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device

from .layers import (attention, decode_attention, gelu_mlp, layer_norm,
                     remat_call,
                     unstack)

# Pooled-serving slot layout (see serving/engine.py _write_slot): batch axis
# of every cache entry, including the encoder cross-attention K/V.
CACHE_BATCH_AXES = {"k": 1, "v": 1, "xk": 1, "xv": 1, "length": 0}


@dataclasses.dataclass(frozen=True)
class WhisperConfig:
    name: str
    n_layers: int            # per stack (24 enc + 24 dec)
    d_model: int
    n_heads: int
    d_ff: int
    vocab: int
    n_audio_ctx: int = 1500
    max_text_ctx: int = 448
    norm_eps: float = 1e-5
    dtype: torch.dtype = torch.bfloat16
    attn_impl: str = "auto"           # auto | xla | pallas (flash policy)

    @property
    def dh(self) -> int:
        return self.d_model // self.n_heads

    def param_count(self) -> int:
        D, F_, L = self.d_model, self.d_ff, self.n_layers
        attn = 4 * D * D
        mlp = 2 * D * F_ + D + F_
        enc = L * (attn + mlp + 4 * D)
        dec = L * (2 * attn + mlp + 6 * D)
        return enc + dec + self.vocab * D + self.max_text_ctx * D + 4 * D


def _sinusoidal(length: int, d: int, device) -> torch.Tensor:
    pos = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    dim = torch.arange(d // 2, dtype=torch.float32, device=device)[None, :]
    ang = pos / (10000.0 ** (dim / (d // 2 - 1)))
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def init_params(cfg: WhisperConfig, generator: torch.Generator,
                device: torch.device) -> dict:
    """Random weights drawn on ``device`` from ``generator``, in the
    reference's key names and nesting (``enc`` / ``dec`` trees, each layer
    stack on a leading axis)."""
    D, Ff, L, dt = cfg.d_model, cfg.d_ff, cfg.n_layers, cfg.dtype

    def nrm(shape):
        x = torch.randn(shape, generator=generator, device=device,
                        dtype=torch.float32)
        return x.mul_(0.02).to(dt)      # one f32 temporary, not two

    def ones(shape):
        return torch.ones(shape, dtype=dt, device=device)

    def zeros(shape):
        return torch.zeros(shape, dtype=dt, device=device)

    def attn():
        return {"wq": nrm((L, D, D)), "bq": zeros((L, D)),
                "wk": nrm((L, D, D)),
                "wv": nrm((L, D, D)), "bv": zeros((L, D)),
                "wo": nrm((L, D, D)), "bo": zeros((L, D))}

    def stack(n_ln, **attns):
        tree = dict(attns)
        for i in range(1, n_ln + 1):
            tree[f"ln{i}_w"], tree[f"ln{i}_b"] = ones((L, D)), zeros((L, D))
        tree.update(mlp_w1=nrm((L, D, Ff)), mlp_b1=zeros((L, Ff)),
                    mlp_w2=nrm((L, Ff, D)), mlp_b2=zeros((L, D)))
        return tree

    return {
        "embed": nrm((cfg.vocab, D)),
        "pos_dec": nrm((cfg.max_text_ctx, D)),
        "enc": stack(2, attn=attn()),
        "dec": stack(3, self=attn(), cross=attn()),
        "ln_enc_w": ones((D,)), "ln_enc_b": zeros((D,)),
        "ln_dec_w": ones((D,)), "ln_dec_b": zeros((D,)),
    }


def _mha(cfg: WhisperConfig, lp: dict, xq, xkv, *, causal: bool):
    """-> (attention output projected, k, v) for queries ``xq`` over
    ``xkv``."""
    B, S, D = xq.shape
    H, Dh = cfg.n_heads, cfg.dh
    Sk = xkv.shape[1]
    q = (xq @ lp["wq"] + lp["bq"]).reshape(B, S, H, Dh)
    k = (xkv @ lp["wk"]).reshape(B, Sk, H, Dh)
    v = (xkv @ lp["wv"] + lp["bv"]).reshape(B, Sk, H, Dh)
    o = attention(q, k, v, causal=causal, window=None, impl=cfg.attn_impl)
    return o.reshape(B, S, D) @ lp["wo"] + lp["bo"], k, v


def _mlp(cfg: WhisperConfig, lp: dict, x, ln: int):
    h = layer_norm(x, lp[f"ln{ln}_w"], lp[f"ln{ln}_b"], cfg.norm_eps)
    return x + gelu_mlp(h, lp["mlp_w1"], lp["mlp_b1"], lp["mlp_w2"],
                        lp["mlp_b2"])


def _enc_layer(cfg: WhisperConfig, lp: dict, x):
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
    x = x + _mha(cfg, lp["attn"], h, h, causal=False)[0]
    return _mlp(cfg, lp, x, 2)


def encode(cfg: WhisperConfig, params: dict,
           frames: torch.Tensor) -> torch.Tensor:
    """frames: (B, S_enc, D) precomputed embeddings (stub frontend).  With
    grad enabled each layer runs under ``torch.utils.checkpoint``
    (:func:`layers.remat_call`)."""
    x = frames.to(cfg.dtype) + _sinusoidal(
        frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)[None]
    for lp in unstack(params["enc"]):
        x = remat_call(_enc_layer, cfg, lp, x)
    return layer_norm(x, params["ln_enc_w"], params["ln_enc_b"],
                      cfg.norm_eps)


def _dec_layer(cfg: WhisperConfig, lp: dict, x, enc_out):
    """One decoder layer over a whole sequence. -> (x, self k, v, cross
    k, v)."""
    h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
    o, k, v = _mha(cfg, lp["self"], h, h, causal=True)
    x = x + o
    h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
    o, xk, xv = _mha(cfg, lp["cross"], h, enc_out, causal=False)
    return _mlp(cfg, lp, x + o, 3), k, v, xk, xv


def _embed(params: dict, tokens: torch.Tensor, positions: torch.Tensor):
    pos = params["pos_dec"]
    return F.embedding(tokens, params["embed"]) + \
        pos[positions % pos.shape[0]]


def _logits(cfg: WhisperConfig, params: dict, x):
    x = layer_norm(x, params["ln_dec_w"], params["ln_dec_b"], cfg.norm_eps)
    return x @ params["embed"].T          # tied output embedding


def _dec_train(cfg: WhisperConfig, lp: dict, x, enc_out):
    return _dec_layer(cfg, lp, x, enc_out)[0]


def forward(cfg: WhisperConfig, params: dict, tokens: torch.Tensor,
            frames: torch.Tensor):
    """Teacher-forced forward: (tokens (B, S_dec), frames (B, S_enc, D))
    -> (logits (B, S_dec, vocab), 0.0).  With grad enabled each encoder
    and each decoder layer runs under ``torch.utils.checkpoint``, the
    reference's units."""
    enc_out = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = _embed(params, tokens,
               torch.arange(S, device=tokens.device)[None])
    for lp in unstack(params["dec"]):
        x = remat_call(_dec_train, cfg, lp, x, enc_out)
    return _logits(cfg, params, x), 0.0


def init_cache(cfg: WhisperConfig, batch: int, max_len: int,
               kv_dtype: torch.dtype | None = None,
               device: torch.device | str | None = None) -> dict:
    """Self-attention K/V of ``max_len`` positions and the cross K/V over
    ``n_audio_ctx`` frames, on ``device`` (default: the CUDA card; raises
    when there is none — pass ``device='cpu'``)."""
    device = resolve_device(device)
    kv_dtype = kv_dtype or cfg.dtype
    L, H, Dh = cfg.n_layers, cfg.n_heads, cfg.dh

    def zeros(n):
        return torch.zeros((L, batch, n, H, Dh), dtype=kv_dtype,
                           device=device)

    return {
        "k": zeros(max_len), "v": zeros(max_len),
        "xk": zeros(cfg.n_audio_ctx), "xv": zeros(cfg.n_audio_ctx),
        "length": torch.zeros((batch,), dtype=torch.int32, device=device),
    }


def prefill(cfg: WhisperConfig, params: dict, tokens: torch.Tensor,
            cache: dict, frames: torch.Tensor):
    """Encode the audio, keep each layer's cross K/V and run the prompt
    through the decoder, writing into ``cache`` in place.  Returns
    (last-token logits (B, 1, V), cache)."""
    enc_out = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = _embed(params, tokens, torch.arange(S, device=tokens.device)[None])
    for i, lp in enumerate(unstack(params["dec"])):
        x, k, v, xk, xv = _dec_layer(cfg, lp, x, enc_out)
        for name, new in (("k", k), ("v", v)):
            cache[name][i, :, :S] = new.to(cache[name].dtype)
        for name, new in (("xk", xk), ("xv", xv)):
            cache[name][i] = new.to(cache[name].dtype)
    cache["length"].fill_(S)
    return _logits(cfg, params, x[:, -1:]), cache


def decode_step(cfg: WhisperConfig, params: dict, tokens: torch.Tensor,
                cache: dict):
    """tokens: (B, 1) -> (logits (B, 1, V), cache updated in place): each
    slot writes its self K/V at its own length and attends over
    ``length + 1`` positions, then over all ``n_audio_ctx`` frames."""
    B = tokens.shape[0]
    H, Dh = cfg.n_heads, cfg.dh
    length = cache["length"]
    x = _embed(params, tokens, length[:, None].long())
    rows = torch.arange(B, device=x.device)
    # idle slots keep counting past the end; their writes clamp to the last
    # row, as the reference's dynamic_update_slice does
    pos = torch.clamp(length.long(), max=cache["k"].shape[2] - 1)
    frames = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32,
                        device=x.device)
    for i, lp in enumerate(unstack(params["dec"])):
        sa, ca = lp["self"], lp["cross"]
        h = layer_norm(x, lp["ln1_w"], lp["ln1_b"], cfg.norm_eps)
        q = (h @ sa["wq"] + sa["bq"]).reshape(B, 1, H, Dh)
        k = (h @ sa["wk"]).reshape(B, 1, H, Dh)
        v = (h @ sa["wv"] + sa["bv"]).reshape(B, 1, H, Dh)
        kc, vc = cache["k"][i], cache["v"][i]
        kc[rows, pos] = k[:, 0].to(kc.dtype)
        vc[rows, pos] = v[:, 0].to(vc.dtype)
        o = decode_attention(q, kc, vc, length + 1)
        x = x + o.reshape(B, 1, -1) @ sa["wo"] + sa["bo"]
        h = layer_norm(x, lp["ln2_w"], lp["ln2_b"], cfg.norm_eps)
        q = (h @ ca["wq"] + ca["bq"]).reshape(B, 1, H, Dh)
        o = decode_attention(q, cache["xk"][i], cache["xv"][i], frames)
        x = x + o.reshape(B, 1, -1) @ ca["wo"] + ca["bo"]
        x = _mlp(cfg, lp, x, 3)
    cache["length"] += 1
    return _logits(cfg, params, x), cache
