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

On a state placed by ``parallel.sharding.shard_tree`` (``param_specs``:
``wq``, ``wk``, ``wv``, ``bq``, ``bv`` and ``mlp_w1`` / ``mlp_b1`` cut on
their output features, ``wo`` and ``mlp_w2`` on their rows, ``embed`` on
its vocabulary; ``bo``, ``mlp_b2``, the norms and ``pos_dec`` replicated)
the same entry points run tensor parallelism over the ``model`` axis
(``parallel.tensor_parallel``): each rank attends with its heads
(``layers.head_plan``; the projections all-gathered where a head straddles
ranks), the cross-attention taking its heads' k and v from the replicated
encoder output; ``wo`` and ``mlp_w2`` are row-parallel, and ``bo`` and
``mlp_b2`` are added once, after the partials' sum.  The output embedding
is tied: rank r's logits are ``x @ embed.at(model=r).T`` over its vocab
rows, and ``embed``'s gradient sums the lookup's and the logits' parts.
``forward`` returns ``tensor_parallel.VocabShards``, the serving steps the
logits gathered whole.  A placed cache holds the self and cross K/V cut as
the transformer's (its heads on the axis where it divides them).
"""
from __future__ import annotations

import dataclasses

import torch
import torch.nn.functional as F

from repro_torch.device import resolve_device
from repro_torch.parallel import tensor_parallel as tp
from repro_torch.parallel.sharding import Placed

from .layers import (add_partials, add_rows, attention, attn_out_parts,
                     decode_attention, expand_views, gather_seq, gelu,
                     gelu_mlp, head_plan, heads_of, kv_cut, kv_heads_of,
                     kv_of, kv_values, kv_views, layer_norm, logits_placed,
                     project_placed, remat_call, seq_map, shard_seq, unstack)

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
    remat: bool = True                # per-layer activation checkpointing
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
    (:func:`layers.remat_call`).  On a placed state each layer runs its
    placed body (module docstring); the output is replicated."""
    if placed(params):
        return _encode_placed(cfg, params, frames, *_tp(cfg, params))
    x = _frames_in(cfg, frames)
    for lp in unstack(params["enc"]):
        x = remat_call(_enc_layer, cfg, lp, x, remat=cfg.remat)
    return layer_norm(x, params["ln_enc_w"], params["ln_enc_b"],
                      cfg.norm_eps)


def _frames_in(cfg: WhisperConfig, frames: torch.Tensor) -> torch.Tensor:
    return frames.to(cfg.dtype) + _sinusoidal(
        frames.shape[1], cfg.d_model, frames.device).to(cfg.dtype)[None]


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
    reference's units.  On a placed state the logits come back as each
    model rank's vocab range (module docstring)."""
    if placed(params):
        return _forward_placed(cfg, params, tokens, frames)
    enc_out = encode(cfg, params, frames)
    S = tokens.shape[1]
    x = _embed(params, tokens,
               torch.arange(S, device=tokens.device)[None])
    for lp in unstack(params["dec"]):
        x = remat_call(_dec_train, cfg, lp, x, enc_out, remat=cfg.remat)
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
    (last-token logits (B, 1, V), cache).  A placed cache on a placed
    state (module docstring)."""
    if placed(params):
        return _prefill_placed(cfg, params, tokens, cache, frames)
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
    ``length + 1`` positions, then over all ``n_audio_ctx`` frames.  A
    placed cache on a placed state (module docstring)."""
    if placed(params):
        return _decode_step_placed(cfg, params, tokens, cache)
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


# ---------------------------------------------------------------------------
# Tensor parallelism on a placed state (module docstring)
# ---------------------------------------------------------------------------

def placed(params: dict) -> bool:
    """Whether ``params`` were placed by ``parallel.sharding.shard_tree``."""
    return isinstance(params.get("embed"), Placed)


def _tp(cfg: WhisperConfig, params: dict):
    """(the model axis's ring, the head plan over it)."""
    ring = tp.model_ring(params["embed"].mesh)
    return ring, head_plan(cfg.n_heads, cfg.n_heads, cfg.dh, ring.size)


def _ln(cfg: WhisperConfig, x, lp: dict, name: str, ring):
    """LayerNorm ``name`` (its ``_w`` / ``_b``) of a replicated or
    sequence-sharded ``x``."""
    return seq_map(lambda t, w, b: layer_norm(t, w, b, cfg.norm_eps), x,
                   ring, lp[name + "_w"].at(), lp[name + "_b"].at())


def _mha_placed(cfg: WhisperConfig, lp: dict, hq: list, hk: list, ring,
                plan, *, causal: bool, all_kv: bool = False):
    """:func:`_mha` on a placed block from each rank's query and key
    inputs (:func:`layers.gather_seq`): each rank's heads
    (``ring="off"``: the ranks split heads), ``wo`` row-parallel.  ->
    (each rank's partial output, before ``bo``; each rank's (k, v))."""
    idx = ring.index()
    q = project_placed(hq, lp["wq"], ring, plan.gather_q, lp["bq"])
    k = project_placed(hk, lp["wk"], ring, plan.gather_kv)
    v = project_placed(hk, lp["wv"], ring, plan.gather_kv, lp["bv"])
    outs, kvs = [], []
    for i, r in enumerate(idx):
        kr, vr = (kv_heads_of(plan, r, t[i], plan.gather_kv, all_kv)
                  for t in (k, v))
        outs.append(attention(heads_of(plan, r, q[i], plan.gather_q),
                              kv_of(plan, r, kr, all_kv),
                              kv_of(plan, r, vr, all_kv), causal=causal,
                              window=None, impl=cfg.attn_impl, ring="off"))
        kvs.append((kr, vr))
    return attn_out_parts(lp["wo"], plan, ring, outs), kvs


def _mlp_placed(cfg: WhisperConfig, lp: dict, x, ring, ln: int):
    """:func:`_mlp` column- then row-parallel, ``mlp_b2`` added once, in
    ``x``'s layout."""
    hs = gather_seq(_ln(cfg, x, lp, f"ln{ln}", ring), ring)
    parts = [gelu(h_r @ lp["mlp_w1"].at(model=r) + lp["mlp_b1"].at(model=r))
             @ lp["mlp_w2"].at(model=r)
             for r, h_r in zip(ring.index(), hs)]
    return add_partials(x, parts, ring, lp["mlp_b2"].at())


def _enc_layer_placed(cfg: WhisperConfig, lp: dict, x, ring, plan):
    """:func:`_enc_layer` on a placed layer, in ``x``'s layout.  The
    reference hints the layer's entry (``gather_seq``) and its output
    (``shard_seq``); between them its sharded carry makes GSPMD land each
    row-parallel sum on the rows too, as :func:`layers.add_partials`
    does."""
    hs = gather_seq(_ln(cfg, x, lp, "ln1", ring), ring)
    parts = _mha_placed(cfg, lp["attn"], hs, hs, ring, plan,
                        causal=False)[0]
    x = add_partials(x, parts, ring, lp["attn"]["bo"].at())
    return _mlp_placed(cfg, lp, x, ring, 2)


def _encode_placed(cfg: WhisperConfig, params: dict, frames: torch.Tensor,
                   ring, plan, shard: bool = False):
    """The encoder on a placed state: its output after the final norm,
    replicated, or with ``shard`` (where the model axis divides S_enc)
    each rank's rows, the residual between the layers too."""
    x = _frames_in(cfg, frames)
    if shard:
        x = shard_seq(x, ring)
    for lp in unstack(params["enc"]):
        x = remat_call(_enc_layer_placed, cfg, lp, x, ring, plan,
                       remat=cfg.remat)
    return _ln(cfg, x, params, "ln_enc", ring)


def _dec_layer_placed(cfg: WhisperConfig, lp: dict, x, enc_hs: list, ring,
                      plan, all_kv: bool = False):
    """:func:`_dec_layer` on a placed layer, in ``x``'s layout, the
    cross-attention over each rank's whole encoder output ``enc_hs``.
    -> (x, each rank's self (k, v), each rank's cross (k, v))."""
    hs = gather_seq(_ln(cfg, x, lp, "ln1", ring), ring)
    parts, kvs = _mha_placed(cfg, lp["self"], hs, hs, ring, plan,
                             causal=True, all_kv=all_kv)
    x = add_partials(x, parts, ring, lp["self"]["bo"].at())
    hs = gather_seq(_ln(cfg, x, lp, "ln2", ring), ring)
    parts, xkvs = _mha_placed(cfg, lp["cross"], hs, enc_hs, ring, plan,
                              causal=False, all_kv=all_kv)
    x = add_partials(x, parts, ring, lp["cross"]["bo"].at())
    return _mlp_placed(cfg, lp, x, ring, 3), kvs, xkvs


def _dec_train_placed(cfg: WhisperConfig, lp: dict, x, enc_hs: list, ring,
                      plan):
    return _dec_layer_placed(cfg, lp, x, enc_hs, ring, plan)[0]


def _embed_placed(params: dict, tokens: torch.Tensor, positions, ring,
                  shard: bool = False):
    """The decoder's input: the vocabulary-parallel embedding (with
    ``shard``, reduce-scattered to each rank's rows where the axis divides
    S) plus the learned positions."""
    pos = params["pos_dec"].at()
    parts = tp.vocab_embed_parts(tokens, params["embed"], ring)
    x = shard_seq(parts, ring) if shard else \
        tp.reduce_from_model(parts, ring)
    return add_rows(x, pos[positions % pos.shape[0]], ring)


def _logits_placed(cfg: WhisperConfig, params: dict, x, ring) -> list:
    return logits_placed(_ln(cfg, x, params, "ln_dec", ring),
                         params["embed"], ring, tied=True)


def _forward_placed(cfg: WhisperConfig, params: dict, tokens: torch.Tensor,
                    frames: torch.Tensor):
    """:func:`forward` on a placed state: the encoder's and the decoder's
    residuals each rank's rows of their sequences where the model axis
    divides them (``layers.shard_seq``), the encoder's output gathered
    whole for the cross-attention."""
    ring, plan = _tp(cfg, params)
    enc_hs = gather_seq(_encode_placed(cfg, params, frames, ring, plan,
                                       shard=True), ring)
    S = tokens.shape[1]
    x = _embed_placed(params, tokens,
                      torch.arange(S, device=tokens.device)[None], ring,
                      shard=True)
    for lp in unstack(params["dec"]):
        x = remat_call(_dec_train_placed, cfg, lp, x, enc_hs, ring, plan,
                       remat=cfg.remat)
    return tp.VocabShards(_logits_placed(cfg, params, x, ring), ring,
                          cfg.vocab), 0.0


def _cross(cache: dict) -> dict:
    """The cross K/V of a cache under the names ``layers.kv_values`` and
    ``layers.kv_views`` read."""
    return {"k": cache["xk"], "v": cache["xv"]}


def _prefill_placed(cfg: WhisperConfig, params: dict, tokens: torch.Tensor,
                    cache: dict, frames: torch.Tensor):
    """:func:`prefill` on a placed state and cache."""
    ring, plan = _tp(cfg, params)
    idx = ring.index()
    cut, xcut = kv_cut(cache["k"]), kv_cut(cache["xk"])
    enc_hs = gather_seq(_encode_placed(cfg, params, frames, ring, plan),
                        ring)
    S = tokens.shape[1]
    x = _embed_placed(params, tokens,
                      torch.arange(S, device=tokens.device)[None], ring)
    for i, lp in enumerate(unstack(params["dec"])):
        x, kvs, xkvs = _dec_layer_placed(cfg, lp, x, enc_hs, ring, plan,
                                         all_kv=cut != "heads")
        for r, (k, v), (xk, xv) in zip(idx, kvs, xkvs):
            for n, val in kv_values(cache, k, v, r, cut, ring).items():
                cache[n].at(model=r)[i, :, :S] = val
            for n, val in kv_values(_cross(cache), xk, xv, r, xcut,
                                    ring).items():
                cache["x" + n].at(model=r)[i] = val
    cache["length"].at().fill_(S)
    logits = _logits_placed(cfg, params, x[:, -1:], ring)
    return tp.gather_from_model(logits, ring, -1), cache


def _decode_step_placed(cfg: WhisperConfig, params: dict,
                        tokens: torch.Tensor, cache: dict):
    """:func:`decode_step` on a placed state and cache."""
    ring, plan = _tp(cfg, params)
    idx = ring.index()
    cut, xcut = kv_cut(cache["k"]), kv_cut(cache["xk"])
    all_kv = cut != "heads"
    B = tokens.shape[0]
    length = cache["length"].at()
    x = _embed_placed(params, tokens, length[:, None].long(), ring)
    rows = torch.arange(B, device=x.device)
    pos = torch.clamp(length.long(), max=cache["k"].shape[2] - 1)
    frames = torch.full((B,), cache["xk"].shape[2], dtype=torch.int32,
                        device=x.device)
    for i, lp in enumerate(unstack(params["dec"])):
        sa, ca = lp["self"], lp["cross"]
        hs = gather_seq(_ln(cfg, x, lp, "ln1", ring), ring)
        q = project_placed(hs, sa["wq"], ring, plan.gather_q, sa["bq"])
        k = project_placed(hs, sa["wk"], ring, plan.gather_kv)
        v = project_placed(hs, sa["wv"], ring, plan.gather_kv, sa["bv"])
        for j, r in enumerate(idx):
            kr, vr = (kv_heads_of(plan, r, t[j], plan.gather_kv, all_kv)
                      for t in (k, v))
            for n, val in kv_values(cache, kr, vr, r, cut, ring).items():
                cache[n].at(model=r)[i][rows, pos] = val[:, 0]
        outs = [decode_attention(heads_of(plan, r, q[j], plan.gather_q),
                                 pg["k"], pg["v"], length + 1)
                for j, (r, pg) in enumerate(zip(idx, (
                    expand_views(plan, r, pg) for r, pg in zip(
                        idx, kv_views(cache, i, ring, plan, cut)))))]
        x = add_partials(x, attn_out_parts(sa["wo"], plan, ring, outs), ring,
                         sa["bo"].at())
        q = project_placed(gather_seq(_ln(cfg, x, lp, "ln2", ring), ring),
                           ca["wq"], ring, plan.gather_q, ca["bq"])
        outs = [decode_attention(heads_of(plan, r, q[j], plan.gather_q),
                                 pg["k"], pg["v"], frames)
                for j, (r, pg) in enumerate(zip(idx, (
                    expand_views(plan, r, pg) for r, pg in zip(
                        idx, kv_views(_cross(cache), i, ring, plan,
                                      xcut)))))]
        x = add_partials(x, attn_out_parts(ca["wo"], plan, ring, outs), ring,
                         ca["bo"].at())
        x = _mlp_placed(cfg, lp, x, ring, 3)
    length += 1
    logits = _logits_placed(cfg, params, x, ring)
    return tp.gather_from_model(logits, ring, -1), cache
