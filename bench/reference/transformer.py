"""The plain reference of a decoder-only transformer (dense SwiGLU or a
dropless top-k MoE), in float32 with TF32 off, for the benchmark's
correctness check.

It reads a configuration file's sizes (:func:`harness.spec.model_sizes`)
and weights in the port's tree layout made by the benchmark from the seed;
it imports nothing of the program.  Parameters are held in the dtype the
configuration states (bfloat16): every product is taken in float32 on
their float32 values, and an AdamW step rounds the updated float32 value
back to that dtype, as bfloat16 weights are stored.

``prec="fp8"`` is the control: every matrix product takes its operands
rounded to float8 e4m3 (each row of the left operand and each column of
the right one scaled by its largest magnitude onto 448), the nearest
precision below bfloat16; the backward passes straight through the
rounding.
"""
from __future__ import annotations

import math

import torch
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

FP8_MAX = 448.0
PRECISIONS = ("f32", "fp8")


def exact_f32() -> None:
    """float32 products in full float32: TF32 off."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.set_float32_matmul_precision("highest")


def _fp8(x: torch.Tensor, dim: int) -> torch.Tensor:
    amax = x.detach().abs().amax(dim, keepdim=True).clamp_min(1e-30)
    scale = amax / FP8_MAX
    q = (x.detach() / scale).to(torch.float8_e4m3fn).float() * scale
    return x + (q - x).detach()


def mm(a: torch.Tensor, b: torch.Tensor, prec: str) -> torch.Tensor:
    if prec == "f32":
        return a @ b
    return _fp8(a, -1) @ _fp8(b, -2)


def rms(x: torch.Tensor, w: torch.Tensor, eps: float) -> torch.Tensor:
    return x * torch.rsqrt(x.pow(2).mean(-1, keepdim=True) + eps) * w


def rope(x: torch.Tensor, theta: float) -> torch.Tensor:
    """x: (S, heads, Dh) at positions 0 .. S - 1; the halves rotated."""
    S, _, dh = x.shape
    inv = 1.0 / theta ** (torch.arange(0, dh, 2, device=x.device,
                                       dtype=torch.float32) / dh)
    ang = torch.arange(S, device=x.device, dtype=torch.float32)[:, None] \
        * inv[None, :]
    cos, sin = torch.cos(ang)[:, None, :], torch.sin(ang)[:, None, :]
    x1, x2 = x[..., :dh // 2], x[..., dh // 2:]
    return torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], -1)


def _group_attention(q, k, v, prec):
    """q: (G, S, Dh), k, v: (S, Dh) -> (G, S, Dh), causal."""
    S, dh = k.shape
    s = mm(q, k.t(), prec) / math.sqrt(dh)
    mask = torch.ones(S, S, dtype=torch.bool, device=q.device).tril()
    p = torch.softmax(s.masked_fill(~mask, float("-inf")), -1)
    return mm(p, v, prec)


def attention(q, k, v, prec):
    """q: (S, H, Dh), k, v: (S, Hkv, Dh): causal GQA, one kv head's group
    at a time (each recomputed in the backward, not kept)."""
    S, H, dh = q.shape
    Hkv = k.shape[1]
    G = H // Hkv
    outs = []
    for g in range(Hkv):
        qg = q[:, g * G:(g + 1) * G].transpose(0, 1)
        args = (qg, k[:, g], v[:, g], prec)
        if torch.is_grad_enabled():
            o = checkpoint(_group_attention, *args, use_reentrant=False)
        else:
            o = _group_attention(*args)
        outs.append(o.transpose(0, 1))
    return torch.cat(outs, 1)


def swiglu(h, wg, wu, wd, prec):
    return mm(F.silu(mm(h, wg, prec)) * mm(h, wu, prec), wd, prec)


def moe(h, lp, s, prec):
    """Dropless top-k MoE: every token's k experts, softmax router in
    float32, the top-k probabilities renormalised where the configuration
    says so."""
    E, K = s["n_experts"], s["top_k"]
    probs = torch.softmax(mm(h, lp["router"], prec), -1)
    gate, idx = torch.topk(probs, K, dim=-1)
    if s["norm_topk_prob"]:
        gate = gate / gate.sum(-1, keepdim=True)
    out = torch.zeros_like(h)
    for e in range(E):
        tok, slot = (idx == e).nonzero(as_tuple=True)
        if tok.numel() == 0:
            continue
        y = swiglu(h[tok], lp["w_gate"][e], lp["w_up"][e], lp["w_down"][e],
                   prec)
        out = out.index_add(0, tok, y * gate[tok, slot][:, None])
    return out


def layer(x, lp, s, prec):
    """One decoder layer on x: (S, D), lp its float32 leaves."""
    S = x.shape[0]
    H, Hkv, dh = s["n_heads"], s["n_kv_heads"], s["head_dim"]
    h = rms(x, lp["ln1"], s["norm_eps"])
    q, k, v = mm(h, lp["wq"], prec), mm(h, lp["wk"], prec), \
        mm(h, lp["wv"], prec)
    if s["qkv_bias"]:
        q, k, v = q + lp["bq"], k + lp["bk"], v + lp["bv"]
    q, k, v = q.view(S, H, dh), k.view(S, Hkv, dh), v.view(S, Hkv, dh)
    if s["qk_norm"]:
        q = rms(q, lp["q_norm"], s["norm_eps"])
        k = rms(k, lp["k_norm"], s["norm_eps"])
    q, k = rope(q, s["rope_theta"]), rope(k, s["rope_theta"])
    x = x + mm(attention(q, k, v, prec).reshape(S, H * dh), lp["wo"], prec)
    h = rms(x, lp["ln2"], s["norm_eps"])
    if s["n_experts"]:
        return x + moe(h, lp, s, prec)
    return x + swiglu(h, lp["w_gate"], lp["w_up"], lp["w_down"], prec)


def layer_leaves(params: dict, i: int, grad: bool = False) -> dict:
    """Layer ``i``'s leaves in float32 (leaves that need a gradient)."""
    return {k: f32(v[i]).requires_grad_(grad)
            for k, v in params["layers"].items()}


def f32(t: torch.Tensor) -> torch.Tensor:
    """A float32 copy (never the stored tensor itself)."""
    return t.to(torch.float32, copy=True)


@torch.no_grad()
def logits(params: dict, tokens: torch.Tensor, s: dict,
           prec: str = "f32") -> torch.Tensor:
    """(S, vocab) float32 logits of one sequence ``tokens`` (S,)."""
    x = params["embed"][tokens.long()].float()
    for i in range(s["n_layers"]):
        x = layer(x, layer_leaves(params, i), s, prec)
    x = rms(x, params["ln_f"].float(), s["norm_eps"])
    return mm(x, params["lm_head"].float(), prec)


# ---------------------------------------------------------------------------
# training: next-token loss, gradients layer by layer, AdamW
# ---------------------------------------------------------------------------

def loss_and_grads(params: dict, tokens: torch.Tensor, labels: torch.Tensor,
                   s: dict, z_weight: float, prec: str = "f32"):
    """Loss (mean next-token CE over all B x S tokens + z_weight x mean
    log Z^2) of rows ``tokens`` / ``labels`` (B, S) and float32 gradients
    of every leaf, keyed by path.  Each layer's input is kept; its backward
    recomputes it."""
    B, S = tokens.shape
    L = s["n_layers"]
    grads: dict[str, torch.Tensor] = {
        "embed": torch.zeros(params["embed"].shape, dtype=torch.float32,
                             device=tokens.device),
        "ln_f": 0, "lm_head": 0}
    for k, v in params["layers"].items():
        grads["layers." + k] = torch.zeros(v.shape, dtype=torch.float32,
                                           device=v.device)
    total = 0.0
    for b in range(B):
        tok = tokens[b].long()
        x = params["embed"][tok].float()
        kept = []
        with torch.no_grad():
            for i in range(L):
                kept.append(x)
                x = layer(x, layer_leaves(params, i), s, prec)
        x.requires_grad_(True)
        ln_f = f32(params["ln_f"]).requires_grad_(True)
        head = f32(params["lm_head"]).requires_grad_(True)
        z = mm(rms(x, ln_f, s["norm_eps"]), head, prec)
        logz = torch.logsumexp(z, -1)
        ce = (logz - z.gather(-1, labels[b].long()[:, None])[:, 0]).mean()
        loss = (ce + z_weight * (logz ** 2).mean()) / B
        loss.backward()
        total += float(loss.detach()) * B
        del z, logz
        grads["ln_f"] = grads["ln_f"] + ln_f.grad
        grads["lm_head"] = grads["lm_head"] + head.grad
        dx = x.grad
        for i in reversed(range(L)):
            xin = kept[i].requires_grad_(True)
            lp = layer_leaves(params, i, grad=True)
            layer(xin, lp, s, prec).backward(dx)
            dx = xin.grad
            kept[i] = None
            for k, v in lp.items():
                grads["layers." + k][i] += v.grad
        grads["embed"].index_add_(0, tok, dx)
    return total / B, grads


def lr_at(opt: dict, step: int) -> float:
    """Linear warm-up to ``lr`` over ``warmup_steps``, then cosine decay
    to ``min_lr_frac`` of it at ``total_steps``."""
    warm = step / max(1.0, opt["warmup_steps"])
    decay = max(1.0, opt["total_steps"] - opt["warmup_steps"])
    frac = min(max((step - opt["warmup_steps"]) / decay, 0.0), 1.0)
    cos = opt["min_lr_frac"] + (1 - opt["min_lr_frac"]) * 0.5 * (
        1 + math.cos(math.pi * frac))
    return opt["lr"] * (warm if step < opt["warmup_steps"] else cos)


def leaf(tree: dict, path: str) -> torch.Tensor:
    if path.startswith("layers."):
        return tree["layers"][path[7:]]
    return tree[path]


@torch.no_grad()
def adamw(params: dict, grads: dict, moments: dict, step: int, opt: dict):
    """One AdamW step in place: the global norm clipped to ``clip_norm``,
    decoupled weight decay, each leaf updated in float32 one slab of its
    leading axis at a time and stored back in its own dtype.  -> (the
    global norm, the clip scale)."""
    gnorm = math.sqrt(sum(float(torch.linalg.vector_norm(g)) ** 2
                          for g in grads.values()))
    scale = min(1.0, opt["clip_norm"] / (gnorm + 1e-9))
    lr = lr_at(opt, step)
    b1, b2 = opt["b1"], opt["b2"]
    b1c, b2c = 1 - b1 ** step, 1 - b2 ** step
    for path, g in grads.items():
        p = leaf(params, path)
        if path not in moments:
            moments[path] = (torch.zeros_like(g), torch.zeros_like(g))
        m, v = moments[path]
        slabs = p.shape[0] if p.dim() > 2 else 1
        for j in range(slabs):
            def sl(t, j=j):
                return t[j] if slabs > 1 else t
            gj = sl(g) * scale
            sl(m).mul_(b1).add_(gj, alpha=1 - b1)
            sl(v).mul_(b2).addcmul_(gj, gj, value=1 - b2)
            pf = sl(p).float()
            upd = (sl(m) / b1c) / ((sl(v) / b2c).sqrt() + opt["eps"]) \
                + opt["weight_decay"] * pf
            sl(p).copy_(pf - lr * upd)
    return gnorm, scale


def train(params: dict, rows: list[dict], s: dict, opt: dict,
          z_weight: float, prec: str = "f32") -> dict:
    """``len(rows)`` training steps of ``params`` (updated in place), row
    ``i`` a dict of (B, S) ``tokens`` / ``labels``.  -> {"losses", "grad_norms"
    (each leaf's norm of the first step's gradient, clipped, as the
    optimizer takes it), "ref_grad_norms_raw" (the same unclipped)}."""
    moments: dict = {}
    losses, first = [], None
    for i, row in enumerate(rows):
        loss, grads = loss_and_grads(params, row["tokens"], row["labels"],
                                     s, z_weight, prec)
        losses.append(loss)
        _, scale = adamw(params, grads, moments, i + 1, opt)
        if first is None:
            first = {k: float(g.norm()) * scale for k, g in grads.items()}
        del grads
    return {"losses": losses, "grad_norms": first}
