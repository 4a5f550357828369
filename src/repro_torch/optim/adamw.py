"""AdamW with decoupled weight decay, global-norm clipping, cosine schedule.

Counterpart of ``repro.optim.adamw``, with the same arithmetic.  Optimizer
state is f32 whatever the param dtype (mixed precision) and mirrors the
param tree; its ``step`` is a 0-d int32 tensor on the host.

Where the reference returns new trees, :func:`adamw_update` updates the
params and the moments IN PLACE, leaf by leaf and in slices of at most
:data:`CHUNK` elements, so no f32 copy of the whole tree, nor of one whole
leaf, ever exists: at qwen3-4b's full width the moments alone take 35 GB of
an 80 GB card, and one f32 copy of the largest leaf (``w_gate``) 3.6 GB.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any

import torch

# Elements per slice of a leaf in the update and the norm (256 MB in f32).
CHUNK = 1 << 26


@dataclasses.dataclass(frozen=True)
class AdamWConfig:
    lr: float = 3e-4
    b1: float = 0.9
    b2: float = 0.95
    eps: float = 1e-8
    weight_decay: float = 0.1
    clip_norm: float = 1.0
    warmup_steps: int = 100
    total_steps: int = 10_000
    min_lr_frac: float = 0.1


def tree_leaves(tree: Any) -> list[torch.Tensor]:
    """The tensors of a nested dict, in sorted-key order (as JAX flattens
    a dict)."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in tree_leaves(tree[k])]
    return [tree]


def tree_map(fn, tree: Any) -> Any:
    if isinstance(tree, dict):
        return {k: tree_map(fn, v) for k, v in tree.items()}
    return fn(tree)


def chunks(t: torch.Tensor) -> tuple[torch.Tensor, ...]:
    """Flat slices of at most CHUNK elements, in the tensor's logical order:
    views of ``t`` when it is contiguous, of a contiguous copy otherwise."""
    return t.reshape(-1).split(CHUNK)


def cosine_schedule(cfg: AdamWConfig, step: int) -> float:
    warm = step / max(1.0, cfg.warmup_steps)
    decay_steps = max(1.0, cfg.total_steps - cfg.warmup_steps)
    frac = min(max((step - cfg.warmup_steps) / decay_steps, 0.0), 1.0)
    cos = cfg.min_lr_frac + (1 - cfg.min_lr_frac) * 0.5 * (
        1 + math.cos(math.pi * frac))
    return cfg.lr * (warm if step < cfg.warmup_steps else cos)


def adamw_init(params: Any) -> dict:
    """f32 zero moments beside each param (on its device), step 0."""
    def zeros(p):
        return torch.zeros(p.shape, dtype=torch.float32, device=p.device)
    return {"mu": tree_map(zeros, params), "nu": tree_map(zeros, params),
            "step": torch.zeros((), dtype=torch.int32)}


def clip_by_global_norm(grads: list[torch.Tensor], max_norm: float
                        ) -> tuple[torch.Tensor, torch.Tensor]:
    """(scale, global norm) as 0-d f32 tensors, the norm taken in f32 over
    every grad.  The reference returns the scaled grads; here the caller
    multiplies each f32 slice by ``scale`` as it uses it, so a bf16 grad is
    never rounded after scaling."""
    sq = sum(c.float().square().sum() for g in grads for c in chunks(g))
    gnorm = torch.sqrt(sq)
    return torch.clamp(max_norm / (gnorm + 1e-9), max=1.0), gnorm


@torch.no_grad()
def adamw_update(cfg: AdamWConfig, params: Any, grads: list[torch.Tensor],
                 state: dict) -> dict:
    """One AdamW step, in place.  ``grads`` are in ``tree_leaves(params)``
    order, of any float dtype.  Returns the metrics ``grad_norm`` and
    ``lr``."""
    leaves = tree_leaves(params)
    mus, nus = tree_leaves(state["mu"]), tree_leaves(state["nu"])
    scale, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
    step = int(state["step"]) + 1
    lr = cosine_schedule(cfg, step)
    b1c = 1 - cfg.b1 ** step
    b2c = 1 - cfg.b2 ** step
    for p, g, m, v in zip(leaves, grads, mus, nus, strict=True):
        if not (p.is_contiguous() and m.is_contiguous()
                and v.is_contiguous()):
            raise ValueError("adamw_update updates contiguous tensors in "
                             "place")
        for pc, gc, mc, vc in zip(chunks(p), chunks(g), chunks(m),
                                  chunks(v)):
            gf = gc.float() * scale
            mc.mul_(cfg.b1).add_(gf, alpha=1 - cfg.b1)
            vc.mul_(cfg.b2).addcmul_(gf, gf, value=1 - cfg.b2)
            del gf
            pf = pc.float()
            upd = (mc / b1c).div_((vc / b2c).sqrt_().add_(cfg.eps))
            upd.add_(pf, alpha=cfg.weight_decay)
            pc.copy_(pf.sub_(upd, alpha=lr))
    state["step"].fill_(step)
    return {"grad_norm": gnorm, "lr": lr}
