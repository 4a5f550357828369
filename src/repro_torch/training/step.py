"""Training step factory: loss, microbatch accumulation, AdamW with the
nonfinite skip, and the host-side GradGuard.

Counterpart of ``repro.training.step`` on one device.  The returned
``train_step(params, opt_state, batch, grad_scale=None) -> (params,
opt_state, metrics)`` runs eagerly and updates ``params`` and
``opt_state`` in place (it returns the same dicts).  Per-layer activation
checkpointing is the model's (``transformer.forward`` under grad).

Nonfinite guard: every step forms a FINITE flag over the loss and every
grad and reads it on the host once; when any value is nonfinite, the
update is not applied, so params, moments and the schedule step stay
byte-identical — a NaN burst skips a step instead of training the model
into garbage.  :class:`GradGuard` consumes the flag plus the loss each step
and escalates: a bounded budget of consecutive skips, then rollback; a
sustained loss spike above the running EMA, then rollback.
"""
from __future__ import annotations

import dataclasses
import math
from typing import Any, Callable

import torch

from repro_torch.obs import REGISTRY
from repro_torch.optim import (AdamWConfig, adamw_update,
                               clip_by_global_norm, cosine_schedule)
from repro_torch.optim.adamw import chunks, tree_leaves


@dataclasses.dataclass(frozen=True)
class TrainHyper:
    optimizer: AdamWConfig = AdamWConfig()
    microbatches: int = 1
    aux_weight: float = 0.01      # MoE load-balance loss weight
    z_weight: float = 1e-4        # z-loss for logit stability


def loss_fn(forward: Callable, params: Any, batch: dict,
            aux_weight: float = 0.01, z_weight: float = 1e-4) -> tuple:
    """Next-token CE + MoE aux + z-loss. forward(params, batch)->(logits,aux).

    The label logit is a ``gather``: the reference's masked sum over the
    vocab axis exists only to keep GSPMD from all-gathering vocab-sharded
    logits, and gives the same value."""
    logits, aux = forward(params, batch)
    labels = batch["labels"]
    T = labels.shape[1]
    logits = logits[:, -T:].float()
    logz = torch.logsumexp(logits, dim=-1)
    at_label = logits.gather(-1, labels[..., None].long())[..., 0]
    ce = (logz - at_label).mean()
    zloss = (logz ** 2).mean()
    return ce + aux_weight * aux + z_weight * zloss, (ce, aux)


def _all_finite(t: torch.Tensor) -> torch.Tensor:
    ok = torch.ones((), dtype=torch.bool, device=t.device)
    for c in chunks(t):
        ok &= torch.isfinite(c).all()
    return ok


def make_train_step(forward: Callable, hyper: TrainHyper) -> Callable:
    """forward(params, batch) -> (logits, aux)."""

    def grad_fn(params, leaves, batch):
        loss, (ce, aux) = loss_fn(forward, params, batch,
                                  aux_weight=hyper.aux_weight,
                                  z_weight=hyper.z_weight)
        grads = torch.autograd.grad(loss, leaves)
        # a MoE forward's aux is a tensor of the graph: keep none of it
        if torch.is_tensor(aux):
            aux = aux.detach()
        return loss.detach(), ce.detach(), aux, list(grads)

    def compute_grads(params, leaves, batch):
        mb = hyper.microbatches
        if mb == 1:
            return grad_fn(params, leaves, batch)
        for x in batch.values():
            if x.shape[0] % mb:
                raise ValueError(f"batch {x.shape[0]} does not split into "
                                 f"{mb} microbatches")
        # f32 accumulator, averaged over microbatches, as the reference
        acc = [torch.zeros(p.shape, dtype=torch.float32, device=p.device)
               for p in leaves]
        loss_a = ce_a = aux_a = 0.0
        for i in range(mb):
            micro = {k: x.reshape(mb, x.shape[0] // mb, *x.shape[1:])[i]
                     for k, x in batch.items()}
            loss, ce, aux, g = grad_fn(params, leaves, micro)
            for a, gi in zip(acc, g):
                a += gi
            del g
            loss_a, ce_a, aux_a = loss_a + loss, ce_a + ce, aux_a + aux
        inv = 1.0 / mb
        return loss_a * inv, ce_a * inv, aux_a * inv, [a.mul_(inv)
                                                       for a in acc]

    def train_step(params, opt_state, batch, grad_scale=None):
        leaves = tree_leaves(params)
        for p in leaves:
            p.requires_grad_(True)
        try:
            loss, ce, aux, grads = compute_grads(params, leaves, batch)
        finally:
            for p in leaves:
                p.requires_grad_(False)
        if grad_scale is not None and float(grad_scale) != 1.0:
            # fault-injection hook: the chaos runtime feeds NaN here so the
            # guard below is exercised end-to-end (1.0 in normal operation,
            # where the product would change nothing)
            grads = [g.float() * float(grad_scale) for g in grads]
        finite = torch.isfinite(loss)
        for g in grads:
            finite &= _all_finite(g)
        cfg = hyper.optimizer
        if bool(finite):                  # the step's one host read
            om = adamw_update(cfg, params, grads, opt_state)
        else:
            # skip-step: params, moments AND the schedule step untouched;
            # the metrics are those the update would have reported
            _, gnorm = clip_by_global_norm(grads, cfg.clip_norm)
            om = {"grad_norm": gnorm,
                  "lr": cosine_schedule(cfg, int(opt_state["step"]) + 1)}
        metrics = {"loss": loss, "ce": ce, "aux": aux,
                   "finite": finite.float(), **om}
        return params, opt_state, metrics

    return train_step


# ---------------------------------------------------------------------------
# host-side escalation: skip budget + loss-spike divergence -> rollback
# ---------------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class GuardPolicy:
    max_consecutive_skips: int = 3   # nonfinite steps in a row before rollback
    spike_factor: float = 3.0        # loss > factor * EMA counts as a spike
    spike_patience: int = 3          # consecutive spikes before rollback
    ema_beta: float = 0.9            # loss EMA decay
    warmup_steps: int = 5            # steps before spike detection arms


class GradGuard:
    """Consumes (loss, finite) once per step; returns the loop's action:

    ``"ok"``        update applied, loss healthy
    ``"skip"``      nonfinite step — params were not updated (the step's
                    finite guard); within the consecutive-skip budget
    ``"rollback"``  skip budget exhausted, or the loss has spiked above
                    ``spike_factor`` x its EMA for ``spike_patience``
                    consecutive steps — restore the last checkpoint

    Pure host-side state so policies are unit-testable without a model;
    call :meth:`reset` after acting on a rollback.
    """

    def __init__(self, policy: GuardPolicy = GuardPolicy()):
        self.policy = policy
        self.ema: float | None = None
        self.steps = 0
        self.consecutive_skips = 0
        self.consecutive_spikes = 0
        # what caused the most recent skip/rollback — the train loop logs
        # it with the step index and it labels the gradguard_events
        # counters in the metrics registry
        self.last_trigger: str | None = None

    def update(self, loss: float, finite: bool) -> str:
        p = self.policy
        if not finite or not math.isfinite(loss):
            self.consecutive_skips += 1
            if self.consecutive_skips > p.max_consecutive_skips:
                self.last_trigger = "skip_budget"
                REGISTRY.counter("gradguard_events", kind="rollback",
                                 trigger="skip_budget")
                return "rollback"
            self.last_trigger = "nonfinite"
            REGISTRY.counter("gradguard_events", kind="skip",
                             trigger="nonfinite")
            return "skip"
        self.consecutive_skips = 0
        self.steps += 1
        if self.ema is None:
            self.ema = loss
            return "ok"
        if self.steps > p.warmup_steps and loss > p.spike_factor * self.ema:
            # diverging: don't fold the spike into the EMA (that would
            # normalize the divergence it is trying to detect)
            self.consecutive_spikes += 1
            if self.consecutive_spikes >= p.spike_patience:
                self.last_trigger = "loss_spike"
                REGISTRY.counter("gradguard_events", kind="rollback",
                                 trigger="loss_spike")
                return "rollback"
            return "ok"
        self.consecutive_spikes = 0
        self.ema = p.ema_beta * self.ema + (1 - p.ema_beta) * loss
        return "ok"

    def reset(self) -> None:
        """Forget history after a rollback (the restored state's loss scale
        may differ from the diverged one's)."""
        self.ema = None
        self.steps = 0
        self.consecutive_skips = 0
        self.consecutive_spikes = 0
