"""Architecture bundles and the flash-attention policy.

Counterpart of ``repro.configs.base``.  A bundle wires a model family
(transformer — dense, MoE or the vision-prefix backbone — / mamba2 /
recurrentgemma / whisper) to the server and the trainer:

  * ``init_params(seed, device)``  — random weights drawn on the device
  * ``forward(params, batch)``     — (logits, aux)
  * ``prefill`` / ``decode_step``  — dense-cache serving steps
  * ``init_paged_pool`` / ``paged_step`` — paged serving steps
  * ``supports(shape)``            — long_500k only for sub-quadratic archs
"""
from __future__ import annotations

import dataclasses
import os
from typing import Any

import torch

from repro_torch.device import resolve_device

# ---------------------------------------------------------------------------
# Flash-attention policy (the hand-written flash kernel vs the plain paths)
#
# Callers resolve a policy (explicit argument > REPRO_FLASH_ATTN env >
# default) instead of flag-flipping module state.  The three mode names are
# the reference's; in this port ``pallas`` names the hand-written Hopper
# kernel (kernels/csrc/flash_fwd.cu), and ``xla`` the plain PyTorch paths.
# ---------------------------------------------------------------------------

FLASH_MODES = ("auto", "pallas", "xla")


@dataclasses.dataclass(frozen=True)
class FlashAttnPolicy:
    """Which attention engine ``models.layers.attention`` dispatches to.

    mode:
      * ``auto``   — the CUDA kernel for tensors on a CUDA device and
        sequences at least ``min_seq`` long (below it the plain full-mask
        path is used, as in the reference); the plain paths on the CPU.
      * ``pallas`` — always the kernel (its plain version on the CPU).
      * ``xla``    — never; the plain PyTorch paths.
    """
    mode: str = "auto"
    min_seq: int = 1024


DEFAULT_FLASH_POLICY = FlashAttnPolicy()


def flash_attn_policy(mode_override: str | None = None) -> FlashAttnPolicy:
    """Resolve the active flash-attention policy.  Precedence: explicit
    ``mode_override`` (e.g. ``TransformerConfig.attn_impl``) >
    ``REPRO_FLASH_ATTN`` env var > default; ``REPRO_FLASH_ATTN_MIN_SEQ``
    tunes the ``auto`` threshold."""
    mode = (mode_override or os.environ.get("REPRO_FLASH_ATTN")
            or DEFAULT_FLASH_POLICY.mode)
    if mode not in FLASH_MODES:
        raise ValueError(f"flash-attention mode {mode!r} not in "
                         f"{FLASH_MODES}")
    ms = int(os.environ.get("REPRO_FLASH_ATTN_MIN_SEQ",
                            DEFAULT_FLASH_POLICY.min_seq))
    return FlashAttnPolicy(mode=mode, min_seq=ms)


def decide_flash(policy: FlashAttnPolicy, *, seq_len: int, kv_len: int,
                 on_cuda: bool) -> str:
    """'pallas' (the hand-written kernel) or 'xla' for one attention call.
    ``auto`` requires the tensors to be on a CUDA device and a sequence
    long enough to amortize the launch (the reference's rule, with the
    TPU replaced by the CUDA card)."""
    if policy.mode != "auto":
        return policy.mode
    if on_cuda and max(seq_len, kv_len) >= policy.min_seq:
        return "pallas"
    return "xla"


@dataclasses.dataclass
class ArchBundle:
    arch_id: str
    kind: str                   # dense | moe | vlm | ssm | audio | hybrid
    cfg: Any
    family: Any                 # model module
    sub_quadratic: bool = False
    kv_dtype_decode: Any = None  # e.g. torch.int8 for big dense decode
    extras: dict = dataclasses.field(default_factory=dict)

    # -- params ------------------------------------------------------------
    def init_params(self, seed: int = 0, device=None) -> dict:
        """Random weights from ``seed``, drawn on ``device`` (default: the
        CUDA card; raises when there is none — pass ``device='cpu'``)."""
        dev = resolve_device(device)
        gen = torch.Generator(device=dev)
        gen.manual_seed(seed)
        return self.family.init_params(self.cfg, gen, dev)

    def param_count(self) -> int:
        return self.cfg.param_count()

    def active_param_count(self) -> int:
        if hasattr(self.cfg, "active_param_count"):
            return self.cfg.active_param_count()
        return self.param_count()

    # -- steps -------------------------------------------------------------
    def forward(self, params, batch):
        if self.kind == "audio":
            return self.family.forward(self.cfg, params, batch["tokens"],
                                       batch["frames"])
        if self.kind == "vlm":
            return self.family.forward(self.cfg, params, batch["tokens"],
                                       vision_embeds=batch["vision"])
        return self.family.forward(self.cfg, params, batch["tokens"])

    def init_cache(self, batch: int, max_len: int, kv_dtype=None,
                   device=None):
        return self.family.init_cache(self.cfg, batch, max_len,
                                      kv_dtype=kv_dtype, device=device)

    def prefill(self, params, tokens, cache, batch_extras=None,
                true_lengths=None):
        if true_lengths is not None and not self.prefill_supports_true_lengths:
            raise ValueError(
                f"{self.arch_id}: family does not support bucketed "
                "(true_lengths) prefill")
        extras = batch_extras or {}
        if self.kind == "audio":
            return self.family.prefill(self.cfg, params, tokens, cache,
                                       extras["frames"])
        if self.kind == "vlm":
            kw = {}
            if true_lengths is not None:
                # the vision prefix is prepended inside prefill, so true
                # sequence lengths shift by the (fixed) prefix size
                vis = extras.get("vision")
                off = vis.shape[1] if vis is not None else 0
                kw["true_lengths"] = true_lengths + off
            return self.family.prefill(self.cfg, params, tokens, cache,
                                       vision_embeds=extras.get("vision"),
                                       **kw)
        kw = {} if true_lengths is None else {"true_lengths": true_lengths}
        return self.family.prefill(self.cfg, params, tokens, cache, **kw)

    def decode_step(self, params, tokens, cache):
        return self.family.decode_step(self.cfg, params, tokens, cache)

    # -- serving capabilities ---------------------------------------------
    @property
    def prefill_supports_true_lengths(self) -> bool:
        """Whether prefill accepts length-bucketed padded prompts (KV
        caches with per-position writes; SSM states do not qualify)."""
        return bool(getattr(self.family, "PREFILL_TRUE_LENGTHS", False)) \
            and self.kind != "audio"

    @property
    def supports_paged_kv(self) -> bool:
        # vlm excluded: the vision prefix enters through dense prefill's
        # embedding concat; the paged chunked-prefill path is token-only.
        return bool(getattr(self.family, "SUPPORTS_PAGED_KV", False)) \
            and self.kind != "vlm"

    def init_paged_pool(self, num_pages: int, page_size: int, kv_dtype=None,
                        device=None):
        return self.family.init_paged_pool(self.cfg, num_pages, page_size,
                                           kv_dtype=kv_dtype, device=device)

    def paged_step(self, params, tokens, pool, page_table, lengths, counts):
        return self.family.paged_step(self.cfg, params, tokens, pool,
                                      page_table, lengths, counts)

    def cache_batch_axes(self, cache) -> dict:
        """Batch-axis index for every cache entry (pooled slot writes).
        Families declare ``CACHE_BATCH_AXES``; unknown keys fall back to
        axis 0 for 1-D entries, else axis 1."""
        declared = getattr(self.family, "CACHE_BATCH_AXES", {})
        return {k: declared.get(k, 0 if v.dim() == 1 else 1)
                for k, v in cache.items()}

    # -- shapes ------------------------------------------------------------
    def supports(self, shape_name: str) -> tuple[bool, str]:
        if shape_name == "long_500k" and not self.sub_quadratic:
            return False, ("full quadratic attention: 512k decode cache "
                           "infeasible; run on SSM/hybrid archs only "
                           "(see DESIGN.md §Arch-applicability)")
        return True, ""
