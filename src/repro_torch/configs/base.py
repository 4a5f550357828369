"""Architecture bundles and the flash-attention policy.

Counterpart of ``repro.configs.base`` for the families this port has
(the dense transformer).  A bundle wires a model family to the server:

  * ``init_params(seed, device)``  — random weights drawn on the device
  * ``forward(params, batch)``     — (logits, aux)
  * ``prefill`` / ``decode_step``  — dense-cache serving steps
  * ``init_paged_pool`` / ``paged_step`` — paged serving steps
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
    kind: str                   # dense (the only kind ported so far)
    cfg: Any
    family: Any                 # model module

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

    # -- steps -------------------------------------------------------------
    def forward(self, params, batch):
        return self.family.forward(self.cfg, params, batch["tokens"])

    def init_cache(self, batch: int, max_len: int, kv_dtype=None,
                   device=None):
        return self.family.init_cache(self.cfg, batch, max_len,
                                      kv_dtype=kv_dtype, device=device)

    def prefill(self, params, tokens, cache, true_lengths=None):
        if true_lengths is not None and not self.prefill_supports_true_lengths:
            raise ValueError(
                f"{self.arch_id}: family does not support bucketed "
                "(true_lengths) prefill")
        kw = {} if true_lengths is None else {"true_lengths": true_lengths}
        return self.family.prefill(self.cfg, params, tokens, cache, **kw)

    def decode_step(self, params, tokens, cache):
        return self.family.decode_step(self.cfg, params, tokens, cache)

    # -- serving capabilities ---------------------------------------------
    @property
    def prefill_supports_true_lengths(self) -> bool:
        return bool(getattr(self.family, "PREFILL_TRUE_LENGTHS", False))

    @property
    def supports_paged_kv(self) -> bool:
        return bool(getattr(self.family, "SUPPORTS_PAGED_KV", False))

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
