"""Config registry: ``get_bundle(arch_id, smoke=False)``."""
from __future__ import annotations

from .base import (DEFAULT_FLASH_POLICY, DEFAULT_RING_POLICY, FLASH_MODES,
                   RING_MODES, SHAPES, ArchBundle, FlashAttnPolicy, RingAttnPolicy,
                   decide_flash, decide_ring, flash_attn_policy,
                   ring_attn_policy)
from . import (granite_moe_3b, internvl2_26b, mamba2_370m, olmoe_1b_7b,
               qwen1_5_32b, qwen2_5_14b, qwen3_4b, recurrentgemma_9b,
               whisper_medium, yi_9b)

# the reference's order
_MODULES = (qwen3_4b, qwen2_5_14b, qwen1_5_32b, yi_9b, internvl2_26b,
            granite_moe_3b, olmoe_1b_7b, mamba2_370m, whisper_medium,
            recurrentgemma_9b)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get_bundle(arch_id: str, smoke: bool = False) -> ArchBundle:
    if arch_id not in REGISTRY:
        raise KeyError(f"unknown arch {arch_id!r} (known: {ARCH_IDS})")
    mod = REGISTRY[arch_id]
    return mod.smoke_bundle() if smoke else mod.full_bundle()


__all__ = ["ArchBundle", "REGISTRY", "ARCH_IDS", "SHAPES", "get_bundle",
           "FLASH_MODES", "FlashAttnPolicy", "DEFAULT_FLASH_POLICY",
           "decide_flash", "flash_attn_policy", "RING_MODES",
           "RingAttnPolicy", "DEFAULT_RING_POLICY", "decide_ring",
           "ring_attn_policy"]
