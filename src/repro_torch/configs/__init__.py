"""Config registry: ``get_bundle(arch_id, smoke=False)``."""
from __future__ import annotations

from .base import (DEFAULT_FLASH_POLICY, FLASH_MODES, ArchBundle,
                   FlashAttnPolicy, decide_flash, flash_attn_policy)
from . import qwen3_4b

_MODULES = (qwen3_4b,)

REGISTRY = {m.ARCH_ID: m for m in _MODULES}
ARCH_IDS = tuple(REGISTRY)


def get_bundle(arch_id: str, smoke: bool = False) -> ArchBundle:
    if arch_id not in REGISTRY:
        raise KeyError(f"{arch_id!r} is not ported to repro_torch yet "
                       f"(ported: {ARCH_IDS})")
    mod = REGISTRY[arch_id]
    return mod.smoke_bundle() if smoke else mod.full_bundle()


__all__ = ["ArchBundle", "REGISTRY", "ARCH_IDS", "get_bundle",
           "FLASH_MODES", "FlashAttnPolicy", "DEFAULT_FLASH_POLICY",
           "decide_flash", "flash_attn_policy"]
