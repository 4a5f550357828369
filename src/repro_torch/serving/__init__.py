from .engine import KV_MODES, ServeConfig, ServingEngine
from .kv import BlockPoolKV, PagedKVConfig
from .prefix import PrefixMatch, RadixPrefixCache
from .scheduler import (Phase, PhaseScheduler, PrefillJob, Request,
                        SchedulerConfig)

__all__ = ["KV_MODES", "ServeConfig", "ServingEngine",
           "BlockPoolKV", "PagedKVConfig", "PrefixMatch", "RadixPrefixCache",
           "Phase", "PhaseScheduler", "PrefillJob", "Request",
           "SchedulerConfig"]
