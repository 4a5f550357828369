from .engine import KV_MODES, ServeConfig, ServingEngine
from .fleet import FleetConfig, LocalFleet
from .kv import BlockPoolKV, PagedKVConfig
from .prefix import (DirectoryMatch, PageOwnershipDirectory, PrefixMatch,
                     RadixPrefixCache)
from .scheduler import (Phase, PhaseScheduler, PrefillJob, Request,
                        SchedulerConfig)

__all__ = ["KV_MODES", "ServeConfig", "ServingEngine",
           "FleetConfig", "LocalFleet",
           "BlockPoolKV", "PagedKVConfig", "DirectoryMatch",
           "PageOwnershipDirectory", "PrefixMatch", "RadixPrefixCache",
           "Phase", "PhaseScheduler", "PrefillJob", "Request",
           "SchedulerConfig"]
