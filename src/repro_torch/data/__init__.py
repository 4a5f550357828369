"""Data pipeline of the port: a copy of the reference's numpy-only
synthetic LM stream and host-sharded loader."""
from .pipeline import (DataConfig, SyntheticLM, ShardedLoader, Prefetcher,
                       make_train_iterator)

__all__ = ["DataConfig", "SyntheticLM", "ShardedLoader", "Prefetcher",
           "make_train_iterator"]
