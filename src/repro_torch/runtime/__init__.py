"""Fault-tolerance runtime of the port: chaos injection, heartbeats and
elastic planning, and the fleet's tree fingerprint (copies of the
reference package's ``repro.runtime`` modules of the same names)."""
from . import chaos, fault, fleet
from .chaos import (KILL_EXIT_CODE, ChaosInjector, ChaosKilled, ChaosSpec,
                    corrupt_checkpoint, parse_chaos, split_spec_strings)
from .fault import (ElasticPlan, HeartbeatMonitor, HostState, StragglerPolicy,
                    plan_elastic_remesh)
from .fleet import tree_fingerprint

__all__ = ["KILL_EXIT_CODE", "ChaosInjector", "ChaosKilled", "ChaosSpec",
           "ElasticPlan", "HeartbeatMonitor", "HostState", "StragglerPolicy",
           "chaos", "corrupt_checkpoint", "fault", "fleet", "parse_chaos",
           "plan_elastic_remesh", "split_spec_strings", "tree_fingerprint"]
