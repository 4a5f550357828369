"""Fault-tolerance runtime of the port: chaos injection, heartbeats and
elastic planning, the fleet's heartbeat files, stripe and page exchanges
and tree fingerprint, and the process supervisor (copies of the reference
package's ``repro.runtime`` modules of the same names)."""
from . import chaos, fault, fleet, supervisor
from .chaos import (KILL_EXIT_CODE, ChaosInjector, ChaosKilled, ChaosSpec,
                    corrupt_checkpoint, parse_chaos, split_spec_strings)
from .fault import (ElasticPlan, HeartbeatMonitor, HostState, StragglerPolicy,
                    plan_elastic_remesh)
from .fleet import (FleetWorker, LocalPageExchange, LocalStripeExchange,
                    PageCorruptError, PageExchangeTimeout,
                    StripeExchangeTimeout, TcpPageExchange,
                    TcpStripeExchange, allocate_ports, decode_page_frame,
                    encode_page_frame, read_heartbeat, tree_fingerprint)
from .supervisor import LaunchSpec, RestartPolicy, Supervisor, write_report

__all__ = ["KILL_EXIT_CODE", "ChaosInjector", "ChaosKilled", "ChaosSpec",
           "ElasticPlan", "FleetWorker", "HeartbeatMonitor", "HostState",
           "LaunchSpec", "LocalPageExchange", "LocalStripeExchange",
           "PageCorruptError", "PageExchangeTimeout", "RestartPolicy",
           "StragglerPolicy", "StripeExchangeTimeout", "Supervisor",
           "TcpPageExchange", "TcpStripeExchange", "allocate_ports", "chaos",
           "corrupt_checkpoint", "decode_page_frame", "encode_page_frame",
           "fault", "fleet", "parse_chaos", "plan_elastic_remesh",
           "read_heartbeat", "split_spec_strings", "supervisor",
           "tree_fingerprint", "write_report"]
