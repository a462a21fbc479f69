"""repro_torch.serving: the batched decode engine, the continuous-batching
scheduler that drives it, the hashed shared-prefix KV block store admission
reuses, and the workload/load-generation layer that measures it all under
multi-tenant traffic."""

from repro_torch.serving.engine import DecodeEngine, Request, SamplerConfig
from repro_torch.serving.loadgen import (ArrivalEvent, LoadGenerator,
                                         LoadResult, RequestRecord,
                                         generate_trace, latency_summary,
                                         percentile)
from repro_torch.serving.prefix_cache import PrefixBlockStore, PrefixStoreStats
from repro_torch.serving.scheduler import ContinuousScheduler, ScheduleBackend
from repro_torch.serving.workload import (SCENARIOS, ArrivalProcess, Dist,
                                          Scenario, TenantSpec, get_scenario)

__all__ = ["DecodeEngine", "Request", "SamplerConfig", "ContinuousScheduler",
           "ScheduleBackend", "PrefixBlockStore", "PrefixStoreStats",
           "Dist", "ArrivalProcess", "TenantSpec", "Scenario", "SCENARIOS",
           "get_scenario", "ArrivalEvent", "RequestRecord", "LoadResult",
           "LoadGenerator", "generate_trace", "percentile",
           "latency_summary"]
