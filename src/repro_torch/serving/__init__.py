"""Out-of-core GNN inference serving over the Helios cache/IO stack.

Request lifecycle: ``submit`` -> SLO-aware admission (``scheduler``) ->
micro-batching with cross-request node dedup (``batcher``) -> one planned
gather through the 3-tier ``HeteroCache`` -> forward step -> per
request scatter-back + latency accounting (``stats``).
"""
from repro_torch.serving.scheduler import (BULK, INTERACTIVE, PriorityClass,
                                     ServeRequest, SLOScheduler,
                                     zipf_workload)
from repro_torch.serving.service import GNNInferenceServer, ServerConfig
from repro_torch.serving.stats import ServingStats

__all__ = ["GNNInferenceServer", "ServerConfig", "ServingStats",
           "SLOScheduler", "ServeRequest", "PriorityClass",
           "INTERACTIVE", "BULK", "zipf_workload"]
