"""GNN inference serving on the port: continuous batching, L-hop
subgraph inference on the card, degree-aware result caching, and the
async SLO-driven pipeline with replication and workload generation."""
from repro_torch.serving.batcher import (AdmittedBatch, GNNBatcher, Request,
                                         Response)
from repro_torch.serving.cache import DegreeAwareCache
from repro_torch.serving.engine import GNNServingEngine, ServingConfig
from repro_torch.serving.pipeline import ServingPipeline
from repro_torch.serving.replicate import ReplicatedServer
from repro_torch.serving.workload import (TimedRequest, WorkloadSpec,
                                          make_trace, replay_closed,
                                          replay_timed)

__all__ = ["AdmittedBatch", "GNNBatcher", "Request", "Response",
           "DegreeAwareCache", "GNNServingEngine", "ServingConfig",
           "ServingPipeline", "ReplicatedServer", "TimedRequest",
           "WorkloadSpec", "make_trace", "replay_closed", "replay_timed"]
