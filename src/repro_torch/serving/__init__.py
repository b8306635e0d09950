"""Batched jagged recall serving on the port: the closed-loop micro-batch
engine (scheduler → cached jagged encode → top-k). The continuous-batching
engine comes in a later slice."""
from repro_torch.serving.engine import RecallEngine, ServeResult
from repro_torch.serving.retrieval import (ShardedTopK, bytes_per_query,
                                           table_scan_bytes, topk_blocked,
                                           topk_dense)
from repro_torch.serving.scheduler import (MicroBatch, RequestScheduler,
                                           ServeRequest, Slot)
from repro_torch.serving.state_cache import UserState, UserStateCache

__all__ = ["RecallEngine", "ServeResult", "ShardedTopK", "bytes_per_query",
           "table_scan_bytes", "topk_blocked", "topk_dense", "MicroBatch",
           "RequestScheduler", "ServeRequest", "Slot", "UserState",
           "UserStateCache"]
