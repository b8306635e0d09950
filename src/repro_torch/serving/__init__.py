"""Recall serving on the port: the closed-loop micro-batch engine
(scheduler → cached jagged encode → top-k) and the continuous-batching
engine over device-resident user state with incremental prefix reuse."""
from repro_torch.serving.engine import (RecallEngine, ServeResult,
                                        StreamingRecallEngine)
from repro_torch.serving.retrieval import (ShardedTopK, bytes_per_query,
                                           table_scan_bytes, topk_blocked,
                                           topk_dense, topk_from_slots)
from repro_torch.serving.scheduler import (Admission, ContinuousScheduler,
                                           MicroBatch, RequestScheduler,
                                           ServeRequest, Slot, TickPlan)
from repro_torch.serving.slot_buffer import (BucketLadder, CompileCache,
                                             SequenceBuffer)
from repro_torch.serving.state_cache import UserState, UserStateCache

__all__ = ["RecallEngine", "ServeResult", "StreamingRecallEngine",
           "ShardedTopK", "bytes_per_query", "table_scan_bytes",
           "topk_blocked", "topk_dense", "topk_from_slots", "Admission",
           "ContinuousScheduler", "MicroBatch", "RequestScheduler",
           "ServeRequest", "Slot", "TickPlan", "BucketLadder",
           "CompileCache", "SequenceBuffer", "UserState", "UserStateCache"]
