"""Serving layers: continuous batching over a stream of requests.

BatchingService batches image/tensor requests into bucketed forwards
(serving/batcher.py), InferenceServer exposes it over HTTP
(serving/http.py), and GenerationService is the continuous-batching LLM
service (serving/llm.py)."""
from .batcher import BatchingService, BucketStats, Request, ServiceStats
from .http import InferenceServer
from .llm import GenerationService, GenStats, StreamHandle

__all__ = ["BatchingService", "BucketStats", "GenStats",
           "GenerationService", "InferenceServer", "Request",
           "ServiceStats", "StreamHandle"]
