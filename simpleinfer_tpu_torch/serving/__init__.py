"""Serving layers: continuous batching over a stream of requests.

BatchingService batches image/tensor requests into bucketed forwards
(serving/batcher.py), InferenceServer exposes it and the generation
services over HTTP (serving/http.py), and GenerationService /
TieredGenerationService are the continuous-batching LLM services
(serving/llm.py)."""
from .batcher import BatchingService, BucketStats, Request, ServiceStats
from .http import InferenceServer
from .llm import (GenerationService, GenStats, StreamHandle,
                  TieredGenerationService)

__all__ = ["BatchingService", "BucketStats", "GenStats",
           "GenerationService", "InferenceServer", "Request",
           "ServiceStats", "StreamHandle", "TieredGenerationService"]
