"""Serving layers, ported subset: the continuous-batching LLM service."""
from .llm import GenerationService, GenStats, StreamHandle

__all__ = ["GenStats", "GenerationService", "StreamHandle"]
