"""Serving substrate of the port: generation engine + drain-mode request
batching."""
from repro_torch.serving.engine import EngineConfig, GenerationEngine
from repro_torch.serving.scheduler import BatchScheduler, Request

__all__ = ["EngineConfig", "GenerationEngine", "BatchScheduler", "Request"]
