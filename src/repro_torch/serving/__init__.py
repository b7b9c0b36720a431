"""Serving substrate of the port: generation engine, drain-mode and
continuous request batching."""
from repro_torch.serving.engine import (EngineConfig, GenerationEngine,
                                        StepwiseRunner)
from repro_torch.serving.scheduler import (BatchScheduler,
                                           ContinuousScheduler, Request)

__all__ = ["EngineConfig", "GenerationEngine", "StepwiseRunner",
           "BatchScheduler", "ContinuousScheduler", "Request"]
