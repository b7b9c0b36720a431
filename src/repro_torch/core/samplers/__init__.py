"""Reverse-process samplers of the port: the DNDM family.

``registry`` maps method names to :class:`~repro_torch.core.samplers.
registry.SamplerSpec` entries; ``loop`` is the shared sampler skeleton.
"""
from repro_torch.core.samplers import dndm, loop, registry
from repro_torch.core.samplers.base import (DenoiseFn, SamplerConfig,
                                            SamplerOutput, init_noise_tokens)

__all__ = ["dndm", "loop", "registry", "DenoiseFn", "SamplerConfig",
           "SamplerOutput", "init_noise_tokens"]
