from repro_torch.kernels.dndm_update import ops, ref

__all__ = ["ops", "ref"]
