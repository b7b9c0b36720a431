from repro_torch.kernels.decode_scores import ops, ref

__all__ = ["ops", "ref"]
