from repro_torch.kernels.ssd_scan import ops, ref

__all__ = ["ops", "ref"]
