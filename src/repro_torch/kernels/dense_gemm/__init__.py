from repro_torch.kernels.dense_gemm import ops, ref

__all__ = ["ops", "ref"]
