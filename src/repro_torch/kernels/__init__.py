"""Hand-written CUDA kernels of the port, one package per kernel.

Each package holds ``ops.py`` (the wrapper: checks, allocation, launch on
the current stream, a launch counter) and ``ref.py`` (the plain PyTorch
version of the same function).  A CUDA tensor goes to the kernel, a CPU
tensor to the plain version.  ``build.py`` compiles ``csrc/*.cu`` with
``nvcc`` at first use.
"""
