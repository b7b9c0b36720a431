"""Hand-written CUDA kernels of the port, one package per kernel.

Each package holds ``ops.py`` (the wrapper: checks, allocation, launch on
the current stream, a launch counter) and ``ref.py`` (the plain PyTorch
version of the same function).  A CUDA tensor goes to the kernel, a CPU
tensor to the plain version.  No kernel has a backward: a wrapper raises
on either device when autograd would need a gradient through it
(``build.no_backward``).  ``build.py`` compiles ``csrc/*.cu`` with
``nvcc`` at first use.
"""
