"""PyTorch/CUDA port of the FuSeConv reproduction.

Mirrors ``src/repro`` module by module (same names, NHWC at the public
functions), with every Pallas kernel replaced by a CUDA C++ kernel for
Hopper (``kernels/csrc``).  Entry points run on ``cuda`` unless the caller
passes ``device="cpu"``; on a CPU tensor each kernel wrapper runs its plain
PyTorch version instead of launching.
"""
