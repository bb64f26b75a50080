"""S2CE in PyTorch and CUDA: the port of the JAX package ``repro``.

Same subpackage layout and names as the reference; it imports neither
JAX nor ``repro``. Entry points run on the card unless the caller asks
for the CPU; the kernels under ``kernels/csrc`` are built at first use.
"""
