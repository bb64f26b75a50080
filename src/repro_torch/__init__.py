"""S2CE in PyTorch and CUDA: the port of the JAX package ``repro``.

Same subpackage layout and names as the reference; it imports neither
JAX nor ``repro``. Entry points run on the card unless the caller asks
for the CPU; the kernels under ``kernels/csrc`` are built at first use.
"""

import torch


def resolve_device(device) -> torch.device:
    """``device`` as a ``torch.device``; a CUDA device must exist."""
    dev = torch.device(device)
    if dev.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError(
            "CUDA is not available; pass device='cpu' to run on the CPU")
    return dev
