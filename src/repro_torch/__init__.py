"""PyTorch + CUDA port of the ternary LUT-accelerator serving stack.

Mirrors ``repro`` module for module (``core/``, ``kernels/``, ``models/``,
``serving/``, ``launch/``).  The ternary projections run through
hand-written CUDA kernels for Hopper (``kernels/csrc/``) built on first use;
every kernel has a plain PyTorch twin that runs on the CPU.
"""

from repro_torch.device import resolve_device

__all__ = ["resolve_device"]
