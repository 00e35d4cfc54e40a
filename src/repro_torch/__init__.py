"""NoM on PyTorch + CUDA: the port of :mod:`repro` to one NVIDIA H100.

Module paths mirror ``repro`` (``repro_torch.core.slot_alloc`` is the
counterpart of ``repro.core.slot_alloc``, and so on).  The package
imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Two slices are ported: the CCU's circuit setup
(``core``, host bookkeeping in numpy as in the reference) and serving
``recurrentgemma-9b`` (``configs``, ``models``, ``train``, ``serving``,
``launch``).  Their device kernels are hand-written CUDA for ``sm_90a``
under ``repro_torch.kernels`` (the slot allocator's wavefront search,
slot scoring and fused per-wave prepare; flash attention; the RG-LRU
scan), each beside a plain PyTorch version that CPU tensors take.

Entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present unless the caller asks for ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
