"""NoM on PyTorch + CUDA: the port of :mod:`repro` to one NVIDIA H100.

Module paths mirror ``repro`` (``repro_torch.core.slot_alloc`` is the
counterpart of ``repro.core.slot_alloc``, and so on).  The package
imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Host bookkeeping stays numpy, as in the reference; the
slot allocator's three device kernels (wavefront search, slot scoring,
fused per-wave prepare) are hand-written CUDA for ``sm_90a`` under
``repro_torch.kernels.slot_alloc``, each beside a plain PyTorch version
that CPU tensors take.

Entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present unless the caller asks for ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
