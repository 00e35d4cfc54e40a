"""NoM on PyTorch + CUDA: the port of :mod:`repro` to one NVIDIA H100.

Module paths mirror ``repro`` (``repro_torch.core.slot_alloc`` is the
counterpart of ``repro.core.slot_alloc``, and so on).  The package
imports ``torch`` and numpy only — never ``jax`` and nothing of
``repro``.  Ported so far: the CCU's circuit setup, single stack and
multi-stack (``core``, host bookkeeping in numpy as in the reference),
the memory simulator behind the paper's Fig. 4 comparison (``memsim``),
serving ``recurrentgemma-9b``, ``mamba2-130m`` and the dense-attention
family (qwen1.5, qwen2.5, command-r-plus, gemma3) (``configs``,
``models``, ``train``, ``serving``, ``launch``), and checkpoints with
their reshard plans (``checkpoint``).  Their device kernels
are hand-written CUDA for ``sm_90a`` under ``repro_torch.kernels`` (the
slot allocator's wavefront search, slot scoring and fused per-wave
prepare; flash attention; the RG-LRU scan; the SSD scan), each beside a
plain PyTorch version that CPU tensors take.

Entry points take ``device=`` (default ``"cuda"``) and raise when no
CUDA device is present unless the caller asks for ``device="cpu"``.
"""
from .device import resolve_device

__all__ = ["resolve_device"]
