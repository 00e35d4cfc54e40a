"""Hand-written CUDA kernels for the H100, each beside a plain PyTorch
version that CPU tensors take:

* slot_alloc — the PE-matrix TDM slot search, slot scoring and the fused
  per-wave CCU prepare (``kernels/slot_alloc/csrc/*.cu``)

The reference's other TPU kernels (flash attention, SSD scan, RG-LRU
scan) are not ported yet."""
