"""Hand-written CUDA kernels for the H100, each beside a plain PyTorch
version that CPU tensors take, all built, loaded, launched and counted by
:mod:`._lib`:

* slot_alloc — the PE-matrix TDM slot search, slot scoring and the fused
  per-wave CCU prepare (``kernels/slot_alloc/csrc/*.cu``)
* flash_attention — online-softmax GQA attention with causal, window and
  key-padding masks (``kernels/flash_attention/csrc/flash_attention.cu``)
* rglru_scan — the RG-LRU linear recurrence
  (``kernels/rglru_scan/csrc/rglru_scan.cu``)
* ssd_scan — the Mamba-2 SSD chunked scan
  (``kernels/ssd_scan/csrc/ssd_scan.cu``)

Together they replace every Pallas TPU kernel of the reference."""
