// Slot scoring: for each (request, arrival slot), the earliest injection
// cycle >= t_ready whose circuit arrives at that slot; kFar32 for a busy
// slot.  argmin over a row (lowest slot on ties) is the slot choice.
//
// Replaces: the Pallas TPU kernel repro/kernels/slot_alloc/fused.py
// (`_score_kernel`, launched by `slot_score_planes`) on its packed
// contract: avail (B,) u32, dists (B,) i32, t_ready (B,) i32 ->
// (B, n_slots) i32 (the TPU kernel's 128-lane planes cut to n_slots).
//
// What bounds it on an H100: launch latency.  A 64-request wave reads
// 768 bytes and writes 4 KB (~1.5 ns at 3.35 TB/s) and does ~10 integer
// operations per output element.
//
// Design: one thread per (request, slot) element, the arithmetic in the
// __device__ function nom::slot_cost that the fused prepare kernel
// calls too, so both score bit-identically.  The int32 sums are exact
// while t_ready < 2**31 - 2*n_slots; the caller guards that bound.
#include "slot_alloc.cuh"

namespace {

__global__ void slot_score_kernel(const uint32_t* __restrict__ avail,
                                  const int32_t* __restrict__ dists,
                                  const int32_t* __restrict__ t_ready,
                                  int32_t* __restrict__ cost, int batch,
                                  int n_slots) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= batch * n_slots) return;
  const int b = i / n_slots;
  cost[i] = nom::slot_cost(avail[b], dists[b], t_ready[b], i % n_slots,
                           n_slots);
}

}  // namespace

extern "C" int slot_score_launch(const void* avail, const void* dists,
                                 const void* t_ready, void* cost, int batch,
                                 int n_slots, void* stream) {
  const int threads = 256;
  const int blocks = (batch * n_slots + threads - 1) / threads;
  slot_score_kernel<<<blocks, threads, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(avail), static_cast<const int32_t*>(dists),
      static_cast<const int32_t*>(t_ready), static_cast<int32_t*>(cost), batch,
      n_slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* slot_score_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
