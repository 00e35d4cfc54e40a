// Batched PE-matrix wavefront search (the NoM slot allocator's search).
//
// Replaces: the Pallas TPU kernel repro/kernels/slot_alloc/slot_alloc.py
// (`_kernel`, launched by `wavefront_search_planes`), with the packed
// batch contract of repro/kernels/slot_alloc/ops.py
// (`wavefront_search_pallas_batch`): occ (n, 7) u32, srcs/dsts (B,) i32,
// init (B,) u32 -> (B, n) u32 busy vectors.
//
// What bounds it on an H100: neither bytes nor operations.  A wave of 64
// requests on the 8x8x4 mesh moves ~73 KB (the (B, n) output dominates),
// ~20 ns at 3.35 TB/s, and a few hundred thousand integer operations.
// The time is the launch plus a serial chain of `dist` dependent sweeps
// per request (up to X+Y+Z-3 = 13 on the paper mesh).
//
// Design: one CTA per request, so each chain lives in one SM: the
// request's vector and its three sign-chosen occupancy columns sit in
// shared memory (16 bytes per node, 4 KB at n = 256), a sweep is one
// pass of the CTA's threads over the nodes at the next lattice distance,
// and a __syncthreads() separates sweeps.  Requests of a wave run as
// independent CTAs across the SMs.
#include "slot_alloc.cuh"

namespace {

__global__ void wavefront_search_kernel(const uint32_t* __restrict__ occ,
                                        const int32_t* __restrict__ srcs,
                                        const int32_t* __restrict__ dsts,
                                        const uint32_t* __restrict__ init,
                                        uint32_t* __restrict__ out,
                                        nom::Mesh m, int n_slots) {
  extern __shared__ uint32_t smem[];
  const int n = m.n();
  uint32_t* vec = smem;
  uint32_t* occ_sel = smem + n;
  const int b = blockIdx.x;
  const nom::Request r(srcs[b], dsts[b], m);
  nom::wavefront_cta(occ, r, m, n_slots, init[b], vec, occ_sel);
  for (int v = threadIdx.x; v < n; v += blockDim.x)
    out[static_cast<size_t>(b) * n + v] = vec[v];
}

}  // namespace

extern "C" int wavefront_search_launch(const void* occ, const void* srcs,
                                       const void* dsts, const void* init,
                                       void* out, int batch, int X, int Y,
                                       int Z, int n_slots, int threads,
                                       void* stream) {
  const nom::Mesh m{X, Y, Z};
  const size_t smem = sizeof(uint32_t) * 4 * static_cast<size_t>(X * Y * Z);
  wavefront_search_kernel<<<batch, threads, smem,
                            static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(occ), static_cast<const int32_t*>(srcs),
      static_cast<const int32_t*>(dsts), static_cast<const uint32_t*>(init),
      static_cast<uint32_t*>(out), m, n_slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wavefront_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
