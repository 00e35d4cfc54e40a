// Batched PE-matrix wavefront search (the NoM slot allocator's search).
//
// Replaces: the Pallas TPU kernel repro/kernels/slot_alloc/slot_alloc.py
// (`_kernel`, launched by `wavefront_search_planes`), with the packed
// batch contract of repro/kernels/slot_alloc/ops.py
// (`wavefront_search_pallas_batch`): occ (n, 7) u32, srcs/dsts (B,) i32,
// init (B,) u32 -> (B, n) u32 busy vectors.
//
// Design: a wave of 64 requests on the 8x8x4 mesh moves ~73 KB, ~20 ns
// at 3.35 TB/s; what takes the time is, per request, a chain of `dist`
// dependent lattice layers (up to X+Y+Z-3 = 17 on the paper mesh) and
// the launch.  So one warp walks one request's chain, and nom::kWarps
// requests share a CTA.  The CTA stages the wave's occupancy table into
// shared memory once (cp.async, one barrier) for its warps; each warp
// runs nom::wavefront_warp over its request's box (one node per lane
// per layer on the paper mesh, neighbours by warp shuffles) and writes
// the box nodes of its (n,) row, which it filled with the all-busy mask,
// coalesced, while the staging was in flight.  A one-request wave is one
// CTA.
//
// The entry point also moves the wave's data when given host buffers:
// the packed request words [srcs | dsts | init] up before the launch and
// the (B, n) result down after it, on the same stream.
#include "slot_alloc.cuh"

namespace {

__global__ void __launch_bounds__(nom::kThreads)
wavefront_search_kernel(const uint32_t* __restrict__ occ,
                        const int32_t* __restrict__ req,
                        uint32_t* __restrict__ out, nom::Mesh m, int n_slots,
                        int batch) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = m.n();
  uint32_t* occ_s = smem;
  const int w = threadIdx.x >> 5;
  const int b = blockIdx.x * nom::kWarps + w;
  const bool live = b < batch;
  uint32_t* row = out + static_cast<size_t>(b) * n;
  // The request's words are read, and its row filled, before the
  // staging, so both hide under its latency.
  const int src = live ? req[b] : 0, dst = live ? req[batch + b] : 0;
  const int init = live ? req[2 * batch + b] : 0;
  if (live) nom::fill_row(n, n_slots, row);
  nom::stage_occupancy(occ, n, occ_s);
  if (!live) return;
  uint32_t* vec = occ_s + n * nom::kNPorts + w * n;
  const nom::Request r(src, dst, m);
  nom::wavefront_warp<false>(occ_s, r, n_slots, static_cast<uint32_t>(init),
                             vec, row, nom::Trace{});
}

// An empty kernel on the search's grid: the launch floor of the same
// ctypes path.
__global__ void launch_floor_kernel() {}

int ctas(int batch) { return (batch + nom::kWarps - 1) / nom::kWarps; }

}  // namespace

extern "C" int wavefront_search_launch(const void* occ, void* req,
                                       const void* req_host, void* out,
                                       void* out_host, int batch, int X,
                                       int Y, int Z, int n_slots,
                                       void* stream) {
  const nom::Mesh m{X, Y, Z};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (req_host)
    err = cudaMemcpyAsync(req, req_host, sizeof(int32_t) * 3 * batch,
                          cudaMemcpyHostToDevice, s);
  const size_t smem = nom::smem_bytes(m, false);
  if (!err && smem > 48 * 1024)
    err = cudaFuncSetAttribute(wavefront_search_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err) return static_cast<int>(err);
  wavefront_search_kernel<<<ctas(batch), nom::kThreads, smem, s>>>(
      static_cast<const uint32_t*>(occ), static_cast<const int32_t*>(req),
      static_cast<uint32_t*>(out), m, n_slots, batch);
  err = cudaGetLastError();
  if (!err && out_host)
    err = cudaMemcpyAsync(out_host, out,
                          sizeof(uint32_t) * batch * static_cast<size_t>(m.n()),
                          cudaMemcpyDeviceToHost, s);
  return static_cast<int>(err);
}

extern "C" int wavefront_search_floor_launch(int batch, void* stream) {
  launch_floor_kernel<<<ctas(batch), nom::kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>();
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* wavefront_search_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
