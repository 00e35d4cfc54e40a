// The fused per-wave CCU prepare: wavefront search, slot scoring, argmin
// slot choice and lockstep trace-back in ONE launch per search wave.
//
// Replaces: repro/kernels/slot_alloc/fused.py `fused_prepare_program`, a
// jit program that on the TPU (kernel="pallas") chains the Pallas
// wavefront kernel (slot_alloc.py `_kernel`), the Pallas scoring kernel
// (`_score_kernel`) and the `_traceback_scan` lax.scan.  Outputs keep its
// packing, as one result buffer of int32 words: ints (B, 3 + 3L) =
// [starts, arr, dists, hop_n[L], hop_p[L], hop_s[L]] with L = max_dist +
// 1, then flags (B, 2 + n_slots) bytes = [denied, ok, free[n_slots]];
// vecs (B, n) u32 apart, for the host's extra-slot bundles.
//
// Design: a 64-request wave on the 8x8x4 mesh reads 7 KB of occupancy
// and writes ~80 KB (vecs dominate), tens of nanoseconds at 3.35 TB/s;
// what takes the time is, per request, `dist` dependent lattice layers,
// a `dist`-step serial trace-back, and the launch.  So one warp takes
// one request, nom::kWarps requests per CTA, sharing the occupancy the
// CTA stages into shared memory once.  The warp runs
// the search as wavefront_search.cu does (nom::wavefront_warp), into its
// vecs row (filled with the all-busy mask while the staging was in
// flight), and keeps two trace-back masks per box node beside each
// node's vector: for every slot the walk could hold there, which
// upstream neighbour it would step to (nom::Trace).  Then:
//   - it scores the arrival slots one per lane with the same
//     nom::slot_cost as slot_score.cu; the first minimum (lowest slot on
//     ties, the reference's argmin) comes from __reduce_min_sync,
//     __ballot_sync and __ffs, and the lanes write the free flags;
//   - it zero-fills the hop entries past `dist` in parallel;
//   - lane 0 walks the trace-back, three shared-memory reads at one
//     address a step: the first free dimension in x -> y -> z order,
//     exactly the scan's step semantics, including the outputs of rows
//     whose walk fails.
// The entry point also moves the wave's data when given host buffers:
// the packed request words [srcs | dsts | t_ready] up before the launch
// and the result buffer down after it, on the same stream.
#include "slot_alloc.cuh"

namespace {

__global__ void __launch_bounds__(nom::kThreads)
fused_prepare_kernel(const uint32_t* __restrict__ occ,
                     const int32_t* __restrict__ req,
                     int32_t* __restrict__ res,
                     uint32_t* __restrict__ vecs, nom::Mesh m, int n_slots,
                     int batch) {
  extern __shared__ __align__(16) uint32_t smem[];
  const int n = m.n();
  uint32_t* occ_s = smem;
  const int w = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int b = blockIdx.x * nom::kWarps + w;
  const bool live = b < batch;
  uint32_t* vrow = vecs + static_cast<size_t>(b) * n;
  // The request's words are read, and its vecs row filled, before the
  // staging, so both hide under its latency.
  const int src = live ? req[b] : 0, dst = live ? req[batch + b] : 0;
  const int t_ready = live ? req[2 * batch + b] : 0;
  if (live) nom::fill_row(n, n_slots, vrow);
  nom::stage_occupancy(occ, n, occ_s);
  if (!live) return;
  uint32_t* vec = occ_s + n * nom::kNPorts + w * n;
  const nom::Trace tr{occ_s + n * (nom::kNPorts + nom::kWarps + 2 * w),
                      occ_s + n * (nom::kNPorts + nom::kWarps + 2 * w + 1)};
  const nom::Request r(src, dst, m);
  nom::wavefront_warp<true>(occ_s, r, n_slots, 0u, vec, vrow, tr);

  const int L = m.X + m.Y + m.Z - 2;
  int32_t* row = res + static_cast<size_t>(b) * (3 + 3 * L);
  int32_t* hop_n = row + 3;
  int32_t* hop_p = hop_n + L;
  int32_t* hop_s = hop_p + L;
  uint8_t* frow = reinterpret_cast<uint8_t*>(
                      res + static_cast<size_t>(batch) * (3 + 3 * L))
                  + static_cast<size_t>(b) * (2 + n_slots);

  // -- slot scoring + argmin: lane s scores slot s ------------------------
  const int last = r.box_size() - 1;           // the destination's box index
  const uint32_t avail =
      vec[last] | occ_s[r.dst * nom::kNPorts + nom::kPortLocal];
  const int32_t c = lane < n_slots
                        ? nom::slot_cost(avail, r.dist, t_ready, lane, n_slots)
                        : nom::kFar32;
  const int32_t best = __reduce_min_sync(nom::kAll, c);
  const int arr = __ffs(__ballot_sync(nom::kAll, c == best)) - 1;
  const bool any_free = __ballot_sync(nom::kAll, c != nom::kFar32) != 0;
  if (lane < n_slots) frow[2 + lane] = c != nom::kFar32;
  for (int k = r.dist + 1 + lane; k < L; k += 32)
    hop_n[k] = hop_p[k] = hop_s[k] = 0;
  if (lane != 0) return;

  // -- trace-back: one step per hop, forward hop t written at step
  //    dist-1-t; the last entry is (dst, LOCAL, arrival slot) ----------
  hop_n[r.dist] = r.dst;
  hop_p[r.dist] = nom::kPortLocal;
  hop_s[r.dist] = arr;
  // The walk carries its box index, node id and slot; each step reads
  // its node's busy bit and choice bits at the slot it holds.  A node
  // with no free upstream neighbour (the source, or where the walk
  // fails) holds the walk for good, so it ends at the source exactly
  // when no step failed.
  int li = last;
  int v = r.dst;
  int j = arr;
  for (int step = 0; step < r.dist; ++step) {
    const int jp = j == 0 ? n_slots - 1 : j - 1;
    const bool stop = (vec[li] >> j) & 1u;
    const bool y = (tr.ys[li] >> j) & 1u, z = (tr.zs[li] >> j) & 1u;
    li -= stop ? 0 : (y ? r.bstride[1] : (z ? r.bstride[2] : 1));
    v -= stop ? 0 : (y ? r.step[1] : (z ? r.step[2] : r.step[0]));
    j = stop ? j : jp;
    const int pos = r.dist - 1 - step;
    hop_n[pos] = v;
    hop_p[pos] = y ? r.port[1] : (z ? r.port[2] : r.port[0]);
    hop_s[pos] = jp;
  }
  const bool ok = v == r.src;
  row[0] = best;
  row[1] = arr;
  row[2] = r.dist;
  frow[0] = !any_free;
  frow[1] = ok;
}

}  // namespace

extern "C" int fused_prepare_launch(const void* occ, void* req,
                                    const void* req_host, void* res,
                                    void* res_host, void* vecs, int batch,
                                    int X, int Y, int Z, int n_slots,
                                    void* stream) {
  const nom::Mesh m{X, Y, Z};
  const auto s = static_cast<cudaStream_t>(stream);
  cudaError_t err = cudaSuccess;
  if (req_host)
    err = cudaMemcpyAsync(req, req_host, sizeof(int32_t) * 3 * batch,
                          cudaMemcpyHostToDevice, s);
  const size_t smem = nom::smem_bytes(m, true);
  if (!err && smem > 48 * 1024)
    err = cudaFuncSetAttribute(fused_prepare_kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               static_cast<int>(smem));
  if (err) return static_cast<int>(err);
  fused_prepare_kernel<<<(batch + nom::kWarps - 1) / nom::kWarps,
                         nom::kThreads, smem, s>>>(
      static_cast<const uint32_t*>(occ), static_cast<const int32_t*>(req),
      static_cast<int32_t*>(res), static_cast<uint32_t*>(vecs), m, n_slots,
      batch);
  err = cudaGetLastError();
  if (!err && res_host) {
    const int L = X + Y + Z - 2;
    const size_t bytes = sizeof(int32_t) * batch * static_cast<size_t>(3 + 3 * L)
                         + static_cast<size_t>(batch) * (2 + n_slots);
    err = cudaMemcpyAsync(res_host, res, bytes, cudaMemcpyDeviceToHost, s);
  }
  return static_cast<int>(err);
}

extern "C" const char* fused_prepare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
