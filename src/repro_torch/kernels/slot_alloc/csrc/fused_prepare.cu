// The fused per-wave CCU prepare: wavefront search, slot scoring, argmin
// slot choice and lockstep trace-back in ONE launch per search wave.
//
// Replaces: repro/kernels/slot_alloc/fused.py `fused_prepare_program`, a
// jit program that on the TPU (kernel="pallas") chains the Pallas
// wavefront kernel (slot_alloc.py `_kernel`), the Pallas scoring kernel
// (`_score_kernel`) and the `_traceback_scan` lax.scan.  Outputs keep its
// packing: ints (B, 3 + 3L) i32 = [starts, arr, dists, hop_n[L],
// hop_p[L], hop_s[L]] with L = max_dist + 1; flags (B, 2 + n_slots) u8 =
// [denied, ok, free[n_slots]]; vecs (B, n) u32 for the host's extra-slot
// bundles.
//
// What bounds it on an H100: latency, not bytes or operations.  A
// 64-request wave on the 8x8x4 mesh reads 7 KB of occupancy and writes
// ~80 KB (vecs dominate), tens of nanoseconds at 3.35 TB/s.  The time is
// the launch plus, per request, `dist` dependent search sweeps and a
// `dist`-step serial trace-back.
//
// Design: one CTA per request.  The search runs as in
// wavefront_search.cu (shared-memory vector, one barrier per lattice
// layer); then thread 0 scores the n_slots arrival slots with the same
// nom::slot_cost as slot_score.cu, takes the first minimum, and walks
// the trace-back against the shared-memory vector (first free dimension
// in x -> y -> z order, exactly the scan's step semantics, including
// the outputs of rows whose walk fails).  Everything the host commit
// needs leaves in two small arrays, so one device->host pull per wave.
#include "slot_alloc.cuh"

namespace {

__global__ void fused_prepare_kernel(const uint32_t* __restrict__ occ,
                                     const int32_t* __restrict__ srcs,
                                     const int32_t* __restrict__ dsts,
                                     const int32_t* __restrict__ t_ready,
                                     int32_t* __restrict__ ints,
                                     uint8_t* __restrict__ flags,
                                     uint32_t* __restrict__ vecs, nom::Mesh m,
                                     int n_slots) {
  extern __shared__ uint32_t smem[];
  const int n = m.n();
  uint32_t* vec = smem;
  uint32_t* occ_sel = smem + n;
  const int b = blockIdx.x;
  const nom::Request r(srcs[b], dsts[b], m);
  nom::wavefront_cta(occ, r, m, n_slots, 0u, vec, occ_sel);
  for (int v = threadIdx.x; v < n; v += blockDim.x)
    vecs[static_cast<size_t>(b) * n + v] = vec[v];
  if (threadIdx.x != 0) return;   // no barrier follows

  const int L = m.X + m.Y + m.Z - 2;
  int32_t* row = ints + static_cast<size_t>(b) * (3 + 3 * L);
  int32_t* hop_n = row + 3;
  int32_t* hop_p = hop_n + L;
  int32_t* hop_s = hop_p + L;
  uint8_t* frow = flags + static_cast<size_t>(b) * (2 + n_slots);

  // -- slot scoring + argmin (first minimum == lowest slot on ties) ------
  const uint32_t avail = vec[r.dst] | occ[r.dst * nom::kNPorts + nom::kPortLocal];
  const int t = t_ready[b];
  int32_t best = nom::kFar32;
  int arr = 0;
  bool any_free = false;
  for (int s = 0; s < n_slots; ++s) {
    const int32_t c = nom::slot_cost(avail, r.dist, t, s, n_slots);
    const bool is_free = c != nom::kFar32;
    frow[2 + s] = is_free;
    any_free |= is_free;
    if (c < best) {
      best = c;
      arr = s;
    }
  }

  // -- trace-back: one step per hop, forward hop t written at step
  //    dist-1-t; the last entry is (dst, LOCAL, arrival slot) ----------
  for (int k = 0; k < L; ++k) hop_n[k] = hop_p[k] = hop_s[k] = 0;
  hop_n[r.dist] = r.dst;
  hop_p[r.dist] = nom::kPortLocal;
  hop_s[r.dist] = arr;
  int v = r.dst;
  int j = arr;
  bool active = v != r.src;
  bool ok = true;
  for (int step = 0; step < r.dist; ++step) {
    const int jp = nom::pymod(j - 1, n_slots);
    int c[3];
    m.coords(v, c);
    int dsel = 0;
    int usel = v;
    bool has = false;
    for (int d = 0; d < 3 && !has; ++d) {
      if (r.sign[d] == 0 || c[d] == r.sc[d]) continue;
      const int u = v - r.sign[d] * m.stride(d);
      if (!(((vec[u] | occ_sel[d * n + u]) >> jp) & 1u)) {
        dsel = d;
        usel = u;
        has = true;
      }
    }
    const bool move = active && has;
    if (active && !has) ok = false;
    const int v2 = move ? usel : v;
    const int pos = r.dist - 1 - step;
    hop_n[pos] = v2;
    hop_p[pos] = r.port[dsel];
    hop_s[pos] = jp;
    if (move) j = jp;
    active = move && v2 != r.src;
    v = v2;
  }
  row[0] = best;
  row[1] = arr;
  row[2] = r.dist;
  frow[0] = !any_free;
  frow[1] = ok;
}

}  // namespace

extern "C" int fused_prepare_launch(const void* occ, const void* srcs,
                                    const void* dsts, const void* t_ready,
                                    void* ints, void* flags, void* vecs,
                                    int batch, int X, int Y, int Z,
                                    int n_slots, int threads, void* stream) {
  const nom::Mesh m{X, Y, Z};
  const size_t smem = sizeof(uint32_t) * 4 * static_cast<size_t>(X * Y * Z);
  fused_prepare_kernel<<<batch, threads, smem,
                         static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(occ), static_cast<const int32_t*>(srcs),
      static_cast<const int32_t*>(dsts), static_cast<const int32_t*>(t_ready),
      static_cast<int32_t*>(ints), static_cast<uint8_t*>(flags),
      static_cast<uint32_t*>(vecs), m, n_slots);
  return static_cast<int>(cudaGetLastError());
}

extern "C" const char* fused_prepare_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
