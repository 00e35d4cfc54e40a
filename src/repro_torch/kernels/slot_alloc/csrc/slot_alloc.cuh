// Device functions shared by the three slot-allocator kernels
// (wavefront_search.cu, slot_score.cu, fused_prepare.cu).
//
// Layout: busy vectors are packed 32-bit words, one word per node per
// vector (bit j == 1: TDM slot j busy), not the TPU kernels' (n, 128)
// 0/1 int32 bit-planes -- those are a layout for the TPU vector unit.
// The slot re-index between neighbouring routers is a rotate within the
// first n_slots bits (n_slots in [1, 32]).
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nom {

constexpr int kPortLocal = 6;
constexpr int kNPorts = 7;
constexpr int32_t kFar32 = 0x7FFFFFFF;   // int32 "infeasible" score

__host__ __device__ inline uint32_t full_mask(int n_slots) {
  // n_slots == 32 would make (1u << 32) undefined: spell it out.
  return n_slots >= 32 ? 0xFFFFFFFFu : ((1u << n_slots) - 1u);
}

// Rotate right by one within n_slots bits.  Both shift counts stay in
// [0, 31] for n_slots in [1, 32], so neither shift is undefined.
__device__ inline uint32_t rotr(uint32_t v, int n_slots) {
  return ((v << 1) | (v >> (n_slots - 1))) & full_mask(n_slots);
}

// Python's a % n (non-negative for n > 0).
__device__ inline int pymod(int a, int n) {
  const int r = a % n;
  return r < 0 ? r + n : r;
}

// Earliest injection cycle >= t_ready whose circuit of `dist` hops
// arrives at slot s; kFar32 when s is busy in `avail`.  Callers keep
// t_ready < 2**31 - 2*n_slots, so the sum stays below kFar32.
__device__ inline int32_t slot_cost(uint32_t avail, int dist, int t_ready,
                                    int s, int n_slots) {
  if ((avail >> s) & 1u) return kFar32;
  const int s_inj = pymod(s - dist, n_slots);
  return t_ready + pymod(s_inj - t_ready, n_slots);
}

struct Mesh {
  int X, Y, Z;
  __device__ int n() const { return X * Y * Z; }
  __device__ void coords(int v, int c[3]) const {
    c[0] = v % X;
    c[1] = (v / X) % Y;
    c[2] = v / (X * Y);
  }
  __device__ int stride(int d) const { return d == 0 ? 1 : (d == 1 ? X : X * Y); }
};

// Geometry of one (src, dst) request: its shortest-path box, the travel
// sign per dimension and the output port a hop along d uses.
struct Request {
  int src, dst, dist;
  int sc[3], lo[3], hi[3], sign[3], port[3];

  __device__ Request(int s, int d, const Mesh& m) : src(s), dst(d), dist(0) {
    int dc[3];
    m.coords(s, sc);
    m.coords(d, dc);
    for (int k = 0; k < 3; ++k) {
      sign[k] = (dc[k] > sc[k]) - (dc[k] < sc[k]);
      lo[k] = min(sc[k], dc[k]);
      hi[k] = max(sc[k], dc[k]);
      port[k] = 2 * k + (sign[k] < 0 ? 1 : 0);
      dist += hi[k] - lo[k];
    }
  }
};

// The PE-matrix wavefront for one request, run by the whole CTA.
//
// vec[n] (shared) ends as the converged busy vector of every node: the
// source row holds init & full_mask, nodes outside the shortest-path box
// stay all-busy.  occ_sel[3 * n] (shared) receives occ[u, port[d]], the
// sign-chosen output-port occupancy per dimension.  The lattice is a DAG
// layered by distance from the source, so sweep k computes exactly the
// box nodes at distance k from their (already final) upstream
// neighbours: `dist` sweeps with a barrier between them reach the
// fixpoint the TPU kernel reaches after max_dist full sweeps.
__device__ inline void wavefront_cta(const uint32_t* __restrict__ occ,
                                     const Request& r, const Mesh& m,
                                     int n_slots, uint32_t init,
                                     uint32_t* vec, uint32_t* occ_sel) {
  const int n = m.n();
  const uint32_t fm = full_mask(n_slots);
  for (int v = threadIdx.x; v < n; v += blockDim.x) {
    vec[v] = (v == r.src) ? (init & fm) : fm;
    for (int d = 0; d < 3; ++d) occ_sel[d * n + v] = occ[v * kNPorts + r.port[d]];
  }
  __syncthreads();
  for (int k = 1; k <= r.dist; ++k) {
    for (int v = threadIdx.x; v < n; v += blockDim.x) {
      int c[3];
      m.coords(v, c);
      int off = 0;
      bool in_box = true;
      for (int d = 0; d < 3; ++d) {
        in_box &= (c[d] >= r.lo[d]) & (c[d] <= r.hi[d]);
        off += abs(c[d] - r.sc[d]);
      }
      if (!in_box || off != k) continue;
      uint32_t acc = fm;
      for (int d = 0; d < 3; ++d) {
        if (c[d] == r.sc[d]) continue;           // no move along d yet
        const int u = v - r.sign[d] * m.stride(d);
        acc &= rotr(vec[u] | occ_sel[d * n + u], n_slots);
      }
      vec[v] = acc;
    }
    __syncthreads();
  }
}

}  // namespace nom
