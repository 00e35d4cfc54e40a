// Device functions shared by the three slot-allocator kernels
// (wavefront_search.cu, slot_score.cu, fused_prepare.cu).
//
// Layout: busy vectors are packed 32-bit words, one word per node per
// vector (bit j == 1: TDM slot j busy), not the TPU kernels' (n, 128)
// 0/1 int32 bit-planes -- those are a layout for the TPU vector unit.
// The slot re-index between neighbouring routers is a rotate within the
// first n_slots bits (n_slots in [1, 32]).
//
// The search and the fused prepare run one warp per request, kWarps
// requests per CTA (wavefront_warp below).  A request reaches only the
// nodes of its shortest-path box, and the box is a DAG layered by
// distance from the source: layer k holds the box nodes at lattice
// distance k, and each takes its value from its upstream neighbours in
// layer k - 1.  The warp walks the layers in order, synchronised
// within the warp only (its shuffles, or a __syncwarp() between layers)
// and never across the CTA.
#pragma once

#include <cstdint>
#include <cuda_runtime.h>

namespace nom {

constexpr int kPortLocal = 6;
constexpr int kNPorts = 7;
constexpr int32_t kFar32 = 0x7FFFFFFF;   // int32 "infeasible" score
constexpr int kWarps = 2;                 // requests (warps) per CTA
constexpr int kThreads = 32 * kWarps;
constexpr unsigned kAll = 0xFFFFFFFFu;

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
  __host__ __device__ int n() const { return X * Y * Z; }
  __device__ void coords(int v, int c[3]) const {
    c[0] = v % X;
    c[1] = (v / X) % Y;
    c[2] = v / (X * Y);
  }
};

// Dynamic shared memory of a search CTA: the wave's occupancy table
// (n x 7 words), and per warp one box vector of up to n words and, for
// the fused prepare, the trace-back's two choice masks per box node.
// At the largest mesh the wrappers take (3072 nodes) that is 156 KB of
// the 227 KB a CTA may opt into, above the default 48 KB.
__host__ inline size_t smem_bytes(const Mesh& m, bool trace) {
  return sizeof(uint32_t) * static_cast<size_t>(m.n()) *
         (kNPorts + kWarps * (trace ? 3 : 1));
}

// Geometry of one (src, dst) request in box-local coordinates: l[d] =
// |c[d] - src[d]| in [0, span[d]], a node's box index l0 + b0 * (l1 +
// b1 * l2) with b = span + 1, its node id src + sum l[d] * step[d].
// One step upstream along d (towards the source) lowers l[d] by one:
// the box index by bstride[d], the node id by step[d].
struct Request {
  int src, dst, dist;
  int sc[3], span[3], step[3], bstride[3], port[3];

  __device__ Request(int s, int d, const Mesh& m) : src(s), dst(d), dist(0) {
    int dc[3];
    m.coords(s, sc);
    m.coords(d, dc);
    const int stride[3] = {1, m.X, m.X * m.Y};
    int b = 1;
    for (int k = 0; k < 3; ++k) {
      const int sign = (dc[k] > sc[k]) - (dc[k] < sc[k]);
      span[k] = abs(dc[k] - sc[k]);
      step[k] = sign * stride[k];
      bstride[k] = b;
      b *= span[k] + 1;
      port[k] = 2 * k + (sign < 0 ? 1 : 0);
      dist += span[k];
    }
  }
  __device__ int box_size() const {
    return bstride[2] * (span[2] + 1);
  }
};

// Stage the wave's occupancy table into shared memory (16-byte
// aligned): every thread of the CTA issues its 16-byte cp.async copies
// at once, so the table arrives in about one memory latency (plain
// loads where the table is not 16-byte aligned, and for its tail); one
// wait, then the CTA's only barrier.
__device__ inline void stage_occupancy(const uint32_t* __restrict__ occ,
                                       int n, uint32_t* occ_s) {
  const int words = n * kNPorts;
  const int quads =
      reinterpret_cast<uintptr_t>(occ) % 16 == 0 ? words / 4 : 0;
  for (int i = threadIdx.x; i < quads; i += blockDim.x) {
    const auto dst =
        static_cast<unsigned>(__cvta_generic_to_shared(occ_s + 4 * i));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
                 "l"(occ + 4 * i)
                 : "memory");
  }
  for (int i = 4 * quads + threadIdx.x; i < words; i += blockDim.x)
    occ_s[i] = occ[i];
  asm volatile("cp.async.wait_all;\n" ::: "memory");
  __syncthreads();
}

// Fill the request's (n,) row of busy vectors in device memory with the
// all-busy mask, coalesced.  The kernels do it before they stage the
// occupancy, under its latency; wavefront_warp then overwrites the box
// nodes, after the staging's barrier has ordered the two.
__device__ inline void fill_row(int n, int n_slots, uint32_t* __restrict__ out) {
  const uint32_t fm = full_mask(n_slots);
  for (int v = threadIdx.x & 31; v < n; v += 32) out[v] = fm;
}

// The trace-back's choice masks of one request, by box index: bit j of
// ys[li] (zs[li]) is set where the walk, holding slot j at that node,
// steps to its upstream neighbour along y (z): the first dimension in
// x -> y -> z order whose neighbour is free at slot j - 1.  It steps
// along x where neither bit nor the node's busy bit j is set, and
// nowhere where that busy bit is set (no neighbour is free).  From the
// node's three rotated upstream values (all-busy where it has no
// neighbour along d), whose AND is its busy vector.
struct Trace {
  uint32_t* ys;
  uint32_t* zs;
  __device__ void put(int li, uint32_t rx, uint32_t ry, uint32_t rz,
                      uint32_t fm) const {
    const uint32_t fx = ~rx & fm, fy = ~ry & fm & ~fx;
    ys[li] = fy;
    zs[li] = ~rz & fm & ~fx & ~fy;
  }
};

// One box node of layer k (box coordinates l0, l1, l2, box index li,
// node id v), where its box has more rows than a warp has lanes: its
// converged busy vector from its layer k - 1 upstream neighbours in vec
// (each the neighbour's vector OR its sign-chosen output-port
// occupancy, rotated into this node's slots), into vec and out, and its
// trace-back masks when kTrace.  The loads are all issued at once: one
// without a neighbour reads the node's own entries, whose value is
// discarded.
template <bool kTrace>
__device__ inline void relax(const uint32_t* occ_s, const Request& r,
                             int n_slots, int l0, int l1, int l2, int li,
                             int v, uint32_t* vec, uint32_t* __restrict__ out,
                             const Trace& tr) {
  const uint32_t fm = full_mask(n_slots);
  const int l[3] = {l0, l1, l2};
  uint32_t rot[3];
  for (int d = 0; d < 3; ++d) {
    const bool has = l[d] > 0;
    const int bs = has ? r.bstride[d] : 0, st = has ? r.step[d] : 0;
    const uint32_t u = vec[li - bs] | occ_s[(v - st) * kNPorts + r.port[d]];
    rot[d] = has ? rotr(u, n_slots) : fm;
  }
  const uint32_t val = rot[0] & rot[1] & rot[2];
  vec[li] = val;
  out[v] = val;
  if (kTrace) tr.put(li, rot[0], rot[1], rot[2], fm);
}

// The PE-matrix wavefront of one request, run by one warp.
//
// vec (this warp's shared memory, box_size() words) ends as the
// converged busy vector of every box node, by box index, and out (the
// request's (n,) row in device memory) holds the same at every box
// node; the source holds init & full_mask.  With kTrace, tr receives
// every node's trace-back masks.  Lane t owns the box rows (l1, l2)
// numbered t, t + 32, ... (row l1 + b1 * l2, a line along x): in layer
// k a row holds one node, l0 = k - l1 - l2, when 0 <= l0 <= span0.  No
// layer holds a division.
//
// The paper mesh's boxes have at most 8 x 4 = 32 rows, one per lane.
// Then a node's upstream neighbours in layer k - 1 are the lane's own
// previous node (x), and the previous nodes of lanes t - 1 (y) and t -
// b1 (z): each lane keeps its last node's value out through each port,
// OR-ed with that port's occupancy and rotated, in registers, and reads
// the occupancy of its next node a layer ahead, so a layer is two warp
// shuffles and a few logic operations; each lane writes its row to out
// once the loop is done.  Larger boxes loop over rows,
// their coordinates advanced by whole-warp steps worked out once, and
// read their neighbours from vec, written before the previous
// __syncwarp().  Either way a layer k node reads only layer k - 1: the
// fixpoint the TPU kernel reaches after max_dist full sweeps.
template <bool kTrace>
__device__ inline void wavefront_warp(const uint32_t* occ_s,
                                      const Request& r, int n_slots,
                                      uint32_t init, uint32_t* vec,
                                      uint32_t* __restrict__ out,
                                      const Trace& tr) {
  const int lane = threadIdx.x & 31;
  const uint32_t fm = full_mask(n_slots);
  const int b0 = r.span[0] + 1, b1 = r.span[1] + 1;
  const int rows = b1 * (r.span[2] + 1);
  const int l1_0 = lane % b1, l2_0 = lane / b1;   // the lane's first row
  const int p0 = r.port[0], p1 = r.port[1], p2 = r.port[2];
  if (rows <= 32) {
    const bool mine = lane < rows;
    const int k0 = l1_0 + l2_0;                   // the row's first layer
    const int li0 = b0 * (l1_0 + b1 * l2_0);
    const int v0 = mine ? r.src + l1_0 * r.step[1] + l2_0 * r.step[2]
                        : r.src;
    // The occupancy row of the lane's node at l0, clamped into its row
    // (a valid address whatever the layer).
    auto occ_at = [&](int l0) {
      return occ_s + (v0 + min(max(l0, 0), b0 - 1) * r.step[0]) * kNPorts;
    };
    // The lane's last node's value out through ports x, y, z.
    uint32_t ox = 0, oy = 0, oz = 0;
    if (lane == 0) {
      const uint32_t val = init & fm;
      const uint32_t* o = occ_s + r.src * kNPorts;
      vec[0] = val;
      ox = rotr(val | o[p0], n_slots);
      oy = rotr(val | o[p1], n_slots);
      oz = rotr(val | o[p2], n_slots);
    }
    // Loop invariants in registers: the rotate's shift and mask, and the
    // all-busy stand-ins for the neighbours a row does not have.
    const int sh = n_slots - 1;
    const uint32_t no_y = l1_0 > 0 ? 0u : fm, no_z = l2_0 > 0 ? 0u : fm;
    const uint32_t* o = occ_at(1 - k0);
    uint32_t c0 = o[p0], c1 = o[p1], c2 = o[p2];
    for (int k = 1; k <= r.dist; ++k) {
      const uint32_t py = __shfl_up_sync(kAll, oy, 1);
      const uint32_t pz = __shfl_up_sync(kAll, oz, b1);
      const int l0 = k - k0;
      o = occ_at(l0 + 1);
      const uint32_t n0 = o[p0], n1 = o[p1], n2 = o[p2];
      const bool live =
          mine && static_cast<unsigned>(l0) < static_cast<unsigned>(b0);
      const uint32_t rx = l0 > 0 ? ox : fm;
      const uint32_t val = rx & (py | no_y) & (pz | no_z);
      if (live) {
        vec[li0 + l0] = val;
        if (kTrace) tr.put(li0 + l0, rx, py | no_y, pz | no_z, fm);
      }
      const uint32_t x0 = val | c0, x1 = val | c1, x2 = val | c2;
      ox = live ? ((x0 << 1) | (x0 >> sh)) & fm : ox;
      oy = live ? ((x1 << 1) | (x1 >> sh)) & fm : oy;
      oz = live ? ((x2 << 1) | (x2 >> sh)) & fm : oz;
      c0 = n0;
      c1 = n1;
      c2 = n2;
    }
    // The lane's row into out once it has converged: the stores stay out
    // of the layer loop, whose every step waits on the one before.
    if (mine)
      for (int l0 = 0; l0 < b0; ++l0) out[v0 + l0 * r.step[0]] = vec[li0 + l0];
    __syncwarp();
    return;
  }
  if (lane == 0) vec[0] = out[r.src] = init & fm;
  __syncwarp();
  const int dl1 = 32 % b1, dl2 = 32 / b1;         // one row step of 32
  for (int k = 1; k <= r.dist; ++k) {
    int l1 = l1_0, l2 = l2_0;
#pragma unroll 1
    for (int row = lane; row < rows; row += 32) {
      const int l0 = k - l1 - l2;
      if (l0 >= 0 && l0 < b0)
        relax<kTrace>(occ_s, r, n_slots, l0, l1, l2,
                      l0 + b0 * (l1 + b1 * l2),
                      r.src + l0 * r.step[0] + l1 * r.step[1] +
                          l2 * r.step[2],
                      vec, out, tr);
      l1 += dl1;
      l2 += dl2;
      if (l1 >= b1) {
        l1 -= b1;
        ++l2;
      }
    }
    __syncwarp();
  }
}

}  // namespace nom
