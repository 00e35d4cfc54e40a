// SSD chunked scan (Mamba-2, arXiv:2405.21060): per (batch, head), chunk
// by chunk in order, with an fp32 (hd, n) state carried from zero:
//
//   cum   = cumsum(dt * A)                    (within the chunk)
//   y     = ((C B^T) * L * dt_j) x + exp(cum) * C state^T,
//           L = exp(cum_i - cum_j) where j <= i, else 0
//   state = state * exp(cum_last) + (x * dt * exp(cum_last - cum))^T B
//
// All math in fp32; y in x's type.
//
// Replaces: the Pallas TPU kernel repro/kernels/ssd_scan/ssd_scan.py
// (`_kernel`, launched by `ssd_scan_fwd`).  The TPU kernel takes x, B, C
// as (b * H, S, .) with B and C broadcast over heads; these take the
// model's layout, x (b, S, H, hd) and B, C (b, S, n) shared by the heads
// (ngroups = 1), all through their strides (in the model they are column
// slices of one conv output), so nothing is transposed or copied.
//
// What bounds it on an H100: operations.  At the model's prefill shape
// (mamba2-130m, b=4, S=8192, H=24, hd=64, n=128, bf16) it moves ~221 MB
// (0.066 ms at 3.35 TB/s); its fp32-operand products (M x, C state^T, the
// state update) need ~26 GFLOP even token by token.
//
// Two kernels behind one entry point; the wrapper chooses by a stated rule
// (ssd_scan.py `plan`), from dtype, shape and alignment, before the launch.
//
// bf16 (`ssd_tc_kernel`): tensor cores, exactly.  Each product has one bf16
// operand (x, B or C) and at most one fp32 one (M, the state, (x * w)).
// The fp32 operand is split into three bf16 pieces, hi = bf16(v), mid =
// bf16(v - hi), lo = bf16(v - hi - mid), which sum to v exactly; a bf16 x
// bf16 product is exact in fp32, so one wgmma per piece into one fp32
// accumulator keeps every product exact (only the order of the sums
// differs from the plain version).  No TF32.  C B^T needs one pass.
// - Segments: each sequence is cut into segments of whole chunks, so the
//   grid (head pairs, batch, segments) holds more CTAs than SMs.  A first
//   launch (kEnd) sums each segment's end state from zero, with only the
//   state-update products, and its total log-decay, into a scratch buffer
//   (in the accumulator's fragment order, so the reads are float4 and
//   coalesced); the second launch chains, in each CTA, the end states of
//   the earlier segments into its carried-in state, and walks its chunks
//   writing y.  Carries cross device memory only at segment bounds.
// - One CTA of 384 threads per (two heads of a batch row, segment): one
//   thread of warpgroup 2 (setmaxnreg 24; the consumers take 240) issues
//   TMA loads of each chunk's x (one tile per head), B and C into a
//   two-stage ring (full/empty mbarriers), read through the strides of the
//   views (4-D and 3-D tensor maps, 32/64/128-byte swizzle); warpgroups 0
//   and 1 are one head each.  B and C are loaded once for both heads, and
//   G = C B^T is formed once: each warpgroup computes 32 of its 64 columns
//   (wgmma m64n32, both K-major) and shares them through shared memory.
// - Per chunk and head (a warpgroup): its half of G (wgmma m64n32 from
//   shared memory) and y_inter^T = prior C^T (rows p: the three pieces of
//   the state straight from its accumulator fragment as A, C K-major as
//   B), which goes to shared memory times exp(cum_i), transposed to rows
//   i; then M = G * exp(cum_i - cum_j) * dt_j (select below the diagonal)
//   in three A fragments, 16 keys a step in two register buffers, so one
//   step is built while the one before runs; y = M x (x MN-major) + the
//   stored y_inter, to global as bf16 from the fragments; then (x * w)^T
//   from the swizzled x tile, split, as A fragments in the same way,
//   state *= exp(cum_last), state += (x * w)^T B (wgmma m64nN, B
//   MN-major).  The state lives in registers (the m64nN accumulator, rows
//   hd padded to 64) and never goes to shared memory.
//
// float32 (`ssd_scan_kernel`) stays on the CUDA cores (a split fp32 x fp32
// product would take nine passes; fp32 runs only in the tests), as do bf16
// shapes outside the wgmma kernel's set.  One CTA of 256 threads per
// (batch, head) walks the chunks (the TPU grid's sequential chunk axis
// becomes a loop; the state lives in shared memory across it, as in the
// TPU kernel's VMEM scratch).  Per chunk the CTA loads x (q, hd), B and C
// (q, n) and dt into shared memory as fp32, and forms three products on
// the CUDA cores, each thread holding a 4 x 4 register tile and reading
// its operands as float4 along the reduction axis:
//   1. G = C B^T (q x q, one tile per thread); warp 0 first scans dt * A;
//      then M = G * exp(cum_i - cum_j) * dt_j below the diagonal, selected
//      (never multiplied by a mask: exp overflows above it), into smem;
//   2. y = M x + exp(cum) * (C state^T), written straight to y;
//   3. state = state * exp(cum_last) + sum_t B_t^T (w_t x_t), in place,
//      each thread owning its (4 x 4) state tiles.
// B and C rows are padded by 4 floats so that the 8 lanes of a float4
// phase land in distinct banks.
//
// Both take 64-token chunks, not the model's 256: the chunk changes only
// the rounding (the plain version's chunk invariance test).
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

constexpr int kChunk = 64;      // tokens per chunk (q)
constexpr int kThreads = 256;   // = (kChunk / 4)^2: one G tile per thread
constexpr int kRows = kChunk / 4;   // row stride of a thread's 4 rows
constexpr int kMpitch = kChunk + 4;
constexpr size_t kMaxSmem = 232448;
static_assert(kRows * kRows == kThreads, "one 4x4 tile of G per thread");
static_assert(kChunk == 64, "the dt scan gives each lane two tokens");

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T>
__device__ __forceinline__ T from_f(float v);
template <>
__device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16(v);
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}
__device__ __forceinline__ float at(const float4& v, int i) {
  return i == 0 ? v.x : i == 1 ? v.y : i == 2 ? v.z : v.w;
}

struct Args {
  const void* x;
  const float* dt;
  const void* B;
  const void* C;
  const float* A;
  void* y;
  int seq, heads, hd, n;
  long long sxb, sxs, sxh;   // x strides (elements); last axis unit
  long long sdb, sds, sdh;   // dt strides
  long long sbb, sbs;        // B strides
  long long scb, scs;        // C strides
};

// fp32 words of shared memory: xs (q, hd), Bs and Cs (q, n + 4),
// Ms (q, q + 4), Ss (n, hd), cum, dt, exp(cum), w (q each).
__host__ __device__ constexpr size_t smem_floats(int hd, int n) {
  return static_cast<size_t>(kChunk) * hd + 2 * kChunk * (n + 4) +
         kChunk * kMpitch + static_cast<size_t>(n) * hd + 4 * kChunk;
}

template <typename T>
__global__ void __launch_bounds__(kThreads, 1) ssd_scan_kernel(Args a) {
  extern __shared__ __align__(16) float smem[];
  const int hd = a.hd, n = a.n, nb = n + 4;
  float* xs = smem;                          // [t][p]
  float* Bs = xs + kChunk * hd;              // [t][k], pitch nb
  float* Cs = Bs + kChunk * nb;              // [t][k], pitch nb
  float* Ms = Cs + kChunk * nb;              // [i][j], pitch kMpitch
  float* Ss = Ms + kChunk * kMpitch;         // state [k][p]
  float* cum = Ss + n * hd;
  float* dts = cum + kChunk;
  float* ecum = dts + kChunk;
  float* wts = ecum + kChunk;

  const int tid = threadIdx.x;
  const int h = blockIdx.x, b = blockIdx.y;
  const float A = a.A[h];
  const T* x = static_cast<const T*>(a.x) + b * a.sxb + h * a.sxh;
  const T* Bg = static_cast<const T*>(a.B) + b * a.sbb;
  const T* Cg = static_cast<const T*>(a.C) + b * a.scb;
  const float* dt = a.dt + b * a.sdb + h * a.sdh;
  T* y = static_cast<T*>(a.y);

  for (int e = tid; e < n * hd; e += kThreads) Ss[e] = 0.f;

  const int hd4 = hd / 4;
  const int gr = tid / kRows, gc = tid % kRows;   // G tile: rows gr + 16r
  for (int s0 = 0; s0 < a.seq; s0 += kChunk) {
    __syncthreads();   // the previous chunk's readers are done
    for (int e = tid; e < kChunk * hd; e += kThreads) {
      const int t = e / hd, p = e - t * hd;
      xs[e] = to_f(x[(s0 + t) * a.sxs + p]);
    }
    for (int e = tid; e < kChunk * n; e += kThreads) {
      const int t = e / n, k = e - t * n;
      Bs[t * nb + k] = to_f(Bg[(s0 + t) * a.sbs + k]);
      Cs[t * nb + k] = to_f(Cg[(s0 + t) * a.scs + k]);
    }
    if (tid < kChunk) dts[tid] = dt[(s0 + tid) * a.sds];
    __syncthreads();

    // cum = inclusive cumsum(dt * A): warp 0, two tokens per lane.
    if (tid < 32) {
      const float d0 = dts[2 * tid] * A, d1 = dts[2 * tid + 1] * A;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (tid == 0) excl = 0.f;
      const float c0 = excl + d0, c1 = c0 + d1;
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * tid] = c0;
      cum[2 * tid + 1] = c1;
      ecum[2 * tid] = expf(c0);
      ecum[2 * tid + 1] = expf(c1);
      wts[2 * tid] = dts[2 * tid] * expf(last - c0);
      wts[2 * tid + 1] = dts[2 * tid + 1] * expf(last - c1);
    }

    // 1. G = C B^T: rows i = gr + 16r, columns j = gc + 16c.
    float g[4][4] = {};
    for (int k = 0; k < n; k += 4) {
      float4 cv[4], bv[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (gr + kRows * r) * nb + k);
#pragma unroll
      for (int c = 0; c < 4; ++c) bv[c] = ld4(Bs + (gc + kRows * c) * nb + k);
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          g[r][c] += cv[r].x * bv[c].x;
          g[r][c] += cv[r].y * bv[c].y;
          g[r][c] += cv[r].z * bv[c].z;
          g[r][c] += cv[r].w * bv[c].w;
        }
    }
    __syncthreads();   // cum, ecum, wts ready
#pragma unroll
    for (int r = 0; r < 4; ++r) {
      const int i = gr + kRows * r;
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int j = gc + kRows * c;
        Ms[i * kMpitch + j] =
            j <= i ? g[r][c] * expf(cum[i] - cum[j]) * dts[j] : 0.f;
      }
    }
    __syncthreads();

    // 2. y = M x + exp(cum) (C state^T): rows i = tr + 16r, columns
    //    p = 4tc .. 4tc + 3.
    for (int tile = tid; tile < kRows * hd4; tile += kThreads) {
      const int tr = tile / hd4, p0 = 4 * (tile - tr * hd4);
      float yi[4][4] = {}, ys[4][4] = {};
      for (int j = 0; j < kChunk; j += 4) {
        float4 mv[4], xv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) mv[r] = ld4(Ms + (tr + kRows * r) * kMpitch + j);
#pragma unroll
        for (int u = 0; u < 4; ++u) xv[u] = ld4(xs + (j + u) * hd + p0);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float m = at(mv[r], u);
            yi[r][0] += m * xv[u].x;
            yi[r][1] += m * xv[u].y;
            yi[r][2] += m * xv[u].z;
            yi[r][3] += m * xv[u].w;
          }
      }
      for (int k = 0; k < n; k += 4) {
        float4 cv[4], sv[4];
#pragma unroll
        for (int r = 0; r < 4; ++r) cv[r] = ld4(Cs + (tr + kRows * r) * nb + k);
#pragma unroll
        for (int u = 0; u < 4; ++u) sv[u] = ld4(Ss + (k + u) * hd + p0);
#pragma unroll
        for (int r = 0; r < 4; ++r)
#pragma unroll
          for (int u = 0; u < 4; ++u) {
            const float cc = at(cv[r], u);
            ys[r][0] += cc * sv[u].x;
            ys[r][1] += cc * sv[u].y;
            ys[r][2] += cc * sv[u].z;
            ys[r][3] += cc * sv[u].w;
          }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = tr + kRows * r;
        const float e = ecum[i];
        T* out = y + ((static_cast<size_t>(b) * a.seq + s0 + i) * a.heads + h)
                         * hd + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) out[c] = from_f<T>(yi[r][c] + e * ys[r][c]);
      }
    }
    __syncthreads();   // every reader of the old state is done

    // 3. state = state * exp(cum_last) + sum_t B_t^T (w_t x_t): rows
    //    k = 4tr .. 4tr + 3, columns p = 4tc .. 4tc + 3, in place.
    const float decay = expf(cum[kChunk - 1]);
    for (int tile = tid; tile < (n / 4) * hd4; tile += kThreads) {
      const int tr = tile / hd4, k0 = 4 * tr, p0 = 4 * (tile - tr * hd4);
      float acc[4][4] = {};
      for (int t = 0; t < kChunk; ++t) {
        const float4 bv = ld4(Bs + t * nb + k0);
        float4 xv = ld4(xs + t * hd + p0);
        const float w = wts[t];
        xv.x *= w;
        xv.y *= w;
        xv.z *= w;
        xv.w *= w;
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const float bb = at(bv, r);
          acc[r][0] += bb * xv.x;
          acc[r][1] += bb * xv.y;
          acc[r][2] += bb * xv.z;
          acc[r][3] += bb * xv.w;
        }
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        float* st = Ss + (k0 + r) * hd + p0;
#pragma unroll
        for (int c = 0; c < 4; ++c) st[c] = st[c] * decay + acc[r][c];
      }
    }
  }
}

template <typename T>
int launch_typed(const Args& a, int batch, cudaStream_t stream) {
  const size_t smem = smem_floats(a.hd, a.n) * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel<T>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.heads, batch);
  ssd_scan_kernel<T><<<grid, kThreads, smem, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA, segments chained through device memory
// ---------------------------------------------------------------------------
constexpr int kStages = 2;              // x/B/C ring depth
constexpr int kTcThreads = 384;         // two consumer warpgroups, a producer
constexpr int kGPitch = kChunk + 8;     // fp32 G and y_inter rows (float2 reads
                                        // conflict-free)
constexpr int kBarGWritten = 1;         // named barriers, 256 consumers
constexpr int kBarGRead = 2;
constexpr int kBarHead = 3;             // + warpgroup, its 128 threads

// A K-major bf16 tile of `rows` rows and C columns in boxes of min(C, 64)
// columns, each row of a box one swizzle span (32, 64 or 128 bytes).
template <int C>
struct Span {
  static constexpr int kCols = C < 64 ? C : 64;
  static constexpr int kRowBytes = kCols * 2;
  static constexpr int kBoxes = C / kCols;
  static constexpr int kStepsPerBox = kCols / 16;
  static constexpr uint64_t kSwizzle =          // descriptor code
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr uint32_t kMask = kRowBytes / 16 - 1;   // 7, 3 or 1
  // The swizzled byte offset of (row, col) in a tile of `rows` rows.
  __device__ static __forceinline__ uint32_t at(int rows, int row, int col) {
    const uint32_t off = (col / kCols) * rows * kRowBytes + row * kRowBytes +
                         (col % kCols) * 2;
    return off ^ (((off >> 7) & kMask) << 4);
  }
};

// Shared memory of one CTA (byte offsets from a 1024-aligned base): the
// ring, G, and per head y_inter = exp(cum) * C·priorᵀ in fp32 (rows i).
// The end-state pass (kEnd) loads no C and keeps neither.
template <int HD, int N, bool kEnd>
struct Tc {
  static constexpr int kXBytes = kChunk * HD * 2;       // one head's x tile
  static constexpr int kBCBytes = kChunk * N * 2;       // B or C tile
  static constexpr int kStageBytes = 2 * kXBytes + (kEnd ? 1 : 2) * kBCBytes;
  static constexpr int kG = kStages * kStageBytes;      // fp32 G
  static constexpr int kYs = kG + (kEnd ? 0 : kChunk * kGPitch * 4);
  static constexpr int kArrays = kYs + (kEnd ? 0 : 2 * kChunk * kGPitch * 4);
  static constexpr int kBars = kArrays + 2 * 4 * kChunk * 4;
  static constexpr size_t kSmem = 1024 + kBars + 8 * 2 * kStages;
  static constexpr uint32_t kTx = kStageBytes;          // TMA bytes a stage
};

// The three bf16 pieces of the A-fragment pair (a, b) -> p[piece][slot]:
// hi = bf16(v), mid = bf16(v - hi), lo = bf16(v - hi - mid), with
// hi + mid + lo == v exactly (ref.split_bf16x3); two values a conversion.
__device__ __forceinline__ uint32_t as_u32(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}
__device__ __forceinline__ void put3(uint32_t (&p)[3][4], int slot, float a,
                                     float b) {
  const __nv_bfloat162 hi = __floats2bfloat162_rn(a, b);   // a: low half
  const float2 fh = __bfloat1622float2(hi);
  const float ra = a - fh.x, rb = b - fh.y;
  const __nv_bfloat162 mid = __floats2bfloat162_rn(ra, rb);
  const float2 fm = __bfloat1622float2(mid);
  p[0][slot] = as_u32(hi);
  p[1][slot] = as_u32(mid);
  p[2][slot] = as_u32(__floats2bfloat162_rn(ra - fm.x, rb - fm.y));
}

// Four 8 x 8 bf16 matrices, transposed, from shared memory (each lane
// gives one row address): the A fragment of a 16 x 16 tile stored
// column-major.
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0, %1, %2, %3}, "
      "[%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(addr));
}

struct TcArgs {
  const float* dt;
  const float* A;
  __nv_bfloat16* y;
  float* ends;      // (b, H, segments, 128 threads, N / 2) end states
  float* logs;      // (b, H, segments) sum of the chunks' cum_last
  int seq, heads, seg_chunks, segments;
  long long sdb, sds, sdh;
};

// One CTA per (pair of heads, batch row, segment): warpgroup w < 2 owns
// head 2 * blockIdx.x + w (the last pair of an odd H computes its second
// head on head H - 1 and writes nothing), warpgroup 2 issues the loads.
// kEnd: the segment's end state from zero and its total log-decay, into
// `ends` / `logs`.  Else: the segment's y from the state chained over the
// earlier segments' end states.
template <int HD, int N, bool kEnd>
__global__ void __launch_bounds__(kTcThreads, 1)
    ssd_tc_kernel(const __grid_constant__ CUtensorMap tm_x,
                  const __grid_constant__ CUtensorMap tm_b,
                  const __grid_constant__ CUtensorMap tm_c, TcArgs a) {
  using L = Tc<HD, N, kEnd>;
  using SX = Span<HD>;
  using SN = Span<N>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + L::kBars);
  uint64_t* empty = full + kStages;

  const int b = blockIdx.y, seg = blockIdx.z;
  const int n_chunks = a.seq / kChunk;
  const int c0 = seg * a.seg_chunks;
  const int count = min(a.seg_chunks, n_chunks - c0);
  const int tid = threadIdx.x;
  if (tid == 0) {
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], 256);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: gives up registers; one thread issues every
    // load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      const int h0 = 2 * blockIdx.x;
      const int h1 = min(h0 + 1, a.heads - 1);
      for (int j = 0; j < count; ++j) {
        const int s = j % kStages;
        const int s0 = (c0 + j) * kChunk;
        if (j >= kStages) hopper::mbar_wait(&empty[s], ((j / kStages) - 1) & 1);
        unsigned char* st = smem + s * L::kStageBytes;
        hopper::mbar_expect_tx(&full[s], L::kTx);
        hopper::tma_load_4d(st, &tm_x, &full[s], 0, h0, s0, b);
        hopper::tma_load_4d(st + L::kXBytes, &tm_x, &full[s], 0, h1, s0, b);
        for (int c = 0; c < SN::kBoxes; ++c) {
          hopper::tma_load_3d(st + 2 * L::kXBytes + c * kChunk * SN::kRowBytes,
                              &tm_b, &full[s], c * SN::kCols, s0, b);
          if constexpr (!kEnd) {
            hopper::tma_load_3d(
                st + 2 * L::kXBytes + L::kBCBytes + c * kChunk * SN::kRowBytes,
                &tm_c, &full[s], c * SN::kCols, s0, b);
          }
        }
      }
    }
    return;
  }

  // ---- consumer warpgroups ----
  asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
  const int wg = tid / 128, t = tid % 128, lane = t % 32;
  const int r0 = (t / 32) * 16 + lane / 4;   // fragment rows r0, r0 + 8
  const int cq = (lane % 4) * 2;             // fragment column pair
  const bool valid = 2 * blockIdx.x + wg < a.heads;
  const int h = min(2 * blockIdx.x + wg, a.heads - 1);
  const float Ah = a.A[h];
  const float* dt = a.dt + b * a.sdb + h * a.sdh;
  float* cum = reinterpret_cast<float*>(smem + L::kArrays) + wg * 4 * kChunk;
  float* ecum = cum + kChunk;
  float* wts = ecum + kChunk;
  float* dts = wts + kChunk;
  float* gs = reinterpret_cast<float*>(smem + L::kG);
  float* ys = reinterpret_cast<float*>(smem + L::kYs) + wg * kChunk * kGPitch;
  const size_t carry = (static_cast<size_t>(b) * a.heads + h) * a.segments;

  // The state (rows p of HD, padded to 64; columns k of N) in the m64nN
  // accumulator layout: element e at row r0 + 8 * ((e / 2) % 2), column
  // (e / 4) * 8 + cq + e % 2.
  float st[N / 2];
#pragma unroll
  for (int e = 0; e < N / 2; ++e) st[e] = 0.f;
  if constexpr (!kEnd) {
    // The carried-in state: the earlier segments' end states, in order.
    for (int s = 0; s < seg; ++s) {
      const float decay = expf(a.logs[carry + s]);
      const float4* e4 = reinterpret_cast<const float4*>(
          a.ends + ((carry + s) * 128 + t) * (N / 2));
#pragma unroll
      for (int e = 0; e < N / 2; e += 4) {
        const float4 v = e4[e / 4];
        st[e] = st[e] * decay + v.x;
        st[e + 1] = st[e + 1] * decay + v.y;
        st[e + 2] = st[e + 2] * decay + v.z;
        st[e + 3] = st[e + 3] * decay + v.w;
      }
    }
  }
  float log_total = 0.f;
  float d_next[2] = {0.f, 0.f};
  if (t < 32) {
    d_next[0] = dt[(c0 * kChunk + 2 * t) * a.sds];
    d_next[1] = dt[(c0 * kChunk + 2 * t + 1) * a.sds];
  }

  for (int j = 0; j < count; ++j) {
    const int stage = j % kStages;
    const int s0 = (c0 + j) * kChunk;
    // cum = inclusive cumsum(dt * A): warp 0, two tokens per lane, with
    // the next chunk's dt in flight.
    if (t < 32) {
      const float dt0 = d_next[0], dt1 = d_next[1];
      if (j + 1 < count) {
        d_next[0] = dt[(s0 + kChunk + 2 * t) * a.sds];
        d_next[1] = dt[(s0 + kChunk + 2 * t + 1) * a.sds];
      }
      const float d0 = dt0 * Ah, d1 = dt1 * Ah;
      float incl = d0 + d1;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (t >= off) incl += v;
      }
      float excl = __shfl_up_sync(0xffffffffu, incl, 1);
      if (t == 0) excl = 0.f;
      const float cA = excl + d0, cB = cA + d1;
      const float last = __shfl_sync(0xffffffffu, cB, 31);
      cum[2 * t] = cA;
      cum[2 * t + 1] = cB;
      ecum[2 * t] = expf(cA);
      ecum[2 * t + 1] = expf(cB);
      wts[2 * t] = dt0 * expf(last - cA);
      wts[2 * t + 1] = dt1 * expf(last - cB);
      dts[2 * t] = dt0;
      dts[2 * t + 1] = dt1;
    }
    hopper::named_sync(kBarHead + wg, 128);
    const float cum_last = cum[kChunk - 1];
    log_total += cum_last;

    hopper::mbar_wait(&full[stage], (j / kStages) & 1);
    unsigned char* tile = smem + stage * L::kStageBytes;
    const uint32_t x_addr = hopper::smem_addr(tile + wg * L::kXBytes);
    const uint32_t b_addr = hopper::smem_addr(tile + 2 * L::kXBytes);

    if constexpr (!kEnd) {
      const uint32_t c_addr = b_addr + L::kBCBytes;
      // y_interᵀ = prior·Cᵀ (rows p, columns i): A = the three pieces of
      // the state, straight from its accumulator fragment (16 state
      // columns a step, two register buffers as below), B = the C tile,
      // K-major.  The first step's pieces are built before G is issued.
      float yt[32] = {};
      uint32_t sa[2][3][4];
      hopper::fence_regs(yt);
#pragma unroll
      for (int slot = 0; slot < 4; ++slot) {
        put3(sa[0], slot, st[2 * slot], st[2 * slot + 1]);
      }
      // This warpgroup's half of G = C·Bᵀ (columns 32 wg .. 32 wg + 31),
      // both K-major from shared memory.
      float g[16] = {};
      hopper::fence_regs(g);
      hopper::wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        const int box = kk / SN::kStepsPerBox;
        const uint32_t col = (kk % SN::kStepsPerBox) * 32;
        const uint64_t da = hopper::make_desc(
            c_addr + box * kChunk * SN::kRowBytes + col, 16,
            8 * SN::kRowBytes, SN::kSwizzle);
        const uint64_t db = hopper::make_desc(
            b_addr + box * kChunk * SN::kRowBytes + 32 * wg * SN::kRowBytes +
                col,
            16, 8 * SN::kRowBytes, SN::kSwizzle);
        hopper::wgmma_ss<32>(g, da, db, kk > 0);
      }
      hopper::wgmma_commit();
#pragma unroll
      for (int kk = 0; kk < N / 16; ++kk) {
        uint32_t (&p)[3][4] = sa[kk % 2];
        if (kk > 0) {
#pragma unroll
          for (int slot = 0; slot < 4; ++slot) {
            put3(p, slot, st[8 * kk + 2 * slot], st[8 * kk + 2 * slot + 1]);
          }
        }
        hopper::fence_regs(p);
        hopper::wgmma_fence();
        const int box = kk / SN::kStepsPerBox;
        const uint32_t col = (kk % SN::kStepsPerBox) * 32;
        const uint64_t db = hopper::make_desc(
            c_addr + box * kChunk * SN::kRowBytes + col, 16,
            8 * SN::kRowBytes, SN::kSwizzle);
#pragma unroll
        for (int k = 0; k < 3; ++k) hopper::wgmma_rs_kmajor_n64(yt, p[k], db);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();   // the step before (and G) is done
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yt);
      hopper::fence_regs(g);
      hopper::fence_regs(sa[0]);
      hopper::fence_regs(sa[1]);

      // exp(cum_i) * y_inter to shared memory, transposed to rows i; this
      // warpgroup's half of G beside it.
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int row = r0 + 8 * ((e / 2) % 2);
        const int i = (e / 4) * 8 + cq + e % 2;
        if (row < HD) ys[i * kGPitch + row] = yt[e] * ecum[i];
      }
#pragma unroll
      for (int e = 0; e < 16; e += 2) {
        const int i = r0 + 8 * ((e / 2) % 2);
        *reinterpret_cast<float2*>(gs + i * kGPitch + 32 * wg + (e / 4) * 8 +
                                   cq) = make_float2(g[e], g[e + 1]);
      }
      hopper::named_sync(kBarGWritten, 256);   // also orders ys

      // y += M·x, M = G * exp(cum_i - cum_j) * dt_j where j <= i (select:
      // exp overflows above the diagonal), 16 keys a step: the step's
      // three A fragments are built in one of two register buffers while
      // the step before runs; B = x (tokens x HD), MN-major (transpose
      // bit).
      float yacc[HD / 2] = {};
      uint32_t pa[2][3][4];
      hopper::fence_regs(yacc);
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        uint32_t (&p)[3][4] = pa[kk % 2];
#pragma unroll
        for (int slot = 0; slot < 4; ++slot) {
          const int i = r0 + 8 * (slot % 2);
          const int jj = kk * 16 + 8 * (slot / 2) + cq;
          const float2 gv =
              *reinterpret_cast<const float2*>(gs + i * kGPitch + jj);
          const float ci = cum[i];
          const float m0 = jj <= i ? gv.x * expf(ci - cum[jj]) * dts[jj] : 0.f;
          const float m1 =
              jj + 1 <= i ? gv.y * expf(ci - cum[jj + 1]) * dts[jj + 1] : 0.f;
          put3(p, slot, m0, m1);
        }
        hopper::fence_regs(p);
        hopper::wgmma_fence();
        const uint64_t db = hopper::make_desc(
            x_addr + kk * 16 * SX::kRowBytes, kChunk * SX::kRowBytes,
            8 * SX::kRowBytes, SX::kSwizzle);
#pragma unroll
        for (int k = 0; k < 3; ++k) hopper::wgmma_rs<HD>(yacc, p[k], db);
        hopper::wgmma_commit();
        hopper::wgmma_wait<1>();   // the step before is done: its buffer
      }
      hopper::named_sync(kBarGRead, 256);
      hopper::wgmma_wait<0>();
      hopper::fence_regs(yacc);
      hopper::fence_regs(pa[0]);
      hopper::fence_regs(pa[1]);
      // y = M·x + exp(cum_i) * y_inter, in bf16 from the fragments.
#pragma unroll
      for (int e = 0; e < HD / 2; e += 2) {
        const int i = r0 + 8 * ((e / 2) % 2);
        const float2 v = *reinterpret_cast<const float2*>(
            ys + i * kGPitch + (e / 4) * 8 + cq);
        yacc[e] += v.x;
        yacc[e + 1] += v.y;
      }
      if (valid) {
        __nv_bfloat16* out =
            a.y + ((static_cast<size_t>(b) * a.seq + s0 + r0) * a.heads + h) *
                      HD + cq;
        const size_t down8 = static_cast<size_t>(8) * a.heads * HD;
#pragma unroll
        for (int n8 = 0; n8 < HD / 8; ++n8) {
          *reinterpret_cast<uint32_t*>(out + n8 * 8) =
              hopper::pack_bf16(yacc[4 * n8], yacc[4 * n8 + 1]);
          *reinterpret_cast<uint32_t*>(out + down8 + n8 * 8) =
              hopper::pack_bf16(yacc[4 * n8 + 2], yacc[4 * n8 + 3]);
        }
      }
    }

    // state = state * exp(cum_last) + (x * w)ᵀ·B, 16 tokens a step as
    // above: A = the pieces of (x * w)ᵀ (rows p) read from the swizzled x
    // tile; B = the B tile (tokens x N), MN-major.
    const float decay = ecum[kChunk - 1];
#pragma unroll
    for (int e = 0; e < N / 2; ++e) st[e] *= decay;
    hopper::fence_regs(st);
    uint32_t xa[2][3][4];
    // Warp-uniform: this warp's 16 rows p lie inside HD or outside it.
    const bool rows_in = (t / 32) * 16 < HD;
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t (&p)[3][4] = xa[kk % 2];
      // xᵀ for rows p of this warp and tokens 16 kk .. 16 kk + 15: lane l
      // points at token row 16 kk + 8 (l / 16) + l % 8, columns from
      // (t / 32) * 16 + 8 ((l / 8) % 2).
      uint32_t xr[4] = {0u, 0u, 0u, 0u};
      if (rows_in) {
        ldmatrix_x4_trans(
            xr, x_addr + SX::at(kChunk, kk * 16 + 8 * (lane / 16) + lane % 8,
                                (t / 32) * 16 + 8 * ((lane / 8) % 2)));
      }
#pragma unroll
      for (int slot = 0; slot < 4; ++slot) {
        const int tk = kk * 16 + 8 * (slot / 2) + cq;
        const float2 xv = __bfloat1622float2(
            *reinterpret_cast<const __nv_bfloat162*>(&xr[slot]));
        put3(p, slot, xv.x * wts[tk], xv.y * wts[tk + 1]);
      }
      hopper::fence_regs(p);
      hopper::wgmma_fence();
      const uint64_t db = hopper::make_desc(
          b_addr + kk * 16 * SN::kRowBytes, kChunk * SN::kRowBytes,
          8 * SN::kRowBytes, SN::kSwizzle);
#pragma unroll
      for (int k = 0; k < 3; ++k) hopper::wgmma_rs<N>(st, p[k], db);
      hopper::wgmma_commit();
      hopper::wgmma_wait<1>();
    }
    hopper::wgmma_wait<0>();
    hopper::fence_regs(st);
    hopper::fence_regs(xa[0]);
    hopper::fence_regs(xa[1]);
    hopper::mbar_arrive(&empty[stage]);
    // Every read of this chunk's cum, ecum, wts, dts and ys is done before
    // warp 0 moves on.
    hopper::named_sync(kBarHead + wg, 128);
  }

  if (kEnd && valid) {   // this segment's end state, in fragment order
    float4* e4 = reinterpret_cast<float4*>(
        a.ends + ((carry + seg) * 128 + t) * (N / 2));
#pragma unroll
    for (int e = 0; e < N / 2; e += 4) {
      e4[e / 4] = make_float4(st[e], st[e + 1], st[e + 2], st[e + 3]);
    }
    if (t == 0) a.logs[carry + seg] = log_total;
  }
}

// A bf16 tensor map of `rank` dimensions (innermost first; `strides` in
// bytes, of dimensions 1 ..), read in boxes whose innermost row of
// `row_bytes` is one swizzle span.
bool encode_bf16(CUtensorMap* map, const void* ptr, int rank,
                 const cuuint64_t* dims, const cuuint64_t* strides,
                 const cuuint32_t* box, int row_bytes) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint32_t elem_strides[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle =
      row_bytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : row_bytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                        : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, rank,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int HD, int N, bool kEnd>
cudaError_t launch_pass(const CUtensorMap& tx, const CUtensorMap& tb,
                        const CUtensorMap& tc, const TcArgs& t, dim3 grid,
                        cudaStream_t stream) {
  constexpr size_t smem = Tc<HD, N, kEnd>::kSmem;
  static_assert(smem <= kMaxSmem, "tiles exceed a block's shared memory");
  const cudaError_t err = cudaFuncSetAttribute(
      ssd_tc_kernel<HD, N, kEnd>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  ssd_tc_kernel<HD, N, kEnd><<<grid, kTcThreads, smem, stream>>>(tx, tb, tc, t);
  return cudaGetLastError();
}

// The end-state pass over every segment but the last, then the output
// pass over all of them.
template <int HD, int N>
int launch_tc(const Args& a, int batch, int seg_chunks, float* ends,
              float* logs, cudaStream_t stream) {
  constexpr int kNCols = N < 64 ? N : 64;
  CUtensorMap tx, tb, tc;
  const cuuint64_t dx[4] = {static_cast<cuuint64_t>(HD),
                            static_cast<cuuint64_t>(a.heads),
                            static_cast<cuuint64_t>(a.seq),
                            static_cast<cuuint64_t>(batch)};
  const cuuint64_t sx[3] = {static_cast<cuuint64_t>(a.sxh) * 2,
                            static_cast<cuuint64_t>(a.sxs) * 2,
                            static_cast<cuuint64_t>(a.sxb) * 2};
  const cuuint32_t bx[4] = {HD, 1, kChunk, 1};
  const cuuint64_t dn[3] = {static_cast<cuuint64_t>(N),
                            static_cast<cuuint64_t>(a.seq),
                            static_cast<cuuint64_t>(batch)};
  const cuuint64_t sb[2] = {static_cast<cuuint64_t>(a.sbs) * 2,
                            static_cast<cuuint64_t>(a.sbb) * 2};
  const cuuint64_t sc[2] = {static_cast<cuuint64_t>(a.scs) * 2,
                            static_cast<cuuint64_t>(a.scb) * 2};
  const cuuint32_t bn[3] = {kNCols, kChunk, 1};
  if (!encode_bf16(&tx, a.x, 4, dx, sx, bx, HD * 2) ||
      !encode_bf16(&tb, a.B, 3, dn, sb, bn, kNCols * 2) ||
      !encode_bf16(&tc, a.C, 3, dn, sc, bn, kNCols * 2)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const int n_chunks = a.seq / kChunk;
  const int segments = (n_chunks + seg_chunks - 1) / seg_chunks;
  const TcArgs t{a.dt,   a.A,   static_cast<__nv_bfloat16*>(a.y),
                 ends,   logs,  a.seq,
                 a.heads, seg_chunks, segments,
                 a.sdb,  a.sds, a.sdh};
  const unsigned pairs = (a.heads + 1) / 2;
  cudaError_t err = cudaSuccess;
  if (segments > 1) {
    err = launch_pass<HD, N, true>(tx, tb, tc, t,
                                   dim3(pairs, batch, segments - 1), stream);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  err = launch_pass<HD, N, false>(tx, tb, tc, t, dim3(pairs, batch, segments),
                                  stream);
  return static_cast<int>(err);
}

template <int HD>
int launch_tc_hd(int n, const Args& a, int batch, int seg_chunks, float* ends,
                 float* logs, cudaStream_t stream) {
  switch (n) {
    case 16: return launch_tc<HD, 16>(a, batch, seg_chunks, ends, logs, stream);
    case 32: return launch_tc<HD, 32>(a, batch, seg_chunks, ends, logs, stream);
    case 64: return launch_tc<HD, 64>(a, batch, seg_chunks, ends, logs, stream);
    case 128: return launch_tc<HD, 128>(a, batch, seg_chunks, ends, logs, stream);
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// x (b, S, H, hd) and B, C (b, S, n) bf16 (bf16 != 0) or fp32, read
// through the given strides (elements; unit stride on the last axis);
// dt (b, S, H) and A (H,) fp32; y (b, S, H, hd) contiguous in x's type;
// S % 64 == 0.  kernel 0: the CUDA-core kernel (hd % 4 == 0, n % 4 == 0,
// fp32 tiles within a block's shared memory; `ends`, `logs` and
// `seg_chunks` unused).  kernel 1: the wgmma kernel (bf16; hd in {16, 32,
// 64}; n in {16, 32, 64, 128}; every base 16-byte aligned and every stride
// a multiple of 8 elements), segments of `seg_chunks` chunks, with scratch
// `ends` (b * H * segments * 64 * n fp32) and `logs` (b * H * segments).
// The caller chooses the kernel (the wrapper's rule); nothing here falls
// back from one to the other.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* B,
                               const void* C, const void* A, void* y,
                               void* ends, void* logs, int batch, int seq,
                               int heads, int hd, int n, long long sxb,
                               long long sxs, long long sxh, long long sdb,
                               long long sds, long long sdh, long long sbb,
                               long long sbs, long long scb, long long scs,
                               int bf16, int kernel, int seg_chunks,
                               void* stream) {
  if (batch <= 0 || heads <= 0 || seq < 0 || seq % kChunk != 0 || hd <= 0 ||
      n <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const Args a{x,   static_cast<const float*>(dt),
               B,   C,
               static_cast<const float*>(A),
               y,   seq, heads, hd, n,
               sxb, sxs, sxh,
               sdb, sds, sdh,
               sbb, sbs,
               scb, scs};
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    const long long strides[6] = {sxb, sxs, sxh, sbb, sbs, scb};
    bool ok = bf16 && seg_chunks > 0 && aligned16(x) && aligned16(B) &&
              aligned16(C) && scs % 8 == 0;
    for (long long st : strides) ok = ok && st % 8 == 0;
    if (!ok || seq == 0) return static_cast<int>(cudaErrorInvalidValue);
    float* e = static_cast<float*>(ends);
    float* l = static_cast<float*>(logs);
    switch (hd) {
      case 16: return launch_tc_hd<16>(n, a, batch, seg_chunks, e, l, s);
      case 32: return launch_tc_hd<32>(n, a, batch, seg_chunks, e, l, s);
      case 64: return launch_tc_hd<64>(n, a, batch, seg_chunks, e, l, s);
      default: return static_cast<int>(cudaErrorInvalidValue);
    }
  }
  if (kernel != 0 || hd % 4 != 0 || n % 4 != 0 ||
      smem_floats(hd, n) * sizeof(float) > kMaxSmem) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (bf16) return launch_typed<__nv_bfloat16>(a, batch, s);
  return launch_typed<float>(a, batch, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
