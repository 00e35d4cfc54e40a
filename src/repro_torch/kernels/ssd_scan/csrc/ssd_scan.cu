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
// as (b * H, S, .) with B and C broadcast over heads; this one takes the
// model's layout, x (b, S, H, hd) and B, C (b, S, n) shared by the heads
// (ngroups = 1), all through their strides (in the model they are column
// slices of one conv output), so nothing is transposed or copied.
//
// What bounds it on an H100: operations.  At the model's prefill shape
// (mamba2-130m, b=4, S=8192, H=24, hd=64, n=128, bf16) it moves ~221 MB
// (0.066 ms at 3.35 TB/s) but does 2q^2 n + 2q^2 hd + 4q hd n FLOPs per
// (batch, head, chunk), 45 GFLOP at q = 64: 0.67 ms at 67 TFLOP/s on the
// CUDA cores.
//
// Design: one CTA of 256 threads per (batch, head) walks the chunks (the
// TPU grid's sequential chunk axis becomes a loop; the state lives in
// shared memory across it, as in the TPU kernel's VMEM scratch).  The
// chunk is 64 tokens, not the model's 256: the q x q fp32 score tile of a
// 256-token chunk alone (256 KB) exceeds the 227 KB a block can hold.
// Per chunk the CTA loads x (q, hd), B and C (q, n) and dt into shared
// memory as fp32, and forms three products on the CUDA cores, each
// thread holding a 4 x 4 register tile and reading its operands as
// float4 along the reduction axis:
//   1. G = C B^T (q x q, one tile per thread); warp 0 first scans dt * A;
//      then M = G * exp(cum_i - cum_j) * dt_j below the diagonal, selected
//      (never multiplied by a mask: exp overflows above it), into smem;
//   2. y = M x + exp(cum) * (C state^T), written straight to y;
//   3. state = state * exp(cum_last) + sum_t B_t^T (w_t x_t), in place,
//      each thread owning its (4 x 4) state tiles.
// B and C rows are padded by 4 floats so that the 8 lanes of a float4
// phase land in distinct banks.  96 CTAs at b = 4 leave 36 of 132 SMs
// idle; splitting S across CTAs (a second pass for the carry) and wgmma
// are later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

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

}  // namespace

// x (b, S, H, hd) and B, C (b, S, n) bf16 (bf16 != 0) or fp32, read
// through the given strides (elements; unit stride on the last axis);
// dt (b, S, H) and A (H,) fp32; y (b, S, H, hd) contiguous in x's type.
// seq % 64 == 0; hd % 4 == 0; n % 4 == 0.
extern "C" int ssd_scan_launch(const void* x, const void* dt, const void* B,
                               const void* C, const void* A, void* y,
                               int batch, int seq, int heads, int hd, int n,
                               long long sxb, long long sxs, long long sxh,
                               long long sdb, long long sds, long long sdh,
                               long long sbb, long long sbs, long long scb,
                               long long scs, int bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || seq < 0 || seq % kChunk != 0 || hd <= 0 ||
      n <= 0 || hd % 4 != 0 || n % 4 != 0 ||
      smem_floats(hd, n) * sizeof(float) > kMaxSmem) {
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
  if (bf16) return launch_typed<__nv_bfloat16>(a, batch, s);
  return launch_typed<float>(a, batch, s);
}

extern "C" const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
