// Flash attention, forward: online-softmax GQA attention with causal,
// sliding-window and key-padding masks, fp32 running max / sum /
// accumulator, and the probabilities cast to v's type before P·V.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (`_kernel`, launched by `flash_attention_fwd`), on
// its layout: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> o (B, Hq, Sq, D),
// Sq and Sk padded by the wrapper to multiples of kBlockQ and kBlockK;
// q-head h reads kv-head h / (Hq / Hkv).  Keys at or past `seq_k` (the
// unpadded length) are masked; padded query rows are sliced off by the
// wrapper.  q is multiplied by `scale` in its own type, as the TPU
// kernel does (the model passes 1.0: its q is scaled already).
//
// What bounds it on an H100: operations.  At the model's prefill shape
// (B=2, 16 q-heads, 1 kv-head, S=4096, D=256, window 2048, bf16) the
// unmasked (q, k) pairs need ~2.1e11 FLOPs (0.21 ms at the 989 TFLOP/s
// bf16 tensor-core rate) against ~142 MB of q/k/v/o (0.04 ms).
//
// Design (simple first; wgmma, TMA and a K/V pipeline are later work):
// one CTA of 256 threads per (q-block of 64 rows, q-head, batch), looping
// over 32-key blocks and skipping the blocks that causality or the window
// mask out entirely (the result is the same: a fully masked block leaves
// m, l and acc as they were).  Four threads own one query row: each
// scores 8 of the block's 32 keys and keeps a quarter of the row's D
// accumulators, strided by 4 so that the V reads of a warp are conflict
// free; the row's max and sum are combined with two warp shuffles, so
// the softmax state never leaves registers.  Tiles live in dynamic
// shared memory in the input type (74 KB for bf16 at D=256, 140 KB for
// fp32), with one extra 4-byte word per q/k row so that the rows a warp
// reads at the same column fall in different banks.  The products run on
// the CUDA cores in fp32 (one FMA per shared-memory load), so the kernel
// is far from the tensor-core bound.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;          // four threads per query row
constexpr int kCols = kBlockK / 4;     // keys scored per thread
constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
}
template <>
__device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float x) {
  return __float2bfloat16(x);   // round to nearest even, as astype does
}

template <typename T, int D>
__host__ __device__ constexpr int row_stride() {   // D elements + 4 bytes
  return D + 4 / static_cast<int>(sizeof(T));
}

template <typename T, int D>
constexpr size_t smem_bytes() {
  return static_cast<size_t>(kBlockQ + kBlockK) * row_stride<T, D>() *
             sizeof(T) +
         static_cast<size_t>(kBlockK) * D * sizeof(T) +
         static_cast<size_t>(kBlockQ) * (kBlockK + 1) * sizeof(float);
}

template <typename T, int D>
__global__ void __launch_bounds__(kThreads)
    flash_fwd_kernel(const T* __restrict__ q, const T* __restrict__ k,
                     const T* __restrict__ v, T* __restrict__ o, int hq,
                     int hkv, int sq, int sk, int seq_k, int causal,
                     int window, float scale) {
  constexpr int LD = row_stride<T, D>();
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* qs = reinterpret_cast<T*>(smem_raw);        // kBlockQ x LD
  T* ks = qs + kBlockQ * LD;                      // kBlockK x LD
  T* vs = ks + kBlockK * LD;                      // kBlockK x D
  float* ps = reinterpret_cast<float*>(vs + kBlockK * D);  // kBlockQ x 33

  const int q0 = blockIdx.x * kBlockQ;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  const size_t q_off = (static_cast<size_t>(b) * hq + h) * sq * D +
                       static_cast<size_t>(q0) * D;
  const size_t kv_off = (static_cast<size_t>(b) * hkv + kvh) * sk * D;
  const int tid = threadIdx.x;
  const int row = tid >> 2;
  const int quarter = tid & 3;
  const int qpos = q0 + row;

  for (int i = tid; i < kBlockQ * D; i += kThreads) {
    qs[(i / D) * LD + i % D] = from_f<T>(to_f(q[q_off + i]) * scale);
  }

  // Key blocks that hold any unmasked key of this q-block.
  int k_begin = 0;
  int k_end = min(sk, seq_k);
  if (causal) k_end = min(k_end, q0 + kBlockQ);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kb_begin = k_begin / kBlockK;
  const int kb_end = (k_end + kBlockK - 1) / kBlockK;

  float m = kNegInf;
  float l = 0.f;
  float acc[D / 4];
#pragma unroll
  for (int i = 0; i < D / 4; ++i) acc[i] = 0.f;
  float* prow = ps + row * (kBlockK + 1);
  const T* qrow = qs + row * LD;

  for (int kb = kb_begin; kb < kb_end; ++kb) {
    const int k0 = kb * kBlockK;
    __syncthreads();   // the q tile is in; the last block's tiles are read
    for (int i = tid; i < kBlockK * D; i += kThreads) {
      ks[(i / D) * LD + i % D] = k[kv_off + static_cast<size_t>(k0) * D + i];
      vs[i] = v[kv_off + static_cast<size_t>(k0) * D + i];
    }
    __syncthreads();

    float s[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) s[j] = 0.f;
    for (int d = 0; d < D; ++d) {
      const float qd = to_f(qrow[d]);
#pragma unroll
      for (int j = 0; j < kCols; ++j) {
        s[j] += qd * to_f(ks[(quarter + 4 * j) * LD + d]);
      }
    }

    bool ok[kCols];
    float mx = kNegInf;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const int kpos = k0 + quarter + 4 * j;
      ok[j] = kpos < seq_k && (!causal || kpos <= qpos) &&
              (window <= 0 || qpos - kpos < window);
      if (ok[j]) mx = fmaxf(mx, s[j]);
    }
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 1));
    mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, 2));
    const float m_new = fmaxf(m, mx);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int j = 0; j < kCols; ++j) {
      const float p = ok[j] ? expf(s[j] - m_new) : 0.f;
      psum += p;
      prow[quarter + 4 * j] = to_f(from_f<T>(p));   // p cast to v's type
    }
    psum += __shfl_xor_sync(0xffffffffu, psum, 1);
    psum += __shfl_xor_sync(0xffffffffu, psum, 2);
    l = l * alpha + psum;
    m = m_new;
    __syncwarp();      // the row's four threads share prow

#pragma unroll
    for (int i = 0; i < D / 4; ++i) acc[i] *= alpha;
    for (int c = 0; c < kBlockK; ++c) {
      const float pc = prow[c];
      const T* vrow = vs + c * D + quarter;
#pragma unroll
      for (int i = 0; i < D / 4; ++i) acc[i] += pc * to_f(vrow[4 * i]);
    }
  }

  const float lm = fmaxf(l, 1e-30f);
  T* orow = o + q_off + static_cast<size_t>(row) * D + quarter;
#pragma unroll
  for (int i = 0; i < D / 4; ++i) orow[4 * i] = from_f<T>(acc[i] / lm);
}

template <typename T, int D>
int launch_typed(const void* q, const void* k, const void* v, void* o,
                 int batch, int hq, int hkv, int sq, int sk, int seq_k,
                 int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<T, D>();
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<T, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq / kBlockQ, hq, batch);
  flash_fwd_kernel<T, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k),
      static_cast<const T*>(v), static_cast<T*>(o), hq, hkv, sq, sk, seq_k,
      causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_dim(int head_dim, const void* q, const void* k, const void* v,
               void* o, int batch, int hq, int hkv, int sq, int sk, int seq_k,
               int causal, int window, float scale, cudaStream_t stream) {
  switch (head_dim) {
    case 16:
      return launch_typed<T, 16>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                                 causal, window, scale, stream);
    case 32:
      return launch_typed<T, 32>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                                 causal, window, scale, stream);
    case 64:
      return launch_typed<T, 64>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                                 causal, window, scale, stream);
    case 128:
      return launch_typed<T, 128>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                                  causal, window, scale, stream);
    case 256:
      return launch_typed<T, 256>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                                  causal, window, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// window <= 0: no window.  bf16 != 0: bfloat16 tensors, else float32.
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int hq, int hkv, int sq, int sk,
                                      int seq_k, int head_dim, int causal,
                                      int window, int bf16, float scale,
                                      void* stream) {
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || sq % kBlockQ != 0 ||
      sk % kBlockK != 0 || seq_k > sk) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) {
    return launch_dim<__nv_bfloat16>(head_dim, q, k, v, o, batch, hq, hkv, sq,
                                     sk, seq_k, causal, window, scale, s);
  }
  return launch_dim<float>(head_dim, q, k, v, o, batch, hq, hkv, sq, sk,
                           seq_k, causal, window, scale, s);
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
