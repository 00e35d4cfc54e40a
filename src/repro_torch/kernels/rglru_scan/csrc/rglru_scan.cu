// RG-LRU scan: h_t = a_t * h_{t-1} + b_t over the sequence, from a zero
// state, with an fp32 carry; y_t = h_t in the inputs' type.
//
// Replaces: the Pallas TPU kernel repro/kernels/rglru_scan/rglru_scan.py
// (`_kernel`, launched by `rglru_scan_fwd`) on its layout: a, b (B, S, W)
// -> y (B, S, W), S padded by the wrapper to a multiple of kUnroll with
// a = 1, b = 0 (steps that leave the state as it is).
//
// What bounds it on an H100: bytes.  At the model's prefill shape
// (B=2, S=4096, W=4096, fp32) it reads a and b and writes y once,
// 3 x 134 MB = 403 MB, 0.12 ms at 3.35 TB/s; two flops per element.
//
// Design: one thread per (batch, channel) walks the sequence in order,
// holding h in a register — the TPU kernel's VMEM-resident state.
// Neighbouring threads hold neighbouring channels, so every load and
// store of a warp is one coalesced 128-byte line.  Each thread loads
// kUnroll steps of a and b before it uses them, to keep enough bytes in
// flight across the few CTAs (2 x 4096 threads at the model's shape).
// Multiply and add round separately (no FMA contraction), as the plain
// PyTorch version's `a * h + b` does, so kernel and plain version agree
// bit for bit.  A chunked two-pass scan that spreads the sequence over
// more threads is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kThreads = 64;
constexpr int kUnroll = 16;

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
  return __float2bfloat16(x);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ y, int seq, int width) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= width) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * width + w;
  float h = 0.f;
  for (int t0 = 0; t0 < seq; t0 += kUnroll) {
    float av[kUnroll];
    float bv[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const size_t i = base + static_cast<size_t>(t0 + u) * width;
      av[u] = to_f(a[i]);
      bv[u] = to_f(b[i]);
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      h = __fadd_rn(__fmul_rn(av[u], h), bv[u]);
      y[base + static_cast<size_t>(t0 + u) * width] = from_f<T>(h);
    }
  }
}

template <typename T>
int launch_typed(const void* a, const void* b, void* y, int batch, int seq,
                 int width, cudaStream_t stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      seq, width);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// bf16 != 0: bfloat16 tensors, else float32.  seq % 16 == 0.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* y,
                                 int batch, int seq, int width, int bf16,
                                 void* stream) {
  if (batch <= 0 || width <= 0 || seq % kUnroll != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (bf16) return launch_typed<__nv_bfloat16>(a, b, y, batch, seq, width, s);
  return launch_typed<float>(a, b, y, batch, seq, width, s);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
