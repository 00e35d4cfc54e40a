// RG-LRU scan: h_t = a_t * h_{t-1} + b_t over the sequence, from a zero
// state, with an fp32 carry; y_t = h_t in the inputs' type.
//
// Replaces: the Pallas TPU kernel repro/kernels/rglru_scan/rglru_scan.py
// (`_kernel`, launched by `rglru_scan_fwd`) on its layout: a, b (B, S, W)
// -> y (B, S, W), contiguous.  Both kernels here take any S and any W, so
// nothing is padded: the TPU kernel's sequential chunk axis becomes a
// loop inside each CTA, its VMEM-resident state a register per channel.
//
// What bounds it on an H100: bytes.  At the model's prefill shape
// (recurrentgemma-9b, B=2, S=4096, W=4096, fp32) it reads a and b and
// writes y once, 3 x 134 MB = 403 MB, 0.12 ms at 3.35 TB/s; two flops per
// element.  The serial chain of one channel (one multiply, one add a
// step) takes ~20 us over 4096 steps, a sixth of that: what sets the time
// is how many bytes are in flight (Little's law: ~3.4 MB across the card
// at ~1 us of loaded latency).
//
// Every step of a channel runs in order, the multiply and the add rounded
// separately (`__fmul_rn`, `__fadd_rn`: no FMA contraction), as the plain
// PyTorch version's `a * h + b` does, so both kernels agree with it bit
// for bit.  A chunked two-pass scan would change the order of the sums
// and move no fewer bytes.
//
// Two kernels behind one entry point; the wrapper chooses by a stated rule
// (rglru_scan.py `plan`), from dtype, width and alignment, before the
// launch:
//
// `rglru_scan_tma_kernel<T, C, D, K>` (rows of 16-byte multiples, 16-byte
// aligned bases): one CTA per (batch row, tile of C channels), 2 x 4096 /
// 32 = 256 CTAs at the model shape, all co-resident.  One producer thread
// (the last warp) issues 3-D TMA loads of a box of C channels x D steps of
// a and of b into a K-stage ring in shared memory; each stage has a full
// mbarrier (the bytes landed) and an empty one (every consumer warp is
// done with it).  The consumer warps hold one channel a lane: each reads
// its column of the stage into registers (lane i reads word i of a row:
// no bank conflicts), releases the stage, then walks the D steps in
// order; each step's y leaves as one coalesced store a warp.  TMA fills a
// box past S or W with zeros; the consumers store no step past S and no
// channel past W.  The tiles (`Tile`, from a sweep on the H100): fp32
// C = 32, D = 16, K = 4 (16 KB in flight a CTA, ~4 MB across the card;
// rings of more steps were slower) and bf16 C = 32, D = 64, K = 4
// (32 KB).
//
// `rglru_scan_kernel<T>` (any other shape): one thread per (batch,
// channel) loads kUnroll steps of a and b through registers before it
// runs them, then the last S % kUnroll steps one at a time.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "../../csrc/hopper.cuh"

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

// --- one thread per channel, loads through registers ------------------------
template <typename T>
__global__ void __launch_bounds__(kThreads)
    rglru_scan_kernel(const T* __restrict__ a, const T* __restrict__ b,
                      T* __restrict__ y, int seq, int width) {
  const int w = blockIdx.x * kThreads + threadIdx.x;
  if (w >= width) return;
  const size_t base = static_cast<size_t>(blockIdx.y) * seq * width + w;
  float h = 0.f;
  int t0 = 0;
  for (; t0 + kUnroll <= seq; t0 += kUnroll) {
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
  for (; t0 < seq; ++t0) {               // the last S % kUnroll steps
    const size_t i = base + static_cast<size_t>(t0) * width;
    h = __fadd_rn(__fmul_rn(to_f(a[i]), h), to_f(b[i]));
    y[i] = from_f<T>(h);
  }
}

// --- TMA load ring -----------------------------------------------------------
template <typename T, int C, int D, int K>
struct Ring {
  static constexpr int kConsumerWarps = (C + 31) / 32;
  static constexpr int kThreads = 32 * (kConsumerWarps + 1);
  static constexpr int kTileBytes = C * D * static_cast<int>(sizeof(T));
  static constexpr int kStageBytes = 2 * kTileBytes;          // a, then b
  static constexpr int kSmem = K * kStageBytes + 2 * K * 8 + 128;
  static_assert(C * sizeof(T) % 16 == 0, "TMA rows are 16-byte multiples");
  static_assert(kTileBytes % 128 == 0, "tiles keep 128-byte alignment");
  static_assert(D <= 256 && C <= 256, "a TMA box is at most 256 a side");
  static_assert(kSmem <= 227 * 1024, "a block holds at most 227 KB");
};

template <typename T, int C, int D, int K>
__global__ void __launch_bounds__(Ring<T, C, D, K>::kThreads)
    rglru_scan_tma_kernel(const __grid_constant__ CUtensorMap tm_a,
                          const __grid_constant__ CUtensorMap tm_b,
                          T* __restrict__ y, int seq, int width) {
  using R = Ring<T, C, D, K>;
  extern __shared__ unsigned char smem_raw[];
  unsigned char* smem =
      smem_raw + ((128 - (hopper::smem_addr(smem_raw) & 127)) & 127);
  uint64_t* full = reinterpret_cast<uint64_t*>(smem + K * R::kStageBytes);
  uint64_t* empty = full + K;

  const int w0 = blockIdx.x * C;
  const int batch = blockIdx.y;
  const int n_tiles = (seq + D - 1) / D;
  const int warp = threadIdx.x / 32;
  const int lane = threadIdx.x % 32;

  if (threadIdx.x == 0) {
    for (int s = 0; s < K; ++s) {
      hopper::mbar_init(&full[s], 1);
      hopper::mbar_init(&empty[s], R::kConsumerWarps);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (warp == R::kConsumerWarps) {
    // ---- producer: one thread keeps up to K stages of loads in flight ----
    if (lane == 0) {
      for (int j = 0; j < n_tiles; ++j) {
        const int s = j % K;
        if (j >= K) hopper::mbar_wait(&empty[s], ((j / K) - 1) & 1);
        unsigned char* stage = smem + s * R::kStageBytes;
        hopper::mbar_expect_tx(&full[s], R::kStageBytes);
        hopper::tma_load_3d(stage, &tm_a, &full[s], w0, j * D, batch);
        hopper::tma_load_3d(stage + R::kTileBytes, &tm_b, &full[s], w0,
                            j * D, batch);
      }
    }
    return;
  }

  // ---- consumers: one channel a lane, every step in order ----
  // A stage's column goes to registers first and the stage is released at
  // once: the loads leave the serial chain, and the producer refills the
  // stage while the chain runs.  Lanes past C (C = 16) read channel 0's
  // column and store nothing.
  const int c = warp * 32 + lane;
  const bool store = c < C && w0 + c < width;
  const int col = c < C ? c : 0;
  T* yp = y + (static_cast<size_t>(batch) * seq) * width + w0 + c;
  float h = 0.f;
  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % K;
    hopper::mbar_wait(&full[s], (j / K) & 1);
    const T* as = reinterpret_cast<const T*>(smem + s * R::kStageBytes) + col;
    const T* bs = as + C * D;
    float av[D];
    float bv[D];
#pragma unroll
    for (int r = 0; r < D; ++r) {
      av[r] = to_f(as[r * C]);
      bv[r] = to_f(bs[r * C]);
    }
    __syncwarp();
    if (lane == 0) hopper::mbar_arrive(&empty[s]);
    T* yt = yp + static_cast<size_t>(j) * D * width;
    const int rows = seq - j * D;
    if (rows >= D) {
#pragma unroll
      for (int r = 0; r < D; ++r) {
        h = __fadd_rn(__fmul_rn(av[r], h), bv[r]);
        if (store) yt[static_cast<size_t>(r) * width] = from_f<T>(h);
      }
    } else {
      // The last tile: past S the chain runs on TMA's zeros and stores
      // nothing (h is not used after it).
#pragma unroll
      for (int r = 0; r < D; ++r) {
        h = __fadd_rn(__fmul_rn(av[r], h), bv[r]);
        if (store && r < rows) {
          yt[static_cast<size_t>(r) * width] = from_f<T>(h);
        }
      }
    }
  }
}

// The TMA kernel's tile per type (rglru_scan.py TMA_TILE): C channels x
// D steps, K stages.  Chosen by a sweep on the H100 (PERF.md section 6):
// in fp32 rings of 64 steps (D x K) were fastest at any C, in bf16 tiles
// of 64 steps.
template <typename T>
struct Tile;
template <>
struct Tile<float> {
  static constexpr int C = 32, D = 16, K = 4;
};
template <>
struct Tile<__nv_bfloat16> {
  static constexpr int C = 32, D = 64, K = 4;
};

template <typename T>
constexpr CUtensorMapDataType tma_type() {
  return sizeof(T) == 4 ? CU_TENSOR_MAP_DATA_TYPE_FLOAT32
                        : CU_TENSOR_MAP_DATA_TYPE_BFLOAT16;
}

// (B, S, W) contiguous, read in boxes of C channels x D steps x 1 row.
template <typename T>
bool encode_map(CUtensorMap* map, const void* ptr, int batch, int seq,
                int width, int c, int d) {
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {static_cast<cuuint64_t>(width),
                              static_cast<cuuint64_t>(seq),
                              static_cast<cuuint64_t>(batch)};
  const cuuint64_t row = static_cast<cuuint64_t>(width) * sizeof(T);
  const cuuint64_t strides[2] = {row, row * static_cast<cuuint64_t>(seq)};
  const cuuint32_t box[3] = {static_cast<cuuint32_t>(c),
                             static_cast<cuuint32_t>(d), 1};
  const cuuint32_t elem_strides[3] = {1, 1, 1};
  return encode(map, tma_type<T>(), 3, const_cast<void*>(ptr), dims,
                strides, box, elem_strides, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T>
int launch_tma(const void* a, const void* b, void* y, int batch, int seq,
               int width, cudaStream_t stream) {
  constexpr int C = Tile<T>::C, D = Tile<T>::D, K = Tile<T>::K;
  using R = Ring<T, C, D, K>;
  CUtensorMap tm_a, tm_b;
  if (!encode_map<T>(&tm_a, a, batch, seq, width, C, D) ||
      !encode_map<T>(&tm_b, b, batch, seq, width, C, D)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (R::kSmem > 48 * 1024) {
    const cudaError_t err = cudaFuncSetAttribute(
        rglru_scan_tma_kernel<T, C, D, K>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, R::kSmem);
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((width + C - 1) / C, batch);
  rglru_scan_tma_kernel<T, C, D, K><<<grid, R::kThreads, R::kSmem, stream>>>(
      tm_a, tm_b, static_cast<T*>(y), seq, width);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int launch_ldg(const void* a, const void* b, void* y, int batch, int seq,
               int width, cudaStream_t stream) {
  const dim3 grid((width + kThreads - 1) / kThreads, batch);
  rglru_scan_kernel<T><<<grid, kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(y),
      seq, width);
  return static_cast<int>(cudaGetLastError());
}

bool aligned16(const void* p) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0;
}

}  // namespace

// a, b, y (B, S, W) contiguous, bfloat16 (bf16 != 0) or float32; any S.
// kernel 0: the per-thread kernel (any width and alignment).  kernel 1:
// the TMA ring with the type's Tile (rows of W elements a 16-byte
// multiple, a and b 16-byte aligned).  The caller chooses the kernel (the
// wrapper's rule); nothing here falls back from one to the other.
extern "C" int rglru_scan_launch(const void* a, const void* b, void* y,
                                 int batch, int seq, int width, int bf16,
                                 int kernel, void* stream) {
  if (batch <= 0 || seq <= 0 || width <= 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (kernel == 1) {
    const int elem = bf16 ? 2 : 4;
    if (width * elem % 16 != 0 || !aligned16(a) || !aligned16(b)) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    if (bf16) return launch_tma<__nv_bfloat16>(a, b, y, batch, seq, width, s);
    return launch_tma<float>(a, b, y, batch, seq, width, s);
  }
  if (kernel != 0) return static_cast<int>(cudaErrorInvalidValue);
  if (bf16) return launch_ldg<__nv_bfloat16>(a, b, y, batch, seq, width, s);
  return launch_ldg<float>(a, b, y, batch, seq, width, s);
}

extern "C" const char* rglru_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
