// Flash attention, forward: online-softmax GQA attention with causal,
// sliding-window and key-padding masks, fp32 running max / sum /
// accumulator, and the probabilities cast to v's type before P·V.
//
// Replaces: the Pallas TPU kernel repro/kernels/flash_attention/
// flash_attention.py (`_kernel`, launched by `flash_attention_fwd`), on
// its layout: q (B, Hq, Sq, D), k/v (B, Hkv, Sk, D) -> o (B, Hq, Sq, D),
// Sq and Sk padded by the wrapper to multiples of 128 and 64 (both
// kernels' blocks divide them); q-head h reads kv-head h / (Hq / Hkv).
// Keys at or past `seq_k` (the unpadded length) are masked; padded query
// rows are sliced off by the wrapper.  q is multiplied by `scale` and
// rounded in its own type, as the TPU kernel does (the model passes 1.0:
// its q is scaled already).
//
// What bounds it on an H100: operations.  At the model's prefill shape
// (B=2, 16 q-heads, 1 kv-head, S=4096, D=256, window 2048, bf16) the
// unmasked (q, k) pairs need 2.06e11 FLOPs (0.2085 ms at the 989 TFLOP/s
// bf16 tensor-core rate) against ~142 MB of q/k/v/o (0.04 ms), so only
// the tensor cores can bring it near its bound.
//
// bf16 (`flash_fwd_bf16_kernel`): Hopper's tensor cores and TMA.  One CTA
// of three warpgroups per (128-row q-block, q-head, batch): 1,024 CTAs at
// the model shape.
// - Warpgroup 2 is the producer: it gives up registers (setmaxnreg 24)
//   and one of its threads issues every TMA load: the Q tile (128 x D)
//   once, then K and V tiles of kBlockN = 64 keys x D through a two-stage
//   ring.  Each stage has "full" mbarriers for K and for V (the bytes
//   landed) and "empty" ones (all 256 consumer threads are done): K is
//   freed as soon as S = Q·Kᵀ has run, V once P·V has.  Rows are loaded in
//   boxes of 64 columns (128 bytes, 128-byte swizzle; D = 32 and 16 take
//   one box of 64 and 32 bytes with the 64- and 32-byte swizzle), which
//   the wgmma descriptors step through.
// - Warpgroups 0 and 1 are consumers (setmaxnreg 240), 64 query rows
//   each.  Per key block: S = Q·Kᵀ by D/16 wgmma.m64n64k16 from shared
//   memory, both operands K-major (32 fp32 registers a thread); masks
//   (by select: a masked score is -inf, so its exp is 0) only on blocks
//   that cross the diagonal, the window's edge or seq_k; the row max over
//   the four lanes of a row (two shuffles); exp2 of the scores; P to bf16
//   in registers: the m64n64 accumulator fragment, 16 keys at a time, is
//   the A fragment of the next wgmma, so P never touches shared memory;
//   O *= alpha in registers; O += P·V by four wgmma.m64nDk16 with V from
//   shared memory, MN-major (transpose bit set).  O is D/2 fp32 registers
//   a thread (128 at D = 256).  The epilogue writes O / l in bf16
//   straight from registers.
// - Schedule: a consumer issues S of block j + 1 and P·V of block j
//   together, then runs the softmax of block j + 1 while its P·V is still
//   on the tensor cores; the two consumers take turns issuing (two named
//   barriers), so one's softmax overlaps the other's products.
// - Shared memory: Q 128·D·2 B + 2 stages × (K + V) 2 × 64·D·2 B, plus
//   nine barriers and 1 KB to align the swizzled tiles: 197,704 B at
//   D = 256 (192 KB of tiles), 99,400 at 128, 50,248 at 64, 25,672 at 32,
//   13,384 at 16.  One CTA per SM; registers 24 × 128 + 240 × 256 = 64,512
//   of the SM's 65,536.
//
// float32 (`flash_fwd_kernel<float>`) stays on the CUDA cores: TF32 tensor
// cores keep ~3 decimal digits, which would break the fp32 tolerance
// (2e-5) and the full-width fp32 decode-vs-forward check that prefills
// through it.  One CTA of 256 threads per (q-block of 64 rows, q-head,
// batch), looping over 32-key blocks and skipping the blocks that
// causality or the window mask out entirely.  Four threads own one query
// row: each scores 8 of the block's 32 keys and keeps a quarter of the
// row's D accumulators, strided by 4 so that the V reads of a warp are
// conflict free; the row's max and sum are combined with two warp
// shuffles.  Tiles live in dynamic shared memory (140 KB at D=256), with
// one extra 4-byte word per q/k row against bank conflicts; one FMA per
// shared-memory load.
//
// The entry point picks the kernel by dtype: a fixed choice by type, not a
// fallback.
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

#include <cmath>
#include <cstddef>
#include <cstdint>

#include "../../csrc/hopper.cuh"

namespace {

// float32 kernel
constexpr int kBlockQ = 64;
constexpr int kBlockK = 32;
constexpr int kThreads = 256;          // four threads per query row
constexpr int kCols = kBlockK / 4;     // keys scored per thread
constexpr float kNegInf = -1e30f;      // the TPU kernel's NEG_INF

// bfloat16 kernel
constexpr int kBlockM = 128;           // query rows per CTA, 64 per consumer
constexpr int kBlockN = 64;            // keys per block
constexpr int kStages = 2;             // K/V ring depth
constexpr int kThreadsBf16 = 384;      // two consumer warpgroups, one producer
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
template <typename T>
__device__ __forceinline__ T from_f(float x);
template <>
__device__ __forceinline__ float from_f<float>(float x) {
  return x;
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

// ---------------------------------------------------------------------------
// bfloat16: wgmma + TMA
// ---------------------------------------------------------------------------
template <int D>
struct Bf16Tiles {
  static constexpr int kBoxCols = D < 64 ? D : 64;     // columns per TMA box
  static constexpr int kRowBytes = kBoxCols * 2;       // 32, 64 or 128
  static constexpr int kBoxes = D / kBoxCols;
  static constexpr uint64_t kSwizzle =                 // descriptor code
      kRowBytes == 128 ? 1 : kRowBytes == 64 ? 2 : 3;
  static constexpr int kKSteps = D / 16;               // of Q·Kᵀ
  static constexpr int kStepsPerBox = kBoxCols / 16;
  static constexpr int kQBoxBytes = kBlockM * kRowBytes;
  static constexpr int kKVBoxBytes = kBlockN * kRowBytes;
  static constexpr int kQBytes = kBlockM * D * 2;
  static constexpr int kKVBytes = kBlockN * D * 2;     // one K or V tile
  static constexpr int kBarriers = 1 + 4 * kStages;    // q; k, v full, empty
  static constexpr size_t kSmem =
      1024 + kQBytes + 2 * kStages * kKVBytes + 8 * kBarriers;
};

// Named barriers (0 is __syncthreads): per consumer warpgroup, one for
// its own 128 threads and one that orders its turns on the tensor cores.
constexpr int kBarScaleQ = 1;   // + warpgroup
constexpr int kBarTurn = 3;     // + warpgroup

template <bool B>
struct Bool {
  static constexpr bool value = B;
};

template <int D>
__global__ void __launch_bounds__(kThreadsBf16, 1)
    flash_fwd_bf16_kernel(const __grid_constant__ CUtensorMap tm_q,
                          const __grid_constant__ CUtensorMap tm_k,
                          const __grid_constant__ CUtensorMap tm_v,
                          __nv_bfloat16* __restrict__ o, int hq, int hkv,
                          int sq, int sk, int seq_k, int causal, int window,
                          float scale) {
  using L = Bf16Tiles<D>;
  extern __shared__ unsigned char smem_raw[];
  // Swizzled tiles start on a 1024-byte boundary (the 128-byte swizzle's
  // period), as the descriptors' zero base offset assumes.
  unsigned char* smem =
      smem_raw + ((1024 - (hopper::smem_addr(smem_raw) & 1023)) & 1023);
  unsigned char* qs = smem;                                  // kBlockM x D
  unsigned char* ks = qs + L::kQBytes;                       // stages x 64 x D
  unsigned char* vs = ks + kStages * L::kKVBytes;
  uint64_t* bars = reinterpret_cast<uint64_t*>(vs + kStages * L::kKVBytes);
  uint64_t* q_full = bars;
  uint64_t* k_full = bars + 1;               // the tile landed
  uint64_t* v_full = k_full + kStages;
  uint64_t* k_empty = v_full + kStages;      // both consumers are done with it
  uint64_t* v_empty = k_empty + kStages;

  const int q0 = blockIdx.x * kBlockM;
  const int h = blockIdx.y;
  const int b = blockIdx.z;
  const int kvh = h / (hq / hkv);
  // Key blocks that hold any unmasked key of this q-block.
  int k_begin = 0;
  int k_end = min(sk, seq_k);
  if (causal) k_end = min(k_end, q0 + kBlockM);
  if (window > 0) k_begin = max(0, q0 - window + 1);
  const int kb_begin = k_begin / kBlockN;
  const int n_blocks = max(0, (k_end + kBlockN - 1) / kBlockN - kb_begin);

  const int tid = threadIdx.x;
  if (tid == 0) {
    hopper::mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      hopper::mbar_init(&k_full[s], 1);
      hopper::mbar_init(&v_full[s], 1);
      hopper::mbar_init(&k_empty[s], 2 * 128);
      hopper::mbar_init(&v_empty[s], 2 * 128);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= 256) {
    // ---- producer warpgroup: one thread issues every load ----
    asm volatile("setmaxnreg.dec.sync.aligned.u32 24;\n");
    if (tid == 256) {
      const int q_row = (b * hq + h) * sq + q0;   // rows of the 2-D maps
      const int kv_row = (b * hkv + kvh) * sk;
      hopper::mbar_expect_tx(q_full, L::kQBytes);
      for (int c = 0; c < L::kBoxes; ++c) {
        hopper::tma_load_2d(qs + c * L::kQBoxBytes, &tm_q, q_full,
                            c * L::kBoxCols, q_row);
      }
      for (int j = 0; j < n_blocks; ++j) {
        const int s = j % kStages;
        const uint32_t parity = ((j / kStages) - 1) & 1;   // of the last use
        const int row = kv_row + (kb_begin + j) * kBlockN;
        if (j >= kStages) hopper::mbar_wait(&k_empty[s], parity);
        hopper::mbar_expect_tx(&k_full[s], L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          hopper::tma_load_2d(ks + s * L::kKVBytes + c * L::kKVBoxBytes,
                              &tm_k, &k_full[s], c * L::kBoxCols, row);
        }
        if (j >= kStages) hopper::mbar_wait(&v_empty[s], parity);
        hopper::mbar_expect_tx(&v_full[s], L::kKVBytes);
        for (int c = 0; c < L::kBoxes; ++c) {
          hopper::tma_load_2d(vs + s * L::kKVBytes + c * L::kKVBoxBytes,
                              &tm_v, &v_full[s], c * L::kBoxCols, row);
        }
      }
    }
  } else {
    // ---- consumer warpgroups: 64 query rows each ----
    asm volatile("setmaxnreg.inc.sync.aligned.u32 240;\n");
    const int wg = tid / 128;
    const int t = tid % 128;
    const int lane = t % 32;
    // This thread's rows of the accumulator fragments: row_a and row_a + 8.
    const int row_a = q0 + wg * 64 + (t / 32) * 16 + lane / 4;
    const int col_t = (lane % 4) * 2;
    const int qmin = q0 + wg * 64;
    const int qmax = qmin + 63;

    hopper::mbar_wait(q_full, 0);
    if (scale != 1.f) {
      // q * scale, rounded to bf16, on this warpgroup's 64 rows of every
      // box (contiguous, whatever the swizzle), before the first wgmma.
      for (int c = 0; c < L::kBoxes; ++c) {
        uint4* rows = reinterpret_cast<uint4*>(qs + c * L::kQBoxBytes +
                                               wg * 64 * L::kRowBytes);
        for (int i = t; i < 64 * L::kRowBytes / 16; i += 128) {
          uint4 u = rows[i];
          __nv_bfloat162* e = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const float2 f = __bfloat1622float2(e[j]);
            e[j] = __floats2bfloat162_rn(f.x * scale, f.y * scale);
          }
          rows[i] = u;
        }
      }
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
      hopper::named_sync(kBarScaleQ + wg, 128);
    }

    const uint32_t q_base = hopper::smem_addr(qs) + wg * 64 * L::kRowBytes;
    const uint32_t k_base = hopper::smem_addr(ks);
    const uint32_t v_base = hopper::smem_addr(vs);
    float acc[D / 2];
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float sc[32] = {};        // scores of one key block, then probabilities
    float m[2] = {kNegInf, kNegInf};
    float l[2] = {0.f, 0.f};  // this thread's share of each row's sum
    float alpha[2] = {1.f, 1.f};

    // S = Q·Kᵀ of block j into sc (64 x 64 per warpgroup, fp32): D/16
    // steps, each 16 columns (32 bytes) further into a box's swizzled
    // rows; 8-row groups 8 rows apart.  Issued and committed, not waited.
    auto mma_scores = [&](int j) {
      const uint32_t k_tile = k_base + (j % kStages) * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < L::kKSteps; ++kk) {
        const int box = kk / L::kStepsPerBox;
        const uint32_t col = (kk % L::kStepsPerBox) * 32;
        const uint64_t da = hopper::make_desc(
            q_base + box * L::kQBoxBytes + col, 16, 8 * L::kRowBytes,
            L::kSwizzle);
        const uint64_t db = hopper::make_desc(
            k_tile + box * L::kKVBoxBytes + col, 16, 8 * L::kRowBytes,
            L::kSwizzle);
        hopper::wgmma_ss<64>(sc, da, db, kk > 0);
      }
      hopper::wgmma_commit();
    };
    // O += P·V of block j: A = P from registers, B = V (16 keys x D)
    // MN-major, 16 rows further per step.  Issued and committed.
    auto mma_pv = [&](int j, const uint32_t (&pa)[4][4]) {
      const uint32_t v_tile = v_base + (j % kStages) * L::kKVBytes;
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t db =
            hopper::make_desc(v_tile + kk * 16 * L::kRowBytes,
                              L::kKVBoxBytes, 8 * L::kRowBytes, L::kSwizzle);
        hopper::wgmma_rs<D>(acc, pa[kk], db);
      }
      hopper::wgmma_commit();
    };
    // Online softmax of block j's scores, once they landed: sc becomes
    // the fp32 probabilities, m and l move on, alpha rescales O.
    // Fragment element i: row row_a + 8 * ((i / 2) % 2), key
    // k0 + (i / 4) * 8 + col_t + i % 2.
    auto softmax = [&](int j) {
      hopper::fence_regs(sc);
      const int k0 = (kb_begin + j) * kBlockN;
      // Masks only where a row of this warpgroup misses a key of the block.
      if (!(k0 + kBlockN <= seq_k && (!causal || k0 + kBlockN - 1 <= qmin) &&
            (window <= 0 || qmax - k0 < window))) {
#pragma unroll
        for (int i = 0; i < 32; ++i) {
          const int qpos = row_a + 8 * ((i / 2) % 2);
          const int kpos = k0 + (i / 4) * 8 + col_t + i % 2;
          const bool ok = kpos < seq_k && (!causal || kpos <= qpos) &&
                          (window <= 0 || qpos - kpos < window);
          sc[i] = ok ? sc[i] : -INFINITY;   // select: exp(-inf) is 0
        }
      }
      float mx[2] = {m[0], m[1]};
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        mx[(i / 2) % 2] = fmaxf(mx[(i / 2) % 2], sc[i]);
      }
      float m_log2[2];
#pragma unroll
      for (int r = 0; r < 2; ++r) {
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 1));
        mx[r] = fmaxf(mx[r], __shfl_xor_sync(0xffffffffu, mx[r], 2));
        alpha[r] = exp2f((m[r] - mx[r]) * kLog2e);
        m[r] = mx[r];
        m_log2[r] = mx[r] * kLog2e;
        l[r] *= alpha[r];
      }
      // The fp32 p goes into the sum, its bf16 rounding into P·V, as in
      // the TPU kernel.
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        sc[i] = exp2f(fmaf(sc[i], kLog2e, -m_log2[(i / 2) % 2]));
        l[(i / 2) % 2] += sc[i];
      }
    };
    // Block j's P·V, with S of block j + 1 if there is one (kNext): both
    // issued in this consumer's turn on the tensor cores, then the
    // softmax of block j + 1 runs while P·V is still in flight.  The two
    // consumers alternate turns, so one's softmax overlaps the other's
    // products.
    auto step = [&](int j, auto has_next) {
      constexpr bool kNext = decltype(has_next)::value;
      // P of block j in bf16, in the A-operand layout: the m64n64
      // accumulator fragment, 16 keys at a time (P never touches shared
      // memory).
      uint32_t pa[4][4];
#pragma unroll
      for (int i = 0; i < 32; i += 2) {
        pa[i / 8][(i % 8) / 2] = hopper::pack_bf16(sc[i], sc[i + 1]);
      }
      if constexpr (kNext) {
        hopper::mbar_wait(&k_full[(j + 1) % kStages],
                          ((j + 1) / kStages) & 1);
      }
      hopper::mbar_wait(&v_full[j % kStages], (j / kStages) & 1);
#pragma unroll
      for (int i = 0; i < D / 2; ++i) acc[i] *= alpha[(i / 2) % 2];
      hopper::named_sync(kBarTurn + wg, 256);
      hopper::fence_regs(sc);
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::wgmma_fence();
      if constexpr (kNext) mma_scores(j + 1);
      mma_pv(j, pa);
      hopper::named_arrive(kBarTurn + 1 - wg, 256);
      if constexpr (kNext) {
        hopper::wgmma_wait<1>();     // S of block j + 1; P·V runs on
        hopper::mbar_arrive(&k_empty[(j + 1) % kStages]);
        softmax(j + 1);
      }
      hopper::wgmma_wait<0>();
      hopper::fence_regs(acc);
      hopper::fence_regs(pa);
      hopper::mbar_arrive(&v_empty[j % kStages]);
    };

    // Warpgroup 0 takes the first turn.
    if (wg == 0) hopper::named_arrive(kBarTurn, 256);
    if (n_blocks > 0) {
      hopper::mbar_wait(&k_full[0], 0);
      hopper::named_sync(kBarTurn + wg, 256);
      hopper::fence_regs(sc);
      hopper::wgmma_fence();
      mma_scores(0);
      hopper::named_arrive(kBarTurn + 1 - wg, 256);
      hopper::wgmma_wait<0>();
      hopper::mbar_arrive(&k_empty[0]);
      softmax(0);
    }
    for (int j = 0; j + 1 < n_blocks; ++j) step(j, Bool<true>{});
    if (n_blocks > 0) step(n_blocks - 1, Bool<false>{});

    // O / max(l, 1e-30) in bf16, straight from the fragments.
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 1);
      l[r] += __shfl_xor_sync(0xffffffffu, l[r], 2);
      l[r] = fmaxf(l[r], 1e-30f);
    }
    __nv_bfloat16* out = o + (static_cast<size_t>(b) * hq + h) * sq * D +
                         static_cast<size_t>(row_a) * D + col_t;
#pragma unroll
    for (int n8 = 0; n8 < D / 8; ++n8) {
      *reinterpret_cast<uint32_t*>(out + n8 * 8) =
          hopper::pack_bf16(acc[4 * n8] / l[0], acc[4 * n8 + 1] / l[0]);
      *reinterpret_cast<uint32_t*>(out + 8 * D + n8 * 8) =
          hopper::pack_bf16(acc[4 * n8 + 2] / l[1], acc[4 * n8 + 3] / l[1]);
    }
  }
}

// ---------------------------------------------------------------------------
// host side
// ---------------------------------------------------------------------------
// A (rows, D) bf16 row-major tensor read in boxes of `box_rows` x
// min(D, 64) columns, swizzled to the box's row width.
template <int D>
bool encode_map(CUtensorMap* map, const void* ptr, uint64_t rows,
                uint32_t box_rows) {
  using L = Bf16Tiles<D>;
  const hopper::EncodeTiled encode = hopper::encode_tiled();
  if (encode == nullptr) return false;
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(D), rows};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(D) * 2};
  const cuuint32_t box[2] = {static_cast<cuuint32_t>(L::kBoxCols), box_rows};
  const cuuint32_t elem_strides[2] = {1, 1};
  const CUtensorMapSwizzle swizzle =
      L::kRowBytes == 128  ? CU_TENSOR_MAP_SWIZZLE_128B
      : L::kRowBytes == 64 ? CU_TENSOR_MAP_SWIZZLE_64B
                           : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 2,
                const_cast<void*>(ptr), dims, strides, box, elem_strides,
                CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch_bf16(const void* q, const void* k, const void* v, void* o,
                int batch, int hq, int hkv, int sq, int sk, int seq_k,
                int causal, int window, float scale, cudaStream_t stream) {
  using L = Bf16Tiles<D>;
  CUtensorMap tm_q, tm_k, tm_v;
  if (!encode_map<D>(&tm_q, q, static_cast<uint64_t>(batch) * hq * sq,
                     kBlockM) ||
      !encode_map<D>(&tm_k, k, static_cast<uint64_t>(batch) * hkv * sk,
                     kBlockN) ||
      !encode_map<D>(&tm_v, v, static_cast<uint64_t>(batch) * hkv * sk,
                     kBlockN)) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_bf16_kernel<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(L::kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq / kBlockM, hq, batch);
  flash_fwd_bf16_kernel<D><<<grid, kThreadsBf16, L::kSmem, stream>>>(
      tm_q, tm_k, tm_v, static_cast<__nv_bfloat16*>(o), hq, hkv, sq, sk,
      seq_k, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_fp32(const void* q, const void* k, const void* v, void* o,
                int batch, int hq, int hkv, int sq, int sk, int seq_k,
                int causal, int window, float scale, cudaStream_t stream) {
  constexpr size_t smem = smem_bytes<float, D>();
  // Above 48 KB a launch is refused unless the kernel opts in.
  cudaError_t err = cudaFuncSetAttribute(
      flash_fwd_kernel<float, D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(sq / kBlockQ, hq, batch);
  flash_fwd_kernel<float, D><<<grid, kThreads, smem, stream>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<float*>(o), hq, hkv, sq, sk,
      seq_k, causal, window, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_typed(int bf16, const void* q, const void* k, const void* v,
                 void* o, int batch, int hq, int hkv, int sq, int sk,
                 int seq_k, int causal, int window, float scale,
                 cudaStream_t stream) {
  if (bf16) {
    if (sq % kBlockM != 0 || sk % kBlockN != 0) {
      return static_cast<int>(cudaErrorInvalidValue);
    }
    return launch_bf16<D>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k, causal,
                          window, scale, stream);
  }
  return launch_fp32<D>(q, k, v, o, batch, hq, hkv, sq, sk, seq_k, causal,
                        window, scale, stream);
}

}  // namespace

// window <= 0: no window.  bf16 != 0: bfloat16 tensors (the wgmma kernel),
// else float32 (the CUDA-core kernel).
extern "C" int flash_attention_launch(const void* q, const void* k,
                                      const void* v, void* o, int batch,
                                      int hq, int hkv, int sq, int sk,
                                      int seq_k, int head_dim, int causal,
                                      int window, int bf16, float scale,
                                      void* stream) {
  // Rows of the (B * H * S, D) views are int coordinates of the TMA boxes.
  if (batch <= 0 || hkv <= 0 || hq % hkv != 0 || sq % kBlockQ != 0 ||
      sk % kBlockK != 0 || seq_k > sk ||
      static_cast<int64_t>(batch) * hq * sq > INT32_MAX ||
      static_cast<int64_t>(batch) * hkv * sk > INT32_MAX) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (head_dim) {
    case 16:
      return launch_typed<16>(bf16, q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                              causal, window, scale, s);
    case 32:
      return launch_typed<32>(bf16, q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                              causal, window, scale, s);
    case 64:
      return launch_typed<64>(bf16, q, k, v, o, batch, hq, hkv, sq, sk, seq_k,
                              causal, window, scale, s);
    case 128:
      return launch_typed<128>(bf16, q, k, v, o, batch, hq, hkv, sq, sk,
                               seq_k, causal, window, scale, s);
    case 256:
      return launch_typed<256>(bf16, q, k, v, o, batch, hq, hkv, sq, sk,
                               seq_k, causal, window, scale, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

extern "C" const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}
