// Pieces shared by the flash-attention kernels for Hopper (sm_90a): the
// forward (flash_attention.cu, K1) and the backward (flash_attention_bwd.cu,
// K2 dq and K3 dk/dv).
//
// Products are mma.sync m16n8k16 (bf16 x bf16 -> fp32), one warp per 16
// rows. Tiles live in shared memory as row-major [rows, D] bf16 with rows
// padded by 8 elements (row stride D + 8), which keeps the 32-bit fragment
// loads of a warp on 32 distinct banks.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

constexpr int NTHREADS = 128;  // 4 warps a CTA
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ void mma_16816(float c[4], const uint32_t a[4],
                                          uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// Two floats -> one 32-bit register of two bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Two bf16 from (possibly non-adjacent) shared-memory slots, lo first.
__device__ __forceinline__ uint32_t pack_pair(const __nv_bfloat16* lo,
                                              const __nv_bfloat16* hi) {
  uint16_t l = *reinterpret_cast<const uint16_t*>(lo);
  uint16_t h = *reinterpret_cast<const uint16_t*>(hi);
  return static_cast<uint32_t>(l) | (static_cast<uint32_t>(h) << 16);
}

__device__ __forceinline__ uint32_t ld32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// Stage rows [row0, row0 + ROWS) of a [L, D] slice (row stride sl) into
// shared memory with 16-byte loads; rows at or past L are zero. With SCALE
// every element is multiplied by `scale` in fp32 and rounded back to bf16:
// q' = bf16(q * bf16(sm_scale * log2 e)), as the JAX host folds the factor
// into q in q's dtype.
template <int D, int ROWS, bool SCALE = false>
__device__ __forceinline__ void load_rows(__nv_bfloat16* dst,
                                          const __nv_bfloat16* src,
                                          long long sl, int row0, int L,
                                          int tid, float scale = 1.f) {
  constexpr int LDS = D + 8;
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NTHREADS) {
    const int r = i / CH, c = (i % CH) * 8;
    uint4 val = make_uint4(0u, 0u, 0u, 0u);
    if (row0 + r < L) {
      val = *reinterpret_cast<const uint4*>(src + (long long)(row0 + r) * sl + c);
      if (SCALE) {
        __nv_bfloat16* e = reinterpret_cast<__nv_bfloat16*>(&val);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
      }
    }
    *reinterpret_cast<uint4*>(dst + r * LDS + c) = val;
  }
}

// The A fragment of k-step kk for rows r0 and r0 + 8 of a shared tile
// (g = lane / 4 picks r0, t = lane % 4 the column pair).
template <int D>
__device__ __forceinline__ void load_a(uint32_t a[4], const __nv_bfloat16* s,
                                       int r0, int kk, int t) {
  constexpr int LDS = D + 8;
  const __nv_bfloat16* p = s + r0 * LDS + kk * 16 + 2 * t;
  a[0] = ld32(p);
  a[1] = ld32(p + 8 * LDS);
  a[2] = ld32(p + 8);
  a[3] = ld32(p + 8 * LDS + 8);
}

// acc[j] += A B^T over the head dim: A is the warp's 16 rows (r0 = warp's
// first row + g) of shared tile sA, B is rows [8j, 8j + 8) of shared tile
// sB, both [rows, D]. acc is the m16n8 C fragment of columns 8j..8j+7.
template <int D, int NJ>
__device__ __forceinline__ void mma_abt(float (&acc)[NJ][4],
                                        const __nv_bfloat16* sA, int r0,
                                        const __nv_bfloat16* sB, int g,
                                        int t) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk) {
    uint32_t a[4];
    load_a<D>(a, sA, r0, kk, t);
#pragma unroll
    for (int j = 0; j < NJ; ++j) {
      const __nv_bfloat16* br = sB + (j * 8 + g) * LDS + kk * 16 + 2 * t;
      mma_16816(acc[j], a, ld32(br), ld32(br + 8));
    }
  }
}

// acc[n] += bf16(P) B: P is 16 x 16*NK in C-fragment layout (p[j] holds
// columns 8j..8j+7, rounded to bf16 here: the accumulator layout of one
// product is the A layout of the next), B is a shared [16*NK, D] tile.
// acc[n] covers output columns 8n..8n+7.
template <int D, int NK>
__device__ __forceinline__ void mma_pb(float (&acc)[D / 8][4],
                                       const float (&p)[2 * NK][4],
                                       const __nv_bfloat16* sB, int g,
                                       int t) {
  constexpr int LDS = D + 8;
#pragma unroll
  for (int kk = 0; kk < NK; ++kk) {
    uint32_t a[4];
    a[0] = pack_bf16(p[2 * kk][0], p[2 * kk][1]);
    a[1] = pack_bf16(p[2 * kk][2], p[2 * kk][3]);
    a[2] = pack_bf16(p[2 * kk + 1][0], p[2 * kk + 1][1]);
    a[3] = pack_bf16(p[2 * kk + 1][2], p[2 * kk + 1][3]);
    const __nv_bfloat16* br = sB + (kk * 16 + 2 * t) * LDS + g;
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      const __nv_bfloat16* b = br + n * 8;
      mma_16816(acc[n], a, pack_pair(b, b + LDS),
                pack_pair(b + 8 * LDS, b + 9 * LDS));
    }
  }
}

// Raise a kernel's dynamic shared-memory limit to `smem` bytes. The limit
// is a per-device attribute of the function that outlives the launch, so
// it is set on the first launch on each device only (`ready` holds one bit
// a device).
template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel* kernel, int smem,
                                   std::atomic<unsigned>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready.fetch_or(1u << dev);
  }
  return cudaSuccess;
}

}  // namespace flash
