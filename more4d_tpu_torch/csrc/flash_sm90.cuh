// Hopper (sm_90a) pieces of the flash-attention kernels (flash_attention.cu
// K1, flash_attention_bwd.cu K2 dq and K3 dk/dv): asynchronous global ->
// shared copies into 128-byte-swizzled tiles (cp.async with commit/wait
// groups in K2/K3; TMA boxes counted on mbarriers, from a producer that
// hands its registers to the consumers, in K1), and warpgroup matrix
// products (wgmma) that read those tiles through shared-memory
// descriptors.
//
// On the H100 only wgmma reaches the tensor cores' full rate, and it reads
// its B operand (and A, unless A comes from registers) from shared memory,
// so what bounds these kernels is keeping swizzled tiles arriving ahead of
// the products: the copies are asynchronous (a ring of stages, filled while
// earlier stages are multiplied), and each product's accumulator layout is
// the register layout of the next product's A (pack_a), so P and dS never
// go back to shared memory.
//
// A tile of ROWS x D bf16 (D = 64 or 128) lies in shared memory as D / 64
// column blocks of ROWS x 64, each ROWS x 128 bytes at a 1024-byte
// aligned address; the 16-byte chunk c of row r sits at chunk c ^ (r % 8)
// of its 128-byte row (the 128-byte swizzle, which keeps the eight rows of
// a chunk column on distinct banks). wgmma reads that one layout both
// ways: K-major, when D is the product's depth (S = q' k^T, dP = dO v^T),
// and MN-major, when the rows are the depth (O += P v, dV += P^T dO,
// dK += dS^T q', dQ += dS k), since bf16 allows both.
#pragma once

#include <cuda_bf16.h>
#include <stdint.h>

#include "flash_common.cuh"

namespace flash {

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

// 16 bytes from global to shared memory, asynchronously. Where !valid the
// destination is zero-filled and nothing is read.
__device__ __forceinline__ void cp_async16(uint32_t dst, const void* src,
                                           bool valid) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 16 : 0)
               : "memory");
}

// 4 bytes, as cp_async16.
__device__ __forceinline__ void cp_async4(uint32_t dst, const void* src,
                                          bool valid) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(dst),
               "l"(src), "r"(valid ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The dynamic shared memory's first 1024-byte aligned address (the
// swizzled tiles need it; each launch asks for 1024 bytes of slack).
__device__ __forceinline__ uint32_t aligned_smem(const unsigned char* raw) {
  return (smem_u32(raw) + 1023u) & ~1023u;
}

// Byte offset of the 16-byte chunk c (elements 8c .. 8c + 7) of row r in
// a swizzled tile of ROWS rows.
template <int ROWS>
__device__ __forceinline__ uint32_t swz(int r, int c) {
  return (c >> 3) * (ROWS * 128) + r * 128 + (((c & 7) ^ (r & 7)) << 4);
}

__device__ __forceinline__ void st_shared_u32(uint32_t addr, uint32_t v) {
  asm volatile("st.shared.u32 [%0], %1;\n" ::"r"(addr), "r"(v) : "memory");
}

__device__ __forceinline__ void st_shared_v4(uint32_t addr, uint4 v) {
  asm volatile("st.shared.v4.u32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "r"(v.x), "r"(v.y), "r"(v.z), "r"(v.w)
               : "memory");
}

__device__ __forceinline__ uint4 ld_shared_v4(uint32_t addr) {
  uint4 v;
  asm volatile("ld.shared.v4.u32 {%0, %1, %2, %3}, [%4];\n"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "r"(addr)
               : "memory");
  return v;
}

// Wait at named barrier `id` (1 to 15; 0 is __syncthreads) until `n`
// threads have arrived.
__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// Hand registers between warpgroups: every warp of a warpgroup lowers
// (dec) or raises (inc) its per-thread register count to N together.
template <int N>
__device__ __forceinline__ void setmaxnreg_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(N));
}
template <int N>
__device__ __forceinline__ void setmaxnreg_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(N));
}

// Arrive at named barrier `id` of `n` threads without waiting.
__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

// mbarriers in shared memory (8 bytes each): a phase completes when
// `count` arrivals have been made and every expected byte of a TMA copy
// has landed; waiters name the phase by its parity.
__device__ __forceinline__ void mbar_init(uint32_t bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count)
               : "memory");
}

// Make mbarrier inits visible to the TMA unit (a __syncthreads follows).
__device__ __forceinline__ void fence_mbar_init() {
  asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
}

__device__ __forceinline__ void mbar_arrive(uint32_t bar) {
  asm volatile(
      "{\n.reg .b64 state;\nmbarrier.arrive.shared::cta.b64 state, [%0];\n}\n"
      ::"r"(bar)
      : "memory");
}

// Arrive and expect `bytes` more of TMA copies in this phase.
__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile(
      "{\n.reg .b64 state;\n"
      "mbarrier.arrive.expect_tx.shared::cta.b64 state, [%0], %1;\n}\n"
      ::"r"(bar), "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
  } while (!done);
}

// TMA: copy the box at coordinates (c0, c1, c2, c3), innermost first, of
// the 4-d tensor map `tmap` into shared memory at dst; the bytes count
// against mbarrier `bar`. Coordinates past the tensor's edge read zeros.
__device__ __forceinline__ void tma_load_4d(uint32_t dst, const void* tmap,
                                            uint32_t bar, int c0, int c1,
                                            int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(tmap)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// Start copying rows [row0, row0 + ROWS) of a [L, D] bf16 slice (row
// stride sl elements) into the swizzled tile at shared address dst; rows
// at or past L are zero-filled. NT threads share the copy, neighbouring
// threads on neighbouring 16-byte chunks of a row.
template <int D, int ROWS, int NT>
__device__ __forceinline__ void load_tile_async(uint32_t dst,
                                                const __nv_bfloat16* src,
                                                long long sl, int row0, int L,
                                                int tid) {
  constexpr int CH = D / 8;
#pragma unroll
  for (int i = tid; i < ROWS * CH; i += NT) {
    const int r = i / CH, c = i % CH;
    const bool valid = row0 + r < L;
    cp_async16(dst + swz<ROWS>(r, c),
               src + (long long)(valid ? row0 + r : 0) * sl + c * 8, valid);
  }
}

// Start copying x[row0, row0 + ROWS) of an fp32 row vector of length L
// into shared memory (zero past L); threads [tid0, tid0 + ROWS) do it.
template <int ROWS>
__device__ __forceinline__ void load_vec_async(float* dst, const float* src,
                                               int row0, int L, int tid,
                                               int tid0) {
  const int r = tid - tid0;
  if (r >= 0 && r < ROWS) {
    const bool valid = row0 + r < L;
    cp_async4(smem_u32(dst + r), src + (valid ? row0 + r : 0), valid);
  }
}

// Make this thread's finished cp.async writes visible to wgmma, which
// reads shared memory through the async proxy.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// A wgmma shared-memory descriptor, 128-byte swizzle: start address, the
// leading and stride byte offsets (each in 16-byte units).
__device__ __forceinline__ uint64_t desc_sw128(uint32_t addr, uint32_t lbo,
                                               uint32_t sbo) {
  return static_cast<uint64_t>((addr & 0x3FFFF) >> 4) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3FFF) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3FFF) << 32) | (1ull << 62);
}

// k16 step kk of a swizzled ROWS x D tile read K-major (depth = D): 32
// bytes further along a 128-byte row, the next column block every four
// steps; eight-row groups 1024 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_k(uint32_t tile, int kk) {
  return desc_sw128(tile + (kk >> 2) * (ROWS * 128) + (kk & 3) * 32, 16,
                    1024);
}

// k16 step kk of a swizzled ROWS x D tile read MN-major (depth = rows,
// N = D): rows 16 kk on, eight-row groups 1024 bytes apart, the 64-column
// blocks ROWS * 128 bytes apart.
template <int ROWS>
__device__ __forceinline__ uint64_t desc_mn(uint32_t tile, int kk) {
  return desc_sw128(tile + kk * 2048, ROWS * 128, 1024);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" ::"n"(N) : "memory");
}

// Pin registers in place around asynchronous wgmma: the compiler may not
// move their reads or writes across this point.
template <int N>
__device__ __forceinline__ void fence_regs(float (&d)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(d[i])::"memory");
}

// The A operand of k16 step kk from a 64 x N fp32 accumulator (its
// columns 16 kk .. 16 kk + 15), each value rounded to bf16: the wgmma
// accumulator layout of a warp's 16 rows is the register layout of A, so
// P and dS go into the next product without leaving registers.
template <int N>
__device__ __forceinline__ void pack_a(uint32_t (&a)[4], const float (&d)[N],
                                       int kk) {
  a[0] = pack_bf16(d[8 * kk], d[8 * kk + 1]);
  a[1] = pack_bf16(d[8 * kk + 2], d[8 * kk + 3]);
  a[2] = pack_bf16(d[8 * kk + 4], d[8 * kk + 5]);
  a[3] = pack_bf16(d[8 * kk + 6], d[8 * kk + 7]);
}

// d (+)= A B^T for one k16 step: m64n64k16, A [64, k] and B [64, k] bf16
// K-major in shared memory (descriptors da, db), d fp32 in registers.
// accumulate = 0 starts the sum (d's old values are ignored).
__device__ __forceinline__ void wgmma_ss_n64(float (&d)[32], uint64_t da,
                                             uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "%32, %33, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "l"(da), "l"(db), "r"(accumulate));
}

// As wgmma_ss_n64 with B [128, k]: m64n128k16.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                              uint64_t db, int accumulate) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "%64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(accumulate));
}

// d (+)= A B^T over N = 64 or 128 columns, as wgmma_ss_n64/n128.
template <int N>
__device__ __forceinline__ void wgmma_ss(float (&d)[N / 2], uint64_t da,
                                         uint64_t db, int accumulate) {
  if constexpr (N == 128)
    wgmma_ss_n128(d, da, db, accumulate);
  else
    wgmma_ss_n64(d, da, db, accumulate);
}

// d += A B for one k16 step: m64n64k16, A [64, 16] bf16 in registers
// (pack_a of an earlier product's accumulator), B [16, 64] bf16 MN-major
// in shared memory (descriptor db).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31}, "
      "{%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B for one k16 step: m64n128k16, A [64, 16] bf16 in registers
// (pack_a of an earlier product's accumulator), B [16, 128] bf16 MN-major
// in shared memory (descriptor db).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                            const uint32_t (&a)[4],
                                            uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, "
      "%8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63}, "
      "{%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// d += A B over N = D (64 or 128) output columns, as wgmma_rs_n64/n128.
template <int D>
__device__ __forceinline__ void wgmma_rs(float (&d)[D / 2],
                                         const uint32_t (&a)[4],
                                         uint64_t db) {
  if constexpr (D == 128)
    wgmma_rs_n128(d, a, db);
  else
    wgmma_rs_n64(d, a, db);
}

}  // namespace flash
