// Flash-attention backward for Hopper (sm_90a): K2 (dq) and K3 (dk, dv),
// bf16 in, fp32 accumulate.
//
// Replaces the TPU kernels more4d_tpu/kernels/flash_attention.py:216
// (_flash_bwd_dq_kernel) and :250 (_flash_bwd_dkv_kernel), host side
// _flash_backward :291. Same function and the same rounding points: with
// q' = bf16(q * bf16(sm_scale * log2 e)), formed once by the caller as the
// JAX host forms it (:319),
//
//   p  = exp2(q' k^T - lse)        fp32; lse is the forward's base-2 lse
//                                  ([B*H, Lq]); keys at or past kv_lens[b]
//                                  and rows past Lq give p = 0
//   dp = dO v^T                    fp32
//   ds = p * (dp - delta) * sm_scale, delta = rowsum(dO * O) (fp32, made by
//                                  the caller)
//   dq = bf16(ds) k                                   (K2)
//   dv = bf16(p)^T dO,  dk = bf16(ds)^T q' / (log2 e * sm_scale), the
//                       divide in fp32 before the final rounding   (K3)
//
// and every output is rounded to bf16 once. P is recomputed from the saved
// lse (no running max), so the tile shapes change no rounding.
//
// What bounds them: at the training path's self-attention (B=1, H=12,
// L=9568, D=128) K2 runs three products (S, dP, dQ), 6*B*H*L^2*D = 8.4e11
// FLOP against ~9.4 MB, K3 four (S, dP, dV, dK), 1.1e12 FLOP: bound by
// tensor-core operations, 0.853 ms and 1.137 ms at 989 TFLOP/s.
//
// The design (FlashAttention-2's two-kernel split, deterministic: no
// atomics anywhere):
//   - one warpgroup (128 threads) a CTA, owning 64 rows: K2 64 q rows and
//     their dq (64 x D fp32 in registers), K3 64 keys and their dk and dv
//     (2 x 64 x D fp32); the CTA walks 64-row tiles of the other side (K2
//     key tiles up to kv_len, K3 q tiles);
//   - products by wgmma: S (K3: S^T = k q'^T) and dP (dP^T = v dO^T) as
//     m64n64k16 with both operands in shared memory, K-major; dQ += dS k,
//     dV += P^T dO and dK += dS^T q' as m64nDk16 with P and dS in registers
//     (the accumulator layout of S and dP is the register layout of A,
//     rounded to bf16 there) and k, dO, q' read MN-major from the same
//     tiles (flash_sm90.cuh);
//   - loads by cp.async into a two-stage ring of 128-byte-swizzled tiles:
//     K2's ring holds the k and v tiles (q' and dO stay), K3's the q', dO,
//     lse and delta tiles (k and v stay); the copy of tile i + 1 runs while
//     the products of tile i do;
//   - ptxas -v at D = 128: K3 249 registers a thread, K2 176, no spills;
//     ~97 KB of shared memory each, so 2 CTAs (8 warps) a SM, and one
//     CTA's exp2 and masking overlap the other's products;
//   - K3's q-split: where ceil(Lk / 64) * B * H CTAs do not fill two a SM
//     (the text and CLIP cross-attentions), S CTAs share each key tile, each
//     over a contiguous range of q tiles (the host picks S); they write fp32
//     partials to a [2, S, B*H, Lk, D] workspace that a second kernel sums
//     in split order, scales and rounds once. With S = 1 K3 writes its
//     outputs itself.
// K2 skips key tiles past kv_len (they hold p = 0 exactly); a K3 CTA whose
// keys all lie past kv_len writes zeros. Inputs are read through strides,
// so BLHD tensors need no transpose; outputs are written through strides.

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int BM = 64;   // rows a CTA owns: K2's q rows, K3's keys
constexpr int BN = 64;   // rows a tile of its loop: K2's keys, K3's q rows
constexpr int NT = 128;  // one warpgroup a CTA

// Element strides (batch, row, head) of every tensor a kernel reads or
// writes, passed by value as one kernel argument.
struct Strides {
  long long v[18];
};

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ kv_lens, int H, int Lq, int Lk,
                    const Strides st, float sm_scale) {
  constexpr int TILE = BN * D * 2;  // bytes of a 64-row tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = aligned_smem(smem_raw);  // q' [BM, D]
  const uint32_t sDO = sQ + TILE;              // dO [BM, D]
  const uint32_t sK = sDO + TILE;              // k [2][BN, D]: the k/v ring
  const uint32_t sV = sK + 2 * TILE;           // v [2][BN, D]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // strides (batch, row, head) of q', k, v, dO, dq in turn
  const bf16* kb = k + b * st.v[3] + h * st.v[5];
  const bf16* vb = v + b * st.v[6] + h * st.v[8];
  int kv_len = Lk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Lk);
  const int n_tiles = (kv_len + BN - 1) / BN;

  load_tile_async<D, BM, NT>(sQ, q + b * st.v[0] + h * st.v[2], st.v[1], q0,
                             Lq, tid);
  load_tile_async<D, BM, NT>(sDO, dout + b * st.v[9] + h * st.v[11],
                             st.v[10], q0, Lq, tid);
  if (n_tiles > 0) {
    load_tile_async<D, BN, NT>(sK, kb, st.v[4], 0, Lk, tid);
    load_tile_async<D, BN, NT>(sV, vb, st.v[7], 0, Lk, tid);
  }
  cp_async_commit();

  // this thread's accumulator rows: r0 and r0 + 8 of the CTA's 64
  const int r0 = warp * 16 + g;
  bool row_ok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    row_ok[i] = row < Lq;
    lse_r[i] = row_ok[i] ? lse[(long long)bh * Lq + row] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(long long)bh * Lq + row] : 0.f;
  }

  // wgmma accumulators: element 4j + c is row r0 + 8 (c / 2), column
  // 8j + 2t + c % 2
  float acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BN;
    // tile kt has landed; every thread is done with tile kt - 1, whose
    // stage the copy of tile kt + 1 now fills while tile kt is multiplied
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (kt + 1 < n_tiles) {
      const int nxt = (kt + 1) & 1;
      load_tile_async<D, BN, NT>(sK + nxt * TILE, kb, st.v[4], k0 + BN, Lk,
                                 tid);
      load_tile_async<D, BN, NT>(sV + nxt * TILE, vb, st.v[7], k0 + BN, Lk,
                                 tid);
      cp_async_commit();
    }
    const uint32_t cK = sK + (kt & 1) * TILE, cV = sV + (kt & 1) * TILE;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S = q' k^T
      wgmma_ss_n64(s, desc_k<BM>(sQ, kk), desc_k<BN>(cK, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP = dO v^T
      wgmma_ss_n64(dp, desc_k<BM>(sDO, kk), desc_k<BN>(cV, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1, e = 4 * j + c;
        const bool ok = row_ok[i] && k0 + j * 8 + 2 * t + (c & 1) < kv_len;
        const float p = ok ? exp2f(s[e] - lse_r[i]) : 0.f;
        s[e] = p * (dp[e] - delta_r[i]) * sm_scale;  // ds
      }
    uint32_t a[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) pack_a(a[kk], s, kk);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // dq += bf16(ds) k
      wgmma_rs<D>(acc, a[kk], desc_mn<BN>(cK, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(acc);
  }
  cp_async_wait<0>();

  bf16* dqb = dq + b * st.v[12] + h * st.v[14];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    bf16* row = dqb + (long long)(q0 + r0 + 8 * i) * st.v[13];
#pragma unroll
    for (int n = 0; n < D / 8; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
          pack_bf16(acc[4 * n + 2 * i], acc[4 * n + 2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(NT, 2)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ kv_lens,
                     float* __restrict__ ws, int H, int Lq, int Lk,
                     const Strides st, float sm_scale, float dk_scale) {
  constexpr int TILE = BN * D * 2;
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sK = aligned_smem(smem_raw);  // k [BM, D]
  const uint32_t sV = sK + TILE;               // v [BM, D]
  const uint32_t sQ = sV + TILE;  // q' [2][BN, D]: the q', dO, lse, delta ring
  const uint32_t sDO = sQ + 2 * TILE;  // dO [2][BN, D]
  float* sL = reinterpret_cast<float*>(
      smem_raw + (sDO + 2 * TILE - smem_u32(smem_raw)));  // lse [2][BN]
  float* sDl = sL + 2 * BN;                               // delta [2][BN]

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BM;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // strides (batch, row, head) of q', k, v, dO, dk, dv in turn
  const bf16* qb = q + b * st.v[0] + h * st.v[2];
  const bf16* dob = dout + b * st.v[9] + h * st.v[11];
  const float* lseb = lse + (long long)bh * Lq;
  const float* deltab = delta + (long long)bh * Lq;
  int kv_len = Lk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Lk);

  // this split's q tiles: ceil(nq / splits) each, the last one short; a
  // CTA whose keys all lie past kv_len walks none and writes zeros
  const int nq = (Lq + BN - 1) / BN;
  const int per = (nq + gridDim.z - 1) / gridDim.z;
  const int qt0 = blockIdx.z * per;
  const int qt1 = k0 < kv_len ? min(nq, qt0 + per) : qt0;

  auto load_q_tile = [&](int qt, int stage) {
    const int q0 = qt * BN;
    load_tile_async<D, BN, NT>(sQ + stage * TILE, qb, st.v[1], q0, Lq, tid);
    load_tile_async<D, BN, NT>(sDO + stage * TILE, dob, st.v[10], q0, Lq,
                               tid);
    load_vec_async<BN>(sL + stage * BN, lseb, q0, Lq, tid, 0);
    load_vec_async<BN>(sDl + stage * BN, deltab, q0, Lq, tid, BN);
  };
  load_tile_async<D, BM, NT>(sK, k + b * st.v[3] + h * st.v[5], st.v[4], k0,
                             Lk, tid);
  load_tile_async<D, BM, NT>(sV, v + b * st.v[6] + h * st.v[8], st.v[7], k0,
                             Lk, tid);
  if (qt0 < qt1) load_q_tile(qt0, 0);
  cp_async_commit();

  // this thread's accumulator rows (keys): k0 + r0 and k0 + r0 + 8
  const int r0 = warp * 16 + g;
  const bool key_ok[2] = {k0 + r0 < kv_len, k0 + r0 + 8 < kv_len};

  // wgmma accumulators: element 4j + c is row r0 + 8 (c / 2), column
  // 8j + 2t + c % 2 (S^T, dP^T: q columns; dk, dv: head-dim columns)
  float dk_acc[D / 2], dv_acc[D / 2], s[32], dp[32];
#pragma unroll
  for (int i = 0; i < D / 2; ++i) dk_acc[i] = dv_acc[i] = 0.f;
#pragma unroll
  for (int i = 0; i < 32; ++i) s[i] = dp[i] = 0.f;

  for (int qt = qt0; qt < qt1; ++qt) {
    const int q0 = qt * BN;
    // tile qt has landed; every thread is done with tile qt - 1, whose
    // stage the copy of tile qt + 1 now fills while tile qt is multiplied
    cp_async_wait<0>();
    fence_proxy_async();
    __syncthreads();
    if (qt + 1 < qt1) {
      load_q_tile(qt + 1, (qt + 1 - qt0) & 1);
      cp_async_commit();
    }
    const int stage = (qt - qt0) & 1;
    const uint32_t cQ = sQ + stage * TILE, cDO = sDO + stage * TILE;
    const float* cL = sL + stage * BN;
    const float* cDl = sDl + stage * BN;

    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // S^T = k q'^T
      wgmma_ss_n64(s, desc_k<BM>(sK, kk), desc_k<BN>(cQ, kk), kk);
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk)  // dP^T = v dO^T
      wgmma_ss_n64(dp, desc_k<BM>(sV, kk), desc_k<BN>(cDO, kk), kk);
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(s);
    fence_regs(dp);
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * 8 + 2 * t + (c & 1), e = 4 * j + c;
        const bool ok = key_ok[c >> 1] && q0 + col < Lq;
        const float p = ok ? exp2f(s[e] - cL[col]) : 0.f;
        s[e] = p;
        dp[e] = p * (dp[e] - cDl[col]) * sm_scale;  // ds^T
      }
    uint32_t pa[BN / 16][4], da[BN / 16][4];
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk) {
      pack_a(pa[kk], s, kk);
      pack_a(da[kk], dp, kk);
    }
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // dv += bf16(p)^T dO
      wgmma_rs<D>(dv_acc, pa[kk], desc_mn<BN>(cDO, kk));
#pragma unroll
    for (int kk = 0; kk < BN / 16; ++kk)  // dk += bf16(ds)^T q'
      wgmma_rs<D>(dk_acc, da[kk], desc_mn<BN>(cQ, kk));
    wgmma_commit();
    wgmma_wait<0>();
    fence_regs(dv_acc);
    fence_regs(dk_acc);
  }
  cp_async_wait<0>();

  if (ws != nullptr) {
    // fp32 partials of this split: ws[0 or 1][split][bh][key][:]
    const long long slice = (long long)gridDim.y * Lk * D;
    float* wk = ws + (blockIdx.z * slice + (long long)bh * Lk * D);
    float* wv = wk + gridDim.z * slice;
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int key = k0 + r0 + 8 * i;
      if (key >= Lk) continue;
#pragma unroll
      for (int n = 0; n < D / 8; ++n) {
        const long long o = (long long)key * D + n * 8 + 2 * t;
        *reinterpret_cast<float2*>(wk + o) =
            make_float2(dk_acc[4 * n + 2 * i], dk_acc[4 * n + 2 * i + 1]);
        *reinterpret_cast<float2*>(wv + o) =
            make_float2(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
      }
    }
    return;
  }
  bf16* dkb = dk + b * st.v[12] + h * st.v[14];
  bf16* dvb = dv + b * st.v[15] + h * st.v[17];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int key = k0 + r0 + 8 * i;
    if (key >= Lk) continue;
    bf16* krow = dkb + (long long)key * st.v[13];
    bf16* vrow = dvb + (long long)key * st.v[16];
#pragma unroll
    for (int n = 0; n < D / 8; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + 2 * t) =
          pack_bf16(dk_acc[4 * n + 2 * i] * dk_scale,
                    dk_acc[4 * n + 2 * i + 1] * dk_scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + 2 * t) =
          pack_bf16(dv_acc[4 * n + 2 * i], dv_acc[4 * n + 2 * i + 1]);
    }
  }
}

// The q-split's second pass: dk and dv as the sum of the splits' fp32
// partials in split order (no atomics, so every run gives the same bits),
// dk times dk_scale, each rounded to bf16 once and written through the
// output strides. One thread a group of 4 elements of dk or dv.
__global__ void dkv_reduce_kernel(const float* __restrict__ ws, int splits,
                                  int BH, int H, int Lk, int D,
                                  bf16* __restrict__ dk,
                                  bf16* __restrict__ dv, const Strides st,
                                  float dk_scale) {
  const long long slice = (long long)BH * Lk * D;
  const long long i4 = ((long long)blockIdx.x * blockDim.x + threadIdx.x) * 4;
  if (i4 >= 2 * slice) return;
  const int which = i4 >= slice;  // 0: dk, 1: dv
  const long long e = i4 - which * slice;
  const float* src = ws + which * splits * slice + e;
  float4 acc = *reinterpret_cast<const float4*>(src);
  for (int s = 1; s < splits; ++s) {
    const float4 x = *reinterpret_cast<const float4*>(src + s * slice);
    acc.x += x.x;
    acc.y += x.y;
    acc.z += x.z;
    acc.w += x.w;
  }
  const float scale = which ? 1.f : dk_scale;
  const int d = e % D;
  const int key = (e / D) % Lk;
  const int bh = e / ((long long)D * Lk);
  const int b = bh / H, h = bh % H;
  const long long* sv = st.v + (which ? 15 : 12);
  bf16* out = (which ? dv : dk) + b * sv[0] + key * sv[1] + h * sv[2] + d;
  uint2 packed;
  packed.x = pack_bf16(acc.x * scale, acc.y * scale);
  packed.y = pack_bf16(acc.z * scale, acc.w * scale);
  *reinterpret_cast<uint2*>(out) = packed;
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* kv_lens, int B, int H, int Lq, int Lk,
              const long long* strides, float sm_scale, cudaStream_t stream) {
  Strides st{};
  for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
  const int smem = 6 * BN * D * 2 + 1024;
  static std::atomic<unsigned> ready{0u};
  const cudaError_t err = smem_limit_once(flash_bwd_dq_kernel<D>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BM - 1) / BM, B * H);
  flash_bwd_dq_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<const int*>(kv_lens), H, Lq, Lk, st,
      sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* kv_lens, void* ws, int B, int H, int Lq, int Lk,
               int splits, const long long* strides, float sm_scale,
               float dk_scale, cudaStream_t stream) {
  Strides st{};
  for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
  const int smem = 6 * BN * D * 2 + 4 * BN * 4 + 1024;
  static std::atomic<unsigned> ready{0u};
  const cudaError_t err =
      smem_limit_once(flash_bwd_dkv_kernel<D>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* wsf = splits > 1 ? static_cast<float*>(ws) : nullptr;
  dim3 grid((Lk + BM - 1) / BM, B * H, splits);
  flash_bwd_dkv_kernel<D><<<grid, NT, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const int*>(kv_lens), wsf, H, Lq, Lk, st, sm_scale,
      dk_scale);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess || wsf == nullptr) return static_cast<int>(e);
  const long long groups = 2LL * B * H * Lk * D / 4;
  dkv_reduce_kernel<<<(unsigned)((groups + 255) / 256), 256, 0, stream>>>(
      wsf, splits, B * H, H, Lk, D, static_cast<bf16*>(dk),
      static_cast<bf16*>(dv), st, dk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. q is q' = q * bf16(sm_scale * log2 e), made by the caller.
// strides: 15 element strides, (batch, row, head) for q', k, v, dO and dq
// in turn. lse and delta are [B*H, Lq] fp32. kv_lens may be null (every
// key valid). Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for an unsupported head dim.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* kv_lens, int B, int H, int Lq,
                                 int Lk, int D, const long long* strides,
                                 float sm_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_lens, B, H, Lq, Lk,
                         strides, sm_scale, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_lens, B, H, Lq,
                          Lk, strides, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3's tile rows: 0 -> the keys a CTA owns (BM), 1 -> the q rows of a tile
// of its loop (BN). The host's split choice counts in them.
extern "C" int flash_bwd_dkv_tile(int which) { return which == 0 ? BM : BN; }

// K3. strides: 18 element strides, (batch, row, head) for q', k, v, dO, dk
// and dv in turn. dk_scale = 1 / (log2 e * sm_scale) rounded to fp32.
// splits CTAs share each 64-key tile; above 1, ws is an fp32 workspace of
// [2, splits, B*H, Lk, D] that a second kernel reduces. Otherwise as
// flash_bwd_dq_bf16.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const void* kv_lens, void* ws, int B, int H,
                                  int Lq, int Lk, int D, int splits,
                                  const long long* strides, float sm_scale,
                                  float dk_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (splits < 1 || (splits > 1 && ws == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, ws, B,
                          H, Lq, Lk, splits, strides, sm_scale, dk_scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, ws, B,
                           H, Lq, Lk, splits, strides, sm_scale, dk_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
