// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate:
// K1.
//
// Replaces the TPU kernel more4d_tpu/kernels/flash_attention.py:48
// (_flash_fwd_kernel, host side _flash_forward :125). Same function and
// rounding points: online-softmax attention with a per-batch kv-length
// mask; q' = bf16(q * bf16(sm_scale * log2 e)), the softmax scale folded
// into q in q's dtype, formed once per q tile; keys at or past kv_lens[b]
// masked to -1e30; exp2 in the softmax; P rounded to bf16 against the
// running max before P v; O = acc / max(l, 1e-30) in bf16 and the base-2
// logsumexp m + log2(max(l, 1e-30)) in fp32 per query row (stored
// [B*H, Lq], read by the backward kernels in flash_attention_bwd.cu). Only
// the key-tile boundaries of the running max depend on the tile shape.
//
// What bounds it on the H100: at the main path's self-attention (B=2,
// H=12, L=9568, D=128) the work is 4*B*H*L^2*D = 1.12e12 FLOP against ~47
// MB of q/k/v/o, so tensor-core operations (>= 1.14 ms at 989 TFLOP/s).
// What keeps a kernel from that is feeding the products and hiding the
// softmax: every q tile streams its head's whole k and v through L2 and
// shared memory (4.9 MB at self), the S product reads q' and k from shared
// memory, and each key tile's exp2 work is as long as its products. The
// design (FlashAttention-3's shape):
//   - BQ = 128 q rows a tile, two consumer warpgroups of 64 rows each
//     (wgmma m64) sharing every k/v tile, which halves the L2 stream of
//     64-row tiles; BK = 128 keys a tile, so that the S product is
//     m64n128 and reads less of shared memory per FLOP;
//   - a producer warpgroup, one thread of which copies q, k and v by TMA
//     into 128-byte-swizzled tiles: a k ring and a v ring of NS stages
//     each, with mbarriers for "full" (bytes landed) and "empty" (every
//     consumer warp done); the consumers never wait for each other on a
//     load, and the first k/v copies are in flight before q' is scaled;
//     the producer hands its registers to the consumers (setmaxnreg: 24
//     and 240 a thread, where ptxas's launch count is 168);
//   - S = q' k^T by wgmma with both tiles in shared memory (K-major), and
//     O += P v by wgmma with P from registers (the accumulator layout of S
//     is the register layout of A) and v read MN-major (flash_sm90.cuh);
//   - in each warpgroup, key tile j's S is issued together with tile
//     j - 1's P v, and S_j's mask and exp2 run while P v is still on the
//     tensor cores; the two warpgroups take turns issuing their products
//     (named barriers), so one's exp2 runs against the other's products;
//   - persistent CTAs, one a SM, walk the (q tile, head) items in turn:
//     the next item's q copy starts once the current item's last S is
//     done and overlaps its last P v and its epilogue;
//   - O leaves through shared memory in 16-byte stores of whole rows.
// Measured on the H100 (PERF.md): 662 TFLOP/s at the self-attention, 1.70
// ms against SDPA's 2.76. ~193 KB of shared memory at D = 128, no spills.
// Tiles past kv_len are skipped: they would add exp2(-1e30 - m) = 0 to
// every sum, so skipping them changes no number. q, k and v are read
// through TMA maps of their strides and O is written through its strides,
// so BLHD tensors need no transpose.

#include <cuda.h>
#include <cudaTypedefs.h>

#include "flash_common.cuh"
#include "flash_sm90.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int NWG = 2;              // consumer warpgroups, 64 q rows each
constexpr int BQ = 64 * NWG;        // q rows a tile
constexpr int BK = 128;             // keys a k/v tile
constexpr int NS = 2;               // stages of the k ring and the v ring
constexpr int NT = 128 * NWG + 128;  // the consumers, then the producer
                                     // warpgroup (one warp of it copies)
// Registers a thread: the producer gives its own away to the consumers
// (the CTA's 65,536 split as 128 x 24 + 256 x 240).
constexpr int PRODUCER_REGS = 24;
constexpr int CONSUMER_REGS = NWG == 2 ? 240 : 256;
constexpr int TURN = 3;             // named barrier TURN + w: warpgroup
                                    // w's turn to issue products

// Warpgroup wg waits for its turn to issue products, then hands the turn
// to the other one.
__device__ __forceinline__ void my_turn(int wg) {
  if constexpr (NWG > 1) bar_sync(TURN + wg, 256);
}
__device__ __forceinline__ void your_turn(int wg) {
  if constexpr (NWG > 1) bar_arrive(TURN + 1 - wg, 256);
}

// One arrival a warp on an "empty" barrier (its count is the consumer
// warps): the wgmma that read the stage has completed for the whole
// warpgroup once any of its threads has waited for it.
__device__ __forceinline__ void release(uint32_t bar, int lane) {
  if (lane == 0) mbar_arrive(bar);
}

// q' = bf16(q * scale) in place over a warpgroup's 64 x D tile (its 128
// threads, 16-byte chunks in storage order): the JAX host folds the factor
// into q in q's dtype the same way.
template <int D>
__device__ __forceinline__ void scale_q(uint32_t tile, int wt, float scale) {
#pragma unroll
  for (int i = wt; i < 64 * D / 8; i += 128) {
    uint4 val = ld_shared_v4(tile + 16 * i);
    bf16* e = reinterpret_cast<bf16*>(&val);
#pragma unroll
    for (int j = 0; j < 8; ++j)
      e[j] = __float2bfloat16(__bfloat162float(e[j]) * scale);
    st_shared_v4(tile + 16 * i, val);
  }
}

// S = q' k^T over one key tile, issued as one wgmma group: q' the
// warpgroup's swizzled 64 x D tile, k a BK x D tile, both K-major. (A
// narrower product for a ragged last tile would save work, but a wgmma
// under a branch makes ptxas serialise every product of the kernel.)
template <int D>
__device__ __forceinline__ void issue_s(float (&s)[BK / 2], uint32_t q_tile,
                                        uint32_t k_tile) {
#pragma unroll
  for (int kk = 0; kk < D / 16; ++kk)
    wgmma_ss<BK>(s, desc_k<64>(q_tile, kk), desc_k<BK>(k_tile, kk), kk);
  wgmma_commit();
}

// acc += bf16(P) v over one key tile, issued as one wgmma group: P from
// registers (pack_a), v a BK x D tile read MN-major.
template <int D>
__device__ __forceinline__ void issue_pv(float (&acc)[D / 2],
                                         const uint32_t (&pa)[BK / 16][4],
                                         uint32_t v_tile) {
#pragma unroll
  for (int kk = 0; kk < BK / 16; ++kk)
    wgmma_rs<D>(acc, pa[kk], desc_mn<BK>(v_tile, kk));
  wgmma_commit();
}

// The online softmax of the key tile at k0, in place: s (scores, element
// 4j + c in row r0 + 8 (c / 2), column k0 + 8j + 2t + c % 2) becomes P =
// exp2(s - m) in fp32 against the new running max m of each of the
// thread's two rows; keys at or past kv_len give -1e30 first. l_row gains
// this thread's part of the row sums; alpha = exp2(m_old - m) rescales
// what was summed before.
__device__ __forceinline__ void online_softmax(float (&s)[BK / 2],
                                               float (&m_row)[2],
                                               float (&l_row)[2],
                                               float (&alpha)[2], int k0,
                                               int kv_len, int t) {
  if (k0 + BK > kv_len) {
#pragma unroll
    for (int j = 0; j < BK / 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if (k0 + j * 8 + 2 * t + (c & 1) >= kv_len) s[4 * j + c] = NEG_INF;
  }
  float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    mx[0] = fmaxf(mx[0], fmaxf(s[4 * j], s[4 * j + 1]));
    mx[1] = fmaxf(mx[1], fmaxf(s[4 * j + 2], s[4 * j + 3]));
  }
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 1));
    mx[i] = fmaxf(mx[i], __shfl_xor_sync(0xffffffffu, mx[i], 2));
    const float m_new = fmaxf(m_row[i], mx[i]);
    alpha[i] = exp2f(m_row[i] - m_new);
    m_row[i] = m_new;
  }
  float psum[2] = {0.f, 0.f};
#pragma unroll
  for (int j = 0; j < BK / 8; ++j) {
    s[4 * j] = exp2f(s[4 * j] - m_row[0]);
    s[4 * j + 1] = exp2f(s[4 * j + 1] - m_row[0]);
    s[4 * j + 2] = exp2f(s[4 * j + 2] - m_row[1]);
    s[4 * j + 3] = exp2f(s[4 * j + 3] - m_row[1]);
    psum[0] += s[4 * j] + s[4 * j + 1];
    psum[1] += s[4 * j + 2] + s[4 * j + 3];
  }
  l_row[0] = alpha[0] * l_row[0] + psum[0];
  l_row[1] = alpha[1] * l_row[1] + psum[1];
}

__device__ __forceinline__ int key_tiles(const int* kv_lens, int b, int Lk,
                                         int& kv_len) {
  kv_len = Lk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Lk);
  return (kv_len + BK - 1) / BK;
}

template <int D>
__global__ void __launch_bounds__(NT, 1)
flash_fwd_kernel(const __grid_constant__ CUtensorMap tm_q,
                 const __grid_constant__ CUtensorMap tm_k,
                 const __grid_constant__ CUtensorMap tm_v,
                 bf16* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_lens, int H, int Lq, int Lk,
                 int n_qt, int n_items, long long o_sb, long long o_sl,
                 long long o_sh, float q_scale) {
  constexpr int QTILE = 64 * D * 2;  // bytes of a warpgroup's q' (O) tile
  constexpr int KTILE = BK * D * 2;  // bytes of a k or v tile
  extern __shared__ __align__(1024) unsigned char smem_raw[];
  const uint32_t sQ = aligned_smem(smem_raw);  // q' [NWG][64, D]
  const uint32_t sO = sQ + NWG * QTILE;        // O [NWG][64, D]
  const uint32_t sK = sO + NWG * QTILE;        // k ring [NS][BK, D]
  const uint32_t sV = sK + NS * KTILE;         // v ring [NS][BK, D]
  const uint32_t q_full = sV + NS * KTILE;     // mbarriers, 8 bytes each
  const uint32_t q_empty = q_full + 8;
  const uint32_t k_full = q_empty + 8;         // [NS]
  const uint32_t k_empty = k_full + 8 * NS;    // [NS]
  const uint32_t v_full = k_empty + 8 * NS;    // [NS]
  const uint32_t v_empty = v_full + 8 * NS;    // [NS]
  constexpr int CONSUMER_WARPS = 4 * NWG;

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  if (tid == 0) {
    mbar_init(q_full, 1);
    mbar_init(q_empty, CONSUMER_WARPS);
#pragma unroll
    for (int s = 0; s < NS; ++s) {
      mbar_init(k_full + 8 * s, 1);
      mbar_init(k_empty + 8 * s, CONSUMER_WARPS);
      mbar_init(v_full + 8 * s, 1);
      mbar_init(v_empty + 8 * s, CONSUMER_WARPS);
    }
    fence_mbar_init();
  }
  __syncthreads();

  if (warp >= CONSUMER_WARPS) {
    // the producer: one thread issues every copy of this CTA's items, in
    // the order the consumers use them; a stage is refilled once every
    // consumer warp has released it
    setmaxnreg_dec<PRODUCER_REGS>();
    if (warp != CONSUMER_WARPS || lane != 0) return;
    int kp = 0, vp = 0;  // k and v tiles copied so far
    for (int it = blockIdx.x, n_it = 0; it < n_items;
         it += gridDim.x, ++n_it) {
      const int bh = it / n_qt, q0 = (it % n_qt) * BQ;
      const int b = bh / H, h = bh % H;
      int kv_len;
      const int n_tiles = key_tiles(kv_lens, b, Lk, kv_len);
      mbar_wait(q_empty, (n_it & 1) ^ 1);
      mbar_expect_tx(q_full, NWG * QTILE);
#pragma unroll
      for (int w = 0; w < NWG; ++w)
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sQ + w * QTILE + c * (64 * 128), &tm_q, q_full,
                      c * 64, h, q0 + w * 64, b);
      for (int j = 0; j < n_tiles; ++j) {
        const uint32_t ks = 8 * (kp % NS), vs = 8 * (vp % NS);
        mbar_wait(k_empty + ks, ((kp / NS) & 1) ^ 1);
        mbar_expect_tx(k_full + ks, KTILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sK + (kp % NS) * KTILE + c * (BK * 128), &tm_k,
                      k_full + ks, c * 64, h, j * BK, b);
        ++kp;
        mbar_wait(v_empty + vs, ((vp / NS) & 1) ^ 1);
        mbar_expect_tx(v_full + vs, KTILE);
#pragma unroll
        for (int c = 0; c < D / 64; ++c)
          tma_load_4d(sV + (vp % NS) * KTILE + c * (BK * 128), &tm_v,
                      v_full + vs, c * 64, h, j * BK, b);
        ++vp;
      }
    }
    return;
  }

  // the consumers: warpgroup wg owns q rows [64 wg, 64 wg + 64) of each
  // item; this thread's rows of them are r0 and r0 + 8
  setmaxnreg_inc<CONSUMER_REGS>();
  const int wg = warp >> 2;
  const int r0 = (warp & 3) * 16 + (lane >> 2), t = lane & 3;
  const uint32_t myQ = sQ + wg * QTILE, myO = sO + wg * QTILE;
  int kc = 0, vc = 0;  // k and v tiles consumed so far
  if (wg == 1) your_turn(1);  // warpgroup 0 issues first

  // wgmma accumulators: element 4j + c is row r0 + 8 (c / 2), column
  // 8j + 2t + c % 2
  float acc[D / 2], s[BK / 2], alpha[2];
  uint32_t pa[BK / 16][4];
#pragma unroll
  for (int i = 0; i < BK / 2; ++i) s[i] = 0.f;
  for (int it = blockIdx.x, n_it = 0; it < n_items;
       it += gridDim.x, ++n_it) {
    const int bh = it / n_qt, q0 = (it % n_qt) * BQ;
    const int b = bh / H, h = bh % H;
    int kv_len;
    const int n_tiles = key_tiles(kv_lens, b, Lk, kv_len);

    mbar_wait(q_full, n_it & 1);
    scale_q<D>(myQ, tid & 127, q_scale);
    fence_proxy_async();
    bar_sync(1 + wg, 128);
    if (n_tiles == 0) release(q_empty, lane);
#pragma unroll
    for (int i = 0; i < D / 2; ++i) acc[i] = 0.f;
    float m_row[2] = {NEG_INF, NEG_INF};
    float l_row[2] = {0.f, 0.f};  // this thread's partial row sums

    // Round r issues S_r = q' k_r^T and P_{r-1} v_{r-1} in this
    // warpgroup's turn (round 0 S_0 alone, round n_tiles the last P v
    // alone), then runs S_r's softmax while P_{r-1} v_{r-1} may still run;
    // each stage is released as soon as its product is done.
    if (n_tiles > 0) {
      {
        const int k0 = 0;
        mbar_wait(k_full + 8 * (kc % NS), (kc / NS) & 1);
        my_turn(wg);
        wgmma_fence();
        issue_s<D>(s, myQ, sK + (kc % NS) * KTILE);
        your_turn(wg);
        wgmma_wait<0>();
        fence_regs(s);
        release(k_empty + 8 * (kc % NS), lane);
        ++kc;
        if (n_tiles == 1) release(q_empty, lane);
        online_softmax(s, m_row, l_row, alpha, k0, kv_len, t);
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], s, kk);
      }
      for (int r = 1; r < n_tiles; ++r) {
        const int k0 = r * BK;
        mbar_wait(k_full + 8 * (kc % NS), (kc / NS) & 1);
        mbar_wait(v_full + 8 * (vc % NS), (vc / NS) & 1);
        my_turn(wg);
        wgmma_fence();
        issue_s<D>(s, myQ, sK + (kc % NS) * KTILE);
        issue_pv<D>(acc, pa, sV + (vc % NS) * KTILE);
        your_turn(wg);
        wgmma_wait<1>();
        fence_regs(s);
        release(k_empty + 8 * (kc % NS), lane);
        ++kc;
        if (r == n_tiles - 1) release(q_empty, lane);
        online_softmax(s, m_row, l_row, alpha, k0, kv_len, t);
        wgmma_wait<0>();
        fence_regs(acc);
        release(v_empty + 8 * (vc % NS), lane);
        ++vc;
#pragma unroll
        for (int n = 0; n < D / 8; ++n) {
          acc[4 * n] *= alpha[0];
          acc[4 * n + 1] *= alpha[0];
          acc[4 * n + 2] *= alpha[1];
          acc[4 * n + 3] *= alpha[1];
        }
#pragma unroll
        for (int kk = 0; kk < BK / 16; ++kk) pack_a(pa[kk], s, kk);
      }
      mbar_wait(v_full + 8 * (vc % NS), (vc / NS) & 1);
      my_turn(wg);
      wgmma_fence();
      issue_pv<D>(acc, pa, sV + (vc % NS) * KTILE);
      your_turn(wg);
      wgmma_wait<0>();
      fence_regs(acc);
      release(v_empty + 8 * (vc % NS), lane);
      ++vc;
    }

#pragma unroll
    for (int i = 0; i < 2; ++i) {
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
      l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
    }
    // O through shared memory, then whole rows in 16-byte stores; the
    // barrier first keeps the previous item's reads of myO behind
    const int row0 = q0 + wg * 64;
    bar_sync(1 + wg, 128);
#pragma unroll
    for (int i = 0; i < 2; ++i) {
      const int r = r0 + 8 * i;
      const float l = fmaxf(l_row[i], 1e-30f);
#pragma unroll
      for (int n = 0; n < D / 8; ++n)
        st_shared_u32(myO + swz<64>(r, n) + 4 * t,
                      pack_bf16(acc[4 * n + 2 * i] / l,
                                acc[4 * n + 2 * i + 1] / l));
      if (t == 0 && row0 + r < Lq)
        lse[(long long)bh * Lq + row0 + r] = m_row[i] + log2f(l);
    }
    bar_sync(1 + wg, 128);
    bf16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
    for (int i = tid & 127; i < 64 * (D / 8); i += 128) {
      const int r = i / (D / 8), c = i % (D / 8);
      if (row0 + r < Lq)
        *reinterpret_cast<uint4*>(ob + (long long)(row0 + r) * o_sl + c * 8) =
            ld_shared_v4(myO + swz<64>(r, c));
    }
  }
  if (wg == 0) my_turn(0);  // warpgroup 1's arrival after its last round
}

// A [B, L, H, D] bf16 tensor with element strides (sb, sl, sh) as a TMA
// map of 128-byte-swizzled boxes of `rows` rows x 64 columns, its
// dimensions innermost first (D, H, L, B): the strides then rise for BLHD
// tensors, fused projections' views included.
bool tensor_map(CUtensorMap* map, const void* ptr, int B, int L, int H,
                int D, long long sb, long long sl, long long sh, int rows) {
  static PFN_cuTensorMapEncodeTiled_v12000 encode = nullptr;
  if (encode == nullptr) {
    void* fn = nullptr;
    cudaDriverEntryPointQueryResult found;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault, &found) != cudaSuccess ||
        found != cudaDriverEntryPointSuccess)
      return false;
    encode = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(fn);
  }
  // a dimension of length 1 may carry any stride (PyTorch leaves such
  // strides as they fell); TMA wants them nonzero
  if (H == 1) sh = D;
  if (L == 1) sl = sh * H;
  if (B == 1) sb = sl * L;
  cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)H, (cuuint64_t)L,
                        (cuuint64_t)B};
  cuuint64_t strides[3] = {(cuuint64_t)sh * 2, (cuuint64_t)sl * 2,
                           (cuuint64_t)sb * 2};
  cuuint32_t box[4] = {64, 1, (cuuint32_t)rows, 1};
  cuuint32_t elem[4] = {1, 1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, elem,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_128B,
                CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* kv_lens, int B, int H, int Lq, int Lk,
           const long long* st, float q_scale, cudaStream_t stream) {
  CUtensorMap tq, tk, tv;
  if (!tensor_map(&tq, q, B, Lq, H, D, st[0], st[1], st[2], 64) ||
      !tensor_map(&tk, k, B, Lk, H, D, st[3], st[4], st[5], BK) ||
      !tensor_map(&tv, v, B, Lk, H, D, st[6], st[7], st[8], BK))
    return static_cast<int>(cudaErrorInvalidValue);
  const int n_qt = (Lq + BQ - 1) / BQ, n_items = n_qt * B * H;
  if (n_items == 0) return static_cast<int>(cudaSuccess);
  const int smem = (2 * NWG * 64 + 2 * NS * BK) * D * 2 + 1024 + 128;
  static std::atomic<unsigned> ready{0u};
  cudaError_t err = smem_limit_once(flash_fwd_kernel<D>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  int dev = 0, sms = 0;
  err = cudaGetDevice(&dev);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  const int grid = min(n_items, sms);
  flash_fwd_kernel<D><<<grid, NT, smem, stream>>>(
      tq, tk, tv, static_cast<bf16*>(o), static_cast<float*>(lse),
      static_cast<const int*>(kv_lens), H, Lq, Lk, n_qt, n_items, st[9],
      st[10], st[11], q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K1's tiles: 0 -> the q rows of a tile (BQ), 1 -> the keys of a tile of
// its loop (BK), the granularity at which it skips keys past kv_len.
extern "C" int flash_fwd_tile(int which) { return which == 0 ? BQ : BK; }

// strides: 12 element strides, (batch, row, head) for q, k, v, o in turn;
// q, k and v need 16-byte aligned addresses and strides (TMA). kv_lens may
// be null (every key valid). Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for an unsupported head dim or strides TMA
// cannot map.
extern "C" int flash_fwd_bf16(const void* q, const void* k, const void* v,
                              void* o, void* lse, const void* kv_lens, int B,
                              int H, int Lq, int Lk, int D,
                              const long long* strides, float q_scale,
                              void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch<64>(q, k, v, o, lse, kv_lens, B, H, Lq, Lk, strides,
                      q_scale, s);
  if (D == 128)
    return launch<128>(q, k, v, o, lse, kv_lens, B, H, Lq, Lk, strides,
                       q_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
