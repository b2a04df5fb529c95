// Flash-attention backward for Hopper (sm_90a): K2 (dq) and K3 (dk, dv),
// bf16 in, fp32 accumulate.
//
// Replaces the TPU kernels more4d_tpu/kernels/flash_attention.py:216
// (_flash_bwd_dq_kernel) and :250 (_flash_bwd_dkv_kernel), host side
// _flash_backward :291. Same function and the same rounding points: with
// q' = bf16(q * bf16(sm_scale * log2 e)) as the forward folds it,
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
// tensor-core operations (>= 0.85 ms and 1.14 ms at 989 TFLOP/s). This
// first version is FlashAttention-2's two-kernel split in its simple form:
//   - K2: one CTA of 4 warps per (batch*head, 64-row q tile), looping over
//     64-key tiles; each warp owns 16 q rows and their dq accumulator in
//     registers (16 x D fp32), like K1's O accumulator;
//   - K3: one CTA of 4 warps per (batch*head, 64-key tile), looping over
//     32-row q tiles; each warp owns 16 keys and their dk and dv
//     accumulators (2 x 16 x D fp32). It forms S^T and dP^T key-major, so
//     the lse and delta of a q column come from shared memory;
//   - every operand is staged in shared memory and A fragments are read
//     from it per product, which keeps the registers for the accumulators;
//   - mma.sync m16n8k16; the accumulator layout of S^T / dS is reused as
//     the A operand of the next product, so P and dS never leave
//     registers; loads are synchronous (no cp.async/TMA, no wgmma).
// K2 skips key tiles past kv_len (they hold p = 0 exactly); a K3 CTA whose
// keys all lie past kv_len writes zeros. Inputs are read through strides,
// so BLHD tensors need no transpose; outputs are written through strides.

#include "flash_common.cuh"

namespace {

using namespace flash;
using bf16 = __nv_bfloat16;

constexpr int BQ = 64;   // K2: q rows a CTA
constexpr int BK = 64;   // key rows a tile (K2's loop, K3's CTA)
constexpr int BQ3 = 32;  // K3: q rows a tile of its loop

// Element strides (batch, row, head) of every tensor a kernel reads or
// writes, passed by value as one kernel argument.
struct Strides {
  long long v[18];
};

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dq_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                    const bf16* __restrict__ v, const bf16* __restrict__ dout,
                    const float* __restrict__ lse,
                    const float* __restrict__ delta, bf16* __restrict__ dq,
                    const int* __restrict__ kv_lens, int H, int Lq, int Lk,
                    const Strides st, float q_scale,
                    float sm_scale) {
  constexpr int LDS = D + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sQ = reinterpret_cast<bf16*>(smem_raw);
  bf16* sDO = sQ + BQ * LDS;
  bf16* sK = sDO + BQ * LDS;
  bf16* sV = sK + BK * LDS;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // strides (batch, row, head) of q, k, v, dO, dq in turn
  const bf16* kb = k + b * st.v[3] + h * st.v[5];
  const bf16* vb = v + b * st.v[6] + h * st.v[8];
  int kv_len = Lk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Lk);

  load_rows<D, BQ, true>(sQ, q + b * st.v[0] + h * st.v[2], st.v[1], q0, Lq,
                         tid, q_scale);
  load_rows<D, BQ>(sDO, dout + b * st.v[9] + h * st.v[11], st.v[10], q0, Lq,
                   tid);

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  bool row_ok[2];
  float lse_r[2], delta_r[2];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    row_ok[i] = row < Lq;
    lse_r[i] = row_ok[i] ? lse[(long long)bh * Lq + row] : 0.f;
    delta_r[i] = row_ok[i] ? delta[(long long)bh * Lq + row] : 0.f;
  }

  float acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n) acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // q/dO staged; every warp is done with the last tile
    load_rows<D, BK>(sK, kb, st.v[4], k0, Lk, tid);
    load_rows<D, BK>(sV, vb, st.v[7], k0, Lk, tid);
    __syncthreads();

    float s[8][4], dp[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
    mma_abt<D, 8>(s, sQ, r0, sK, g, t);    // q' k^T
    mma_abt<D, 8>(dp, sDO, r0, sV, g, t);  // dO v^T
#pragma unroll
    for (int j = 0; j < 8; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int i = c >> 1;
        const bool ok = row_ok[i] && k0 + j * 8 + 2 * t + (c & 1) < kv_len;
        const float p = ok ? exp2f(s[j][c] - lse_r[i]) : 0.f;
        s[j][c] = p * (dp[j][c] - delta_r[i]) * sm_scale;  // ds
      }
    mma_pb<D, BK / 16>(acc, s, sK, g, t);  // dq += bf16(ds) k
  }

  bf16* dqb = dq + b * st.v[12] + h * st.v[14];
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    if (!row_ok[i]) continue;
    bf16* row = dqb + (long long)(q0 + r0 + 8 * i) * st.v[13];
#pragma unroll
    for (int n = 0; n < ND; ++n)
      *reinterpret_cast<uint32_t*>(row + n * 8 + 2 * t) =
          pack_bf16(acc[n][2 * i], acc[n][2 * i + 1]);
  }
}

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_bwd_dkv_kernel(const bf16* __restrict__ q, const bf16* __restrict__ k,
                     const bf16* __restrict__ v,
                     const bf16* __restrict__ dout,
                     const float* __restrict__ lse,
                     const float* __restrict__ delta, bf16* __restrict__ dk,
                     bf16* __restrict__ dv, const int* __restrict__ kv_lens,
                     int H, int Lq, int Lk, const Strides st,
                     float q_scale, float sm_scale, float dk_scale) {
  constexpr int LDS = D + 8;
  constexpr int ND = D / 8;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  bf16* sK = reinterpret_cast<bf16*>(smem_raw);
  bf16* sV = sK + BK * LDS;
  bf16* sQ = sV + BK * LDS;
  bf16* sDO = sQ + BQ3 * LDS;
  float* sL = reinterpret_cast<float*>(sDO + BQ3 * LDS);
  float* sDl = sL + BQ3;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int k0 = blockIdx.x * BK;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;
  // strides (batch, row, head) of q, k, v, dO, dk, dv in turn
  const bf16* qb = q + b * st.v[0] + h * st.v[2];
  const bf16* dob = dout + b * st.v[9] + h * st.v[11];
  int kv_len = Lk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Lk);

  load_rows<D, BK>(sK, k + b * st.v[3] + h * st.v[5], st.v[4], k0, Lk, tid);
  load_rows<D, BK>(sV, v + b * st.v[6] + h * st.v[8], st.v[7], k0, Lk, tid);

  const int r0 = warp * 16 + g;  // this thread's keys: k0 + r0, k0 + r0 + 8
  const bool key_ok[2] = {k0 + r0 < kv_len, k0 + r0 + 8 < kv_len};

  float dk_acc[ND][4], dv_acc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk_acc[n][c] = dv_acc[n][c] = 0.f;

  const int n_tiles = k0 < kv_len ? (Lq + BQ3 - 1) / BQ3 : 0;
  for (int qt = 0; qt < n_tiles; ++qt) {
    const int q0 = qt * BQ3;
    __syncthreads();  // k/v staged; every warp is done with the last tile
    load_rows<D, BQ3, true>(sQ, qb, st.v[1], q0, Lq, tid, q_scale);
    load_rows<D, BQ3>(sDO, dob, st.v[10], q0, Lq, tid);
    if (tid < BQ3) {
      const bool ok = q0 + tid < Lq;
      sL[tid] = ok ? lse[(long long)bh * Lq + q0 + tid] : 0.f;
      sDl[tid] = ok ? delta[(long long)bh * Lq + q0 + tid] : 0.f;
    }
    __syncthreads();

    float s[4][4], dp[4][4];
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[j][c] = dp[j][c] = 0.f;
    mma_abt<D, 4>(s, sK, r0, sQ, g, t);    // S^T = k q'^T
    mma_abt<D, 4>(dp, sV, r0, sDO, g, t);  // dP^T = v dO^T
#pragma unroll
    for (int j = 0; j < 4; ++j)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int col = j * 8 + 2 * t + (c & 1);
        const bool ok = key_ok[c >> 1] && q0 + col < Lq;
        const float p = ok ? exp2f(s[j][c] - sL[col]) : 0.f;
        s[j][c] = p;
        dp[j][c] = p * (dp[j][c] - sDl[col]) * sm_scale;  // ds^T
      }
    mma_pb<D, BQ3 / 16>(dv_acc, s, sDO, g, t);  // dv += bf16(p)^T dO
    mma_pb<D, BQ3 / 16>(dk_acc, dp, sQ, g, t);  // dk += bf16(ds)^T q'
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
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(krow + n * 8 + 2 * t) = pack_bf16(
          dk_acc[n][2 * i] * dk_scale, dk_acc[n][2 * i + 1] * dk_scale);
      *reinterpret_cast<uint32_t*>(vrow + n * 8 + 2 * t) =
          pack_bf16(dv_acc[n][2 * i], dv_acc[n][2 * i + 1]);
    }
  }
}

template <int D>
int launch_dq(const void* q, const void* k, const void* v, const void* dout,
              const void* lse, const void* delta, void* dq,
              const void* kv_lens, int B, int H, int Lq, int Lk,
              const long long* strides, float q_scale, float sm_scale,
              cudaStream_t stream) {
  Strides st{};
  for (int i = 0; i < 15; ++i) st.v[i] = strides[i];
  const int smem = (2 * BQ + 2 * BK) * (D + 8) * 2;
  static std::atomic<unsigned> ready{0u};
  const cudaError_t err = smem_limit_once(flash_bwd_dq_kernel<D>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_bwd_dq_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dq), static_cast<const int*>(kv_lens), H, Lq, Lk, st,
      q_scale, sm_scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int launch_dkv(const void* q, const void* k, const void* v, const void* dout,
               const void* lse, const void* delta, void* dk, void* dv,
               const void* kv_lens, int B, int H, int Lq, int Lk,
               const long long* strides, float q_scale, float sm_scale,
               float dk_scale, cudaStream_t stream) {
  Strides st{};
  for (int i = 0; i < 18; ++i) st.v[i] = strides[i];
  const int smem = (2 * BK + 2 * BQ3) * (D + 8) * 2 + 2 * BQ3 * 4;
  static std::atomic<unsigned> ready{0u};
  const cudaError_t err =
      smem_limit_once(flash_bwd_dkv_kernel<D>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lk + BK - 1) / BK, B * H);
  flash_bwd_dkv_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const bf16*>(q), static_cast<const bf16*>(k),
      static_cast<const bf16*>(v), static_cast<const bf16*>(dout),
      static_cast<const float*>(lse), static_cast<const float*>(delta),
      static_cast<bf16*>(dk), static_cast<bf16*>(dv),
      static_cast<const int*>(kv_lens), H, Lq, Lk, st, q_scale, sm_scale,
      dk_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// K2. strides: 15 element strides, (batch, row, head)
// for q, k, v, dO and dq in turn. lse and delta are [B*H, Lq] fp32.
// kv_lens may be null (every key valid). Returns the cudaError_t of the
// launch; 1 (cudaErrorInvalidValue) for an unsupported head dim.
extern "C" int flash_bwd_dq_bf16(const void* q, const void* k, const void* v,
                                 const void* dout, const void* lse,
                                 const void* delta, void* dq,
                                 const void* kv_lens, int B, int H, int Lq,
                                 int Lk, int D, const long long* strides,
                                 float q_scale, float sm_scale,
                                 void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dq<64>(q, k, v, dout, lse, delta, dq, kv_lens, B, H, Lq, Lk,
                         strides, q_scale, sm_scale, s);
  if (D == 128)
    return launch_dq<128>(q, k, v, dout, lse, delta, dq, kv_lens, B, H, Lq,
                          Lk, strides, q_scale, sm_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}

// K3. strides: 18 element strides, (batch, row, head)
// for q, k, v, dO, dk and dv in turn. dk_scale = 1 / (log2 e * sm_scale)
// rounded to fp32. Otherwise as flash_bwd_dq_bf16.
extern "C" int flash_bwd_dkv_bf16(const void* q, const void* k, const void* v,
                                  const void* dout, const void* lse,
                                  const void* delta, void* dk, void* dv,
                                  const void* kv_lens, int B, int H, int Lq,
                                  int Lk, int D, const long long* strides,
                                  float q_scale, float sm_scale,
                                  float dk_scale, void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (D == 64)
    return launch_dkv<64>(q, k, v, dout, lse, delta, dk, dv, kv_lens, B, H,
                          Lq, Lk, strides, q_scale, sm_scale, dk_scale, s);
  if (D == 128)
    return launch_dkv<128>(q, k, v, dout, lse, delta, dk, dv, kv_lens, B, H,
                           Lq, Lk, strides, q_scale, sm_scale, dk_scale, s);
  return static_cast<int>(cudaErrorInvalidValue);
}
