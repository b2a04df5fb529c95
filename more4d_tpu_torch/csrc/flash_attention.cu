// Flash-attention forward for Hopper (sm_90a), bf16 in, fp32 accumulate.
//
// Replaces the TPU kernel more4d_tpu/kernels/flash_attention.py:48
// (_flash_fwd_kernel, host side _flash_forward :125). Same function:
// online-softmax attention with a per-batch kv-length mask, the softmax
// scale times log2(e) folded into q in q's dtype (bf16) before QK^T,
// exp2 in the softmax, P rounded to v's dtype before PV, O = acc / max(l,
// 1e-30) in bf16 and the base-2 logsumexp m + log2(max(l, 1e-30)) in fp32
// per query row (stored [B*H, Lq], read by the backward kernels in
// flash_attention_bwd.cu). The mma and tile helpers are flash_common.cuh.
//
// What bounds it: at the main path's self-attention (B=2, H=12, L=9568,
// D=128) the work is 4*B*H*L^2*D = 1.12e12 FLOP against ~47 MB of q/k/v/o,
// so it is bound by tensor-core operations (>= 1.14 ms at 989 TFLOP/s).
// The training path launches it at batch 1 (half that), and again in each
// rematerialised block's recompute.
// This first version is the simple, correct shape of FlashAttention-2:
//   - one CTA of 4 warps per (batch*head, 64-row q tile); each warp owns
//     16 q rows, kept as mma A fragments in registers for the whole loop;
//   - k/v tiles of 64 keys staged in shared memory (rows padded by 8
//     elements so the 32-bit fragment loads are free of bank conflicts);
//   - QK^T and PV with mma.sync m16n8k16 (bf16 x bf16 -> fp32); the S
//     accumulator's register layout is reused as PV's A operand, so P
//     never leaves registers;
//   - loads are synchronous (no cp.async/TMA pipeline, no wgmma, no warp
//     specialisation): those are the later, faster versions' work.
// Tiles past kv_len are skipped: they would add exp2(-1e30 - m) = 0 to
// every sum, so skipping them changes no number. Inputs are read through
// strides, so BLHD tensors need no transpose; the last dim is contiguous.

#include "flash_common.cuh"

namespace {

using namespace flash;

constexpr int BQ = 64;
constexpr int BK = 64;

template <int D>
__global__ void __launch_bounds__(NTHREADS)
flash_fwd_kernel(const __nv_bfloat16* __restrict__ q,
                 const __nv_bfloat16* __restrict__ k,
                 const __nv_bfloat16* __restrict__ v,
                 __nv_bfloat16* __restrict__ o, float* __restrict__ lse,
                 const int* __restrict__ kv_lens, int H, int Lq, int Lk,
                 long long q_sb, long long q_sl, long long q_sh,
                 long long k_sb, long long k_sl, long long k_sh,
                 long long v_sb, long long v_sl, long long v_sh,
                 long long o_sb, long long o_sl, long long o_sh,
                 float q_scale) {
  constexpr int LDS = D + 8;
  constexpr int KD = D / 16;   // k-steps of QK^T
  constexpr int ND = D / 8;    // n8 tiles of the output row block
  extern __shared__ __align__(16) unsigned char smem_raw[];
  __nv_bfloat16* sQ = reinterpret_cast<__nv_bfloat16*>(smem_raw);
  __nv_bfloat16* sK = sQ + BQ * LDS;
  __nv_bfloat16* sV = sK + BK * LDS;

  const int bh = blockIdx.y;
  const int b = bh / H, h = bh % H;
  const int q0 = blockIdx.x * BQ;
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t = lane & 3;

  const __nv_bfloat16* qb = q + b * q_sb + h * q_sh;
  const __nv_bfloat16* kb = k + b * k_sb + h * k_sh;
  const __nv_bfloat16* vb = v + b * v_sb + h * v_sh;
  int kv_len = Lk;
  if (kv_lens != nullptr) kv_len = min(max(kv_lens[b], 0), Lk);

  // q tile, scaled by sm_scale*log2(e) and rounded back to bf16 (the JAX
  // host folds the factor into q in q's dtype the same way)
  load_rows<D, BQ, true>(sQ, qb, q_sl, q0, Lq, tid, q_scale);
  __syncthreads();

  const int r0 = warp * 16 + g;  // this thread's rows: r0 and r0 + 8
  uint32_t qf[KD][4];
#pragma unroll
  for (int kk = 0; kk < KD; ++kk) load_a<D>(qf[kk], sQ, r0, kk, t);

  float oacc[ND][4];
#pragma unroll
  for (int n = 0; n < ND; ++n)
    oacc[n][0] = oacc[n][1] = oacc[n][2] = oacc[n][3] = 0.f;
  float m_row[2] = {NEG_INF, NEG_INF};
  float l_row[2] = {0.f, 0.f};  // this thread's partial row sums

  const int n_tiles = (kv_len + BK - 1) / BK;
  for (int kt = 0; kt < n_tiles; ++kt) {
    const int k0 = kt * BK;
    __syncthreads();  // every warp is done with the previous k/v tile
    load_rows<D, BK>(sK, kb, k_sl, k0, Lk, tid);
    load_rows<D, BK>(sV, vb, v_sl, k0, Lk, tid);
    __syncthreads();

    float s[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) s[j][0] = s[j][1] = s[j][2] = s[j][3] = 0.f;
#pragma unroll
    for (int kk = 0; kk < KD; ++kk) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const __nv_bfloat16* kr = sK + (j * 8 + g) * LDS + kk * 16 + 2 * t;
        mma_16816(s[j], qf[kk], ld32(kr), ld32(kr + 8));
      }
    }

    if (k0 + BK > kv_len) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          if (k0 + j * 8 + 2 * t + (c & 1) >= kv_len) s[j][c] = NEG_INF;
    }

    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      mx[0] = fmaxf(mx[0], fmaxf(s[j][0], s[j][1]));
      mx[1] = fmaxf(mx[1], fmaxf(s[j][2], s[j][3]));
    }
    float alpha[2];
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
    for (int j = 0; j < 8; ++j) {
      s[j][0] = exp2f(s[j][0] - m_row[0]);
      s[j][1] = exp2f(s[j][1] - m_row[0]);
      s[j][2] = exp2f(s[j][2] - m_row[1]);
      s[j][3] = exp2f(s[j][3] - m_row[1]);
      psum[0] += s[j][0] + s[j][1];
      psum[1] += s[j][2] + s[j][3];
    }
    l_row[0] = alpha[0] * l_row[0] + psum[0];
    l_row[1] = alpha[1] * l_row[1] + psum[1];
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      oacc[n][0] *= alpha[0];
      oacc[n][1] *= alpha[0];
      oacc[n][2] *= alpha[1];
      oacc[n][3] *= alpha[1];
    }

    mma_pb<D, BK / 16>(oacc, s, sV, g, t);
  }

#pragma unroll
  for (int i = 0; i < 2; ++i) {
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 1);
    l_row[i] += __shfl_xor_sync(0xffffffffu, l_row[i], 2);
  }
  __nv_bfloat16* ob = o + b * o_sb + h * o_sh;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int row = q0 + r0 + 8 * i;
    if (row >= Lq) continue;
    const float l = fmaxf(l_row[i], 1e-30f);
    __nv_bfloat16* orow = ob + (long long)row * o_sl;
#pragma unroll
    for (int n = 0; n < ND; ++n) {
      *reinterpret_cast<uint32_t*>(orow + n * 8 + 2 * t) =
          pack_bf16(oacc[n][2 * i] / l, oacc[n][2 * i + 1] / l);
    }
    if (t == 0) lse[(long long)bh * Lq + row] = m_row[i] + log2f(l);
  }
}

template <int D>
int launch(const void* q, const void* k, const void* v, void* o, void* lse,
           const void* kv_lens, int B, int H, int Lq, int Lk,
           const long long* st, float q_scale, cudaStream_t stream) {
  const int smem = (BQ + 2 * BK) * (D + 8) * 2;
  static std::atomic<unsigned> ready{0u};
  const cudaError_t err = smem_limit_once(flash_fwd_kernel<D>, smem, ready);
  if (err != cudaSuccess) return static_cast<int>(err);
  dim3 grid((Lq + BQ - 1) / BQ, B * H);
  flash_fwd_kernel<D><<<grid, NTHREADS, smem, stream>>>(
      static_cast<const __nv_bfloat16*>(q), static_cast<const __nv_bfloat16*>(k),
      static_cast<const __nv_bfloat16*>(v), static_cast<__nv_bfloat16*>(o),
      static_cast<float*>(lse), static_cast<const int*>(kv_lens), H, Lq, Lk,
      st[0], st[1], st[2], st[3], st[4], st[5], st[6], st[7], st[8], st[9],
      st[10], st[11], q_scale);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// strides: 12 element strides, (batch, row, head) for q, k, v, o in turn.
// kv_lens may be null (every key valid). Returns the cudaError_t of the
// launch; 1 (cudaErrorInvalidValue) for an unsupported head dim.
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
