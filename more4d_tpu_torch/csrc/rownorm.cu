// Row norms with the elementwise chains that follow them, for Hopper
// (sm_90a), bf16 in and out: K5.
//
// Replaces no TPU kernel: the JAX package leaves these chains to XLA,
// which fuses each into one pass over the token's row. PyTorch's eager code
// runs each step of a chain as its own kernel (casts, the statistics, the
// subtractions, multiplies and adds), about 270 passes over a [B, L, D]
// tensor a DiT block. Here each chain is one pass: a CTA loads its token's
// row once (16-byte loads, held in registers), takes the statistics in
// fp32, applies the epilogue and stores the row once in bf16. The
// epilogues (EPI), each the function of its plain version in
// more4d_tpu_torch/kernels/rownorm.py:
//
//   RMS       y = bf16(x * rsqrt(mean(x^2) + eps) * w)          (RMSNorm)
//   RMS_ROPE  the same y, then each head's consecutive channel pairs
//             (y_2j, y_2j+1) rotated by the token's cos/sin row [head_dim/2]
//             in fp32 and rounded once: the norm's bf16 rounding before the
//             rotation is kept, as the eager chain has it
//   AFFINE    y = bf16((x - mean) * rsqrt(var + eps) * w + b)     (norm3)
//   MODULATE  h = n * (1 + scale) + shift, n the LayerNorm without affine,
//             shift/scale the adaLN rows (per sample or per token)
//   FILM      MODULATE, then h * (1 + (ps * m) * g) + (ph * m) * g with
//             (ps, ph) the FiLM projection's row [2D], m the token's mask
//             rounded to bf16 and g the gate [D]
//
// The statistics are the eager code's: mean, then the mean of squared
// deviations (two passes over the registers), or the mean square, in fp32,
// with the same epsilons. MODULATE and FILM keep fp32 from the norm to the
// store, where the eager chain rounds to bf16 after every operation: the
// kernel rounds at fewer points, never at more.
//
// What bounds it on the H100: a FILM row at D = 1536 reads 2D + 4D bytes
// and writes 2D (with ~15 operations an element), about 2 operations a
// byte against the card's ~295, so only bytes count. The design:
//   - one CTA a row, CPT 16-byte chunks a thread, chunk c of a row taken
//     by thread c % T (neighbouring threads on neighbouring addresses);
//     the whole row stays in registers from the load to the store;
//   - the row and the FiLM projection's row are loaded before the first
//     reduction, so the CTA's bytes are in flight together; the per-sample
//     vectors (weights, adaLN rows, gate, cos/sin) are small and read
//     from L2 in the epilogue;
//   - the block sum: a warp's shuffles, one shared float a warp, every
//     thread summing the warps' partials in the same order;
//   - T = ceil(D / 8 / CPT) rounded up to a warp, CPT 1 up to D 2048
//     and 4 from there to 8192 (D 1536: 192 threads of one chunk, 10 rows
//     resident on an SM; D 5120: 160 threads of four), the two the
//     configured widths reach. Four rows a CTA (a thread's loads of four rows in flight
//     at once, one barrier for the four) measured no faster: the FiLM
//     row at D 1536 took 0.155 ms against 0.093, RoPE 0.061 against 0.057,
//     the LayerNorm 0.050 against 0.056 (H100 SXM, 700 W).
//
// Under a gradient the forward also writes each row's fp32 statistics
// (mean and rstd, or rstd for RMS; the no-gradient launch passes a null
// pointer and skips the store), and the backward is one pass
// over the rows, each epilogue's gradients in fp32 from the bf16 x and
// output gradient dy and the saved statistics (n the normalised row,
// g = dL/dn):
//
//   RMS       dw = sum dy n,  g = dy w
//   RMS_ROPE  the same with dy first turned back by each pair's -theta (the
//             norm's bf16 rounding before the rotation passes the gradient
//             as it is, as autograd passes a cast)
//   AFFINE    dw = sum dy n,  db = sum dy,  g = dy w
//   MODULATE  dshift = dy, dscale = dy n (summed over the sample's tokens
//             for per-sample rows, stored a row for per-token ones),
//             g = dy (1 + scale)
//   FILM      dgate = sum dy (h ps m + ph m), dparams = dy g m (h | 1) (0
//             on masked rows), then MODULATE's with dy (1 + ps m g)
//   dx        rstd (g - mean(g) - n mean(g n)), without mean(g) for RMS
//
// It is a reduction along both axes: dx per row, the weights' gradients
// (and per-sample shift/scale's, over a sample's tokens) per column. A CTA
// takes a strip of consecutive rows (one wave of the card's CTAs in all,
// strips never crossing a sample), a row at a time as the forward does,
// with the same threads a chunk and the column sums kept in registers over
// the strip, and writes its partial sums once; a second pass adds the
// strips' partials in a fixed order (no atomics: the same bits every run).
// What bounds it: bytes, as the forward: the FiLM row at D 1536 reads x,
// dy and the projection (8D bytes) and writes dx and the projection's
// gradient (6D), ~3 operations a byte; the partials add one float a
// column a sum a strip, written and read once (a few percent of the rows'
// bytes at the DiT's lengths).

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

enum Epilogue : int {
  RMS = 0,
  RMS_ROPE = 1,
  AFFINE = 2,
  MODULATE = 3,
  FILM = 4,
};

constexpr int VEC = 8;  // bf16 elements in a 16-byte chunk
constexpr int MAX_CPT = 4;
constexpr int MAX_THREADS = 256;

// flags: the norm's weight or bias is stored in bf16 (else fp32)
constexpr int W_BF16 = 1;
constexpr int B_BF16 = 2;

struct Args {
  const __nv_bfloat16* x;  // [rows, D]
  __nv_bfloat16* out;      // [rows, D]
  int L;                   // tokens a sample: row r is token r % L of r / L
  int D;
  float eps;
  const void* w;  // [D] norm weight (RMS, RMS_ROPE, AFFINE)
  const void* b;  // [D] norm bias (AFFINE)
  const __nv_bfloat16* shift;  // adaLN rows (MODULATE, FILM): element
  const __nv_bfloat16* scale;  // (b, l, d) at b * mod_sb + l * mod_sl + d
  long long mod_sb, mod_sl;
  const __nv_bfloat16* film;  // [rows, 2D]: scale | shift (FILM)
  const float* mask;          // [L] or null (FILM)
  const __nv_bfloat16* gate;  // [D] (FILM)
  const float* cos;           // [L, half] (RMS_ROPE)
  const float* sin;
  int half;  // head_dim / 2
  int flags;
  float* stats;  // [rows, 2] (mean, rstd), [rows] rstd (RMS, RMS_ROPE), or
                 // null: the statistics kept for the backward
};

__device__ __forceinline__ void load8_bf16(const __nv_bfloat16* p,
                                           float (&v)[VEC]) {
  const uint4 u = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i) {
    const float2 f = __bfloat1622float2(h[i]);
    v[2 * i] = f.x;
    v[2 * i + 1] = f.y;
  }
}

__device__ __forceinline__ void load8_f32(const float* p, float (&v)[VEC]) {
  const float4 a = reinterpret_cast<const float4*>(p)[0];
  const float4 b = reinterpret_cast<const float4*>(p)[1];
  v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
  v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
}

// 8 elements from index i of a vector stored in bf16 or fp32
__device__ __forceinline__ void load8(const void* p, bool bf16, long long i,
                                      float (&v)[VEC]) {
  if (bf16)
    load8_bf16(static_cast<const __nv_bfloat16*>(p) + i, v);
  else
    load8_f32(static_cast<const float*>(p) + i, v);
}

__device__ __forceinline__ void store8_bf16(__nv_bfloat16* p,
                                            const float (&v)[VEC]) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < VEC / 2; ++i)
    h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  *reinterpret_cast<uint4*>(p) = u;
}

__device__ __forceinline__ float round_bf16(float v) {
  return __bfloat162float(__float2bfloat16_rn(v));
}

// The sum of every thread's s, the same value in every thread of the CTA.
__device__ __forceinline__ float block_sum(float s, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(0xffffffffu, s, o);
  const int warps = blockDim.x >> 5;
  __syncthreads();  // the previous sum's readers are done with red
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = s;
  __syncthreads();
  float t = 0.f;
  for (int i = 0; i < warps; ++i) t += red[i];
  return t;
}

// The epilogue of one 16-byte chunk x (elements d0 .. d0 + 7 of the row
// `row`, token l of sample bi) and its store.
template <int EPI>
__device__ __forceinline__ void chunk_epilogue(
    const Args& a, const float (&x)[VEC], const float (&ps)[VEC],
    const float (&ph)[VEC], float mean, float rstd, int l, long long bi,
    float m, int d0, long long row) {
  float y[VEC];
  if constexpr (EPI == RMS || EPI == RMS_ROPE) {
    float w[VEC];
    load8(a.w, a.flags & W_BF16, d0, w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[j] = x[j] * rstd * w[j];
    if constexpr (EPI == RMS_ROPE) {
      // the pairs of this chunk: j0 .. j0 + 3 of one head (head_dim is a
      // multiple of 8)
      const int j0 = (d0 % (2 * a.half)) / 2;
      const long long t = static_cast<long long>(l) * a.half + j0;
      const float4 cs = *reinterpret_cast<const float4*>(a.cos + t);
      const float4 sn = *reinterpret_cast<const float4*>(a.sin + t);
      const float cv[4] = {cs.x, cs.y, cs.z, cs.w};
      const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float e = round_bf16(y[2 * p]);
        const float o = round_bf16(y[2 * p + 1]);
        y[2 * p] = e * cv[p] - o * sv[p];
        y[2 * p + 1] = e * sv[p] + o * cv[p];
      }
    }
  } else if constexpr (EPI == AFFINE) {
    float w[VEC], b[VEC];
    load8(a.w, a.flags & W_BF16, d0, w);
    load8(a.b, a.flags & B_BF16, d0, b);
#pragma unroll
    for (int j = 0; j < VEC; ++j) y[j] = (x[j] - mean) * rstd * w[j] + b[j];
  } else {
    float sh[VEC], sc[VEC];
    const long long mo = bi * a.mod_sb + l * a.mod_sl + d0;
    load8_bf16(a.shift + mo, sh);
    load8_bf16(a.scale + mo, sc);
#pragma unroll
    for (int j = 0; j < VEC; ++j)
      y[j] = (x[j] - mean) * rstd * (1.f + sc[j]) + sh[j];
    if constexpr (EPI == FILM) {
      float g[VEC];
      load8_bf16(a.gate + d0, g);
#pragma unroll
      for (int j = 0; j < VEC; ++j)
        y[j] = y[j] * (1.f + ps[j] * m * g[j]) + ph[j] * m * g[j];
    }
  }
  store8_bf16(a.out + row * a.D + d0, y);
}

template <int EPI, int CPT>
__global__ void __launch_bounds__(MAX_THREADS)
more4d_rownorm_kernel(const Args a) {
  constexpr bool kLayerNorm = EPI == AFFINE || EPI == MODULATE || EPI == FILM;
  constexpr int FC = EPI == FILM ? CPT : 1;
  __shared__ float red[MAX_THREADS / 32];

  const long long row = blockIdx.x;
  const int D = a.D;
  const int nc = D / VEC;

  // the row's chunks (and the FiLM projection's) in flight together
  float v[CPT][VEC];
  float ps[FC][VEC];  // the FiLM projection's scale
  float ph[FC][VEC];  // and shift
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nc) {
      load8_bf16(a.x + row * D + c * VEC, v[i]);
      if constexpr (EPI == FILM) {
        const __nv_bfloat16* fr = a.film + row * 2 * D + c * VEC;
        load8_bf16(fr, ps[i]);
        load8_bf16(fr + D, ph[i]);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) v[i][j] = 0.f;
    }
  }

  const float inv_d = 1.f / static_cast<float>(D);
  float mean = 0.f, q = 0.f;  // q: the sum of squares (of deviations)
  if constexpr (kLayerNorm) {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) mean += v[i][j];
    mean = block_sum(mean, red) * inv_d;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      if (threadIdx.x + i * blockDim.x < nc) {
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          const float t = v[i][j] - mean;
          q += t * t;
        }
      }
    }
  } else {
#pragma unroll
    for (int i = 0; i < CPT; ++i)
#pragma unroll
      for (int j = 0; j < VEC; ++j) q += v[i][j] * v[i][j];
  }
  const float rstd = rsqrtf(block_sum(q, red) * inv_d + a.eps);
  if (a.stats != nullptr && threadIdx.x == 0) {
    if constexpr (kLayerNorm) {
      a.stats[2 * row] = mean;
      a.stats[2 * row + 1] = rstd;
    } else {
      a.stats[row] = rstd;
    }
  }

  const int l = static_cast<int>(row % a.L);
  const long long bi = row / a.L;
  float m = 1.f;
  if constexpr (EPI == FILM) {
    if (a.mask != nullptr) m = round_bf16(a.mask[l]);
  }
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c < nc)
      chunk_epilogue<EPI>(a, v[i], ps[i % FC], ph[i % FC], mean, rstd, l,
                          bi, m, c * VEC, row);
  }
}

template <int EPI>
cudaError_t launch_cpt(const Args& a, long long rows, int cpt, int threads,
                       cudaStream_t stream) {
  const dim3 grid(static_cast<unsigned>(rows));
  if (cpt == 1)
    more4d_rownorm_kernel<EPI, 1><<<grid, threads, 0, stream>>>(a);
  else
    more4d_rownorm_kernel<EPI, MAX_CPT><<<grid, threads, 0, stream>>>(a);
  return cudaGetLastError();
}

// ---------------------------------------------------------------- backward

constexpr int BWD_MAX_CPT = 2;
constexpr int BWD_MAX_THREADS = 512;
constexpr int SUM_LANES = 32;  // the column-sum pass: lanes over the strips

// The column sums (slots) of an epilogue's backward: RMS and RMS_ROPE the
// weight's; AFFINE the weight's and the bias's; MODULATE per-sample shift's
// and scale's; FILM those and the gate's.
__host__ __device__ constexpr int bwd_slots(int epi) {
  return epi == RMS || epi == RMS_ROPE ? 1 : epi == FILM ? 3 : 2;
}

struct BwdArgs {
  const __nv_bfloat16* x;   // [rows, D]
  const __nv_bfloat16* dy;  // [rows, D]: the output's gradient
  const float* stats;       // the forward's statistics (Args::stats)
  __nv_bfloat16* dx;        // [rows, D] or null
  long long group_rows;     // rows a group (a sample where shift and scale
                            // are per sample, else every row)
  int L;
  int D;
  const void* w;  // the operands, read as the forward reads them
  const __nv_bfloat16* shift;
  const __nv_bfloat16* scale;
  long long mod_sb, mod_sl;
  const __nv_bfloat16* film;
  const float* mask;
  const __nv_bfloat16* gate;
  const float* cos;
  const float* sin;
  int half;
  int flags;
  __nv_bfloat16* dshift;  // [rows, D] for per-token shift and scale, or null
  __nv_bfloat16* dscale;
  __nv_bfloat16* dfilm;   // [rows, 2D] or null
  float* partial;         // [groups, strips, slots, D]
  int need;               // bit q: slot q's partial sums are written
};

// The sums of every thread's s and t, the same in every thread of the CTA.
__device__ __forceinline__ float2 block_sum2(float s, float t, float* red) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) {
    s += __shfl_xor_sync(0xffffffffu, s, o);
    t += __shfl_xor_sync(0xffffffffu, t, o);
  }
  const int warps = blockDim.x >> 5;
  __syncthreads();  // the previous row's readers are done with red
  if ((threadIdx.x & 31) == 0) {
    red[2 * (threadIdx.x >> 5)] = s;
    red[2 * (threadIdx.x >> 5) + 1] = t;
  }
  __syncthreads();
  float2 r = make_float2(0.f, 0.f);
  for (int i = 0; i < warps; ++i) {
    r.x += red[2 * i];
    r.y += red[2 * i + 1];
  }
  return r;
}

// The backward of one 16-byte chunk (elements d0 .. d0 + 7 of the row
// `row`, token l of sample bi) up to the norm: the normalised n and
// g = dL/dn, for the row sums that give dx; the chunk's terms of the column
// sums added to acc; the FiLM projection's and per-token adaLN rows'
// gradients stored.
template <int EPI, bool PER_TOKEN, int Q>
__device__ __forceinline__ void chunk_backward(
    const BwdArgs& a, long long row, int l, long long bi, float m,
    float mean, float rstd, int d0, float (&n)[VEC], float (&g)[VEC],
    float (&acc)[Q][VEC]) {
  const long long at = row * a.D + d0;
  float x[VEC], dy[VEC];
  load8_bf16(a.x + at, x);
  load8_bf16(a.dy + at, dy);
#pragma unroll
  for (int j = 0; j < VEC; ++j) n[j] = (x[j] - mean) * rstd;
  if constexpr (EPI == RMS || EPI == RMS_ROPE) {
    if constexpr (EPI == RMS_ROPE) {
      // back through the rotation: each pair turned by -theta (the norm's
      // bf16 rounding before it passes the gradient as it is)
      const int j0 = (d0 % (2 * a.half)) / 2;
      const long long t = static_cast<long long>(l) * a.half + j0;
      const float4 cs = *reinterpret_cast<const float4*>(a.cos + t);
      const float4 sn = *reinterpret_cast<const float4*>(a.sin + t);
      const float cv[4] = {cs.x, cs.y, cs.z, cs.w};
      const float sv[4] = {sn.x, sn.y, sn.z, sn.w};
#pragma unroll
      for (int p = 0; p < 4; ++p) {
        const float e = dy[2 * p], o = dy[2 * p + 1];
        dy[2 * p] = e * cv[p] + o * sv[p];
        dy[2 * p + 1] = o * cv[p] - e * sv[p];
      }
    }
    float w[VEC];
    load8(a.w, a.flags & W_BF16, d0, w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[0][j] += dy[j] * n[j];
      g[j] = dy[j] * w[j];
    }
  } else if constexpr (EPI == AFFINE) {
    float w[VEC];
    load8(a.w, a.flags & W_BF16, d0, w);
#pragma unroll
    for (int j = 0; j < VEC; ++j) {
      acc[0][j] += dy[j] * n[j];
      acc[1][j] += dy[j];
      g[j] = dy[j] * w[j];
    }
  } else {
    float sc[VEC];
    const long long mo = bi * a.mod_sb + l * a.mod_sl + d0;
    load8_bf16(a.scale + mo, sc);
    if constexpr (EPI == FILM) {
      // out = h * (1 + ps m g) + ph m g, h the adaLN output in fp32
      float sh[VEC], ps[VEC], ph[VEC], gt[VEC], dps[VEC], dph[VEC];
      load8_bf16(a.shift + mo, sh);
      const __nv_bfloat16* fr = a.film + row * 2 * a.D + d0;
      load8_bf16(fr, ps);
      load8_bf16(fr + a.D, ph);
      load8_bf16(a.gate + d0, gt);
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        const float h = n[j] * (1.f + sc[j]) + sh[j];
        const float as = ps[j] * m, ah = ph[j] * m;
        acc[2][j] += dy[j] * (h * as + ah);
        dph[j] = dy[j] * gt[j] * m;
        dps[j] = dph[j] * h;
        dy[j] *= 1.f + as * gt[j];  // now dL/dh
      }
      if (a.dfilm != nullptr) {
        __nv_bfloat16* fo = a.dfilm + row * 2 * a.D + d0;
        store8_bf16(fo, dps);
        store8_bf16(fo + a.D, dph);
      }
    }
    if constexpr (PER_TOKEN) {
      if (a.dshift != nullptr) store8_bf16(a.dshift + at, dy);
      if (a.dscale != nullptr) {
        float t[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j) t[j] = dy[j] * n[j];
        store8_bf16(a.dscale + at, t);
      }
    } else {
#pragma unroll
      for (int j = 0; j < VEC; ++j) {
        acc[0][j] += dy[j];
        acc[1][j] += dy[j] * n[j];
      }
    }
#pragma unroll
    for (int j = 0; j < VEC; ++j) g[j] = dy[j] * (1.f + sc[j]);
  }
}

// One CTA a strip of consecutive rows of one group (blockIdx.y), a row at a
// time: dx from the saved statistics and the row's two sums, the column
// sums kept in registers over the strip and written once, as the strip's
// partial sums.
template <int EPI, int CPT, bool PER_TOKEN>
__global__ void __launch_bounds__(BWD_MAX_THREADS)
more4d_rownorm_bwd_kernel(const BwdArgs a) {
  constexpr bool kLayerNorm = EPI == AFFINE || EPI == MODULATE || EPI == FILM;
  constexpr int Q = bwd_slots(EPI);
  __shared__ float red[2 * BWD_MAX_THREADS / 32];

  const int D = a.D;
  const int nc = D / VEC;
  const long long per = (a.group_rows + gridDim.x - 1) / gridDim.x;
  const long long base = static_cast<long long>(blockIdx.y) * a.group_rows;
  const long long r0 = base + min(a.group_rows, blockIdx.x * per);
  const long long r1 = base + min(a.group_rows, (blockIdx.x + 1) * per);
  const float inv_d = 1.f / static_cast<float>(a.D);

  float acc[CPT][Q][VEC];
#pragma unroll
  for (int i = 0; i < CPT; ++i)
#pragma unroll
    for (int q = 0; q < Q; ++q)
#pragma unroll
      for (int j = 0; j < VEC; ++j) acc[i][q][j] = 0.f;

  for (long long row = r0; row < r1; ++row) {
    float mean = 0.f, rstd;
    if constexpr (kLayerNorm) {
      mean = a.stats[2 * row];
      rstd = a.stats[2 * row + 1];
    } else {
      rstd = a.stats[row];
    }
    const int l = static_cast<int>(row % a.L);
    const long long bi = row / a.L;
    float m = 1.f;
    if constexpr (EPI == FILM) {
      if (a.mask != nullptr) m = round_bf16(a.mask[l]);
    }
    float n[CPT][VEC], g[CPT][VEC];
    float sg = 0.f, sgn = 0.f;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nc) {
        chunk_backward<EPI, PER_TOKEN, Q>(a, row, l, bi, m, mean, rstd,
                                          c * VEC, n[i], g[i], acc[i]);
#pragma unroll
        for (int j = 0; j < VEC; ++j) {
          sg += g[i][j];
          sgn += g[i][j] * n[i][j];
        }
      } else {
#pragma unroll
        for (int j = 0; j < VEC; ++j) n[i][j] = g[i][j] = 0.f;
      }
    }
    const float2 sums = block_sum2(sg, sgn, red);
    const float mg = kLayerNorm ? sums.x * inv_d : 0.f;
    const float mgn = sums.y * inv_d;
#pragma unroll
    for (int i = 0; i < CPT; ++i) {
      const int c = threadIdx.x + i * blockDim.x;
      if (c < nc && a.dx != nullptr) {
        float d[VEC];
#pragma unroll
        for (int j = 0; j < VEC; ++j)
          d[j] = rstd * (g[i][j] - mg - n[i][j] * mgn);
        store8_bf16(a.dx + row * D + c * VEC, d);
      }
    }
  }

  const long long slot0 =
      (static_cast<long long>(blockIdx.y) * gridDim.x + blockIdx.x) * Q;
#pragma unroll
  for (int i = 0; i < CPT; ++i) {
    const int c = threadIdx.x + i * blockDim.x;
    if (c >= nc) continue;
#pragma unroll
    for (int q = 0; q < Q; ++q) {
      if (!((a.need >> q) & 1)) continue;
      float4* p = reinterpret_cast<float4*>(a.partial + (slot0 + q) * D +
                                            c * VEC);
      p[0] = make_float4(acc[i][q][0], acc[i][q][1], acc[i][q][2],
                         acc[i][q][3]);
      p[1] = make_float4(acc[i][q][4], acc[i][q][5], acc[i][q][6],
                         acc[i][q][7]);
    }
  }
}

struct SumArgs {
  const float* partial;  // [groups, strips, slots, D]
  int groups, strips, slots, D;
  void* out[3];  // slot q's gradient ([groups, D] per group, else [D]) or null
  int bf16;       // bit q: slot q's gradient is stored in bf16, else fp32
  int per_group;  // bit q: slot q is summed per group, else over all groups
};

// The strips' partial sums added up, a column a thread and SUM_LANES lanes
// over the strips (8 loads of a lane in flight), each lane in strip order
// and the lanes in lane order: the same bits every run (no atomics).
__global__ void __launch_bounds__(32 * SUM_LANES)
more4d_rownorm_bwd_sum_kernel(const SumArgs a) {
  const int q = blockIdx.y;
  const bool per_group = (a.per_group >> q) & 1;
  void* out = q == 0 ? a.out[0] : q == 1 ? a.out[1] : a.out[2];
  if (out == nullptr || (!per_group && blockIdx.z > 0)) return;
  const int col = blockIdx.x * 32 + threadIdx.x;
  const int g0 = per_group ? blockIdx.z : 0;
  const int g1 = per_group ? blockIdx.z + 1 : a.groups;
  float t = 0.f;
  if (col < a.D) {
    for (int g = g0; g < g1; ++g)
#pragma unroll 8
      for (int s = threadIdx.y; s < a.strips; s += SUM_LANES)
        t += a.partial[((static_cast<long long>(g) * a.strips + s) * a.slots
                        + q) * a.D + col];
  }
  __shared__ float red[SUM_LANES][32];
  red[threadIdx.y][threadIdx.x] = t;
  __syncthreads();
  if (threadIdx.y == 0 && col < a.D) {
    float v = 0.f;
#pragma unroll
    for (int i = 0; i < SUM_LANES; ++i) v += red[i][threadIdx.x];
    const long long o = static_cast<long long>(per_group ? blockIdx.z : 0)
                        * a.D + col;
    if ((a.bf16 >> q) & 1)
      static_cast<__nv_bfloat16*>(out)[o] = __float2bfloat16_rn(v);
    else
      static_cast<float*>(out)[o] = v;
  }
}

// The backward's threads a CTA and chunks a thread (1, or 2 from D 4104):
// 0 threads where D is not a positive multiple of 8 up to 8192.
int bwd_config(int D, int* cpt) {
  if (D <= 0 || D % VEC) return 0;
  const int nc = D / VEC;
  const int c = nc > BWD_MAX_THREADS ? BWD_MAX_CPT : 1;
  const int threads = ((nc + c - 1) / c + 31) / 32 * 32;
  if (threads > BWD_MAX_THREADS) return 0;
  *cpt = c;
  return threads;
}

// Launches the backward kernel over `strips` x `groups` CTAs, or, with
// `occupancy`, writes there the CTAs an SM holds at once and launches
// nothing.
template <int EPI, int CPT, bool PT>
cudaError_t bwd_run(const BwdArgs& a, int strips, int groups, int threads,
                    cudaStream_t s, int* occupancy) {
  if (occupancy != nullptr)
    return cudaOccupancyMaxActiveBlocksPerMultiprocessor(
        occupancy, more4d_rownorm_bwd_kernel<EPI, CPT, PT>, threads, 0);
  more4d_rownorm_bwd_kernel<EPI, CPT, PT>
      <<<dim3(strips, groups), threads, 0, s>>>(a);
  return cudaGetLastError();
}

template <int EPI, bool PT>
cudaError_t bwd_cpt(int cpt, const BwdArgs& a, int strips, int groups,
                    int threads, cudaStream_t s, int* occupancy) {
  if (cpt == 1)
    return bwd_run<EPI, 1, PT>(a, strips, groups, threads, s, occupancy);
  return bwd_run<EPI, BWD_MAX_CPT, PT>(a, strips, groups, threads, s,
                                       occupancy);
}

cudaError_t bwd_dispatch(int epi, bool per_token, const BwdArgs& a,
                         int strips, int groups, cudaStream_t s,
                         int* occupancy) {
  int cpt = 0;
  const int threads = bwd_config(a.D, &cpt);
  if (threads == 0) return cudaErrorInvalidValue;
  switch (epi) {
    case RMS:
      return bwd_cpt<RMS, false>(cpt, a, strips, groups, threads, s,
                                 occupancy);
    case RMS_ROPE:
      return bwd_cpt<RMS_ROPE, false>(cpt, a, strips, groups, threads, s,
                                      occupancy);
    case AFFINE:
      return bwd_cpt<AFFINE, false>(cpt, a, strips, groups, threads, s,
                                    occupancy);
    case MODULATE:
      return per_token ? bwd_cpt<MODULATE, true>(cpt, a, strips, groups,
                                                 threads, s, occupancy)
                       : bwd_cpt<MODULATE, false>(cpt, a, strips, groups,
                                                  threads, s, occupancy);
    case FILM:
      return per_token ? bwd_cpt<FILM, true>(cpt, a, strips, groups,
                                             threads, s, occupancy)
                       : bwd_cpt<FILM, false>(cpt, a, strips, groups,
                                              threads, s, occupancy);
    default:
      return cudaErrorInvalidValue;
  }
}

}  // namespace

// The chunks a thread takes (1 or 4) and the threads a CTA for rows of D
// elements; 0 threads where D is not a positive multiple of 8 or is wider
// than 4 chunks a thread of a 256-thread CTA take (D > 8192).
extern "C" int rownorm_config(int D, int* cpt) {
  if (D <= 0 || D % VEC) return 0;
  const int nc = D / VEC;
  const int c = nc > MAX_THREADS ? MAX_CPT : 1;
  const int threads = ((nc + c - 1) / c + 31) / 32 * 32;
  if (threads > MAX_THREADS) return 0;
  *cpt = c;
  return threads;
}

// One launch of K5 over `rows` rows of D bf16 elements with the epilogue
// `epi` (0 RMS, 1 RMS_ROPE, 2 AFFINE, 3 MODULATE, 4 FILM); the vectors an
// epilogue does not use may be null. w and b are bf16 where `flags` sets
// 1 and 2, else fp32; shift, scale, film and gate are bf16, mask, cos and
// sin fp32 (cos/sin [L, half], half a multiple of 4 dividing D / 2). Every
// pointer and the adaLN strides (mod_sb, mod_sl, in elements) 16-byte
// aligned. `stats`, where not null, takes each row's fp32 statistics for
// the backward: (mean, rstd) a row for AFFINE, MODULATE and FILM, rstd
// for RMS and RMS_ROPE.
// Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for an
// epilogue, a width or a row count the kernel does not take.
extern "C" int rownorm_bf16(int epi, const void* x, void* out, long long rows,
                            int L, int D, float eps, const void* w,
                            const void* b, const void* shift,
                            const void* scale, long long mod_sb,
                            long long mod_sl, const void* film,
                            const void* mask, const void* gate,
                            const void* cos, const void* sin, int half,
                            int flags, void* stats, void* stream) {
  int cpt = 0;
  const int threads = rownorm_config(D, &cpt);
  if (threads == 0 || rows <= 0 || rows > 0x7fffffffLL || L <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.out = static_cast<__nv_bfloat16*>(out);
  a.L = L;
  a.D = D;
  a.eps = eps;
  a.w = w;
  a.b = b;
  a.shift = static_cast<const __nv_bfloat16*>(shift);
  a.scale = static_cast<const __nv_bfloat16*>(scale);
  a.mod_sb = mod_sb;
  a.mod_sl = mod_sl;
  a.film = static_cast<const __nv_bfloat16*>(film);
  a.mask = static_cast<const float*>(mask);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.half = half;
  a.flags = flags;
  a.stats = static_cast<float*>(stats);
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (epi) {
    case RMS:
      return static_cast<int>(launch_cpt<RMS>(a, rows, cpt, threads, s));
    case RMS_ROPE:
      return static_cast<int>(launch_cpt<RMS_ROPE>(a, rows, cpt, threads, s));
    case AFFINE:
      return static_cast<int>(launch_cpt<AFFINE>(a, rows, cpt, threads, s));
    case MODULATE:
      return static_cast<int>(launch_cpt<MODULATE>(a, rows, cpt, threads, s));
    case FILM:
      return static_cast<int>(launch_cpt<FILM>(a, rows, cpt, threads, s));
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// The CTAs of K5's backward for `epi` at width D (per-token adaLN rows where
// `per_token`) that an SM holds at once, in *blocks: the wrapper cuts the
// rows into that many strips an SM. Returns the cudaError_t of the query.
extern "C" int rownorm_bwd_occupancy(int epi, int D, int per_token,
                                     int* blocks) {
  BwdArgs a{};
  a.D = D;
  return static_cast<int>(bwd_dispatch(epi, per_token != 0, a, 0, 0,
                                       nullptr, blocks));
}

// K5's backward for `epi` over `rows` rows of D elements in `groups` groups
// of consecutive rows (the samples where shift and scale are per sample,
// else 1), each cut into `strips` strips, one CTA a strip; then, where any
// column sum is asked for, the pass that adds up the strips' partial sums.
// x, dy and the operands as the forward took them; `stats` the forward's.
// Writes, each where its pointer is not null: dx [rows, D] bf16; per-token
// dshift and dscale [rows, D] bf16; dfilm [rows, 2D] bf16 (masked rows 0);
// the column sums sum0, sum1, sum2 (slots: RMS, RMS_ROPE dweight; AFFINE
// dweight, dbias; MODULATE, FILM per-sample dshift, dscale [groups, D],
// and FILM dgate [D]), bf16 where `sum_bf16` sets their bit, else fp32.
// `partial` holds groups x strips x slots x D floats. Returns the
// cudaError_t of the launches; 1 (cudaErrorInvalidValue) for what the
// kernel does not take.
extern "C" int rownorm_bwd_bf16(
    int epi, const void* x, const void* dy, const void* stats, void* dx,
    long long rows, int L, int groups, int strips, int D, const void* w,
    const void* shift, const void* scale, long long mod_sb, long long mod_sl,
    int per_token, const void* film, const void* mask, const void* gate,
    const void* cos, const void* sin, int half, int flags, void* dshift,
    void* dscale, void* dfilm, void* partial, void* sum0, void* sum1,
    void* sum2, int sum_bf16, void* stream) {
  if (epi < RMS || epi > FILM || rows <= 0 || L <= 0 || groups <= 0 ||
      strips <= 0 || rows % groups || groups > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  const int slots = bwd_slots(epi);
  void* sums[3] = {sum0, sum1, sum2};
  int need = 0;
  for (int q = 0; q < slots; ++q)
    if (sums[q] != nullptr) need |= 1 << q;
  if (need && partial == nullptr)
    return static_cast<int>(cudaErrorInvalidValue);
  BwdArgs a;
  a.x = static_cast<const __nv_bfloat16*>(x);
  a.dy = static_cast<const __nv_bfloat16*>(dy);
  a.stats = static_cast<const float*>(stats);
  a.dx = static_cast<__nv_bfloat16*>(dx);
  a.group_rows = rows / groups;
  a.L = L;
  a.D = D;
  a.w = w;
  a.shift = static_cast<const __nv_bfloat16*>(shift);
  a.scale = static_cast<const __nv_bfloat16*>(scale);
  a.mod_sb = mod_sb;
  a.mod_sl = mod_sl;
  a.film = static_cast<const __nv_bfloat16*>(film);
  a.mask = static_cast<const float*>(mask);
  a.gate = static_cast<const __nv_bfloat16*>(gate);
  a.cos = static_cast<const float*>(cos);
  a.sin = static_cast<const float*>(sin);
  a.half = half;
  a.flags = flags;
  a.dshift = static_cast<__nv_bfloat16*>(dshift);
  a.dscale = static_cast<__nv_bfloat16*>(dscale);
  a.dfilm = static_cast<__nv_bfloat16*>(dfilm);
  a.partial = static_cast<float*>(partial);
  a.need = need;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  cudaError_t err = bwd_dispatch(epi, per_token != 0, a, strips, groups, s,
                                 nullptr);
  if (err != cudaSuccess || !need) return static_cast<int>(err);
  SumArgs sa;
  sa.partial = a.partial;
  sa.groups = groups;
  sa.strips = strips;
  sa.slots = slots;
  sa.D = D;
  for (int q = 0; q < 3; ++q) sa.out[q] = q < slots ? sums[q] : nullptr;
  sa.bf16 = sum_bf16;
  sa.per_group = (epi == MODULATE || epi == FILM) && !per_token ? 3 : 0;
  const dim3 grid((D + 31) / 32, slots, groups);
  more4d_rownorm_bwd_sum_kernel<<<grid, dim3(32, SUM_LANES), 0, s>>>(sa);
  return static_cast<int>(cudaGetLastError());
}
