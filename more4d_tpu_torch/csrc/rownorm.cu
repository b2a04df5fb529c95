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
// aligned.
// Returns the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for an
// epilogue, a width or a row count the kernel does not take.
extern "C" int rownorm_bf16(int epi, const void* x, void* out, long long rows,
                            int L, int D, float eps, const void* w,
                            const void* b, const void* shift,
                            const void* scale, long long mod_sb,
                            long long mod_sl, const void* film,
                            const void* mask, const void* gate,
                            const void* cos, const void* sin, int half,
                            int flags, void* stream) {
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
