// fp8 (e4m3) weights widened to bf16 or fp32 for Hopper (sm_90a): K6.
//
// Replaces no TPU kernel: the JAX package's fp8 kernels are promoted to the
// compute dtype inside the XLA graph, which fuses the cast into the read of
// the product's operand. The port widens each fp8 weight once a forward,
// before its product (nn/layers.py compute_param), and PyTorch's generic
// cast kernel does that at about a quarter of the card's bandwidth: one
// byte a thread, the e4m3 decode in software. This kernel is the same
// function as its plain version in more4d_tpu_torch/kernels/widen.py:
//
//   unscaled  y = out(float(q))                    (p.to(out))
//   scaled    y = out(bf16_rn(float(q) * scale))   ((p.float() * scale)
//                                                   .to(torch.bfloat16)
//                                                   .to(out))
//
// with out bf16 (the DiT's products) or fp32 (its time embedding), and
// scale the fp32 scalar beside the weight, read on the card (the host never
// waits for it). Every finite e4m3 value, subnormals included, is exact in
// f16, f32 and bf16, so the unscaled output is the plain version's bits;
// the scaled one rounds the fp32 product once to bf16 with round to nearest
// even, as the plain version does, and fp32 widens that exactly. The two
// NaN codes (0x7f, 0xff) come out as the plain version's NaNs: through
// bf16, the NaN that cvt.rn.bf16x2.f32 gives, the instruction behind
// PyTorch's own float -> bf16 on the card; unscaled to fp32, the sign and
// 0x7ff00000, PyTorch's e4m3 -> float.
//
// What bounds it on the H100: 1 byte read and 2 (4) written an element and
// a handful of operations for 3 (5) bytes, so only bytes count. The design:
//   - loads of the fp8 values one 16-byte store takes: 8 bytes for bf16,
//     4 for fp32; each pair decoded by the hardware (cvt.rn.f16x2.e4m3x2),
//     widened to f32 (and scaled), and for bf16 packed to bf16x2
//     (cvt.rn.bf16x2.f32); so a warp's stores are 512 contiguous bytes
//     (its bf16 loads 256). For bf16, 16-byte loads, each lane then
//     writing 32 bytes in two stores that each cover half of every sector
//     the warp touches, ran at 0.0998 ms against 0.0755 at [13824, 5120]
//     (64% and 84% of the byte bound; H100 SXM, 700 W), the same grid
//     sizing;
//   - UNROLL loads of a thread in flight before its first store, in one
//     pass: a CTA of THREADS takes THREADS * UNROLL consecutive vectors and
//     the grid covers the tensor (a grid-stride loop over one wave of
//     resident CTAs measured no faster);
//   - the loads stream past the caches (ld.global.cs), so the output,
//     which the product reads next, keeps L2;
//   - a start that is not aligned to the load is widened element by
//     element up to the first aligned one, and so is the tail past the
//     last whole vector; where the output cannot then align with the input
//     (an input start not aligned to the load against a 16-byte aligned
//     output) every element goes the scalar way. A parameter from
//     PyTorch's allocator and a view of the streamed blocks' flat buffers
//     (256-byte offsets, parallel/offload.py) take the vector path whole.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_fp8.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int UNROLL = 4;  // loads in flight a thread

// The load that fills one 16-byte store: 8 fp8 values for bf16, 4 for fp32.
template <bool F32>
struct Vec {
  using Out = __nv_bfloat16;
  using Load = uint2;
  static constexpr int N = 8;
};
template <>
struct Vec<true> {
  using Out = float;
  using Load = uint32_t;
  static constexpr int N = 4;
};

template <bool SCALED>
__device__ __forceinline__ float2 decode_pair(uint32_t pair, float s) {
  const __half2_raw h = __nv_cvt_fp8x2_to_halfraw2(
      static_cast<__nv_fp8x2_storage_t>(pair), __NV_E4M3);
  float2 f = __half22float2(__half2(h));
  if (SCALED) {
    f.x = __fmul_rn(f.x, s);
    f.y = __fmul_rn(f.y, s);
  }
  return f;
}

template <bool SCALED>
__device__ __forceinline__ float decode_one(uint32_t q, float s) {
  const __half_raw h = __nv_cvt_fp8_to_halfraw(
      static_cast<__nv_fp8_storage_t>(q), __NV_E4M3);
  const float f = __half2float(__half(h));
  return SCALED ? __fmul_rn(f, s) : f;
}

__device__ __forceinline__ uint32_t bf16x2_bits(float2 f) {
  const __nv_bfloat162 b = __float22bfloat162_rn(f);
  return *reinterpret_cast<const uint32_t*>(&b);
}

// Code q, decoded (and scaled) to f, in fp32 as the plain version gives it:
// scaled, the product rounded to bf16 and widened back; unscaled, f, and
// the NaN codes as PyTorch's e4m3 -> float (the sign, then 0x7ff00000).
template <bool SCALED>
__device__ __forceinline__ float as_f32(uint32_t q, float f) {
  if (SCALED) return __bfloat162float(__float2bfloat16_rn(f));
  return (q & 0x7fu) == 0x7fu
             ? __uint_as_float(((q & 0x80u) << 24) | 0x7ff00000u)
             : f;
}

template <bool SCALED>
__device__ __forceinline__ uint4 widen_vec(uint2 v, float s) {
  return make_uint4(bf16x2_bits(decode_pair<SCALED>(v.x & 0xffffu, s)),
                    bf16x2_bits(decode_pair<SCALED>(v.x >> 16, s)),
                    bf16x2_bits(decode_pair<SCALED>(v.y & 0xffffu, s)),
                    bf16x2_bits(decode_pair<SCALED>(v.y >> 16, s)));
}

template <bool SCALED>
__device__ __forceinline__ uint4 widen_vec(uint32_t v, float s) {
  const float2 a = decode_pair<SCALED>(v & 0xffffu, s);
  const float2 b = decode_pair<SCALED>(v >> 16, s);
  return make_uint4(__float_as_uint(as_f32<SCALED>(v & 0xffu, a.x)),
                    __float_as_uint(as_f32<SCALED>((v >> 8) & 0xffu, a.y)),
                    __float_as_uint(as_f32<SCALED>((v >> 16) & 0xffu, b.x)),
                    __float_as_uint(as_f32<SCALED>(v >> 24, b.y)));
}

template <bool SCALED>
__device__ __forceinline__ void widen_one(uint8_t q, float s,
                                          __nv_bfloat16* y) {
  *y = __float2bfloat16_rn(decode_one<SCALED>(q, s));
}

template <bool SCALED>
__device__ __forceinline__ void widen_one(uint8_t q, float s, float* y) {
  *y = as_f32<SCALED>(q, decode_one<SCALED>(q, s));
}

// Elements [head, head + N * nvec) of src go by whole vectors (src + head
// aligned to the load and dst + head to 16 bytes), the rest, [0, head) and
// past the last vector up to n, one at a time.
template <bool F32, bool SCALED>
__global__ void __launch_bounds__(THREADS)
    more4d_widen_fp8_kernel(const uint8_t* __restrict__ src,
                            typename Vec<F32>::Out* __restrict__ dst,
                            long long head, long long nvec, long long n,
                            const float* __restrict__ scale) {
  using Load = typename Vec<F32>::Load;
  const float s = SCALED ? __ldg(scale) : 1.0f;
  const Load* in = reinterpret_cast<const Load*>(src + head);
  uint4* out = reinterpret_cast<uint4*>(dst + head);
  const long long i0 =
      static_cast<long long>(blockIdx.x) * THREADS * UNROLL + threadIdx.x;
  Load v[UNROLL];
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = i0 + u * THREADS;
    if (i < nvec) v[u] = __ldcs(in + i);
  }
#pragma unroll
  for (int u = 0; u < UNROLL; ++u) {
    const long long i = i0 + u * THREADS;
    if (i < nvec) out[i] = widen_vec<SCALED>(v[u], s);
  }
  const long long body_end = head + Vec<F32>::N * nvec;
  const long long rest = head + (n - body_end);
  const long long total = static_cast<long long>(gridDim.x) * THREADS;
  for (long long r = static_cast<long long>(blockIdx.x) * THREADS +
                     threadIdx.x;
       r < rest; r += total) {
    const long long i = r < head ? r : body_end + (r - head);
    widen_one<SCALED>(src[i], s, dst + i);
  }
}

template <bool F32>
int launch(const void* src, void* dst, long long n, const void* scale,
           cudaStream_t st) {
  using Out = typename Vec<F32>::Out;
  constexpr int N = Vec<F32>::N;
  const uintptr_t a = reinterpret_cast<uintptr_t>(src);
  const uintptr_t b = reinterpret_cast<uintptr_t>(dst);
  long long head = static_cast<long long>((N - a % N) % N);
  if (head > n) head = n;
  long long nvec = (n - head) / N;
  if ((b + sizeof(Out) * head) % 16 != 0) {
    head = n;
    nvec = 0;
  }
  const long long rest = n - N * nvec;
  long long blocks = (nvec + THREADS * UNROLL - 1) / (THREADS * UNROLL);
  if (blocks < (rest + THREADS - 1) / THREADS)
    blocks = (rest + THREADS - 1) / THREADS;
  if (blocks > 0x7fffffffLL) return static_cast<int>(cudaErrorInvalidValue);
  const uint8_t* in = static_cast<const uint8_t*>(src);
  Out* out = static_cast<Out*>(dst);
  const unsigned grid = static_cast<unsigned>(blocks);
  if (scale != nullptr) {
    more4d_widen_fp8_kernel<F32, true><<<grid, THREADS, 0, st>>>(
        in, out, head, nvec, n, static_cast<const float*>(scale));
  } else {
    more4d_widen_fp8_kernel<F32, false><<<grid, THREADS, 0, st>>>(
        in, out, head, nvec, n, nullptr);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// One launch of K6: the n fp8 (e4m3) values at src widened to bf16 (f32 =
// 0) or fp32 (f32 = 1) at dst (n elements, not overlapping src), through
// the fp32 scalar at `scale` where it is not null, on `stream`. Any
// alignment. Returns the cudaError_t of the launch; 1
// (cudaErrorInvalidValue) for a negative length or one past what a grid
// holds.
extern "C" int widen_fp8(const void* src, void* dst, long long n, int f32,
                         const void* scale, void* stream) {
  if (n < 0) return static_cast<int>(cudaErrorInvalidValue);
  if (n == 0) return 0;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return f32 ? launch<true>(src, dst, n, scale, st)
             : launch<false>(src, dst, n, scale, st);
}
