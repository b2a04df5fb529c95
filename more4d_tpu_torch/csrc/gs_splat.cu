// Tile splat rasteriser for Hopper (sm_90a), fp32: K4.
//
// Replaces the TPU kernel more4d_tpu/kernels/gs_splat.py:121
// (_splat_kernel; host prep _tile_records :45, entry gs_render_tiled
// :175). Same function: for every 16x16 pixel tile, composite the tile's
// depth-sorted isotropic Gaussian records front to back,
//   w_k = min(o_k * exp(-0.5 * d2 / (s_k * s_k)), 0.9999)
//   T_k = prod_{j<k} (1 - w_j)       (the TPU kernel's exp(excl. cumsum
//                                     log1p(-w)), which it needed only
//                                     because cumsum does not lower in
//                                     Pallas; the product is the same
//                                     quantity up to rounding)
//   colour = sum_k w_k T_k c_k,  alpha = sum_k w_k T_k,
// then blend the background: image = colour + background * (1 - alpha).
// Every record up to the tile's count is composited, in depth order: no
// cull, no early termination (the TPU kernel has neither); the records
// past the count are padding with zero opacity that would add nothing.
//
// What bounds it on the H100: per (record, pixel) pair one exp and ~12
// fp32 operations; a 49-frame trajectory at the main path's 368x512 has
// ~4.7e9 pairs against a few tens of MB of records and images, so it is
// bound by the fp32 issue rate (and the SFU's exp2 at 16 a clock a SM,
// against 128 fp32 lanes). The design keeps the pair loop to that:
//   - the per-record terms are formed once, while the CTA stages its
//     tile's records: the exponent coefficient c_k = -0.5 log2(e) / s_k^2,
//     so that w_k = min(o_k * exp2(c_k * d2), 0.9999) needs no division,
//     and the records packed as float4 (u, v, c, o) and a float4 of
//     colours (C <= 4), two 16-byte shared loads a record;
//   - exp2 is the SFU's ex2.approx.ftz (relative error below 2^-22, ~2.4e-7,
//     against ~1 ulp for expf); with c_k * d2 rounded twice instead of
//     -0.5 * d2 / s^2 three times, a weight moves by at most ~1e-6
//     absolute (w * ln2 * |c d2| * 3e-7 peaks at |c d2| = 1 / ln 2), far
//     under the 1e-4 the comparison with the plain version allows;
//   - PPT pixels a thread, one column of the tile at rows y, y + 16 / PPT,
//     ...: each record read from shared memory feeds PPT pairs, dx^2 is
//     shared by them, and their transmittance chains run side by side.
// One CTA per (tile, frame) of NPIX / PPT threads.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int PPT = 4;            // pixels a thread (divides TILE)
constexpr int NT = NPIX / PPT;    // threads a CTA
constexpr int MAX_C = 4;
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float ex2_approx(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;" : "=f"(y) : "f"(x));
  return y;
}

template <int C>
__global__ void __launch_bounds__(NT)
splat_kernel(const float* __restrict__ ru, const float* __restrict__ rv,
             const float* __restrict__ rs, const float* __restrict__ ro,
             const float* __restrict__ rc, const int* __restrict__ counts,
             float* __restrict__ img, float* __restrict__ alpha_out,
             int num_tiles, int tiles_x, int K, int H, int W,
             float background) {
  extern __shared__ float4 sm[];
  float4* srec = sm;      // [K] (u, v, c, o)
  float4* scol = sm + K;  // [K] colours, zero past C

  const int tile = blockIdx.x;
  const long long frame = blockIdx.y;
  const long long rec = frame * num_tiles + tile;
  const int n = min(counts[rec], K);
  const float* u = ru + rec * K;
  const float* v = rv + rec * K;
  const float* s = rs + rec * K;
  const float* o = ro + rec * K;
  const float* c = rc + rec * K * C;
  for (int i = threadIdx.x; i < n; i += NT) {
    const float sk = s[i];
    const float coef = -0.5f * kLog2e / (sk * sk);
    srec[i] = make_float4(u[i], v[i], coef, o[i]);
    float col[MAX_C] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int ch = 0; ch < C; ++ch) col[ch] = c[i * C + ch];
    scol[i] = make_float4(col[0], col[1], col[2], col[3]);
  }
  __syncthreads();

  const int ix = (tile % tiles_x) * TILE + threadIdx.x % TILE;
  const int iy0 = (tile / tiles_x) * TILE + threadIdx.x / TILE;
  constexpr int DY = TILE / PPT;  // rows between a thread's pixels
  const float px = static_cast<float>(ix) + 0.5f;
  float py[PPT], trans[PPT], alpha[PPT], acc[PPT][C];
#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    py[p] = static_cast<float>(iy0 + p * DY) + 0.5f;
    trans[p] = 1.f;
    alpha[p] = 0.f;
#pragma unroll
    for (int ch = 0; ch < C; ++ch) acc[p][ch] = 0.f;
  }

  for (int k = 0; k < n; ++k) {
    const float4 r = srec[k];
    const float4 cv = scol[k];
    const float col[MAX_C] = {cv.x, cv.y, cv.z, cv.w};
    const float dx = px - r.x;
    const float dx2 = dx * dx;
#pragma unroll
    for (int p = 0; p < PPT; ++p) {
      const float dy = py[p] - r.y;
      const float d2 = dx2 + dy * dy;
      const float w = fminf(r.w * ex2_approx(r.z * d2), 0.9999f);
      const float contrib = w * trans[p];
#pragma unroll
      for (int ch = 0; ch < C; ++ch) acc[p][ch] += contrib * col[ch];
      alpha[p] += contrib;
      trans[p] *= 1.f - w;
    }
  }

#pragma unroll
  for (int p = 0; p < PPT; ++p) {
    const long long pix = (frame * H + iy0 + p * DY) * W + ix;
#pragma unroll
    for (int ch = 0; ch < C; ++ch)
      img[pix * C + ch] = acc[p][ch] + background * (1.f - alpha[p]);
    alpha_out[pix] = alpha[p];
  }
}

template <int C>
int launch(const void* ru, const void* rv, const void* rs, const void* ro,
           const void* rc, const void* counts, void* img, void* alpha,
           int frames, int num_tiles, int tiles_x, int K, int H, int W,
           float background, cudaStream_t stream) {
  const int smem = K * 2 * static_cast<int>(sizeof(float4));
  // The shared-memory limit is a per-device attribute of the function that
  // outlives the launch: raise it only when a launch needs more than any
  // earlier one on this device.
  static std::atomic<int> limit[32] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 32) return static_cast<int>(cudaErrorInvalidDevice);
  if (smem > limit[dev].load()) {
    static std::mutex mu;
    std::lock_guard<std::mutex> hold(mu);
    if (smem > limit[dev].load()) {
      err = cudaFuncSetAttribute(
          splat_kernel<C>, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit[dev].store(smem);
    }
  }
  dim3 grid(num_tiles, frames);
  splat_kernel<C><<<grid, NT, smem, stream>>>(
      static_cast<const float*>(ru), static_cast<const float*>(rv),
      static_cast<const float*>(rs), static_cast<const float*>(ro),
      static_cast<const float*>(rc), static_cast<const int*>(counts),
      static_cast<float*>(img), static_cast<float*>(alpha), num_tiles,
      tiles_x, K, H, W, background);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// Records are [F, num_tiles, K] (colours [F, num_tiles, K, C]), counts
// [F, num_tiles]; outputs image [F, H, W, C] and alpha [F, H, W]. Returns
// the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for C outside
// 1 to 4.
extern "C" int splat_fwd_f32(const void* ru, const void* rv, const void* rs,
                             const void* ro, const void* rc,
                             const void* counts, void* img, void* alpha,
                             int frames, int num_tiles, int tiles_x, int K,
                             int H, int W, int C, float background,
                             void* stream) {
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (C) {
    case 1:
      return launch<1>(ru, rv, rs, ro, rc, counts, img, alpha, frames,
                       num_tiles, tiles_x, K, H, W, background, s);
    case 2:
      return launch<2>(ru, rv, rs, ro, rc, counts, img, alpha, frames,
                       num_tiles, tiles_x, K, H, W, background, s);
    case 3:
      return launch<3>(ru, rv, rs, ro, rc, counts, img, alpha, frames,
                       num_tiles, tiles_x, K, H, W, background, s);
    case 4:
      return launch<4>(ru, rv, rs, ro, rc, counts, img, alpha, frames,
                       num_tiles, tiles_x, K, H, W, background, s);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
