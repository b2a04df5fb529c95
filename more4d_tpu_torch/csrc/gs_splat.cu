// Tile splat rasteriser for Hopper (sm_90a), fp32.
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
//
// Layout: one CTA per (tile, frame), 256 threads, one thread per pixel.
// The CTA stages its tile's records (u, v, sigma, opacity, C colours; 7 x
// 4 B each at C = 3, 14 KB at K = 512) in shared memory, then every thread
// walks them in depth order carrying its transmittance. There is no early
// termination (the TPU kernel has none, and skipping records would change
// the numbers); the walk stops at the tile's record count, past which the
// records are padding with zero opacity that add exactly nothing.
//
// What bounds it: per frame ~1e8 (record, pixel) pairs at the main path's
// 368x512 with 188,416 points, each one exp (SFU) and ~15 fp32 operations;
// the record and image bytes are a few MB. It is bound by operations.

#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>
#include <mutex>

namespace {

constexpr int TILE = 16;
constexpr int NPIX = TILE * TILE;
constexpr int MAX_C = 4;

__global__ void __launch_bounds__(NPIX)
splat_kernel(const float* __restrict__ ru, const float* __restrict__ rv,
             const float* __restrict__ rs, const float* __restrict__ ro,
             const float* __restrict__ rc, const int* __restrict__ counts,
             float* __restrict__ img, float* __restrict__ alpha_out,
             int num_tiles, int tiles_x, int K, int H, int W, int C,
             float background) {
  extern __shared__ float sm[];
  float* su = sm;
  float* sv = su + K;
  float* ss = sv + K;
  float* so = ss + K;
  float* sc = so + K;  // [K][C]

  const int tile = blockIdx.x;
  const long long frame = blockIdx.y;
  const long long rec = frame * num_tiles + tile;
  const int n = min(counts[rec], K);
  const float* u = ru + rec * K;
  const float* v = rv + rec * K;
  const float* s = rs + rec * K;
  const float* o = ro + rec * K;
  const float* c = rc + rec * K * C;
  for (int i = threadIdx.x; i < n; i += NPIX) {
    su[i] = u[i];
    sv[i] = v[i];
    ss[i] = s[i];
    so[i] = o[i];
  }
  for (int i = threadIdx.x; i < n * C; i += NPIX) sc[i] = c[i];
  __syncthreads();

  const int ix = (tile % tiles_x) * TILE + threadIdx.x % TILE;
  const int iy = (tile / tiles_x) * TILE + threadIdx.x / TILE;
  const float px = static_cast<float>(ix) + 0.5f;
  const float py = static_cast<float>(iy) + 0.5f;

  float trans = 1.f, alpha = 0.f;
  float acc[MAX_C] = {0.f, 0.f, 0.f, 0.f};
  for (int k = 0; k < n; ++k) {
    const float dx = px - su[k];
    const float dy = py - sv[k];
    const float d2 = dx * dx + dy * dy;
    const float sk = ss[k];
    float w = so[k] * expf(-0.5f * d2 / (sk * sk));
    w = fminf(w, 0.9999f);
    const float contrib = w * trans;
#pragma unroll
    for (int ch = 0; ch < MAX_C; ++ch)
      if (ch < C) acc[ch] += contrib * sc[k * C + ch];
    alpha += contrib;
    trans *= 1.f - w;
  }

  const long long pix = (frame * H + iy) * W + ix;
#pragma unroll
  for (int ch = 0; ch < MAX_C; ++ch)
    if (ch < C) img[pix * C + ch] = acc[ch] + background * (1.f - alpha);
  alpha_out[pix] = alpha;
}

}  // namespace

// Records are [F, num_tiles, K] (colours [F, num_tiles, K, C]), counts
// [F, num_tiles]; outputs image [F, H, W, C] and alpha [F, H, W]. Returns
// the cudaError_t of the launch; 1 (cudaErrorInvalidValue) for C > 4.
extern "C" int splat_fwd_f32(const void* ru, const void* rv, const void* rs,
                             const void* ro, const void* rc,
                             const void* counts, void* img, void* alpha,
                             int frames, int num_tiles, int tiles_x, int K,
                             int H, int W, int C, float background,
                             void* stream) {
  if (C < 1 || C > MAX_C) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = K * (4 + C) * static_cast<int>(sizeof(float));
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
          splat_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
      if (err != cudaSuccess) return static_cast<int>(err);
      limit[dev].store(smem);
    }
  }
  dim3 grid(num_tiles, frames);
  splat_kernel<<<grid, NPIX, smem, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(ru), static_cast<const float*>(rv),
      static_cast<const float*>(rs), static_cast<const float*>(ro),
      static_cast<const float*>(rc), static_cast<const int*>(counts),
      static_cast<float*>(img), static_cast<float*>(alpha), num_tiles,
      tiles_x, K, H, W, C, background);
  return static_cast<int>(cudaGetLastError());
}
