// Pieces shared by the flash-attention kernels for Hopper (sm_90a): the
// forward (flash_attention.cu, K1) and the backward (flash_attention_bwd.cu,
// K2 dq and K3 dk/dv). All three are bound by tensor-core operations at the
// main path's shapes and are built from the same Hopper pieces, the
// cp.async ring of swizzled tiles and the wgmma products in
// flash_sm90.cuh. What is left here is what every kernel needs around
// them: the mask value, the bf16 rounding of a pair of fp32 values (P, dS
// and every output are rounded through it, at the JAX kernels' points) and
// the once-per-device raise of a kernel's dynamic shared-memory limit.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

#include <atomic>

namespace flash {

constexpr float NEG_INF = -1e30f;

// Two floats -> one 32-bit register of two bf16, lo in the low half.
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Raise a kernel's dynamic shared-memory limit to `smem` bytes. The limit
// is a per-device attribute of the function that outlives the launch, so
// it is set on the first launch on each device only (`ready` holds one bit
// a device).
template <typename Kernel>
inline cudaError_t smem_limit_once(Kernel* kernel, int smem,
                                   std::atomic<unsigned>& ready) {
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return err;
  if (dev >= 32) return cudaErrorInvalidDevice;
  if (!(ready.load() & (1u << dev))) {
    err = cudaFuncSetAttribute(kernel,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               smem);
    if (err != cudaSuccess) return err;
    ready.fetch_or(1u << dev);
  }
  return cudaSuccess;
}

}  // namespace flash
