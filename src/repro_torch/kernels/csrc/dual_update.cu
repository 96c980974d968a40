// Fused dual-averaging prox (paper eq. 7) for Hopper:
//   out = w0 - z * (0.5 / beta).
//
// Replaces the Pallas TPU kernel `dual_update_pallas`
// (src/repro/kernels/dual_update.py).  z is the fp32 dual, w0 the prox
// anchor in fp32 or bf16, out the fp32 primal.  One element needs 4 + 4 + 4
// (or 4 + 2 + 4) bytes and two flops, so the kernel is bound by device
// memory bandwidth: the design is a plain grid-stride loop with coalesced
// scalar loads and one store per element, nothing staged in shared memory.
// Offsets are 64-bit: the gossip path's per-worker dual is past 2^31
// elements.  The subtract and the multiply round separately (no FMA
// contraction), as the TPU kernel computes them.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

template <typename T>
__global__ void dual_update_kernel(const float* __restrict__ z,
                                   const T* __restrict__ w0,
                                   float* __restrict__ out, float half_inv_beta,
                                   int64_t n) {
  const int64_t stride = static_cast<int64_t>(blockDim.x) * gridDim.x;
  for (int64_t i = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
       i < n; i += stride) {
    out[i] = __fsub_rn(to_f32(w0[i]), __fmul_rn(z[i], half_inv_beta));
  }
}

constexpr int kThreads = 256;
constexpr int64_t kMaxBlocks = 132 * 32;  // 32 resident blocks per SM

template <typename T>
int launch(const void* z, const void* w0, void* out, float beta, int64_t n,
           void* stream) {
  if (n <= 0) return 0;
  int64_t blocks = (n + kThreads - 1) / kThreads;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const float half_inv_beta = 0.5f / beta;
  dual_update_kernel<T><<<static_cast<unsigned>(blocks), kThreads, 0,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(z), static_cast<const T*>(w0),
      static_cast<float*>(out), half_inv_beta, n);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" int dual_update_f32(const void* z, const void* w0, void* out,
                               float beta, int64_t n, void* stream) {
  return launch<float>(z, w0, out, beta, n, stream);
}

extern "C" int dual_update_bf16(const void* z, const void* w0, void* out,
                                float beta, int64_t n, void* stream) {
  return launch<__nv_bfloat16>(z, w0, out, beta, n, stream);
}
