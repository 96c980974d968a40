// Fused dual-averaging prox (paper eq. 7) for Hopper:
//   out = w0 - z * (0.5 / beta).
//
// Replaces the Pallas TPU kernel `dual_update_pallas`
// (src/repro/kernels/dual_update.py).  z is the fp32 dual, w0 the prox
// anchor in fp32 or bf16, out the fp32 primal.  One element needs 4 + 4 + 4
// (or 4 + 2 + 4) bytes and two flops, so the kernel is bound by device
// memory bandwidth, and the design keeps enough bytes in flight to cover
// the memory's latency:
//   * 16-byte vectors: z and out move as float4, w0 as float4 (fp32) or
//     4 bf16 in 8 bytes;
//   * each thread issues kUnroll = 4 vectors of every operand before its
//     first store;
//   * one block per kThreads x kUnroll vectors, all launched at once: on
//     the H100 a grid of only the resident threads (SMs x 2048 / 256
//     blocks) striding over the vectors was 3 to 5% slower at the embed
//     leaf, and below `torch.add` (PERF.md, Findings);
//   * streaming cache hints (ld.global.cs / st.global.cs): nothing is
//     reused.
// Ragged edges: z and out 16-byte aligned and w0 16-byte (bf16: 8-byte)
// aligned take the vectors, and a scalar tail covers the count past the
// last whole vector; any other start (a per-worker dual view z[k][i] whose
// leaf size is not a multiple of 4) takes a scalar loop.  The wrapper
// allocates out, so only z's and w0's starts decide.  Offsets are 64-bit:
// the gossip path's per-worker dual is past 2^31 elements.  The
// subtract and the multiply round separately (no FMA contraction), as the
// TPU kernel computes them, so the results are bit-identical to a plain
// elementwise loop.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kUnroll = 4;           // vectors of each operand in flight

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ float prox(float w0, float z, float h) {
  return __fsub_rn(w0, __fmul_rn(z, h));
}

// Four w0 values from one vector: a float4, or 4 bf16 in a uint2.
template <typename T>
struct W4;

template <>
struct W4<float> {
  using V = float4;
  static __device__ __forceinline__ V load(const float* p) {
    return __ldcs(reinterpret_cast<const float4*>(p));
  }
  static __device__ __forceinline__ float4 unpack(const V w) { return w; }
};

template <>
struct W4<__nv_bfloat16> {
  using V = uint2;
  static __device__ __forceinline__ V load(const __nv_bfloat16* p) {
    return __ldcs(reinterpret_cast<const uint2*>(p));
  }
  static __device__ __forceinline__ float4 unpack(const V w) {
    return make_float4(__uint_as_float(w.x << 16),
                       __uint_as_float(w.x & 0xffff0000u),
                       __uint_as_float(w.y << 16),
                       __uint_as_float(w.y & 0xffff0000u));
  }
};

// The nvec = n / 4 whole vectors kUnroll at a time per thread, then the
// elements [4 nvec, n) one at a time.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_update_vec(const float* __restrict__ z, const T* __restrict__ w0,
                    float* __restrict__ out, float h, int64_t n) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * kThreads +
                      threadIdx.x;
  const int64_t nvec = n / 4;
  const float4* zv = reinterpret_cast<const float4*>(z);
  float4* ov = reinterpret_cast<float4*>(out);
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll +
                      threadIdx.x;
       base < nvec; base += step) {
    float4 zr[kUnroll];
    typename W4<T>::V wr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i < nvec) {
        zr[u] = __ldcs(zv + i);
        wr[u] = W4<T>::load(w0 + 4 * i);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i < nvec) {
        const float4 w = W4<T>::unpack(wr[u]);
        __stcs(ov + i, make_float4(prox(w.x, zr[u].x, h),
                                   prox(w.y, zr[u].y, h),
                                   prox(w.z, zr[u].z, h),
                                   prox(w.w, zr[u].w, h)));
      }
    }
  }
  // the scalar tail: at most 3 elements
  const int64_t tail0 = 4 * nvec;
  if (tid < n - tail0)
    out[tail0 + tid] = prox(to_f32(w0[tail0 + tid]), z[tail0 + tid], h);
}

// Misaligned views: one element at a time, kUnroll loads in flight.
template <typename T>
__global__ void __launch_bounds__(kThreads)
    dual_update_scalar(const float* __restrict__ z, const T* __restrict__ w0,
                       float* __restrict__ out, float h, int64_t n) {
  const int64_t step = static_cast<int64_t>(gridDim.x) * kThreads * kUnroll;
  for (int64_t base = static_cast<int64_t>(blockIdx.x) * kThreads * kUnroll +
                      threadIdx.x;
       base < n; base += step) {
    float zr[kUnroll], wr[kUnroll];
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i < n) {
        zr[u] = __ldcs(z + i);
        wr[u] = to_f32(w0[i]);
      }
    }
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const int64_t i = base + static_cast<int64_t>(u) * kThreads;
      if (i < n) __stcs(out + i, prox(wr[u], zr[u], h));
    }
  }
}

bool aligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes == 0;
}

// One block per kThreads x kUnroll items (at least one block; the loops
// stride past the grid's limit).
unsigned blocks_for(int64_t items) {
  const int64_t per = kThreads * kUnroll;
  const int64_t blocks = (items + per - 1) / per;
  return static_cast<unsigned>(blocks < 1 ? 1 : (blocks > 0x7fffffff
                                                     ? 0x7fffffff
                                                     : blocks));
}

template <typename T>
int launch(const void* z, const void* w0, void* out, float beta, int64_t n,
           void* stream) {
  if (n <= 0) return 0;
  const float half_inv_beta = 0.5f / beta;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (aligned(z, 16) && aligned(out, 16) && aligned(w0, 4 * sizeof(T))) {
    dual_update_vec<T><<<blocks_for(n / 4), kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const T*>(w0),
        static_cast<float*>(out), half_inv_beta, n);
  } else {
    dual_update_scalar<T><<<blocks_for(n), kThreads, 0, s>>>(
        static_cast<const float*>(z), static_cast<const T*>(w0),
        static_cast<float*>(out), half_inv_beta, n);
  }
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
