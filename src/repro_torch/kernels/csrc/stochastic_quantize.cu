// Send half of a quantized gossip round for Hopper:
//   u     = (m - h - lo[i]) / scale[i]
//   lvl   = min(floor(u) + (rnd < u - floor(u)), levels)     (uint8)
//   h_new = (h + lo[i]) + lvl * scale[i]                    (over h)
//
// Replaces the Pallas TPU kernel `stochastic_quantize_pallas`
// (src/repro/kernels/gossip_combine.py).  m, h and rnd are (n, d) fp32 row
// stacks (one row per worker), lo and scale the (n,) row grids; the level
// plane is (n, d) uint8 and the updated public replica is written over h.
//
// Bound: device memory.  An element reads 12 bytes and writes 5 for a
// handful of flops.  Block (x, y) takes one span of kThreads * kIlp
// columns of row y, and x runs fastest, so the resident blocks walk one
// row of each operand at a time, as PyTorch's elementwise kernels walk a
// flat buffer (with the row on the fast axis, all n rows of every operand
// streamed at once and the kernel reached half the rate).  Accesses are
// scalar and coalesced: the rows are d = P + 1 elements long, an odd
// length, so rows are not 4- or 16-byte aligned for vector accesses.  h is
// written in place, so the compiler may not move one element's loads above
// another's stores: each thread loads its kIlp elements, a block apart,
// before it stores any.  Every subtract, divide, multiply and add rounds
// on its own (no FMA contraction, and a true division, not a reciprocal):
// one changed rounding would move u across a threshold and flip a
// stochastic level.  h_new may alias h: each element is read and then
// written by one thread only, so h carries no __restrict__.  Offsets are
// 64-bit (n * d is past 2^31).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kIlp = 4;  // elements per thread, loaded together
constexpr int64_t kSpan = kThreads * kIlp;

__global__ void __launch_bounds__(kThreads) stochastic_quantize_kernel(
    const float* __restrict__ m, const float* h,
    const float* __restrict__ rnd, const float* __restrict__ lo,
    const float* __restrict__ scale, uint8_t* __restrict__ lvl_out,
    float* h_out, float levels, int64_t d) {
  const float lo_r = lo[blockIdx.y];
  const float sc_r = scale[blockIdx.y];
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kSpan + threadIdx.x;
  const int64_t at = static_cast<int64_t>(blockIdx.y) * d + c0;
  float mv[kIlp], hv[kIlp], rv[kIlp];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    if (c0 + j * kThreads < d) {
      mv[j] = m[at + j * kThreads];
      hv[j] = h[at + j * kThreads];
      rv[j] = rnd[at + j * kThreads];
    }
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    if (c0 + j * kThreads < d) {
      const float u =
          __fdiv_rn(__fsub_rn(__fsub_rn(mv[j], hv[j]), lo_r), sc_r);
      const float fl = floorf(u);
      float lv = rv[j] < __fsub_rn(u, fl) ? __fadd_rn(fl, 1.0f) : fl;
      lv = fminf(lv, levels);
      lvl_out[at + j * kThreads] = static_cast<uint8_t>(lv);
      h_out[at + j * kThreads] =
          __fadd_rn(__fadd_rn(hv[j], lo_r), __fmul_rn(lv, sc_r));
    }
  }
}

}  // namespace

// m, h, rnd: (n, d) fp32 on the card; lo, scale: (n,) fp32 on the card;
// lvl_out: (n, d) uint8; h_out: (n, d) fp32, may be h itself.
extern "C" int stochastic_quantize_f32(const void* m, const void* h,
                                       const void* rnd, const void* lo,
                                       const void* scale, void* lvl_out,
                                       void* h_out, float levels, int n,
                                       int64_t d, void* stream) {
  if (n < 1 || n > 65535) return static_cast<int>(cudaErrorInvalidValue);
  if (d <= 0) return 0;
  const int64_t spans = (d + kSpan - 1) / kSpan;
  if (spans > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(spans), static_cast<unsigned>(n));
  stochastic_quantize_kernel<<<grid, kThreads, 0,
                               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const float*>(h),
      static_cast<const float*>(rnd), static_cast<const float*>(lo),
      static_cast<const float*>(scale), static_cast<uint8_t*>(lvl_out),
      static_cast<float*>(h_out), levels, d);
  return static_cast<int>(cudaGetLastError());
}
