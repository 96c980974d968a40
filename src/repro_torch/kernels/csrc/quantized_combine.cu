// Receive half of a quantized gossip round for Hopper:
//   hnbr_new[k-1, i, :] = (hnbr[k-1, i, :] + lo[s]) + lvl[s, :] * scale[s]
//   out[i, :]           = w[0] * m[i, :] + sum_{k>=1} w[k] * hnbr_new[k-1, i, :]
// with s = src[k][i], the row of the level plane that tap k of output row
// i reads.  m, hnbr and out have n_out rows; lvl, lo and scale n_src rows.
// A process holding every worker passes n_out = n_src = n and the (K, n)
// tap table; a process per worker passes its one row (n_out = 1), the K
// level rows it holds (its own first, then the K - 1 it received, in tap
// order) and the (K, 1) table [[0], [1], ..., [K-1]].
//
// Replaces the Pallas TPU kernel `quantized_combine_pallas`
// (src/repro/kernels/gossip_combine.py) together with the tap rolls that
// feed it (`taps.take` of the level plane and the grid scalars in
// `QuantizedGossipConsensus.combine`, src/repro/dist/consensus.py).  On the
// TPU each neighbour's level plane is rolled into a (K-1, n, d) uint8
// stack; on one card the kernel reads the (n, d) plane every worker sent
// this round in place, through the (K, n) source-row table.
//
// Bound: device memory.  For ring n = 4, K = 3 an element reads m, two
// replicas and the level plane (13 bytes) and writes out and two replicas
// (12 bytes); 4 K flops are nothing beside that.  Block (x, y) takes one
// span of kThreads * kIlp columns of worker row i = y, and x runs fastest,
// so the resident blocks walk one row of each operand at a time (with the
// row on the fast axis, all n rows of every operand streamed at once and
// the kernel reached half the rate).  A block copies its row's K source
// rows and their grid scalars into shared memory first.  Rows are d = P +
// 1 elements long, an odd length, so the kernel uses scalar coalesced
// accesses.  out may alias m and the replicas are updated in place: each
// element is read and then written by one thread only, so m, the replicas
// and out carry no __restrict__, and the compiler may not move one
// element's loads above another's stores.  So each thread loads its kIlp
// elements, a block apart (kIlp (2K - 1) loads in flight), before it
// stores any, and the kernel is instantiated for each tap count K so it
// holds registers only for the taps it has.  Each product and sum rounds
// on its own, in tap order, as the TPU kernel accumulates.  Offsets are
// 64-bit (n * d is past 2^31).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;

struct TapWeights {
  float w[kMaxTaps];
};

constexpr int kThreads = 256;
constexpr int kIlp = 4;  // elements per thread, loaded together
constexpr int64_t kSpan = kThreads * kIlp;

template <int K>
__global__ void __launch_bounds__(kThreads) quantized_combine_kernel(
    const float* m, const float* hnbr, float* hnbr_out,
    const uint8_t* __restrict__ lvl, const float* __restrict__ lo,
    const float* __restrict__ scale, const int32_t* __restrict__ src,
    float* out, TapWeights tw, int n_out, int64_t d) {
  __shared__ int64_t s_row[kMaxTaps];  // offset of source row s_k
  __shared__ float s_lo[kMaxTaps];
  __shared__ float s_sc[kMaxTaps];
  const int i = blockIdx.y;
  if (threadIdx.x < K) {
    const int s = src[threadIdx.x * n_out + i];
    s_row[threadIdx.x] = static_cast<int64_t>(s) * d;
    s_lo[threadIdx.x] = lo[s];
    s_sc[threadIdx.x] = scale[s];
  }
  __syncthreads();
  // one replica stack
  const int64_t plane = static_cast<int64_t>(n_out) * d;
  const int64_t c0 = static_cast<int64_t>(blockIdx.x) * kSpan + threadIdx.x;
  const int64_t at = static_cast<int64_t>(i) * d + c0;
  // every load first, so they are in flight together (a store to a
  // replica or to out could alias a later load otherwise)
  float mv[kIlp];
  float hv[kIlp][K];
  float q[kIlp][K];
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    if (c0 + j * kThreads < d) {
      mv[j] = m[at + j * kThreads];
#pragma unroll
      for (int k = 1; k < K; ++k) {
        hv[j][k] = hnbr[(k - 1) * plane + at + j * kThreads];
        q[j][k] = static_cast<float>(lvl[s_row[k] + c0 + j * kThreads]);
      }
    }
  }
#pragma unroll
  for (int j = 0; j < kIlp; ++j) {
    if (c0 + j * kThreads < d) {
      float acc = __fmul_rn(tw.w[0], mv[j]);
#pragma unroll
      for (int k = 1; k < K; ++k) {
        const float hn = __fadd_rn(__fadd_rn(hv[j][k], s_lo[k]),
                                   __fmul_rn(q[j][k], s_sc[k]));
        hnbr_out[(k - 1) * plane + at + j * kThreads] = hn;
        acc = __fadd_rn(acc, __fmul_rn(tw.w[k], hn));
      }
      out[at + j * kThreads] = acc;
    }
  }
}

}  // namespace

// m: (n_out, d) fp32; hnbr: (k_taps - 1, n_out, d) fp32; lvl: (n_src, d)
// uint8; lo, scale: (n_src,) fp32; src: (k_taps, n_out) int32 rows of lvl,
// all on the card; weights: k_taps host floats; out: (n_out, d) fp32, may
// be m itself; hnbr_out: (k_taps - 1, n_out, d) fp32, may be hnbr itself.
extern "C" int quantized_combine_f32(const void* m, const void* hnbr,
                                     void* hnbr_out, const void* lvl,
                                     const void* lo,
                                     const void* scale, const void* src,
                                     const float* weights, void* out,
                                     int k_taps, int n_out, int n_src,
                                     int64_t d, void* stream) {
  if (k_taps < 1 || k_taps > kMaxTaps || n_out < 1 || n_out > 65535 ||
      n_src < 1) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 0) return 0;
  TapWeights tw{};
  for (int k = 0; k < k_taps; ++k) tw.w[k] = weights[k];
  const int64_t spans = (d + kSpan - 1) / kSpan;
  if (spans > 0x7fffffff) return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid(static_cast<unsigned>(spans),
                  static_cast<unsigned>(n_out));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const float* m_f = static_cast<const float*>(m);
  const float* h_f = static_cast<const float*>(hnbr);
  float* ho_f = static_cast<float*>(hnbr_out);
  const uint8_t* l_u = static_cast<const uint8_t*>(lvl);
  const float* lo_f = static_cast<const float*>(lo);
  const float* sc_f = static_cast<const float*>(scale);
  const int32_t* src_i = static_cast<const int32_t*>(src);
  float* out_f = static_cast<float*>(out);
#define QC_LAUNCH(K)                                                       \
  case K:                                                                  \
    quantized_combine_kernel<K><<<grid, kThreads, 0, st>>>(                \
        m_f, h_f, ho_f, l_u, lo_f, sc_f, src_i, out_f, tw, n_out, d);      \
    break;
  switch (k_taps) {
    QC_LAUNCH(1)
    QC_LAUNCH(2)
    QC_LAUNCH(3)
    QC_LAUNCH(4)
    QC_LAUNCH(5)
    QC_LAUNCH(6)
    QC_LAUNCH(7)
    QC_LAUNCH(8)
  }
#undef QC_LAUNCH
  return static_cast<int>(cudaGetLastError());
}
