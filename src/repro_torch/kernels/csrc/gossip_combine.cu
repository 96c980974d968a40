// One round of tap gossip for Hopper:
//   out[i, :] = sum_k w[k] * m[src[k][i], :],   i < n_out, src[k][i] < n.
//
// Replaces the Pallas TPU kernel `gossip_combine_pallas`
// (src/repro/kernels/gossip_combine.py) together with the tap rolls that
// feed it (`_roll_taps` in src/repro/dist/consensus.py).  On the TPU each
// neighbour's rolled copy of the (n, D) message stack is materialised as a
// (K, n, D) stack and then combined; on one card the kernel reads the
// neighbour row m[src[k][i]] in place, so the stack is never built (at the
// 8-layer qwen2-1.5b width it alone would be 40 GB).  The source rows and
// the output rows are counted apart: one process holding every worker
// gives m all n workers' rows and n_out = n; one process per worker gives
// m the K rows it received, in tap order, a (K, 1) table naming them, and
// n_out = 1, so each rank writes its own row with the same products and
// sums as the stacked round.
//
// Bound: device memory.  The function reads the (n, D) source rows once
// and writes the (n_out, D) result once; 2K flops per output element are
// nothing beside that.  A block walks tiles of `tile` columns: it copies
// the tile of all n source rows into shared memory (every thread has n *
// kMaxCols independent loads in flight), then computes the n_out output
// rows of the tile from shared memory, so device memory sees each input
// element once however many taps read it.  The (K, n_out) source-row
// table sits in shared memory beside the tile.  The rows are D = P + 1
// elements long (the eq.-6 weight column rides last), an odd length, so
// rows are not 16-byte aligned: the kernel uses scalar coalesced loads
// rather than padding the row pitch.  The sum is taken in fp32 in tap
// order k = 0..K-1 from 0, each product and add rounded separately, as
// the TPU kernel accumulates.  Offsets are 64-bit (n * D is past 2^31).
#include <cstdint>
#include <cuda_runtime.h>

namespace {

constexpr int kMaxTaps = 8;

struct TapWeights {
  float w[kMaxTaps];
};

constexpr int kThreads = 256;
constexpr int kMaxCols = 4;       // tile columns per thread
constexpr int kSharedFloats = 12288;  // 48 KB: source-row table + tile
constexpr int64_t kMaxBlocks = 132 * 8;

__global__ void gossip_combine_kernel(const float* __restrict__ m,
                                      const int32_t* __restrict__ src,
                                      float* __restrict__ out, TapWeights tw,
                                      int k_taps, int n, int n_out,
                                      int64_t d, int tile) {
  extern __shared__ float smem[];
  int32_t* rows = reinterpret_cast<int32_t*>(smem);  // (k_taps, n_out)
  float* cols = smem + k_taps * n_out;                 // (n, tile)
  for (int t = threadIdx.x; t < k_taps * n_out; t += blockDim.x) {
    rows[t] = src[t];
  }
  for (int64_t t0 = static_cast<int64_t>(blockIdx.x) * tile; t0 < d;
       t0 += static_cast<int64_t>(gridDim.x) * tile) {
    __syncthreads();  // the table is written, the previous tile consumed
#pragma unroll 4
    for (int r = 0; r < n; ++r) {
      const float* row = m + static_cast<int64_t>(r) * d + t0;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = threadIdx.x + c * kThreads;
        if (col < tile) {
          cols[r * tile + col] = t0 + col < d ? __ldg(row + col) : 0.0f;
        }
      }
    }
    __syncthreads();
    for (int i = 0; i < n_out; ++i) {
      float* o = out + static_cast<int64_t>(i) * d + t0;
#pragma unroll
      for (int c = 0; c < kMaxCols; ++c) {
        const int col = threadIdx.x + c * kThreads;
        if (col < tile && t0 + col < d) {
          float acc = 0.0f;
#pragma unroll
          for (int k = 0; k < kMaxTaps; ++k) {
            if (k < k_taps) {
              const float x = cols[rows[k * n_out + i] * tile + col];
              acc = __fadd_rn(acc, __fmul_rn(tw.w[k], x));
            }
          }
          o[col] = acc;
        }
      }
    }
  }
}

}  // namespace

// m: (n, d) fp32 on the card; src: (k_taps, n_out) int32 rows of m on the
// card; weights: k_taps host floats; out: (n_out, d) fp32 on the card, not
// aliasing m.
extern "C" int gossip_combine_f32(const void* m, const void* src,
                                  const float* weights, void* out, int k_taps,
                                  int n, int n_out, int64_t d, void* stream) {
  // widest tile (a multiple of the block) that fits beside the table
  const int per_thread =
      n < 1 ? 0 : (kSharedFloats - k_taps * n_out) / (n * kThreads);
  const int tile = kThreads * (per_thread < kMaxCols ? per_thread : kMaxCols);
  if (k_taps < 1 || k_taps > kMaxTaps || n < 1 || n_out < 1 ||
      tile < kThreads) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (d <= 0) return 0;
  TapWeights tw{};
  for (int k = 0; k < k_taps; ++k) tw.w[k] = weights[k];
  int64_t blocks = (d + tile - 1) / tile;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  const size_t shared = sizeof(float) * (k_taps * n_out + n * tile);
  gossip_combine_kernel<<<static_cast<unsigned>(blocks), kThreads, shared,
                          static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(m), static_cast<const int32_t*>(src),
      static_cast<float*>(out), tw, k_taps, n, n_out, d, tile);
  return static_cast<int>(cudaGetLastError());
}
