// Online-softmax attention, forward, for Hopper: GQA, causal, sliding
// window, query offset, ragged sequence ends.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py).  It computes that kernel's
// function, not its block structure:
//   q (B, H, Sq, hd), k and v (B, KV, Skv, hd); query head h reads KV head
//   h / G (G = H / KV); s = (q . k) * scale with scale the fp32 rounding of
//   1/sqrt(hd) taken in double, as the Pallas kernel takes it; s = -1e30
//   where the mask says no (k_pos <= q_pos when causal, q_pos - k_pos <
//   window when window > 0, q_pos = q_offset + row); an online softmax
//   whose running max, denominator and accumulator are fp32; the output is
//   acc / max(l, 1e-30), rounded to the input type.
//
// Bound: at prefill shapes the work is ~4 hd flops per (query, visible key)
// pair against ~2 hd bytes per query row, so the card's arithmetic rate
// bounds it (989 TFLOP/s bf16 on the tensor cores).  This first version is
// simple and right, not fast: all products run on the CUDA cores in fp32
// (P.V stays fp32 as in the Pallas kernel), with no wgmma, TMA or
// pipelining.
//
// Design.  One block of 256 threads computes a 64-row query tile of one
// (batch, head), as a 16 x 16 grid of threads: thread (ty, tx) owns the
// 4 x 4 scores of rows 4 ty .. 4 ty + 3 and keys 4 tx .. 4 tx + 3 of each
// 64-key tile, and hd / 16 output columns of its 4 rows, held in registers
// (register blocking, as a CUDA-core matrix product does): one 16-byte
// shared load feeds 4 to 8 FMAs, so the FMA pipe, not the load pipe, sets
// the rate.  Q and V sit in shared memory row-major, K transposed (hd x
// 64) and P transposed (64 keys x 64 rows), all fp32, so each fragment is
// one float4.  A row's max and sum are four shuffles across the 16 threads
// of its tile row.  The block loops over 64-row KV tiles and skips those
// that the causal or window mask rules out for every row of the query
// tile.  Tiles are loaded as 16-byte vectors, all of a thread's loads in
// flight before its first store.  Inputs are read in place from the
// strides the caller passes (only the head dim must be contiguous), so the
// model's (B, S, KV, G, hd) tensors are read as permuted views without a
// copy; ragged edges are masked here, nothing is padded on the host.
// Query tiles are issued latest first, so the longest causal tiles start
// in the first wave.
//
// Ragged KV edge and rows with no valid key.  Keys past Skv score -inf,
// masked keys -1e30.  A row with at least one valid key gets exactly the
// Pallas result (its masked and missing keys weigh exp(-1e30 - m) = 0).  A
// row with no valid key (only possible with window > 0 and q_pos >= Skv - 1
// + window) weighs every real key exp(0) = 1 and none of the padding: it
// gets the mean of v over the Skv keys, which is what the plain softmax
// (kernels/ref.py, and the JAX package's `flash_attention_ref`) gives.  The
// Pallas kernel instead averages over its zero-padded last block.  A query
// tile holding such a row visits every KV tile.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockQ = 64;
constexpr int kBlockK = 64;
constexpr int kThreads = 256;        // a 16 x 16 grid, 4 x 4 scores each
constexpr int kPad = 4;              // row pitch hd + 4 of Q and V
constexpr int kPitchT = 64 + 4;      // row pitch of transposed K and P
constexpr float kMasked = -1e30f;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float x, float* dst) { *dst = x; }
__device__ __forceinline__ void store(float x, __nv_bfloat16* dst) {
  *dst = __float2bfloat16_rn(x);
}

struct Args {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  int group;                         // G = H / KV
  int sq, skv;
  int64_t q_sb, q_sh, q_ss;          // element strides of (B, H|KV, S)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t o_sb, o_sh, o_ss;
  float scale;
  int causal, window, q_offset;
};

// 16-byte vectors of T: E elements each, unpacked exactly to fp32.
template <typename T>
struct Vec;

template <>
struct Vec<float> {
  static constexpr int E = 4;
  static __device__ __forceinline__ void unpack(const uint4 u, float* f) {
    f[0] = __uint_as_float(u.x);
    f[1] = __uint_as_float(u.y);
    f[2] = __uint_as_float(u.z);
    f[3] = __uint_as_float(u.w);
  }
};

template <>
struct Vec<__nv_bfloat16> {
  static constexpr int E = 8;
  static __device__ __forceinline__ void unpack(const uint4 u, float* f) {
    const unsigned w[4] = {u.x, u.y, u.z, u.w};
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      f[2 * i] = __uint_as_float(w[i] << 16);
      f[2 * i + 1] = __uint_as_float(w[i] & 0xffff0000u);
    }
  }
};

// 64 rows x HD elements at `src` (row pitch `stride`) into shared fp32,
// row-major with pitch HD + kPad, or transposed (HD x 64, pitch kPitchT);
// rows past `valid` are zero.  With 16-byte aligned rows (`vec`) each
// thread issues all its 16-byte loads before it stores any, the threads of
// a warp on consecutive rows (so the transposed stores, and the row-major
// float4 stores, are free of bank conflicts); otherwise one element at a
// time.
template <typename T, int HD, bool kTransposed>
__device__ __forceinline__ void load_tile(float* dst, const T* src,
                                          int64_t stride, int valid,
                                          bool vec) {
  if (vec) {
    constexpr int E = Vec<T>::E;
    constexpr int N = kBlockQ * HD / E / kThreads;   // vectors per thread
    uint4 buf[N];
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int id = threadIdx.x + n * kThreads;
      const int r = id % kBlockQ, c = id / kBlockQ * E;
      buf[n] = r < valid ? *reinterpret_cast<const uint4*>(
                               src + static_cast<int64_t>(r) * stride + c)
                         : make_uint4(0u, 0u, 0u, 0u);
    }
#pragma unroll
    for (int n = 0; n < N; ++n) {
      const int id = threadIdx.x + n * kThreads;
      const int r = id % kBlockQ, c = id / kBlockQ * E;
      float f[E];
      Vec<T>::unpack(buf[n], f);
      if (kTransposed) {
#pragma unroll
        for (int e = 0; e < E; ++e) dst[(c + e) * kPitchT + r] = f[e];
      } else {
#pragma unroll
        for (int e = 0; e < E; e += 4)
          *reinterpret_cast<float4*>(dst + r * (HD + kPad) + c + e) =
              make_float4(f[e], f[e + 1], f[e + 2], f[e + 3]);
      }
    }
    return;
  }
  for (int i = threadIdx.x; i < kBlockQ * HD; i += kThreads) {
    const int r = i / HD, c = i % HD;
    const float x =
        r < valid ? to_f32(src[static_cast<int64_t>(r) * stride + c]) : 0.f;
    dst[kTransposed ? c * kPitchT + r : r * (HD + kPad) + c] = x;
  }
}

// Shared floats: Q, K^T and V tiles, and P^T, which reuses the K^T tile
// once the scores are taken when it fits (hd >= 64).
template <int HD>
constexpr bool kPInK = HD * kPitchT >= kBlockK * kPitchT;

template <int HD>
constexpr size_t kSmemBytes =
    sizeof(float) * (2 * kBlockQ * (HD + kPad) + HD * kPitchT +
                     (kPInK<HD> ? 0 : kBlockK * kPitchT));

// Output column k (< HD / 16) of thread column tx: float4 groups 4 tx +
// 64 j for hd >= 64, a float2 at 2 tx for hd = 32 (contiguous per thread
// group, so the V loads are free of bank conflicts).
template <int HD>
__device__ __forceinline__ int out_col(int tx, int k) {
  if constexpr (HD >= 64) {
    return 4 * tx + 64 * (k / 4) + k % 4;
  } else {
    return 2 * tx + k;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
    flash_fwd_kernel(const Args a) {
  constexpr int LD = HD + kPad;
  constexpr int NC = HD / 16;        // output columns per thread
  extern __shared__ float4 smem4[];
  float* q_s = reinterpret_cast<float*>(smem4);
  float* kt_s = q_s + kBlockQ * LD;
  float* v_s = kt_s + HD * kPitchT;
  float* pt_s = kPInK<HD> ? kt_s : v_s + kBlockK * LD;

  const int qt = gridDim.x - 1 - blockIdx.x;
  const int h = blockIdx.y, b = blockIdx.z;
  const int q0 = qt * kBlockQ;
  const int q_rows = min(kBlockQ, a.sq - q0);
  const int kvh = h / a.group;
  const T* qg = static_cast<const T*>(a.q) + b * a.q_sb + h * a.q_sh +
                static_cast<int64_t>(q0) * a.q_ss;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + kvh * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + kvh * a.v_sh;

  const int ty = threadIdx.x >> 4;   // rows 4 ty .. 4 ty + 3 of the tile
  const int tx = threadIdx.x & 15;   // keys 4 tx .. 4 tx + 3 of a KV tile
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + q_rows - 1;

  // KV tiles that hold a valid key for some row of this query tile
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (a.window > 0 && q_hi < a.skv - 1 + a.window)
    k_begin = max(0, q_lo - a.window + 1) / kBlockK * kBlockK;

  // 16-byte vector loads when every row of q, k and v starts aligned
  const bool vec =
      (reinterpret_cast<uintptr_t>(qg) | reinterpret_cast<uintptr_t>(kg) |
       reinterpret_cast<uintptr_t>(vg)) % 16 == 0 &&
      ((a.q_ss | a.k_ss | a.v_ss) * static_cast<int64_t>(sizeof(T))) % 16 ==
          0;
  load_tile<T, HD, false>(q_s, qg, a.q_ss, q_rows, vec);

  float m[4], l[4], acc[4][NC];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kMasked;
    l[i] = 0.f;
#pragma unroll
    for (int k = 0; k < NC; ++k) acc[i][k] = 0.f;
  }

  for (int k0 = k_begin; k0 < k_end; k0 += kBlockK) {
    const int k_rows = min(kBlockK, a.skv - k0);
    __syncthreads();                 // the last tile's P and V are read
    load_tile<T, HD, true>(kt_s, kg + static_cast<int64_t>(k0) * a.k_ss,
                           a.k_ss, k_rows, vec);
    load_tile<T, HD, false>(v_s, vg + static_cast<int64_t>(k0) * a.v_ss,
                            a.v_ss, k_rows, vec);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.f;
#pragma unroll 2
    for (int d = 0; d < HD; d += 4) {
      float4 qf[4], kf[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        qf[i] = *reinterpret_cast<const float4*>(q_s + (4 * ty + i) * LD + d);
#pragma unroll
      for (int e = 0; e < 4; ++e)
        kf[e] = *reinterpret_cast<const float4*>(kt_s + (d + e) * kPitchT +
                                                 4 * tx);
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float qd[4] = {qf[i].x, qf[i].y, qf[i].z, qf[i].w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          s[i][0] += qd[e] * kf[e].x;
          s[i][1] += qd[e] * kf[e].y;
          s[i][2] += qd[e] * kf[e].z;
          s[i][3] += qd[e] * kf[e].w;
        }
      }
    }

    float corr[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int q_pos = q_lo + 4 * ty + i;
      float row_max = -INFINITY;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const int c = 4 * tx + j;
        const int k_pos = k0 + c;
        const bool ok = (!a.causal || k_pos <= q_pos) &&
                        (a.window <= 0 || q_pos - k_pos < a.window);
        s[i][j] = c >= k_rows ? -INFINITY : (ok ? s[i][j] * a.scale
                                                 : kMasked);
        row_max = fmaxf(row_max, s[i][j]);
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        row_max = fmaxf(row_max, __shfl_xor_sync(0xffffffffu, row_max, o));
      const float m_new = fmaxf(m[i], row_max);
      float row_sum = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = expf(s[i][j] - m_new);
        row_sum += s[i][j];
      }
#pragma unroll
      for (int o = 1; o < 16; o <<= 1)
        row_sum += __shfl_xor_sync(0xffffffffu, row_sum, o);
      corr[i] = expf(m[i] - m_new);
      l[i] = l[i] * corr[i] + row_sum;
      m[i] = m_new;
#pragma unroll
      for (int k = 0; k < NC; ++k) acc[i][k] *= corr[i];
    }

    if (kPInK<HD>) __syncthreads();  // every thread's scores are taken
#pragma unroll
    for (int j = 0; j < 4; ++j)
      *reinterpret_cast<float4*>(pt_s + (4 * tx + j) * kPitchT + 4 * ty) =
          make_float4(s[0][j], s[1][j], s[2][j], s[3][j]);
    __syncthreads();

    // acc += P V over this tile's real keys
    for (int c = 0; c < k_rows; ++c) {
      const float4 p4 =
          *reinterpret_cast<const float4*>(pt_s + c * kPitchT + 4 * ty);
      const float p[4] = {p4.x, p4.y, p4.z, p4.w};
      const float* v_row = v_s + c * LD;
      float vv[NC];
      if constexpr (HD >= 64) {
#pragma unroll
        for (int g = 0; g < NC / 4; ++g) {
          const float4 x =
              *reinterpret_cast<const float4*>(v_row + 4 * tx + 64 * g);
          vv[4 * g] = x.x;
          vv[4 * g + 1] = x.y;
          vv[4 * g + 2] = x.z;
          vv[4 * g + 3] = x.w;
        }
      } else {
        const float2 x = *reinterpret_cast<const float2*>(v_row + 2 * tx);
        vv[0] = x.x;
        vv[1] = x.y;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int k = 0; k < NC; ++k) acc[i][k] += p[i] * vv[k];
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int r = 4 * ty + i;
    if (r < q_rows) {
      const float denom = fmaxf(l[i], 1e-30f);
      T* o_row = static_cast<T*>(a.o) + b * a.o_sb + h * a.o_sh +
                 static_cast<int64_t>(q0 + r) * a.o_ss;
#pragma unroll
      for (int k = 0; k < NC; ++k)
        store(acc[i][k] / denom, o_row + out_col<HD>(tx, k));
    }
  }
}

// The dynamic shared-memory limit, raised once per device.
template <typename T, int HD>
int allow_smem() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(flash_fwd_kernel<T, HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(kSmemBytes<HD>));
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64) done[dev] = true;
  return 0;
}

template <typename T, int HD>
int launch(const Args& a, int batch, int heads, void* stream) {
  const size_t smem = kSmemBytes<HD>;
  const int err = allow_smem<T, HD>();
  if (err) return err;
  const dim3 grid((a.sq + kBlockQ - 1) / kBlockQ, heads, batch);
  flash_fwd_kernel<T, HD><<<grid, kThreads, smem,
                            static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T>
int run(const void* q, const void* k, const void* v, void* o, int batch,
        int heads, int kv_heads, int sq, int skv, int hd,
        const int64_t* strides, float scale, int causal, int window,
        int q_offset, void* stream) {
  if (sq <= 0) return 0;
  if (skv <= 0 || kv_heads <= 0 || heads % kv_heads != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.q = q;
  a.k = k;
  a.v = v;
  a.o = o;
  a.group = heads / kv_heads;
  a.sq = sq;
  a.skv = skv;
  a.q_sb = strides[0];
  a.q_sh = strides[1];
  a.q_ss = strides[2];
  a.k_sb = strides[3];
  a.k_sh = strides[4];
  a.k_ss = strides[5];
  a.v_sb = strides[6];
  a.v_sh = strides[7];
  a.v_ss = strides[8];
  a.o_sb = strides[9];
  a.o_sh = strides[10];
  a.o_ss = strides[11];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  switch (hd) {
    case 32:
      return launch<T, 32>(a, batch, heads, stream);
    case 64:
      return launch<T, 64>(a, batch, heads, stream);
    case 128:
      return launch<T, 128>(a, batch, heads, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// strides: 12 element strides, (batch, head, seq) of q, k, v and o in turn;
// the head dim of each is contiguous.  Returns the CUDA error of the launch.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int batch,
                                   int heads, int kv_heads, int sq, int skv,
                                   int hd, const int64_t* strides,
                                   float scale, int causal, int window,
                                   int q_offset, void* stream) {
  return run<float>(q, k, v, o, batch, heads, kv_heads, sq, skv, hd, strides,
                    scale, causal, window, q_offset, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int batch,
                                    int heads, int kv_heads, int sq, int skv,
                                    int hd, const int64_t* strides,
                                    float scale, int causal, int window,
                                    int q_offset, void* stream) {
  return run<__nv_bfloat16>(q, k, v, o, batch, heads, kv_heads, sq, skv, hd,
                            strides, scale, causal, window, q_offset, stream);
}
