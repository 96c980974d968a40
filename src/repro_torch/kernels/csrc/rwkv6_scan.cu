// RWKV6 chunked wkv scan, forward, for Hopper: data-dependent per-channel
// decay, current-token bonus u, the state after the last token.
//
// Replaces the Pallas TPU kernel `rwkv6_scan_pallas`
// (src/repro/kernels/rwkv6_scan.py).  It computes that kernel's function,
// chunk by chunk of C = 16 tokens, with the same exponent clip:
//   logd = log(max(d, 1e-20)), cums = cumsum(logd) inside the chunk,
//   rd = r exp(clip(cums - logd, +-60)), kd = k exp(clip(-cums, +-60)),
//   y = rd S + tril(rd kd^T, -1) v + (r . (u k)) v,
//   S <- exp(total) S + (k exp(total - cums))^T v,  total = cums[C - 1],
// with S the (hd, hd) fp32 state carried across chunks from zero.  Tokens
// past the sequence end act as r = k = v = 0, d = 1, as the Pallas kernel
// pads them, so they leave S alone and write nothing.  The output is fp32
// y and the state after token S (which the Pallas kernel drops; prefill
// hands it to decode).
//
// Bound: per token and head it reads r, k, v (bf16 in the model) and d
// (fp32) and writes y (fp32), about 16 hd bytes, against about 4 hd^2 +
// 2 (C - 1) hd + 5 hd flops (the state terms, the causal half of the
// chunk's tile, the bonus); at hd = 64 the card's memory and its fp32
// rate bound it about equally (0.02 ms each for 40 heads x 2048 tokens).  This version
// is simple and right, not fast: products on the CUDA cores in fp32, no
// tensor cores, and a block walks its chunks in order, so a chunk's
// arithmetic and its barriers, not the card's rates, set the time.
//
// Design.  The chunk axis is sequential, so one block per (batch, head)
// would give 40 blocks for 132 SMs at batch 1.  Column e of the state and
// of y depends only on column e of v, so a block takes 32 value columns of
// one head (hd / 32 blocks a head) and recomputes the chunk's hd-wide
// quantities (cums, rd, kd, the 16 x 16 rd kd^T tile), which is cheap at
// C = 16.  A block of 256 threads keeps its (hd, 32) state slice and the
// chunk's r, k, d, v tiles in shared memory as fp32.  The next chunk's
// tiles are copied into a raw staging area with cp.async (16 bytes a
// thread) while the current chunk is computed; a copy held in registers
// overlapped less of the wait for device memory.  Per
// chunk, thread (channel i, group g) takes C / (256 / hd) tokens of
// channel i for the cumulative log decay (a two-level prefix across the
// groups) and the three exponentials; one thread per (t, s) pair of the
// 16 x 16 tile takes rd_t . kd_s (s < t) or the bonus r_t . (u k_t) (s =
// t); each thread then computes a register block of y (2 columns of one
// token) and of the state update (rows x 4 columns), so one shared load
// feeds several FMAs.  Inputs are read in place through the (batch, head,
// token) strides the caller passes (only the head dim must be
// contiguous), so the model's (B, S, H, hd) projections are read as (B,
// H, S, hd) views; y is written through strides as well.
//
// Chunk C = 16 is the Pallas kernel's default: the port then clips
// exactly where the TPU kernel clips, the 16 x 16 tile is one element a
// thread, and typical RWKV6 decays stay far from the clip (a chunk's
// cumulative log decay would have to fall below -60).
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 16;           // tokens per chunk (C)
constexpr int kThreads = 256;
constexpr int kMaxCols = 32;         // value columns of the state per block
constexpr int kPad = 4;              // row pitch hd + 4 of r, k, rd, kd
constexpr float kClip = 60.f;

static_assert(kChunk * kChunk <= kThreads, "one thread per (t, s) pair");

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

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::);
}

// A chunk's (C, W) tile of T, staged raw in shared memory: one 16-byte
// vector per thread at most, copied by cp.async (no register holds it, so
// the copy of the next chunk runs under the current chunk's arithmetic),
// or element by element where rows are not 16-byte aligned; then
// converted to fp32 for the chunk's work.
template <typename T, int W>
struct Stage {
  static constexpr int E = Vec<T>::E;
  static constexpr int kPerRow = W / E;
  static constexpr int kVecs = kChunk * kPerRow;
  static_assert(W % E == 0 && kVecs <= kThreads, "one vector per thread");

  static __device__ __forceinline__ void fetch(uint4* stage, const T* base,
                                               int64_t stride, int t0,
                                               int seq, bool vec) {
    const int id = threadIdx.x;
    if (id >= kVecs) return;
    const int row = id / kPerRow, col = id % kPerRow * E;
    if (t0 + row >= seq) return;
    const T* p = base + static_cast<int64_t>(t0 + row) * stride + col;
    if (vec) {
      cp_async16(stage + id, p);
    } else {
      T* o = reinterpret_cast<T*>(stage + id);
#pragma unroll
      for (int j = 0; j < E; ++j) o[j] = p[j];
    }
  }

  // fp32 into dst (row pitch P); rows past the sequence end get `fill`
  template <int P>
  static __device__ __forceinline__ void convert(const uint4* stage,
                                                 float* dst, int t0, int seq,
                                                 float fill) {
    const int id = threadIdx.x;
    if (id >= kVecs) return;
    const int row = id / kPerRow, col = id % kPerRow * E;
    float f[E];
    if (t0 + row < seq) {
      Vec<T>::unpack(stage[id], f);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) f[j] = fill;
    }
#pragma unroll
    for (int j = 0; j < E; j += 4)
      *reinterpret_cast<float4*>(dst + row * P + col + j) =
          make_float4(f[j], f[j + 1], f[j + 2], f[j + 3]);
  }
};

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* d;
  const float* u;                    // (heads, hd)
  float* y;
  float* state;                      // (batch, heads, hd, hd)
  int heads, seq;
  int64_t r_sb, r_sh, r_ss;          // element strides of (B, H, S)
  int64_t k_sb, k_sh, k_ss;
  int64_t v_sb, v_sh, v_ss;
  int64_t d_sb, d_sh, d_ss;
  int64_t y_sb, y_sh, y_ss;
};

__device__ __forceinline__ bool rows_aligned(const void* p, int64_t stride,
                                             int elem) {
  return reinterpret_cast<uintptr_t>(p) % 16 == 0 &&
         (stride * elem) % 16 == 0;
}

__device__ __forceinline__ float clip(float x) {
  return fminf(fmaxf(x, -kClip), kClip);
}

// n consecutive floats of shared memory (n = 1, 2 or 4, aligned to n)
template <int N>
__device__ __forceinline__ void lds(const float* p, float* out) {
  if constexpr (N == 4) {
    const float4 x = *reinterpret_cast<const float4*>(p);
    out[0] = x.x;
    out[1] = x.y;
    out[2] = x.z;
    out[3] = x.w;
  } else if constexpr (N == 2) {
    const float2 x = *reinterpret_cast<const float2*>(p);
    out[0] = x.x;
    out[1] = x.y;
  } else {
    out[0] = *p;
  }
}

template <typename T, typename TD, int HD>
__global__ void __launch_bounds__(kThreads)
    rwkv6_scan_kernel(const Args a) {
  constexpr int COLS = kMaxCols < HD ? kMaxCols : HD;
  constexpr int LD = HD + kPad;
  constexpr int G = kThreads / HD;   // token groups of the cumulative sum
  constexpr int TPG = kChunk / G;    // tokens per group
  constexpr int AP = kChunk + 1;     // row pitch of the (t, s) tile
  constexpr int YB = kChunk * COLS / kThreads;  // y columns per thread
  constexpr int CG = COLS / 4;       // state column groups of 4
  constexpr int IB = HD * COLS / kThreads / 4;  // state rows per thread
  static_assert(kThreads % HD == 0 && kChunk % G == 0, "channel groups");
  static_assert(YB == 1 || YB == 2 || YB == 4, "y register block");
  static_assert(IB == 1 || IB == 2 || IB == 4, "state register block");

  __shared__ __align__(16) float r_s[kChunk * LD];
  __shared__ __align__(16) float k_s[kChunk * LD];
  __shared__ __align__(16) float rd_s[kChunk * LD];
  __shared__ __align__(16) float kd_s[kChunk * LD];
  // the raw decay, then (once the log decay is taken) k exp(total - cums)
  __shared__ __align__(16) float dkw_s[kChunk * HD];
  __shared__ __align__(16) float v_s[kChunk * COLS];
  __shared__ __align__(16) float st_s[HD * COLS];  // the state's columns
  __shared__ float att_s[kChunk * AP];
  __shared__ float part_s[G * HD];
  __shared__ float tot_s[HD];
  __shared__ float u_s[HD];
  using SR = Stage<T, HD>;
  using SD = Stage<TD, HD>;
  using SV = Stage<T, COLS>;
  __shared__ uint4 sr[SR::kVecs], sk[SR::kVecs], sd[SD::kVecs],
      sv[SV::kVecs];

  const int tid = threadIdx.x;
  const int e0 = blockIdx.x * COLS;
  const int h = blockIdx.y, b = blockIdx.z;
  const T* rg = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh + e0;
  const TD* dg = static_cast<const TD*>(a.d) + b * a.d_sb + h * a.d_sh;
  float* yg = a.y + b * a.y_sb + h * a.y_sh + e0;
  const bool vr = rows_aligned(rg, a.r_ss, sizeof(T));
  const bool vk = rows_aligned(kg, a.k_ss, sizeof(T));
  const bool vv = rows_aligned(vg, a.v_ss, sizeof(T));
  const bool vd = rows_aligned(dg, a.d_ss, sizeof(TD));

  for (int i = tid; i < HD; i += kThreads) u_s[i] = a.u[h * HD + i];
  for (int i = tid; i < HD * COLS; i += kThreads) st_s[i] = 0.f;

  auto fetch = [&](int t0) {
    SR::fetch(sr, rg, a.r_ss, t0, a.seq, vr);
    SR::fetch(sk, kg, a.k_ss, t0, a.seq, vk);
    SD::fetch(sd, dg, a.d_ss, t0, a.seq, vd);
    SV::fetch(sv, vg, a.v_ss, t0, a.seq, vv);
    cp_async_commit();
  };
  fetch(0);

  const int ci = tid % HD, cg = tid / HD;      // cumulative-sum role
  const int nchunks = (a.seq + kChunk - 1) / kChunk;
  for (int c = 0; c < nchunks; ++c) {
    const int t0 = c * kChunk;
    cp_async_wait_all();
    __syncthreads();                 // chunk c is staged; chunk c - 1 done
    SR::template convert<LD>(sr, r_s, t0, a.seq, 0.f);
    SR::template convert<LD>(sk, k_s, t0, a.seq, 0.f);
    SD::template convert<HD>(sd, dkw_s, t0, a.seq, 1.f);
    SV::template convert<COLS>(sv, v_s, t0, a.seq, 0.f);
    __syncthreads();
    if (c + 1 < nchunks) fetch(t0 + kChunk);   // in flight meanwhile

    // log decay and its running sum over this group's tokens of channel ci
    float logd[TPG], cums[TPG];
    float run = 0.f;
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      logd[j] = logf(fmaxf(dkw_s[(cg * TPG + j) * HD + ci], 1e-20f));
      run += logd[j];
      cums[j] = run;
    }
    part_s[cg * HD + ci] = run;
    __syncthreads();

    // the earlier groups' sums give the offset; all of them the total (the
    // last token's cums, summed in the same order, equals it exactly)
    float off = 0.f, total = 0.f;
#pragma unroll
    for (int g = 0; g < G; ++g) {
      const float p = part_s[g * HD + ci];
      if (g < cg) off += p;
      total += p;
    }
#pragma unroll
    for (int j = 0; j < TPG; ++j) {
      const int t = cg * TPG + j;
      const float cs = off + cums[j];
      const float kk = k_s[t * LD + ci];
      rd_s[t * LD + ci] = r_s[t * LD + ci] * expf(clip(cs - logd[j]));
      kd_s[t * LD + ci] = kk * expf(clip(-cs));
      dkw_s[t * HD + ci] = kk * expf(total - cs);
      k_s[t * LD + ci] = u_s[ci] * kk;   // k is read as u k from here on
    }
    if (cg == 0) tot_s[ci] = expf(total);
    __syncthreads();

    // the (t, s) tile: rd_t . kd_s below the diagonal, the bonus r_t . (u
    // k_t) on it, zero above
    if (tid < kChunk * kChunk) {
      const int t = tid / kChunk, s = tid % kChunk;
      const float* x = s == t ? r_s + t * LD : rd_s + t * LD;
      const float* z = s == t ? k_s + t * LD : kd_s + s * LD;
      float acc = 0.f;
      if (s <= t) {
#pragma unroll
        for (int i = 0; i < HD; i += 4) {
          const float4 p = *reinterpret_cast<const float4*>(x + i);
          const float4 q = *reinterpret_cast<const float4*>(z + i);
          acc += p.x * q.x;
          acc += p.y * q.y;
          acc += p.z * q.z;
          acc += p.w * q.w;
        }
      }
      att_s[t * AP + s] = acc;
    }
    __syncthreads();

    // y[t, e] = rd_t S[:, e] + sum_{s < t} att[t, s] v[s, e] + bonus_t v[t, e]
    // for YB consecutive columns e of one token t a thread
    {
      const int t = tid / (COLS / YB), eb = tid % (COLS / YB) * YB;
      float yi[YB], ya[YB], w[YB];
#pragma unroll
      for (int j = 0; j < YB; ++j) yi[j] = ya[j] = 0.f;
#pragma unroll 4
      for (int i = 0; i < HD; i += 4) {
        const float4 x = *reinterpret_cast<const float4*>(rd_s + t * LD + i);
        const float xs[4] = {x.x, x.y, x.z, x.w};
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          lds<YB>(st_s + (i + q) * COLS + eb, w);
#pragma unroll
          for (int j = 0; j < YB; ++j) yi[j] += xs[q] * w[j];
        }
      }
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        if (s < t) {
          const float at = att_s[t * AP + s];
          lds<YB>(v_s + s * COLS + eb, w);
#pragma unroll
          for (int j = 0; j < YB; ++j) ya[j] += at * w[j];
        }
      }
      const float ad = att_s[t * AP + t];
      lds<YB>(v_s + t * COLS + eb, w);
      if (t0 + t < a.seq) {
        float* yr = yg + static_cast<int64_t>(t0 + t) * a.y_ss + eb;
#pragma unroll
        for (int j = 0; j < YB; ++j) yr[j] = (yi[j] + ya[j]) + ad * w[j];
      }
    }
    __syncthreads();                 // every read of the old state is done

    // S[i, e] <- exp(total_i) S[i, e] + sum_s kw[s, i] v[s, e] for IB rows
    // and 4 columns a thread
    {
      const int e = tid % CG * 4, i0 = tid / CG * IB;
      float acc[IB][4];
#pragma unroll
      for (int q = 0; q < IB; ++q)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[q][j] = 0.f;
#pragma unroll
      for (int s = 0; s < kChunk; ++s) {
        const float4 vv4 =
            *reinterpret_cast<const float4*>(v_s + s * COLS + e);
        float kw[IB];
        lds<IB>(dkw_s + s * HD + i0, kw);
#pragma unroll
        for (int q = 0; q < IB; ++q) {
          acc[q][0] += kw[q] * vv4.x;
          acc[q][1] += kw[q] * vv4.y;
          acc[q][2] += kw[q] * vv4.z;
          acc[q][3] += kw[q] * vv4.w;
        }
      }
#pragma unroll
      for (int q = 0; q < IB; ++q) {
        const float dt = tot_s[i0 + q];
        float4* sp = reinterpret_cast<float4*>(st_s + (i0 + q) * COLS + e);
        const float4 o = *sp;
        *sp = make_float4(dt * o.x + acc[q][0], dt * o.y + acc[q][1],
                          dt * o.z + acc[q][2], dt * o.w + acc[q][3]);
      }
    }
  }
  __syncthreads();
  float* sg = a.state + (static_cast<int64_t>(b) * a.heads + h) * HD * HD;
  for (int idx = tid; idx < HD * COLS; idx += kThreads)
    sg[(idx / COLS) * HD + e0 + idx % COLS] = st_s[idx];
}

template <typename T, typename TD, int HD>
int launch(const Args& a, int batch, void* stream) {
  constexpr int COLS = kMaxCols < HD ? kMaxCols : HD;
  const dim3 grid(HD / COLS, a.heads, batch);
  rwkv6_scan_kernel<T, TD, HD><<<grid, kThreads, 0,
                                 static_cast<cudaStream_t>(stream)>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD>
int dispatch_hd(const Args& a, int batch, int hd, void* stream) {
  switch (hd) {
    case 32:
      return launch<T, TD, 32>(a, batch, stream);
    case 64:
      return launch<T, TD, 64>(a, batch, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// r, k, v: float32 (rkv_bf16 = 0) or bfloat16 (1); d: the same choice by
// d_bf16; u (heads, hd) and the outputs fp32; strides: 15 element strides,
// (batch, head, seq) of r, k, v, d and y in turn, each head dim contiguous;
// state: (batch, heads, hd, hd) contiguous.  Returns the launch's CUDA error.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* d, const float* u, float* y,
                          float* state, int batch, int heads, int seq,
                          int hd, const int64_t* strides, int rkv_bf16,
                          int d_bf16, void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Args a;
  a.r = r;
  a.k = k;
  a.v = v;
  a.d = d;
  a.u = u;
  a.y = y;
  a.state = state;
  a.heads = heads;
  a.seq = seq;
  int64_t* f[15] = {&a.r_sb, &a.r_sh, &a.r_ss, &a.k_sb, &a.k_sh,
                    &a.k_ss, &a.v_sb, &a.v_sh, &a.v_ss, &a.d_sb,
                    &a.d_sh, &a.d_ss, &a.y_sb, &a.y_sh, &a.y_ss};
  for (int i = 0; i < 15; ++i) *f[i] = strides[i];
  if (rkv_bf16) {
    return d_bf16
               ? dispatch_hd<__nv_bfloat16, __nv_bfloat16>(a, batch, hd,
                                                           stream)
               : dispatch_hd<__nv_bfloat16, float>(a, batch, hd, stream);
  }
  return d_bf16 ? dispatch_hd<float, __nv_bfloat16>(a, batch, hd, stream)
                : dispatch_hd<float, float>(a, batch, hd, stream);
}
