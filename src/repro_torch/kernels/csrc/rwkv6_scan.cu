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
// 2 (C - 1) hd + 5 hd flops; at hd = 64 the card's memory and its fp32
// rate bound it about equally (0.02 ms each for 40 heads x 2048 tokens).
// A sequential walk is held back by its chain (one block per head walking
// 128 chunks in order at the rwkv6-3b prefill: 80 blocks for 132 SMs).
//
// Design: chunk-parallel segments.  Only rd and kd (clipped) are local to
// a chunk; the carry across chunks is unclipped and associative,
// (a1, S1) o (a2, S2) = (a1 a2, diag(a2) S1 + S2) with a the per-channel
// decay product.  The sequence is cut into segments of L chunks (segment
// boundaries fall on chunk boundaries, so the clip fires where the Pallas
// kernel's does), and three launches run in order on the caller's stream:
//   A  one block per (batch, head, segment): the segment's state from a
//      zero start, chunk by chunk as above (dS), and a = exp(sum logd);
//   B  one thread per (batch, head, state element): the short prefix over
//      the segments, S_start[j + 1] = diag(a_j) S_start[j] + dS_j, written
//      over dS_j in place; the state after the last segment is the
//      returned state;
//   C  one block per (batch, head, segment): from S_start[j], the
//      segment's chunks in order, writing y.
// A and C have B H (S / 16L) blocks (640 at the rwkv6-3b prefill, L = 8),
// each with a chain of L chunks.  A separate carry launch keeps C's blocks
// from each repeating the prefix and needs no ordering between blocks (a
// decoupled look-back would); the cost is that A and C both read the
// inputs.  The scratch (dS then S_start, and a) is B H segments (hd^2 +
// hd) fp32, allocated by the caller (10.6 MB at S 2048).
//
// A block has hd / 16 warps and owns the whole (hd, hd) state of its
// head, held transposed in the accumulators (see the kernel).  Per chunk:
// (1) elementwise, thread (channel i, quarter q) takes tokens q, q + 4,
// q + 8, q + 12 of two channels: log decay, its running sum (through
// shuffles), the three clipped or unclipped exponentials and the bonus'
// partial dot, into fp32 planes of shared memory; (2) tensor cores,
// mma.sync m16n8k8 TF32 in 3xTF32 (a_hi b_hi + a_hi b_lo + a_lo b_hi,
// fp32 accumulate: about fp32's precision, where one TF32 product keeps
// three digits): each warp computes the 16 x 16 tile rd kd^T (masked, the
// bonus on its diagonal), y^T for its 16 value columns, and the state
// update of its 16 rows.  Two barriers a chunk.  The next two chunks' r,
// k, d, v are copied raw into a three-buffer staging ring with cp.async
// (16 bytes a thread, element by element where rows are not 16-byte
// aligned) while the current chunk is computed.  Inputs are read in place
// through the (batch, head, token) strides the caller passes (only the
// head dim must be contiguous); y is written through strides.
#include <cstdint>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kChunk = 16;           // tokens per chunk (C)
constexpr float kLog2e = 1.4426950408889634f;
constexpr float kClip2 = 60.f * kLog2e;   // the +-60 clip, in base 2
constexpr int kStages = 3;           // staging ring: two chunks in flight
constexpr int kCarryThreads = 256;
constexpr int kCarryBatch = 16;      // segments whose loads a carry thread
                                     // issues before it stores
constexpr unsigned kFull = 0xffffffffu;

// 16-byte vectors of T: E elements each.
template <typename T>
struct Vec {
  static constexpr int E = 16 / sizeof(T);
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

__device__ __forceinline__ void cp_async16(void* smem, const void* gmem) {
  const unsigned dst = static_cast<unsigned>(__cvta_generic_to_shared(smem));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(dst),
               "l"(gmem));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

// all but the newest group done
__device__ __forceinline__ void cp_async_wait_prior() {
  asm volatile("cp.async.wait_group 1;\n" ::);
}

// Row pitch (elements) of a staged tile: 32 bytes past the row, so the
// four token rows that a warp reads at once fall on distinct banks.
template <typename T, int HD>
__host__ __device__ constexpr int stage_pitch() {
  return HD + 32 / static_cast<int>(sizeof(T));
}

// A chunk's (C, HD) tile of T, staged raw in shared memory: 16-byte
// vectors copied by cp.async, or element by element where rows are not
// 16-byte aligned.  Rows past the sequence end are left as they are: the
// reader substitutes the pad values.
template <typename T, int HD>
__device__ __forceinline__ void fetch(T* stage, const T* base, int64_t stride,
                                      int t0, int seq, bool vec) {
  constexpr int E = Vec<T>::E;
  constexpr int kPerRow = HD / E;
  for (int id = threadIdx.x; id < kChunk * kPerRow; id += blockDim.x) {
    const int row = id / kPerRow, col = id % kPerRow * E;
    if (t0 + row >= seq) break;      // rows grow with id
    const T* p = base + static_cast<int64_t>(t0 + row) * stride + col;
    T* o = stage + row * stage_pitch<T, HD>() + col;
    if (vec) {
      cp_async16(o, p);
    } else {
#pragma unroll
      for (int j = 0; j < E; ++j) o[j] = p[j];
    }
  }
}

struct Args {
  const void* r;
  const void* k;
  const void* v;
  const void* d;
  const float* u;                    // (heads, hd)
  float* y;
  float* state;                      // (batch, heads, hd, hd)
  float* ds;     // (batch, heads, segments, hd, hd): dS^T, then S_start^T
  float* dec;                        // (batch, heads, segments, hd)
  int heads, seq, seg_chunks, segments;
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

__device__ __forceinline__ float clip2(float x) {
  return fminf(fmaxf(x, -kClip2), kClip2);
}

// x = hi + lo + O(2^-20 x) for 3xTF32.  The tensor core reads the top 19
// bits of a TF32 operand and ignores the rest: hi is x cut to them, lo the
// fp32 remainder (cut by the core in turn): a mask and a subtraction, where
// a conversion instruction would run on the slower conversion pipe.
__device__ __forceinline__ void split(float x, uint32_t& hi, uint32_t& lo) {
  hi = __float_as_uint(x) & 0xffffe000u;
  lo = __float_as_uint(x - __uint_as_float(hi));
}

__device__ __forceinline__ void mma(float* c, const uint32_t* a,
                                    const uint32_t* b) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c += a b in 3xTF32: the two small cross terms first, then hi hi; with
// A_EXACT, a is a TF32 value (al = 0) and its cross term is left out
template <bool A_EXACT = false>
__device__ __forceinline__ void mma3(float* c, const uint32_t* ah,
                                     const uint32_t* al, const uint32_t* bh,
                                     const uint32_t* bl) {
  mma(c, ah, bl);
  if (!A_EXACT) mma(c, al, bh);
  mma(c, ah, bh);
}

// Shared memory of one block, in floats from the (16-byte aligned) base:
// the chunk's fp32 planes, then the staging ring.
template <typename T, typename TD, int HD, bool OUT>
struct Smem {
  static constexpr int NW = HD / 16;           // warps: one 16-row slab each
  static constexpr int THREADS = NW * 32;
  static constexpr int PR = HD + 8;            // pitch of rd, kd
  static constexpr int PW = HD + 4;            // pitch of kw, v
  static constexpr int kw = 0;                 // C x PW
  static constexpr int v = kw + kChunk * PW;
  static constexpr int tot = v + kChunk * PW;                // HD
  static constexpr int rd = tot + HD;                        // C x PR
  static constexpr int kd = rd + (OUT ? kChunk * PR : 0);
  static constexpr int bon = kd + (OUT ? kChunk * PR : 0);   // NW x C
  static constexpr int u = bon + (OUT ? NW * kChunk : 0);    // HD
  static constexpr int stage = u + (OUT ? HD : 0);
  static_assert(stage % 4 == 0, "16-byte aligned staging");
  // one staging buffer: r (OUT only), k, v of T and d of TD, C rows each
  static constexpr int rkv_bytes = kChunk * stage_pitch<T, HD>() * sizeof(T);
  static constexpr int buf_bytes =
      (OUT ? 3 : 2) * rkv_bytes + kChunk * stage_pitch<TD, HD>() * sizeof(TD);
  static constexpr int bytes = stage * 4 + kStages * buf_bytes;
};

// Passes A (OUT = false: the segment's dS and decay row) and C (OUT =
// true: y from the segment's start state).  Grid (segments, heads, batch).
//
// The state is held transposed, S^T (value column e, key channel i), in
// the accumulators: warp w owns rows e of [16 w, 16 w + 16) and every
// column i.  Each product takes its k-step's 8 indices in the order 0, 2,
// 4, 6 | 1, 3, 5, 7 (A's columns t4 | t4 + 4 hold k0 + 2 t4 | k0 + 2 t4 +
// 1, and B's rows likewise): a sum does not care, and in that order an
// accumulator fragment (c0, c1 | c2, c3 at columns 2 t4, 2 t4 + 1) is
// already an A fragment (a0, a2 | a1, a3), and two neighbours of a row of
// shared memory load as one float2.  So y^T = S^T rd^T takes S^T from the
// registers, y^T += v^T (masked tile)^T takes the tile from the registers
// that computed it, and S^T <- S^T diag(exp(total)) + v^T kw shares v^T's
// fragments.  Nothing of the state goes through shared memory.
template <typename T, typename TD, int HD, bool OUT>
__global__ void __launch_bounds__(HD * 2, 4)
    rwkv6_segment_kernel(const Args a) {
  using L = Smem<T, TD, HD, OUT>;
  constexpr int NW = L::NW, PR = L::PR, PW = L::PW;
  constexpr int NT = HD / 8;         // n8 tiles of the state; k-steps over i
  constexpr int SP = stage_pitch<T, HD>(), SPD = stage_pitch<TD, HD>();
  extern __shared__ __align__(16) float sm[];
  float* kw_s = sm + L::kw;
  float* v_s = sm + L::v;
  float* tot_s = sm + L::tot;
  float* rd_s = sm + L::rd;
  float* kd_s = sm + L::kd;
  float* bon_s = sm + L::bon;
  float* u_s = sm + L::u;
  char* stage_base = reinterpret_cast<char*>(sm + L::stage);

  const int tid = threadIdx.x, lane = tid & 31, w = tid >> 5;
  const int j = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int64_t head = static_cast<int64_t>(b) * a.heads + h;
  const T* rg = static_cast<const T*>(a.r) + b * a.r_sb + h * a.r_sh;
  const T* kg = static_cast<const T*>(a.k) + b * a.k_sb + h * a.k_sh;
  const T* vg = static_cast<const T*>(a.v) + b * a.v_sb + h * a.v_sh;
  const TD* dg = static_cast<const TD*>(a.d) + b * a.d_sb + h * a.d_sh;
  float* yg = a.y + b * a.y_sb + h * a.y_sh;
  const bool vr = rows_aligned(rg, a.r_ss, sizeof(T));
  const bool vk = rows_aligned(kg, a.k_ss, sizeof(T));
  const bool vv = rows_aligned(vg, a.v_ss, sizeof(T));
  const bool vd = rows_aligned(dg, a.d_ss, sizeof(TD));
  // the segment's scratch: S^T, row e, column i
  float* slot = a.ds + (head * a.segments + j) * HD * HD;

  auto stage_r = [&](int buf) {
    return reinterpret_cast<T*>(stage_base + buf * L::buf_bytes);
  };
  auto stage_k = [&](int buf) {
    return reinterpret_cast<T*>(stage_base + buf * L::buf_bytes +
                                (OUT ? 1 : 0) * L::rkv_bytes);
  };
  auto stage_v = [&](int buf) {
    return reinterpret_cast<T*>(stage_base + buf * L::buf_bytes +
                                (OUT ? 2 : 1) * L::rkv_bytes);
  };
  auto stage_d = [&](int buf) {
    return reinterpret_cast<TD*>(stage_base + buf * L::buf_bytes +
                                 (OUT ? 3 : 2) * L::rkv_bytes);
  };
  auto issue = [&](int buf, int t0) {
    if (OUT) fetch<T, HD>(stage_r(buf), rg, a.r_ss, t0, a.seq, vr);
    fetch<T, HD>(stage_k(buf), kg, a.k_ss, t0, a.seq, vk);
    fetch<T, HD>(stage_v(buf), vg, a.v_ss, t0, a.seq, vv);
    fetch<TD, HD>(stage_d(buf), dg, a.d_ss, t0, a.seq, vd);
  };

  const int nchunks = (a.seq + kChunk - 1) / kChunk;
  const int c_begin = j * a.seg_chunks;
  const int c_end = min(c_begin + a.seg_chunks, nchunks);
  issue(0, c_begin * kChunk);
  cp_async_commit();
  if (c_begin + 1 < c_end) issue(1, (c_begin + 1) * kChunk);
  cp_async_commit();                 // one group a chunk, empty past the end

  // mma fragment coordinates and this warp's slab of S^T
  const int g = lane >> 2, t4 = lane & 3;
  const int m0 = w * 16;
  float acc_s[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    float2 lo = make_float2(0.f, 0.f), hi = lo;
    if (OUT) {
      lo = *reinterpret_cast<const float2*>(slot + (m0 + g) * HD + n * 8 +
                                            2 * t4);
      hi = *reinterpret_cast<const float2*>(slot + (m0 + g + 8) * HD +
                                            n * 8 + 2 * t4);
    }
    acc_s[n][0] = lo.x;
    acc_s[n][1] = lo.y;
    acc_s[n][2] = hi.x;
    acc_s[n][3] = hi.y;
  }
  if (OUT)
    for (int i = tid; i < HD; i += L::THREADS) u_s[i] = a.u[h * HD + i];

  // elementwise role: channels ci0 and ci0 + HD / 2, tokens cq, cq + 4,
  // cq + 8, cq + 12
  const int cq = lane >> 3, ci0 = w * 8 + (lane & 7);
  float seg_log[2] = {0.f, 0.f};     // pass A: sums of the chunks' totals

  for (int c = c_begin; c < c_end; ++c) {
    const int t0 = c * kChunk, buf = (c - c_begin) % kStages;
    const bool last = c + 1 == c_end;
    cp_async_wait_prior();
    __syncthreads();                 // chunk c staged; chunk c - 1 done
    if (c + 2 < c_end) issue((buf + 2) % kStages, t0 + 2 * kChunk);
    cp_async_commit();

    // (1) elementwise: log decay, its running sum, the factors (fp32)
    {
      const T* sr = stage_r(buf);
      const T* sk = stage_k(buf);
      const T* sv = stage_v(buf);
      const TD* sd = stage_d(buf);
      float bonus[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int p = 0; p < 2; ++p) {
        const int ci = ci0 + p * (HD / 2);
        // base-2 logs (the function's natural ones times log2 e, and its
        // clip likewise): the card's log2 and exp2 are single instructions.
        // Row q of the chunk is tokens 4q .. 4q + 3, one a quarter: its
        // running sum across the quarters, then the rows' totals in order
        float lg[4], cum[4];
        float pre = 0.f;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = q * 4 + cq;
          const float dv = t0 + t < a.seq ? to_f32(sd[t * SPD + ci]) : 1.f;
          lg[q] = __log2f(fmaxf(dv, 1e-20f));
          float x = lg[q];
          float y = __shfl_up_sync(kFull, x, 8);
          if (cq >= 1) x += y;
          y = __shfl_up_sync(kFull, x, 16);
          if (cq >= 2) x += y;
          cum[q] = pre + x;
          pre += __shfl_sync(kFull, x, (lane & 7) + 24);
        }
        // the chunk total is token 15's cumulative sum, summed alike
        const float total = pre;
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          const int t = q * 4 + cq;
          const bool in = t0 + t < a.seq;
          const float kk = in ? to_f32(sk[t * SP + ci]) : 0.f;
          kw_s[t * PW + ci] = kk * exp2f(total - cum[q]);
          v_s[t * PW + ci] = in ? to_f32(sv[t * SP + ci]) : 0.f;
          if (OUT) {
            const float rr = in ? to_f32(sr[t * SP + ci]) : 0.f;
            rd_s[t * PR + ci] = rr * exp2f(clip2(cum[q] - lg[q]));
            kd_s[t * PR + ci] = kk * exp2f(clip2(-cum[q]));
            bonus[q] += rr * (u_s[ci] * kk);
          }
        }
        if (cq == 0) tot_s[ci] = exp2f(total);
        seg_log[p] += total;
      }
      if (OUT) {
        // the bonus' dot over this warp's 16 channels, one partial a warp
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          float x = bonus[q];
          x += __shfl_xor_sync(kFull, x, 1);
          x += __shfl_xor_sync(kFull, x, 2);
          x += __shfl_xor_sync(kFull, x, 4);
          if ((lane & 7) == 0) bon_s[w * kChunk + q * 4 + cq] = x;
        }
      }
    }
    __syncthreads();

    // v^T fragments over the chunk's tokens (two k-steps): the A operand of
    // the state update and of the tile's product.  A bf16 v is a TF32
    // value (8 of TF32's 10 mantissa bits): its lo half is zero, and its
    // products take two tensor-core passes, not three.
    constexpr bool kVExact = sizeof(T) == 2;
    uint32_t vh[2][4], vl[2][4];
#pragma unroll
    for (int kt = 0; kt < 2; ++kt) {
      const float* p0 = v_s + (kt * 8 + 2 * t4) * PW + m0 + g;
      split(p0[0], vh[kt][0], vl[kt][0]);
      split(p0[8], vh[kt][1], vl[kt][1]);
      split(p0[PW], vh[kt][2], vl[kt][2]);
      split(p0[PW + 8], vh[kt][3], vl[kt][3]);
    }

    if (OUT) {
      // (2) one pass over the head dim: the tile rd kd^T (t, s) and y^T
      // (e, t) = S^T rd^T.  rd's fragment serves both: as the tile's A
      // (rows t = g, g + 8) it is, in this k order, y's B for the two token
      // tiles.  Two k-step chains a product.
      float att[2][2][4] = {}, acc_y[2][2][4] = {};
#pragma unroll
      for (int ks = 0; ks < NT; ++ks) {
        const int k0 = ks * 8 + 2 * t4;
        uint32_t rh[4], rl[4];  // rd: (g, k0), (g + 8, k0), (g, k0 + 1), ...
        float2 f = *reinterpret_cast<const float2*>(rd_s + g * PR + k0);
        split(f.x, rh[0], rl[0]);
        split(f.y, rh[2], rl[2]);
        f = *reinterpret_cast<const float2*>(rd_s + (g + 8) * PR + k0);
        split(f.x, rh[1], rl[1]);
        split(f.y, rh[3], rl[3]);
#pragma unroll
        for (int ns = 0; ns < 2; ++ns) {
          uint32_t bh[2], bl[2];
          f = *reinterpret_cast<const float2*>(kd_s + (ns * 8 + g) * PR + k0);
          split(f.x, bh[0], bl[0]);
          split(f.y, bh[1], bl[1]);
          mma3(att[ks & 1][ns], rh, rl, bh, bl);
        }
        uint32_t ah[4], al[4];       // S^T: c0, c2, c1, c3 = a0, a1, a2, a3
        split(acc_s[ks][0], ah[0], al[0]);
        split(acc_s[ks][2], ah[1], al[1]);
        split(acc_s[ks][1], ah[2], al[2]);
        split(acc_s[ks][3], ah[3], al[3]);
#pragma unroll
        for (int nt = 0; nt < 2; ++nt) {
          const uint32_t bh[2] = {rh[nt], rh[nt + 2]};
          const uint32_t bl[2] = {rl[nt], rl[nt + 2]};
          mma3(acc_y[ks & 1][nt], ah, al, bh, bl);
        }
      }
      // the tile masked: rd kd^T below the diagonal, the bonus r . (u k)
      // on it, zero above
      float bt[2] = {0.f, 0.f};      // the bonus of tokens g and g + 8
#pragma unroll
      for (int p = 0; p < NW; ++p) {
        bt[0] += bon_s[p * kChunk + g];
        bt[1] += bon_s[p * kChunk + g + 8];
      }
      float tile[2][4];   // [s tile][c]: t = g (+8), s = 8 ns + 2 t4 (+1)
#pragma unroll
      for (int ns = 0; ns < 2; ++ns)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = g + (e >> 1) * 8, s = ns * 8 + 2 * t4 + (e & 1);
          const float x = att[0][ns][e] + att[1][ns][e];
          tile[ns][e] = s < t ? x : s == t ? bt[e >> 1] : 0.f;
        }

      // (3) y^T += v^T tile^T, and y stored
#pragma unroll
      for (int nt = 0; nt < 2; ++nt) {
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          // B (s, t) = tile (t, s): s tile kt, t rows g (+8) of tile nt
          uint32_t bh[2], bl[2];
          split(tile[kt][nt * 2], bh[0], bl[0]);
          split(tile[kt][nt * 2 + 1], bh[1], bl[1]);
          mma3<kVExact>(acc_y[1][nt], vh[kt], vl[kt], bh, bl);
        }
        // y (t, e): c0 (e = m0 + g, t = 8 nt + 2 t4), c1 (t + 1), c2, c3
        // (e + 8)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int t = nt * 8 + 2 * t4 + (e & 1);
          if (t0 + t < a.seq)
            yg[static_cast<int64_t>(t0 + t) * a.y_ss + m0 + g + (e >> 1) * 8] =
                acc_y[0][nt][e] + acc_y[1][nt][e];
        }
      }
    }

    // (4) S^T <- S^T diag(exp(total)) + v^T kw (not needed after a
    // segment's last chunk in pass C: pass B carries the segments)
    if (!OUT || !last) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const float2 dt =
            *reinterpret_cast<const float2*>(tot_s + n * 8 + 2 * t4);
        acc_s[n][0] *= dt.x;
        acc_s[n][1] *= dt.y;
        acc_s[n][2] *= dt.x;
        acc_s[n][3] *= dt.y;
#pragma unroll
        for (int kt = 0; kt < 2; ++kt) {
          const float* p0 = kw_s + (kt * 8 + 2 * t4) * PW + n * 8 + g;
          uint32_t bh[2], bl[2];
          split(p0[0], bh[0], bl[0]);
          split(p0[PW], bh[1], bl[1]);
          mma3<kVExact>(acc_s[n], vh[kt], vl[kt], bh, bl);
        }
      }
    }
  }

  if (!OUT) {
    // the segment's S^T from zero and its decay row
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      const int col = n * 8 + 2 * t4;
      *reinterpret_cast<float2*>(slot + (m0 + g) * HD + col) =
          make_float2(acc_s[n][0], acc_s[n][1]);
      *reinterpret_cast<float2*>(slot + (m0 + g + 8) * HD + col) =
          make_float2(acc_s[n][2], acc_s[n][3]);
    }
    if (cq == 0) {
      float* dec = a.dec + (head * a.segments + j) * HD;
      dec[ci0] = exp2f(seg_log[0]);
      dec[ci0 + HD / 2] = exp2f(seg_log[1]);
    }
  }
}

// Pass B: one thread per (batch, head, element of S^T), the segments in
// order.  Slot j holds dS_j^T on entry and S_start[j]^T on exit; the
// state after the last segment is written untransposed.
template <int HD>
__global__ void __launch_bounds__(kCarryThreads)
    rwkv6_carry_kernel(const Args a, int64_t n) {
  const int64_t idx = static_cast<int64_t>(blockIdx.x) * kCarryThreads +
                      threadIdx.x;
  if (idx >= n) return;
  const int64_t bh = idx / (HD * HD);
  const int rem = static_cast<int>(idx % (HD * HD));
  const int e = rem / HD, i = rem % HD;
  float* slot = a.ds + bh * a.segments * HD * HD + rem;
  const float* dec = a.dec + bh * a.segments * HD + i;
  float s = 0.f;
  for (int j0 = 0; j0 < a.segments; j0 += kCarryBatch) {
    // all loads of a batch first: the stores cannot overtake them
    float ds[kCarryBatch], dc[kCarryBatch];
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      const int jj = min(j0 + q, a.segments - 1);
      ds[q] = slot[static_cast<int64_t>(jj) * HD * HD];
      dc[q] = dec[jj * HD];
    }
#pragma unroll
    for (int q = 0; q < kCarryBatch; ++q) {
      if (j0 + q < a.segments) {
        slot[static_cast<int64_t>(j0 + q) * HD * HD] = s;
        s = dc[q] * s + ds[q];
      }
    }
  }
  a.state[bh * HD * HD + i * HD + e] = s;
}

template <typename T, typename TD, int HD, bool OUT>
int launch_segments(const Args& a, int batch, cudaStream_t stream) {
  using L = Smem<T, TD, HD, OUT>;
  auto kernel = rwkv6_segment_kernel<T, TD, HD, OUT>;
  cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, L::bytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid(a.segments, a.heads, batch);
  kernel<<<grid, L::THREADS, L::bytes, stream>>>(a);
  return static_cast<int>(cudaGetLastError());
}

template <typename T, typename TD, int HD>
int launch(const Args& a, int batch, cudaStream_t stream) {
  int err = launch_segments<T, TD, HD, false>(a, batch, stream);
  if (err) return err;
  const int64_t n = static_cast<int64_t>(batch) * a.heads * HD * HD;
  rwkv6_carry_kernel<HD>
      <<<static_cast<unsigned>((n + kCarryThreads - 1) / kCarryThreads),
         kCarryThreads, 0, stream>>>(a, n);
  err = static_cast<int>(cudaGetLastError());
  if (err) return err;
  return launch_segments<T, TD, HD, true>(a, batch, stream);
}

template <typename T, typename TD>
int dispatch_hd(const Args& a, int batch, int hd, cudaStream_t stream) {
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
// (batch, head, seq) of r, k, v, d and y in turn, each head dim contiguous
// (y's rows 8-byte aligned); state: (batch, heads, hd, hd) contiguous;
// scratch: batch * heads * segments * (hd * hd + hd) fp32, segments =
// ceil(ceil(seq / 16) / seg_chunks).  Three launches in order on `stream`;
// returns the first CUDA error.
extern "C" int rwkv6_scan(const void* r, const void* k, const void* v,
                          const void* d, const float* u, float* y,
                          float* state, float* scratch, int batch, int heads,
                          int seq, int hd, int seg_chunks,
                          const int64_t* strides, int rkv_bf16, int d_bf16,
                          void* stream) {
  if (batch <= 0 || heads <= 0 || seq <= 0 || seg_chunks <= 0)
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
  a.seg_chunks = seg_chunks;
  const int nchunks = (seq + kChunk - 1) / kChunk;
  a.segments = (nchunks + seg_chunks - 1) / seg_chunks;
  a.ds = scratch;
  a.dec = scratch + static_cast<int64_t>(batch) * heads * a.segments * hd * hd;
  int64_t* f[15] = {&a.r_sb, &a.r_sh, &a.r_ss, &a.k_sb, &a.k_sh,
                    &a.k_ss, &a.v_sb, &a.v_sh, &a.v_ss, &a.d_sb,
                    &a.d_sh, &a.d_ss, &a.y_sb, &a.y_sh, &a.y_ss};
  for (int i = 0; i < 15; ++i) *f[i] = strides[i];
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (rkv_bf16) {
    return d_bf16 ? dispatch_hd<__nv_bfloat16, __nv_bfloat16>(a, batch, hd, s)
                  : dispatch_hd<__nv_bfloat16, float>(a, batch, hd, s);
  }
  return d_bf16 ? dispatch_hd<float, __nv_bfloat16>(a, batch, hd, s)
                : dispatch_hd<float, float>(a, batch, hd, s);
}
