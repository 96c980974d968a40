// Online-softmax attention, forward, on Hopper's tensor cores (bf16):
// GQA, causal, sliding window, query offset, ragged sequence ends.
//
// Replaces the Pallas TPU kernel `flash_attention_pallas`
// (src/repro/kernels/flash_attention.py) for bf16 inputs whose rows TMA can
// read (see `body` in kernels/flash_attention.py); every other input takes
// the CUDA-core body, csrc/flash_attention.cu, whose header defines the
// function both compute:
//   q (B, H, Sq, hd), k and v (B, KV, Skv, hd); query head h reads KV head
//   h / G; s = (q . k) * scale, scale the fp32 1/sqrt(hd); s = -1e30 where
//   the mask says no (k_pos <= q_pos when causal, q_pos - k_pos < window
//   when window > 0, q_pos = q_offset + row), keys at or past Skv weigh 0;
//   an online softmax in fp32; out = acc / max(l, 1e-30) in bf16, so a row
//   with no valid key gets the mean of v over the Skv keys.  The output is
//   written into the (B, Sq, H, hd) storage behind the (B, H, Sq, hd) view.
//
// Bound: about 4 hd flops per (query, visible key) pair against 2 hd bytes
// per row read or written, so the tensor cores' bf16 rate bounds it at the
// prefill shapes.  Design:
//   * one CTA per 128-row query tile of one (batch, head): two warpgroups
//     of 64 rows each, 256 threads, one CTA per SM.  No producer warp: a
//     ninth warp would put three warps on one of the SM's four register
//     files and cap every thread at 168 registers, too few for O (64), the
//     scores (64) and both parts of P at once (`setmaxnreg` did not lift
//     ptxas's cap); at 8 warps a thread may hold 255;
//   * thread 0 loads the Q tile and the first K and V tiles of 128 keys,
//     and the last warp done with a stage loads the next tile into it: a
//     ring of two stages, each with TMA, a full `mbarrier` and a counter
//     of the warps done with it, so no warp waits for another to refill.
//     Shared memory at hd 128: Q 32 KB + 2 x (K 32 KB + V 32 KB) = 160 KB
//     of the 227 KB;
//   * tensor maps are 4-D (hd, S, heads, B) over the caller's strided views
//     (the prefill passes permuted views: no copy), with a 128-byte swizzle
//     (hd 128: two 64-column boxes a tile) or, at hd 32, a 64-byte one.
//     TMA fills rows past Sq or Skv with zeros; keys past Skv are masked
//     here all the same;
//   * S = Q K^T by `wgmma` m64n128k16, bf16 in and fp32 accumulators in
//     registers (products of bf16 values are exact in fp32, so S differs
//     from the plain version only in summation order), scaled every tile,
//     masked only on tiles that straddle a causal, window or Skv boundary;
//   * the online softmax stays in the accumulator's layout: a row's max is
//     two shuffles across the four threads that hold it, its sum is kept
//     per thread and summed at the end in fp32;
//   * P = P_hi + P_lo, both bf16 (P_lo the rounding of P - P_hi, so the
//     pair is off by at most 2^-17 of P, where P_hi alone is off by up to
//     2^-9 and flips the bf16 rounding of outputs in their top binade);
//     each is the A operand of a `wgmma` from registers, V the B operand
//     from shared memory with the transpose bit (it is MN-major), both
//     products into the same fp32 accumulators: P.V costs two `wgmma`s a
//     k-step of 16 keys, where one bf16 P would take one;
//   * tiles the mask rules out for all rows of the CTA are never loaded,
//     those it rules out for one warpgroup's rows that warpgroup skips;
//   * query tiles are issued latest first across all (batch, head) pairs
//     (the grid is (H, B, query tiles), x fastest), so the longest causal
//     tiles fill the first wave and the short ones fill in behind them.
#include <cstdint>
#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>

namespace {

constexpr int kBlockM = 128;          // query rows per CTA
constexpr int kBlockN = 128;          // keys per K / V tile
constexpr int kStages = 2;
constexpr int kConsumers = 2;         // warpgroups of 64 rows
constexpr int kThreads = kConsumers * 128;
constexpr float kMasked = -1e30f;
constexpr float kLog2e = 1.4426950408889634f;

// Shared-memory layout of one head dim: every tile is kPanels panels of
// kBoxCols columns (one TMA box each), rows of kRowBytes, swizzled in
// atoms of 8 rows.
template <int HD>
struct Tile {
  static constexpr int kBoxCols = HD < 64 ? HD : 64;
  static constexpr int kPanels = HD / kBoxCols;
  static constexpr int kRowBytes = 2 * kBoxCols;           // 128 or 64
  static constexpr uint64_t kLayout = kRowBytes == 128 ? 1 : 2;  // B128, B64
  static constexpr int kAtomBytes = 8 * kRowBytes;
  static constexpr int kQPanel = kBlockM * kRowBytes;
  static constexpr int kKVPanel = kBlockN * kRowBytes;
  static constexpr int kQBytes = kPanels * kQPanel;
  static constexpr int kKVBytes = kPanels * kKVPanel;      // one K or V tile
  static constexpr int kStageBytes = 2 * kKVBytes;
  static constexpr int kBarOffset = kQBytes + kStages * kStageBytes;
  // + q_full, full[kStages], done[kStages], + slack to align to 1 KB
  static constexpr int kSmemBytes = kBarOffset + 8 * (1 + 2 * kStages) + 1024;
};

struct Params {
  void* o;
  int group, sq, skv;
  int64_t o_sb, o_sh, o_ss;          // element strides of o's (B, H, S)
  float scale;
  int causal, window, q_offset;
};

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint32_t bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(bar),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect_tx(uint32_t bar, uint32_t bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

// Wait until the phase of parity `parity` has completed.  A wait that
// never ends (a fault in the pipeline) traps after about 2^26 polls, so the
// launch fails instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint32_t bar, uint32_t parity) {
  uint32_t done = 0;
  for (uint32_t polls = 0;; ++polls) {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(bar), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1u << 26)) __trap();
  }
}

__device__ __forceinline__ void tma_load(uint32_t dst, const CUtensorMap* map,
                                         int c0, int c1, int c2, int c3,
                                         uint32_t bar) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3, %4, %5}], [%6];" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2),
      "r"(c3), "r"(bar)
      : "memory");
}

// wgmma shared-memory matrix descriptor: start address, leading and stride
// byte offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t desc(uint32_t addr, uint32_t lbo,
                                         uint32_t sbo, uint64_t layout) {
  return static_cast<uint64_t>((addr >> 4) & 0x3fff) |
         (static_cast<uint64_t>((lbo >> 4) & 0x3fff) << 16) |
         (static_cast<uint64_t>((sbo >> 4) & 0x3fff) << 32) | (layout << 62);
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;" ::: "memory");
}

// Keep the compiler from touching registers an in-flight wgmma reads or
// writes before the wait.
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// D (64 x 128, fp32) = A (64 x 16) B^T, both K-major bf16 in shared memory;
// scale_d 0 overwrites D.
__device__ __forceinline__ void wgmma_ss_n128(float (&d)[64], uint64_t da,
                                             uint64_t db, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %66, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, %64, %65, p, 1, 1, 0, 0;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "l"(da), "l"(db), "r"(scale_d));
}

// D (64 x 128, fp32) += A (64 x 16, bf16 fragments in registers) B, B
// MN-major bf16 in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n128(float (&d)[64],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31, "
      "%32, %33, %34, %35, %36, %37, %38, %39, "
      "%40, %41, %42, %43, %44, %45, %46, %47, "
      "%48, %49, %50, %51, %52, %53, %54, %55, "
      "%56, %57, %58, %59, %60, %61, %62, %63"
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]), "+f"(d[40]),
        "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]), "+f"(d[45]),
        "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]), "+f"(d[50]),
        "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]), "+f"(d[60]),
        "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 64, fp32) += A (64 x 16, bf16 fragments in registers) B, B
// MN-major bf16 in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n64(float (&d)[32],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n64k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15, "
      "%16, %17, %18, %19, %20, %21, %22, %23, "
      "%24, %25, %26, %27, %28, %29, %30, %31"
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]), "+f"(d[20]),
        "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]), "+f"(d[25]),
        "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]), "+f"(d[30]),
        "+f"(d[31])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// D (64 x 32, fp32) += A (64 x 16, bf16 fragments in registers) B, B
// MN-major bf16 in shared memory (the transpose bit).
__device__ __forceinline__ void wgmma_rs_n32(float (&d)[16],
                                             const uint32_t* a, uint64_t db) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k16.f32.bf16.bf16 {"
      "%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, %15"
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]), "+f"(d[5]),
        "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]), "+f"(d[10]),
        "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1));
}

// O += P V for one k-step of 16 keys: N = HD output columns.
template <int HD>
__device__ __forceinline__ void wgmma_pv(float (&o)[HD / 2],
                                         const uint32_t* a, uint64_t db);
template <>
__device__ __forceinline__ void wgmma_pv<128>(float (&o)[64],
                                              const uint32_t* a,
                                              uint64_t db) {
  wgmma_rs_n128(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<64>(float (&o)[32],
                                             const uint32_t* a, uint64_t db) {
  wgmma_rs_n64(o, a, db);
}
template <>
__device__ __forceinline__ void wgmma_pv<32>(float (&o)[16],
                                             const uint32_t* a, uint64_t db) {
  wgmma_rs_n32(o, a, db);
}

__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  const __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<const uint32_t*>(&v);
}

// (x, y) = hi + lo: hi packs their bf16 roundings, lo the bf16 roundings of
// what those leave out (x - bf16(x) is exact in fp32).
__device__ __forceinline__ void split_bf16(float x, float y, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x, y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = pack_bf16(x - __low2float(h), y - __high2float(h));
}

template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
    flash_fwd_sm90(const __grid_constant__ CUtensorMap tq,
                   const __grid_constant__ CUtensorMap tk,
                   const __grid_constant__ CUtensorMap tv, const Params a) {
  using L = Tile<HD>;
  extern __shared__ uint8_t smem_raw[];
  const uint32_t base = (smem_u32(smem_raw) + 1023) & ~1023u;
  const uint32_t q_s = base;
  const uint32_t bars = base + L::kBarOffset;
  const uint32_t q_full = bars;
  auto full = [&](int s) { return bars + 8 * (1 + s); };
  // warps done with stage s (a counter in shared memory, not a barrier)
  unsigned* const done = reinterpret_cast<unsigned*>(
      smem_raw + (bars + 8 * (1 + kStages) - smem_u32(smem_raw)));
  auto k_tile = [&](int s) { return base + L::kQBytes + s * L::kStageBytes; };

  const int qt = gridDim.z - 1 - blockIdx.z;
  const int h = blockIdx.x, b = blockIdx.y;
  const int q0 = qt * kBlockM;
  const int q_rows = min(kBlockM, a.sq - q0);
  const int q_lo = a.q_offset + q0;
  const int q_hi = q_lo + q_rows - 1;
  // KV tiles that hold a valid key for some row of this query tile
  int k_end = a.skv;
  if (a.causal) k_end = min(k_end, q_hi + 1);
  int k_begin = 0;
  if (a.window > 0 && q_hi < a.skv - 1 + a.window)
    k_begin = max(0, q_lo - a.window + 1) / kBlockN * kBlockN;
  const int n_tiles = (k_end - k_begin + kBlockN - 1) / kBlockN;

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int kvh = h / a.group;
  // K and V tile j into stage j % kStages
  auto load_kv = [&](int j) {
    const int s = j % kStages;
    const int k0 = k_begin + j * kBlockN;
    mbar_expect_tx(full(s), L::kStageBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p) {
      tma_load(k_tile(s) + p * L::kKVPanel, &tk, p * L::kBoxCols, k0, kvh, b,
               full(s));
      tma_load(k_tile(s) + L::kKVBytes + p * L::kKVPanel, &tv,
               p * L::kBoxCols, k0, kvh, b, full(s));
    }
  };
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full(s), 1);
      done[s] = 0;
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    mbar_expect_tx(q_full, L::kQBytes);
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
      tma_load(q_s + p * L::kQPanel, &tq, p * L::kBoxCols, q0, h, b, q_full);
    for (int j = 0; j < min(kStages, n_tiles); ++j) load_kv(j);
  }

  // consumer warpgroup wg: CTA rows 64 wg .. 64 wg + 63; this thread holds
  // rows row_a and row_a + 8, columns 8 c + col0 + {0, 1} of each 8-column
  // chunk c of an accumulator
  const int wg = warp / 4;
  const int row_a = wg * 64 + (warp % 4) * 16 + lane / 4;
  const int col0 = 2 * (lane % 4);
  const int wg_rows = min(64, q_rows - wg * 64);
  const int wq_lo = q_lo + wg * 64;
  const int wq_hi = wq_lo + wg_rows - 1;
  // a row with no valid key needs every tile (the mean of v over Skv keys)
  const bool wg_no_key_rows = a.window > 0 && wq_hi >= a.skv - 1 + a.window;

  float o[HD / 2];
#pragma unroll
  for (int i = 0; i < HD / 2; ++i) o[i] = 0.f;
  float m_a = kMasked, m_b = kMasked, l_a = 0.f, l_b = 0.f;
  mbar_wait(q_full, 0);

  for (int j = 0; j < n_tiles; ++j) {
    const int s = j % kStages;
    const int k0 = k_begin + j * kBlockN;
    mbar_wait(full(s), (j / kStages) & 1);
    bool skip = wg_rows <= 0;
    if (!wg_no_key_rows) {
      skip |= a.causal && k0 > wq_hi;
      skip |= a.window > 0 && k0 + kBlockN - 1 <= wq_lo - a.window;
    }
    if (!skip) {
      const uint32_t k_s = k_tile(s), v_s = k_s + L::kKVBytes;
      float sc[kBlockN / 2];
#pragma unroll
      for (int i = 0; i < kBlockN / 2; ++i) sc[i] = 0.f;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk * 16 / L::kBoxCols;
        const int c = (kk * 16 % L::kBoxCols) * 2;
        const uint64_t da =
            desc(q_s + p * L::kQPanel + wg * 64 * L::kRowBytes + c, 16,
                 L::kAtomBytes, L::kLayout);
        const uint64_t db =
            desc(k_s + p * L::kKVPanel + c, 16, L::kAtomBytes, L::kLayout);
        wgmma_ss_n128(sc, da, db, kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(sc);

      const bool straddles =
          k0 + kBlockN > a.skv ||
          (a.causal && k0 + kBlockN - 1 > wq_lo) ||
          (a.window > 0 && wq_hi - k0 >= a.window);
      if (straddles) {
        const int qa = q_lo + row_a;
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) {
          const int q_pos = qa + ((i / 2) % 2) * 8;
          const int k_pos = k0 + (i / 4) * 8 + col0 + i % 2;
          const bool ok = (!a.causal || k_pos <= q_pos) &&
                          (a.window <= 0 || q_pos - k_pos < a.window);
          sc[i] = k_pos >= a.skv ? -INFINITY
                                 : (ok ? sc[i] * a.scale : kMasked);
        }
      } else {
#pragma unroll
        for (int i = 0; i < kBlockN / 2; ++i) sc[i] *= a.scale;
      }

      float mx_a = -INFINITY, mx_b = -INFINITY;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; i += 4) {
        mx_a = fmaxf(mx_a, fmaxf(sc[i], sc[i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sc[i + 2], sc[i + 3]));
      }
#pragma unroll
      for (int d = 1; d < 4; d <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, d));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, d));
      }
      const float mn_a = fmaxf(m_a, mx_a), mn_b = fmaxf(m_b, mx_b);
      const float corr_a = exp2f((m_a - mn_a) * kLog2e);
      const float corr_b = exp2f((m_b - mn_b) * kLog2e);
      m_a = mn_a;
      m_b = mn_b;

      // P as two bf16 parts, packed as the A operand's fragments: k-step
      // kk of 16 keys is hi[4 kk .. 4 kk + 3] and lo[4 kk .. 4 kk + 3]
      uint32_t hi[kBlockN / 4], lo[kBlockN / 4];
      float sum_a = 0.f, sum_b = 0.f;
#pragma unroll
      for (int i = 0; i < kBlockN / 2; i += 4) {
        const float p0 = exp2f((sc[i] - mn_a) * kLog2e);
        const float p1 = exp2f((sc[i + 1] - mn_a) * kLog2e);
        const float p2 = exp2f((sc[i + 2] - mn_b) * kLog2e);
        const float p3 = exp2f((sc[i + 3] - mn_b) * kLog2e);
        sum_a += p0 + p1;
        sum_b += p2 + p3;
        split_bf16(p0, p1, hi[i / 2], lo[i / 2]);
        split_bf16(p2, p3, hi[i / 2 + 1], lo[i / 2 + 1]);
      }
      l_a = l_a * corr_a + sum_a;
      l_b = l_b * corr_b + sum_b;
#pragma unroll
      for (int i = 0; i < HD / 2; i += 4) {
        o[i] *= corr_a;
        o[i + 1] *= corr_a;
        o[i + 2] *= corr_b;
        o[i + 3] *= corr_b;
      }

      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < kBlockN / 16; ++kk) {
        const uint64_t db = desc(v_s + kk * 16 * L::kRowBytes, L::kKVPanel,
                                 L::kAtomBytes, L::kLayout);
        wgmma_pv<HD>(o, hi + 4 * kk, db);
        wgmma_pv<HD>(o, lo + 4 * kk, db);
      }
      wgmma_commit();
      wgmma_wait();
      fence_regs(o);
      fence_regs(hi);
      fence_regs(lo);
    }
    // the last warp done with stage s refills it with tile j + kStages
    if (lane == 0) {
      __threadfence_block();
      if (atomicAdd(&done[s], 1u) == kConsumers * 4 - 1) {
        done[s] = 0;
        __threadfence_block();
        if (j + kStages < n_tiles) load_kv(j + kStages);
      }
    }
  }

  if (wg_rows <= 0) return;
#pragma unroll
  for (int d = 1; d < 4; d <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, d);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, d);
  }
  const float den_a = fmaxf(l_a, 1e-30f), den_b = fmaxf(l_b, 1e-30f);
  __nv_bfloat16* out = static_cast<__nv_bfloat16*>(a.o) + b * a.o_sb +
                       h * a.o_sh + col0;
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int r = row_a + 8 * half;
    if (r < q_rows) {
      const float den = half ? den_b : den_a;
      uint32_t* dst = reinterpret_cast<uint32_t*>(
          out + static_cast<int64_t>(q0 + r) * a.o_ss);
#pragma unroll
      for (int c = 0; c < HD / 8; ++c)
        dst[4 * c] = pack_bf16(o[4 * c + 2 * half] / den,
                               o[4 * c + 2 * half + 1] / den);
    }
  }
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver, through the runtime (no -lcuda).
EncodeTiled encoder() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &found);
#else
    const cudaError_t err = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p)
               : nullptr;
  }();
  return fn;
}

constexpr int kEncodeFailed = 1000;   // + the CUresult of the encode

// One operand's map from its 9 arguments: dims (hd, S, heads, B), byte
// strides of S, heads and B, box (columns, rows).
int encode(CUtensorMap* map, const void* ptr, const int64_t* arg,
           int box_cols, int box_rows, CUtensorMapSwizzle swizzle) {
  if (arg[7] != box_cols || arg[8] != box_rows)
    return static_cast<int>(cudaErrorInvalidValue);
  const EncodeTiled fn = encoder();
  if (fn == nullptr) return static_cast<int>(cudaErrorNotSupported);
  const cuuint64_t dims[4] = {
      static_cast<cuuint64_t>(arg[0]), static_cast<cuuint64_t>(arg[1]),
      static_cast<cuuint64_t>(arg[2]), static_cast<cuuint64_t>(arg[3])};
  const cuuint64_t strides[3] = {static_cast<cuuint64_t>(arg[4]),
                                 static_cast<cuuint64_t>(arg[5]),
                                 static_cast<cuuint64_t>(arg[6])};
  const cuuint32_t box[4] = {static_cast<cuuint32_t>(box_cols),
                             static_cast<cuuint32_t>(box_rows), 1, 1};
  const cuuint32_t elem[4] = {1, 1, 1, 1};
  const CUresult res = fn(map, CU_TENSOR_MAP_DATA_TYPE_BFLOAT16, 4,
                          const_cast<void*>(ptr), dims, strides, box, elem,
                          CU_TENSOR_MAP_INTERLEAVE_NONE, swizzle,
                          CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
                          CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return res == CUDA_SUCCESS ? 0 : kEncodeFailed + static_cast<int>(res);
}

// The dynamic shared-memory limit, raised once per device.
template <int HD>
int allow_smem() {
  static bool done[64] = {false};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64 && done[dev]) return 0;
  err = cudaFuncSetAttribute(flash_fwd_sm90<HD>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             Tile<HD>::kSmemBytes);
  if (err != cudaSuccess) return static_cast<int>(err);
  if (dev >= 0 && dev < 64) done[dev] = true;
  return 0;
}

template <int HD>
int launch(const void* q, const void* k, const void* v, const Params& a,
           int batch, int heads, const int64_t* maps, void* stream) {
  using L = Tile<HD>;
  const CUtensorMapSwizzle swizzle = L::kRowBytes == 128
                                         ? CU_TENSOR_MAP_SWIZZLE_128B
                                         : CU_TENSOR_MAP_SWIZZLE_64B;
  CUtensorMap tq, tk, tv;
  int err = encode(&tq, q, maps, L::kBoxCols, kBlockM, swizzle);
  if (!err) err = encode(&tk, k, maps + 9, L::kBoxCols, kBlockN, swizzle);
  if (!err) err = encode(&tv, v, maps + 18, L::kBoxCols, kBlockN, swizzle);
  if (!err) err = allow_smem<HD>();
  if (err) return err;
  const dim3 grid(heads, batch, (a.sq + kBlockM - 1) / kBlockM);
  flash_fwd_sm90<HD><<<grid, kThreads, L::kSmemBytes,
                       static_cast<cudaStream_t>(stream)>>>(tq, tk, tv, a);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// maps: 27 values, 9 for each of q, k, v (see `encode`); o_strides: the
// element strides of o's (B, H, S); o's head dim is contiguous.  Returns
// the CUDA error of the launch, or 1000 + the CUresult of a failed encode.
extern "C" int flash_attention_sm90_bf16(
    const void* q, const void* k, const void* v, void* o, int batch,
    int heads, int kv_heads, int sq, int skv, int hd, const int64_t* maps,
    const int64_t* o_strides, float scale, int causal, int window,
    int q_offset, void* stream) {
  if (sq <= 0) return 0;
  if (skv <= 0 || kv_heads <= 0 || heads % kv_heads != 0 ||
      batch > 65535 || (sq + kBlockM - 1) / kBlockM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  Params a;
  a.o = o;
  a.group = heads / kv_heads;
  a.sq = sq;
  a.skv = skv;
  a.o_sb = o_strides[0];
  a.o_sh = o_strides[1];
  a.o_ss = o_strides[2];
  a.scale = scale;
  a.causal = causal;
  a.window = window;
  a.q_offset = q_offset;
  switch (hd) {
    case 32:
      return launch<32>(q, k, v, a, batch, heads, maps, stream);
    case 64:
      return launch<64>(q, k, v, a, batch, heads, maps, stream);
    case 128:
      return launch<128>(q, k, v, a, batch, heads, maps, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Dynamic shared memory a CTA of the kernel for head dim `hd` asks for
// (ptxas reports only static shared memory), or -1.
extern "C" int flash_attention_sm90_smem_bytes(int hd) {
  switch (hd) {
    case 32:
      return Tile<32>::kSmemBytes;
    case 64:
      return Tile<64>::kSmemBytes;
    case 128:
      return Tile<128>::kSmemBytes;
    default:
      return -1;
  }
}
