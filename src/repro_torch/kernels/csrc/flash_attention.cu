// Blockwise online-softmax attention (flash attention) for Hopper (sm_90a),
// on the tensor cores.
//
// Replaces the TPU kernel K7 of src/repro/kernels/flash_attention.py:
// _kernel (:24) launched by flash_attention_3d (:78), whose GQA wrapper is
// kernels/ops.py:131 flash_attention.  For q (BH, S, hd) and k, v (BH, T, hd),
// f32 or bf16 (all three alike), it computes per row i of q
//
//     s_j   = (q_i * hd^-0.5) . k_j              f32 accumulation
//     p_j   = exp(s_j - max_j s_j), masked keys 0
//     out_i = sum_j p_j v_j / max(sum_j p_j, 1e-30)   in q's dtype
//
// where key j is visible to row i iff j <= pos(i) under ``causal`` (every key
// otherwise), with pos(i) = i % period for period > 0 (the GQA group-folded
// layout: G query heads of one KV head stacked as G*S rows) and pos(i) = i
// for period 0.  S and T need not be multiples of a tile: rows past S are
// not written and keys past T are invisible.  Given an ``lse`` pointer, both
// paths also write each row's f32 log-sum-exp of its masked, scaled scores,
//
//     lse_i = log sum_j exp(s_j),   (bh, s) floats,
//
// which the backward (csrc/flash_attention_bwd.cu) recomputes P from.
//
// What bounds it on this card: operations.  4*hd flops per visible (query,
// key) pair against 2-4 bytes per element moved once: at the model path's
// shapes (S = T >= 1024, hd 64-128) hundreds of flops a byte, far above the
// H100's ~295 (bf16) or ~150 (TF32) flops per byte of HBM.  The least time
// is the visible pairs' flops over the tensor-core rate: 989 TFLOP/s dense
// bf16, 495 TF32.
//
// Both paths own 128 query rows of one bh per block and walk the 64-key
// tiles of K and V in order, keeping the running max, normaliser and output
// in f32 registers.  Key tiles wholly above the causal diagonal of a block's
// rows (period taken into account) are not loaded; a warp or warpgroup whose
// own rows end earlier skips the block's last tiles; within a visited tile
// a masked key adds exactly 0.  The grid puts bh on x and the row blocks on
// y, last rows first, so the heaviest causal blocks of every bh start first.
//
// bf16: wgmma from shared memory filled by TMA, warp-specialised.
// - one producer warp keeps a ring of K and V tiles in flight (4 stages at
//   hd <= 64, 3 at 128) with cp.async.bulk.tensor on 3-D tensor maps (hd,
//   rows, bh), so a box never reads another slice's rows and TMA zero-fills
//   the ragged tails (a zero-filled key scores 0, so keys past T are masked
//   explicitly); mbarriers signal full (transaction bytes) and empty (one
//   arrive per consumer warp);
// - two consumer warpgroups own 64 rows each.  S = Q K^T is wgmma m64n64k16
//   with Q and K both K-major in shared memory (128-byte swizzle, 64-byte at
//   hd = 32; hd = 128 is stored as two 64-column panels); P is rounded to
//   bf16 in registers, where the accumulator's layout is already wgmma's
//   register-A layout, and O += P V is the register-A wgmma with V as the
//   MN-major B operand, straight from the tile TMA wrote;
// - once P is in registers the next tile's S is issued into the freed
//   accumulator, so it runs on the tensor cores back to back with P V;
// - the softmax runs in base 2 (ex2.approx) on the f32 accumulator, the
//   scale * log2 e and the max's subtraction folded into one FMA; the
//   normaliser sums the unrounded f32 p.
//
// f32: three-pass TF32 (3xTF32) on mma.sync, cp.async double buffering.
// - a single TF32 product keeps 10 mantissa bits, too few for the f32
//   tolerance at S = 4096 or for 24 layers of logits; each operand is split
//   x = hi + lo (hi = x rounded to TF32 on its bit pattern, lo = x - hi,
//   which the tensor core reads truncated) and each product taken as
//   lo*hi + hi*lo + hi*hi with f32 accumulation, which drops only lo*lo
//   (~2^-21 relative);
// - eight warps own 16 rows each (mma.sync.m16n8k8); Q, and K and V in two
//   buffers, sit in shared memory in f32 with rows padded by 4 floats (the
//   fragment loads hit 32 distinct banks) and are split on the fly, in
//   three integer and float operations an element;
// - the P operand of P V comes straight from the S accumulator: the keys of
//   each 8-key step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), which
//   turns the accumulator's (2t, 2t+1) columns into the A fragment's (t,
//   t+4) and costs only the same permutation of V's rows.  wgmma takes TF32
//   only K-major, which would need V transposed in shared memory; mma.sync
//   reads V as it lies;
// - the softmax is exp(x) = 2^(x log2 e) by ex2.approx (2 ulp), the max's
//   subtraction folded into the FMA.
#include <math.h>

#include "hopper.cuh"  // 3xTF32, cp.async, TMA, wgmma, tensor maps

namespace {

constexpr int kRows = 128;  // query rows a block owns
constexpr int kKeys = 64;   // keys a tile holds

__device__ __forceinline__ int row_pos(int row, int period) {
  return period > 0 ? row % period : row;
}

// The causal positions rows [first, last] reach, largest and smallest.
struct Span {
  int max_pos, min_pos;
};

__device__ __forceinline__ Span span(int first, int last, int period) {
  if (period > 0) {
    if (first / period != last / period) return {period - 1, 0};
    return {last % period, first % period};
  }
  return {last, first};
}

// The key tiles rows [first, last] can see.
__device__ __forceinline__ int visible_tiles(int first, int last, int t,
                                             int causal, int period) {
  int n = (t + kKeys - 1) / kKeys;
  if (causal) n = min(n, span(first, last, period).max_pos / kKeys + 1);
  return n;
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync.m16n8k8
// ---------------------------------------------------------------------------
namespace f32k {

constexpr int kThreads = 256;  // 8 warps x 16 rows

template <int HD>
struct Layout {
  static constexpr int kStride = HD + 4;  // floats a shared row takes
  static constexpr int kFloats = (kRows + 4 * kKeys) * kStride;
};

// Rows [row0, row0 + n) of a (rows, HD) slice into shared memory at stride
// HD + 4; rows at or past ``rows`` are zero-filled.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int rows, int n) {
  constexpr int kC4 = HD / 4;
  for (int idx = threadIdx.x; idx < n * kC4; idx += kThreads) {
    const int r = idx / kC4, c = (idx % kC4) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * Layout<HD>::kStride + c,
               src + (long long)(ok ? row0 + r : 0) * HD + c, ok);
  }
}

template <int HD>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
attention(const float* __restrict__ q, const float* __restrict__ k,
          const float* __restrict__ v, float* __restrict__ o,
          float* __restrict__ lse, int S, int T, int causal, int period,
          float scale) {
  constexpr int kStride = Layout<HD>::kStride;
  constexpr int kND = HD / 8;  // 8-column blocks of the output
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* ks = qs + kRows * kStride;      // two buffers of kKeys rows
  float* vs = ks + 2 * kKeys * kStride;  // likewise

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const long long bh = blockIdx.x;
  q += bh * S * HD;
  k += bh * T * HD;
  v += bh * T * HD;
  o += bh * S * HD;
  if (lse != nullptr) lse += bh * S;

  const int n_tiles = visible_tiles(r0, min(r0 + kRows, S) - 1, T, causal,
                                    period);
  // this warp's 16 rows: thread rows a = wr0 + g and b = a + 8
  const int wr0 = r0 + 16 * warp;
  const int w_last = min(wr0 + 15, S - 1);
  const bool has_rows = w_last >= wr0;
  const Span ws = span(wr0, has_rows ? w_last : wr0, period);
  const int row_a = wr0 + g, row_b = row_a + 8;
  const int pos_a = row_pos(row_a, period), pos_b = row_pos(row_b, period);

  stage<HD>(qs, q, r0, S, kRows);
  stage<HD>(ks, k, 0, T, kKeys);
  stage<HD>(vs, v, 0, T, kKeys);
  cp_commit();

  float acc[kND][4];
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int buf = t & 1;
    if (t + 1 < n_tiles) {
      stage<HD>(ks + (buf ^ 1) * kKeys * kStride, k, (t + 1) * kKeys, T,
                kKeys);
      stage<HD>(vs + (buf ^ 1) * kKeys * kStride, v, (t + 1) * kKeys, T,
                kKeys);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int k0 = t * kKeys;
    if (has_rows && (!causal || k0 <= ws.max_pos)) {
      const float* kt = ks + buf * kKeys * kStride;
      const float* vt = vs + buf * kKeys * kStride;
      // S = (q * scale) K^T over this tile's 64 keys
      float s[8][4];
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) s[n][j] = 0.0f;
#pragma unroll 2
      for (int kk = 0; kk < HD / 8; ++kk) {
        const float* qa = qs + (16 * warp + g) * kStride + 8 * kk + tq;
        uint32_t ah[4], al[4];
        split(qa[0] * scale, ah[0], al[0]);
        split(qa[8 * kStride] * scale, ah[1], al[1]);
        split(qa[4] * scale, ah[2], al[2]);
        split(qa[8 * kStride + 4] * scale, ah[3], al[3]);
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float* kb = kt + (8 * n + g) * kStride + 8 * kk + tq;
          uint32_t bh0, bl0, bh1, bl1;
          split(kb[0], bh0, bl0);
          split(kb[4], bh1, bl1);
          mma3(s[n], ah, al, bh0, bh1, bl0, bl1);
        }
      }
      // mask: keys past T, and above the diagonal under causal
      if (k0 + kKeys > T || (causal && k0 + kKeys - 1 > ws.min_pos)) {
#pragma unroll
        for (int n = 0; n < 8; ++n)
#pragma unroll
          for (int j = 0; j < 4; ++j) {
            const int key = k0 + 8 * n + 2 * tq + (j & 1);
            const int pos = j < 2 ? pos_a : pos_b;
            if (key >= T || (causal && key > pos)) s[n][j] = -INFINITY;
          }
      }
      // online softmax; a row's 64 keys lie in one quad of lanes
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        mx_a = fmaxf(mx_a, fmaxf(s[n][0], s[n][1]));
        mx_b = fmaxf(mx_b, fmaxf(s[n][2], s[n][3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      // key 0 is visible to every row, so the max is finite from tile 0 on;
      // e^x as 2^(x log2 e), the subtraction folded into one FMA
      const float c_a = ex2((m_a - mx_a) * kLog2e);
      const float c_b = ex2((m_b - mx_b) * kLog2e);
      m_a = mx_a;
      m_b = mx_b;
      const float ms_a = m_a * kLog2e, ms_b = m_b * kLog2e;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        s[n][0] = ex2(fmaf(s[n][0], kLog2e, -ms_a));
        s[n][1] = ex2(fmaf(s[n][1], kLog2e, -ms_a));
        s[n][2] = ex2(fmaf(s[n][2], kLog2e, -ms_b));
        s[n][3] = ex2(fmaf(s[n][3], kLog2e, -ms_b));
        sum_a += s[n][0] + s[n][1];
        sum_b += s[n][2] + s[n][3];
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
#pragma unroll
      for (int n = 0; n < kND; ++n) {
        acc[n][0] *= c_a;
        acc[n][1] *= c_a;
        acc[n][2] *= c_b;
        acc[n][3] *= c_b;
      }
      // O += P V, the keys of step kk taken as 8kk + (0, 2, 4, 6, 1, 3, 5, 7)
#pragma unroll
      for (int kk = 0; kk < 8; ++kk) {
        uint32_t ph[4], pl[4];
        split(s[kk][0], ph[0], pl[0]);
        split(s[kk][2], ph[1], pl[1]);
        split(s[kk][1], ph[2], pl[2]);
        split(s[kk][3], ph[3], pl[3]);
        const float* vb = vt + (8 * kk + 2 * tq) * kStride + g;
#pragma unroll
        for (int n = 0; n < kND; ++n) {
          uint32_t bh0, bl0, bh1, bl1;
          split(vb[8 * n], bh0, bl0);
          split(vb[kStride + 8 * n], bh1, bl1);
          mma3(acc[n], ph, pl, bh0, bh1, bl0, bl1);
        }
      }
    }
    __syncthreads();  // the next tile's loads reuse this buffer
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int col = 8 * n + 2 * tq;
    if (row_a < S)
      *reinterpret_cast<float2*>(o + (long long)row_a * HD + col) =
          make_float2(acc[n][0] / d_a, acc[n][1] / d_a);
    if (row_b < S)
      *reinterpret_cast<float2*>(o + (long long)row_b * HD + col) =
          make_float2(acc[n][2] / d_b, acc[n][3] / d_b);
  }
  // the scores were scaled before the max: lse = m + log l
  if (lse != nullptr && tq == 0) {
    if (row_a < S) lse[row_a] = m_a + logf(d_a);
    if (row_b < S) lse[row_b] = m_b + logf(d_b);
  }
}

}  // namespace f32k

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------
namespace bf16k {

constexpr int kConsumers = 256;      // two warpgroups of 64 rows
constexpr int kThreads = kConsumers + 32;

template <int HD>
struct Layout {
  // one shared row of a panel is one swizzle span: 64 columns (128 bytes),
  // or all 32 at hd = 32 (64 bytes)
  static constexpr int kPanelCols = HD < 64 ? HD : 64;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;  // wgmma's code
  static constexpr int kQBytes = kRows * HD * 2;
  static constexpr int kTileBytes = kKeys * HD * 2;  // one K or V tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  // the K/V ring's depth: 4 stages (64 KB) at hd <= 64, 3 (96 KB) at 128
  static constexpr int kStages = HD <= 64 ? 4 : 3;
  // 1024 bytes of slack to align the tiles to the swizzle atom, then the
  // tiles, then 2 * kStages + 1 mbarriers
  static constexpr int kBytes =
      1024 + kQBytes + kStages * kStageBytes + 8 * (2 * kStages + 1);
};


template <int HD>
__global__ void __launch_bounds__(kThreads, 1)
attention(const __grid_constant__ CUtensorMap qmap,
          const __grid_constant__ CUtensorMap kmap,
          const __grid_constant__ CUtensorMap vmap,
          __nv_bfloat16* __restrict__ o, float* __restrict__ lse, int S,
          int T, int causal, int period, float scale_log2) {
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kPW = L::kPanelCols;
  constexpr int kRB = L::kRowBytes;
  constexpr int kStepsPerPanel = kPW / 16;  // k16 steps along hd a panel
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  uint64_t* bars = reinterpret_cast<uint64_t*>(
      base + L::kQBytes + kStages * L::kStageBytes);
  uint64_t* q_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int r0 = (gridDim.y - 1 - blockIdx.y) * kRows;
  const int bh = blockIdx.x;
  const int n_tiles = visible_tiles(r0, min(r0 + kRows, S) - 1, T, causal,
                                    period);
  if (threadIdx.x == 0) {
    mbar_init(q_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread issues every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(q_full, L::kQBytes);
      for (int p = 0; p < L::kPanels; ++p)
        tma_load(base + p * kRows * kRB, &qmap, q_full, p * kPW, r0, bh);
      for (int t = 0; t < n_tiles; ++t) {
        const int s = t % kStages, round = t / kStages;
        if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
        mbar_expect_tx(full + s, L::kStageBytes);
        uint8_t* kt = base + L::kQBytes + s * L::kStageBytes;
        uint8_t* vt = kt + L::kTileBytes;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(kt + p * kKeys * kRB, &kmap, full + s, p * kPW,
                   t * kKeys, bh);
          tma_load(vt + p * kKeys * kRB, &vmap, full + s, p * kPW,
                   t * kKeys, bh);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows r0 + 64 wg + [0, 64)
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int row0 = r0 + 64 * wg;
  const int last = min(row0 + 63, S - 1);
  int my_tiles = 0, min_pos = 0;
  if (last >= row0) {
    my_tiles = visible_tiles(row0, last, T, causal, period);
    min_pos = span(row0, last, period).min_pos;
  }
  // a thread's accumulator rows: a and b = a + 8
  const int row_a = row0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int row_b = row_a + 8;
  const int pos_a = row_pos(row_a, period), pos_b = row_pos(row_b, period);

  float sacc[32];
#pragma unroll
  for (int i = 0; i < 32; ++i) sacc[i] = 0.0f;
  float oacc[L::kPanels][kPW / 2];
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kPW / 2; ++i) oacc[p][i] = 0.0f;
  float m_a = -INFINITY, m_b = -INFINITY, l_a = 0.0f, l_b = 0.0f;

  const uint32_t q_base = smem_u32(base) + 64 * wg * kRB;
  // S = Q K^T for tile t into sacc: both K-major, 16 columns of hd a step
  auto issue_s = [&](int t) {
    const uint32_t k_base =
        smem_u32(base + L::kQBytes + (t % kStages) * L::kStageBytes);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < HD / 16; ++kk) {
      const int p = kk / kStepsPerPanel;
      const uint32_t off = (kk % kStepsPerPanel) * 32;
      wgmma_ss_n64(sacc,
                   make_desc(q_base + p * kRows * kRB + off, 16, 8 * kRB,
                             L::kSwizzle),
                   make_desc(k_base + p * kKeys * kRB + off, 16, 8 * kRB,
                             L::kSwizzle),
                   kk > 0);
    }
    wgmma_commit();
  };

  mbar_wait(q_full, 0);
  if (my_tiles > 0) {
    mbar_wait(full, 0);
    issue_s(0);
    wgmma_wait();
    pin(sacc);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int s = t % kStages;
    if (t < my_tiles) {
      // sacc[4i + j]: row (j < 2 ? a : b), key k0 + 8i + 2(lane%4) + (j&1);
      // the running max m is kept in raw score units
      const int k0 = t * kKeys;
      if (k0 + kKeys > T || (causal && k0 + kKeys - 1 > min_pos)) {
#pragma unroll
        for (int e = 0; e < 32; ++e) {
          const int key = k0 + 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
          const int pos = (e & 2) ? pos_b : pos_a;
          if (key >= T || (causal && key > pos)) sacc[e] = -INFINITY;
        }
      }
      float mx_a = m_a, mx_b = m_b;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        mx_a = fmaxf(mx_a, fmaxf(sacc[4 * i], sacc[4 * i + 1]));
        mx_b = fmaxf(mx_b, fmaxf(sacc[4 * i + 2], sacc[4 * i + 3]));
      }
#pragma unroll
      for (int off = 1; off <= 2; off <<= 1) {
        mx_a = fmaxf(mx_a, __shfl_xor_sync(0xffffffffu, mx_a, off));
        mx_b = fmaxf(mx_b, __shfl_xor_sync(0xffffffffu, mx_b, off));
      }
      // key 0 is visible to every row, so the max is finite from tile 0 on
      const float c_a = ex2((m_a - mx_a) * scale_log2);
      const float c_b = ex2((m_b - mx_b) * scale_log2);
      m_a = mx_a;
      m_b = mx_b;
      const float ms_a = m_a * scale_log2, ms_b = m_b * scale_log2;
      float sum_a = 0.0f, sum_b = 0.0f;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        sacc[4 * i] = ex2(fmaf(sacc[4 * i], scale_log2, -ms_a));
        sacc[4 * i + 1] = ex2(fmaf(sacc[4 * i + 1], scale_log2, -ms_a));
        sacc[4 * i + 2] = ex2(fmaf(sacc[4 * i + 2], scale_log2, -ms_b));
        sacc[4 * i + 3] = ex2(fmaf(sacc[4 * i + 3], scale_log2, -ms_b));
        sum_a += sacc[4 * i] + sacc[4 * i + 1];
        sum_b += sacc[4 * i + 2] + sacc[4 * i + 3];
      }
      l_a = l_a * c_a + sum_a;
      l_b = l_b * c_b + sum_b;
      // P in bf16, already in wgmma's register-A layout: step kk's
      // registers are the accumulator's columns 16kk .. 16kk + 15
      uint32_t pa[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r)
          pa[kk][r] = pack_bf16(sacc[8 * kk + 2 * r],
                                sacc[8 * kk + 2 * r + 1]);
      // sacc is free: the next tile's S runs while P V is issued
      if (t + 1 < my_tiles) {
        mbar_wait(full + (t + 1) % kStages, ((t + 1) / kStages) & 1);
        issue_s(t + 1);
      }
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
        for (int i = 0; i < kPW / 8; ++i) {
          oacc[p][4 * i] *= c_a;
          oacc[p][4 * i + 1] *= c_a;
          oacc[p][4 * i + 2] *= c_b;
          oacc[p][4 * i + 3] *= c_b;
        }
      // O += P V: V is the MN-major B operand, 16 keys a step
      const uint32_t v_base =
          smem_u32(base + L::kQBytes + s * L::kStageBytes) + L::kTileBytes;
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          const uint64_t dv =
              make_desc(v_base + p * kKeys * kRB + kk * 16 * kRB,
                        kKeys * kRB, 8 * kRB, L::kSwizzle);
          if constexpr (kPW == 64)
            wgmma_rs_n64(oacc[p], pa[kk], dv);
          else
            wgmma_rs_n32(oacc[p], pa[kk], dv);
        }
      wgmma_commit();
      wgmma_wait();
      pin(sacc);
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) pin(oacc[p]);
    } else {
      mbar_wait(full + s, (t / kStages) & 1);  // released unread
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with stage s
  }

#pragma unroll
  for (int off = 1; off <= 2; off <<= 1) {
    l_a += __shfl_xor_sync(0xffffffffu, l_a, off);
    l_b += __shfl_xor_sync(0xffffffffu, l_b, off);
  }
  const float d_a = fmaxf(l_a, 1e-30f), d_b = fmaxf(l_b, 1e-30f);
  o += (long long)bh * S * HD;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kPW / 8; ++i) {
      const int col = p * kPW + 8 * i + 2 * (lane % 4);
      if (row_a < S)
        *reinterpret_cast<uint32_t*>(o + (long long)row_a * HD + col) =
            pack_bf16(oacc[p][4 * i] / d_a, oacc[p][4 * i + 1] / d_a);
      if (row_b < S)
        *reinterpret_cast<uint32_t*>(o + (long long)row_b * HD + col) =
            pack_bf16(oacc[p][4 * i + 2] / d_b, oacc[p][4 * i + 3] / d_b);
    }
  // m is in raw score units: lse = (m scale log2 e + log2 l) ln 2
  if (lse != nullptr && lane % 4 == 0) {
    lse += (long long)bh * S;
    if (row_a < S) lse[row_a] = (m_a * scale_log2 + log2f(d_a)) * kLn2;
    if (row_b < S) lse[row_b] = (m_b * scale_log2 + log2f(d_b)) * kLn2;
  }
}

}  // namespace bf16k

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

dim3 grid(int bh, int s) { return dim3(bh, (s + kRows - 1) / kRows); }

template <int HD>
int run_f32(const void* q, const void* k, const void* v, void* o, float* lse,
            int bh, int s, int t, int causal, int period, float scale,
            cudaStream_t stream) {
  const int bytes = f32k::Layout<HD>::kFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      f32k::attention<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err != cudaSuccess) return (int)err;
  f32k::attention<HD><<<grid(bh, s), f32k::kThreads, bytes, stream>>>(
      (const float*)q, (const float*)k, (const float*)v, (float*)o, lse, s,
      t, causal, period, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int run_bf16(const void* q, const void* k, const void* v, void* o,
             float* lse, int bh, int s, int t, int causal, int period,
             float scale, cudaStream_t stream) {
  using L = bf16k::Layout<HD>;
  CUtensorMap qmap, kmap, vmap;
  int rc = make_map(&qmap, q, HD, s, bh, L::kPanelCols, kRows);
  if (rc == 0) rc = make_map(&kmap, k, HD, t, bh, L::kPanelCols, kKeys);
  if (rc == 0) rc = make_map(&vmap, v, HD, t, bh, L::kPanelCols, kKeys);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      bf16k::attention<HD>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err != cudaSuccess) return (int)err;
  bf16k::attention<HD><<<grid(bh, s), bf16k::kThreads, L::kBytes, stream>>>(
      qmap, kmap, vmap, (__nv_bfloat16*)o, lse, s, t, causal, period,
      scale * kLog2e);
  return (int)cudaGetLastError();
}

typedef int (*Runner)(const void*, const void*, const void*, void*, float*,
                      int, int, int, int, int, float, cudaStream_t);

int dispatch(Runner r32, Runner r64, Runner r128, const void* q,
             const void* k, const void* v, void* o, void* lse, int bh, int s,
             int t, int hd, int causal, int period, float scale,
             void* stream) {
  if (bh < 1 || s < 1 || t < 1 || period < 0 ||
      (s + kRows - 1) / kRows > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Runner run = hd == 32 ? r32 : hd == 64 ? r64 : hd == 128 ? r128 : nullptr;
  if (run == nullptr) return (int)cudaErrorInvalidValue;
  return run(q, k, v, o, (float*)lse, bh, s, t, causal, period, scale,
             (cudaStream_t)stream);
}

}  // namespace

// q, o: (bh, s, hd); k, v: (bh, t, hd); contiguous, 16-byte aligned; lse:
// null, or (bh, s) floats for the rows' log-sum-exp.  Returns the launch's CUDA error code (kMapError + the driver's code when
// a bf16 tensor map is refused).
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, void* lse, int bh,
                                   int s, int t, int hd, int causal,
                                   int period, float scale, void* stream) {
  return dispatch(run_f32<32>, run_f32<64>, run_f32<128>, q, k, v, o, lse,
                  bh, s, t, hd, causal, period, scale, stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, void* lse,
                                    int bh, int s, int t, int hd, int causal,
                                    int period, float scale, void* stream) {
  return dispatch(run_bf16<32>, run_bf16<64>, run_bf16<128>, q, k, v, o,
                  lse, bh, s, t, hd, causal, period, scale, stream);
}
