// The backward of K7 (blockwise attention) for Hopper (sm_90a), on the
// tensor cores.
//
// Replaces no TPU kernel: the reference trains through its XLA attention
// (src/repro/models/attention.py) and never differentiates its Pallas K7.
// The port runs the model's attention through K7 on the card
// (models/attention.py flash_gqa), so training needs K7's gradient; this
// kernel gives it without materialising the (S, T) scores, in O(S + T)
// memory a slice.  For q, o, dO (BH, S, hd), k, v (BH, T, hd), f32 or bf16
// (all alike), and the forward's row log-sum-exp lse (BH, S) in f32:
//
//     P  = exp(q k^T * hd^-0.5 - lse)     invisible keys 0
//     D  = rowsum(dO * O)
//     dV = P^T dO,  dP = dO V^T,  dS = P * (dP - D)
//     dQ = dS K * hd^-0.5,  dK = dS^T Q * hd^-0.5
//
// with K7's visibility rule (key j visible to row i iff j <= pos(i) under
// causal, pos(i) = i % period for period > 0, else i; keys past T never).
// Under a period (the GQA fold: G query heads of one KV head stacked as G*S
// rows) dK and dV sum over every folded row that sees a key, the G heads'
// sum, by construction.  Accumulation in f32; outputs in the input dtype.
//
// What bounds it on this card: operations.  5 products of 2 hd flops, 10 hd
// flops, a visible (row, key) pair, against a few bytes an element: at the
// train step's shapes (S = T = 4096, hd = 64) far above the card's flops a
// byte.  Every product runs on the tensor cores.
//
// Launches on the stream, in order:
// 1. prep: D and lse * log2 e of every row, one warp a row, into scratch
//    rows padded to a multiple of 128 (zero past S), so that a tile of them
//    is one aligned copy;
// 2. dkdv: a block owns a tile of keys of one bh, holds its K and V, and
//    walks the 64-row query tiles that can see them (the rest are skipped),
//    recomputing S^T = K Q^T and dP^T = V dO^T with the keys as the M side,
//    then P^T and dS^T in registers, and dV += P^T dO, dK += dS^T Q.  Blocks
//    run heaviest first (key tile 0 sees the most rows under causal);
// 3. sum_parts, only where the walk is split (below): the parts' f32 dK and
//    dV summed in part order into the output dtype;
// 4. dq: a block owns a tile of query rows, holds Q and dO, and walks the
//    key tiles its rows can see, recomputing S and dP, then dS, and
//    dQ += dS K.  The last row tiles (the most keys under causal) first.
// No block writes what another writes and no atomics are used: dQ gets a
// pass of its own at the price of computing S and dP twice, 7 tile
// products a pair where the bound counts 5 (10 in bf16, below).  Every sum runs in an order
// fixed by the shapes alone (not by BH, so a vmap fold gives each slice
// the bits of its own call), so two calls give the same bits.
//
// The split walk.  A dK/dV block's walk is cut into parts of ``chunk`` row
// tiles: one folded group's tiles a part under a period (the yi-9b fold,
// 8 groups of 2048 rows: 8 parts of at most 32 tiles, 8x the blocks of an
// unsplit grid that would leave the card half idle), else 64 tiles
// (4,096 rows).  Each part writes its f32 dK and dV to scratch; sum_parts
// adds them.  ``plan`` here and ``bwd_plan`` in kernels/flash_attention.py
// compute the split alike; the wrapper sizes the scratch from it.
//
// f32: 3xTF32 on mma.sync.m16n8k8 (hopper.cuh), as K7's forward.  A single
// TF32 pass keeps 10 mantissa bits, too few for the f32 train step's
// tolerance; each operand is split x = hi + lo and each product taken as
// lo*hi + hi*lo + hi*hi in f32.  A block is 64 owner rows (keys in dkdv,
// query rows in dq) and 8 warps: warp w takes owner rows 16 (w % 4) .. +15
// against streamed rows 32 (w / 4) .. +31 of each 64-row tile, and the two
// streamed halves' sums are added (first + second) at the end.  The owner
// tiles sit in shared memory; the streamed tiles (Q and dO, or K and V) are
// double-buffered with cp.async.  Rows are padded by 4 floats, so every
// fragment load hits 32 banks.  The second product's A operand (P^T or
// dS^T, dS) comes straight from the first's accumulator: the streamed rows
// of each 8-row step are taken in the order (0, 2, 4, 6, 1, 3, 5, 7), which
// turns the accumulator's (2t, 2t+1) columns into the A fragment's (t,
// t+4), and costs the same permutation of the B operand's rows.  The
// tensor core rounds its f32 sums toward zero, so each tile's second
// product is summed in fresh registers and added to the running dK, dV or
// dQ in f32 (product_acc): fed straight through mma, the running sums of a
// 4,096-row walk shrank by ~1e-4 of themselves.
//
// bf16: wgmma on shared memory filled by TMA, warp-specialised as K7's
// bf16 forward.  A block is 128 owner rows, two consumer warpgroups of 64
// and one producer warp, which loads the owner tiles once and keeps a ring
// of streamed tiles in flight (with the rows' lse and D in dkdv, by bulk
// copies).  S^T = K Q^T and dP^T = V dO^T (or S = Q K^T, dP = dO V^T) are
// SS wgmmas with both operands K-major; P^T and dS^T (or dS) are taken in
// registers, where the accumulator already lies in wgmma's register-A
// layout, as two bf16 terms each, hi (x rounded) + lo (the rest rounded),
// and feed register-A wgmmas with dO and Q (or K) as the MN-major B operand,
// straight from the tiles TMA wrote.  One rounding of P was too coarse: the
// first rows' P is large (~1/3 at row 2), a key's dV small by cancellation,
// and at hd = 128 one element missed bf16's tolerance; the lo terms cost
// one more register-A wgmma a product (10 products a pair in all) and keep
// ~2^-16 of each term.  What is left against the plain version (which
// computes in f32 and rounds once) is the outputs' rounding to bf16, which
// bf16's tolerance is for.
#include <math.h>

#include "hopper.cuh"  // 3xTF32, cp.async, TMA, wgmma, tensor maps

namespace {

constexpr int kTile = 64;     // rows of a streamed tile, and of a walk step
constexpr int kRowPad = 128;  // the scratch rows of lse and D pad S to this
constexpr int kMaxWalk = 64;  // row tiles a part walks at most, no period

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}

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

// Whether rows [r, r + nr) and keys [c, c + nc) hold a visible pair (any)
// and only visible pairs (all).
struct Vis {
  bool any, all;
};

__device__ __forceinline__ Vis visibility(int r, int nr, int c, int nc,
                                          int S, int T, int causal,
                                          int period) {
  if (r >= S || c >= T) return {false, false};
  const bool inside = r + nr <= S && c + nc <= T;
  if (!causal) return {true, inside};
  const Span sp = span(r, min(r + nr, S) - 1, period);
  return {c <= sp.max_pos, inside && c + nc - 1 <= sp.min_pos};
}

__device__ __forceinline__ bool visible(int row, int key, int S, int T,
                                        int causal, int period) {
  return row < S && key < T && (!causal || key <= row_pos(row, period));
}

// The first row tile in [qt, end) whose rows see key ``key`` (end if none).
__device__ __forceinline__ int next_tile(int qt, int end, int S, int key,
                                         int causal, int period) {
  while (qt < end &&
         !visibility(qt * kTile, kTile, key, 1, S, 0x7fffffff, causal,
                     period).any)
    ++qt;
  return qt;
}

// The split of a dK/dV block's walk over the n_q row tiles: parts of
// ``chunk`` tiles (kernels/flash_attention.py bwd_plan computes the same).
struct Plan {
  int chunk, parts;
};

Plan plan(int s, int period) {
  const int n_q = (s + kTile - 1) / kTile;
  int chunk = period > 0 ? (period + kTile - 1) / kTile : kMaxWalk;
  chunk = chunk < n_q ? chunk : n_q;
  chunk = chunk > 1 ? chunk : 1;
  return {chunk, (n_q + chunk - 1) / chunk};
}

__device__ __forceinline__ void put2(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
__device__ __forceinline__ void put2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<uint32_t*>(p) = pack_bf16(a, b);
}

// D and lse * log2 e of the padded rows, one warp a row; zero past S.
template <int HD, typename T>
__global__ void __launch_bounds__(256)
prep(const T* __restrict__ o, const T* __restrict__ dout,
     const float* __restrict__ lse, float* __restrict__ l2,
     float* __restrict__ dd, int S, int s_pad, long long rows_pad) {
  const long long idx = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (idx >= rows_pad) return;
  const long long bh = idx / s_pad;
  const int r = (int)(idx % s_pad);
  float acc = 0.0f;
  if (r < S) {
    const long long row = bh * S + r;
#pragma unroll
    for (int c = lane; c < HD; c += 32)
      acc = fmaf(to_f(o[row * HD + c]), to_f(dout[row * HD + c]), acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) {
    dd[idx] = acc;
    l2[idx] = r < S ? lse[bh * S + r] * kLog2e : 0.0f;
  }
}

// dK = (sum of the parts' dK) * scale, dV = sum of the parts' dV, the parts
// added in order: ``part`` holds parts dK slabs of n floats, then parts dV
// slabs.  One thread per 4 floats.
template <typename T>
__global__ void __launch_bounds__(256)
sum_parts(const float* __restrict__ part, T* __restrict__ dk,
          T* __restrict__ dv, long long n, int parts, float scale) {
  const long long n4 = n / 4;
  long long i = (long long)blockIdx.x * 256 + threadIdx.x;
  if (i >= 2 * n4) return;
  const bool is_v = i >= n4;
  if (is_v) i -= n4;
  const float4* src =
      reinterpret_cast<const float4*>(part) + (is_v ? parts * n4 : 0) + i;
  float4 a = src[0];
  for (int p = 1; p < parts; ++p) {
    const float4 b = src[p * n4];
    a.x += b.x;
    a.y += b.y;
    a.z += b.z;
    a.w += b.w;
  }
  const float m = is_v ? 1.0f : scale;
  T* dst = (is_v ? dv : dk) + 4 * i;
  put2(dst, a.x * m, a.y * m);
  put2(dst + 2, a.z * m, a.w * m);
}

// ---------------------------------------------------------------------------
// f32: 3xTF32 on mma.sync.m16n8k8, cp.async double buffering
// ---------------------------------------------------------------------------
namespace f32k {

constexpr int kThreads = 256;  // 4 owner-row groups x 2 streamed halves

template <int HD>
struct Layout {
  static constexpr int kStride = HD + 4;  // floats a shared row takes
  static constexpr int kTileFloats = kTile * kStride;
  // the owner tiles, the streamed tiles in two buffers, and the streamed
  // rows' lse and D in two buffers
  static constexpr int kFloats = 6 * kTileFloats + 4 * kTile;
};

// Rows [row0, row0 + 64) of a (rows, HD) slice at stride HD + 4; rows at or
// past ``rows`` are zero-filled.
template <int HD>
__device__ __forceinline__ void stage(float* dst, const float* src, int row0,
                                      int rows) {
  constexpr int kC4 = HD / 4;
  for (int idx = threadIdx.x; idx < kTile * kC4; idx += kThreads) {
    const int r = idx / kC4, c = (idx % kC4) * 4;
    const bool ok = row0 + r < rows;
    cp_async16(dst + r * Layout<HD>::kStride + c,
               src + (long long)(ok ? row0 + r : 0) * HD + c, ok);
  }
}

// 64 floats of lse and of D (padded rows: aligned, no tail).
__device__ __forceinline__ void stage_rows(float* l2s, float* ds,
                                          const float* l2, const float* dd) {
  if (threadIdx.x < 16)
    cp_async16(l2s + 4 * threadIdx.x, l2 + 4 * threadIdx.x, true);
  else if (threadIdx.x < 32)
    cp_async16(ds + 4 * (threadIdx.x - 16), dd + 4 * (threadIdx.x - 16),
               true);
}

// c (16 x 32) = A B^T over HD: A the 16 rows at ``a``, B the 32 rows at
// ``b``; c[n][j] is row g + 8 (j >> 1), column 8 n + 2 tq + (j & 1).
template <int HD>
__device__ __forceinline__ void product_t(float (&c)[4][4], const float* a,
                                          const float* b, int g, int tq) {
  constexpr int kStride = Layout<HD>::kStride;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) c[n][j] = 0.0f;
#pragma unroll 2
  for (int kk = 0; kk < HD / 8; ++kk) {
    const float* pa = a + g * kStride + 8 * kk + tq;
    uint32_t ah[4], al[4];
    split(pa[0], ah[0], al[0]);
    split(pa[8 * kStride], ah[1], al[1]);
    split(pa[4], ah[2], al[2]);
    split(pa[8 * kStride + 4], ah[3], al[3]);
#pragma unroll
    for (int n = 0; n < 4; ++n) {
      const float* pb = b + (8 * n + g) * kStride + 8 * kk + tq;
      uint32_t bh0, bl0, bh1, bl1;
      split(pb[0], bh0, bl0);
      split(pb[4], bh1, bl1);
      mma3(c[n], ah, al, bh0, bh1, bl0, bl1);
    }
  }
}

// acc (16 x HD) += F B: F (16 x 32) in product_t's accumulator layout, B the
// 32 rows at ``b``; the rows of step kk taken as 8 kk + (0, 2, 4, 6, 1, 3,
// 5, 7), so that F's registers are the A fragment as they lie.  Each
// 8-column block's product is summed in a fresh accumulator and added to
// ``acc`` in f32: the tensor core rounds its f32 sums toward zero, and a
// running dK, dV or dQ fed straight through mma over a 4,096-row walk
// shrank by ~1e-4 of itself (S = 4096, hd = 64); a tile's 12 roundings
// at the tile's own scale cost ~1e-6.
template <int HD>
__device__ __forceinline__ void product_acc(float (&acc)[HD / 8][4],
                                            const float (&f)[4][4],
                                            const float* b, int g, int tq) {
  constexpr int kStride = Layout<HD>::kStride;
  uint32_t fh[4][4], fl[4][4];
#pragma unroll
  for (int kk = 0; kk < 4; ++kk) {
    split(f[kk][0], fh[kk][0], fl[kk][0]);
    split(f[kk][2], fh[kk][1], fl[kk][1]);
    split(f[kk][1], fh[kk][2], fl[kk][2]);
    split(f[kk][3], fh[kk][3], fl[kk][3]);
  }
  const float* pb = b + 2 * tq * kStride + g;
#pragma unroll
  for (int n = 0; n < HD / 8; ++n) {
    float t[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) {
      uint32_t bh0, bl0, bh1, bl1;
      split(pb[8 * kk * kStride + 8 * n], bh0, bl0);
      split(pb[(8 * kk + 1) * kStride + 8 * n], bh1, bl1);
      mma3(t, fh[kk], fl[kk], bh0, bh1, bl0, bl1);
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) acc[n][j] += t[j];
  }
}

// kDq false (dkdv): owner K and V, streamed Q and dO; out0 = dK, out1 = dV,
// or, with ``part``, this part's unscaled f32 sums there.  kDq true: owner Q
// and dO, streamed K and V; out0 = dQ.
template <int HD, bool kDq>
__global__ void __launch_bounds__(kThreads, HD <= 64 ? 2 : 1)
pass(const float* __restrict__ q, const float* __restrict__ k,
     const float* __restrict__ v, const float* __restrict__ dout,
     const float* __restrict__ l2, const float* __restrict__ dd,
     float* __restrict__ out0, float* __restrict__ out1,
     float* __restrict__ part, int S, int T, int s_pad, int causal,
     int period, int chunk, float scale) {
  using L = Layout<HD>;
  constexpr int kStride = L::kStride;
  constexpr int kND = HD / 8;  // 8-column blocks of an output row
  constexpr int kTF = L::kTileFloats;
  extern __shared__ float4 smem4[];
  float* xs = reinterpret_cast<float*>(smem4);  // owner: K, or Q
  float* zs = xs + kTF;                         // owner: V, or dO
  float* ys = zs + kTF;                         // streamed: Q, or K (x2)
  float* ws = ys + 2 * kTF;                     // streamed: dO, or V (x2)
  float* l2s = ws + 2 * kTF;                    // streamed rows' lse (x2)
  float* dds = l2s + 2 * kTile;                 // and D (x2)

  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  const int g = lane / 4, tq = lane % 4;
  const int mw = warp % 4, nw = warp / 4;
  const long long bh = blockIdx.x;
  const int n_q = (S + kTile - 1) / kTile;
  q += bh * S * HD;
  dout += bh * S * HD;
  k += bh * T * HD;
  v += bh * T * HD;
  l2 += bh * s_pad;
  dd += bh * s_pad;
  const float scale_log2 = scale * kLog2e;

  // the owner's first row (dq) or key (dkdv); the streamed tiles [t, end)
  int o0, t, end;
  if constexpr (kDq) {
    o0 = (gridDim.y - 1 - blockIdx.y) * kTile;
    t = 0;
    end = (T + kTile - 1) / kTile;
    if (causal)
      end = min(end,
                span(o0, min(o0 + kTile, S) - 1, period).max_pos / kTile + 1);
  } else {
    o0 = blockIdx.z * kTile;
    t = blockIdx.y * chunk;
    end = min(t + chunk, n_q);
    t = next_tile(t, end, S, o0, causal, period);
  }
  const float* own_x = kDq ? q : k;
  const float* own_z = kDq ? dout : v;
  const float* str_y = kDq ? k : q;
  const float* str_w = kDq ? v : dout;
  const int own_rows = kDq ? S : T, str_rows = kDq ? T : S;
  auto next = [&](int u) {
    return kDq ? u : next_tile(u, end, S, o0, causal, period);
  };

  stage<HD>(xs, own_x, o0, own_rows);
  stage<HD>(zs, own_z, o0, own_rows);
  if (t < end) {
    stage<HD>(ys, str_y, t * kTile, str_rows);
    stage<HD>(ws, str_w, t * kTile, str_rows);
    if (!kDq) stage_rows(l2s, dds, l2 + t * kTile, dd + t * kTile);
  }
  cp_commit();

  // this thread's owner rows (keys in dkdv): a and b = a + 8
  const int m_a = o0 + 16 * mw + g, m_b = m_a + 8;
  float l2_a = 0.0f, l2_b = 0.0f, d_a = 0.0f, d_b = 0.0f;
  int pos_a = 0, pos_b = 0;
  if constexpr (kDq) {
    l2_a = l2[m_a];  // the padded rows reach past every block's rows
    l2_b = l2[m_b];
    d_a = dd[m_a];
    d_b = dd[m_b];
    pos_a = row_pos(m_a, period);
    pos_b = row_pos(m_b, period);
  }

  float acc0[kND][4];                 // dQ, or dK
  float acc1[kDq ? 1 : kND][4];       // dV
#pragma unroll
  for (int n = 0; n < kND; ++n)
#pragma unroll
    for (int j = 0; j < 4; ++j) acc0[n][j] = 0.0f;
  if constexpr (!kDq) {
#pragma unroll
    for (int n = 0; n < kND; ++n)
#pragma unroll
      for (int j = 0; j < 4; ++j) acc1[n][j] = 0.0f;
  }

  int buf = 0;
  while (t < end) {
    const int tn = next(t + 1);
    if (tn < end) {
      stage<HD>(ys + (buf ^ 1) * kTF, str_y, tn * kTile, str_rows);
      stage<HD>(ws + (buf ^ 1) * kTF, str_w, tn * kTile, str_rows);
      if (!kDq)
        stage_rows(l2s + (buf ^ 1) * kTile, dds + (buf ^ 1) * kTile,
                   l2 + tn * kTile, dd + tn * kTile);
      cp_commit();
      cp_wait<1>();
    } else {
      cp_wait<0>();
    }
    __syncthreads();
    const int s0 = t * kTile + 32 * nw;  // this warp's first streamed row
    const int o_w = o0 + 16 * mw;        // and owner row
    const Vis vis = kDq ? visibility(o_w, 16, s0, 32, S, T, causal, period)
                        : visibility(s0, 32, o_w, 16, S, T, causal, period);
    if (vis.any) {
      const float* yt = ys + buf * kTF + 32 * nw * kStride;
      const float* wt = ws + buf * kTF + 32 * nw * kStride;
      float s[4][4], dp[4][4];
      product_t<HD>(s, xs + 16 * mw * kStride, yt, g, tq);
      product_t<HD>(dp, zs + 16 * mw * kStride, wt, g, tq);
      // P and dS; the accumulator's rows are owner rows, its columns
      // streamed rows
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int c = 8 * n + 2 * tq + (j & 1);  // streamed, in the half
          float lr, dr;
          if constexpr (kDq) {
            lr = j < 2 ? l2_a : l2_b;
            dr = j < 2 ? d_a : d_b;
          } else {
            lr = l2s[buf * kTile + 32 * nw + c];
            dr = dds[buf * kTile + 32 * nw + c];
          }
          float p = ex2(fmaf(s[n][j], scale_log2, -lr));
          if (!vis.all) {
            const int m = j < 2 ? m_a : m_b;
            bool ok;
            if constexpr (kDq)
              ok = m < S && s0 + c < T &&
                   (!causal || s0 + c <= (j < 2 ? pos_a : pos_b));
            else
              ok = visible(s0 + c, m, S, T, causal, period);
            if (!ok) p = 0.0f;
          }
          s[n][j] = p;
          dp[n][j] = p * (dp[n][j] - dr);
        }
      if constexpr (kDq) {
        product_acc<HD>(acc0, dp, yt, g, tq);  // dQ += dS K
      } else {
        product_acc<HD>(acc1, s, wt, g, tq);   // dV += P^T dO
        product_acc<HD>(acc0, dp, yt, g, tq);  // dK += dS^T Q
      }
    }
    __syncthreads();  // the next tile's loads reuse this buffer
    buf ^= 1;
    t = tn;
  }
  cp_wait<0>();
  __syncthreads();

  // the second streamed half's sums, added to the first's in that order
  float* red0 = ys;
  float* red1 = ws;
  if (nw == 1) {
#pragma unroll
    for (int n = 0; n < kND; ++n) {
      const int at = (16 * mw + g) * kStride + 8 * n + 2 * tq;
      put2(red0 + at, acc0[n][0], acc0[n][1]);
      put2(red0 + at + 8 * kStride, acc0[n][2], acc0[n][3]);
      if constexpr (!kDq) {
        put2(red1 + at, acc1[n][0], acc1[n][1]);
        put2(red1 + at + 8 * kStride, acc1[n][2], acc1[n][3]);
      }
    }
  }
  __syncthreads();
  if (nw == 1) return;
  const int rows_out = kDq ? S : T;
  float* o_0 = out0;
  float* o_1 = out1;
  float mul = scale;
  if (!kDq && part != nullptr) {
    // this part's slabs: dK part p, then (after all parts) dV part p
    const long long slab = (long long)gridDim.x * T * HD;
    o_0 = part + blockIdx.y * slab;
    o_1 = part + (gridDim.y + blockIdx.y) * slab;
    mul = 1.0f;
  }
  const long long off = bh * (long long)rows_out * HD;
#pragma unroll
  for (int n = 0; n < kND; ++n) {
    const int at = (16 * mw + g) * kStride + 8 * n + 2 * tq;
    const int col = 8 * n + 2 * tq;
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int m = h ? m_b : m_a;
      if (m >= rows_out) continue;
      const int r = at + 8 * kStride * h;
      float* dst = o_0 + off + (long long)m * HD + col;
      put2(dst, (acc0[n][2 * h] + red0[r]) * mul,
           (acc0[n][2 * h + 1] + red0[r + 1]) * mul);
      if constexpr (!kDq)
        put2(o_1 + off + (long long)m * HD + col, acc1[n][2 * h] + red1[r],
             acc1[n][2 * h + 1] + red1[r + 1]);
    }
  }
}

}  // namespace f32k

// ---------------------------------------------------------------------------
// bf16: TMA + wgmma, one producer warp and two consumer warpgroups
// ---------------------------------------------------------------------------
namespace bf16k {

constexpr int kOwn = 128;        // owner rows a block holds
constexpr int kConsumers = 256;  // two warpgroups of 64 owner rows
constexpr int kThreads = kConsumers + 32;

template <int HD>
struct Layout {
  // one shared row of a panel is one swizzle span: 64 columns (128 bytes),
  // or all 32 at hd = 32 (64 bytes)
  static constexpr int kPanelCols = HD < 64 ? HD : 64;
  static constexpr int kPanels = HD / kPanelCols;
  static constexpr int kRowBytes = 2 * kPanelCols;
  static constexpr int kSwizzle = kRowBytes == 128 ? 1 : 2;  // wgmma's code
  static constexpr int kOwnBytes = kOwn * HD * 2;    // one owner tile
  static constexpr int kTileBytes = kTile * HD * 2;  // one streamed tile
  static constexpr int kStageBytes = 2 * kTileBytes;
  static constexpr int kStages = HD <= 64 ? 4 : 3;
  static constexpr int kRowsBytes = 2 * kTile * 4;  // a stage's lse and D
  // 1024 bytes of slack to align the tiles to the swizzle atom, then the
  // owner tiles, the ring, its rows' lse and D, and 2 * kStages + 1
  // mbarriers
  static constexpr int kRowsOff = 2 * kOwnBytes + kStages * kStageBytes;
  static constexpr int kBarOff = kRowsOff + kStages * kRowsBytes;
  static constexpr int kBytes = 1024 + kBarOff + 8 * (2 * kStages + 1);
};

// ``bytes`` (a multiple of 16) from global to shared memory, completing on
// ``bar``.
__device__ __forceinline__ void bulk_load(void* dst, const void* src,
                                          uint32_t bytes, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1], %2, [%3];\n" ::"r"(smem_u32(dst)),
      "l"(src), "r"(bytes), "r"(smem_u32(bar))
      : "memory");
}

// (a, b) = hi + lo, each a pair of bf16 (packed as wgmma's A registers):
// hi rounded to nearest, lo the rest rounded, ~2^-16 of |a| in all.
__device__ __forceinline__ void split_bf16(float a, float b, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(a, b);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  const float2 f = __bfloat1622float2(h);
  lo = pack_bf16(a - f.x, b - f.y);
}

// D (64 x HD panel, f32) += A (registers, 64 x 16) B (16 streamed rows of
// the panel at ``b``, MN-major), over one panel's width.
template <int HD>
__device__ __forceinline__ void rs(float (&d)[Layout<HD>::kPanelCols / 2],
                                   const uint32_t (&a)[4], uint64_t b) {
  if constexpr (Layout<HD>::kPanelCols == 64)
    wgmma_rs_n64(d, a, b);
  else
    wgmma_rs_n32(d, a, b);
}

// As f32k::pass, on bf16 tensors through tensor maps: x, z the owner's (K,
// V or Q, dO; boxes of 128 rows), y, w the streamed (Q, dO or K, V; 64).
template <int HD, bool kDq>
__global__ void __launch_bounds__(kThreads, 1)
pass(const __grid_constant__ CUtensorMap xmap,
     const __grid_constant__ CUtensorMap zmap,
     const __grid_constant__ CUtensorMap ymap,
     const __grid_constant__ CUtensorMap wmap, const float* __restrict__ l2,
     const float* __restrict__ dd, __nv_bfloat16* __restrict__ out0,
     __nv_bfloat16* __restrict__ out1, float* __restrict__ part, int S,
     int T, int s_pad, int causal, int period, int chunk, float scale) {
  using L = Layout<HD>;
  constexpr int kStages = L::kStages;
  constexpr int kPW = L::kPanelCols;
  constexpr int kRB = L::kRowBytes;
  constexpr int kStepsPerPanel = kPW / 16;  // k16 steps along hd a panel
  extern __shared__ uint8_t smem_raw[];
  uint8_t* base = smem_raw + ((1024 - (smem_u32(smem_raw) & 1023)) & 1023);
  float* rows_s = reinterpret_cast<float*>(base + L::kRowsOff);
  uint64_t* bars = reinterpret_cast<uint64_t*>(base + L::kBarOff);
  uint64_t* own_full = bars;
  uint64_t* full = bars + 1;
  uint64_t* empty = bars + 1 + kStages;

  const int bh = blockIdx.x;
  const int n_q = (S + kTile - 1) / kTile;
  l2 += (long long)bh * s_pad;
  dd += (long long)bh * s_pad;
  int o0, first, end;
  if constexpr (kDq) {
    o0 = (gridDim.y - 1 - blockIdx.y) * kOwn;
    first = 0;
    end = (T + kTile - 1) / kTile;
    if (causal)
      end = min(end,
                span(o0, min(o0 + kOwn, S) - 1, period).max_pos / kTile + 1);
  } else {
    o0 = blockIdx.z * kOwn;
    first = blockIdx.y * chunk;
    end = min(first + chunk, n_q);
  }
  // the streamed tiles the block walks: in dkdv those whose rows see the
  // block's first key
  auto next = [&](int u) {
    return kDq ? u : next_tile(u, end, S, o0, causal, period);
  };

  if (threadIdx.x == 0) {
    mbar_init(own_full, 1);
    for (int s = 0; s < kStages; ++s) {
      mbar_init(full + s, 1);
      mbar_init(empty + s, kConsumers / 32);
    }
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (threadIdx.x >= kConsumers) {
    // producer: one thread starts every copy
    if (threadIdx.x == kConsumers) {
      mbar_expect_tx(own_full, 2 * L::kOwnBytes);
      for (int p = 0; p < L::kPanels; ++p) {
        tma_load(base + p * kOwn * kRB, &xmap, own_full, p * kPW, o0, bh);
        tma_load(base + L::kOwnBytes + p * kOwn * kRB, &zmap, own_full,
                 p * kPW, o0, bh);
      }
      int n = 0;
      for (int t = next(first); t < end; t = next(t + 1), ++n) {
        const int s = n % kStages, round = n / kStages;
        if (round > 0) mbar_wait(empty + s, (round - 1) & 1);
        mbar_expect_tx(full + s, L::kStageBytes + (kDq ? 0 : L::kRowsBytes));
        uint8_t* yt = base + 2 * L::kOwnBytes + s * L::kStageBytes;
        uint8_t* wt = yt + L::kTileBytes;
        for (int p = 0; p < L::kPanels; ++p) {
          tma_load(yt + p * kTile * kRB, &ymap, full + s, p * kPW,
                   t * kTile, bh);
          tma_load(wt + p * kTile * kRB, &wmap, full + s, p * kPW,
                   t * kTile, bh);
        }
        if (!kDq) {
          float* rs_ = rows_s + s * 2 * kTile;
          bulk_load(rs_, l2 + t * kTile, kTile * 4, full + s);
          bulk_load(rs_ + kTile, dd + t * kTile, kTile * 4, full + s);
        }
      }
    }
    return;
  }

  // consumers: warpgroup wg owns rows (keys) m0 + [0, 64)
  const int wg = threadIdx.x / 128;
  const int lane = threadIdx.x % 32;
  const int m0 = o0 + 64 * wg;
  // a thread's accumulator rows: a and b = a + 8
  const int m_a = m0 + 16 * ((threadIdx.x % 128) / 32) + lane / 4;
  const int m_b = m_a + 8;
  float l2_a = 0.0f, l2_b = 0.0f, d_a = 0.0f, d_b = 0.0f;
  int pos_a = 0, pos_b = 0;
  if constexpr (kDq) {
    l2_a = l2[m_a];  // the padded rows reach past every block's rows
    l2_b = l2[m_b];
    d_a = dd[m_a];
    d_b = dd[m_b];
    pos_a = row_pos(m_a, period);
    pos_b = row_pos(m_b, period);
  }
  const float scale_log2 = scale * kLog2e;

  float acc0[L::kPanels][kPW / 2];              // dQ, or dK
  float acc1[kDq ? 1 : L::kPanels][kPW / 2];    // dV
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kPW / 2; ++i) acc0[p][i] = 0.0f;
  if constexpr (!kDq) {
#pragma unroll
    for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
      for (int i = 0; i < kPW / 2; ++i) acc1[p][i] = 0.0f;
  }

  const uint32_t x_base = smem_u32(base) + 64 * wg * kRB;
  const uint32_t z_base = x_base + L::kOwnBytes;
  mbar_wait(own_full, 0);
  int n = 0;
  for (int t = next(first); t < end; t = next(t + 1), ++n) {
    const int s = n % kStages;
    mbar_wait(full + s, (n / kStages) & 1);
    const int s0 = t * kTile;
    const Vis vis = kDq ? visibility(m0, 64, s0, kTile, S, T, causal, period)
                        : visibility(s0, kTile, m0, 64, S, T, causal, period);
    if (vis.any) {
      const uint32_t y_base =
          smem_u32(base + 2 * L::kOwnBytes + s * L::kStageBytes);
      const uint32_t w_base = y_base + L::kTileBytes;
      // S (S^T) and dP (dP^T): all four operands K-major, 16 columns of hd
      // a step; acc[4i + j]: owner row (j & 2 ? b : a), streamed row
      // s0 + 8 i + 2 (lane % 4) + (j & 1).  Each tile's first wgmma
      // ignores what the registers hold, so they are not zeroed (nor kept
      // live across tiles)
      float sacc[32], pacc[32];
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / kStepsPerPanel;
        const uint32_t off = (kk % kStepsPerPanel) * 32;
        wgmma_ss_n64(sacc,
                     make_desc(x_base + p * kOwn * kRB + off, 16, 8 * kRB,
                               L::kSwizzle),
                     make_desc(y_base + p * kTile * kRB + off, 16, 8 * kRB,
                               L::kSwizzle),
                     kk > 0);
      }
#pragma unroll
      for (int kk = 0; kk < HD / 16; ++kk) {
        const int p = kk / kStepsPerPanel;
        const uint32_t off = (kk % kStepsPerPanel) * 32;
        wgmma_ss_n64(pacc,
                     make_desc(z_base + p * kOwn * kRB + off, 16, 8 * kRB,
                               L::kSwizzle),
                     make_desc(w_base + p * kTile * kRB + off, 16, 8 * kRB,
                               L::kSwizzle),
                     kk > 0);
      }
      wgmma_commit();
      wgmma_wait();
      pin(sacc);
      pin(pacc);
      const float* rl = rows_s + s * 2 * kTile;
#pragma unroll
      for (int e = 0; e < 32; ++e) {
        const int c = 8 * (e / 4) + 2 * (lane % 4) + (e & 1);
        float lr, dr;
        if constexpr (kDq) {
          lr = (e & 2) ? l2_b : l2_a;
          dr = (e & 2) ? d_b : d_a;
        } else {
          lr = rl[c];
          dr = rl[kTile + c];
        }
        float p = ex2(fmaf(sacc[e], scale_log2, -lr));
        if (!vis.all) {
          const int m = (e & 2) ? m_b : m_a;
          bool ok;
          if constexpr (kDq)
            ok = m < S && s0 + c < T &&
                 (!causal || s0 + c <= ((e & 2) ? pos_b : pos_a));
          else
            ok = visible(s0 + c, m, S, T, causal, period);
          if (!ok) p = 0.0f;
        }
        sacc[e] = p;
        pacc[e] = p * (pacc[e] - dr);
      }
      // P (P^T) and dS (dS^T) each as two bf16 terms, in wgmma's
      // register-A layout: step kk's registers are the accumulator's
      // columns 16 kk .. 16 kk + 15
      uint32_t ph[kDq ? 1 : 4][4], pl[kDq ? 1 : 4][4], gh[4][4], gl[4][4];
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          const int e = 8 * kk + 2 * r;
          if constexpr (!kDq)
            split_bf16(sacc[e], sacc[e + 1], ph[kk][r], pl[kk][r]);
          split_bf16(pacc[e], pacc[e + 1], gh[kk][r], gl[kk][r]);
        }
      // dQ += dS K, or dV += P^T dO and dK += dS^T Q, the small terms
      // first: the streamed tiles are the MN-major B operand, 16 streamed
      // rows a step
      wgmma_fence();
#pragma unroll
      for (int kk = 0; kk < 4; ++kk)
#pragma unroll
        for (int p = 0; p < L::kPanels; ++p) {
          const uint32_t at = p * kTile * kRB + kk * 16 * kRB;
          const uint64_t yd =
              make_desc(y_base + at, kTile * kRB, 8 * kRB, L::kSwizzle);
          rs<HD>(acc0[p], gl[kk], yd);
          rs<HD>(acc0[p], gh[kk], yd);
          if constexpr (!kDq) {
            const uint64_t wd =
                make_desc(w_base + at, kTile * kRB, 8 * kRB, L::kSwizzle);
            rs<HD>(acc1[p], pl[kk], wd);
            rs<HD>(acc1[p], ph[kk], wd);
          }
        }
      wgmma_commit();
      wgmma_wait();
#pragma unroll
      for (int p = 0; p < L::kPanels; ++p) {
        pin(acc0[p]);
        if constexpr (!kDq) pin(acc1[p]);
      }
    }
    __syncwarp();
    if (lane == 0) mbar_arrive(empty + s);  // this warp is done with stage s
  }

  // acc[p][4i + j]: row (j & 2 ? b : a), column p kPW + 8 i + 2 (lane % 4)
  // + (j & 1)
  const int rows_out = kDq ? S : T;
  const long long off = (long long)bh * rows_out * HD;
  const bool split_out = !kDq && part != nullptr;
  const long long slab = (long long)gridDim.x * T * HD;
  float* p0 = split_out ? part + blockIdx.y * slab : nullptr;
  float* p1 = split_out ? part + (gridDim.y + blockIdx.y) * slab : nullptr;
#pragma unroll
  for (int p = 0; p < L::kPanels; ++p)
#pragma unroll
    for (int i = 0; i < kPW / 8; ++i)
#pragma unroll
      for (int h = 0; h < 2; ++h) {
        const int m = h ? m_b : m_a;
        if (m >= rows_out) continue;
        const long long at =
            off + (long long)m * HD + p * kPW + 8 * i + 2 * (lane % 4);
        const float a0 = acc0[p][4 * i + 2 * h];
        const float a1 = acc0[p][4 * i + 2 * h + 1];
        if (split_out) {
          put2(p0 + at, a0, a1);
          if constexpr (!kDq)
            put2(p1 + at, acc1[p][4 * i + 2 * h], acc1[p][4 * i + 2 * h + 1]);
        } else {
          put2(out0 + at, a0 * scale, a1 * scale);
          if constexpr (!kDq)
            put2(out1 + at, acc1[p][4 * i + 2 * h],
                 acc1[p][4 * i + 2 * h + 1]);
        }
      }
}

}  // namespace bf16k

// ---------------------------------------------------------------------------
// Host side
// ---------------------------------------------------------------------------

// The scratch: lse * log2 e and D of bh x s_pad rows, then, for a split
// walk, the parts' dK and dV (kernels/flash_attention.py bwd_scratch_floats).
struct Scratch {
  float *l2, *dd, *part;
  int s_pad;
};

Scratch carve(void* scratch, int bh, int s) {
  const int s_pad = (s + kRowPad - 1) / kRowPad * kRowPad;
  float* l2 = static_cast<float*>(scratch);
  float* dd = l2 + (long long)bh * s_pad;
  return {l2, dd, dd + (long long)bh * s_pad, s_pad};
}

template <int HD, typename T>
int launch_prep(const void* o, const void* dout, const void* lse,
                const Scratch& sc, int bh, int s, cudaStream_t stream) {
  const long long rows = (long long)bh * sc.s_pad;
  prep<HD, T><<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(
      (const T*)o, (const T*)dout, (const float*)lse, sc.l2, sc.dd, s,
      sc.s_pad, rows);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_sum(const Scratch& sc, void* dk, void* dv, int bh, int t, int hd,
               int parts, float scale, cudaStream_t stream) {
  const long long n = (long long)bh * t * hd;
  sum_parts<T><<<(unsigned)((2 * (n / 4) + 255) / 256), 256, 0, stream>>>(
      sc.part, (T*)dk, (T*)dv, n, parts, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int run_f32(const void* q, const void* k, const void* v, const void* o,
            const void* dout, const void* lse, void* dq, void* dk, void* dv,
            void* scratch, int bh, int s, int t, int causal, int period,
            float scale, cudaStream_t stream) {
  const Scratch sc = carve(scratch, bh, s);
  const Plan pl = plan(s, period);
  int rc = launch_prep<HD, float>(o, dout, lse, sc, bh, s, stream);
  if (rc != 0) return rc;
  const int bytes = f32k::Layout<HD>::kFloats * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      f32k::pass<HD, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      bytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(f32k::pass<HD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               bytes);
  if (err != cudaSuccess) return (int)err;
  const float *fq = (const float*)q, *fk = (const float*)k,
              *fv = (const float*)v, *fdo = (const float*)dout;
  f32k::pass<HD, false>
      <<<dim3(bh, pl.parts, (t + kTile - 1) / kTile), f32k::kThreads, bytes,
         stream>>>(fq, fk, fv, fdo, sc.l2, sc.dd, (float*)dk, (float*)dv,
                   pl.parts > 1 ? sc.part : nullptr, s, t, sc.s_pad, causal,
                   period, pl.chunk, scale);
  rc = (int)cudaGetLastError();
  if (rc == 0 && pl.parts > 1)
    rc = launch_sum<float>(sc, dk, dv, bh, t, HD, pl.parts, scale, stream);
  if (rc != 0) return rc;
  f32k::pass<HD, true>
      <<<dim3(bh, (s + kTile - 1) / kTile), f32k::kThreads, bytes, stream>>>(
          fq, fk, fv, fdo, sc.l2, sc.dd, (float*)dq, nullptr, nullptr, s, t,
          sc.s_pad, causal, period, pl.chunk, scale);
  return (int)cudaGetLastError();
}

template <int HD>
int run_bf16(const void* q, const void* k, const void* v, const void* o,
             const void* dout, const void* lse, void* dq, void* dk, void* dv,
             void* scratch, int bh, int s, int t, int causal, int period,
             float scale, cudaStream_t stream) {
  using L = bf16k::Layout<HD>;
  constexpr int kPW = L::kPanelCols;
  const Scratch sc = carve(scratch, bh, s);
  const Plan pl = plan(s, period);
  // owner tiles in boxes of 128 rows, streamed tiles in boxes of 64
  CUtensorMap q_own, do_own, k_own, v_own, q_str, do_str, k_str, v_str;
  int rc = make_map(&q_own, q, HD, s, bh, kPW, bf16k::kOwn);
  if (rc == 0) rc = make_map(&do_own, dout, HD, s, bh, kPW, bf16k::kOwn);
  if (rc == 0) rc = make_map(&k_own, k, HD, t, bh, kPW, bf16k::kOwn);
  if (rc == 0) rc = make_map(&v_own, v, HD, t, bh, kPW, bf16k::kOwn);
  if (rc == 0) rc = make_map(&q_str, q, HD, s, bh, kPW, kTile);
  if (rc == 0) rc = make_map(&do_str, dout, HD, s, bh, kPW, kTile);
  if (rc == 0) rc = make_map(&k_str, k, HD, t, bh, kPW, kTile);
  if (rc == 0) rc = make_map(&v_str, v, HD, t, bh, kPW, kTile);
  if (rc != 0) return rc;
  rc = launch_prep<HD, __nv_bfloat16>(o, dout, lse, sc, bh, s, stream);
  if (rc != 0) return rc;
  cudaError_t err = cudaFuncSetAttribute(
      bf16k::pass<HD, false>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      L::kBytes);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(bf16k::pass<HD, true>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               L::kBytes);
  if (err != cudaSuccess) return (int)err;
  bf16k::pass<HD, false>
      <<<dim3(bh, pl.parts, (t + bf16k::kOwn - 1) / bf16k::kOwn),
         bf16k::kThreads, L::kBytes, stream>>>(
          k_own, v_own, q_str, do_str, sc.l2, sc.dd, (__nv_bfloat16*)dk,
          (__nv_bfloat16*)dv, pl.parts > 1 ? sc.part : nullptr, s, t,
          sc.s_pad, causal, period, pl.chunk, scale);
  rc = (int)cudaGetLastError();
  if (rc == 0 && pl.parts > 1)
    rc = launch_sum<__nv_bfloat16>(sc, dk, dv, bh, t, HD, pl.parts, scale,
                                   stream);
  if (rc != 0) return rc;
  bf16k::pass<HD, true>
      <<<dim3(bh, (s + bf16k::kOwn - 1) / bf16k::kOwn), bf16k::kThreads,
         L::kBytes, stream>>>(q_own, do_own, k_str, v_str, sc.l2, sc.dd,
                              (__nv_bfloat16*)dq, nullptr, nullptr, s, t,
                              sc.s_pad, causal, period, pl.chunk, scale);
  return (int)cudaGetLastError();
}

typedef int (*Runner)(const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, void*, void*,
                      int, int, int, int, int, float, cudaStream_t);

int dispatch(Runner r32, Runner r64, Runner r128, const void* q,
             const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* dq, void* dk, void* dv, void* scratch,
             int bh, int s, int t, int hd, int causal, int period,
             float scale, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || period < 0 ||
      (s + kTile - 1) / kTile > 65535 || (t + kTile - 1) / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Runner r = hd == 32 ? r32 : hd == 64 ? r64 : hd == 128 ? r128 : nullptr;
  if (r == nullptr) return (int)cudaErrorInvalidValue;
  return r(q, k, v, o, dout, lse, dq, dk, dv, scratch, bh, s, t, causal,
           period, scale, (cudaStream_t)stream);
}

}  // namespace

// q, o, dout, dq: (bh, s, hd); k, v, dk, dv: (bh, t, hd), contiguous (the
// bf16 path reads them through TMA: 16-byte aligned); lse: (bh, s) floats;
// scratch: kernels/flash_attention.py bwd_scratch_floats(bh, s, t, hd,
// period) floats, 16-byte aligned.  Launches on ``stream``; returns the
// first CUDA error code, or 0 (kMapError + the CUresult when a bf16
// tensor map is refused).
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, int bh, int s, int t, int hd, int causal, int period,
    float scale, void* stream) {
  return dispatch(run_f32<32>, run_f32<64>, run_f32<128>, q, k, v, o, dout,
                  lse, dq, dk, dv, scratch, bh, s, t, hd, causal, period,
                  scale, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* scratch, int bh, int s, int t, int hd, int causal, int period,
    float scale, void* stream) {
  return dispatch(run_bf16<32>, run_bf16<64>, run_bf16<128>, q, k, v, o,
                  dout, lse, dq, dk, dv, scratch, bh, s, t, hd, causal,
                  period, scale, stream);
}
