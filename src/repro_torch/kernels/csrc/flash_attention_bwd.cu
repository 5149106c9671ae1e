// The backward of K7 (blockwise attention) for Hopper (sm_90a), in f32 on the
// CUDA cores.
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
// Three launches on the stream, in order:
// 1. row_dot: D, one warp a row;
// 2. dkdv: a block owns 64 keys of one bh, keeps their K and V tiles and its
//    dK and dV sums (registers) and walks the 64-row query tiles that can see
//    them (a tile wholly above the causal diagonal is skipped), recomputing
//    S = Q K^T and dP = dO V^T for each, then P and dS in shared memory;
// 3. dq: a block owns 64 query rows, keeps Q, dO, lse and D, and walks its
//    visible key tiles, recomputing P and dS and summing dQ in registers.
// No block writes what another block writes, so nothing needs atomics, at
// the price of computing S and dP twice: 7 tile products a (row, key) pair
// where 5 would do.
//
// What bounds it on this card: operations.  10 hd flops a visible pair (5
// products of 2 hd) against a few bytes an element: at the train step's
// shapes (S = T = 4096, hd = 64) far above the card's flops a byte.  This
// first version multiplies in f32 on the CUDA cores (67 TFLOP/s), not on the
// tensor cores: each thread owns a 4 x 4 block of a 64 x 64 score tile, or a
// 4 x hd/16 block of a 64 x hd product, and reads its operands from shared
// memory whose rows are padded to an odd stride (hd + 1), so that the 16
// rows a warp reads at one column lie in 16 banks.  A tensor-core version
// (wgmma, TMA) is later work.
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kTile = 64;      // query rows, and keys, a tile holds
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPStride = kTile + 16;  // floats a row of a P or dS tile takes
constexpr float kLog2e = 1.4426950408889634f;

__device__ __forceinline__ float to_f(float x) { return x; }
__device__ __forceinline__ float to_f(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void put(float* p, float v) { *p = v; }
__device__ __forceinline__ void put(__nv_bfloat16* p, float v) {
  *p = __float2bfloat16(v);
}

__device__ __forceinline__ int row_pos(int row, int period) {
  return period > 0 ? row % period : row;
}

// The largest causal position rows [first, last] reach.
__device__ __forceinline__ int max_pos(int first, int last, int period) {
  if (period > 0) {
    if (first / period != last / period) return period - 1;
    return last % period;
  }
  return last;
}

// 2^x (ex2.approx: 2 ulp; -inf gives +0).
__device__ __forceinline__ float ex2(float x) {
  float y;
  asm("ex2.approx.ftz.f32 %0, %1;\n" : "=f"(y) : "f"(x));
  return y;
}

template <int HD>
struct Layout {
  static constexpr int kStride = HD + 1;        // floats a shared row takes
  static constexpr int kTileFloats = kTile * kStride;
  static constexpr int kPFloats = kTile * kPStride;
  // dkdv: K, V, Q, dO tiles, P and dS tiles, lse and D of the query tile
  static constexpr int kDkdvFloats = 4 * kTileFloats + 2 * kPFloats + 2 * kTile;
  // dq: Q, dO, K, V tiles, the dS tile, lse and D
  static constexpr int kDqFloats = 4 * kTileFloats + kPFloats + 2 * kTile;
};

// Rows [row0, row0 + 64) of a (rows, HD) slice into shared memory as f32 at
// stride HD + 1; rows at or past ``rows`` are zero-filled.
template <int HD, typename T>
__device__ __forceinline__ void stage(float* dst, const T* __restrict__ src,
                                      int row0, int rows) {
  for (int idx = threadIdx.x; idx < kTile * HD; idx += kThreads) {
    const int r = idx / HD, c = idx % HD;
    float x = 0.0f;
    if (row0 + r < rows) x = to_f(src[(long long)(row0 + r) * HD + c]);
    dst[r * Layout<HD>::kStride + c] = x;
  }
}

// lse (times log2 e) and D of rows [row0, row0 + 64); zero past S.
__device__ __forceinline__ void stage_rows(float* lse_s, float* d_s,
                                           const float* __restrict__ lse,
                                           const float* __restrict__ d,
                                           int row0, int S) {
  if (threadIdx.x < kTile) {
    const int r = row0 + threadIdx.x;
    lse_s[threadIdx.x] = r < S ? lse[r] * kLog2e : 0.0f;
    d_s[threadIdx.x] = r < S ? d[r] : 0.0f;
  }
}

// P and dS of one tile of 64 query rows (from r0) by 64 keys (from k0):
// thread (ty, tx) owns rows ty + 16 i and keys tx + 16 j, i, j < 4.  Writes
// dS, and P when ``ps`` is given, at stride kPStride.
template <int HD>
__device__ __forceinline__ void tile_p_ds(
    const float* qs, const float* dos, const float* ks, const float* vs,
    const float* lse_s, const float* d_s, int r0, int k0, int S, int T,
    int causal, int period, float scale_log2, float* ps, float* dss) {
  constexpr int kStride = Layout<HD>::kStride;
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float s[4][4], dp[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = dp[i][j] = 0.0f;
#pragma unroll 4
  for (int c = 0; c < HD; ++c) {
    float a[4], e[4], b[4], f[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      a[i] = qs[(ty + 16 * i) * kStride + c];
      e[i] = dos[(ty + 16 * i) * kStride + c];
      b[i] = ks[(tx + 16 * i) * kStride + c];
      f[i] = vs[(tx + 16 * i) * kStride + c];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        s[i][j] = fmaf(a[i], b[j], s[i][j]);
        dp[i][j] = fmaf(e[i], f[j], dp[i][j]);
      }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int lr = ty + 16 * i, row = r0 + lr;
    const int pos = row_pos(row, period);
    const float l2 = lse_s[lr], di = d_s[lr];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const int lk = tx + 16 * j, key = k0 + lk;
      const bool vis = row < S && key < T && (!causal || key <= pos);
      const float p = vis ? ex2(fmaf(s[i][j], scale_log2, -l2)) : 0.0f;
      if (ps != nullptr) ps[lr * kPStride + lk] = p;
      dss[lr * kPStride + lk] = p * (dp[i][j] - di);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
row_dot(const T* __restrict__ o, const T* __restrict__ dout,
        float* __restrict__ d, long long rows) {
  const long long row = (long long)blockIdx.x * (kThreads / 32) +
                        threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float acc = 0.0f;
#pragma unroll
  for (int c = lane; c < HD; c += 32)
    acc = fmaf(to_f(o[row * HD + c]), to_f(dout[row * HD + c]), acc);
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) d[row] = acc;
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
dkdv(const T* __restrict__ q, const T* __restrict__ k,
     const T* __restrict__ v, const T* __restrict__ dout,
     const float* __restrict__ lse, const float* __restrict__ d,
     T* __restrict__ dk, T* __restrict__ dv, int S, int T_, int causal,
     int period, float scale) {
  using L = Layout<HD>;
  constexpr int kStride = L::kStride;
  constexpr int kNJ = HD / 16;  // columns of hd a thread owns
  extern __shared__ float sm[];
  float* ks = sm;
  float* vs = ks + L::kTileFloats;
  float* qs = vs + L::kTileFloats;
  float* dos = qs + L::kTileFloats;
  float* ps = dos + L::kTileFloats;
  float* dss = ps + L::kPFloats;
  float* lse_s = dss + L::kPFloats;
  float* d_s = lse_s + kTile;

  const long long bh = blockIdx.x;
  const int k0 = blockIdx.y * kTile;
  q += bh * S * HD;
  dout += bh * S * HD;
  k += bh * T_ * HD;
  v += bh * T_ * HD;
  dk += bh * T_ * HD;
  dv += bh * T_ * HD;
  lse += bh * S;
  d += bh * S;
  const float scale_log2 = scale * kLog2e;

  stage<HD>(ks, k, k0, T_);
  stage<HD>(vs, v, k0, T_);
  // thread (ty, tx) sums keys ty + 16 i, columns tx + 16 j
  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc_k[4][kNJ], acc_v[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc_k[i][j] = acc_v[i][j] = 0.0f;

  const int n_q = (S + kTile - 1) / kTile;
  for (int qt = 0; qt < n_q; ++qt) {
    const int r0 = qt * kTile;
    if (causal && max_pos(r0, min(r0 + kTile, S) - 1, period) < k0)
      continue;  // no row of this tile sees a key of this block
    __syncthreads();  // the last tile's readers are done
    stage<HD>(qs, q, r0, S);
    stage<HD>(dos, dout, r0, S);
    stage_rows(lse_s, d_s, lse, d, r0, S);
    __syncthreads();
    tile_p_ds<HD>(qs, dos, ks, vs, lse_s, d_s, r0, k0, S, T_, causal, period,
                  scale_log2, ps, dss);
    __syncthreads();
    // dV += P^T dO, dK += dS^T Q over the tile's 64 rows
#pragma unroll 2
    for (int r = 0; r < kTile; ++r) {
      float p[4], g[4], o[kNJ], x[kNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        p[i] = ps[r * kPStride + ty + 16 * i];
        g[i] = dss[r * kPStride + ty + 16 * i];
      }
#pragma unroll
      for (int j = 0; j < kNJ; ++j) {
        o[j] = dos[r * kStride + tx + 16 * j];
        x[j] = qs[r * kStride + tx + 16 * j];
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) {
          acc_v[i][j] = fmaf(p[i], o[j], acc_v[i][j]);
          acc_k[i][j] = fmaf(g[i], x[j], acc_k[i][j]);
        }
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int key = k0 + ty + 16 * i;
    if (key >= T_) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j) {
      const long long at = (long long)key * HD + tx + 16 * j;
      put(dk + at, acc_k[i][j] * scale);
      put(dv + at, acc_v[i][j]);
    }
  }
}

template <int HD, typename T>
__global__ void __launch_bounds__(kThreads)
dq_pass(const T* __restrict__ q, const T* __restrict__ k,
        const T* __restrict__ v, const T* __restrict__ dout,
        const float* __restrict__ lse, const float* __restrict__ d,
        T* __restrict__ dq, int S, int T_, int causal, int period,
        float scale) {
  using L = Layout<HD>;
  constexpr int kStride = L::kStride;
  constexpr int kNJ = HD / 16;
  extern __shared__ float sm[];
  float* qs = sm;
  float* dos = qs + L::kTileFloats;
  float* ks = dos + L::kTileFloats;
  float* vs = ks + L::kTileFloats;
  float* dss = vs + L::kTileFloats;
  float* lse_s = dss + L::kPFloats;
  float* d_s = lse_s + kTile;

  const long long bh = blockIdx.x;
  // the last row tiles (the most keys under causal) first
  const int r0 = (gridDim.y - 1 - blockIdx.y) * kTile;
  q += bh * S * HD;
  dout += bh * S * HD;
  dq += bh * S * HD;
  k += bh * T_ * HD;
  v += bh * T_ * HD;
  lse += bh * S;
  d += bh * S;
  const float scale_log2 = scale * kLog2e;

  stage<HD>(qs, q, r0, S);
  stage<HD>(dos, dout, r0, S);
  stage_rows(lse_s, d_s, lse, d, r0, S);
  int n_tiles = (T_ + kTile - 1) / kTile;
  if (causal)
    n_tiles = min(n_tiles,
                  max_pos(r0, min(r0 + kTile, S) - 1, period) / kTile + 1);

  const int ty = threadIdx.x / 16, tx = threadIdx.x % 16;
  float acc[4][kNJ];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < kNJ; ++j) acc[i][j] = 0.0f;

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kTile;
    __syncthreads();  // the last tile's readers are done
    stage<HD>(ks, k, k0, T_);
    stage<HD>(vs, v, k0, T_);
    __syncthreads();
    tile_p_ds<HD>(qs, dos, ks, vs, lse_s, d_s, r0, k0, S, T_, causal, period,
                  scale_log2, nullptr, dss);
    __syncthreads();
    // dQ += dS K over the tile's 64 keys; thread rows ty + 16 i
#pragma unroll 2
    for (int c = 0; c < kTile; ++c) {
      float g[4], x[kNJ];
#pragma unroll
      for (int i = 0; i < 4; ++i) g[i] = dss[(ty + 16 * i) * kPStride + c];
#pragma unroll
      for (int j = 0; j < kNJ; ++j) x[j] = ks[c * kStride + tx + 16 * j];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < kNJ; ++j) acc[i][j] = fmaf(g[i], x[j], acc[i][j]);
    }
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int row = r0 + ty + 16 * i;
    if (row >= S) continue;
#pragma unroll
    for (int j = 0; j < kNJ; ++j)
      put(dq + (long long)row * HD + tx + 16 * j, acc[i][j] * scale);
  }
}

template <int HD, typename T>
int run(const void* q, const void* k, const void* v, const void* o,
        const void* dout, const void* lse, void* dq, void* dk, void* dv,
        void* dscratch, int bh, int s, int t, int causal, int period,
        float scale, cudaStream_t stream) {
  using L = Layout<HD>;
  const long long rows = (long long)bh * s;
  const long long dot_blocks = (rows + kThreads / 32 - 1) / (kThreads / 32);
  row_dot<HD, T><<<(unsigned)dot_blocks, kThreads, 0, stream>>>(
      (const T*)o, (const T*)dout, (float*)dscratch, rows);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int kv_bytes = L::kDkdvFloats * (int)sizeof(float);
  err = cudaFuncSetAttribute(dkdv<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             kv_bytes);
  if (err != cudaSuccess) return (int)err;
  dkdv<HD, T><<<dim3(bh, (t + kTile - 1) / kTile), kThreads, kv_bytes,
                 stream>>>((const T*)q, (const T*)k, (const T*)v,
                           (const T*)dout, (const float*)lse,
                           (const float*)dscratch, (T*)dk, (T*)dv, s, t,
                           causal, period, scale);
  err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;

  const int q_bytes = L::kDqFloats * (int)sizeof(float);
  err = cudaFuncSetAttribute(dq_pass<HD, T>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             q_bytes);
  if (err != cudaSuccess) return (int)err;
  dq_pass<HD, T><<<dim3(bh, (s + kTile - 1) / kTile), kThreads, q_bytes,
                   stream>>>((const T*)q, (const T*)k, (const T*)v,
                             (const T*)dout, (const float*)lse,
                             (const float*)dscratch, (T*)dq, s, t, causal,
                             period, scale);
  return (int)cudaGetLastError();
}

typedef int (*Runner)(const void*, const void*, const void*, const void*,
                      const void*, const void*, void*, void*, void*, void*,
                      int, int, int, int, int, float, cudaStream_t);

int dispatch(Runner r32, Runner r64, Runner r128, const void* q,
             const void* k, const void* v, const void* o, const void* dout,
             const void* lse, void* dq, void* dk, void* dv, void* dscratch,
             int bh, int s, int t, int hd, int causal, int period,
             float scale, void* stream) {
  if (bh < 1 || s < 1 || t < 1 || period < 0 ||
      (s + kTile - 1) / kTile > 65535 || (t + kTile - 1) / kTile > 65535) {
    return (int)cudaErrorInvalidValue;
  }
  Runner r = hd == 32 ? r32 : hd == 64 ? r64 : hd == 128 ? r128 : nullptr;
  if (r == nullptr) return (int)cudaErrorInvalidValue;
  return r(q, k, v, o, dout, lse, dq, dk, dv, dscratch, bh, s, t, causal,
           period, scale, (cudaStream_t)stream);
}

}  // namespace

// q, o, dout, dq: (bh, s, hd); k, v, dk, dv: (bh, t, hd), contiguous; lse
// and dscratch: (bh, s) floats (dscratch receives D).  Three launches on
// ``stream``; returns the first CUDA error code, or 0.
extern "C" int flash_attention_bwd_f32(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dscratch, int bh, int s, int t, int hd, int causal, int period,
    float scale, void* stream) {
  return dispatch(run<32, float>, run<64, float>, run<128, float>, q, k, v, o,
                  dout, lse, dq, dk, dv, dscratch, bh, s, t, hd, causal,
                  period, scale, stream);
}

extern "C" int flash_attention_bwd_bf16(
    const void* q, const void* k, const void* v, const void* o,
    const void* dout, const void* lse, void* dq, void* dk, void* dv,
    void* dscratch, int bh, int s, int t, int hd, int causal, int period,
    float scale, void* stream) {
  return dispatch(run<32, __nv_bfloat16>, run<64, __nv_bfloat16>,
                  run<128, __nv_bfloat16>, q, k, v, o, dout, lse, dq, dk, dv,
                  dscratch, bh, s, t, hd, causal, period, scale, stream);
}
