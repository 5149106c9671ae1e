// Blockwise online-softmax attention (flash attention) for Hopper (sm_90a).
//
// Replaces the TPU kernel K7 of src/repro/kernels/flash_attention.py:
// _kernel (:24) launched by flash_attention_3d (:78), whose GQA wrapper is
// kernels/ops.py:131 flash_attention.  For q (BH, S, hd) and k, v (BH, T, hd),
// f32 or bf16 (all three alike), it computes per row i of q
//
//     s_j   = (q_i * hd^-0.5) . k_j              f32
//     p_j   = exp(s_j - max_j s_j), masked keys 0
//     out_i = sum_j p_j v_j / max(sum_j p_j, 1e-30)   in q's dtype
//
// where key j is visible to row i iff j <= pos(i) under ``causal`` (every key
// otherwise), with pos(i) = i % period for period > 0 (the GQA group-folded
// layout: G query heads of one KV head stacked as G*S rows) and pos(i) = i
// for period 0.  Unlike the TPU kernel, S and T need not be multiples of a
// block: the tails are masked here (rows past S are not written, keys past T
// are invisible).
//
// What bounds it on this card: operations.  4*hd flops per visible (query,
// key) pair against 2-4 bytes per element moved once: at the model path's
// shapes (S = T >= 1024, hd 64-128) hundreds of flops a byte, far above the
// H100's ~20 f32 flops per byte.  The least time is the visible pairs'
// flops over 67 TFLOP/s (f32 outside the tensor cores) or 989 TFLOP/s (bf16
// tensor cores).
//
// This first design runs on the CUDA cores, in f32 for both input types (no
// tensor core, TMA or warp specialisation yet):
// - one block of 256 threads (16 x 16) owns 64 query rows of one bh; the
//   grid takes the heaviest causal tiles (the last rows) first;
// - the block walks the 64-key tiles in order, staging K and then V through
//   one shared buffer, and the tile of probabilities P through another, so a
//   block holds about 85 KB at hd=128 and two fit an SM;
// - each thread owns a 4 x 4 tile of the 64 x 64 scores (rows ty+16i, keys
//   tx+16j: the float4 reads of K hit distinct banks) and 4 rows x hd/16
//   columns of the output accumulator, in registers;
// - the running max and normaliser are kept per row in f32; the max is
//   reduced over the 16 threads of a row by warp shuffles, the normaliser
//   is kept as per-thread partial sums (the rescale is the same for all 16)
//   and summed once at the end;
// - key tiles wholly above the causal diagonal of the block's rows (with the
//   period taken into account) are not visited, as the TPU kernel's pl.when
//   skips them; a masked key inside a visited tile adds exactly 0, like the
//   reference's where(mask, p, 0).
#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int kBlockQ = 64;      // query rows a block owns
constexpr int kBlockK = 64;      // keys a tile holds
constexpr int kThreads = 256;    // 16 x 16
constexpr float kNegInf = -1e30f;  // the reference's NEG_INF
constexpr int kPStride = kBlockK + 4;

template <int HD>
struct Layout {
  static constexpr int kStride = HD + 4;   // row stride of the Q and K/V tiles
  static constexpr int kFloats =
      (kBlockQ + kBlockK) * kStride + kBlockQ * kPStride;
};

__device__ __forceinline__ float4 load4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ float4 load4(const __nv_bfloat16* p) {
  const __nv_bfloat162* p2 = reinterpret_cast<const __nv_bfloat162*>(p);
  float2 a = __bfloat1622float2(p2[0]);
  float2 b = __bfloat1622float2(p2[1]);
  return make_float4(a.x, a.y, b.x, b.y);
}

__device__ __forceinline__ void store(float* p, float x) { *p = x; }

__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16_rn(x);
}

// Rows [row0, row0 + 64) of a (rows, HD) matrix into a shared tile of
// stride HD + 4, times ``scale``; rows at or past ``rows`` are zero.
template <typename T, int HD>
__device__ __forceinline__ void load_tile(float* dst, const T* src, int row0,
                                          int rows, float scale) {
  constexpr int kC4 = HD / 4;
  constexpr int kStride = Layout<HD>::kStride;
  for (int idx = threadIdx.x; idx < kBlockK * kC4; idx += kThreads) {
    int r = idx / kC4;
    int c = (idx % kC4) * 4;
    float4 x = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
    if (row0 + r < rows) {
      x = load4(src + (long long)(row0 + r) * HD + c);
      x.x *= scale;
      x.y *= scale;
      x.z *= scale;
      x.w *= scale;
    }
    *reinterpret_cast<float4*>(dst + r * kStride + c) = x;
  }
}

template <typename T, int HD>
__global__ void __launch_bounds__(kThreads, 2)
flash_attention_kernel(const T* __restrict__ q, const T* __restrict__ k,
                       const T* __restrict__ v, T* __restrict__ o, int S,
                       int Tk, int causal, int period, float scale) {
  constexpr int kStride = Layout<HD>::kStride;
  constexpr int kCols = HD / 16;              // output columns a thread owns
  constexpr int kVec = kCols < 4 ? kCols : 4;  // as float4 (float2 at hd=32)
  constexpr int kGroups = kCols / kVec;
  extern __shared__ float4 smem4[];
  float* qs = reinterpret_cast<float*>(smem4);
  float* kvs = qs + kBlockQ * kStride;
  float* ps = kvs + kBlockK * kStride;

  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int r0 = (gridDim.x - 1 - blockIdx.x) * kBlockQ;
  const long long bh = blockIdx.y;
  q += bh * S * HD;
  k += bh * Tk * HD;
  v += bh * Tk * HD;
  o += bh * S * HD;

  // the key tiles this block's rows can see
  int n_tiles = (Tk + kBlockK - 1) / kBlockK;
  if (causal) {
    int r_last = min(r0 + kBlockQ, S) - 1;
    int last_pos = r_last;
    if (period > 0) {
      last_pos = (r0 / period != r_last / period) ? period - 1
                                                   : r_last % period;
    }
    n_tiles = min(n_tiles, last_pos / kBlockK + 1);
  }

  load_tile<T, HD>(qs, q, r0, S, scale);

  float acc[4][kCols];
  float m[4], l[4];
  int pos[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    m[i] = kNegInf;
    l[i] = 0.0f;
    int row = r0 + ty + 16 * i;
    pos[i] = period > 0 ? row % period : row;
#pragma unroll
    for (int c = 0; c < kCols; ++c) acc[i][c] = 0.0f;
  }

  for (int t = 0; t < n_tiles; ++t) {
    const int k0 = t * kBlockK;
    __syncthreads();  // the last tile's P.V no longer reads kvs and ps
    load_tile<T, HD>(kvs, k, k0, Tk, 1.0f);
    __syncthreads();

    float s[4][4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 4; ++j) s[i][j] = 0.0f;
#pragma unroll 4
    for (int d = 0; d < HD; d += 4) {
      float4 a[4], b[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        a[i] = *reinterpret_cast<const float4*>(qs + (ty + 16 * i) * kStride
                                                + d);
#pragma unroll
      for (int j = 0; j < 4; ++j)
        b[j] = *reinterpret_cast<const float4*>(kvs + (tx + 16 * j) * kStride
                                                + d);
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          s[i][j] = fmaf(a[i].x, b[j].x, s[i][j]);
          s[i][j] = fmaf(a[i].y, b[j].y, s[i][j]);
          s[i][j] = fmaf(a[i].z, b[j].z, s[i][j]);
          s[i][j] = fmaf(a[i].w, b[j].w, s[i][j]);
        }
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      bool seen[4];
      float mx = kNegInf;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        int key = k0 + tx + 16 * j;
        seen[j] = key < Tk && (!causal || key <= pos[i]);
        if (!seen[j]) s[i][j] = kNegInf;
        mx = fmaxf(mx, s[i][j]);
      }
#pragma unroll
      for (int off = 8; off > 0; off >>= 1)
        mx = fmaxf(mx, __shfl_xor_sync(0xffffffffu, mx, off, 16));
      float m_new = fmaxf(m[i], mx);
      float corr = expf(m[i] - m_new);
      float psum = 0.0f;
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        float p = seen[j] ? expf(s[i][j] - m_new) : 0.0f;
        psum += p;
        ps[(ty + 16 * i) * kPStride + tx + 16 * j] = p;
      }
      l[i] = l[i] * corr + psum;
      m[i] = m_new;
#pragma unroll
      for (int c = 0; c < kCols; ++c) acc[i][c] *= corr;
    }

    __syncthreads();  // P is written and K no longer read
    load_tile<T, HD>(kvs, v, k0, Tk, 1.0f);
    __syncthreads();

#pragma unroll 2
    for (int c = 0; c < kBlockK; c += 4) {
      float4 p4[4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
        p4[i] = *reinterpret_cast<const float4*>(ps + (ty + 16 * i) * kPStride
                                                 + c);
#pragma unroll
      for (int cc = 0; cc < 4; ++cc) {
        const float* vrow = kvs + (c + cc) * kStride + tx * kVec;
        float vv[kCols];
#pragma unroll
        for (int g = 0; g < kGroups; ++g) {
          if constexpr (kVec == 4) {
            float4 x = *reinterpret_cast<const float4*>(vrow + g * 64);
            vv[4 * g] = x.x;
            vv[4 * g + 1] = x.y;
            vv[4 * g + 2] = x.z;
            vv[4 * g + 3] = x.w;
          } else {
            float2 x = *reinterpret_cast<const float2*>(vrow + g * 32);
            vv[2 * g] = x.x;
            vv[2 * g + 1] = x.y;
          }
        }
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          float p = cc == 0 ? p4[i].x
                  : cc == 1 ? p4[i].y
                  : cc == 2 ? p4[i].z : p4[i].w;
#pragma unroll
          for (int e = 0; e < kCols; ++e) acc[i][e] = fmaf(p, vv[e], acc[i][e]);
        }
      }
    }
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
#pragma unroll
    for (int off = 8; off > 0; off >>= 1)
      l[i] += __shfl_xor_sync(0xffffffffu, l[i], off, 16);
    int row = r0 + ty + 16 * i;
    if (row >= S) continue;
    float denom = fmaxf(l[i], 1e-30f);
    T* out = o + (long long)row * HD + tx * kVec;
#pragma unroll
    for (int g = 0; g < kGroups; ++g)
#pragma unroll
      for (int e = 0; e < kVec; ++e)
        store(out + g * 16 * kVec + e, acc[i][g * kVec + e] / denom);
  }
}

template <typename T, int HD>
int run(const void* q, const void* k, const void* v, void* o, int bh, int s,
        int t, int causal, int period, float scale, void* stream) {
  const size_t bytes = Layout<HD>::kFloats * sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(
      flash_attention_kernel<T, HD>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
  if (err != cudaSuccess) return (int)err;
  dim3 grid((s + kBlockQ - 1) / kBlockQ, bh);
  flash_attention_kernel<T, HD><<<grid, kThreads, bytes,
                                  (cudaStream_t)stream>>>(
      (const T*)q, (const T*)k, (const T*)v, (T*)o, s, t, causal, period,
      scale);
  return (int)cudaGetLastError();
}

template <typename T>
int dispatch(const void* q, const void* k, const void* v, void* o, int bh,
             int s, int t, int hd, int causal, int period, float scale,
             void* stream) {
  if (bh < 1 || bh > 65535 || s < 1 || t < 1 || period < 0) {
    return (int)cudaErrorInvalidValue;
  }
  switch (hd) {
    case 32:
      return run<T, 32>(q, k, v, o, bh, s, t, causal, period, scale, stream);
    case 64:
      return run<T, 64>(q, k, v, o, bh, s, t, causal, period, scale, stream);
    case 128:
      return run<T, 128>(q, k, v, o, bh, s, t, causal, period, scale, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// q, o: (bh, s, hd); k, v: (bh, t, hd); contiguous, 16-byte aligned.
extern "C" int flash_attention_f32(const void* q, const void* k,
                                   const void* v, void* o, int bh, int s,
                                   int t, int hd, int causal, int period,
                                   float scale, void* stream) {
  return dispatch<float>(q, k, v, o, bh, s, t, hd, causal, period, scale,
                         stream);
}

extern "C" int flash_attention_bf16(const void* q, const void* k,
                                    const void* v, void* o, int bh, int s,
                                    int t, int hd, int causal, int period,
                                    float scale, void* stream) {
  return dispatch<__nv_bfloat16>(q, k, v, o, bh, s, t, hd, causal, period,
                                 scale, stream);
}
