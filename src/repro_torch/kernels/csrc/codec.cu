// Fused codec decode + aggregate kernels for Hopper (sm_90a).
//
// Replace the TPU kernels of src/repro/kernels/codec.py (launcher :54):
//   K5  _agg_kernel / codec_aggregate (codec.py:34, :76): the dequantized
//       masked cohort mean over the stacked flat packs
//
//       out = sum_k m_k * s_k * v_k / max(sum_k m_k, 1)
//
//   K6  _agg_sum_kernel / codec_aggregate_partial (codec.py:44, :93): the
//       same sum without the division, the partial of one shard of the
//       client mesh; the shards' partials and mask counts are summed
//       across ranks and divided once
//
//       out = sum_k m_k * s_k * v_k
//
//       vals (K, rows, 128) f32, scales and mask (K,) f32 -> (rows, 128) f32.
//
// What bounds them on this card: memory.  Each output element reads one
// value per active client and writes one result, two flops per value read,
// far below the H100's ~20 flops/byte balance point.  The least time is the
// bytes of the active clients' slabs plus the output over 3.35 TB/s: at the
// main path's shapes (K=10, or K/D per rank of the mesh, 8 or 64 rows) 4-330
// KB, 0.001-0.1 us.  A launch costs microseconds, so at those shapes the
// kernels are bound by launch latency, not by either roofline.
//
// This first design: every block first reads the K scales and mask entries
// (K <= 1024) into shared memory as a compacted list of the active clients
// with their weights w_k = s_k * m_k, and the count max(sum_k m_k, 1).  One
// thread then owns a float4 of the output and walks the active clients in
// order k = 0..K-1: acc = acc + v[k] * w_k; K5 then divides by the count.
// A masked client's slab is never read (its term would be +-0 for finite
// inputs), so masked clients cost no bandwidth, and an all-inactive cohort
// or shard gives +0.0.  Both kernels run one __device__ body, so the mean
// and the partial cannot drift apart.  The TPU kernel's row-block grid is
// not carried over: a block here owns 1024 consecutive output values, so
// (8, 128) runs on one block and (64, 128) on eight; the cure for the idle
// SMs at these shapes is fewer launches, not a wider grid.
//
// The file is built with -fmad=false, so every multiply and add rounds on
// its own, in the same order as the plain PyTorch versions in
// kernels/ref.py (codec_aggregate_ref, codec_aggregate_partial_ref), and
// kernel and plain version are bitwise equal.
#include <cuda_runtime.h>

static const int kMaxClients = 1024;
static const int kThreads = 256;

// The masked dequantized sum of one float4 of the output, and the count
// max(sum_k m_k, 1).  Every thread of the block calls it.
__device__ __forceinline__ float4 masked_sum(
    const float4* __restrict__ vals, const float* __restrict__ scales,
    const float* __restrict__ mask, int k_clients, long long n4,
    long long i, float* count_out) {
  __shared__ float weight[kMaxClients];
  __shared__ int client[kMaxClients];
  __shared__ int n_active;
  __shared__ float count;
  if (threadIdx.x == 0) {
    float c = 0.0f;
    int na = 0;
    for (int k = 0; k < k_clients; ++k) {
      float m = mask[k];
      c = c + m;
      if (m != 0.0f) {
        client[na] = k;
        weight[na] = scales[k] * m;
        ++na;
      }
    }
    n_active = na;
    count = fmaxf(c, 1.0f);
  }
  __syncthreads();
  *count_out = count;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  if (i >= n4) return acc;
  for (int j = 0; j < n_active; ++j) {
    float4 v = vals[(long long)client[j] * n4 + i];
    float w = weight[j];
    acc.x = acc.x + v.x * w;
    acc.y = acc.y + v.y * w;
    acc.z = acc.z + v.z * w;
    acc.w = acc.w + v.w * w;
  }
  return acc;
}

__global__ void codec_aggregate_kernel(
    const float4* __restrict__ vals, const float* __restrict__ scales,
    const float* __restrict__ mask, float4* __restrict__ out, int k_clients,
    long long n4) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float c;
  float4 acc = masked_sum(vals, scales, mask, k_clients, n4, i, &c);
  if (i >= n4) return;
  acc.x = acc.x / c;
  acc.y = acc.y / c;
  acc.z = acc.z / c;
  acc.w = acc.w / c;
  out[i] = acc;
}

__global__ void codec_aggregate_partial_kernel(
    const float4* __restrict__ vals, const float* __restrict__ scales,
    const float* __restrict__ mask, float4* __restrict__ out, int k_clients,
    long long n4) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  float c;
  float4 acc = masked_sum(vals, scales, mask, k_clients, n4, i, &c);
  if (i >= n4) return;
  out[i] = acc;
}

typedef void (*codec_kernel_t)(const float4*, const float*, const float*,
                               float4*, int, long long);

static int launch(codec_kernel_t kernel, const void* vals,
                  const void* scales, const void* mask, void* out,
                  int k_clients, long long n_elems, void* stream) {
  if (k_clients < 1 || k_clients > kMaxClients || n_elems % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long n4 = n_elems / 4;
  if (n4 > 0) {
    unsigned blocks = (unsigned)((n4 + kThreads - 1) / kThreads);
    kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)vals, (const float*)scales, (const float*)mask,
        (float4*)out, k_clients, n4);
  }
  return (int)cudaGetLastError();
}

// n_elems: rows * 128 values per client slab (a multiple of 4).
extern "C" int codec_aggregate_f32(const void* vals, const void* scales,
                                   const void* mask, void* out, int k_clients,
                                   long long n_elems, void* stream) {
  return launch(codec_aggregate_kernel, vals, scales, mask, out, k_clients,
                n_elems, stream);
}

extern "C" int codec_aggregate_partial_f32(const void* vals,
                                           const void* scales,
                                           const void* mask, void* out,
                                           int k_clients, long long n_elems,
                                           void* stream) {
  return launch(codec_aggregate_partial_kernel, vals, scales, mask, out,
                k_clients, n_elems, stream);
}
