// Fused codec decode + aggregate kernel for Hopper (sm_90a).
//
// Replaces the TPU kernel of src/repro/kernels/codec.py:
//   K5  _agg_kernel / codec_aggregate (codec.py:34, :76; launcher :54):
//       the dequantized masked cohort mean over the stacked flat packs
//
//       out = sum_k m_k * s_k * v_k / max(sum_k m_k, 1)
//
//       vals (K, rows, 128) f32, scales and mask (K,) f32 -> (rows, 128) f32.
//
// What bounds it on this card: memory.  Each output element reads one value
// per active client and writes one result, two flops per value read, far
// below the H100's ~20 flops/byte balance point.  The least time is the
// bytes of the active clients' slabs plus the output over 3.35 TB/s: at the
// main path's shapes (K=10, 8 or 64 rows, one client masked) 41 KB or
// 328 KB, 0.01-0.1 us.  A launch costs microseconds, so at those shapes
// the kernel is bound by launch latency, not by either roofline.
//
// This first design: every block first reads the K scales and mask entries
// (K <= 1024) into shared memory as a compacted list of the active clients
// with their weights w_k = s_k * m_k, and the count max(sum_k m_k, 1).  One
// thread then owns a float4 of the output and walks the active clients in
// order k = 0..K-1: acc = acc + v[k] * w_k, then acc / count.  A masked
// client's slab is never read (its term would be +-0 for finite inputs), so
// masked clients cost no bandwidth, and an all-inactive cohort gives zeros.
// The TPU kernel's row-block grid is not carried over: a block here owns
// 1024 consecutive output values, so (8, 128) runs on one block and
// (64, 128) on eight; the cure for the idle SMs at these shapes is fewer
// launches, not a wider grid.
//
// The file is built with -fmad=false, so every multiply and add rounds on
// its own, in the same order as the plain PyTorch version in
// kernels/ref.py (codec_aggregate_ref), and the two are bitwise equal.
#include <cuda_runtime.h>

static const int kMaxClients = 1024;
static const int kThreads = 256;

__global__ void codec_aggregate_kernel(
    const float4* __restrict__ vals, const float* __restrict__ scales,
    const float* __restrict__ mask, float4* __restrict__ out, int k_clients,
    long long n4) {
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
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  for (int j = 0; j < n_active; ++j) {
    float4 v = vals[(long long)client[j] * n4 + i];
    float w = weight[j];
    acc.x = acc.x + v.x * w;
    acc.y = acc.y + v.y * w;
    acc.z = acc.z + v.z * w;
    acc.w = acc.w + v.w * w;
  }
  float c = count;
  acc.x = acc.x / c;
  acc.y = acc.y / c;
  acc.z = acc.z / c;
  acc.w = acc.w / c;
  out[i] = acc;
}

// n_elems: rows * 128 values per client slab (a multiple of 4).
extern "C" int codec_aggregate_f32(const void* vals, const void* scales,
                                   const void* mask, void* out, int k_clients,
                                   long long n_elems, void* stream) {
  if (k_clients < 1 || k_clients > kMaxClients || n_elems % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  long long n4 = n_elems / 4;
  if (n4 > 0) {
    unsigned blocks = (unsigned)((n4 + kThreads - 1) / kThreads);
    codec_aggregate_kernel<<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)vals, (const float*)scales, (const float*)mask,
        (float4*)out, k_clients, n4);
  }
  return (int)cudaGetLastError();
}
