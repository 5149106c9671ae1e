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
// What bounds a call at the main path's shapes is its path, not bytes:
// the host's (kernels/codec.py keeps it to a few attribute reads, one
// ctypes call and one allocation) and, on the card, the launch and one
// block's preamble.  The design:
// - every block first lists the active clients in order, with their
//   weights w_k = s_k * m_k (and, for K5, the count max(sum_k m_k, 1)), in
//   shared memory.  Warp 0 does it 32 clients at a time: coalesced loads of
//   32 mask and scale entries, __ballot_sync of "active", and each active
//   lane's slot from __popc of the lower lanes' bits -- at most 32 steps of
//   one warp for K <= 1024, while the other warps wait at the one barrier;
// - then one thread owns a float4 of the output and walks the active
//   clients in order k = 0..K-1, acc = acc + v[k] * w_k, with the loads of
//   four clients' float4s issued ahead of their adds; K5 divides by the
//   count.  A masked client's slab is never read (its term would be +-0
//   for finite inputs), and an all-inactive cohort or shard gives +0.0;
// - 128 threads a block (512 output values), so a slab of thousands of
//   rows spreads over all 132 SMs.
// Both kernels are one template, so the mean and the partial cannot drift
// apart.
//
// The file is built with -fmad=false, so every multiply and add rounds on
// its own, in the same order as the plain PyTorch versions in
// kernels/ref.py (codec_aggregate_ref, codec_aggregate_partial_ref), and
// kernel and plain version are bitwise equal.  The count: for masks of 0s
// and 1s every partial sum is a small integer, exact in any order, so a
// shuffle tree gives the plain version's sum over k = 0..K-1 exactly; any
// other mask is summed in that order, by one lane.
#include <cuda_runtime.h>

static const int kMaxClients = 1024;
static const int kThreads = 128;

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

__device__ __forceinline__ void add_scaled(float4& acc, float4 v, float w) {
  acc.x = acc.x + v.x * w;
  acc.y = acc.y + v.y * w;
  acc.z = acc.z + v.z * w;
  acc.w = acc.w + v.w * w;
}

// kMean: K5 (the masked mean), else K6 (the masked sum).
template <bool kMean>
__global__ void __launch_bounds__(kThreads) aggregate_kernel(
    const float4* __restrict__ vals, const float* __restrict__ scales,
    const float* __restrict__ mask, float4* __restrict__ out, int k_clients,
    long long n4) {
  __shared__ float weight[kMaxClients];
  __shared__ int client[kMaxClients];
  __shared__ int n_active;
  __shared__ float count;
  if (threadIdx.x < 32) {
    const int lane = threadIdx.x;
    int na = 0;
    float part = 0.0f;
    bool binary = true;
    for (int base = 0; base < k_clients; base += 32) {
      const int k = base + lane;
      const float m = k < k_clients ? mask[k] : 0.0f;
      const unsigned act = __ballot_sync(0xffffffffu, m != 0.0f);
      if (m != 0.0f) {
        const int slot = na + __popc(act & ((1u << lane) - 1u));
        client[slot] = k;
        weight[slot] = scales[k] * m;
      }
      na += __popc(act);
      if (kMean) {
        part = part + m;
        binary = binary && (m == 0.0f || m == 1.0f);
      }
    }
    if (kMean) {
      float c = 0.0f;
      if (__all_sync(0xffffffffu, binary)) {
        c = warp_sum(part);
      } else if (lane == 0) {
        for (int k = 0; k < k_clients; ++k) c = c + mask[k];
      }
      if (lane == 0) count = fmaxf(c, 1.0f);
    }
    if (lane == 0) n_active = na;
  }
  __syncthreads();
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  const int na = n_active;
  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int j = 0;
  for (; j + 4 <= na; j += 4) {
    const float4 v0 = vals[(long long)client[j] * n4 + i];
    const float4 v1 = vals[(long long)client[j + 1] * n4 + i];
    const float4 v2 = vals[(long long)client[j + 2] * n4 + i];
    const float4 v3 = vals[(long long)client[j + 3] * n4 + i];
    add_scaled(acc, v0, weight[j]);
    add_scaled(acc, v1, weight[j + 1]);
    add_scaled(acc, v2, weight[j + 2]);
    add_scaled(acc, v3, weight[j + 3]);
  }
  for (; j < na; ++j) add_scaled(acc, vals[(long long)client[j] * n4 + i],
                                 weight[j]);
  if (kMean) {
    const float c = count;
    acc.x = acc.x / c;
    acc.y = acc.y / c;
    acc.z = acc.z / c;
    acc.w = acc.w / c;
  }
  out[i] = acc;
}

template <bool kMean>
static int launch(const void* vals, const void* scales, const void* mask,
                  void* out, int k_clients, long long n_elems, void* stream) {
  if (k_clients < 1 || k_clients > kMaxClients || n_elems % 4 != 0) {
    return (int)cudaErrorInvalidValue;
  }
  const long long n4 = n_elems / 4;
  if (n4 > 0) {
    const unsigned blocks = (unsigned)((n4 + kThreads - 1) / kThreads);
    aggregate_kernel<kMean><<<blocks, kThreads, 0, (cudaStream_t)stream>>>(
        (const float4*)vals, (const float*)scales, (const float*)mask,
        (float4*)out, k_clients, n4);
  }
  return (int)cudaGetLastError();
}

// n_elems: rows * 128 values per client slab (a multiple of 4).
extern "C" int codec_aggregate_f32(const void* vals, const void* scales,
                                   const void* mask, void* out, int k_clients,
                                   long long n_elems, void* stream) {
  return launch<true>(vals, scales, mask, out, k_clients, n_elems, stream);
}

extern "C" int codec_aggregate_partial_f32(const void* vals,
                                           const void* scales,
                                           const void* mask, void* out,
                                           int k_clients, long long n_elems,
                                           void* stream) {
  return launch<false>(vals, scales, mask, out, k_clients, n_elems, stream);
}
