// FedDANE local-update kernels for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/dane_update.py:
//   K1  _flat_kernel / dane_update_flat (dane_update.py:62, :85): the masked
//       step over the whole-pytree (K*rows, 128) f32 flat pack, one launch
//       per local step for all leaves and all K devices;
//   K4  _kernel / dane_update_2d (dane_update.py:27, :38): the same step,
//       unmasked, over one leaf's (rows, 128) view (f32 or bf16 storage,
//       f32 arithmetic); the per-device select is done by the caller.
//
//       w' = w - eta * (g + c + mu * (w - a))
//
// What bounds it on this card: memory.  Per element the step reads four
// values and writes one (20 bytes in f32) for six flops, far below the
// H100's ~20 flops/byte balance point, so the least time is bytes over
// 3.35 TB/s.  At the main path's shape (K=10 devices x 8 rows x 128 lanes =
// 10,240 elements, 200 KB) that is ~0.06 us: a launch costs far more, so
// the kernel is bound by launch latency there, not by either roofline.
//
// This first design: one thread per float4 of lanes (K1) or per element
// (K4), 256 threads a block, a 1-D grid over the buffer, no shared memory.
// K1 finds a row's device as row / rows_per_dev (flatpack never lets a row
// straddle devices), so the (K,) mask needs no expanded copy.  At 10k
// elements only ~10 blocks run, so most of the 132 SMs idle; the cure is
// fewer launches (fusing the step into K2/K3, or a CUDA graph), not a
// faster body.
//
// Both kernels call dane_step(), and the file is built with -fmad=false:
// every operation rounds on its own, exactly like the plain PyTorch
// version, so the flat and per-leaf paths are bitwise equal to each other
// and to kernels/ref.py on the card.
#include <cuda_runtime.h>
#include <cuda_bf16.h>

__device__ __forceinline__ float dane_step(float w, float g, float c,
                                           float a, float eta, float mu) {
  return w - eta * (g + c + mu * (w - a));
}

__global__ void dane_update_flat_kernel(
    const float4* __restrict__ w, const float4* __restrict__ g,
    const float4* __restrict__ c, const float4* __restrict__ a,
    const float* __restrict__ mask, float4* __restrict__ out,
    long long n4, long long vec_per_dev, float eta, float mu) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n4) return;
  float4 wv = w[i];
  if (mask[i / vec_per_dev] > 0.0f) {
    float4 gv = g[i], cv = c[i], av = a[i];
    wv.x = dane_step(wv.x, gv.x, cv.x, av.x, eta, mu);
    wv.y = dane_step(wv.y, gv.y, cv.y, av.y, eta, mu);
    wv.z = dane_step(wv.z, gv.z, cv.z, av.z, eta, mu);
    wv.w = dane_step(wv.w, gv.w, cv.w, av.w, eta, mu);
  }
  out[i] = wv;
}

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return p[i];
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(p[i]);
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16(v);
}

template <typename T>
__global__ void dane_update_2d_kernel(
    const T* __restrict__ w, const T* __restrict__ g,
    const T* __restrict__ c, const T* __restrict__ a, T* __restrict__ out,
    long long n, float eta, float mu) {
  long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n) return;
  store(out, i, dane_step(load_f32(w, i), load_f32(g, i), load_f32(c, i),
                          load_f32(a, i), eta, mu));
}

static const int kThreads = 256;

static unsigned blocks_for(long long n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

extern "C" int dane_update_flat_f32(
    const void* w, const void* g, const void* c, const void* a,
    const void* mask, void* out, long long total_rows, long long rows_per_dev,
    float eta, float mu, void* stream) {
  long long n4 = total_rows * 32;  // 128 lanes = 32 float4 per row
  if (n4 > 0) {
    dane_update_flat_kernel<<<blocks_for(n4), kThreads, 0,
                              (cudaStream_t)stream>>>(
        (const float4*)w, (const float4*)g, (const float4*)c,
        (const float4*)a, (const float*)mask, (float4*)out, n4,
        rows_per_dev * 32, eta, mu);
  }
  return (int)cudaGetLastError();
}

// dtype: 0 = float32, 1 = bfloat16
extern "C" int dane_update_2d(
    const void* w, const void* g, const void* c, const void* a, void* out,
    long long n, int dtype, float eta, float mu, void* stream) {
  if (n > 0) {
    cudaStream_t s = (cudaStream_t)stream;
    if (dtype == 0) {
      dane_update_2d_kernel<float><<<blocks_for(n), kThreads, 0, s>>>(
          (const float*)w, (const float*)g, (const float*)c,
          (const float*)a, (float*)out, n, eta, mu);
    } else if (dtype == 1) {
      dane_update_2d_kernel<__nv_bfloat16><<<blocks_for(n), kThreads, 0, s>>>(
          (const __nv_bfloat16*)w, (const __nv_bfloat16*)g,
          (const __nv_bfloat16*)c, (const __nv_bfloat16*)a,
          (__nv_bfloat16*)out, n, eta, mu);
    } else {
      return (int)cudaErrorInvalidValue;
    }
  }
  return (int)cudaGetLastError();
}
