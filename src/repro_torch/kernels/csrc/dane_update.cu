// FedDANE local-update kernel for Hopper (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/dane_update.py:
//   K1  _flat_kernel / dane_update_flat (dane_update.py:62, :85): the masked
//       step over the whole-pytree (K*rows, 128) f32 flat pack, one launch
//       per local step for all leaves and all K devices;
//   K4  _kernel / dane_update_2d (dane_update.py:27, :38): the same step,
//       unmasked, over one leaf's (rows, 128) view (f32 or bf16 storage,
//       f32 arithmetic).
//
//       w' = w - eta * (g + c + mu * (w - a))
//
// What bounds it on this card: memory, and before that the launch.  Per
// element the step reads four values and writes one (20 bytes in f32) for
// six flops, far below the H100's ~20 flops/byte balance point, so the
// least time is bytes over 3.35 TB/s: ~0.06 us for the main path's 200 KB
// step (K=10 devices x 8 rows x 128 lanes).  A launch costs far more, and
// the host's path around it more again, so the design is about the launch:
//
// - ONE kernel body for K1, K4 and the per_leaf solver step.  A launch
//   takes a table of up to MAX_SEGMENTS segments, passed by value as the
//   kernel's parameter (3.9 KB, inside the 4 KB parameter space): each
//   segment is one array (a leaf, or the whole flat pack) with its five
//   pointers, element count, elements per device (to find an element's
//   device for the (K,) mask) and dtype.  K1 is one masked f32 segment,
//   K4 one unmasked segment, and the per_leaf step every leaf of a
//   K-stacked tree, masked, in one launch; a device whose mask is not > 0
//   writes w's bits unchanged, so the select the caller did afterwards is
//   folded in.  Longer trees launch in chunks of MAX_SEGMENTS.
// - Each segment owns a whole number of blocks (a prefix of blocks per
//   segment, found by a binary search of the table), so a block never
//   straddles two segments and the dtype and vector branches are uniform
//   within it.
// - A thread updates 4 elements: one 16-byte float4 (f32) or 8-byte load
//   of 4 bf16 per operand where the segment allows it (all five pointers
//   aligned, n and the elements per device multiples of 4), else 4
//   scalars strided by the block.  A masked device loads only w.  A
//   block has kThreads = 128 threads, so that the small main path spreads
//   over more SMs (10,240 elements: 20 blocks); 64 and 256 were no
//   faster on the card.
//
// Every output goes through dane_step() and the file is built with
// -fmad=false: each operation rounds on its own, exactly like the plain
// PyTorch version, so K1, K4 and the per_leaf step are bitwise equal to
// each other and to kernels/ref.py on the card.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

#define MAX_SEGMENTS 64

static const int kThreads = 128;   // threads a block; 4 elements each

// One segment as the wrapper writes it (kernels/dane_update.py, _SEG).
struct HostSegment {
  const void* w;
  const void* g;
  const void* c;
  const void* a;
  void* out;
  long long n;        // elements
  long long per_dev;  // elements per device (masked launches)
  int dtype;          // 0 float32, 1 bfloat16
  int unused;
};

enum { kF32 = 0, kBF16 = 1, kVec = 2 };

struct Segment {
  const void* w;
  const void* g;
  const void* c;
  const void* a;
  void* out;
  long long n;
  int per_dev;
  int kind;           // dtype | kVec
};

// What every segment of a launch shares.
struct Step {
  const float* mask;  // null: unmasked
  long long mask_stride;
  float eta, mu;
};

// A launch's parameter.
struct Table {
  Step p;
  int nseg;
  int first_block[MAX_SEGMENTS];
  Segment seg[MAX_SEGMENTS];
};

static_assert(sizeof(Table) <= 4096,
              "the table must fit the parameter space");

__device__ __forceinline__ float dane_step(float w, float g, float c,
                                           float a, float eta, float mu) {
  return w - eta * (g + c + mu * (w - a));
}

// Whether element i's device takes the step.
__device__ __forceinline__ bool active(const Step& t, long long i,
                                       int per_dev, bool small) {
  if (t.mask == nullptr) return true;
  long long d = small ? (long long)((unsigned)i / (unsigned)per_dev)
                      : i / per_dev;
  return t.mask[d * t.mask_stride] > 0.0f;
}

__device__ __forceinline__ float4 step4(float4 w, float4 g, float4 c,
                                        float4 a, float eta, float mu) {
  return make_float4(dane_step(w.x, g.x, c.x, a.x, eta, mu),
                     dane_step(w.y, g.y, c.y, a.y, eta, mu),
                     dane_step(w.z, g.z, c.z, a.z, eta, mu),
                     dane_step(w.w, g.w, c.w, a.w, eta, mu));
}

// 4 bf16 in 8 bytes <-> 4 floats
__device__ __forceinline__ float4 bf4_to_f4(uint2 v) {
  __nv_bfloat162 lo = *reinterpret_cast<__nv_bfloat162*>(&v.x);
  __nv_bfloat162 hi = *reinterpret_cast<__nv_bfloat162*>(&v.y);
  float2 l = __bfloat1622float2(lo), h = __bfloat1622float2(hi);
  return make_float4(l.x, l.y, h.x, h.y);
}

__device__ __forceinline__ uint2 f4_to_bf4(float4 v) {
  __nv_bfloat162 lo = __halves2bfloat162(__float2bfloat16(v.x),
                                         __float2bfloat16(v.y));
  __nv_bfloat162 hi = __halves2bfloat162(__float2bfloat16(v.z),
                                         __float2bfloat16(v.w));
  uint2 r;
  r.x = *reinterpret_cast<uint32_t*>(&lo);
  r.y = *reinterpret_cast<uint32_t*>(&hi);
  return r;
}

__device__ __forceinline__ float load_f32(const float* p, long long i) {
  return __ldg(p + i);
}
__device__ __forceinline__ float load_f32(const __nv_bfloat16* p,
                                          long long i) {
  return __bfloat162float(__ldg(p + i));
}
__device__ __forceinline__ void store(float* p, long long i, float v) {
  p[i] = v;
}
__device__ __forceinline__ void store(__nv_bfloat16* p, long long i,
                                      float v) {
  p[i] = __float2bfloat16(v);
}

// 4 strided elements a thread; any alignment, any n, any per_dev.
template <typename T>
__device__ __forceinline__ void scalar_path(const Step& t, const Segment& s,
                                            long long base, bool small) {
  const T* __restrict__ w = (const T*)s.w;
  const T* __restrict__ g = (const T*)s.g;
  const T* __restrict__ c = (const T*)s.c;
  const T* __restrict__ a = (const T*)s.a;
  T* __restrict__ out = (T*)s.out;
  bool keep[4];
  long long idx[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    idx[k] = base + threadIdx.x + (long long)k * kThreads;
    keep[k] = idx[k] < s.n && active(t, idx[k], s.per_dev, small);
  }
  float wv[4], gv[4], cv[4], av[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (keep[k]) {
      wv[k] = load_f32(w, idx[k]);
      gv[k] = load_f32(g, idx[k]);
      cv[k] = load_f32(c, idx[k]);
      av[k] = load_f32(a, idx[k]);
    }
  }
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    if (keep[k]) {
      store(out, idx[k], dane_step(wv[k], gv[k], cv[k], av[k], t.eta, t.mu));
    } else if (idx[k] < s.n) {
      out[idx[k]] = w[idx[k]];   // a masked device keeps w's bits
    }
  }
}

// One 4-element vector a thread: V is float4 (f32) or uint2 (4 bf16).
template <typename V>
__device__ __forceinline__ void vector_path(const Step& t, const Segment& s,
                                            long long base, bool small) {
  long long i = base + 4LL * threadIdx.x;
  if (i >= s.n) return;
  long long v = i >> 2;
  const V* __restrict__ w = (const V*)s.w;
  V* __restrict__ out = (V*)s.out;
  if (!active(t, i, s.per_dev, small)) {
    out[v] = w[v];               // a masked device keeps w's bits
    return;
  }
  V wv = __ldg(w + v), gv = __ldg((const V*)s.g + v),
    cv = __ldg((const V*)s.c + v), av = __ldg((const V*)s.a + v);
  if constexpr (sizeof(V) == 16) {
    out[v] = step4(wv, gv, cv, av, t.eta, t.mu);
  } else {
    out[v] = f4_to_bf4(step4(bf4_to_f4(wv), bf4_to_f4(gv), bf4_to_f4(cv),
                             bf4_to_f4(av), t.eta, t.mu));
  }
}

__global__ void __launch_bounds__(kThreads)
dane_update_kernel(const __grid_constant__ Table t) {
  // the segment that owns this block: the last whose first block <= it
  int b = blockIdx.x, lo = 0, hi = t.nseg - 1;
  while (lo < hi) {
    int mid = (lo + hi + 1) >> 1;
    if (t.first_block[mid] <= b) lo = mid; else hi = mid - 1;
  }
  const Segment& s = t.seg[lo];
  long long base = (long long)(b - t.first_block[lo]) * 4 * kThreads;
  bool small = s.n <= 0xffffffffLL;   // 32-bit division finds the device
  switch (s.kind) {
    case kF32 | kVec: vector_path<float4>(t.p, s, base, small); break;
    case kBF16 | kVec: vector_path<uint2>(t.p, s, base, small); break;
    case kF32: scalar_path<float>(t.p, s, base, small); break;
    default: scalar_path<__nv_bfloat16>(t.p, s, base, small); break;
  }
}

static bool aligned(const void* p, uintptr_t to) {
  return ((uintptr_t)p & (to - 1)) == 0;
}

// Launch the step over nseg segments (1..MAX_SEGMENTS); mask: null
// (unmasked) or (K,) float32 with the given stride in elements.  Returns
// the launch's CUDA error code; cudaErrorInvalidValue for a table the
// kernel cannot take.
extern "C" int dane_update_segments(const HostSegment* segs, int nseg,
                                    const void* mask, long long mask_stride,
                                    float eta, float mu, void* stream) {
  if (nseg < 1 || nseg > MAX_SEGMENTS) return (int)cudaErrorInvalidValue;
  Table t;
  long long blocks = 0, per_block = 4LL * kThreads;
  for (int k = 0; k < nseg; ++k) {
    const HostSegment& h = segs[k];
    if (h.n < 0 || (h.dtype != kF32 && h.dtype != kBF16) ||
        (mask && (h.per_dev <= 0 || h.per_dev > 0x7fffffffLL))) {
      return (int)cudaErrorInvalidValue;
    }
    uintptr_t bytes = h.dtype == kF32 ? 16 : 8;
    bool vec = h.n % 4 == 0 && (!mask || h.per_dev % 4 == 0) &&
               aligned(h.w, bytes) && aligned(h.g, bytes) &&
               aligned(h.c, bytes) && aligned(h.a, bytes) &&
               aligned(h.out, bytes);
    t.seg[k] = Segment{h.w, h.g, h.c, h.a, h.out, h.n,
                       mask ? (int)h.per_dev : 1, h.dtype | (vec ? kVec : 0)};
    t.first_block[k] = (int)blocks;
    blocks += (h.n + per_block - 1) / per_block;
    if (blocks > 0x7fffffffLL) return (int)cudaErrorInvalidValue;
  }
  t.p = Step{(const float*)mask, mask_stride, eta, mu};
  t.nseg = nseg;
  if (blocks > 0) {
    dane_update_kernel<<<(unsigned)blocks, kThreads, 0,
                         (cudaStream_t)stream>>>(t);
  }
  return (int)cudaGetLastError();
}
