// Fused local-solve kernels for K stacked softmax regressions, for Hopper
// (sm_90a).
//
// Replaces the TPU kernels of src/repro/kernels/local_solve.py:
//   K2  _epoch_kernel / local_epoch (local_solve.py:168, :200): the whole
//       E-epoch masked SGD solve in one launch; step t uses batch t % nb
//       and is kept where step_mask[k, t] > 0;
//   K3  _step_kernel / linear_logistic_step (local_solve.py:68, :111): one
//       masked SGD step, the gradient accumulated over row blocks.
//
// One step of device k, with x (B, d), y (B,), w (d, C), b (C,):
//   z = x w + b;  p = softmax(z);  r = (p - onehot(y)) / B
//   w' = w - eta (x^T r + cw_k + mu (w - w0));  b' = b - eta (sum r + cb_k + mu (b - b0))
// computed in f32 in the reference's order of operations (max-subtract,
// exp with expf, normalise, (p - onehot) / B, then x^T r), with no tensor
// cores (no TF32) and no fast-math.
//
// The TPU grid runs in order and carried the running weights (K2) or the
// gradient accumulators (K3) in VMEM scratch from one grid step to the
// next.  Hopper's blocks run in any order, so one block owns device k and
// walks its steps (K2) itself.  A masked step is skipped outright, so it
// keeps w and b exactly.  Two tiers take every shape the reference's gate
// (B d + 2 d C <= 2^20 words) takes:
// - the shared tier (K2 where its layout below fits 227 KB: d <= 1,030 at
//   C = B = 10) holds w, the correction, the anchor and two batches in
//   shared memory;
// - the global tier (K2 beyond that, and K3 at every size) runs a device
//   on a cluster of up to 8 blocks, each owning a slice of the features,
//   keeps w in global memory (1.4 MB a device at d = 34,952, C = 10),
//   reads the batch, the correction and the anchor from there, and keeps
//   in shared memory only what does not grow with d: two tiles of w, the
//   B x C logit partials and residual, the biases.  See cluster_step.
//
// What bounds K2's shared tier on this card: neither roofline.  A step is
// ~4 B d C flops (2.4 kflop at d=60, C=B=10; 31 kflop at d=784) on a 2.4 KB
// (or 31 KB) batch, well under a microsecond of the card's bytes or FMAs;
// but the steps of one device are a chain, and only K blocks (10 of 132
// SMs) run.  K2's time is that chain's latency, step after step.  Its
// design shortens one step:
// - a scheduling warp, beside the work warps, holds the step table as bits
//   in shared memory (read once; a window of 4096 steps, moved by that warp
//   if a longer table needs it), finds the next kept step there, and starts
//   copying its batch into a second shared buffer (one cp.async.bulk on an
//   mbarrier when the slabs are 16-byte aligned, else 4-byte cp.async)
//   while the current step computes; no global load is left on the chain;
// - the device's correction and the anchor are staged in shared memory once
//   for the whole solve, every row padded to RS = C rounded up to 4 (the pad
//   classes stay 0), so the update reads them as float4;
// - one work warp per batch row computes that row's logits: the lanes split
//   d, each carries 16 class sums at once (independent FMA chains), and a
//   reduce-scatter shuffle tree (16 shuffles for 16 classes, not 80) leaves
//   each class's sum on two lanes; with C <= 16 the same warp takes the
//   row's softmax and residual from there in registers (shuffle trees for
//   the max and normaliser, divisions as products with correctly rounded
//   reciprocals), with no block barrier;
// - one barrier, then each work thread owns (feature f, four classes) of
//   the gradient x^T r, summed over the B rows, and applies the prox update
//   in place; one barrier before the next step.
// Two barriers a step instead of four.  The sums run in another order than
// the plain version's (lane partials over f = lane mod 32, then the trees).
// What bounds the global tier: a step reads ~8 MB a device at d = 34,952
// (x twice, w twice, the correction and the anchor, w written back) with
// few loads in flight a thread, so memory latency, and on one block a
// device every instruction of the step would issue on one SM.  The
// cluster spreads both over up to 8 SMs a device.
#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <algorithm>

namespace cg = cooperative_groups;

__device__ __forceinline__ float sgd_prox(float w, float g, float corr,
                                          float anchor, float eta,
                                          float mu) {
  return w - eta * (g + corr + mu * (w - anchor));
}

// ---------------------------------------------------------------------------
// K2
// ---------------------------------------------------------------------------

// The step table's window in shared memory: 4096 steps as bits.
static const int kWinWords = 128;

__device__ __forceinline__ void cp_async4(void* dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src)
               : "memory");
}

__device__ __forceinline__ void cp_async_wait_all() {
  asm volatile("cp.async.wait_all;\n" ::: "memory");
}

// 4 bytes, or 4 zero bytes where ``n`` is 0 (nothing is read).
__device__ __forceinline__ void cp_async4_zfill(void* dst, const void* src,
                                                int n) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   (unsigned)__cvta_generic_to_shared(dst)),
               "l"(src), "r"(n)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one of this thread's copy groups is in flight.
__device__ __forceinline__ void cp_async_wait_one() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// Steps [base, base + 32 kWinWords) of a device's table as bits (kept iff
// mask > 0; none past T), written by the threads [first, first + n) of the
// block (whole warps).
__device__ void load_window(unsigned* bits, const float* mk, int base, int T,
                            int first, int n) {
#pragma unroll 4
  for (int j = threadIdx.x - first; j < kWinWords * 32; j += n) {
    const int t = base + j;
    const unsigned word = __ballot_sync(0xffffffffu, t < T && mk[t] > 0.0f);
    if ((j & 31) == 0) bits[j >> 5] = word;
  }
}

// The first kept step at or after ``from`` (T if none), by one warp, the
// same in its every lane; the warp moves the window when the search
// leaves it.
__device__ int next_kept(int from, int T, int& base, unsigned* bits,
                         const float* mk) {
  int t = from;
  while (t < T) {
    if (t >= base + kWinWords * 32) {
      __syncwarp();
      base = t & ~31;
      load_window(bits, mk, base, T, threadIdx.x & ~31, 32);
      __syncwarp();
    }
    const int off = t - base;
    const unsigned word = bits[off >> 5] >> (off & 31);
    if (word != 0u) return t + __ffs(word) - 1;
    t = base + ((off >> 5) + 1) * 32;
  }
  return T;
}

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(unsigned long long* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_addr(bar))
               : "memory");
}

// Wait until the barrier's phase of parity ``parity`` has completed.
__device__ __forceinline__ void mbar_wait(unsigned long long* bar,
                                          int parity) {
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_addr(bar)), "r"(parity)
        : "memory");
  } while (!done);
}

// Start copying a batch (B x d floats, B labels) into shared memory, by
// one warp.  When every slab is 16-byte aligned (``bulk``) lane 0 moves
// the floats in one bulk copy that completes on ``bar`` (the buffers were
// last read through the generic proxy, hence the fence first); otherwise
// the lanes copy 4 bytes at a time.  The labels go 4 bytes a lane.
// cp_async_wait_all(), and mbar_wait() for a bulk copy, complete it.
__device__ __forceinline__ void stage_async(float* xs, int* ys,
                                            const float* x, const int* y,
                                            int B, int d, bool bulk,
                                            unsigned long long* bar) {
  const int lane = threadIdx.x % 32;
  if (bulk) {
    if (lane == 0) {
      const unsigned bytes = 4u * (unsigned)(B * d);
      asm volatile(
          "fence.proxy.async.shared::cta;\n"
          "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
          "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
          " [%2], [%3], %1, [%0];\n" ::"r"(smem_addr(bar)),
          "r"(bytes), "r"(smem_addr(xs)), "l"(x)
          : "memory");
    }
  } else {
    for (int i = lane; i < B * d; i += 32) cp_async4(xs + i, x + i);
  }
  for (int i = lane; i < B; i += 32) cp_async4(ys + i, y + i);
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, off));
  return v;
}

// The butterfly leaves the same sum in every lane (a + b == b + a).
__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    v += __shfl_xor_sync(0xffffffffu, v, off);
  return v;
}

// Sum 16 values over the warp's 32 lanes, leaving class cls(lane) =
// 8 bit4 + 4 bit3 + 2 bit2 + bit1 of the lane on the lane: at each level a
// lane keeps half its values and adds its partner's copy of that half.
__device__ __forceinline__ float reduce_scatter16(float (&v)[16], int lane) {
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const bool up = lane & 16;
    const float keep = up ? v[j + 8] : v[j];
    const float send = up ? v[j] : v[j + 8];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 16);
  }
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const bool up = lane & 8;
    const float keep = up ? v[j + 4] : v[j];
    const float send = up ? v[j] : v[j + 4];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 8);
  }
#pragma unroll
  for (int j = 0; j < 2; ++j) {
    const bool up = lane & 4;
    const float keep = up ? v[j + 2] : v[j];
    const float send = up ? v[j] : v[j + 2];
    v[j] = keep + __shfl_xor_sync(0xffffffffu, send, 4);
  }
  const bool up = lane & 2;
  const float keep = up ? v[1] : v[0];
  const float send = up ? v[0] : v[1];
  const float s = keep + __shfl_xor_sync(0xffffffffu, send, 2);
  return s + __shfl_xor_sync(0xffffffffu, s, 1);
}

// Row i's residual r = (softmax(x_i w + b) - onehot(y_i)) / B, by one warp,
// with the two divisions taken as products with correctly rounded
// reciprocals (inv_b = 1/B).  Rows of w, z and r are RS floats apart.  With C <= 16 the logits stay in
// registers, each class on two lanes, and the softmax's max and normaliser
// are shuffle trees over one lane of each pair; a wider C goes through z.
__device__ __forceinline__ void row_residual(int i, const float* xs,
                                             const int* ys, const float* w,
                                             const float* b, float* z,
                                             float* r, int d, int C, int RS,
                                             float inv_b) {
  const int lane = threadIdx.x % 32;
  const int cls = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                  ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  const float* xi = xs + i * d;
  const int y = ys[i];
  for (int c0 = 0; c0 < RS; c0 += 16) {
    float acc[16];
#pragma unroll
    for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
    for (int f = lane; f < d; f += 32) {
      const float xf = xi[f];
      const float4* wr = reinterpret_cast<const float4*>(w + f * RS + c0);
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        if (c0 + 4 * q < RS) {
          const float4 w4 = wr[q];
          acc[4 * q] = fmaf(xf, w4.x, acc[4 * q]);
          acc[4 * q + 1] = fmaf(xf, w4.y, acc[4 * q + 1]);
          acc[4 * q + 2] = fmaf(xf, w4.z, acc[4 * q + 2]);
          acc[4 * q + 3] = fmaf(xf, w4.w, acc[4 * q + 3]);
        }
      }
    }
    const int c = c0 + cls;
    const float zc = reduce_scatter16(acc, lane) + (c < C ? b[c] : 0.0f);
    if (RS <= 16) {
      // lanes l and l ^ 1 hold the same class: the trees over offsets
      // 16 .. 2 see every class once, and leave one result in all lanes
      float m = c < C ? zc : -INFINITY;
#pragma unroll
      for (int off = 16; off > 1; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xffffffffu, m, off));
      const float e = c < C ? expf(zc - m) : 0.0f;
      float s = e;
#pragma unroll
      for (int off = 16; off > 1; off >>= 1)
        s += __shfl_xor_sync(0xffffffffu, s, off);
      if ((lane & 1) == 0 && c < RS)
        r[i * RS + c] =
            c < C ? (e * __frcp_rn(s) - (c == y ? 1.0f : 0.0f)) * inv_b
                  : 0.0f;
      return;
    }
    if ((lane & 1) == 0 && c < C) z[i * RS + c] = zc;
  }
  __syncwarp();
  // C > 16: the softmax across the lanes, lane l taking classes l, l + 32..
  const float* zi = z + i * RS;
  float m = -INFINITY;
  for (int c = lane; c < C; c += 32) m = fmaxf(m, zi[c]);
  m = warp_max(m);
  float s = 0.0f;
  for (int c = lane; c < C; c += 32) s += expf(zi[c] - m);
  s = warp_sum(s);
  const float inv_s = __frcp_rn(s);
  for (int c = lane; c < RS; c += 32)
    r[i * RS + c] =
        c < C ? (expf(zi[c] - m) * inv_s - (c == y ? 1.0f : 0.0f)) * inv_b
              : 0.0f;
}

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

// Grid (K,), blockDim 32 * (work warps + 1).  The work warps take one
// batch row each for the residual, then the gradient units; the last warp
// schedules: it finds the next kept step, starts copying its batch, and
// waits for the copy before the step's last barrier.  Shared: two mbarriers
// (one a batch buffer), then in 4-byte words (RS = C rounded up to 4):
// w, cw, w0 (d*RS each) | b, cb, b0 (RS each) | z, r (B*RS each) | x (2
// buffers of B*d) | y (2 of B) | the step table's window (kWinWords) | the
// next step (2 slots, by parity).
__global__ void __launch_bounds__(1024) local_epoch_kernel(
    const float* __restrict__ x, const int* __restrict__ y,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ step_mask, float* __restrict__ ow,
    float* __restrict__ ob, int nb, int B, int d, int C, int T, float eta,
    float mu) {
  extern __shared__ float4 smem4[];
  const int RS = (C + 3) & ~3;
  unsigned long long* bars = reinterpret_cast<unsigned long long*>(smem4);
  float* w = reinterpret_cast<float*>(bars + 2);
  float* cws = w + d * RS;
  float* w0s = cws + d * RS;
  float* b = w0s + d * RS;
  float* cbs = b + RS;
  float* b0s = cbs + RS;
  float* z = b0s + RS;
  float* r = z + B * RS;
  float* xbuf = r + B * RS;
  int* ybuf = reinterpret_cast<int*>(xbuf + 2 * B * d);
  unsigned* bits = reinterpret_cast<unsigned*>(ybuf + 2 * B);
  int* next_step = reinterpret_cast<int*>(bits + kWinWords);
  const int k = blockIdx.x;
  const float* cwk = cw + (long long)k * d * C;
  const float* cbk = cb + (long long)k * C;
  const float* mk = step_mask + (long long)k * T;
  const float* xk = x + (long long)k * nb * B * d;
  const int* yk = y + (long long)k * nb * B;
  // one bulk copy a batch when every slab starts 16-byte aligned
  const bool bulk = ((reinterpret_cast<unsigned long long>(x) & 15) == 0) &&
                    ((B * d) % 4 == 0);

  const int warp = threadIdx.x / 32;
  const int work_warps = blockDim.x / 32 - 1;
  const int n_work = 32 * work_warps;
  const bool scheduler = warp == work_warps;

  if (threadIdx.x == 0) {
    mbar_init(bars);
    mbar_init(bars + 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  for (int e = threadIdx.x; e < d * RS; e += blockDim.x) {
    const int f = e / RS, c = e % RS;
    const float a = c < C ? w0[f * C + c] : 0.0f;
    w[e] = a;
    w0s[e] = a;
    cws[e] = c < C ? cwk[f * C + c] : 0.0f;
  }
  for (int c = threadIdx.x; c < RS; c += blockDim.x) {
    b[c] = b0s[c] = c < C ? b0[c] : 0.0f;
    cbs[c] = c < C ? cbk[c] : 0.0f;
  }
  load_window(bits, mk, 0, T, 0, blockDim.x);
  __syncthreads();
  // the scheduler's own state: the window's first step, and the parity
  // of each buffer's barrier (bit j for buffer j)
  int base = 0, parity = 0;
  if (scheduler) {
    const int t0 = next_kept(0, T, base, bits, mk);
    if (threadIdx.x % 32 == 0) next_step[0] = t0;
    if (t0 < T) {
      stage_async(xbuf, ybuf, xk + (long long)(t0 % nb) * B * d,
                  yk + (t0 % nb) * B, B, d, bulk, bars);
      cp_async_wait_all();
      if (bulk) {
        mbar_wait(bars, 0);
        parity ^= 1;
      }
    }
  }
  __syncthreads();
  int t = next_step[0];
  int cur = 0;

  // gradient units: u = f + d * q for feature f and classes 4q .. 4q + 3;
  // this thread's first, and the stride between its units
  const float inv_b = __frcp_rn((float)B);
  const int quads = RS / 4, units = d * quads;
  const int f_first = threadIdx.x % d, c_first = 4 * (threadIdx.x / d);
  const int f_step = n_work % d, c_step = 4 * (n_work / d);
  while (t < T) {
    const float* xs = xbuf + cur * B * d;
    const int* ys = ybuf + cur * B;
    if (scheduler) {
      // the next kept step's batch lands while this one runs
      const int tn = next_kept(t + 1, T, base, bits, mk);
      if (threadIdx.x % 32 == 0) next_step[cur ^ 1] = tn;
      if (tn < T)
        stage_async(xbuf + (cur ^ 1) * B * d, ybuf + (cur ^ 1) * B,
                    xk + (long long)(tn % nb) * B * d, yk + (tn % nb) * B,
                    B, d, bulk, bars + (cur ^ 1));
    } else {
      for (int i = warp; i < B; i += work_warps)
        row_residual(i, xs, ys, w, b, z, r, d, C, RS, inv_b);
    }
    __syncthreads();
    // every thread reads the slot before the barrier after next, when the
    // scheduler writes it again
    const int tn = next_step[cur ^ 1];
    if (scheduler) {
      if (tn < T) {
        cp_async_wait_all();
        if (bulk) {
          mbar_wait(bars + (cur ^ 1), (parity >> (cur ^ 1)) & 1);
          parity ^= 1 << (cur ^ 1);
        }
      }
    } else {
      int f = f_first, c = c_first;
      for (int u = threadIdx.x; u < units; u += n_work) {
        float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 5
        for (int i = 0; i < B; ++i) {
          const float xv = xs[i * d + f];
          const float4 r4 = ld4(r + i * RS + c);
          g.x = fmaf(xv, r4.x, g.x);
          g.y = fmaf(xv, r4.y, g.y);
          g.z = fmaf(xv, r4.z, g.z);
          g.w = fmaf(xv, r4.w, g.w);
        }
        const int o = f * RS + c;
        const float4 cv = ld4(cws + o), av = ld4(w0s + o);
        float4 wv = ld4(w + o);
        wv.x = sgd_prox(wv.x, g.x, cv.x, av.x, eta, mu);
        wv.y = sgd_prox(wv.y, g.y, cv.y, av.y, eta, mu);
        wv.z = sgd_prox(wv.z, g.z, cv.z, av.z, eta, mu);
        wv.w = sgd_prox(wv.w, g.w, cv.w, av.w, eta, mu);
        *reinterpret_cast<float4*>(w + o) = wv;
        f += f_step;
        c += c_step;
        if (f >= d) {
          f -= d;
          c += 4;
        }
      }
      // the bias quads, from the last work thread down
      for (int q = n_work - 1 - threadIdx.x; q < quads; q += n_work) {
        const int cq = 4 * q;
        float4 g = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
        for (int i = 0; i < B; ++i) {
          const float4 r4 = ld4(r + i * RS + cq);
          g.x += r4.x;
          g.y += r4.y;
          g.z += r4.z;
          g.w += r4.w;
        }
        const float4 cv = ld4(cbs + cq), av = ld4(b0s + cq);
        float4 bv = ld4(b + cq);
        bv.x = sgd_prox(bv.x, g.x, cv.x, av.x, eta, mu);
        bv.y = sgd_prox(bv.y, g.y, cv.y, av.y, eta, mu);
        bv.z = sgd_prox(bv.z, g.z, cv.z, av.z, eta, mu);
        bv.w = sgd_prox(bv.w, g.w, cv.w, av.w, eta, mu);
        *reinterpret_cast<float4*>(b + cq) = bv;
      }
    }
    __syncthreads();
    t = tn;
    cur ^= 1;
  }
  for (int e = threadIdx.x; e < d * C; e += blockDim.x)
    ow[(long long)k * d * C + e] = w[(e / C) * RS + e % C];
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    ob[(long long)k * C + c] = b[c];
}

// ---------------------------------------------------------------------------
// The global tier: K2 where its shared-memory layout does not fit one
// block, and K3 at every size
// ---------------------------------------------------------------------------
//
// A device's step runs on a cluster of cs blocks (cs <= 8, on neighbouring
// SMs), block q owning a slice of the features, with w in global memory.
// One block a device would wait on L2 and issue every instruction of the
// step on one SM; the cluster spreads both over cs SMs.  Per kept step:
//   1. each block: partial logits over its slice, z_q = x[:, slice]
//      w[slice, :], into its own shared memory (slice_logits);
//   2. one cluster barrier; each block sums the partials of all cs blocks
//      in rank order, through distributed shared memory, and adds the
//      bias: every block holds the same logits, bit for bit; then the
//      softmax residual r, a warp a row;
//   3. each block updates its slice of w (slice_update) and, redundantly
//      and identically, the bias.
// The partials alternate between two buffers from one kept step to the
// next, so one cluster barrier a step suffices: a block writes a buffer
// again only after the next step's barrier, which every block passes
// after its reads.  A batch of thousands of rows (3 B RS floats past
// kPartialFloats) runs on one block a device, its partials and r in a
// global scratch that the caller allocates at the size
// global_scratch_floats reports.

// Floats of one of the two w tiles a block stages in shared memory (64 KB).
static const int kTileFloats = 16384;

// Row stride of a tile of ``width`` classes (a multiple of 4): an odd
// multiple of 4 floats, so that the float4 reads of 8 lanes on 8
// consecutive rows fall on 32 distinct banks.
__host__ __device__ __forceinline__ int tile_stride(int width) {
  return ((width / 4) & 1) ? width : width + 4;
}

// The widest tile row over the 16-class chunks of RS classes.
__host__ __device__ __forceinline__ int tile_stride_max(int RS) {
  return RS <= 16 ? tile_stride(RS) : 20;
}

// Rows of w a tile holds (a multiple of 32).
__host__ __device__ __forceinline__ int tile_rows(int RS) {
  return (kTileFloats / tile_stride_max(RS)) & ~31;
}

// Start copying rows [f0, f0 + nf) of w, classes [c0, c0 + width), into
// a tile of ``S`` floats a row (the classes past C as zeros), by the whole
// block, as one copy group of each thread.
__device__ __forceinline__ void stage_tile(float* tile, const float* w,
                                           int f0, int nf, int c0,
                                           int width, int S, int C) {
  for (int e = threadIdx.x; e < nf * width; e += blockDim.x) {
    const int f = e / width, c = e - f * width;
    const bool in = c0 + c < C;
    cp_async4_zfill(tile + f * S + c,
                    w + (in ? (long long)(f0 + f) * C + c0 + c : 0),
                    in ? 4 : 0);
  }
  cp_async_commit();
}

// zout[i * RS + c] = sum_f x[i, f] w[f, c] over the dl features of a
// slice (x's rows ldx apart, w's C), by the whole block (NW warps), 16
// classes at a time: the block copies F rows of w (those classes,
// padded) into one tile with cp.async while it computes on the other;
// warp j takes row g0 + j % rows of a group of rows and part j / rows of
// every tile, its lanes splitting the part's features with 16 class sums
// a lane, kept across the tiles; one reduce-scatter a row and part, then
// each sum adds its parts in order.  w is read once (once a group of NW
// rows when B > NW).  ``tiles``: two tiles; ``zp``: NW * 16 floats.
// Ends with a block barrier.
__device__ void slice_logits(const float* __restrict__ x, long long ldx,
                             const float* w, int dl, int B, int C, int F,
                             float* tiles, float* zp, float* zout) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int NW = blockDim.x / 32;
  const int RS = (C + 3) & ~3;
  const int cls = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                  ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
  const int tile_floats = F * tile_stride_max(RS);
  for (int c0 = 0; c0 < RS; c0 += 16) {
    const int width = min(16, RS - c0);
    const int S = tile_stride(width);
    for (int g0 = 0; g0 < B; g0 += NW) {
      const int rows = min(NW, B - g0);
      const int parts = NW / rows;
      const bool active = warp < rows * parts;
      const int p = warp / rows;
      const float* xi = x + (long long)(g0 + warp % rows) * ldx;
      float acc[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) acc[c] = 0.0f;
      if (dl > 0) stage_tile(tiles, w, 0, min(F, dl), c0, width, S, C);
      for (int f0 = 0, it = 0; f0 < dl; f0 += F, ++it) {
        const int nf = min(F, dl - f0);
        if (f0 + F < dl) {  // the next tile lands while this one is used
          stage_tile(tiles + ((it + 1) & 1) * tile_floats, w, f0 + F,
                     min(F, dl - f0 - F), c0, width, S, C);
          cp_async_wait_one();
        } else {
          cp_async_wait_all();
        }
        __syncthreads();
        const float* tile = tiles + (it & 1) * tile_floats;
        if (active) {
          const int per = (nf + parts - 1) / parts;
          const int hi = min(nf, (p + 1) * per);
#pragma unroll 8
          for (int f = p * per + lane; f < hi; f += 32) {
            const float xf = xi[f0 + f];
            const float4* wr = reinterpret_cast<const float4*>(tile + f * S);
#pragma unroll
            for (int q = 0; q < 4; ++q) {
              if (4 * q < width) {
                const float4 w4 = wr[q];
                acc[4 * q] = fmaf(xf, w4.x, acc[4 * q]);
                acc[4 * q + 1] = fmaf(xf, w4.y, acc[4 * q + 1]);
                acc[4 * q + 2] = fmaf(xf, w4.z, acc[4 * q + 2]);
                acc[4 * q + 3] = fmaf(xf, w4.w, acc[4 * q + 3]);
              }
            }
          }
        }
        __syncthreads();  // this tile's readers are done before it refills
      }
      if (active) {
        const float s = reduce_scatter16(acc, lane);
        if ((lane & 1) == 0) zp[warp * 16 + cls] = s;
      }
      __syncthreads();
      for (int o = threadIdx.x; o < rows * width; o += blockDim.x) {
        const int i = o / width, c = o - i * width;
        float s = 0.0f;
        for (int q = 0; q < parts; ++q) s += zp[(q * rows + i) * 16 + c];
        zout[(g0 + i) * RS + c0 + c] = s;
      }
      __syncthreads();  // zp is free again
    }
  }
}

// In place: logits -> (softmax - onehot(y)) / B, a warp a row, with
// divisions; the pad classes [C, RS) become 0.
__device__ void residual_rows(float* r, const int* __restrict__ y, int B,
                              int C) {
  const int lane = threadIdx.x % 32, warp = threadIdx.x / 32;
  const int RS = (C + 3) & ~3;
  const float bt = (float)B;
  for (int i = warp; i < B; i += blockDim.x / 32) {
    float* ri = r + i * RS;
    float m = -INFINITY;
    for (int c = lane; c < C; c += 32) m = fmaxf(m, ri[c]);
    m = warp_max(m);
    float s = 0.0f;
    for (int c = lane; c < C; c += 32) s += expf(ri[c] - m);
    s = warp_sum(s);
    const int yi = y[i];
    for (int c = lane; c < RS; c += 32)
      ri[c] = c < C ? (expf(ri[c] - m) / s - (c == yi ? 1.0f : 0.0f)) / bt
                    : 0.0f;
  }
}

// The update of a slice of dl rows of w (x's rows ldx apart): a thread a
// feature f, 16 classes at a time: its w, correction and anchor loaded
// first (before any store, so they are in flight together with the x
// column), g = sum_i x[i, f] r[i, :] over the B rows in order, then the
// prox update written straight to w_out.  w_in and w_out may alias: a
// thread reads and then writes only its own entries.
__device__ void slice_update(const float* __restrict__ x, long long ldx,
                             int dl, const float* r, const float* w_in,
                             const float* __restrict__ cw,
                             const float* __restrict__ w0, float* w_out,
                             int B, int C, float eta, float mu) {
  const int RS = (C + 3) & ~3;
  for (int f = threadIdx.x; f < dl; f += blockDim.x) {
    for (int c0 = 0; c0 < C; c0 += 16) {
      const long long o = (long long)f * C + c0;
      float wv[16], cv[16], av[16], g[16];
#pragma unroll
      for (int c = 0; c < 16; ++c) {
        const bool in = c0 + c < C;
        wv[c] = in ? w_in[o + c] : 0.0f;
        cv[c] = in ? cw[o + c] : 0.0f;
        av[c] = in ? w0[o + c] : 0.0f;
        g[c] = 0.0f;
      }
#pragma unroll 5
      for (int i = 0; i < B; ++i) {
        const float xv = x[(long long)i * ldx + f];
        const float4* ri = reinterpret_cast<const float4*>(r + i * RS + c0);
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          if (c0 + 4 * q < RS) {
            const float4 r4 = ri[q];
            g[4 * q] = fmaf(xv, r4.x, g[4 * q]);
            g[4 * q + 1] = fmaf(xv, r4.y, g[4 * q + 1]);
            g[4 * q + 2] = fmaf(xv, r4.z, g[4 * q + 2]);
            g[4 * q + 3] = fmaf(xv, r4.w, g[4 * q + 3]);
          }
        }
      }
#pragma unroll
      for (int c = 0; c < 16; ++c)
        if (c0 + c < C)
          w_out[o + c] = sgd_prox(wv[c], g[c], cv[c], av[c], eta, mu);
    }
  }
}

// The slices of a device's features: block ``rank`` of ``cs`` owns
// [*f_lo, *f_lo + *dl), in multiples of 32 (the last may be short or
// empty).
__host__ __device__ __forceinline__ int slice_len(int d, int cs) {
  return ((d + cs - 1) / cs + 31) & ~31;
}

// Where a global-tier block keeps things: two tiles | zp | (K2: b, cb, b0,
// RS each) | the partials (two buffers of B * RS) | r (B * RS).  With
// ``scratch``, the partials and r lie in global memory instead, 3 B RS
// floats a device.
struct GlobalLayout {
  float *tiles, *zp, *bias, *zpart, *r;
  int F;
};

__device__ __forceinline__ GlobalLayout global_layout(float* smem,
                                                      float* scratch, int k,
                                                      int B, int C,
                                                      int n_bias) {
  GlobalLayout L;
  const int RS = (C + 3) & ~3;
  L.F = tile_rows(RS);
  L.tiles = smem;
  L.zp = L.tiles + 2 * L.F * tile_stride_max(RS);
  L.bias = L.zp + blockDim.x / 2;  // 16 floats a warp
  L.zpart = scratch ? scratch + (long long)k * 3 * B * RS
                    : L.bias + n_bias * RS;
  L.r = L.zpart + 2 * B * RS;
  return L;
}

// One kept step of device k on its cluster (see the section's note):
// w_in/b_in -> w_out/b_out, block ``rank`` updating its slice of w, rank
// 0 writing b_out when ``write_bias``; ``zpart``: this step's buffer.
__device__ void cluster_step(
    cg::cluster_group& cluster, int cs, int rank, const float* __restrict__ x,
    const int* __restrict__ y, const float* w_in, const float* b_in,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ w0, const float* __restrict__ b0, float* w_out,
    float* b_out, bool write_bias, const GlobalLayout& L, float* zpart,
    int B, int d, int C, float eta, float mu) {
  const int RS = (C + 3) & ~3;
  const int per = slice_len(d, cs);
  const int f_lo = min(d, rank * per), dl = min(per, d - f_lo);
  const long long o = (long long)f_lo * C;
  slice_logits(x + f_lo, d, w_in + o, dl, B, C, L.F, L.tiles, L.zp, zpart);
  cluster.sync();
  for (int e = threadIdx.x; e < B * RS; e += blockDim.x) {
    float s = 0.0f;
    for (int q = 0; q < cs; ++q)
      s += (cs == 1 ? zpart : cluster.map_shared_rank(zpart, q))[e];
    const int c = e % RS;
    L.r[e] = s + (c < C ? b_in[c] : 0.0f);
  }
  __syncthreads();
  residual_rows(L.r, y, B, C);
  __syncthreads();
  slice_update(x + f_lo, d, dl, L.r, w_in + o, cw + o, w0 + o, w_out + o, B,
               C, eta, mu);
  if (write_bias) {
    for (int c = blockDim.x - 1 - threadIdx.x; c < C; c += blockDim.x) {
      float g = 0.0f;
      for (int i = 0; i < B; ++i) g += L.r[i * RS + c];
      b_out[c] = sgd_prox(b_in[c], g, cb[c], b0[c], eta, mu);
    }
  }
  __syncthreads();
}

// K2's global tier.  Grid (cs K,) in clusters of cs, a cluster a device;
// device k's running w is its rows of ow (each block initialises and
// updates its own slice), its bias and the correction's and anchor's
// biases are in each block's shared memory (every block updates its copy
// alike; rank 0 writes ob).  The step table is read from global memory
// (all threads read the same word), and a masked step is skipped by the
// whole cluster, so it keeps w and b exactly.
__global__ void __launch_bounds__(512) local_epoch_global_kernel(
    const float* __restrict__ x, const int* __restrict__ y,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ step_mask, float* ow, float* __restrict__ ob,
    float* scratch, int nb, int B, int d, int C, int T, float eta,
    float mu) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k = blockIdx.x / cs;
  const int RS = (C + 3) & ~3;
  const GlobalLayout L = global_layout(reinterpret_cast<float*>(smem4),
                                       scratch, k, B, C, 3);
  float* b = L.bias;
  float* cbs = b + RS;
  float* b0s = cbs + RS;
  const long long dC = (long long)d * C;
  float* owk = ow + k * dC;
  const int per = slice_len(d, cs);
  const long long lo = (long long)min(d, rank * per) * C;
  const long long hi = (long long)min(d, (rank + 1) * per) * C;
  for (long long e = lo + threadIdx.x; e < hi; e += blockDim.x)
    owk[e] = w0[e];
  for (int c = threadIdx.x; c < RS; c += blockDim.x) {
    b[c] = b0s[c] = c < C ? b0[c] : 0.0f;
    cbs[c] = c < C ? cb[(long long)k * C + c] : 0.0f;
  }
  __syncthreads();
  const float* mk = step_mask + (long long)k * T;
  int parity = 0;
  for (int t = 0; t < T; ++t) {
    if (!(mk[t] > 0.0f)) continue;
    const long long slab = (long long)k * nb + t % nb;
    cluster_step(cluster, cs, rank, x + slab * B * d, y + slab * B, owk, b,
                 cw + k * dC, cbs, w0, b0s, owk, b, true, L,
                 L.zpart + parity * B * RS, B, d, C, eta, mu);
    parity ^= 1;
  }
  if (rank == 0)
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      ob[(long long)k * C + c] = b[c];
  cluster.sync();  // no block leaves while another may read its partials
}

// K3.  Grid (cs K,) in clusters of cs, a cluster a device: one
// cluster_step from w to ow, or, for a masked device, w copied through.
// Device k's batch rows start at x + k * x_stride (y + k * y_stride) and
// are contiguous within the device.  Shared memory is O(B C), whatever d.
__global__ void __launch_bounds__(512) logistic_step_kernel(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ x, long long x_stride,
    const int* __restrict__ y, long long y_stride,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ mask, float* __restrict__ ow,
    float* __restrict__ ob, float* scratch, int B, int d, int C, float eta,
    float mu) {
  extern __shared__ float4 smem4[];
  cg::cluster_group cluster = cg::this_cluster();
  const int cs = (int)cluster.num_blocks(), rank = (int)cluster.block_rank();
  const int k = blockIdx.x / cs;
  const long long dC = (long long)d * C;
  const float* wk = w + k * dC;
  const float* bk = bias + (long long)k * C;
  float* owk = ow + k * dC;
  float* obk = ob + (long long)k * C;
  if (!(mask[k] > 0.0f)) {  // masked device: identity step, by slices
    const int per = slice_len(d, cs);
    const long long hi = (long long)min(d, (rank + 1) * per) * C;
    for (long long e = (long long)min(d, rank * per) * C + threadIdx.x;
         e < hi; e += blockDim.x)
      owk[e] = wk[e];
    if (rank == 0)
      for (int i = threadIdx.x; i < C; i += blockDim.x) obk[i] = bk[i];
    return;
  }
  const GlobalLayout L = global_layout(reinterpret_cast<float*>(smem4),
                                       scratch, k, B, C, 0);
  cluster_step(cluster, cs, rank, x + k * x_stride, y + k * y_stride, wk, bk,
               cw + k * dC, cb + (long long)k * C, w0, b0, owk, obk,
               rank == 0, L, L.zpart, B, d, C, eta, mu);
  cluster.sync();  // no block leaves while another may read its partials
}

static int allow_smem(const void* fn, size_t bytes) {
  if (bytes <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)bytes);
}

extern "C" int local_epoch_f32(
    const void* x, const void* y, const void* cw, const void* cb,
    const void* w0, const void* b0, const void* step_mask, void* ow,
    void* ob, int K, int nb, int B, int d, int C, int T, float eta, float mu,
    void* stream) {
  const size_t rs = (size_t)((C + 3) & ~3);
  const size_t smem =
      2 * sizeof(unsigned long long) +
      sizeof(float) * (3 * (size_t)d * rs + 3 * rs + 2 * (size_t)B * rs +
                       2 * (size_t)B * d) +
      sizeof(int) * (2 * (size_t)B + 2) + sizeof(unsigned) * kWinWords;
  // a work warp per batch row, and enough for one gradient unit a thread,
  // plus the scheduling warp
  const long long units = ((long long)d + 1) * (long long)(rs / 4);
  const long long warps =
      1 + std::min(31LL, std::max((long long)B, (units + 31) / 32));
  int rc = allow_smem((const void*)local_epoch_kernel, smem);
  if (rc) return rc;
  local_epoch_kernel<<<K, 32 * (int)warps, smem, (cudaStream_t)stream>>>(
      (const float*)x, (const int*)y, (const float*)cw, (const float*)cb,
      (const float*)w0, (const float*)b0, (const float*)step_mask,
      (float*)ow, (float*)ob, nb, B, d, C, T, eta, mu);
  return (int)cudaGetLastError();
}

// Floats of a device's logit partials and residual (3 B RS) that a
// global-tier block keeps in shared memory; past this they lie in global
// scratch.
static const long long kPartialFloats = 16384;

static bool partials_in_scratch(int B, int C) {
  return 3LL * B * ((C + 3) & ~3) > kPartialFloats;
}

// The global scratch the global-tier launchers take for K devices on
// batches of B rows and C classes, in floats: 0 where the partials and r
// fit in shared memory (the launchers then take a null scratch).
extern "C" int global_scratch_floats(int K, int B, int C,
                                     long long* floats) {
  *floats = partials_in_scratch(B, C) ? 3LL * K * B * ((C + 3) & ~3) : 0;
  return 0;
}

// Blocks a device: up to 8 (a portable cluster), about 256 features a
// block at least, and no more clusters than fit the SMs at once; one
// where the partials lie in global scratch.
static int cluster_size(int K, int d, bool scratch) {
  static int sms = 0;
  if (scratch) return 1;
  if (sms == 0) {
    int dev = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
  }
  const int cs = std::min(std::min(8, (d + 255) / 256), sms / std::max(K, 1));
  return std::max(1, cs);
}

// Threads of a global-tier block: a warp a batch row, and a thread a
// feature of its slice, within 4 to 16 warps.
static int global_threads(int B, int dl) {
  return 32 * std::min(16, std::max(4, std::max(B, (dl + 31) / 32)));
}

// Shared bytes of a global-tier block: two tiles, zp, the biases, and the
// partials and r unless they lie in global scratch.
static size_t global_smem(int B, int C, int threads, int n_bias,
                          bool scratch) {
  const size_t rs = (size_t)((C + 3) & ~3);
  return sizeof(float) *
         (2 * (size_t)tile_rows((int)rs) * tile_stride_max((int)rs) +
          (size_t)threads / 2 + n_bias * rs +
          (scratch ? 0 : 3 * (size_t)B * rs));
}

template <typename Kernel, typename... Args>
static int launch_clusters(Kernel kernel, int K, int cs, int threads,
                           size_t smem, void* stream, Args... args) {
  int rc = allow_smem((const void*)kernel, smem);
  if (rc) return rc;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3((unsigned)(K * cs));
  cfg.blockDim = dim3((unsigned)threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = (cudaStream_t)stream;
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = (unsigned)cs;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  rc = (int)cudaLaunchKernelEx(&cfg, kernel, args...);
  if (rc) return rc;
  return (int)cudaGetLastError();
}

extern "C" int local_epoch_global_f32(
    const void* x, const void* y, const void* cw, const void* cb,
    const void* w0, const void* b0, const void* step_mask, void* ow,
    void* ob, void* scratch, int K, int nb, int B, int d, int C, int T,
    float eta, float mu, void* stream) {
  const bool in_scratch = partials_in_scratch(B, C);
  if (in_scratch != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  const int cs = cluster_size(K, d, in_scratch);
  const int threads = global_threads(B, slice_len(d, cs));
  return launch_clusters(
      local_epoch_global_kernel, K, cs, threads,
      global_smem(B, C, threads, 3, in_scratch), stream,
      (const float*)x, (const int*)y, (const float*)cw, (const float*)cb,
      (const float*)w0, (const float*)b0, (const float*)step_mask,
      (float*)ow, (float*)ob, (float*)scratch, nb, B, d, C, T, eta, mu);
}

extern "C" int linear_logistic_step_f32(
    const void* w, const void* b, const void* x, long long x_stride,
    const void* y, long long y_stride, const void* cw, const void* cb,
    const void* w0, const void* b0, const void* mask, void* ow, void* ob,
    void* scratch, int K, int B, int d, int C, float eta, float mu,
    void* stream) {
  const bool in_scratch = partials_in_scratch(B, C);
  if (in_scratch != (scratch != nullptr)) return (int)cudaErrorInvalidValue;
  const int cs = cluster_size(K, d, in_scratch);
  const int threads = global_threads(B, slice_len(d, cs));
  return launch_clusters(
      logistic_step_kernel, K, cs, threads,
      global_smem(B, C, threads, 0, in_scratch), stream,
      (const float*)w, (const float*)b, (const float*)x, x_stride,
      (const int*)y, y_stride, (const float*)cw, (const float*)cb,
      (const float*)w0, (const float*)b0, (const float*)mask, (float*)ow,
      (float*)ob, (float*)scratch, B, d, C, eta, mu);
}
