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
// walks its steps (K2) or row blocks (K3) itself, with the state in shared
// memory.  A masked step is skipped outright, so it keeps w and b exactly.
//
// What bounds K2 on this card: neither roofline.  A step is ~4 B d C flops
// (2.4 kflop at d=60, C=B=10; 31 kflop at d=784) on a 2.4 KB (or 31 KB)
// batch, well under a microsecond of the whole card's bytes or f32 FMAs;
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
// K3 keeps its first design: one thread per output, a serial dot product
// per logit and per gradient entry, four barriers per row block.
#include <cuda_runtime.h>

#include <algorithm>

static const int kThreads = 256;  // K3's block

// Stage rows [0, rows) of a batch slab into shared memory.
__device__ __forceinline__ void stage_batch(const float* __restrict__ x,
                                            const int* __restrict__ y,
                                            float* xs, int* ys, int rows,
                                            int d) {
  for (int i = threadIdx.x; i < rows * d; i += blockDim.x) xs[i] = x[i];
  for (int i = threadIdx.x; i < rows; i += blockDim.x) ys[i] = y[i];
}

// z[i, c] = sum_f xs[i, f] w[f, c] + b[c] for i < rows.
__device__ __forceinline__ void logits(const float* xs, const float* w,
                                       const float* b, float* z, int rows,
                                       int d, int C) {
  for (int o = threadIdx.x; o < rows * C; o += blockDim.x) {
    const int i = o / C, c = o % C;
    const float* xi = xs + i * d;
    float acc = 0.0f;
    for (int f = 0; f < d; ++f) acc = fmaf(xi[f], w[f * C + c], acc);
    z[o] = acc + b[c];
  }
}

// In place: logits -> (softmax - onehot(y)) / batch_total, one row a thread.
__device__ __forceinline__ void softmax_residual(float* z, const int* ys,
                                                 int rows, int C,
                                                 int batch_total) {
  const float bt = (float)batch_total;
  for (int i = threadIdx.x; i < rows; i += blockDim.x) {
    float* zi = z + i * C;
    float m = zi[0];
    for (int c = 1; c < C; ++c) m = fmaxf(m, zi[c]);
    float s = 0.0f;
    for (int c = 0; c < C; ++c) {
      const float e = expf(zi[c] - m);
      zi[c] = e;
      s += e;
    }
    for (int c = 0; c < C; ++c) {
      const float p = zi[c] / s;
      zi[c] = (p - (c == ys[i] ? 1.0f : 0.0f)) / bt;
    }
  }
}

// Partial x^T r over the staged rows for output o = f * C + c.
__device__ __forceinline__ float grad_w(const float* xs, const float* z,
                                        int rows, int d, int C, int o) {
  const int f = o / C, c = o % C;
  float g = 0.0f;
  for (int i = 0; i < rows; ++i) g = fmaf(xs[i * d + f], z[i * C + c], g);
  return g;
}

__device__ __forceinline__ float grad_b(const float* z, int rows, int C,
                                        int c) {
  float g = 0.0f;
  for (int i = 0; i < rows; ++i) g += z[i * C + c];
  return g;
}

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

// K3.  Grid (K,); shared: gw (d*C) | gb (C) | x (RB*d) | z (RB*C) | y (RB).
// Device k's batch rows start at x + k * x_stride (y + k * y_stride) and
// are contiguous within the device.
__global__ void logistic_step_kernel(
    const float* __restrict__ w, const float* __restrict__ bias,
    const float* __restrict__ x, long long x_stride,
    const int* __restrict__ y, long long y_stride,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ mask, float* __restrict__ ow,
    float* __restrict__ ob, int B, int d, int C, int RB, float eta,
    float mu) {
  extern __shared__ float smem[];
  const int dC = d * C;
  float* gw = smem;
  float* gb = gw + dC;
  float* xs = gb + C;
  float* z = xs + RB * d;
  int* ys = (int*)(z + RB * C);
  const int k = blockIdx.x;
  const float* wk = w + (long long)k * dC;
  const float* bk = bias + (long long)k * C;
  float* owk = ow + (long long)k * dC;
  float* obk = ob + (long long)k * C;

  if (!(mask[k] > 0.0f)) {  // masked device: identity step
    for (int i = threadIdx.x; i < dC; i += blockDim.x) owk[i] = wk[i];
    for (int i = threadIdx.x; i < C; i += blockDim.x) obk[i] = bk[i];
    return;
  }
  for (int i = threadIdx.x; i < dC; i += blockDim.x) gw[i] = 0.0f;
  for (int i = threadIdx.x; i < C; i += blockDim.x) gb[i] = 0.0f;
  const float* xk = x + (long long)k * x_stride;
  const int* yk = y + (long long)k * y_stride;
  for (int r0 = 0; r0 < B; r0 += RB) {
    const int rows = min(RB, B - r0);
    __syncthreads();
    stage_batch(xk + (long long)r0 * d, yk + r0, xs, ys, rows, d);
    __syncthreads();
    logits(xs, wk, bk, z, rows, d, C);
    __syncthreads();
    softmax_residual(z, ys, rows, C, B);
    __syncthreads();
    for (int o = threadIdx.x; o < dC; o += blockDim.x)
      gw[o] += grad_w(xs, z, rows, d, C, o);
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      gb[c] += grad_b(z, rows, C, c);
  }
  const float* cwk = cw + (long long)k * dC;
  const float* cbk = cb + (long long)k * C;
  for (int o = threadIdx.x; o < dC; o += blockDim.x)
    owk[o] = sgd_prox(wk[o], gw[o], cwk[o], w0[o], eta, mu);
  for (int c = threadIdx.x; c < C; c += blockDim.x)
    obk[c] = sgd_prox(bk[c], gb[c], cbk[c], b0[c], eta, mu);
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

extern "C" int linear_logistic_step_f32(
    const void* w, const void* b, const void* x, long long x_stride,
    const void* y, long long y_stride, const void* cw, const void* cb,
    const void* w0, const void* b0, const void* mask, void* ow, void* ob,
    int K, int B, int d, int C, int RB, float eta, float mu, void* stream) {
  const size_t smem =
      sizeof(float) * ((size_t)d * C + C + (size_t)RB * d + (size_t)RB * C) +
      sizeof(int) * (size_t)RB;
  int rc = allow_smem((const void*)logistic_step_kernel, smem);
  if (rc) return rc;
  logistic_step_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
      (const float*)w, (const float*)b, (const float*)x, x_stride,
      (const int*)y, y_stride, (const float*)cw, (const float*)cb,
      (const float*)w0, (const float*)b0, (const float*)mask, (float*)ow,
      (float*)ob, B, d, C, RB, eta, mu);
  return (int)cudaGetLastError();
}
