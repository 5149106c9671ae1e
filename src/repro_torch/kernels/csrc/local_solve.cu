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
// computed in f32 FMA loops in the reference's order (max-subtract, exp
// with expf, normalise, (p - onehot) / B, then x^T r), with no tensor cores
// (no TF32) and no fast-math.
//
// The TPU grid runs in order and carried the running weights (K2) or the
// gradient accumulators (K3) in VMEM scratch from one grid step to the
// next.  Hopper's blocks run in any order, so here one block owns device k
// and walks the steps (K2) or the row blocks (K3) itself, with the
// weights, the gradient accumulators and the staged batch in shared
// memory.  A masked step is skipped outright, so it keeps w and b exactly.
//
// What bounds it on this card: neither roofline.  A step is ~4 B d C flops
// (2.4 kflop for synthetic, d=60 C=10 B=10; 31 kflop for FEMNIST-like,
// d=784) on a 2.4 KB (or 31 KB) batch: the data and the f32 FMA work would
// take well under a microsecond per step on the whole card.  This first
// design runs only K blocks (10 of 132 SMs), and inside a block the steps
// are a chain of dependent phases separated by __syncthreads(), with one
// thread per output element doing a serial dot product (length d for the
// logits, B for the gradient).  It is bound by that latency chain: the
// time grows with the number of steps E * nb, not with bytes or flops.
// Later work: split the dot products across warps, keep several devices
// per SM busy, or use warp-level mma for the two products.
#include <cuda_runtime.h>

static const int kThreads = 256;

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

// K2.  Grid (K,); shared: w (d*C) | b (C) | x (B*d) | z (B*C) | y (B ints).
__global__ void local_epoch_kernel(
    const float* __restrict__ x, const int* __restrict__ y,
    const float* __restrict__ cw, const float* __restrict__ cb,
    const float* __restrict__ w0, const float* __restrict__ b0,
    const float* __restrict__ step_mask, float* __restrict__ ow,
    float* __restrict__ ob, int nb, int B, int d, int C, int T, float eta,
    float mu) {
  extern __shared__ float smem[];
  const int dC = d * C;
  float* w = smem;
  float* b = w + dC;
  float* xs = b + C;
  float* z = xs + B * d;
  int* ys = (int*)(z + B * C);
  const int k = blockIdx.x;
  const float* cwk = cw + (long long)k * dC;
  const float* cbk = cb + (long long)k * C;
  const float* mk = step_mask + (long long)k * T;

  for (int i = threadIdx.x; i < dC; i += blockDim.x) w[i] = w0[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x) b[i] = b0[i];
  __syncthreads();
  for (int t = 0; t < T; ++t) {
    if (!(mk[t] > 0.0f)) continue;  // the same for every thread
    const long long slab = (long long)k * nb + t % nb;
    stage_batch(x + slab * B * d, y + slab * B, xs, ys, B, d);
    __syncthreads();
    logits(xs, w, b, z, B, d, C);
    __syncthreads();
    softmax_residual(z, ys, B, C, B);
    __syncthreads();
    for (int o = threadIdx.x; o < dC; o += blockDim.x)
      w[o] = sgd_prox(w[o], grad_w(xs, z, B, d, C, o), cwk[o], w0[o], eta,
                      mu);
    for (int c = threadIdx.x; c < C; c += blockDim.x)
      b[c] = sgd_prox(b[c], grad_b(z, B, C, c), cbk[c], b0[c], eta, mu);
    __syncthreads();
  }
  for (int i = threadIdx.x; i < dC; i += blockDim.x)
    ow[(long long)k * dC + i] = w[i];
  for (int i = threadIdx.x; i < C; i += blockDim.x)
    ob[(long long)k * C + i] = b[i];
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
  const size_t smem =
      sizeof(float) * ((size_t)d * C + C + (size_t)B * d + (size_t)B * C) +
      sizeof(int) * (size_t)B;
  int rc = allow_smem((const void*)local_epoch_kernel, smem);
  if (rc) return rc;
  local_epoch_kernel<<<K, kThreads, smem, (cudaStream_t)stream>>>(
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
