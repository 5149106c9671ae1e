// The Mamba selective scan's backward (K8-bwd) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its lax.scan of
// _mamba_step (src/repro/models/ssm.py:99-108) under chunked_scan
// (:26-41), whose chunks of 64 steps are under jax.checkpoint, so BPTT
// keeps only the chunk-boundary states.  Here the forward
// (selective_scan.cu, selective_scan_states_f32) saves those states, H
// (B, ceil(S / 64), di, N), and this kernel recomputes each chunk's
// states from H and walks the chunk back, chunks last to first.  With
// da_t = exp(dt_t A) and dh (the state's cotangent) from 0, each step:
//
//     dh       += dy_t[i] c_t
//     dC_t[n]   = sum_i dy_t[i] h_t[i, n]
//     dB_t[n]   = sum_i dh[i, n] (dt_t x_t)[i]
//     dx_t[i]   = dt_t[i] sum_n dh b_t
//     ddt_t[i]  = x_t[i] sum_n dh b_t + sum_n dh h_{t-1} da_t A
//     dA[i, n] += dh h_{t-1} da_t dt_t
//     dh       *= da_t
//
// The plain version is kernels/ref.py selective_scan_bwd_ref.
//
// The design, simple first:
// - one thread a (b, i, n) state, not a (b, i) channel: the chunk's 65
//   states h_{t0-1..t0+63} of that one (i, n) then fit in registers
//   (a fully unrolled walk), where a thread a channel would need
//   64 steps x N x 4 B of shared memory a channel (256 KB for 64
//   channels at N=16, over the 227 KB a block may have), and the
//   sequential recurrence gets N times the threads (131 k at jamba's
//   B=1, di=8,192, N=16, against 8 k);
// - a block is kThreads = 256 threads: kThreads / N channels (16 at
//   N=16, 32 at N=8); the chunk's x, dt, dy of its channels and b, c are
//   staged in shared memory, and dx, ddt are written from there in rows;
// - the sums over n (dx, ddt) are xor butterflies over the N lanes of a
//   channel; the sums over i (dB, dC) a butterfly over the warp's
//   channels, then the block's warps in order in shared memory, then a
//   partial a block, (2, B, n_blocks, S, N) in the scratch;
// - dA is a partial a batch row, (B, di, N) in the scratch;
// - a second launch adds the blocks' partials of dB and dC in block order
//   and the rows' partials of dA in row order within each of A's groups:
//   no atomics, so the same inputs give the same bits, and a vmap fold
//   of K clients (G = K groups) gives each client's own bits;
// - expf (not __expf), as the forward.
//
// What bounds it on this card: at jamba's B=1, S=4,096, di=8,192, N=16 it
// reads x, dt, dy (3 x 134 MB) and H (33.5 MB), writes dx, ddt
// (268 MB): ~0.21 ms at 3.35 TB/s.  The gradient needs B*S*di*N = 0.54 G
// exponentials exp(dt_t A) on the special-function units (~0.13 ms);
// this design evaluates each twice, in the recompute and in the walk.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;
constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;

template <int N>
struct Smem {
  static constexpr int kCh = kThreads / N;  // channels a block
  float x[kChunk][kCh];
  float dt[kChunk][kCh];
  float dy[kChunk][kCh];
  float dx[kChunk][kCh];
  float ddt[kChunk][kCh];
  float b[kChunk][N];
  float c[kChunk][N];
  float red[kChunk][kWarps][2 * N];  // each warp's dB, dC of a step
};

template <int N>
__global__ void __launch_bounds__(kThreads, 2) selective_scan_bwd_kernel(
    const float* __restrict__ xs, const float* __restrict__ dt,
    const float* __restrict__ bc, const float* __restrict__ cc,
    const float* __restrict__ a, const float* __restrict__ states,
    const float* __restrict__ dy, float* __restrict__ dxs,
    float* __restrict__ ddt, float* __restrict__ part_bc,
    float* __restrict__ part_a, int batch, int seq_len, int di,
    int rows_per_group) {
  constexpr int kCh = Smem<N>::kCh;
  extern __shared__ float4 smem_raw[];
  Smem<N>& sm = *reinterpret_cast<Smem<N>*>(smem_raw);
  const int seq = blockIdx.y;
  const int blk = blockIdx.x;
  const int n_blk = gridDim.x;
  const int tid = threadIdx.x;
  const int lc = tid / N;  // the thread's channel within the block
  const int n = tid % N;
  const int lane = tid % 32;
  const int warp = tid / 32;
  const int ch = blk * kCh + lc;
  const bool live = ch < di;
  const float an =
      live ? a[((long long)(seq / rows_per_group) * di + ch) * N + n] : 0.0f;
  const int n_chunks = (seq_len + kChunk - 1) / kChunk;

  float dh = 0.0f, dA = 0.0f;
  for (int chunk = n_chunks - 1; chunk >= 0; --chunk) {
    const int t0 = chunk * kChunk;
    const int steps = min(kChunk, seq_len - t0);
    __syncthreads();  // the last chunk's rows are written out
    // the chunk's inputs; steps past S and channels past di read as 0,
    // which leaves h and dh as they are and adds nothing to dB, dC, dA
    for (int j = tid; j < kChunk * kCh; j += kThreads) {
      const int s = j / kCh, l = j % kCh, c = blk * kCh + l;
      float xv = 0.0f, dtv = 0.0f, dyv = 0.0f;
      if (s < steps && c < di) {
        const long long off = ((long long)seq * seq_len + t0 + s) * di + c;
        xv = xs[off];
        dtv = dt[off];
        dyv = dy[off];
      }
      sm.x[s][l] = xv;
      sm.dt[s][l] = dtv;
      sm.dy[s][l] = dyv;
    }
    for (int j = tid; j < kChunk * N; j += kThreads) {
      const int s = j / N, m = j % N;
      float bv = 0.0f, cv = 0.0f;
      if (s < steps) {
        const long long off = ((long long)seq * seq_len + t0 + s) * N + m;
        bv = bc[off];
        cv = cc[off];
      }
      sm.b[s][m] = bv;
      sm.c[s][m] = cv;
    }
    __syncthreads();

    // the chunk's states, recomputed from H as the forward computes them
    float hs[kChunk + 1];
    hs[0] = live ? states[(((long long)seq * n_chunks + chunk) * di + ch) * N
                          + n]
                 : 0.0f;
#pragma unroll
    for (int s = 0; s < kChunk; ++s) {
      const float dtv = sm.dt[s][lc];
      const float dx = dtv * sm.x[s][lc];
      const float da = expf(dtv * an);
      hs[s + 1] = da * hs[s] + dx * sm.b[s][n];
    }

    // the walk back
#pragma unroll
    for (int s = kChunk - 1; s >= 0; --s) {
      const float dtv = sm.dt[s][lc];
      const float xv = sm.x[s][lc];
      const float dyv = sm.dy[s][lc];
      const float da = expf(dtv * an);
      dh += dyv * sm.c[s][n];
      float pc = dyv * hs[s + 1];      // dC's term
      float pb = dh * (dtv * xv);      // dB's term
      float sb = dh * sm.b[s][n];      // sum_n dh b
      const float q = dh * hs[s] * da;
      float sa = q * an;               // sum_n dh h_{t-1} da A
      dA += q * dtv;
      dh *= da;
#pragma unroll
      for (int o = N / 2; o > 0; o >>= 1) {
        sb += __shfl_xor_sync(0xffffffffu, sb, o);
        sa += __shfl_xor_sync(0xffffffffu, sa, o);
      }
#pragma unroll
      for (int o = N; o < 32; o <<= 1) {
        pb += __shfl_xor_sync(0xffffffffu, pb, o);
        pc += __shfl_xor_sync(0xffffffffu, pc, o);
      }
      if (n == 0) {
        sm.dx[s][lc] = dtv * sb;
        sm.ddt[s][lc] = xv * sb + sa;
      }
      if (lane < N) {
        sm.red[s][warp][lane] = pb;
        sm.red[s][warp][N + lane] = pc;
      }
    }
    __syncthreads();

    for (int j = tid; j < kChunk * kCh; j += kThreads) {
      const int s = j / kCh, l = j % kCh, c = blk * kCh + l;
      if (s < steps && c < di) {
        const long long off = ((long long)seq * seq_len + t0 + s) * di + c;
        dxs[off] = sm.dx[s][l];
        ddt[off] = sm.ddt[s][l];
      }
    }
    // this block's dB and dC of each step: its warps in order
    for (int j = tid; j < kChunk * 2 * N; j += kThreads) {
      const int s = j / (2 * N), v = j % (2 * N);
      if (s < steps) {
        float acc = sm.red[s][0][v];
#pragma unroll
        for (int w = 1; w < kWarps; ++w) acc += sm.red[s][w][v];
        const int which = v / N, m = v % N;
        part_bc[((((long long)which * batch + seq) * n_blk + blk) * seq_len +
                 t0 + s) * N + m] = acc;
      }
    }
  }
  if (live) part_a[((long long)seq * di + ch) * N + n] = dA;
}

// dB, dC: the blocks' partials in block order; dA: the rows' partials in
// row order within each group.
__global__ void selective_scan_bwd_close(
    const float* __restrict__ part_bc, const float* __restrict__ part_a,
    float* __restrict__ dbc, float* __restrict__ dcc, float* __restrict__ da,
    int batch, int seq_len, int n_state, int n_blk, int di, int groups) {
  const long long per_seq = (long long)seq_len * n_state;
  const long long n_bc = (long long)batch * per_seq;
  const long long n_a = (long long)groups * di * n_state;
  const long long total = 2 * n_bc + n_a;
  for (long long j = (long long)blockIdx.x * blockDim.x + threadIdx.x;
       j < total; j += (long long)gridDim.x * blockDim.x) {
    if (j < 2 * n_bc) {
      const long long which = j / n_bc, r = j % n_bc;
      const long long seq = r / per_seq, tm = r % per_seq;
      const float* p = part_bc + ((which * batch + seq) * n_blk) * per_seq + tm;
      float acc = p[0];
      for (int k = 1; k < n_blk; ++k) acc += p[k * per_seq];
      (which ? dcc : dbc)[r] = acc;
    } else {
      const long long r = j - 2 * n_bc;
      const long long per_g = (long long)di * n_state;
      const long long g = r / per_g, im = r % per_g;
      const int rows = batch / groups;
      const float* p = part_a + g * rows * per_g + im;
      float acc = p[0];
      for (int k = 1; k < rows; ++k) acc += p[k * per_g];
      da[r] = acc;
    }
  }
}

template <int N>
int launch(const void* xs, const void* dt, const void* bc, const void* cc,
           const void* a, const void* states, const void* dy, void* dxs,
           void* ddt, void* dbc, void* dcc, void* da, void* scratch,
           int batch, int seq_len, int di, int groups, void* stream) {
  constexpr int kCh = Smem<N>::kCh;
  const int n_blk = (di + kCh - 1) / kCh;
  const int smem = static_cast<int>(sizeof(Smem<N>));
  cudaError_t err = cudaFuncSetAttribute(
      selective_scan_bwd_kernel<N>,
      cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  float* part_bc = static_cast<float*>(scratch);
  float* part_a = part_bc + 2LL * batch * n_blk * seq_len * N;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  selective_scan_bwd_kernel<N><<<dim3(n_blk, batch), kThreads, smem, s>>>(
      static_cast<const float*>(xs), static_cast<const float*>(dt),
      static_cast<const float*>(bc), static_cast<const float*>(cc),
      static_cast<const float*>(a), static_cast<const float*>(states),
      static_cast<const float*>(dy), static_cast<float*>(dxs),
      static_cast<float*>(ddt), part_bc, part_a, batch, seq_len, di,
      batch / groups);
  err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long total =
      2LL * batch * seq_len * N + (long long)groups * di * N;
  const int threads = 256;
  const long long want = (total + threads - 1) / threads;
  const int grid = static_cast<int>(want < 132 * 16 ? want : 132 * 16);
  selective_scan_bwd_close<<<grid, threads, 0, s>>>(
      part_bc, part_a, static_cast<float*>(dbc), static_cast<float*>(dcc),
      static_cast<float*>(da), batch, seq_len, N, n_blk, di, groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (dxs, ddt) (B, S, di), (dbc, dcc) (B, S, N) and da (groups, di, N) of
// the scan under dy, from the forward's H; A (groups, di, N), ``groups``
// dividing the batch.  scratch: 2 B n_blocks S N + B di N floats, n_blocks
// = ceil(di / (256 / N)).  N is 8 or 16 (any other N returns
// cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int selective_scan_bwd_f32(
    const void* xs, const void* dt, const void* bc, const void* cc,
    const void* a, const void* states, const void* dy, void* dxs, void* ddt,
    void* dbc, void* dcc, void* da, void* scratch, int batch, int seq_len,
    int di, int n_state, int groups, void* stream) {
  if (groups < 1 || batch % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_state == 8)
    return launch<8>(xs, dt, bc, cc, a, states, dy, dxs, ddt, dbc, dcc, da,
                     scratch, batch, seq_len, di, groups, stream);
  if (n_state == 16)
    return launch<16>(xs, dt, bc, cc, a, states, dy, dxs, ddt, dbc, dcc, da,
                      scratch, batch, seq_len, di, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
