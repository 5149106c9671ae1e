// The Mamba selective scan (K8) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as a
// lax.scan of one step a token (src/repro/models/ssm.py:99-108
// _mamba_step, under chunked_scan :26-41), which XLA compiles into one
// loop on the TPU.  On the card a Python loop of that step costs about
// 8 launches a token, ~33 k a mamba layer of a 4,096-token prefill, so
// the scan is a kernel of the port.
//
// From h = 0, for t = 0..S-1, each (b, i) channel of N states computes
//
//     h[n] = exp(dt_t A[i, n]) * h[n] + (dt_t x_t) * b_t[n]
//     y_t  = sum_n h[n] c_t[n]
//
//     xs, dt (B, S, di); Bc, Cc (B, S, N); A (di, N); all f32 -> y (B, S, di)
//
// with the products in the reference's order: dt * x first, then times
// b.  The plain version is kernels/ref.py selective_scan_ref.
//
// Training's entry point (selective_scan_states_f32) also writes H
// (B, ceil(S / 64), di, N), the state before each chunk of kChunk = 64
// steps, which the backward (selective_scan_bwd.cu) recomputes each
// chunk from, and takes A per group: A (G, di, N), row b reading
// A[b / (B / G)] (a vmap fold of G clients with their own A).  Its y is
// serving's, bit for bit: the same instructions compute h and y, and H
// is stored beside them.
//
// What bounds it on this card: at jamba's prefill (B=1, S=4,096,
// di=8,192, N=16) it reads x and dt and writes y, 403 MB (0.120 ms at
// 3.35 TB/s), and evaluates B*S*di*N = 537 M exponentials (the SFU's
// 16 a clock an SM: ~0.13 ms), so both bounds lie near 0.13 ms.  The
// recurrence is sequential in t, so the parallelism is the B*di channels
// alone: 8,192 threads, two warps an SM.
//
// The design, simple first:
// - one thread a (b, i) channel, its N states and its row of A in
//   registers (a template over N: 8 for the reduced preset, 16 at full
//   width);
// - a block a tile of kChannels = 64 channels of one sequence (B=1,
//   di=8,192 gives 128 blocks, about one wave on the 132 SMs);
// - x and dt of kSteps timesteps for the block's channels (a row of 256
//   contiguous bytes a step) and b_t, c_t of those steps (shared by every
//   channel of the block) are staged in shared memory by cp.async, two
//   tiles in flight: the next tile loads while this one is computed;
// - c_t and b_t are read from shared memory as broadcasts, y_t is
//   written straight to device memory, a 256-byte row a step;
// - expf (not __expf): the plain version's exp to an ulp or two.
#include <cuda_runtime.h>

namespace {

constexpr int kChannels = 64;
constexpr int kSteps = 32;
constexpr int kChunk = 64;  // steps between the saved states (2 tiles)

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most one group (the newest) is still in flight.
__device__ __forceinline__ void cp_wait_all_but_newest() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

template <int N>
struct Tile {
  float x[kSteps][kChannels];
  float dt[kSteps][kChannels];
  float b[kSteps * N];
  float c[kSteps * N];
};

// Issue the copies of tile ``tile`` (steps [tile * kSteps, ...)) of
// sequence ``seq`` into ``dst``; rows past S are not copied.
template <int N>
__device__ __forceinline__ void load_tile(
    Tile<N>& dst, const float* __restrict__ xs, const float* __restrict__ dt,
    const float* __restrict__ bc, const float* __restrict__ cc, int seq,
    int tile, int seq_len, int di, int ch) {
  const int t0 = tile * kSteps;
  const int steps = min(kSteps, seq_len - t0);
  const int lane = threadIdx.x;
  if (ch < di) {
    const long long base = ((long long)seq * seq_len + t0) * di + ch;
    for (int s = 0; s < steps; ++s) {
      cp_async4(&dst.x[s][lane], xs + base + (long long)s * di);
      cp_async4(&dst.dt[s][lane], dt + base + (long long)s * di);
    }
  }
  const long long bbase = ((long long)seq * seq_len + t0) * N;
  for (int j = lane; j < steps * N; j += kChannels) {
    cp_async4(&dst.b[j], bc + bbase + j);
    cp_async4(&dst.c[j], cc + bbase + j);
  }
}

// kStates: also write each chunk's starting state to ``states`` (H),
// and read A of the row's group (``rows_per_group`` rows a group).
template <int N, bool kStates>
__global__ void __launch_bounds__(kChannels) selective_scan_kernel(
    const float* __restrict__ xs, const float* __restrict__ dt,
    const float* __restrict__ bc, const float* __restrict__ cc,
    const float* __restrict__ a, float* __restrict__ y,
    float* __restrict__ states, int seq_len, int di, int rows_per_group) {
  __shared__ Tile<N> tiles[2];
  const int seq = blockIdx.y;
  const int ch = blockIdx.x * kChannels + threadIdx.x;
  const bool live = ch < di;
  const float* arow =
      kStates ? a + (long long)(seq / rows_per_group) * di * N : a;

  float an[N], h[N];
#pragma unroll
  for (int n = 0; n < N; ++n) {
    an[n] = live ? arow[(long long)ch * N + n] : 0.0f;
    h[n] = 0.0f;
  }
  const int n_chunks = (seq_len + kChunk - 1) / kChunk;

  const int n_tiles = (seq_len + kSteps - 1) / kSteps;
  float* yrow = y + (long long)seq * seq_len * di + ch;
  load_tile<N>(tiles[0], xs, dt, bc, cc, seq, 0, seq_len, di, ch);
  cp_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    if (tile + 1 < n_tiles)
      load_tile<N>(tiles[(tile + 1) & 1], xs, dt, bc, cc, seq, tile + 1,
                   seq_len, di, ch);
    cp_commit();  // an empty group on the last tile keeps the count even
    cp_wait_all_but_newest();
    __syncthreads();
    const Tile<N>& cur = tiles[tile & 1];
    const int t0 = tile * kSteps;
    const int steps = min(kSteps, seq_len - t0);
    if (kStates && live && t0 % kChunk == 0) {
      float4* dst = reinterpret_cast<float4*>(
          states + (((long long)seq * n_chunks + t0 / kChunk) * di + ch) * N);
#pragma unroll
      for (int n = 0; n < N; n += 4)
        dst[n / 4] = make_float4(h[n], h[n + 1], h[n + 2], h[n + 3]);
    }
#pragma unroll 2
    for (int s = 0; s < steps; ++s) {
      const float dtv = cur.dt[s][threadIdx.x];
      const float dx = dtv * cur.x[s][threadIdx.x];
      float acc = 0.0f;
#pragma unroll
      for (int n = 0; n < N; ++n) {
        const float da = expf(dtv * an[n]);
        h[n] = da * h[n] + dx * cur.b[s * N + n];
        acc += h[n] * cur.c[s * N + n];
      }
      if (live) yrow[(long long)(t0 + s) * di] = acc;
    }
    __syncthreads();  // the next iteration refills this buffer
  }
}

template <int N, bool kStates>
int launch(const void* xs, const void* dt, const void* bc, const void* cc,
           const void* a, void* y, void* states, int batch, int seq_len,
           int di, int groups, void* stream) {
  const dim3 grid((di + kChannels - 1) / kChannels, batch);
  selective_scan_kernel<N, kStates><<<grid, kChannels, 0,
                                      static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(xs), static_cast<const float*>(dt),
      static_cast<const float*>(bc), static_cast<const float*>(cc),
      static_cast<const float*>(a), static_cast<float*>(y),
      static_cast<float*>(states), seq_len, di, batch / groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// y (B, S, di) of the scan; N is 8 or 16 (any other N returns
// cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int selective_scan_f32(const void* xs, const void* dt,
                                  const void* bc, const void* cc,
                                  const void* a, void* y, int batch,
                                  int seq_len, int di, int n_state,
                                  void* stream) {
  if (n_state == 8)
    return launch<8, false>(xs, dt, bc, cc, a, y, nullptr, batch, seq_len,
                            di, 1, stream);
  if (n_state == 16)
    return launch<16, false>(xs, dt, bc, cc, a, y, nullptr, batch, seq_len,
                             di, 1, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}

// Training's forward: y as above, and H (B, ceil(S / 64), di, N), the
// state before each chunk of 64 steps; A (groups, di, N), ``groups``
// dividing the batch (1: A (di, N) for every row).
extern "C" int selective_scan_states_f32(const void* xs, const void* dt,
                                         const void* bc, const void* cc,
                                         const void* a, void* y,
                                         void* states, int batch,
                                         int seq_len, int di, int n_state,
                                         int groups, void* stream) {
  if (groups < 1 || batch % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  if (n_state == 8)
    return launch<8, true>(xs, dt, bc, cc, a, y, states, batch, seq_len, di,
                           groups, stream);
  if (n_state == 16)
    return launch<16, true>(xs, dt, bc, cc, a, y, states, batch, seq_len,
                            di, groups, stream);
  return static_cast<int>(cudaErrorInvalidValue);
}
