// The mLSTM scan (K9) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as a
// lax.scan of one step a token (src/repro/models/xlstm.py:52-68
// _mlstm_step, under chunked_scan, :105-106), which XLA compiles into one
// loop on the TPU.  On the card a Python loop of the step costs about 12
// launches a token, ~49 k an mLSTM layer of a 4,096-token prefill, so the
// scan is a kernel of the port.
//
// From C = 0, n = 0, m = -1e30, for t = 0..S-1, each (b, head) computes
//
//     m' = max(log_f + m, log_i);  i = exp(log_i - m');  f = exp(log_f + m - m')
//     C[r][c] = f C[r][c] + (i k[r]) v[c];   n[r] = f n[r] + i k[r]
//     h[c] = sum_r C[r][c] q[r] s / max(|sum_r n[r] q[r] s|, 1),  s = dk^-1/2
//
//     q, k, v (B, S, H, D); log_i, log_f (B, S, H); all f32 -> h (B, S, H, D)
//
// with D = dk = dv.  The plain version is kernels/ref.py mlstm_scan_ref.
//
// What bounds it on this card: at xlstm-350m's prefill (B=1, S=4,096,
// H=4, D=512) the state C is 1 MB a head, and each step touches all of it
// (about 5 flops an element: 21.5 GFLOP, 0.32 ms at 67 TFLOP/s), while
// the bytes are q, k, v read and h written once (134 MB, 0.04 ms).  No
// thread needs another's C between steps: C's columns and rows are each
// their own recurrence, and only h's two sums cross threads.
//
// The design (mlstm_plan in kernels/xlstm_scan.py mirrors Layout):
// - a block takes one (b, head) and kCols = 16 columns of C (32 blocks a
//   head at D = 512, 128 at B=1), with D threads that hold its D x 16
//   slab of C in registers, 4 rows of 4 columns a thread (so a step's
//   shared loads are 4 rows of i k and q s and 4 columns of v for 16
//   elements), and a service warp;
// - q, k and the block's 16 columns of v of kTile = 16 steps are staged
//   in shared memory by cp.async, a warp a row, two tiles in flight
//   (bulk copies issued by the service warp measured no faster, PERF.md);
// - after a tile lands, the block computes its shared values once, not
//   once a column thread: thread r makes row r of i k and q s, in place
//   of k and q, carries n's row r through the tile, and its warp adds
//   den's 16 sums (n . q s a step) together by a reduce-scatter;
// - each step a thread adds its 4 x 4 products of C q s, the warp's 8 row
//   groups of each column by a reduce-scatter, and the warp's 16 partial
//   sums go into a buffer the size of a tile: no block barrier between a
//   tile's steps.  Two barriers a tile (the tile landed; its shared
//   values made).  The service warp, beside the steps, adds the last
//   tile's warps' partials in warp order and stores its h, and runs the
//   gates' scalar chain (m, i, f) a tile ahead;
// - the recurrence rounds one operation at a time as the plain version
//   does (C = f C + (i k) v, n = f n + i k); the sums keep their FMAs;
//   sums in a fixed order, no atomics: two calls give the same bits;
//   expf (not __expf): the plain version's exp to an ulp or two.
//
// Bytes at (x1): q, k, v read and h written once, 134 MB.  What bounds
// it: 4 instructions an element a step (the recurrence rounded as 3, and
// the FMA of h's sum), ~0.53 ms of the SMs' f32 issue at (x1), with one
// block an SM.
//
// Training (mlstm_scan_states_f32): the same kernel also writes the state
// before each chunk of kChunk = 64 steps, C (B, ceil(S / 64), H, D, D),
// n (B, ceil(S / 64), H, D) and m (B, ceil(S / 64), H), from which the
// backward (mlstm_scan_bwd.cu) recomputes each chunk: each block writes
// its 16 columns of C, the head's first block n and m.  The serving
// launch is the template without those stores.
#include <cuda_runtime.h>

namespace {

constexpr int kCols = 16;
constexpr int kTile = 16;
constexpr int kChunk = 64;  // steps between saved states (a multiple of kTile)
constexpr unsigned kFull = 0xffffffffu;

// The layout of head dim D: D threads hold the block's D x 16 slab of C,
// thread i rows 4 (i / 4) .. + 3 of columns 4 (i % 4) .. + 3, and a
// service warp follows them; in dynamic shared memory, in floats, two
// tiles of (q, k: kTile x D each; v: kTile x kCols), then two of (i, f)
// a step, the warps' partial sums of h's numerator (two tiles, 16 a
// warp) and of den (two tiles, a warp's 32 rows of n each).
template <int D>
struct Layout {
  static constexpr int kWarps = D / 32;
  static constexpr int kBlock = D + 32;
  static constexpr int kTileFloats = 2 * kTile * D + kTile * kCols;
  static constexpr int kIpf = 2 * kTileFloats;
  static constexpr int kNum = kIpf + 2 * 2 * kTile;
  static constexpr int kDen = kNum + 2 * kTile * kWarps * kCols;
  static constexpr int kFloats = kDen + 2 * kTile * kWarps;
  static constexpr int kBytes = 4 * kFloats;
  static_assert(D % 32 == 0, "whole warps");
  static_assert(kBytes <= 232448, "within a block's shared memory");
};

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

__device__ __forceinline__ void cp_wait_all() {
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// One round of a warp's reduce-scatter of 2 * kLen values: lanes whose
// bit kO is set keep the upper half, the others the lower, each adding
// its partner's copy of the half it keeps.
template <int kO, int kLen>
__device__ __forceinline__ void scatter_round(float* x, int lane) {
  const bool up = (lane & kO) != 0;
#pragma unroll
  for (int i = 0; i < kLen; ++i) {
    const float send = up ? x[i] : x[i + kLen];
    const float keep = up ? x[i + kLen] : x[i];
    x[i] = keep + __shfl_xor_sync(kFull, send, kO);
  }
}

// Issue the copies of the steps [t0, t0 + steps) of (b, head) into tile
// ``dst`` (q at 0, k at kTile D, v at 2 kTile D): a warp a row of q or k
// at a time, 16 bytes a lane.
template <int D>
__device__ __forceinline__ void load_tile(
    float* dst, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, int b, int head, int heads, int seq_len,
    int col0, int t0, int steps) {
  const int tid = threadIdx.x, lane = tid % 32;
  constexpr int kW = Layout<D>::kBlock / 32;
  for (int r = tid / 32; r < 2 * steps; r += kW) {
    const int s = r < steps ? r : r - steps;
    const long long row = ((long long)b * seq_len + t0 + s) * heads + head;
    const float* src = (r < steps ? q : k) + row * D;
    float* to = dst + (r < steps ? s : kTile + s) * D;
#pragma unroll
    for (int c4 = 4 * lane; c4 < D; c4 += 128) cp_async16(to + c4, src + c4);
  }
  if (tid < steps * (kCols / 4)) {
    const int s = tid / (kCols / 4), c4 = (tid % (kCols / 4)) * 4;
    const long long row = ((long long)b * seq_len + t0 + s) * heads + head;
    cp_async16(dst + 2 * kTile * D + s * kCols + c4,
               v + row * D + col0 + c4);
  }
}

// 4 x 4 elements of C a thread.  kSave: the training launch, which also
// writes the state before each chunk into c_st, n_st, m_st.
template <int D, bool kSave>
__global__ void __launch_bounds__(Layout<D>::kBlock, 1) mlstm_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, float* __restrict__ h,
    float* __restrict__ c_st, float* __restrict__ n_st,
    float* __restrict__ m_st, int seq_len, int heads, float scale) {
  using Lay = Layout<D>;
  constexpr int W = Lay::kWarps;
  extern __shared__ float4 smem4[];
  float* smem = reinterpret_cast<float*>(smem4);
  float2* ipf = reinterpret_cast<float2*>(smem + Lay::kIpf);  // [2][kTile]
  float* numpart = smem + Lay::kNum;  // [2][kTile][W][kCols]
  float* denpart = smem + Lay::kDen;  // [2][kTile][W]
  const int b = blockIdx.x / heads, head = blockIdx.x % heads;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int r0 = 4 * (tid / 4), c0 = 4 * (tid % 4);  // this thread's slab
  const bool service = warp == W;
  const bool saver = kSave && blockIdx.y == 0;  // writes n and m
  const int n_chunks = (seq_len + kChunk - 1) / kChunk;
  const int n_tiles = (seq_len + kTile - 1) / kTile;
  auto in_row = [&](int t) {
    return ((long long)b * seq_len + t) * heads + head;
  };
  auto tile_steps = [&](int t) { return min(kTile, seq_len - t * kTile); };

  float C[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int c = 0; c < 4; ++c) C[r][c] = 0.0f;
  float n = 0.0f;  // row tid of n
  // the service warp's gates' chain: m before the next tile, and the
  // gates of that tile, lane s holding step s
  float m = -1e30f, li_n = 0.0f, lf_n = 0.0f;
  auto gates = [&](int t) {
    if (t < n_tiles && lane < tile_steps(t)) {
      li_n = log_i[in_row(t * kTile + lane)];
      lf_n = log_f[in_row(t * kTile + lane)];
    }
  };
  // tile t's (i, f) into ipf[t & 1], from the gates in li_n, lf_n
  auto chain = [&](int t) {
    if (t >= n_tiles) return;
    const int steps = tile_steps(t);
    if (saver && (t * kTile) % kChunk == 0 && lane == 0)
      m_st[((long long)b * n_chunks + t * kTile / kChunk) * heads + head] =
          m;
    float my_a = 0.0f, my_mn = 0.0f, my_li = 0.0f;
#pragma unroll
    for (int s = 0; s < kTile; ++s) {
      const float li = __shfl_sync(kFull, li_n, s);
      const float lf = __shfl_sync(kFull, lf_n, s);
      if (s < steps) {
        const float a = lf + m, mn = fmaxf(a, li);
        if (lane == s) my_a = a, my_mn = mn, my_li = li;
        m = mn;
      }
    }
    if (lane < steps)
      ipf[(t & 1) * kTile + lane] =
          make_float2(expf(my_li - my_mn), expf(my_a - my_mn));
  };
  // tile t's h from the warps' partials, by the service warp
  auto store_h = [&](int t) {
    const int steps = tile_steps(t), buf = t & 1;
    for (int e = lane; e < steps * kCols; e += 32) {
      const int s = e / kCols, c = e % kCols;
      const float* np = numpart + ((buf * kTile + s) * W) * kCols + c;
      const float* dp = denpart + (buf * kTile + s) * W;
      float nu = 0.0f, de = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) nu += np[w * kCols];
#pragma unroll
      for (int w = 0; w < W; ++w) de += dp[w];
      h[in_row(t * kTile + s) * D + col0 + c] = nu / fmaxf(fabsf(de), 1.0f);
    }
  };

  load_tile<D>(smem, q, k, v, b, head, heads, seq_len, col0, 0,
               tile_steps(0));
  cp_commit();
  if (service) {
    gates(0);
    chain(0);
    gates(1);
  }
  for (int t = 0; t < n_tiles; ++t) {
    const int steps = tile_steps(t), buf = t & 1;
    float* tile = smem + buf * Lay::kTileFloats;
    float* qs = tile;                 // q, then q s
    float* ik = tile + kTile * D;     // k, then i k
    const float* vt = tile + 2 * kTile * D;
    cp_wait_all();
    __syncthreads();  // tile t landed; tile t - 1's steps and partials done
    if (t + 1 < n_tiles) {
      load_tile<D>(smem + (buf ^ 1) * Lay::kTileFloats, q, k, v, b, head,
                   heads, seq_len, col0, (t + 1) * kTile, tile_steps(t + 1));
      cp_commit();
    }
    if (!service) {
      // the tile's shared values: thread r makes row r of i k and q s,
      // carries n's row r, and the warp adds den's 16 sums together
      if (saver && (t * kTile) % kChunk == 0)
        n_st[(((long long)b * n_chunks + t * kTile / kChunk) * heads + head) *
                 D + tid] = n;
      // (branch-free, so that the loads run ahead: a partial tile's
      // rows past its steps are made and not used)
      float d[kTile];
#pragma unroll
      for (int s = 0; s < kTile; ++s) {
        const float2 g = ipf[buf * kTile + s];
        const float x = __fmul_rn(g.x, ik[s * D + tid]);
        const float y = __fmul_rn(qs[s * D + tid], scale);
        ik[s * D + tid] = x;
        qs[s * D + tid] = y;
        const bool in = s < steps;
        n = in ? __fadd_rn(__fmul_rn(g.y, n), x) : n;
        d[s] = in ? n * y : 0.0f;
      }
      scatter_round<16, 8>(d, lane);
      scatter_round<8, 4>(d, lane);
      scatter_round<4, 2>(d, lane);
      scatter_round<2, 1>(d, lane);
      d[0] += __shfl_xor_sync(kFull, d[0], 1);
      const int s = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                    ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
      if ((lane & 1) == 0 && s < steps)
        denpart[(buf * kTile + s) * W + warp] = d[0];
    }
    __syncthreads();  // the tile's i k, q s and den's partials made
    if (service) {  // beside the tile's steps: the last tile's h, and the
                    // gates a tile ahead
      if (t > 0) store_h(t - 1);
      chain(t + 1);
      gates(t + 2);
      continue;
    }
    if (kSave && (t * kTile) % kChunk == 0) {
      const long long at =
          ((long long)b * n_chunks + t * kTile / kChunk) * heads + head;
#pragma unroll
      for (int r = 0; r < 4; ++r)
        *reinterpret_cast<float4*>(c_st + (at * D + r0 + r) * D + col0 + c0) =
            make_float4(C[r][0], C[r][1], C[r][2], C[r][3]);
    }
    // a step: (i k, q s, v) of the tile's row s; unrolled over a whole
    // tile, so that the next step's loads run ahead of this one's math
    auto step = [&](int s) {
      const float fp = ipf[buf * kTile + s].y;
      const float4 k4 = *reinterpret_cast<const float4*>(ik + s * D + r0);
      const float4 q4 = *reinterpret_cast<const float4*>(qs + s * D + r0);
      const float4 v4 =
          *reinterpret_cast<const float4*>(vt + s * kCols + c0);
      const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
      const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
      const float vv[4] = {v4.x, v4.y, v4.z, v4.w};
      float num[4] = {0.0f, 0.0f, 0.0f, 0.0f};
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int c = 0; c < 4; ++c) {
          C[r][c] = __fadd_rn(__fmul_rn(fp, C[r][c]), __fmul_rn(kk[r], vv[c]));
          num[c] = fmaf(C[r][c], qq[r], num[c]);
        }
      // the sums over the warp's 8 row groups of each of its 16 columns
      // (a reduce-scatter: lane 4 g + i ends with column 4 i + 2 g_4 +
      // g_3 of its group's sums, g_2 choosing no half)
      scatter_round<16, 2>(num, lane);
      scatter_round<8, 1>(num, lane);
      num[0] += __shfl_xor_sync(kFull, num[0], 4);
      if ((lane & 4) == 0)
        numpart[((buf * kTile + s) * W + warp) * kCols + c0 +
                ((lane >> 4) & 1) * 2 + ((lane >> 3) & 1)] = num[0];
    };
    if (steps == kTile) {
#pragma unroll
      for (int s = 0; s < kTile; ++s) step(s);
    } else {
      for (int s = 0; s < steps; ++s) step(s);
    }
  }
  __syncthreads();
  if (service) store_h(n_tiles - 1);
}

template <int D, bool kSave>
int launch(const void* q, const void* k, const void* v, const void* log_i,
           const void* log_f, void* h, void* c_st, void* n_st, void* m_st,
           int batch, int seq_len, int heads, float scale, void* stream) {
  static int rc = -1;
  if (rc < 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        mlstm_scan_kernel<D, kSave>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, Layout<D>::kBytes));
  if (rc) return rc;
  const dim3 grid(batch * heads, D / kCols);
  mlstm_scan_kernel<D, kSave><<<grid, Layout<D>::kBlock, Layout<D>::kBytes,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(log_i),
      static_cast<const float*>(log_f), static_cast<float*>(h),
      static_cast<float*>(c_st), static_cast<float*>(n_st),
      static_cast<float*>(m_st), seq_len, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
bool plan_matches(int cols, int tile, int threads, int shared_bytes) {
  return cols == kCols && tile == kTile && threads == Layout<D>::kBlock &&
         shared_bytes == Layout<D>::kBytes;
}

template <bool kSave>
int dispatch(const void* q, const void* k, const void* v, const void* log_i,
             const void* log_f, void* h, void* c_st, void* n_st, void* m_st,
             int batch, int seq_len, int heads, int dim, int cols, int tile,
             int threads, int shared_bytes, float scale, void* stream) {
#define MLSTM_LAUNCH(D)                                                     \
  plan_matches<D>(cols, tile, threads, shared_bytes)                        \
      ? launch<D, kSave>(q, k, v, log_i, log_f, h, c_st, n_st, m_st, batch, \
                         seq_len, heads, scale, stream)                     \
      : static_cast<int>(cudaErrorInvalidValue)
  switch (dim) {
    case 64:
      return MLSTM_LAUNCH(64);
    case 128:
      return MLSTM_LAUNCH(128);
    case 256:
      return MLSTM_LAUNCH(256);
    case 512:
      return MLSTM_LAUNCH(512);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLSTM_LAUNCH
}

}  // namespace

// h (B, S, H, D) of the scan; D is 64, 128, 256 or 512, laid out by the
// plan (cols, tile, threads, shared_bytes) of xlstm_scan.mlstm_plan(D)'s
// forward fields (any other D or plan returns cudaErrorInvalidValue; the
// wrapper refuses a D first).
extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v,
                              const void* log_i, const void* log_f, void* h,
                              int batch, int seq_len, int heads, int dim,
                              int cols, int tile, int threads,
                              int shared_bytes, float scale, void* stream) {
  return dispatch<false>(q, k, v, log_i, log_f, h, nullptr, nullptr, nullptr,
                         batch, seq_len, heads, dim, cols, tile, threads,
                         shared_bytes, scale, stream);
}

// The training launch: h and the state before each chunk of 64 steps,
// C (B, ceil(S / 64), H, D, D), n (B, ceil(S / 64), H, D), m (B,
// ceil(S / 64), H).
extern "C" int mlstm_scan_states_f32(
    const void* q, const void* k, const void* v, const void* log_i,
    const void* log_f, void* h, void* c_st, void* n_st, void* m_st,
    int batch, int seq_len, int heads, int dim, int cols, int tile,
    int threads, int shared_bytes, float scale, void* stream) {
  return dispatch<true>(q, k, v, log_i, log_f, h, c_st, n_st, m_st, batch,
                        seq_len, heads, dim, cols, tile, threads,
                        shared_bytes, scale, stream);
}
