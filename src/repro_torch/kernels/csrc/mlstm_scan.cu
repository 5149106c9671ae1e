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
// the bytes are q, k, v read and h written once (134 MB, 0.04 ms).  Both
// are far below what the dependent chain of 4,096 steps allows: each
// step needs the previous one's C, and two sums over all D rows.
//
// The design, simple first:
// - the columns of C are independent: a block takes one (b, head) and
//   kCols = 16 columns, so D = 512 gives 32 blocks a head, 128 at B=1;
// - 256 threads a block: thread (g, c) keeps rows g*R .. g*R+R-1 of
//   column c of C in registers (R = D / 16: 32 floats at D = 512), and
//   the same rows of n (the 16 threads of a row group compute n alike:
//   cheaper than sharing it);
// - q and k of kSteps steps (a whole row each), the block's 16 columns
//   of v and the gates are staged in shared memory by cp.async, two tiles
//   in flight, as K8 stages its inputs;
// - each step sums a thread's R products of C q and n q, adds the two
//   row groups of a warp by a shuffle and the 8 warps' partials through
//   shared memory (one barrier a step; the partial buffer alternates
//   with the step's parity), and 16 threads write the step's 16 outputs;
// - sums in a fixed order, no atomics: two calls give the same bits;
// - expf (not __expf): the plain version's exp to an ulp or two.
//
// Training (mlstm_scan_states_f32): the same kernel also writes the state
// before each chunk of kChunk = 64 steps, C (B, ceil(S / 64), H, D, D),
// n (B, ceil(S / 64), H, D) and m (B, ceil(S / 64), H), from which the
// backward (mlstm_scan_bwd.cu) recomputes each chunk: each block writes
// its 16 columns of C, the head's first block n and m.  The serving
// launch is the template without those stores.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 256;
constexpr int kCols = 16;
constexpr int kGroups = kThreads / kCols;  // row groups, 16
constexpr int kWarps = kThreads / 32;
constexpr int kSteps = 4;
constexpr int kMaxDim = 512;
constexpr int kChunk = 64;  // steps between saved states (a multiple of kSteps)

__device__ __forceinline__ void cp_async16(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n" ::"r"(s),
               "l"(src));
}

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

struct __align__(16) Tile {
  float q[kSteps][kMaxDim];
  float k[kSteps][kMaxDim];
  float v[kSteps][kCols];
  float log_i[kSteps];
  float log_f[kSteps];
};

// Issue the copies of the steps [t0, t0 + steps) of head ``bh`` (row
// ``(b * S + t) * H + head`` of the inputs) into ``dst``.
__device__ __forceinline__ void load_tile(
    Tile& dst, const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, int b, int head, int heads, int seq_len,
    int dim, int col0, int t0, int steps) {
  const int tid = threadIdx.x;
  const int per_row = dim / 4;  // 16-byte copies a row of q or k
  for (int e = tid; e < steps * per_row; e += kThreads) {
    const int s = e / per_row, c4 = (e % per_row) * 4;
    const long long row = ((long long)b * seq_len + t0 + s) * heads + head;
    cp_async16(&dst.q[s][c4], q + row * dim + c4);
    cp_async16(&dst.k[s][c4], k + row * dim + c4);
  }
  if (tid < steps * (kCols / 4)) {
    const int s = tid / (kCols / 4), c4 = (tid % (kCols / 4)) * 4;
    const long long row = ((long long)b * seq_len + t0 + s) * heads + head;
    cp_async16(&dst.v[s][c4], v + row * dim + col0 + c4);
  }
  if (tid < steps) {
    const long long row = ((long long)b * seq_len + t0 + tid) * heads + head;
    cp_async4(&dst.log_i[tid], log_i + row);
    cp_async4(&dst.log_f[tid], log_f + row);
  }
}

// R rows a thread: D = 16 R.  kSave: the training launch, which also
// writes the state before each chunk into c_st, n_st, m_st.
template <int R, bool kSave>
__global__ void __launch_bounds__(kThreads) mlstm_scan_kernel(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, float* __restrict__ h,
    float* __restrict__ c_st, float* __restrict__ n_st,
    float* __restrict__ m_st, int seq_len, int heads, float scale) {
  constexpr int dim = kGroups * R;
  __shared__ Tile tiles[2];
  __shared__ float2 partial[2][kWarps][kCols];
  const int b = blockIdx.x / heads, head = blockIdx.x % heads;
  const int col0 = blockIdx.y * kCols;
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int col = tid % kCols, group = tid / kCols;

  float C[R], n[R];
#pragma unroll
  for (int r = 0; r < R; ++r) C[r] = n[r] = 0.0f;
  float m = -1e30f;

  const int n_tiles = (seq_len + kSteps - 1) / kSteps;
  load_tile(tiles[0], q, k, v, log_i, log_f, b, head, heads, seq_len, dim,
            col0, 0, min(kSteps, seq_len));
  cp_commit();
  for (int tile = 0; tile < n_tiles; ++tile) {
    const int t0 = tile * kSteps;
    const int steps = min(kSteps, seq_len - t0);
    if (tile + 1 < n_tiles)
      load_tile(tiles[(tile + 1) & 1], q, k, v, log_i, log_f, b, head, heads,
                seq_len, dim, col0, t0 + kSteps,
                min(kSteps, seq_len - t0 - kSteps));
    cp_commit();  // an empty group on the last tile keeps the count even
    cp_wait_all_but_newest();
    __syncthreads();
    const Tile& cur = tiles[tile & 1];
    for (int s = 0; s < steps; ++s) {
      const int t = t0 + s;
      if (kSave && t % kChunk == 0) {
        // the state before step t: this block's columns of C; the head's
        // first block n (one thread a row group) and m
        const int n_chunks = (seq_len + kChunk - 1) / kChunk;
        const long long at =
            ((long long)b * n_chunks + t / kChunk) * heads + head;
#pragma unroll
        for (int r = 0; r < R; ++r)
          c_st[(at * dim + group * R + r) * dim + col0 + col] = C[r];
        if (blockIdx.y == 0 && col == 0) {
#pragma unroll
          for (int r = 0; r < R; ++r) n_st[at * dim + group * R + r] = n[r];
        }
        if (blockIdx.y == 0 && tid == 0) m_st[at] = m;
      }
      const float li = cur.log_i[s], lf = cur.log_f[s];
      const float m_new = fmaxf(lf + m, li);
      const float ip = expf(li - m_new);
      const float fp = expf(lf + m - m_new);
      m = m_new;
      const float vc = cur.v[s][col];
      const float* kr = &cur.k[s][group * R];
      const float* qr = &cur.q[s][group * R];
      float num = 0.0f, den = 0.0f;
#pragma unroll
      for (int r = 0; r < R; r += 4) {
        const float4 k4 = *reinterpret_cast<const float4*>(kr + r);
        const float4 q4 = *reinterpret_cast<const float4*>(qr + r);
        const float kk[4] = {k4.x, k4.y, k4.z, k4.w};
        const float qq[4] = {q4.x, q4.y, q4.z, q4.w};
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const float ik = ip * kk[e];
          C[r + e] = fp * C[r + e] + ik * vc;
          n[r + e] = fp * n[r + e] + ik;
          const float qs = qq[e] * scale;
          num += C[r + e] * qs;
          den += n[r + e] * qs;
        }
      }
      // the warp's two row groups (lanes c and c + 16 share column c)
      num += __shfl_xor_sync(0xffffffffu, num, 16);
      den += __shfl_xor_sync(0xffffffffu, den, 16);
      float2 (*part)[kCols] = partial[t & 1];
      if (lane < kCols) part[warp][lane] = make_float2(num, den);
      __syncthreads();
      if (tid < kCols) {
        float nu = 0.0f, de = 0.0f;
#pragma unroll
        for (int w = 0; w < kWarps; ++w) {
          nu += part[w][tid].x;
          de += part[w][tid].y;
        }
        const long long row = ((long long)b * seq_len + t) * heads + head;
        h[row * dim + col0 + tid] = nu / fmaxf(fabsf(de), 1.0f);
      }
    }
    __syncthreads();  // the next iteration refills this buffer
  }
}

template <int R, bool kSave>
int launch(const void* q, const void* k, const void* v, const void* log_i,
           const void* log_f, void* h, void* c_st, void* n_st, void* m_st,
           int batch, int seq_len, int heads, float scale, void* stream) {
  const dim3 grid(batch * heads, (kGroups * R) / kCols);
  mlstm_scan_kernel<R, kSave><<<grid, kThreads, 0,
                                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(q), static_cast<const float*>(k),
      static_cast<const float*>(v), static_cast<const float*>(log_i),
      static_cast<const float*>(log_f), static_cast<float*>(h),
      static_cast<float*>(c_st), static_cast<float*>(n_st),
      static_cast<float*>(m_st), seq_len, heads, scale);
  return static_cast<int>(cudaGetLastError());
}

template <bool kSave>
int dispatch(const void* q, const void* k, const void* v, const void* log_i,
             const void* log_f, void* h, void* c_st, void* n_st, void* m_st,
             int batch, int seq_len, int heads, int dim, float scale,
             void* stream) {
  switch (dim) {
    case 64:
      return launch<4, kSave>(q, k, v, log_i, log_f, h, c_st, n_st, m_st,
                              batch, seq_len, heads, scale, stream);
    case 128:
      return launch<8, kSave>(q, k, v, log_i, log_f, h, c_st, n_st, m_st,
                              batch, seq_len, heads, scale, stream);
    case 256:
      return launch<16, kSave>(q, k, v, log_i, log_f, h, c_st, n_st, m_st,
                               batch, seq_len, heads, scale, stream);
    case 512:
      return launch<32, kSave>(q, k, v, log_i, log_f, h, c_st, n_st, m_st,
                               batch, seq_len, heads, scale, stream);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}

}  // namespace

// h (B, S, H, D) of the scan; D is 64, 128, 256 or 512 (any other D
// returns cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int mlstm_scan_f32(const void* q, const void* k, const void* v,
                              const void* log_i, const void* log_f, void* h,
                              int batch, int seq_len, int heads, int dim,
                              float scale, void* stream) {
  return dispatch<false>(q, k, v, log_i, log_f, h, nullptr, nullptr, nullptr,
                         batch, seq_len, heads, dim, scale, stream);
}

// The training launch: h and the state before each chunk of 64 steps,
// C (B, ceil(S / 64), H, D, D), n (B, ceil(S / 64), H, D), m (B,
// ceil(S / 64), H).
extern "C" int mlstm_scan_states_f32(const void* q, const void* k,
                                     const void* v, const void* log_i,
                                     const void* log_f, void* h, void* c_st,
                                     void* n_st, void* m_st, int batch,
                                     int seq_len, int heads, int dim,
                                     float scale, void* stream) {
  return dispatch<true>(q, k, v, log_i, log_f, h, c_st, n_st, m_st, batch,
                        seq_len, heads, dim, scale, stream);
}
