// The sLSTM scan (K10) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference runs this recurrence as a
// lax.scan of one step a token (src/repro/models/xlstm.py:141-160
// _slstm_step, under chunked_scan, :187-189), which XLA compiles into one
// loop on the TPU.  On the card a Python loop of the step costs about 20
// launches a token, ~82 k an sLSTM layer of a 4,096-token prefill, so the
// scan is a kernel of the port.
//
// From c = n = h = 0, m = -1e30, for t = 0..S-1, each (b, head) computes,
// for every output column j of the head's dh,
//
//     a_g[j] = sum_i h[i] R_g[i][j]                 (g = z, i, f, o)
//     z = tanh(zx + a_z);  i_raw = ix + a_i;  f_raw = fx + a_f
//     o = sigmoid(ox + a_o);  log_f = min(f_raw, 0) - log1p(exp(-|f_raw|))
//     m' = max(log_f + m, i_raw);  i = exp(i_raw - m');  f = exp(log_f + m - m')
//     c = f c + i z;  n = f n + i;  h[j] = o c / max(n, 1e-6)
//
//     zx, ix, fx, ox (B, S, H, dh); R_g (H, dh, dh); all f32 -> h (B, S, H, dh)
//
// The plain version is kernels/ref.py slstm_scan_ref.
//
// What bounds it on this card: at xlstm-350m's prefill (B=1, S=4,096,
// H=4, dh=256) the four recurrent products are 4.3 GFLOP (0.064 ms at
// 67 TFLOP/s) and the bytes the inputs, matrices and output (84 MB,
// 0.025 ms).  The recurrence is what holds it back: every step's products
// need the whole h of the step before, so the S steps run one after the
// other, and a head's four matrices (1 MB at dh = 256) do not fit one SM.
//
// The design: a thread-block cluster a (b, head) that holds the head's
// matrices on chip for the whole launch, and one exchange across the
// cluster a step (Plan in slstm_cluster.cuh):
// - kCluster blocks a (b, head), 8 at dh = 256 (a portable cluster), 2 at
//   128, 1 at 64 and 32; block r owns the kCols = dh / kCluster output
//   columns j in [r kCols, (r + 1) kCols) and keeps their c, n, m;
// - at the start each thread loads, once, kRows = 64 entries (dh at 32)
//   of one gate's column into registers: thread (column, gate g, chunk q)
//   holds R_g[i][j] for the rows i = 4 (kChunks s + q) + e, e < 4, so the
//   column's kChunks chunk lanes read adjacent 16 bytes of h (a warp's
//   float4 load is one shared-memory wavefront): 128 KiB of the matrices
//   a block at dh = 256 and 128, in 512 threads (126 registers, no
//   spills);
// - each step every thread multiplies its rows by the h of the step
//   before (in this block's shared memory; four accumulators), the chunk
//   lanes add their sums by shuffles in a fixed order, and the column's
//   first lane gathers the four gates' pre-activations and updates the
//   cell; kCluster of the column's lanes store h[j] into every block's h
//   buffer with st.async (distributed shared memory), each store counted
//   in that block's mbarrier of the buffer, which the block arms for the
//   4 dh bytes of each step; a block goes on when its own mbarrier
//   completes.  On the card that exchange takes a fraction of the cluster
//   barrier a step the kernel first had (barrier.cluster, which every
//   thread of the 8 blocks must reach; tools/slstm_step_parts.py times
//   both).  The two h
//   buffers alternate with the step's parity: a block stores h_t into a
//   peer's buffer only once it has all of h_{t-1}, which every block
//   sends only after it has read h_{t-2} from that buffer, so the buffer
//   is free without a second barrier; h[j] and the states go to global
//   memory after the exchange, off the step's chain;
// - nothing of R is read from global memory or L2 inside the step loop;
//   the step's zx, ix, fx, ox are staged in shared memory by cp.async,
//   kTile steps at a time (kTile kCols = 512 floats a gate), a tile ahead;
// - sums in a fixed order, no atomics: two calls give the same bits, and a
//   (b, head)'s h does not depend on B (a vmap fold is each client's call);
// - expf, tanhf, log1pf (not the fast intrinsics), and no FMA contraction
//   (-fmad=false, build.py): the cell's multiplies and adds round one by
//   one, as the plain version's elementwise ops do; the products' fmaf
//   stay fused.
//
// Training (slstm_scan_states_f32): the same kernel also writes every
// step's cell state c, n, m and the four gates' pre-activations zx + a_z,
// ix + a_i, fx + a_f, ox + a_o (each (B, S, H, dh)), on which the backward
// (slstm_scan_bwd.cu) walks without a recompute, and takes the recurrent
// matrices in G groups (G, H, dh, dh), batch row b taking group
// b / (B / G) (a vmap fold of G clients, each with its own).  The serving
// launch is the template without those stores, on one group.
#include <cuda_runtime.h>

#include "slstm_cluster.cuh"

namespace {

// The seven state outputs of a training launch (c, n, m, and the
// pre-activations of z, i, f, o), passed by value.
struct States {
  float* p[7];
};

// kSave: the training launch, which also writes the states into st.
template <int D, bool kSave>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1) slstm_scan_kernel(
    const float* __restrict__ zx, const float* __restrict__ ix,
    const float* __restrict__ fx, const float* __restrict__ ox,
    const float* __restrict__ rz, const float* __restrict__ ri,
    const float* __restrict__ rf, const float* __restrict__ ro,
    float* __restrict__ h, States st, int seq_len, int heads,
    int rows_per_group) {
  using P = Plan<D>;
  constexpr int kVec = P::kRows / 4;  // float4s of h a thread reads a step
  constexpr int kTile = P::kTile;
  __shared__ __align__(16) float hs[2][D];
  __shared__ float xs[2][4][kTile][P::kCols];  // [tile parity][gate][step][col]
  __shared__ uint64_t full[2];                 // hs[x] holds the whole h
  const int rank = block_rank<P::kCluster>();
  const int bh = blockIdx.x / P::kCluster;
  const int b = bh / heads, head = bh % heads;
  const int tid = threadIdx.x, lane = tid & 31;
  const int col = tid / P::kLanes, sub = tid % P::kLanes;
  const int g = sub & 3, q = sub >> 2;
  const int j = rank * P::kCols + col;
  const int first = lane - sub;  // the column's first lane
  const bool cell = sub == 0;

  // the block's slice of the matrices, once: R_g[i][j] of this thread's
  // rows, r[4 s + e] at i = 4 (kChunks s + q) + e
  const float* mat = g == 0 ? rz : g == 1 ? ri : g == 2 ? rf : ro;
  const float* rc =
      mat + ((long long)(b / rows_per_group) * heads + head) * D * D + j;
  float r[P::kRows];
#pragma unroll
  for (int s = 0; s < kVec; ++s)
#pragma unroll
    for (int e = 0; e < 4; ++e)
      r[4 * s + e] = rc[(long long)(4 * (P::kChunks * s + q) + e) * D];

  const long long stride = (long long)heads * D;
  // step 0 of the block's first column
  const long long blk0 =
      ((long long)b * seq_len * heads + head) * D + rank * P::kCols;
  // tile k's inputs (steps k kTile ..) into xs[k & 1], one group
  auto stage = [&](int k) {
    const int t0 = k * kTile;
    for (int e = tid; e < 4 * kTile * P::kCols; e += P::kThreads) {
      const int a = e / (kTile * P::kCols), tt = e / P::kCols % kTile,
                c = e % P::kCols;
      const float* src = a == 0 ? zx : a == 1 ? ix : a == 2 ? fx : ox;
      if (t0 + tt < seq_len)
        cp_async4(&xs[k & 1][a][tt][c], src + blk0 + (t0 + tt) * stride + c);
    }
    cp_commit();
  };

  for (int e = tid; e < D; e += P::kThreads) hs[0][e] = 0.0f;
  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  stage(0);
  stage(1);
  cp_wait<1>();
  // every block of the cluster running, its barriers set, h_{-1} zero,
  // tile 0 in
  cluster_barrier<P::kCluster>();

  float c = 0.0f, n = 0.0f, m = -1e30f;
  const long long col0 = blk0 + col;
  for (int t = 0; t < seq_len; ++t) {
    const int tt = t % kTile, buf = (t / kTile) & 1;
    if (tt == 0 && t > 0) {  // tile t / kTile in, the one before read
      cp_wait<0>();
      __syncthreads();
      stage(t / kTile + 1);
    }
    const float x = xs[buf][g][tt][col];  // this lane's gate's input
    // h_{t-1}, the (t-1)/2-th that hs[t & 1] takes
    if (t > 0) mbar_wait(&full[t & 1], ((t - 1) >> 1) & 1);
    if (tid == 0 && t + 1 < seq_len) mbar_expect(&full[(t + 1) & 1], 4 * D);
    const float4* h4 = reinterpret_cast<const float4*>(hs[t & 1]);
    float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
    for (int s = 0; s < kVec; ++s) {
      const float4 hv = h4[P::kChunks * s + q];
      a0 = fmaf(hv.x, r[4 * s], a0);
      a1 = fmaf(hv.y, r[4 * s + 1], a1);
      a2 = fmaf(hv.z, r[4 * s + 2], a2);
      a3 = fmaf(hv.w, r[4 * s + 3], a3);
    }
    // the chunks' sums, alike in every chunk lane (x + y == y + x), and
    // gate g's pre-activation; the column's first lane gathers the four
    float a = (a0 + a1) + (a2 + a3);
#pragma unroll
    for (int o = 4; o < P::kLanes; o *= 2) a += __shfl_xor_sync(~0u, a, o);
    const float pz = x + a;  // of gate g: z in the first lane
    const float i_raw = __shfl_sync(~0u, pz, first + 1);
    const float f_raw = __shfl_sync(~0u, pz, first + 2);
    const float po = __shfl_sync(~0u, pz, first + 3);
    float hv = 0.0f;
    if (cell) {
      const float z = tanhf(pz);
      const float o_t = 1.0f / (1.0f + expf(-po));
      const float log_f = fminf(f_raw, 0.0f) - log1pf(expf(-fabsf(f_raw)));
      const float m_new = fmaxf(log_f + m, i_raw);
      const float ip = expf(i_raw - m_new);
      const float fp = expf(log_f + m - m_new);
      m = m_new;
      c = fp * c + ip * z;
      n = fp * n + ip;
      hv = o_t * c / fmaxf(n, 1e-6f);
    }
    if (t + 1 < seq_len) {
      hv = __shfl_sync(~0u, hv, first);
      if (sub < P::kCluster)
        st_async(&hs[(t + 1) & 1][j], hv, &full[(t + 1) & 1], sub);
    }
    if (cell) {  // off the step's chain: after the exchange
      const long long at = col0 + t * stride;
      h[at] = hv;
      if (kSave) {
        st.p[0][at] = c;
        st.p[1][at] = n;
        st.p[2][at] = m;
        st.p[3][at] = pz;
        st.p[4][at] = i_raw;
        st.p[5][at] = f_raw;
        st.p[6][at] = po;
      }
    }
  }
  cp_wait<0>();
  cluster_barrier<P::kCluster>();  // no block leaves while stores fly
}

template <int D, bool kSave>
int launch_dim(const void* zx, const void* ix, const void* fx,
               const void* ox, const void* rz, const void* ri, const void* rf,
               const void* ro, void* h, States st, int batch, int seq_len,
               int heads, int rows_per_group, void* stream) {
  static int resident = -1;
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  return launch_clusters<D>(
      slstm_scan_kernel<D, kSave>, &resident, batch * heads, stream, f(zx),
      f(ix), f(fx), f(ox), f(rz), f(ri), f(rf), f(ro),
      static_cast<float*>(h), st, seq_len, heads, rows_per_group);
}

// The launch of head dim ``dim`` with the plan (cluster, cols, threads,
// tile) the wrapper passes: cudaErrorInvalidValue for another dim, a plan
// other than the kernel's, or a batch the groups do not divide.
template <bool kSave>
int launch(const void* zx, const void* ix, const void* fx, const void* ox,
           const void* rz, const void* ri, const void* rf, const void* ro,
           void* h, States st, int batch, int seq_len, int heads, int dim,
           int groups, int cluster, int cols, int threads, int tile,
           void* stream) {
  if (groups < 1 || batch % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpg = batch / groups;
#define SLSTM_DIM(DIM)                                                    \
  case DIM:                                                               \
    if (!plan_matches<DIM>(cluster, cols, threads, tile)) break;          \
    return launch_dim<DIM, kSave>(zx, ix, fx, ox, rz, ri, rf, ro, h, st,  \
                                  batch, seq_len, heads, rpg, stream);
  switch (dim) {
    SLSTM_DIM(32)
    SLSTM_DIM(64)
    SLSTM_DIM(128)
    SLSTM_DIM(256)
  }
#undef SLSTM_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}

}  // namespace

// h (B, S, H, dh) of the scan; dh 32, 64, 128 or 256 with its plan
// (cluster, cols, threads, tile; any other returns cudaErrorInvalidValue,
// the wrapper refuses the dim first).
extern "C" int slstm_scan_f32(const void* zx, const void* ix, const void* fx,
                              const void* ox, const void* rz, const void* ri,
                              const void* rf, const void* ro, void* h,
                              int batch, int seq_len, int heads, int dim,
                              int cluster, int cols, int threads, int tile,
                              void* stream) {
  return launch<false>(zx, ix, fx, ox, rz, ri, rf, ro, h, States{}, batch,
                       seq_len, heads, dim, 1, cluster, cols, threads, tile,
                       stream);
}

// The training launch: h and every step's c, n, m, zx + a_z, ix + a_i,
// fx + a_f, ox + a_o (each (B, S, H, dh)); the r's in ``groups`` groups
// (G, H, dh, dh), batch row b taking group b / (B / G).
extern "C" int slstm_scan_states_f32(
    const void* zx, const void* ix, const void* fx, const void* ox,
    const void* rz, const void* ri, const void* rf, const void* ro, void* h,
    void* c, void* n, void* m, void* pz, void* pi, void* pf, void* po,
    int batch, int seq_len, int heads, int dim, int groups, int cluster,
    int cols, int threads, int tile, void* stream) {
  const States st{{static_cast<float*>(c), static_cast<float*>(n),
                   static_cast<float*>(m), static_cast<float*>(pz),
                   static_cast<float*>(pi), static_cast<float*>(pf),
                   static_cast<float*>(po)}};
  return launch<true>(zx, ix, fx, ox, rz, ri, rf, ro, h, st, batch, seq_len,
                      heads, dim, groups, cluster, cols, threads, tile,
                      stream);
}

// How many clusters of the launch of head dim ``dim`` (the training
// launch where ``save``) can be resident on the card at once, into
// *count (cudaOccupancyMaxActiveClusters); the CUDA error code.
extern "C" int slstm_scan_resident_clusters(int dim, int save, void* count) {
  int* out = static_cast<int*>(count);
#define SLSTM_DIM(DIM)                                             \
  case DIM:                                                        \
    return resident_clusters<DIM>(                                 \
        save ? (const void*)slstm_scan_kernel<DIM, true>           \
             : (const void*)slstm_scan_kernel<DIM, false>, out);
  switch (dim) {
    SLSTM_DIM(32)
    SLSTM_DIM(64)
    SLSTM_DIM(128)
    SLSTM_DIM(256)
  }
#undef SLSTM_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}
