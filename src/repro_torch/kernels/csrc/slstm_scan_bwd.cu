// The sLSTM scan's backward (K10-bwd) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its lax.scan of
// _slstm_step (src/repro/models/xlstm.py:141-160) under chunked_scan
// (:187-189, src/repro/models/ssm.py:26-41).  The state of a step is
// small (c, n, m of dh floats a head), so the forward (slstm_scan.cu,
// slstm_scan_states_f32) keeps every step's c, n, m and the four gates'
// pre-activations, and this kernel walks t = S-1 .. 0 on them without a
// recompute, which would repeat the four recurrent products.  With z =
// tanh(pz), o = sigmoid(po), log_f = logsigmoid(pf), the gates i =
// exp(pi - m_t), f = exp(log_f + m_{t-1} - m_t), N = max(n_t, 1e-6), and
// dc, dn, dm and the recurrent cotangent g_h from 0, each step:
//
//     g   = dh_t + g_h;   do = g c_t / N
//     dc += g o / N;      dn += -g h_t / N [n_t vs 1e-6]
//     df  = dc c_{t-1} + dn n_{t-1};  di = dc z + dn;  dz = dc i
//     dc *= f;  dn *= f
//     dm' = dm - di i - df f
//     dpi = di i + dm' [pi vs log_f + m];  dm = df f + dm' [log_f + m vs pi]
//     dpf = dm sigmoid(-pf);  dpz = dz (1 - z^2);  dpo = do o (1 - o)
//     g_h[i] = sum_g sum_k r_g[i][k] d_g[k]      (d_g = dpz, dpi, dpf, dpo)
//
// where [a vs b] is 1 if a > b, 0.5 at a tie and 0 else (the split of
// jnp.maximum's gradient), h_t = o c_t / N as the forward computes it.
// The inputs zx, ix, fx, ox enter the pre-activations additively, so
// d_g is their gradient; the recurrent matrices' gradients, sums over
// (b, t) of h_{t-1} (x) d_g, are one product a gate over the saved h after
// this walk (kernels/xlstm_scan.py).  The plain version is kernels/ref.py
// slstm_scan_bwd_ref.
//
// The design is the forward's cluster (Plan in slstm_cluster.cuh):
// - kCluster blocks a (b, head); block r owns the kCols rows i in
//   [r kCols, (r + 1) kCols) of g_h and the same columns' dc, dn, dm, so
//   the g_h it computes is the one its own cells need at the next step;
// - at the start each thread loads, once, kRows entries of the four
//   matrices r_g themselves (no transposed copy) into registers: lane l
//   of warp w holds row i = (w mod G) 32 + l (G = kCols / 32 warps cover
//   the rows) at the kK = kRows / 4 k's of its warp's range, w / G, of
//   the kThreads / kCols ranges, for the four gates;
// - each step every thread multiplies its entries by the four d_g[k] of
//   the step after (a float4 (d_z, d_i, d_f, d_o) a k in this block's
//   shared memory, the same float4s for every lane of a warp: one
//   wavefront each) and writes its sum to shared memory; after one block
//   barrier thread col < kCols adds the ranges' sums of row col in a
//   fixed order, walks column col's cell back, stores the float4 of d_g
//   into every block's buffer with st.async, counted in that block's
//   mbarrier (as the forward exchanges h), and writes its four gradients;
// - what a step's saved values alone give (z, o, the gates i and f, the
//   clamps' shares and sigmoid(-pf): the exact transcendentals) three
//   other warp groups compute a step ahead, while the cells walk, into
//   shared memory, so the chain from g_h to d_g is a few flops and three
//   divisions;
// - nothing of r is read from global memory or L2 inside the step loop;
//   the saved states, pre-activations and dh_t are staged in shared memory
//   by cp.async, kTile steps at a time (c, n, m with the step before the
//   tile), a tile ahead;
// - sums in a fixed order, no atomics: two calls give the same bits;
// - the groups of r: batch row b takes group b / (B / G), as the forward;
// - expf, tanhf, log1pf and no FMA contraction, as the forward.
//
// What bounds it on this card: at xlstm-350m's B=1, S=4,096, H=4, dh=256
// the four products a step are 4.3 GFLOP (0.064 ms at 67 TFLOP/s) and the
// bytes the saved states, inputs and outputs (12 x 16.8 MB, 0.06 ms); the
// chain of 4,096 dependent steps, each a cluster exchange, is what holds
// it back, as in the forward.
#include <cuda_runtime.h>

#include "slstm_cluster.cuh"

namespace {

// The saved arrays a step reads, in their order in the staged tile: c, n,
// m (slots 0 .. kTile: the step before the tile, then its steps), then
// pz, pi, pf, po and dh (slots 1 .. kTile).
constexpr int kArrays = 8;

template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1) slstm_bwd_kernel(
    const float* __restrict__ rz, const float* __restrict__ ri,
    const float* __restrict__ rf, const float* __restrict__ ro,
    const float* __restrict__ c_s, const float* __restrict__ n_s,
    const float* __restrict__ m_s, const float* __restrict__ pz_s,
    const float* __restrict__ pi_s, const float* __restrict__ pf_s,
    const float* __restrict__ po_s, const float* __restrict__ dy,
    float* __restrict__ dz_o, float* __restrict__ di_o,
    float* __restrict__ df_o, float* __restrict__ do_o, int seq_len,
    int heads, int rows_per_group) {
  using P = Plan<D>;
  constexpr int kTile = P::kTile;
  constexpr int kGroups = P::kCols / 32;  // warps that cover the rows once
  constexpr int kSplits = P::kThreads / P::kCols;  // ranges of k
  constexpr int kK = D / kSplits;  // k's a thread, each with 4 gates
  static_assert(P::kCols % 32 == 0 && 4 * kK == P::kRows && kSplits % 4 == 0,
                "a lane a row, kRows entries a thread, 4 warp groups");
  __shared__ __align__(16) float4 ds[2][D];  // (d_z, d_i, d_f, d_o)[k]
  __shared__ float ts[2][kArrays][kTile + 1][P::kCols];
  __shared__ float part[kSplits][P::kCols];  // the ranges' sums of g_h
  // what a step's saved values alone give, by the step's parity:
  // z, o, i, f, max(n, 1e-6), [n vs 1e-6], h, [log_f + m vs pi], sigmoid(-pf)
  __shared__ float pre[2][9][P::kCols];
  __shared__ uint64_t full[2];  // ds[x] holds every k
  const int rank = block_rank<P::kCluster>();
  const int bh = blockIdx.x / P::kCluster;
  const int b = bh / heads, head = bh % heads;
  const int tid = threadIdx.x, warp = tid / 32;
  const int col = warp % kGroups * 32 + (tid & 31);  // the block's row
  const int split = warp / kGroups;
  const int i = rank * P::kCols + col;  // the row of g_h and the cell's column
  // thread col: column col's cell; threads a kCols + col, a = 1, 2, 3:
  // what the saved values of its step before alone give
  const bool cell = tid < P::kCols;
  const int ahead = tid / P::kCols < 4 ? tid / P::kCols : 0;

  // the block's rows of the four matrices, once: r[4 s + g] = r_g[i][k]
  // at k = split kK + s
  const long long row =
      (((long long)(b / rows_per_group) * heads + head) * D + i) * D +
      split * kK;
  float r[P::kRows];
#pragma unroll
  for (int s = 0; s < kK; ++s) {
    r[4 * s] = rz[row + s];
    r[4 * s + 1] = ri[row + s];
    r[4 * s + 2] = rf[row + s];
    r[4 * s + 3] = ro[row + s];
  }

  const long long stride = (long long)heads * D;
  const long long blk0 =
      ((long long)b * seq_len * heads + head) * D + rank * P::kCols;
  // tile k's saved arrays into ts[k & 1] (none for k < 0), one group
  auto stage = [&](int k) {
    if (k >= 0) {
      const int t0 = k * kTile - 1;  // the step of slot 0
      for (int e = tid; e < kArrays * (kTile + 1) * P::kCols;
           e += P::kThreads) {
        const int a = e / ((kTile + 1) * P::kCols),
                  sl = e / P::kCols % (kTile + 1), c = e % P::kCols;
        const int t = t0 + sl;
        const float* src = a == 0   ? c_s
                           : a == 1 ? n_s
                           : a == 2 ? m_s
                           : a == 3 ? pz_s
                           : a == 4 ? pi_s
                           : a == 5 ? pf_s
                           : a == 6 ? po_s
                                    : dy;
        if (t >= 0 && t < seq_len && (a < 3 || sl > 0))
          cp_async4(&ts[k & 1][a][sl][c], src + blk0 + t * stride + c);
      }
    }
    cp_commit();
  };

  if (tid == 0) {
    mbar_init(&full[0]);
    mbar_init(&full[1]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  const int last = (seq_len - 1) / kTile;
  stage(last);
  stage(last - 1);
  cp_wait<1>();
  // every block of the cluster running, its barriers set, the last tile in
  cluster_barrier<P::kCluster>();

  // step u's saved values into what they alone give, for u's cell; the
  // three warp groups after the cells' each take a third
  auto prepare = [&](int u) {
    const float(*tile)[kTile + 1][P::kCols] = ts[(u / kTile) & 1];
    const int sl = u % kTile + 1;
    float(*out)[P::kCols] = pre[u & 1];
    if (ahead == 1) {
      const float c = tile[0][sl][col], n = tile[1][sl][col];
      const float o = 1.0f / (1.0f + expf(-tile[6][sl][col]));
      const float N = fmaxf(n, 1e-6f);
      out[0][col] = tanhf(tile[3][sl][col]);
      out[1][col] = o;
      out[4][col] = N;
      out[5][col] = n > 1e-6f ? 1.0f : (n == 1e-6f ? 0.5f : 0.0f);
      out[6][col] = o * c / N;
    } else if (ahead == 2) {
      const float m = tile[2][sl][col], pi = tile[4][sl][col],
                  pf = tile[5][sl][col];
      const float m_before = u > 0 ? tile[2][sl - 1][col] : -1e30f;
      const float log_f = fminf(pf, 0.0f) - log1pf(expf(-fabsf(pf)));
      const float a = log_f + m_before;
      out[2][col] = expf(pi - m);
      out[3][col] = expf(log_f + m_before - m);
      out[7][col] = a > pi ? 1.0f : (a == pi ? 0.5f : 0.0f);
    } else {
      out[8][col] = 1.0f / (1.0f + expf(tile[5][sl][col]));
    }
  };
  if (ahead) prepare(seq_len - 1);

  float dc = 0.0f, dn = 0.0f, dm = 0.0f;
  const long long col0 = blk0 + col;
  for (int t = seq_len - 1; t >= 0; --t) {
    const int tt = t % kTile, k = t / kTile;
    if (tid == 0 && t > 0) mbar_expect(&full[t & 1], 16 * D);
    if (t < seq_len - 1) {
      // d_{t+1}, the (S-2-t)/2-th that ds[(t + 1) & 1] takes; every lane
      // of a warp reads the same float4s
      mbar_wait(&full[(t + 1) & 1], ((seq_len - 2 - t) >> 1) & 1);
      const float4* d4 = ds[(t + 1) & 1] + split * kK;
      float a0 = 0.0f, a1 = 0.0f, a2 = 0.0f, a3 = 0.0f;
#pragma unroll
      for (int s = 0; s < kK; ++s) {
        const float4 d = d4[s];
        a0 = fmaf(r[4 * s], d.x, a0);
        a1 = fmaf(r[4 * s + 1], d.y, a1);
        a2 = fmaf(r[4 * s + 2], d.z, a2);
        a3 = fmaf(r[4 * s + 3], d.w, a3);
      }
      part[split][col] = (a0 + a1) + (a2 + a3);
    }
    if (tt == 0 && t > 0) cp_wait<0>();  // tile k - 1, for prepare(t - 1)
    __syncthreads();
    // tile k - 1 into the buffer of tile k + 1, read by now
    if (tt == kTile - 1 && t < seq_len - 1) stage(k - 1);
    if (cell) {  // the ranges' sums in a fixed order, the chain through g_h
      float g0 = 0.0f, g1 = 0.0f;
      if (t < seq_len - 1) {
#pragma unroll
        for (int sp = 0; sp < kSplits; sp += 2) {
          g0 += part[sp][col];
          g1 += part[sp + 1][col];
        }
      }
      const float(*tile)[kTile + 1][P::kCols] = ts[k & 1];
      const float(*now)[P::kCols] = pre[t & 1];
      const int sl = tt + 1;
      const float c_now = tile[0][sl][col];
      const float c_before = t > 0 ? tile[0][sl - 1][col] : 0.0f;
      const float n_before = t > 0 ? tile[1][sl - 1][col] : 0.0f;
      const float z = now[0][col], o = now[1][col], ip = now[2][col],
                  fp = now[3][col], N = now[4][col], share_n = now[5][col],
                  ht = now[6][col], share = now[7][col], sig = now[8][col];
      const float gt = tile[7][sl][col] + (g0 + g1);
      const float d_o = gt * c_now / N;
      dc = dc + gt * o / N;
      dn = dn - gt * ht / N * share_n;
      const float df = dc * c_before + dn * n_before;
      const float di = dc * z + dn;
      const float dz = dc * ip;
      dc *= fp;
      dn *= fp;
      const float dm_new = dm - di * ip - df * fp;
      const float dpi = di * ip + dm_new * (1.0f - share);
      dm = df * fp + dm_new * share;
      const float4 d = make_float4(dz * (1.0f - z * z), dpi, dm * sig,
                                   d_o * o * (1.0f - o));
      if (t > 0)
        for (int q = 0; q < P::kCluster; ++q)
          st_async(&ds[t & 1][i], d, &full[t & 1], q);
      // off the step's chain: after the exchange
      const long long at = col0 + t * stride;
      dz_o[at] = d.x;
      di_o[at] = d.y;
      df_o[at] = d.z;
      do_o[at] = d.w;
    } else if (ahead && t > 0) {
      prepare(t - 1);  // while the cells walk step t
    }
  }
  cp_wait<0>();
  cluster_barrier<P::kCluster>();  // no block leaves while stores fly
}

template <int D>
int launch_dim(const float* const* in, float* const* out, int batch,
               int seq_len, int heads, int rows_per_group, void* stream) {
  static int resident = -1;
  return launch_clusters<D>(slstm_bwd_kernel<D>, &resident, batch * heads,
                            stream, in[0], in[1], in[2], in[3], in[4], in[5],
                            in[6], in[7], in[8], in[9], in[10], in[11],
                            out[0], out[1], out[2], out[3], seq_len, heads,
                            rows_per_group);
}

// The walk of head dim ``dim`` with the plan (cluster, cols, threads,
// tile) the wrapper passes: cudaErrorInvalidValue for another dim, a plan
// other than the kernel's, or a batch the groups do not divide.
int launch(const float* const* in, float* const* out, int batch,
           int seq_len, int heads, int dim, int groups, int cluster,
           int cols, int threads, int tile, void* stream) {
  if (groups < 1 || batch % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int rpg = batch / groups;
#define SLSTM_DIM(DIM)                                           \
  case DIM:                                                      \
    if (!plan_matches<DIM>(cluster, cols, threads, tile)) break; \
    return launch_dim<DIM>(in, out, batch, seq_len, heads, rpg, stream);
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

// d(zx, ix, fx, ox) (each (B, S, H, dh)) of the scan under dh, from the
// forward's states; the recurrent matrices r_z, r_i, r_f, r_o as the
// forward takes them, (G, H, dh, dh), batch row b taking group b / (B /
// G); dh 32, 64, 128 or 256 with its plan (cluster, cols, threads, tile;
// any other returns cudaErrorInvalidValue, the wrapper refuses the dim
// first).
extern "C" int slstm_scan_bwd_f32(
    const void* rz, const void* ri, const void* rf, const void* ro,
    const void* c, const void* n, const void* m, const void* pz,
    const void* pi, const void* pf, const void* po, const void* dh,
    void* dzx, void* dix, void* dfx, void* dox, int batch, int seq_len,
    int heads, int dim, int groups, int cluster, int cols, int threads,
    int tile, void* stream) {
  const float* in[12];
  const void* src[12] = {rz, ri, rf, ro, c, n, m, pz, pi, pf, po, dh};
  for (int e = 0; e < 12; ++e) in[e] = static_cast<const float*>(src[e]);
  float* const out[4] = {static_cast<float*>(dzx), static_cast<float*>(dix),
                         static_cast<float*>(dfx), static_cast<float*>(dox)};
  return launch(in, out, batch, seq_len, heads, dim, groups, cluster, cols,
                threads, tile, stream);
}

// How many clusters of the walk of head dim ``dim`` can be resident on
// the card at once, into *count (cudaOccupancyMaxActiveClusters); the
// CUDA error code.
extern "C" int slstm_scan_bwd_resident_clusters(int dim, void* count) {
  int* out = static_cast<int*>(count);
#define SLSTM_DIM(DIM) \
  case DIM:            \
    return resident_clusters<DIM>((const void*)slstm_bwd_kernel<DIM>, out);
  switch (dim) {
    SLSTM_DIM(32)
    SLSTM_DIM(64)
    SLSTM_DIM(128)
    SLSTM_DIM(256)
  }
#undef SLSTM_DIM
  return static_cast<int>(cudaErrorInvalidValue);
}
