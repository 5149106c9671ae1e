// The mLSTM scan's backward (K9-bwd) for Hopper (sm_90a).
//
// Replaces no TPU kernel: the reference differentiates its lax.scan of
// _mlstm_step (src/repro/models/xlstm.py:52-68) under chunked_scan
// (src/repro/models/ssm.py:26-41), whose chunks of 64 steps are under
// jax.checkpoint, so BPTT keeps only the chunk-boundary states.  Here the
// forward (mlstm_scan.cu, mlstm_scan_states_f32) saves those states, C
// (B, ceil(S / 64), H, D, D), n and m, and this kernel recomputes each
// chunk's states from them and walks the chunk back, chunks last to
// first.  With s = D^-1/2, den = n_t . q s, Dn = max(|den|, 1), the gates
// i, f of the step, and dC, dn, dm from 0, each step (t = S-1 .. 0):
//
//     dden = -(dh . h_t) / Dn [|den| vs 1] sign(den);  dnum = dh / Dn
//     dC  += (q s) (x) dnum;  dn += q s dden
//     dq   = s (C_t dnum + n_t dden)
//     u    = dC v + dn;  dk = i u;  di = k . u;  dv = i dC^T k
//     df   = sum(dC * C_{t-1}) + dn . n_{t-1};  dC *= f;  dn *= f
//     dm'  = dm - di i - df f
//     dlog_i = di i + dm' [log_i vs log_f + m];  dlog_f = df f + dm' [log_f + m vs log_i];  dm = dlog_f
//
// where [a vs b] is 1 if a > b, 0.5 at a tie and 0 else (the split of
// jnp.maximum's gradient).  The plain version is kernels/ref.py
// mlstm_scan_bwd_ref.
//
// What bounds it on this card: at xlstm-350m's B=1, S=4,096, H=4, D=512
// the gradient reads q, k, v, h, dh and the gates and writes dq, dk, dv
// (8 x 33.6 MB) plus the saved states (0.27 GB at 64 chunks), ~0.16 ms at
// 3.35 TB/s; the function needs 14 flops an element of C a step (the
// recurrence recomputed once, 3, and the walk's five products with dC,
// 11), 60 GFLOP, 0.90 ms at 67 TFLOP/s.  This design recomputes the
// recurrence twice (below), 17 flops, its own overhead beyond the bound.
//
// The design (kernels/xlstm_scan.py mlstm_plan mirrors Plan):
// - a prologue launch (mlstm_bwd_prep), a block a (b, chunk, head), walks
//   the chunk's gates from its saved m (i, f and the tie shares of every
//   step), its n from the saved n (den = n_t . q s of every step), and
//   dh . h_t of every step;
// - the walk (mlstm_bwd_walk) takes a block a (b, head) and kCols = 8
//   columns of C, all D rows: a thread owns kRho rows (2 at D = 512, else
//   1) of the block's 8 columns, so the sums over the columns (dq's
//   C_t dnum, u's dC v) are a thread's own and those over the rows (dv,
//   df) a reduce-scatter over the warp and the warps' partials;
// - a chunk's 64 states of C do not fit on chip (16 KB a block a state at
//   D = 512), so the walk recomputes them in sub-chunks of kSub = 4096 /
//   D steps (8 at D = 512, 64 at D = 64), whose states fill 128 KB of the
//   block's shared memory: one forward pass over the chunk from its saved
//   state keeps the start of each sub-chunk (6 of the 8 at D = 512: the
//   first is the saved state, reread; the last is where the pass ends)
//   in a thread's local memory (a 432-byte stack frame, 6/64 of the
//   chunk's state, ~110 KB a block: more than L1 has beside the shared
//   memory, so served from L2); then, sub-chunks last to first, the
//   block recomputes the sub-chunk's states into shared memory (each
//   thread its own slots: no barrier) and walks it back, C_t in
//   registers and C_{t-1} read from shared memory.  The sub-chunks'
//   states never leave shared memory; the recurrence is never inverted
//   (f can be 0).  k and q come into
//   registers a group of kG = 8 steps ahead of their use;
// - dq, dk and di (sums over all the columns) and df (over all of C)
//   cross the column blocks: a thread-block cluster of kCluster = 2
//   column blocks (66 of them fill the card's 132 SMs) takes them in
//   turn.  Each thread
//   sends its rows' (w, u) partials of a step to the cluster block whose
//   rank owns those rows, and each warp its df to rank 0, by st.async into
//   that block's shared memory, counted into its mbarrier; after the next
//   sub-chunk's recompute each block adds what it received, the senders
//   in rank order, into device memory, and a closing launch
//   (mlstm_bwd_reduce) adds the clusters' sums in order.  The head's first
//   block adds n's terms.  Two buffers of a sub-chunk's sums, and a
//   relaxed cluster barrier a sub-chunk that only orders a buffer's reuse
//   (barrier.cluster.arrive.release would fence every global store).  A
//   second closing launch walks the scalar chain of m, a warp a (b,
//   head).  No atomics: the same inputs give the same bits;
// - the elementwise recurrence rounds one operation at a time as the
//   plain version does (C = f C + (i k) v, dC + (q s) dnum, f dC, and
//   the same for n), so the recomputed states are the forward's bits;
//   the sums keep their FMAs; expf (not __expf), as the forward.
//
// Bytes at xlstm-350m's (x1): the inputs and outputs above, 0.27 GB of
// saved states read once, and the clusters' partial sums of dq and dk,
// 2 x 1.07 GB (32 clusters a head), written and read once.  What bounds
// it: one 256-thread block an SM (its 223 KB of shared memory), whose 8
// warps cannot hide the latency of a step's loads and shuffles.
#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kChunk = 64;
constexpr int kCols = 8;
// Column blocks of a cluster (tools/mlstm_scan_parts.py builds others).
constexpr int kCluster = 2;
// Steps of k and q loaded together, a group ahead of their use; a
// group's df partials are one reduce-scatter of 8 values.
constexpr int kG = 8;
constexpr unsigned kFull = 0xffffffffu;

// The walk's plan for head dim D: kRho rows a thread, kThreads threads,
// sub-chunks of kSub steps (kSub x D x kCols floats of states = 128 KB),
// and the dynamic shared memory it takes (kFloats floats).
template <int D>
struct Plan {
  static constexpr int kRho = D >= 512 ? 2 : 1;
  static constexpr int kThreads = D / kRho;
  static constexpr int kWarps = kThreads / 32;
  static constexpr int kSub = 4096 / D;
  static constexpr int kSubs = kChunk / kSub;
  static constexpr int kBlocks = D / kCols;  // column blocks a head
  static constexpr int kQ = kRho * kCols / 4;  // float4s of a thread's slot
  // states, n's states, two buffers each of the w and u rows received
  // from the cluster, of dv's warp partials and of i; the chunk's v and
  // dnum columns, and its i, f, dden and Dn; and two buffers of the df
  // warp partials received from the cluster
  static constexpr int kBytes =
      4 * (kSub * D * kCols + kSub * D + 2 * kSub * 2 * D
           + 2 * kSub * kWarps * kCols + 2 * kSub + 2 * kChunk * kCols
           + 4 * kChunk + 2 * kSub * kCluster * kWarps);
  static_assert(kThreads % 32 == 0, "whole warps");
  static_assert(kBlocks % kCluster == 0 && (D / kCluster) % 4 == 0,
                "whole clusters, whole float4s of rows a rank");
};

__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(kFull, x, o);
  return x;
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

// The cluster barrier, for execution order alone: a block's arrival after
// it has read a buffer, and the senders' wait before they write it again
// (the data itself crosses by st.async, counted in mbarriers).
__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;\n" ::: "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_u32(bar)),
               "r"(count)
               : "memory");
}

// This thread's arrival at ``bar``'s current phase (its shared-memory
// stores released to the block), with ``bytes`` more expected by st.async
// when ``bytes`` > 0.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar, unsigned bytes) {
  if (bytes)
    asm volatile(
        "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
            smem_u32(bar)),
        "r"(bytes)
        : "memory");
  else
    asm volatile("mbarrier.arrive.shared::cta.b64 _, [%0];\n" ::"r"(
                     smem_u32(bar))
                 : "memory");
}

// Wait until ``bar``'s phase of parity ``parity`` has completed; what the
// cluster stored into this block before it completed is seen after.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  const unsigned addr = smem_u32(bar);
  unsigned done;
  do {
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], "
        "%2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(addr), "r"(parity)
        : "memory");
  } while (!done);
}

__device__ __forceinline__ unsigned mapa(const void* p, int rank) {
  unsigned a;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(a)
               : "r"(smem_u32(p)), "r"(rank));
  return a;
}

// ``*dst`` of the cluster's block ``rank`` = the R values x (and y), each
// pair (x[i], y[i]) side by side, counted in that block's ``*bar`` (dst
// and bar: this block's addresses of the same variables).
template <int R>
__device__ __forceinline__ void st_async_pairs(float* dst, const float* x,
                                               const float* y,
                                               uint64_t* bar, int rank) {
  const unsigned d = mapa(dst, rank), b = mapa(bar, rank);
  if constexpr (R == 2)
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 "
        "[%0], {%1, %2, %3, %4}, [%5];\n" ::"r"(d),
        "f"(x[0]), "f"(y[0]), "f"(x[1]), "f"(y[1]), "r"(b)
        : "memory");
  else
    asm volatile(
        "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 "
        "[%0], {%1, %2}, [%3];\n" ::"r"(d),
        "f"(x[0]), "f"(y[0]), "r"(b)
        : "memory");
}

__device__ __forceinline__ void st_async(float* dst, float x, uint64_t* bar,
                                         int rank) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(mapa(dst, rank)),
      "r"(__float_as_uint(x)), "r"(mapa(bar, rank))
      : "memory");
}

// kRho consecutive floats at p (8-byte aligned for kRho = 2).
template <int R>
__device__ __forceinline__ void load_rows(float (&x)[R], const float* p) {
  if constexpr (R == 2) {
    const float2 y = *reinterpret_cast<const float2*>(p);
    x[0] = y.x;
    x[1] = y.y;
  } else {
    x[0] = *p;
  }
}

// The prologue: block (b * heads + head, chunk), 256 threads.  The
// gates' scalar recurrence from the saved m (one thread; the exps a
// step a thread), n's from the saved n with den = n_t . q s a step, and
// dh . h_t a step (a warp a row).
template <int D>
__global__ void __launch_bounds__(256) mlstm_bwd_prep(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ log_i, const float* __restrict__ log_f,
    const float* __restrict__ h, const float* __restrict__ dh,
    const float* __restrict__ n_st, const float* __restrict__ m_st,
    float* __restrict__ ipg, float* __restrict__ fpg,
    float* __restrict__ sag, float* __restrict__ deng,
    float* __restrict__ hdg, int seq_len, int heads, float scale) {
  constexpr int kRows = D >= 256 ? D / 256 : 1;  // n's rows a thread
  constexpr int kUnroll = 8;
  __shared__ float li_s[kChunk], lf_s[kChunk], a_s[kChunk], mn_s[kChunk];
  __shared__ float ip_s[kChunk], fp_s[kChunk], red_s[kChunk][8];
  const int bh = blockIdx.x, c = blockIdx.y;
  const int b = bh / heads, head = bh % heads;
  const int t0 = c * kChunk, steps = min(kChunk, seq_len - t0);
  const int n_chunks = gridDim.y;
  const int j = threadIdx.x, lane = j % 32, warp = j / 32;
  const long long at = ((long long)b * n_chunks + c) * heads + head;
  auto in_row = [&](int t) {
    return ((long long)b * seq_len + t) * heads + head;
  };
  if (j < steps) {
    li_s[j] = log_i[in_row(t0 + j)];
    lf_s[j] = log_f[in_row(t0 + j)];
  }
  __syncthreads();
  if (j == 0) {
    float m = m_st[at];
    for (int s = 0; s < steps; ++s) {
      const float a = lf_s[s] + m;
      a_s[s] = a;
      m = mn_s[s] = fmaxf(a, li_s[s]);
    }
  }
  __syncthreads();
  if (j < steps) {
    const float li = li_s[j], a = a_s[j], mn = mn_s[j];
    const long long row = in_row(t0 + j);
    ipg[row] = ip_s[j] = expf(li - mn);
    fpg[row] = fp_s[j] = expf(a - mn);
    sag[row] = a > li ? 1.0f : (a == li ? 0.5f : 0.0f);
  }
  __syncthreads();
  // n's recurrence: thread j holds rows j, j + 256, ... (threads past D
  // hold none) and adds its rows' n . q s a step
  if (j < D) {
    float n[kRows];
#pragma unroll
    for (int rr = 0; rr < kRows; ++rr) n[rr] = n_st[at * D + j + 256 * rr];
    for (int s0 = 0; s0 < steps; s0 += kUnroll) {
      float kk[kUnroll][kRows], qq[kUnroll][kRows];
#pragma unroll
      for (int u = 0; u < kUnroll; ++u)
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const bool in = s0 + u < steps;
          const long long p = in_row(t0 + (in ? s0 + u : 0)) * D + j
                              + 256 * rr;
          kk[u][rr] = k[p];
          qq[u][rr] = q[p];
        }
#pragma unroll
      for (int u = 0; u < kUnroll; ++u) {
        if (s0 + u >= steps) break;
        const float ip = ip_s[s0 + u], fp = fp_s[s0 + u];
        float part = 0.0f;
#pragma unroll
        for (int rr = 0; rr < kRows; ++rr) {
          const float ik = __fmul_rn(ip, kk[u][rr]);
          n[rr] = __fadd_rn(__fmul_rn(fp, n[rr]), ik);
          part = fmaf(n[rr], __fmul_rn(qq[u][rr], scale), part);
        }
        part = warp_sum(part);
        if (lane == 0) red_s[s0 + u][warp] = part;
      }
    }
  }
  // dh . h a step: warp w takes steps w, w + 8, ...
  for (int s = warp; s < steps; s += 8) {
    const long long row = in_row(t0 + s);
    float x = 0.0f;
    for (int cc = lane; cc < D; cc += 32)
      x = fmaf(dh[row * D + cc], h[row * D + cc], x);
    x = warp_sum(x);
    if (lane == 0) hdg[row] = x;
  }
  __syncthreads();
  if (j < steps) {
    constexpr int kNw = (D < 256 ? D : 256) / 32;  // warps holding n
    float d = 0.0f;
#pragma unroll
    for (int w = 0; w < kNw; ++w) d += red_s[j][w];
    deng[in_row(t0 + j)] = d;
  }
}

// The walk: block (b * heads + head) * kBlocks + column block, a cluster
// of kCluster consecutive column blocks of a head; thread j owns rows
// kRho j .. kRho j + kRho - 1 of the block's 8 columns of C and dC.
template <int D>
__global__ void __launch_bounds__(Plan<D>::kThreads, 1) mlstm_bwd_walk(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ c_st,
    const float* __restrict__ n_st, const float* __restrict__ dh,
    const float* __restrict__ ipg, const float* __restrict__ fpg,
    const float* __restrict__ deng, const float* __restrict__ hdg,
    float* __restrict__ dv, float* __restrict__ wpart,
    float* __restrict__ upart, float* __restrict__ fpart, int seq_len,
    int heads, float scale) {
  using P = Plan<D>;
  constexpr int T = P::kThreads, W = P::kWarps, R = P::kRho, L = P::kSub;
  constexpr int NS = P::kSubs, NB = P::kBlocks, Q = P::kQ;
  extern __shared__ float4 smem4[];
  float4* st = smem4;                        // [L][Q][T] states before each step
  float* ns = reinterpret_cast<float*>(st + L * Q * T);  // [L][D] n before each step
  // [2][L][cl][D / cl][2]: (w, u) of this rank's rows a step, a sender each
  float* wu = ns + L * D;
  float* dvp_s = wu + 2 * L * 2 * D;         // [2][L][W][kCols] dv's warp partials
  float* ipu_s = dvp_s + 2 * L * W * kCols;  // [2][L] i of the steps
  float* v_s = ipu_s + 2 * L;                // [kChunk][kCols]
  float* dnum_s = v_s + kChunk * kCols;      // [kChunk][kCols]
  float* ip_s = dnum_s + kChunk * kCols;     // [kChunk]
  float* fp_s = ip_s + kChunk;
  float* dden_s = fp_s + kChunk;
  float* dn_s = dden_s + kChunk;             // max(|den|, 1)
  float* rdf = dn_s + kChunk;                // [2][L][cl][W] df, rank 0's
  __shared__ __align__(8) uint64_t full[2];  // a unit's sums all received

  cg::cluster_group cluster = cg::this_cluster();
  constexpr int cl = kCluster;
  const int rank = static_cast<int>(cluster.block_rank());
  const int bh = blockIdx.x / NB, blk = blockIdx.x % NB;
  const int b = bh / heads, head = bh % heads;
  const int col0 = blk * kCols;
  constexpr int n_cl = NB / cl, rows_per = D / cl;  // rows a rank sums
  const int cl_idx = blk / cl;
  const bool first = blk == 0;  // adds n's terms
  const int j = threadIdx.x, lane = j % 32, warp = j / 32, r0 = R * j;
  const int owner = r0 / rows_per;  // the rank that sums this thread's rows
  const int n_chunks = (seq_len + kChunk - 1) / kChunk;
  const long long part0 = ((long long)bh * n_cl + cl_idx) * seq_len;
  auto in_row = [&](int t) {
    return ((long long)b * seq_len + t) * heads + head;
  };

  float dC[R][kCols], dn[R];
#pragma unroll
  for (int rr = 0; rr < R; ++rr) {
    dn[rr] = 0.0f;
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) dC[rr][cc] = 0.0f;
  }
  float C[R][kCols], n[R];
  float start[NS > 2 ? NS - 2 : 1][R][kCols], nstart[NS > 2 ? NS - 2 : 1][R];
  // k and q of the kG steps in use (kg, qg) and of the next group (kx,
  // qx), loaded a group ahead of its use, phase boundaries included
  float kg[kG][R], qg[kG][R], kx[kG][R], qx[kG][R];
  auto prefetch = [&](int t) {  // the group from step t, if any
    if (t < 0) return;
#pragma unroll
    for (int u = 0; u < kG; ++u) {
      const long long p = in_row(min(t + u, seq_len - 1)) * D + r0;
      load_rows<R>(kx[u], k + p);
      load_rows<R>(qx[u], q + p);
    }
  };
  auto take = [&]() {
#pragma unroll
    for (int u = 0; u < kG; ++u)
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        kg[u][rr] = kx[u][rr];
        qg[u][rr] = qx[u][rr];
      }
  };

  // the saved state before chunk c
  auto load_state = [&](int c) {
    const long long at = ((long long)b * n_chunks + c) * heads + head;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float4* src = reinterpret_cast<const float4*>(
          c_st + (at * D + r0 + rr) * D + col0);
      const float4 x0 = src[0], x1 = src[1];
      C[rr][0] = x0.x, C[rr][1] = x0.y, C[rr][2] = x0.z, C[rr][3] = x0.w;
      C[rr][4] = x1.x, C[rr][5] = x1.y, C[rr][6] = x1.z, C[rr][7] = x1.w;
      n[rr] = first ? n_st[at * D + r0 + rr] : 0.0f;
    }
  };
  // one step of the recurrence, s in the chunk, kc its k rows
  auto advance = [&](int s, const float (&kc)[R]) {
    const float ip = ip_s[s], fp = fp_s[s];
    const float* vv = v_s + s * kCols;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      const float ik = __fmul_rn(ip, kc[rr]);
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc)
        C[rr][cc] = __fadd_rn(__fmul_rn(fp, C[rr][cc]), __fmul_rn(ik, vv[cc]));
      if (first) n[rr] = __fadd_rn(__fmul_rn(fp, n[rr]), ik);
    }
  };
  // a sub-chunk's sums (``steps`` steps from ``t_lo``, buffer ``buf``),
  // once this block's mbarrier has counted in every member's sends: the
  // (w, u) of the D / cl rows this rank owns, the senders in rank order;
  // this block's dv, its warps in order; and, in rank 0, the cluster's
  // df, the senders' warps in order
  auto finish = [&](int t_lo, int steps, int buf) {
    const int pairs = rows_per / 2;
    for (int e = j; e < steps * pairs; e += T) {
      const int s = e / pairs, r = rank * rows_per + 2 * (e % pairs);
      const float* src = wu + ((buf * L + s) * D + 2 * (e % pairs)) * 2;
      float4 x = *reinterpret_cast<const float4*>(src);
      for (int p = 1; p < cl; ++p) {  // the senders in rank order
        const float4 y =
            *reinterpret_cast<const float4*>(src + p * rows_per * 2);
        x.x += y.x, x.y += y.y, x.z += y.z, x.w += y.w;
      }
      const long long at = (part0 + t_lo + s) * D + r;
      *reinterpret_cast<float2*>(wpart + at) = make_float2(x.x, x.z);
      *reinterpret_cast<float2*>(upart + at) = make_float2(x.y, x.w);
    }
    const float* dvb = dvp_s + buf * L * W * kCols;
    for (int e = j; e < steps * kCols; e += T) {  // dv, warps in order
      const int s = e / kCols, cc = e % kCols;
      float y = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) y += dvb[(s * W + w) * kCols + cc];
      dv[in_row(t_lo + s) * D + col0 + cc] = ipu_s[buf * L + s] * y;
    }
    if (rank == 0)  // the cluster's df, senders and warps in order
      for (int s = j; s < steps; s += T) {
        const float* rb = rdf + (buf * L + s) * cl * W;
        float y = 0.0f;
        for (int w = 0; w < cl * W; ++w) y += rb[w];
        fpart[part0 + t_lo + s] = y;
      }
  };
  // step s of the recompute (lo: the sub-chunk's first): its state into
  // shared memory, then the recurrence
  auto recompute_step = [&](int s, int lo, int t0, const float (&kc)[R]) {
    float4* dst = st + (s - lo) * Q * T + j;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float* x = &C[i / 2][(i % 2) * 4];
      dst[i * T] = make_float4(x[0], x[1], x[2], x[3]);
    }
    if (first) {
#pragma unroll
      for (int rr = 0; rr < R; ++rr) ns[(s - lo) * D + r0 + rr] = n[rr];
    }
    advance(s - t0, kc);
  };
  // step s of the walk back (buffer buf), kc and qc its k and q rows;
  // returns this thread's part of the step's df
  auto walk_step = [&](int s, int lo, int t0, int buf, const float (&kc)[R],
                       const float (&qc)[R]) {
    const int sl = s - t0, sj = s - lo;
    float cp[R][kCols];
    const float4* src = st + sj * Q * T + j;
#pragma unroll
    for (int i = 0; i < Q; ++i) {
      const float4 x = src[i * T];
      float* y = &cp[i / 2][(i % 2) * 4];
      y[0] = x.x, y[1] = x.y, y[2] = x.z, y[3] = x.w;
    }
    const float fp = fp_s[sl], dden = dden_s[sl];
    const float* dnum = dnum_s + sl * kCols;
    const float* vv = v_s + sl * kCols;
    float dvp[kCols], w[R], uu[R], df4[4] = {0.0f, 0.0f, 0.0f, 0.0f}, qs[R];
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) dvp[cc] = 0.0f;
#pragma unroll
    for (int rr = 0; rr < R; ++rr) {
      qs[rr] = __fmul_rn(qc[rr], scale);
      float wr = 0.0f, ur = 0.0f;
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        const float dct = __fadd_rn(dC[rr][cc], __fmul_rn(qs[rr], dnum[cc]));
        wr = fmaf(C[rr][cc], dnum[cc], wr);
        ur = fmaf(dct, vv[cc], ur);
        dvp[cc] = fmaf(dct, kc[rr], dvp[cc]);
        df4[cc % 4] = fmaf(dct, cp[rr][cc], df4[cc % 4]);
        dC[rr][cc] = __fmul_rn(fp, dct);
        C[rr][cc] = cp[rr][cc];
      }
      w[rr] = wr;
      uu[rr] = ur;
    }
    float df = (df4[0] + df4[1]) + (df4[2] + df4[3]);
    if (first) {  // n's terms, once a head
#pragma unroll
      for (int rr = 0; rr < R; ++rr) {
        const float np = ns[sj * D + r0 + rr];
        const float dnt = __fadd_rn(dn[rr], __fmul_rn(qs[rr], dden));
        w[rr] = fmaf(n[rr], dden, w[rr]);
        uu[rr] += dnt;
        df = fmaf(dnt, np, df);
        dn[rr] = __fmul_rn(fp, dnt);
        n[rr] = np;
      }
    }
    // (w, u) of the rows to their owner (df: a group's at once, below)
    st_async_pairs<R>(
        wu + ((buf * L + sj) * D + rank * rows_per + r0 - owner * rows_per) * 2,
        w, uu, &full[buf], owner);
    scatter_round<16, 4>(dvp, lane);
    scatter_round<8, 2>(dvp, lane);
    scatter_round<4, 1>(dvp, lane);
    dvp[0] += __shfl_xor_sync(kFull, dvp[0], 2);
    dvp[0] += __shfl_xor_sync(kFull, dvp[0], 1);
    if ((lane & 3) == 0) {
      const int col =
          ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
      dvp_s[((buf * L + sj) * W + warp) * kCols + col] = dvp[0];
    }
    if (j == 0) ipu_s[buf * L + sj] = ip_s[sl];
    return df;
  };
  // the warp's df of the group of steps from t (dfg[u]: this thread's
  // part of step t + u) to rank 0: a reduce-scatter over the lanes, lane
  // 4 g ending with step t + 4 g_4 + 2 g_3 + g_2
  auto send_df = [&](float (&dfg)[kG], int t, int lo, int hi, int buf) {
    scatter_round<16, 4>(dfg, lane);
    scatter_round<8, 2>(dfg, lane);
    scatter_round<4, 1>(dfg, lane);
    dfg[0] += __shfl_xor_sync(kFull, dfg[0], 2);
    dfg[0] += __shfl_xor_sync(kFull, dfg[0], 1);
    const int s =
        t + ((lane >> 4) & 1) * 4 + ((lane >> 3) & 1) * 2 + ((lane >> 2) & 1);
    if ((lane & 3) == 0 && s < hi)
      st_async(rdf + ((buf * L + s - lo) * cl + rank) * W + warp, dfg[0],
               &full[buf], 0);
  };

  if (j == 0) {
    mbar_init(&full[0], T);
    mbar_init(&full[1], T);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  cluster.sync();  // every block has started, its mbarriers made
  int unit = 0, pend_lo = 0, pend_steps = 0;
  prefetch((n_chunks - 1) * kChunk);
  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, steps = min(kChunk, seq_len - t0);
    const int nsub = (steps + L - 1) / L;
    __syncthreads();  // the last chunk's readers of these arrays are done
    for (int e = j; e < steps * kCols; e += T) {
      const long long at = in_row(t0 + e / kCols) * D + col0 + e % kCols;
      v_s[e] = v[at];
      dnum_s[e] = dh[at];
    }
    for (int s = j; s < steps; s += T) {
      const long long row = in_row(t0 + s);
      const float den = deng[row], ad = fabsf(den), dn_ = fmaxf(ad, 1.0f);
      const float share = ad > 1.0f ? 1.0f : (ad == 1.0f ? 0.5f : 0.0f);
      const float sg = den > 0.0f ? 1.0f : (den < 0.0f ? -1.0f : 0.0f);
      ip_s[s] = ipg[row];
      fp_s[s] = fpg[row];
      dden_s[s] = -hdg[row] / dn_ * share * sg;
      dn_s[s] = dn_;
    }
    __syncthreads();
    for (int e = j; e < steps * kCols; e += T)
      dnum_s[e] = dnum_s[e] / dn_s[e / kCols];
    __syncthreads();

    // pass 1: the start of each sub-chunk but the first and the last into
    // start[]; C ends at the start of the last
    load_state(c);
    for (int t = t0; t < t0 + (nsub - 1) * L; t += kG) {
      const int sc = (t - t0) / L;
      if (sc >= 1 && (t - t0) % L == 0) {
#pragma unroll
        for (int i = 0; i < NS - 2; ++i)
          if (i == sc - 1) {
#pragma unroll
            for (int rr = 0; rr < R; ++rr) {
              nstart[i][rr] = n[rr];
#pragma unroll
              for (int cc = 0; cc < kCols; ++cc) start[i][rr][cc] = C[rr][cc];
            }
          }
      }
      take();
      prefetch(t + kG);
#pragma unroll
      for (int u = 0; u < kG; ++u) advance(t - t0 + u, kg[u]);
    }

    // pass 2: sub-chunks last to first
    for (int sc = nsub - 1; sc >= 0; --sc) {
      if (sc < nsub - 1) {
        if (sc == 0) {
          load_state(c);
        } else {
#pragma unroll
          for (int i = 0; i < NS - 2; ++i)
            if (i == sc - 1) {
#pragma unroll
              for (int rr = 0; rr < R; ++rr) {
                n[rr] = nstart[i][rr];
#pragma unroll
                for (int cc = 0; cc < kCols; ++cc) C[rr][cc] = start[i][rr][cc];
              }
            }
        }
      }
      const int lo = t0 + sc * L, hi = min(lo + L, t0 + steps);
      const int last = lo + (hi - lo - 1) / kG * kG;  // the last group
      const int buf = unit & 1;
      // the sub-chunk's states into shared memory, each thread its own
      // slots; C ends as the state after its last step
      for (int t = lo; t < hi; t += kG) {
        take();
        prefetch(t + kG < hi ? t + kG : last);
        if (t + kG <= hi) {
#pragma unroll
          for (int u = 0; u < kG; ++u) recompute_step(t + u, lo, t0, kg[u]);
        } else {
#pragma unroll
          for (int u = 0; u < kG; ++u)
            if (t + u < hi) recompute_step(t + u, lo, t0, kg[u]);
        }
      }
      // the last sub-chunk's sums, once they have all come in; then, once
      // every block has taken its sums of the one before, this one's
      // buffers are free
      if (pend_steps) {
        mbar_wait(&full[buf ^ 1], ((unit - 1) >> 1) & 1);
        finish(pend_lo, pend_steps, buf ^ 1);
        cluster_wait();
      }
      cluster_arrive();
      for (int t = last; t >= lo; t -= kG) {  // the walk back
        take();
        prefetch(t > lo ? t - kG
                        : (sc > 0 ? lo - L : (c > 0 ? t0 - kChunk : -1)));
        float dfg[kG];
        if (t + kG <= hi) {
#pragma unroll
          for (int u = kG - 1; u >= 0; --u)
            dfg[u] = walk_step(t + u, lo, t0, buf, kg[u], qg[u]);
        } else {
#pragma unroll
          for (int u = kG - 1; u >= 0; --u)
            dfg[u] = t + u < hi ? walk_step(t + u, lo, t0, buf, kg[u], qg[u])
                                : 0.0f;
        }
        send_df(dfg, t, lo, hi, buf);
      }
      // every thread's arrival: its dv partials and sends are done, and
      // thread 0 counts the bytes the cluster sends this block
      mbar_arrive(&full[buf],
                  j ? 0u
                    : 4u * (hi - lo) * (2 * D + (rank == 0 ? cl * W : 0)));
      pend_lo = lo;
      pend_steps = hi - lo;
      ++unit;
    }
  }
  if (pend_steps) {
    mbar_wait(&full[(unit - 1) & 1], ((unit - 1) >> 1) & 1);
    finish(pend_lo, pend_steps, (unit - 1) & 1);
    cluster_wait();
  }
  cluster.sync();  // no block leaves while a peer may still send to it
}

// The clusters' partial sums of a row (b, t, head), added in cluster
// order: dq = s w, dk = i u, and di = k . u, df for the scalar chain.
template <int D>
__global__ void __launch_bounds__(128) mlstm_bwd_reduce(
    const float* __restrict__ k, const float* __restrict__ wpart,
    const float* __restrict__ upart, const float* __restrict__ fpart,
    const float* __restrict__ ipg, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dig,
    float* __restrict__ dfg, int seq_len, int heads, int n_cl,
    float scale) {
  __shared__ float red[4];
  const long long row = blockIdx.x;  // (b * S + t) * heads + head
  const int head = (int)(row % heads);
  const long long bt = row / heads;
  const int t = (int)(bt % seq_len);
  const long long b = bt / seq_len;
  const long long part0 = ((b * heads + head) * n_cl) * seq_len + t;
  const int j = threadIdx.x;
  const float ip = ipg[row];
  float di = 0.0f;
  for (int r4 = j; r4 < D / 4; r4 += 128) {
    float4 w = make_float4(0.0f, 0.0f, 0.0f, 0.0f), u = w;
#pragma unroll 8
    for (int p = 0; p < n_cl; ++p) {
      const long long at = (part0 + (long long)p * seq_len) * D + 4 * r4;
      const float4 x = *reinterpret_cast<const float4*>(wpart + at);
      const float4 y = *reinterpret_cast<const float4*>(upart + at);
      w.x += x.x, w.y += x.y, w.z += x.z, w.w += x.w;
      u.x += y.x, u.y += y.y, u.z += y.z, u.w += y.w;
    }
    const float4 kk = *reinterpret_cast<const float4*>(k + row * D + 4 * r4);
    *reinterpret_cast<float4*>(dq + row * D + 4 * r4) =
        make_float4(scale * w.x, scale * w.y, scale * w.z, scale * w.w);
    *reinterpret_cast<float4*>(dk + row * D + 4 * r4) =
        make_float4(ip * u.x, ip * u.y, ip * u.z, ip * u.w);
    di = fmaf(kk.x, u.x, di);
    di = fmaf(kk.y, u.y, di);
    di = fmaf(kk.z, u.z, di);
    di = fmaf(kk.w, u.w, di);
  }
  di = warp_sum(di);
  if (j % 32 == 0) red[j / 32] = di;
  __syncthreads();
  if (j == 0) {
    dig[row] = (red[0] + red[1]) + (red[2] + red[3]);
    float df = 0.0f;
    for (int p = 0; p < n_cl; ++p)
      df += fpart[part0 + (long long)p * seq_len];
    dfg[row] = df;
  }
}

// The stabiliser's scalar chain, t = S-1 .. 0, one warp a (b, head):
// the lanes load 32 steps' scalars a group ahead, and every lane walks
// the chain through them by shuffles, lane s keeping step s's outputs.
// Each operation rounds on its own, as the plain version's.
__global__ void __launch_bounds__(128) mlstm_bwd_chain(
    const float* __restrict__ ipg, const float* __restrict__ fpg,
    const float* __restrict__ sag, const float* __restrict__ dig,
    const float* __restrict__ dfg, float* __restrict__ dli,
    float* __restrict__ dlf, int batch, int seq_len, int heads) {
  const int bh = (blockIdx.x * blockDim.x + threadIdx.x) / 32;
  const int lane = threadIdx.x % 32;
  if (bh >= batch * heads) return;  // whole warps
  const int b = bh / heads, head = bh % heads;
  auto row = [&](int t) {
    return ((long long)b * seq_len + t) * heads + head;
  };
  float nx[5] = {0.0f, 0.0f, 0.0f, 0.0f, 0.0f};
  auto load = [&](int top) {  // lane's step top - lane of the next group
    const int t = top - lane;
    if (t >= 0) {
      const long long r = row(t);
      nx[0] = ipg[r], nx[1] = fpg[r], nx[2] = sag[r], nx[3] = dig[r];
      nx[4] = dfg[r];
    }
  };
  float dm = 0.0f;
  load(seq_len - 1);
  for (int top = seq_len - 1; top >= 0; top -= 32) {
    float cur[5];
#pragma unroll
    for (int i = 0; i < 5; ++i) cur[i] = nx[i];
    load(top - 32);
    const int n = min(32, top + 1);
    float my_li = 0.0f, my_lf = 0.0f;
#pragma unroll
    for (int s = 0; s < 32; ++s) {
      const float ip = __shfl_sync(kFull, cur[0], s);
      const float fp = __shfl_sync(kFull, cur[1], s);
      const float sa = __shfl_sync(kFull, cur[2], s);
      const float di = __shfl_sync(kFull, cur[3], s);
      const float df = __shfl_sync(kFull, cur[4], s);
      if (s < n) {
        const float dip = __fmul_rn(di, ip), dfp = __fmul_rn(df, fp);
        const float dm_new = __fsub_rn(__fsub_rn(dm, dip), dfp);
        const float li = __fadd_rn(dip, __fmul_rn(dm_new, 1.0f - sa));
        dm = __fadd_rn(dfp, __fmul_rn(dm_new, sa));
        if (lane == s) my_li = li, my_lf = dm;
      }
    }
    if (lane < n) {
      dli[row(top - lane)] = my_li;
      dlf[row(top - lane)] = my_lf;
    }
  }
}

template <int D>
cudaLaunchConfig_t walk_config(int clusters, cudaStream_t st,
                               cudaLaunchAttribute* attr) {
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * kCluster));
  cfg.blockDim = dim3(static_cast<unsigned>(Plan<D>::kThreads));
  cfg.dynamicSmemBytes = Plan<D>::kBytes;
  cfg.stream = st;
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(kCluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// The walk's dynamic shared memory, set once: at most what a block has
// beside its two mbarriers.
constexpr int kMaxDynamic = 232448 - 16;

template <int D>
int walk_attributes() {
  static int rc = -1;
  if (rc < 0)
    rc = static_cast<int>(cudaFuncSetAttribute(
        mlstm_bwd_walk<D>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kMaxDynamic));
  return rc;
}

template <int D>
bool plan_matches(int cols, int sub, int threads, int cluster,
                  int shared_bytes) {
  using P = Plan<D>;
  static_assert(P::kBytes <= kMaxDynamic, "a block's shared memory");
  return cols == kCols && sub == P::kSub && threads == P::kThreads &&
         cluster == kCluster && shared_bytes == P::kBytes;
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const float* log_i, const float* log_f, const float* h,
           const float* c_st, const float* n_st, const float* m_st,
           const float* dh, float* dq, float* dk, float* dv, float* dli,
           float* dlf, float* scratch, int batch, int seq_len, int heads,
           float scale, cudaStream_t stream) {
  using P = Plan<D>;
  constexpr int n_cl = P::kBlocks / kCluster;
  const long long bh = (long long)batch * heads;
  const long long rows = bh * seq_len;
  const int n_chunks = (seq_len + kChunk - 1) / kChunk;
  float* wpart = scratch;
  float* upart = wpart + bh * n_cl * seq_len * D;
  float* fpart = upart + bh * n_cl * seq_len * D;
  float* hd = fpart + bh * n_cl * seq_len;
  float* den = hd + rows;
  float* ipg = den + rows;
  float* fpg = ipg + rows;
  float* sag = fpg + rows;
  float* dig = sag + rows;
  float* dfg = dig + rows;
  int rc = walk_attributes<D>();
  if (rc) return rc;
  mlstm_bwd_prep<D><<<dim3((unsigned)bh, n_chunks), 256, 0, stream>>>(
      q, k, log_i, log_f, h, dh, n_st, m_st, ipg, fpg, sag, den, hd,
      seq_len, heads, scale);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg =
      walk_config<D>((int)bh * n_cl, stream, &attr);
  rc = static_cast<int>(cudaLaunchKernelEx(
      &cfg, mlstm_bwd_walk<D>, q, k, v, c_st, n_st, dh,
      (const float*)ipg, (const float*)fpg, (const float*)den,
      (const float*)hd, dv, wpart, upart, fpart, seq_len, heads, scale));
  if (rc) return rc;
  mlstm_bwd_reduce<D><<<(unsigned)rows, 128, 0, stream>>>(
      k, wpart, upart, fpart, ipg, dq, dk, dig, dfg, seq_len, heads, n_cl,
      scale);
  mlstm_bwd_chain<<<(unsigned)((32 * bh + 127) / 128), 128, 0, stream>>>(
      ipg, fpg, sag, dig, dfg, dli, dlf, batch, seq_len, heads);
  return static_cast<int>(cudaGetLastError());
}

template <int D>
int resident(int* count) {
  const int rc = walk_attributes<D>();
  if (rc) return rc;
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = walk_config<D>(1, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(
      count, (const void*)mlstm_bwd_walk<D>, &cfg));
}

}  // namespace

// (dq, dk, dv, dlog_i, dlog_f) of the scan under dh, from the forward's h
// and chunk states; D is 64, 128, 256 or 512, laid out by the plan
// (cols, sub, threads, cluster, shared_bytes) of
// xlstm_scan.mlstm_plan(D): any other D, or a plan other than the
// kernel's own, returns cudaErrorInvalidValue.
// ``scratch`` holds B*H*(D/8/kCluster)*S*(2D+1) + 7*B*S*H floats
// (xlstm_scan.mlstm_bwd_scratch_floats).
extern "C" int mlstm_scan_bwd_f32(
    const void* q, const void* k, const void* v, const void* log_i,
    const void* log_f, const void* h, const void* c_st, const void* n_st,
    const void* m_st, const void* dh, void* dq, void* dk, void* dv,
    void* dli, void* dlf, void* scratch, int batch, int seq_len, int heads,
    int dim, int cols, int sub, int threads, int cluster, int shared_bytes,
    float scale, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLSTM_BWD_LAUNCH(D)                                                 \
  plan_matches<D>(cols, sub, threads, cluster, shared_bytes)                \
      ? launch<D>(f(q), f(k), f(v), f(log_i), f(log_f), f(h), f(c_st),     \
                  f(n_st), f(m_st), f(dh), g(dq), g(dk), g(dv), g(dli),     \
                  g(dlf), g(scratch), batch, seq_len, heads, scale, st)     \
      : static_cast<int>(cudaErrorInvalidValue)
  switch (dim) {
    case 64:
      return MLSTM_BWD_LAUNCH(64);
    case 128:
      return MLSTM_BWD_LAUNCH(128);
    case 256:
      return MLSTM_BWD_LAUNCH(256);
    case 512:
      return MLSTM_BWD_LAUNCH(512);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
#undef MLSTM_BWD_LAUNCH
}

// How many clusters of the walk's blocks of head dim ``dim`` can be
// resident on the card at once (cudaOccupancyMaxActiveClusters), into
// *count; the CUDA error code.
extern "C" int mlstm_scan_bwd_resident_clusters(int dim, int* count) {
  switch (dim) {
    case 64:
      return resident<64>(count);
    case 128:
      return resident<128>(count);
    case 256:
      return resident<256>(count);
    case 512:
      return resident<512>(count);
    default:
      return static_cast<int>(cudaErrorInvalidValue);
  }
}
