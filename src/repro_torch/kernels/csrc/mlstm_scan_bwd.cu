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
// The design, simple first:
// - dC and dn need only the forward's values, not dm: the walk carries
//   them, and the stabiliser's scalar chain (dm) runs in a closing launch
//   on each step's di and df;
// - the walk takes a block a (b, head) and kCols = 16 columns of C, as the
//   forward does; a thread keeps 2 rows x 16 columns of dC in registers
//   (D / 2 threads a block), so the sums over the columns (dq's C_t dnum,
//   u's dC v) are a thread's own, and the sums over the rows (dv, df) a
//   butterfly over the warp and the warps' partials in shared memory;
// - a chunk's 64 states of C do not fit on chip (2 MB a block at D =
//   512): the recompute writes them to a scratch in device memory, and the
//   walk reads them back, one state a step, the next one's load in flight
//   while the step computes; the recurrence is never inverted (f can be 0);
// - C_t = f C_{t-1} + (i k) v^T is recomputed in the walk from C_{t-1} by
//   the forward's own expression;
// - dq, dk and di (sums over all the columns) and df (over all of C)
//   cross the column blocks: each block writes its partial sums a step,
//   and a closing launch adds them in block order; the head's first block
//   adds n's terms.  A second closing launch walks the scalar chain of m.
//   No atomics: the same inputs give the same bits;
// - a prologue launch computes dh . h_t a row (the forward's h);
// - expf (not __expf), as the forward.
//
// What bounds it on this card: at xlstm-350m's B=1, S=4,096, H=4, D=512
// the gradient reads q, k, v, h, dh and the gates and writes dq, dk, dv
// (8 x 33.6 MB) plus the saved states (0.27 GB at 64 chunks), ~0.16 ms at
// 3.35 TB/s; it needs 14 flops an element of C a step (the recurrence
// recomputed, 3, and the walk's five products with dC, 11), 60 GFLOP,
// 0.90 ms at 67 TFLOP/s.  This design also moves the recomputed states
// through device memory, 16 GB each way, and the partial sums, 2 x 1.07
// GB each way.
#include <cuda_runtime.h>

namespace {

constexpr int kChunk = 64;
constexpr int kCols = 16;
constexpr unsigned kFull = 0xffffffffu;

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

// dh . h a row (b, t, head): one warp a row.
__global__ void __launch_bounds__(256) mlstm_bwd_dot(
    const float* __restrict__ h, const float* __restrict__ dh,
    float* __restrict__ hd, long long rows, int dim) {
  const long long row = (long long)blockIdx.x * 8 + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= rows) return;
  float x = 0.0f;
  for (int c = lane; c < dim; c += 32)
    x += dh[row * dim + c] * h[row * dim + c];
  x = warp_sum(x);
  if (lane == 0) hd[row] = x;
}

// The walk: block (b * heads + head, column block), D / 2 threads, thread
// j keeps rows 2j and 2j+1 of the block's 16 columns of dC.
template <int D>
__global__ void __launch_bounds__(D / 2) mlstm_bwd_walk(
    const float* __restrict__ q, const float* __restrict__ k,
    const float* __restrict__ v, const float* __restrict__ log_i,
    const float* __restrict__ log_f, const float* __restrict__ c_st,
    const float* __restrict__ n_st, const float* __restrict__ m_st,
    const float* __restrict__ dh, const float* __restrict__ hd,
    float* __restrict__ dv, float4* __restrict__ cbuf,
    float2* __restrict__ nbuf, float* __restrict__ wpart,
    float* __restrict__ upart, float* __restrict__ fpart,
    float* __restrict__ ipg, float* __restrict__ fpg,
    float* __restrict__ sag, int seq_len, int heads, float scale) {
  constexpr int T = D / 2, W = T / 32, NB = D / kCols;
  __shared__ float v_s[kChunk][kCols], dh_s[kChunk][kCols];
  __shared__ float li_s[kChunk], lf_s[kChunk], ip_s[kChunk], fp_s[kChunk],
      sa_s[kChunk], hd_s[kChunk], den_s[kChunk];
  __shared__ float red_s[kChunk][W];          // den, then df partials
  __shared__ float dvp_s[kChunk][W][kCols];   // dv partials
  const int bh = blockIdx.x, b = bh / heads, head = bh % heads;
  const int blk = blockIdx.y, col0 = blk * kCols;
  const int j = threadIdx.x, lane = j % 32, warp = j / 32, r0 = 2 * j;
  const int n_chunks = (seq_len + kChunk - 1) / kChunk;
  float4* cb = cbuf + ((long long)bh * NB + blk) * kChunk * 8 * T;
  float2* nb = nbuf + (long long)bh * kChunk * T;
  const long long part0 = ((long long)bh * NB + blk) * seq_len;
  auto in_row = [&](int t) {
    return ((long long)b * seq_len + t) * heads + head;
  };

  float dC[2][kCols], dn[2] = {0.0f, 0.0f};
#pragma unroll
  for (int rr = 0; rr < 2; ++rr)
#pragma unroll
    for (int cc = 0; cc < kCols; ++cc) dC[rr][cc] = 0.0f;

  for (int c = n_chunks - 1; c >= 0; --c) {
    const int t0 = c * kChunk, steps = min(kChunk, seq_len - t0);
    for (int e = j; e < steps * kCols; e += T) {
      const int s = e / kCols, cc = e % kCols;
      const long long at = in_row(t0 + s) * D + col0 + cc;
      v_s[s][cc] = v[at];
      dh_s[s][cc] = dh[at];
    }
    for (int s = j; s < steps; s += T) {
      const long long row = in_row(t0 + s);
      li_s[s] = log_i[row];
      lf_s[s] = log_f[row];
      hd_s[s] = hd[row];
    }
    // the saved state before the chunk
    const long long at = ((long long)b * n_chunks + c) * heads + head;
    float C[2][kCols], n[2];
#pragma unroll
    for (int rr = 0; rr < 2; ++rr) {
      const float4* src = reinterpret_cast<const float4*>(
          c_st + (at * D + r0 + rr) * D + col0);
#pragma unroll
      for (int c4 = 0; c4 < 4; ++c4) {
        const float4 x = src[c4];
        C[rr][4 * c4] = x.x;
        C[rr][4 * c4 + 1] = x.y;
        C[rr][4 * c4 + 2] = x.z;
        C[rr][4 * c4 + 3] = x.w;
      }
      n[rr] = n_st[at * D + r0 + rr];
    }
    __syncthreads();
    if (j == 0) {  // the gates' scalar recurrence, as the forward's
      float m = m_st[at];
      for (int s = 0; s < steps; ++s) {
        const float li = li_s[s], lf = lf_s[s];
        const float m_new = fmaxf(lf + m, li);
        ip_s[s] = expf(li - m_new);
        fp_s[s] = expf(lf + m - m_new);
        const float a = lf + m;
        sa_s[s] = a > li ? 1.0f : (a == li ? 0.5f : 0.0f);
        m = m_new;
      }
    }
    __syncthreads();

    // recompute: the state before each step into the scratch, and den
    float2 k2 = *reinterpret_cast<const float2*>(k + in_row(t0) * D + r0);
    float2 q2 = *reinterpret_cast<const float2*>(q + in_row(t0) * D + r0);
    for (int s = 0; s < steps; ++s) {
      const float2 kc = k2, qc = q2;
      if (s + 1 < steps) {
        k2 = *reinterpret_cast<const float2*>(k + in_row(t0 + s + 1) * D +
                                              r0);
        q2 = *reinterpret_cast<const float2*>(q + in_row(t0 + s + 1) * D +
                                              r0);
      }
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        const float* x = &C[i / 4][(i % 4) * 4];
        cb[(s * 8 + i) * T + j] = make_float4(x[0], x[1], x[2], x[3]);
      }
      if (blk == 0) nb[s * T + j] = make_float2(n[0], n[1]);
      const float ip = ip_s[s], fp = fp_s[s];
      const float kk[2] = {kc.x, kc.y};
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float ik = ip * kk[rr];
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc)
          C[rr][cc] = fp * C[rr][cc] + ik * v_s[s][cc];
        n[rr] = fp * n[rr] + ik;
      }
      float part = n[0] * (qc.x * scale) + n[1] * (qc.y * scale);
      part = warp_sum(part);
      if (lane == 0) red_s[s][warp] = part;
    }
    __syncthreads();
    for (int s = j; s < steps; s += T) {
      float d = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) d += red_s[s][w];
      den_s[s] = d;
    }
    __syncthreads();

    // the walk back, the next step's state in flight
    float4 nxt[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) nxt[i] = cb[((steps - 1) * 8 + i) * T + j];
    k2 = *reinterpret_cast<const float2*>(k + in_row(t0 + steps - 1) * D + r0);
    q2 = *reinterpret_cast<const float2*>(q + in_row(t0 + steps - 1) * D + r0);
    for (int s = steps - 1; s >= 0; --s) {
      float cp[2][kCols];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        float* x = &cp[i / 4][(i % 4) * 4];
        x[0] = nxt[i].x;
        x[1] = nxt[i].y;
        x[2] = nxt[i].z;
        x[3] = nxt[i].w;
      }
      const float2 kc = k2, qc = q2;
      if (s > 0) {
#pragma unroll
        for (int i = 0; i < 8; ++i) nxt[i] = cb[((s - 1) * 8 + i) * T + j];
        k2 = *reinterpret_cast<const float2*>(k + in_row(t0 + s - 1) * D +
                                              r0);
        q2 = *reinterpret_cast<const float2*>(q + in_row(t0 + s - 1) * D +
                                              r0);
      }
      const float ip = ip_s[s], fp = fp_s[s], den = den_s[s];
      const float ad = fabsf(den), dn_ = fmaxf(ad, 1.0f);
      const float share = ad > 1.0f ? 1.0f : (ad == 1.0f ? 0.5f : 0.0f);
      const float sg = den > 0.0f ? 1.0f : (den < 0.0f ? -1.0f : 0.0f);
      const float dden = -hd_s[s] / dn_ * share * sg;
      float dnum[kCols], dvp[kCols];
#pragma unroll
      for (int cc = 0; cc < kCols; ++cc) {
        dnum[cc] = dh_s[s][cc] / dn_;
        dvp[cc] = 0.0f;
      }
      const float kk[2] = {kc.x, kc.y};
      const float qs[2] = {qc.x * scale, qc.y * scale};
      float w[2], u[2], df = 0.0f;
#pragma unroll
      for (int rr = 0; rr < 2; ++rr) {
        const float ik = ip * kk[rr];
        float wr = 0.0f, ur = 0.0f;
#pragma unroll
        for (int cc = 0; cc < kCols; ++cc) {
          const float vc = v_s[s][cc];
          const float ct = fp * cp[rr][cc] + ik * vc;
          const float dct = dC[rr][cc] + qs[rr] * dnum[cc];
          wr += ct * dnum[cc];
          ur += dct * vc;
          dvp[cc] += dct * kk[rr];
          df += dct * cp[rr][cc];
          dC[rr][cc] = fp * dct;
        }
        w[rr] = wr;
        u[rr] = ur;
      }
      if (blk == 0) {  // n's terms, once a head
        const float2 np = nb[s * T + j];
        const float npr[2] = {np.x, np.y};
#pragma unroll
        for (int rr = 0; rr < 2; ++rr) {
          const float nt = fp * npr[rr] + ip * kk[rr];
          const float dnt = dn[rr] + qs[rr] * dden;
          w[rr] += nt * dden;
          u[rr] += dnt;
          df += dnt * npr[rr];
          dn[rr] = fp * dnt;
        }
      }
      const long long p = (part0 + t0 + s) * D + r0;
      *reinterpret_cast<float2*>(wpart + p) = make_float2(w[0], w[1]);
      *reinterpret_cast<float2*>(upart + p) = make_float2(u[0], u[1]);
      scatter_round<16, 8>(dvp, lane);
      scatter_round<8, 4>(dvp, lane);
      scatter_round<4, 2>(dvp, lane);
      scatter_round<2, 1>(dvp, lane);
      dvp[0] += __shfl_xor_sync(kFull, dvp[0], 1);
      if ((lane & 1) == 0) {
        const int col = ((lane >> 4) & 1) * 8 + ((lane >> 3) & 1) * 4 +
                        ((lane >> 2) & 1) * 2 + ((lane >> 1) & 1);
        dvp_s[s][warp][col] = dvp[0];
      }
      df = warp_sum(df);
      if (lane == 0) red_s[s][warp] = df;
    }
    __syncthreads();
    for (int e = j; e < steps * kCols; e += T) {
      const int s = e / kCols, cc = e % kCols;
      float x = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) x += dvp_s[s][w][cc];
      dv[in_row(t0 + s) * D + col0 + cc] = ip_s[s] * x;
    }
    for (int s = j; s < steps; s += T) {
      float x = 0.0f;
#pragma unroll
      for (int w = 0; w < W; ++w) x += red_s[s][w];
      fpart[part0 + t0 + s] = x;
      if (blk == 0) {
        const long long row = in_row(t0 + s);
        ipg[row] = ip_s[s];
        fpg[row] = fp_s[s];
        sag[row] = sa_s[s];
      }
    }
    __syncthreads();  // the next chunk refills the shared arrays
  }
}

// The column blocks' partial sums of a row (b, t, head), added in block
// order: dq = s w, dk = i u, and di = k . u, df for the scalar chain.
template <int D>
__global__ void __launch_bounds__(128) mlstm_bwd_reduce(
    const float* __restrict__ k, const float* __restrict__ wpart,
    const float* __restrict__ upart, const float* __restrict__ fpart,
    const float* __restrict__ ipg, float* __restrict__ dq,
    float* __restrict__ dk, float* __restrict__ dig,
    float* __restrict__ dfg, int seq_len, int heads, float scale) {
  constexpr int NB = D / kCols;
  __shared__ float red[4];
  const long long row = blockIdx.x;  // (b * S + t) * heads + head
  const int head = (int)(row % heads);
  const long long bt = row / heads;
  const int t = (int)(bt % seq_len);
  const long long b = bt / seq_len;
  const long long part0 = ((b * heads + head) * NB) * seq_len + t;
  const int j = threadIdx.x;
  const float ip = ipg[row];
  float di = 0.0f;
  for (int r = j; r < D; r += 128) {
    float w = 0.0f, u = 0.0f;
    for (int blk = 0; blk < NB; ++blk) {
      const long long p = (part0 + (long long)blk * seq_len) * D + r;
      w += wpart[p];
      u += upart[p];
    }
    dq[row * D + r] = scale * w;
    dk[row * D + r] = ip * u;
    di += k[row * D + r] * u;
  }
  di = warp_sum(di);
  if (j % 32 == 0) red[j / 32] = di;
  __syncthreads();
  if (j == 0) {
    dig[row] = (red[0] + red[1]) + (red[2] + red[3]);
    float df = 0.0f;
    for (int blk = 0; blk < NB; ++blk)
      df += fpart[part0 + (long long)blk * seq_len];
    dfg[row] = df;
  }
}

// The stabiliser's scalar chain, t = S-1 .. 0, one thread a (b, head).
__global__ void mlstm_bwd_chain(
    const float* __restrict__ ipg, const float* __restrict__ fpg,
    const float* __restrict__ sag, const float* __restrict__ dig,
    const float* __restrict__ dfg, float* __restrict__ dli,
    float* __restrict__ dlf, int batch, int seq_len, int heads) {
  const int bh = blockIdx.x * blockDim.x + threadIdx.x;
  if (bh >= batch * heads) return;
  const int b = bh / heads, head = bh % heads;
  float dm = 0.0f;
#pragma unroll 8
  for (int t = seq_len - 1; t >= 0; --t) {
    const long long row = ((long long)b * seq_len + t) * heads + head;
    const float ip = ipg[row], fp = fpg[row], sa = sag[row];
    const float di = dig[row], df = dfg[row];
    const float dm_new = dm - di * ip - df * fp;
    dli[row] = di * ip + dm_new * (1.0f - sa);
    dm = df * fp + dm_new * sa;
    dlf[row] = dm;
  }
}

template <int D>
int launch(const float* q, const float* k, const float* v,
           const float* log_i, const float* log_f, const float* h,
           const float* c_st, const float* n_st, const float* m_st,
           const float* dh, float* dq, float* dk, float* dv, float* dli,
           float* dlf, float* scratch, int batch, int seq_len, int heads,
           float scale, cudaStream_t stream) {
  constexpr int NB = D / kCols;
  const long long bh = (long long)batch * heads;
  const long long rows = bh * seq_len;
  float* cbuf = scratch;
  float* nbuf = cbuf + bh * kChunk * D * D;
  float* wpart = nbuf + bh * kChunk * D;
  float* upart = wpart + bh * NB * seq_len * D;
  float* fpart = upart + bh * NB * seq_len * D;
  float* hd = fpart + bh * NB * seq_len;
  float* ipg = hd + rows;
  float* fpg = ipg + rows;
  float* sag = fpg + rows;
  float* dig = sag + rows;
  float* dfg = dig + rows;
  mlstm_bwd_dot<<<(unsigned)((rows + 7) / 8), 256, 0, stream>>>(h, dh, hd,
                                                                rows, D);
  mlstm_bwd_walk<D><<<dim3((unsigned)bh, NB), D / 2, 0, stream>>>(
      q, k, v, log_i, log_f, c_st, n_st, m_st, dh, hd, dv,
      reinterpret_cast<float4*>(cbuf), reinterpret_cast<float2*>(nbuf),
      wpart, upart, fpart, ipg, fpg, sag, seq_len, heads, scale);
  mlstm_bwd_reduce<D><<<(unsigned)rows, 128, 0, stream>>>(
      k, wpart, upart, fpart, ipg, dq, dk, dig, dfg, seq_len, heads, scale);
  mlstm_bwd_chain<<<(unsigned)((bh + 127) / 128), 128, 0, stream>>>(
      ipg, fpg, sag, dig, dfg, dli, dlf, batch, seq_len, heads);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// (dq, dk, dv, dlog_i, dlog_f) of the scan under dh, from the forward's h
// and chunk states; D is 64, 128, 256 or 512 (any other returns
// cudaErrorInvalidValue; the wrapper refuses it first).  ``scratch`` holds
// B*H*64*D*D + B*H*64*D + B*H*(D/16)*S*(2D+1) + 6*B*S*H floats
// (xlstm_scan.mlstm_bwd_scratch_floats).
extern "C" int mlstm_scan_bwd_f32(
    const void* q, const void* k, const void* v, const void* log_i,
    const void* log_f, const void* h, const void* c_st, const void* n_st,
    const void* m_st, const void* dh, void* dq, void* dk, void* dv,
    void* dli, void* dlf, void* scratch, int batch, int seq_len, int heads,
    int dim, float scale, void* stream) {
  const auto f = [](const void* p) { return static_cast<const float*>(p); };
  const auto g = [](void* p) { return static_cast<float*>(p); };
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
#define MLSTM_BWD_LAUNCH(D)                                                \
  launch<D>(f(q), f(k), f(v), f(log_i), f(log_f), f(h), f(c_st), f(n_st), \
            f(m_st), f(dh), g(dq), g(dk), g(dv), g(dli), g(dlf),          \
            g(scratch), batch, seq_len, heads, scale, st)
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
