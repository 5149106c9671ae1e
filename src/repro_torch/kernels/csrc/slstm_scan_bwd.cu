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
//     g_h[i] = sum_g sum_j r_g[i][j] d_g[j]      (d_g = dpz, dpi, dpf, dpo)
//
// where [a vs b] is 1 if a > b, 0.5 at a tie and 0 else (the split of
// jnp.maximum's gradient), h_t = o c_t / N as the forward computes it.
// The inputs zx, ix, fx, ox enter the pre-activations additively, so
// d_g is their gradient; the recurrent matrices' gradients, sums over
// (b, t) of h_{t-1} (x) d_g, are one product a gate over the saved h after
// this walk (kernels/xlstm_scan.py).  The plain version is kernels/ref.py
// slstm_scan_bwd_ref.
//
// The design mirrors the forward's:
// - one block a (b, head) of kThreads = 1,024 threads;
// - the products g_h = sum_g r_g d_g read rows of the transposed matrices
//   r_g^T (the wrapper transposes them once a call: (G, 4, H, dh, dh)) as
//   the forward's h r_g reads rows of r_g: thread (p, g, q) multiplies rows
//   j of part p of r_g^T by d_g[j] (a broadcast from shared memory) into
//   the four columns 4q .. 4q+3, each row's four one 16-byte load; the
//   partial sums meet in shared memory and thread i adds them in a fixed
//   order (gate, then part) at the next step;
// - thread j < dh keeps column j's dc, dn, dm in registers and reads the
//   next step's states and inputs one step ahead;
// - two barriers a step; no atomics: two calls give the same bits;
// - the groups of r: batch row b takes group b / (B / G), as the forward.
//
// What bounds it on this card: at xlstm-350m's B=1, S=4,096, H=4, dh=256
// the four products a step are 4.3 GFLOP (0.064 ms at 67 TFLOP/s) and the
// bytes the saved states, inputs and outputs (12 x 16.8 MB, 0.06 ms); the
// chain of 4,096 dependent steps, each reading the head's four matrices
// (1 MB) from L2, is what holds it back, as in the forward.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDim = 256;

struct Cell {  // one step's values of column j
  float c, n, m;
};

__global__ void __launch_bounds__(kThreads) slstm_bwd_kernel(
    const float* __restrict__ rt, const float* __restrict__ c_s,
    const float* __restrict__ n_s, const float* __restrict__ m_s,
    const float* __restrict__ pz_s, const float* __restrict__ pi_s,
    const float* __restrict__ pf_s, const float* __restrict__ po_s,
    const float* __restrict__ dy, float* __restrict__ dz_o,
    float* __restrict__ di_o, float* __restrict__ df_o,
    float* __restrict__ do_o, int seq_len, int heads, int dim,
    int rows_per_group) {
  __shared__ float ds[4][kMaxDim];
  __shared__ __align__(16) float partial[kThreads * 4];  // [p][g][dim]
  const int b = blockIdx.x / heads, head = blockIdx.x % heads;
  const int tid = threadIdx.x;
  // the products: thread (p, g, q)
  const int quads = dim / 4;
  const int q = tid % quads, g = (tid / quads) % 4, p = tid / dim;
  const int rows = dim * dim / kThreads;  // rows a part
  const long long grp = b / rows_per_group;
  const float4* __restrict__ col = reinterpret_cast<const float4*>(
      rt + (((grp * 4 + g) * heads + head) * dim + (long long)p * rows) *
               dim) + q;
  float4* out4 = reinterpret_cast<float4*>(partial) + tid;
  const float* dsp = ds[g] + p * rows;
  // the cell: thread j < dim, column j
  const int j = tid;
  const bool cell = j < dim;
  const long long row0 = ((long long)b * seq_len * heads + head) * dim + j;
  const long long stride = (long long)heads * dim;
  const int parts = kThreads / dim;

  auto state = [&](int t) {
    if (t < 0) return Cell{0.0f, 0.0f, -1e30f};
    const long long at = row0 + t * stride;
    return Cell{c_s[at], n_s[at], m_s[at]};
  };
  float dc = 0.0f, dn = 0.0f, dm = 0.0f;
  Cell cur{}, prev{};
  float xz = 0.0f, xi = 0.0f, xf = 0.0f, xo = 0.0f, xd = 0.0f;
  if (cell && seq_len > 0) {
    const long long at = row0 + (long long)(seq_len - 1) * stride;
    cur = state(seq_len - 1);
    prev = state(seq_len - 2);
    xz = pz_s[at];
    xi = pi_s[at];
    xf = pf_s[at];
    xo = po_s[at];
    xd = dy[at];
  }
  for (int t = seq_len - 1; t >= 0; --t) {
    if (cell) {
      const long long at = row0 + t * stride;
      float g_h = 0.0f;
      if (t < seq_len - 1) {
#pragma unroll
        for (int gate = 0; gate < 4; ++gate)
          for (int part = 0; part < parts; ++part)
            g_h += partial[(part * 4 + gate) * dim + j];
      }
      const Cell now = cur, before = prev;
      const float pz = xz, pi = xi, pf = xf, po = xo, dyt = xd;
      if (t > 0) {  // the step before's inputs and the state before it
        cur = prev;
        prev = state(t - 2);
        xz = pz_s[at - stride];
        xi = pi_s[at - stride];
        xf = pf_s[at - stride];
        xo = po_s[at - stride];
        xd = dy[at - stride];
      }
      const float z = tanhf(pz);
      const float o = 1.0f / (1.0f + expf(-po));
      const float log_f = fminf(pf, 0.0f) - log1pf(expf(-fabsf(pf)));
      const float ip = expf(pi - now.m);
      const float fp = expf(log_f + before.m - now.m);
      const float N = fmaxf(now.n, 1e-6f);
      const float share_n =
          now.n > 1e-6f ? 1.0f : (now.n == 1e-6f ? 0.5f : 0.0f);
      const float gt = dyt + g_h;
      const float ht = o * now.c / N;
      const float d_o = gt * now.c / N;
      dc = dc + gt * o / N;
      dn = dn - gt * ht / N * share_n;
      const float df = dc * before.c + dn * before.n;
      const float di = dc * z + dn;
      const float dz = dc * ip;
      dc *= fp;
      dn *= fp;
      const float a = log_f + before.m;
      const float share = a > pi ? 1.0f : (a == pi ? 0.5f : 0.0f);
      const float dm_new = dm - di * ip - df * fp;
      const float dpi = di * ip + dm_new * (1.0f - share);
      dm = df * fp + dm_new * share;
      const float dpf = dm * (1.0f / (1.0f + expf(pf)));
      const float dpz = dz * (1.0f - z * z);
      const float dpo = d_o * o * (1.0f - o);
      dz_o[at] = dpz;
      di_o[at] = dpi;
      df_o[at] = dpf;
      do_o[at] = dpo;
      ds[0][j] = dpz;
      ds[1][j] = dpi;
      ds[2][j] = dpf;
      ds[3][j] = dpo;
    }
    __syncthreads();
    if (t > 0) {
      float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
      for (int i = 0; i < rows; ++i) {
        const float di = dsp[i];
        const float4 r = __ldg(col + (long long)i * quads);
        acc.x += di * r.x;
        acc.y += di * r.y;
        acc.z += di * r.z;
        acc.w += di * r.w;
      }
      *out4 = acc;
    }
    __syncthreads();
  }
}

}  // namespace

// d(zx, ix, fx, ox) (each (B, S, H, dh)) of the scan under dh, from the
// forward's states; rt holds the recurrent matrices transposed, (G, 4, H,
// dh, dh) in the gate order z, i, f, o, batch row b taking group
// b / (B / G); dh 32, 64, 128 or 256 (any other returns
// cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int slstm_scan_bwd_f32(
    const void* rt, const void* c, const void* n, const void* m,
    const void* pz, const void* pi, const void* pf, const void* po,
    const void* dh, void* dzx, void* dix, void* dfx, void* dox, int batch,
    int seq_len, int heads, int dim, int groups, void* stream) {
  if (dim < 32 || dim > kMaxDim || (dim & (dim - 1)) != 0 || groups < 1 ||
      batch % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const auto f = [](const void* x) { return static_cast<const float*>(x); };
  const auto w = [](void* x) { return static_cast<float*>(x); };
  slstm_bwd_kernel<<<batch * heads, kThreads, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      f(rt), f(c), f(n), f(m), f(pz), f(pi), f(pf), f(po), f(dh), w(dzx),
      w(dix), w(dfx), w(dox), seq_len, heads, dim, batch / groups);
  return static_cast<int>(cudaGetLastError());
}
