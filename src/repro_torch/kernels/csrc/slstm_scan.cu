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
// need the whole h of the step before, and a head's four matrices (1 MB)
// do not fit one SM's shared memory.
//
// The design, simple first (the cluster design that keeps the matrices
// in the shared memory of 8 blocks is later work):
// - one block a (b, head) of kThreads = 1,024 threads;
// - each step reads the head's four matrices whole from L2 (the 4 MB of
//   all heads stay resident there), as many bytes in flight as one SM
//   allows: thread (p, g, q) multiplies rows i of part p (dh / P rows,
//   P = 1,024 / dh parts) of matrix g by h[i] and sums them into the
//   four columns 4q .. 4q+3, reading each row's four as one 16-byte load
//   (a warp reads 512 contiguous bytes a row), h[i] a broadcast from
//   shared memory;
// - the parts' sums meet in shared memory; thread j < dh adds them in
//   part order for column j of each gate and updates the cell state of
//   column j, which it keeps in registers; the step's inputs are read one
//   step ahead into its registers;
// - two barriers a step: the parts' sums, then h (two buffers
//   alternating with the step's parity);
// - sums in a fixed order, no atomics: two calls give the same bits;
// - expf, tanhf, log1pf (not the fast intrinsics).
//
// Training (slstm_scan_states_f32): the same kernel also writes every
// step's cell state c, n, m and the four gates' pre-activations zx + a_z,
// ix + a_i, fx + a_f, ox + a_o (each (B, S, H, dh)), on which the backward
// (slstm_scan_bwd.cu) walks without a recompute, and takes the recurrent
// matrices in G groups (G, H, dh, dh), batch row b taking group
// b / (B / G) (a vmap fold of G clients, each with its own).  The serving
// launch is the template without those stores, on one group.
#include <cuda_runtime.h>

namespace {

constexpr int kThreads = 1024;
constexpr int kMaxDim = 256;  // 1,024 / 4 gates: one (gate, column quad)
                              // a thread at the least

// The seven state outputs of a training launch (c, n, m, and the
// pre-activations of z, i, f, o), passed by value.
struct States {
  float* p[7];
};

// kSave: the training launch, which also writes the states into st.
template <bool kSave>
__global__ void __launch_bounds__(kThreads) slstm_scan_kernel(
    const float* __restrict__ zx, const float* __restrict__ ix,
    const float* __restrict__ fx, const float* __restrict__ ox,
    const float* __restrict__ rz, const float* __restrict__ ri,
    const float* __restrict__ rf, const float* __restrict__ ro,
    float* __restrict__ h, States st, int seq_len,
    int heads, int dim, int rows_per_group) {
  __shared__ float hs[2][kMaxDim];
  __shared__ __align__(16) float partial[kThreads * 4];  // [p][g][dim]
  const int b = blockIdx.x / heads, head = blockIdx.x % heads;
  const int tid = threadIdx.x;
  // the products: thread (p, g, q)
  const int quads = dim / 4;
  const int q = tid % quads, g = (tid / quads) % 4, p = tid / dim;
  const int rows = dim * dim / kThreads;  // rows a part
  const float* mat = g == 0 ? rz : g == 1 ? ri : g == 2 ? rf : ro;
  const long long grp = b / rows_per_group;
  const float4* __restrict__ col = reinterpret_cast<const float4*>(
      mat + ((grp * heads + head) * dim + (long long)p * rows) * dim) + q;
  float4* out4 = reinterpret_cast<float4*>(partial) + tid;
  // the cell: thread j < dim, column j
  const int j = tid;
  const bool cell = j < dim;
  const long long row0 = ((long long)b * seq_len * heads + head) * dim + j;
  const long long stride = (long long)heads * dim;

  float c = 0.0f, n = 0.0f, m = -1e30f;
  float nz = 0.0f, ni = 0.0f, nf = 0.0f, no = 0.0f;
  if (cell) {
    hs[0][j] = 0.0f;
    nz = zx[row0];
    ni = ix[row0];
    nf = fx[row0];
    no = ox[row0];
  }
  __syncthreads();
  for (int t = 0; t < seq_len; ++t) {
    const float* hp = hs[t & 1] + p * rows;
    float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
#pragma unroll 8
    for (int i = 0; i < rows; ++i) {
      const float hi = hp[i];
      const float4 r = __ldg(col + (long long)i * quads);
      acc.x += hi * r.x;
      acc.y += hi * r.y;
      acc.z += hi * r.z;
      acc.w += hi * r.w;
    }
    *out4 = acc;
    __syncthreads();
    if (cell) {
      const long long at = row0 + t * stride;
      const float xz = nz, xi = ni, xf = nf, xo = no;
      if (t + 1 < seq_len) {
        nz = zx[at + stride];
        ni = ix[at + stride];
        nf = fx[at + stride];
        no = ox[at + stride];
      }
      float a[4];
#pragma unroll
      for (int gate = 0; gate < 4; ++gate) {
        float sum = 0.0f;
        for (int part = 0; part < kThreads / dim; ++part)
          sum += partial[(part * 4 + gate) * dim + j];
        a[gate] = sum;
      }
      const float pz = xz + a[0], po = xo + a[3];
      const float z = tanhf(pz);
      const float i_raw = xi + a[1];
      const float f_raw = xf + a[2];
      const float o_t = 1.0f / (1.0f + expf(-po));
      const float log_f = fminf(f_raw, 0.0f) - log1pf(expf(-fabsf(f_raw)));
      const float m_new = fmaxf(log_f + m, i_raw);
      const float ip = expf(i_raw - m_new);
      const float fp = expf(log_f + m - m_new);
      m = m_new;
      c = fp * c + ip * z;
      n = fp * n + ip;
      const float hv = o_t * c / fmaxf(n, 1e-6f);
      h[at] = hv;
      hs[(t + 1) & 1][j] = hv;
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
    __syncthreads();
  }
}

template <bool kSave>
int launch(const void* zx, const void* ix, const void* fx, const void* ox,
           const void* rz, const void* ri, const void* rf, const void* ro,
           void* h, States st, int batch, int seq_len, int heads,
           int dim, int groups, void* stream) {
  if (dim < 32 || dim > kMaxDim || (dim & (dim - 1)) != 0 || groups < 1 ||
      batch % groups != 0)
    return static_cast<int>(cudaErrorInvalidValue);
  slstm_scan_kernel<kSave><<<batch * heads, kThreads, 0,
                             static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float*>(zx), static_cast<const float*>(ix),
      static_cast<const float*>(fx), static_cast<const float*>(ox),
      static_cast<const float*>(rz), static_cast<const float*>(ri),
      static_cast<const float*>(rf), static_cast<const float*>(ro),
      static_cast<float*>(h), st, seq_len, heads, dim, batch / groups);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

// h (B, S, H, dh) of the scan; dh 32, 64, 128 or 256 (any other returns
// cudaErrorInvalidValue; the wrapper refuses it first).
extern "C" int slstm_scan_f32(const void* zx, const void* ix, const void* fx,
                              const void* ox, const void* rz, const void* ri,
                              const void* rf, const void* ro, void* h,
                              int batch, int seq_len, int heads, int dim,
                              void* stream) {
  return launch<false>(zx, ix, fx, ox, rz, ri, rf, ro, h, States{}, batch,
                       seq_len, heads, dim, 1, stream);
}

// The training launch: h and every step's c, n, m, zx + a_z, ix + a_i,
// fx + a_f, ox + a_o (each (B, S, H, dh)); the r's in ``groups`` groups
// (G, H, dh, dh), batch row b taking group b / (B / G).
extern "C" int slstm_scan_states_f32(
    const void* zx, const void* ix, const void* fx, const void* ox,
    const void* rz, const void* ri, const void* rf, const void* ro, void* h,
    void* c, void* n, void* m, void* pz, void* pi, void* pf, void* po,
    int batch, int seq_len, int heads, int dim, int groups, void* stream) {
  const States st{{static_cast<float*>(c), static_cast<float*>(n),
                   static_cast<float*>(m), static_cast<float*>(pz),
                   static_cast<float*>(pi), static_cast<float*>(pf),
                   static_cast<float*>(po)}};
  return launch<true>(zx, ix, fx, ox, rz, ri, rf, ro, h, st, batch, seq_len,
                      heads, dim, groups, stream);
}
