// What the two sLSTM sources share (csrc/slstm_scan.cu, K10, and
// csrc/slstm_scan_bwd.cu, K10-bwd), for Hopper (sm_90a): the launch plan of
// a head dim, the 4-byte cp.async that stages a tile of steps, the
// mbarriers and st.async stores of a step's exchange across the cluster,
// and the launch of a grid of clusters.
// kernels/xlstm_scan.py slstm_plan mirrors Plan; every launch checks the
// plan the wrapper passes against the kernel's own.  Everything lies in an
// anonymous namespace: each source that includes this header gets its own
// copy.
#pragma once

#include <cooperative_groups.h>
#include <cstdint>
#include <cuda_runtime.h>

namespace cg = cooperative_groups;

namespace {

// The plan of head dim D.  A (b, head) runs on a cluster of kCluster
// blocks, the fewest that hold its four (D, D) f32 matrices at no more
// than 128 KiB a block (8 at D = 256, 2 at 128, 1 at 64 and 32).  Block r
// owns the kCols = D / kCluster columns [r kCols, (r + 1) kCols): the
// forward's outputs, the backward's rows of g_h, and their cell states.
// A thread holds kRows (64, or D below 64) of the block's 4 D kCols
// matrix entries in registers, kLanes = 4 kChunks threads a column, so a
// block has kThreads = kCols kLanes (K10 gives a column kLanes lanes of
// one warp, K10-bwd a lane in each of kThreads / kCols warps).  The step
// inputs are staged kTile steps at a time (kTile kCols = 512).
template <int D>
struct Plan {
  static constexpr int kCluster = D * D / 8192 > 1 ? D * D / 8192 : 1;
  static constexpr int kCols = D / kCluster;
  static constexpr int kRows = D < 64 ? D : 64;
  static constexpr int kChunks = D / kRows;
  static constexpr int kLanes = 4 * kChunks;
  static constexpr int kThreads = kCols * kLanes;
  static constexpr int kTile = 512 / kCols;
  static_assert(kCluster <= 8, "a portable cluster");
  static_assert(32 % kLanes == 0 && kThreads % 32 == 0,
                "whole columns in whole warps");
  static_assert(kLanes >= kCluster,
                "a column's lanes store its value into every block");
};

template <int D>
bool plan_matches(int cluster, int cols, int threads, int tile) {
  using P = Plan<D>;
  return cluster == P::kCluster && cols == P::kCols &&
         threads == P::kThreads && tile == P::kTile;
}

__device__ __forceinline__ void cp_async4(float* dst, const float* src) {
  const unsigned s = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(s),
               "l"(src));
}

__device__ __forceinline__ void cp_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N groups (the newest) are still in flight.
template <int N>
__device__ __forceinline__ void cp_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(
                   smem_u32(bar))
               : "memory");
}

// This block's one arrival at ``bar``'s current phase, which then
// completes when ``bytes`` more have come in by st_async.
__device__ __forceinline__ void mbar_expect(uint64_t* bar, unsigned bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_u32(bar)),
      "r"(bytes)
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

// ``*dst`` of the block of rank ``rank`` = v, counted as sizeof(T) bytes
// in that block's ``*bar`` (dst and bar: this block's addresses).
__device__ __forceinline__ void st_async(float* dst, float v, uint64_t* bar,
                                         int rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.b32 [%0], %1, "
      "[%2];\n" ::"r"(d),
      "r"(__float_as_uint(v)), "r"(b)
      : "memory");
}

__device__ __forceinline__ void st_async(float4* dst, float4 v,
                                         uint64_t* bar, int rank) {
  unsigned d, b;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(d)
               : "r"(smem_u32(dst)), "r"(rank));
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;\n"
               : "=r"(b)
               : "r"(smem_u32(bar)), "r"(rank));
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], "
      "{%1, %2, %3, %4}, [%5];\n" ::"r"(d),
      "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(b)
      : "memory");
}

template <int kCluster>
__device__ __forceinline__ int block_rank() {
  if constexpr (kCluster == 1) return 0;
  else return static_cast<int>(cg::this_cluster().block_rank());
}

// Every thread of the cluster arrives (release) and waits (acquire).
template <int kCluster>
__device__ __forceinline__ void cluster_barrier() {
  if constexpr (kCluster == 1) __syncthreads();
  else cg::this_cluster().sync();
}

template <int D>
cudaLaunchConfig_t cluster_config(int clusters, void* stream,
                                  cudaLaunchAttribute* attr) {
  using P = Plan<D>;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(static_cast<unsigned>(clusters * P::kCluster));
  cfg.blockDim = dim3(static_cast<unsigned>(P::kThreads));
  cfg.dynamicSmemBytes = 0;
  cfg.stream = static_cast<cudaStream_t>(stream);
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = static_cast<unsigned>(P::kCluster);
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// How many clusters of ``kernel`` can be resident on the card at once
// (cudaOccupancyMaxActiveClusters), into *count; the CUDA error code.
template <int D>
int resident_clusters(const void* kernel, int* count) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<D>(1, nullptr, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(count, kernel,
                                                         &cfg));
}

// ``kernel`` on a grid of ``clusters`` clusters of Plan<D>::kCluster
// blocks (cudaLaunchKernelEx).  Refuses, with
// cudaErrorInvalidConfiguration, a cluster that cannot be resident at all,
// checked at the kernel's first launch (``*resident``, the caller's, -1
// until then); more clusters than fit at once run in waves, each on its
// own.
template <int D, typename Kernel, typename... Args>
int launch_clusters(Kernel kernel, int* resident, int clusters,
                    void* stream, Args... args) {
  if (*resident < 0) {
    int count = 0;
    const int rc = resident_clusters<D>((const void*)kernel, &count);
    if (rc) return rc;
    *resident = count;
  }
  if (*resident < 1) return static_cast<int>(cudaErrorInvalidConfiguration);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = cluster_config<D>(clusters, stream, &attr);
  const int rc = static_cast<int>(cudaLaunchKernelEx(&cfg, kernel, args...));
  if (rc) return rc;
  return static_cast<int>(cudaGetLastError());
}

}  // namespace
