// Helpers shared by the thread-block cluster kernels (dwt.cu: K2, K3;
// analysis.cu: K4, K10; scans.cu: S3; lowq.cu: S11): staging rows with
// cp.async, a row pass stored transposed into the peers' shared memory
// (distributed shared memory, DSM), the cluster barrier in halves, and the
// cluster launch with what the card allows for it.
#pragma once

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace nhw {

namespace cg = cooperative_groups;

__device__ __forceinline__ uint32_t pack16(int lo, int hi) {
  return static_cast<uint32_t>(static_cast<uint16_t>(lo)) |
         (static_cast<uint32_t>(static_cast<uint16_t>(hi)) << 16);
}

// One row pass of a cluster kernel, stored transposed through DSM.  The
// calling CTA holds kRows source rows, rows row0 onwards (row0 even) of
// its plane; values(r, k, v0, v1) gives the values of moment k (k < kM)
// of its local row r.  v0 goes to transposed row kStride k and, when
// kSecond > 0, v1 to row kStride k + kSecond, in the column of the source
// row.  Transposed row j lies in the CTA of rank j / kDstRows, at local
// row j % kDstRows of `dst` (pitch kDstPitch int16).  A warp takes
// kRun = 32 / kPairs consecutive k of kPairs neighbouring source row
// pairs: each thread packs the two rows of its pair into one 32-bit word,
// the warp's words for v0 all go to one CTA (and those for v1 to one
// CTA), and with a word pitch times kStride equal to kPairs modulo 32 they
// fall on 32 banks.  The synthesis passes (K2, K3) send pair k to rows 2k
// and 2k + 1 (kStride 2, kSecond 1, kPairs 2: 16 k of two row pairs, odd
// word pitch); the analysis (K4, K10) sends low moment k to row k and high
// moment k to row k + kM (kStride 1, kSecond kM, kPairs 4: 8 k of four
// row pairs, 16-byte rows).
template <int kRows, int kM, int kDstRows, int kDstPitch, int kThreads,
          int kStride, int kSecond, int kPairs, typename Values>
__device__ __forceinline__ void rows_to_peers_t(const cg::cluster_group& cluster,
                                                int row0, int16_t* dst,
                                                Values values) {
  constexpr int kRun = 32 / kPairs;
  static_assert(32 % kPairs == 0 && kM % kRun == 0 && kRows % 2 == 0 &&
                    (kRows / 2) % kPairs == 0 &&
                    (kRows / 2 * kM) % kThreads == 0,
                "kRun k of kPairs row pairs a warp, whole tasks");
  static_assert(kDstPitch % 2 == 0 && (kDstPitch / 2 * kStride) % 32 == kPairs,
                "a warp's 32 words on 32 banks");
  static_assert(kDstRows % (kRun * kStride) == 0 &&
                    (kSecond < kStride || kSecond % kDstRows == 0),
                "a warp's rows in one CTA for each value");
  constexpr int kKBlocks = kM / kRun;
#pragma unroll 2
  for (int it = 0; it < kRows / 2 * kM / kThreads; ++it) {
    const int g = threadIdx.x + it * kThreads;
    const int w = g >> 5;
    const int k = (w % kKBlocks) * kRun + (g & (kRun - 1));
    const int rp = (w / kKBlocks) * kPairs + (g & 31) / kRun;
    int a0, b0, a1, b1;
    values(2 * rp, k, a0, b0);
    values(2 * rp + 1, k, a1, b1);
    const int d0 = kStride * k;
    int16_t* peer = cluster.map_shared_rank(dst, d0 / kDstRows);
    const int at = (d0 % kDstRows) * kDstPitch;
    uint32_t* word = reinterpret_cast<uint32_t*>(peer + at) + row0 / 2 + rp;
    word[0] = pack16(a0, a1);
    if constexpr (kSecond > 0 && kSecond < kStride) {
      // the same CTA, kSecond rows down
      word[kSecond * kDstPitch / 2] = pack16(b0, b1);
    } else if constexpr (kSecond > 0) {
      // the same local row, kSecond / kDstRows ranks on
      int16_t* far = cluster.map_shared_rank(dst, (d0 + kSecond) / kDstRows);
      reinterpret_cast<uint32_t*>(far + at)[row0 / 2 + rp] = pack16(b0, b1);
    }
  }
}

// Issue the 16-byte copies of `rows` rows of kRowLen int16 (global, row
// pitch src_pitch int16) into shared memory (pitch kDstPitch) by kThreads
// threads, without waiting: cp.async, one commit group.
template <int kRowLen, int kDstPitch, int kThreads>
__device__ __forceinline__ void stage_rows_async(int16_t* dst,
                                                 const int16_t* src,
                                                 size_t src_pitch, int rows) {
  constexpr int kVecs = kRowLen / 8;
  for (int i = threadIdx.x; i < rows * kVecs; i += kThreads)
    __pipeline_memcpy_async(dst + (i / kVecs) * kDstPitch + (i % kVecs) * 8,
                            src + (i / kVecs) * src_pitch + (i % kVecs) * 8,
                            16);
  __pipeline_commit();
}

// A cluster barrier in two halves, for every thread of the cluster: an
// arrive with no ordering (e.g. at a kernel's start, so that the wait
// before the first DSM access finds every CTA started), an arrive that
// releases this thread's writes (shared memory and DSM), and the wait that
// acquires the others'.
__device__ __forceinline__ void cluster_arrive_relaxed() {
  asm volatile("barrier.cluster.arrive.relaxed.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_arrive_release() {
  asm volatile("barrier.cluster.arrive.release.aligned;\n" ::: "memory");
}

__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.acquire.aligned;\n" ::: "memory");
}

inline cudaLaunchAttribute cluster_dims(int cluster) {
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = cluster;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  return a;
}

// A cluster kernel's launch shape and what the card allows for it, found
// once per process: registers per thread, shared memory per CTA and the
// most clusters that can be resident at once.
struct ClusterKernel {
  int cluster, threads, dyn_smem;
  cudaError_t err;
  int regs, smem, clusters;
};

template <typename Kernel>
ClusterKernel cluster_setup(Kernel* kernel, int cluster, int threads,
                            int smem) {
  ClusterKernel k{cluster, threads, smem, cudaSuccess, 0, 0, 0};
  const void* fn = reinterpret_cast<const void*>(kernel);
  k.err = cudaFuncSetAttribute(
      fn, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaFuncAttributes attrs;
  if (k.err == cudaSuccess) k.err = cudaFuncGetAttributes(&attrs, fn);
  if (k.err == cudaSuccess) {
    k.regs = attrs.numRegs;
    k.smem = smem + static_cast<int>(attrs.sharedSizeBytes);
    cudaLaunchAttribute dims = cluster_dims(cluster);
    cudaLaunchConfig_t cfg = {};
    cfg.gridDim = dim3(cluster, 1, 1);
    cfg.blockDim = dim3(threads, 1, 1);
    cfg.dynamicSmemBytes = smem;
    cfg.attrs = &dims;
    cfg.numAttrs = 1;
    k.err = cudaOccupancyMaxActiveClusters(&k.clusters, fn, &cfg);
  }
  if (k.err == cudaSuccess && k.clusters < 1)
    k.err = cudaErrorLaunchOutOfResources;
  return k;
}

// What the card allows for `k`, as nhw_cluster_info reports it: info[0]
// registers per thread, info[1] shared memory per CTA (bytes), info[2]
// the most clusters resident at once.
inline int cluster_info(const ClusterKernel& k, void* info) {
  if (k.err != cudaSuccess) return k.err;
  int* out = static_cast<int*>(info);
  out[0] = k.regs;
  out[1] = k.smem;
  out[2] = k.clusters;
  return cudaSuccess;
}

// One cluster per image: grid (cluster, batch).
template <typename Kernel, typename... Args>
cudaError_t launch_cluster(const ClusterKernel& k, Kernel* kernel, int batch,
                           cudaStream_t stream, Args... args) {
  if (k.err != cudaSuccess) return k.err;
  cudaLaunchAttribute dims = cluster_dims(k.cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(k.cluster, batch, 1);
  cfg.blockDim = dim3(k.threads, 1, 1);
  cfg.dynamicSmemBytes = k.dyn_smem;
  cfg.stream = stream;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, args...);
  return e != cudaSuccess ? e : cudaGetLastError();
}

inline bool misaligned(const void* p, uintptr_t to) {
  return reinterpret_cast<uintptr_t>(p) % to != 0;
}

}  // namespace nhw
