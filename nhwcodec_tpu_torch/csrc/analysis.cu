// K4 nhw_analysis_level_jp and K10 nhw_analysis_level: one 5/3 analysis
// level of the encoder, hand-written for Hopper (sm_90a).  Plain C
// interface, bound with ctypes by nhwcodec_tpu_torch/kernels/build.py;
// wrappers and torch twins in nhwcodec_tpu_torch/ops/dwt.py
// (analysis_level_jp / analysis_level_jp_ref, analysis_level /
// analysis_level_ref).
//
// K4 replaces nhwcodec_tpu/ops/pallas_dwt.py analysis_level_pallas_jp
// (_analysis_level_jp_kernel): (B, n, n) int16, n in {128, 256, 512} ->
//   j = the raw IV row pass (downfilter53IV) stored transposed,
//   p = row k of j filtered by VI (downfilter53VI, the error-feedback
//       dither, /64 and /8) for k < n/2 and by plain 53 (/16 and /2)
//       otherwise, stored as [low | high]
// (encoder/filters.c:55-386; no LL transpose-back, which stays with the
// callers of the exact encode front).
//
// K10 replaces nhwcodec_tpu/ops/pallas_dwt.py analysis_level_pallas
// (_analysis_level_kernel), the level of the transform entry
// (models/transform.encode_transform_pallas): K4's p with its LL quadrant
// transposed back, out = p except out[:n/2, :n/2] = p[:n/2, :n/2]^T, and
// no j output.  out may be x itself: the transform's second level runs in
// place on the LL corner of the level-1 plane (the port's form of
// l1.at[:D, :D].set(l2), nhwcodec_tpu/models/transform.py:180-182).  The
// TPU kernel's m = 64 duplicate-filter-and-select branch is a Mosaic
// workaround and has no counterpart here.
//
// Bound.  About 30 int32 operations per element on 6 bytes moved (K4: x
// read once, j and p written once) or 4 (K10): the operations bound both
// at the int32 issue rate (chip_smoke.py computes both for each call).
//
// Design: each call is one launch on thread-block clusters, one cluster
// per plane, with j in the cluster's distributed shared memory (DSM), as
// K2 in dwt.cu (the helpers are in cluster.cuh).  A 512x512 int16 plane
// is 512 KiB; a cluster of 8 CTAs holds it as 64 rows of j each.  The
// cluster sizes (kShapes) keep more CTAs than SMs at the encode path's
// batches: (16, 512), (16, 256) and (32, 256) planes of n in clusters of
// 8, (32, 128) in clusters of 4.  CTA c owns rows [cR, (c+1)R) of j (R =
// n / cluster), 16-byte aligned in shared memory with a word pitch of 4
// modulo 32.  Four phases:
//   1. Row pass.  CTA c stages its R rows of x by quarters through two
//      cp.async buffers, each quarter's pass overlapping the next one's
//      copies, and computes each row's raw IV moments; rows_to_peers_t
//      stores low moment k of row r into column r of row k of j and high
//      moment k into row k + n/2, straight into the CTA that owns the row:
//      a warp takes 8 consecutive k of 8 neighbouring rows, packs two
//      rows into a 32-bit store, and its 32 stores fall on 32 banks, 16
//      contiguous bytes to each of 8 rows of one CTA.  A cluster.sync()
//      ends the phase: every row of j is complete, and every read of x
//      is done (the last quarter waits with __pipeline_wait_prior(0)), so
//      from here on the cluster may write the plane it read.
//   2. Column pass.  One warp per row k of j, a lane per 32nd pair t: VI
//      for k < n/2, plain 53 otherwise.  R divides n/2, so the switch
//      falls on a CTA edge and the branch is uniform per CTA.  The
//      previous slot's dither and the previous pair's parity are
//      recomputed from the row, not carried, so the lanes are
//      independent; the last pair takes its edge terms; each value wraps
//      to int16 where the C code stores to short.  The warp keeps the
//      row's results in registers and writes them over the row.
//   3. K4: row k of j leaves before the pass and row k of p after it, as
//      16-byte stores: x is read once and j and p written once.
//   4. K10: the rows k >= n/2 and the high halves of the VI rows leave as
//      16-byte stores.  The low half of VI row k is the LL transpose-back:
//      element t goes to out[t][k].  A second rows_to_peers_t sends it
//      into row t of the CTA that owns out row t (the staging buffers,
//      free since phase 1), then a cluster.sync() and 16-byte stores of
//      the LL rows.  No j output and no scratch plane: x read once, out
//      written once.
// One cluster covers a whole plane, and no global store precedes the end
// of phase 1, so K10 runs in place.  Every array takes a plane and a row
// stride (multiples of 8 elements, 16-byte aligned bases), so the requant
// tail (requant.cu) runs K4 from its 256-stride scratch into the LL
// corners of its 512-stride planes.  The shared memory stays near 100 KB
// at n = 512 (about 25 and 13 KB below) and the registers at 64 a thread,
// so two CTAs fit an SM.  Each entry point sets the shared memory limit
// and asks cudaOccupancyMaxActiveClusters once per n; if no cluster fits
// it returns cudaErrorLaunchOutOfResources, and nothing falls back to
// other launches.
//
// Exactness: int32 arithmetic with the int16 wrap at each C store, the
// sign-symmetric rounding written as the C pattern (not a shift of a
// negative), an arithmetic shift that does not rely on
// implementation-defined >>, and the last pair's edge terms.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"
#include "lifting.cuh"

namespace {

namespace cg = cooperative_groups;

// The launch shape for each n: {n, CTAs a cluster, threads a CTA}.  The
// numpy emulation of the kernel's maps (tests/test_torch_analysis_cluster.py)
// reads this table.
constexpr int kShapes[3][3] = {{512, 8, 512}, {256, 8, 256}, {128, 4, 256}};

constexpr int shape_of(int n, int i) {
  return n == kShapes[0][0] ? kShapes[0][i]
         : n == kShapes[1][0] ? kShapes[1][i] : kShapes[2][i];
}

template <int kN>
struct Layout {
  static constexpr int kM = kN / 2;
  static constexpr int kCluster = shape_of(kN, 1);
  static constexpr int kThreads = shape_of(kN, 2);
  static constexpr int kRows = kN / kCluster;   // rows of j and of x a CTA
  static constexpr int kQuarter = kRows / 4;    // rows of x staged at a time
  static constexpr int kPitch = kN + 8;         // int16: word pitch 4 mod 32
  static constexpr int kLLPitch = kM + 8;       // the same
  static constexpr int kStage = 2 * kQuarter * kPitch;
  static constexpr int kRecv = kRows * kLLPitch;   // K10's received LL rows
  static constexpr int kSmem =
      2 * (kRows * kPitch + (kStage > kRecv ? kStage : kRecv));
  static constexpr int kWarpRows = kRows * 32 / kThreads;
  static_assert(shape_of(kN, 0) == kN && kM % kRows == 0 && kM % 32 == 0 &&
                    kWarpRows * kThreads == kRows * 32,
                "a known n, the VI/53 switch on a CTA edge, whole warps");
};

// Un-normalised lowpass moment k of a row of length 2m
// (encoder/filters.c:367-384).
__device__ __forceinline__ int low_raw(const int16_t* X, int m, int k) {
  const int e = 2 * k;
  if (k == 0) return 6 * X[0] + 4 * X[1] - 2 * X[2];
  const int right = k == m - 1 ? X[e] : X[e + 2];
  return 6 * X[e] + 2 * (X[e - 1] + X[e + 1]) - (X[e - 2] + right);
}

// Parity-adjusted highpass moment k < m-1 (encoder/filters.c:62-81):
// a = X[2k] + X[2k+2] gains 1 at odd k when it and the previous pair's
// sum are both odd.
__device__ __forceinline__ int high_adj(const int16_t* X, int k) {
  const int e = 2 * k;
  const int a = X[e] + X[e + 2];
  const int prev_odd = k > 0 ? ((X[e - 2] + X[e]) & 1) : 0;
  return X[e + 1] - nhw::asr(a + ((a & 1) & prev_odd & (k & 1)), 1);
}

// C pattern r >= 0 ? (r + add) >> s : -((-r + add) >> s); both shifted
// operands are non-negative.
__device__ __forceinline__ int round_pos(int r, int add, int s) {
  return r >= 0 ? (r + add) >> s : -((add - r) >> s);
}

// Error-feedback dither (encoder/filters.c:155-156).
__device__ __forceinline__ int dither(int r) {
  const int rm = (r < 0 ? -r : r) & 63;
  const int mag = rm < 32 ? rm >> 2 : -((64 - rm) >> 2);
  return r >= 0 ? mag : -mag;
}

// The column pass of one row of j (length 2 kM, shared memory) for the
// lane's pairs t = lane + 32 s: VI (kVI) or plain 53, lo[s] and hi[s]
// before the int16 wrap.
template <int kM, bool kVI>
__device__ __forceinline__ void column_pass(const int16_t* row, int lane,
                                            int (&lo)[kM / 32],
                                            int (&hi)[kM / 32]) {
  const int edge = row[2 * kM - 1] - row[2 * kM - 2];
#pragma unroll
  for (int s = 0; s < kM / 32; ++s) {
    const int t = lane + 32 * s;
    const int raw = low_raw(row, kM, t);
    if (kVI) {   // /64 low after the previous slot's dither, /8 high
      const int d_prev = t > 0 ? dither(low_raw(row, kM, t - 1)) : 0;
      lo[s] = round_pos(nhw::wrap16(raw + d_prev), 32, 6);
      hi[s] = t < kM - 1 ? round_pos(high_adj(row, t), 4, 3)
                         : nhw::asr(nhw::wrap16(edge), 3);
    } else {     // /16 low, /2 high with positive-biased rounding
      lo[s] = round_pos(raw, 8, 4);
      if (t < kM - 1) {
        const int h = high_adj(row, t);
        hi[s] = h > 0 ? (h + 1) >> 1 : nhw::asr(h, 1);
      } else {
        hi[s] = nhw::asr(edge + 1, 1);
      }
    }
  }
}

// kLen int16 from shared src to global dst by one warp, 16 bytes a lane.
template <int kLen>
__device__ __forceinline__ void store_row(int16_t* dst, const int16_t* src,
                                          int lane) {
  static_assert(kLen % 8 == 0, "whole 16-byte vectors");
#pragma unroll
  for (int i = lane; i < kLen / 8; i += 32)
    reinterpret_cast<uint4*>(dst)[i] = reinterpret_cast<const uint4*>(src)[i];
}

// One analysis level of plane blockIdx.y: grid (cluster, B), clusters of
// Layout<kN>::kCluster CTAs.  K4 (kLLBack false) writes j and p; K10 writes
// out (passed as p, j unused), which may be x.
template <int kN, bool kLLBack>
__global__ void __launch_bounds__(Layout<kN>::kThreads, 2)
analysis_cluster(const int16_t* x, size_t x_plane, int x_row, int16_t* j,
                 size_t j_plane, int j_row, int16_t* p, size_t p_plane,
                 int p_row) {
  using L = Layout<kN>;
  constexpr int kM = L::kM;
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* js = reinterpret_cast<int16_t*>(smem);   // the CTA's rows of j
  int16_t* in = js + L::kRows * L::kPitch;   // quarter buffers; K10's LL rows
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.y;
  const int16_t* src =
      x + b * x_plane + static_cast<size_t>(L::kRows) * c * x_row;

  // 1. the raw IV row pass over the CTA's rows of x, quarter by quarter,
  // stored transposed into the owners of the rows of j
  for (int q = 0; q < 2; ++q)
    nhw::stage_rows_async<kN, L::kPitch, L::kThreads>(
        in + q * L::kQuarter * L::kPitch,
        src + static_cast<size_t>(q) * L::kQuarter * x_row, x_row,
        L::kQuarter);
  cluster.sync();   // every peer runs before anyone writes to it
  for (int q = 0; q < 4; ++q) {
    if (q < 3) __pipeline_wait_prior(1); else __pipeline_wait_prior(0);
    __syncthreads();   // quarter q is in, from every thread's copies
    const int16_t* buf = in + (q & 1) * L::kQuarter * L::kPitch;
    nhw::rows_to_peers_t<L::kQuarter, kM, L::kRows, L::kPitch, L::kThreads, 1,
                         kM, 4>(
        cluster, L::kRows * c + L::kQuarter * q, js,
        [&](int r, int k, int& lo, int& hi) {
          const int16_t* row = buf + r * L::kPitch;
          lo = low_raw(row, kM, k);
          hi = k < kM - 1 ? 2 * row[2 * k + 1] - (row[2 * k] + row[2 * k + 2])
                          : 2 * (row[kN - 1] - row[kN - 2]);
        });
    __syncthreads();   // every read of the buffer before it is refilled
    if (q < 2)
      nhw::stage_rows_async<kN, L::kPitch, L::kThreads>(
          in + (q & 1) * L::kQuarter * L::kPitch,
          src + static_cast<size_t>(q + 2) * L::kQuarter * x_row, x_row,
          L::kQuarter);
  }
  cluster.sync();   // j is complete, and no CTA reads x any more

  // 2-3. one warp per row k of j: K4 stores it, then the column pass
  // replaces it by row k of p, which leaves (K10: all of it below the VI
  // rows, the high half of a VI row)
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const bool vi = c < L::kCluster / 2;   // rows k < kM
  for (int i = 0; i < L::kWarpRows; ++i) {
    const int lr = warp * L::kWarpRows + i;
    const size_t k = static_cast<size_t>(L::kRows) * c + lr;
    int16_t* row = js + lr * L::kPitch;
    if constexpr (!kLLBack)
      store_row<kN>(j + b * j_plane + k * j_row, row, lane);
    int lo[kM / 32], hi[kM / 32];
    if (vi)
      column_pass<kM, true>(row, lane, lo, hi);
    else
      column_pass<kM, false>(row, lane, lo, hi);
    __syncwarp();   // every read of the row before it is overwritten
#pragma unroll
    for (int s = 0; s < kM / 32; ++s) {
      row[lane + 32 * s] = static_cast<int16_t>(nhw::wrap16(lo[s]));
      row[kM + lane + 32 * s] = static_cast<int16_t>(nhw::wrap16(hi[s]));
    }
    __syncwarp();
    int16_t* dst = p + b * p_plane + k * p_row;
    if (kLLBack && vi)
      store_row<kM>(dst + kM, row + kM, lane);
    else
      store_row<kN>(dst, row, lane);
  }

  if constexpr (kLLBack) {
    // 4. the LL transpose-back: element t of VI row k to column k of row t
    // in the CTA that owns out row t, then the LL rows leave
    __syncthreads();   // every row of p is in js
    if (vi)
      nhw::rows_to_peers_t<L::kRows, kM, L::kRows, L::kLLPitch, L::kThreads,
                           1, 0, 4>(
          cluster, L::kRows * c, in, [&](int r, int t, int& v, int& none) {
            v = js[r * L::kPitch + t];
            none = 0;
          });
    cluster.sync();   // every LL row is in; the last access to any peer
    if (vi)
      for (int i = 0; i < L::kWarpRows; ++i) {
        const int lr = warp * L::kWarpRows + i;
        store_row<kM>(
            p + b * p_plane + (static_cast<size_t>(L::kRows) * c + lr) * p_row,
            in + lr * L::kLLPitch, lane);
      }
  }
}

template <int kN, bool kLLBack>
const nhw::ClusterKernel& level_kernel() {
  static const nhw::ClusterKernel k = nhw::cluster_setup(
      analysis_cluster<kN, kLLBack>, Layout<kN>::kCluster,
      Layout<kN>::kThreads, Layout<kN>::kSmem);
  return k;
}

template <bool kLLBack>
const nhw::ClusterKernel& level_kernel_n(int n) {
  return n == 512   ? level_kernel<512, kLLBack>()
         : n == 256 ? level_kernel<256, kLLBack>()
                    : level_kernel<128, kLLBack>();
}

template <bool kLLBack>
cudaError_t launch_level(int n, int batch, void* stream, const void* x,
                         int x_plane, int x_row, void* j, int j_plane,
                         int j_row, void* p, int p_plane, int p_row) {
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xs = static_cast<const int16_t*>(x);
  auto* js = static_cast<int16_t*>(j);
  auto* ps = static_cast<int16_t*>(p);
  const size_t xp = x_plane, jp = j_plane, pp = p_plane;
  if (n == 512)
    return nhw::launch_cluster(level_kernel<512, kLLBack>(),
                               analysis_cluster<512, kLLBack>, batch, s, xs,
                               xp, x_row, js, jp, j_row, ps, pp, p_row);
  if (n == 256)
    return nhw::launch_cluster(level_kernel<256, kLLBack>(),
                               analysis_cluster<256, kLLBack>, batch, s, xs,
                               xp, x_row, js, jp, j_row, ps, pp, p_row);
  return nhw::launch_cluster(level_kernel<128, kLLBack>(),
                             analysis_cluster<128, kLLBack>, batch, s, xs, xp,
                             x_row, js, jp, j_row, ps, pp, p_row);
}

bool bad_args(int n, int batch) {
  return (n != 128 && n != 256 && n != 512) || batch < 1 || batch > 65535;
}

// 16-byte copies need a 16-byte base and strides of whole 16-byte vectors.
bool unaligned(const void* ptr, int plane, int row, int batch) {
  return nhw::misaligned(ptr, 16) || row % 8 != 0 ||
         (batch > 1 && plane % 8 != 0);
}

}  // namespace

extern "C" {

// K4.  x, j, p: (B, n, n) int16, each with its plane and row strides
// (elements, multiples of 8; 16-byte aligned bases); n in {128, 256,
// 512}.  x must not overlap j or p.
int nhw_analysis_level_jp(const void* x, int x_plane, int x_row, void* j,
                          int j_plane, int j_row, void* p, int p_plane,
                          int p_row, int batch, int n, void* stream) {
  if (bad_args(n, batch)) return cudaErrorInvalidValue;
  if (unaligned(x, x_plane, x_row, batch) ||
      unaligned(j, j_plane, j_row, batch) ||
      unaligned(p, p_plane, p_row, batch))
    return cudaErrorMisalignedAddress;
  return launch_level<false>(n, batch, stream, x, x_plane, x_row, j, j_plane,
                             j_row, p, p_plane, p_row);
}

// K10.  x, out: (B, n, n) int16 with their plane and row strides
// (elements, multiples of 8; 16-byte aligned bases); n in {128, 256,
// 512}.  out may be x itself (in place), or else must not overlap it.
int nhw_analysis_level(const void* x, int x_plane, int x_row, void* out,
                       int out_plane, int out_row, int batch, int n,
                       void* stream) {
  if (bad_args(n, batch)) return cudaErrorInvalidValue;
  if (unaligned(x, x_plane, x_row, batch) ||
      unaligned(out, out_plane, out_row, batch))
    return cudaErrorMisalignedAddress;
  return launch_level<true>(n, batch, stream, x, x_plane, x_row, nullptr, 0,
                            0, out, out_plane, out_row);
}

// What the card allows for K4 (kernel 0-2) and K10 (3-5) at n = 512, 256,
// 128 (nhw_cluster_info, dwt.cu, reports it).
int nhw_analysis_cluster_info(int kernel, void* info) {
  if (kernel < 0 || kernel > 5) return cudaErrorInvalidValue;
  const int n = 512 >> (kernel % 3);
  return nhw::cluster_info(
      kernel < 3 ? level_kernel_n<false>(n) : level_kernel_n<true>(n), info);
}

}  // extern "C"
