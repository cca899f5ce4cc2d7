// Hand-written Hopper (sm_90a) kernel of the device encode scans' chroma
// steps.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrapper and torch twin in
// nhwcodec_tpu_torch/models/device_scans.py (uv_sentinel_marking_device /
// uv_sentinel_marking_ref).
//
// S9 nhw_uv_sentinel replaces nhwcodec_tpu/models/device_scans.py:1327
//    uv_sentinel_marking_device (a 128-step lax.scan over rows, each row an
//    associative scan of the skip walk, _uvsm_row :1263): the band
//    sentinels 12400/12600/12900/13000 of encode_uv on a (B, 256, 256) int16
//    plane, against rf_ext (B, rf_len) int16, res256 and its tail.  One
//    launch.
//
// The reference's count register walks rf_ext with the raster: it advances
// by 2 where a pair is placed and by 1 elsewhere, and scan resets to each
// row's start, so a pair placed at a row's last lane (127) moves every later
// row's window by one (a drift).  Within a row every read is an initial
// value but one: lane 127's d1 reads plane column 128, which is band 0's
// slot of lane 0 of the same row.  Which lanes the walk visits is the run
// parity of the placed pairs (a placed pair skips the next lane).
//
// The bound is bytes: the plane read once and written once, rf_ext read
// once, some 40 operations a lane.  The only carry between rows is row r's
// window start, 128 r + D_r, where D_r counts the drifts of rows 0..r - 1.
// So a cluster of kUvCtas CTAs an image, a warp a row (lane l on positions
// 4 l..4 l + 3), walks every row at once from a guessed D_r, in two
// levels.  Within a CTA, the rows walk from the CTA's entry count (the
// drifts of the CTAs above as known, 0 at first) plus the drifts of its
// rows above, and the warps whose D_r moved walk again until none moves
// (block barriers only; after t passes its first t rows are exact for that
// entry).  Then the CTAs swap their drift masks (16 bits a CTA) through DSM
// before one cluster.sync() a round, and each takes its entry count from
// the masks below it; the rounds end when the masks stand (the same vote in
// every CTA, since each holds them all).  After s rounds CTAs 0..s - 1 are
// exact, so kUvCtas + 1 rounds at most, and the round that moves nothing
// gives the serial result: a chain of drifts costs a block barrier a row
// and a cluster barrier a CTA.  A CTA stages its 16 rows' plane reads
// (rows r and 128 + r) with cp.async and the rf_ext window its rows can
// reach, [2048 c, 2048 c + 2177), once; a row's walk is then shared memory
// and shuffles: the lanes decide, the run parity of the placed pairs
// (block_scan.cuh's run_parity_lanes4) gives the visited lanes, lane 127
// decides again against the value lane 0 left in column 128.  The warps
// keep their rows' band values in registers and write them once, with the
// LL quadrant's copy, after the last round.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using nhw::iabs;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kD = 256;
constexpr int kPlane = kD * kD;
constexpr int kLanes = 128;           // a row's positions
constexpr int kRfMin = 16384 + 130 + 127;  // res256, a row's 130 reads, drift
constexpr int kUvCtas = 8;                  // a cluster an image
constexpr int kUvRows = kLanes / kUvCtas;   // rows a CTA, a warp each
constexpr int kUvThreads = 32 * kUvRows;
// a CTA's rf_ext window: row k's reads start at 128 k + D_r < 2048 (D_r <=
// 127) and run over 129 values
constexpr int kUvWin = kUvRows * kLanes + kLanes + 1;
constexpr int kUvVecs = kD / 8;             // 16-byte vectors a plane row
constexpr int kUvRounds = kUvCtas + 1;

// One lane's decision (encoder/nhw_encoder.c:2372-2424) on its two
// differences d0, d1, where it has a free band slot or not: the code it
// writes if visited (a 12400/12600 pair where it finds a free slot, else
// the single sentinel 12900/13000, 0 for none) and whether that is a
// placed pair (the walk then skips a lane).  The range tests are unsigned
// compares, so the decision is selects, no branch.
struct Decision {
  int code;
  bool placed;
};

__device__ __forceinline__ Decision decide(int d0, int d1, bool free,
                                           int res_uv) {
  const bool pos = (unsigned(d0 - 4) <= 2u) & (unsigned(d1 - 3) <= 3u);
  const bool neg = (unsigned(d0 + 6) <= 2u) & (unsigned(d1 + 7) <= 4u);
  const bool placed = (pos | neg) & free;
  const int single = iabs(d0) <= res_uv            ? 0
                     : d0 > 0                      ? 12900
                     : (d0 == -5) & (d1 >= 0)      ? 0
                                                   : 13000;
  return {placed ? (pos ? 12400 : 12600) : single, placed};
}

// What a CTA holds: its rows' plane reads (rows r, then rows 128 + r), its
// rf_ext window, each warp's drift (a byte) and the cluster's drift masks
// (a 16-bit mask a CTA, DSM, by the round's parity).
struct UvStage {
  int16_t p[2 * kUvRows * kD];
  int16_t rf[kUvWin];
  alignas(16) uint8_t drift[kUvRows];
  uint16_t masks[2][kUvCtas];
};

// The CTA's drift bytes (0 or 1) as a 16-bit mask: each word's four bytes
// gathered into a nibble by one multiply.
__device__ __forceinline__ unsigned drift_mask(const uint8_t* drift) {
  const uint4 w = *reinterpret_cast<const uint4*>(drift);
  const uint32_t q[4] = {w.x, w.y, w.z, w.w};
  unsigned m = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) m |= ((q[i] * 0x01020408u) >> 24) << (4 * i);
  return m;
}

// A lane's values of its row: the plane's reads (x: columns 4 l..4 l + 4,
// b0..b2: the band slots of its 4 positions, slot: the first free one, 3
// for none) and, after a walk, its band values.
struct UvLane {
  int x[5], b0[4], b1[4], b2[4], slot[4];
  int w0[4], w1[4], w2[4];
};

// Row k of the CTA from window offset at (128 k + D_r): the lane's band
// values into v; returns the row's drift (lane 127 visited and placed).
// Lane 0 is always visited, so the value it leaves in column 128, which
// lane 127 decides again against, is known with the decisions, and lane
// 127's second decision runs beside the run parity.
__device__ __forceinline__ bool uv_row(const int16_t* rf, int at, int lane,
                                       int res_uv, UvLane& v) {
  int rr[5];
#pragma unroll
  for (int i = 0; i < 5; ++i) rr[i] = rf[at + 4 * lane + i];
  Decision d[4];
  unsigned placed = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    d[i] = decide(v.x[i] - rr[i], v.x[i + 1] - rr[i + 1], v.slot[i] < 3,
                  res_uv);
    placed |= unsigned(d[i].placed) << i;
  }
  const int w00 = d[0].code && v.slot[0] == 0 ? d[0].code : v.b0[0];
  const int col128 = __shfl_sync(kFull, w00, 0);
  const Decision d3 = decide(v.x[3] - rr[3], col128 - rr[4], v.slot[3] < 3,
                             res_uv);
  if (lane == 31) d[3] = d3;
  const unsigned fired = nhw::run_parity_lanes4(placed, lane);
  const unsigned before = __shfl_up_sync(kFull, fired >> 3, 1) & 1u;
  const unsigned prev = ((fired << 1) | (lane ? before : 0u)) & 0xFu;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const bool fire = !((prev >> i) & 1u) && d[i].code;
    v.w0[i] = fire && v.slot[i] == 0 ? d[i].code : v.b0[i];
    v.w1[i] = fire && v.slot[i] == 1 ? d[i].code : v.b1[i];
    v.w2[i] = fire && v.slot[i] == 2 ? d[i].code : v.b2[i];
  }
  return __shfl_sync(kFull, !((prev >> 3) & 1u) && d[3].placed, 31);
}

__device__ __forceinline__ int2 pack4(const int* v) {
  return make_int2(static_cast<int>(nhw::pack16(v[0], v[1])),
                   static_cast<int>(nhw::pack16(v[2], v[3])));
}

__global__ void __launch_bounds__(kUvThreads)
    uv_sentinel_rows(const int16_t* __restrict__ process,
                     const int16_t* __restrict__ rf_ext,
                     int16_t* __restrict__ out, int rf_len, int res_uv) {
  __shared__ __align__(16) UvStage st;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, k = t >> 5;
  const int r0 = rank * kUvRows, r = r0 + k;   // the warp's row
  const size_t img = static_cast<size_t>(blockIdx.y) * kPlane;
  for (int i = t; i < 2 * kUvRows * kUvVecs; i += kUvThreads) {
    const int row = i / kUvVecs, c = (i % kUvVecs) * 8;
    const int src = row < kUvRows ? r0 + row : kLanes + r0 + row - kUvRows;
    __pipeline_memcpy_async(st.p + row * kD + c, process + img + src * kD + c,
                            16);
  }
  __pipeline_commit();
  const int16_t* rf = rf_ext + static_cast<size_t>(blockIdx.y) * rf_len +
                      r0 * kLanes;
#pragma unroll
  for (int u = 0; u < (kUvWin + kUvThreads - 1) / kUvThreads; ++u) {
    const int i = t + u * kUvThreads;
    if (i < kUvWin) st.rf[i] = rf[i];
  }
  __pipeline_wait_prior(0);
  cluster.sync();        // staged, every peer started
  UvLane v;
  const int16_t* top = st.p + k * kD;
  const int16_t* bot = st.p + (kUvRows + k) * kD;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int j = 4 * lane + i;
    v.x[i] = top[j];
    v.b0[i] = top[kLanes + j];
    v.b1[i] = bot[j];
    v.b2[i] = bot[kLanes + j];
    v.slot[i] = iabs(v.b0[i]) < 8   ? 0
                : iabs(v.b1[i]) < 8 ? 1
                : iabs(v.b2[i]) < 8 ? 2
                                    : 3;
  }
  // lane 127's d1 reads column 128's initial value
  const int right = __shfl_down_sync(kFull, v.x[0], 1);
  v.x[4] = lane == 31 ? top[kLanes] : right;
  int drifts = 0;        // D_r, the drifts of the rows above as guessed
  bool drift = uv_row(st.rf, k * kLanes, lane, res_uv, v);
  int entry = 0;         // the drifts of the CTAs above as known
  uint32_t seen[4] = {0u, 0u, 0u, 0u};   // the masks the entry came from
  for (int s = 0; s < kUvRounds; ++s) {
    // the CTA's rows consistent with its entry
    unsigned m;
    for (int pass = 0; pass <= kUvRows; ++pass) {
      if (lane == 0) st.drift[k] = drift;
      __syncthreads();
      m = drift_mask(st.drift);
      const int n = entry + __popc(m & ((1u << k) - 1u));
      const bool moved = n != drifts;
      if (moved) {
        drifts = n;
        drift = uv_row(st.rf, k * kLanes + drifts, lane, res_uv, v);
      }
      if (!__syncthreads_or(moved)) break;
    }
    const int par = s & 1;
    if (t < kUvCtas)
      *cluster.map_shared_rank(&st.masks[par][rank], t) =
          static_cast<uint16_t>(m);
    cluster.sync();
    uint32_t bits[4];
    bool same = true;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      bits[q] = uint32_t(st.masks[par][2 * q]) |
                (uint32_t(st.masks[par][2 * q + 1]) << 16);
      // row 127's drift moves no window
      const uint32_t live = q == 3 ? 0x7FFFFFFFu : kFull;
      same &= ((bits[q] ^ seen[q]) & live) == 0u;
      seen[q] = bits[q];
    }
    if (same) break;
    entry = 0;
#pragma unroll
    for (int c = 0; c < kUvCtas; ++c)
      entry += c < rank ? __popc(st.masks[par][c]) : 0;
  }
  int16_t* o = out + img;
  const int c = 4 * lane;
  *reinterpret_cast<int2*>(o + r * kD + c) = pack4(v.x);
  *reinterpret_cast<int2*>(o + r * kD + kLanes + c) = pack4(v.w0);
  *reinterpret_cast<int2*>(o + (kLanes + r) * kD + c) = pack4(v.w1);
  *reinterpret_cast<int2*>(o + (kLanes + r) * kD + kLanes + c) = pack4(v.w2);
}

}  // namespace

extern "C" {

// S9.  process, out: (B, 256, 256) int16, 16-byte aligned; rf_ext: (B,
// rf_len) int16, rf_len >= 16384 + 130 + 127 (res256, then the tail the
// drift reads).
int nhw_uv_sentinel(const void* process, const void* rf_ext, void* out,
                    int batch, int rf_len, int res_uv, void* stream) {
  if (batch < 1 || batch > 65535 || rf_len < kRfMin)
    return cudaErrorInvalidValue;
  if (nhw::misaligned(process, 16) || nhw::misaligned(rf_ext, 2) ||
      nhw::misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  cudaLaunchAttribute dims = nhw::cluster_dims(kUvCtas);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kUvCtas, batch, 1);
  cfg.blockDim = dim3(kUvThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, uv_sentinel_rows, static_cast<const int16_t*>(process),
      static_cast<const int16_t*>(rf_ext), static_cast<int16_t*>(out),
      rf_len, res_uv);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // extern "C"
