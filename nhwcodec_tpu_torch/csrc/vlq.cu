// Hand-written Hopper (sm_90a) kernels of the device encode scans' programs
// below LOW7.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (low_q_ll1_cleanup_device /
// _ref, very_low_q_cleanup_device / _ref, uv_ll_smooth_device / _ref).
//
// S12 nhw_very_low_q_cleanup replaces
//    nhwcodec_tpu/models/device_scans.py:2479 very_low_q_cleanup_device
//    (pass 1 as 128 row scans of 124 steps, passes 2 and 3 as 126-row
//    scans of 126-step column scans, pass 4 and the far zeroings
//    elementwise): the q < LOW7 LL2 window smoothing of a (B, 512, 512)
//    int16 plane and the zeroings its fires cause in the other bands.  Two
//    launches: vlq_rows (one CTA an image: passes 1-4 on the LL2 quadrant,
//    the count masks out as bits) and vlq_far (the masked zeroings).
// S13 nhw_low_q_ll1_cleanup replaces
//    nhwcodec_tpu/models/device_scans.py:2101 low_q_ll1_cleanup_device
//    (a Jacobi while_loop over rows 128..255): the q <= LOW9
//    isolated-coefficient zeroing.  One launch, a thread a row.
// S14 nhw_uv_ll_smooth replaces
//    nhwcodec_tpu/models/device_scans.py:2353 uv_ll_smooth_device (two
//    62-row scans of 62-step column scans): the q <= LOW9 smoothing of
//    the chroma LL2 block, in place on (B, 256, 256) int16 planes.  One
//    launch (uvs_relay), one CTA a plane, the two passes walked together.
//
// S13's rows are independent: a visit reads its left neighbour as the walk
// left it (column 0 the previous row's column 511, which no visit writes)
// and its right neighbour as it was (column 255 reads column 256).  So each
// thread walks one row of 256 visits, the rows staged in shared memory (32
// a CTA, block_scan.cuh's stage_rows) and written back whole.
//
// S12's pass 1 writes only within its row (a window's write at j + 2 is
// read by the next two windows): a thread a row, 124 steps, the window in
// registers, one value read a step.  Passes 2 and 3 and S14's two passes
// share one recurrence: visit (r, j) reads rows r, r + 1 and r + 2 at
// columns j..j + 2 and writes (r + 1, j + 1), so it needs visits (r, j - 1)
// and (r - 1, j + 1) done and nothing later.  Both keep the order with a
// barrier every few steps (S12 4, S14 3): a lane a row, 32 rows a warp,
// each lane holding windows of its row r (columns j..j + 2) and of row r +
// 1; what it writes at (r + 1, j + 1) is what lane r + 1 reads next as
// its row's newest value, passed one lane on with a shuffle; row r + 2 at
// j + 1 is still an input (lane r + 1 writes it two steps later).  Lane 31
// of a warp writes the row that lane 0 of the next warp reads from shared
// memory, so each warp runs behind the one before by the 65 steps the
// dependence needs and the barrier interval (S12: 69).  Each step loads
// what the next needs and has no branch.  S14's passes have no write test
// and no tracking (uvs_step), and run on four warps together: pass 2 on
// warps 0 and 1, pass 3 on warps 2 and 3 over the same rows, kUvsDelay
// steps behind (uvs_relay).  Pass 3's visit (r, j) needs pass 2's visits up to
// (r + 1, j) and (r, j + 1); the loads a step ahead make its step read
// pass 2's writes of (r + 1, j + 4) and (r + 2, j + 2) (pass 2's rows r
// and r + 1, at visits j + 3 and j + 1), and with row r + 1 in the next
// pass-2 warp, that visit comes kUvsLag - 62 = kUvsSync + 3 steps after
// the same-lane step; so kUvsDelay = 2 kUvsSync + 4, which also keeps
// every pass-2 read of a cell before pass 3 overwrites it (pass 2's lane 0
// reads the row above 2 kUvsSync steps before pass 3 writes it).  A
// launch is kUvsSteps = 204 steps, 68 barriers (each pass was 184 steps
// with a barrier each).
//
// The far zeroings land outside the quadrant, which no pass reads, and
// zero only, so they apply once after the passes from masks: vlq_rows
// writes, per image, the count masks (128 x 128 bits each, count position
// (r, c) = plane position r * 512 + c) that the far zeroings read: cnt1
// (pass 1's fires at c + 1..c + 3), d23 (passes 2-3's at (r + 1, c + 1)),
// fe34 (pass 4's at c + 1) and l2 (the level-2 zeroings': cnt1, d23 and
// its row neighbours, fe34), and the stale carry's mode.  The one far
// target a pass reads is (0, 127): pass 3's hits before its first fire
// zero the level-2 bands around the carry passes 1-2 left, 0 when neither
// fired, and 0 + 128 - 1 is (0, 127) (at q <= LOW9, |v| < 11).  Pass 3's
// visit (0, 125) and pass 4 read it; row 0's visits come first in raster
// order, so row 0's lane zeroes it at its first stale hit, as the C does,
// and vlq_rows again after pass 3 where the first hit came later.  vlq_far
// (a CTA every 16 plane rows, 16-byte accesses) zeroes each position
// outside the quadrant that a mask reaches below its threshold; vlq_rows
// writes the quadrant.
//
// The bound is bytes (S12: the plane read and written; S13: rows
// 128..255; S14: the 64 x 64 block); each visit is some 20-40 operations.
// What limits S12 and S14 is their dependent steps: S12 124 + 2 x 400
// (the warps 69 steps apart), S13 256, S14 204 (the passes together);
// S12's step is bound by its instructions, one warp on each of the SM's
// four schedulers, and so is S14's.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

using nhw::iabs;

constexpr int kN = 512;
constexpr int kPlane = kN * kN;
constexpr int kD = 256;
constexpr int kUvPlane = kD * kD;

constexpr int kVlq = 128;              // the LL2 quadrant's side
constexpr int kVlqP1 = kVlq - 4;       // pass 1's visits a row
constexpr int kVlqWave = kVlq - 2;     // passes 2-3: rows and visits a row
constexpr int kVlqPitch = 132;         // int16 a staged row
constexpr int kVlqWarps = kVlq / 32;   // a lane a row
constexpr int kMaskWords = kVlq / 32;  // bit words a mask row
constexpr int kVlqMasks = 4;           // cnt1, d23, fe34, l2
constexpr int kVlqOut = kVlqMasks * kVlq * kMaskWords + 4;  // u32 an image
constexpr int kFarRows = 16;           // plane rows a CTA of vlq_far
// S12's relay: a CTA barrier every kVlqSync steps, each warp kVlqLag steps
// behind the one before, kVlqSteps in all (vlq_wave)
constexpr int kVlqSync = 4;
constexpr int kVlqLag = 65 + kVlqSync;
constexpr int kVlqSteps =
    ((kVlqWarps - 1) * kVlqLag + 2 * 31 + kVlqWave + 3 + kVlqSync - 1) /
    kVlqSync * kVlqSync;
// A step reads row r + 2 at j + 2 and rows r, r + 1 at j + 4 whatever its
// lane's j, so that it needs no clamp: from the quadrant's first row the
// reads stay inside it (each row's j starts at -3 - 2 r or lower, and its
// row lies 132 r on), and past its last row they reach kVlqTail further
// (the values there are read by idle steps only).
constexpr int kVlqTail =
    (kVlqSteps - 3 + 4 - kVlqPitch + 7) / 8 * 8;
constexpr int kFarThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kUvs = 64;               // the chroma LL2 block's side
constexpr int kUvsPitch = 68;          // int16 a staged row
constexpr int kUvsWave = kUvs - 2;     // rows and visits a row of a pass
// S14's relay (uvs_relay): a barrier every kUvsSync steps (3: the windows'
// period, so an unrolled group needs no register moves), warp 1 of a
// pass kUvsLag steps behind warp 0 (as S12's kVlqLag), pass 3 kUvsDelay
// steps behind pass 2, kUvsLead idle steps that fill a lane's windows
// before its visit 0 (the first loads of row r + 1 read column 0 four
// steps ahead); kUvsSteps: pass 3's row 61 visits its column 61 in the
// last step, rounded up to a barrier
constexpr int kUvsSync = 3;
constexpr int kUvsLag = 65 + kUvsSync;
constexpr int kUvsDelay = 2 * kUvsSync + 4;
constexpr int kUvsLead = 4;
constexpr int kUvsSteps =
    (kUvsLead + kUvsLag + 2 * (kUvsWave - 1 - 32) + kUvsDelay + kUvsWave +
     kUvsSync - 1) / kUvsSync * kUvsSync;
// the reads run kUvsDelay before the block's first row (pass 3's row 0,
// its first step) and up to kUvsSteps past its last row's start
constexpr int kUvsFront = 16;
constexpr int kUvsSmem = kUvsFront + kUvs * kUvsPitch + kUvsSteps;
static_assert(kUvsFront >= kUvsDelay && kUvsFront % 8 == 0,
              "the slack before row 0 keeps rows 8-byte aligned");
constexpr int kLl1Rows = 32;           // S13: rows a CTA, a thread each
constexpr int kLl1First = 128;         // S13's rows 128..255
constexpr int kLl1Cols = 256;

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// ---------------------------------------------------------------------------
// S12

struct VlqShared {
  int16_t q[kVlq * kVlqPitch + kVlqTail];   // the quadrant, then slack
  uint32_t p1[kVlq][kMaskWords];        // pass 1's fires, visit frame
  uint32_t f23[kVlq][kMaskWords];       // passes 2-3's fires, visit frame
  int first_hit, first_fire;            // pass 3's, raster order
};

// Pass 1 on staged row `row`: 124 windows of 5, a write at j + 2, the
// window in registers; its fires into bits.  Returns whether any fired.
__device__ __forceinline__ bool vlq_pass1(int16_t* row, int x1, int x2,
                                          uint32_t* bits) {
  int p0 = row[0], p1 = row[1], p2 = row[2], p3 = row[3];
  bool any = false;
#pragma unroll 1
  for (int jc = 0; jc < kMaskWords; ++jc) {
    uint32_t w = 0;
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int j = 32 * jc + i;
      if (j < kVlqP1) {
        const int p4 = row[j + 4];
        const bool c1 = (iabs(p4 - p0) < x1) & (iabs(p4 - p3) < x1) &
                        (iabs(p1 - p0) < x1) & (iabs(p3 - p1) < x1) &
                        (iabs(p3 - p2) < x2 - 2);
        const bool to3 = ((p3 - p1 > 5) & (p2 - p3 >= 0)) |
                         ((p1 - p3 > 5) & (p2 - p3 <= 0));
        const bool to1 = ((p1 - p3 > 5) & (p2 - p1 >= 0)) |
                         ((p3 - p1 > 5) & (p2 - p1 <= 0));
        const bool keep = ((p3 - p2 > 0) & (p2 - p1 > 0)) |
                          ((p1 - p2 > 0) & (p2 - p3 > 0));
        const int v = to3 ? p3 : to1 ? p1 : keep ? p2 : (p3 + p1) >> 1;
        const bool c2 = (iabs(p4 - p0) < x2 + 1) & (iabs(p4 - p3) < x2 + 1) &
                        (iabs(p1 - p0) < x2 + 1) & (iabs(p3 - p1) < x2 + 6) &
                        (iabs(p3 - p2) < x2 + 6) &
                        (((p3 - p2 >= 0) & (p2 - p1 >= 0)) |
                         ((p3 - p2 <= 0) & (p2 - p1 <= 0)));
        w |= uint32_t(c1 | c2) << i;
        p2 = c1 ? v : p2;
        row[j + 2] = static_cast<int16_t>(p2);
        p0 = p1;
        p1 = p2;
        p2 = p3;
        p3 = p4;
      }
    }
    bits[jc] = w;
    any |= w != 0;
  }
  return any;
}

// One lane's walk of a pass: its windows of row r (t: columns j..j + 2)
// and of row r + 1 (m), this step's loads (b2: row r + 2 at j + 1; mn, tn:
// rows r + 1 and r at j + 3), its fires as a 128-bit shift register; pass
// 3 at q <= LOW9 also the row's first hit and fire (columns, kVlq for
// none) and (0, 127) as the stale carry leaves it.
struct WaveLane {
  int j, t0, t1, t2, m0, m1, m2, b2, mn, tn;
  uint32_t f0, f1, f2, f3;
  int fh, ff, q127;
  bool any, fired0;
};

// One step.  kTrack: pass 3 at q <= LOW9 (first hit and fire); kStale:
// with the stale carry 0, which zeroes (0, 127) on row 0 (z_row).
template <int kVariant, bool kTrack, bool kStale>
__device__ __forceinline__ void wave_step(WaveLane& a, const int16_t* row_t,
                                          int16_t* row_m,
                                          const int16_t* row_b, bool row_ok,
                                          int lane, int x3, int x4,
                                          bool z_row) {
  constexpr int kRnd = kVariant == 2 ? 2 : 1;
  const int j = a.j;
  const bool act = row_ok & (j >= 0) & (j < kVlqWave);
  const int b2n = row_b[j + 2];
  const int mnn = row_m[j + 4];
  const int tnn = row_t[j + 4];
  bool outer, inner;
  if (kVariant == 2) {
    outer = (iabs(a.t1 - a.b2) < x3) & (iabs(a.m0 - a.m2) < x3);
    inner = outer & (iabs(a.m1 - a.m0) < x4 - 1) & (iabs(a.t1 - a.m1) < x4);
  } else {
    outer = (iabs(a.t2 - a.t1) < x3) & (iabs(a.t1 - a.t0) < x3) &
            (iabs(a.t0 - a.m0) < x3) & (iabs(a.t2 - a.m2) < x3);
    inner = outer & (iabs(a.b2 - a.m0) < x3) & (iabs(a.m0 - a.m1) < x4);
  }
  const int e = (a.t1 + a.b2 + a.m0 + a.m2 + kRnd) >> 2;
  const bool wr = inner & ((iabs(e - a.m0) < 5) | (iabs(e - a.m2) < 5));
  const int val = wr ? e : a.m1;
  if (act) row_m[j + 1] = static_cast<int16_t>(val);
  a.f0 = act ? __funnelshift_r(a.f0, a.f1, 1) : a.f0;
  a.f1 = act ? __funnelshift_r(a.f1, a.f2, 1) : a.f1;
  a.f2 = act ? __funnelshift_r(a.f2, a.f3, 1) : a.f2;
  a.f3 = act ? (a.f3 >> 1) | (uint32_t(inner) << 31) : a.f3;
  a.any |= act & inner;
  if (kTrack) {
    a.fh = act & outer & (a.fh == kVlq) ? j : a.fh;
    a.ff = act & inner & (a.ff == kVlq) ? j : a.ff;
  }
  if (kStale) {
    a.q127 = act & z_row & outer & !inner & !a.fired0 & (iabs(a.q127) < 11)
                 ? 0
                 : a.q127;
    a.fired0 |= act & inner;
  }
  const int recv = __shfl_up_sync(kFull, val, 1);
  const int cin = j + 3;
  const bool sh = (cin >= 0) & (cin < kVlq);
  const bool mid = (lane > 0) & (cin >= 1) & (cin <= kVlqWave);
  const int nv = mid ? recv : (kStale & z_row & (cin == kVlq - 1)) ? a.q127
                                                                   : a.tn;
  a.t0 = sh ? a.t1 : a.t0;
  a.t1 = sh ? a.t2 : a.t1;
  a.t2 = sh ? nv : a.t2;
  a.m0 = act ? val : a.m0;
  a.m1 = act ? a.m2 : a.m1;
  a.m2 = act ? a.mn : a.m2;
  a.b2 = b2n;
  a.mn = mnn;
  a.tn = tnn;
  a.j = j + 1;
}

// Pass 2 (kVariant 2) or 3 in place on the staged quadrant, a lane a row r
// < kVlqWave (the header's relay).  Lane l of warp w does visit j at its
// warp's step t = 2 l + j, and warp w runs kVlqLag steps behind warp w -
// 1; the CTA synchronises every kVlqSync steps.  After each step a lane
// shifts its row's next value (column j + 3) into its window: what lane l
// - 1 wrote in that step, passed a lane on, or (lane 0, and columns 0 and
// 127) the staged row.  Lane 0 of warp w reads row 32 w there, which lane
// 31 of warp w - 1 wrote at least kVlqSync steps and a barrier before: the
// lag is the 65 steps the dependence needs (62 from lane 31's offset, 3
// for the read a step ahead) plus kVlqSync.  Every load a step needs is
// issued a step ahead (rows r + 1 and r + 2 are inputs until lane l and
// lane l + 1 write them, later), and the step has no branch.  The lane's
// fires OR into f23.  kStale: pass 3 at q <= LOW9 with no pass-1 or pass-2
// fire.
template <int kVariant, bool kTrack, bool kStale>
__device__ __forceinline__ void vlq_wave(VlqShared& sh, int x3, int x4,
                                         WaveLane& a) {
  const int r = threadIdx.x, lane = r & 31, w = r >> 5;
  const bool z_row = kStale & (r == 0);
  const bool row_ok = r < kVlqWave;
  const int16_t* row_t = sh.q + r * kVlqPitch;
  int16_t* row_m = sh.q + min(r + 1, kVlq - 1) * kVlqPitch;
  const int16_t* row_b = sh.q + min(r + 2, kVlq - 1) * kVlqPitch;
  const int j = -3 - kVlqLag * w - 2 * lane;
  a.j = j;
  a.t0 = a.t1 = a.t2 = 0;
  a.m0 = row_m[0];
  a.m1 = row_m[1];
  a.m2 = row_m[2];
  a.b2 = row_b[j + 1];
  a.mn = row_m[j + 3];
  a.tn = row_t[j + 3];
  a.f0 = a.f1 = a.f2 = a.f3 = 0;
  a.fh = a.ff = kVlq;
  a.q127 = sh.q[kVlq - 1];
  a.any = a.fired0 = false;
#pragma unroll 1
  for (int s0 = 0; s0 < kVlqSteps; s0 += kVlqSync) {
#pragma unroll
    for (int k = 0; k < kVlqSync; ++k)
      wave_step<kVariant, kTrack, kStale>(a, row_t, row_m, row_b, row_ok,
                                          lane, x3, x4, z_row);
    __syncthreads();
  }
  // bit j of the visits sits at 2 + j after 126 shifts
  uint32_t* fr = sh.f23[r];
  fr[0] |= __funnelshift_r(a.f0, a.f1, 2);
  fr[1] |= __funnelshift_r(a.f1, a.f2, 2);
  fr[2] |= __funnelshift_r(a.f2, a.f3, 2);
  fr[3] |= a.f3 >> 2;
  if (z_row) sh.q[kVlq - 1] = static_cast<int16_t>(a.q127);
}

// 128-bit rows of 4 words, bit c of word c / 32: shifted to higher
// columns by n (1..3), and to lower ones by 1.
__device__ __forceinline__ void shl128(const uint32_t* a, int n, uint32_t* o) {
#pragma unroll
  for (int k = kMaskWords - 1; k > 0; --k)
    o[k] = (a[k] << n) | (a[k - 1] >> (32 - n));
  o[0] = a[0] << n;
}

__device__ __forceinline__ void shr128(const uint32_t* a, uint32_t* o) {
#pragma unroll
  for (int k = 0; k + 1 < kMaskWords; ++k)
    o[k] = (a[k] >> 1) | (a[k + 1] << 31);
  o[kMaskWords - 1] = a[kMaskWords - 1] >> 1;
}

// S12, the passes: one CTA an image, a thread a quadrant row.  Writes the
// quadrant of out and the image's masks (kVlqMasks x 128 rows x 4 words:
// cnt1, d23, fe34, l2) and, after them, the stale carry's mode (0 none,
// 1 carry 4, 2 carry 0).
__global__ void __launch_bounds__(kVlq)
    vlq_rows(const int16_t* __restrict__ in, int16_t* __restrict__ out,
             uint32_t* __restrict__ masks, int low9, int x1, int x2, int x3,
             int x4, int x7) {
  __shared__ __align__(16) VlqShared sh;
  const int r = threadIdx.x;
  const size_t img = static_cast<size_t>(blockIdx.x) * kPlane;
  for (int i = r; i < kVlq * kVlq / 8; i += kVlq) {
    const int row = i >> 4, c = (i & 15) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(in + img + row * kN + c);
    uint2* d = reinterpret_cast<uint2*>(sh.q + row * kVlqPitch + c);
    d[0] = make_uint2(v.x, v.y);
    d[1] = make_uint2(v.z, v.w);
  }
  if (r == 0) sh.first_hit = sh.first_fire = kVlq * kVlq;
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) sh.f23[r][k] = 0;
  __syncthreads();
  const bool any1 =
      __syncthreads_or(vlq_pass1(sh.q + r * kVlqPitch, x1, x2, sh.p1[r]));
  WaveLane a, c;
  vlq_wave<2, false, false>(sh, x3, x4, a);
  const bool any2 = __syncthreads_or(a.any);
  if (!low9)
    vlq_wave<3, false, false>(sh, x3, x4, c);
  else if (!any1 && !any2)
    vlq_wave<3, true, true>(sh, x3, x4, c);
  else
    vlq_wave<3, true, false>(sh, x3, x4, c);
  const int fh = c.fh, ff = c.ff;
  // pass 3's first hit and first fire in raster order
  const int hp = __reduce_min_sync(kFull, fh < kVlq ? r * kVlq + fh
                                                    : kVlq * kVlq);
  const int fp = __reduce_min_sync(kFull, ff < kVlq ? r * kVlq + ff
                                                    : kVlq * kVlq);
  if ((r & 31) == 0) {
    atomicMin(&sh.first_hit, hp);
    atomicMin(&sh.first_fire, fp);
  }
  __syncthreads();
  const int stale = low9 && !any2 && sh.first_hit < sh.first_fire
                        ? (any1 ? 1 : 2)
                        : 0;
  if (r == 0 && stale == 2 && iabs(sh.q[kVlq - 1]) < 11) sh.q[kVlq - 1] = 0;
  __syncthreads();
  // pass 4's fires on the finished quadrant (q <= LOW9), columns 0..125
  uint32_t f4[kMaskWords] = {0u, 0u, 0u, 0u};
  if (low9) {
    const int16_t* row = sh.q + r * kVlqPitch;
    int a = row[0], b = row[1];
#pragma unroll 1
    for (int jc = 0; jc < kMaskWords; ++jc) {
      uint32_t w = 0;
#pragma unroll
      for (int i = 0; i < 32; ++i) {
        const int c = 32 * jc + i;
        if (c < kVlqWave) {
          const int d = row[c + 2];
          w |= uint32_t((iabs(d - b) < x7) & (iabs(d - a) < x7) &
                        (iabs(b - a) < x7)) << i;
          a = b;
          b = d;
        }
      }
      f4[jc] = w;
    }
  }
  // the count masks of row r
  uint32_t p[kMaskWords], c1[kMaskWords], c2[kMaskWords], c3[kMaskWords];
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) p[k] = sh.p1[r][k];
  shl128(p, 1, c1);
  shl128(p, 2, c2);
  shl128(p, 3, c3);
  uint32_t cnt1[kMaskWords], d23[kMaskWords], fe34[kMaskWords];
  uint32_t l2[kMaskWords], dl[kMaskWords], dr[kMaskWords];
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k) {
    cnt1[k] = c1[k] | c2[k] | c3[k];
    p[k] = r > 0 ? sh.f23[r - 1][k] : 0u;
  }
  shl128(p, 1, d23);
  shl128(f4, 1, fe34);
  shl128(d23, 1, dl);
  shr128(d23, dr);
#pragma unroll
  for (int k = 0; k < kMaskWords; ++k)
    l2[k] = low9 ? cnt1[k] | d23[k] | dl[k] | dr[k] | fe34[k] : 0u;
  uint32_t* M = masks + static_cast<size_t>(blockIdx.x) * kVlqOut;
  uint4* mr = reinterpret_cast<uint4*>(M + r * kMaskWords);
  constexpr int kStride = kVlq;   // uint4s between masks
  mr[0] = make_uint4(cnt1[0], cnt1[1], cnt1[2], cnt1[3]);
  mr[kStride] = make_uint4(d23[0], d23[1], d23[2], d23[3]);
  mr[2 * kStride] = make_uint4(fe34[0], fe34[1], fe34[2], fe34[3]);
  mr[3 * kStride] = make_uint4(l2[0], l2[1], l2[2], l2[3]);
  if (r == 0) M[kVlqMasks * kVlq * kMaskWords] = static_cast<uint32_t>(stale);
  // the quadrant out
  for (int i = r; i < kVlq * kVlq / 8; i += kVlq) {
    const int row = i >> 4, c = (i & 15) * 8;
    const uint2* d = reinterpret_cast<const uint2*>(sh.q + row * kVlqPitch + c);
    const uint2 lo = d[0], hi = d[1];
    *reinterpret_cast<uint4*>(out + img + row * kN + c) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

// The bits of mask k at count row cr from count column c (n of them, n a
// power of two dividing 32, c a multiple of n).
__device__ __forceinline__ uint32_t mask_bits(const uint32_t* M, int k, int cr,
                                              int c, int n) {
  return (__ldg(M + (k * kVlq + cr) * kMaskWords + (c >> 5)) >> (c & 31)) &
         ((1u << n) - 1u);
}

// S12, the far zeroings: a CTA every kFarRows rows of an image, 8 values
// a thread in 16-byte accesses, outside the quadrant (vlq_rows writes it):
// a value is zeroed where a mask reaches it and |v| lies below the
// threshold of its band (level 2 beside the quadrant: l2 at 11, 12, 13;
// level 1 over each count position's 2 x 2 block: cnt1 | d23 | fe34 at x6
// and x6 + 6, and in the last band cnt1 at x5, d23 at 32, fe34 at 34), and
// at the stale carry's targets.
constexpr int kFarVecs = kFarRows * kN / 8 / kFarThreads;   // a thread's

__global__ void __launch_bounds__(kFarThreads)
    vlq_far(const int16_t* __restrict__ in, int16_t* __restrict__ out,
            const uint32_t* __restrict__ masks, int x5, int x6) {
  const size_t img = static_cast<size_t>(blockIdx.y) * kPlane;
  uint4 q[kFarVecs];
#pragma unroll
  for (int k = 0; k < kFarVecs; ++k) {
    const int i = threadIdx.x + k * kFarThreads;
    const int y = blockIdx.x * kFarRows + (i >> 6), x0 = (i & 63) * 8;
    q[k] = *reinterpret_cast<const uint4*>(in + img + y * kN + x0);
  }
  const uint32_t* M = masks + static_cast<size_t>(blockIdx.y) * kVlqOut;
  const int stale = static_cast<int>(M[kVlqMasks * kVlq * kMaskWords]);
  const int base = stale == 1 ? 3 : -1;
#pragma unroll
  for (int k = 0; k < kFarVecs; ++k) {
    const int i = threadIdx.x + k * kFarThreads;
    const int y = blockIdx.x * kFarRows + (i >> 6), x0 = (i & 63) * 8;
    if ((y < kVlq) & (x0 < kVlq)) continue;
    const uint32_t wd[4] = {q[k].x, q[k].y, q[k].z, q[k].w};
    int v[8];
#pragma unroll
    for (int h = 0; h < 4; ++h) {
      v[2 * h] = iabs(static_cast<int16_t>(wd[h] & 0xFFFFu));
      v[2 * h + 1] = iabs(static_cast<int16_t>(wd[h] >> 16));
    }
    uint32_t z = 0;
    if ((y >= kD) | (x0 >= kD)) {
      // level 1: count position ((y & 255) / 2, (x & 255) / 2)
      const int cr = (y & (kD - 1)) >> 1, cc = (x0 & (kD - 1)) >> 1;
      const uint32_t b1 = mask_bits(M, 0, cr, cc, 4);
      const uint32_t b2 = mask_bits(M, 1, cr, cc, 4);
      const uint32_t b3 = mask_bits(M, 2, cr, cc, 4);
      const bool last = (y >= kD) & (x0 >= kD);
      const int thr = y < kD ? x6 : x6 + 6;
#pragma unroll
      for (int h = 0; h < 8; ++h) {
        const int c = h >> 1;
        const bool one = (((b1 | b2 | b3) >> c) & 1u) & (v[h] < thr);
        const bool two = ((((b1 >> c) & 1u) != 0) & (v[h] < x5)) |
                         ((((b2 >> c) & 1u) != 0) & (v[h] < 32)) |
                         ((((b3 >> c) & 1u) != 0) & (v[h] < 34));
        z |= uint32_t(last ? two : one) << h;
      }
    } else {
      // level 2 beside the quadrant: count position (y & 127, x & 127)
      const uint32_t b4 = mask_bits(M, 3, y & (kVlq - 1), x0 & (kVlq - 1), 8);
      const int thr = y < kVlq ? 11 : x0 < kVlq ? 12 : 13;
#pragma unroll
      for (int h = 0; h < 8; ++h)
        z |= uint32_t(((b4 >> h) & 1u) & (v[h] < thr)) << h;
    }
    if (stale) {
      const int p0 = y * kN + x0 - base;
      const int off[3] = {128, 65536, 65536 + 128}, thr[3] = {11, 12, 13};
#pragma unroll
      for (int h = 0; h < 8; ++h)
#pragma unroll
        for (int o = 0; o < 3; ++o)
          z |= uint32_t((unsigned(p0 + h - off[o]) < 3u) & (v[h] < thr[o]))
               << h;
    }
    uint32_t keep[4];
#pragma unroll
    for (int h = 0; h < 4; ++h)
      keep[h] = ((z >> (2 * h)) & 1u ? 0u : 0xFFFFu) |
                ((z >> (2 * h + 1)) & 1u ? 0u : 0xFFFF0000u);
    *reinterpret_cast<uint4*>(out + img + y * kN + x0) =
        make_uint4(wd[0] & keep[0], wd[1] & keep[1], wd[2] & keep[2],
                   wd[3] & keep[3]);
  }
}

// S13: rows 128 + blockIdx.x * 32.. of image blockIdx.y, a thread a row,
// from in to out (whose other rows the wrapper copied).
__global__ void __launch_bounds__(kLl1Rows)
    ll1_rows(const int16_t* __restrict__ in, int16_t* __restrict__ out,
             int x1) {
  __shared__ int16_t s[kLl1Rows * nhw::kStagePitch];
  const size_t b = blockIdx.y;
  const int r0 = kLl1First + blockIdx.x * kLl1Rows;
  nhw::stage_rows(in + b * kPlane, r0, kLl1Rows, s);
  __syncthreads();
  int16_t* row = s + threadIdx.x * nhw::kStagePitch + 1;
  int left = row[-1];
  for (int j = 0; j < kLl1Cols; ++j) {
    int v = row[j];
    const int av = iabs(v);
    if (av >= 8 && av < x1) {
      const bool lsm = iabs(left) < 8, rsm = iabs(row[j + 1]) < 8;
      if ((lsm && rsm) || (av == 8 && (lsm || rsm))) v = 0;
    }
    row[j] = static_cast<int16_t>(v);
    left = v;
  }
  __syncthreads();
  nhw::unstage_rows(s, kLl1Rows, out + b * kPlane, r0);
}

// ---------------------------------------------------------------------------
// S14

// One lane's windows (as S12's WaveLane): row r at columns j..j + 2 (t),
// row r + 1 (m), this step's loads (b2: row r + 2 at j + 1; mn, tn: rows r
// + 1 and r at j + 3).
struct UvsLane {
  int j, t0, t1, t2, m0, m1, m2, b2, mn, tn;
};

// |a - b| < n as one add and one unsigned compare
__device__ __forceinline__ bool near(int a, int b, int n) {
  return static_cast<unsigned>(a - b + (n - 1)) <
         static_cast<unsigned>(2 * n - 1);
}

// One step of pass 2 (kVariant 2) or 3: the visit's test and write, the
// loads for the next step, the relay.  The windows shift every step, idle
// or not, so a lane's first steps fill them from what it loads.  lane0:
// a warp's first lane (its row's new values come from memory).
template <int kVariant>
__device__ __forceinline__ void uvs_step(UvsLane& a, const int16_t* row_t,
                                         int16_t* row_m,
                                         const int16_t* row_b, bool row_ok,
                                         bool lane0) {
  constexpr int kRnd = kVariant == 2 ? 2 : 1;
  constexpr int x3 = 5, x4 = 8;
  const int j = a.j;
  const bool act = row_ok & (static_cast<unsigned>(j) < kUvsWave);
  const int b2n = row_b[j + 2];
  const int mnn = row_m[j + 4];
  const int tnn = row_t[j + 4];
  bool inner;
  if (kVariant == 2)
    inner = near(a.t1, a.b2, x3) & near(a.m0, a.m2, x3) &
            near(a.m1, a.m0, x4 - 1) & near(a.t1, a.m1, x4);
  else
    inner = near(a.t2, a.t1, x3) & near(a.t1, a.t0, x3) &
            near(a.t0, a.m0, x3) & near(a.t2, a.m2, x3) &
            near(a.b2, a.m0, x3) & near(a.m0, a.m1, x4);
  const int e = (a.t1 + a.b2 + a.m0 + a.m2 + kRnd) >> 2;
  const int val = act & inner ? e : a.m1;
  if (act) row_m[j + 1] = static_cast<int16_t>(val);
  const int recv = __shfl_up_sync(kFull, val, 1);
  // the row's next value, column j + 3: for columns 1..kUvsWave what the
  // lane above wrote in this step
  const bool mid = !lane0 & (static_cast<unsigned>(j + 2) < kUvsWave);
  a.t0 = a.t1;
  a.t1 = a.t2;
  a.t2 = mid ? recv : a.tn;
  a.m0 = val;
  a.m1 = a.m2;
  a.m2 = a.mn;
  a.b2 = b2n;
  a.mn = mnn;
  a.tn = tnn;
  a.j = j + 1;
}

// A lane's walk of its pass over row r (< kUvs; rows 62 and 63 idle),
// from column j0 (negative: its lead, its warp's lag and its pass's
// delay), every lane kUvsSteps steps with a CTA barrier every kUvsSync.
template <int kVariant>
__device__ __forceinline__ void uvs_walk(int16_t* q, int r, int lane,
                                         int j0) {
  const int16_t* row_t = q + r * kUvsPitch;
  int16_t* row_m = q + min(r + 1, kUvs - 1) * kUvsPitch;
  const int16_t* row_b = q + min(r + 2, kUvs - 1) * kUvsPitch;
  const bool row_ok = r < kUvsWave;
  UvsLane a{j0, 0, 0, 0, 0, 0, 0, 0, 0, 0};
#pragma unroll 1
  for (int s0 = 0; s0 < kUvsSteps; s0 += kUvsSync) {
#pragma unroll
    for (int k = 0; k < kUvsSync; ++k)
      uvs_step<kVariant>(a, row_t, row_m, row_b, row_ok, lane == 0);
    __syncthreads();
  }
}

// S14: one CTA a plane, 4 warps: warp w & 1 of pass 2 + (w >> 1), lane l
// on row 32 (w & 1) + l; both passes in place on the staged block.
__global__ void __launch_bounds__(128) uvs_relay(int16_t* __restrict__ uv) {
  __shared__ __align__(16) int16_t sm[kUvsSmem];
  int16_t* q = sm + kUvsFront;
  int16_t* P = uv + static_cast<size_t>(blockIdx.x) * kUvPlane;
  const int t = threadIdx.x;
  for (int i = t; i < kUvs * kUvs / 8; i += 128) {
    const int row = i >> 3, c = (i & 7) * 8;
    const uint4 v = *reinterpret_cast<const uint4*>(P + row * kD + c);
    uint2* d = reinterpret_cast<uint2*>(q + row * kUvsPitch + c);
    d[0] = make_uint2(v.x, v.y);
    d[1] = make_uint2(v.z, v.w);
  }
  __syncthreads();
  const int w = t >> 5, lane = t & 31;
  const int r = (w & 1) * 32 + lane;
  const int j0 =
      -kUvsLead - kUvsLag * (w & 1) - 2 * lane - kUvsDelay * (w >> 1);
  if (w < 2)
    uvs_walk<2>(q, r, lane, j0);
  else
    uvs_walk<3>(q, r, lane, j0);
  // the walks end on a barrier: every write is in
  for (int i = t; i < kUvs * kUvs / 8; i += 128) {
    const int row = i >> 3, c = (i & 7) * 8;
    const uint2* d = reinterpret_cast<const uint2*>(q + row * kUvsPitch + c);
    const uint2 lo = d[0], hi = d[1];
    *reinterpret_cast<uint4*>(P + row * kD + c) =
        make_uint4(lo.x, lo.y, hi.x, hi.y);
  }
}

}  // namespace

extern "C" {

// S12.  in, out: (B, 512, 512) int16, 16-byte aligned; masks: (B,
// kVlqOut) u32 scratch, 16-byte aligned; low9: q <= LOW9; x1..x7:
// _VLQ_THRX.  Two launches.
int nhw_very_low_q_cleanup(const void* in, void* out, void* masks, int batch,
                           int low9, int x1, int x2, int x3, int x4, int x5,
                           int x6, int x7, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(in, 16) || misaligned(out, 16) || misaligned(masks, 16))
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* m = static_cast<uint32_t*>(masks);
  vlq_rows<<<batch, kVlq, 0, s>>>(static_cast<const int16_t*>(in),
                                   static_cast<int16_t*>(out), m, low9, x1, x2,
                                   x3, x4, x7);
  vlq_far<<<dim3(kN / kFarRows, batch), kFarThreads, 0, s>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), m, x5, x6);
  return cudaGetLastError();
}

// S13.  in, out: (B, 512, 512) int16, 16-byte aligned; out holds in's
// other rows; x1: 10 or 11.
int nhw_low_q_ll1_cleanup(const void* in, void* out, int batch, int x1,
                          void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(in, 16) || misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  const dim3 grid((kD - kLl1First) / kLl1Rows, batch);
  ll1_rows<<<grid, kLl1Rows, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), x1);
  return cudaGetLastError();
}

// S14.  uv: (B, 256, 256) int16, 16-byte aligned, smoothed in place.
int nhw_uv_ll_smooth(void* uv, int batch, void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  if (misaligned(uv, 16)) return cudaErrorMisalignedAddress;
  uvs_relay<<<batch, 128, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(uv));
  return cudaGetLastError();
}

}  // extern "C"
