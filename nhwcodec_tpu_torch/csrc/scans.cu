// Hand-written Hopper (sm_90a) kernels of the device encode scans' stream
// stage.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (snap_pass_device / _ref,
// offset_y_device / offset_y_ref, merge_crossing_device / _ref).
//
// S1 nhw_snap_passes replaces nhwcodec_tpu/models/device_scans.py:93
//    snap_pass_device (an XLA while_loop, a Jacobi fixpoint over the
//    left-neighbour fixup chain): up to three _band_snap_pass regions in
//    order on a (B, 512, 512) int16 plane.  One launch.
// S2 nhw_offset_y replaces nhwcodec_tpu/models/device_scans.py:375
//    offset_y_device (a Jacobi while_loop, a 256-step lax.scan over rows
//    and elementwise passes): the q > LOW4 quantizer, (B, 512, 512) int16
//    plane -> int16 code plane.  Three launches.
// S3 nhw_merge_crossing replaces nhwcodec_tpu/models/device_scans.py:527
//    merge_crossing_device (an associative scan of a 5-state skip machine):
//    the crossing merge of a (B, n >= 4 SZ) uint8 stream.  One launch
//    (merge_crossing, a cluster of 8 CTAs a stream).
// S10 nhw_offset_y_low4 replaces nhwcodec_tpu/models/device_scans.py:2750
//    offset_y_low4_device (a Jacobi while_loop for pass 1, then one flat
//    262,144-step lax.scan, _oy4_step :2655): the q <= LOW4 quantizer with
//    the duty-cycle counters, (B, 512, 512) int16 plane -> int16 code plane.
//    A fill and two launches (S2's pass 1, oy4_rows).
//
// The bound of S1 is its operations (some 30 a region position; the
// plane read and written once for the three regions), S3's operations:
// the stream read once and written once, some 25 operations a position;
// S2's and S10's is their operations, 45-105 a position.  Each is a chain
// of dependent steps along a row or a stream:
// - S1: one warp a row: the row and the rows above and below staged in
//   shared memory in 16-byte loads, the row stored whole (rows and
//   columns outside every region are copied coalesced).  The neighbour
//   count is static (alive values stay alive under every write of the
//   pass; the rows above and below come from the input), so a position
//   depends on its left neighbour only through the class of that
//   neighbour's post-snap e (snap_class: decrement, increment or
//   neither), and a region's row is a scan of maps of 3 classes: lane l
//   takes the 8 columns from col0 + 8 l (16 for regions wider than 255),
//   composes their maps, the warp scans the 32 maps with shuffles, each
//   lane walks its columns again from its entry class.  The spill column
//   takes the class that reaches it; positions past the region map every
//   class to 0.  The regions of a row run in order on the staged row;
//   the wrapper checks that no region reads, above or below, what an
//   earlier one writes (the three variants of a quality pass: variant 1's
//   rows 1..254 neither touch nor neighbour rows 256..510, and variant 3
//   reads variant 2's output only in its own row).
// - S2: pass 1 one thread a row (a give lands on the next column and never
//   leaves column 510), 32 rows a CTA staged in shared memory with their
//   flat neighbours (block_scan.cuh's stage_rows: whole rows a warp, 16
//   bytes a lane, so the reads are coalesced and the walks read shared
//   memory); passes 2-3 (offset_y_bands) a cluster of 8 CTAs an image, a
//   warp a band of 16 rows in order, lane l on 8 columns: each CTA stages
//   its 32 input rows and the next (cp.async) and each value's four range
//   tests (the rules read a value only through them), so a row's step is
//   bit operations on the lanes' 8-bit masks, the greedy pair rule's run
//   parity two warp ballots, and the row's writes codes merged into it
//   from a 64-entry table.  The only carry between rows is pend, the 256
//   bits of a row's vertical writes into the next (10100 onto j - 1 and
//   j), so each band walks from a guessed entry (none), its exit is
//   relayed to the band below (across CTAs through DSM), and a band walks
//   again while its entry changes: two cluster barriers a sweep, bands
//   0..s - 1 exact after s sweeps (16 at most, 1-2 on real planes; row
//   255's exit lands in plane row 256).  One CTA an image (16 warps on
//   one SM) was bound by instruction throughput, and slower.
//   Pass 4 is elementwise, one thread a position.
// - S3: a cluster of 8 CTAs a stream, 512 threads a CTA, 64 positions a
//   thread, loaded and stored in 16-byte accesses.  A position's skip and
//   fire test are bit masks of its bytes (four bit operations a mask for
//   32 positions), so each thread builds its map over the 5 entry states
//   (skips left) once, 15 bits advanced a position at a time; the warp
//   scans its lanes' maps with shuffles and warp 0 the 16 warp
//   composites.  Each CTA pushes its composite, its map up to its last 4
//   positions and their fires from each state to every CTA of the cluster
//   (DSM) before one cluster barrier; each CTA then has its entry state
//   and the fires whose 201 lands in its first 4 bytes.  Each thread walks
//   again from its entry state for its fire bits and writes its 64 bytes
//   from them a word at a time: out[i] = fire[i - 4] ? 201 : fire[i] ?
//   code[i] : v[i].  Every byte has one writer; the stream past 4 SZ is
//   copied in 16-byte chunks.
// - S10: pass 1 is S2's launch (offset_y_rows); passes 2-3 do not run at
//   these qualities.  Pass 4's counters: quant and quant6 reset at each row
//   start and only choose whether a negative value is masked, which no rule
//   reads, so each is a count of the row's earlier ticks (a prefix
//   popcount); quant4 runs on, and a step may leave a write pending on the
//   next position.  What steers the walk is one of 8 states: quant4 0..2
//   with nothing pending, with a fixup pending (-9, -8 or 9: none fires a
//   rule, -9 and -8 take one code, and the next input, 7 or -7, tells
//   which), or quant4 1 with the next input - 2 (up) or + 2 (down)
//   pending.  A position's next state from each is fixed by its inputs:
//   one evaluation of the rules (a fixup's value fires none, and neither
//   does an input -+ 2 that the pair rule took), so it is a table of 8
//   states, 3 bits each.  At column 511 only the pair rule
//   writes on (into the next row's column 0), so a row enters and leaves in
//   one of 5 states.  oy4_rows: a warp a row, 16 rows a CTA, lane l on
//   columns 16 l..16 l + 15 loaded in 16-byte loads; each lane builds its
//   16 tables once and composes them, the warp scans the 32 lane maps with
//   shuffles, and lane 31's composite is the row's 5-state map.  Each CTA
//   takes a ticket (tile-major over the images), composes its 16 row maps,
//   publishes the composite and looks back (a lane a predecessor tile, the
//   nearest whose exit is out) to its entry; then each lane walks its
//   columns again from its entry state, the warp counts the ticks before
//   each lane, and each lane stores its 16 codes in 16-byte stores.  At
//   batch 16, 512 CTAs of 512 threads on every SM, one CTA an SM: the row
//   and its 16 tables stay in registers (some 100 a thread), and no CTA
//   waits behind another's table phase.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

#include "block_scan.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using nhw::iabs;
using nhw::kMap5Ident;
using nhw::map5_at;
using nhw::map5_then;
using nhw::map5_warp_scan;

constexpr int kN = 512;
constexpr int kD = 256;
constexpr int kSZ = 65536;
constexpr int kPlane = kN * kN;

constexpr int kSnapWarps = 8;       // rows a CTA of S1, a warp each
constexpr int kSnapMax = 3;         // regions one S1 launch walks
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRows = 32;           // rows a CTA of S2's pass 1 and S10
constexpr int kCodeThreads = 256;   // positions a CTA of S2's pass 4

constexpr int kMT = 64;                      // positions a thread of S3
constexpr int kMThreads = 512;               // threads a CTA of S3
constexpr int kMWarps = kMThreads / 32;
constexpr int kMWords = kMT / 4;             // 32-bit words a thread
constexpr int kMSpan = kMT * kMThreads;      // positions a CTA
constexpr int kMLen = 4 * kSZ;               // positions walked and written
constexpr int kMEnd = kMLen - 4;             // the cursor walk's end
constexpr int kMCtas = kMLen / kMSpan;       // CTAs a stream: one cluster
constexpr uint32_t kMOnes = 0x1249u;         // bit 0 of each state's field
static_assert(kMCtas == 8, "a stream is one cluster of 8 CTAs");

constexpr int kOy4Tile = 16;                 // columns a lane of S10
constexpr int kOy4Warps = 16;                // rows a CTA of S10, a warp each
constexpr int kOy4Tiles = kN / kOy4Warps;    // CTAs an image: look-back tiles
static_assert(kOy4Tile * 32 == kN && kOy4Tiles <= 32,
              "a warp a row; one look-back window of 32 tiles");

// ---------------------------------------------------------------------------
// S1: snap pass

struct SnapArgs {
  int r0, r1, col0, col1, thr, yw, yw2, second_rule, guard6, gc;
};

struct SnapList {
  int n;
  SnapArgs v[kSnapMax];
};

// The snap decision (encoder/nhw_encoder.c:1923-1960) for an alive value
// v whose static neighbour count gave the limits lim1 (cnt < 3: min(yw,
// yw2), else 0) and lim2 (the second rule at cnt 0: yw2, else 0): the
// first rule snaps |v| < lim1 to +-7 (with the +-6 guard, not |v| <= 6),
// the second |v| < lim2.  S1's steps are selects on ints (`&`, `|`: `&&`,
// `||` would branch and split the warp).
__device__ __forceinline__ int snap_decide(int v, int lim1, int lim2,
                                           bool guard6) {
  const int av = iabs(v);
  const bool snap = (av < lim1) ? !(guard6 & (av <= 6)) : (av < lim2);
  return snap ? (v < 0 ? -7 : 7) : v;
}

// The class of a post-snap e that its right neighbour's fixup reads: 1
// the decrement (e >= 8, e & 7 < 2), 2 the increment (e < -7, -e & 7 <
// 2), 0 neither.  A dead position passes class 0 on.
__device__ __forceinline__ int snap_class(int e) {
  const int ae = iabs(e);
  return ((ae >= 8) & ((ae & 6) == 0)) ? (e > 0 ? 1 : 2) : 0;
}

// The two fixups a left neighbour can make on I (right: I's right
// neighbour; gc_ok: the neighbour's column lies below the guard column):
// class 1 decrements where dec1, class 2 increments where inc2.
__device__ __forceinline__ bool snap_dec1(int I) {
  return (I > 7) & (I < 10000);
}
__device__ __forceinline__ bool snap_inc2(int I, int right, bool gc_ok) {
  const int m = (-I) & 7;
  return (I < -14) & ((m == 7) | ((m < 2) & gc_ok & (right <= 0)));
}

// A warp's rows in shared memory: the row, the rows above and below,
// column c at kSnapOff + c, 0 at -1 and 512 (the plane's edges).
constexpr int kSnapOff = 8;
constexpr int kSnapPitch = kN + 2 * kSnapOff;

// One region on the warp's row in shared memory (xs: the row as the
// earlier regions left it; us, ds: the input rows r - 1 and r + 1), lane
// l taking the K columns from col0 + K l (the region and its spill
// column).  A region position with left class k writes decide(fix_k(x)):
// a fixup moves x by one where class 1 meets dec1 or class 2 meets inc2
// (never both), so each position has two outcomes, from x and from the
// moved value.  Lanes build their columns' maps from the 3 entry classes,
// the warp scans the maps, and each lane walks its columns again from its
// entry class, deciding again (fewer registers than keeping both
// outcomes).
template <int K>
__device__ __forceinline__ void snap_region(int16_t* xs, const int16_t* us,
                                            const int16_t* ds, int r,
                                            int lane, const SnapArgs& a) {
  const int c_lo = a.col0 + K * lane;
  int x[K + 2], cnt[K];             // x[i]: column c_lo - 1 + i
#pragma unroll
  for (int i = 0; i < K + 2; ++i) {
    const int c = min(c_lo - 1 + i, kN);
    x[i] = xs[kSnapOff + c];
  }
  const int up_thr = r - 1 >= a.r0 ? a.thr : 6;   // the row above walked
  const int lim1 = min(a.yw, a.yw2);
  const bool g6 = a.guard6 != 0;
  int s0 = 0, s1 = 1, s2 = 2;       // the lane's exit class from each entry
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = c_lo + i, cc = min(c, kN);
    const int cur = x[i + 1], left = x[i], right = x[i + 2];
    cnt[i] = int(iabs(left) >= (c > a.col0 ? a.thr : 6)) +
             int(iabs(right) >= 6) + int(iabs(us[kSnapOff + cc]) >= up_thr) +
             int(iabs(ds[kSnapOff + cc]) >= 6);
    const int l1 = cnt[i] < 3 ? lim1 : 0;
    const int l2 = (a.second_rule != 0) & (cnt[i] == 0) ? a.yw2 : 0;
    const bool d1 = snap_dec1(cur), i2 = snap_inc2(cur, right, c - 1 < a.gc);
    const bool live = (c < a.col1) & (iabs(cur) >= a.thr);
    const int k0 = snap_class(snap_decide(cur, l1, l2, g6));
    const int k1 = snap_class(snap_decide(d1 ? cur - 1 : cur + 1, l1, l2, g6));
    // the column's map: class 0 -> k0, 1 -> (d1 ? k1 : k0), 2 -> (i2 ? k1
    // : k0); everything -> 0 off the live region positions
    const int t = live ? (k0 | ((d1 ? k1 : k0) << 2) | ((i2 ? k1 : k0) << 4))
                       : 0;
    s0 = (t >> (2 * s0)) & 3;
    s1 = (t >> (2 * s1)) & 3;
    s2 = (t >> (2 * s2)) & 3;
  }
  int m = s0 | (s1 << 2) | (s2 << 4);
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int prev = __shfl_up_sync(kFull, m, d);
    // m after prev: entry k -> m's entry prev(k)
    const int h = ((m >> (2 * (prev & 3))) & 3) |
                  (((m >> (2 * ((prev >> 2) & 3))) & 3) << 2) |
                  (((m >> (2 * ((prev >> 4) & 3))) & 3) << 4);
    m = lane >= d ? h : m;
  }
  const int before = __shfl_up_sync(kFull, m, 1);
  int k = lane > 0 ? (before & 3) : 0;   // from class 0 at column col0
  int y[K];
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = c_lo + i;
    const int cur = x[i + 1], right = x[i + 2];
    const bool moved = ((k == 1) & snap_dec1(cur)) |
                       ((k == 2) & snap_inc2(cur, right, c - 1 < a.gc));
    const int fixed = moved ? cur + (k == 1 ? -1 : 1) : cur;
    const int e = snap_decide(fixed, cnt[i] < 3 ? lim1 : 0,
                              (a.second_rule != 0) & (cnt[i] == 0) ? a.yw2
                                                                   : 0,
                              g6);
    const bool live = (c < a.col1) & (iabs(cur) >= a.thr);
    k = live ? snap_class(e) : 0;
    y[i] = c < a.col1 ? (live ? (((e == -7) & (right == 8)) ? -8 : e) : 0)
                      : fixed;      // the spill column
  }
  __syncwarp();                      // every lane has read its columns
#pragma unroll
  for (int i = 0; i < K; ++i) {
    const int c = c_lo + i;
    if (c <= a.col1 && c < kN) xs[kSnapOff + c] = static_cast<int16_t>(y[i]);
  }
  __syncwarp();
}

// A lane's 16 values of row r (0 outside the plane) into a staged row.
__device__ __forceinline__ void stage_cols(const int16_t* plane, int r,
                                           int lane, int16_t* row) {
  uint4* d = reinterpret_cast<uint4*>(row + kSnapOff + 16 * lane);
  if (r < 0 || r >= kN) {
    d[0] = d[1] = make_uint4(0, 0, 0, 0);
    return;
  }
  const uint4* p = reinterpret_cast<const uint4*>(plane + r * kN + 16 * lane);
  d[0] = __ldg(p);
  d[1] = __ldg(p + 1);
}

// One warp a row: the row and its neighbours staged in shared memory in
// 16-byte loads, the regions that cover the row in order, the row stored
// whole.
__global__ void __launch_bounds__(kSnapWarps * 32)
    snap_passes(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                int batch, SnapList list) {
  __shared__ __align__(16) int16_t sm[kSnapWarps][3][kSnapPitch];
  const int lane = threadIdx.x & 31, w = threadIdx.x >> 5;
  const int g = blockIdx.x * kSnapWarps + w;
  if (g >= batch * kN) return;
  const int r = g % kN;
  const int16_t* plane = in + static_cast<size_t>(g / kN) * kPlane;
  int16_t* xs = sm[w][0];
  stage_cols(plane, r, lane, xs);
  if (lane < 2) {
    for (int k = 0; k < 3; ++k) {
      sm[w][k][kSnapOff - 1] = 0;
      sm[w][k][kSnapOff + kN] = 0;
    }
  }
  bool staged = false;
  for (int v = 0; v < list.n; ++v) {
    // a static index: a dynamic one copies the list to local memory
    const SnapArgs a = v == 0 ? list.v[0] : (v == 1 ? list.v[1] : list.v[2]);
    if (r < a.r0 || r >= a.r1) continue;
    if (!staged) {
      stage_cols(plane, r - 1, lane, sm[w][1]);
      stage_cols(plane, r + 1, lane, sm[w][2]);
      staged = true;
    }
    __syncwarp();
    if (a.col1 - a.col0 < 8 * 32)
      snap_region<8>(xs, sm[w][1], sm[w][2], r, lane, a);
    else
      snap_region<16>(xs, sm[w][1], sm[w][2], r, lane, a);
  }
  __syncwarp();
  uint4* o = reinterpret_cast<uint4*>(out + static_cast<size_t>(g) * kN +
                                      16 * lane);
  const uint4* src = reinterpret_cast<const uint4*>(xs + kSnapOff + 16 * lane);
  o[0] = src[0];
  o[1] = src[1];
}

// ---------------------------------------------------------------------------
// S2: offset_y, q > LOW4

// Pass 1 (image_processing.c:194-237): even-pair decrements, one thread a
// row of kRows staged ones (the CTA's rows with their flat neighbours);
// reads of x + 1, x + 2 and x - 1 are initial values, in flat order, so the
// thread keeps them in registers and writes the row in place.
__global__ void __launch_bounds__(kRows)
    offset_y_rows(const int16_t* __restrict__ in, int16_t* __restrict__ out) {
  __shared__ int16_t s[kRows * nhw::kStagePitch];
  const size_t b = blockIdx.y;
  const int r0 = blockIdx.x * kRows, r = r0 + threadIdx.x;
  nhw::stage_rows(in + b * kPlane, r0, kRows, s);
  __syncthreads();
  int16_t* row = s + threadIdx.x * nhw::kStagePitch + 1;
  int irs = row[-1], cur = row[0], il = row[1], d = 0;
  for (int c = 0; c < kN; ++c) {
    const int il2 = row[c + 2];
    const bool x0 = r > 0 || c > 0;     // x > 0
    const int a = cur - d;
    const bool reg = (r >= kD || c >= kD) && c < 2 * kD - 1;
    const bool outer =
        reg && a > 7 && il > 7 && (a & 7) == 0 && (il & 7) == 0;
    const bool outer_r =
        il > 15 && (il & 7) == 0 && c < 2 * kD - 2 && il2 <= 0;
    const bool big = a > 15;
    const bool case_a = outer && big && x0 && irs <= 0;
    const bool give = outer && outer_r && (!big || (x0 && irs > 0));
    row[c] = static_cast<int16_t>(a - int(case_a));
    d = int(give);
    irs = cur;
    cur = il;
    il = il2;
  }
  __syncthreads();
  nhw::unstage_rows(s, kRows, out + b * kPlane, r0);
}

// Passes 2-3 (image_processing.c:241-309) on the LL quadrant of one image,
// in place: a warp a band of kOyBandRows rows in order, lane l on columns
// 8 l..8 l + 7, a cluster of kOyCtas CTAs an image, kOyWarps bands each.
// The only carry from row to row is pend, the 256 bits of the vertical
// fires' writes into the next row, so each band walks from a guessed entry
// (none), its exit is relayed to the band below (through DSM across CTAs),
// and a band walks again while its entry changes: after s sweeps bands
// 0..s - 1 are exact, so kOyBands sweeps at most.  A CTA stages its input
// rows and the next CTA's first (a band's last row reads the next band's
// first as input), beside each value's range tests (the rules test only
// whether a value lies in 4..7, -7..-4, 5..7 or -7..-5, and a written
// value is a sentinel, in none), so a row's step is bit operations on the
// lanes' 8-bit masks; the outputs go straight to the plane.
constexpr int kOyBands = 16;                     // bands an image
constexpr int kOyBandRows = kD / kOyBands;
constexpr int kOyCtas = 8;                       // a cluster an image
constexpr int kOyWarps = kOyBands / kOyCtas;     // bands a CTA
constexpr int kOyRows = kOyWarps * kOyBandRows;  // rows a CTA
constexpr int kOyThreads = 128;                  // the walkers and helpers
constexpr int kOyVecs = kD / 8;                  // 8-column vectors a row

__device__ __forceinline__ void unpack8(int4 q, int* x) {
  const int w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = static_cast<int16_t>(w[k] & 0xFFFF);
    x[2 * k + 1] = w[k] >> 16;
  }
}

// The range tests of 8 values (bit i: value i): byte 0 in 4..7, byte 1 in
// -7..-4, byte 2 in 5..7, byte 3 in -7..-5.
__device__ __forceinline__ uint32_t offset_y_flags(int4 q) {
  int x[8];
  unpack8(q, x);
  uint32_t f = 0;
#pragma unroll
  for (int i = 0; i < 8; ++i)
    f |= (uint32_t(unsigned(x[i] - 4) <= 3u) << i) |
         (uint32_t(unsigned(x[i] + 7) <= 3u) << (8 + i)) |
         (uint32_t(unsigned(x[i] - 5) <= 2u) << (16 + i)) |
         (uint32_t(unsigned(x[i] + 7) <= 2u) << (24 + i));
  return f;
}

// What a row's step writes, as codes a position: 0 its input, 1 10100, 2
// 12700, 3 12900, 4 12100, 5 12200, 6 10300, 7 10204; entry idx of the
// table merges two columns' codes into a 32-bit word (mask, value), idx
// bits 0-1 the two columns' code bit 0, bits 2-3 bit 1, bits 4-5 bit 2.
__device__ __forceinline__ uint32_t offset_y_code_value(int code) {
  switch (code) {
    case 1: return 10100;
    case 2: return 12700;
    case 3: return 12900;
    case 4: return 12100;
    case 5: return 12200;
    case 6: return 10300;
    case 7: return 10204;
    default: return 0;
  }
}
__device__ __forceinline__ uint2 offset_y_code_pair(int idx) {
  const int lo = (idx & 1) | ((idx >> 1) & 2) | ((idx >> 2) & 4);
  const int hi = ((idx >> 1) & 1) | ((idx >> 2) & 2) | ((idx >> 3) & 4);
  return make_uint2((lo ? 0xFFFFu : 0u) | (hi ? 0xFFFF0000u : 0u),
                    offset_y_code_value(lo) | (offset_y_code_value(hi) << 16));
}

// fired = f and an even offset within f's run, over a warp's row of 256
// positions, 8 a lane (bit i: position 8 lane + i).  Within the lane, a run
// starting at an even bit fires its even bits and one starting at an odd
// bit its odd bits (adding its start bit clears a run); the state before
// the lane's bit 0 is the last bit fired by the nearest lane below that
// holds a non-candidate (a lane of 8 candidates passes it through), and
// where it fired, the lane's leading run flips.
__device__ __forceinline__ unsigned run_parity_row(unsigned f, int lane) {
  const unsigned starts = f & ~(f << 1);
  const unsigned even = f & ~(f + (starts & 0x55u));
  const unsigned fired = (even & 0x55u) | (f & ~even & 0xAAu);
  const unsigned gaps = __ballot_sync(kFull, f != 0xFFu);
  const unsigned last = __ballot_sync(kFull, (fired >> 7) & 1u);
  const unsigned below = gaps & ((1u << lane) - 1u);
  const unsigned e = below ? (last >> (31 - __clz(below))) & 1u : 0u;
  return fired ^ (f & ~(f + 1u) & (0u - e));
}

// Row r of passes 2-3 on a warp: fr, fn the lane's range tests of rows r
// and r + 1 (offset_y_flags), pend the lane's bits of row r - 1's vertical
// writes, cur its 8 input values of row r.  Stores row r's output at dst
// and returns row r + 1's pend.
__device__ __forceinline__ unsigned offset_y_row(uint32_t fr, uint32_t fn,
                                                 unsigned pend, int4 cur,
                                                 const uint2* tab, int lane,
                                                 int16_t* dst) {
  // a pended value is 10100: in no range
  const unsigned pv = fr & ~pend & 0xFFu, nv = (fr >> 8) & ~pend & 0xFFu;
  const unsigned pn = fn & 0xFFu, nn = (fn >> 8) & 0xFFu;
  // the bits across the lane's edges (columns -1 and 256 masked by ok)
  const unsigned mine = pv | (nv << 8) | (pn << 16) | (nn << 24);
  const unsigned lo = __shfl_up_sync(kFull, mine, 1);
  const unsigned hi = __shfl_down_sync(kFull, mine, 1);
  const unsigned ok = lane == 0 ? 0xFEu : (lane == 31 ? 0x7Fu : 0xFFu);
  const unsigned fp = ok & pv & ((pv << 1) | ((lo >> 7) & 1u));
  const unsigned fm = ok & nv & ((nv << 1) | ((lo >> 15) & 1u));
  const unsigned fph = fp & ((pv >> 1) | ((hi & 1u) << 7));
  const unsigned fmh = fm & ((nv >> 1) | (((hi >> 8) & 1u) << 7));
  const unsigned fpv = fp & ~fph & pn & ((pn << 1) | ((lo >> 23) & 1u));
  const unsigned fmv = fm & ~fmh & nn & ((nn << 1) | (lo >> 31));
  const unsigned h = fph | fmh;
  const unsigned fired = run_parity_row(h | fpv | fmv, lane);
  const unsigned fh = fired & h, fvp = fired & fpv, fvm = fired & fmv;
  // a fire at j writes onto j - 1: 10100 (horizontal), 12100, 12200
  const unsigned up =
      __shfl_down_sync(kFull, (fh & 1u) | ((fvp & 1u) << 1) | ((fvm & 1u) << 2),
                       1) &
      (lane < 31 ? 7u : 0u);
  const unsigned w1 = (fh >> 1) | ((up & 1u) << 7);
  const unsigned w4 = (fvp >> 1) | (((up >> 1) & 1u) << 7);
  const unsigned w5 = (fvm >> 1) | ((up >> 2) << 7);
  const unsigned fv = fvp | fvm, w = w1 | w4 | w5;
  const unsigned pend_next = (fv | (fv >> 1) | ((w4 | w5) & 0x80u)) & 0xFFu;
  const unsigned m1 = w1 | ((pend | fv) & ~w), m2 = fh & fph & ~w,
                 m3 = fh & fmh & ~w;
  // pass 3 on the finished row: own writes only, on values left as input
  const unsigned keep = ~(pend | fired | w) & 0xFFu;
  const unsigned p3 = (fr >> 16) & keep, n3 = (fr >> 24) & keep;
  const unsigned r3 = __shfl_down_sync(kFull, p3 | (n3 << 8), 1);
  const unsigned ok3 = lane == 31 ? 0x7Fu : 0xFFu;
  const unsigned f3p = ok3 & p3 & ((p3 >> 1) | ((r3 & 1u) << 7));
  const unsigned f3n = ok3 & n3 & ((n3 >> 1) | (((r3 >> 8) & 1u) << 7));
  const unsigned fired3 = run_parity_row(f3p | f3n, lane);
  const unsigned m6 = fired3 & f3p, m7 = fired3 & f3n;
  const unsigned c0 = m1 | m3 | w5 | m7, c1 = m2 | m3 | m6 | m7,
                 c2 = w4 | w5 | m6 | m7;
  uint32_t word[4] = {uint32_t(cur.x), uint32_t(cur.y), uint32_t(cur.z),
                      uint32_t(cur.w)};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const uint2 e = tab[((c0 >> 2 * k) & 3u) | (((c1 >> 2 * k) & 3u) << 2) |
                        (((c2 >> 2 * k) & 3u) << 4)];
    word[k] = (word[k] & ~e.x) | e.y;
  }
  *reinterpret_cast<int4*>(dst) =
      make_int4(int(word[0]), int(word[1]), int(word[2]), int(word[3]));
  return pend_next;
}

// A warp's band (local rows r0.. of the stage) from the entry pend;
// returns its exit.  img: the band's first row in the plane.
__device__ __forceinline__ unsigned offset_y_band(const int16_t* rows,
                                                  const uint32_t* flags,
                                                  const uint2* tab,
                                                  int16_t* img, int r0,
                                                  int lane, unsigned pend) {
  uint32_t fn = flags[r0 * kOyVecs + lane];
#pragma unroll 2
  for (int r = r0; r < r0 + kOyBandRows; ++r) {
    const uint32_t fr = fn;
    fn = flags[(r + 1) * kOyVecs + lane];
    const int4 cur = *reinterpret_cast<const int4*>(rows + r * kD + 8 * lane);
    pend = offset_y_row(fr, fn, pend, cur, tab, lane,
                        img + (r - r0) * kN + 8 * lane);
  }
  return pend;
}

// What a CTA of passes 2-3 holds: its kOyRows input rows and the next
// CTA's first, their range tests, the code table, and the relay: its
// bands' exits, the entry relayed from the CTA above (DSM) and each CTA's
// "an entry moved" (DSM).
struct OffsetYStage {
  int16_t rows[(kOyRows + 1) * kD];
  uint32_t flags[(kOyRows + 1) * kOyVecs];
  uint2 tab[64];
  uint8_t exits[kOyWarps][32];
  uint8_t entry_in[32];
  int moved[kOyCtas];
};

__global__ void __launch_bounds__(kOyThreads)
    offset_y_bands(int16_t* __restrict__ plane) {
  __shared__ __align__(16) OffsetYStage st;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int r0 = rank * kOyRows;
  int16_t* img = plane + static_cast<size_t>(blockIdx.y) * kPlane;
  for (int i = t; i < (kOyRows + 1) * kOyVecs; i += kOyThreads)
    __pipeline_memcpy_async(
        st.rows + i * 8, img + (r0 + i / kOyVecs) * kN + (i % kOyVecs) * 8,
        16);
  __pipeline_commit();
  if (t < 64) st.tab[t] = offset_y_code_pair(t);
  __pipeline_wait_prior(0);
  __syncthreads();
  for (int i = t; i < (kOyRows + 1) * kOyVecs; i += kOyThreads)
    st.flags[i] =
        offset_y_flags(*reinterpret_cast<const int4*>(st.rows + i * 8));
  cluster.sync();        // staged, every peer started
  const bool walks = w < kOyWarps;
  const int br = w * kOyBandRows;          // the warp's band, local rows
  int16_t* band_img = img + (r0 + br) * kN;
  unsigned entry = 0, pend = 0;
  if (walks)
    pend = offset_y_band(st.rows, st.flags, st.tab, band_img, br, lane, 0);
  for (int s = 1; s < kOyBands; ++s) {
    if (walks) {
      if (w < kOyWarps - 1)
        st.exits[w][lane] = static_cast<uint8_t>(pend);
      else if (rank < kOyCtas - 1)
        *cluster.map_shared_rank(&st.entry_in[lane], rank + 1) =
            static_cast<uint8_t>(pend);
    }
    cluster.sync();
    const unsigned want = !walks ? 0u
                          : w > 0 ? st.exits[w - 1][lane]
                          : rank > 0 ? st.entry_in[lane] : 0u;
    const bool moved = walks && __any_sync(kFull, want != entry);
    const int any = __syncthreads_or(moved);
    if (t < kOyCtas) *cluster.map_shared_rank(&st.moved[rank], t) = any;
    cluster.sync();
    int again = 0;
#pragma unroll
    for (int c = 0; c < kOyCtas; ++c) again |= st.moved[c];
    if (!again) break;
    if (moved) {
      entry = want;
      pend = offset_y_band(st.rows, st.flags, st.tab, band_img, br, lane,
                           entry);
    }
  }
  // row 255's vertical writes land in plane row 256
  if (rank == kOyCtas - 1 && w == kOyWarps - 1 && pend) {
    int4 row =
        *reinterpret_cast<const int4*>(st.rows + kOyRows * kD + 8 * lane);
    int16_t* x = reinterpret_cast<int16_t*>(&row);
#pragma unroll
    for (int i = 0; i < 8; ++i) x[i] = ((pend >> i) & 1u) ? 10100 : x[i];
    *reinterpret_cast<int4*>(img + kD * kN + 8 * lane) = row;
  }
}

__device__ __forceinline__ int sentinel_code(int a) {
  int c = a;
  c = a == 10100 ? 128 : c;
  c = a == 12700 ? 127 : c;
  c = a == 12900 ? 129 : c;
  c = a == 10204 ? 125 : c;
  c = a == 10300 ? 126 : c;
  c = a == 12100 ? 121 : c;
  c = a == 12200 ? 122 : c;
  return c;
}

// |a| > 127 escape words; esc: (2, 19) int32, EXTRA_WORDS1 then
// EXTRA_WORDS2.
__device__ __forceinline__ int escape_code(int a, const int* __restrict__ esc) {
  if (a > 127) return esc[min(max(((a & 0xfff8) - 128) >> 3, 0), 18)];
  return esc[19 + min(max((((-a) & 0xfff8) - 128) >> 3, 0), 18)];
}

// Pass 4 (image_processing.c:312-520): the fixup write onto x from x - 1,
// then the code map; one thread a position.
__global__ void __launch_bounds__(kCodeThreads)
    offset_y_codes(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                   const int* __restrict__ esc, int total, int m1) {
  const int i = blockIdx.x * kCodeThreads + threadIdx.x;
  if (i >= total) return;
  const int x = i % kPlane;
  const int f = in[i];
  const int il = x + 1 < kPlane ? in[i + 1] : 0;
  const bool incol = (x & (kN - 1)) < 2 * kD - 1;
  int a = f;
  if (x > 0 && ((x - 1) & (kN - 1)) < 2 * kD - 1) {
    const int fp = in[i - 1];   // the left position; its right is f
    const bool w_m9 = fp < -12 && ((-fp) & 7) == 6 && f == -7;
    const bool w_m8 = fp == 8 && f == -7;
    const bool w_9 = fp >= 0 && fp != 8 && fp > 12 && (fp & 7) >= 6 && f == 7;
    const bool plain = fp < 10000 && fp >= -10000 && iabs(fp) <= 127;
    if (plain && (w_m9 || w_m8 || w_9)) a = w_m9 ? -9 : (w_m8 ? -8 : 9);
  }
  int o;
  if (f == 0) {
    o = 128;
  } else if (a > 10000) {
    o = sentinel_code(a);
  } else if (a > 127 || a < -127) {
    o = escape_code(a, esc);
  } else {
    const int a2 = (a == -7 && il == 8 && incol) ? -8 : a;
    int an = -a2;
    if (an > 14 && (an & 7) == 7 && il > 0 && il < 8) an -= 2;
    if ((an & 7) < 7) an &= 504;
    const int aq = a2 < 0 ? -an : a2;
    o = (aq > -m1 && aq < m1) ? 128 : ((aq + 128) & 248);
  }
  out[i] = static_cast<int16_t>(o);
}

// ---------------------------------------------------------------------------
// S10: offset_y_low4, q <= LOW4
//
// States (the header's): 0..2 quant4 with nothing pending, 3..5 quant4
// with a fixup pending, 6 quant4 1 with the input - 2 pending (up), 7 the
// input + 2 (down).  A table holds the next state of each, 3 bits a state.
// States 3..5 go to 0..2 (no rule fires on a fixup's value) and 6, 7 to 1:
// the pending value is the input -+ 2 of an input the pair rule took (>=
// 14, & 6 == 6), so its & 7 is 4, 5, 0 or 1, which neither the pair rule
// nor a fixup takes.

constexpr uint32_t kOy4Fixed = 0u << 9 | 1u << 12 | 2u << 15 | 1u << 18 |
                               1u << 21;                          // 3..7
constexpr uint32_t kOy4Ident = 0xFAC688u;                         // 0..7
constexpr int kOy4Neg = 1 << 20;   // a walked value: a plain negative's an

// A position's table from its input i0 and the next two, i1 and i2: the
// rules at i0 for states 0..2 (a fixup writes the next position; the
// quant4 pair rule fires where quant4 is 0, else advances it), compares
// combined with & and |.
__device__ __forceinline__ uint32_t oy4_table(int i0, int i1, int i2,
                                              bool incol, bool reg4,
                                              bool r2ok) {
  const bool plain = (unsigned(i0 + 127) <= 254u) & (i0 != 0);
  const bool fix = plain & incol &
                   (((i1 == -7) & (((i0 < -12) & (((-i0) & 7) == 6)) |
                                   (i0 == 8))) |
                    ((i1 == 7) & (i0 > 12) & ((i0 & 7) >= 6)));
  const bool pair = plain & reg4 & (i0 >= 14) & (i1 >= 14) &
                    ((i0 & 6) == 6) & ((i1 & 6) == 6) & (((i0 | i1) & 1) != 0);
  const bool same = (i0 & 504) == (i1 & 504);
  const bool up = same ? i0 >= i1 : i0 <= i1;
  const bool r2 = r2ok & (((i2 > -8) & (i2 < -2)) |
                          ((i2 < -7) & (((-i2) & 7) >= 6)));
  const uint32_t n0 = fix ? 3u : !pair ? 0u : up ? 6u : r2 ? 1u : 7u;
  const uint32_t n1 = 1u + uint32_t(pair) + 3u * uint32_t(fix);
  const uint32_t n2 = 2u + 3u * uint32_t(fix) - 2u * uint32_t(pair);
  return n0 | n1 << 3 | n2 << 6 | kOy4Fixed;
}

__device__ __forceinline__ int oy4_at(uint32_t f, int s) {
  return (f >> (3 * s)) & 7;
}

// The map of f, then g (8 states).
__device__ __forceinline__ uint32_t oy4_then(uint32_t f, uint32_t g) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) r |= uint32_t(oy4_at(g, oy4_at(f, s))) << (3 * s);
  return r;
}

// The 5-state map of a row (entry state 0, 1, 2, 6, 7 -> exit state, as
// 0..4) from its 8-state composite.
__device__ __forceinline__ uint32_t oy4_row_map(uint32_t m) {
  uint32_t r = 0;
#pragma unroll
  for (int k = 0; k < 5; ++k) {
    const int s = oy4_at(m, k < 3 ? k : k + 3);
    r |= uint32_t(s < 3 ? s : s - 3) << (3 * k);
  }
  return r;
}

__device__ __forceinline__ uint32_t ld_relaxed32(const uint32_t* p) {
  uint32_t v;
  asm volatile("ld.relaxed.gpu.global.u32 %0, [%1];"
               : "=r"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed32(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// A tile's look-back word: 0, then kOy4Agg | its composite (15 bits),
// then also kOy4Incl | its exit state << 16.  A 32-bit word written
// whole, so a reader sees 0, the composite or both.
constexpr uint32_t kOy4Agg = 1u << 31;
constexpr uint32_t kOy4Incl = 1u << 30;

// Lane l's 16 values of row r of one image's pass-1 output, and the two
// after them (the next lane's first, or the next row's columns 0 and 1; 0
// past the plane), loaded in 16-byte loads.
__device__ __forceinline__ void oy4_load(const int16_t* I, int r, int lane,
                                         int* x) {
  const uint4* p = reinterpret_cast<const uint4*>(I + r * kN + kOy4Tile * lane);
  const uint4 q0 = p[0], q1 = p[1];
  const uint32_t wd[8] = {q0.x, q0.y, q0.z, q0.w, q1.x, q1.y, q1.z, q1.w};
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    x[2 * k] = static_cast<int16_t>(wd[k] & 0xFFFFu);
    x[2 * k + 1] = static_cast<int16_t>(wd[k] >> 16);
  }
  const uint32_t nx = lane == 31 && r + 1 < kN
                          ? *reinterpret_cast<const uint32_t*>(I + (r + 1) * kN)
                          : 0u;
  x[kOy4Tile] = __shfl_down_sync(kFull, x[0], 1);
  x[kOy4Tile + 1] = __shfl_down_sync(kFull, x[1], 1);
  if (lane == 31) {
    x[kOy4Tile] = static_cast<int16_t>(nx & 0xFFFFu);
    x[kOy4Tile + 1] = static_cast<int16_t>(nx >> 16);
  }
}

struct Oy4Shared {
  int esc[38];
  uint32_t row_map[kOy4Warps];
  uint32_t row_pre[kOy4Warps];
  int job, entry;
};

// One warp a row of pass 1's output (tmp), kOy4Warps rows a CTA (a tile
// of the look-back), each CTA an image's tile by its ticket (tile-major:
// it waits only on tiles that started before it).  Lane l takes columns
// 16 l..16 l + 15: their tables once, composed into the lane's map of 8
// states; the warp scans the 32 maps, and lane 31's composite gives the
// row's map from its 5 entry states.  Warp 0 composes the CTA's rows,
// publishes the composite, looks back to its entry and publishes its
// exit; then each lane walks its columns again from its entry state (a
// table lookup a step, the value of its state's class), the warp counts
// the ticks before each lane (a shuffle scan of popcounts), and each
// lane writes its 16 codes in two 16-byte stores.
__global__ void __launch_bounds__(kOy4Warps * 32, 1)
    oy4_rows(const int16_t* __restrict__ in, int16_t* __restrict__ out,
             const int* __restrict__ esc, uint32_t* __restrict__ look,
             int batch, int m1) {
  __shared__ Oy4Shared sh;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  if (t == 0) sh.job = static_cast<int>(atomicAdd(look, 1u));
  if (t < 38) sh.esc[t] = esc[t];
  __syncthreads();
  const int tile = sh.job / batch, b = sh.job % batch;
  const int r = tile * kOy4Warps + w;
  const int16_t* I = in + static_cast<size_t>(b) * kPlane;
  int x[kOy4Tile + 2];
  oy4_load(I, r, lane, x);
  const int c0 = kOy4Tile * lane;
  uint32_t tab[kOy4Tile];
  int s[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) s[q] = q;
#pragma unroll
  for (int k = 0; k < kOy4Tile; ++k) {
    const int c = c0 + k;
    tab[k] = oy4_table(x[k], x[k + 1], x[k + 2], c < kN - 1,
                       (r >= kD) | (c >= kD), (c > 0) & (c < kN - 2));
#pragma unroll
    for (int q = 0; q < 8; ++q) s[q] = oy4_at(tab[k], s[q]);
  }
  uint32_t m = 0;
#pragma unroll
  for (int q = 0; q < 8; ++q) m |= uint32_t(s[q]) << (3 * q);
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t f = __shfl_up_sync(kFull, m, d);
    if (lane >= d) m = oy4_then(f, m);
  }
  uint32_t pre = __shfl_up_sync(kFull, m, 1);
  if (lane == 0) pre = kOy4Ident;
  if (lane == 31) sh.row_map[w] = oy4_row_map(m);
  __syncthreads();
  if (w == 0) {
    uint32_t rm = lane < kOy4Warps ? sh.row_map[lane] : kMap5Ident;
    const uint32_t rp = map5_warp_scan(rm, lane);
    if (lane < kOy4Warps) sh.row_pre[lane] = rp;
    const uint32_t agg = __shfl_sync(kFull, rm, kOy4Warps - 1);
    uint32_t* st = look + 1 + static_cast<size_t>(b) * kOy4Tiles;
    int e = 0;
    if (tile > 0) {
      if (lane == 0) st_relaxed32(st + tile, kOy4Agg | agg);
      const int pj = tile - 1 - lane;
      uint32_t v = 0;
      if (pj >= 0) {
        do {
          v = ld_relaxed32(st + pj);
        } while (v == 0);
      }
      // the nearest tile whose exit is out (tile 0's always comes), then
      // the composites after it
      const unsigned inc = __ballot_sync(kFull, (v & kOy4Incl) != 0);
      const int first = __ffs(inc) - 1;
      e = __shfl_sync(kFull, static_cast<int>((v >> 16) & 7u), first);
      for (int i = first - 1; i >= 0; --i)
        e = map5_at(__shfl_sync(kFull, v & 0x7FFFu, i), e);
    }
    if (lane == 0) {
      st_relaxed32(st + tile, kOy4Agg | kOy4Incl | agg |
                                  uint32_t(map5_at(agg, e)) << 16);
      sh.entry = e;
    }
  }
  __syncthreads();
  const int e5 = map5_at(sh.row_pre[w], sh.entry);
  int st = oy4_at(pre, e5 < 3 ? e5 : e5 + 3);
  // the walk again: each position's value from its state's class, the
  // plain negatives as kOy4Neg | an (coded once the ticks are counted)
  uint32_t t15 = 0, t22 = 0;
#pragma unroll
  for (int k = 0; k < kOy4Tile; ++k) {
    const int i0 = x[k], i1 = x[k + 1];
    const bool incol = c0 + k < kN - 1;
    const int a0 = st < 3   ? i0
                   : st < 6 ? (i0 == 7 ? 9 : -8)
                   : st == 6 ? i0 - 2
                             : i0 + 2;
    st = oy4_at(tab[k], st);
    const bool neg = unsigned(a0 + 127) < 127u;      // -127..-1
    const int a1 = ((a0 == -7) & (i1 == 8) & incol) ? -8 : a0;
    int an = -a1;
    an -= ((an > 14) & ((an & 7) == 7) & (i1 > 0) & (i1 < 8)) ? 2 : 0;
    const bool is15 = neg & (an == 15);
    const bool is22 = neg & (an != 15) & (an > 22) & ((an & 7) == 7);
    t15 |= uint32_t(is15) << k;
    t22 |= uint32_t(is22) << k;
    const int a = a0 + (st == 6 ? 2 : 0);
    const int dz = (a > -m1) & (a < m1) ? 128 : ((a + 128) & 248);
    const int ek = a0 > 127 ? ((a0 & 0xfff8) - 128) >> 3
                            : 19 + ((((-a0) & 0xfff8) - 128) >> 3);
    const int ec = sh.esc[a0 > 127 ? min(max(ek, 0), 18)
                                   : min(max(ek, 19), 37)];
    int v = a0 == 0                       ? 128
            : a0 > 10000                  ? sentinel_code(a0)
            : (a0 > 127) | (a0 < -127)    ? ec
            : neg                         ? kOy4Neg | an
                                          : dz;
    x[k] = v;
  }
  // the ticks before the lane: quant and quant6 from the row's start
  const uint32_t cnt = __popc(t15) | __popc(t22) << 16;
  uint32_t incl = cnt;
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t y = __shfl_up_sync(kFull, incl, d);
    if (lane >= d) incl += y;
  }
  const uint32_t ex = incl - cnt;
  int q15 = static_cast<int>(ex & 0xFFFFu) % 6, q22 = (ex >> 16) & 3;
  uint32_t o[8];
#pragma unroll
  for (int k = 0; k < kOy4Tile; ++k) {
    const int v = x[k];
    const bool is15 = (t15 >> k) & 1u, is22 = (t22 >> k) & 1u;
    const bool keep = (is15 & (q15 != 0)) | (is22 & (q22 != 0));
    q15 = is15 ? (q15 == 5 ? 0 : q15 + 1) : q15;
    q22 = is22 ? (q22 + 1) & 3 : q22;
    const int an = v & 0xFFFF;
    const int a = -(keep ? an : an & 504);
    const int code =
        (v & kOy4Neg) ? ((a > -m1) & (a < m1) ? 128 : ((a + 128) & 248)) : v;
    if (k & 1)
      o[k >> 1] |= (static_cast<uint32_t>(code) & 0xFFFFu) << 16;
    else
      o[k >> 1] = static_cast<uint32_t>(code) & 0xFFFFu;
  }
  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * kPlane +
                                        r * kN + c0);
  dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
}

// ---------------------------------------------------------------------------
// S3: merge_crossing
//
// A position's step is fixed by its bytes: the cursor's skip k (1..5; 1 at
// or past the walk's end) and whether a fire pattern stands there.  In
// bit masks over 32 positions (bit i: position i), with E the bytes equal
// to 128 and A those equal to 136 or 120: c1 = ~E & E >> 1, c2 = c1 & E >>
// 2, c3 = c2 & E >> 3, fire = c3 & A & A >> 4, and k - 1 is the sum of
// the four bits.  The cursor's state before a position is its skips left
// (0..4), so a run of positions is a map of 5 states, 3 bits each in 15
// bits (merge_step advances all five at once), and maps compose.

// 4 bits, bit i set where byte i of m is 0xFF (m from __vcmpeq4), and back.
__device__ __forceinline__ uint32_t byte_bits(uint32_t m) {
  return ((m & 0x08040201u) * 0x01010101u) >> 24;
}

__device__ __forceinline__ uint32_t bits_bytes(uint32_t b) {
  return ((b * 0x00204081u) & 0x01010101u) * 0xFFu;
}

// The steps of 32 positions from their 36 bytes (w[0..8]), as bit planes
// of k - 1 (0..4: b0, b1, b2 = the fire pattern f); live: the positions
// before the walk's end.
struct MergeBits {
  uint32_t b0, b1, f;
};

__device__ __forceinline__ MergeBits merge_bits(const uint32_t* w,
                                                uint32_t live) {
  uint64_t e = 0, a = 0;
#pragma unroll
  for (int k = 0; k < 9; ++k) {
    e |= uint64_t(byte_bits(__vcmpeq4(w[k], 0x80808080u))) << (4 * k);
    a |= uint64_t(byte_bits(__vcmpeq4(w[k], 0x88888888u) |
                            __vcmpeq4(w[k], 0x78787878u)))
         << (4 * k);
  }
  const uint32_t c1 = ~uint32_t(e) & uint32_t(e >> 1) & live;
  const uint32_t c2 = c1 & uint32_t(e >> 2);
  const uint32_t c3 = c2 & uint32_t(e >> 3);
  const uint32_t f = c3 & uint32_t(a) & uint32_t(a >> 4);
  // k - 1 = 1 on c1 & ~c2, 2 on c2 & ~c3, 3 on c3 & ~f, 4 on f
  return MergeBits{(c1 & ~c2) | (c3 & ~f), c2 & ~f, f};
}

__device__ __forceinline__ int merge_km1(const MergeBits& m, int i) {
  return ((m.b0 >> i) & 1) | (((m.b1 >> i) & 1) << 1) |
         (((m.f >> i) & 1) << 2);
}

// One position for all 5 entry states: a state above 0 counts down, 0
// takes the position's k - 1.
__device__ __forceinline__ uint32_t merge_step(uint32_t p, int km1) {
  const uint32_t t = (p | (p >> 1) | (p >> 2)) & kMOnes;
  return p - t + (~t & kMOnes) * static_cast<uint32_t>(km1);
}

// A thread's two plane sets (positions 0..31 and 32..63) advance their
// maps together, each from the identity: two independent chains for the
// scheduler.  The loop is unrolled 4 at a time, not 32: unrolled whole, the
// compiler takes every position's step out of the walk ahead of it and
// spills.  Also returns the second set's map over its first 28 positions.
__device__ __forceinline__ void merge_maps(const MergeBits* mb,
                                           uint32_t& p0, uint32_t& p1,
                                           uint32_t& p28) {
  p0 = p1 = p28 = kMap5Ident;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    if (i == 28) p28 = p1;
    p0 = merge_step(p0, merge_km1(mb[0], i));
    p1 = merge_step(p1, merge_km1(mb[1], i));
  }
}

// The walks again of both plane sets, from their entry states s0 and s1:
// their fire bits; s1 ends as the thread's exit state.
__device__ __forceinline__ void merge_walk(const MergeBits* mb, int s0,
                                           int s1, uint32_t* fires) {
  fires[0] = fires[1] = 0;
#pragma unroll 4
  for (int i = 0; i < 32; ++i) {
    const bool z0 = s0 == 0, z1 = s1 == 0;
    fires[0] |= uint32_t(z0 & ((mb[0].f >> i) & 1u)) << i;
    fires[1] |= uint32_t(z1 & ((mb[1].f >> i) & 1u)) << i;
    s0 = z0 ? merge_km1(mb[0], i) : s0 - 1;
    s1 = z1 ? merge_km1(mb[1], i) : s1 - 1;
  }
}

struct MergeShared {
  uint32_t warp_map[kMWarps];       // each warp's composite
  uint32_t warp_pre[kMWarps];       // the composite of the warps before it
  uint32_t last[3];                 // the CTA's last thread, see below
  uint32_t last_fires[kMWarps];     // lane 31's fires at its last 4
  unsigned long long pub[kMCtas];   // each CTA's composite, partial, fires
};

// A cluster of 8 CTAs a stream, 512 threads of 64 positions each: thread t
// of CTA r owns positions g0 = 32768 r + 64 t .. g0 + 63, loads them and
// the next 4 bytes in 16-byte (and one 4-byte) loads, builds their step
// masks and their map once (its two halves as two chains), and the warp
// scans its 32 maps with shuffles.
// Warp 0 scans the 16 warp composites and pushes the CTA's word to every
// CTA of the cluster (DSM) before one cluster barrier: the CTA's composite,
// its partial map (positions up to its last 4) and the fires of those 4
// from each state, so that each CTA finds its entry state and the fires
// whose 201 lands in its first 4 bytes.  Each thread walks its positions
// again from its entry state for its fire bits; lane 31's last 4 go to the
// next thread by shuffle (across warps through shared memory), and the
// thread writes its 64 bytes in 16-byte stores: out[i] = fire[i - 4] ? 201
// : fire[i] ? code[i] : v[i], a word at a time.  Every byte has one writer.
// The CTAs copy the stream past 4 SZ in 16-byte chunks.  A row that is not
// 16-byte aligned (in or out) is read and written a byte at a time.
__global__ void __launch_bounds__(kMThreads, 2)
    merge_crossing(const uint8_t* __restrict__ in, uint8_t* __restrict__ out,
                   int n) {
  __shared__ MergeShared sh;
  nhw::cluster_arrive_relaxed();
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const size_t base = static_cast<size_t>(blockIdx.y) * n;
  const uint8_t* src = in + base;
  uint8_t* dst = out + base;
  const bool vec = ((reinterpret_cast<uintptr_t>(src) |
                     reinterpret_cast<uintptr_t>(dst)) & 15) == 0;
  const int g0 = rank * kMSpan + t * kMT;
  uint32_t v[kMWords + 1];
  if (vec) {
    const uint4* s4 = reinterpret_cast<const uint4*>(src + g0);
#pragma unroll
    for (int k = 0; k < kMWords / 4; ++k) {
      const uint4 q = s4[k];
      v[4 * k] = q.x;
      v[4 * k + 1] = q.y;
      v[4 * k + 2] = q.z;
      v[4 * k + 3] = q.w;
    }
    v[kMWords] = g0 + kMT < kMLen
                     ? *reinterpret_cast<const uint32_t*>(src + g0 + kMT)
                     : 0u;
  } else {
#pragma unroll
    for (int k = 0; k <= kMWords; ++k) {
      uint32_t x = 0;
      if (g0 + 4 * k < kMLen)
        for (int i = 0; i < 4; ++i)
          x |= uint32_t(src[g0 + 4 * k + i]) << (8 * i);
      v[k] = x;
    }
  }
  MergeBits mb[2];
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int lim = kMEnd - (g0 + 32 * h);
    mb[h] = merge_bits(v + 8 * h, lim >= 32  ? ~0u
                                  : lim <= 0 ? 0u
                                             : (1u << lim) - 1u);
  }
  // the thread's map, and (for the CTA's last thread) its map over its
  // first 60 positions and the fires of its last 4 from each state
  uint32_t p0, p1, p28;
  merge_maps(mb, p0, p1, p28);
  const uint32_t p60 = map5_then(p0, p28);
  uint32_t inc = map5_then(p0, p1);
  const uint32_t excl = map5_warp_scan(inc, lane);
  if (lane == 31) sh.warp_map[w] = inc;
  if (t == kMThreads - 1) {
    uint32_t tab = 0;
    for (int s = 0; s < 5; ++s) {
      int st = s;
      for (int i = 28; i < 32; ++i) {
        const bool z = st == 0;
        tab |= uint32_t(z && ((mb[1].f >> i) & 1)) << (4 * s + i - 28);
        st = z ? merge_km1(mb[1], i) : st - 1;
      }
    }
    sh.last[0] = p60;
    sh.last[1] = excl;
    sh.last[2] = tab;
  }
  __syncthreads();
  nhw::cluster_wait();         // every CTA of the cluster has started
  if (w == 0) {
    uint32_t c = lane < kMWarps ? sh.warp_map[lane] : kMap5Ident;
    const uint32_t pre = map5_warp_scan(c, lane);
    if (lane < kMWarps) sh.warp_pre[lane] = pre;
    const uint32_t comp = __shfl_sync(kFull, c, 31);
    const uint32_t last_pre =
        map5_then(__shfl_sync(kFull, pre, kMWarps - 1), sh.last[1]);
    const unsigned long long word =
        comp | (uint64_t(map5_then(last_pre, sh.last[0])) << 15) |
        (uint64_t(sh.last[2]) << 30);
    if (lane < kMCtas) *cluster.map_shared_rank(&sh.pub[rank], lane) = word;
  }
  nhw::cluster_arrive_release();
  nhw::cluster_wait();
  // the CTA's entry state, and the previous CTA's fires at its last 4
  int e = 0, e_prev = 0;
  for (int r = 0; r < rank; ++r) {
    e_prev = e;
    e = map5_at(static_cast<uint32_t>(sh.pub[r]) & 0x7FFFu, e);
  }
  uint32_t prev4 = 0;
  if (rank > 0) {
    const unsigned long long pw = sh.pub[rank - 1];
    const int s = map5_at(static_cast<uint32_t>(pw >> 15) & 0x7FFFu, e_prev);
    prev4 = static_cast<uint32_t>(pw >> (30 + 4 * s)) & 15u;
  }
  const int st = map5_at(excl, map5_at(sh.warp_pre[w], e));
  uint32_t fires[2];
  merge_walk(mb, st, map5_at(p0, st), fires);
  const uint32_t up = __shfl_up_sync(kFull, fires[1] >> 28, 1);
  if (lane == 31) sh.last_fires[w] = fires[1] >> 28;
  __syncthreads();
  uint32_t pf = bits_bytes(lane > 0 ? up : w > 0 ? sh.last_fires[w - 1]
                                                 : prev4);
  uint32_t m136 = __vcmpeq4(v[0], 0x88888888u);
#pragma unroll
  for (int k = 0; k < kMWords; ++k) {
    const uint32_t next136 = __vcmpeq4(v[k + 1], 0x88888888u);
    const uint32_t fm = bits_bytes((fires[k >> 3] >> (4 * (k & 7))) & 15u);
    // 132..135: 135 - 2 (this byte 136) - 1 (the byte 4 on 136)
    const uint32_t code =
        0x87878787u - (m136 & 0x02020202u) - (next136 & 0x01010101u);
    v[k] = (pf & 0xC9C9C9C9u) | (~pf & ((fm & code) | (~fm & v[k])));
    pf = fm;
    m136 = next136;
  }
  if (vec) {
    uint4* d4 = reinterpret_cast<uint4*>(dst + g0);
#pragma unroll
    for (int k = 0; k < kMWords / 4; ++k)
      d4[k] = make_uint4(v[4 * k], v[4 * k + 1], v[4 * k + 2], v[4 * k + 3]);
  } else {
#pragma unroll
    for (int k = 0; k < kMWords; ++k)
      for (int i = 0; i < 4; ++i)
        dst[g0 + 4 * k + i] = static_cast<uint8_t>(v[k] >> (8 * i));
  }
  // the stream past 4 SZ
  const int tail = n - kMLen, gt = rank * kMThreads + t;
  if (vec) {
    const int chunks = tail >> 4;
    const uint4* s4 = reinterpret_cast<const uint4*>(src + kMLen);
    uint4* d4 = reinterpret_cast<uint4*>(dst + kMLen);
    for (int i = gt; i < chunks; i += kMCtas * kMThreads) d4[i] = s4[i];
    if (gt < tail - 16 * chunks)
      dst[kMLen + 16 * chunks + gt] = src[kMLen + 16 * chunks + gt];
  } else {
    for (int i = gt; i < tail; i += kMCtas * kMThreads)
      dst[kMLen + i] = src[kMLen + i];
  }
}

const nhw::ClusterKernel& merge_kernel() {
  static const nhw::ClusterKernel k =
      nhw::cluster_setup(merge_crossing, kMCtas, kMThreads, 0);
  return k;
}

bool misaligned(std::initializer_list<std::pair<const void*, int>> ptrs) {
  for (const auto& p : ptrs)
    if (reinterpret_cast<uintptr_t>(p.first) % p.second != 0) return true;
  return false;
}

}  // namespace

extern "C" {

// S1.  in, out: (B, 512, 512) int16, 16-byte aligned; args: n regions
// of 10 ints each (r0, r1, col0, col1, thr, yw, yw2, second_rule,
// snap_guard6, gc), walked in order: region rows [r0, r1), columns
// [col0, col1), col1 <= 512 (the spill write lands on column col1 when it
// is below 512).  The caller guarantees that no region's reads of the rows
// above and below touch what an earlier region writes.
int nhw_snap_passes(const void* in, void* out, int batch, int n,
                    const int* args, void* stream) {
  if (batch < 1 || batch > (1 << 21) / kN * kSnapWarps || n < 1 ||
      n > kSnapMax || args == nullptr)
    return cudaErrorInvalidValue;
  if (misaligned({{in, 16}, {out, 16}})) return cudaErrorMisalignedAddress;
  SnapList list{};
  list.n = n;
  for (int k = 0; k < n; ++k) {
    const int* p = args + 10 * k;
    list.v[k] = SnapArgs{p[0], p[1], p[2], p[3], p[4],
                         p[5], p[6], p[7], p[8], p[9]};
    const SnapArgs& a = list.v[k];
    if (a.r0 < 0 || a.r0 >= a.r1 || a.r1 > kN || a.col0 < 0 ||
        a.col0 >= a.col1 || a.col1 > kN)
      return cudaErrorInvalidValue;
  }
  const int rows = batch * kN;
  snap_passes<<<(rows + kSnapWarps - 1) / kSnapWarps, kSnapWarps * 32, 0,
                static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), batch,
      list);
  return cudaGetLastError();
}

// S2.  in, tmp, out: (B, 512, 512) int16 (tmp holds passes 1-3); esc: (2,
// 19) int32 escape words.
int nhw_offset_y(const void* in, void* tmp, void* out, const void* esc,
                 int batch, int m1, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned({{in, 16}, {tmp, 16}, {out, 2}, {esc, 4}}))
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int16_t*>(tmp);
  offset_y_rows<<<dim3(kN / kRows, batch), kRows, 0, s>>>(
      static_cast<const int16_t*>(in), t);
  cudaLaunchAttribute dims = nhw::cluster_dims(kOyCtas);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kOyCtas, batch, 1);
  cfg.blockDim = dim3(kOyThreads, 1, 1);
  cfg.stream = s;
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(&cfg, offset_y_bands, t);
  if (e != cudaSuccess) return e;
  const int total = batch * kPlane;
  offset_y_codes<<<(total + kCodeThreads - 1) / kCodeThreads, kCodeThreads,
                   0, s>>>(t, static_cast<int16_t*>(out),
                           static_cast<const int*>(esc), total, m1);
  return cudaGetLastError();
}

// S10.  in, tmp, out: (B, 512, 512) int16, 16-byte aligned (tmp holds pass
// 1); look: (1 + B * 32) u32, the look-back's ticket and words (zeroed
// here); esc: (2, 19) int32 escape words.  A fill and two launches.
int nhw_offset_y_low4(const void* in, void* tmp, void* look, void* out,
                      const void* esc, int batch, int m1, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned({{in, 16}, {tmp, 16}, {look, 4}, {out, 16}, {esc, 4}}))
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int16_t*>(tmp);
  auto* lb = static_cast<uint32_t*>(look);
  cudaError_t e = cudaMemsetAsync(
      lb, 0, sizeof(uint32_t) * (1 + static_cast<size_t>(batch) * kOy4Tiles),
      s);
  if (e != cudaSuccess) return e;
  offset_y_rows<<<dim3(kN / kRows, batch), kRows, 0, s>>>(
      static_cast<const int16_t*>(in), t);
  oy4_rows<<<batch * kOy4Tiles, kOy4Warps * 32, 0, s>>>(
      t, static_cast<int16_t*>(out), static_cast<const int*>(esc), lb, batch,
      m1);
  return cudaGetLastError();
}

// S3.  in, out: (B, n) uint8, n >= 4 SZ.  One cluster launch.
int nhw_merge_crossing(const void* in, void* out, int batch, int n,
                       void* stream) {
  if (batch < 1 || batch > 65535 || n < kMLen) return cudaErrorInvalidValue;
  return nhw::launch_cluster(merge_kernel(), merge_crossing, batch,
                             static_cast<cudaStream_t>(stream),
                             static_cast<const uint8_t*>(in),
                             static_cast<uint8_t*>(out), n);
}

// What the card allows for S3's cluster kernel: info[0] registers per
// thread, info[1] shared memory per CTA, info[2] the most clusters
// resident at once.
int nhw_merge_crossing_info(void* info) {
  return nhw::cluster_info(merge_kernel(), info);
}

}  // extern "C"
