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
//    Three launches.
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
//   start, quant4 runs on, and a step may leave a write pending on the next
//   position; at column 511 only the quant4 pair rule can, into the next
//   row's column 0, and only where it fires (quant4 is 1 after).  So a row
//   enters from one of 5 states (quant4 0, 1, 2; or 1 with column 0 pending
//   at its value - 2 or + 2) and leaves in one.  Both walks take 32 staged
//   rows a CTA (as pass 1).  oy4_maps walks every row from every entry
//   state, a thread each, and stores the exit; oy4_emit stages an image's
//   512 maps too, its warp chains them (block_scan.cuh's chain_entries),
//   and each thread walks its row again from its entry state and writes
//   the codes in place, which the CTA writes back whole rows a warp.

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

constexpr int kOy4States = 5;                // S10's entry states a row

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
  switch (a) {
    case 10100: return 128;
    case 12700: return 127;
    case 12900: return 129;
    case 10204: return 125;
    case 10300: return 126;
    case 12100: return 121;
    case 12200: return 122;
    default: return a;
  }
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

struct Oy4State {
  int quant, quant6, quant4, pend_val;
  bool pend, up;    // a write pending on the next position; by the up rule
};

__device__ __forceinline__ Oy4State oy4_entry(int s, int i0) {
  Oy4State st;
  st.quant = st.quant6 = 0;
  st.quant4 = s == 0 ? 0 : (s == 2 ? 2 : 1);
  st.pend = s >= 3;
  st.pend_val = i0 + (s == 3 ? -2 : 2);
  st.up = false;
  return st;
}

// One step of pass 4 (image_processing.c:312-520 with the duty cycles) at
// column c of row r: i0 the position's input value, i1 and i2 the next two
// positions' (a step writes only the next position, where the next step
// starts); the previous position is a code by then, so the pair rule's r1
// is 0.  Returns the code.
__device__ __forceinline__ int oy4_step(Oy4State& st, int i0, int i1, int i2,
                                        int r, int c, int m1,
                                        const int* __restrict__ esc) {
  const int a0 = st.pend ? st.pend_val : i0;
  st.pend = st.up = false;
  if (a0 == 0) return 128;
  if (a0 > 10000) return sentinel_code(a0);
  if (a0 > 127 || a0 < -127) return escape_code(a0, esc);
  const bool incol = c < 2 * kD - 1;
  int a = a0, fix = 0;
  if (a0 < 0) {
    if (a0 < -12 && ((-a0) & 7) == 6 && incol && i1 == -7) fix = -9;
    int an = (a0 == -7 && i1 == 8 && incol) ? 8 : -a0;
    if (an > 14 && (an & 7) == 7 && i1 > 0 && i1 < 8) an -= 2;
    if (an == 15) {
      if (st.quant == 0) {
        an &= 504;
        st.quant = 1;
      } else {
        st.quant = (st.quant + 1) % 6;
      }
    } else if (an > 22 && (an & 7) == 7) {
      if (st.quant6 == 0) {
        an &= 504;
        st.quant6 = 1;
      } else {
        st.quant6 = (st.quant6 + 1) % 4;
      }
    } else {
      an &= 504;
    }
    a = -an;
  } else if (a0 == 8 && i1 == -7 && incol) {
    fix = -8;
  } else if (a0 > 12 && (a0 & 7) >= 6 && incol && i1 == 7) {
    fix = 9;
  }
  if (fix) {
    st.pend = true;
    st.pend_val = fix;
  } else if (a >= 14 && i1 >= 14 && (r >= kD || c >= kD) &&
             ((a & 510) & 7) == 6 && ((i1 & 510) & 7) == 6 &&
             ((a & 1) || (i1 & 1))) {
    if (st.quant4 == 0) {
      const bool same = (a & 504) == (i1 & 504);
      const bool r2 = c > 0 && c < 2 * kD - 2 &&
                      ((i2 > -8 && i2 < -2) || (i2 < -7 && ((-i2) & 7) >= 6));
      if (same ? a >= i1 : a <= i1) {
        a += 2;
        st.pend = st.up = true;
        st.pend_val = i1 - 2;
      } else if (!r2) {
        st.pend = true;
        st.pend_val = i1 + 2;
      }
      st.quant4 = 1;
    } else {
      st.quant4 = (st.quant4 + 1) % 3;
    }
  }
  return (a > -m1 && a < m1) ? 128 : ((a + 128) & 248);
}

// Row r of one image from entry state s, staged at row (kStageAfter
// values past its end); writes the codes in place when kWrite.  Returns
// the exit state.
template <bool kWrite>
__device__ __forceinline__ int oy4_walk(int16_t* row, int r, int s, int m1,
                                        const int* __restrict__ esc) {
  int i0 = row[0], i1 = row[1], i2 = row[2];
  Oy4State st = oy4_entry(s, i0);
  for (int c = 0; c < kN; ++c) {
    const int i3 = row[c + 3];
    const int code = oy4_step(st, i0, i1, i2, r, c, m1, esc);
    if (kWrite) row[c] = static_cast<int16_t>(code);
    i0 = i1;
    i1 = i2;
    i2 = i3;
  }
  return st.pend ? (st.up ? 3 : 4) : st.quant4;
}

// kRows staged rows from every entry state, a thread each: maps (B, 512,
// 5) uint8.
__global__ void __launch_bounds__(kRows * kOy4States)
    oy4_maps(const int16_t* __restrict__ in, uint8_t* __restrict__ maps,
             int m1, const int* __restrict__ esc) {
  __shared__ int16_t s[kRows * nhw::kStagePitch];
  const size_t b = blockIdx.y;
  const int r0 = blockIdx.x * kRows;
  nhw::stage_rows(in + b * kPlane, r0, kRows, s);
  __syncthreads();
  const int k = threadIdx.x / kOy4States, e = threadIdx.x % kOy4States;
  maps[(b * kN + r0 + k) * kOy4States + e] = static_cast<uint8_t>(
      oy4_walk<false>(s + k * nhw::kStagePitch + 1, r0 + k, e, m1, esc));
}

// kN / kRows CTAs an image: each chains the image's maps, then each thread
// walks its staged row from its entry state and writes the codes.
__global__ void __launch_bounds__(kRows)
    oy4_emit(const int16_t* __restrict__ in,
             const uint8_t* __restrict__ maps, int16_t* __restrict__ out,
             int m1, const int* __restrict__ esc) {
  __shared__ int16_t s[kRows * nhw::kStagePitch];
  __shared__ uint8_t map_s[kN * kOy4States];
  __shared__ uint8_t entry_s[kN];
  const size_t b = blockIdx.y;
  const int r0 = blockIdx.x * kRows, k = threadIdx.x;
  nhw::stage_rows(in + b * kPlane, r0, kRows, s);
  const uint8_t* m = maps + b * kN * kOy4States;
  for (int i = k; i < kN * kOy4States; i += kRows) map_s[i] = m[i];
  __syncthreads();
  nhw::chain_entries<kOy4States>(map_s, entry_s, kN);
  __syncthreads();
  oy4_walk<true>(s + k * nhw::kStagePitch + 1, r0 + k, entry_s[r0 + k], m1,
                 esc);
  __syncthreads();
  nhw::unstage_rows(s, kRows, out + b * kPlane, r0);
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
// 1); maps: (B, 512, 5) uint8 scratch; esc: (2, 19) int32 escape words.
int nhw_offset_y_low4(const void* in, void* tmp, void* maps, void* out,
                      const void* esc, int batch, int m1, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned({{in, 16}, {tmp, 16}, {out, 16}, {esc, 4}}))
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int16_t*>(tmp);
  auto* m = static_cast<uint8_t*>(maps);
  const auto* e = static_cast<const int*>(esc);
  const dim3 grid(kN / kRows, batch);
  offset_y_rows<<<grid, kRows, 0, s>>>(static_cast<const int16_t*>(in), t);
  oy4_maps<<<grid, kRows * kOy4States, 0, s>>>(t, m, m1, e);
  oy4_emit<<<grid, kRows, 0, s>>>(t, m, static_cast<int16_t*>(out), m1, e);
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
