// Hand-written Hopper (sm_90a) kernels of the device encode scans' residue
// stage.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (pair_promotion_device / _ref,
// column_ladder_device / _ref, classify_device / _ref).
//
// S4 nhw_pair_promotion replaces nhwcodec_tpu/models/device_scans.py:2070
//    pair_promotion_device (a Jacobi while_loop over the decision plane):
//    _pair_promotion on a (B, 512, 512) int16 plane.  One launch
//    (pair_promotion_rows).
// S5 nhw_column_ladder replaces nhwcodec_tpu/models/device_scans.py:952
//    column_ladder_device (a 255-step lax.scan with the columns as lanes,
//    then column 255's scan twice): res256_column_ladder.  Two launches: the
//    step's table, then 8 CTAs an image.
// S6 nhw_classify replaces nhwcodec_tpu/models/device_scans.py:1105
//    classify_device (a 256-step lax.scan over rows): res256_classify and
//    its counts n1, n3, n5.  One launch (classify_bands).
//
// The bound of each is bytes: a plane (and res256) read once and written
// once, some tens of operations a position.  Each is a chain of dependent
// steps:
// - S4: the C's chain never leaves a row (its 7/-7 promotions and the lower
//   block's vertical cases are dead: 4 < v < 8 and -8 < v < -4 take v = 7,
//   -6 and -7 first), and the two regions, rows 1..254 x columns 257..510
//   and rows 257..510 x columns 1..254, share no row.  The walk's carry
//   between visits is one of nine states, read by a visit through three
//   classes, so a visit is a table of the next state from the inputs and
//   a row is a scan of small maps: one warp a row (every row of the batch,
//   all SMs busy), a lane a tile of 8 columns loaded and stored in 16
//   bytes, the tile's map of three exit states, a warp scan, and each
//   lane's walk again from its entry state (pair_promotion_rows).  One
//   launch.
// - S5: columns 0..254 walk independently (their j + 1 reads are input
//   values: the C walks column j + 1 after column j), so 8 CTAs an image
//   each take a block of 32 columns (the last 31), a lane a column, one
//   warp walking rows 0..254 from shared memory: the CTA stages with
//   cp.async pf rows 0..256 and rf rows 0..257 of its columns and the
//   next (the j + 1 reads) and its 32 band rows (columns 256..511, where
//   column j writes its row j), and the walks read and write them in
//   place, __syncwarp() a step keeping the lanes one step apart.  Column
//   255's flat j + 1 reads land on band column 256 (row k: column k's
//   step-0 band value) and on rf column 0 of the next rows, so CTA 0
//   walks it on a second warp 4 steps behind column 0: that warp first
//   computes every column's step 0 from the input, then follows column
//   0's published row count in shared memory.  The other warps copy what
//   the ladder leaves meanwhile; each CTA then writes its columns' rows,
//   rf rows and band rows whole.  A step is a walk's whole latency, so
//   its if/else chain (14 branches on res, a, b2 and 4 bits) is a table
//   of its effects by classes of res, a and b2 (ladder_table, a first
//   launch; 96 KB, staged with the rest): a lookup, no branches to split
//   the warp.  Two launches.
// - S6: the pf[scan] and rf[cnt] reads are inputs, so the rf codes, the
//   counts and each step's band rule are static; band row j's only chain
//   is its st - 1 read of the value its previous step wrote, and a step
//   reads that value only through 6 classes (<= -8, -7..-1, 0..1, 2,
//   3..7, >= 8; every bp test of the C's rules), so the chain is a scan of
//   6-class maps.  8 CTAs an image, 32 band rows each: the CTA reads its 32
//   columns of rows 0..255 in 16-byte loads, writes their codes and stages
//   their rules transposed (a band row's steps a row of bytes), copies its
//   share of the rest of the plane, then a warp a band row: lane l loads
//   its 8 band values in one 16-byte load, composes their maps, the warp
//   scans the 32 maps with shuffles, and each lane walks its steps again
//   from its entry class.  The counts are summed in the CTA, then one
//   atomicAdd each a CTA.

#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 512;
constexpr int kD = 256;
constexpr int kSZ = 65536;
constexpr int kPlane = kN * kN;
constexpr int kRfExt = kSZ + 1024;   // res256 and the tail the C reads

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// ---------------------------------------------------------------------------
// S4: pair promotion
//
// The walk's carry from visit c to visit c + 1 is the pair (left, cur) as
// visit c left it: left the value to write at c, cur the value at c + 1.
// Each is the input or a constant one of the rules wrote, so the carry is
// one of nine states:
//   0 (in, in)     1 (10100, in)  2 (9, in)      3 (-9, in)    4 (10, in)
//   5 (12700, 10100)  6 (12900, 10100)  7 (9, 9)  8 (-9, -9)
// No constant fires a rule, and a visit reads left only through its class
// (4..5, 6..7, -5..-4, -7..-6, other), every constant's "other".  So what
// visit c does is fixed by the inputs at c - 1 .. c + 1 and three classes
// of the state: A (0: the full rules), B (1-4: left "other"), C (5-8: cur
// a constant, nothing fires).  A visit is then a table of the next state:
// A's and B's from the rule that fires (none 0, 12700 triple 5, 12900
// triple 6, 8 -> 10 4, -8 -> -9 3, 8/8 -> 9/9 7, -8/-8 -> -9/-9 8), C's
// fixed (5, 6 -> 1, 7 -> 2, 8 -> 3); a walk of two or more visits from any
// state of a class ends in one state, so a lane's tile of 8 visits is a
// map of three exit states (4 bits each), composed along the warp by a
// scan.

constexpr int kPPWarps = 4;          // rows a CTA of S4, a warp each
constexpr int kPPTile = 8;           // visits (columns) a lane
constexpr unsigned kFull = 0xFFFFFFFFu;

__device__ __forceinline__ int pp_class(int s) {
  return s == 0 ? 0 : (s <= 4 ? 1 : 2);
}

// The state a visit leaves from class A (l the input) or B (l = 0, of the
// class "other"): v the input at c, r the input at c + 1.
__device__ __forceinline__ int pp_fire(int l, int v, int r, bool band) {
  const bool tri1 = static_cast<unsigned>(v - 5) <= 2u &&
                    static_cast<unsigned>(l - 4) <= 3u &&
                    static_cast<unsigned>(r - 4) <= 3u;
  const bool tri2 = static_cast<unsigned>(v + 7) <= 2u &&
                    static_cast<unsigned>(l + 7) <= 3u &&
                    static_cast<unsigned>(r + 7) <= 3u;
  const bool c6 = ((l & 65534) == 6) | ((r & 65534) == 6);
  const bool c7 = (((-l) & 65534) == 6) | (((-r) & 65534) == 6);
  return tri1 ? 5
         : tri2 ? 6
         : v == 8 ? (c6 ? 4 : (band && r == 8) ? 7 : 0)
         : v == -8 ? (c7 ? 3 : (band && r == -8) ? 8 : 0)
                   : 0;
}

// The next state from state s at a visit whose A and B states are in
// bits 0-3 and 4-7 of t.
__device__ __forceinline__ int pp_next(int s, int t) {
  return s == 0 ? t & 15 : s <= 4 ? t >> 4 : (0x3211 >> (4 * (s - 5))) & 15;
}

// The values of state s: left where the input there is xl, cur where it
// is xv.
__device__ __forceinline__ int pp_left(int s, int xl) {
  return s == 0 ? xl
         : s == 1 ? 10100
         : (s == 2 || s == 7) ? 9
         : (s == 3 || s == 8) ? -9
         : s == 4 ? 10
         : s == 5 ? 12700 : 12900;
}

__device__ __forceinline__ int pp_cur(int s, int xv) {
  return s <= 4 ? xv : s <= 6 ? 10100 : s == 7 ? 9 : -9;
}

// Composes two tile maps (3 exit states, 4 bits each, by entry class):
// first f, then g.
__device__ __forceinline__ int pp_compose(int f, int g) {
  int r = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k)
    r |= ((g >> (4 * pp_class((f >> (4 * k)) & 15))) & 15) << (4 * k);
  return r;
}

// A warp a row.  A region row's 256 columns (columns 256..511 of band rows
// 1..254, columns 0..255 of rows 257..510) are 8 a lane, loaded in one
// 16-byte load: lane l walks visits c = base + 1 + 8 l .. base + 8 l + 8
// (lane 31 the region's last 6) and writes columns c - 1, its own 8; the
// next lane's first two inputs come by shuffle.  Each lane builds its
// visits' tables and its tile's map from the three classes, the warp scans
// the maps, and each lane walks again from its entry state, writing each
// column's value.  A row whose visits hold no value of 5..8 or -8..-5
// fires nothing and is copied; so are the other half row and rows 0, 255,
// 256 and 511.
__global__ void __launch_bounds__(kPPWarps * 32)
    pair_promotion_rows(const int16_t* __restrict__ in,
                        int16_t* __restrict__ out, int batch) {
  const int lane = threadIdx.x & 31;
  const int g = blockIdx.x * kPPWarps + (threadIdx.x >> 5);
  if (g >= batch * kN) return;
  const int row = g % kN;
  const uint4* src =
      reinterpret_cast<const uint4*>(in) + static_cast<size_t>(g) * (kN / 8);
  uint4* dst = reinterpret_cast<uint4*>(out) + static_cast<size_t>(g) * (kN / 8);
  const uint4 lo = src[lane], hi = src[32 + lane];
  const bool band = row >= 1 && row < kD - 1;
  const bool region = band || (row >= kD + 1 && row < kN - 1);
  dst[band ? lane : 32 + lane] = band ? lo : hi;
  const uint4 q = band ? hi : lo;
  int x[kPPTile + 2];
  const uint32_t words[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = static_cast<int16_t>(words[k] & 0xFFFFu);
    x[2 * k + 1] = static_cast<int16_t>(words[k] >> 16);
  }
  x[8] = __shfl_down_sync(kFull, x[0], 1);
  x[9] = __shfl_down_sync(kFull, x[1], 1);
  const int nv = lane == 31 ? kPPTile - 2 : kPPTile;
  bool hot = false;
#pragma unroll
  for (int j = 1; j <= kPPTile; ++j)
    hot |= static_cast<unsigned>((x[j] < 0 ? -x[j] : x[j]) - 5) <= 3u;
  if (!__any_sync(kFull, hot && region)) {
    dst[band ? 32 + lane : lane] = q;
    return;
  }
  int tab[kPPTile];
#pragma unroll
  for (int j = 0; j < kPPTile; ++j)
    tab[j] = pp_fire(x[j], x[j + 1], x[j + 2], band) |
             pp_fire(0, x[j + 1], x[j + 2], band) << 4;
  int map = 0;
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    int s = k == 0 ? 0 : k == 1 ? 1 : 5;
#pragma unroll
    for (int j = 0; j < kPPTile; ++j)
      if (j < nv) s = pp_next(s, tab[j]);
    map |= s << (4 * k);
  }
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int before = __shfl_up_sync(kFull, map, d);
    if (lane >= d) map = pp_compose(before, map);
  }
  const int before = __shfl_up_sync(kFull, map, 1);
  int s = lane ? before & 15 : 0;
  uint32_t packed[4] = {0u, 0u, 0u, 0u};
#pragma unroll
  for (int j = 0; j < kPPTile; ++j) {
    int w;
    if (j < nv) {
      const int t = tab[j] & 15;
      w = s == 0 && (t == 5 || t == 6) ? 10100 : pp_left(s, x[j]);
      s = pp_next(s, tab[j]);
    } else {
      w = j == nv ? pp_left(s, x[j]) : pp_cur(s, x[j]);
    }
    packed[j >> 1] |= (static_cast<uint32_t>(w) & 0xFFFFu) << (16 * (j & 1));
  }
  dst[band ? 32 + lane : lane] =
      make_uint4(packed[0], packed[1], packed[2], packed[3]);
}

// ---------------------------------------------------------------------------
// S5: the res256 column ladder (encoder/nhw_encoder.c:1084-1326, the host
// copy's nhw_column_ladder)

struct LadderFlags {
  int low1, low2, hi1, res_setting;
};

// A step's effect, packed: bits 0-4 the mark (0 kept, m: 12000 + 100 m),
// 5-7 v1's delta + 2, 8 v1 := rf1 (as the step leaves it), 9-10 v2's
// delta / 2 + 1, 11-12 rf1 (0 kept, 1 14100, 2 14000), 13-15 the band
// op (0 none, 1 w1, 2 w2, 3 w3, 4 lw4, 5 lw6).
__device__ constexpr int ladder_pack(int mk, int d1, int set1,
                                                int d2, int rf, int op) {
  return mk | ((d1 + 2) << 5) | (set1 << 8) | ((d2 / 2 + 1) << 9) |
         (rf << 11) | (op << 13);
}
constexpr int kLNone = ladder_pack(0, 0, 0, 0, 0, 0);
constexpr int kL12400 = ladder_pack(4, -2, 0, -2, 0, 0);
constexpr int kL12300 = ladder_pack(3, 2, 0, 2, 0, 0);

// The first of two branches of an if/else chain: (fired, effect).
struct LadderPick {
  int c;   // 0 or 1
  int e;
};
__device__ __forceinline__ LadderPick ladder_first(LadderPick a,
                                                   LadderPick b) {
  return {a.c | b.c, a.c ? a.e : b.e};
}

// The conditions of the chain besides res, a and b2, as bits: 0 the row
// above's delta up >= 0, 1 up <= 0 (both 0 at row 0), 2 the cross-column
// pair check (the j + 1 deltas x0, x1 in {2, 3}, x2 > 0), 3 its negative
// (x0, x1 in {-2, -3}, x2 < 0).
__device__ __forceinline__ int ladder_sp(bool has_up, int up, int x0, int x1,
                                         int x2) {
  const bool pair = ((x0 == 2) | (x0 == 3)) & ((x1 == 2) | (x1 == 3)) &
                    (x2 > 0);
  const bool npair = ((x0 == -2) | (x0 == -3)) & ((x1 == -2) | (x1 == -3)) &
                     (x2 < 0);
  return int(has_up & (up >= 0)) | (int(has_up & (up <= 0)) << 1) |
         (int(pair) << 2) | (int(npair) << 3);
}

// The effect of one step of a column's ladder (encoder/nhw_encoder.c:
// 1084-1326, the host copy's nhw_column_ladder) from res = pf[scan] -
// rf[cnt], a = pf[scan + N] - rf[cnt + D], b2 = pf[scan + 2N] - rf[cnt +
// 2D] and the bits of ladder_sp.  The C's if/else chain (14 branches,
// nested) without branches: each branch's condition and effect side by
// side, the first that fires picked by a tree of selects (`&`, `|` on
// bools: `&&`, `||` would branch).
__device__ __forceinline__ int ladder_effect(int res, int a, int b2, int sp,
                                             const LadderFlags f) {
  const bool r2 = res == 2, r3 = res == 3, rm2 = res == -2, rm3 = res == -3;
  const bool a2 = a == 2, a3 = a == 3, am3 = a == -3;
  const bool b23 = (b2 == 2) | (b2 == 3), bm23 = (b2 == -2) | (b2 == -3);
  const bool r23 = r2 | r3, rm23 = rm2 | rm3, a23 = a2 | a3;
  const bool low1 = f.low1, low2 = f.low2, hi1 = f.hi1;
  const int set1 = ladder_pack(0, 0, 1, 0, 0, 0);
  LadderPick p[14];
  p[0] = {r2 & a2 & (b2 >= 2), ((b2 < 5) | (b2 > 6)) ? kL12400 : kLNone};
  p[1] = {((r2 & a3) | (r3 & a2)) & (b2 > 1) & (b2 < 6), kL12400};
  p[2] = {r3 & a3, ((b2 > 0) & (b2 < 6))
                       ? kL12400
                       : (low1 ? ladder_pack(1, 0, 1, 0, 0, 0) : kLNone)};
  p[3] = {(a == -4) & r23 & b23,
          (r2 & (b2 == 2)) ? ladder_pack(0, 1, 0, 0, 0, 0) : kL12400};
  p[4] = {(res == 1) & a3 & (b2 == 2),
          (sp & 1) ? kL12400 : kLNone};
  {
    const int l2 = ((res < 5) & (a == 5)) ? ladder_pack(0, 0, 1, 0, 1, 0)
                   : (res >= 5)           ? ladder_pack(21, 0, 1, 0, 0, 0)
                   : (r3 & (a >= 4))      ? ladder_pack(0, 0, 1, 0, 1, 0)
                                          : set1;
    p[5] = {(r3 | (res == 4) | (res == 5) | (res > 6)) &
                (a3 | ((a & 65534) == 4)),
            (res > 6) ? ladder_pack(5, 0, 1, 0, 0, 0)
            : low1    ? ladder_pack(1, 0, 1, 0, 0, 0)
            : low2    ? l2
                      : kLNone};
  }
  p[6] = {r23 & a23,
          (((b2 == 0) | (b2 == 1)) & ((sp >> 2) & 1)) ? kL12400 : kLNone};
  p[7] = {(a == 4) & rm23 & bm23,
          (rm2 & (b2 == -2)) ? ladder_pack(0, -1, 0, 0, 0, 0) : kL12300};
  {
    const int l2 = ((res > -5) & (a == -5)) ? ladder_pack(0, 0, 1, 0, 2, 0)
                   : (res <= -5)            ? ladder_pack(20, 0, 1, 0, 0, 0)
                   : (rm3 & (a <= -4))      ? ladder_pack(0, 0, 1, 0, 2, 0)
                                            : set1;
    p[8] = {(rm3 | (res == -4) | (res == -5) | (res < -7)) &
                (am3 | (a == -4) | (a == -5)),
            (res < -7) ? ladder_pack(6, 0, 1, 0, 0, 0)
            : low1     ? ladder_pack(2, 0, 1, 0, 0, 0)
            : low2     ? l2
                       : kLNone};
  }
  {
    const bool npair = (sp >> 3) & 1;
    const int e23 = (b2 < 0)            ? kL12300
                    : (rm3 & hi1)       ? ladder_pack(25, 0, 0, 0, 0, 0)
                    : (b2 == 0)         ? (npair ? kL12300 : kLNone)
                    : rm2               ? ladder_pack(0, 0, 0, 0, 0, 2)
                                        : ladder_pack(0, 0, 0, 0, 0, 3);
    const int e1 = (am3 & (b2 == -2))
                       ? (((sp >> 1) & 1) ? kL12300 : kLNone)
                   : (b2 == -3) ? kL12300
                                : ladder_pack(0, 0, 0, 0, 0, 1);
    const int e4 = bm23 ? kL12300 : ladder_pack(20, 0, 0, 0, 0, 4);
    p[9] = {am3 | (a == -2), rm23             ? e23
                             : (res == -1)    ? e1
                             : (res == -4)    ? e4
                                              : kLNone};
  }
  p[10] = {(res == 0) | (res == -1), ladder_pack(0, 0, 0, 0, 0, 1)};
  p[11] = {rm2, ladder_pack(0, 0, 0, 0, 0, 2)};
  p[12] = {rm3, hi1 ? ladder_pack(25, 0, 0, 0, 0, 0)
                    : ladder_pack(0, 0, 0, 0, 0, 3)};
  p[13] = {res < -f.res_setting,
           (res == -4)                 ? ladder_pack(20, 0, 0, 0, 0, 4)
           : ((res < -7) & hi1)        ? ladder_pack(29, 0, 0, 0, 0, 0)
           : (res < -6)                ? ladder_pack(20, 0, 0, 0, 0, 5)
                                       : ladder_pack(20, 0, 0, 0, 0, 0)};
  const LadderPick q0 = ladder_first(p[0], p[1]),
                   q1 = ladder_first(p[2], p[3]),
                   q2 = ladder_first(p[4], p[5]),
                   q3 = ladder_first(p[6], p[7]),
                   q4 = ladder_first(p[8], p[9]),
                   q5 = ladder_first(p[10], p[11]),
                   q6 = ladder_first(p[12], p[13]);
  const LadderPick s0 = ladder_first(q0, q1), s1 = ladder_first(q2, q3),
                   s2 = ladder_first(q4, q5);
  const LadderPick t = ladder_first(ladder_first(s0, s1),
                                    ladder_first(s2, q6));
  return t.c ? t.e : kLNone;
}

// The chain reads res, a and b2 only through these classes: res clamped
// to [-9, 7] (res < -res_setting the same below -9 while res_setting <=
// 8), a to [-6, 6] and, apart, the a with (a & 65534) == 4 below 4 (as
// -65532) and above 5 (as 65540), b2 to [-4, 7].  A step's effect is a
// table of the classes and the 4 bits of ladder_sp, built once a call
// (ladder_table).
constexpr int kLResLo = -9;
constexpr int kLResN = 7 - kLResLo + 1;
constexpr int kLAN = 15;
constexpr int kLBN = 12;
constexpr int kLTab = kLResN * kLAN * kLBN * 16;   // 48,960 effects

__device__ __forceinline__ int ladder_index(int res, int a, int b2, int sp) {
  const int rc = min(max(res, kLResLo), 7) - kLResLo;
  const bool odd4 = ((a & 65534) == 4) & ((a < 4) | (a > 5));
  const int ac = odd4 ? (a < 0 ? 13 : 14) : min(max(a, -6), 6) + 6;
  const int bc = min(max(b2, -4), 7) + 4;
  return ((rc * kLAN + ac) * kLBN + bc) * 16 + sp;
}

// The effect of every class and bits: tab (kLTab) uint16.
__global__ void __launch_bounds__(256)
    ladder_table(LadderFlags f, uint16_t* __restrict__ tab) {
  const int i = blockIdx.x * 256 + threadIdx.x;
  if (i >= kLTab) return;
  const int cell = i >> 4;
  const int ac = cell / kLBN % kLAN;
  tab[i] = static_cast<uint16_t>(
      ladder_effect(cell / (kLAN * kLBN) + kLResLo,
                    ac == 13 ? -65532 : (ac == 14 ? 65540 : ac - 6),
                    cell % kLBN - 4, i & 15, f));
}

// One step of a column's ladder at row r with pf/rf reads as values: v0 =
// pf[scan], v1 = pf[scan + N] (both as the walk left them), v2 = pf[scan
// + 2N]; mark = rf[cnt] (as the walk left it), rf1 = rf[cnt + D], rf2 =
// rf[cnt + 2D]; up = pf[scan - N] - rf[cnt - D] (r > 0); x0..x2 = pf[scan
// + 1 + kN k] - rf[cnt + 1 + kD k]; bnd = pf[st], bp = pf[st - 1].  v1,
// v2, mark, rf1 and bnd are updated in place; the effect comes from the
// table.
__device__ __forceinline__ void ladder_step(const uint16_t* tab, int v0,
                                            int& v1, int& v2, int& mark,
                                            int& rf1, int rf2, bool has_up,
                                            int up, int x0, int x1, int x2,
                                            int& bnd, int bp) {
  const int e = tab[ladder_index(v0 - mark, v1 - rf1, v2 - rf2,
                                 ladder_sp(has_up, up, x0, x1, x2))];
  // the band values of the ops
  const int nb = -bnd;
  const bool neg_ok = (bnd < -14) & (((nb & 7) == 0) | ((nb & 7) == 7));
  const int neg = neg_ok ? bnd + 1 : bnd;
  const int w1 = (((bnd == 7) & (bp >= 0) & (bp < 8)) |
                  ((bnd == 8) & (bp >= -2) & (bp < 8)))
                     ? bnd + 2
                     : bnd;
  const int w2 = (bnd < -14) ? neg
                 : (((bnd == 7) | ((bnd & 65534) == 8)) & (bp >= -2))
                     ? bnd + 3
                     : bnd;
  const int w3 = (bnd < -14) ? neg
                 : ((bnd >= 0) & (((bnd + 2) & 65532) == 8))
                     ? ((bp >= -2) ? 10 : bnd)
                 : ((bnd > 14) & ((bnd & 7) == 7)) ? bnd + 1
                                                   : bnd;
  const int lw4 =
      (((bnd == -7) | (bnd == -8)) & (bp > -8) & (bp < 2)) ? -9 : bnd;
  const int lw6 = (bnd < -14) ? neg
                  : (((bnd == 7) | (bnd == 8)) & (bp >= -1) & (bp < 8))
                      ? bnd + 3
                      : bnd;
  const int mc = e & 31, op = (e >> 13) & 7, rc = (e >> 11) & 3;
  rf1 = rc == 0 ? rf1 : (rc == 1 ? 14100 : 14000);
  v1 = ((e >> 8) & 1) ? rf1 : v1 + ((e >> 5) & 7) - 2;
  v2 += 2 * ((e >> 9) & 3) - 2;
  mark = mc ? 12000 + 100 * mc : mark;
  bnd = op == 0   ? bnd
        : op == 1 ? w1
        : op == 2 ? w2
        : op == 3 ? w3
        : op == 4 ? lw4
                  : lw6;
}

// A column's walk over rows 0..254.  Src gives the reads that are not
// carried: v2(r) = pf row r + 2, rf(k) = rf row k (k <= 257), band(r) = the
// band value (j, 256 + r), bp0() = pf (j, 255), x(k) = the j + 1 read of
// row k, pf (k, j + 1) - rf[k * 256 + j + 1]; it takes each step's
// results (put), is told before step r reads row r + 2 (ready) and after
// it (done), and takes rows 255 and 256 at the end (finish).
template <class Src>
__device__ __forceinline__ void ladder_walk(Src& src, const uint16_t* tab) {
  int v0 = src.pf(0), v1 = src.pf(1);
  int rfc = src.rf(0), rf1 = src.rf(1);
  int bp = src.bp0();
  int vprev = 0, markm1 = 0;
  src.ready(-1);
  int x0 = src.x(0), x1 = src.x(1);
  for (int r = 0; r < kD - 1; ++r) {
    src.ready(r);
    int v2 = src.pf(r + 2);
    const int rf2 = src.rf(r + 2);
    const int x2 = src.x(r + 2);
    int bnd = src.band(r);
    int mark = rfc, nv1 = v1, nrf1 = rf1;
    ladder_step(tab, v0, nv1, v2, mark, nrf1, rf2, r > 0, vprev - markm1, x0,
                x1, x2, bnd, bp);
    src.put(r, v0, mark, bnd);
    src.done(r);
    vprev = v0;
    markm1 = mark;
    v0 = nv1;
    v1 = v2;
    rfc = nrf1;
    rf1 = rf2;
    bp = bnd;
    x0 = x1;
    x1 = x2;
  }
  src.finish(v0, v1, rfc);
}

// S5's shared memory, int16 unless noted.  A CTA stages pf rows 0..256 and
// rf rows 0..257 of kLCols columns from its block's first (its columns and
// the j + 1 reads of its last; 16-byte rows) and its band rows, columns
// kLBand0..511 (pitch kLBandPitch: 133 words, odd, so a warp's lanes, a
// row each, read one column on 32 banks).  CTA 0 also holds column 255's
// inputs and every column's step-0 band value.
constexpr int kLBlock = 32;                    // columns a CTA walks
constexpr int kLCtas = kD / kLBlock;           // CTAs an image
constexpr int kLThreads = 128;
constexpr int kLCols = 40;
constexpr int kLPfRows = kD + 1;
constexpr int kLRfRows = kD + 2;
constexpr int kLBand0 = kD - 8;
constexpr int kLBandPitch = kN - kLBand0 + 2;
constexpr int kLPf = 0;
constexpr int kLRf = kLPf + kLPfRows * kLCols;
constexpr int kLBand = kLRf + kLRfRows * kLCols;
constexpr int kL255Pf = kLBand + kLBlock * kLBandPitch;   // pf (k, 255)
constexpr int kL255Rf = kL255Pf + kLRfRows;               // rf (k, 255)
constexpr int kL255Band = kL255Rf + kLRfRows;             // row 255
constexpr int kLStep0 = kL255Band + kLBandPitch;          // (k, 256)
constexpr int kLProgress = kLStep0 + kLRfRows;            // int
constexpr int kLSmem = 2 * (kLTab + kLProgress) + 16;    // bytes, the
                                                          // table first
static_assert(kLRf % 8 == 0 && kLBand % 2 == 0 && kLProgress % 2 == 0,
              "S5 staging alignment");

// Column j = j0 + lane of a block, from the CTA's staged copy, in place.
// The warp keeps its lanes one step apart at most (done), so a lane's j + 1
// reads of row r + 2 come before its neighbour writes that row.  CTA 0's
// lane 0 (column 0) publishes after each step how many rf rows of column 0
// are final.
struct BlockSrc {
  int16_t* sm;
  int lane;
  volatile int* progress;   // column 0's final rf rows, or null
  __device__ int pf(int k) const { return sm[kLPf + k * kLCols + lane]; }
  __device__ int rf(int k) const { return sm[kLRf + k * kLCols + lane]; }
  __device__ int band(int r) const {
    return sm[kLBand + lane * kLBandPitch + kD - kLBand0 + r];
  }
  __device__ int bp0() const {
    return sm[kLBand + lane * kLBandPitch + kD - 1 - kLBand0];
  }
  __device__ int x(int k) const {
    return sm[kLPf + k * kLCols + lane + 1] -
           sm[kLRf + k * kLCols + lane + 1];
  }
  __device__ void ready(int) const {}
  __device__ void put(int r, int v0, int mark, int bnd) const {
    sm[kLPf + r * kLCols + lane] = static_cast<int16_t>(v0);
    sm[kLRf + r * kLCols + lane] = static_cast<int16_t>(mark);
    sm[kLBand + lane * kLBandPitch + kD - kLBand0 + r] =
        static_cast<int16_t>(bnd);
  }
  __device__ void done(int r) const {
    if (progress && lane == 0) {
      __threadfence_block();
      *progress = r + 1;
    }
    __syncwarp();
  }
  __device__ void finish(int v0, int v1, int rfc) const {
    sm[kLPf + (kD - 1) * kLCols + lane] = static_cast<int16_t>(v0);
    sm[kLPf + kD * kLCols + lane] = static_cast<int16_t>(v1);
    sm[kLRf + (kD - 1) * kLCols + lane] = static_cast<int16_t>(rfc);
    if (progress && lane == 0) {
      __threadfence_block();
      *progress = kD;
    }
  }
};

// Column 255 in CTA 0, 4 steps behind column 0: its flat j + 1 reads
// land on band column 256 (row k: column k's step-0 band value, its own
// from its step 0 on, the input at row 256) and on rf column 0 of rows
// k + 1, final once column 0 has walked row k + 1 (rows 256 and 257 are
// the tail).
struct Col255Src {
  int16_t* sm;
  volatile int* progress;
  __device__ int pf(int k) const { return sm[kL255Pf + k]; }
  __device__ int rf(int k) const { return sm[kL255Rf + k]; }
  __device__ int band(int r) const {
    return sm[kL255Band + kD - kLBand0 + r];
  }
  __device__ int bp0() const { return sm[kL255Band + kD - 1 - kLBand0]; }
  __device__ int x(int k) const {
    const volatile int16_t* rf0 = sm + kLRf;
    return sm[kLStep0 + k] - rf0[(k + 1) * kLCols];
  }
  // before step r reads x(r + 2): rf (r + 3, 0) final
  __device__ void ready(int r) const {
    const int need = min(r + 4, kD);
    while (*progress < need) {
    }
    __threadfence_block();
  }
  __device__ void put(int r, int v0, int mark, int bnd) const {
    sm[kL255Pf + r] = static_cast<int16_t>(v0);
    sm[kL255Rf + r] = static_cast<int16_t>(mark);
    sm[kL255Band + kD - kLBand0 + r] = static_cast<int16_t>(bnd);
    if (r == 0) sm[kLStep0 + kD - 1] = static_cast<int16_t>(bnd);
  }
  __device__ void done(int) const {}
  __device__ void finish(int v0, int v1, int rfc) const {
    sm[kL255Pf + kD - 1] = static_cast<int16_t>(v0);
    sm[kL255Pf + kD] = static_cast<int16_t>(v1);
    sm[kL255Rf + kD - 1] = static_cast<int16_t>(rfc);
  }
};

// Column j's step 0 from the input: its band value (j, 256).  Every read
// is an input value (rows 0..2 of columns j and j + 1).
struct Step0Src {
  const int16_t* p;
  const int16_t* rfe;
  int j;
  __device__ int pf(int k) const { return p[k * kN + j]; }
  __device__ int rf(int k) const { return rfe[k * kD + j]; }
  __device__ int band(int r) const { return p[j * kN + kD + r]; }
  __device__ int bp0() const { return p[j * kN + kD - 1]; }
  __device__ int x(int k) const {
    return p[k * kN + j + 1] - rfe[k * kD + j + 1];
  }
};

__device__ __forceinline__ int step0_band(const int16_t* p,
                                          const int16_t* rfe, int j,
                                          const uint16_t* tab) {
  const Step0Src s{p, rfe, j};
  int v1 = s.pf(1), v2 = s.pf(2), mark = s.rf(0), rf1 = s.rf(1);
  int bnd = s.band(0);
  ladder_step(tab, s.pf(0), v1, v2, mark, rf1, s.rf(2), false, 0, s.x(0),
              s.x(1), s.x(2), bnd, s.bp0());
  return bnd;
}

// kLCtas CTAs an image (blockIdx.y), CTA k walking columns [32 k, 32 k +
// 32) but 255 with its warp 0 from shared memory.  In CTA 0, warp 1 first
// computes every column's step-0 band value, then its lane 0 walks column
// 255 behind column 0; in the others warps 1-3 (in CTA 0 warps 2-3) copy
// what the ladder leaves during the walk.  Then the CTA writes its
// columns' rows, its band rows and, in CTA 0, column 255.
__global__ void __launch_bounds__(kLThreads)
    column_ladder(const int16_t* __restrict__ pin,
                  const int16_t* __restrict__ rfin, int16_t* __restrict__ pout,
                  int16_t* __restrict__ rfout,
                  const uint16_t* __restrict__ tab) {
  extern __shared__ __align__(16) int16_t smem[];
  uint16_t* tab_s = reinterpret_cast<uint16_t*>(smem);
  int16_t* lsm = smem + kLTab;
  const int t = threadIdx.x, w = t >> 5, lane = t & 31;
  const int blk = blockIdx.x, j0 = blk * kLBlock;
  const int ncols = min(kLBlock, kD - 1 - j0);
  const size_t b = blockIdx.y;
  const int16_t* p = pin + b * kPlane;
  const int16_t* rf = rfin + b * kRfExt;
  int16_t* o = pout + b * kPlane;
  int16_t* ro = rfout + b * kSZ;
  volatile int* progress = reinterpret_cast<volatile int*>(lsm + kLProgress);
  for (int i = t; i < kLTab / 8; i += kLThreads)
    __pipeline_memcpy_async(tab_s + 8 * i, tab + 8 * i, 16);
  constexpr int kVecs = kLCols / 8;
  for (int i = t; i < kLPfRows * kVecs; i += kLThreads)
    __pipeline_memcpy_async(lsm + kLPf + (i / kVecs) * kLCols +
                                (i % kVecs) * 8,
                            p + (i / kVecs) * kN + j0 + (i % kVecs) * 8, 16);
  for (int i = t; i < kLRfRows * kVecs; i += kLThreads)
    __pipeline_memcpy_async(lsm + kLRf + (i / kVecs) * kLCols +
                                (i % kVecs) * 8,
                            rf + (i / kVecs) * kD + j0 + (i % kVecs) * 8, 16);
  constexpr int kBandWords = (kN - kLBand0) / 2;
  for (int i = t; i < kLBlock * kBandWords; i += kLThreads)
    __pipeline_memcpy_async(
        lsm + kLBand + (i / kBandWords) * kLBandPitch + (i % kBandWords) * 2,
        p + (j0 + i / kBandWords) * kN + kLBand0 + (i % kBandWords) * 2, 4);
  if (blk == 0) {
    for (int i = t; i < kBandWords; i += kLThreads)
      __pipeline_memcpy_async(lsm + kL255Band + 2 * i,
                              p + (kD - 1) * kN + kLBand0 + 2 * i, 4);
    for (int k = t; k < kLRfRows; k += kLThreads) {
      if (k < kLPfRows) lsm[kL255Pf + k] = p[k * kN + kD - 1];
      lsm[kL255Rf + k] = rf[k * kD + kD - 1];
    }
    if (t == 0) {
      *progress = 0;
      lsm[kLStep0 + kD] = p[kD * kN + kD];
    }
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  if (w == 0) {
    BlockSrc src{lsm, lane, blk == 0 ? progress : nullptr};
    ladder_walk(src, tab_s);
  } else if (blk == 0 && w == 1) {
#pragma unroll
    for (int i = 0; i < kD / 32; ++i) {
      const int k = lane + 32 * i;
      if (k < kD - 1)
        lsm[kLStep0 + k] = static_cast<int16_t>(step0_band(p, rf, k, tab_s));
    }
    __syncwarp();
    if (lane == 0) {
      Col255Src src{lsm, progress};
      ladder_walk(src, tab_s);
    }
  } else {
    // what the ladder leaves: rows 257..511, row 256's right half
    const int helpers = blk == 0 ? 64 : 96;
    const int h = t - (kLThreads - helpers);
    constexpr int kRowVecs = kN / 8;
    const int rows = (kN - kD - 1 - blk + kLCtas - 1) / kLCtas;
    for (int i = h; i < rows * kRowVecs; i += helpers) {
      const int r = kD + 1 + blk + kLCtas * (i / kRowVecs);
      const size_t at = r * kN + (i % kRowVecs) * 8;
      *reinterpret_cast<int4*>(o + at) =
          *reinterpret_cast<const int4*>(p + at);
    }
    if (blk == kLCtas - 1)
      for (int i = h; i < kD / 8; i += helpers) {
        const size_t at = kD * kN + kD + i * 8;
        *reinterpret_cast<int4*>(o + at) =
            *reinterpret_cast<const int4*>(p + at);
      }
  }
  __syncthreads();
  for (int i = t; i < kLPfRows * kLBlock; i += kLThreads) {
    const int r = i / kLBlock, c = i % kLBlock;
    if (c < ncols) o[r * kN + j0 + c] = lsm[kLPf + r * kLCols + c];
  }
  for (int i = t; i < kD * kLBlock; i += kLThreads) {
    const int r = i / kLBlock, c = i % kLBlock;
    if (c < ncols) ro[r * kD + j0 + c] = lsm[kLRf + r * kLCols + c];
  }
  // band rows: columns 256..511 (511 as staged)
  constexpr int kOutWords = kD / 2;
  for (int i = t; i < ncols * kOutWords; i += kLThreads) {
    const int k = i / kOutWords, c = kD + 2 * (i % kOutWords);
    *reinterpret_cast<uint32_t*>(o + (j0 + k) * kN + c) =
        *reinterpret_cast<const uint32_t*>(lsm + kLBand + k * kLBandPitch +
                                           c - kLBand0);
  }
  if (blk == 0) {
    for (int k = t; k < kLPfRows; k += kLThreads)
      o[k * kN + kD - 1] = lsm[kL255Pf + k];
    for (int k = t; k < kD; k += kLThreads)
      ro[k * kD + kD - 1] = lsm[kL255Rf + k];
    for (int i = t; i < kOutWords; i += kLThreads)
      *reinterpret_cast<uint32_t*>(o + (kD - 1) * kN + kD + 2 * i) =
          *reinterpret_cast<const uint32_t*>(lsm + kL255Band + kD - kLBand0 +
                                             2 * i);
  }
}

cudaError_t column_ladder_setup() {
  static const cudaError_t e = cudaFuncSetAttribute(
      column_ladder, cudaFuncAttributeMaxDynamicSharedMemorySize, kLSmem);
  return e;
}

// ---------------------------------------------------------------------------
// S6: classify (encoder/nhw_encoder.c:1329-1420, the host copy's
// nhw_classify).  Marks outside the ladder's set map to 149.

constexpr int kCRows = 32;               // band rows a CTA of S6
constexpr int kCCtas = kD / kCRows;      // CTAs an image
constexpr int kCThreads = 512;
constexpr int kCSteps = kD / 32;         // steps a lane takes along its row
constexpr int kCPitch = kD + 4;          // bytes a staged band row: 65 words

// The band rule a step applies, from res = pf - mark (marks below 12000):
// res 0..1, res 2, res 3 (below HIGH1), res 4 above res_setting, res above
// 6 and res_setting (but res above 7 at HIGH1); every other step keeps v.
enum ClassifyCase : int { kKeep, kRes01, kRes2, kRes3, kRes4, kResHi };

__device__ __forceinline__ int mark_code(int mark) {
  switch (mark) {
    case 14000: return 140;
    case 14500: return 145;
    case 12200: return 122;
    case 12100: return 121;
    case 12300: return 123;
    case 12400: return 124;
    case 14100: return 141;
    case 12500: return 125;
    case 12600: return 126;
    default: return 149;
  }
}

// The static part of the step at (r, j): its band rule, its rf code and
// the counts it adds (none of them reads the band).
__device__ __forceinline__ int classify_case(int pf, int mark, bool hi1,
                                             int res_setting, int& code,
                                             int& n1, int& n3, int& n5) {
  if (mark >= 12000) {
    code = mark_code(mark);
    n1 += (code == 140) | (code == 141) | (code == 125) | (code == 126) |
          (code == 149);
    n3 += (code >= 121) & (code <= 126);
    n5 += (code == 145) | (code == 149);
    return kKeep;
  }
  const int res = pf - mark;
  code = 0;
  if (res == 0 || res == 1) return kRes01;
  if (res == 2) return kRes2;
  if (res == 3) {
    if (!hi1) return kRes3;
    code = 144;
    ++n5;
    return kKeep;
  }
  if (res <= res_setting) return kKeep;
  code = 141;
  ++n1;
  if (res == 4) return kRes4;
  if (res <= 6) return kKeep;
  if (res > 7 && hi1) {
    code = 148;
    ++n5;
    ++n1;
    return kKeep;
  }
  return kResHi;
}

// The class of a band value that the next step's rules read: <= -8, -7..-1,
// 0..1, 2, 3..7, >= 8 (every bp test of the C's rules is one of these).
__device__ __forceinline__ int band_class(int v) {
  return int(v >= -7) + int(v >= 0) + int(v >= 2) + int(v >= 3) +
         int(v >= 8);
}

// A step's effect on its band value v: it writes w where the class of the
// value written before it is in the mask m (bit c: class c), else keeps v.
// Selects on ints, no branch: the rules' v tests are exclusive.
__device__ __forceinline__ void classify_effect(int c, int v, int& w,
                                                int& m) {
  const bool m78 = (v == -7) | (v == -8), m6 = v == -6;
  const bool dec = ((v > 15) & ((v & 7) == 0)) &
                   ((c == kRes2) | (c == kRes3) | (c == kResHi));
  const bool to10 = (c == kRes3) & (m78 | m6 | (v == -9));
  const bool up2 = (c == kRes4) & ((v == 7) | (v == 8) | (v == 9));
  int mm = ((c == kRes01) & m78) ? 0x06 : 0;                 // bp -7..1
  mm |= ((c == kRes2) & m78) ? 0x07 : 0;                     // bp <= 1
  mm |= (((c == kRes2) & m6) | ((c == kResHi) & (m78 | m6))) ? 0x02
                                                              : 0;  // -7..-1
  mm |= to10 ? 0x0F : 0;                                     // bp <= 2
  mm |= up2 ? 0x1C : 0;                                      // bp 0..7
  m = dec ? 0x3F : mm;
  w = dec ? v - 1 : (to10 ? -10 : (up2 ? v + 2 : -9));
}

// Band row j, a warp: lane l takes steps 8 l..8 l + 7 (band columns 256 +
// 8 l..), cs the row's staged cases.  Each lane composes its steps' 6-class
// maps, the warp scans the 32 maps with shuffles, and each lane walks its
// steps again from its entry class and stores its 8 values.
__device__ __forceinline__ void classify_row(const int16_t* p, int16_t* o,
                                             const uint8_t* cs, int j,
                                             int lane) {
  const int4 raw =
      *reinterpret_cast<const int4*>(p + j * kN + kD + kCSteps * lane);
  const uint32_t c4[2] = {
      *reinterpret_cast<const uint32_t*>(cs + kCSteps * lane),
      *reinterpret_cast<const uint32_t*>(cs + kCSteps * lane + 4)};
  const int16_t* vs = reinterpret_cast<const int16_t*>(&raw);
  int v[kCSteps], w[kCSteps], m[kCSteps];
  int f[6] = {0, 1, 2, 3, 4, 5};        // the lane's exit from each class
#pragma unroll
  for (int k = 0; k < kCSteps; ++k) {
    v[k] = vs[k];
    classify_effect((c4[k >> 2] >> (8 * (k & 3))) & 0xFF, v[k], w[k], m[k]);
    const int cv = band_class(v[k]), cw = band_class(w[k]);
#pragma unroll
    for (int s = 0; s < 6; ++s) f[s] = ((m[k] >> f[s]) & 1) ? cw : cv;
  }
  int map = f[0] | (f[1] << 3) | (f[2] << 6) | (f[3] << 9) | (f[4] << 12) |
            (f[5] << 15);
#pragma unroll
  for (int d = 1; d < 32; d *= 2) {
    const int prev = __shfl_up_sync(kFull, map, d);
    // map after prev: class s -> map's exit from prev's exit from s
    int h = 0;
#pragma unroll
    for (int s = 0; s < 6; ++s)
      h |= ((map >> (3 * ((prev >> (3 * s)) & 7))) & 7) << (3 * s);
    map = lane >= d ? h : map;
  }
  const int c0 = band_class(p[j * kN + kD - 1]);
  const int before = __shfl_up_sync(kFull, map, 1);
  int e = lane > 0 ? (before >> (3 * c0)) & 7 : c0;
  int4 res;
  int16_t* out = reinterpret_cast<int16_t*>(&res);
#pragma unroll
  for (int k = 0; k < kCSteps; ++k) {
    const bool hit = (m[k] >> e) & 1;
    out[k] = static_cast<int16_t>(hit ? w[k] : v[k]);
    e = band_class(out[k]);
  }
  *reinterpret_cast<int4*>(o + j * kN + kD + kCSteps * lane) = res;
}

// kCCtas CTAs an image, kCRows band rows each.  The CTA reads rows 0..255
// of its columns j0..j0 + 31 (pf and the marks, 16 bytes a thread), writes
// their rf codes and stages their band rules transposed, a band row's 256
// steps a row of bytes; it copies its share of what the walks leave
// (columns 0..255 of its band rows, plane rows 256 + j0..); then each
// warp walks band rows, and the counts are summed in the CTA.
__global__ void __launch_bounds__(kCThreads)
    classify_bands(const int16_t* __restrict__ pin,
                   const int16_t* __restrict__ rfin,
                   int16_t* __restrict__ pout, int16_t* __restrict__ rfout,
                   int* __restrict__ counts, int hi1, int res_setting) {
  __shared__ __align__(16) uint8_t cases[kCRows * kCPitch];
  __shared__ int s_n[3];
  const int t = threadIdx.x, lane = t & 31;
  const int j0 = blockIdx.x * kCRows;
  const size_t b = blockIdx.y;
  const int16_t* p = pin + b * kPlane;
  const int16_t* rf = rfin + b * kSZ;
  int16_t* o = pout + b * kPlane;
  int16_t* ro = rfout + b * kSZ;
  if (t < 3) s_n[t] = 0;
  int n1 = 0, n3 = 0, n5 = 0;
  constexpr int kVecs = kCRows / 8;      // 8-column vectors a row
  for (int i = t; i < kD * kVecs; i += kCThreads) {
    const int r = i / kVecs, q = i % kVecs;
    const int at = r * kD + j0 + 8 * q;
    const int4 pv = *reinterpret_cast<const int4*>(p + r * kN + j0 + 8 * q);
    const int4 mv = *reinterpret_cast<const int4*>(rf + at);
    const int16_t* pf = reinterpret_cast<const int16_t*>(&pv);
    const int16_t* mk = reinterpret_cast<const int16_t*>(&mv);
    int4 cv;
    int16_t* code = reinterpret_cast<int16_t*>(&cv);
#pragma unroll
    for (int k = 0; k < 8; ++k) {
      int c;
      cases[(8 * q + k) * kCPitch + r] = static_cast<uint8_t>(
          classify_case(pf[k], mk[k], hi1 != 0, res_setting, c, n1, n3, n5));
      code[k] = static_cast<int16_t>(c);
    }
    *reinterpret_cast<int4*>(ro + at) = cv;
  }
  constexpr int kLeft = kCRows * (kD / 8), kRowVecs = kN / 8;
  for (int i = t; i < kLeft + kCRows * kRowVecs; i += kCThreads) {
    const int k = i - kLeft;
    const size_t at = i < kLeft
                          ? (j0 + i / (kD / 8)) * kN + (i % (kD / 8)) * 8
                          : (kD + j0 + k / kRowVecs) * kN + (k % kRowVecs) * 8;
    *reinterpret_cast<int4*>(o + at) = *reinterpret_cast<const int4*>(p + at);
  }
  __syncthreads();
  for (int k = t >> 5; k < kCRows; k += kCThreads / 32)
    classify_row(p, o, cases + k * kCPitch, j0 + k, lane);
  n1 = __reduce_add_sync(kFull, n1);
  n3 = __reduce_add_sync(kFull, n3);
  n5 = __reduce_add_sync(kFull, n5);
  if (lane == 0) {
    atomicAdd(&s_n[0], n1);
    atomicAdd(&s_n[1], n3);
    atomicAdd(&s_n[2], n5);
  }
  __syncthreads();
  if (t < 3) atomicAdd(counts + b * 3 + t, s_n[t]);
}

}  // namespace

extern "C" {

// S4.  in, out: (B, 512, 512) int16, 16-byte aligned.
int nhw_pair_promotion(const void* in, void* out, int batch, void* stream) {
  if (batch < 1 || batch > (1 << 21)) return cudaErrorInvalidValue;
  if (misaligned(in, 16) || misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  const int rows = batch * kN;
  pair_promotion_rows<<<(rows + kPPWarps - 1) / kPPWarps, kPPWarps * 32, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), batch);
  return cudaGetLastError();
}

// S5.  plane, out: (B, 512, 512) int16; rf_ext: (B, SZ + 1024) int16;
// rf_out: (B, SZ) int16; tab: (48960,) int16 scratch, the step's table of
// these flags (16-byte aligned), written first.  res_setting 0..8.
int nhw_column_ladder(const void* plane, const void* rf_ext, void* out,
                      void* rf_out, void* tab, int batch, int low1, int low2,
                      int hi1, int res_setting, void* stream) {
  if (batch < 1 || batch > 65535 || res_setting < 0 || res_setting > 8)
    return cudaErrorInvalidValue;
  if (misaligned(plane, 16) || misaligned(rf_ext, 16) || misaligned(out, 16) ||
      misaligned(rf_out, 2) || misaligned(tab, 16))
    return cudaErrorMisalignedAddress;
  const cudaError_t e = column_ladder_setup();
  if (e != cudaSuccess) return e;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<uint16_t*>(tab);
  ladder_table<<<(kLTab + 255) / 256, 256, 0, s>>>(
      LadderFlags{low1, low2, hi1, res_setting}, t);
  column_ladder<<<dim3(kLCtas, batch), kLThreads, kLSmem, s>>>(
      static_cast<const int16_t*>(plane), static_cast<const int16_t*>(rf_ext),
      static_cast<int16_t*>(out), static_cast<int16_t*>(rf_out), t);
  return cudaGetLastError();
}

// S6.  plane, out: (B, 512, 512) int16; res256, rf_out: (B, 256, 256)
// int16; all 16-byte aligned; counts: (B, 3) int32 (n1, n3, n5), zeroed
// by the caller (each CTA adds its share).
int nhw_classify(const void* plane, const void* res256, void* out,
                 void* rf_out, void* counts, int batch, int hi1,
                 int res_setting, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(plane, 16) || misaligned(res256, 16) ||
      misaligned(out, 16) || misaligned(rf_out, 16) || misaligned(counts, 4))
    return cudaErrorMisalignedAddress;
  classify_bands<<<dim3(kCCtas, batch), kCThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(plane), static_cast<const int16_t*>(res256),
      static_cast<int16_t*>(out), static_cast<int16_t*>(rf_out),
      static_cast<int*>(counts), hi1, res_setting);
  return cudaGetLastError();
}

}  // extern "C"
