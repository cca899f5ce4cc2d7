// Hand-written Hopper (sm_90a) kernel of the device encode scans' low-q
// cleanups.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrapper and torch twin in
// nhwcodec_tpu_torch/models/device_scans.py (lowest_q_band_cleanup_device /
// lowest_q_band_cleanup_ref).
//
// S11 nhw_lowest_q_band_cleanup replaces
//    nhwcodec_tpu/models/device_scans.py:2165 lowest_q_band_cleanup_device
//    (two Jacobi while_loops, one over loop A's quadrant and one over the
//    lower half): the q < LOW6 band dead-zoning of a (B, 512, 512) int16
//    plane against r3_ext (B, r3_len) int16 (resIII and the heap-alias tail
//    its last rows read) with each image's thresholds xs (B, 5) int32.
//    One launch (lowest_q_rows, a cluster of 8 CTAs an image).
//
// A visit reads its left neighbour as the walk left it, its right
// neighbour as it was, and may zero either (pairL, pairR) or itself.
// - Loop A (rows 0..255, columns 256..511) never crosses a row: column 255
//   and the next row's column 0, its reads past the region, are written
//   only by the visit that reads them.  Its pairL at column 256 zeroes
//   column 255, its pairR at column 511 the next row's column 0 (rows
//   1..256; row 256's is loops B + C's first input).
// - Loops B + C (rows 256..511) are one walk over columns 0..510 of each
//   row, the thresholds switching at column 256.  It crosses a row only
//   through column 511, which it does not visit: the next row's column-0
//   visit reads it as its left neighbour, zeroed or not by the row's pairR
//   at column 510.  Row 256 enters from loop A's row 255.  pairL at column
//   0 zeroes the previous row's column 511 once that row is done.
//
// The carry into a visit is one of 5 states: (left the input at the column
// before, none pending), (0, none), (0, this visit's value zeroed by the
// last visit's pairR), (+7, none), (-7, none): a visit writes its input, 0
// or the +-7 snap, and pairR leaves 0 behind.  The right neighbour and the
// r3 test are inputs, so each visit is a table of the next state (and of
// pairL) from the 5, fixed by its own inputs (lq_table: range tests as
// compares combined with & and |, no branches), and a run of visits is a
// map of 5 states, 3 bits each, as S3's.
//
// The bound is bytes: the plane read once and written once, r3_ext's
// slices read once, some 30 operations a visit.  A cluster of 8 CTAs an
// image, 16 warps a CTA; CTA k takes rows 32 k..32 k + 31 of loop A and
// 256 + 32 k.. of B + C, a warp two rows of each, loaded and stored whole
// in 16-byte accesses (lane l: loop A's columns 256 + 8 l.., B + C's 16 l..;
// the lane's r3 values in one load).  A lane builds its visits' tables and
// composes them, the warp scans the 32 lane maps with shuffles:
// - a row of loop A enters from its own state 0, so each lane walks its
//   visits again at once and the warp writes the row; its column 0 (pairR
//   at the row above's column 511) after the cluster barrier;
// - a row of B + C keeps its tables and lane prefixes in shared memory;
//   its map from the entry states to the next row's (pairR at 510 or not)
//   is composed over the CTA's 32 rows by warp 0, and each CTA pushes its
//   composite (CTA 7 also row 256's entry, the exit of loop A's row 255,
//   and each CTA its last loop-A row's pairR at 511) to every CTA of the
//   cluster (DSM) before one cluster barrier.  Each CTA then chains the
//   composites before it from row 256's entry, and each lane walks its
//   visits again from its entry.  Column 511 is zeroed by the row's pairR
//   at 510 or by the next row's pairL at column 0, whose visit the row's
//   lane 31 makes from the next row's entry (its own exit).

#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using nhw::iabs;
using nhw::map5_at;
using nhw::map5_warp_scan;

constexpr int kN = 512;
constexpr int kD = 256;
constexpr int kSZ = 65536;
constexpr int kPlane = kN * kN;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kLqCtas = 8;                 // CTAs an image: one cluster
constexpr int kLqWarps = 16;               // warps a CTA
constexpr int kLqThreads = kLqWarps * 32;
constexpr int kLqRows = kD / kLqCtas;      // rows of A and of B + C a CTA
constexpr int kBcTile = 16;                // B + C visits a lane
constexpr int kATile = 8;                  // loop A visits a lane
constexpr int kR3Min = ((kSZ - 2) >> 1) + (kSZ >> 1) + 128 + 1;
static_assert(kLqRows == 2 * kLqWarps, "two rows of each loop a warp");

// A segment's parameters: phase 1's window [8, thi) and phase 2's [8, tlo)
// as unsigned widths of av - 8 (thi - 8, tlo - 8; 0 when empty), lo2 (|v|
// below it zeroes without the isolation test; 0: never) and the +-7 snap.
struct Seg {
  uint32_t w1, w2;
  int lo2;
  bool snap;
};

__device__ __forceinline__ Seg make_seg(int thi, int tlo, int lo2,
                                        bool snap) {
  return Seg{thi > 8 ? uint32_t(thi - 8) : 0u,
             tlo > 8 ? uint32_t(tlo - 8) : 0u, lo2, snap};
}

// A visit's table: 6 bits a carry state s at bits 6 s..6 s + 5, 6 times
// the next state (bits 0-4) and pairL (bit 5).  The walk carries a state
// as its field's offset 6 s, so a step is a shift and a mask.  States: 0
// (left the input at the column before), 1 (left 0), 2 (left 0, the value
// zeroed by the last visit's pairR: nothing fires, next 1), 3 (left +7),
// 4 (left -7).
constexpr uint32_t kFields = 1u | 1u << 6 | 1u << 18 | 1u << 24;   // 0 1 3 4
constexpr uint32_t kConstLeft = 1u << 6 | 1u << 18 | 1u << 24;     // 1 3 4
constexpr uint32_t kState2 = 6u << 12;                               // -> 1
constexpr uint32_t kStay = 6u << 6 | 12u << 12 | 18u << 18 | 24u << 24;

// |v| < x5 as unsigned(v + x5 - 1) < 2 x5 - 1 (never when x5 <= 0), and
// the constant lefts' |left| < x5 as field bits.
struct Pair {
  int m1;
  uint32_t w, lb;
};

__device__ __forceinline__ Pair make_pair(int x5) {
  return Pair{x5 - 1, x5 > 0 ? uint32_t(2 * x5 - 1) : 0u,
              (x5 > 0 ? 1u << 6 : 0u) | (x5 > 7 ? 1u << 18 | 1u << 24 : 0u)};
}

// The table of a visit (encoder/nhw_encoder.c:833-968) at input x (the
// value unless the last visit's pairR zeroed it), right the input at the
// next column, xl the input at the column before, r3ok its r3 test.  The
// visit's tests of its left neighbour (|x + left| < x5 for pairL, |left|
// < x5 for pairR, |left| < 8 for the isolation) are bit masks over the
// four lefts (xl, 0, +7, -7) at their fields' bit 0, and so are the rules
// that fire: pairL, pairR (the next state 2), a zeroing (1), the phase-2
// write (the snap's state, or 1); no branches.  Phase 1 writes 0 where it
// fires, so phase 2 reads the neighbours as the visit found them.
__device__ __forceinline__ uint32_t lq_table(const Seg& g, const Pair& q,
                                             int x, int xl, int right,
                                             bool r3ok) {
  const int av = iabs(x);
  const bool c1 = uint32_t(av - 8) < g.w1;
  const bool c2 = uint32_t(av - 8) < g.w2;
  const bool lo = av < g.lo2;
  const bool r8 = uint32_t(right + 7) < 15u;
  const bool rok = uint32_t(right + q.m1) < q.w;
  const bool prv = uint32_t(x + right + q.m1) < q.w;
  const int xb = x + q.m1;
  const uint32_t la = (uint32_t(xb + xl) < q.w ? 1u : 0u) |
                      (uint32_t(xb) < q.w ? 1u << 6 : 0u) |
                      (uint32_t(xb + 7) < q.w ? 1u << 18 : 0u) |
                      (uint32_t(xb - 7) < q.w ? 1u << 24 : 0u);
  const uint32_t lb = q.lb | (uint32_t(xl + q.m1) < q.w ? 1u : 0u);
  const uint32_t lc = kConstLeft | (uint32_t(xl + 7) < 15u ? 1u : 0u);
  const bool pair = c1 & !r3ok;
  const uint32_t pl = pair & rok ? la : 0u;
  const uint32_t pr = pair & prv ? lb & ~pl : 0u;
  const uint32_t f1 = c1 & r3ok ? kFields : pl | pr;
  const uint32_t hit =
      c2 ? ((r8 ? lc : 0u) | (lo ? kFields : 0u)) & ~f1 : 0u;
  const uint32_t hit6 = g.snap & (x >= 16)    ? 18u
                        : g.snap & (x <= -16) ? 24u
                                              : 6u;
  return (pr + f1) * 6u + hit * hit6 + kState2 + (pl << 5);
}

// A state's field offset after a step from offset off, and its pairL.
__device__ __forceinline__ int lq_step(uint32_t tab, int off) {
  return (tab >> off) & 31;
}

__device__ __forceinline__ uint32_t lq_pl(uint32_t tab, int off) {
  return (tab >> (off + 5)) & 1u;
}

// The value a visit leaves at input x when it moves to the state at
// offset off.
__device__ __forceinline__ int lq_value(int off, int x) {
  return off == 0 ? x : off == 18 ? 7 : off == 24 ? -7 : 0;
}

// The map of 5 states (block_scan.cuh's map5) from the offsets that the
// walks from the 5 states reached (off / 6 as (off * 43) >> 8).
__device__ __forceinline__ uint32_t lq_map(const int* off) {
  uint32_t m = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s) m |= uint32_t((off[s] * 43) >> 8) << (3 * s);
  return m;
}

struct Thresholds {
  int x1, x2, x3, x4, x5;
  __device__ explicit Thresholds(const int* xs)
      : x1(xs[0]), x2(xs[1]), x3(xs[2]), x4(xs[3]), x5(xs[4]) {}
};

__device__ __forceinline__ Seg seg_a(const Thresholds& x) {
  return make_seg(x.x3 + 2, x.x3, 0, false);
}

__device__ __forceinline__ Seg seg_b(const Thresholds& x) {
  return make_seg(x.x1 + 2, x.x1, x.x1 - 4, false);
}

__device__ __forceinline__ Seg seg_c(const Thresholds& x, int gt_low10) {
  return make_seg(x.x2 + 1, x.x2, x.x2 - 5, gt_low10 != 0);
}

// kN16 (4, 8 or 16) int16 values from p (aligned to 2 kN16 bytes, at most
// 16, when vec).
template <int kN16>
__device__ __forceinline__ void load16(const int16_t* p, bool vec, int* x) {
  if (vec && kN16 == 4) {
    const int2 q = *reinterpret_cast<const int2*>(p);
    const int16_t* e = reinterpret_cast<const int16_t*>(&q);
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = e[i];
  } else if (vec) {
#pragma unroll
    for (int k = 0; k < kN16 / 8; ++k) {
      const int4 q = reinterpret_cast<const int4*>(p)[k];
      const int16_t* e = reinterpret_cast<const int16_t*>(&q);
#pragma unroll
      for (int i = 0; i < 8; ++i) x[8 * k + i] = e[i];
    }
  } else {
#pragma unroll
    for (int i = 0; i < kN16; ++i) x[i] = p[i];
  }
}

__device__ __forceinline__ uint4 pack8(const int* v) {
  return make_uint4(nhw::pack16(v[0], v[1]), nhw::pack16(v[2], v[3]),
                    nhw::pack16(v[4], v[5]), nhw::pack16(v[6], v[7]));
}

__device__ __forceinline__ void unpack8(uint4 q, int* x) {
  const uint32_t w[4] = {q.x, q.y, q.z, q.w};
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    x[2 * k] = static_cast<int16_t>(w[k] & 0xFFFFu);
    x[2 * k + 1] = static_cast<int16_t>(w[k] >> 16);
  }
}

struct LqShared {
  uint32_t tab[kLqRows][kBcTile][32];   // B + C rows: each visit's table
  uint32_t lane_pre[kLqRows][32];       // ... each lane's exclusive prefix
  uint32_t row_map[kLqRows];            // ... entry state -> next row's
  uint32_t row_pre[kLqRows];            // ... the CTA's rows before it
  uint32_t a_flag[kLqRows];             // loop A rows: pairR at 511
  uint32_t e256;                        // row 256's entry (CTA 7)
  uint32_t pub[kLqCtas];                // each CTA's word, see below
};

// The int16 at k of 16 packed two to a word.
__device__ __forceinline__ int at16(const uint32_t* w, int k) {
  return static_cast<int16_t>(w[k >> 1] >> (16 * (k & 1)));
}

__device__ __forceinline__ void load_words(const int16_t* p, uint32_t* w) {
  const uint4 a = reinterpret_cast<const uint4*>(p)[0];
  const uint4 b = reinterpret_cast<const uint4*>(p)[1];
  w[0] = a.x, w[1] = a.y, w[2] = a.z, w[3] = a.w;
  w[4] = b.x, w[5] = b.y, w[6] = b.z, w[7] = b.w;
}

// Bit i: |r3 value i| < thr, for kN16 values from p.
template <int kN16>
__device__ __forceinline__ uint32_t r3_bits(const int16_t* p, bool vec,
                                            int thr) {
  int q[kN16];
  load16<kN16>(p, vec, q);
  uint32_t ok = 0;
#pragma unroll
  for (int i = 0; i < kN16; ++i) ok |= uint32_t(iabs(q[i]) < thr) << i;
  return ok;
}

// Loop A's row r (0..255): walks it, stores it but for the 16 bytes of
// columns 0..7 (lane 0, after the cluster barrier) and returns (lane 31)
// the row's exit state; row 255's column 511 also takes pairL at (256, 0)
// from that state.
__device__ __forceinline__ int lq_a_row(const int16_t* I, const int16_t* r3,
                                        bool r3vec, int16_t* O,
                                        const Thresholds& x, const Pair& q,
                                        int r, int lane) {
  const Seg g = seg_a(x);
  int v[kATile];
  unpack8(reinterpret_cast<const uint4*>(I + r * kN)[32 + lane], v);
  const uint32_t ok = r3_bits<4>(r3 + 128 + r * 128 + 4 * lane, r3vec, x.x4);
  const int left0 = I[r * kN + kD - 1];                 // column 255
  const int xl0 = __shfl_up_sync(kFull, v[kATile - 1], 1);
  const int xr = __shfl_down_sync(kFull, v[0], 1);
  const int next0 = lane == 31 ? I[(r + 1) * kN] : 0;   // the next row's col 0
  uint32_t tab[kATile];
  int off[5] = {0, 6, 12, 18, 24};
#pragma unroll
  for (int k = 0; k < kATile; ++k) {
    const int xl = k ? v[k - 1] : lane ? xl0 : left0;
    const int right = k + 1 < kATile ? v[k + 1] : lane < 31 ? xr : next0;
    tab[k] = lq_table(g, q, v[k], xl, right, (ok >> (k >> 1)) & 1u);
#pragma unroll
    for (int s = 0; s < 5; ++s) off[s] = lq_step(tab[k], off[s]);
  }
  // (256, 0): row 256's first visit, from row 255's exit
  uint32_t t256 = 0;
  if (lane == 31 && r == kD - 1)
    t256 = lq_table(seg_b(x), q, next0, v[kATile - 1], I[kD * kN + 1],
                    iabs(r3[kSZ >> 1]) < x.x4);
  uint32_t m = lq_map(off);
  int at = 6 * map5_at(map5_warp_scan(m, lane), 0);
  uint32_t pl = 0;
#pragma unroll
  for (int k = 0; k < kATile; ++k) {
    pl |= lq_pl(tab[k], at) << k;
    at = lq_step(tab[k], at);
    v[k] = lq_value(at, v[k]);
  }
  const uint32_t pl_next = __shfl_down_sync(kFull, pl & 1u, 1);
  const uint32_t pl256 = __shfl_sync(kFull, pl & 1u, 0);
#pragma unroll
  for (int k = 0; k + 1 < kATile; ++k)
    if ((pl >> (k + 1)) & 1u) v[k] = 0;
  if (lane < 31 && pl_next) v[kATile - 1] = 0;
  if (lq_pl(t256, at)) v[kATile - 1] = 0;
  uint4* dst = reinterpret_cast<uint4*>(O + r * kN);
  dst[32 + lane] = pack8(v);
  if (lane) {
    int a[8];
    unpack8(reinterpret_cast<const uint4*>(I + r * kN)[lane], a);
    if (lane == 31 && pl256) a[7] = 0;                  // column 255
    dst[lane] = pack8(a);
  }
  return at / 6;
}

__global__ void __launch_bounds__(kLqThreads, 2)
    lowest_q_rows(const int16_t* __restrict__ in,
                  const int16_t* __restrict__ r3_ext,
                  const int* __restrict__ xs, int16_t* __restrict__ out,
                  int r3_len, int gt_low10) {
  extern __shared__ __align__(16) unsigned char lq_smem[];
  LqShared& sh = *reinterpret_cast<LqShared*>(lq_smem);
  nhw::cluster_arrive_relaxed();
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const size_t b = blockIdx.y;
  const int16_t* I = in + b * kPlane;
  const int16_t* r3 = r3_ext + b * r3_len;
  int16_t* O = out + b * kPlane;
  const bool r3vec =
      (reinterpret_cast<uintptr_t>(r3_ext) & 15) == 0 && r3_len % 8 == 0;
  const Thresholds x(xs + b * 5);
  const Pair q = make_pair(x.x5);
  const int r0 = rank * kLqRows;
  // loop A, rows r0 + w and r0 + w + 16
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int lr = w + kLqWarps * h, r = r0 + lr;
    const int st = lq_a_row(I, r3, r3vec, O, x, q, r, lane);
    if (lane == 31) {
      sh.a_flag[lr] = st == 2;
      if (r == kD - 1) sh.e256 = st;
    }
  }
  // B + C, rows 256 + r0 + w and + 16: each visit's table, the lanes' maps
  const Seg gs = lane < 16 ? seg_b(x) : seg_c(x, gt_low10);
  const int thr = lane < 16 ? x.x4 : x.x4 + 1;
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int lr = w + kLqWarps * h, r = kD + r0 + lr;
    uint32_t v[8];
    load_words(I + r * kN + kBcTile * lane, v);
    const uint32_t ok =
        r3_bits<8>(r3 + (kSZ >> 1) + (r - kD) * 128 + 8 * lane, r3vec, thr);
    const int xl0 = __shfl_up_sync(kFull, at16(v, kBcTile - 1), 1);
    const int xr = __shfl_down_sync(kFull, at16(v, 0), 1);
    const int prev511 = lane == 0 ? I[r * kN - 1] : 0;
    int off[5] = {0, 6, 12, 18, 24};
#pragma unroll
    for (int k = 0; k < kBcTile; ++k) {
      const int xl = k ? at16(v, k - 1) : lane ? xl0 : prev511;
      const int right = k + 1 < kBcTile ? at16(v, k + 1) : xr;
      const uint32_t t = lq_table(gs, q, at16(v, k), xl, right,
                                  (ok >> (k >> 1)) & 1u);
      // column 511 is not visited: each state stays
      const uint32_t tab = lane == 31 && k + 1 == kBcTile ? kStay : t;
      sh.tab[lr][k][lane] = tab;
#pragma unroll
      for (int s = 0; s < 5; ++s) off[s] = lq_step(tab, off[s]);
    }
    uint32_t m = lq_map(off);
    sh.lane_pre[lr][lane] = map5_warp_scan(m, lane);
    if (lane == 31) {
      // the next row's entry: 1 after pairR at 510, else 0
      uint32_t rm = 0;
#pragma unroll
      for (int s = 0; s < 5; ++s) rm |= uint32_t(map5_at(m, s) == 2) << (3 * s);
      sh.row_map[lr] = rm;
    }
  }
  __syncthreads();
  nhw::cluster_wait();         // every CTA of the cluster has started
  if (w == 0) {
    uint32_t m = sh.row_map[lane];
    sh.row_pre[lane] = map5_warp_scan(m, lane);
    const uint32_t comp = __shfl_sync(kFull, m, 31);
    const uint32_t word = comp |
                          (rank == kLqCtas - 1 ? sh.e256 << 15 : 0u) |
                          (sh.a_flag[kLqRows - 1] << 18);
    if (lane < kLqCtas) *cluster.map_shared_rank(&sh.pub[rank], lane) = word;
  }
  nhw::cluster_arrive_release();
  nhw::cluster_wait();
  int e = (sh.pub[kLqCtas - 1] >> 15) & 7;   // row 256's entry
  for (int k = 0; k < rank; ++k) e = map5_at(sh.pub[k] & 0x7FFFu, e);
  // loop A: columns 0..7, column 0 zeroed by the row above's pairR at 511
  if (lane == 0) {
#pragma unroll 1
    for (int h = 0; h < 2; ++h) {
      const int lr = w + kLqWarps * h, r = r0 + lr;
      int a[8];
      unpack8(reinterpret_cast<const uint4*>(I + r * kN)[0], a);
      const uint32_t above = lr ? sh.a_flag[lr - 1]
                             : rank ? (sh.pub[rank - 1] >> 18) & 1u : 0u;
      if (above) a[0] = 0;
      reinterpret_cast<uint4*>(O + r * kN)[0] = pack8(a);
    }
  }
  // B + C: each row walked again from its entry
#pragma unroll 1
  for (int h = 0; h < 2; ++h) {
    const int lr = w + kLqWarps * h, r = kD + r0 + lr;
    uint32_t v[8];
    load_words(I + r * kN + kBcTile * lane, v);
    int at =
        6 * map5_at(sh.lane_pre[lr][lane], map5_at(sh.row_pre[lr], e));
    uint32_t pl = 0, o[8] = {0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
#pragma unroll
    for (int k = 0; k < kBcTile; ++k) {
      const uint32_t tab = sh.tab[lr][k][lane];
      pl |= lq_pl(tab, at) << k;
      at = lq_step(tab, at);
      const int val = lane == 31 && k + 1 == kBcTile
                          ? at16(v, k)
                          : lq_value(at, at16(v, k));
      o[k >> 1] |= (static_cast<uint32_t>(val) & 0xFFFFu) << (16 * (k & 1));
    }
    // a value is zeroed by the next visit's pairL (the next lane's first
    // for the lane's last)
    const uint32_t pl_next = __shfl_down_sync(kFull, pl & 1u, 1);
    uint32_t zero = (pl >> 1) | (lane < 31 ? pl_next << (kBcTile - 1) : 0u);
    if (lane == 31) {
      // column 511: the state is 2 (offset 12) after pairR at 510; else
      // the next row enters from state 0 (left column 511) and its
      // column-0 visit may pairL it
      bool z511 = at == 12;
      if (!z511 && r + 1 < kN) {
        const uint32_t tab = lq_table(
            seg_b(x), q, I[(r + 1) * kN], at16(v, kBcTile - 1),
            I[(r + 1) * kN + 1],
            iabs(r3[(kSZ >> 1) + (r + 1 - kD) * 128]) < x.x4);
        z511 = lq_pl(tab, 0);
      }
      zero |= uint32_t(z511) << (kBcTile - 1);
    }
#pragma unroll
    for (int k = 0; k < kBcTile; ++k)
      if ((zero >> k) & 1u) o[k >> 1] &= ~(0xFFFFu << (16 * (k & 1)));
    uint4* dst = reinterpret_cast<uint4*>(O + r * kN + kBcTile * lane);
    dst[0] = make_uint4(o[0], o[1], o[2], o[3]);
    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);
  }
}

const nhw::ClusterKernel& lq_kernel() {
  static const nhw::ClusterKernel k = nhw::cluster_setup(
      lowest_q_rows, kLqCtas, kLqThreads, sizeof(LqShared));
  return k;
}

}  // namespace

extern "C" {

// S11.  in, out: (B, 512, 512) int16, 16-byte aligned; r3_ext: (B, r3_len)
// int16, r3_len >= 65664 (resIII, then the tail the last rows read); xs:
// (B, 5) int32, each image's (x1, x2, x3, x4, x5).  One cluster launch.
int nhw_lowest_q_band_cleanup(const void* in, const void* r3_ext,
                              const void* xs, void* out, int batch,
                              int r3_len, int gt_low10, void* stream) {
  if (batch < 1 || batch > 65535 || r3_len < kR3Min)
    return cudaErrorInvalidValue;
  if (nhw::misaligned(in, 16) || nhw::misaligned(out, 16) ||
      nhw::misaligned(r3_ext, 2) || nhw::misaligned(xs, 4))
    return cudaErrorMisalignedAddress;
  return nhw::launch_cluster(
      lq_kernel(), lowest_q_rows, batch, static_cast<cudaStream_t>(stream),
      static_cast<const int16_t*>(in), static_cast<const int16_t*>(r3_ext),
      static_cast<const int*>(xs), static_cast<int16_t*>(out), r3_len,
      gt_low10);
}

// What the card allows for S11's cluster kernel: info[0] registers per
// thread, info[1] shared memory per CTA, info[2] the most clusters
// resident at once.
int nhw_lowest_q_band_cleanup_info(void* info) {
  return nhw::cluster_info(lq_kernel(), info);
}

}  // extern "C"
