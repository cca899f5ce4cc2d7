// Hand-written Hopper (sm_90a) kernels of the device encode scans' low-q
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
//    Three launches.
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
//   at column 510.  So a row enters from one of two states and leaves in
//   one; row 256 enters from loop A's last value.  pairL at column 0 zeroes
//   the previous row's column 511 once that row is done.
//
// The bound is bytes: the plane read once and written once, r3_ext's
// slices read once, some 30 operations a visit.  Each launch takes 32 rows
// a CTA, a thread a row, staged in shared memory with their flat
// neighbours (block_scan.cuh's stage_rows) and their r3 tests as bits (a
// ballot a word), so that the walks read no global memory.  lq_a walks
// loop A's rows and writes them back whole, and marks the rows whose
// pairR at 511 zeroes the next row's column 0.  lq_maps walks each row of
// B + C from both entry states for its exit (pairR at 510).  lq_emit
// chains an image's 256 exits in its warp (block_scan.cuh's
// chain_entries), walks each row again from its entry, in place, and
// writes it back; column 511 is zeroed by the row's pairR at 510 or by
// the next row's pairL at column 0, whose visit the thread repeats from
// the next row's entry (its own exit).  lq_emit also writes loop A's
// zeroes into columns 0 and row 255's column 511.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

using nhw::iabs;
using nhw::kStagePitch;

constexpr int kN = 512;
constexpr int kD = 256;
constexpr int kSZ = 65536;
constexpr int kPlane = kN * kN;
constexpr int kRows = 32;                  // rows a CTA, a thread each
constexpr int kR3A = 128;                  // r3 values a row of loop A reads
constexpr int kR3H = 256;                  // ... a row of B + C (B, then C)
constexpr int kOkPitch = 9;                // words of r3 bits a staged row
constexpr int kR3Min = ((kSZ - 2) >> 1) + (kSZ >> 1) + 128 + 1;

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// A segment's parameters: phase 1's window [8, thi), phase 2's window [8,
// tlo), lo2 (|v| below it zeroes without the isolation test; 0: never) and
// the +-7 snap.
struct Seg {
  int thi, tlo, lo2;
  bool snap;
};

// One visit (encoder/nhw_encoder.c:833-968) on vin, the value the walk
// found there; left and right as the visit found them (where phase 1
// writes, the value is 0 and phase 2 has nothing to do); r3ok: the r3
// test of the position.
__device__ __forceinline__ int lq_visit(const Seg& s, int x5, int vin,
                                        int left, int right, bool r3ok,
                                        bool& pl, bool& pr) {
  pl = pr = false;
  int v = vin;
  const int av = iabs(vin);
  if (av >= 8 && av < s.thi) {
    if (r3ok) {
      v = 0;
    } else if (iabs(vin + left) < x5 && iabs(right) < x5) {
      v = 0;
      pl = true;
    } else if (iabs(vin + right) < x5 && iabs(left) < x5) {
      v = 0;
      pr = true;
    }
  }
  const int av2 = iabs(v);
  if (av2 >= 8 && av2 < s.tlo &&
      ((iabs(left) < 8 && iabs(right) < 8) || av2 < s.lo2))
    v = s.snap ? (v >= 16 ? 7 : (v <= -16 ? -7 : 0)) : 0;
  return v;
}

struct Thresholds {
  int x1, x2, x3, x4, x5;
  __device__ explicit Thresholds(const int* xs)
      : x1(xs[0]), x2(xs[1]), x3(xs[2]), x4(xs[3]), x5(xs[4]) {}
};

// Stage the r3 tests as bits: row k's bit i is |r3[first + k * kR3A + i]|
// < thr0 (i < 128) or thr1, for its n values, at ok + k * kOkPitch (a warp
// a row, one ballot a word).
__device__ __forceinline__ void stage_r3ok(const int16_t* __restrict__ r3,
                                           int first, int n, int thr0,
                                           int thr1, uint32_t* ok) {
  const int lane = threadIdx.x & 31;
  for (int k = threadIdx.x >> 5; k < kRows; k += blockDim.x >> 5)
    for (int i = lane; i < n; i += 32) {
      const int thr = i < 128 ? thr0 : thr1;
      const unsigned m =
          __ballot_sync(0xFFFFFFFFu, iabs(r3[first + k * kR3A + i]) < thr);
      if (lane == 0) ok[k * kOkPitch + (i >> 5)] = m;
    }
}

__device__ __forceinline__ bool bit(const uint32_t* ok, int i) {
  return (ok[i >> 5] >> (i & 31)) & 1u;
}

// Row t + 256's walk over columns 0..510, staged at row (column 0 holding
// its first value), from the left neighbour left; writes the row in place
// when kWrite.  ok: its r3 bits (column j's is bit j / 2).  Returns pairR
// at column 510; pl0: pairL at column 0.
template <bool kWrite>
__device__ __forceinline__ bool bc_walk(int16_t* row, int left,
                                        const uint32_t* ok, const Seg& sb,
                                        const Seg& sc, int x5, bool& pl0) {
  bool z = false, pl, pr;
  int cur = row[0];
  for (int j = 0; j < kD; ++j) {
    const int right = row[j + 1];
    const int v = lq_visit(sb, x5, z ? 0 : cur, left, right,
                           bit(ok, j >> 1), pl, pr);
    if (kWrite) {
      row[j] = static_cast<int16_t>(v);
      if (pl && j > 0) row[j - 1] = 0;
    }
    if (j == 0) pl0 = pl;
    left = v;
    z = pr;
    cur = right;
  }
  for (int j = kD; j < kN - 1; ++j) {
    const int right = row[j + 1];
    const int v = lq_visit(sc, x5, z ? 0 : cur, left, right,
                           bit(ok, j >> 1), pl, pr);
    if (kWrite) {
      row[j] = static_cast<int16_t>(v);
      if (pl) row[j - 1] = 0;
    }
    left = v;
    z = pr;
    cur = right;
  }
  return z;
}

__device__ __forceinline__ Seg seg_b(const Thresholds& x) {
  return Seg{x.x1 + 2, x.x1, x.x1 - 4, false};
}

__device__ __forceinline__ Seg seg_c(const Thresholds& x, int gt_low10) {
  return Seg{x.x2 + 1, x.x2, x.x2 - 5, gt_low10 != 0};
}

// Loop A: rows r0..r0 + 31 of 0..255, columns 256..511; writes the rows
// back whole and flags (B, 256) uint8: pairR at column 511.
__global__ void __launch_bounds__(kRows)
    lq_a(const int16_t* __restrict__ in, const int16_t* __restrict__ r3_ext,
         const int* __restrict__ xs, int16_t* __restrict__ out,
         uint8_t* __restrict__ flags, int r3_len) {
  __shared__ int16_t s[kRows * kStagePitch];
  __shared__ uint32_t ok_s[kRows * kOkPitch];
  const size_t b = blockIdx.y;
  const int r0 = blockIdx.x * kRows, t = threadIdx.x;
  const Thresholds x(xs + b * 5);
  nhw::stage_rows(in + b * kPlane, r0, kRows, s);
  stage_r3ok(r3_ext + b * r3_len, r0 * kR3A + 128, kR3A, x.x4, x.x4, ok_s);
  __syncthreads();
  const Seg sa{x.x3 + 2, x.x3, 0, false};
  int16_t* row = s + t * kStagePitch + 1;
  const uint32_t* ok = ok_s + t * kOkPitch;
  int left = row[kD - 1], cur = row[kD];
  bool z = false, pl, pr;
  for (int j = kD; j < kN; ++j) {
    const int right = row[j + 1];   // 511: the next row's column 0
    const int v = lq_visit(sa, x.x5, z ? 0 : cur, left, right,
                           bit(ok, (j - kD) >> 1), pl, pr);
    row[j] = static_cast<int16_t>(v);
    if (pl) row[j - 1] = 0;
    left = v;
    z = pr;
    cur = right;
  }
  flags[b * kD + r0 + t] = z;
  __syncthreads();
  nhw::unstage_rows(s, kRows, out + b * kPlane, r0);
}

// Stage rows 256 + r0.. of B + C and their r3 bits (B's against x4, C's
// against x4 + 1); row 256 gets loop A's results: its left neighbour (row
// 255's last value, from out) and its column 0 (zeroed by row 255's pairR
// at 511).
__device__ __forceinline__ void stage_bc(const int16_t* in,
                                         const int16_t* r3, const int16_t* out,
                                         const uint8_t* flags, int r0, int x4,
                                         int16_t* s, uint32_t* ok) {
  nhw::stage_rows(in, kD + r0, kRows, s);
  stage_r3ok(r3, (kSZ >> 1) + r0 * kR3A, kR3H, x4, x4 + 1, ok);
  __syncthreads();
  if (r0 == 0 && threadIdx.x == 0) {
    s[0] = out[kD * kN - 1];
    if (flags[kD - 1]) s[1] = 0;
  }
  __syncthreads();
}

// B + C: each row from both entry states -> exits (B, 256, 2) uint8.
__global__ void __launch_bounds__(kRows)
    lq_maps(const int16_t* __restrict__ in,
            const int16_t* __restrict__ r3_ext, const int* __restrict__ xs,
            const int16_t* __restrict__ out, const uint8_t* __restrict__ flags,
            uint8_t* __restrict__ exits, int r3_len, int gt_low10) {
  __shared__ int16_t s[kRows * kStagePitch];
  __shared__ uint32_t ok_s[kRows * kOkPitch];
  const size_t b = blockIdx.y;
  const int r0 = blockIdx.x * kRows, t = threadIdx.x;
  const Thresholds x(xs + b * 5);
  stage_bc(in + b * kPlane, r3_ext + b * r3_len, out + b * kPlane,
           flags + b * kD, r0, x.x4, s, ok_s);
  const Seg sb = seg_b(x), sc = seg_c(x, gt_low10);
  int16_t* row = s + t * kStagePitch + 1;
  const uint32_t* ok = ok_s + t * kOkPitch;
  bool pl0;
  uint8_t* e = exits + (b * kD + r0 + t) * 2;
  e[0] = bc_walk<false>(row, row[-1], ok, sb, sc, x.x5, pl0);
  e[1] = bc_walk<false>(row, 0, ok, sb, sc, x.x5, pl0);
}

// B + C: chain the image's exits, walk each row from its entry and write
// it; then loop A's zeroes outside its region.
__global__ void __launch_bounds__(kRows)
    lq_emit(const int16_t* __restrict__ in,
            const int16_t* __restrict__ r3_ext, const int* __restrict__ xs,
            int16_t* __restrict__ out, const uint8_t* __restrict__ flags,
            const uint8_t* __restrict__ exits, int r3_len, int gt_low10) {
  __shared__ int16_t s[kRows * kStagePitch];
  __shared__ uint32_t ok_s[kRows * kOkPitch];
  __shared__ uint8_t exit_s[kD * 2];
  __shared__ uint8_t entry_s[kD];
  const size_t b = blockIdx.y;
  const int r0 = blockIdx.x * kRows, t = threadIdx.x, rt = r0 + t;
  int16_t* O = out + b * kPlane;
  const int16_t* r3 = r3_ext + b * r3_len;
  const Thresholds x(xs + b * 5);
  for (int i = t; i < kD * 2; i += kRows) exit_s[i] = exits[b * kD * 2 + i];
  stage_bc(in + b * kPlane, r3, O, flags + b * kD, r0, x.x4, s, ok_s);
  nhw::chain_entries<2>(exit_s, entry_s, kD);
  __syncthreads();
  const Seg sb = seg_b(x), sc = seg_c(x, gt_low10);
  int16_t* row = s + t * kStagePitch + 1;
  const int last = row[kN - 1];   // column 511, never visited
  bool pl0;
  const bool pr510 = bc_walk<true>(row, entry_s[rt] ? 0 : row[-1],
                                   ok_s + t * kOkPitch, sb, sc, x.x5, pl0);
  // the next row's column-0 visit, from its entry (this row's exit)
  bool pl_next = false, pr;
  if (rt + 1 < kD)
    lq_visit(sb, x.x5, row[kN], pr510 ? 0 : last, row[kN + 1],
             iabs(r3[(kSZ >> 1) + (rt + 1) * kR3A]) < x.x4, pl_next, pr);
  row[kN - 1] = static_cast<int16_t>(pr510 || pl_next ? 0 : last);
  if (rt == 0 && pl0) O[kD * kN - 1] = 0;
  if (rt > 0 && flags[b * kD + rt - 1]) O[rt * kN] = 0;
  __syncthreads();
  nhw::unstage_rows(s, kRows, O, kD + r0);
}

}  // namespace

extern "C" {

// S11.  in, out: (B, 512, 512) int16, 16-byte aligned; r3_ext: (B, r3_len)
// int16, r3_len >= 65664 (resIII, then the tail the last rows read); xs:
// (B, 5) int32, each image's (x1, x2, x3, x4, x5); scratch: (B, 768) uint8.
int nhw_lowest_q_band_cleanup(const void* in, const void* r3_ext,
                              const void* xs, void* out, void* scratch,
                              int batch, int r3_len, int gt_low10,
                              void* stream) {
  if (batch < 1 || batch > 65535 || r3_len < kR3Min)
    return cudaErrorInvalidValue;
  if (misaligned(in, 16) || misaligned(out, 16) || misaligned(r3_ext, 2) ||
      misaligned(xs, 4))
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* I = static_cast<const int16_t*>(in);
  const auto* R = static_cast<const int16_t*>(r3_ext);
  const auto* X = static_cast<const int*>(xs);
  auto* O = static_cast<int16_t*>(out);
  auto* flags = static_cast<uint8_t*>(scratch);
  uint8_t* exits = flags + static_cast<size_t>(batch) * kD;
  const dim3 grid(kD / kRows, batch);
  lq_a<<<grid, kRows, 0, s>>>(I, R, X, O, flags, r3_len);
  lq_maps<<<grid, kRows, 0, s>>>(I, R, X, O, flags, exits, r3_len, gt_low10);
  lq_emit<<<grid, kRows, 0, s>>>(I, R, X, O, flags, exits, r3_len, gt_low10);
  return cudaGetLastError();
}

}  // extern "C"
