// Hand-written Hopper (sm_90a) kernels of the device encode scans' programs
// below LOW7.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (low_q_ll1_cleanup_device /
// _ref, very_low_q_cleanup_device / _ref, uv_ll_smooth_device / _ref).
//
// S12 nhw_very_low_q_cleanup replaces
//    nhwcodec_tpu/models/device_scans.py:2479 very_low_q_cleanup_device
//    (pass 1 as 128 row scans of 124 steps, passes 2 and 3 as 126-row
//    scans of 126-step column scans): passes 1-3 of the q < LOW7 LL2
//    window smoothing, in place on the LL2 quadrant of a (B, 512, 512)
//    int16 plane, and the fire masks the far zeroings take (torch ops
//    in the wrapper, with pass 4).  One launch, one CTA an image.
// S13 nhw_low_q_ll1_cleanup replaces
//    nhwcodec_tpu/models/device_scans.py:2101 low_q_ll1_cleanup_device
//    (a Jacobi while_loop over rows 128..255): the q <= LOW9
//    isolated-coefficient zeroing.  One launch, a thread a row.
// S14 nhw_uv_ll_smooth replaces
//    nhwcodec_tpu/models/device_scans.py:2353 uv_ll_smooth_device (two
//    62-row scans of 62-step column scans): the q <= LOW9 smoothing of
//    the chroma LL2 block, in place on (B, 256, 256) int16 planes.  One
//    launch, one CTA a plane.
//
// S13's rows are independent: a visit reads its left neighbour as the walk
// left it (column 0 the previous row's column 511, which no visit writes)
// and its right neighbour as it was (column 255 reads column 256).  So each
// thread walks one row of 256 visits, the rows staged in shared memory (32
// a CTA, block_scan.cuh's stage_rows) and written back whole.
//
// S12's pass 1 writes only within its row (a window's write at j + 2 is
// read by the next two windows): a thread a row, 124 steps.  Passes 2 and
// 3 and S14's two passes share one recurrence: visit (r, j) reads rows r,
// r + 1 and r + 2 at columns j..j + 2 and writes (r + 1, j + 1), so it
// needs visits (r, j - 1) and (r - 1, j + 1) done and nothing later.  Row
// r's visit j runs at step 2r + j (wave_pass): 376 steps for S12's 126 x
// 126 visits, 184 for S14's 62 x 62, a barrier a step, and within a step
// no visit reads what another writes.  The quadrant sits in shared memory
// at kVlqPitch int16 a row (66 words: a step's visits, two columns apart a
// row, read 32 banks; pass 1's row-per-thread reads hit two threads a
// bank), S14's block at kUvsPitch (34 words).
//
// S12's far zeroings land in the level-1 bands, which no pass reads, and
// zero only: they apply once after the passes.  The kernel emits, per image,
// (4, 128, 128) bool masks in the visit frame: pass 1's fires (c1 or c2),
// pass 2's and pass 3's fires (the inner test, whether or not the value is
// written), pass 3's hits (the outer test).  The one far target a pass
// reads is (0, 127): pass 3's hits before its first fire zero the level-2
// bands around the carry passes 1-2 left, which is 0 when neither fired,
// and 0 + 128 - 1 is (0, 127) (at q <= LOW9, |v| < 11).  Pass 3's visit
// (0, 125) and pass 4 read it; row 0's visits come first in raster order,
// so the thread of row 0 zeroes it at its first stale hit, as the C does.
//
// The bound is bytes (S12: the quadrant read and written, the masks
// written; S13: rows 128..255; S14: the 64 x 64 block); each visit is some
// 20-40 operations.  What limits them is their dependent steps: S12 124 +
// 2 x 376, S13 256, S14 2 x 184, each a barrier or a shared-memory read.

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
constexpr int kMasks = 4;
constexpr int kMaskWords = kVlq / 32;  // bit words a mask row
constexpr int kUvs = 64;               // the chroma LL2 block's side
constexpr int kUvsPitch = 68;
constexpr int kLl1Rows = 32;           // S13: rows a CTA, a thread each
constexpr int kLl1First = 128;         // S13's rows 128..255
constexpr int kLl1Cols = 256;

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// A wave pass's rule: variant 2 tests row r at j + 1 only, variant 3 at j,
// j + 1 and j + 2; x3, x4 its thresholds, rnd the rounding of the mean;
// always: an inner fire writes (S14), else only where the mean lies within
// 5 of a row neighbour (S12).
struct Wave {
  int variant, x3, x4, rnd;
  bool always;
};

// Stage the top-left side x side corner of a row-major plane (row stride
// `stride` int16, 4-byte aligned) at s (pitch int16 a row, even), a word a
// thread a step: the warp reads consecutive words of a row.
__device__ __forceinline__ void stage_corner(const int16_t* plane, int stride,
                                             int side, int pitch, int16_t* s) {
  const int words = side / 2;
  for (int w = threadIdx.x; w < side * words; w += blockDim.x) {
    const int r = w / words, c = w % words;
    reinterpret_cast<uint32_t*>(s + r * pitch)[c] =
        reinterpret_cast<const uint32_t*>(plane + r * stride)[c];
  }
}

__device__ __forceinline__ void unstage_corner(const int16_t* s, int side,
                                               int pitch, int16_t* plane,
                                               int stride) {
  const int words = side / 2;
  for (int w = threadIdx.x; w < side * words; w += blockDim.x) {
    const int r = w / words, c = w % words;
    reinterpret_cast<uint32_t*>(plane + r * stride)[c] =
        reinterpret_cast<const uint32_t*>(s + r * pitch)[c];
  }
}

// Collect a row's visit bits a word at a time: bit j of word j / 32.
struct BitRow {
  uint32_t* row;   // kMaskWords words in shared memory, or null
  uint32_t w = 0;
  __device__ __forceinline__ void put(int j, bool b, int last) {
    if (!row) return;
    w |= static_cast<uint32_t>(b) << (j & 31);
    if ((j & 31) == 31 || j == last) {
      row[j >> 5] = w;
      w = 0;
    }
  }
};

// One wave pass over the m x m visits of the corner staged at s (pitch
// int16 a row), every thread of the CTA taking part (row r = threadIdx.x,
// r < m).  fire, hit: the rows' bit words of the inner and outer tests
// (kMaskWords a row), or null.  stale0: pass 3's stale carry is 0 (S12 at
// q <= LOW9 with no pass-1 or pass-2 fire): row 0's hits before its first
// fire zero (0, 127) below 11.
template <int kPitch>
__device__ void wave_pass(int16_t* s, int m, const Wave& w, uint32_t* fire,
                          uint32_t* hit, bool stale0) {
  const int r = threadIdx.x;
  BitRow fr{fire ? fire + r * kMaskWords : nullptr};
  BitRow hr{hit ? hit + r * kMaskWords : nullptr};
  bool fired0 = false;
  for (int step = 0; step < 3 * m - 2; ++step) {
    const int j = step - 2 * r;
    if (r < m && j >= 0 && j < m) {
      const int16_t* p0 = s + r * kPitch + j;
      int16_t* p1 = s + (r + 1) * kPitch + j;
      const int r0 = p0[0], r0s = p0[1], r0s2 = p0[2];
      const int a0 = p1[0], r1i1 = p1[1], r1i2 = p1[2];
      const int r2s = p0[2 * kPitch + 1];
      bool outer, inner;
      if (w.variant == 2) {
        outer = iabs(r0s - r2s) < w.x3 && iabs(a0 - r1i2) < w.x3;
        inner = outer && iabs(r1i1 - a0) < w.x4 - 1 &&
                iabs(r0s - r1i1) < w.x4;
      } else {
        outer = iabs(r0s2 - r0s) < w.x3 && iabs(r0s - r0) < w.x3 &&
                iabs(r0 - a0) < w.x3 && iabs(r0s2 - r1i2) < w.x3;
        inner = outer && iabs(r2s - a0) < w.x3 && iabs(a0 - r1i1) < w.x4;
      }
      const int e = (r0s + r2s + a0 + r1i2 + w.rnd) >> 2;
      if (inner && (w.always || iabs(e - a0) < 5 || iabs(e - r1i2) < 5))
        p1[1] = static_cast<int16_t>(e);
      if (stale0 && r == 0 && outer && !inner && !fired0 &&
          iabs(s[kVlq - 1]) < 11)
        s[kVlq - 1] = 0;
      fired0 |= inner;
      fr.put(j, inner, m - 1);
      hr.put(j, outer, m - 1);
    }
    __syncthreads();
  }
}

// S12's pass 1 on staged row `row`: 124 windows of 5, a write at j + 2;
// returns whether any window fired, its fires into bits.
__device__ __forceinline__ bool vlq_pass1(int16_t* row, int x1, int x2,
                                          BitRow bits) {
  bool any = false;
  for (int j = 0; j < kVlqP1; ++j) {
    const int p0 = row[j], p1 = row[j + 1], p2 = row[j + 2];
    const int p3 = row[j + 3], p4 = row[j + 4];
    bool fire = false;
    if (iabs(p4 - p0) < x1 && iabs(p4 - p3) < x1 && iabs(p1 - p0) < x1 &&
        iabs(p3 - p1) < x1 && iabs(p3 - p2) < x2 - 2) {
      fire = true;
      int v = (p3 + p1) >> 1;
      if (p3 - p1 > 5 && p2 - p3 >= 0) v = p3;
      else if (p1 - p3 > 5 && p2 - p3 <= 0) v = p3;
      else if (p1 - p3 > 5 && p2 - p1 >= 0) v = p1;
      else if (p3 - p1 > 5 && p2 - p1 <= 0) v = p1;
      else if ((p3 - p2 > 0 && p2 - p1 > 0) || (p1 - p2 > 0 && p2 - p3 > 0))
        v = p2;
      row[j + 2] = static_cast<int16_t>(v);
    } else if (iabs(p4 - p0) < x2 + 1 && iabs(p4 - p3) < x2 + 1 &&
               iabs(p1 - p0) < x2 + 1 && iabs(p3 - p1) < x2 + 6 &&
               iabs(p3 - p2) < x2 + 6 &&
               ((p3 - p2 >= 0 && p2 - p1 >= 0) ||
                (p3 - p2 <= 0 && p2 - p1 <= 0))) {
      fire = true;
    }
    any |= fire;
    bits.put(j, fire, kVlqP1 - 1);
  }
  return any;
}

// S12: one CTA an image, a thread a quadrant row.  plane (B, 512, 512) in
// place; masks (B, 4, 128, 128) bytes, 0 or 1.
__global__ void __launch_bounds__(kVlq)
    vlq_passes(int16_t* __restrict__ plane, uint8_t* __restrict__ masks,
               int low9, int x1, int x2, int x3, int x4) {
  __shared__ __align__(16) int16_t s[kVlq * kVlqPitch];
  __shared__ uint32_t bits[kMasks * kVlq * kMaskWords];
  int16_t* P = plane + static_cast<size_t>(blockIdx.x) * kPlane;
  const int r = threadIdx.x;
  for (int i = r; i < kMasks * kVlq * kMaskWords; i += kVlq) bits[i] = 0;
  stage_corner(P, kN, kVlq, kVlqPitch, s);
  __syncthreads();
  const bool p1 = vlq_pass1(s + r * kVlqPitch, x1, x2,
                            BitRow{bits + r * kMaskWords});
  const bool any1 = __syncthreads_or(p1);
  uint32_t* f2 = bits + kVlq * kMaskWords;
  wave_pass<kVlqPitch>(s, kVlqWave, Wave{2, x3, x4, 2, false}, f2, nullptr,
                       false);
  bool p2 = false;
  for (int k = 0; k < kMaskWords; ++k) p2 |= f2[r * kMaskWords + k] != 0;
  const bool any2 = __syncthreads_or(p2);
  wave_pass<kVlqPitch>(s, kVlqWave, Wave{3, x3, x4, 1, false},
                       bits + 2 * kVlq * kMaskWords,
                       bits + 3 * kVlq * kMaskWords,
                       low9 && !any1 && !any2);
  unstage_corner(s, kVlq, kVlqPitch, P, kN);
  // each word of masks: four positions of one mask row
  uint32_t* M = reinterpret_cast<uint32_t*>(
      masks + static_cast<size_t>(blockIdx.x) * kMasks * kVlq * kVlq);
  for (int w = r; w < kMasks * kVlq * kVlq / 4; w += kVlq) {
    const int row = w >> 5, col = (w & 31) * 4;   // row: mask * 128 + r
    const uint32_t b = bits[row * kMaskWords + (col >> 5)] >> (col & 31);
    M[w] = (b & 1u) | ((b >> 1) & 1u) << 8 | ((b >> 2) & 1u) << 16 |
           ((b >> 3) & 1u) << 24;
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

// S14: one CTA a plane, a thread a block row; both passes in place.
__global__ void __launch_bounds__(kUvs) uv_smooth(int16_t* __restrict__ uv) {
  __shared__ __align__(16) int16_t s[kUvs * kUvsPitch];
  int16_t* P = uv + static_cast<size_t>(blockIdx.x) * kUvPlane;
  stage_corner(P, kD, kUvs, kUvsPitch, s);
  __syncthreads();
  wave_pass<kUvsPitch>(s, kUvs - 2, Wave{2, 5, 8, 2, true}, nullptr, nullptr,
                       false);
  wave_pass<kUvsPitch>(s, kUvs - 2, Wave{3, 5, 8, 1, true}, nullptr, nullptr,
                       false);
  unstage_corner(s, kUvs, kUvsPitch, P, kD);
}

}  // namespace

extern "C" {

// S12.  plane: (B, 512, 512) int16, 4-byte aligned, its LL2 quadrant
// rewritten in place by passes 1-3; masks: (B, 4, 128, 128) bytes (pass 1's
// fires, pass 2's, pass 3's, pass 3's hits), 4-byte aligned; low9: q <=
// LOW9; x1..x4: the first four of _VLQ_THRX.
int nhw_very_low_q_cleanup(void* plane, void* masks, int batch, int low9,
                           int x1, int x2, int x3, int x4, void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  if (misaligned(plane, 4) || misaligned(masks, 4))
    return cudaErrorMisalignedAddress;
  vlq_passes<<<batch, kVlq, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(plane), static_cast<uint8_t*>(masks), low9, x1,
      x2, x3, x4);
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

// S14.  uv: (B, 256, 256) int16, 4-byte aligned, smoothed in place.
int nhw_uv_ll_smooth(void* uv, int batch, void* stream) {
  if (batch < 1) return cudaErrorInvalidValue;
  if (misaligned(uv, 4)) return cudaErrorMisalignedAddress;
  uv_smooth<<<batch, kUvs, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(uv));
  return cudaGetLastError();
}

}  // extern "C"
