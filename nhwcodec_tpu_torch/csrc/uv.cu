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
// row's window by one.  Within a row every read is an initial value but one:
// lane 127's d1 reads plane column 128, which is band 0's slot of lane 0 of
// the same row.  Which lanes the walk visits is the run parity of the
// placed pairs (a placed pair skips the next lane).
//
// The bound is bytes: the plane read once and written once, rf_ext read
// once, some 40 operations a lane.  The design is the simple exact one, not
// yet tuned: one CTA an image, a thread a lane, the 128 rows in order with
// the row's window start (count_start) in a register.  Each row: every
// lane decides on its own reads; the visited lanes are the run parity of
// the placed pairs (block_scan.cuh's run_parity_block, as S2's pair rule
// and S7's 2a fires); lane 0 hands its band 0 value through shared memory and
// lane 127 decides again against it after a barrier; lane 127's placed
// pair is the drift every thread adds to count_start.  Each lane writes its
// three band slots (the written value or the initial one) and the CTA
// copies the LL quadrant, so the output is whole.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

using nhw::iabs;
using nhw::run_parity_block;

constexpr int kD = 256;
constexpr int kPlane = kD * kD;
constexpr int kLanes = 128;           // a row's positions; the CTA's threads
constexpr int kHalf = kPlane / 2;     // bands 1 and 2 start here
constexpr int kRfMin = 16384 + 130 + 127;  // res256, a row's 130 reads, drift

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// One lane's decision (encoder/nhw_encoder.c:2372-2424): d0, d1 its two
// differences, b0..b2 the initial values of its band slots.
struct Decision {
  bool pos;       // a 12400 pair, else 12600
  bool placed;    // a pair that finds a free slot: the walk skips a lane
  int code;       // the single sentinel, 0 for none
  int slot;       // the first free slot, -1 for none
};

__device__ __forceinline__ Decision decide(int d0, int d1, int b0, int b1,
                                           int b2, int res_uv) {
  Decision d;
  d.pos = d0 > 3 && d0 < 7 && d1 > 2 && d1 < 7;
  const bool neg = d0 > -7 && d0 < -3 && d1 > -8 && d1 < -2;
  d.slot = iabs(b0) < 8 ? 0 : iabs(b1) < 8 ? 1 : iabs(b2) < 8 ? 2 : -1;
  d.placed = (d.pos || neg) && d.slot >= 0;
  d.code = iabs(d0) <= res_uv           ? 0
           : d0 > 0                     ? 12900
           : (d0 == -5 && d1 >= 0)      ? 0
                                        : 13000;
  return d;
}

// The lane's band values w0..w2 after its turn (they hold the initial
// values on entry); returns whether it placed a pair.
__device__ __forceinline__ bool apply(bool visited, const Decision& d,
                                      int& w0, int& w1, int& w2) {
  const int code = d.placed ? (d.pos ? 12400 : 12600) : d.code;
  if (visited && code) {
    w0 = d.slot == 0 ? code : w0;
    w1 = d.slot == 1 ? code : w1;
    w2 = d.slot == 2 ? code : w2;
  }
  return visited && d.placed;
}

__global__ void __launch_bounds__(kLanes)
    uv_sentinel(const int16_t* __restrict__ process,
                const int16_t* __restrict__ rf_ext, int16_t* __restrict__ out,
                int rf_len, int res_uv) {
  __shared__ int warp_last[kLanes / 32];
  __shared__ uint8_t fire_s[kLanes + 1];   // fire_s[j + 1]: lane j fired
  __shared__ int w0_lane0;
  __shared__ int drift;
  const int j = threadIdx.x;
  const int16_t* p = process + static_cast<size_t>(blockIdx.x) * kPlane;
  const int16_t* rf = rf_ext + static_cast<size_t>(blockIdx.x) * rf_len;
  int16_t* o = out + static_cast<size_t>(blockIdx.x) * kPlane;

  for (int r = 0; r < kLanes; ++r) o[r * kD + j] = p[r * kD + j];
  if (j == 0) fire_s[0] = 0;

  int count_start = 0;
  for (int r = 0; r < kLanes; ++r) {
    const int row = r * kD;
    const int b0 = p[row + kLanes + j], b1 = p[kHalf + row + j],
              b2 = p[kHalf + row + kLanes + j];
    const int x0 = p[row + j];
    const int r0 = rf[count_start + j], r1 = rf[count_start + j + 1];
    // lane 127 reads column 128: lane 0's band 0 slot, before lane 0's turn
    Decision d = decide(x0 - r0, p[row + j + 1] - r1, b0, b1, b2, res_uv);
    fire_s[j + 1] = run_parity_block(d.placed, warp_last);
    __syncthreads();
    const bool visited = !fire_s[j];
    int w0 = b0, w1 = b1, w2 = b2;
    apply(visited, d, w0, w1, w2);
    if (j == 0) w0_lane0 = w0;
    __syncthreads();
    if (j == kLanes - 1) {
      // decided again against the value lane 0 left in column 128
      d = decide(x0 - r0, w0_lane0 - r1, b0, b1, b2, res_uv);
      w0 = b0;
      w1 = b1;
      w2 = b2;
      drift = apply(visited, d, w0, w1, w2);
    }
    o[row + kLanes + j] = static_cast<int16_t>(w0);
    o[kHalf + row + j] = static_cast<int16_t>(w1);
    o[kHalf + row + kLanes + j] = static_cast<int16_t>(w2);
    __syncthreads();
    count_start += kLanes + drift;
  }
}

}  // namespace

extern "C" {

// S9.  process, out: (B, 256, 256) int16; rf_ext: (B, rf_len) int16,
// rf_len >= 16384 + 130 + 127 (res256, then the tail the drift reads).
int nhw_uv_sentinel(const void* process, const void* rf_ext, void* out,
                    int batch, int rf_len, int res_uv, void* stream) {
  if (batch < 1 || batch > 65535 || rf_len < kRfMin)
    return cudaErrorInvalidValue;
  if (misaligned(process, 2) || misaligned(rf_ext, 2) || misaligned(out, 2))
    return cudaErrorMisalignedAddress;
  uv_sentinel<<<batch, kLanes, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(process),
      static_cast<const int16_t*>(rf_ext), static_cast<int16_t*>(out),
      rf_len, res_uv);
  return cudaGetLastError();
}

}  // extern "C"
