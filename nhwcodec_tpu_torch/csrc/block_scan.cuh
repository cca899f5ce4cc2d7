// Helpers shared by the encode scans' kernels (scans.cu, ll2.cu, uv.cu,
// lowq.cu, vlq.cu): the run parity of a warp's row (ll2.cu, uv.cu), rows
// staged for CTAs whose threads walk a row each, and maps of 5 states and
// their warp scan (scans.cu, lowq.cu).
#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace nhw {

__device__ __forceinline__ int iabs(int x) { return x < 0 ? -x : x; }

// fired = f and an even offset within f's run, over a warp's row of 128
// positions, 4 a lane (bit i: position 4 lane + i): the greedy rule that
// fires and skips the next position, over a static predicate.  Within the
// lane, a run starting at an even bit fires its even bits and one starting
// at an odd bit its odd bits (adding its start bit clears a run); the state
// before the lane's bit 0 is the last bit fired by the nearest lane below
// that holds a non-candidate (a lane of 4 candidates passes it through),
// and where it fired, the lane's leading run flips.  Every lane of the warp
// calls it.
__device__ __forceinline__ unsigned run_parity_lanes4(unsigned f, int lane) {
  const unsigned starts = f & ~(f << 1);
  const unsigned even = f & ~(f + (starts & 0x5u));
  const unsigned fired = (even & 0x5u) | (f & ~even & 0xAu);
  const unsigned gaps = __ballot_sync(0xFFFFFFFFu, f != 0xFu);
  const unsigned last = __ballot_sync(0xFFFFFFFFu, (fired >> 3) & 1u);
  const unsigned below = gaps & ((1u << lane) - 1u);
  const unsigned e = below ? (last >> (31 - __clz(below))) & 1u : 0u;
  return fired ^ (f & ~(f + 1u) & (0u - e));
}

// Rows of a (512, 512) int16 plane staged in shared memory for kernels
// whose threads walk a row each: a staged row holds the plane row at
// [0, 512), the flat previous value (the previous row's last, 0 before the
// plane) at -1 and the flat next values (the next row's first, 0 past the
// plane) from 512 on.  kStagePitch int16 a row is 259 words, odd, so the
// threads of a warp, a row each, read one column on 32 banks.
constexpr int kStageCols = 512;
constexpr int kStageAfter = 3;
constexpr int kStagePitch = 518;

// Stage rows [r0, r0 + rows) of plane (16-byte aligned) into s, row k at s
// + k * kStagePitch + 1: each warp loads whole rows, 16 bytes a lane.  All
// threads of the CTA call it; the caller synchronises before reading.
__device__ __forceinline__ void stage_rows(const int16_t* __restrict__ plane,
                                           int r0, int rows, int16_t* s) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < rows; k += nw) {
    const int r = r0 + k;
    const int16_t* src = plane + r * kStageCols;
    int16_t* dst = s + k * kStagePitch + 1;
#pragma unroll
    for (int h = 0; h < kStageCols; h += 256) {
      const int c = h + lane * 8;
      const int4 v = *reinterpret_cast<const int4*>(src + c);
      const int16_t* e = reinterpret_cast<const int16_t*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) dst[c + i] = e[i];
    }
    if (lane == 0) dst[-1] = r > 0 ? src[-1] : 0;
    if (lane < kStageAfter)
      dst[kStageCols + lane] = r + 1 < kStageCols ? src[kStageCols + lane] : 0;
  }
}

// Write staged rows [0, rows) back to plane rows [r0, r0 + rows) (16-byte
// aligned), each warp whole rows.
__device__ __forceinline__ void unstage_rows(const int16_t* s, int rows,
                                             int16_t* __restrict__ plane,
                                             int r0) {
  const int lane = threadIdx.x & 31, nw = blockDim.x >> 5;
  for (int k = threadIdx.x >> 5; k < rows; k += nw) {
    const int16_t* src = s + k * kStagePitch + 1;
    int16_t* dst = plane + (r0 + k) * kStageCols;
#pragma unroll
    for (int h = 0; h < kStageCols; h += 256) {
      const int c = h + lane * 8;
      int4 v;
      int16_t* e = reinterpret_cast<int16_t*>(&v);
#pragma unroll
      for (int i = 0; i < 8; ++i) e[i] = src[c + i];
      *reinterpret_cast<int4*>(dst + c) = v;
    }
  }
}

// Maps of 5 states, 3 bits a state in 15 bits (state s goes to bits 3 s..3 s
// + 2), for walks whose carry is one of 5 states (scans.cu: S3's skips
// left; lowq.cu: S11's carry between visits).
constexpr uint32_t kMap5Ident = 0x4688u;

__device__ __forceinline__ int map5_at(uint32_t f, int s) {
  return (f >> (3 * s)) & 7;
}

// The map of f, then g.
__device__ __forceinline__ uint32_t map5_then(uint32_t f, uint32_t g) {
  uint32_t r = 0;
#pragma unroll
  for (int s = 0; s < 5; ++s)
    r |= uint32_t(map5_at(g, map5_at(f, s))) << (3 * s);
  return r;
}

// The inclusive scan of a warp's maps in lane order, in place, and the
// lane's exclusive prefix (the identity at lane 0).  Every lane calls it.
__device__ __forceinline__ uint32_t map5_warp_scan(uint32_t& m, int lane) {
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const uint32_t b = __shfl_up_sync(0xFFFFFFFFu, m, d);
    if (lane >= d) m = map5_then(b, m);
  }
  const uint32_t e = __shfl_up_sync(0xFFFFFFFFu, m, 1);
  return lane == 0 ? kMap5Ident : e;
}

}  // namespace nhw
