// K5 nhw_requant_tail: the encoder's requant feedback tail, hand-written
// for Hopper (sm_90a).  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrapper and torch twin in
// nhwcodec_tpu_torch/ops/dwt.py (requant_tail, requant_tail_ref).
//
// Replaces nhwcodec_tpu/ops/pallas_dwt.py requant_tail_pallas
// (_requant_tail_kernel): on jpeg, process (B, 512, 512) int16 and res256
// (B, 256, 256) int16 with its 16000/12000 sentinels, the host sequence
// wavelet_synthesis(256) -> unmark_res256 -> requant_scan_ladder ->
// wavelet_analysis(256, last) (encoder/nhw_encoder.c:183-279).
//
// Bound.  The three stages touch the 256x256 LL quadrant only (8 MiB at
// batch 16 across all passes); the ladder is a 256-step dependent chain
// per LL row, so latency, not bandwidth or arithmetic, bounds it.
//
// Design.  Only the LL quadrants of jpeg and process change; outside them
// the tail reads just process[r, 256] and the row-end band cells
// process[r-1, 511].  So the kernel updates the caller's two 512 planes
// in place (callers that need the inputs again pass clones) and moves no
// other byte.  Stages, all on the caller's stream:
//   1. level-2 synthesis of the jpeg LL: K1 (nhw_synth_level, dwt.cu) on
//      the 512-stride corner view, into scratch;
//   2. unmark + ladder in one launch, one thread per (image, LL row): the
//      ladder's left term reads the previous column's updated value, but
//      at column 0 the C pointer reads the previous row's band cell,
//      which the ladder never writes, so each row is an independent
//      left-to-right chain of 256 steps and the walk gives the exact
//      sequential result with no fixpoint iteration (the TPU kernel's
//      while_loop).  A block owns 32 rows: its 256 threads stage the
//      rows' unmarked LL and sentinel-free res256 in shared memory with
//      coalesced loads (the row pitch of 258 int16 keeps the walkers'
//      column reads on distinct banks), one warp walks, and all threads
//      store the new jpeg LL rows and res_clean;
//   3. the re-analysis: K4's cluster launch (nhw_analysis_level_jp,
//      analysis.cu) from scratch into the jpeg and process LL corners
//      through their 512 row stride.
// The TPU kernel's dead ll_f (the post-ladder process LL, overwritten by
// the re-analysis) is not computed.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lifting.cuh"

extern "C" int nhw_synth_level(const void* x, int plane_stride, int row_stride,
                               void* scratch, void* out, int batch, int n,
                               void* stream);
extern "C" int nhw_analysis_level_jp(const void* x, int x_plane, int x_row,
                                     void* j, int j_plane, int j_row, void* p,
                                     int p_plane, int p_row, int batch, int n,
                                     void* stream);

namespace {

constexpr int kN = 512;         // Y plane side
constexpr int kD = 256;         // LL quadrant side
constexpr int kRows = 32;       // LL rows per block, one walker each
constexpr int kLd = kD + 2;     // shared row pitch (int16)
constexpr int kThreads = 256;

__device__ __forceinline__ int clean(int v) {
  return v > 14000 ? v - 16000 : (v > 10000 ? v - 12000 : v);
}

__device__ __forceinline__ int mark_delta(int v) {
  return v > 14000 ? 1 : (v > 10000 ? -1 : 0);
}

// The unmark nudge at LL position (R, C): regions (r<128, c>=128),
// (r>=128, c<128) and (r>=128, c>=128) of res256 map to the interleaved
// targets (2(c-128)+1, 2r), (2c, 2(r-128)+1) and (2(c-128)+1, 2(r-128)+1).
__device__ __forceinline__ int unmark_delta(const int16_t* res, int R, int C) {
  if (!((R | C) & 1)) return 0;
  const int row = (C & 1) ? 128 + (C >> 1) : (C >> 1);
  const int col = (R & 1) ? 128 + (R >> 1) : (R >> 1);
  return mark_delta(res[row * kD + col]);
}

// The |a| > 4 pre-shrink of the right-neighbour delta
// (encoder/nhw_encoder.c:232-246).
__device__ __forceinline__ int adjust_a(int a) {
  if (a > 4) return a + (a > 11 ? -7 : a > 7 ? -4 : a > 5 ? -2 : -1);
  if (a < -4) return a + (a < -11 ? 7 : a < -7 ? 4 : a < -5 ? 2 : 1);
  return a;
}

// The +-7/4/2/1 nudge for scan = pf[e] - r256 and the adjusted,
// left-augmented neighbour term aa (encoder/nhw_encoder.c:218-279).
__device__ __forceinline__ int ladder_decide(int scan, int aa) {
  if (scan > 11) return -7;
  if (scan > 7) return -4;
  if (scan > 5) return -2;
  if (scan > 4) return -1;
  if (scan < -11) return 7;
  if (scan < -7) return 4;
  if (scan < -5) return 2;
  if (scan < -4) return 1;
  if (scan >= -1 && scan <= 1) return 0;
  if (scan >= 4 && aa >= 1) return -1;
  if (scan <= -4 && aa <= -1) return 1;
  if (scan == 3 && aa >= 0) return -1;
  if (scan == -3 && aa <= 0) return 1;
  if (aa > -3 && aa < 3) return 0;
  if (scan > 0 && aa > 0) return -1;
  if (scan < 0 && aa < 0) return 1;
  if (aa >= 5) return -2;
  if (aa <= -5) return 2;
  if (aa >= 4) return -1;
  if (aa <= -4) return 1;
  return 0;
}

// Stage 2.  syn: (B,256,256) synthesized LL; res256: (B,256,256) with
// sentinels; process: (B,512,512) (band cells read only); res_clean:
// (B,256,256) out; jll: (B,256,256) out, the new jpeg LL before the
// re-analysis.  grid (256 / kRows, B), block kThreads.
__global__ void __launch_bounds__(kThreads)
    unmark_ladder(const int16_t* __restrict__ syn,
                  const int16_t* __restrict__ res256,
                  const int16_t* __restrict__ process,
                  int16_t* __restrict__ res_clean, int16_t* __restrict__ jll) {
  __shared__ int16_t ll_s[kRows][kLd];
  __shared__ int16_t rc_s[kRows][kLd];
  const int r0 = blockIdx.x * kRows;
  const size_t b = blockIdx.y;
  const int16_t* S = syn + b * kD * kD;
  const int16_t* res = res256 + b * kD * kD;
  const int16_t* P = process + b * kN * kN;
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int rr = i / kD;
    const int c = i % kD;
    const int R = r0 + rr;
    ll_s[rr][c] = static_cast<int16_t>(
        nhw::wrap16(S[R * kD + c] + unmark_delta(res, R, c)));
    rc_s[rr][c] = static_cast<int16_t>(clean(res[R * kD + c]));
  }
  __syncthreads();
  if (threadIdx.x < kRows) {
    const int rr = threadIdx.x;
    const int R = r0 + rr;
    int16_t* ll = ll_s[rr];
    const int16_t* rc = rc_s[rr];
    // column 0 reads the previous row's band cell; (0, 0) reads nothing
    int left = R == 0 ? 0
                      : P[(R - 1) * kN + kN - 1] - clean(res[(R - 1) * kD + kD - 1]);
    const int band = P[R * kN + kD];
    const int next0 = R < kD - 1 ? clean(res[(R + 1) * kD]) : 0;
    int cur = ll[0];
    for (int c = 0; c < kD; ++c) {
      const int r = rc[c];
      const int right = c < kD - 1 ? ll[c + 1] : band;
      const int r_next = c < kD - 1 ? rc[c + 1] : next0;
      const int m = ladder_decide(cur - r, adjust_a(right - r_next) + left);
      ll[c] = static_cast<int16_t>(nhw::wrap16(r + m));
      left = cur + m - r;
      cur = right;
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < kRows * kD; i += kThreads) {
    const int rr = i / kD;
    const int c = i % kD;
    const size_t o = b * kD * kD + static_cast<size_t>(r0 + rr) * kD + c;
    jll[o] = ll_s[rr][c];
    res_clean[o] = rc_s[rr][c];
  }
}

}  // namespace

extern "C" {

// K5.  jpeg, process: (B, 512, 512) int16, updated in place (LL quadrant);
// res256: (B, 256, 256) int16; res_clean: (B, 256, 256) int16 out;
// scratch: 3 x (B, 256, 256) int16.
int nhw_requant_tail(void* jpeg, void* process, const void* res256,
                     void* res_clean, void* scratch, int batch, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t ll = static_cast<size_t>(batch) * kD * kD;
  auto* s_synth = static_cast<int16_t*>(scratch);
  int16_t* syn = s_synth + ll;
  int16_t* jll = syn + ll;
  int e = nhw_synth_level(jpeg, kN * kN, kN, s_synth, syn, batch, kD, stream);
  if (e != 0) return e;
  unmark_ladder<<<dim3(kD / kRows, batch), kThreads, 0, s>>>(
      syn, static_cast<const int16_t*>(res256),
      static_cast<const int16_t*>(process), static_cast<int16_t*>(res_clean),
      jll);
  e = cudaGetLastError();
  if (e != 0) return e;
  return nhw_analysis_level_jp(jll, kD * kD, kD, jpeg, kN * kN, kN, process,
                               kN * kN, kN, batch, kD, stream);
}

}  // extern "C"
