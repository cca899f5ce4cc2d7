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
// batch 16 across all passes) at about 110 int32 operations an element;
// the ladder adds a 256-step dependent chain per LL row.
//
// Design.  Only the LL quadrants of jpeg and process change; outside them
// the tail reads just process[r, 256] and the row-end band cells
// process[r-1, 511].  So the kernel updates the caller's two 512 planes
// in place (callers that need the inputs again pass clones) and moves no
// other byte.  Stages, all on the caller's stream:
//   1. level-2 synthesis of the jpeg LL: K1 (nhw_synth_level, dwt.cu, one
//      cluster launch) on the 512-stride corner view, into scratch;
//   2. unmark + ladder in one launch, requant_ladder (below);
//   3. the re-analysis: K4's cluster launch (nhw_analysis_level_jp,
//      analysis.cu) from scratch into the jpeg and process LL corners
//      through their 512 row stride.
// The TPU kernel's dead ll_f (the post-ladder process LL, overwritten by
// the re-analysis) is not computed.
//
// The ladder as a table walk.  At LL column c the C loop nudges by
// m = decide(scan[c], aa[c]) with scan = ll - rc (ll the unmarked LL, rc
// res256 without its sentinels, both before the ladder) and aa[c] =
// A[c] + left[c]: A[c] = adjust_a(ll[c+1] - rc[c+1]) = adjust_a(scan[c+1])
// reads the pre-ladder right neighbour (at c = 255 it crosses to
// process[r, 256] - rc[r+1, 0], 0 past the last row), and left[c+1] =
// scan[c] + m reads the updated left one.  Column 0's left term reads the
// previous row's band cell process[r-1, 511] - rc[r-1, 255], which the
// ladder never writes, so rows are independent chains and one
// left-to-right walk a row gives the sequential result exactly: no
// fixpoint (the TPU kernel's while_loop) is needed.  decide compares aa
// only with thresholds in [-5, 5] and scan only with thresholds in
// [-12, 12], so with the state s = clamp(aa, -5, 5), 11 values,
//   s[c+1] = clamp(A[c+1] + scan[c] + decide(scan[c], s[c]), -5, 5)
// and m = decide(scan[c], s[c]).  Since |decide| <= 7, the next state
// depends on base = A[c+1] + scan[c] only through clamp(base, -12, 12).
// Each column's map from s[c] to s[c+1] is therefore one of 25 x 25
// tables of 11 four-bit entries, a uint64 each (kLut), which each block
// builds from the 25 x 11 table kDecide.
//
// requant_ladder: one block of kThreads (32 warps) per 32 LL rows of one
// image, grid (8, B): 128 blocks, one per SM, at batch 16.  (4096 rows
// over 132 SMs leave some SM 32 walks whatever the grid, so smaller
// blocks would not shorten the walk.)
//   - Pre-pass, all warps, branch-free (selects): warp w takes row
//     32 blockIdx.x + w, lane l its columns 8l..8l+7 with 16-byte loads;
//     the unmarked LL, rc (stored at once as res_clean, 16-byte stores),
//     scan, A from the next lane's scan (__shfl_down_sync), each column's
//     table index (25 clamp(scan) + clamp(base)) into shared memory and
//     the row's initial state.
//   - The walk, warp 0, lane t walking row t: s = (T >> 4 s) & 15 for
//     256 columns, the table words of the next 8 columns loaded while the
//     current 8 are walked; the states go to shared memory, one byte a
//     column.
//   - All warps again: m = kDecide[clamp(scan)][s], jll = wrap16(rc + m),
//     16-byte stores.
// The shared rows keep conflict-free pitches: the walkers' 16-byte index
// loads and 8-byte state stores take the fewest wavefronts their bytes
// allow.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"
#include "lifting.cuh"

extern "C" int nhw_synth_level(const void* x, int plane_stride, int row_stride,
                               void* out, int batch, int n, void* stream);
extern "C" int nhw_analysis_level_jp(const void* x, int x_plane, int x_row,
                                     void* j, int j_plane, int j_row, void* p,
                                     int p_plane, int p_row, int batch, int n,
                                     void* stream);

namespace {

constexpr int kN = 512;         // Y plane side
constexpr int kD = 256;         // LL quadrant side
constexpr int kRows = 32;       // LL rows a block, one walker lane each
constexpr int kThreads = 32 * kRows;   // a warp a row in the parallel passes
constexpr int kCols = kD / 32;  // columns a lane in the parallel passes
constexpr int kAaClamp = 5;     // the state: aa clamped to [-5, 5]
constexpr int kStates = 2 * kAaClamp + 1;
constexpr int kScanClamp = 12;  // scan and base clamped to [-12, 12]
constexpr int kScans = 2 * kScanClamp + 1;
constexpr int kBits = 4;        // bits of one next-state entry
constexpr int kLut = kScans * kScans;
constexpr int kIdxPitch = kD + 8;   // uint16: 16-byte rows
constexpr int kStPitch = kD + 8;    // bytes: 8-byte rows
static_assert(kStates * kBits <= 64 && kStates <= (1 << kBits),
              "a column's next-state table fits one uint64");

// decide(scan, aa) (encoder/nhw_encoder.c:218-279) for scan = -12..12
// (rows) and aa = -5..5 (columns): the +-7/4/2/1 nudge.  Beyond these
// ranges the ladder's thresholds give the same values as at their ends.
__constant__ int8_t kDecide[kScans][kStates] = {
    { 7,  7,  7,  7,  7,  7,  7,  7,  7,  7,  7},  // scan -12
    { 4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4},  // scan -11
    { 4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4},  // scan -10
    { 4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4},  // scan -9
    { 4,  4,  4,  4,  4,  4,  4,  4,  4,  4,  4},  // scan -8
    { 2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2},  // scan -7
    { 2,  2,  2,  2,  2,  2,  2,  2,  2,  2,  2},  // scan -6
    { 1,  1,  1,  1,  1,  1,  1,  1,  1,  1,  1},  // scan -5
    { 1,  1,  1,  1,  1,  0,  0,  0,  0, -1, -2},  // scan -4
    { 1,  1,  1,  1,  1,  1,  0,  0,  0, -1, -2},  // scan -3
    { 1,  1,  1,  0,  0,  0,  0,  0,  0, -1, -2},  // scan -2
    { 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0},  // scan -1
    { 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0},  // scan 0
    { 0,  0,  0,  0,  0,  0,  0,  0,  0,  0,  0},  // scan 1
    { 2,  1,  0,  0,  0,  0,  0,  0, -1, -1, -1},  // scan 2
    { 2,  1,  0,  0,  0, -1, -1, -1, -1, -1, -1},  // scan 3
    { 2,  1,  0,  0,  0,  0, -1, -1, -1, -1, -1},  // scan 4
    {-1, -1, -1, -1, -1, -1, -1, -1, -1, -1, -1},  // scan 5
    {-2, -2, -2, -2, -2, -2, -2, -2, -2, -2, -2},  // scan 6
    {-2, -2, -2, -2, -2, -2, -2, -2, -2, -2, -2},  // scan 7
    {-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4},  // scan 8
    {-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4},  // scan 9
    {-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4},  // scan 10
    {-4, -4, -4, -4, -4, -4, -4, -4, -4, -4, -4},  // scan 11
    {-7, -7, -7, -7, -7, -7, -7, -7, -7, -7, -7},  // scan 12
};

__device__ __forceinline__ int clamp_to(int v, int lim) {
  return v < -lim ? -lim : (v > lim ? lim : v);
}

__device__ __forceinline__ int clean(int v) {
  return v > 14000 ? v - 16000 : (v > 10000 ? v - 12000 : v);
}

// The unmark nudge at LL position (R, C): regions (r<128, c>=128),
// (r>=128, c<128) and (r>=128, c>=128) of res256 map to the interleaved
// targets (2(c-128)+1, 2r), (2c, 2(r-128)+1) and (2(c-128)+1, 2(r-128)+1);
// (even, even) positions get none.
__device__ __forceinline__ int unmark_delta(const int16_t* res, int R, int C) {
  const int row = (C & 1) ? 128 + (C >> 1) : (C >> 1);
  const int col = (R & 1) ? 128 + (R >> 1) : (R >> 1);
  const int v = ((R | C) & 1) ? __ldg(res + row * kD + col) : 0;
  return v > 14000 ? 1 : (v > 10000 ? -1 : 0);
}

// The |a| > 4 pre-shrink of the right-neighbour delta
// (encoder/nhw_encoder.c:232-246), as selects.
__device__ __forceinline__ int adjust_a(int a) {
  return a + (a > 11 ? -7 : a > 7 ? -4 : a > 5 ? -2 : a > 4 ? -1
              : a < -11 ? 7 : a < -7 ? 4 : a < -5 ? 2 : a < -4 ? 1 : 0);
}

__device__ __forceinline__ int lo16(uint32_t w) {
  return static_cast<int16_t>(w & 0xffffu);
}
__device__ __forceinline__ int hi16(uint32_t w) {
  return static_cast<int16_t>(w >> 16);
}

// Stage 2.  syn: (B,256,256) synthesized LL; res256: (B,256,256) with
// sentinels; process: (B,512,512) (band cells read only); res_clean:
// (B,256,256) out; jll: (B,256,256) out, the new jpeg LL before the
// re-analysis.  grid (256 / kRows, B), block kThreads.
__global__ void __launch_bounds__(kThreads, 1)
    requant_ladder(const int16_t* __restrict__ syn,
                   const int16_t* __restrict__ res256,
                   const int16_t* __restrict__ process,
                   int16_t* __restrict__ res_clean, int16_t* __restrict__ jll) {
  __shared__ uint64_t lut[kLut];
  __shared__ __align__(16) uint16_t idx_s[kRows][kIdxPitch];
  __shared__ __align__(16) uint8_t st_s[kRows][kStPitch];
  __shared__ int8_t dec_s[kScans * kStates];
  __shared__ uint8_t s0_s[kRows];
  const int tid = threadIdx.x;
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const size_t b = blockIdx.y;
  const int R = blockIdx.x * kRows + warp;
  const int16_t* res = res256 + b * kD * kD;
  const int16_t* P = process + b * kN * kN;
  const size_t row_at = (b * kD + R) * kD;

  // the next-state tables: entry s of kLut[25 sc + bc] is
  // clamp(bc - 12 + kDecide[sc][s], -5, 5) + 5
  for (int i = tid; i < kLut; i += kThreads) {
    const int sc = i / kScans;
    const int base = i % kScans - kScanClamp;
    uint64_t word = 0;
#pragma unroll
    for (int s = 0; s < kStates; ++s)
      word |= static_cast<uint64_t>(
                  clamp_to(base + kDecide[sc][s], kAaClamp) + kAaClamp)
              << (kBits * s);
    lut[i] = word;
  }
  if (tid < kScans * kStates) dec_s[tid] = (&kDecide[0][0])[tid];

  // 1. the pre-pass: warp w on row R, lane l on columns 8l..8l+7
  const uint4 sv = __ldg(reinterpret_cast<const uint4*>(syn + row_at) + lane);
  const uint4 rv = __ldg(reinterpret_cast<const uint4*>(res + R * kD) + lane);
  const uint32_t sw[4] = {sv.x, sv.y, sv.z, sv.w};
  const uint32_t rw[4] = {rv.x, rv.y, rv.z, rv.w};
  int scan[kCols];
  uint32_t rcw[kCols / 2];   // rc, two columns a word, kept for stage 3
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int C = kCols * lane + i;
    const uint32_t s2 = sw[i >> 1], r2 = rw[i >> 1];
    const int rc = clean((i & 1) ? hi16(r2) : lo16(r2));
    const int ll = nhw::wrap16(((i & 1) ? hi16(s2) : lo16(s2)) +
                               unmark_delta(res, R, C));
    scan[i] = ll - rc;
    rcw[i >> 1] = (i & 1) ? rcw[i >> 1] | (static_cast<uint32_t>(rc) << 16)
                          : static_cast<uint32_t>(rc) & 0xffffu;
  }
  reinterpret_cast<uint4*>(res_clean + row_at)[lane] =
      make_uint4(rcw[0], rcw[1], rcw[2], rcw[3]);
  // scan of columns 8l + 8 and 8l + 9, from the next lane; lane 31's
  // column 254 takes A[255] = adjust_a(process[R, 256] - rc[R+1, 0])
  const int next0 = __shfl_down_sync(0xffffffffu, scan[0], 1);
  const int next1 = __shfl_down_sync(0xffffffffu, scan[1], 1);
  const bool last = lane == 31;
  const int cross = last ? P[R * kN + kD] -
                               (R < kD - 1 ? clean(__ldg(res + (R + 1) * kD)) : 0)
                         : next0;
  uint32_t iw[kCols / 2];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    // A[c+1]; column 255's entry is never read (the walk ends there)
    const int a_next = i < kCols - 2 ? adjust_a(scan[i + 2])
                       : i == kCols - 2 ? adjust_a(cross)
                                        : (last ? 0 : adjust_a(next1));
    const int id = (clamp_to(scan[i], kScanClamp) + kScanClamp) * kScans +
                   clamp_to(a_next + scan[i], kScanClamp) + kScanClamp;
    iw[i >> 1] = (i & 1) ? iw[i >> 1] | (static_cast<uint32_t>(id) << 16)
                         : static_cast<uint32_t>(id);
  }
  reinterpret_cast<uint4*>(&idx_s[warp][0])[lane] =
      make_uint4(iw[0], iw[1], iw[2], iw[3]);
  if (lane == 0) {
    // column 0's left term reads the previous row's band cell; (0, 0)
    // reads nothing
    const int left0 = R == 0 ? 0
                             : P[(R - 1) * kN + kN - 1] -
                                   clean(__ldg(res + (R - 1) * kD + kD - 1));
    s0_s[warp] = static_cast<uint8_t>(
        clamp_to(adjust_a(scan[1]) + left0, kAaClamp) + kAaClamp);
  }
  __syncthreads();

  // 2. the walk: lane t of warp 0 walks row t, 8 columns a group, the next
  // group's table words loaded while this one is walked
  if (warp == 0) {
    const uint4* ix = reinterpret_cast<const uint4*>(&idx_s[lane][0]);
    uint64_t* st = reinterpret_cast<uint64_t*>(&st_s[lane][0]);
    uint32_t s = s0_s[lane];
    uint64_t T[kCols];
    {
      const uint4 v = ix[0];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        T[i] = lut[(i & 1) ? w[i >> 1] >> 16 : w[i >> 1] & 0xffffu];
    }
#pragma unroll 1
    for (int g = 0; g < kD / kCols; ++g) {
      uint64_t Tn[kCols];
      const uint4 v = ix[g + 1 < kD / kCols ? g + 1 : g];
      const uint32_t w[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
      for (int i = 0; i < kCols; ++i)
        Tn[i] = lut[(i & 1) ? w[i >> 1] >> 16 : w[i >> 1] & 0xffffu];
      uint64_t rec = 0;
#pragma unroll
      for (int i = 0; i < kCols; ++i) {
        rec |= static_cast<uint64_t>(s) << (8 * i);
        s = static_cast<uint32_t>(T[i] >> (kBits * s)) & ((1u << kBits) - 1);
      }
      st[g] = rec;
#pragma unroll
      for (int i = 0; i < kCols; ++i) T[i] = Tn[i];
    }
  }
  __syncthreads();

  // 3. the nudges and the new jpeg LL row, warp w on row R again
  const uint4 iv = reinterpret_cast<const uint4*>(&idx_s[warp][0])[lane];
  const uint64_t states =
      reinterpret_cast<const uint64_t*>(&st_s[warp][0])[lane];
  const uint32_t iw2[4] = {iv.x, iv.y, iv.z, iv.w};
  int out[kCols];
#pragma unroll
  for (int i = 0; i < kCols; ++i) {
    const int id = (i & 1) ? iw2[i >> 1] >> 16 : iw2[i >> 1] & 0xffffu;
    const int s = static_cast<int>((states >> (8 * i)) & 0xffu);
    const int rc = (i & 1) ? hi16(rcw[i >> 1]) : lo16(rcw[i >> 1]);
    out[i] = nhw::wrap16(rc + dec_s[(id / kScans) * kStates + s]);
  }
  reinterpret_cast<uint4*>(jll + row_at)[lane] =
      make_uint4(nhw::pack16(out[0], out[1]), nhw::pack16(out[2], out[3]),
                 nhw::pack16(out[4], out[5]), nhw::pack16(out[6], out[7]));
}

}  // namespace

extern "C" {

// K5.  jpeg, process: (B, 512, 512) int16, updated in place (LL quadrant),
// 16-byte aligned; res256: (B, 256, 256) int16; res_clean: (B, 256, 256)
// int16 out; scratch: 2 x (B, 256, 256) int16.  All contiguous.
int nhw_requant_tail(void* jpeg, void* process, const void* res256,
                     void* res_clean, void* scratch, int batch, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (nhw::misaligned(res256, 16) || nhw::misaligned(res_clean, 16) ||
      nhw::misaligned(scratch, 16))
    return cudaErrorMisalignedAddress;
  const auto s = static_cast<cudaStream_t>(stream);
  const size_t ll = static_cast<size_t>(batch) * kD * kD;
  auto* syn = static_cast<int16_t*>(scratch);
  int16_t* jll = syn + ll;
  int e = nhw_synth_level(jpeg, kN * kN, kN, syn, batch, kD, stream);
  if (e != 0) return e;
  requant_ladder<<<dim3(kD / kRows, batch), kThreads, 0, s>>>(
      syn, static_cast<const int16_t*>(res256),
      static_cast<const int16_t*>(process), static_cast<int16_t*>(res_clean),
      jll);
  e = cudaGetLastError();
  if (e != 0) return e;
  return nhw_analysis_level_jp(jll, kD * kD, kD, jpeg, kN * kN, kN, process,
                               kN * kN, kN, batch, kD, stream);
}

}  // extern "C"
