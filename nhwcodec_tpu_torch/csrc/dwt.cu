// Hand-written Hopper (sm_90a) kernels for the three synthesis kernels of
// the batched decode path.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins live in
// nhwcodec_tpu_torch/ops/dwt.py.
//
// K1 nhw_synth_level replaces nhwcodec_tpu/ops/pallas_dwt.py
//    synth_level_pallas (_synth_level_kernel): one 2-D 5/3 synthesis
//    level, out = norm_rows(int16(unnorm_rows(x))^T), on (B, n, n) int16
//    with n in {128, 256, 512}.
// K2 nhw_y_stage2_full replaces pallas_dwt.py y_stage2_full_pallas
//    (_y_stage2_full_kernel): decode Y stage 2 without an HQ scatter -
//    un-normalised row pass + transpose, n_waves dering waves, normalised
//    row pass, clip to uint8, on (B, 512, 512).
// K3 nhw_uv_synth replaces pallas_dwt.py uv_synth_pallas
//    (_uv_synth_kernel): the whole chroma synthesis on (B, 256, 256).
// K7 nhw_synth_unnorm_rows_t replaces pallas_dwt.py
//    synth_unnorm_rows_t_pallas: K1's launch A alone, the un-normalised row
//    pass stored transposed, on (B, n, n) with n in {128, 256, 512}.
// K8 nhw_synth_norm_rows_clip_waves replaces pallas_dwt.py
//    synth_norm_rows_clip_waves_pallas: K2's launch B alone, on a
//    (B, 512, 512) transposed plane that the caller has scattered the HQ
//    residue into.
// K9 nhw_synth_norm_rows_clip replaces pallas_dwt.py
//    synth_norm_rows_clip_pallas: the normalised row pass and the clip,
//    K1's launch B with a uint8 store.
// nhw_smooth_marks_seq replaces the sequential mark scan of
//    nhwcodec_tpu/models/device_decode.py y_stage2_device (a lax.scan,
//    :126-148; host form native/hotpass.c nhw_smooth_marks), the decode's
//    fallback when same-row dering marks come out of column order.
//
// Bound.  Every kernel is integer stencil work of a few operations per
// byte, so it is bound by memory traffic and launch latency, not by
// arithmetic.  Each plane is read and written about twice: once by the
// row pass that stores its result transposed, once by the second pass.
// At the decode pipeline's batch of 16 the planes are 2 MiB (K1, K3 per
// plane set) and 8 MiB (K2): all of it stays in the 50 MB L2.
//
// Design.  The TPU kernels hold a whole plane in VMEM; a 512x512 int16
// plane (512 KiB) does not fit in one block's 227 KB of shared memory,
// and one block per image would leave most of the 132 SMs idle at batch
// 16.  So each level is two launches through global memory (L2), with
// one block per (image, row) and one thread per output pair k:
//   launch A (unnorm_rows_t): stage a row in shared memory, compute the
//     un-normalised pair (2k, 2k+1), store int16 TRANSPOSED to scratch;
//   launch B (norm_rows / waves_norm_clip): stage one scratch row,
//     compute the normalised pair, store the output row.
// K2's launch B runs the dering waves first.  Marks lie only on even
// rows of the transposed plane, and a mark's stencil reads rows j-1 and
// j+1, which are odd and never written, so one block finishes row j on
// its own: it stages rows j-1, j, j+1 (3 x 512 int16) and runs each wave
// as a read phase, a barrier and a masked write of row j.  Rows without
// marks skip the waves.  Row and column neighbours wrap modulo 512 like
// the reference's rolls (the depth plane is 0 on the borders anyway).
// The HQ scatter does not move marks, so the same argument holds for K8.
// K3 chooses the multi-launch form: K1 on the 128x128 LL, one
// elementwise launch for the residue sentinel deltas, band clears and
// the LL transpose-back, and K1 on the 256x256 plane.
//
// The mark scan is a chain of dependent reads and writes in emission
// order, so one thread walks one image's list, in place, reading each
// neighbour back from memory after the previous mark's write (bound by
// L2 latency, one round trip per mark).
//
// The transposed stores of launch A are 2-byte scattered writes that the
// L2 absorbs; tiling that transpose through shared memory is later work.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "lifting.cuh"

namespace {

constexpr int kMaxN = 512;
constexpr int kY = 512;     // decode Y plane side
constexpr int kUV = 256;    // decode chroma plane side
constexpr int kLL = 128;    // chroma LL block side

// Launch A: un-normalised synthesis of row r of image b, written
// transposed: t[b][j][r] = unnorm_rows(x)[r][j].  grid (n, B), block n/2.
// x may be a strided view: row r of image b starts at
// b * plane_stride + r * row_stride.
__global__ void unnorm_rows_t(const int16_t* __restrict__ x,
                              size_t plane_stride, int row_stride,
                              int16_t* __restrict__ t, int n) {
  __shared__ int16_t row[kMaxN];
  const int m = n >> 1;
  const int r = blockIdx.x;
  const int k = threadIdx.x;
  const size_t b = blockIdx.y;
  const int16_t* src = x + b * plane_stride + static_cast<size_t>(r) * row_stride;
  row[k] = src[k];
  row[k + m] = src[k + m];
  __syncthreads();
  int even, odd;
  nhw::unnorm_pair(row, row + m, m, k, even, odd);
  int16_t* dst = t + b * n * n;
  dst[static_cast<size_t>(2 * k) * n + r] = static_cast<int16_t>(even);
  dst[static_cast<size_t>(2 * k + 1) * n + r] = static_cast<int16_t>(odd);
}

__device__ __forceinline__ uint8_t clip_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The normalised value of an un-normalised one, stored as int16 (a
// synthesis level) or clipped to uint8 (the last pass of the Y decode).
template <typename T>
__device__ __forceinline__ T norm_out(int t);
template <>
__device__ __forceinline__ int16_t norm_out<int16_t>(int t) {
  return static_cast<int16_t>(nhw::norm_value(t));
}
template <>
__device__ __forceinline__ uint8_t norm_out<uint8_t>(int t) {
  return clip_u8(nhw::norm_value(t));
}

// Launch B: normalised synthesis of row r of the contiguous (B, n, n)
// plane t into out.  grid (n, B), block n/2.
template <typename T>
__global__ void norm_rows(const int16_t* __restrict__ t, T* __restrict__ out,
                          int n) {
  __shared__ int16_t row[kMaxN];
  const int m = n >> 1;
  const int k = threadIdx.x;
  const size_t base = (static_cast<size_t>(blockIdx.y) * n + blockIdx.x) * n;
  row[k] = t[base + k];
  row[k + m] = t[base + k + m];
  __syncthreads();
  int even, odd;
  nhw::unnorm_pair(row, row + m, m, k, even, odd);
  out[base + 2 * k] = norm_out<T>(even);
  out[base + 2 * k + 1] = norm_out<T>(odd);
}

// One dering wave at column c of the middle staged row: the smoothed
// value in v; true where the 8-neighbour residue is below 116
// (pallas_dwt.py:617-629).
__device__ __forceinline__ bool wave_cell(const int16_t* up, const int16_t* mid,
                                          const int16_t* dn, int c, int& v) {
  const int cl = (c + kY - 1) & (kY - 1);
  const int cr = (c + 1) & (kY - 1);
  const int x = mid[c];
  const int le = mid[cl];
  const int ri = mid[cr];
  const int u = up[c];
  const int d = dn[c];
  const int res = x * 8 - le - ri - u - d - up[cl] - up[cr] - dn[cl] - dn[cr];
  v = nhw::asr(x * 4 + le + ri + u + d + 4, 3);
  return (res < 0 ? -res : res) < 116;
}

// K2 launch B: dering waves on row j of the transposed plane, then the
// normalised row pass and the clip.  grid (512, B), block 256.
__global__ void waves_norm_clip(const int16_t* __restrict__ t,
                                const uint8_t* __restrict__ depth,
                                uint8_t* __restrict__ out, int n_waves) {
  __shared__ int16_t rows[3][kY];
  __shared__ int row_depth;
  const int j = blockIdx.x;
  const int k = threadIdx.x;
  const size_t b = blockIdx.y;
  const int16_t* plane = t + b * kY * kY;
  const int j_up = (j + kY - 1) & (kY - 1);
  const int j_dn = (j + 1) & (kY - 1);
  const size_t row_j = (b * kY + j) * kY;
  const int c0 = 2 * k;
  const int c1 = 2 * k + 1;
  const int d0 = depth[row_j + c0];
  const int d1 = depth[row_j + c1];
  if (k == 0) row_depth = 0;
  for (int i = k; i < kY; i += blockDim.x) {
    rows[0][i] = plane[static_cast<size_t>(j_up) * kY + i];
    rows[1][i] = plane[static_cast<size_t>(j) * kY + i];
    rows[2][i] = plane[static_cast<size_t>(j_dn) * kY + i];
  }
  __syncthreads();
  if (d0 | d1) atomicMax(&row_depth, d0 > d1 ? d0 : d1);
  __syncthreads();
  const int last = n_waves < row_depth ? n_waves : row_depth;
  for (int r = 1; r <= last; ++r) {
    int v0 = 0, v1 = 0;
    const bool take0 = d0 == r && wave_cell(rows[0], rows[1], rows[2], c0, v0);
    const bool take1 = d1 == r && wave_cell(rows[0], rows[1], rows[2], c1, v1);
    __syncthreads();   // every read of this wave before any write
    if (take0) rows[1][c0] = static_cast<int16_t>(v0);
    if (take1) rows[1][c1] = static_cast<int16_t>(v1);
    __syncthreads();
  }
  int even, odd;
  nhw::unnorm_pair(rows[1], rows[1] + kY / 2, kY / 2, k, even, odd);
  out[row_j + c0] = norm_out<uint8_t>(even);
  out[row_j + c1] = norm_out<uint8_t>(odd);
}

// The sequential mark scan: thread b walks image b's records in order,
// in place on the transposed plane x (B, 512, 512).  A record is
// row << 8 | col of the 256x256 LL block, at x[2 row][col]; its
// neighbours are read flat (x[.][col - 1] at col 0 is the previous row's
// last cell), as the C pass reads them.  Records with valid 0 write
// nothing; so do rows outside 1..255, whose stencil would leave the
// plane.  grid ceil(B / 32), block 32.
__global__ void smooth_marks_seq(int16_t* x, const int32_t* __restrict__ recs,
                                 const uint8_t* __restrict__ valid, int k_max,
                                 int batch) {
  const int b = blockIdx.x * blockDim.x + threadIdx.x;
  if (b >= batch) return;
  int16_t* p = x + static_cast<size_t>(b) * kY * kY;
  const int32_t* rec = recs + static_cast<size_t>(b) * k_max;
  const uint8_t* ok = valid + static_cast<size_t>(b) * k_max;
  for (int k = 0; k < k_max; ++k) {
    const int r = rec[k];
    if (!ok[k] || r < 256 || r >= 65536) continue;
    const int scan = ((r >> 8) << 10) + (r & 255);
    const int c = p[scan];
    const int le = p[scan - 1];
    const int ri = p[scan + 1];
    const int up = p[scan - kY];
    const int dn = p[scan + kY];
    const int res = c * 8 - le - ri - up - dn - p[scan - kY - 1] -
                    p[scan + kY - 1] - p[scan - kY + 1] - p[scan + kY + 1];
    if ((res < 0 ? -res : res) < 116)
      p[scan] = static_cast<int16_t>(
          nhw::wrap16(nhw::asr(c * 4 + le + ri + up + dn + 4, 3)));
  }
}

// Residue sentinels 5003..5006 (decoder/nhw_decoder.c:991-1069): the
// delta at the target and the one at target + 1.
__device__ __forceinline__ int pair_delta(int v) {
  return v == 5005 ? -4 : (v == 5006 ? 4 : 0);
}
__device__ __forceinline__ int single_delta(int v) {
  return v == 5003 ? -6 : (v == 5004 ? 6 : 0);
}

// K3 middle launch: jp[i][j] = proc[j][i] in the LL block, where
// proc = wrap16(ll1 + sentinel deltas of the three bands), and the
// coefficient plane with its sentinels cleared elsewhere
// (pallas_dwt.py:353-372).  grid (256, B), block 256.
__global__ void uv_assemble(const int16_t* __restrict__ x,
                            const int16_t* __restrict__ ll1,
                            int16_t* __restrict__ jp) {
  const int i = blockIdx.x;
  const int j = threadIdx.x;
  const size_t b = blockIdx.y;
  const int16_t* X = x + b * kUV * kUV;
  int val;
  if (i < kLL && j < kLL) {
    const int r = j;
    const int c = i;
    const int ur = X[r * kUV + kLL + c];
    const int lo_l = X[(kLL + r) * kUV + c];
    const int lo_r = X[(kLL + r) * kUV + kLL + c];
    int v = ll1[b * kLL * kLL + r * kLL + c]
            + pair_delta(ur) + single_delta(ur)
            + pair_delta(lo_l) + single_delta(lo_l)
            + pair_delta(lo_r) + single_delta(lo_r);
    if (c > 0) {
      v += pair_delta(X[r * kUV + kLL + c - 1])
           + pair_delta(X[(kLL + r) * kUV + c - 1])
           + pair_delta(X[(kLL + r) * kUV + kLL + c - 1]);
    }
    val = nhw::wrap16(v);
  } else {
    const int v = X[i * kUV + j];
    val = (v >= 5003 && v <= 5006) ? 0 : v;
  }
  jp[b * kUV * kUV + i * kUV + j] = static_cast<int16_t>(val);
}

cudaError_t synth_level(const int16_t* x, size_t plane_stride, int row_stride,
                        int16_t* scratch, int16_t* out, int batch, int n,
                        cudaStream_t s) {
  const dim3 grid(n, batch);
  unnorm_rows_t<<<grid, n / 2, 0, s>>>(x, plane_stride, row_stride, scratch, n);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  norm_rows<int16_t><<<grid, n / 2, 0, s>>>(scratch, out, n);
  return cudaGetLastError();
}

bool bad_n(int n) { return n != 128 && n != 256 && n != 512; }

bool bad_batch(int batch) { return batch < 1 || batch > 65535; }

}  // namespace

extern "C" {

const char* nhw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  x: (B, n, n) int16 with the given plane and row strides (elements);
// scratch, out: contiguous (B, n, n) int16.
int nhw_synth_level(const void* x, int plane_stride, int row_stride,
                    void* scratch, void* out, int batch, int n, void* stream) {
  if (bad_n(n) || bad_batch(batch)) return cudaErrorInvalidValue;
  return synth_level(static_cast<const int16_t*>(x), plane_stride, row_stride,
                     static_cast<int16_t*>(scratch), static_cast<int16_t*>(out),
                     batch, n, static_cast<cudaStream_t>(stream));
}

// K2.  jp: (B, 512, 512) int16, depth: (B, 512, 512) uint8 (non-zero only
// on even rows), scratch: (B, 512, 512) int16, out: (B, 512, 512) uint8.
int nhw_y_stage2_full(const void* jp, const void* depth, void* scratch,
                      void* out, int batch, int n_waves, void* stream) {
  if (bad_batch(batch)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const dim3 grid(kY, batch);
  unnorm_rows_t<<<grid, kY / 2, 0, s>>>(static_cast<const int16_t*>(jp),
                                        static_cast<size_t>(kY) * kY, kY,
                                        static_cast<int16_t*>(scratch), kY);
  const cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  waves_norm_clip<<<grid, kY / 2, 0, s>>>(
      static_cast<const int16_t*>(scratch), static_cast<const uint8_t*>(depth),
      static_cast<uint8_t*>(out), n_waves);
  return cudaGetLastError();
}

// K3.  x: (B, 256, 256) int16; s128, ll1: (B, 128, 128) int16 scratch;
// jp, s256: (B, 256, 256) int16 scratch; out: (B, 256, 256) int16.
int nhw_uv_synth(const void* x, void* s128, void* ll1, void* jp, void* s256,
                 void* out, int batch, void* stream) {
  if (bad_batch(batch)) return cudaErrorInvalidValue;
  const auto s = static_cast<cudaStream_t>(stream);
  const auto* xin = static_cast<const int16_t*>(x);
  auto* jpp = static_cast<int16_t*>(jp);
  auto* ll = static_cast<int16_t*>(ll1);
  const size_t plane = static_cast<size_t>(kUV) * kUV;
  cudaError_t e = synth_level(xin, plane, kUV, static_cast<int16_t*>(s128), ll,
                              batch, kLL, s);
  if (e != cudaSuccess) return e;
  uv_assemble<<<dim3(kUV, batch), kUV, 0, s>>>(xin, ll, jpp);
  e = cudaGetLastError();
  if (e != cudaSuccess) return e;
  return synth_level(jpp, plane, kUV, static_cast<int16_t*>(s256),
                     static_cast<int16_t*>(out), batch, kUV, s);
}

// K7.  x: (B, n, n) int16 with the given plane and row strides (elements);
// out: contiguous (B, n, n) int16, out[b] = int16(unnorm_rows(x[b]))^T.
int nhw_synth_unnorm_rows_t(const void* x, int plane_stride, int row_stride,
                            void* out, int batch, int n, void* stream) {
  if (bad_n(n) || bad_batch(batch)) return cudaErrorInvalidValue;
  unnorm_rows_t<<<dim3(n, batch), n / 2, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), plane_stride, row_stride,
      static_cast<int16_t*>(out), n);
  return cudaGetLastError();
}

// K8.  t: (B, 512, 512) int16 transposed plane, depth: (B, 512, 512) uint8
// (non-zero only on even rows), out: (B, 512, 512) uint8.
int nhw_synth_norm_rows_clip_waves(const void* t, const void* depth, void* out,
                                   int batch, int n_waves, void* stream) {
  if (bad_batch(batch)) return cudaErrorInvalidValue;
  waves_norm_clip<<<dim3(kY, batch), kY / 2, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(t), static_cast<const uint8_t*>(depth),
      static_cast<uint8_t*>(out), n_waves);
  return cudaGetLastError();
}

// K9.  t: contiguous (B, n, n) int16, out: (B, n, n) uint8.
int nhw_synth_norm_rows_clip(const void* t, void* out, int batch, int n,
                             void* stream) {
  if (bad_n(n) || bad_batch(batch)) return cudaErrorInvalidValue;
  norm_rows<uint8_t><<<dim3(n, batch), n / 2, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(t), static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

// The mark scan.  x: (B, 512, 512) int16, updated in place; recs: (B, K)
// int32 records; valid: (B, K) uint8 (0 = padding).
int nhw_smooth_marks_seq(void* x, const void* recs, const void* valid, int k,
                         int batch, void* stream) {
  if (batch < 1 || k < 0) return cudaErrorInvalidValue;
  if (k == 0) return cudaSuccess;
  smooth_marks_seq<<<(batch + 31) / 32, 32, 0,
                     static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(x), static_cast<const int32_t*>(recs),
      static_cast<const uint8_t*>(valid), k, batch);
  return cudaGetLastError();
}

}  // extern "C"
