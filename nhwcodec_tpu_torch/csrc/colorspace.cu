// K6 nhw_colorspace_down420: the exact q >= NORM encode colorspace fused
// with the 4:2:0 chroma decimation, hand-written for Hopper (sm_90a).
// Plain C interface, bound with ctypes by nhwcodec_tpu_torch/kernels/
// build.py; wrapper and torch twin in nhwcodec_tpu_torch/ops/colorspace.py
// (rgb_to_yuv420, rgb_to_yuv420_ref).
//
// Replaces nhwcodec_tpu/ops/pallas_colorspace.py colorspace_down420_pallas
// (_colorspace_kernel): (B, 512, 512, 3) uint8 RGB -> Y (B, 512, 512)
// int16 and U, V (B, 256, 256) uint8 (encoder/colorspace.c:55-260).
// nhw_rgb_to_yuv_full runs the same per-pixel function (yuv_pixel)
// without the decimation, so an exhaustive sweep holds the band kernel's
// own arithmetic, every pixel's chroma, to the host (a decimated output
// could hide a one-off value).
//
// Arithmetic.  The TPU has no float64, so the JAX package replays the
// reference's float chain in u32 limbs.  This card has IEEE float64 and
// float32, so the kernel computes the host chain itself
// (nhwcodec_tpu/ops/colorspace.py rgb_to_yuv): the Y sum
// 0.299r + 0.587g + 0.114b left to right in float64, +0.5, truncation;
// the chroma sums in float64, rounded to float32, +128.5f or +128.4f by
// sign in float32, truncation, the (v>>8)!=0 clip.  nvcc would contract
// a*b+c into one FMA, which rounds once and is not exact here, so every
// operation is written with a rounding intrinsic (__dmul_rn, __dadd_rn,
// __double2float_rn, __fadd_rn), which nvcc never contracts; the file
// needs no -fmad=false.
//
// Bound.  Memory: 768 KiB of RGB in and 640 KiB of YUV out per image.  A
// few dozen float64 operations per pixel are below that at the card's
// float64 rate (64 a clock per SM), but conversions to and from 64-bit
// types issue at 16 a clock per SM (a quarter of that rate): the eight a
// pixel of the plain chain (three u8 -> f64, one f64 -> int, two f64 ->
// f32, two f32 -> int) take 8.0 us at batch 16 (12 with a 1.5x chroma
// recompute), above the 6.9 us byte bound.  So yuv_pixel keeps only the
// two f64 -> f32 roundings and does the rest exactly on the add pipes:
//   u8 -> f64: the double whose high word is 0x43300000 and low word v is
//     2^52 + v, so subtracting 2^52 gives v exactly;
//   trunc(v), 0 <= v < 2^52: __dadd_rz(v, 2^52) is 2^52 + floor(v), whose
//     low word is floor(v) (Y's v lies in [0.5, 256));
//   trunc(w), 0 <= w < 2^23 (float): __fadd_rz(w, 2^23) is 2^23 +
//     floor(w), read from its bits (the chroma's w lies in
//     [0.8999939, 256]).
// tests/test_torch_colorspace_band.py checks those ranges over all 2^24
// RGB triples; the card's 2^24 sweep through nhw_rgb_to_yuv_full checks
// the results.  Tables of the nine products (256 float64 each, in shared
// memory) were not used, on an estimate only (neither design was built
// and timed against the other): nine 8-byte shared loads a pixel are at
// least 0.56 shared-memory wavefronts a pixel with no bank conflict, and
// lanes index them divergently, against 0.05 float64 issue slots for the
// three exact adds that replace the conversions.
//
// Design.  A CTA owns a band of kBandRows output chroma rows r0.. of one
// image, i.e. input rows 2 r0 .. 2 r0 + 2 kBandRows - 1, plus the halo row
// 2 r0 - 1 that the [1,2,1] vertical taps of chroma row r0 read: one
// recomputed row (chroma only) for every 2 kBandRows rows, 1/8 at 4 rows.
// One warp per input row, 16 pixels (48 bytes, three 16-byte loads) a
// lane: the lane stores its 16 Y values as two 16-byte stores, takes the
// horizontal [1,2,1]/4 of its 8 even columns (column 16 lane - 1 from the
// previous lane by a shuffle; column 0 pair-averaged) and stores them to
// the band's int16 rows in shared memory, 16 bytes a chroma.  After a
// barrier 256 threads take 4 columns of one chroma row each, the vertical
// [1,2,1]/4 (chroma row 0 pair-averages input rows 0 and 1), and store U
// and V with 4-byte stores.  grid (256 / kBandRows, B), 9 warps a CTA.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"

namespace {

using nhw::misaligned;
using nhw::pack16;

constexpr int kN = 512;                        // image side
constexpr int kH = 256;                        // chroma side after 4:2:0
constexpr int kBandRows = 4;                   // chroma rows a CTA
constexpr int kBandIn = 2 * kBandRows + 1;     // input rows, the halo first
constexpr int kBandThreads = 32 * kBandIn;     // a warp an input row
constexpr int kLanePx = kN / 32;               // pixels a lane
static_assert(kLanePx == 16 && kBandRows * kH / 4 <= kBandThreads,
              "48 bytes of RGB a lane, one vertical task a thread");

constexpr double kTwo52 = 4503599627370496.0;  // 2^52
constexpr float kTwo23 = 8388608.0f;           // 2^23

__device__ __forceinline__ int clip_u8(int t) {
  return t < 0 ? 0 : (t > 255 ? 255 : t);   // == (t>>8)!=0 ? (t<0?0:255) : t
}

// v in 0..255 as a double, without a conversion
__device__ __forceinline__ double u8_to_f64(int v) {
  return __dadd_rn(__hiloint2double(0x43300000, v), -kTwo52);
}

// trunc(v) for 0 <= v < 2^31, without a conversion
__device__ __forceinline__ int trunc_f64(double v) {
  return __double2loint(__dadd_rz(v, kTwo52));
}

// trunc(w) for 0 <= w < 2^23, without a conversion
__device__ __forceinline__ int trunc_f32(float w) {
  return __float_as_int(__fadd_rz(w, kTwo23)) - __float_as_int(kTwo23);
}

// A float64 chroma sum -> the clipped chroma byte.
__device__ __forceinline__ int chroma_out(double c) {
  const float c32 = __double2float_rn(c);
  const float w = c32 >= 0.0f ? __fadd_rn(c32, 128.5f) : __fadd_rn(c32, 128.4f);
  return clip_u8(trunc_f32(w));
}

// The exact q >= NORM colorspace of one RGB pixel (bytes r8, g8, b8).
__device__ __forceinline__ void yuv_pixel(int r8, int g8, int b8, int& y,
                                          int& u, int& v) {
  const double r = u8_to_f64(r8);
  const double g = u8_to_f64(g8);
  const double b = u8_to_f64(b8);
  const double ys = __dadd_rn(__dadd_rn(__dmul_rn(0.299, r), __dmul_rn(0.587, g)),
                              __dmul_rn(0.114, b));
  y = trunc_f64(__dadd_rn(ys, 0.5));
  const double cb = __dadd_rn(
      __dadd_rn(__dmul_rn(-0.1687, r), -__dmul_rn(0.3313, g)), __dmul_rn(0.5, b));
  const double cr = __dadd_rn(
      __dadd_rn(__dmul_rn(0.5, r), -__dmul_rn(0.4187, g)), -__dmul_rn(0.0813, b));
  u = chroma_out(cb);
  v = chroma_out(cr);
}

__device__ __forceinline__ int byte_of(const uint32_t* w, int i) {
  return static_cast<int>((w[i >> 2] >> (8 * (i & 3))) & 255u);
}

// Horizontal [1,2,1]/4 at even column 2c of a lane's 16 values c16 (left:
// the previous lane's last value; first: the row's column 0, which is
// pair-averaged).
__device__ __forceinline__ int hdec(const int* c16, int c, int left,
                                   bool first) {
  if (c == 0)
    return first ? (c16[0] + c16[1] + 1) >> 1
                 : (left + 2 * c16[0] + c16[1] + 2) >> 2;
  return (c16[2 * c - 1] + 2 * c16[2 * c] + c16[2 * c + 1] + 2) >> 2;
}

// One input row by one warp: the lane's 16 pixels, Y stored when kOwn,
// the horizontally decimated chroma into hu, hv (256 int16 each).
template <bool kOwn>
__device__ __forceinline__ void band_row(const uint8_t* __restrict__ rgb_row,
                                         int16_t* __restrict__ y_row,
                                         int16_t* hu, int16_t* hv, int lane) {
  const uint4* src = reinterpret_cast<const uint4*>(rgb_row) + 3 * lane;
  uint32_t w[12];
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const uint4 q = __ldg(src + i);
    w[4 * i] = q.x;
    w[4 * i + 1] = q.y;
    w[4 * i + 2] = q.z;
    w[4 * i + 3] = q.w;
  }
  int u[kLanePx], v[kLanePx];
  uint32_t y2[kLanePx / 2];
#pragma unroll
  for (int p = 0; p < kLanePx; p += 2) {
    int y0, y1;
    yuv_pixel(byte_of(w, 3 * p), byte_of(w, 3 * p + 1), byte_of(w, 3 * p + 2),
              y0, u[p], v[p]);
    yuv_pixel(byte_of(w, 3 * p + 3), byte_of(w, 3 * p + 4),
              byte_of(w, 3 * p + 5), y1, u[p + 1], v[p + 1]);
    y2[p / 2] = pack16(y0, y1);
  }
  if (kOwn) {
    uint4* dst = reinterpret_cast<uint4*>(y_row) + 2 * lane;
    dst[0] = make_uint4(y2[0], y2[1], y2[2], y2[3]);
    dst[1] = make_uint4(y2[4], y2[5], y2[6], y2[7]);
  }
  const int ul = __shfl_up_sync(0xffffffffu, u[kLanePx - 1], 1);
  const int vl = __shfl_up_sync(0xffffffffu, v[kLanePx - 1], 1);
  uint32_t hu2[4], hv2[4];
#pragma unroll
  for (int c = 0; c < 8; c += 2) {
    hu2[c / 2] = pack16(hdec(u, c, ul, lane == 0), hdec(u, c + 1, ul, false));
    hv2[c / 2] = pack16(hdec(v, c, vl, lane == 0), hdec(v, c + 1, vl, false));
  }
  reinterpret_cast<uint4*>(hu)[lane] =
      make_uint4(hu2[0], hu2[1], hu2[2], hu2[3]);
  reinterpret_cast<uint4*>(hv)[lane] =
      make_uint4(hv2[0], hv2[1], hv2[2], hv2[3]);
}

// Vertical [1,2,1]/4 of 4 columns of the band's decimated rows up, mid,
// dn (chroma row 0: the pair average of mid and dn) -> 4 packed bytes.
__device__ __forceinline__ uint32_t vdec4(const int16_t* up,
                                          const int16_t* mid,
                                          const int16_t* dn, bool first) {
  const uint2 a = *reinterpret_cast<const uint2*>(up);
  const uint2 m = *reinterpret_cast<const uint2*>(mid);
  const uint2 z = *reinterpret_cast<const uint2*>(dn);
  uint32_t out = 0;
#pragma unroll
  for (int j = 0; j < 4; ++j) {
    const int sh = 16 * (j & 1);
    const int av = static_cast<int16_t>(((j < 2 ? a.x : a.y) >> sh) & 0xffffu);
    const int mv = static_cast<int16_t>(((j < 2 ? m.x : m.y) >> sh) & 0xffffu);
    const int zv = static_cast<int16_t>(((j < 2 ? z.x : z.y) >> sh) & 0xffffu);
    const int o = first ? (mv + zv + 1) >> 1 : (av + 2 * mv + zv + 2) >> 2;
    out |= static_cast<uint32_t>(o) << (8 * j);
  }
  return out;
}

// grid (kH / kBandRows, B), block kBandThreads.
__global__ void __launch_bounds__(kBandThreads)
    colorspace_band(const uint8_t* __restrict__ rgb, int16_t* __restrict__ Y,
                    uint8_t* __restrict__ U, uint8_t* __restrict__ V) {
  // band row i is input row 2 r0 - 1 + i
  __shared__ __align__(16) int16_t hu[kBandIn][kH];
  __shared__ __align__(16) int16_t hv[kBandIn][kH];
  const int r0 = blockIdx.x * kBandRows;
  const size_t b = blockIdx.y;
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int row = 2 * r0 - 1 + warp;
  const size_t at = (b * kN + row) * kN;   // row's first pixel (row >= 0)
  if (warp == 0) {
    if (row >= 0) band_row<false>(rgb + 3 * at, nullptr, hu[0], hv[0], lane);
  } else {
    band_row<true>(rgb + 3 * at, Y + at, hu[warp], hv[warp], lane);
  }
  __syncthreads();
  if (threadIdx.x < kBandRows * kH / 4) {
    const int i = threadIdx.x / (kH / 4);   // chroma row r0 + i
    const int c = 4 * (threadIdx.x % (kH / 4));
    const bool first = r0 + i == 0;
    const size_t o = (b * kH + r0 + i) * kH + c;
    *reinterpret_cast<uint32_t*>(U + o) =
        vdec4(&hu[2 * i][c], &hu[2 * i + 1][c], &hu[2 * i + 2][c], first);
    *reinterpret_cast<uint32_t*>(V + o) =
        vdec4(&hv[2 * i][c], &hv[2 * i + 1][c], &hv[2 * i + 2][c], first);
  }
}

// One thread per pixel, no decimation.
__global__ void rgb_to_yuv_full(const uint8_t* __restrict__ rgb,
                                int16_t* __restrict__ Y, uint8_t* __restrict__ U,
                                uint8_t* __restrict__ V, int n_pixels) {
  const int i = blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_pixels) return;
  const uint8_t* px = rgb + static_cast<size_t>(i) * 3;
  int y, u, v;
  yuv_pixel(px[0], px[1], px[2], y, u, v);
  Y[i] = static_cast<int16_t>(y);
  U[i] = static_cast<uint8_t>(u);
  V[i] = static_cast<uint8_t>(v);
}

}  // namespace

extern "C" {

// K6.  rgb: (B, 512, 512, 3) uint8, 16-byte aligned; y: (B, 512, 512)
// int16, 16-byte aligned; u, v: (B, 256, 256) uint8, 4-byte aligned; all
// contiguous.
int nhw_colorspace_down420(const void* rgb, void* y, void* u, void* v,
                           int batch, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(rgb, 16) || misaligned(y, 16) || misaligned(u, 4) ||
      misaligned(v, 4))
    return cudaErrorMisalignedAddress;
  colorspace_band<<<dim3(kH / kBandRows, batch), kBandThreads, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int16_t*>(y),
      static_cast<uint8_t*>(u), static_cast<uint8_t*>(v));
  return cudaGetLastError();
}

// K6's per-pixel function alone.  rgb: (n_pixels, 3) uint8; y: int16, u,
// v: uint8, n_pixels each; all contiguous.
int nhw_rgb_to_yuv_full(const void* rgb, void* y, void* u, void* v,
                        int n_pixels, void* stream) {
  if (n_pixels < 1) return cudaErrorInvalidValue;
  constexpr int kBlock = 256;
  rgb_to_yuv_full<<<(n_pixels + kBlock - 1) / kBlock, kBlock, 0,
                    static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(rgb), static_cast<int16_t*>(y),
      static_cast<uint8_t*>(u), static_cast<uint8_t*>(v), n_pixels);
  return cudaGetLastError();
}

}  // extern "C"
