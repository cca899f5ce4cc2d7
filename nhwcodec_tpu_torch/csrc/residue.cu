// Hand-written Hopper (sm_90a) kernels of the device encode scans' residue
// stage.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (pair_promotion_device / _ref,
// column_ladder_device / _ref, classify_device / _ref).
//
// S4 nhw_pair_promotion replaces nhwcodec_tpu/models/device_scans.py:2070
//    pair_promotion_device (a Jacobi while_loop over the decision plane):
//    _pair_promotion on a (B, 512, 512) int16 plane.  One launch.
// S5 nhw_column_ladder replaces nhwcodec_tpu/models/device_scans.py:952
//    column_ladder_device (a 255-step lax.scan with the columns as lanes,
//    then column 255's scan twice): res256_column_ladder.  One launch.
// S6 nhw_classify replaces nhwcodec_tpu/models/device_scans.py:1105
//    classify_device (a 256-step lax.scan over rows): res256_classify and
//    its counts n1, n3, n5.  One launch.
//
// The bound of each is bytes: a plane (and res256) read once and written
// once, some tens of operations a position.  Each is a chain of dependent
// steps, and the designs below are the simple exact ones, not yet tuned:
// - S4: the C's chain never leaves a row (its 7/-7 promotions and the lower
//   block's vertical cases are dead: 4 < v < 8 and -8 < v < -4 take v = 7,
//   -6 and -7 first), and the two regions, rows 1..254 x columns 257..510
//   and rows 257..510 x columns 1..254, share no row.  One thread a row
//   walks left to right with the left neighbour and the visited value in
//   registers and reads the right neighbour from the input; a value is
//   final, and stored, once the walk is one column past it (a visit
//   writes a - 1, a and a + 1: columns 256 and 0 take the first a - 1).
// - S5: one CTA an image, a thread a column.  Column j's walk over rows
//   0..254 carries (pf[scan], pf[scan + N], pf[scan - N], rf[cnt - D],
//   rf[cnt], the band value it wrote last) and reads the rest from the
//   input: rows r + 2, column j + 1 (which the C visits later) and its band
//   row j.  Its outputs go to a separate plane.  Column 255's flat j + 1
//   reads land on band column 256 (row r's value there is column r's
//   step-0 band write), on rf column 0 of rows r + 1..r + 3 and on the
//   tail, so it walks after a block barrier: the CTA stages its inputs and
//   those results in shared memory, and one thread walks it in place, its
//   own step-0 band value (read back at steps 253-254) stored as it goes.
// - S6: one CTA an image, a thread a column: the pf[scan] and rf[cnt] reads
//   are inputs, and column j's only chain is its band row's st - 1 read of
//   the value its previous row wrote.  The counts are summed in the CTA.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kN = 512;
constexpr int kD = 256;
constexpr int kSZ = 65536;
constexpr int kPlane = kN * kN;
constexpr int kRfExt = kSZ + 1024;   // res256 and the tail the C reads

constexpr int kPPThreads = 128;      // rows a CTA of S4

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// ---------------------------------------------------------------------------
// S4: pair promotion

// One visit (encoder/nhw_encoder.c:970-1074, the live branches): l, v, r
// are a - 1, a, a + 1 as the walk left them.
__device__ __forceinline__ void pp_visit(int& l, int& v, int& r, bool band) {
  if (v > 4 && v < 8) {
    if (l > 3 && l <= 7 && r > 3 && r <= 7) {
      v = 12700;
      l = r = 10100;
    }
  } else if (v < -4 && v > -8) {
    if (l < -3 && l >= -7 && r < -3 && r >= -7) {
      v = 12900;
      l = r = 10100;
    }
  } else if (v == 8) {
    if ((l & 65534) == 6 || (r & 65534) == 6) {
      v = 10;
    } else if (band && r == 8) {
      v = r = 9;
    }
  } else if (v == -8) {
    if (((-l) & 65534) == 6 || ((-r) & 65534) == 6) {
      v = -9;
    } else if (band && r == -8) {
      v = r = -9;
    }
  }
}

__global__ void __launch_bounds__(kPPThreads)
    pair_promotion(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                   int batch) {
  const int g = blockIdx.x * kPPThreads + threadIdx.x;
  if (g >= batch * kN) return;
  const int row = g % kN;
  const int16_t* p = in + static_cast<size_t>(g) * kN;
  int16_t* o = out + static_cast<size_t>(g) * kN;
  int c0 = 0, c1 = 0;
  bool band = false;
  if (row >= 1 && row < kD - 1) {
    c0 = kD + 1, c1 = kN - 1, band = true;
  } else if (row >= kD + 1 && row < kN - 1) {
    c0 = 1, c1 = kD - 1;
  } else {
    for (int c = 0; c < kN; ++c) o[c] = p[c];
    return;
  }
  for (int c = 0; c < c0 - 1; ++c) o[c] = p[c];
  for (int c = c1 + 1; c < kN; ++c) o[c] = p[c];
  int left = p[c0 - 1], cur = p[c0];
  for (int c = c0; c < c1; ++c) {
    int right = p[c + 1];
    pp_visit(left, cur, right, band);
    o[c - 1] = static_cast<int16_t>(left);
    left = cur;
    cur = right;
  }
  o[c1 - 1] = static_cast<int16_t>(left);
  o[c1] = static_cast<int16_t>(cur);
}

// ---------------------------------------------------------------------------
// S5: the res256 column ladder (encoder/nhw_encoder.c:1084-1326, the host
// copy's nhw_column_ladder)

struct LadderFlags {
  int low1, low2, hi1, res_setting;
};

__device__ __forceinline__ int band_w1(int v, int bp) {
  if (v == 7) return (bp >= 0 && bp < 8) ? v + 2 : v;
  if (v == 8) return (bp >= -2 && bp < 8) ? v + 2 : v;
  return v;
}

__device__ __forceinline__ int band_w2(int v, int bp) {
  if (v < -14) return ((((-v) & 7) == 0) || (((-v) & 7) == 7)) ? v + 1 : v;
  if (v == 7 || (v & 65534) == 8) return bp >= -2 ? v + 3 : v;
  return v;
}

__device__ __forceinline__ int band_w3(int v, int bp) {
  if (v < -14) return ((((-v) & 7) == 0) || (((-v) & 7) == 7)) ? v + 1 : v;
  if (v >= 0 && ((v + 2) & 65532) == 8) return bp >= -2 ? 10 : v;
  if (v > 14 && (v & 7) == 7) return v + 1;
  return v;
}

// One step of a column's ladder at row r, the C's chain with pf/rf reads
// as values: v0 = pf[scan], v1 = pf[scan + N] (both as the walk left
// them), v2 = pf[scan + 2N]; mark = rf[cnt] (as the walk left it), rf1 =
// rf[cnt + D], rf2 = rf[cnt + 2D]; up = pf[scan - N] - rf[cnt - D] (r > 0);
// x0..x2 = pf[scan + 1 + kN k] - rf[cnt + 1 + kD k]; bnd = pf[st], bp =
// pf[st - 1].  v1, v2, mark, rf1 and bnd are updated in place.
__device__ __forceinline__ void ladder_step(int v0, int& v1, int& v2,
                                            int& mark, int& rf1, int rf2,
                                            bool has_up, int up, int x0,
                                            int x1, int x2, int& bnd, int bp,
                                            const LadderFlags f) {
  const int res = v0 - mark;
  const int a = v1 - rf1;
  const int b2 = v2 - rf2;
  auto m12400 = [&] { mark = 12400; v1 -= 2; v2 -= 2; };
  auto m12300 = [&] { mark = 12300; v1 += 2; v2 += 2; };
  auto lw3 = [&] {
    if (f.hi1) mark = 14500;
    else bnd = band_w3(bnd, bp);
  };
  auto lw5 = [&] {
    mark = 14000;
    if (res == -4) {
      if ((bnd == -7 || bnd == -8) && bp > -8 && bp < 2) bnd = -9;
    } else if (res < -6) {
      if (res < -7 && f.hi1) {
        mark = 14900;
      } else if (bnd < -14) {
        if ((((-bnd) & 7) == 0) || (((-bnd) & 7) == 7)) bnd += 1;
      } else if ((bnd == 7 || bnd == 8) && bp >= -1 && bp < 8) {
        bnd += 3;
      }
    }
  };
  if (res == 2 && a == 2 && b2 >= 2) {
    if (b2 < 5 || b2 > 6) m12400();
  } else if (((res == 2 && a == 3) || (res == 3 && a == 2)) && b2 > 1 &&
             b2 < 6) {
    m12400();
  } else if (res == 3 && a == 3) {
    if (b2 > 0 && b2 < 6) {
      m12400();
    } else if (f.low1) {
      mark = 12100;
      v1 = rf1;
    }
  } else if (a == -4 && (res == 2 || res == 3) && (b2 == 2 || b2 == 3)) {
    if (res == 2 && b2 == 2) v1 += 1;
    else m12400();
  } else if (res == 1 && a == 3 && b2 == 2) {
    if (has_up && up >= 0) m12400();
  } else if ((res == 3 || res == 4 || res == 5 || res > 6) &&
             (a == 3 || (a & 65534) == 4)) {
    if (res > 6) {
      mark = 12500;
      v1 = rf1;
    } else if (f.low1) {
      mark = 12100;
      v1 = rf1;
    } else if (f.low2) {
      if (res < 5 && a == 5) rf1 = 14100;
      else if (res >= 5) mark = 14100;
      else if (res == 3 && a >= 4) rf1 = 14100;
      v1 = rf1;
    }
  } else if ((res == 2 || res == 3) && (a == 2 || a == 3)) {
    if ((b2 == 0 || b2 == 1) && (x0 == 2 || x0 == 3) &&
        (x1 == 2 || x1 == 3) && x2 > 0)
      m12400();
  } else if (a == 4 && (res == -2 || res == -3) && (-b2 == 2 || -b2 == 3)) {
    if (res == -2 && b2 == -2) v1 -= 1;
    else m12300();
  } else if ((res == -3 || res == -4 || res == -5 || res < -7) &&
             (a == -3 || a == -4 || a == -5)) {
    if (res < -7) {
      mark = 12600;
      v1 = rf1;
    } else if (f.low1) {
      mark = 12200;
      v1 = rf1;
    } else if (f.low2) {
      if (res > -5 && a == -5) rf1 = 14000;
      else if (res <= -5) mark = 14000;
      else if (res == -3 && a <= -4) rf1 = 14000;
      v1 = rf1;
    }
  } else if (a == -2 || a == -3) {
    if (res == -2 || res == -3) {
      if (-b2 > 0) {
        m12300();
      } else if (res == -3 && f.hi1) {
        mark = 14500;
      } else if (-b2 == 0) {
        if ((x0 == -2 || x0 == -3) && (x1 == -2 || x1 == -3) && x2 < 0)
          m12300();
      } else if (res == -2) {
        bnd = band_w2(bnd, bp);
      } else {
        lw3();
      }
    } else if (res == -1 && a == -3 && b2 == -2) {
      if (has_up && up <= 0) m12300();
    } else if (res == -1) {
      if (-b2 == 3) m12300();
      else bnd = band_w1(bnd, bp);
    } else if (res == -4) {
      if (-b2 > 1 && -b2 < 4) m12300();
      else lw5();
    }
  } else if (res == 0 || res == -1) {
    bnd = band_w1(bnd, bp);
  } else if (res == -2) {
    bnd = band_w2(bnd, bp);
  } else if (res == -3) {
    lw3();
  } else if (res < -f.res_setting) {
    lw5();
  }
}

// Column j's walk over rows 0..254.  Src gives the reads that are not
// carried: v2(r) = pf row r + 2, rf(k) = rf[k * 256 + j] for rows k <= 257
// (the tail past row 255), band(r) = pf (j, 256 + r), x(k) = the j + 1 read
// pf[k * 512 + j + 1] - rf[k * 256 + j + 1] of row k, and is told of each
// band value written (wrote_band).  The results go to o (plane) and ro (rf).
template <class Src>
__device__ void ladder_walk(int j, const int16_t* p, Src& src, int16_t* o,
                            int16_t* ro, const LadderFlags f) {
  int v0 = p[j], v1 = p[kN + j];
  int rfc = src.rf(0), rf1 = src.rf(1);
  int bp = p[j * kN + kD - 1];
  int vprev = 0, markm1 = 0;
  int x0 = src.x(0), x1 = src.x(1);
  for (int r = 0; r < kD - 1; ++r) {
    int v2 = src.v2(r);
    const int rf2 = src.rf(r + 2);
    const int x2 = src.x(r + 2);
    int bnd = src.band(r);
    int mark = rfc, nv1 = v1, nrf1 = rf1;
    ladder_step(v0, nv1, v2, mark, nrf1, rf2, r > 0, vprev - markm1, x0, x1,
                x2, bnd, bp, f);
    o[r * kN + j] = static_cast<int16_t>(v0);
    ro[r * kD + j] = static_cast<int16_t>(mark);
    o[j * kN + kD + r] = static_cast<int16_t>(bnd);
    src.wrote_band(r, bnd);
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
  o[(kD - 1) * kN + j] = static_cast<int16_t>(v0);
  o[kD * kN + j] = static_cast<int16_t>(v1);
  ro[(kD - 1) * kD + j] = static_cast<int16_t>(rfc);
}

// Columns 0..254: every read an input value.
struct InputSrc {
  const int16_t* p;
  const int16_t* rfe;
  int j;
  __device__ int v2(int r) const { return p[(r + 2) * kN + j]; }
  __device__ int rf(int k) const { return rfe[k * kD + j]; }
  __device__ int band(int r) const { return p[j * kN + kD + r]; }
  __device__ int x(int k) const {
    return p[k * kN + j + 1] - rfe[k * kD + j + 1];
  }
  __device__ void wrote_band(int, int) const {}
};

// Column 255 after the barrier, from shared memory: its own input column
// and band row, band column 256 (rows 0..254 the other columns' results,
// row 255 its own as it walks, row 256 the input) and rf column 0 (rows
// 0..255 results, 256 and 257 the tail).
struct Col255Src {
  const int16_t* v2s;    // pf (r + 2, 255), r = 0..254
  const int16_t* rfs;    // rf (k, 255), k = 0..257
  const int16_t* bnds;   // pf (255, 256 + r), r = 0..254
  int16_t* c256;         // pf (k, 256), k = 0..256
  const int16_t* rf0;    // rf (k, 0), k = 0..257
  __device__ int v2(int r) const { return v2s[r]; }
  __device__ int rf(int k) const { return rfs[k]; }
  __device__ int band(int r) const { return bnds[r]; }
  // the flat j + 1 read of row k: pf (k, 256) - rf (k + 1, 0)
  __device__ int x(int k) const { return c256[k] - rf0[k + 1]; }
  __device__ void wrote_band(int r, int v) const {
    if (r == 0) c256[kD - 1] = static_cast<int16_t>(v);
  }
};

__global__ void __launch_bounds__(kD)
    column_ladder(const int16_t* __restrict__ pin,
                  const int16_t* __restrict__ rfin, int16_t* __restrict__ pout,
                  int16_t* __restrict__ rfout, LadderFlags f) {
  __shared__ int16_t s_v2[kD], s_rf[kD + 2], s_bnd[kD], s_c256[kD + 1],
      s_rf0[kD + 2];
  const int j = threadIdx.x;
  const size_t b = blockIdx.x;
  const int16_t* p = pin + b * kPlane;
  const int16_t* rf = rfin + b * kRfExt;
  int16_t* o = pout + b * kPlane;
  int16_t* ro = rfout + b * kSZ;
  // what the ladder leaves: rows 257..511, row 256's right half, column 511
  for (int r = kD + 1; r < kN; ++r) {
    o[r * kN + j] = p[r * kN + j];
    o[r * kN + kD + j] = p[r * kN + kD + j];
  }
  o[kD * kN + kD + j] = p[kD * kN + kD + j];
  o[j * kN + kN - 1] = p[j * kN + kN - 1];
  if (j < kD - 1) {
    InputSrc src{p, rf, j};
    ladder_walk(j, p, src, o, ro, f);
  }
  __syncthreads();
  const int c = kD - 1;
  if (j < kD - 1) {
    s_v2[j] = p[(j + 2) * kN + c];
    s_bnd[j] = p[c * kN + kD + j];
    s_c256[j] = o[j * kN + kD];
  }
  s_rf[j] = rf[j * kD + c];
  s_rf0[j] = ro[j * kD];
  if (j < 2) {
    s_rf[kD + j] = rf[(kD + j) * kD + c];
    s_rf0[kD + j] = rf[(kD + j) * kD];
  }
  if (j == 0) s_c256[kD] = p[kD * kN + kD];
  __syncthreads();
  if (j == 0) {
    Col255Src src{s_v2, s_rf, s_bnd, s_c256, s_rf0};
    ladder_walk(c, p, src, o, ro, f);
  }
}

// ---------------------------------------------------------------------------
// S6: classify (encoder/nhw_encoder.c:1329-1420, the host copy's
// nhw_classify).  Marks outside the ladder's set map to 149.

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

__global__ void __launch_bounds__(kD)
    classify(const int16_t* __restrict__ pin, const int16_t* __restrict__ rfin,
             int16_t* __restrict__ pout, int16_t* __restrict__ rfout,
             int* __restrict__ counts, int hi1, int res_setting) {
  __shared__ int s_n[3];
  const int j = threadIdx.x;
  const size_t b = blockIdx.x;
  const int16_t* p = pin + b * kPlane;
  const int16_t* rf = rfin + b * kSZ;
  int16_t* o = pout + b * kPlane;
  int16_t* ro = rfout + b * kSZ;
  if (j < 3) s_n[j] = 0;
  // what classify leaves: columns 0..255 of rows 0..255, rows 256..511
  for (int r = 0; r < kD; ++r) o[r * kN + j] = p[r * kN + j];
  for (int r = kD; r < kN; ++r) {
    o[r * kN + j] = p[r * kN + j];
    o[r * kN + kD + j] = p[r * kN + kD + j];
  }
  int n1 = 0, n3 = 0, n5 = 0;
  int bp = p[j * kN + kD - 1];
  for (int r = 0; r < kD; ++r) {
    const int mark = rf[r * kD + j];
    int v = p[j * kN + kD + r];
    int code;
    if (mark < 12000) {
      const int res = p[r * kN + j] - mark;
      code = 0;
      if (res == 0 || res == 1) {
        if ((v == -7 || v == -8) && bp > -8 && bp < 2) v = -9;
      } else if (res == 2) {
        if (v > 15 && !(v & 7)) v -= 1;
        else if (v == -7 || v == -8) { if (bp <= 1) v = -9; }
        else if (v == -6 && bp > -8 && bp <= -1) v = -9;
      } else if (res == 3) {
        if (hi1) {
          code = 144;
          ++n5;
        } else if (v > 15 && !(v & 7)) {
          v -= 1;
        } else if (v <= 0 && ((((-v) + 2) & 65532) == 8) && bp <= 2) {
          v = -10;
        }
      } else if (res > res_setting) {
        code = 141;
        ++n1;
        if (res == 4) {
          if ((v == 7 || (v & 65534) == 8) && bp >= 0 && bp < 8) v += 2;
        } else if (res > 6) {
          if (res > 7 && hi1) {
            code = 148;
            ++n5;
            ++n1;
          } else if (v > 15 && !(v & 7)) {
            v -= 1;
          } else if ((v == -6 || v == -7 || v == -8) && bp > -8 && bp < 0) {
            v = -9;
          }
        }
      }
    } else {
      code = mark_code(mark);
      n1 += code == 140 || code == 141 || code == 125 || code == 126 ||
            code == 149;
      n3 += code >= 121 && code <= 126;
      n5 += code == 145 || code == 149;
    }
    ro[r * kD + j] = static_cast<int16_t>(code);
    o[j * kN + kD + r] = static_cast<int16_t>(v);
    bp = v;
  }
  __syncthreads();
  atomicAdd(&s_n[0], n1);
  atomicAdd(&s_n[1], n3);
  atomicAdd(&s_n[2], n5);
  __syncthreads();
  if (j < 3) counts[b * 3 + j] = s_n[j];
}

}  // namespace

extern "C" {

// S4.  in, out: (B, 512, 512) int16.
int nhw_pair_promotion(const void* in, void* out, int batch, void* stream) {
  if (batch < 1 || batch > (1 << 21)) return cudaErrorInvalidValue;
  if (misaligned(in, 2) || misaligned(out, 2))
    return cudaErrorMisalignedAddress;
  const int rows = batch * kN;
  pair_promotion<<<(rows + kPPThreads - 1) / kPPThreads, kPPThreads, 0,
                   static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), batch);
  return cudaGetLastError();
}

// S5.  plane, out: (B, 512, 512) int16; rf_ext: (B, SZ + 1024) int16;
// rf_out: (B, SZ) int16.
int nhw_column_ladder(const void* plane, const void* rf_ext, void* out,
                      void* rf_out, int batch, int low1, int low2, int hi1,
                      int res_setting, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(plane, 2) || misaligned(rf_ext, 2) || misaligned(out, 2) ||
      misaligned(rf_out, 2))
    return cudaErrorMisalignedAddress;
  column_ladder<<<batch, kD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(plane), static_cast<const int16_t*>(rf_ext),
      static_cast<int16_t*>(out), static_cast<int16_t*>(rf_out),
      LadderFlags{low1, low2, hi1, res_setting});
  return cudaGetLastError();
}

// S6.  plane, out: (B, 512, 512) int16; res256, rf_out: (B, 256, 256)
// int16; counts: (B, 3) int32 (n1, n3, n5).
int nhw_classify(const void* plane, const void* res256, void* out,
                 void* rf_out, void* counts, int batch, int hi1,
                 int res_setting, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(plane, 2) || misaligned(res256, 2) || misaligned(out, 2) ||
      misaligned(rf_out, 2) || misaligned(counts, 4))
    return cudaErrorMisalignedAddress;
  classify<<<batch, kD, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(plane), static_cast<const int16_t*>(res256),
      static_cast<int16_t*>(out), static_cast<int16_t*>(rf_out),
      static_cast<int*>(counts), hi1, res_setting);
  return cudaGetLastError();
}

}  // extern "C"
