// Hand-written Hopper (sm_90a) kernels of the device encode scans' stream
// stage.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (snap_pass_device / _ref,
// offset_y_device / offset_y_ref, merge_crossing_device / _ref).
//
// S1 nhw_snap_pass replaces nhwcodec_tpu/models/device_scans.py:93
//    snap_pass_device (an XLA while_loop, a Jacobi fixpoint over the
//    left-neighbour fixup chain): one _band_snap_pass on a (B, 512, 512)
//    int16 plane.  One launch.
// S2 nhw_offset_y replaces nhwcodec_tpu/models/device_scans.py:375
//    offset_y_device (a Jacobi while_loop, a 256-step lax.scan over rows
//    and elementwise passes): the q > LOW4 quantizer, (B, 512, 512) int16
//    plane -> int16 code plane.  Three launches.
// S3 nhw_merge_crossing replaces nhwcodec_tpu/models/device_scans.py:527
//    merge_crossing_device (an associative scan of a 5-state skip machine):
//    the crossing merge of a (B, n >= 4 SZ) uint8 stream.  Three launches.
//
// The bound of each is bytes: the plane or the stream read once and
// written once, some tens of operations a position.  Each is a chain of
// dependent steps along a row or a stream, and the designs below are the
// simple exact ones, not yet tuned:
// - S1: one thread a row walks its region columns left to right, the left
//   neighbour's post-snap value and aliveness in registers; the neighbour
//   count is static (alive values stay alive under every write of the
//   pass), read from the input plane above and below.  The thread also
//   copies its row's columns outside the region, so the output is whole.
// - S2: pass 1 one thread a row (a give lands on the next column and never
//   leaves column 510); passes 2-3 one CTA an image, a thread a column,
//   rows in order, in place on pass 1's output (a vertical fire writes
//   10100 into the next row through a register; row 255's land in plane
//   row 256).  The greedy pair rule is the parity of a position in its run
//   of candidates; the run starts are a block max-scan of warp ballots.
//   Pass 4 is elementwise, one thread a position.
// - S3: 16 positions a thread.  Each thread builds its tile's map over
//   the 5 entry states (positions still skipped), lanes 0-4 compose a
//   warp's 32 tiles and threads 0-4 the CTA's 8 warps (merge_tiles); one
//   warp a stream walks the 64 CTAs' composites from state 0, the state
//   picked by a shuffle (merge_entries); merge_emit rebuilds the maps,
//   hands the entry down to warps and tiles, and each thread walks its 16
//   positions and the next tile's first 4.  A fire at i writes i and
//   201 at i + 4, so thread t writes positions [16 t + 4, 16 t + 20) (and
//   tile 0 also [0, 4)): every byte has one writer.

#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>
#include <utility>

#include "block_scan.cuh"

namespace {

using nhw::iabs;
using nhw::run_parity_block;

constexpr int kN = 512;
constexpr int kD = 256;
constexpr int kSZ = 65536;
constexpr int kPlane = kN * kN;

constexpr int kSnapThreads = 128;   // rows a CTA of S1
constexpr int kRowThreads = 128;    // rows a CTA of S2's pass 1
constexpr int kCodeThreads = 256;   // positions a CTA of S2's pass 4

constexpr int kMT = 16;                      // positions a thread of S3
constexpr int kMThreads = 256;               // threads a CTA of S3
constexpr int kMWarps = kMThreads / 32;
constexpr int kMSpan = kMT * kMThreads;      // positions a CTA
constexpr int kMLen = 4 * kSZ;               // positions walked and written
constexpr int kMEnd = kMLen - 4;             // the cursor walk's end
constexpr int kMCtas = kMLen / kMSpan;       // CTAs a stream
constexpr int kMStage = kMSpan + 32;         // staged bytes a CTA
constexpr int kMStates = 5;

// ---------------------------------------------------------------------------
// S1: snap pass

struct SnapArgs {
  int r0, r1, col0, col1, thr, yw, yw2, second_rule, guard6, gc;
};

// The snap decision for an alive position with current value v and static
// neighbour count cnt (encoder/nhw_encoder.c:1923-1960).
__device__ __forceinline__ int snap_decide(int v, int cnt, const SnapArgs& a) {
  const int av = iabs(v);
  if (av < a.yw2 && cnt < 3 && v > -a.yw && v < a.yw) {
    if (a.guard6) return v < -6 ? -7 : (v > 6 ? 7 : v);
    return v < 0 ? -7 : 7;
  }
  if (a.second_rule && cnt == 0 && av < a.yw2) return v < 0 ? -7 : 7;
  return v;
}

// Value of I after its alive left neighbour's fixup, given the neighbour's
// post-snap e; right is I's right neighbour, gc_ok whether the neighbour's
// column lies below the guard column.
__device__ __forceinline__ int snap_fixup(int I, int right, int e_left,
                                          bool left_alive, bool gc_ok) {
  if (!left_alive) return I;
  if (e_left >= 8 && (e_left & 7) < 2) return (I > 7 && I < 10000) ? I - 1 : I;
  if (e_left < -7 && ((-e_left) & 7) < 2 && I < -14) {
    const int m = (-I) & 7;
    if (m == 7 || (m < 2 && gc_ok && right <= 0)) return I + 1;
  }
  return I;
}

__global__ void __launch_bounds__(kSnapThreads)
    snap_pass(const int16_t* __restrict__ in, int16_t* __restrict__ out,
              int batch, SnapArgs a) {
  const int g = blockIdx.x * kSnapThreads + threadIdx.x;
  if (g >= batch * kN) return;
  const int r = g % kN;
  const int16_t* p = in + static_cast<size_t>(g) * kN;
  int16_t* o = out + static_cast<size_t>(g) * kN;
  if (r < a.r0 || r >= a.r1) {
    for (int c = 0; c < kN; ++c) o[c] = p[c];
    return;
  }
  const bool has_up = r > 0, has_dn = r + 1 < kN;
  const bool up_in = r - 1 >= a.r0;   // the row above lies in the region
  for (int c = 0; c < a.col0; ++c) o[c] = p[c];
  int e_prev = 0;
  bool la = false;
  int left = a.col0 > 0 ? p[a.col0 - 1] : 0;
  int cur = p[a.col0];
  for (int c = a.col0; c < a.col1; ++c) {
    const int right = c + 1 < kN ? p[c + 1] : 0;
    const bool alive = iabs(cur) >= a.thr;
    int e = cur, val = 0;
    if (alive) {
      const int up = has_up ? p[c - kN] : 0;
      const int dn = has_dn ? p[c + kN] : 0;
      const bool l_tr = c > a.col0 ? la : iabs(left) >= 6;
      const bool u_tr = up_in ? iabs(up) >= a.thr : iabs(up) >= 6;
      const int cnt = int(l_tr) + int(iabs(right) >= 6) + int(u_tr) +
                      int(iabs(dn) >= 6);
      e = snap_decide(snap_fixup(cur, right, e_prev, la, c - 1 < a.gc), cnt,
                      a);
      val = (e == -7 && right == 8) ? -8 : e;
    }
    o[c] = static_cast<int16_t>(val);
    e_prev = e;
    la = alive;
    left = cur;
    cur = right;
  }
  if (a.col1 < kN) {
    const int right = a.col1 + 1 < kN ? p[a.col1 + 1] : 0;
    o[a.col1] = static_cast<int16_t>(
        snap_fixup(cur, right, e_prev, la, a.col1 - 1 < a.gc));
    for (int c = a.col1 + 1; c < kN; ++c) o[c] = p[c];
  }
}

// ---------------------------------------------------------------------------
// S2: offset_y, q > LOW4

// Pass 1 (image_processing.c:194-237): even-pair decrements, one thread a
// row; reads of x + 1, x + 2 and x - 1 are initial values, in flat order.
__global__ void __launch_bounds__(kRowThreads)
    offset_y_rows(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                  int batch) {
  const int g = blockIdx.x * kRowThreads + threadIdx.x;
  if (g >= batch * kN) return;
  const int r = g % kN;
  const int16_t* img = in + static_cast<size_t>(g / kN) * kPlane;
  int16_t* o = out + static_cast<size_t>(g) * kN;
  int d = 0;
  for (int c = 0; c < kN; ++c) {
    const int x = r * kN + c;
    const int a = img[x] - d;
    const int il = x + 1 < kPlane ? img[x + 1] : 0;
    const int il2 = x + 2 < kPlane ? img[x + 2] : 0;
    const int irs = x > 0 ? img[x - 1] : 0;
    const bool reg = (r >= kD || c >= kD) && c < 2 * kD - 1;
    const bool outer =
        reg && a > 7 && il > 7 && (a & 7) == 0 && (il & 7) == 0;
    const bool outer_r =
        il > 15 && (il & 7) == 0 && c < 2 * kD - 2 && il2 <= 0;
    const bool big = a > 15;
    const bool case_a = outer && big && x > 0 && irs <= 0;
    const bool give = outer && outer_r && (!big || (x > 0 && irs > 0));
    o[c] = static_cast<int16_t>(a - int(case_a));
    d = int(give);
  }
}

// Passes 2-3 (image_processing.c:241-309) on the LL quadrant of one image,
// in place: rows in order, a thread a column.
__global__ void __launch_bounds__(kD) offset_y_ll(int16_t* __restrict__ plane) {
  __shared__ int row_s[kD + 2];      // the row's values, 0 at both ends
  __shared__ int lval_s[kD + 1];     // value a fire at j writes at j - 1
  __shared__ uint8_t flag_s[kD + 1]; // bit 0: fh | fv, bit 1: fv
  __shared__ int warp_last[kD / 32];
  const int j = threadIdx.x;
  int16_t* img = plane + static_cast<size_t>(blockIdx.x) * kPlane;
  if (j == 0) {
    row_s[0] = row_s[kD + 1] = 0;
    flag_s[kD] = 0;
  }
  bool pend = false;
  const bool ok = j >= 1 && j < kD - 1;
  for (int r = 0; r < kD; ++r) {
    const int i_r = img[r * kN + j];
    const int i_r1 = img[(r + 1) * kN + j];
    const int n1l = j > 0 ? img[(r + 1) * kN + j - 1] : 0;
    const int v = pend ? 10100 : i_r;
    row_s[j + 1] = v;
    __syncthreads();
    const int vl = row_s[j], vr = row_s[j + 2];
    const bool fp = ok && v > 3 && v < 8 && vl > 3 && vl <= 7;
    const bool fph = fp && vr > 3 && vr <= 7;
    const bool fpv =
        fp && !fph && n1l > 3 && n1l <= 7 && i_r1 > 3 && i_r1 <= 7;
    const bool fn = ok && v > -8 && v < -3 && vl > -8 && vl <= -4;
    const bool fnh = fn && vr > -8 && vr <= -4;
    const bool fnv =
        fn && !fnh && n1l > -8 && n1l <= -4 && i_r1 > -8 && i_r1 <= -4;
    const bool fired = run_parity_block(fph || fpv || fnh || fnv, warp_last);
    const bool fh = fired && (fph || fnh);
    const bool fv = fired && (fpv || fnv);
    int o = v;
    if (fh) o = fph ? 12700 : 12900;
    if (fv) o = 10100;
    lval_s[j] = fh ? 10100 : (fpv ? 12100 : 12200);
    flag_s[j] = uint8_t((fh || fv) | (fv << 1));
    __syncthreads();
    const uint8_t nxt = flag_s[j + 1];
    if (nxt & 1) o = lval_s[j + 1];
    const bool pend_next = fv || (nxt & 2);
    // pass 3 on the finished row: own writes only
    row_s[j + 1] = o;
    __syncthreads();
    const int orr = row_s[j + 2];
    const bool f3p = j < kD - 1 && o >= 5 && o <= 7 && orr >= 5 && orr <= 7;
    const bool f3n =
        j < kD - 1 && o >= -7 && o <= -5 && orr >= -7 && orr <= -5;
    const bool fired3 = run_parity_block(f3p || f3n, warp_last);
    img[r * kN + j] = static_cast<int16_t>(fired3 ? (f3p ? 10300 : 10204) : o);
    pend = pend_next;
  }
  if (pend) img[kD * kN + j] = 10100;
}

__device__ __forceinline__ int sentinel_code(int a) {
  switch (a) {
    case 10100: return 128;
    case 12700: return 127;
    case 12900: return 129;
    case 10204: return 125;
    case 10300: return 126;
    case 12100: return 121;
    case 12200: return 122;
    default: return a;
  }
}

// |a| > 127 escape words; esc: (2, 19) int32, EXTRA_WORDS1 then
// EXTRA_WORDS2.
__device__ __forceinline__ int escape_code(int a, const int* __restrict__ esc) {
  if (a > 127) return esc[min(max(((a & 0xfff8) - 128) >> 3, 0), 18)];
  return esc[19 + min(max((((-a) & 0xfff8) - 128) >> 3, 0), 18)];
}

// Pass 4 (image_processing.c:312-520): the fixup write onto x from x - 1,
// then the code map; one thread a position.
__global__ void __launch_bounds__(kCodeThreads)
    offset_y_codes(const int16_t* __restrict__ in, int16_t* __restrict__ out,
                   const int* __restrict__ esc, int total, int m1) {
  const int i = blockIdx.x * kCodeThreads + threadIdx.x;
  if (i >= total) return;
  const int x = i % kPlane;
  const int f = in[i];
  const int il = x + 1 < kPlane ? in[i + 1] : 0;
  const bool incol = (x & (kN - 1)) < 2 * kD - 1;
  int a = f;
  if (x > 0 && ((x - 1) & (kN - 1)) < 2 * kD - 1) {
    const int fp = in[i - 1];   // the left position; its right is f
    const bool w_m9 = fp < -12 && ((-fp) & 7) == 6 && f == -7;
    const bool w_m8 = fp == 8 && f == -7;
    const bool w_9 = fp >= 0 && fp != 8 && fp > 12 && (fp & 7) >= 6 && f == 7;
    const bool plain = fp < 10000 && fp >= -10000 && iabs(fp) <= 127;
    if (plain && (w_m9 || w_m8 || w_9)) a = w_m9 ? -9 : (w_m8 ? -8 : 9);
  }
  int o;
  if (f == 0) {
    o = 128;
  } else if (a > 10000) {
    o = sentinel_code(a);
  } else if (a > 127 || a < -127) {
    o = escape_code(a, esc);
  } else {
    const int a2 = (a == -7 && il == 8 && incol) ? -8 : a;
    int an = -a2;
    if (an > 14 && (an & 7) == 7 && il > 0 && il < 8) an -= 2;
    if ((an & 7) < 7) an &= 504;
    const int aq = a2 < 0 ? -an : a2;
    o = (aq > -m1 && aq < m1) ? 128 : ((aq + 128) & 248);
  }
  out[i] = static_cast<int16_t>(o);
}

// ---------------------------------------------------------------------------
// S3: merge_crossing

struct MergeShared {
  uint8_t v[kMStage];             // the CTA's bytes and 32 past them
  uint32_t map[kMThreads];        // tile maps, 3 bits an entry state
  uint8_t warp_fn[kMWarps][kMStates];
  uint8_t entry[kMThreads];
  uint8_t warp_entry[kMWarps];
};

// The cursor's skip at local position i (1..5, 1 at or past the end) and
// whether a fire pattern stands there (before the end only).
__device__ __forceinline__ int merge_k(const uint8_t* v, int i, int gi,
                                       bool& fire_p) {
  const int v0 = v[i], v1 = v[i + 1], v2 = v[i + 2], v3 = v[i + 3],
            v4 = v[i + 4];
  const bool c1 = v0 != 128 && v1 == 128;
  const bool fp = c1 && v2 == 128 && v3 == 128 && (v0 == 136 || v0 == 120) &&
                  (v4 == 136 || v4 == 120);
  fire_p = fp && gi < kMEnd;
  if (gi >= kMEnd || !c1) return 1;
  if (v2 != 128) return 2;
  if (v3 != 128) return 3;
  return fp ? 5 : 4;
}

__device__ __forceinline__ int map_at(uint32_t f, int m) {
  return (f >> (3 * m)) & 7;
}

// Stage the CTA's bytes, build every thread's tile map and every warp's
// composite.
__device__ void merge_build(MergeShared& sh, const uint8_t* __restrict__ s,
                            int n, int b, int cta) {
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const size_t base = static_cast<size_t>(b) * n;
  const int start = cta * kMSpan;
  for (int i = t; i < kMStage; i += kMThreads)
    sh.v[i] = start + i < n ? s[base + start + i] : 0;
  __syncthreads();
  int st[kMStates] = {0, 1, 2, 3, 4};
  for (int q = 0; q < kMT; ++q) {
    bool fp;
    const int km1 = merge_k(sh.v, t * kMT + q, start + t * kMT + q, fp) - 1;
#pragma unroll
    for (int m = 0; m < kMStates; ++m) st[m] = st[m] > 0 ? st[m] - 1 : km1;
  }
  uint32_t f = 0;
#pragma unroll
  for (int m = 0; m < kMStates; ++m) f |= uint32_t(st[m]) << (3 * m);
  sh.map[t] = f;
  __syncthreads();
  if (lane < kMStates) {
    int x = lane;
    for (int l = 0; l < 32; ++l) x = map_at(sh.map[w * 32 + l], x);
    sh.warp_fn[w][lane] = uint8_t(x);
  }
  __syncthreads();
}

// Phase 1: each CTA's composite over the 5 entry states, comp (B, ctas, 5).
__global__ void __launch_bounds__(kMThreads)
    merge_tiles(const uint8_t* __restrict__ s, int n, int* __restrict__ comp) {
  __shared__ MergeShared sh;
  const int b = blockIdx.y, cta = blockIdx.x, t = threadIdx.x;
  merge_build(sh, s, n, b, cta);
  if (t < kMStates) {
    int x = t;
    for (int w = 0; w < kMWarps; ++w) x = sh.warp_fn[w][x];
    comp[(static_cast<size_t>(b) * kMCtas + cta) * kMStates + t] = x;
  }
}

// Phase 2: one warp a stream walks its CTAs' composites from state 0; lane
// m < 5 holds the composite's value for state m, the walker's next state
// is a shuffle.  entry (B, ctas).
__global__ void __launch_bounds__(32)
    merge_entries(const int* __restrict__ comp, int* __restrict__ entry) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const int* c = comp + static_cast<size_t>(b) * kMCtas * kMStates;
  int st = 0;
  for (int k = 0; k < kMCtas; ++k) {
    const int val = lane < kMStates ? c[k * kMStates + lane] : 0;
    if (lane == 0) entry[b * kMCtas + k] = st;
    st = __shfl_sync(0xFFFFFFFFu, val, st);
  }
}

// Phase 3: the entries handed down to warps and tiles; each thread walks
// its 16 positions and the next tile's first 4 and writes positions
// [16 t + 4, 16 t + 20) of the stream (tile 0 also [0, 4)); the CTAs also
// copy the stream past 4 SZ.
__global__ void __launch_bounds__(kMThreads)
    merge_emit(const uint8_t* __restrict__ s, int n,
               const int* __restrict__ entry, uint8_t* __restrict__ out) {
  __shared__ MergeShared sh;
  const int b = blockIdx.y, cta = blockIdx.x, t = threadIdx.x;
  const int lane = t & 31, w = t >> 5;
  merge_build(sh, s, n, b, cta);
  if (t == 0) {
    int x = entry[b * kMCtas + cta];
    for (int k = 0; k < kMWarps; ++k) {
      sh.warp_entry[k] = uint8_t(x);
      x = sh.warp_fn[k][x];
    }
  }
  __syncthreads();
  if (lane == 0) {
    int x = sh.warp_entry[w];
    for (int l = 0; l < 32; ++l) {
      sh.entry[w * 32 + l] = uint8_t(x);
      x = map_at(sh.map[w * 32 + l], x);
    }
  }
  __syncthreads();
  const size_t base = static_cast<size_t>(b) * n;
  const int start = cta * kMSpan + t * kMT;
  const uint8_t* v = sh.v + t * kMT;
  uint32_t fires = 0;
  int st = sh.entry[t];
  for (int q = 0; q < kMT + 4; ++q) {
    bool fp;
    const int k = merge_k(sh.v, t * kMT + q, start + q, fp);
    if (st == 0) {
      fires |= uint32_t(fp) << q;
      st = k - 1;
    } else {
      --st;
    }
  }
  auto value = [&](int q) -> uint8_t {
    if (q >= 4 && ((fires >> (q - 4)) & 1)) return 201;
    if ((fires >> q) & 1)
      return v[q] == 136 ? (v[q + 4] == 136 ? 132 : 133)
                         : (v[q + 4] == 136 ? 134 : 135);
    return v[q];
  };
  for (int q = 4; q < kMT + 4; ++q)
    if (start + q < kMLen) out[base + start + q] = value(q);
  if (cta == 0 && t == 0)
    for (int q = 0; q < 4; ++q) out[base + q] = value(q);
  const int tail = n - kMLen;
  const int chunk = (tail + kMCtas - 1) / kMCtas;
  for (int i = t; i < chunk; i += kMThreads) {
    const int gi = kMLen + cta * chunk + i;
    if (gi < n) out[base + gi] = s[base + gi];
  }
}

bool misaligned(std::initializer_list<std::pair<const void*, int>> ptrs) {
  for (const auto& p : ptrs)
    if (reinterpret_cast<uintptr_t>(p.first) % p.second != 0) return true;
  return false;
}

}  // namespace

extern "C" {

// S1.  in, out: (B, 512, 512) int16; region rows [r0, r1), columns
// [col0, col1), col1 <= 512 (the spill write lands on column col1 when it
// is below 512).
int nhw_snap_pass(const void* in, void* out, int batch, int r0, int r1,
                  int col0, int col1, int thr, int yw, int yw2,
                  int second_rule, int snap_guard6, int gc, void* stream) {
  if (batch < 1 || batch > (1 << 21) || r0 < 0 || r0 >= r1 || r1 > kN ||
      col0 < 0 || col0 >= col1 || col1 > kN)
    return cudaErrorInvalidValue;
  if (misaligned({{in, 2}, {out, 2}})) return cudaErrorMisalignedAddress;
  const SnapArgs a{r0, r1, col0, col1, thr, yw, yw2, second_rule,
                   snap_guard6, gc};
  const int rows = batch * kN;
  snap_pass<<<(rows + kSnapThreads - 1) / kSnapThreads, kSnapThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(in), static_cast<int16_t*>(out), batch, a);
  return cudaGetLastError();
}

// S2.  in, tmp, out: (B, 512, 512) int16 (tmp holds passes 1-3); esc: (2,
// 19) int32 escape words.
int nhw_offset_y(const void* in, void* tmp, void* out, const void* esc,
                 int batch, int m1, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned({{in, 2}, {tmp, 2}, {out, 2}, {esc, 4}}))
    return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  auto* t = static_cast<int16_t*>(tmp);
  const int rows = batch * kN;
  offset_y_rows<<<(rows + kRowThreads - 1) / kRowThreads, kRowThreads, 0,
                  s>>>(static_cast<const int16_t*>(in), t, batch);
  offset_y_ll<<<batch, kD, 0, s>>>(t);
  const int total = batch * kPlane;
  offset_y_codes<<<(total + kCodeThreads - 1) / kCodeThreads, kCodeThreads,
                   0, s>>>(t, static_cast<int16_t*>(out),
                           static_cast<const int*>(esc), total, m1);
  return cudaGetLastError();
}

// S3.  in, out: (B, n) uint8, n >= 4 SZ; comp: (B, 64, 5) int32 and entry:
// (B, 64) int32 scratch.
int nhw_merge_crossing(const void* in, void* out, void* comp, void* entry,
                       int batch, int n, void* stream) {
  if (batch < 1 || batch > 65535 || n < kMLen) return cudaErrorInvalidValue;
  if (misaligned({{comp, 4}, {entry, 4}})) return cudaErrorMisalignedAddress;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* src = static_cast<const uint8_t*>(in);
  merge_tiles<<<dim3(kMCtas, batch), kMThreads, 0, s>>>(
      src, n, static_cast<int*>(comp));
  merge_entries<<<batch, 32, 0, s>>>(static_cast<const int*>(comp),
                                     static_cast<int*>(entry));
  merge_emit<<<dim3(kMCtas, batch), kMThreads, 0, s>>>(
      src, n, static_cast<const int*>(entry), static_cast<uint8_t*>(out));
  return cudaGetLastError();
}

}  // extern "C"
