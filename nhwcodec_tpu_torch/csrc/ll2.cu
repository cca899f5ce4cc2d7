// Hand-written Hopper (sm_90a) kernels of the device encode scans' LL2
// stage.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins in
// nhwcodec_tpu_torch/models/device_scans.py (ll2_code_y_scan /
// ll2_code_y_ref, walk_visited_device / walk_visited_ref).
//
// S7 nhw_ll2_code_y replaces nhwcodec_tpu/models/device_scans.py:1899
//    ll2_code_y_device's serial part (an associative scan of the skip
//    walk and a 128-step lax.scan over rows, _ll2y_row :1855): the 4-run
//    odd marking and the nudge scan of ll2_code_y on a (B, 512, 512) int16
//    plane -> each LL2 position's value after its nudges and unmark (vem,
//    int32) and its 24000 mark (is24).  One launch.
// S8 nhw_walk_visited replaces nhwcodec_tpu/models/device_scans.py:1411
//    _walk_visited (pointer doubling: log2 n rounds of gather, scatter-max
//    and select): the visited mask of the walk start -> nxt[start] -> ...
//    over (B, n) int32 successors.  One launch.
//
// The bound of each is bytes: the LL2 rows read once, vem and is24 written
// once; the successors read once, the mask written once.  Both are chains
// of dependent steps, and the designs below are the simple exact ones, not
// yet tuned:
// - S7: one CTA an image.  The marking is a skip walk within a row (the
//   windows read the original parities: the marks are even), one thread a
//   row, its marks kept as codes in shared memory.  The nudge scan is one
//   thread a column over the 128 rows in order: a row's values after the
//   nudges from the row above go through shared memory (the reads at
//   j + 1, j + 2 reach plane columns 128-129, which the marking never
//   touches and nothing nudges); the 2a fire's +1 on the next column makes
//   it even, so the fires are the run parity of the static predicate (a
//   block max-scan of warp ballots, as S2's pair rule); the cross-row
//   tests read rows r + 1..r + 3 before their nudges (a row only nudges
//   the next one, at its own column), and the nudge into row r + 1 stays
//   in the thread's register.
// - S8: one CTA a stream.  The CTA stages the jumps nxt[i] - i as uint16
//   in shared memory (0 = the walk ends here: a successor >= n or one that
//   does not increase), one thread walks them marking visited bytes in
//   shared memory, and the CTA writes the mask out.  A row of n takes 3 n
//   bytes of shared memory, 192 KiB at n = 65536.

#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"

namespace {

using nhw::iabs;
using nhw::run_parity_block;

constexpr int kN = 512;
constexpr int kPlane = kN * kN;
constexpr int kLL = 128;            // the LL2 block's side; S7's threads
constexpr int kMarkPitch = kLL + 4; // bytes a row of S7's mark codes
constexpr int kLLN = kLL * kLL;

constexpr int kWalkThreads = 1024;
constexpr int kWalkMaxN = 1 << 16;  // jumps fit 16 bits
constexpr int kWalkSmemMax = 3 * kWalkMaxN;

// the jumps' room in S8's shared memory: n rounded up to 8
__host__ __device__ constexpr int walk_pitch(int n) { return (n + 7) & ~7; }

bool misaligned(const void* p, int bytes) {
  return reinterpret_cast<uintptr_t>(p) % bytes != 0;
}

// ---------------------------------------------------------------------------
// S7: the LL2 byte coding's marks and nudges (encoder/nhw_encoder.c:636-743,
// the host copy's nhw_ll2_code_y)

__device__ __forceinline__ bool odd(int x) { return x & 1; }

// The value at (row, col) after the marking and before any nudge: mark
// code 1 adds 24000, 2 adds 16000; rows and columns past 127 are unmarked.
__device__ __forceinline__ int marked_value(const int16_t* p,
                                            const uint8_t* marks, int row,
                                            int col) {
  const int v = p[row * kN + col];
  if (row >= kLL || col >= kLL) return v;
  const uint8_t m = marks[row * kMarkPitch + col];
  return v + (m == 1 ? 24000 : m == 2 ? 16000 : 0);
}

__global__ void __launch_bounds__(kLL)
    ll2_code_y(const int16_t* __restrict__ plane, int* __restrict__ vem,
               uint8_t* __restrict__ is24, int gt_low3) {
  __shared__ uint8_t marks[kLL * kMarkPitch];
  __shared__ int row_s[kLL + 4];     // this row's values, columns 0..130
  __shared__ uint8_t fire_s[kLL + 1]; // fire_s[j + 1]: column j fired 2a
  __shared__ int warp_last[kLL / 32];
  const int t = threadIdx.x;
  const int16_t* p = plane + static_cast<size_t>(blockIdx.x) * kPlane;
  int* vo = vem + static_cast<size_t>(blockIdx.x) * kLLN;
  uint8_t* io = is24 + static_cast<size_t>(blockIdx.x) * kLLN;

  // the 4-run odd marking: thread t walks row t
  uint8_t* m = marks + t * kMarkPitch;
  for (int j = 0; j < kLL; ++j) m[j] = 0;
  if (gt_low3) {
    const int16_t* row = p + t * kN;
    int j = 0;
    while (j < 125) {
      const int x0 = row[j], x3 = row[j + 3];
      if (odd(x0) && odd(row[j + 1]) && odd(row[j + 2]) && odd(x3) &&
          iabs(x0 - x3) > 1) {
        m[j] = 1;
        m[j + 1] = m[j + 2] = m[j + 3] = 2;
        j += 4;
      } else {
        ++j;
      }
    }
  }
  if (t == 0) fire_s[0] = 0;
  __syncthreads();

  // the nudge scan: thread j owns column j
  const int j = t;
  int pend = 0;
  for (int r = 0; r < kLL; ++r) {
    const int cur = marked_value(p, marks, r, j) + pend;
    row_s[j] = cur;
    if (j < 3) row_s[kLL + j] = p[r * kN + kLL + j];
    __syncthreads();
    const int c1 = row_s[j + 1], c2 = row_s[j + 2];
    const bool marked = gt_low3 && cur > 10000;
    const bool f2a = gt_low3 && !marked && odd(cur) && j > 0 && odd(c1) &&
                     j < 126 && odd(c2) && iabs(cur - c2) > 1;
    const bool fire = run_parity_block(f2a, warp_last);
    fire_s[j + 1] = fire;
    __syncthreads();
    const int v = cur + fire_s[j];
    int next = 0;
    if (gt_low3 && !marked && odd(v)) {
      const bool left = j > 0 && odd(c1);
      if (left ? !(j < 126 && odd(c2)) && r <= 126 : r >= 1 && r <= 124) {
        const int n0 = marked_value(p, marks, r + 1, j);
        const int n1 = marked_value(p, marks, r + 1, j + 1);
        if (odd(n0) && odd(n1) && n0 < 10000) {
          next = left ? !odd(marked_value(p, marks, r + 1, j + 2))
                      : odd(marked_value(p, marks, r + 2, j)) &&
                            !odd(marked_value(p, marks, r + 3, j));
        }
      }
    }
    pend = next;
    const bool hi = gt_low3 && v > 20000;
    vo[r * kLL + j] = hi ? v - 24000 : (gt_low3 && v > 10000 ? v - 16000 : v);
    io[r * kLL + j] = hi;
  }
}

// ---------------------------------------------------------------------------
// S8: the walk's visited mask

__global__ void __launch_bounds__(kWalkThreads)
    walk_visited(const int* __restrict__ nxt, uint8_t* __restrict__ visited,
                 int n, int start) {
  extern __shared__ __align__(16) uint8_t smem[];
  uint16_t* jump = reinterpret_cast<uint16_t*>(smem);
  uint8_t* vis = smem + 2 * walk_pitch(n);
  const int* row = nxt + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kWalkThreads) {
    const int s = row[i];
    jump[i] = (s > i && s < n) ? static_cast<uint16_t>(s - i) : 0;
    vis[i] = 0;
  }
  __syncthreads();
  if (threadIdx.x == 0) {
    int i = start;
    for (;;) {
      vis[i] = 1;
      const int d = jump[i];
      if (!d) break;
      i += d;
    }
  }
  __syncthreads();
  uint8_t* out = visited + static_cast<size_t>(blockIdx.x) * n;
  for (int i = threadIdx.x; i < n; i += kWalkThreads) out[i] = vis[i];
}

cudaError_t walk_visited_setup() {
  static const cudaError_t e = cudaFuncSetAttribute(
      walk_visited, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kWalkSmemMax);
  return e;
}

}  // namespace

extern "C" {

// S7.  plane: (B, 512, 512) int16; vem: (B, 16384) int32; is24: (B, 16384)
// bytes (torch.bool).
int nhw_ll2_code_y(const void* plane, void* vem, void* is24, int batch,
                   int gt_low3, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(plane, 2) || misaligned(vem, 4))
    return cudaErrorMisalignedAddress;
  ll2_code_y<<<batch, kLL, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(plane), static_cast<int*>(vem),
      static_cast<uint8_t*>(is24), gt_low3);
  return cudaGetLastError();
}

// S8.  nxt: (B, n) int32, 1 <= n <= 65536; visited: (B, n) bytes
// (torch.bool); 0 <= start < n.
int nhw_walk_visited(const void* nxt, void* visited, int batch, int n,
                     int start, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || n > kWalkMaxN || start < 0 ||
      start >= n)
    return cudaErrorInvalidValue;
  if (misaligned(nxt, 4)) return cudaErrorMisalignedAddress;
  const cudaError_t e = walk_visited_setup();
  if (e != cudaSuccess) return e;
  walk_visited<<<batch, kWalkThreads, 2 * walk_pitch(n) + n,
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), static_cast<uint8_t*>(visited), n,
      start);
  return cudaGetLastError();
}

}  // extern "C"
