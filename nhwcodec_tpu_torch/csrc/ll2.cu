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
//    over (B, n) int32 successors.  One launch, segmented walks.
//
// The bound of each is bytes: the LL2 rows read once, vem and is24 written
// once; the successors read once, the mask written once.  Both are chains
// of dependent steps:
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
// - S8: one CTA a row; the walk by segments, so that its serial depth no
//   longer grows with the path.  The CTA stages the jumps nxt[i] - i as
//   uint16 in shared memory (0 = the walk ends here: a successor >= n or
//   one that does not increase; no input can hang the walk).  The row is
//   cut into segments of s = 2^seg_log2 >= sqrt(n) nodes (at most 256 of
//   at most 256 nodes), thread g owning segment g.  (a) In one backward
//   pass over its segment, thread g finds each node's last node within
//   the segment on the walk from it (the node the walk leaves from, or
//   ends at), as an offset byte.  (b) Thread 0 follows the chain of
//   segment entries from `start`: entry -> its last node -> that node's
//   jump, at most one hop a segment, since the walk only moves forward.
//   (c) Thread g walks its segment from its entry, if it has one, and
//   marks the visited nodes; the bytes of (a) become the visited bytes.
//   Serial depth: s + segments + s steps, about 770 at n = 65536 against
//   the path's length.  Shared memory holds the jumps and one byte a node
//   (194 KiB at n = 65536), with no second jump table: the last-node
//   offsets fit a byte.  Each segment sits at an odd word pitch, so that
//   the lanes of a warp, at one offset of 32 segments, hit 32 banks.

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
constexpr int kWalkAhead = 4;       // S8's loads in flight a thread
constexpr int kWalkMaxN = 1 << 16;  // jumps fit 16 bits
constexpr int kWalkMaxSegLog2 = 8;  // in-segment offsets fit 8 bits
constexpr int kWalkMaxSegs = 256;   // a thread a segment

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
// S8: the walk's visited mask, by segments

// The jump staged for node i from its successor s: 0 (the walk ends) for
// a successor >= n or one that does not increase.
__device__ __forceinline__ uint16_t walk_jump(int s, int i, int n) {
  return (s > i && s < n) ? static_cast<uint16_t>(s - i) : 0;
}

// S8's shared memory for segments of s nodes: each segment's jumps at a
// pitch of s + 2 uint16 and its bytes at s + 4, so that the threads of a
// warp, one segment each, reach the same offset of their segments on 32
// banks (odd word pitches).
__host__ __device__ constexpr int walk_jump_pitch(int s) { return s + 2; }
__host__ __device__ constexpr int walk_byte_pitch(int s) { return s + 4; }
__host__ __device__ constexpr int walk_bytes_at(int segs, int s) {
  return (2 * segs * walk_jump_pitch(s) + 3) & ~3;
}
__host__ __device__ constexpr int walk_smem(int segs, int s) {
  return walk_bytes_at(segs, s) + segs * walk_byte_pitch(s);
}

__global__ void __launch_bounds__(kWalkThreads)
    walk_visited(const int* __restrict__ nxt, uint8_t* __restrict__ visited,
                 int n, int start, int seg_log2) {
  extern __shared__ __align__(16) uint8_t smem[];
  __shared__ int entry[kWalkMaxSegs];
  const int s = 1 << seg_log2, mask = s - 1;
  const int segs = ((n - 1) >> seg_log2) + 1;
  const int jp = walk_jump_pitch(s), bp = walk_byte_pitch(s);
  uint16_t* jump = reinterpret_cast<uint16_t*>(smem);
  // (a)-(b): the last node of each node's walk within its segment, as an
  // offset in the segment; (c): the visited bytes
  uint8_t* last = smem + walk_bytes_at(segs, s);
  const int t = threadIdx.x;
  // stage the jumps: 16-byte loads from the row's first aligned word, four
  // of them in flight a thread
  const int* row = nxt + static_cast<size_t>(blockIdx.x) * n;
  auto stage = [&](int i, int v) {
    jump[(i >> seg_log2) * jp + (i & mask)] = walk_jump(v, i, n);
  };
  const int head = min(
      n, static_cast<int>((16 - (reinterpret_cast<uintptr_t>(row) & 15)) &
                          15) / 4);
  const int nv = (n - head) / 4;
  const int4* row4 = reinterpret_cast<const int4*>(row + head);
  for (int v0 = t; v0 < nv; v0 += kWalkAhead * kWalkThreads) {
    int4 x[kWalkAhead];
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u) {
      const int v = v0 + u * kWalkThreads;
      if (v < nv) x[u] = row4[v];
    }
#pragma unroll
    for (int u = 0; u < kWalkAhead; ++u) {
      const int v = v0 + u * kWalkThreads;
      if (v < nv) {
        const int i = head + 4 * v;
        stage(i, x[u].x);
        stage(i + 1, x[u].y);
        stage(i + 2, x[u].z);
        stage(i + 3, x[u].w);
      }
    }
  }
  if (t < head) stage(t, row[t]);
  for (int i = head + 4 * nv + t; i < n; i += kWalkThreads) stage(i, row[i]);
  for (int g = t; g < segs; g += kWalkThreads) entry[g] = -1;
  __syncthreads();
  // (a) thread g, segment g of m nodes: every node's last in-segment node,
  // backward, branch-free, the jumps of eight nodes read ahead
  const int g = t;
  const int m = min(s, n - (g << seg_log2));
  uint16_t* jseg = jump + g * jp;
  uint8_t* lseg = last + g * bp;
  auto last_of = [&](int o, int d) {
    const int j = o + d, leave = (d == 0) | (j >= m);
    const int on = lseg[leave ? o : j];
    lseg[o] = static_cast<uint8_t>(leave ? o : on);
  };
  if (g < segs) {
    int o = m - 1;
    for (; o >= 2 * kWalkAhead - 1; o -= 2 * kWalkAhead) {
      int d[2 * kWalkAhead];
#pragma unroll
      for (int u = 0; u < 2 * kWalkAhead; ++u) d[u] = jseg[o - u];
#pragma unroll
      for (int u = 0; u < 2 * kWalkAhead; ++u) last_of(o - u, d[u]);
    }
    for (; o >= 0; --o) last_of(o, jseg[o]);
  }
  __syncthreads();
  // (b) the chain of segment entries: a walk leaves a segment from its
  // last node, and never comes back
  if (t == 0) {
    int i = start;
    for (;;) {
      const int sg = i >> seg_log2;
      entry[sg] = i;
      const int p = last[sg * bp + (i & mask)];
      const int d = jump[sg * jp + p];
      if (!d) break;
      i = (sg << seg_log2) + p + d;
    }
  }
  __syncthreads();
  // (c) the bytes cleared, then thread g walks segment g from its entry,
  // marking
  const int bytes = segs * bp;
  uint32_t* words = reinterpret_cast<uint32_t*>(last);
  for (int w = t; w < bytes / 4; w += kWalkThreads) words[w] = 0;
  if (t < bytes % 4) last[bytes / 4 * 4 + t] = 0;
  __syncthreads();
  if (g < segs) {
    const int i = entry[g];
    if (i >= 0) {
      for (int o = i - (g << seg_log2);;) {
        lseg[o] = 1;
        const int d = jseg[o];
        o += d;
        if (!d || o >= m) break;
      }
    }
  }
  __syncthreads();
  uint8_t* out = visited + static_cast<size_t>(blockIdx.x) * n;
#pragma unroll 4
  for (int i = t; i < n; i += kWalkThreads)
    out[i] = last[(i >> seg_log2) * bp + (i & mask)];
}

constexpr int kWalkSmemMax =
    walk_smem(kWalkMaxSegs, 1 << kWalkMaxSegLog2);   // 198,656 bytes

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
// (torch.bool); 0 <= start < n; segments of 2^seg_log2 nodes, at most
// kWalkMaxSegs of them and at most 256 nodes each.
int nhw_walk_visited(const void* nxt, void* visited, int batch, int n,
                     int start, int seg_log2, void* stream) {
  if (batch < 1 || batch > 65535 || n < 1 || n > kWalkMaxN || start < 0 ||
      start >= n || seg_log2 < 0 || seg_log2 > kWalkMaxSegLog2 ||
      ((n - 1) >> seg_log2) >= kWalkMaxSegs)
    return cudaErrorInvalidValue;
  if (misaligned(nxt, 4)) return cudaErrorMisalignedAddress;
  const cudaError_t e = walk_visited_setup();
  if (e != cudaSuccess) return e;
  walk_visited<<<batch, kWalkThreads,
                 walk_smem(((n - 1) >> seg_log2) + 1, 1 << seg_log2),
                 static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int*>(nxt), static_cast<uint8_t*>(visited), n,
      start, seg_log2);
  return cudaGetLastError();
}

}  // extern "C"
