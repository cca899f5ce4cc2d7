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
// - S7: a cluster of kYCtas CTAs an image, kYRows LL2 rows each.  A CTA
//   stages its rows and the kYHalo rows below them that the cross-row
//   tests read (rows up to 130), columns 0..135, with cp.async.  The
//   marking is a skip walk within a row over static windows (they read the
//   original parities: the marks are even), so a warp marks a staged row,
//   the halo rows too (rows past 127 stay unmarked): lane l composes the
//   4-state maps of the skip counter at its positions 4 l..4 l + 3, the
//   warp scans the lanes' maps with shuffles, and each lane walks its
//   positions again from its entry state (a fired window adds 24000, a
//   skipped position 16000).  Each band row's cross-row tests (rows r +
//   1..r + 3 before their nudges: a row only nudges the next one, at its
//   own column) are then static bits a lane.  The nudge scan is a warp a
//   band of kYBandRows rows in order, lane l on columns 4 l..4 l + 3: the
//   2a fire's +1 on the next column makes it even, so the fires are the
//   run parity of the static-in-row predicate (block_scan.cuh's
//   run_parity_lanes4), and the only carry between rows is pend, the 128
//   bits of the nudges into the next row, in registers.  Each band walks
//   from no pend, its exit is relayed to the band below (through DSM
//   across CTAs), and a band walks again while its entry changes, the
//   vote a flag a band pushed to every CTA before one cluster.sync() a
//   sweep (double-buffered by the sweep's parity): after s sweeps bands
//   0..s - 1 are exact, so kYBands sweeps at most.  vem and is24 collect
//   in shared memory and go out once, whole rows in 16-byte stores.
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

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>

#include "block_scan.cuh"
#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;
using nhw::iabs;
using nhw::misaligned;

constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kN = 512;
constexpr int kPlane = kN * kN;
constexpr int kLL = 128;            // the LL2 block's side
constexpr int kLLN = kLL * kLL;
constexpr int kYCtas = 8;                       // S7: a cluster an image
constexpr int kYRows = kLL / kYCtas;            // LL2 rows a CTA
constexpr int kYBandRows = 8;                   // rows a band, a warp each
constexpr int kYBands = kLL / kYBandRows;       // bands an image
constexpr int kYWalkers = kYRows / kYBandRows;  // bands a CTA
constexpr int kYThreads = 256;                  // the walkers and helpers
constexpr int kYHalo = 3;            // rows r + 1..r + 3 the tests read
constexpr int kYStage = kYRows + kYHalo;
constexpr int kYCols = 136;          // staged columns: the reads reach 129
constexpr int kYVecs = kYCols / 8;
constexpr int kYPitch = kLL + 4;     // marked values a row: columns 0..131

constexpr int kWalkThreads = 1024;
constexpr int kWalkAhead = 4;       // S8's loads in flight a thread
constexpr int kWalkMaxN = 1 << 16;  // jumps fit 16 bits
constexpr int kWalkMaxSegLog2 = 8;  // in-segment offsets fit 8 bits
constexpr int kWalkMaxSegs = 256;   // a thread a segment

// ---------------------------------------------------------------------------
// S7: the LL2 byte coding's marks and nudges (encoder/nhw_encoder.c:636-743,
// the host copy's nhw_ll2_code_y)

__device__ __forceinline__ int odd(int x) { return x & 1; }

// The skip walk's state maps: the skip counter (0..3) before a position to
// the counter after it, a byte a state (byte s: the image of s).  A match
// at counter 0 fires and leaves 3, else the counter counts down.
constexpr unsigned kSkipId = 0x03020100u;
constexpr unsigned kSkipHit = 0x02010003u;
constexpr unsigned kSkipMiss = 0x02010000u;

// "a then b": byte s of the result is byte a[s] of b, one byte permute
// with a's bytes packed as its nibble selector.
__device__ __forceinline__ unsigned compose4(unsigned a, unsigned b) {
  const unsigned x = (a | (a >> 4)) & 0x00FF00FFu;
  return __byte_perm(b, 0u, (x | (x >> 8)) & 0xFFFFu);
}

// What a CTA of S7 holds: its rows and the halo as staged (int16) and as
// marked (int32), each band row's cross-row tests (a byte a lane: bits 0-3
// the left rule's, 4-7 the other's), vem and is24 of its rows, and the
// relay: band 0's exit for band 1, the entry from the CTA above (DSM) and
// each band's "my exit changed" (DSM), by the sweep's parity.
struct Ll2Stage {
  int16_t raw[kYStage * kYCols];
  int m[kYStage * kYPitch];
  uint8_t tests[kYRows][32];
  int vem[kYRows * kLL];
  uint32_t is24[kYRows * 32];
  uint8_t exits[2][32];
  uint8_t entry_in[2][32];
  alignas(16) uint8_t changed[2][kYBands];
};

// Staged row k (plane row g) marked by a warp: a window of four odd values
// with |v[j] - v[j + 3]| > 1 at j < 125 fires where the skip counter is 0,
// adds 24000 at j and 16000 at j + 1..j + 3 (the skipped positions); rows
// past 127 and columns past 127 stay as they are.
__device__ __forceinline__ void mark_row(Ll2Stage& st, int k, int g,
                                         int lane, bool gt_low3) {
  const int16_t* x = st.raw + k * kYCols + 4 * lane;
  int xv[7];
#pragma unroll
  for (int i = 0; i < 7; ++i) xv[i] = x[i];
  int add[4] = {0, 0, 0, 0};
  if (gt_low3 && g < kLL) {
    unsigned match = 0, f = kSkipId;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * lane + i;
      const int hit = (j < kLL - 3) & odd(xv[i]) & odd(xv[i + 1]) &
                      odd(xv[i + 2]) & odd(xv[i + 3]) &
                      (iabs(xv[i] - xv[i + 3]) > 1);
      match |= unsigned(hit) << i;
      f = compose4(f, hit ? kSkipHit : kSkipMiss);
    }
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const unsigned g2 = __shfl_up_sync(kFull, f, d);
      if (lane >= d) f = compose4(g2, f);
    }
    const unsigned e = __shfl_up_sync(kFull, f, 1);
    int sk = lane ? static_cast<int>(e & 0xFFu) : 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const bool fire = sk == 0 && ((match >> i) & 1u);
      add[i] = fire ? 24000 : sk ? 16000 : 0;
      sk = fire ? 3 : max(sk - 1, 0);
    }
  }
  int* m = st.m + k * kYPitch + 4 * lane;
  *reinterpret_cast<int4*>(m) =
      make_int4(xv[0] + add[0], xv[1] + add[1], xv[2] + add[2],
                xv[3] + add[3]);
  if (lane == 31)
    *reinterpret_cast<int4*>(m + 4) = make_int4(xv[4], xv[5], xv[6], x[7]);
}

// Band row k's cross-row tests at lane l (plane row g): the nudge into row
// g + 1 needs odd marked values at (g + 1, j) and (g + 1, j + 1), the first
// under 10000, and then, for the left rule (g <= 126), an even (g + 1, j +
// 2), for the other (1 <= g <= 124), an odd (g + 2, j) and an even (g + 3,
// j).
__device__ __forceinline__ uint8_t row_tests(const Ll2Stage& st, int k,
                                             int g, int lane) {
  const int* n1 = st.m + (k + 1) * kYPitch + 4 * lane;
  const int* n2 = st.m + (k + 2) * kYPitch + 4 * lane;
  const int* n3 = st.m + (k + 3) * kYPitch + 4 * lane;
  const int ok2 = g <= kLL - 2, ok3 = (g >= 1) & (g <= kLL - 4);
  unsigned bits = 0;
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const int a = odd(n1[i]) & odd(n1[i + 1]) & (n1[i] < 10000);
    bits |= unsigned(a & ok2 & !odd(n1[i + 2])) << i;
    bits |= unsigned(a & ok3 & odd(n2[i]) & !odd(n3[i])) << (4 + i);
  }
  return static_cast<uint8_t>(bits);
}

// A warp's band (local rows k0.., plane rows from r0 + k0) from the entry
// pend (bit i of the lane: a nudge into position 4 lane + i of row k0); the
// rows' vem and is24 into the stage.  Returns the exit pend.
__device__ __forceinline__ unsigned ll2_band(Ll2Stage& st, int k0, int lane,
                                             int gt, unsigned pend) {
#pragma unroll 2
  for (int k = k0; k < k0 + kYBandRows; ++k) {
    const int* row = st.m + k * kYPitch;
    const int4 mv = *reinterpret_cast<const int4*>(row + 4 * lane);
    int c[6] = {mv.x + int(pend & 1u), mv.y + int((pend >> 1) & 1u),
                mv.z + int((pend >> 2) & 1u), mv.w + int((pend >> 3) & 1u),
                0, 0};
    const int up0 = __shfl_down_sync(kFull, c[0], 1);
    const int up1 = __shfl_down_sync(kFull, c[1], 1);
    // columns 128-129: never marked or nudged
    c[4] = lane == 31 ? row[kLL] : up0;
    c[5] = lane == 31 ? row[kLL + 1] : up1;
    unsigned f2a = 0;
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * lane + i;
      const int marked = gt & (c[i] > 10000);
      f2a |= unsigned(gt & !marked & odd(c[i]) & (j > 0) & odd(c[i + 1]) &
                      (j < kLL - 2) & odd(c[i + 2]) &
                      (iabs(c[i] - c[i + 2]) > 1))
             << i;
    }
    const unsigned fired = nhw::run_parity_lanes4(f2a, lane);
    const unsigned before = __shfl_up_sync(kFull, fired >> 3, 1) & 1u;
    const unsigned prev = ((fired << 1) | (lane ? before : 0u)) & 0xFu;
    const unsigned tests = st.tests[k][lane];
    unsigned next = 0, hi = 0;
    int o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int j = 4 * lane + i;
      const int v = c[i] + int((prev >> i) & 1u);
      const int marked = gt & (c[i] > 10000);
      const int left = (j > 0) & odd(c[i + 1]);
      const int rule = left ? !((j < kLL - 2) & odd(c[i + 2])) &
                                  int((tests >> i) & 1u)
                            : int((tests >> (4 + i)) & 1u);
      next |= unsigned(gt & !marked & odd(v) & rule) << i;
      const int h = gt & (v > 20000);
      hi |= unsigned(h) << (8 * i);
      o[i] = h ? v - 24000 : (gt & (v > 10000)) ? v - 16000 : v;
    }
    *reinterpret_cast<int4*>(st.vem + k * kLL + 4 * lane) =
        make_int4(o[0], o[1], o[2], o[3]);
    st.is24[k * 32 + lane] = hi;
    pend = next;
  }
  return pend;
}

__global__ void __launch_bounds__(kYThreads)
    ll2_code_y_bands(const int16_t* __restrict__ plane, int* __restrict__ vem,
                     uint8_t* __restrict__ is24, int gt_low3) {
  __shared__ __align__(16) Ll2Stage st;
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int r0 = rank * kYRows;
  const int16_t* img = plane + static_cast<size_t>(blockIdx.y) * kPlane;
  for (int i = t; i < kYStage * kYVecs; i += kYThreads)
    __pipeline_memcpy_async(st.raw + (i / kYVecs) * kYCols + (i % kYVecs) * 8,
                            img + (r0 + i / kYVecs) * kN + (i % kYVecs) * 8,
                            16);
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();
  const int gt = gt_low3 != 0;
  for (int k = w; k < kYStage; k += kYThreads / 32)
    mark_row(st, k, r0 + k, lane, gt);
  __syncthreads();
  for (int i = t; i < kYRows * 32; i += kYThreads)
    st.tests[i / 32][i % 32] = row_tests(st, i / 32, r0 + i / 32, i % 32);
  cluster.sync();        // staged and marked, every peer started
  const bool walks = w < kYWalkers;
  // the last band's exit nudges row 128, which is not coded
  const bool last = rank == kYCtas - 1 && w == kYWalkers - 1;
  const int k0 = w * kYBandRows;
  unsigned entry = 0, pend = 0, sent = 0;
  if (walks) pend = ll2_band(st, k0, lane, gt, 0u);
  for (int s = 0; s < kYBands; ++s) {
    const int par = s & 1;
    if (walks) {
      if (w < kYWalkers - 1)
        st.exits[par][lane] = static_cast<uint8_t>(pend);
      else if (rank < kYCtas - 1)
        *cluster.map_shared_rank(&st.entry_in[par][lane], rank + 1) =
            static_cast<uint8_t>(pend);
      // each band tells every CTA whether its exit changed
      const bool changed = !last && __any_sync(kFull, pend != sent);
      sent = pend;
      if (lane < kYCtas)
        *cluster.map_shared_rank(&st.changed[par][rank * kYWalkers + w],
                                 lane) = changed;
    }
    cluster.sync();
    const uint4 flags = *reinterpret_cast<const uint4*>(st.changed[par]);
    if (!(flags.x | flags.y | flags.z | flags.w)) break;
    const unsigned want = !walks ? 0u
                          : w > 0 ? st.exits[par][lane]
                          : rank > 0 ? st.entry_in[par][lane] : 0u;
    if (walks && __any_sync(kFull, want != entry)) {
      entry = want;
      pend = ll2_band(st, k0, lane, gt, entry);
    }
  }
  const size_t at = static_cast<size_t>(blockIdx.y) * kLLN + r0 * kLL;
  int4* vo = reinterpret_cast<int4*>(vem + at);
  const int4* vs = reinterpret_cast<const int4*>(st.vem);
  for (int i = t; i < kYRows * kLL / 4; i += kYThreads) vo[i] = vs[i];
  int4* io = reinterpret_cast<int4*>(is24 + at);
  const int4* is = reinterpret_cast<const int4*>(st.is24);
  for (int i = t; i < kYRows * kLL / 16; i += kYThreads) io[i] = is[i];
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
// bytes (torch.bool); all 16-byte aligned.
int nhw_ll2_code_y(const void* plane, void* vem, void* is24, int batch,
                   int gt_low3, void* stream) {
  if (batch < 1 || batch > 65535) return cudaErrorInvalidValue;
  if (misaligned(plane, 16) || misaligned(vem, 16) || misaligned(is24, 16))
    return cudaErrorMisalignedAddress;
  cudaLaunchAttribute dims = nhw::cluster_dims(kYCtas);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kYCtas, batch, 1);
  cfg.blockDim = dim3(kYThreads, 1, 1);
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, ll2_code_y_bands, static_cast<const int16_t*>(plane),
      static_cast<int*>(vem), static_cast<uint8_t*>(is24), gt_low3);
  return e != cudaSuccess ? e : cudaGetLastError();
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
