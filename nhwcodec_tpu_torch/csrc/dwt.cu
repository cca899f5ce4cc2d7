// Hand-written Hopper (sm_90a) kernels for the synthesis kernels of the
// batched decode path.  Plain C interface, bound with ctypes by
// nhwcodec_tpu_torch/kernels/build.py; wrappers and torch twins live in
// nhwcodec_tpu_torch/ops/dwt.py.
//
// K1 nhw_synth_level replaces nhwcodec_tpu/ops/pallas_dwt.py
//    synth_level_pallas (_synth_level_kernel): one 2-D 5/3 synthesis
//    level, out = norm_rows(int16(unnorm_rows(x))^T), on (B, n, n) int16
//    with n in {128, 256, 512}, x a strided view.  One cluster launch.
// K2 nhw_y_stage2_full replaces pallas_dwt.py y_stage2_full_pallas
//    (_y_stage2_full_kernel): decode Y stage 2 without an HQ scatter -
//    un-normalised row pass + transpose, n_waves dering waves, normalised
//    row pass, clip to uint8, on (B, 512, 512).  One cluster launch.
// K3 nhw_uv_synth replaces pallas_dwt.py uv_synth_pallas
//    (_uv_synth_kernel): the whole chroma synthesis on (B, 256, 256).
//    One cluster launch.
// K7 nhw_synth_unnorm_rows_t replaces pallas_dwt.py
//    synth_unnorm_rows_t_pallas: the un-normalised row pass stored
//    transposed, on (B, n, n) with n in {128, 256, 512}, x a strided
//    view.  One launch of 64 x 32 tiles (unnorm_rows_t_tile).
// K8 nhw_synth_norm_rows_clip_waves replaces pallas_dwt.py:586
//    synth_norm_rows_clip_waves_pallas: K2's waves, normalised row pass
//    and clip alone, on a (B, 512, 512) transposed plane that the caller
//    has scattered the HQ residue into.  One launch of 32-row bands
//    (waves_band), a warp a row with K2's back end (waves_norm_clip_row).
// K9 nhw_synth_norm_rows_clip replaces pallas_dwt.py
//    synth_norm_rows_clip_pallas: the normalised row pass and the clip
//    (norm_rows below, with a uint8 store).
// nhw_smooth_marks_seq replaces the sequential mark scan of
//    nhwcodec_tpu/models/device_decode.py y_stage2_device (a lax.scan,
//    :126-148; host form native/hotpass.c nhw_smooth_marks), the decode's
//    fallback when same-row dering marks come out of column order.
//
// Bound.  Every kernel here is integer stencil work, 12-48 int32
// operations per element on 3-4 bytes moved: at the int32 issue rate
// (132 SMs x 64 lanes x 1.98 GHz) the operations bound K1-K3, K8 and K9
// and the bytes bound K7 (chip_smoke.py computes both for each call).
// A transposed store straight to global memory (2-byte writes 1 KiB
// apart, 32 sectors a warp) cost the first kernels 62-87% of their device
// time, so every transpose here goes through shared memory: the cluster
// kernels (K1-K3) keep the transposed plane in distributed shared memory
// because a next pass reads it there; K7's output must reach global
// memory, so it transposes one tile at a time in the CTA's own shared
// memory and stores whole 128-byte row segments.
//
// K9 (norm_rows) is one launch through global memory (L2), one block per
// (image, row) of the plane, one thread per output pair k: stage the row,
// compute the normalised pair, store the output row.
//
// The dering waves (K2, K8).  Marks lie only on even rows of the
// transposed plane, and a mark's stencil reads rows j-1 and j+1, which
// are odd and never written, so one warp finishes row j on its own once
// rows j-1, j, j+1 are in shared memory: waves_norm_clip_row runs each
// wave as a read phase, __syncwarp() and a masked write of row j.  Rows
// without marks skip the waves.  Row and column neighbours wrap modulo
// 512 like the reference's rolls.  The HQ scatter does not move marks,
// so the same argument holds for K8, and a band of rows needs only the
// rows on either side of it, read-only: K8 (waves_band) stages 32 rows
// and that halo (1/16 more reads), each warp finishing one even and one
// odd row.  K8 is bound by its operations (5.38 us at (16, 512,
// 512) with 8 waves on chip_smoke.py's inputs) with its bytes close
// behind (16 MiB, 5.0 us): the band reads every row of the plane once
// with 16-byte copies (plus the halo), each depth row with one 16-byte
// load a lane, and leaves as 16-byte stores; a warp's waves need no block
// barrier, and the 256 CTAs of batch 16 are resident at once, two an SM.
//
// Cluster kernels (K1, K2, K3): one launch, the plane in distributed shared
// memory (DSM; the helpers are in cluster.cuh).  A 512x512 int16 plane
// (512 KiB) does not fit one block's 227 KB, but a thread-block cluster of 8 CTAs holds it, 64 KiB
// of transposed rows each; K3's 256 plane is spread over 4 CTAs, because
// one CTA per plane would leave three quarters of the SMs idle at the
// pipeline's 32 chroma planes.  CTA c of an image's cluster stages its
// input rows in shared memory (cp.async, 16 bytes a copy), and a row pass
// stores each value through DSM (cluster.map_shared_rank) straight into
// the CTA that owns its transposed row: the transpose never reaches
// global memory, so only the input and the final plane cross HBM, and
// the launch count drops to one.  rows_to_peers_t gives each warp 16
// pairs k of two neighbouring source rows: a thread packs the two rows'
// values of one transposed row into one 32-bit store, the warp's 32
// stores all go to one CTA, and with a row pitch that is odd in 32-bit
// words they land on 32 distinct banks.  cluster.sync() separates the
// passes (and at the start, makes sure every peer runs before anyone
// writes to it).  The kernels stay near 100 KB of shared memory or less
// and at 64 registers a thread where 512-thread CTAs must pair, so two
// CTAs fit an SM: with one CTA an SM an H100 holds only 15 clusters of 8,
// and a batch of 16 images would take two waves.
//   K1 (synth_cluster) takes one cluster a plane, of the size in
//   kSynthShapes: 8 CTAs at n = 512 and 256, 4 at 128, so the paths'
//   (16, 256), (8, 256) and (16, 128) planes give 64-128 CTAs.  CTA c
//   stages its n / cluster rows of x (any plane and row stride that keeps
//   16-byte copies: the decode, K5 and the transform pass corner views
//   of 512 and 256 planes) by quarters through two buffers, at a word
//   pitch of 8 mod 32 so a warp's reads of four rows fall on four bank
//   groups; the un-normalised pass goes through DSM with K3's map; after
//   the cluster.sync() each CTA's transposed rows are complete, and their
//   normalised pass is K1's output rows (the output is the transposed
//   orientation), 32-bit stores, no second exchange.
//   K2 stages its 64 input rows in four quarters through two buffers,
//   each quarter's row pass overlapping the next one's copies.  Then each
//   warp finishes two even and two odd transposed rows with
//   waves_norm_clip_row, reading each row's depth (16-byte loads, the next
//   row's while this one is worked on).  Row j-1 of the CTA's first row
//   lies in the previous CTA (row 511 for row 0: the ranks wrap like the
//   reference's rolls) and is read there.  A last cluster.sync() keeps
//   every CTA's rows alive until no peer reads them.
//   K3 runs the pattern three times: the 128 LL level's row pass (CTA c
//   stages LL rows 32c..32c+31); its normalised pass plus the sentinel
//   deltas (summed while the rows load), stored transposed into the LL
//   block of the 256 plane's rows (the transpose-back), beside the other
//   quadrants with their sentinels cleared, which each CTA loaded for its
//   own 64 rows; the 256 level's row pass.  Its normalised pass writes
//   the int16 rows.
// What is left is the DSM stores (4-byte stores to 32 rows a warp;
// kernels/cluster_probe.py times them against stores to the CTA itself)
// and the row passes' integer work with 16 warps an SM.
// Each entry point sets the dynamic shared memory limit and asks
// cudaOccupancyMaxActiveClusters once; if no cluster fits it returns
// cudaErrorLaunchOutOfResources, and nothing falls back to other launches.
//
// The mark scan (mark_rows).  A record at LL (row, col) writes plane cell
// (2 row, col) and reads plane rows 2 row - 1 .. 2 row + 1 at columns col
// - 1 .. col + 1, flat: column 0's left cells are column 511 of the rows
// above, column 255's right cells column 256.  Records write only even
// rows at columns 0..255, so the odd rows, column 511 and column 256 are
// never written, and a record depends only on the earlier records of its
// own LL row (at col - 1, col and col + 1): rows are independent, and
// only each row's own order matters.  A CTA owns a band of kMsRows LL
// rows of one image (grid (256 / kMsRows, B): 128 CTAs at batch 16) and
// stages the 65 plane rows its records read, columns 0..256 and the left
// wraps, in shared memory.  It reads the image's records in chunks of
// kMsChunk, four rounds of a record a thread (coalesced, the next chunk's
// loads in flight during this one), and buckets the live records of its
// band by row in list order: a warp's ranks in a round by
// __match_any_sync, the counts by a prefix over the rounds' warps, the
// rows' offsets by a warp scan, four barriers a chunk and no other global
// load.  Then warp 0 walks: lane l takes LL row r0 + l, its chunk's
// records in order, each a dozen shared-memory reads issued a step ahead
// and a dozen operations; a record's cells take the step's write where it
// lands on them.  The band's touched rows go back in 16-byte stores.  The
// work per record is a few operations on 20 bytes, so what bounds the
// kernel is its latencies: the staging, a chunk's record loads and
// barriers, and the longest row's chain.

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "cluster.cuh"
#include "lifting.cuh"

namespace {

namespace cg = cooperative_groups;
using nhw::ClusterKernel;
using nhw::cluster_setup;
using nhw::launch_cluster;
using nhw::misaligned;
using nhw::pack16;
using nhw::rows_to_peers_t;
using nhw::stage_rows_async;

constexpr int kMaxN = 512;
constexpr int kY = 512;     // decode Y plane side
constexpr int kUV = 256;    // decode chroma plane side
constexpr int kLL = 128;    // chroma LL block side

// K7 as a tiled transpose: t[b][j][r] = unnorm_rows(x)[r][j].  A CTA owns
// kT7Rows source rows r0.. and kT7Pairs output pairs k0.. of one plane,
// i.e. the kT7Rows columns r0.. of transposed rows 2k0 .. 2k0 + 2kT7Pairs.
// Pair k reads L[k..k+1] and H[k-1..k+1] only (lifting.cuh), so the tile
// needs a one-value halo and no other CTA: no cluster.  Staged row r
// holds kT7LVecs 16-byte vectors of L from k0 (L[k0 + kT7Pairs] is the
// last one's first value) and kT7HVecs of H from k0 - 8 (H[k0 - 1] and
// H[k0 + kT7Pairs] are the first's last and the last's first value);
// vectors outside the row are not staged (k0 = 0, the last tile), and
// unnorm_pair's edges at k = 0 and m - 1 never read them.  Row pairs sit
// kT7PairPitch words apart, the odd row kT7OddRow words after the even
// one: 16-byte rows for cp.async, and 4 banks between row pairs, so a
// warp's reads of 8 even (or odd) rows at 4 k fall on distinct banks.
// The row pass uses the warp map of cluster.cuh's rows_to_peers_t with
// kStride 2 and kPairs 8, aimed at the CTA's own tile: a warp takes 4 k
// of 8 row pairs, each thread packs its two rows into a 32-bit store;
// with a transposed-row pitch of kT7TPitch = 4 mod 16 words the warp's 32
// stores fall on 32 banks, and the rows stay 16-byte aligned.  The tile leaves as 16-byte stores of
// whole 128-byte row segments.  grid (m / kT7Pairs, n / kT7Rows, B).
//   Tile sizes: 64 x 32 gives a 64 x 64 int16 output tile, 22,016 bytes
//   of shared memory and 256 threads, so 8 CTAs fit an SM (one wave of
//   1,024 CTAs at (16, 512, 512), 256 at (16, 256, 256)); the halo costs
//   11 staged vectors for 8 of the tile's own, and the neighbouring
//   tile's staging reads the same bytes from L2 (blockIdx.x, the k tile,
//   runs fastest).
constexpr int kT7Rows = 64;
constexpr int kT7Pairs = 32;
constexpr int kT7Threads = 256;
constexpr int kT7LVecs = 5;        // L[k0, k0 + 40)
constexpr int kT7HVecs = 6;        // H[k0 - 8, k0 + 40)
constexpr int kT7OddRow = 48;      // words
constexpr int kT7PairPitch = 100;  // words, 4 mod 32
constexpr int kT7TPitch = 36;      // words, 4 mod 16
constexpr int kT7Vecs = kT7LVecs + kT7HVecs;
static_assert(kT7LVecs == kT7Pairs / 8 + 1 && kT7HVecs == kT7Pairs / 8 + 2,
              "the tile's vectors and the halo's");
static_assert(4 * kT7Vecs <= kT7OddRow && kT7OddRow % 4 == 0 &&
                  kT7OddRow + 4 * kT7Vecs <= kT7PairPitch &&
                  kT7PairPitch % 32 == 4,
              "16-byte staged rows, row pairs 4 banks apart");
static_assert(kT7TPitch % 16 == 4 && 2 * kT7TPitch >= kT7Rows,
              "16-byte transposed rows, a warp's stores on 32 banks");
static_assert(kT7Rows / 2 % 8 == 0 && kT7Pairs % 4 == 0 &&
                  kT7Rows / 2 * kT7Pairs % kT7Threads == 0 &&
                  2 * kT7Pairs * kT7Rows / 8 % kT7Threads == 0,
              "whole warp tasks and whole output passes");

__global__ void __launch_bounds__(kT7Threads)
unnorm_rows_t_tile(const int16_t* __restrict__ x, size_t plane_stride,
                   int row_stride, int16_t* __restrict__ t, int n) {
  __shared__ __align__(16) uint32_t staged[kT7Rows / 2 * kT7PairPitch];
  __shared__ __align__(16) uint32_t tile[2 * kT7Pairs * kT7TPitch];
  const int m = n >> 1;
  const int k0 = blockIdx.x * kT7Pairs;
  const int r0 = blockIdx.y * kT7Rows;
  const size_t b = blockIdx.z;
  const int16_t* src =
      x + b * plane_stride + static_cast<size_t>(r0) * row_stride;
  const auto row_at = [&](int r) {   // staged row r as int16
    return reinterpret_cast<int16_t*>(staged + (r >> 1) * kT7PairPitch +
                                      (r & 1) * kT7OddRow);
  };

  for (int i = threadIdx.x; i < kT7Rows * kT7Vecs; i += kT7Threads) {
    const int r = i / kT7Vecs;
    const int v = i % kT7Vecs;
    const bool low = v < kT7LVecs;
    const int c = low ? k0 + 8 * v : k0 + 8 * (v - kT7LVecs - 1);
    if (c < 0 || c >= m) continue;
    __pipeline_memcpy_async(row_at(r) + 8 * v,
                            src + static_cast<size_t>(r) * row_stride +
                                (low ? c : m + c),
                            16);
  }
  __pipeline_commit();
  __pipeline_wait_prior(0);
  __syncthreads();

  // the row pass: warp task w takes k0 + 4 (w % 8) + (lane & 3) of row
  // pairs 8 (w / 8) + (lane >> 2)
#pragma unroll
  for (int it = 0; it < kT7Rows / 2 * kT7Pairs / kT7Threads; ++it) {
    const int g = threadIdx.x + it * kT7Threads;
    const int w = g >> 5;
    const int i = (w % (kT7Pairs / 4)) * 4 + (g & 3);
    const int rp = (w / (kT7Pairs / 4)) * 8 + ((g & 31) >> 2);
    int e[2], o[2];
#pragma unroll
    for (int s = 0; s < 2; ++s) {
      const int16_t* row = row_at(2 * rp + s);
      nhw::unnorm_pair_at(row, row + 8 * kT7LVecs + 8, m, k0 + i, i, e[s],
                          o[s]);
    }
    tile[2 * i * kT7TPitch + rp] = pack16(e[0], e[1]);
    tile[(2 * i + 1) * kT7TPitch + rp] = pack16(o[0], o[1]);
  }
  __syncthreads();

  int16_t* dst = t + b * n * n + static_cast<size_t>(2 * k0) * n + r0;
#pragma unroll
  for (int it = 0; it < 2 * kT7Pairs * kT7Rows / 8 / kT7Threads; ++it) {
    const int q = threadIdx.x + it * kT7Threads;
    const int j = q / (kT7Rows / 8);
    const int v = q % (kT7Rows / 8);
    *reinterpret_cast<uint4*>(dst + static_cast<size_t>(j) * n + 8 * v) =
        *reinterpret_cast<const uint4*>(tile + j * kT7TPitch + 4 * v);
  }
}

__device__ __forceinline__ uint8_t clip_u8(int v) {
  return static_cast<uint8_t>(v < 0 ? 0 : (v > 255 ? 255 : v));
}

// The normalised value of an un-normalised one, clipped to uint8 (the
// last pass of the Y decode).
__device__ __forceinline__ uint8_t norm_out(int t) {
  return clip_u8(nhw::norm_value(t));
}

// K9: normalised synthesis of row r of the contiguous (B, n, n) plane t
// into out.  grid (n, B), block n/2.
__global__ void norm_rows(const int16_t* __restrict__ t,
                          uint8_t* __restrict__ out, int n) {
  __shared__ int16_t row[kMaxN];
  const int m = n >> 1;
  const int k = threadIdx.x;
  const size_t base = (static_cast<size_t>(blockIdx.y) * n + blockIdx.x) * n;
  row[k] = t[base + k];
  row[k + m] = t[base + k + m];
  __syncthreads();
  int even, odd;
  nhw::unnorm_pair(row, row + m, m, k, even, odd);
  out[base + 2 * k] = norm_out(even);
  out[base + 2 * k + 1] = norm_out(odd);
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

// The back end of K2 and K8 for one row j of the transposed plane, by one
// warp: the dering waves on `mid` (row j, in shared memory), the
// normalised row pass and the clip into `out_row`.  up and dn are rows
// j-1 and j+1, which no wave writes while j is worked on (see above);
// `depth` is the row's depth bytes 16l .. 16l + 15 in lane l; `staged` is
// the warp's kRowScratch bytes of shared memory, 16-byte aligned, which
// hold the depth row, then the list of the row's marked cells, then the
// output row.  A row whose depth is all zero (every odd row, most even
// ones) skips the waves.  Otherwise its cells are compacted onto the
// lanes (a prefix sum over the lanes' counts), so with up to 32 marks a
// wave is one stencil a lane, __syncwarp() and a masked store; longer
// rows take 32 cells a pass.  Within a wave every read precedes every
// write.  The normalised pass and the clip fill a 512-byte row that
// leaves as 16-byte stores.
constexpr int kRowScratch = 4 * kY;   // a list of a whole row's cells

__device__ __forceinline__ void waves_norm_clip_row(
    const int16_t* up, int16_t* mid, const int16_t* dn, uint4 depth,
    uint8_t* staged, uint8_t* __restrict__ out_row, int n_waves, int lane) {
  uint32_t* cells = reinterpret_cast<uint32_t*>(staged);
  reinterpret_cast<uint4*>(staged)[lane] = depth;
  __syncwarp();
  // the lane's cells: 64 s + 2 lane + {0, 1}, s < 8
  uint32_t d[8];
  int row_depth = 0;
  int marked = 0;
#pragma unroll
  for (int s = 0; s < 8; ++s) {
    d[s] = reinterpret_cast<const uint16_t*>(staged)[32 * s + lane];
    row_depth = max(row_depth, static_cast<int>(max(d[s] & 255u, d[s] >> 8)));
    marked += ((d[s] & 255u) != 0) + ((d[s] >> 8) != 0);
  }
  row_depth = __reduce_max_sync(0xffffffffu, row_depth);
  const int last = n_waves < row_depth ? n_waves : row_depth;
  if (last > 0) {
    // the row's marked cells as a list, col | depth << 16, over the
    // depth bytes: lane l's cells after those of lanes 0..l-1
    int pos = marked;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
      const int below = __shfl_up_sync(0xffffffffu, pos, o);
      if (lane >= o) pos += below;
    }
    const int n = __shfl_sync(0xffffffffu, pos, 31);
    pos -= marked;
    __syncwarp();   // every lane's depth reads before the list
#pragma unroll
    for (int q = 0; q < 16; ++q) {
      const uint32_t dq = (q & 1) ? d[q >> 1] >> 8 : d[q >> 1] & 255u;
      if (dq != 0) cells[pos++] = (64 * (q >> 1) + 2 * lane + (q & 1)) | (dq << 16);
    }
    __syncwarp();
    if (n <= 32) {
      // one cell a lane: a wave is one stencil and a masked store
      const uint32_t cell = lane < n ? cells[lane] : 0;
      const int col = static_cast<int>(cell & 0xffffu);
      for (int r = 1; r <= last; ++r) {
        int val = 0;
        const bool take = static_cast<int>(cell >> 16) == r &&
                          wave_cell(up, mid, dn, col, val);
        __syncwarp();   // every read of this wave before any write
        if (take) mid[col] = static_cast<int16_t>(val);
        __syncwarp();
      }
    } else {
      // 32 cells a pass, up to 16 passes a wave
      for (int r = 1; r <= last; ++r) {
        int v[kY / 32];
        unsigned take = 0;
#pragma unroll
        for (int j = 0; j < kY / 32; ++j) {
          if (32 * j < n) {
            const uint32_t cell =
                32 * j + lane < n ? cells[32 * j + lane] : 0;
            int val = 0;
            if (static_cast<int>(cell >> 16) == r &&
                wave_cell(up, mid, dn, static_cast<int>(cell & 0xffffu),
                          val))
              take |= 1u << j;
            v[j] = val;
          }
        }
        __syncwarp();
#pragma unroll
        for (int j = 0; j < kY / 32; ++j)
          if ((take >> j) & 1u)
            mid[cells[32 * j + lane] & 0xffffu] = static_cast<int16_t>(v[j]);
        __syncwarp();
      }
    }
  }
#pragma unroll
  for (int s = 0; s < kY / 64; ++s) {
    const int k = lane + 32 * s;
    int even, odd;
    nhw::unnorm_pair(mid, mid + kY / 2, kY / 2, k, even, odd);
    reinterpret_cast<uint16_t*>(staged)[k] = static_cast<uint16_t>(
        norm_out(even) | (norm_out(odd) << 8));
  }
  __syncwarp();
  reinterpret_cast<uint4*>(out_row)[lane] =
      reinterpret_cast<const uint4*>(staged)[lane];
  __syncwarp();
}

// K8 as row bands: grid (kY / kW8Rows, B), kW8Threads threads.  CTA x
// owns rows j0 = kW8Rows x .. j0 + kW8Rows - 1 of plane blockIdx.y and
// stages rows j0 - 1 .. j0 + kW8Rows (modulo 512: the first band's row
// above is 511, the last band's row below is 0) with 16-byte cp.async
// copies, staged row s = j0 - 1 + s; no wave writes the halo rows (the
// one above is odd, the one below is read by no wave, since the band's
// last row is odd).  Warp w finishes rows j0 + kW8RowsPerWarp w onwards,
// one even and one odd, reading the second row's depth while the first
// is worked on.  67,584 bytes of shared memory and at most 64 registers:
// two CTAs an SM, so the 256 CTAs of batch 16 are all resident at once.
constexpr int kW8Rows = 32;
constexpr int kW8Threads = 512;
constexpr int kW8Warps = kW8Threads / 32;
constexpr int kW8RowsPerWarp = kW8Rows / kW8Warps;
constexpr int kW8Smem = 2 * (kW8Rows + 2) * kY + kW8Warps * kRowScratch;
static_assert(kY % kW8Rows == 0 && kW8Rows % 2 == 0 &&
                  kW8RowsPerWarp == 2,
              "whole bands of even rows, one even and one odd row a warp");

__global__ void __launch_bounds__(kW8Threads, 2)
waves_band(const int16_t* __restrict__ t, const uint8_t* __restrict__ depth,
           uint8_t* __restrict__ out, int n_waves) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* rows = reinterpret_cast<int16_t*>(smem);
  const int j0 = blockIdx.x * kW8Rows;
  const size_t b = blockIdx.y;
  const int16_t* plane = t + b * kY * kY;
  for (int i = threadIdx.x; i < (kW8Rows + 2) * (kY / 8); i += kW8Threads) {
    const int s = i / (kY / 8);
    const int v = i % (kY / 8);
    const int j = (j0 - 1 + s) & (kY - 1);
    __pipeline_memcpy_async(rows + s * kY + 8 * v,
                            plane + static_cast<size_t>(j) * kY + 8 * v, 16);
  }
  __pipeline_commit();
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const int lr0 = warp * kW8RowsPerWarp;
  const uint8_t* depth_rows = depth + (b * kY + j0 + lr0) * kY;
  uint8_t* staged = smem + 2 * (kW8Rows + 2) * kY + warp * kRowScratch;
  uint4 next = __ldg(reinterpret_cast<const uint4*>(depth_rows) + lane);
  __pipeline_wait_prior(0);
  __syncthreads();   // every thread's copies are in
  for (int i = 0; i < kW8RowsPerWarp; ++i) {
    int16_t* mid = rows + (lr0 + i + 1) * kY;
    const uint4 cur = next;
    if (i + 1 < kW8RowsPerWarp)
      next = __ldg(reinterpret_cast<const uint4*>(depth_rows + (i + 1) * kY) +
                   lane);
    waves_norm_clip_row(mid - kY, mid, mid + kY, cur, staged,
                        out + (b * kY + j0 + lr0 + i) * kY, n_waves, lane);
  }
}

cudaError_t waves_band_setup() {
  static const cudaError_t e = cudaFuncSetAttribute(
      waves_band, cudaFuncAttributeMaxDynamicSharedMemorySize, kW8Smem);
  return e;
}

// The mark scan (see the header): a band of kMsRows LL rows a CTA.  Its
// plane rows 2 r0 - 1 .. 2 r0 + 2 kMsRows - 1 are staged at kMsPitch int16
// a row: kMsCol0 + c holds column c (0..256), kMsCol0 - 1 the flat left
// wrap (the row above's column 511); an odd word pitch, so that the walk's
// lanes, a row each, spread over the banks.
constexpr int kMsRows = 32;
constexpr int kMsThreads = 256;
constexpr int kMsWarps = kMsThreads / 32;
constexpr int kMsPer = 4;                       // records a thread a chunk
constexpr int kMsChunk = kMsThreads * kMsPer;   // records a chunk
constexpr int kMsPitch = 274;
constexpr int kMsCol0 = 2;
constexpr int kMsStaged = 2 * kMsRows + 1;   // plane rows a CTA stages
constexpr int kMsStage = (kMsStaged * 32 + kMsThreads - 1) / kMsThreads;

struct MarkShared {
  int16_t even[kMsRows * kMsPitch];        // plane rows 2 (r0 + i)
  int16_t odd[(kMsRows + 1) * kMsPitch];   // plane rows 2 (r0 + i) - 1
  uint8_t col[kMsChunk + 4];     // a chunk's kept records' columns by row
                                 // (+4: a row with none reads its first)
  int cnt[kMsPer * kMsWarps][kMsRows];   // a (round, warp)'s kept records
                                         // a row, then the earlier ones'
  int off[kMsRows], n[kMsRows];  // a row's first entry and its count
  unsigned touched;              // rows with records
};

// grid (256 / kMsRows, B), kMsThreads threads.  x (B, 512, 512) int16,
// 16-byte aligned, in place; recs, valid (B, k).  Records with valid 0 or
// a row outside 1..255 write nothing.
__global__ void __launch_bounds__(kMsThreads)
    mark_rows(int16_t* __restrict__ x, const int32_t* __restrict__ recs,
              const uint8_t* __restrict__ valid, int k) {
  __shared__ __align__(16) MarkShared sh;
  const int t = threadIdx.x, lane = t & 31, w = t >> 5;
  const int r0 = blockIdx.x * kMsRows;
  int16_t* p = x + static_cast<size_t>(blockIdx.y) * kY * kY;
  const int32_t* rec = recs + static_cast<size_t>(blockIdx.y) * k;
  const uint8_t* ok = valid + static_cast<size_t>(blockIdx.y) * k;
  // round u of a chunk takes its records u kMsThreads + t
  int nr[kMsPer];
  bool nok[kMsPer];
#pragma unroll
  for (int u = 0; u < kMsPer; ++u) {
    const int i = u * kMsThreads + t;
    nr[u] = i < k ? __ldg(rec + i) : 0;
    nok[u] = i < k && __ldg(ok + i) != 0;
  }
  // staged row s is plane row 2 r0 - 1 + s (the one before plane row 0
  // is never read: LL row 0 is never walked)
  auto staged = [&](int s) {
    return (s & 1 ? sh.even : sh.odd) + (s >> 1) * kMsPitch + kMsCol0;
  };
  // every load in flight before the first store
  uint4 q[kMsStage];
#pragma unroll
  for (int u = 0; u < kMsStage; ++u) {
    const int i = t + u * kMsThreads, pr = 2 * r0 - 1 + (i >> 5);
    q[u] = i < kMsStaged * 32 && pr >= 0
               ? *reinterpret_cast<const uint4*>(p + pr * kY + 8 * (i & 31))
               : make_uint4(0, 0, 0, 0);
  }
#pragma unroll
  for (int u = 0; u < kMsStage; ++u) {
    const int i = t + u * kMsThreads;
    if (i < kMsStaged * 32) {
      uint32_t* d = reinterpret_cast<uint32_t*>(staged(i >> 5) + 8 * (i & 31));
      d[0] = q[u].x;
      d[1] = q[u].y;
      d[2] = q[u].z;
      d[3] = q[u].w;
    }
  }
  if (t < kMsStaged && 2 * r0 - 1 + t >= 0) {
    const int pr = 2 * r0 - 1 + t;
    staged(t)[-1] = pr > 0 ? p[pr * kY - 1] : 0;
    staged(t)[256] = p[pr * kY + 256];
  }
  bool touched = false;
  for (int base = 0; base < k; base += kMsChunk) {
    int r[kMsPer], lr[kMsPer], rank[kMsPer];
    bool keep[kMsPer];
#pragma unroll
    for (int u = 0; u < kMsPer; ++u) {
      r[u] = nr[u];
      lr[u] = (r[u] >> 8) - r0;
      keep[u] = nok[u] & (r[u] >= 256) & (r[u] < 65536) & (lr[u] >= 0) &
                (lr[u] < kMsRows);
      const int i = base + kMsChunk + u * kMsThreads + t;
      nr[u] = i < k ? __ldg(rec + i) : 0;
      nok[u] = i < k && __ldg(ok + i) != 0;
    }
#pragma unroll
    for (int u = 0; u < kMsPer; ++u) {
      const unsigned peers =
          __match_any_sync(0xFFFFFFFFu, keep[u] ? lr[u] : -1);
      rank[u] = __popc(peers & ((1u << lane) - 1u));
      int* cnt = sh.cnt[u * kMsWarps + w];
      cnt[lane] = 0;
      __syncwarp();
      if (keep[u] & (rank[u] == 0)) cnt[lr[u]] = __popc(peers);
    }
    __syncthreads();
    if (w == 0) {
      int run = 0;
#pragma unroll
      for (int v = 0; v < kMsPer * kMsWarps; ++v) {
        const int c = sh.cnt[v][lane];
        sh.cnt[v][lane] = run;
        run += c;
      }
      int incl = run;
#pragma unroll
      for (int d = 1; d < 32; d <<= 1) {
        const int y = __shfl_up_sync(0xFFFFFFFFu, incl, d);
        incl += lane >= d ? y : 0;
      }
      sh.off[lane] = incl - run;
      sh.n[lane] = run;
    }
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kMsPer; ++u)
      if (keep[u])
        sh.col[sh.off[lr[u]] + sh.cnt[u * kMsWarps + w][lr[u]] + rank[u]] =
            static_cast<uint8_t>(r[u] & 255);
    __syncthreads();
    if (w == 0) {
      // lane = the band's row; its records in list order.  The next
      // record's cells are read before this one's store and take its
      // value where they are its cell, so a step's chain is its
      // arithmetic, not a load after a store.
      const int n = sh.n[lane];
      const uint8_t* e = sh.col + sh.off[lane];
      int16_t* row = sh.even + lane * kMsPitch + kMsCol0;
      const int16_t* up = sh.odd + lane * kMsPitch + kMsCol0;
      const int16_t* dn = up + kMsPitch;
      const int most = __reduce_max_sync(0xFFFFFFFFu, n);
      int cur = e[0], nxt = e[n > 1 ? 1 : 0];
      // the six odd-row cells of a record's stencil and their middle two
      auto six = [&](int c) {
        return up[c - 1] + up[c] + up[c + 1] + dn[c - 1] + dn[c] + dn[c + 1];
      };
      int le = row[cur - 1], c = row[cur], ri = row[cur + 1];
      int s6 = six(cur), ud = up[cur] + dn[cur];
      for (int m = 0; m < most; ++m) {
        const int after = e[max(0, min(m + 2, n - 1))];   // in the row
        const int le2 = row[nxt - 1], c2 = row[nxt], ri2 = row[nxt + 1];
        const int s62 = six(nxt), ud2 = up[nxt] + dn[nxt];
        const int res = 8 * c - le - ri - s6;
        const int v = (res < 0 ? -res : res) < 116
                          ? (4 * c + le + ri + ud + 4) >> 3
                          : c;
        if (m < n) row[cur] = static_cast<int16_t>(v);
        const int d = nxt - cur;
        le = d == 1 ? v : le2;
        c = d == 0 ? v : c2;
        ri = d == -1 ? v : ri2;
        s6 = s62;
        ud = ud2;
        cur = nxt;
        nxt = after;
      }
      touched |= n > 0;
    }
    __syncthreads();   // the counts and the bucket are the next chunk's
  }
  if (w == 0) {
    const unsigned m = __ballot_sync(0xFFFFFFFFu, touched);
    if (lane == 0) sh.touched = m;
  }
  __syncthreads();
  const unsigned m = sh.touched;
  for (int i = t; i < kMsRows * 32; i += kMsThreads) {
    const int row = i >> 5, v = i & 31;
    if (!((m >> row) & 1u)) continue;
    const uint32_t* d = reinterpret_cast<const uint32_t*>(
        sh.even + row * kMsPitch + kMsCol0 + 8 * v);
    *reinterpret_cast<uint4*>(p + 2 * (r0 + row) * kY + 8 * v) =
        make_uint4(d[0], d[1], d[2], d[3]);
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

__device__ __forceinline__ int clear_sentinel(int v) {
  return v >= 5003 && v <= 5006 ? 0 : v;
}

__device__ __forceinline__ uint32_t clear_pair(uint32_t w) {
  return pack16(clear_sentinel(static_cast<int16_t>(w & 0xffffu)),
                clear_sentinel(static_cast<int16_t>(w >> 16)));
}

// K2 as one cluster launch: grid (8, B), cluster (8, 1, 1), one cluster
// per image; CTA c owns rows 64c..64c+63 of the transposed plane.
constexpr int kY2Cluster = 8;
constexpr int kY2Rows = kY / kY2Cluster;
constexpr int kY2Threads = 512;
constexpr int kY2Warps = kY2Threads / 32;
constexpr int kY2Quarter = kY2Rows / 4;
constexpr int kY2InPitch = kY + 32;  // 272 words: rows r, r+1 16 banks apart
constexpr int kY2TPitch = kY + 2;    // 257 words: odd
constexpr int kY2Smem = 2 * (kY2Rows * kY2TPitch + 2 * kY2Quarter * kY2InPitch);
// after the row pass the staging buffers give each warp the scratch of
// waves_norm_clip_row
constexpr int kY2WarpBytes = 2 * kY2Quarter * kY2InPitch * 2 / kY2Warps;
static_assert(kY2WarpBytes >= kRowScratch && kY2WarpBytes % 16 == 0,
              "a list of a whole row's cells per warp, 16-byte aligned");

__global__ void __launch_bounds__(kY2Threads, 2)
y_stage2_cluster(const int16_t* __restrict__ jp,
                 const uint8_t* __restrict__ depth, uint8_t* __restrict__ out,
                 int n_waves) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* t = reinterpret_cast<int16_t*>(smem);
  int16_t* in = t + kY2Rows * kY2TPitch;        // two quarter buffers
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int16_t* src = jp + (b * kY + static_cast<size_t>(kY2Rows) * c) * kY;

  // 1-2. the un-normalised row pass over the CTA's 64 rows, quarter by
  // quarter, stored transposed into the owners
  for (int q = 0; q < 2; ++q)
    stage_rows_async<kY, kY2InPitch, kY2Threads>(
        in + q * kY2Quarter * kY2InPitch, src + q * kY2Quarter * kY, kY,
        kY2Quarter);
  cluster.sync();   // every peer runs before anyone writes to it
  for (int q = 0; q < 4; ++q) {
    if (q < 3) __pipeline_wait_prior(1); else __pipeline_wait_prior(0);
    __syncthreads();   // quarter q is in, from every thread's copies
    const int16_t* buf = in + (q & 1) * kY2Quarter * kY2InPitch;
    rows_to_peers_t<kY2Quarter, kY / 2, kY2Rows, kY2TPitch, kY2Threads, 2, 1,
                    2>(
        cluster, kY2Rows * c + kY2Quarter * q, t,
        [&](int r, int k, int& even, int& odd) {
          const int16_t* row = buf + r * kY2InPitch;
          nhw::unnorm_pair(row, row + kY / 2, kY / 2, k, even, odd);
        });
    __syncthreads();   // every read of the buffer before it is refilled
    if (q < 2)
      stage_rows_async<kY, kY2InPitch, kY2Threads>(
          in + (q & 1) * kY2Quarter * kY2InPitch,
          src + (q + 2) * kY2Quarter * kY, kY, kY2Quarter);
  }
  // 3-5. one warp per transposed row (two even and two odd rows each):
  // waves_norm_clip_row.  The first row's depth is read before the
  // barrier, each next one while the current one is worked on.
  const int warp = tid >> 5;
  const int lane = tid & 31;
  const int lr0 = warp * (kY2Rows / kY2Warps);
  const uint8_t* depth_rows = depth + (b * kY + kY2Rows * c + lr0) * kY;
  uint4 next = __ldg(reinterpret_cast<const uint4*>(depth_rows) + lane);
  cluster.sync();
  const int16_t* up_peer = cluster.map_shared_rank(
      t + (kY2Rows - 1) * kY2TPitch, (c + kY2Cluster - 1) % kY2Cluster);
  const int16_t* dn_peer = cluster.map_shared_rank(t, (c + 1) % kY2Cluster);
  uint8_t* staged = reinterpret_cast<uint8_t*>(in) + warp * kY2WarpBytes;
  for (int i = 0; i < kY2Rows / kY2Warps; ++i) {
    const int lr = lr0 + i;
    int16_t* mid = t + lr * kY2TPitch;
    const int16_t* up = lr == 0 ? up_peer : mid - kY2TPitch;
    const int16_t* dn = lr == kY2Rows - 1 ? dn_peer : mid + kY2TPitch;
    const uint4 cur = next;
    if (i + 1 < kY2Rows / kY2Warps)
      next = __ldg(reinterpret_cast<const uint4*>(depth_rows + (i + 1) * kY) +
                   lane);
    waves_norm_clip_row(up, mid, dn, cur, staged,
                        out + (b * kY + kY2Rows * c + lr) * kY, n_waves, lane);
  }
  cluster.sync();   // no peer reads this CTA's rows after it exits
}

// K3 as one cluster launch: grid (4, B), cluster (4, 1, 1), one cluster
// per chroma plane; CTA c owns LL rows 32c..32c+31 for the 128 level and
// rows 64c..64c+63 of the 256 plane.  The sentinel deltas of its LL rows
// are summed while the rows load, so the transpose-back reads them from
// shared memory.
constexpr int kUVCluster = 4;
constexpr int kUVRows = kUV / kUVCluster;
constexpr int kLLRows = kLL / kUVCluster;
constexpr int kUVThreads = 512;
constexpr int kXllPitch = kLL + 32;  // 80 words: rows r, r+1 16 banks apart
constexpr int kT1Pitch = kLL + 34;   // 81 words: odd, rows 17 banks apart
constexpr int kJpPitch = kUV + 34;   // 145 words: the same
constexpr int kT2Pitch = kUV + 2;    // 129 words: odd
constexpr int kUVSmem = 2 * (kLLRows * (kXllPitch + kT1Pitch) +
                             kUVRows * (kJpPitch + kT2Pitch)) +
                        kLLRows * kLL;   // int8 deltas
static_assert(kLLRows * kLL / 8 == kUVThreads, "one delta task per thread");

__global__ void __launch_bounds__(kUVThreads, 2)
uv_synth_cluster(const int16_t* __restrict__ x, int16_t* __restrict__ out) {
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* xll = reinterpret_cast<int16_t*>(smem);   // LL rows, 128 level
  int16_t* t1 = xll + kLLRows * kXllPitch;           // its transposed rows
  int16_t* jp = t1 + kLLRows * kT1Pitch;             // rows of the 256 plane
  int16_t* t2 = jp + kUVRows * kJpPitch;             // its transposed rows
  int8_t* delta = reinterpret_cast<int8_t*>(t2 + kUVRows * kT2Pitch);
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.y;
  const int tid = threadIdx.x;
  const int16_t* X = x + b * kUV * kUV;

  stage_rows_async<kLL, kXllPitch, kUVThreads>(
      xll, X + kLLRows * c * kUV, kUV, kLLRows);
  // the 256 plane's rows outside the LL block, sentinels cleared (the LL
  // block comes from the transpose-back below)
  constexpr int kVecs = kUVRows * kUV / 8 / kUVThreads;
  uint4 v[kVecs];
#pragma unroll
  for (int it = 0; it < kVecs; ++it) {
    const int i = tid + it * kUVThreads;
    v[it] = __ldg(reinterpret_cast<const uint4*>(X + kUVRows * c * kUV) + i);
  }
  // the sentinel deltas that land on LL row R = 32c + tid / 16, columns
  // 8 (tid % 16) onwards: the three bands' own values there and their
  // pair deltas from one column to the left; column 127's pair delta
  // would land on column 128, outside the block, and is dropped
  // (pallas_dwt.py:353-364)
  {
    const int R = kLLRows * c + tid / 16;
    const int C = 8 * (tid % 16);
    const int16_t* band[3] = {X + R * kUV + kLL + C, X + (kLL + R) * kUV + C,
                              X + (kLL + R) * kUV + kLL + C};
    uint4 own[3];
    int left = 0;
#pragma unroll
    for (int i = 0; i < 3; ++i) {
      own[i] = __ldg(reinterpret_cast<const uint4*>(band[i]));
      if (C > 0) left += pair_delta(__ldg(band[i] - 1));
    }
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      int d = left;
      left = 0;
#pragma unroll
      for (int i = 0; i < 3; ++i) {
        const uint32_t w = j < 2 ? own[i].x : j < 4 ? own[i].y
                         : j < 6 ? own[i].z : own[i].w;
        const int e = static_cast<int16_t>((j & 1) ? w >> 16 : w & 0xffffu);
        d += pair_delta(e) + single_delta(e);
        left += pair_delta(e);
      }
      delta[(tid / 16) * kLL + C + j] = static_cast<int8_t>(d);
    }
  }
#pragma unroll
  for (int it = 0; it < kVecs; ++it) {
    const int i = tid + it * kUVThreads;
    const int r = i / (kUV / 8);
    const int q = i % (kUV / 8);
    if (kUVRows * c + r < kLL && q < kLL / 8) continue;
    uint32_t* d = reinterpret_cast<uint32_t*>(jp + r * kJpPitch + 8 * q);
    d[0] = clear_pair(v[it].x);
    d[1] = clear_pair(v[it].y);
    d[2] = clear_pair(v[it].z);
    d[3] = clear_pair(v[it].w);
  }
  __pipeline_wait_prior(0);
  cluster.sync();

  // the 128 level's un-normalised row pass
  rows_to_peers_t<kLLRows, kLL / 2, kLLRows, kT1Pitch, kUVThreads, 2, 1, 2>(
      cluster, kLLRows * c, t1, [&](int r, int k, int& even, int& odd) {
        const int16_t* row = xll + r * kXllPitch;
        nhw::unnorm_pair(row, row + kLL / 2, kLL / 2, k, even, odd);
      });
  cluster.sync();

  // its normalised pass (LL row R = 32c + r) plus the sentinel deltas,
  // transposed back into the 256 plane: proc[R][C] -> row C, column R
  rows_to_peers_t<kLLRows, kLL / 2, kUVRows, kJpPitch, kUVThreads, 2, 1, 2>(
      cluster, kLLRows * c, jp, [&](int r, int k, int& even, int& odd) {
        const int16_t* row = t1 + r * kT1Pitch;
        int ue, uo;
        nhw::unnorm_pair(row, row + kLL / 2, kLL / 2, k, ue, uo);
        even = nhw::wrap16(nhw::norm_value(ue) + delta[r * kLL + 2 * k]);
        odd = nhw::wrap16(nhw::norm_value(uo) + delta[r * kLL + 2 * k + 1]);
      });
  cluster.sync();

  // the 256 level's un-normalised row pass
  rows_to_peers_t<kUVRows, kUV / 2, kUVRows, kT2Pitch, kUVThreads, 2, 1, 2>(
      cluster, kUVRows * c, t2, [&](int r, int k, int& even, int& odd) {
        const int16_t* row = jp + r * kJpPitch;
        nhw::unnorm_pair(row, row + kUV / 2, kUV / 2, k, even, odd);
      });
  cluster.sync();   // also the last access to any peer

  // its normalised pass: int16 rows 64c.. of out, 32-bit stores
  uint32_t* o32 = reinterpret_cast<uint32_t*>(
      out + (b * kUV + static_cast<size_t>(kUVRows) * c) * kUV);
#pragma unroll 4
  for (int it = 0; it < kUVRows * kUV / 2 / kUVThreads; ++it) {
    const int g = tid + it * kUVThreads;
    const int16_t* row = t2 + (g / (kUV / 2)) * kT2Pitch;
    int even, odd;
    nhw::unnorm_pair(row, row + kUV / 2, kUV / 2, g % (kUV / 2), even, odd);
    o32[g] = pack16(nhw::norm_value(even), nhw::norm_value(odd));
  }
}

const ClusterKernel& y2_kernel() {
  static const ClusterKernel k =
      cluster_setup(y_stage2_cluster, kY2Cluster, kY2Threads, kY2Smem);
  return k;
}

const ClusterKernel& uv_kernel() {
  static const ClusterKernel k =
      cluster_setup(uv_synth_cluster, kUVCluster, kUVThreads, kUVSmem);
  return k;
}

// K1 as one cluster launch: grid (cluster, B), one cluster per plane.  The
// launch shape for each n: {n, CTAs a cluster, threads a CTA}; the numpy
// emulation of the kernel's maps (tests/test_torch_synth_cluster.py)
// reads this table.
constexpr int kSynthShapes[3][3] = {{512, 8, 512}, {256, 8, 256}, {128, 4, 256}};

constexpr int synth_shape(int n, int i) {
  return n == kSynthShapes[0][0] ? kSynthShapes[0][i]
         : n == kSynthShapes[1][0] ? kSynthShapes[1][i] : kSynthShapes[2][i];
}

template <int kN>
struct SynthLayout {
  static constexpr int kM = kN / 2;
  static constexpr int kCluster = synth_shape(kN, 1);
  static constexpr int kThreads = synth_shape(kN, 2);
  static constexpr int kRows = kN / kCluster;   // rows of x and of t a CTA
  static constexpr int kQuarter = kRows / 4;    // rows of x staged at a time
  static constexpr int kInPitch = kN + 16;      // int16: word pitch 8 mod 32
  static constexpr int kTPitch = kN + 2;        // int16: odd word pitch
  static constexpr int kSmem =
      2 * (kRows * kTPitch + 2 * kQuarter * kInPitch);
  static_assert(synth_shape(kN, 0) == kN && kRows % 32 == 0 &&
                    (kRows * kTPitch) % 8 == 0,
                "a known n, whole transposed row blocks, aligned buffers");
};

// out = norm_rows(int16(unnorm_rows(x))^T) for plane blockIdx.y.  CTA c
// stages rows [cR, (c+1)R) of x by quarters through two cp.async buffers;
// the un-normalised row pass sends pair k of each row to transposed rows
// 2k and 2k + 1, column = the source row, in the CTA that owns them
// (rows_to_peers_t, K3's map: a warp takes 16 k of two row pairs, two
// rows in a 32-bit store, 32 banks at the odd word pitch); after a
// cluster.sync() the CTA's R transposed rows are complete and it runs the
// normalised pass on them, 32-bit stores of out rows [cR, (c+1)R).
template <int kN>
__global__ void __launch_bounds__(SynthLayout<kN>::kThreads, 2)
synth_cluster(const int16_t* x, size_t x_plane, int x_row,
              int16_t* __restrict__ out) {
  using L = SynthLayout<kN>;
  constexpr int kM = L::kM;
  extern __shared__ __align__(16) unsigned char smem[];
  int16_t* t = reinterpret_cast<int16_t*>(smem);   // the CTA's rows of t
  int16_t* in = t + L::kRows * L::kTPitch;         // two quarter buffers
  const cg::cluster_group cluster = cg::this_cluster();
  const int c = static_cast<int>(cluster.block_rank());
  const size_t b = blockIdx.y;
  const int16_t* src =
      x + b * x_plane + static_cast<size_t>(L::kRows) * c * x_row;

  for (int q = 0; q < 2; ++q)
    stage_rows_async<kN, L::kInPitch, L::kThreads>(
        in + q * L::kQuarter * L::kInPitch,
        src + static_cast<size_t>(q) * L::kQuarter * x_row, x_row,
        L::kQuarter);
  cluster.sync();   // every peer runs before anyone writes to it
  for (int q = 0; q < 4; ++q) {
    if (q < 3) __pipeline_wait_prior(1); else __pipeline_wait_prior(0);
    __syncthreads();   // quarter q is in, from every thread's copies
    const int16_t* buf = in + (q & 1) * L::kQuarter * L::kInPitch;
    rows_to_peers_t<L::kQuarter, kM, L::kRows, L::kTPitch, L::kThreads, 2, 1,
                    2>(
        cluster, L::kRows * c + L::kQuarter * q, t,
        [&](int r, int k, int& even, int& odd) {
          const int16_t* row = buf + r * L::kInPitch;
          nhw::unnorm_pair(row, row + kM, kM, k, even, odd);
        });
    __syncthreads();   // every read of the buffer before it is refilled
    if (q < 2)
      stage_rows_async<kN, L::kInPitch, L::kThreads>(
          in + (q & 1) * L::kQuarter * L::kInPitch,
          src + static_cast<size_t>(q + 2) * L::kQuarter * x_row, x_row,
          L::kQuarter);
  }
  cluster.sync();   // every transposed row is in; the last access to a peer

  uint32_t* o32 = reinterpret_cast<uint32_t*>(
      out + (b * kN + static_cast<size_t>(L::kRows) * c) * kN);
#pragma unroll 4
  for (int it = 0; it < L::kRows * kM / L::kThreads; ++it) {
    const int g = threadIdx.x + it * L::kThreads;
    const int16_t* row = t + (g / kM) * L::kTPitch;
    int even, odd;
    nhw::unnorm_pair(row, row + kM, kM, g % kM, even, odd);
    o32[g] = pack16(nhw::norm_value(even), nhw::norm_value(odd));
  }
}

template <int kN>
const ClusterKernel& synth_kernel() {
  static const ClusterKernel k =
      cluster_setup(synth_cluster<kN>, SynthLayout<kN>::kCluster,
                    SynthLayout<kN>::kThreads, SynthLayout<kN>::kSmem);
  return k;
}

const ClusterKernel& synth_kernel_n(int n) {
  return n == 512   ? synth_kernel<512>()
         : n == 256 ? synth_kernel<256>()
                    : synth_kernel<128>();
}

cudaError_t synth_level(const int16_t* x, size_t plane_stride, int row_stride,
                        int16_t* out, int batch, int n, cudaStream_t s) {
  if (n == 512)
    return launch_cluster(synth_kernel<512>(), synth_cluster<512>, batch, s, x,
                          plane_stride, row_stride, out);
  if (n == 256)
    return launch_cluster(synth_kernel<256>(), synth_cluster<256>, batch, s, x,
                          plane_stride, row_stride, out);
  return launch_cluster(synth_kernel<128>(), synth_cluster<128>, batch, s, x,
                        plane_stride, row_stride, out);
}

bool bad_n(int n) { return n != 128 && n != 256 && n != 512; }

bool bad_batch(int batch) { return batch < 1 || batch > 65535; }

}  // namespace

extern "C" {

int nhw_analysis_cluster_info(int kernel, void* info);

const char* nhw_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

// K1.  x: (B, n, n) int16 with the given plane and row strides (elements,
// multiples of 8; 16-byte aligned base); out: contiguous (B, n, n) int16,
// 16-byte aligned, not overlapping x.
int nhw_synth_level(const void* x, int plane_stride, int row_stride, void* out,
                    int batch, int n, void* stream) {
  if (bad_n(n) || bad_batch(batch)) return cudaErrorInvalidValue;
  if (misaligned(x, 16) || row_stride % 8 != 0 ||
      (batch > 1 && plane_stride % 8 != 0) || misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  return synth_level(static_cast<const int16_t*>(x), plane_stride, row_stride,
                     static_cast<int16_t*>(out), batch, n,
                     static_cast<cudaStream_t>(stream));
}

// K2.  jp: (B, 512, 512) int16; depth: (B, 512, 512) uint8 (non-zero only
// on even rows), read with 16-byte loads; out: (B, 512, 512) uint8; all
// three 16-byte aligned.
int nhw_y_stage2_full(const void* jp, const void* depth, void* out, int batch,
                      int n_waves, void* stream) {
  if (bad_batch(batch)) return cudaErrorInvalidValue;
  if (misaligned(jp, 16) || misaligned(depth, 16) || misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  return launch_cluster(y2_kernel(), y_stage2_cluster, batch,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const int16_t*>(jp),
                        static_cast<const uint8_t*>(depth),
                        static_cast<uint8_t*>(out), n_waves);
}

// K3.  x: (B, 256, 256) int16, 16-byte aligned; out: (B, 256, 256) int16,
// 4-byte aligned.
int nhw_uv_synth(const void* x, void* out, int batch, void* stream) {
  if (bad_batch(batch)) return cudaErrorInvalidValue;
  if (misaligned(x, 16) || misaligned(out, 4))
    return cudaErrorMisalignedAddress;
  return launch_cluster(uv_kernel(), uv_synth_cluster, batch,
                        static_cast<cudaStream_t>(stream),
                        static_cast<const int16_t*>(x),
                        static_cast<int16_t*>(out));
}

// What the card allows for cluster kernel `kernel` (0: K2, 1: K3, 2-7:
// K4 and K10 at n = 512, 256, 128, analysis.cu; 8-10: K1 at n = 512, 256,
// 128), as its entry point found it: info[0] registers per thread,
// info[1] shared memory per CTA (bytes), info[2] the most clusters
// resident at once.
int nhw_cluster_info(int kernel, void* info) {
  if (kernel >= 8 && kernel <= 10)
    return nhw::cluster_info(synth_kernel_n(512 >> (kernel - 8)), info);
  if (kernel >= 2) return nhw_analysis_cluster_info(kernel - 2, info);
  if (kernel != 0 && kernel != 1) return cudaErrorInvalidValue;
  return nhw::cluster_info(kernel == 0 ? y2_kernel() : uv_kernel(), info);
}

// K7.  x: (B, n, n) int16 with the given plane and row strides (elements,
// multiples of 8; 16-byte aligned base); out: contiguous (B, n, n) int16,
// 16-byte aligned, out[b] = int16(unnorm_rows(x[b]))^T.
int nhw_synth_unnorm_rows_t(const void* x, int plane_stride, int row_stride,
                            void* out, int batch, int n, void* stream) {
  if (bad_n(n) || bad_batch(batch)) return cudaErrorInvalidValue;
  if (misaligned(x, 16) || row_stride % 8 != 0 ||
      (batch > 1 && plane_stride % 8 != 0) || misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  unnorm_rows_t_tile<<<dim3(n / 2 / kT7Pairs, n / kT7Rows, batch), kT7Threads,
                       0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(x), plane_stride, row_stride,
      static_cast<int16_t*>(out), n);
  return cudaGetLastError();
}

// K8.  t: (B, 512, 512) int16 transposed plane, depth: (B, 512, 512) uint8
// (non-zero only on even rows), out: (B, 512, 512) uint8; all three
// 16-byte aligned.
int nhw_synth_norm_rows_clip_waves(const void* t, const void* depth, void* out,
                                   int batch, int n_waves, void* stream) {
  if (bad_batch(batch)) return cudaErrorInvalidValue;
  if (misaligned(t, 16) || misaligned(depth, 16) || misaligned(out, 16))
    return cudaErrorMisalignedAddress;
  const cudaError_t e = waves_band_setup();
  if (e != cudaSuccess) return e;
  waves_band<<<dim3(kY / kW8Rows, batch), kW8Threads, kW8Smem,
               static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(t), static_cast<const uint8_t*>(depth),
      static_cast<uint8_t*>(out), n_waves);
  return cudaGetLastError();
}

// K9.  t: contiguous (B, n, n) int16, out: (B, n, n) uint8.
int nhw_synth_norm_rows_clip(const void* t, void* out, int batch, int n,
                             void* stream) {
  if (bad_n(n) || bad_batch(batch)) return cudaErrorInvalidValue;
  norm_rows<<<dim3(n, batch), n / 2, 0,
                       static_cast<cudaStream_t>(stream)>>>(
      static_cast<const int16_t*>(t), static_cast<uint8_t*>(out), n);
  return cudaGetLastError();
}

// The mark scan.  x: (B, 512, 512) int16, 16-byte aligned, updated in
// place; recs: (B, K) int32 records; valid: (B, K) uint8 (0 = padding).
int nhw_smooth_marks_seq(void* x, const void* recs, const void* valid, int k,
                         int batch, void* stream) {
  if (batch < 1 || batch > 65535 || k < 0) return cudaErrorInvalidValue;
  if (misaligned(x, 16)) return cudaErrorMisalignedAddress;
  if (k == 0) return cudaSuccess;
  mark_rows<<<dim3(kY / 2 / kMsRows, batch), kMsThreads, 0,
              static_cast<cudaStream_t>(stream)>>>(
      static_cast<int16_t*>(x), static_cast<const int32_t*>(recs),
      static_cast<const uint8_t*>(valid), k);
  return cudaGetLastError();
}

}  // extern "C"
