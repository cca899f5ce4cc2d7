// Hand-written Hopper (sm_90a) kernels of the device Huffman decode.  Plain
// C interface, bound with ctypes by nhwcodec_tpu_torch/kernels/build.py;
// wrappers and torch twins in nhwcodec_tpu_torch/ops/entropy_decode_device.py
// (chain_starts_batch / chain_starts_ref, runs_fixpoint / runs_fixpoint_ref).
//
// E1 nhw_chain_starts replaces nhwcodec_tpu/ops/entropy_chain_scan.py:131
//    chain_starts_batch (an XLA program; its CPU form is the peek LUT with
//    pointer doubling, entropy_decode_device.py:179): every codeword start
//    of each stream's bit chain from bit 0, and its symbol.  (B, W) u32
//    words, (B,) nbits and zone -> (B, s_max) int32 symbols by rank and the
//    (B,) count of starts below nbits.  Three launches.
// E2 nhw_y_runs_fixpoint replaces nhwcodec_tpu/ops/entropy_decode_device.py
//    :923 _runs_fixpoint (an XLA while_loop around a lax.scan, step
//    _runs_step :634): the Y run automaton as a chunk-relay fixpoint over
//    time-major (L, B k) per-run tuples -> per-run (e_in, ev1, ev2) and
//    each stream's sweep count.  One cluster launch.
//
// E1's bound.  The function reads 4 bytes a word, writes 4 bytes a
// codeword start and needs some 30 operations a start (a 20-bit peek, a
// 5-step binary search over the code's affine segments, the length, the
// symbol, the step to the next start): microseconds at a q20 chunk of 16.
// But the starts form one dependent walk along each stream.  To walk the
// words in parallel, the design below does that step at all 32 offsets of
// every word (some 960 operations a word), with the segments (at most 28
// thresholds) in shared memory, not an 8 MiB peek table.  Design: the
// chain's state at a word boundary is the overhang of the current codeword
// into the word, one of 20 values, so a word is a transfer function over
// 20 states.  One thread a word builds
// it right to left (exit and start count from every offset, 32 steps; the
// first 20 rows are the function), a warp lane per state composes a warp's
// 32 functions, and threads 0-19 a tile's 8 warps (chain_tiles).  One warp
// a stream then walks the tiles' composites, the 20 states in the lanes and
// the walker's state picked by a shuffle, with the loads running ahead of
// the walk (chain_entries).  chain_emit rebuilds the tile's functions,
// walks warps and words from the tile's entry state and rank, and writes
// each word's symbols at their ranks.  256 words a CTA, so a q20 chunk of
// 16 runs some 2,600 CTAs on the 132 SMs.
//
// E2's bound.  It reads the per-run tuples once and writes e_in and the
// flags once (13 bytes a run) - microseconds - but it is a chain of
// dependent steps: sweeps x L of them (L = runs / k).  What a step costs
// is then what matters: with a step's loads from global memory and one or
// two warps an SM, 270-620 ns (H100); from shared memory 71-100 ns, some
// 80 instructions 13 deep.  Design: a thread-block cluster a stream,
// min(k, 8) CTAs (at batch 16, 128 of the 132 SMs), each CTA owning a
// contiguous block of the stream's chunks, one thread a chunk.  Each CTA
// stages its chunks' (ebase, fields) rows in shared memory once with
// cp.async (a q20 stream's 0.6 MB fits the cluster's 8 x 220 KB), and
// every sweep walks them from there, the loads of eight steps issued
// ahead; rows past what fits are read from global memory by the same
// loop.  After a sweep the relay: the exclusive prefix of the chunks'
// insert deltas is a warp scan within the CTA plus the totals of the
// lower-ranked CTAs, and the other carries shift from the chunk before,
// across a CTA edge from the peer's last chunk; both go through
// distributed shared memory between cluster.sync()s, double-buffered by
// the sweep's parity, and so does "an in-carry changed".  A chunk whose
// in-carry did not change keeps its last walk (e_in, flags and out-carry
// stand) and is not walked again.  The batch's exact fallback is a launch
// at k = 1 (one CTA, one thread walks every run).

#include <cooperative_groups.h>
#include <cuda_pipeline.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <initializer_list>

#include "cluster.cuh"

namespace {

namespace cg = cooperative_groups;

constexpr int kTile = 256;          // words a CTA of E1, one a thread
constexpr int kWarps = kTile / 32;
constexpr int kStates = 20;         // overhang states (longest code 20)
constexpr int kSeg = 32;            // padded segment table (>= 28 used)
constexpr int kPitch = kTile + 1;   // row pitch of the per-offset table
constexpr int kMaxChunks = 1024;
constexpr int kFixCluster = 8;            // E2: CTAs a stream, at most
constexpr int kFixThreads = 128;          // E2: threads a CTA, >= its chunks
constexpr int kFixWarps = kFixThreads / 32;
constexpr int kFixSmemMax = 220 * 1024;   // E2: staged tuples a CTA, bytes
static_assert(kMaxChunks <= kFixCluster * kFixThreads,
              "a chunk a thread over the cluster");

// The segment table of one zone mode in shared memory: thresholds (padded
// with 2^20), lengths and bases, from the (2, 3, 32) int32 table.
struct Segs {
  int thr[kSeg];
  int len[kSeg];
  int base[kSeg];
};

__device__ __forceinline__ void load_segs(Segs& s, const int* tab, int zone) {
  const int t = threadIdx.x;
  if (t < kSeg) {
    const int* z = tab + zone * 3 * kSeg;
    s.thr[t] = z[t];
    s.len[t] = z[kSeg + t];
    s.base[t] = z[2 * kSeg + t];
  }
}

// The segment of a 20-bit peek: the greatest s with thr[s] <= peek
// (thr[0] == 0).
__device__ __forceinline__ int segment(const Segs& s, int peek) {
  int i = 0;
#pragma unroll
  for (int step = 16; step > 0; step >>= 1)
    if (s.thr[i + step] <= peek) i += step;
  return i;
}

// The 20 bits from offset p (0..31) of word w, then nxt.
__device__ __forceinline__ int peek_at(uint32_t w, uint32_t nxt, int p) {
  const uint32_t win = p ? (w << p) | (nxt >> (32 - p)) : w;
  return static_cast<int>(win >> 12);
}

struct TileShared {
  Segs segs;
  // f[p * kPitch + t]: word t's walk from offset p: exit overhang in bits
  // 0-7, starts in the word from 8; rows 0-19 are the transfer function
  uint32_t f[32 * kPitch];
  uint32_t warp_fn[kWarps][kStates];   // exit | starts << 8, per warp
};

// Builds the tile's per-word walks (f) and per-warp composites (warp_fn).
// Words at or past n_words are the identity with no start.
__device__ void tile_functions(TileShared& sh, const uint32_t* words,
                               const int* seg_tab, int zone, int n_words,
                               int b, int tile) {
  const int t = threadIdx.x;
  const int j = tile * kTile + t;
  load_segs(sh.segs, seg_tab, zone);
  __syncthreads();
  if (j < n_words) {
    const uint32_t* row = words + static_cast<size_t>(b) * n_words;
    const uint32_t w = row[j];
    const uint32_t nxt = j + 1 < n_words ? row[j + 1] : 0u;
    for (int p = 31; p >= 0; --p) {
      const int q = p + sh.segs.len[segment(sh.segs, peek_at(w, nxt, p))];
      sh.f[p * kPitch + t] =
          q >= 32 ? static_cast<uint32_t>(q - 32) | (1u << 8)
                  : sh.f[q * kPitch + t] + (1u << 8);
    }
  } else {
    for (int p = 0; p < kStates; ++p) sh.f[p * kPitch + t] = p;
  }
  __syncthreads();
  const int warp = t >> 5, lane = t & 31;
  if (lane < kStates) {
    uint32_t s = lane, starts = 0;
    for (int i = 0; i < 32; ++i) {
      const uint32_t v = sh.f[s * kPitch + warp * 32 + i];
      starts += v >> 8;
      s = v & 0xFFu;
    }
    sh.warp_fn[warp][lane] = s | (starts << 8);
  }
  __syncthreads();
}

// E1 phase 1: each tile's composite transfer function, exit | starts << 16
// per entry state, into comp (B, tiles, 20).
__global__ void __launch_bounds__(kTile)
    chain_tiles(const uint32_t* __restrict__ words, const int* __restrict__ zone,
                const int* __restrict__ seg_tab, int n_words,
                uint32_t* __restrict__ comp) {
  __shared__ TileShared sh;
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  tile_functions(sh, words, seg_tab, zone[b] != 0, n_words, b, tile);
  if (t < kStates) {
    uint32_t s = t, starts = 0;
    for (int w = 0; w < kWarps; ++w) {
      const uint32_t v = sh.warp_fn[w][s];
      starts += v >> 8;
      s = v & 0xFFu;
    }
    comp[(static_cast<size_t>(b) * gridDim.x + tile) * kStates + t] =
        s | (starts << 16);
  }
}

// E1 phase 2: one warp a stream walks its tiles' composites from state 0,
// rank 0, and writes each tile's entry (state, rank) into entry (B, tiles,
// 2).  Lane d < 20 holds the composite's value for state d; the walker's
// next state is a shuffle.  The loads do not depend on the walk, so eight
// tiles' loads are issued before their shuffles.
__global__ void __launch_bounds__(32)
    chain_entries(const uint32_t* __restrict__ comp, int tiles,
                  int* __restrict__ entry) {
  const int b = blockIdx.x, lane = threadIdx.x;
  const uint32_t* c = comp + static_cast<size_t>(b) * tiles * kStates;
  int* e = entry + static_cast<size_t>(b) * tiles * 2;
  int s = 0, rank = 0;
  constexpr int kAhead = 8;
  for (int t0 = 0; t0 < tiles; t0 += kAhead) {
    uint32_t v[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i)
      v[i] = (lane < kStates && t0 + i < tiles)
                 ? c[static_cast<size_t>(t0 + i) * kStates + lane]
                 : 0u;
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      if (t0 + i < tiles) {
        if (lane == 0) {
          e[2 * (t0 + i)] = s;
          e[2 * (t0 + i) + 1] = rank;
        }
        const uint32_t got = __shfl_sync(0xFFFFFFFFu, v[i], s);
        s = static_cast<int>(got & 0xFFFFu);
        rank += static_cast<int>(got >> 16);
      }
    }
  }
}

// E1 phase 3: every word's entry overhang and rank from its tile's, and its
// starts' symbols written at their ranks below s_max; counts[b] gains the
// starts below nbits[b].
__global__ void __launch_bounds__(kTile)
    chain_emit(const uint32_t* __restrict__ words, const int* __restrict__ nbits,
               const int* __restrict__ zone, const int* __restrict__ seg_tab,
               const int* __restrict__ entry, int n_words, int s_max,
               int* __restrict__ syms, int* __restrict__ counts) {
  __shared__ TileShared sh;
  __shared__ int warp_state[kWarps], warp_rank[kWarps];
  __shared__ uint8_t word_state[kTile];
  const int b = blockIdx.y, tile = blockIdx.x, t = threadIdx.x;
  const int warp = t >> 5, lane = t & 31;
  tile_functions(sh, words, seg_tab, zone[b] != 0, n_words, b, tile);
  if (t == 0) {
    const int* e = entry + (static_cast<size_t>(b) * gridDim.x + tile) * 2;
    uint32_t s = e[0];
    int rank = e[1];
    for (int w = 0; w < kWarps; ++w) {
      warp_state[w] = s;
      warp_rank[w] = rank;
      const uint32_t v = sh.warp_fn[w][s];
      rank += static_cast<int>(v >> 8);
      s = v & 0xFFu;
    }
  }
  __syncthreads();
  if (lane == 0) {
    uint32_t s = warp_state[warp];
    for (int i = 0; i < 32; ++i) {
      word_state[warp * 32 + i] = static_cast<uint8_t>(s);
      s = sh.f[s * kPitch + warp * 32 + i] & 0xFFu;
    }
  }
  __syncwarp();
  const int j = tile * kTile + t;
  const int p0 = word_state[t];
  const int n = j < n_words ? static_cast<int>(sh.f[p0 * kPitch + t] >> 8) : 0;
  int before = n;   // inclusive warp scan of the words' starts
#pragma unroll
  for (int d = 1; d < 32; d <<= 1) {
    const int o = __shfl_up_sync(0xFFFFFFFFu, before, d);
    if (lane >= d) before += o;
  }
  int below = 0;
  if (n) {
    const uint32_t* row = words + static_cast<size_t>(b) * n_words;
    const uint32_t w = row[j];
    const uint32_t nxt = j + 1 < n_words ? row[j + 1] : 0u;
    const long long bit0 = 32LL * j;
    const int limit = nbits[b];
    int* out = syms + static_cast<size_t>(b) * s_max;
    int rank = warp_rank[warp] + before - n;
    for (int p = p0; p < 32; ++rank) {
      const int peek = peek_at(w, nxt, p);
      const int s = segment(sh.segs, peek);
      const int len = sh.segs.len[s];
      if (rank < s_max) out[rank] = sh.segs.base[s] + (peek >> (20 - len));
      below += bit0 + p < limit;
      p += len;
    }
  }
#pragma unroll
  for (int d = 16; d > 0; d >>= 1)
    below += __shfl_xor_sync(0xFFFFFFFFu, below, d);
  if (lane == 0 && below) atomicAdd(counts + b, below);
}

// One run of the Y automaton (decoder/compress_pixel.c:296-341 at a run
// word, the literals since the last run folded into the window summary),
// as _runs_step / ops.entropy_decode_device.runs_step.
struct Carry {
  int ins, mem, mem2, ac1, run_over, win;
};

// Branch-free: the conditions are ints combined with & and |, so that a
// walk's unrolled steps form one basic block and their shared-memory loads
// can be issued ahead of the carry chain.
__device__ __forceinline__ int run_step(Carry& c, int e_base, int f, int p1,
                                        int* e_in_out) {
  const int rle = f & 0xFF, segm = (f >> 8) & 31, segc = (f >> 13) & 7;
  const int prun = (f >> 16) & 1, valid = (f >> 18) & 1;
  const int rle4 = rle >= 4, is254 = rle == 254;
  const int e_in = e_base + c.ins;
  const int act = valid & (e_in < p1 - 1);
  const int mem_in = prun ? c.mem : 0;
  const int mem2_in = prun ? c.mem2 : (f >> 17) & 1;
  const int m2 = mem2_in == 1;
  const int ac1_in = prun ? c.ac1 : 0;
  const int win_in = (segm | (c.win << segc)) & 31;
  const int room = e_in - c.run_over >= 257 - rle;
  // the long run's insert (output 1 back zero) and, right after a run that
  // inserted, the one with outputs 1..4 back zero; both need room past
  // run_over and no 254-run just before
  const int long_run = rle4 & (e_in > 0) & ((win_in & 1) == 0);
  const int after = (mem_in == 1) & (e_in >= 4) & ((win_in & 15) == 0);
  const int ev1 = act & (m2 ^ 1) & (ac1_in == 0) & room & (long_run | after);
  const int ev2 = act & m2 &
                  (((e_in >= 5) & ((win_in & 30) == 0)) |
                   (rle4 & (e_in >= 2) & ((win_in & 2) == 0)));
  const int ins = ev1 | ev2;
  // mem is read only through mem == 1 a run later: it saturates at 2;
  // 1 after an ev1, 0 after a 254-run
  const int mem_new =
      ((min(mem_in + 1, 2) & (ev1 - 1)) | ev1) & (is254 - 1);
  const int win_new = (((win_in << ins) | ins) << min(rle, 5)) & 31;
  c.mem = act ? mem_new : c.mem;
  c.mem2 = act ? (m2 ? 0 : mem2_in) : c.mem2;
  c.ac1 = act ? is254 : c.ac1;
  c.run_over = (act & is254) ? e_in + ins : c.run_over;
  c.win = act ? win_new : c.win;
  c.ins += ins;
  *e_in_out = e_in;
  return ev1 | (ev2 << 1);
}

// E2's rows of per-run tuples, walked by one thread from run t0 to t1:
// the loads of kAhead steps are issued before their steps (they do not
// depend on the carry), and each step writes its e_in and flags at rows t
// of the thread's column (row pitch n).
template <typename Rows>
__device__ __forceinline__ void walk_rows(Carry& c, const Rows& rows, int t0,
                                          int t1, int p1, size_t n,
                                          int* e_in, uint8_t* flags,
                                          bool& live) {
  constexpr int kAhead = 8;
  int t = t0;
  for (; t + kAhead <= t1; t += kAhead) {
    int2 x[kAhead];
#pragma unroll
    for (int i = 0; i < kAhead; ++i) x[i] = rows(t + i);
#pragma unroll
    for (int i = 0; i < kAhead; ++i) {
      live |= x[i].x < p1 - 1;
      flags[(t + i) * n] = static_cast<uint8_t>(
          run_step(c, x[i].x, x[i].y, p1, e_in + (t + i) * n));
    }
  }
  for (; t < t1; ++t) {
    const int2 x = rows(t);
    live |= x.x < p1 - 1;
    flags[t * n] =
        static_cast<uint8_t>(run_step(c, x.x, x.y, p1, e_in + t * n));
  }
}

// A chunk's staged (ebase, fields) rows in shared memory, pitch: the CTA's
// chunks.
struct SharedRows {
  const int2* p;
  int pitch;
  __device__ __forceinline__ int2 operator()(int t) const {
    return p[t * pitch];
  }
};

// A chunk's rows past the staged ones, in global memory (pitch n).
struct GlobalRows {
  const int* eb;
  const int* fl;
  size_t n;
  __device__ __forceinline__ int2 operator()(int t) const {
    return make_int2(eb[t * n], fl[t * n]);
  }
};

// What a CTA of E2 hears from its cluster each sweep, by the sweep's
// parity: written by the peers through DSM before a cluster.sync(), read
// from the CTA's own shared memory after it.
struct FixRelay {
  int sum[2][kFixCluster];      // each CTA's insert-delta total, by rank
  int last[2][5];               // rank - 1's last chunk's mem, mem2, ac1,
                                // run_over, win
  int changed[2][kFixCluster];  // each CTA: an in-carry changed
};

// E2: a cluster of gridDim.x CTAs a stream (blockIdx.y); CTA `rank` owns
// chunks [rank cpc, rank cpc + cpc) of the stream's k, one thread each,
// and stages rows [0, rows) of their tuples in shared memory.  ebase,
// fields: (L, B k) int32; e_in: (L, B k) int32; flags: (L, B k) uint8;
// sweeps: (B,) int32.
__global__ void __launch_bounds__(kFixThreads)
    y_runs_fixpoint(const int* __restrict__ ebase,
                    const int* __restrict__ fields, int* __restrict__ e_in,
                    uint8_t* __restrict__ flags, int* __restrict__ sweeps,
                    int length, int k, int p1, int cpc, int rows) {
  extern __shared__ __align__(16) uint8_t fix_smem[];
  int2* tup = reinterpret_cast<int2*>(fix_smem);
  __shared__ FixRelay relay;
  __shared__ int s_mem[kFixThreads], s_mem2[kFixThreads], s_ac1[kFixThreads],
      s_ro[kFixThreads], s_win[kFixThreads];
  __shared__ int s_warp[kFixWarps];
  const cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int ncta = static_cast<int>(cluster.num_blocks());
  const int c = threadIdx.x, lane = c & 31, warp = c >> 5;
  const int first = rank * cpc;
  const int nloc = max(0, min(k - first, cpc));
  const bool active = c < nloc;
  const size_t n = static_cast<size_t>(gridDim.y) * k;
  const size_t col0 = static_cast<size_t>(blockIdx.y) * k + first;
  for (int i = c; i < rows * nloc; i += kFixThreads) {
    const int t = i / nloc, j = i - t * nloc;
    const size_t at = t * n + col0 + j;
    __pipeline_memcpy_async(&tup[t * cpc + j].x, ebase + at, 4);
    __pipeline_memcpy_async(&tup[t * cpc + j].y, fields + at, 4);
  }
  __pipeline_commit();
  const size_t col = col0 + c;
  const int ro_floor = active ? ebase[col] - 256 : 0;
  const SharedRows staged{tup + c, cpc};
  const GlobalRows spilled{ebase + col, fields + col, n};
  __pipeline_wait_prior(0);
  cluster.sync();   // the tuples staged, every peer started

  Carry in{0, 0, 0, 0, -257, 0}, out = in;
  bool live = false, dirty = true;
  int it = 1;
  for (;; ++it) {
    const int par = it & 1;
    if (active && dirty) {
      out = in;
      walk_rows(out, staged, 0, rows, p1, n, e_in + col, flags + col, live);
      walk_rows(out, spilled, rows, length, p1, n, e_in + col, flags + col,
                live);
    }
    // the CTA's inclusive prefix of its chunks' insert deltas
    const int delta = active ? out.ins - in.ins : 0;
    int incl = delta;
#pragma unroll
    for (int d = 1; d < 32; d <<= 1) {
      const int o = __shfl_up_sync(0xFFFFFFFFu, incl, d);
      if (lane >= d) incl += o;
    }
    if (lane == 31) s_warp[warp] = incl;
    if (active) {
      s_mem[c] = out.mem;
      s_mem2[c] = out.mem2;
      s_ac1[c] = out.ac1;
      s_ro[c] = out.run_over;
      s_win[c] = out.win;
    }
    __syncthreads();
    if (c == 0) {
#pragma unroll
      for (int w = 1; w < kFixWarps; ++w) s_warp[w] += s_warp[w - 1];
    }
    __syncthreads();
    // to the peers: the CTA's total, and its last chunk's carries to the
    // next CTA
    if (c < ncta)
      *cluster.map_shared_rank(&relay.sum[par][rank], c) =
          s_warp[kFixWarps - 1];
    if (active && c == nloc - 1 && rank + 1 < ncta) {
      int* to = cluster.map_shared_rank(relay.last[par], rank + 1);
      to[0] = out.mem;
      to[1] = out.mem2;
      to[2] = out.ac1;
      to[3] = out.run_over;
      to[4] = out.win;
    }
    cluster.sync();
    bool changed = false;
    if (active) {
      int before = incl - delta + (warp ? s_warp[warp - 1] : 0);
      for (int r = 0; r < rank; ++r) before += relay.sum[par][r];
      const bool pin = first + c == 0 || !live;
      const int* prev = relay.last[par];
      const int pm = c ? s_mem[c - 1] : prev[0];
      const int pm2 = c ? s_mem2[c - 1] : prev[1];
      const int pa = c ? s_ac1[c - 1] : prev[2];
      const int pr = c ? s_ro[c - 1] : prev[3];
      const int pw = c ? s_win[c - 1] : prev[4];
      Carry nxt;
      nxt.ins = pin ? 0 : before;
      nxt.mem = pin ? 0 : pm;
      nxt.mem2 = pin ? 0 : pm2;
      nxt.ac1 = pin ? 0 : pa;
      nxt.run_over = max(pin ? -257 : pr, ro_floor);
      nxt.win = pin ? 0 : pw;
      changed = nxt.ins != in.ins || nxt.mem != in.mem ||
                nxt.mem2 != in.mem2 || nxt.ac1 != in.ac1 ||
                nxt.run_over != in.run_over || nxt.win != in.win;
      in = nxt;
    }
    // a chunk whose in-carry stands keeps its walk: its e_in, flags and
    // out-carry are those of this in-carry
    dirty = changed;
    const int any = __syncthreads_or(changed);
    if (c < ncta) *cluster.map_shared_rank(&relay.changed[par][rank], c) = any;
    cluster.sync();
    bool again = false;
    for (int r = 0; r < ncta; ++r) again |= relay.changed[par][r] != 0;
    if (!again || it == k + 1) break;
  }
  if (rank == 0 && c == 0) sweeps[blockIdx.y] = it;
}

cudaError_t fixpoint_setup() {
  static const cudaError_t e = cudaFuncSetAttribute(
      y_runs_fixpoint, cudaFuncAttributeMaxDynamicSharedMemorySize,
      kFixSmemMax);
  return e;
}

bool misaligned4(std::initializer_list<const void*> ptrs) {
  for (const void* p : ptrs)
    if (reinterpret_cast<uintptr_t>(p) % 4 != 0) return true;
  return false;
}

}  // namespace

extern "C" {

// E1.  words: (B, W) u32; nbits: (B,) int32; zone: (B,) int32, non-zero
// for the zone mode; seg_tab: (2, 3, 32) int32; comp: (B, tiles, 20) int32
// and entry: (B, tiles, 2) int32 scratch (tiles = ceil(W / 256)); syms:
// (B, s_max) int32 and counts: (B,) int32, both zeroed by the caller.
int nhw_chain_starts(const void* words, const void* nbits, const void* zone,
                     const void* seg_tab, void* comp, void* entry, void* syms,
                     void* counts, int batch, int n_words, int s_max,
                     void* stream) {
  if (batch < 1 || batch > 65535 || n_words < 1 || s_max < 1)
    return cudaErrorInvalidValue;
  if (misaligned4({words, nbits, zone, seg_tab, comp, entry, syms, counts}))
    return cudaErrorMisalignedAddress;
  const int tiles = (n_words + kTile - 1) / kTile;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* w = static_cast<const uint32_t*>(words);
  const auto* z = static_cast<const int*>(zone);
  const auto* tab = static_cast<const int*>(seg_tab);
  chain_tiles<<<dim3(tiles, batch), kTile, 0, s>>>(
      w, z, tab, n_words, static_cast<uint32_t*>(comp));
  chain_entries<<<batch, 32, 0, s>>>(static_cast<const uint32_t*>(comp),
                                     tiles, static_cast<int*>(entry));
  chain_emit<<<dim3(tiles, batch), kTile, 0, s>>>(
      w, static_cast<const int*>(nbits), z, tab,
      static_cast<const int*>(entry), n_words, s_max, static_cast<int*>(syms),
      static_cast<int*>(counts));
  return cudaGetLastError();
}

// E2.  ebase, fields: (L, B k) int32 time-major per-run tuples; e_in: (L,
// B k) int32, flags: (L, B k) uint8 (ev1 bit 0, ev2 bit 1), sweeps: (B,)
// int32.  A cluster of min(k, 8) CTAs a stream; each CTA stages the first
// rows of its chunks' tuples that fit kFixSmemMax and reads the rest from
// global memory.
int nhw_y_runs_fixpoint(const void* ebase, const void* fields, void* e_in,
                        void* flags, void* sweeps, int length, int batch,
                        int k, int p1, void* stream) {
  if (batch < 1 || batch > 65535 || length < 1 || k < 1 || k > kMaxChunks)
    return cudaErrorInvalidValue;
  if (misaligned4({ebase, fields, e_in, sweeps}))
    return cudaErrorMisalignedAddress;
  const cudaError_t e = fixpoint_setup();
  if (e != cudaSuccess) return e;
  const int cluster = k < kFixCluster ? k : kFixCluster;
  const int cpc = (k + cluster - 1) / cluster;
  int rows = kFixSmemMax / (8 * cpc);
  if (rows > length) rows = length;
  cudaLaunchAttribute dims = nhw::cluster_dims(cluster);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, batch, 1);
  cfg.blockDim = dim3(kFixThreads, 1, 1);
  cfg.dynamicSmemBytes = static_cast<size_t>(rows) * cpc * 8;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = &dims;
  cfg.numAttrs = 1;
  const cudaError_t l = cudaLaunchKernelEx(
      &cfg, y_runs_fixpoint, static_cast<const int*>(ebase),
      static_cast<const int*>(fields), static_cast<int*>(e_in),
      static_cast<uint8_t*>(flags), static_cast<int*>(sweeps), length, k,
      p1, cpc, rows);
  return l != cudaSuccess ? l : cudaGetLastError();
}

}  // extern "C"
