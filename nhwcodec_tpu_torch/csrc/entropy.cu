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
//    (B,) count of starts below nbits.  One launch (chain_scan) after the
//    caller zeroes its look-back state.
// E2 nhw_y_runs_fixpoint replaces nhwcodec_tpu/ops/entropy_decode_device.py
//    :923 _runs_fixpoint (an XLA while_loop around a lax.scan, step
//    _runs_step :634): the Y run automaton as a chunk-relay fixpoint over
//    time-major (L, B k) per-run tuples -> per-run (e_in, ev1, ev2) and
//    each stream's sweep count.  One cluster launch.
//
// E1's bound.  The function reads 4 bytes a word, writes 4 bytes a
// codeword start and needs some 30 operations a start (a 20-bit peek, the
// code's segment, the length, the symbol, the step to the next start):
// microseconds at a q20 chunk of 16.  But the starts form one dependent
// walk along each stream.  To walk the words in parallel, the design below
// does that step at all 32 offsets of every word, so that a word is a
// transfer function over the chain's state at its boundary, the overhang
// of the current codeword into the word (one of 20 values).  Design: a
// single-pass chained scan over tiles of 256 words, one CTA a tile, with
// decoupled look-back.  Each CTA takes a ticket (tile-major over the
// streams), so it only ever waits on tiles that have started.  It builds
// its words' functions once: one thread a word, right to left (exit and
// start count from every offset, 32 steps, in shared memory), each
// offset's code length one lookup in a table on the peek's top 10 bits
// (a binary search over the code's segments only in the buckets that span
// several); lanes 0-19 of each warp then walk its 32 words from every
// state (recording the trajectory), and threads 0-19 the 8 warps.  Warp 0
// publishes the tile's composite (20 entries of exit | starts) and looks
// back: a lane a predecessor, 32 at a time, it loads their status words
// and composites at once (each word is written once, so what it reads is
// 0 or final), stages the composites up to the nearest predecessor whose
// inclusive (state, rank) is out in shared memory, and folds them, a lane
// a state; then it publishes its own inclusive (state, rank) (a 64-bit
// status word a tile).  Meanwhile the warps whose
// entry state is the same from every tile entry state (the chains from
// all 20 have met, as they do within a few codewords) emit: each thread
// walks its word's starts from its entry state (two lookups in the
// trajectories) and writes the symbols at their local ranks into the
// warp's run in shared memory.  The other warps emit once the entry is
// out, and the CTA copies the runs to the tile's ranks, coalesced.  The
// word holding bit nbits writes the count; the stream's last tile writes
// the zeros past the chain's last start.  256 words a CTA, so a q20 chunk
// of 16 runs some 2,600 CTAs on the 132 SMs.
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
constexpr int kLutBits = 10;        // the length table's peek bits
constexpr int kLut = 1 << kLutBits;
constexpr int kAggBits = 16;        // starts in a tile composite entry
constexpr int kRun = 512;           // a warp's symbols at most (f rows 0-15)
constexpr int kRunRows = 16;        // f rows holding the warps' runs
constexpr int kScanCtas = 5;        // E1: resident CTAs an SM (smem, regs)
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxChunks = 1024;
constexpr int kFixCluster = 8;            // E2: CTAs a stream, at most
constexpr int kFixThreads = 128;          // E2: threads a CTA, >= its chunks
constexpr int kFixWarps = kFixThreads / 32;
constexpr int kFixSmemMax = 220 * 1024;   // E2: staged tuples a CTA, bytes
static_assert(kMaxChunks <= kFixCluster * kFixThreads,
              "a chunk a thread over the cluster");
static_assert(kLut * 4 == kTile * 16, "one 16-byte load a thread");

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

// The 32 bits from offset p (0..31) of word w, then nxt.
__device__ __forceinline__ uint32_t window_at(uint32_t w, uint32_t nxt,
                                              int p) {
  return __funnelshift_l(nxt, w, p);
}

// A code's (len, base) at a 32-bit window (its top 20 bits the peek): the
// length table's entry on the top 10 bits, len | base << 5 (the symbol is
// base + (peek >> (20 - len))), or 0 where the bucket spans segments and
// the binary search decides.
__device__ __noinline__ int code_searched(const Segs& s, uint32_t win) {
  const int seg = segment(s, static_cast<int>(win >> 12));
  return s.len[seg] | (s.base[seg] << 5);
}

__device__ __forceinline__ int code_at(const Segs& s, const int* lut,
                                       uint32_t win) {
  const int e = lut[win >> (32 - kLutBits)];
  return e != 0 ? e : code_searched(s, win);
}

// The look-back's words are each written once, from 0 to their final
// value, so a reader needs no ordering: what it reads is 0 (not out yet)
// or final.  Its loads bypass L1 (this SM may have cached the line before
// the word was written) and are issued anew on every read.
__device__ __forceinline__ unsigned long long ld_relaxed(
    const unsigned long long* p) {
  unsigned long long v;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];"
               : "=l"(v) : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ uint4 ld_volatile4(const uint32_t* p) {
  uint4 v;
  asm volatile("ld.volatile.global.v4.u32 {%0, %1, %2, %3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w)
               : "l"(p) : "memory");
  return v;
}

__device__ __forceinline__ void st_relaxed(unsigned long long* p,
                                           unsigned long long v) {
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;"
               :: "l"(p), "l"(v) : "memory");
}

__device__ __forceinline__ void st_relaxed32(uint32_t* p, uint32_t v) {
  asm volatile("st.relaxed.gpu.global.u32 [%0], %1;"
               :: "l"(p), "r"(v) : "memory");
}

// A tile's composite entries carry kOut (the composite is out once all 20
// of them do); its status word is 0 until its inclusive prefix is out,
// then kInclusive | exit state << 8 | the starts through it << 32.
constexpr uint32_t kOut = 1u << 31;
constexpr unsigned long long kInclusive = 2;

struct ChainShared {
  Segs segs;
  alignas(16) int lut[kLut];
  // f[p * kPitch + t]: word t's walk from offset p, exit overhang in bits
  // 0-7, starts in the word from 8; rows 0-19 are its transfer function.
  // Once the functions are built, rows 20-29 of column t hold word t's
  // trajectory: the state after it and the starts since its warp's entry,
  // state | starts << 5 as 16 bits, for each warp entry state (two a row).
  uint32_t f[32 * kPitch];
  uint32_t warp_fn[kWarps][kStates];   // exit | starts << 8, per warp
  uint32_t warp_in[kWarps][kStates];   // warp w's entry | starts before it,
                                       // per tile entry state
  uint32_t tile_fn[kStates];           // exit | starts << 16
  int warp_off[kWarps];                // warp w's first start in the tile
  int job, entry_state, entry_rank, last_rank;
};
static_assert(kWarps * kRun <= kRunRows * kPitch, "the runs fit f rows 0-15");
static_assert(32 * kStates <= (kStates - kRunRows) * kPitch,
              "the look-back's stage fits f rows 16-19");

// Word t's trajectory entry for warp entry state s: the halves of f row
// 20 + s / 2, column t.
__device__ __forceinline__ uint16_t& traj_half(ChainShared& sh, int t, int s) {
  return reinterpret_cast<uint16_t*>(
      sh.f + (kStates + (s >> 1)) * kPitch + t)[s & 1];
}

// Word j's starts from its warp's entry state ws, each symbol at its local
// rank in the warp's run (f rows 0-15, free once the functions are
// composed): lr the word's first, n its starts, nbelow those below bit
// lim.  Every lane of the warp calls it.
__device__ __forceinline__ void emit_local(ChainShared& sh, uint32_t w,
                                           uint32_t nxt, int j, int n_words,
                                           long long lim, int warp, int lane,
                                           int ws, int& lr, int& n,
                                           int& nbelow) {
  int p = ws;
  lr = 0;
  if (lane) {
    const uint32_t tv = traj_half(sh, warp * 32 + lane - 1, ws);
    p = tv & 31u;
    lr = static_cast<int>(tv >> 5);
  }
  n = nbelow = 0;
  if (j >= n_words) return;
  uint32_t* run = sh.f + warp * kRun;
  const long long bit0 = 32LL * j;
  while (p < 32) {
    const uint32_t win = window_at(w, nxt, p);
    const int c = code_at(sh.segs, sh.lut, win);
    const int len = c & 31;
    run[lr + n] = static_cast<uint32_t>(
        (c >> 5) + static_cast<int>((win >> 12) >> (20 - len)));
    nbelow += bit0 + p < lim;
    ++n;
    p += len;
  }
}

// Warp 0: publishes the tile's composite, looks back to its entry (state,
// rank) and publishes its inclusive prefix; the entry goes to sh.  A lane
// a predecessor, 32 at a time, loads its status word and its composite at
// once; the composites of the run of predecessors whose composite is out,
// up to the nearest one whose inclusive prefix is out, are staged in f
// rows 16-19, and lanes 0-19, a state each, fold them earliest first.
__device__ void look_back(ChainShared& sh, uint32_t* __restrict__ agg,
                          unsigned long long* __restrict__ state, int b,
                          int tiles, int tile, int lane) {
  const size_t at = static_cast<size_t>(b) * tiles + tile;
  unsigned long long* status = state + 1 + static_cast<size_t>(b) * tiles;
  const uint32_t mine = lane < kStates ? sh.tile_fn[lane] : 0u;
  uint32_t* stage = sh.f + kRunRows * kPitch;
  int e_state = 0, e_rank = 0;
  if (tile > 0) {
    if (lane < kStates) st_relaxed32(agg + at * kStates + lane, mine | kOut);
    // g: from the state at boundary `base` to this tile's entry
    int g_state = lane, g_rank = 0, base = tile;
    while (true) {
      const int pj = base - 1 - lane;
      unsigned long long st = kInclusive;
      bool out = true;
      if (pj >= 0) {
        const uint32_t* row = agg + (static_cast<size_t>(b) * tiles + pj) *
                                        kStates;
        st = ld_relaxed(status + pj);
#pragma unroll
        for (int k = 0; k < kStates / 4; ++k) {
          const uint4 v = ld_volatile4(row + 4 * k);
          out &= (v.x & v.y & v.z & v.w & kOut) != 0;
          reinterpret_cast<uint4*>(stage + lane * kStates)[k] = v;
        }
      }
      const bool inc = (st & 3u) == kInclusive;
      const unsigned ready = __ballot_sync(kFull, out || inc);
      const unsigned incl = __ballot_sync(kFull, inc);
      const int run = ready == kFull ? 32 : __ffs(~ready) - 1;
      const int first = incl ? __ffs(incl) - 1 : 32;
      const int n = first < run ? first : run;
      __syncwarp();
      int s = lane, r = 0;
      if (lane < kStates) {
        for (int i = n - 1; i >= 0; --i) {
          const uint32_t v = stage[i * kStates + s] & ~kOut;
          s = static_cast<int>(v & 0xFFFFu);
          r += static_cast<int>(v >> kAggBits);
        }
      }
      __syncwarp();
      const int gs = __shfl_sync(kFull, g_state, s);
      const int gr = __shfl_sync(kFull, g_rank, s);
      g_state = gs;
      g_rank = r + gr;
      base -= n;
      if (first < run) {
        const int is = pj >= 0 ? static_cast<int>((st >> 8) & 0xFFu) : 0;
        const int ir = pj >= 0 ? static_cast<int>(st >> 32) : 0;
        const int in_s = __shfl_sync(kFull, is, first);
        const int in_r = __shfl_sync(kFull, ir, first);
        e_state = __shfl_sync(kFull, g_state, in_s);
        e_rank = in_r + __shfl_sync(kFull, g_rank, in_s);
        break;
      }
    }
  }
  const uint32_t out = __shfl_sync(kFull, mine, e_state);
  if (lane == 0) {
    const unsigned long long exit_rank =
        static_cast<unsigned long long>(e_rank + (out >> kAggBits));
    st_relaxed(status + tile,
               kInclusive | ((out & 0xFFu) << 8) | (exit_rank << 32));
    sh.entry_state = e_state;
    sh.entry_rank = e_rank;
  }
}

// E1: one CTA a tile of 256 words of one stream.  state: a ticket counter,
// then the (B, tiles) status words; agg: (B, tiles, 20) u32, each tile's
// composite (exit | starts << 16 | kOut); both zeroed by the caller.
__global__ void __launch_bounds__(kTile, kScanCtas)
    chain_scan(const uint32_t* __restrict__ words, const int* __restrict__ nbits,
               const int* __restrict__ zone, const int* __restrict__ seg_tab,
               const int* __restrict__ lut_tab, int n_words, int tiles,
               int batch, int s_max, unsigned long long* __restrict__ state,
               uint32_t* __restrict__ agg, int* __restrict__ syms,
               int* __restrict__ counts) {
  __shared__ ChainShared sh;
  const int t = threadIdx.x, warp = t >> 5, lane = t & 31;
  if (t == 0) sh.job = static_cast<int>(atomicAdd(state, 1ull));
  __syncthreads();
  const int tile = sh.job / batch, b = sh.job % batch;
  const int z = zone[b] != 0;
  load_segs(sh.segs, seg_tab, z);
  reinterpret_cast<int4*>(sh.lut)[t] =
      reinterpret_cast<const int4*>(lut_tab + z * kLut)[t];
  const uint32_t* row = words + static_cast<size_t>(b) * n_words;
  const int j = tile * kTile + t;
  const uint32_t w = j < n_words ? row[j] : 0u;
  const uint32_t nxt = j + 1 < n_words ? row[j + 1] : 0u;
  __syncthreads();

  // each word's walk from every offset, right to left; the lengths first,
  // independent lookups
  if (j < n_words) {
    int len[32];
#pragma unroll
    for (int p = 0; p < 32; ++p)
      len[p] = code_at(sh.segs, sh.lut, window_at(w, nxt, p)) & 31;
#pragma unroll
    for (int p = 31; p >= 0; --p) {
      const int q = p + len[p];
      sh.f[p * kPitch + t] =
          q >= 32 ? static_cast<uint32_t>(q - 32) | (1u << 8)
                  : sh.f[q * kPitch + t] + (1u << 8);
    }
  } else {
    for (int p = 0; p < kStates; ++p) sh.f[p * kPitch + t] = p;
  }
  __syncwarp();
  // lanes 0-19 walk the warp's words from every entry state, keeping the
  // trajectory (rows 20-29 are free once the warp's rows 0-19 are read
  // only)
  if (lane < kStates) {
    uint32_t s = lane, starts = 0;
    for (int i = 0; i < 32; ++i) {
      const int c = warp * 32 + i;
      const uint32_t v = sh.f[s * kPitch + c];
      starts += v >> 8;
      s = v & 0xFFu;
      traj_half(sh, c, lane) = static_cast<uint16_t>(s | (starts << 5));
    }
    sh.warp_fn[warp][lane] = s | (starts << 8);
  }
  __syncthreads();
  if (t < kStates) {
    uint32_t s = t, starts = 0;
    for (int v = 0; v < kWarps; ++v) {
      sh.warp_in[v][t] = s | (starts << 8);
      const uint32_t x = sh.warp_fn[v][s];
      starts += x >> 8;
      s = x & 0xFFu;
    }
    sh.tile_fn[t] = s | (starts << kAggBits);
  }
  __syncthreads();

  // Warps 1-7 whose entry state is the same from every tile entry state
  // (the chains have met, as they do within a few codewords) emit now,
  // into their shared-memory run at local ranks, while warp 0 publishes
  // the composite and looks back; warp 0 and the others emit once the
  // tile's entry is out.  The runs are then copied to the tile's ranks.
  bool early = false;
  if (warp > 0) {
    const uint32_t w0 = sh.warp_in[warp][0] & 0xFFu;
    early = __all_sync(kFull, lane >= kStates ||
                                  (sh.warp_in[warp][lane] & 0xFFu) == w0);
  }
  int lr = 0, n = 0, nbelow = 0;
  const long long lim = nbits[b];
  if (warp == 0) {
    look_back(sh, agg, state, b, tiles, tile, lane);
  } else if (early) {
    emit_local(sh, w, nxt, j, n_words, lim, warp, lane,
               sh.warp_in[warp][0] & 0xFFu, lr, n, nbelow);
  }
  __syncthreads();
  const int e = sh.entry_state, base_rank = sh.entry_rank;
  if (!early)
    emit_local(sh, w, nxt, j, n_words, lim, warp, lane,
               sh.warp_in[warp][e] & 0xFFu, lr, n, nbelow);
  const int word_rank =
      base_rank + static_cast<int>(sh.warp_in[warp][e] >> 8) + lr;
  const int limit_word = lim <= 0 ? 0
      : static_cast<int>(min(lim >> 5, static_cast<long long>(n_words - 1)));
  if (j == limit_word) counts[b] = word_rank + nbelow;
  if (j == n_words - 1) sh.last_rank = word_rank + n;
  if (t < kWarps) sh.warp_off[t] = static_cast<int>(sh.warp_in[t][e] >> 8);
  __syncthreads();
  // the tile's symbols at ranks base_rank + g, g < its starts
  int* out = syms + static_cast<size_t>(b) * s_max;
  const int total = static_cast<int>(sh.tile_fn[e] >> kAggBits);
  for (int g = t; g < total && base_rank + g < s_max; g += kTile) {
    int v = 0;
#pragma unroll
    for (int k = 1; k < kWarps; ++k) v += g >= sh.warp_off[k];
    out[base_rank + g] =
        static_cast<int>(sh.f[v * kRun + g - sh.warp_off[v]]);
  }
  // the zeros past the chain's last start: 16-byte stores between a
  // scalar head and tail
  if (tile == tiles - 1) {
    __syncthreads();
    const int from = sh.last_rank;
    if (from < s_max) {
      const int lead = min(static_cast<int>(
          ((16u - (reinterpret_cast<uintptr_t>(out + from) & 15u)) & 15u) / 4),
          s_max - from);
      if (t < lead) out[from + t] = 0;
      const int start = from + lead, nvec = (s_max - start) / 4;
      int4* v = reinterpret_cast<int4*>(out + start);
      for (int i = t; i < nvec; i += kTile) v[i] = make_int4(0, 0, 0, 0);
      const int tail = start + 4 * nvec + t;
      if (tail < s_max) out[tail] = 0;
    }
  }
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
// for the zone mode; seg_tab: (2, 3, 32) int32; lut: (2, 1024) int32, the
// length table (16-byte aligned); state: (1 + B tiles) u64, the ticket and
// the tiles' status words, and agg: (B, tiles, 20) u32 (16-byte aligned),
// the tiles' composites, both zeroed by the caller (tiles = ceil(W /
// 256)); syms: (B, s_max) int32 and counts: (B,) int32, both written
// whole.
int nhw_chain_starts(const void* words, const void* nbits, const void* zone,
                     const void* seg_tab, const void* lut, void* state,
                     void* agg, void* syms, void* counts, int batch,
                     int n_words, int s_max, void* stream) {
  if (batch < 1 || batch > 65535 || n_words < 1 || s_max < 1)
    return cudaErrorInvalidValue;
  if (misaligned4({words, nbits, zone, seg_tab, syms, counts}) ||
      reinterpret_cast<uintptr_t>(lut) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(agg) % 16 != 0 ||
      reinterpret_cast<uintptr_t>(state) % 8 != 0)
    return cudaErrorMisalignedAddress;
  const int tiles = (n_words + kTile - 1) / kTile;
  if (static_cast<long long>(tiles) * batch > (1LL << 31) - 1)
    return cudaErrorInvalidValue;
  chain_scan<<<tiles * batch, kTile, 0, static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint32_t*>(words), static_cast<const int*>(nbits),
      static_cast<const int*>(zone), static_cast<const int*>(seg_tab),
      static_cast<const int*>(lut), n_words, tiles, batch, s_max,
      static_cast<unsigned long long*>(state), static_cast<uint32_t*>(agg),
      static_cast<int*>(syms), static_cast<int*>(counts));
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
