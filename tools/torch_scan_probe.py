"""Device times of the port's S1 (snap passes), S2 (offset_y), S3
(merge_crossing), S4 (pair promotion), S5 (column ladder), S6
(classify), S7 (ll2_code_y), S9 (uv_sentinel), S10 (offset_y_low4), S11
(the lowest-q cleanup), S12 (the very-low-q cleanup), S14 (the chroma LL
smoothing), the decode's mark scan and E1 (chain_starts, the Y and the
UV words) on the q20 batch (S10 on q16, S11 on q13, S12 on q12, S14 on
q8 planes), for one tree of the repo, and the split of a kernel of S2-S5,
S7, S9-S12, S14, the mark scan or E1 between its phases.

Run from anywhere on a machine with a CUDA card:

    python3 tools/torch_scan_probe.py [--tree DIR] [--ladder-src FILE]
        [--offset-y-src FILE] [--uv-src FILE] [--ll2-src FILE]
        [--pp-src FILE] [--entropy-src FILE] [--merge-src FILE]
        [--lq-src FILE] [--merge-lq-only] [--oy4-src FILE]
        [--vlq-src FILE] [--oy4-vlq-only] [--marks-src FILE]
        [--uvs-src FILE] [--marks-uvs-only] [--dump DIR] [--batches]
        [--placement] [--sass] [--runs N]

``--tree`` is the root of the tree whose ``nhwcodec_tpu_torch`` and
``chip_smoke`` are measured (default: this script's repo).  The inputs
are the tree's own: ``chip_smoke``'s 16 encode images, their host
encodes at q20 captured by ``chip_smoke.StreamCapture``; S1 runs on the
captured Y planes before the snap passes, S2 on their output (the three
variants in turn), S5 on pair promotion's output of the captured E11
planes, S6 on the column ladder's output.  Times are CUDA events around
replays of a CUDA graph of 20 calls (``chip_smoke.graph_ms``): the three
snap variants as three ``snap_pass_device`` calls, and, where the tree has
``snap_passes_device``, as one call; ``offset_y_device`` (and, where the
tree has ``offset_y_sweeps``, the sweeps of its passes 2-3 per image);
``column_ladder_device``; ``classify_device``.

``--ladder-src`` takes a ``residue.cu`` of either column-ladder design,
patches ``%globaltimer`` stamps into a copy, builds it with ``nvcc`` for
sm_90a into a temporary directory, checks its output against the tree's
``column_ladder_device`` and reports per CTA, in µs from the CTA's start
(medians over CTAs and runs):

- one CTA an image (a thread a column, column 255 again after a block
  barrier): the end of the walk of columns 0..254 (with the copy of what
  the ladder leaves), of the barrier and its staging, of column 255's
  walk;
- 8 CTAs an image (``ladder_table`` first): the end of the staging, of
  the walk of the CTA's block (CTA 0 and the others apart), the start
  and end of column 255's walk in CTA 0, the write-back's start.

``--offset-y-src`` takes a ``scans.cu`` of the banded passes 2-3 (a
cluster of 8 CTAs an image, ``offset_y_bands``), patches stamps into a
copy the same way, checks its output against the tree's
``offset_y_device`` and reports, per CTA in µs from its start (medians
over CTAs and runs), the end of the staging with the range tests, of the
first sweep and of the kernel, on the snapped q20 planes and on
``chip_smoke.offset_y_relay_edge_planes`` (16 sweeps), with each input's
sweeps.

``--uv-src`` takes a ``uv.cu`` of either S9 design and ``--ll2-src`` an
``ll2.cu`` of either S7 design; each is stamped the same way, checked
against the tree's ``uv_sentinel_marking_device`` / ``ll2_code_y_scan``
and reported per CTA in µs from its start (medians over CTAs and runs):

- S9, one CTA an image (the rows in order): the end of the LL quadrant's
  copy, of row 0 and of the kernel;
- S9, a cluster of 8 CTAs an image (``uv_sentinel_rows``): the end of the
  staging, of the first round (its drifts exchanged) and of the kernel,
  and the mean cycles of a row's walk again (its SM's clock) and the walks
  again a CTA;
- S7, one CTA an image: the end of the marking and of the nudge scan;
- S7, a cluster of 8 CTAs an image (``ll2_code_y_bands``): the end of the
  staging, of the marking (with the cross-row tests), of the first sweep
  and of the kernel;

on the captured q20 planes (U and V for S9) and on the edge inputs that
take the most sweeps (``chip_smoke.uv_sentinel_edge_inputs`` "drift" and
"cta edges", ``chip_smoke.ll2_edge_planes`` "band edges"), with each
input's sweeps where the tree has ``uv_sentinel_sweeps`` /
``ll2_code_y_sweeps``.  Without the options, the JSON line also holds the
tree's S9 (U, V) and S7 (gt_low3 on) graph times on the q20 planes.

``--pp-src`` takes a ``residue.cu`` of either S4 design and
``--entropy-src`` an ``entropy.cu`` of either E1 design; each is stamped
the same way, checked against the tree's ``pair_promotion_device`` /
``chain_starts_batch`` and reported per CTA in µs from its start (medians
over CTAs and runs):

- S4, one thread a row (``pair_promotion``): the end of the copies of the
  columns outside the walk, and of the walk (the CTA's slowest thread);
- S4, a warp a row (``pair_promotion_rows``): the end of the row's
  staging (16-byte loads, unpacked), of the lane maps, of the warp scan,
  of the walk again, and of the store (the CTA's slowest warp);
- E1, three launches (``chain_tiles``, ``chain_entries``,
  ``chain_emit``): in chain_tiles the end of the per-word build and of
  the warp composites; in chain_emit the same, then the end of the
  words' entry walk and of the emission (``chain_entries`` is not
  stamped);
- E1, one launch (``chain_scan``): the end of the staging, of the
  per-word build (slowest warp), of the composites, of the look-back (the
  inclusive prefix out), of the emission (both phases: the warps whose
  chains have met before the look-back ends, the rest after it) and of
  the copy to the tile's ranks (slowest warp); the look-back's windows a
  CTA; and the share of warps 1-7 that emit early (from the twin);

on the q20 E11 planes (S4) and the q20 chunk's Y and UV words (E1; the
16 images' own host encodes).  ``--sass`` disassembles the tree's kernel
library with ``cuobjdump -sass`` and counts, for each S3, S4, S11 and E1
kernel, its instructions by class (shared, global, shuffle, branch,
barrier).

The JSON line also holds S3's graph times on the q20 streams (the
serpentine of offset_y's codes), ``chip_smoke.stream_edge_streams`` and,
where the tree has them, ``chip_smoke.merge_edge_streams``, and S11's on
the 4 planes captured from the tree's host encodes of
``chip_smoke.quality_batch(images, 13)``, 4 times (a batch of 16), and on
each ``chip_smoke.LQ_KINDS`` kind at batch 16.  ``--merge-src`` takes a
``scans.cu`` and ``--lq-src`` a ``lowq.cu`` of either design; each is
stamped (16 stamps a CTA), checked against the tree's wrapper on those
inputs and reported in µs:

- S3, three launches (``merge_tiles``, ``merge_entries``,
  ``merge_emit``): from a CTA's start, merge_tiles' staging, maps and
  warp composites; merge_entries' walk; merge_emit's staging, rebuilt
  maps and composites, the entries handed down, the walk and the stores;
  and on a timeline from the first CTA's start, each launch's start and
  end;
- S3, one cluster launch (``merge_crossing``): from a CTA's start, the
  step masks, the maps, the warp scans, the cluster barrier passed, the
  walk again, the stores and the tail copy;
- S11, three launches (``lq_a``, ``lq_maps``, ``lq_emit``): each one's
  staging and walk, and the timeline across them;
- S11, one cluster launch (``lowest_q_rows``): from a CTA's start, loop
  A's rows, B + C's tables and maps, the CTA barrier, the cluster
  barrier and the end;

with the new designs' spread of CTA starts and their last CTA's end.
``--merge-lq-only`` skips every kernel but S3 and S11.  ``--batches``
adds their graph times on the first 1, 8, 14, 15 and 16 streams / planes,
and ``--placement`` where 16 clusters of 8 CTAs of 512 threads land
(each CTA's ``%smid``) with the most clusters resident, without dynamic
shared memory, with S11's and with enough for one CTA an SM.

``--oy4-src`` takes a ``scans.cu`` and ``--vlq-src`` a ``vlq.cu`` of
either design; with either, or ``--oy4-vlq-only``, the JSON line holds
S10's graph times on the 16 planes ``offset_y`` got in the tree's host
encodes at q16 and on each ``chip_smoke.OY4_KINDS`` kind, and S12's (the
whole ``very_low_q_cleanup_device``) on the 4 planes captured at q12 from
``chip_smoke.quality_batch(images, 12)``, 4 times, and on each
``chip_smoke.VLQ_KINDS`` kind at its first quality.  Each source is
stamped (16 stamps a CTA), checked against the tree's wrapper on those
inputs and reported in µs:

- S10, three launches (S2's pass 1, ``oy4_maps``, ``oy4_emit``): the
  maps' staging and walk from every entry state, then the emit's start on
  a timeline, its chain of the row maps and its walk again;
- S10, ``oy4_rows``: from a CTA's start, the row loaded, the tables and
  lane maps, the warp scan, the look-back's start and its entry, the
  walk again, the codes and the stores (the slowest warp), with the
  spread of the CTAs' starts and the last CTA's end;
- S12, one launch of passes 1-3 (``vlq_passes``): the staging, pass 1,
  each wave pass (and its ns a step), the quadrant back, the masks;
- S12, ``vlq_rows`` + ``vlq_far``: the staging, pass 1, passes 2 and 3
  (and their ns a step), the stale carry, pass 4 and the masks, the
  quadrant out and the end of ``vlq_far``.

``--oy4-vlq-only`` skips every other kernel, ``--dump`` saves the raw
stamps of S10 and S12 (runs x CTAs x 16, ns) as ``.npy`` files, and
``--sass`` covers both designs of both.

``--marks-src`` takes a ``dwt.cu`` and ``--uvs-src`` a ``vlq.cu`` of
either design of the mark scan and S14; with either, or
``--marks-uvs-only``, the JSON line holds the mark scan's graph times
(clone + scan, and the clone alone) at batch 16 on the first three
``chip_smoke.MARK_KINDS`` inputs, as ``chip_smoke.mark_scan_phase``
draws them, and on the q20 chunk of the forced fallback's decode
(``chip_smoke.fallback_phase``), and S14's on the 8 U and V planes
captured at q8 from ``chip_smoke.quality_batch(images, 8)``, twice, and
on each
``chip_smoke.UVS_KINDS`` kind.  Each source is stamped (16 stamps a
CTA), checked against the tree's wrapper on those inputs and reported in
µs:

- the mark scan, a thread an image (``smooth_marks_seq``): the walk of
  the longest list from the CTA's start, and its ns a record;
- the mark scan, a band of 32 LL rows a CTA (``mark_rows``): from a CTA's
  start, the band staged; summed over the chunks, the loads and the
  bucketing, and the walk (with the longest row's records, the chain, and
  its ns a record); the stores; the spread of the CTAs' starts and the
  last CTA's end;
- either design of either kernel: the graph time of the stamped library's
  call (the plane's copy and the launch; for the mark scan the copy's
  alone beside it), the two designs' times within one call;
- S14, a barrier a step (``uv_smooth``): the staging, each pass (and its
  ns a step), the store;
- S14, the relay (``uvs_relay``): the staging, the walk (and its ns a
  step), each warp's share of the walk spent waiting at the barriers
  (its SM's clock), the store.

``--marks-uvs-only`` skips every other kernel; ``--sass`` covers both
designs of both (the given sources' counts are of their stamped builds).

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import re
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
STAMPS = 8
DUMP = None      # --dump: a directory for S10's and S12's raw stamps

STAMP_DEFS = r"""
#define NHW_PER 8
__device__ unsigned long long g_ladder_stamp[65536 * NHW_PER];
__device__ __forceinline__ unsigned long long nhw_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define NHW_STAMP(k)                                                    \
  (g_ladder_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * NHW_PER + (k)] = \
       nhw_now())
#define NHW_STAMP_MAX(k)                                                \
  atomicMax(&g_ladder_stamp[(blockIdx.y * gridDim.x + blockIdx.x) *     \
                            NHW_PER + (k)], nhw_now())
"""

# (anchor, text inserted before it, text inserted after it)
ONE_CTA_PATCHES = (
    ("  // what the ladder leaves: rows 257..511, row 256's right half, "
     "column 511\n",
     "  if (threadIdx.x == 0) NHW_STAMP(0);\n", ""),
    ("    InputSrc src{p, rf, j};\n    ladder_walk(j, p, src, o, ro, f);\n",
     "", "    atomicMax(&g_ladder_stamp[blockIdx.x * 8 + 1], nhw_now());\n"),
    ("    Col255Src src{s_v2, s_rf, s_bnd, s_c256, s_rf0};\n"
     "    ladder_walk(c, p, src, o, ro, f);\n",
     "    NHW_STAMP(2);\n", "    NHW_STAMP(3);\n"),
)
BLOCK_PATCHES = (
    ("  volatile int* progress = reinterpret_cast<volatile int*>(lsm + "
     "kLProgress);\n", "", "  if (t == 0) NHW_STAMP(0);\n"),
    ("  if (w == 0) {\n    BlockSrc src{lsm, lane, blk == 0 ? progress : "
     "nullptr};\n    ladder_walk(src, tab_s);\n",
     "  if (t == 0) NHW_STAMP(1);\n", "    if (lane == 0) NHW_STAMP(2);\n"),
    ("      Col255Src src{lsm, progress};\n      ladder_walk(src, tab_s);\n",
     "      NHW_STAMP(3);\n", "      NHW_STAMP(4);\n"),
    ("  for (int i = t; i < kLPfRows * kLBlock; i += kLThreads) {\n",
     "  if (t == 0) NHW_STAMP(5);\n", ""),
)

OFFSET_Y_PATCHES = (
    ("  const int r0 = rank * kOyRows;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  cluster.sync();        // staged, every peer started\n",
     "  __syncthreads();\n  if (t == 0) NHW_STAMP(1);\n", ""),
    ("    pend = offset_y_band(st.rows, st.flags, st.tab, band_img, br, lane, "
     "0);\n", "",
     "  if (lane == 0)\n    atomicMax(&g_ladder_stamp[(blockIdx.y * gridDim.x "
     "+ blockIdx.x) * 8 + 2], nhw_now());\n"),
    ("  // row 255's vertical writes land in plane row 256\n",
     "  __syncthreads();\n  if (t == 0) NHW_STAMP(3);\n", ""),
)

# S9: a cluster of 8 CTAs an image; stamps 4 and 5 sum the cycles and the
# count of the rows' walks after the first
UV_ROWS_PATCHES = (
    ("  const size_t img = static_cast<size_t>(blockIdx.y) * kPlane;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  cluster.sync();        // staged, every peer started\n",
     "", "  if (t == 0) NHW_STAMP(1);\n"),
    ("    cluster.sync();\n    uint32_t bits[4];\n",
     "", "    if (s == 0 && t == 0) NHW_STAMP(2);\n"),
    ("        drift = uv_row(st.rf, k * kLanes + drifts, lane, res_uv, v);"
     "\n", "        const long long c0 = clock64();\n",
     "        if (lane == 0) {\n          unsigned long long* base = "
     "g_ladder_stamp + (blockIdx.y * gridDim.x + blockIdx.x) * 8;\n"
     "          atomicAdd(base + 4, "
     "static_cast<unsigned long long>(clock64() - c0));\n"
     "          atomicAdd(base + 5, 1ull);\n"
     "        }\n"),
    ("  int16_t* o = out + img;\n", "  if (t == 0) NHW_STAMP(3);\n", ""),
)
# S9: one CTA an image, the rows in order
UV_ONE_CTA_PATCHES = (
    ("  int16_t* o = out + static_cast<size_t>(blockIdx.x) * kPlane;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  if (j == 0) fire_s[0] = 0;\n",
     "", "  __syncthreads();\n  if (j == 0) NHW_STAMP(1);\n"),
    ("    count_start += kLanes + drift;\n  }\n",
     "    if (r == 0 && j == 0) NHW_STAMP(2);\n",
     "  if (j == 0) NHW_STAMP(3);\n"),
)
# S7: a cluster of 8 CTAs an image (stamp 4: the marking's end)
LL2_BANDS_PATCHES = (
    ("  const int r0 = rank * kYRows;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  const int gt = gt_low3 != 0;\n", "  if (t == 0) NHW_STAMP(1);\n", ""),
    ("  cluster.sync();        // staged and marked, every peer started\n",
     "", "  if (t == 0) NHW_STAMP(4);\n"),
    ("    const uint4 flags = ",
     "    if (s == 0 && t == 0) NHW_STAMP(2);\n", ""),
    ("  const size_t at = static_cast<size_t>(blockIdx.y) * kLLN + r0 * kLL;"
     "\n", "  if (t == 0) NHW_STAMP(3);\n", ""),
)
# S7: one CTA an image, the rows in order
LL2_ONE_CTA_PATCHES = (
    ("  uint8_t* io = is24 + static_cast<size_t>(blockIdx.x) * kLLN;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  if (t == 0) fire_s[0] = 0;\n  __syncthreads();\n",
     "", "  if (t == 0) NHW_STAMP(4);\n"),
    ("    io[r * kLL + j] = hi;\n  }\n",
     "", "  __syncthreads();\n  if (j == 0) NHW_STAMP(3);\n"),
)

# S4: one thread a row (stamp 1: the copies' end, 2: the walk's end)
PP_ONE_THREAD_PATCHES = (
    ("  const int g = blockIdx.x * kPPThreads + threadIdx.x;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("    for (int c = 0; c < kN; ++c) o[c] = p[c];\n",
     "", "    NHW_STAMP_MAX(2);\n"),
    ("  int left = p[c0 - 1], cur = p[c0];\n", "  NHW_STAMP_MAX(1);\n", ""),
    ("  o[c1] = static_cast<int16_t>(cur);\n", "", "  NHW_STAMP_MAX(2);\n"),
)
# S4: a warp a row (1 staged, 2 maps, 3 scan, 4 walked again, 5 stored;
# rows without a value of 5..8 or -8..-5 stop at 1)
PP_ROWS_PATCHES = (
    ("  if (g >= batch * kN) return;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  x[9] = __shfl_down_sync(kFull, x[1], 1);\n",
     "", "  if (lane == 0) NHW_STAMP_MAX(1);\n"),
    ("    map |= s << (4 * k);\n  }\n",
     "", "  if (lane == 0) NHW_STAMP_MAX(2);\n"),
    ("  const int before = __shfl_up_sync(kFull, map, 1);\n"
     "  int s = lane ? before & 15 : 0;\n",
     "  if (lane == 0) NHW_STAMP_MAX(3);\n", ""),
    ("  dst[band ? 32 + lane : lane] =\n      make_uint4(packed[0], packed[1], "
     "packed[2], packed[3]);\n", "  if (lane == 0) NHW_STAMP_MAX(4);\n",
     "  if (lane == 0) NHW_STAMP_MAX(5);\n"),
)
# E1, three launches: chain_tiles 0 start, 1 build, 2 composites;
# chain_emit 3 start, 4 build, 5 composites, 6 entries, 7 end
E1_THREE_PATCHES = (
    ("  uint32_t warp_fn[kWarps][kStates];   // exit | starts << 8, per warp\n",
     "", "  int stamp_base;\n"),
    ("  } else {\n    for (int p = 0; p < kStates; ++p) sh.f[p * kPitch + t] = "
     "p;\n  }\n  __syncthreads();\n",
     "", "  if (t == 0) NHW_STAMP(sh.stamp_base + 1);\n"),
    ("    sh.warp_fn[warp][lane] = s | (starts << 8);\n  }\n  __syncthreads();\n",
     "", "  if (t == 0) NHW_STAMP(sh.stamp_base + 2);\n"),
    ("  tile_functions(sh, words, seg_tab, zone[b] != 0, n_words, b, tile);\n"
     "  if (t < kStates) {\n",
     "  if (t == 0) {\n    sh.stamp_base = 0;\n    NHW_STAMP(0);\n  }\n", ""),
    ("  tile_functions(sh, words, seg_tab, zone[b] != 0, n_words, b, tile);\n"
     "  if (t == 0) {\n",
     "  if (t == 0) {\n    sh.stamp_base = 3;\n    NHW_STAMP(3);\n  }\n", ""),
    ("  const int p0 = word_state[t];\n",
     "", "  if (lane == 0) NHW_STAMP_MAX(6);\n"),
    ("  if (lane == 0 && below) atomicAdd(counts + b, below);\n",
     "", "  if (lane == 0) NHW_STAMP_MAX(7);\n"),
)
# E1, one launch: 0 ticket, 1 staged, 2 build, 3 composites, 4 look-back,
# 5 emitted (both phases), 6 copied, 7 look-back windows
E1_SCAN_PATCHES = (
    ("  if (t == 0) sh.job = static_cast<int>(atomicAdd(state, 1ull));\n",
     "", "  if (t == 0) NHW_STAMP(0);\n"),
    ("  const uint32_t nxt = j + 1 < n_words ? row[j + 1] : 0u;\n"
     "  __syncthreads();\n", "", "  if (t == 0) NHW_STAMP(1);\n"),
    ("  __syncwarp();\n  // lanes 0-19 walk the warp's words",
     "  if (lane == 0) NHW_STAMP_MAX(2);\n", ""),
    ("  // Warps 1-7 whose entry state is the same from every tile entry "
     "state\n", "  if (t == 0) NHW_STAMP(3);\n", ""),
    ("    sh.entry_state = e_state;\n", "    NHW_STAMP(4);\n", ""),
    ("  if (t < kWarps) sh.warp_off[t] = static_cast<int>(sh.warp_in[t][e] >> "
     "8);\n  __syncthreads();\n", "", "  if (t == 0) NHW_STAMP(5);\n"),
    ("  // the zeros past the chain's last start",
     "  if (lane == 0) NHW_STAMP_MAX(6);\n", ""),
    ("      const int pj = base - 1 - lane;\n",
     "      if (lane == 0)\n        atomicAdd(&g_ladder_stamp[(blockIdx.y * "
     "gridDim.x + blockIdx.x) * 8 + 7], 1ull);\n", ""),
)

STAMP_API = r"""
extern "C" int nhw_ladder_stamps(void* dst, int n, int reset) {
  if (reset) {
    static unsigned long long zero[65536 * NHW_PER];
    return cudaMemcpyToSymbol(g_ladder_stamp, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(dst, g_ladder_stamp,
                              sizeof(unsigned long long) * NHW_PER * n);
}
"""

# S3, three launches (merge_tiles 0 start, 1 staged, 2 maps, 3 warp
# composites, 4 end; merge_emit 5 start, 6 staged, 7 maps, 8 composites, 9
# entries handed down, 10 walked, 11 stored, 12 end; merge_entries 14 start
# and 15 end, on CTA (0, b)'s stamps)
MERGE_THREE_PATCHES = (
    ("  uint8_t warp_entry[kMWarps];\n", "", "  int stamp_base;\n"),
    ("    sh.v[i] = start + i < n ? s[base + start + i] : 0;\n"
     "  __syncthreads();\n", "",
     "  if (threadIdx.x == 0) NHW_STAMP(sh.stamp_base + 1);\n"),
    ("  sh.map[t] = f;\n  __syncthreads();\n", "",
     "  if (threadIdx.x == 0) NHW_STAMP(sh.stamp_base + 2);\n"),
    ("    sh.warp_fn[w][lane] = uint8_t(x);\n  }\n  __syncthreads();\n", "",
     "  if (threadIdx.x == 0) NHW_STAMP(sh.stamp_base + 3);\n"),
    ("  merge_build(sh, s, n, b, cta);\n  if (t < kMStates) {\n",
     "  if (t == 0) {\n    sh.stamp_base = 0;\n    NHW_STAMP(0);\n  }\n", ""),
    ("    comp[(static_cast<size_t>(b) * kMCtas + cta) * kMStates + t] = x;"
     "\n  }\n", "", "  NHW_STAMP_MAX(4);\n"),
    ("  const int* c = comp + static_cast<size_t>(b) * kMCtas * kMStates;\n",
     "", "  if (lane == 0)\n    g_ladder_stamp[b * kMCtas * NHW_PER + 14] = "
     "nhw_now();\n"),
    ("    st = __shfl_sync(0xFFFFFFFFu, val, st);\n  }\n", "",
     "  if (lane == 0)\n    g_ladder_stamp[b * kMCtas * NHW_PER + 15] = "
     "nhw_now();\n"),
    ("  merge_build(sh, s, n, b, cta);\n  if (t == 0) {\n",
     "  if (t == 0) {\n    sh.stamp_base = 5;\n    NHW_STAMP(5);\n  }\n", ""),
    ("      x = map_at(sh.map[w * 32 + l], x);\n    }\n  }\n"
     "  __syncthreads();\n", "", "  if (t == 0) NHW_STAMP(9);\n"),
    ("  auto value = [&](int q) -> uint8_t {\n", "  NHW_STAMP_MAX(10);\n", ""),
    ("  const int tail = n - kMLen;\n", "  NHW_STAMP_MAX(11);\n", ""),
    ("    if (gi < n) out[base + gi] = s[base + gi];\n  }\n", "",
     "  NHW_STAMP_MAX(12);\n"),
)
# S3, one cluster launch: 0 start, 1 step masks built (slowest warp), 2
# maps built, 3 warp scanned, 4 past the cluster barrier, 5 walked again,
# 6 stores issued, 7 the tail copied
MERGE_CLUSTER_PATCHES = (
    ("  const int g0 = rank * kMSpan + t * kMT;\n", "",
     "  if (t == 0) NHW_STAMP(0);\n"),
    ("  // the thread's map, and (for the CTA's last thread) its map over its"
     "\n", "  if (lane == 0) NHW_STAMP_MAX(1);\n", ""),
    ("  uint32_t inc = map5_then(p0, p1);\n", "",
     "  if (lane == 0) NHW_STAMP_MAX(2);\n"),
    ("  __syncthreads();\n  nhw::cluster_wait();         // every CTA of the "
     "cluster has started\n", "  if (lane == 0) NHW_STAMP_MAX(3);\n", ""),
    ("  // the CTA's entry state, and the previous CTA's fires at its last "
     "4\n", "  if (t == 0) NHW_STAMP(4);\n", ""),
    ("  const uint32_t up = __shfl_up_sync(kFull, fires[1] >> 28, 1);\n",
     "  if (lane == 0) NHW_STAMP_MAX(5);\n", ""),
    ("        dst[g0 + 4 * k + i] = static_cast<uint8_t>(v[k] >> (8 * i));\n"
     "  }\n", "", "  if (lane == 0) NHW_STAMP_MAX(6);\n"),
    ("      dst[kMLen + i] = src[kMLen + i];\n  }\n", "",
     "  if (lane == 0) NHW_STAMP_MAX(7);\n"),
)
# S11, three launches of a thread a row: lq_a 0 start, 1 staged, 2 walked,
# 3 end; lq_maps 4 start, 5 staged, 6 walked from both entries; lq_emit 7
# start, 8 staged and chained, 9 walked, 10 end
LQ_THREE_PATCHES = (
    ("  stage_r3ok(r3_ext + b * r3_len, r0 * kR3A + 128, kR3A, x.x4, x.x4, "
     "ok_s);\n  __syncthreads();\n", "  if (t == 0) NHW_STAMP(0);\n",
     "  if (t == 0) NHW_STAMP(1);\n"),
    ("  flags[b * kD + r0 + t] = z;\n", "", "  NHW_STAMP_MAX(2);\n"),
    ("  nhw::unstage_rows(s, kRows, out + b * kPlane, r0);\n", "",
     "  NHW_STAMP_MAX(3);\n"),
    ("  stage_bc(in + b * kPlane, r3_ext + b * r3_len, out + b * kPlane,\n",
     "  if (t == 0) NHW_STAMP(4);\n", ""),
    ("  const Seg sb = seg_b(x), sc = seg_c(x, gt_low10);\n"
     "  int16_t* row = s + t * kStagePitch + 1;\n"
     "  const uint32_t* ok = ok_s + t * kOkPitch;\n",
     "  if (t == 0) NHW_STAMP(5);\n", ""),
    ("  e[1] = bc_walk<false>(row, 0, ok, sb, sc, x.x5, pl0);\n", "",
     "  NHW_STAMP_MAX(6);\n"),
    ("  for (int i = t; i < kD * 2; i += kRows) exit_s[i] = exits[b * kD * 2 "
     "+ i];\n", "  if (t == 0) NHW_STAMP(7);\n", ""),
    ("  nhw::chain_entries<2>(exit_s, entry_s, kD);\n  __syncthreads();\n",
     "", "  if (t == 0) NHW_STAMP(8);\n"),
    ("  if (rt > 0 && flags[b * kD + rt - 1]) O[rt * kN] = 0;\n",
     "  NHW_STAMP_MAX(9);\n", ""),
    ("  nhw::unstage_rows(s, kRows, O, kD + r0);\n", "",
     "  NHW_STAMP_MAX(10);\n"),
)
# S11, one cluster launch: 0 start, 1 loop A's rows done (slowest warp), 2
# B + C's tables and maps, 3 the CTA synchronised, 4 past the cluster
# barrier, 5 B + C walked again and stored
LQ_CLUSTER_PATCHES = (
    ("  const int r0 = rank * kLqRows;\n", "",
     "  if (t == 0) NHW_STAMP(0);\n"),
    ("  // B + C, rows 256 + r0 + w and + 16: each visit's table, the lanes' "
     "maps\n", "  if (lane == 0) NHW_STAMP_MAX(1);\n", ""),
    ("  __syncthreads();\n  nhw::cluster_wait();         // every CTA of the "
     "cluster has started\n", "  if (lane == 0) NHW_STAMP_MAX(2);\n",
     "  if (t == 0) NHW_STAMP(3);\n"),
    ("  int e = (sh.pub[kLqCtas - 1] >> 15) & 7;   // row 256's entry\n",
     "  if (t == 0) NHW_STAMP(4);\n", ""),
    ("    dst[1] = make_uint4(o[4], o[5], o[6], o[7]);\n  }\n", "",
     "  if (lane == 0) NHW_STAMP_MAX(5);\n"),
)

# S10, three launches (S2's pass 1 unstamped): oy4_maps 0 start, 1 staged,
# 2 walked from every entry state (slowest thread); oy4_emit 3 start, 4
# staged and chained, 5 walked again (slowest thread)
OY4_THREE_PATCHES = (
    ("  const int r0 = blockIdx.x * kRows;\n", "",
     "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  const int k = threadIdx.x / kOy4States, e = threadIdx.x % kOy4States;"
     "\n", "  if (threadIdx.x == 0) NHW_STAMP(1);\n", ""),
    ("      oy4_walk<false>(s + k * nhw::kStagePitch + 1, r0 + k, e, m1, esc));"
     "\n", "", "  NHW_STAMP_MAX(2);\n"),
    ("  const int r0 = blockIdx.x * kRows, k = threadIdx.x;\n", "",
     "  if (k == 0) NHW_STAMP(3);\n"),
    ("  nhw::chain_entries<kOy4States>(map_s, entry_s, kN);\n"
     "  __syncthreads();\n", "", "  if (k == 0) NHW_STAMP(4);\n"),
    ("                 esc);\n  __syncthreads();\n", "",
     "  NHW_STAMP_MAX(5);\n"),
)
# S10, a warp a row (oy4_rows): 0 ticket, 1 loaded, 2 tables and lane maps,
# 3 warp scan, 8 look-back started, 4 its entry out, 5 walked again, 6
# codes, 7 stored (1-3, 5-7 the slowest warp)
OY4_ROWS_PATCHES = (
    ("  const int tile = sh.job / batch, b = sh.job % batch;\n", "",
     "  if (t == 0) NHW_STAMP(0);\n"),
    ("  const int c0 = kOy4Tile * lane;\n",
     "  if (lane == 0) NHW_STAMP_MAX(1);\n", ""),
    ("  for (int q = 0; q < 8; ++q) m |= uint32_t(s[q]) << (3 * q);\n", "",
     "  if (lane == 0) NHW_STAMP_MAX(2);\n"),
    ("  if (lane == 31) sh.row_map[w] = oy4_row_map(m);\n",
     "  if (lane == 0) NHW_STAMP_MAX(3);\n", ""),
    ("      const int pj = tile - 1 - lane;\n",
     "      if (lane == 0) NHW_STAMP(8);\n", ""),
    ("      sh.entry = e;\n", "", "      NHW_STAMP(4);\n"),
    ("  // the ticks before the lane: quant and quant6 from the row's start\n",
     "  if (lane == 0) NHW_STAMP_MAX(5);\n", ""),
    ("  uint4* dst = reinterpret_cast<uint4*>(out + static_cast<size_t>(b) * "
     "kPlane +\n", "  if (lane == 0) NHW_STAMP_MAX(6);\n", ""),
    ("  dst[1] = make_uint4(o[4], o[5], o[6], o[7]);\n", "",
     "  if (lane == 0) NHW_STAMP_MAX(7);\n"),
)
# S12, one launch of passes 1-3 (vlq_passes): 0 start, 1 staged, 2 pass 1,
# 3 pass 2, 4 pass 3, 5 the quadrant back, 6 the masks written
VLQ_ONE_PATCHES = (
    ("  for (int i = r; i < kMasks * kVlq * kMaskWords; i += kVlq) bits[i] = "
     "0;\n", "  if (r == 0) NHW_STAMP(0);\n", ""),
    ("  stage_corner(P, kN, kVlq, kVlqPitch, s);\n  __syncthreads();\n", "",
     "  if (r == 0) NHW_STAMP(1);\n"),
    ("  const bool any1 = __syncthreads_or(p1);\n", "",
     "  if (r == 0) NHW_STAMP(2);\n"),
    ("  const bool any2 = __syncthreads_or(p2);\n", "",
     "  if (r == 0) NHW_STAMP(3);\n"),
    ("  unstage_corner(s, kVlq, kVlqPitch, P, kN);\n",
     "  if (r == 0) NHW_STAMP(4);\n",
     "  __syncthreads();\n  if (r == 0) NHW_STAMP(5);\n"),
    ("           ((b >> 3) & 1u) << 24;\n  }\n", "",
     "  __syncthreads();\n  if (r == 0) NHW_STAMP(6);\n"),
)
# S12, vlq_rows + vlq_far: 0 start, 1 staged, 2 pass 1, 8 pass 2, 3 pass
# 3, 4 the stale carry, 5 pass 4 and the masks, 6 the quadrant out; 7
# vlq_far's last CTA's end
VLQ_RELAY_PATCHES = (
    ("  const size_t img = static_cast<size_t>(blockIdx.x) * kPlane;\n", "",
     "  if (r == 0) NHW_STAMP(0);\n"),
    ("  const bool any1 =\n", "  if (r == 0) NHW_STAMP(1);\n", ""),
    ("  WaveLane a, c;\n", "  if (r == 0) NHW_STAMP(2);\n", ""),
    ("  const bool any2 = __syncthreads_or(a.any);\n", "",
     "  if (r == 0) NHW_STAMP(8);\n"),
    ("  const int fh = c.fh, ff = c.ff;\n", "  if (r == 0) NHW_STAMP(3);\n",
     ""),
    ("  // pass 4's fires on the finished quadrant (q <= LOW9), columns "
     "0..125\n", "  if (r == 0) NHW_STAMP(4);\n", ""),
    ("  // the quadrant out\n", "  if (r == 0) NHW_STAMP(5);\n", ""),
    ("        make_uint4(lo.x, lo.y, hi.x, hi.y);\n  }\n", "",
     "  __syncthreads();\n  if (r == 0) NHW_STAMP(6);\n"),
    ("        make_uint4(wd[0] & keep[0], wd[1] & keep[1], wd[2] & keep[2],\n"
     "                   wd[3] & keep[3]);\n  }\n", "",
     "  atomicMax(&g_ladder_stamp[blockIdx.y * NHW_PER + 7], nhw_now());\n"),
)
# the mark scan, a thread an image (smooth_marks_seq): 0 start, 5 the
# last walk's end
MARKS_SEQ_PATCHES = (
    ("  const int b = blockIdx.x * blockDim.x + threadIdx.x;\n"
     "  if (b >= batch) return;\n", "",
     "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("          nhw::wrap16(nhw::asr(c * 4 + le + ri + up + dn + 4, 3)));\n"
     "  }\n", "", "  NHW_STAMP_MAX(5);\n"),
)
# the mark scan, a band a CTA (mark_rows): 0 start, 1 staged, 5 stored;
# summed over the chunks (ns): 2 the loads and the bucketing, 3 the walk;
# 4 the longest row's records summed over the chunks, 6 the chunks
MARKS_ROWS_PATCHES = (
    ("  // round u of a chunk takes its records u kMsThreads + t\n",
     "  if (t == 0) NHW_STAMP(0);\n"
     "  unsigned long long ps_t = 0, ps_c = 0, ps_w = 0, ps_n = 0, ps_k = 0;"
     "\n", ""),
    ("  bool touched = false;\n", "  NHW_STAMP_MAX(1);\n", ""),
    ("    int r[kMsPer], lr[kMsPer], rank[kMsPer];\n",
     "    ps_t = nhw_now();\n    ++ps_k;\n", ""),
    ("    if (w == 0) {\n      // lane = the band's row; its records in list "
     "order",
     "    if (t == 0) {\n      const unsigned long long n_ = nhw_now();\n"
     "      ps_c += n_ - ps_t;\n      ps_t = n_;\n    }\n", ""),
    ("      touched |= n > 0;\n", "", "      ps_n += most;\n"),
    ("    __syncthreads();   // the counts and the bucket are the next "
     "chunk's\n", "", "    if (t == 0) ps_w += nhw_now() - ps_t;\n"),
    ("        make_uint4(d[0], d[1], d[2], d[3]);\n  }\n", "",
     "  NHW_STAMP_MAX(5);\n  if (t == 0) {\n    unsigned long long* nhw_b = "
     "g_ladder_stamp + (blockIdx.y * gridDim.x + blockIdx.x) * NHW_PER;\n"
     "    nhw_b[2] = ps_c;\n    nhw_b[3] = ps_w;\n    nhw_b[4] = ps_n;\n"
     "    nhw_b[6] = ps_k;\n  }\n"),
)
# S14, a barrier a step (uv_smooth): 0 start, 1 staged, 2 pass 2, 3 pass
# 3, 4 stored
UVS_ONE_PATCHES = (
    ("  stage_corner(P, kD, kUvs, kUvsPitch, s);\n",
     "  if (threadIdx.x == 0) NHW_STAMP(0);\n", ""),
    ("  wave_pass<kUvsPitch>(s, kUvs - 2, Wave{2, 5, 8, 2});\n",
     "  if (threadIdx.x == 0) NHW_STAMP(1);\n",
     "  if (threadIdx.x == 0) NHW_STAMP(2);\n"),
    ("  wave_pass<kUvsPitch>(s, kUvs - 2, Wave{3, 5, 8, 1});\n", "",
     "  if (threadIdx.x == 0) NHW_STAMP(3);\n"),
    ("  unstage_corner(s, kUvs, kUvsPitch, P, kD);\n", "",
     "  __syncthreads();\n  if (threadIdx.x == 0) NHW_STAMP(4);\n"),
)
# S14, the relay (uvs_relay): 0 start, 1 staged, 2 walked, 4 stored; SM
# cycles of warp w's walk at 12 + w, of its waits at the barriers at 8 + w
UVS_RELAY_PATCHES = (
    ("  UvsLane a{j0, 0, 0, 0, 0, 0, 0, 0, 0, 0};\n", "",
     "  long long nhw_wait = 0;\n  const long long nhw_w0 = clock64();\n"),
    ("      uvs_step<kVariant>(a, row_t, row_m, row_b, row_ok, lane == 0);\n",
     "",
     "    const long long nhw_c0 = clock64();\n"),
    ("    const long long nhw_c0 = clock64();\n    __syncthreads();\n", "",
     "    nhw_wait += clock64() - nhw_c0;\n"),
    ("    nhw_wait += clock64() - nhw_c0;\n  }\n", "",
     "  if (lane == 0) {\n    unsigned long long* nhw_b = g_ladder_stamp + "
     "blockIdx.x * NHW_PER + (threadIdx.x >> 5);\n"
     "    atomicAdd(nhw_b + 8, static_cast<unsigned long long>(nhw_wait));\n"
     "    atomicAdd(nhw_b + 12, static_cast<unsigned long long>(clock64() - "
     "nhw_w0));\n  }\n"),
    ("  const int w = t >> 5, lane = t & 31;\n",
     "  if (t == 0) NHW_STAMP(1);\n", ""),
    ("  int16_t* P = uv + static_cast<size_t>(blockIdx.x) * kUvPlane;\n"
     "  const int t = threadIdx.x;\n", "", "  if (t == 0) NHW_STAMP(0);\n"),
    ("  // the walks end on a barrier: every write is in\n",
     "  if (t == 0) NHW_STAMP(2);\n", ""),
    ("    *reinterpret_cast<uint4*>(P + row * kD + c) =\n"
     "        make_uint4(lo.x, lo.y, hi.x, hi.y);\n  }\n", "",
     "  __syncthreads();\n  if (t == 0) NHW_STAMP(4);\n"),
)

# the steps of a wave pass: a CTA barrier a step (one launch of passes
# 1-3); the relay's (csrc/vlq.cu kVlqSteps: 3 warps 69 steps apart, 191
# steps a warp, rounded up to 4)
VLQ_ONE_STEPS = 3 * 126 - 2
VLQ_RELAY_STEPS = 400

def blocks(src: str) -> bool:
    """Whether a residue.cu is the 8-CTAs-an-image design."""
    return "ladder_table" in src


def patch_stamps(src: str, patches, per: int = STAMPS) -> str:
    """A stamped copy of a kernel source: ``patches`` of (anchor, text
    before it, text after it); ``per`` stamps a CTA."""
    at = src.index("namespace {")
    src = (src[:at] + STAMP_DEFS.replace("#define NHW_PER 8",
                                         f"#define NHW_PER {per}")
           + src[at:])
    for anchor, before, after in patches:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_scan_probe: anchor not found once in "
                             f"the ladder source: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + STAMP_API


def build_stamped(src_path: Path, out_dir: Path, patches,
                  per: int = STAMPS, extra: tuple = ()):
    """The stamped library of a kernel source (with the sources ``extra``
    of its directory, whose symbols it calls, as they are)."""
    from torch.utils.cpp_extension import CUDA_HOME

    cu = out_dir / f"{src_path.stem}_stamped.cu"
    cu.write_text(patch_stamps(src_path.read_text(), patches, per))
    lib = out_dir / f"lib{src_path.stem}_stamped.so"
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(src_path.parent), str(cu),
                    *(str(src_path.parent / e) for e in extra), "-o",
                    str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.nhw_ladder_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    dll.nhw_ladder_stamps.restype = ctypes.c_int
    return dll


def build_ladder(src_path: Path, out_dir: Path):
    """(the stamped column-ladder library, whether it is the 8-CTA
    design)."""
    new = blocks(src_path.read_text())
    dll = build_stamped(src_path, out_dir,
                        BLOCK_PATCHES if new else ONE_CTA_PATCHES)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_column_ladder.argtypes = [p] * (5 if new else 4) + [i] * 5 + [p]
    dll.nhw_column_ladder.restype = i
    return dll, new


def stamp_runs(dll, call, ctas: int, runs: int) -> np.ndarray:
    """(runs, ctas, STAMPS) µs from each CTA's first stamp."""
    import torch

    per_run = []
    stamps = np.zeros((ctas, STAMPS), np.uint64)
    for _ in range(runs):
        dll.nhw_ladder_stamps(None, ctas, 1)
        call()
        torch.cuda.synchronize()
        dll.nhw_ladder_stamps(stamps.ctypes.data, ctas, 0)
        s = stamps.astype(np.int64)
        per_run.append((s - s[:, :1]) / 1e3)
    return np.stack(per_run)


def raw_stamps(dll, call, ctas: int, runs: int,
               per: int = STAMPS) -> np.ndarray:
    """(runs, ctas, per) as the kernel left them (accumulators too)."""
    import torch

    out = []
    stamps = np.zeros((ctas, per), np.uint64)
    for _ in range(runs):
        dll.nhw_ladder_stamps(None, ctas, 1)
        call()
        torch.cuda.synchronize()
        dll.nhw_ladder_stamps(stamps.ctypes.data, ctas, 0)
        out.append(stamps.astype(np.int64))
    return np.stack(out)


def since_start(t: np.ndarray, k: int) -> float:
    """The median over runs and CTAs of stamp k in µs from stamp 0, over
    the CTAs that set it."""
    d = (t[..., k] - t[..., 0]) / 1e3
    d = d[t[..., k] > 0]
    return float(np.median(d)) if d.size else None


def uv_split(dll, rows: bool, inputs: dict, runs: int, cs) -> dict:
    """The stamped S9 on each input (process, rf_ext, res_uv): its output
    against the tree's uv_sentinel_marking_device, the sweeps, the stamps'
    medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_uv_sentinel.argtypes = [p, p, p, i, i, i, p]
    dll.nhw_uv_sentinel.restype = i
    out = {}
    for what, (x, rf, res_uv) in inputs.items():
        got = torch.empty_like(x)
        b = x.shape[0]

        def call():
            rc = dll.nhw_uv_sentinel(x.data_ptr(), rf.data_ptr(),
                                     got.data_ptr(), b, rf.shape[1], res_uv,
                                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.uv_sentinel_marking_device(x, rf,
                                                                res_uv)),
                 "the stamped uv_sentinel differs from the tree's")
        t = raw_stamps(dll, call, 8 * b if rows else b, runs)
        res = {"staged_us": since_start(t, 1),
               "first_us": since_start(t, 2), "end_us": since_start(t, 3),
               "ctas": int(t.shape[1]), "runs": runs,
               "event_ms": cs.median_ms(call)}
        if rows:
            walks = t[..., 5].sum()
            res["walk_again_cycles"] = (float(t[..., 4].sum() / walks)
                                        if walks else None)
            res["walks_again_per_cta"] = float(walks / t[..., 5].size)
        if hasattr(ds, "uv_sentinel_sweeps"):
            res["sweeps"] = ds.uv_sentinel_sweeps(x, rf, res_uv).tolist()
        out[what] = res
    return out


def ll2_split(dll, bands: bool, planes: dict, runs: int, cs) -> dict:
    """The stamped S7 on each plane (gt_low3 on): its output against the
    tree's ll2_code_y_scan, the sweeps, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_ll2_code_y.argtypes = [p, p, p, i, i, p]
    dll.nhw_ll2_code_y.restype = i
    out = {}
    for what, x in planes.items():
        b = x.shape[0]
        vem = torch.empty((b, 16384), dtype=torch.int32, device=x.device)
        is24 = torch.empty((b, 16384), dtype=torch.bool, device=x.device)

        def call():
            rc = dll.nhw_ll2_code_y(x.data_ptr(), vem.data_ptr(),
                                    is24.data_ptr(), b, 1,
                                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        want = ds.ll2_code_y_scan(x, True)
        cs.check(torch.equal(vem, want[0]) and torch.equal(is24, want[1]),
                 "the stamped ll2_code_y differs from the tree's")
        t = raw_stamps(dll, call, 8 * b if bands else b, runs)
        res = {"marked_us": since_start(t, 4), "end_us": since_start(t, 3),
               "ctas": int(t.shape[1]), "runs": runs,
               "event_ms": cs.median_ms(call)}
        if bands:
            res["staged_us"] = since_start(t, 1)
            res["first_sweep_us"] = since_start(t, 2)
        if hasattr(ds, "ll2_code_y_sweeps"):
            res["sweeps"] = ds.ll2_code_y_sweeps(x, True).tolist()
        out[what] = res
    return out


def build_design(src_path: Path, out_dir: Path, marker: str, new_patches,
                 old_patches, per: int = STAMPS, extra: tuple = ()):
    """(the stamped library of either design of a kernel source, whether
    it is the new design: ``marker`` in it)."""
    new = marker in src_path.read_text()
    return build_stamped(src_path, out_dir, new_patches if new
                         else old_patches, per, extra), new


def lq_inputs(cs, host_encoder, images, dev) -> dict:
    """S11's inputs, (plane, r3_ext, xs, q) each at batch 16: the 4 q13
    planes captured from the host copy's encodes of
    ``chip_smoke.quality_batch(images, 13)``, 4 times; and each
    ``chip_smoke.LQ_KINDS`` kind at the LOW7 thresholds."""
    import torch

    from nhwcodec_tpu_torch.models import device_encode_scans as des

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with cs.StreamCapture() as cap:
        for img in cs.quality_batch(images, 13):
            host_encoder.encode(img, 13)
    recs = [r for r in cap.records if "lq" in r]
    k = 16 // len(recs)
    out = {"q13 planes": (
        t(np.stack([r["e11"] for r in recs] * k)),
        t(np.stack([r["lq"]["r3"] for r in recs] * k)),
        t(np.array([r["lq"]["xs"] for r in recs] * k, np.int32)), 13)}
    rng = np.random.default_rng(cs.SEED + 70)
    xs = t(np.tile(np.array(des.LOW7_XS, np.int32), (16, 1)))
    for kind in cs.LQ_KINDS:
        x, r3 = cs.lowq_edge_inputs(rng, 16, kind)
        out[f"{kind} planes"] = (t(x), t(r3), xs, 13)
    return out


def offset_y_split(dll, planes: dict, runs: int, cs) -> dict:
    """The stamped passes 2-3 on each input: output against the tree's
    offset_y_device, the sweeps, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_offset_y.argtypes = [p, p, p, p, i, i, p]
    dll.nhw_offset_y.restype = i
    out = {}
    for what, x in planes.items():
        tmp, got = torch.empty_like(x), torch.empty_like(x)
        esc = ds._escape_table(x.device)

        def call():
            rc = dll.nhw_offset_y(x.data_ptr(), tmp.data_ptr(),
                                  got.data_ptr(), esc.data_ptr(), x.shape[0],
                                  8, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.offset_y_device(x, 8)),
                 "the stamped offset_y differs from the tree's")
        t = stamp_runs(dll, call, 8 * x.shape[0], runs)
        med = lambda v: float(np.median(v))             # noqa: E731
        out[what] = {"sweeps": ds.offset_y_sweeps(x).tolist(),
                     "staged_us": med(t[..., 1]),
                     "first_sweep_us": med(t[..., 2]),
                     "end_us": med(t[..., 3]), "ctas": 8 * x.shape[0],
                     "runs": runs}
    return out


def ladder_split(dll, new: bool, pp, rf_ext, flags, rs, runs: int,
                 cs) -> dict:
    """Run the stamped kernel ``runs`` times on (pp, rf_ext): its output
    against the tree's, and the per-CTA phase times."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    b = pp.shape[0]
    ctas = 8 * b if new else b
    out = torch.empty_like(pp)
    rf = torch.empty((b, 65536), dtype=torch.int16, device=pp.device)
    tab = torch.empty(17 * 15 * 12 * 16, dtype=torch.int16, device=pp.device)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [pp.data_ptr(), rf_ext.data_ptr(), out.data_ptr(),
                rf.data_ptr()] + ([tab.data_ptr()] if new else [])
        rc = dll.nhw_column_ladder(*ptrs, b, *flags, rs, stream)
        if rc:
            raise SystemExit(f"torch_scan_probe: stamped launch failed {rc}")

    call()
    torch.cuda.synchronize()
    want_p, want_rf = ds.column_ladder_device(pp, rf_ext, 20, rs)
    cs.check(torch.equal(out, want_p) and torch.equal(rf, want_rf),
             "the stamped ladder differs from the tree's column_ladder")
    t = stamp_runs(dll, call, ctas, runs)               # (runs, ctas, 8)
    med = lambda v: float(np.median(v))                 # noqa: E731
    if not new:
        return {"design": "one CTA an image", "walk_end_us": med(t[..., 1]),
                "barrier_end_us": med(t[..., 2]),
                "tail_end_us": med(t[..., 3]),
                "tail_us": med(t[..., 3] - t[..., 2]), "ctas": ctas,
                "runs": runs, "event_ms": cs.median_ms(call)}
    cta0, rest = t[:, ::8], np.concatenate([t[:, k::8] for k in range(1, 8)],
                                           1)
    return {"design": "8 CTAs an image", "staged_us": med(t[..., 1]),
            "walk_end_us": med(rest[..., 2]),
            "cta0_walk_end_us": med(cta0[..., 2]),
            "col255_start_us": med(cta0[..., 3]),
            "col255_end_us": med(cta0[..., 4]),
            "write_back_start_us": med(t[..., 5]),
            "last_write_back_start_us": med(t[..., 5].max(-1)),
            "ctas": ctas, "runs": runs, "event_ms": cs.median_ms(call)}


def since(t: np.ndarray, k: int, k0: int) -> float:
    """The median over runs and CTAs of stamp k in µs from stamp k0, over
    the CTAs that set both."""
    ok = (t[..., k] > 0) & (t[..., k0] > 0)
    d = (t[..., k] - t[..., k0])[ok] / 1e3
    return float(np.median(d)) if d.size else None


def pp_split(dll, rows: bool, planes: dict, runs: int, cs) -> dict:
    """The stamped S4 on each plane: its output against the tree's
    pair_promotion_device, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_pair_promotion.argtypes = [p, p, i, p]
    dll.nhw_pair_promotion.restype = i
    out = {}
    for what, x in planes.items():
        got = torch.empty_like(x)
        b = x.shape[0]

        def call():
            rc = dll.nhw_pair_promotion(
                x.data_ptr(), got.data_ptr(), b,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.pair_promotion_device(x)),
                 "the stamped pair_promotion differs from the tree's")
        ctas = b * 512 // 8 if rows else -(-b * 512 // 128)
        t = raw_stamps(dll, call, ctas, runs)
        res = {"ctas": ctas, "runs": runs, "event_ms": cs.median_ms(call)}
        if rows:
            res.update(staged_us=since_start(t, 1), maps_us=since_start(t, 2),
                       scan_us=since_start(t, 3),
                       walked_us=since_start(t, 4),
                       stored_us=since_start(t, 5))
        else:
            res.update(copies_us=since_start(t, 1),
                       walk_end_us=since_start(t, 2))
        out[what] = res
    return out


def e1_split(dll, scan: bool, cases: dict, runs: int, cs) -> dict:
    """The stamped E1 on each (words, nbits, zone, s_max): its output
    against the tree's chain_starts_batch, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_chain_starts.argtypes = [p] * (9 if scan else 8) + [i] * 3 + [p]
    dll.nhw_chain_starts.restype = i
    out = {}
    for what, (words, nbits, zone, s_max) in cases.items():
        b, w = words.shape
        dev = words.device
        tiles = -(-w // 256)
        syms = torch.zeros((b, s_max), dtype=torch.int32, device=dev)
        counts = torch.zeros(b, dtype=torch.int32, device=dev)
        seg = edd._seg_device(dev)
        if scan:
            state = torch.zeros(1 + b * tiles, dtype=torch.int64, device=dev)
            agg = torch.zeros((b, tiles, 20), dtype=torch.int32, device=dev)
            lut = torch.from_numpy(edd._length_table()).to(dev)
            ptrs = [seg.data_ptr(), lut.data_ptr(), state.data_ptr(),
                    agg.data_ptr()]
        else:
            comp = torch.empty((b, tiles, 20), dtype=torch.int32, device=dev)
            entry = torch.empty((b, tiles, 2), dtype=torch.int32, device=dev)
            ptrs = [seg.data_ptr(), comp.data_ptr(), entry.data_ptr()]

        def call():
            if scan:
                state.zero_()
                agg.zero_()
            else:
                syms.zero_()
                counts.zero_()
            rc = dll.nhw_chain_starts(
                words.data_ptr(), nbits.data_ptr(), zone.data_ptr(), *ptrs,
                syms.data_ptr(), counts.data_ptr(), b, w, s_max,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        want = edd.chain_starts_batch(words, nbits, zone, s_max)
        cs.check(torch.equal(syms, want[0]) and torch.equal(counts, want[1]),
                 f"the stamped chain_starts differs from the tree's: {what}")
        t = raw_stamps(dll, call, tiles * b, runs)
        res = {"ctas": tiles * b, "runs": runs,
               "event_ms": cs.median_ms(call)}
        if scan:
            warp_in = edd._chain_tiles(words, zone)[3] & 0xFF
            early = (warp_in[:, :, 1:] == warp_in[:, :, 1:, :1]).all(-1)
            res.update(staged_us=since(t, 1, 0), build_us=since(t, 2, 0),
                       composites_us=since(t, 3, 0),
                       lookback_us=since(t, 4, 0), emitted_us=since(t, 5, 0),
                       copied_us=since(t, 6, 0),
                       lookback_windows=float(np.median(t[..., 7])),
                       lookback_windows_max=int(t[..., 7].max()),
                       early_warps=float(early.double().mean()))
        else:
            res.update(tiles_build_us=since(t, 1, 0),
                       tiles_composites_us=since(t, 2, 0),
                       emit_build_us=since(t, 4, 3),
                       emit_composites_us=since(t, 5, 3),
                       emit_entries_us=since(t, 6, 3),
                       emit_end_us=since(t, 7, 3))
        out[what] = res
    return out


def since_launch(t: np.ndarray, k: int) -> float:
    """The median over runs and CTAs of stamp k in µs from the run's first
    stamp 0 (the launch's first CTA; for the designs of several launches,
    a timeline across them), over the CTAs that set it."""
    s0 = np.where(t[..., 0] > 0, t[..., 0], np.iinfo(np.int64).max)
    d = (t[..., k] - s0.min(axis=1, keepdims=True)) / 1e3
    d = d[t[..., k] > 0]
    return float(np.median(d)) if d.size else None


def skew(t: np.ndarray, k: int) -> dict:
    """Medians over runs of the spread of the CTAs' starts and of the
    last CTA's stamp k, µs from the run's first stamp 0."""
    s0 = np.where(t[..., 0] > 0, t[..., 0], np.iinfo(np.int64).max)
    first = s0.min(axis=1)
    return {"start_skew_us": float(np.median(
        (np.where(t[..., 0] > 0, t[..., 0], first[:, None]).max(1) - first)
        / 1e3)), "last_end_from_launch_us": float(np.median(
            (t[..., k].max(1) - first) / 1e3))}


PLACEMENT_SRC = r"""
#include <cuda_runtime.h>
// Each CTA records the SM it ran on, then waits ns nanoseconds so that
// the whole grid is resident at once.
__global__ void placed(int* smid, unsigned long long ns, int smem) {
  extern __shared__ unsigned char pad[];
  unsigned s;
  asm volatile("mov.u32 %0, %%smid;" : "=r"(s));
  unsigned long long t0, t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t0));
  do {
    asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  } while (t - t0 < ns);
  if (threadIdx.x == 0) {
    smid[blockIdx.y * gridDim.x + blockIdx.x] = s;
    if (smem) pad[0] = 1;
  }
}
// A launch of gx x gy CTAs of `threads` in clusters of `cluster` with
// `smem` bytes of dynamic shared memory: each CTA's SM into smid_host and
// cudaOccupancyMaxActiveClusters into max_clusters.
extern "C" int place(int threads, int smem, int cluster, int gx, int gy,
                     int* smid_host, int* max_clusters) {
  cudaFuncSetAttribute((const void*)placed,
                       cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  cudaLaunchAttribute a;
  a.id = cudaLaunchAttributeClusterDimension;
  a.val.clusterDim.x = cluster;
  a.val.clusterDim.y = 1;
  a.val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, 1, 1);
  cfg.blockDim = dim3(threads, 1, 1);
  cfg.dynamicSmemBytes = smem;
  cfg.attrs = &a;
  cfg.numAttrs = 1;
  int e = cudaOccupancyMaxActiveClusters(max_clusters, (const void*)placed,
                                         &cfg);
  if (e) return e;
  int* d;
  e = cudaMalloc(&d, sizeof(int) * gx * gy);
  if (e) return e;
  cfg.gridDim = dim3(gx, gy, 1);
  e = cudaLaunchKernelEx(&cfg, placed, d, 20000ull, smem);
  if (!e) e = cudaDeviceSynchronize();
  if (!e) e = cudaMemcpy(smid_host, d, sizeof(int) * gx * gy,
                         cudaMemcpyDeviceToHost);
  cudaFree(d);
  return e;
}
"""


def placement(out_dir: Path) -> dict:
    """Where a batch of 16 clusters of 8 CTAs lands: for S3's and S11's
    CTA shapes (512 threads; no dynamic shared memory, and S11's 70,052
    bytes) and for one CTA an SM (120,000 bytes), the most clusters
    resident and, from each CTA's %smid, the SMs used and how many CTAs
    each took."""
    import collections

    from torch.utils.cpp_extension import CUDA_HOME

    cu = out_dir / "placement.cu"
    cu.write_text(PLACEMENT_SRC)
    lib = out_dir / "libplacement.so"
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-O3",
                    "-shared", "-Xcompiler", "-fPIC", str(cu), "-o",
                    str(lib)], check=True)
    dll = ctypes.CDLL(str(lib))
    out = {}
    for smem in (0, 70052, 120000):
        smid = np.zeros(8 * 16, np.int32)
        most = ctypes.c_int(0)
        rc = dll.place(512, smem, 8, 8, 16, smid.ctypes.data_as(
            ctypes.c_void_p), ctypes.byref(most))
        if rc:
            raise SystemExit(f"torch_scan_probe: placement launch failed {rc}")
        per_sm = collections.Counter(smid.tolist())
        out[f"512 threads, {smem} bytes"] = {
            "max_active_clusters": most.value, "sms_used": len(per_sm),
            "ctas_per_sm": dict(collections.Counter(per_sm.values()))}
    return out


def batch_times(streams: dict, lq: dict, cs) -> dict:
    """S3's and S11's graph times on the first b streams / planes of the
    q20 streams and the q13 planes, b = 1, 8, 14, 15, 16: 16 clusters of
    8 do not fit at one CTA an SM."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    s = streams["q20 streams"]
    x, r3, xs, q = lq["q13 planes"]
    out = {}
    for b in (1, 8, 14, 15, 16):
        out[str(b)] = {
            "merge_crossing_graph_ms": cs.graph_ms(
                lambda: ds.merge_crossing_device(s[:b])),
            "lowest_q_graph_ms": cs.graph_ms(
                lambda: ds.lowest_q_band_cleanup_device(x[:b], r3[:b], q,
                                                        xs[:b]))}
    return out


def merge_split(dll, new: bool, streams: dict, runs: int, cs) -> dict:
    """The stamped S3 on each (B, n) stream: its output against the tree's
    merge_crossing_device, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_merge_crossing.argtypes = ([p, p, i, i, p] if new
                                       else [p, p, p, p, i, i, p])
    dll.nhw_merge_crossing.restype = i
    out = {}
    for what, x in streams.items():
        b, n = x.shape
        got = torch.empty_like(x)
        comp = torch.empty((b, 64, 5), dtype=torch.int32, device=x.device)
        entry = torch.empty((b, 64), dtype=torch.int32, device=x.device)

        def call():
            scratch = [] if new else [comp.data_ptr(), entry.data_ptr()]
            rc = dll.nhw_merge_crossing(
                x.data_ptr(), got.data_ptr(), *scratch, b, n,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.merge_crossing_device(x)),
                 f"the stamped merge_crossing differs from the tree's: {what}")
        ctas = (8 if new else 64) * b
        t = raw_stamps(dll, call, ctas, runs, 16)
        res = {"ctas": ctas, "runs": runs, "event_ms": cs.median_ms(call)}
        if new:
            res.update(design="one cluster launch",
                       masks_us=since_start(t, 1), maps_us=since_start(t, 2),
                       scanned_us=since_start(t, 3),
                       barrier_us=since_start(t, 4),
                       walked_us=since_start(t, 5),
                       stored_us=since_start(t, 6),
                       tail_us=since_start(t, 7),
                       end_from_launch_us=since_launch(t, 7), **skew(t, 7))
        else:
            first = t[:, ::64]            # CTA (0, b): merge_entries' stamps
            res.update(
                design="three launches",
                tiles_staged_us=since(t, 1, 0), tiles_maps_us=since(t, 2, 0),
                tiles_composites_us=since(t, 3, 0),
                tiles_end_us=since(t, 4, 0),
                tiles_end_from_launch_us=since_launch(t, 4),
                entries_us=float(np.median(
                    (first[..., 15] - first[..., 14]) / 1e3)),
                emit_start_from_launch_us=since_launch(t, 5),
                emit_staged_us=since(t, 6, 5), emit_maps_us=since(t, 7, 5),
                emit_composites_us=since(t, 8, 5),
                emit_handed_down_us=since(t, 9, 5),
                emit_walked_us=since(t, 10, 5),
                emit_stored_us=since(t, 11, 5), emit_end_us=since(t, 12, 5),
                end_from_launch_us=since_launch(t, 12))
        out[what] = res
    return out


def lq_split(dll, new: bool, inputs: dict, runs: int, cs) -> dict:
    """The stamped S11 on each (plane, r3_ext, xs, q): its output against
    the tree's lowest_q_band_cleanup_device, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_lowest_q_band_cleanup.argtypes = (
        [p, p, p, p, i, i, i, p] if new else [p, p, p, p, p, i, i, i, p])
    dll.nhw_lowest_q_band_cleanup.restype = i
    out = {}
    for what, (x, r3, xs, q) in inputs.items():
        b = x.shape[0]
        got = torch.empty_like(x)
        scratch = torch.empty((b, 768), dtype=torch.uint8, device=x.device)

        def call():
            extra = [] if new else [scratch.data_ptr()]
            rc = dll.nhw_lowest_q_band_cleanup(
                x.data_ptr(), r3.data_ptr(), xs.data_ptr(), got.data_ptr(),
                *extra, b, r3.shape[1], int(q > T.LOW10),
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.lowest_q_band_cleanup_device(x, r3, q,
                                                                  xs)),
                 f"the stamped lowest_q_band_cleanup differs from the "
                 f"tree's: {what}")
        t = raw_stamps(dll, call, 8 * b, runs, 16)
        res = {"ctas": 8 * b, "runs": runs, "event_ms": cs.median_ms(call)}
        if new:
            res.update(design="one cluster launch",
                       loop_a_us=since_start(t, 1),
                       bc_maps_us=since_start(t, 2),
                       synced_us=since_start(t, 3),
                       barrier_us=since_start(t, 4),
                       end_us=since_start(t, 5),
                       end_from_launch_us=since_launch(t, 5), **skew(t, 5))
        else:
            res.update(
                design="three launches",
                a_staged_us=since(t, 1, 0), a_walk_us=since(t, 2, 1),
                a_end_from_launch_us=since_launch(t, 3),
                maps_start_from_launch_us=since_launch(t, 4),
                maps_staged_us=since(t, 5, 4), maps_walk_us=since(t, 6, 5),
                maps_end_from_launch_us=since_launch(t, 6),
                emit_start_from_launch_us=since_launch(t, 7),
                emit_chained_us=since(t, 8, 7), emit_walk_us=since(t, 9, 8),
                emit_end_us=since(t, 10, 7),
                end_from_launch_us=since_launch(t, 10))
        out[what] = res
    return out


def oy4_vlq_inputs(cs, host_encoder, images, dev) -> tuple:
    """S10's inputs (plane at batch 16: the 16 planes offset_y got in the
    host copy's encodes at q16, and each ``chip_smoke.OY4_KINDS`` kind)
    and S12's ((plane, q) at batch 16: the 4 planes captured at q12 from
    ``chip_smoke.quality_batch(images, 12)``, 4 times, and each
    ``chip_smoke.VLQ_KINDS`` kind at its first quality)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    with cs.StreamCapture() as cap:
        for img in images:
            host_encoder.encode(img, 16)
        for img in cs.quality_batch(images, 12):
            host_encoder.encode(img, 12)
    oy = {"q16 planes": t(np.stack([r["oy"]["in"] for r in cap.records
                                    if "oy" in r and r["oy"]["q"] == 16]))}
    rng = np.random.default_rng(cs.SEED + 70)
    for kind in cs.OY4_KINDS:
        oy[f"{kind} planes"] = t(cs.oy4_edge_planes(rng, 16, kind))
    recs = [r for r in cap.records if "vlq" in r]
    vlq = {"q12 planes": (t(np.stack([r["vlq"]["in"] for r in recs]
                                     * (16 // len(recs)))), 12)}
    rng = np.random.default_rng(cs.SEED + 80)
    for kind in cs.VLQ_KINDS:
        vlq[f"{kind} planes"] = (t(cs.vlq_edge_planes(rng, 16, kind)),
                                 cs.VLQ_EDGE_QS[kind][0])
    return oy, vlq


def oy4_split(dll, new: bool, planes: dict, runs: int, cs) -> dict:
    """The stamped S10 on each plane: its output against the tree's
    offset_y_low4_device, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_offset_y_low4.argtypes = [p, p, p, p, p, i, i, p]
    dll.nhw_offset_y_low4.restype = i
    out = {}
    for what, x in planes.items():
        b = x.shape[0]
        tmp, got = torch.empty_like(x), torch.empty_like(x)
        scratch = (torch.empty(1 + 32 * b, dtype=torch.int32, device=x.device)
                   if new else torch.empty((b, 512, 5), dtype=torch.uint8,
                                           device=x.device))
        esc = ds._escape_table(x.device)

        def call():
            rc = dll.nhw_offset_y_low4(
                x.data_ptr(), tmp.data_ptr(), scratch.data_ptr(),
                got.data_ptr(), esc.data_ptr(), b, 8,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.offset_y_low4_device(x, 8)),
                 f"the stamped offset_y_low4 differs from the tree's: {what}")
        ctas = 32 * b if new else 16 * b
        t = raw_stamps(dll, call, ctas, runs, 16)
        if DUMP:
            np.save(Path(DUMP) / f"oy4_{'new' if new else 'old'}_"
                    f"{what.replace(' ', '_')}.npy", t)
        res = {"ctas": ctas, "runs": runs, "event_ms": cs.median_ms(call)}
        if new:
            res.update(design="a warp a row, a look-back",
                       loaded_us=since_start(t, 1),
                       tables_us=since_start(t, 2),
                       warp_scan_us=since_start(t, 3),
                       look_back_start_us=since_start(t, 8),
                       entry_us=since_start(t, 4),
                       walked_us=since_start(t, 5),
                       codes_us=since_start(t, 6),
                       stored_us=since_start(t, 7),
                       end_from_launch_us=since_launch(t, 7), **skew(t, 7))
        else:
            res.update(design="three launches",
                       maps_staged_us=since(t, 1, 0),
                       maps_walked_us=since(t, 2, 0),
                       emit_start_from_launch_us=since_launch(t, 3),
                       emit_chained_us=since(t, 4, 3),
                       emit_walked_us=since(t, 5, 3),
                       end_from_launch_us=since_launch(t, 5))
        out[what] = res
    return out


def vlq_split(dll, new: bool, inputs: dict, runs: int, cs) -> dict:
    """The stamped S12 on each (plane, q): its output against the tree's
    (the passes' plane for the one-launch design), the stamps' medians
    and each wave pass's time a step."""
    import torch

    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_very_low_q_cleanup.argtypes = (
        [p, p, p, i, i] + [i] * 7 + [p] if new else [p, p, i, i] + [i] * 4
        + [p])
    dll.nhw_very_low_q_cleanup.restype = i
    steps = VLQ_RELAY_STEPS if new else VLQ_ONE_STEPS
    out = {}
    for what, (x, q) in inputs.items():
        b = x.shape[0]
        xs7 = host_encoder._VLQ_THRX(q, None)
        low9 = int(q <= T.LOW9)
        got = torch.empty_like(x)
        masks = (torch.empty((b, ds.VLQ_MASK_WORDS), dtype=torch.int32,
                             device=x.device) if new else
                 torch.empty((b, 4, 128, 128), dtype=torch.uint8,
                             device=x.device))

        def call():
            st = torch.cuda.current_stream().cuda_stream
            if new:
                rc = dll.nhw_very_low_q_cleanup(
                    x.data_ptr(), got.data_ptr(), masks.data_ptr(), b, low9,
                    *map(int, xs7), st)
            else:
                got.copy_(x)
                rc = dll.nhw_very_low_q_cleanup(
                    got.data_ptr(), masks.data_ptr(), b, low9,
                    *map(int, xs7[:4]), st)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        want = (ds.very_low_q_cleanup_device(x, q, xs7) if new
                else ds.very_low_q_passes_device(x, q, xs7)[0])
        cs.check(torch.equal(got, want),
                 f"the stamped very_low_q_cleanup differs from the tree's: "
                 f"{what}")
        t = raw_stamps(dll, call, b, runs, 16)
        if DUMP:
            np.save(Path(DUMP) / f"vlq_{'new' if new else 'old'}_"
                    f"{what.replace(' ', '_')}.npy", t)
        res = {"ctas": b, "runs": runs, "q": q,
               "event_ms": cs.median_ms(call),
               "staged_us": since_start(t, 1), "pass1_us": since(t, 2, 1)}
        if new:
            res.update(
                design="a warp relay, then vlq_far",
                pass2_us=since(t, 8, 2), pass3_us=since(t, 3, 8),
                stale_us=since(t, 4, 3),
                pass4_masks_us=since(t, 5, 4),
                quadrant_out_us=since(t, 6, 5),
                far_end_from_rows_end_us=since(t, 7, 6),
                end_from_launch_us=since_launch(t, 7), **skew(t, 7))
        else:
            res.update(design="one launch, CTA barriers",
                       pass2_us=since(t, 3, 2), pass3_us=since(t, 4, 3),
                       unstage_us=since(t, 5, 4), masks_us=since(t, 6, 5),
                       end_from_launch_us=since_launch(t, 6))
        for k in ("pass2", "pass3"):
            res[f"{k}_ns_a_step"] = 1e3 * res[f"{k}_us"] / steps
        out[what] = res
    return out


def marks_uvs_inputs(cs, host_encoder, images, dev) -> tuple:
    """The mark scan's inputs ((x, recs, valid): the first three
    ``chip_smoke.MARK_KINDS`` inputs at batch 16 as ``mark_scan_phase``
    draws them, and the scan's own inputs in the forced fallback's decode
    of ``chip_smoke.fallback_streams``' 4 q20 streams) and S14's (planes
    at batch 16: the 8 U and V planes captured at q8 from
    ``chip_smoke.quality_batch(images, 8)``, twice, and each
    ``chip_smoke.UVS_KINDS`` kind as ``vlq_kernel_phase`` draws them)."""
    import torch

    def t(a):
        return torch.from_numpy(np.ascontiguousarray(a)).to(dev)

    from nhwcodec_tpu_torch.models import device_decode as tdd

    rng = np.random.default_rng(cs.SEED + 90)
    marks = {f"{kind} marks": tuple(map(t, cs.mark_scan_inputs(rng, 16,
                                                                kind)))
             for kind in cs.MARK_KINDS[:3]}
    with cs.ScanCapture() as cap:
        tdd.decode_batch_device(cs.fallback_streams()[:4], device=dev)
    marks["q20 fallback chunk's marks"] = cap.calls[0]
    with cs.StreamCapture() as cap:
        for img in cs.quality_batch(images, 8):
            host_encoder.encode(img, 8)
    u = np.stack([p["in"] for r in cap.records if "uvs" in r
                  for p in r["uvs"]])
    uvs = {"q8 U and V planes": t(np.concatenate([u] * (16 // len(u))))}
    rng = np.random.default_rng(cs.SEED + 80)
    for kind in cs.VLQ_KINDS:
        cs.vlq_edge_planes(rng, 16, kind)
    for kind in cs.LL1_KINDS:
        cs.ll1_edge_planes(rng, 16, kind)
    for kind in cs.UVS_KINDS:
        uvs[f"{kind} planes"] = t(cs.uvs_edge_planes(rng, 16, kind))
    return marks, uvs


def marks_split(dll, rows: bool, inputs: dict, runs: int, cs) -> dict:
    """The stamped mark scan on each (x, recs, valid): its output against
    the tree's smooth_marks_seq, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.ops import dwt

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_smooth_marks_seq.argtypes = [p, p, p, i, i, p]
    dll.nhw_smooth_marks_seq.restype = i
    out = {}
    for what, (x, recs, valid) in inputs.items():
        b, k = recs.shape
        got = x.clone()

        def call():
            got.copy_(x)
            rc = dll.nhw_smooth_marks_seq(
                got.data_ptr(), recs.data_ptr(), valid.data_ptr(), k, b,
                torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, dwt.smooth_marks_seq(x.clone(), recs,
                                                       valid)),
                 f"the stamped smooth_marks_seq differs from the tree's: "
                 f"{what}")
        ctas = 8 * b if rows else (b + 31) // 32
        t = raw_stamps(dll, call, ctas, runs, 16)
        res = {"ctas": ctas, "runs": runs, "k": k,
               "event_ms": cs.median_ms(call),
               "copy_and_scan_graph_ms": cs.graph_ms(call),
               "copy_graph_ms": cs.graph_ms(lambda: got.copy_(x))}
        if rows:
            chain = t[..., 4] > 0
            res.update(design="a band of 32 rows a CTA",
                       staged_us=since(t, 1, 0),
                       loads_and_buckets_us=float(np.median(t[..., 2])) / 1e3,
                       walk_us=float(np.median(t[..., 3])) / 1e3,
                       chunks=float(np.median(t[..., 6])),
                       longest_row_records=int(t[..., 4].max()),
                       walk_ns_a_record=float(np.median(
                           t[..., 3][chain] / t[..., 4][chain])),
                       stored_us=since(t, 5, 0), **skew(t, 5))
        else:
            res.update(design="a thread an image", walk_us=since(t, 5, 0),
                       walk_ns_a_record=1e3 * since(t, 5, 0) / k)
        out[what] = res
    return out


def uvs_split(dll, relay: bool, planes: dict, runs: int, cs) -> dict:
    """The stamped S14 on each plane batch: its output against the tree's
    uv_ll_smooth_device, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_uv_ll_smooth.argtypes = [p, i, p]
    dll.nhw_uv_ll_smooth.restype = i
    steps = ds.uvs_steps() if relay else 3 * 62 - 2
    out = {}
    for what, x in planes.items():
        b = x.shape[0]
        got = x.clone()

        def call():
            got.copy_(x)
            rc = dll.nhw_uv_ll_smooth(got.data_ptr(), b,
                                      torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.uv_ll_smooth_device(x)),
                 f"the stamped uv_ll_smooth differs from the tree's: {what}")
        t = raw_stamps(dll, call, b, runs, 16)
        res = {"ctas": b, "runs": runs, "event_ms": cs.median_ms(call),
               "copy_and_smooth_graph_ms": cs.graph_ms(call),
               "staged_us": since(t, 1, 0)}
        if relay:
            walk = since(t, 2, 1)
            res.update(design="the relay, four warps", walk_us=walk,
                       steps=steps, ns_a_step=1e3 * walk / steps,
                       barrier_wait_share=[float(np.median(
                           t[..., 8 + w] / np.maximum(t[..., 12 + w], 1)))
                           for w in range(4)],
                       stored_us=since(t, 4, 2),
                       end_from_launch_us=since_launch(t, 4))
        else:
            res.update(design="a barrier a step", pass2_us=since(t, 2, 1),
                       pass3_us=since(t, 3, 2), stored_us=since(t, 4, 3),
                       end_from_launch_us=since_launch(t, 4))
            for k in ("pass2", "pass3"):
                res[f"{k}_ns_a_step"] = 1e3 * res[f"{k}_us"] / steps
        out[what] = res
    return out


SASS_KERNELS = ("pair_promotion", "chain_tiles", "chain_entries",
                "chain_emit", "chain_scan", "merge_tiles", "merge_entries",
                "merge_emit", "merge_crossing", "lq_a", "lq_maps", "lq_emit",
                "lowest_q_rows", "oy4_maps", "oy4_emit", "oy4_rows",
                "vlq_passes", "vlq_rows", "vlq_far", "smooth_marks_seq",
                "mark_rows", "uv_smooth", "uvs_relay")
SASS_CLASSES = {"shared": ("LDS", "STS", "ATOMS"),
                "global": ("LDG", "STG", "ATOMG", "RED", "LD.", "ST."),
                "shuffle": ("SHFL",), "vote": ("VOTE",),
                "branch": ("BRA", "BRX", "CALL", "RET"),
                "barrier": ("BAR", "WARPSYNC", "BSYNC", "BSSY")}


def sass_summary(lib: Path) -> dict:
    """Per S4/E1/S3/S11 kernel of the library: instruction counts by
    class, from ``cuobjdump -sass``."""
    from torch.utils.cpp_extension import CUDA_HOME

    tool = (str(Path(CUDA_HOME) / "bin" / "cuobjdump") if CUDA_HOME
            else "cuobjdump")
    text = subprocess.run([tool, "-sass", str(lib)], capture_output=True,
                          text=True, check=True).stdout
    out, name = {}, None
    for line in text.splitlines():
        line = line.strip()
        if line.startswith("Function :"):
            fn = line.split(":", 1)[1].strip()
            name = next((k for k in SASS_KERNELS
                         if k in fn and "_" + k + "_" not in fn), None)
            if name is not None:
                out[name] = {"instructions": 0, **{c: 0 for c in
                                                     SASS_CLASSES}}
            continue
        if name is None or not line.startswith("/*") or "*/" not in line:
            continue
        ins = line.split("*/", 1)[1].strip()
        if not ins or ins.startswith("/*"):
            continue
        op = re.match(r"(?:@!?U?P\w+\s+)?([A-Z0-9_.]+)", ins).group(1)
        out[name]["instructions"] += 1
        for c, ops in SASS_CLASSES.items():
            if op.startswith(ops):
                out[name][c] += 1
    return out


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--ladder-src", default=None)
    ap.add_argument("--offset-y-src", default=None)
    ap.add_argument("--uv-src", default=None)
    ap.add_argument("--ll2-src", default=None)
    ap.add_argument("--pp-src", default=None)
    ap.add_argument("--entropy-src", default=None)
    ap.add_argument("--merge-src", default=None)
    ap.add_argument("--lq-src", default=None)
    ap.add_argument("--merge-lq-only", action="store_true")
    ap.add_argument("--oy4-src", default=None)
    ap.add_argument("--vlq-src", default=None)
    ap.add_argument("--oy4-vlq-only", action="store_true")
    ap.add_argument("--marks-src", default=None)
    ap.add_argument("--uvs-src", default=None)
    ap.add_argument("--marks-uvs-only", action="store_true")
    ap.add_argument("--dump", default=None)
    ap.add_argument("--batches", action="store_true")
    ap.add_argument("--placement", action="store_true")
    ap.add_argument("--sass", action="store_true")
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    global DUMP
    DUMP = args.dump
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    from nhwcodec_tpu_torch.host.utils.container import parse_nhw

    images = cs.encode_images(np.random.default_rng(cs.SEED))
    with cs.StreamCapture() as cap:
        datas = [host_encoder.encode(img, 20) for img in images]
    st = cs.stack_records(cap.records)
    y = torch.from_numpy(st["y"]).to(dev)
    e11, res256, khead, resIII = cs.residue_inputs(st, dev)
    pp = ds.pair_promotion_device(e11)
    rf_ext = des._rf_ext(res256, khead, resIII)
    rs = host_encoder._res_setting(20)
    variants = des.snap_args(20)
    out = {"tree": str(tree), "batch": len(images)}
    if args.marks_src or args.uvs_src or args.marks_uvs_only:
        from nhwcodec_tpu_torch.ops import dwt

        marks, uvs = marks_uvs_inputs(cs, host_encoder, images, dev)
        for what, (x, r, v) in marks.items():
            out[f"smooth_marks_seq_graph_ms {what}"] = cs.graph_ms(
                lambda: dwt.smooth_marks_seq(x.clone(), r, v))
            out[f"clone_graph_ms {what}"] = cs.graph_ms(lambda: x.clone())
        for what, x in uvs.items():
            out[f"uv_ll_smooth_graph_ms {what}"] = cs.graph_ms(
                lambda: ds.uv_ll_smooth_device(x))
        if args.marks_src:
            with tempfile.TemporaryDirectory() as d:
                dll, rows = build_design(Path(args.marks_src).resolve(),
                                         Path(d), "mark_rows",
                                         MARKS_ROWS_PATCHES,
                                         MARKS_SEQ_PATCHES, per=16,
                                         extra=("analysis.cu",))
                out["marks_split"] = marks_split(dll, rows, marks, args.runs,
                                                 cs)
                if args.sass:
                    out["marks_sass_stamped"] = sass_summary(
                        Path(d) / f"lib{Path(args.marks_src).stem}_stamped.so")
        if args.uvs_src:
            with tempfile.TemporaryDirectory() as d:
                dll, relay = build_design(Path(args.uvs_src).resolve(),
                                          Path(d), "uvs_relay",
                                          UVS_RELAY_PATCHES, UVS_ONE_PATCHES,
                                          per=16)
                out["uvs_split"] = uvs_split(dll, relay, uvs, args.runs, cs)
                if args.sass:
                    out["uvs_sass_stamped"] = sass_summary(
                        Path(d) / f"lib{Path(args.uvs_src).stem}_stamped.so")
        if args.sass:
            from nhwcodec_tpu_torch.kernels import build

            out["sass"] = sass_summary(build.lib_path())
        if args.marks_uvs_only:
            print(json.dumps(out), flush=True)
            return 0
    if args.oy4_src or args.vlq_src or args.oy4_vlq_only:
        oy, vlq = oy4_vlq_inputs(cs, host_encoder, images, dev)
        for what, x in oy.items():
            out[f"offset_y_low4_graph_ms {what}"] = cs.graph_ms(
                lambda: ds.offset_y_low4_device(x, 8))
        for what, (x, q) in vlq.items():
            xs7 = host_encoder._VLQ_THRX(q, None)
            out[f"very_low_q_cleanup_graph_ms {what}"] = cs.graph_ms(
                lambda: ds.very_low_q_cleanup_device(x, q, xs7))
        if args.oy4_src:
            with tempfile.TemporaryDirectory() as d:
                dll, new = build_design(Path(args.oy4_src).resolve(),
                                        Path(d), "oy4_rows",
                                        OY4_ROWS_PATCHES, OY4_THREE_PATCHES,
                                        per=16)
                out["oy4_split"] = oy4_split(dll, new, oy, args.runs, cs)
        if args.vlq_src:
            with tempfile.TemporaryDirectory() as d:
                dll, new = build_design(Path(args.vlq_src).resolve(),
                                        Path(d), "vlq_rows",
                                        VLQ_RELAY_PATCHES, VLQ_ONE_PATCHES,
                                        per=16)
                out["vlq_split"] = vlq_split(dll, new, vlq, args.runs, cs)
        if args.sass:
            from nhwcodec_tpu_torch.kernels import build

            out["sass"] = sass_summary(build.lib_path())
        if args.oy4_vlq_only:
            print(json.dumps(out), flush=True)
            return 0
    snapped = y
    for a in variants:
        snapped = ds.snap_pass_device(snapped, *a)
    stream = torch.zeros((len(images), 6 * cs.SZ + 16), dtype=torch.uint8,
                         device=dev)
    stream[:, : 4 * cs.SZ] = ds.serpentine_y_device(
        ds.offset_y_device(snapped, 8))
    rng = np.random.default_rng(cs.SEED + 30)
    streams = {"q20 streams": stream, "edge streams": torch.from_numpy(
        cs.stream_edge_streams(rng, len(images))).to(dev)}
    for kind in getattr(cs, "MERGE_EDGE_KINDS", ()):
        streams[f"{kind} streams"] = torch.from_numpy(
            cs.merge_edge_streams(rng, len(images), kind)).to(dev)
    for what, x in streams.items():
        out[f"merge_crossing_graph_ms {what}"] = cs.graph_ms(
            lambda: ds.merge_crossing_device(x))
    lq = lq_inputs(cs, host_encoder, images, dev)
    for what, (x, r3, xs, q) in lq.items():
        out[f"lowest_q_graph_ms {what}"] = cs.graph_ms(
            lambda: ds.lowest_q_band_cleanup_device(x, r3, q, xs))
    if args.batches:
        out["by_batch"] = batch_times(streams, lq, cs)
    if args.placement:
        with tempfile.TemporaryDirectory() as d:
            out["placement"] = placement(Path(d))
    if args.merge_src:
        with tempfile.TemporaryDirectory() as d:
            dll, new = build_design(Path(args.merge_src).resolve(), Path(d),
                                    "    merge_crossing(const uint8_t*",
                                    MERGE_CLUSTER_PATCHES,
                                    MERGE_THREE_PATCHES, per=16)
            out["merge_split"] = merge_split(dll, new, streams, args.runs,
                                             cs)
    if args.lq_src:
        with tempfile.TemporaryDirectory() as d:
            dll, new = build_design(Path(args.lq_src).resolve(), Path(d),
                                    "lowest_q_rows", LQ_CLUSTER_PATCHES,
                                    LQ_THREE_PATCHES, per=16)
            out["lq_split"] = lq_split(dll, new, lq, args.runs, cs)
    if args.sass:
        from nhwcodec_tpu_torch.kernels import build

        out["sass"] = sass_summary(build.lib_path())
    if args.merge_lq_only:
        print(json.dumps(out), flush=True)
        return 0
    out["snap_three_calls_graph_ms"] = cs.graph_ms(
        lambda: [ds.snap_pass_device(y, *a) for a in variants])
    if hasattr(ds, "snap_passes_device"):
        out["snap_one_call_graph_ms"] = cs.graph_ms(
            lambda: ds.snap_passes_device(y, variants))
    out["column_ladder_graph_ms"] = cs.graph_ms(
        lambda: ds.column_ladder_device(pp, rf_ext, 20, rs))
    lp, lrf = ds.column_ladder_device(pp, rf_ext, 20, rs)
    lrf = lrf.reshape(-1, 256, 256)
    out["classify_graph_ms"] = cs.graph_ms(
        lambda: ds.classify_device(lp, lrf, 20, rs))
    snapped = y
    for a in variants:
        snapped = ds.snap_pass_device(snapped, *a)
    out["offset_y_graph_ms"] = cs.graph_ms(
        lambda: ds.offset_y_device(snapped, 8))
    if hasattr(ds, "offset_y_sweeps"):
        out["offset_y_sweeps"] = ds.offset_y_sweeps(snapped).tolist()
    sm = cs.stack_uv(cap.records)["sm"]
    uv = {f"q20 {'UV'[c]} planes": tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in x[:2])
        + (x[2],) for c, x in enumerate(sm)}
    for what, (x, rf, res_uv) in uv.items():
        out[f"uv_sentinel_graph_ms {what}"] = cs.graph_ms(
            lambda: ds.uv_sentinel_marking_device(x, rf, res_uv))
        if hasattr(ds, "uv_sentinel_sweeps"):
            out[f"uv_sentinel_sweeps {what}"] = ds.uv_sentinel_sweeps(
                x, rf, res_uv).tolist()
    ll2 = torch.from_numpy(cs.stack_ll2(cap.records, 20)["P"]).to(dev)
    out["ll2_code_y_graph_ms"] = cs.graph_ms(
        lambda: ds.ll2_code_y_scan(ll2, True))
    if hasattr(ds, "ll2_code_y_sweeps"):
        out["ll2_code_y_sweeps"] = ds.ll2_code_y_sweeps(ll2, True).tolist()
    out["pair_promotion_graph_ms"] = cs.graph_ms(
        lambda: ds.pair_promotion_device(e11))
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    cases = {k: v for k, v in cs.chain_cases(
        dev, [parse_nhw(d) for d in datas]).items()
        if k in (f"Y words, batch {len(images)}",
                 f"UV words, batch {len(images)}")}
    for what, a in cases.items():
        out[f"chain_starts_graph_ms {what}"] = cs.graph_ms(
            lambda: edd.chain_starts_batch(*a))
        out[f"chain_starts_shape {what}"] = [*a[0].shape, a[3]]
    if args.sass:
        from nhwcodec_tpu_torch.kernels import build

        out["sass"] = sass_summary(build.lib_path())
    if args.pp_src:
        with tempfile.TemporaryDirectory() as d:
            dll, rows = build_design(Path(args.pp_src).resolve(), Path(d),
                                     "pair_promotion_rows", PP_ROWS_PATCHES,
                                     PP_ONE_THREAD_PATCHES)
            out["pp_split"] = pp_split(dll, rows, {"q20 E11 planes": e11},
                                       args.runs, cs)
    if args.entropy_src:
        with tempfile.TemporaryDirectory() as d:
            dll, scan = build_design(Path(args.entropy_src).resolve(),
                                     Path(d), "    chain_scan(const uint32_t*", E1_SCAN_PATCHES,
                                     E1_THREE_PATCHES)
            out["e1_split"] = e1_split(dll, scan, cases, args.runs, cs)
    if args.uv_src:
        rng = np.random.default_rng(cs.SEED + 60)
        for kind in ("drift", "cta edges"):
            x, rf = cs.uv_sentinel_edge_inputs(rng, len(images), kind)
            uv[f"{kind} planes"] = (torch.from_numpy(x).to(dev),
                                    torch.from_numpy(rf).to(dev), 4)
        with tempfile.TemporaryDirectory() as d:
            dll, rows = build_design(Path(args.uv_src).resolve(), Path(d),
                                     "uv_sentinel_rows", UV_ROWS_PATCHES,
                                     UV_ONE_CTA_PATCHES)
            out["uv_split"] = uv_split(dll, rows, uv, args.runs, cs)
    if args.ll2_src:
        rng = np.random.default_rng(cs.SEED + 50)
        planes = {"q20 LL2 planes": ll2, "band edge planes": torch.from_numpy(
            cs.ll2_edge_planes(rng, len(images), "band edges")).to(dev)}
        with tempfile.TemporaryDirectory() as d:
            dll, bands = build_design(Path(args.ll2_src).resolve(), Path(d),
                                      "ll2_code_y_bands", LL2_BANDS_PATCHES,
                                      LL2_ONE_CTA_PATCHES)
            out["ll2_split"] = ll2_split(dll, bands, planes, args.runs, cs)
    if args.ladder_src:
        with tempfile.TemporaryDirectory() as d:
            dll, new = build_ladder(Path(args.ladder_src).resolve(),
                                    Path(d))
            flags = [int(x) for x in ds._ladder_flags(20, rs)[:3]]
            out["ladder_split"] = ladder_split(dll, new, pp, rf_ext, flags,
                                               rs, args.runs, cs)
    if args.offset_y_src:
        rng = np.random.default_rng(cs.SEED + 30)
        relay = torch.from_numpy(cs.offset_y_relay_edge_planes(
            rng, len(images))).to(dev)
        with tempfile.TemporaryDirectory() as d:
            dll = build_stamped(Path(args.offset_y_src).resolve(), Path(d),
                                OFFSET_Y_PATCHES)
            out["offset_y_split"] = offset_y_split(
                dll, {"q20 snapped planes": snapped, "relay edge planes":
                      relay}, args.runs, cs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
