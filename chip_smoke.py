#!/usr/bin/env python3
"""Smoke run of the PyTorch/CUDA port (nhwcodec_tpu_torch) on one GPU.

1. Builds the port's CUDA kernels from nhwcodec_tpu_torch/csrc with nvcc
   (one nvcc per source, in parallel).
2. Drives the batched decode service
   (nhwcodec_tpu_torch.parallel.device_pipeline.decode_batch_device) on
   host-encoded streams (q20 and a mixed q4/14/19/21 batch; q23 and q22
   with the HQ residue and a mixed q20/22/23/21 batch; the sequential
   mark-scan fallback, forced, at q20 and q23) and the batched encode
   service (encode_batch_device) on fixture and random images, checks
   every image and stream byte for byte against the port's copy of the
   host decoder and encoder (nhwcodec_tpu_torch.host) and the fixture
   streams against SHA-256 digests of the JAX package's encoder
   (STREAM_SHA256, recomputed by tests/test_torch_host_copy.py), and
   checks that every kernel of each path was launched on that path
   (launch counts set to 0 just before the path and read just after);
   profiles each service and splits its wall time over the host steps,
   and the q23 chunk's HQ Y stage 2 (K7, the HQ scatter, K8) over its
   device ops (hq_stage2_split).
3. Drives the transform entry (nhwcodec_tpu_torch.entry: encode_transform
   and transform_step on the seed-0 (8, 512, 512, 3) batch): every
   output equal to the port's plain CPU path, the coefficients to
   digests of the JAX package's encode_transform (TRANSFORM_SHA256,
   recomputed by tests/test_torch_transform.py), K10 launched 4 times per
   encode_transform, K1, K7 and K9 by decode_transform; times both.
4. Holds each of the ten kernels and the mark scan to its torch twin on
   the card, at the shapes its path gives it (batch 16 for the decode
   and encode services, the transform's four K10 shapes at batch 16),
   and times both (CUDA events around the wrapper call; torch.profiler
   device time; for every kernel but the scan also CUDA events around a
   CUDA graph of back-to-back calls, for the scan, which works in place,
   graphs of clone + scan and of the clone alone) beside the least time
   the card could take for the same bytes and operations.  The scan
   (``mark_rows``, one launch) is held to its twin at batch 1, 3 and 16
   and to the host copy's C on MARK_KINDS lists (out of order, edges,
   dense, duplicates, padding between live records, very different K),
   its graphs beside MARK_SCAN_WAS_MS.  K1 and K7 (at their three
   path shapes), K4 and K10 (at their four) are timed at every shape,
   each call shown by the profiler to be one launch of one kernel, as
   are K6's and K8's; K5 is split into its three stages (K1, the unmark
   + ladder table walk, K4) and timed as a graph on restored inputs, and
   held to its twin at batch 1, 3 and 16 on real states, chain planes
   and row-crossing reads.  The cluster kernels (K1, K2, K3, K4, K10) print
   what the card allows for them (registers, shared memory per CTA,
   resident clusters); K2 and K3 are held to their twins at batch
   1, 3 and 16 on random, near-flat, residue-bound and cluster-edge
   inputs, K4 and K10 at batch 1, 3 and 16 at their four shapes on
   full-range, +-1800 and edge inputs (ANALYSIS_EDGE_INPUTS) and in
   place on the LL corners, K7 at batch 1, 3 and 16 at its three sizes
   on int16 extremes and tile-edge inputs, K8 at batch 1, 3 and 16 on
   marks at every band edge, both column ends, a row of 384 marks, depths
   past n_waves, one wave and no marks (WAVES_EDGE_INPUTS; the waves must
   change image 0's output wherever it is marked), K6 at batch
   1, 3 and 16 on fixture, random and flat images, and K2 is timed
   beside K7 + K8, its two-launch form, on the same inputs.
5. Sweeps the decode colorspace over all 2^24 (y, u, v) triples in all
   four modes against the host decoder, and the encode colorspace over
   all 2^24 RGB triples (K6's per-pixel entry at q >= NORM, the on-card
   torch path for the gain and integer modes) against the host encoder.
6. Drives the decode with ``entropy_on_device=True`` (the Huffman decode
   on the card: E1 ``chain_starts`` and E2 ``y_runs_fixpoint``,
   csrc/entropy.cu, and torch ops) on q20 and q23 chunks of 16 (the 11
   fixtures and 5 random images), the mixed q4/14/19/21 and q20/22/23/21
   batches, an identical-rows batch and the q20 chunk with the fixpoint
   forced through its k = 1 fallback: each byte-identical to the host
   decoder, E1 launched twice a chunk (Y, UV) and E2 at least once, and
   neither with the option off.  Times the q20 chunk with the option on
   and off in turns (on, off, off, on), the host breakdown splitting the
   host Huffman automata from the rest of the front, and the device
   decode's stages.  Holds E1 to its twin at batch 1, 3 and 16 on the
   chunk's Y and UV words, the near-flat fixture's words and random
   words in both zone modes, and E2 to its twin on the q20 and q23
   chunks' per-run tuples at the default k at batch 1, 3 and 16 and, to
   2048 runs a stream, at k = 1, and on edge tuples (random, pinned
   tails, a carry through every chunk, the k + 1 cap, runs past the
   plane) at k = 1, 2, 7, 37 and 100 and on streams longer than a
   cluster stages; times E2 at k = 64, 128, 256, 512 and 1024 with each
   k's sweeps, beside the one-CTA kernel's times.
7. Drives the device encode scans' stream stage
   (models/device_encode_scans.py: the three snap passes, offset_y, the
   serpentines, the crossing merge, select codes, the run cap and
   offset_uv; S1 snap_pass, S2 offset_y and S3 merge_crossing in
   csrc/scans.cu, the rest torch ops) once a batch on the planes captured
   from the host copy's own encodes of step 2 (StreamCapture: the 16 q20
   images and the batches of 4 at q21, q19 and q17): each image's 6 SZ
   stream and nhw_select1/2 byte for byte against the host's, snap_pass
   launched 3 times a batch, offset_y and merge_crossing once; times the
   q20 batch's stage beside the host copy's C scans on the same images.
   Holds S1-S3 to their twins, timed on the q20 batch's planes and
   stream, and at batch 1, 3 and 16 on chain and spill planes (all three
   variants and q17's window), offset_y's edge planes (row 255's
   vertical fires, whole-row parity chains), relay edge planes (a pend
   carried through every band of passes 2-3) and the captured planes,
   also against the host copy's C, and edge streams (128-runs of 255 +
   254 m + d, crossings at the walk's end), whose merge + select + cap
   on the card also equal the host copy's, and S3's span edge streams
   (crossings before every thread, warp and CTA span edge; each cursor
   state carried across them), against the host copy's merge; S3 one
   launch of merge_crossing a call, its graph time beside the old
   design's.  The encode breakdown
   splits the host's encode_from_planes into the tokenizer, the stream
   stage, the E16 LL2 coders, E17 (uv_highres_compression), the E11 tail
   and E12 (pair promotion, the mid-q cleanup, the column ladder,
   classify, the positional streams and finish_stream) and the rest of
   encode_uv (its UV LL2 coding included).
8. Drives the device encode scans' residue stage
   (models/device_encode_scans._y_residue_stage: the mid-q cleanup, pair
   promotion, the column ladder, classify, the res1/res3/res5 positional
   streams and the LL2-zone rebuild; S4 pair_promotion, S5 column_ladder
   and S6 classify in csrc/residue.cu, the rest torch ops) once a batch
   on the inputs captured from the same host encodes (16 at q20, 4 each
   at q21, q19 and q17) and from 4 host encodes at q18: the plane the
   snap passes get, pair promotion's output and every res section byte
   for byte against the host's, and, chained into the stream stage, each
   image's stream and sel1/sel2; S4-S6 launched once a batch; times the
   q20 batch's stage beside the host copy's C scans on the same inputs.
   Holds S4-S6 to their twins, timed on the q20 batch's inputs, and at
   batch 1, 3 and 16 on the adversarial pair-promotion plane, delta
   planes at q17/18/20/21 and planes on which column 255's walk after
   the others changes the ladder (also against the host copy's C),
   classify also on the captured inputs and on class edge inputs (every
   class boundary at the lane-tile edges) at q20/q21 and res_setting
   3/4/6/8 against the host copy's C, and the positional streams on the
   card against the host copy's C on edge rfs.
9. Drives the device encode scans' LL2 stage
   (models/device_encode_scans._y_ll2_stage, _uv_ll2_stage,
   _uv_highres_stage, _ll2_sections and _uv_ll2_sections: the Y LL2 byte
   coding and run-delta compression (E16), the chroma LL2 coding and
   compression (E17); S7 ll2_code_y and S8 walk_visited in csrc/ll2.cu,
   the rest torch ops) once a batch on the planes captured from the host copy's own
   encodes (16 at q20, 4 each at q21, q17, q16, q15, q8 and q1): the
   zeroed Y, U and V planes, every E16 and E17 section and hr_mem byte for
   byte against the host's, ll2_code_y launched once a batch and
   walk_visited three times; times the q20 batch's stage beside the host
   copy's C on the same planes.  Holds S7 to its twin on the q20 planes
   (timed) and at batch 1, 3 and 16 on planes with odd 4-runs at the row
   ends, values about 10000 and 20000, int16 extremes, escapes at
   positions 0 and 1, all-even and dense-odd planes, gt_low3 both ways;
   S8 on the stage's three walks of the q20 batch (timed) and at batch 1,
   3 and 16 on them, on rows of jumps of 65, of 255 and 256, long jumps,
   parks, squeeze rows whose 64/128 codes sit at the bound, and rows at
   the segmented walk's edges (jumps onto segment ends and over many
   segments, a park in the first segment, n off the segment grid, n = 1,
   a start in the last segment).
10. Drives the encode service with every raster scan on the card,
   ``encode_batch_device(images, q, scans_on_device=True)``
   (models/device_encode_scans.encode_batch_scans_device: the front, the
   LL2, residue and stream stages, the chroma ladders, the tokenizer and
   the packer; S9 uv_sentinel in csrc/uv.cu; at q <= LOW4 S10
   offset_y_low4 in csrc/scans.cu, the low56 cleanup and, below LOW6, S11
   lowest_q_band_cleanup in csrc/lowq.cu; below LOW7 S12
   very_low_q_cleanup, at q <= LOW9 S13 low_q_ll1_cleanup and S14
   uv_ll_smooth in csrc/vlq.cu), on the encode batch's 16 images at q20
   and at q16 in one call each and 4 each at q21, q19, q18, q17, q15, q14,
   q13, q12, q11, q8 and q1: every stream byte for byte against the host
   copy's encoder, the fixtures' against STREAM_SHA256, each call's
   launches (K4, K5 above q6, K6 at q >= NORM, S1-S8, S9 twice at q >=
   LOW2 and never below, S10 in S2's place and no S4 at q <= 16, S11
   below q14, S12 below q13, no S5, S6 or positional stream at q <= 12,
   S13 once and S14 twice at q <= 11); q0 and q22 raise ValueError.
   Times the q20 and q16 calls of 16 and the q13 and q8 calls of 4 in
   turns against the option off (one chunk, and the default pool), splits
   the on path's wall at q20, q16 and q8 over its host steps and device
   stages, and profiles one q20 call.  Holds S9 to its twin and the
   host copy's C on the chroma planes captured from the host copy's
   encodes (StreamCapture: q20, q21, q19, q18; timed on the q20 U planes)
   and at batch 1, 3 and 16 on edge planes (lane 127's pairs drifting the
   window into the oob tail, lane 0 writing the slot lane 127 reads, d0 =
   -5, taken band slots, runs of 128 pairs), res_uv 4 and 5, and the
   compare ladder (torch ops) on the card to the host copy's C, strict
   both ways.
11. Holds S10 to its twin and the host copy's C on the planes its host
   encodes captured at q16 (16, timed, its launches S2's pass 1 and
   oy4_rows, its graph time beside the old design's), q15, q14 and q13
   (4 each) and at batch 1, 3 and 16 on edge planes (quant4 pair writes
   across row ends, counters at row starts, random trigger values, writes
   pending across lane tiles, ticks counted across tiles, rows entering
   pending that fire at column 511 again), timed on each kind; S11 on the
   captured
   q13 planes (timed as a batch of 16 and of 4) and at batch 1, 3 and 16
   on edge planes (pairR at 510 chained into the next row, pairL at
   column 0, loop A's writes into columns 255 and 0 and row 256, reads in
   the tail past resIII, random; a lane tile's edges: pairL on its first
   column, pairR on its last, each carry state entering it, the +-7
   snap; a chain through all 256 rows of B + C) at q13 and q10, timed on
   each kind too; one launch of lowest_q_rows a call, its graph time
   beside the old design's; the low56 cleanup on the captured q15 and
   q14 planes.
12. Holds S12, S13 and S14 to their twins and the whole programs to the
   host copy's C on the planes captured from the host encodes at q12,
   q11, q8 and q1 (S12 timed at q12, its launches vlq_rows and vlq_far,
   its graph time beside the old design's passes and wrapper; S13 and S14
   at q8, each as a batch of 16, S14 also at batch 1, 3 and 16, one
   launch of uvs_relay, its graph beside S14_WAS_GRAPH_MS) and at batch
   1, 3 and 16 on edge planes (a pass-1 write chained into the next
   window, a wavefront step reading its left neighbour's write, fires at
   the relay's warp edges, pass 3's stale carry 4 and 0, S14's pass 3
   firing on pass 2's write (each kind's graph timed), level-2
   zeroings in the LL1 cleanup's region, a zeroed left neighbour, the
   row ends, random), and the count-adaptive lowest-q thresholds on the
   card to the host's at each count band's edge.

Prints the card's name and power limit (nvidia-smi), whether the host
copy's C scans were built (``native host library: loaded``) or the host
runs pure Python, one JSON line of per-kernel results, and last a JSON
status line.  Any failure raises and exits non-zero; so does a machine
without a CUDA card.  Imports neither jax nor the JAX package.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import hashlib
import json
import os
import re
import subprocess
import sys
import time

import numpy as np

B = 16          # the decode and encode pipelines' largest chunk
RUNS = 25       # timed runs per measurement (median), after warm-up
SEED = 2026
CSRC = "nhwcodec_tpu_torch/csrc/"
# name -> (source, TPU kernel it replaces)
KERNELS = {
    "synth_level": (CSRC + "dwt.cu", "nhwcodec_tpu/ops/pallas_dwt.py:70"),
    "y_stage2_full": (CSRC + "dwt.cu", "nhwcodec_tpu/ops/pallas_dwt.py:637"),
    "uv_synth": (CSRC + "dwt.cu", "nhwcodec_tpu/ops/pallas_dwt.py:378"),
    "analysis_level_jp": (CSRC + "analysis.cu",
                          "nhwcodec_tpu/ops/pallas_dwt.py:241"),
    "requant_tail": (CSRC + "requant.cu",
                     "nhwcodec_tpu/ops/pallas_dwt.py:533"),
    "colorspace_down420": (CSRC + "colorspace.cu",
                           "nhwcodec_tpu/ops/pallas_colorspace.py:83"),
    "synth_unnorm_rows_t": (CSRC + "dwt.cu",
                            "nhwcodec_tpu/ops/pallas_dwt.py:298"),
    "synth_norm_rows_clip_waves": (CSRC + "dwt.cu",
                                   "nhwcodec_tpu/ops/pallas_dwt.py:586"),
    "synth_norm_rows_clip": (CSRC + "dwt.cu",
                             "nhwcodec_tpu/ops/pallas_dwt.py:325"),
    "smooth_marks_seq": (CSRC + "dwt.cu",
                         "nhwcodec_tpu/models/device_decode.py:126-148"),
    "analysis_level": (CSRC + "analysis.cu",
                       "nhwcodec_tpu/ops/pallas_dwt.py:264"),
    "chain_starts": (CSRC + "entropy.cu",
                     "nhwcodec_tpu/ops/entropy_chain_scan.py:131"),
    "y_runs_fixpoint": (CSRC + "entropy.cu",
                        "nhwcodec_tpu/ops/entropy_decode_device.py:923"),
    "snap_pass": (CSRC + "scans.cu",
                  "nhwcodec_tpu/models/device_scans.py:93"),
    "offset_y": (CSRC + "scans.cu",
                 "nhwcodec_tpu/models/device_scans.py:375"),
    "merge_crossing": (CSRC + "scans.cu",
                       "nhwcodec_tpu/models/device_scans.py:527"),
    "pair_promotion": (CSRC + "residue.cu",
                       "nhwcodec_tpu/models/device_scans.py:2070"),
    "column_ladder": (CSRC + "residue.cu",
                      "nhwcodec_tpu/models/device_scans.py:952"),
    "classify": (CSRC + "residue.cu",
                 "nhwcodec_tpu/models/device_scans.py:1105"),
    "ll2_code_y": (CSRC + "ll2.cu",
                   "nhwcodec_tpu/models/device_scans.py:1899"),
    "walk_visited": (CSRC + "ll2.cu",
                     "nhwcodec_tpu/models/device_scans.py:1411"),
    "uv_sentinel": (CSRC + "uv.cu",
                    "nhwcodec_tpu/models/device_scans.py:1327"),
    "offset_y_low4": (CSRC + "scans.cu",
                      "nhwcodec_tpu/models/device_scans.py:2750"),
    "lowest_q_band_cleanup": (CSRC + "lowq.cu",
                              "nhwcodec_tpu/models/device_scans.py:2165"),
    "very_low_q_cleanup": (CSRC + "vlq.cu",
                           "nhwcodec_tpu/models/device_scans.py:2479"),
    "low_q_ll1_cleanup": (CSRC + "vlq.cu",
                          "nhwcodec_tpu/models/device_scans.py:2101"),
    "uv_ll_smooth": (CSRC + "vlq.cu",
                     "nhwcodec_tpu/models/device_scans.py:2353"),
}
DECODE_KERNELS = ("synth_level", "y_stage2_full", "uv_synth")
HQ_KERNELS = ("synth_unnorm_rows_t", "synth_norm_rows_clip_waves")
FALLBACK_KERNELS = ("synth_norm_rows_clip", "smooth_marks_seq")
ENCODE_KERNELS = ("analysis_level_jp", "requant_tail", "colorspace_down420")
# the groups of the encode breakdown timed inside encode_from_planes
ENCODE_SCAN_GROUPS = ("host tokenizer", "host stream stage",
                      "host E16 LL2 coders", "host E17",
                      "host E11 tail + E12", "host encode_uv, the rest")
TRANSFORM_KERNELS = {"analysis_level": 4, "synth_level": 2,
                     "synth_unnorm_rows_t": 2, "synth_norm_rows_clip": 2}

# SHA-256 of nhwcodec_tpu.encode(generator(), q) for the fixture
# generators at q20 and one fixture per other quality
# (tests/test_torch_host_copy.py recomputes them with the JAX package)
OTHER_QS = (23, 22, 21, 19, 17, 16, 12, 8, 1)
STREAM_SHA256 = {
    ("gradient", 20):
        "e4251e8a13ae8dfcb67e22811ce154d062416d56826325b41ce6aaf5ca7c609d",
    ("texture", 20):
        "cb0903443e3538cb1f30dab4f383af4064e15dc1dffba7f695c2966cfa699bb9",
    ("blocks", 20):
        "c79b7560eab87bb3e6cc5c7fc0a55592b60d9dedc769c9172dfe1da026b5228b",
    ("flat", 20):
        "7a58254e7d05f82e59d30c0370270867079f22b20a800185de46f528780f8bb3",
    ("checker", 20):
        "3887eaf41a3ff854534cf0cc1c668e80bdcc499794f24815a403dbe17f515b2a",
    ("maxnoise", 20):
        "ca6638ec8dae261db0a611761e0387785110dd2a88aa64877186736e833be29f",
    ("allblack", 20):
        "2dfb84c37c6e80424651b205d5217f4fe319902cbb6c6f1d86b6b35f3bb4e656",
    ("allwhite", 20):
        "724bc5783f02ce87139c15674282393699eae925c69b94ce32f1946193a849bd",
    ("saturated", 20):
        "91aee3c883a69ab4d3eb420fd36803acb89e3e581d5e209e5b48fb369d9d6166",
    ("photo2", 20):
        "149509ed92c93c2c6d6de59ddb0905df0218029c0908f563b4b3efef50a4ea1f",
    ("boundary", 20):
        "fd84cdb8d99b172dd7feb5a3d862c0af609b698af3134a841fc3e17058f81012",
    ("texture", 23):
        "cbfed13d4e4a2802edff85e583088078064da5099be6a35485c0900fcd12ce94",
    ("gradient", 22):
        "8826d13477fecdd6c9ebc76b53217316872da3a66c11d92ef0e33c923a184732",
    ("boundary", 21):
        "d8bddba403d63ec009991b6ada764747755784ae29e79f8d972f45199ba6d0d7",
    ("saturated", 19):
        "8d9a0d7e0404b9ef16709d48e6e409ce5288a4107b3798b7be4f5afe630de6c0",
    ("allblack", 17):
        "aea415270b28260d9366e369bd63dd37f1e3a7b4df3afef377b8559701d5a258",
    ("maxnoise", 16):
        "8bd955cd29d1bd5c11b929c0b3710f44204f9af47f5638555999ece695126e35",
    ("texture", 12):
        "fce9a3ab65a400535a2041ea37166d8fecac2c575d76e4f9f565b17abf842db5",
    ("saturated", 8):
        "adeb3e1e61c88fec0a39ba6e1296be023efebfc11d5d815ddf8fa008bd6f9f42",
    ("texture", 1):
        "b999f74c57d99d7e9650255612b789f161b2438494602df90e92a97214e3992d",
}
# SHA-256 of image i's (y, u, v) coefficients from the JAX package's
# encode_transform on the entry batch (transform_digest), i = 0..7, with
# its float32 colorspace evaluated op by op, as written (XLA's fused CPU
# program contracts multiply-adds and moves 115 Y codes of this batch)
TRANSFORM_SHA256 = [
    "a57ef41016b4cf4d1d3c33fd7fd44a6a38fd0fa0bbffc7d8de16681e9e6a98cb",
    "d6059394a340b2ca3661c0ddba184a3cb5d3024bdc7f24482b1aaec471a50dcc",
    "eb3f60fbd254d6546d52fc5c9596cc6fd0a3d119f3daecb2758308d65aa88adc",
    "5d009f4482a5624aeef63a7a61a6374acca4521d71979a8bd0412be5530134cc",
    "8f06557d9cb41126c928937b61d7631209ebde459068da6069cb5e7f46d0ff4e",
    "20ab32204deb2f85a98891eb62950f6f5ea95fe49611af1342f424286b8e1296",
    "a0712d5aff6c9e2ba48bf591ffd83d5a97749e670780e6c19fb5721421ec20b6",
    "c99752b0bee0cedfd3c72d5dca44bf73ddf2b1252e432c73be8825fade40815b",
]

# the card's peaks for the bound (H100 SXM at 700 W, NVIDIA's data
# sheet): HBM bytes/s, and operations/s outside the tensor cores for
# operations that are not fused multiply-adds.  The sheet's 67 TFLOP/s
# float32 is 132 SMs x 128 lanes x 2 (an FMA) x 1.98 GHz; int32 adds,
# shifts, compares and selects, and unfused float64 operations, issue on
# 64 lanes of each SM, one operation each: 132 x 64 x 1.98 GHz
PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 64 * 1.98e9
# operations per element of each kernel, counted from its source: int32
# (float64 for colorspace_down420, per pixel) adds, shifts, compares and
# selects; y_stage2_full and synth_norm_rows_clip_waves add wave_ops(),
# smooth_marks_seq counts per live record
OPS = {"synth_level": 30, "y_stage2_full": 32, "uv_synth": 48,
       "analysis_level_jp": 30, "requant_tail": 110,
       "colorspace_down420": 26, "synth_unnorm_rows_t": 12,
       "synth_norm_rows_clip_waves": 20, "synth_norm_rows_clip": 20,
       "smooth_marks_seq": 25, "analysis_level": 30}
WAVE_OPS = 22


def wave_ops(depth, n_waves: int) -> int:
    """The dering waves' operations on these depth planes: WAVE_OPS for
    each marked cell, smoothed in its own wave, and the depth compare of
    every cell of a marked row in each wave up to the row's depth (the
    kernel skips unmarked rows and the waves past a row's depth)."""
    import torch

    d = depth.to(torch.int32)
    rows = d.amax(-1).clamp(max=n_waves)
    return (WAVE_OPS * int((d > 0).sum())
            + 2 * d.shape[-1] * int(rows.sum()))


def fixture_generators() -> dict:
    """name -> generator of the 11 fixture images, in a fixed order."""
    from nhwcodec_tpu_torch.host.utils import fixtures

    return {**fixtures.GENERATORS, **fixtures.EXTREME_GENERATORS}


def fixture_for(q: int) -> str:
    """The fixture whose q stream is pinned in STREAM_SHA256 (q != 20)."""
    names = list(fixture_generators())
    return names[q % len(names)]


def quality_batch(images: np.ndarray, q: int) -> np.ndarray:
    """The 4 images of the encode batch that a quality other than q20 is
    encoded on: a fixture with a pinned digest first (fixture_for), then
    random images and fixtures."""
    names = list(fixture_generators())
    return images[[names.index(fixture_for(q)), (q + 5) % B,
                   len(names) + q % 5, (3 * q) % B]]


def sha256(data: bytes) -> str:
    return hashlib.sha256(data).hexdigest()


def transform_digest(planes) -> str:
    """SHA-256 of one image's (y, u, v) int16 coefficient planes."""
    h = hashlib.sha256()
    for p in planes:
        h.update(np.ascontiguousarray(p, np.int16).tobytes())
    return h.hexdigest()


def work(nbytes: float, ops: float) -> dict:
    """The least time the card could take to move ``nbytes`` and do
    ``ops`` operations: {"bound_ms", "bound_by"}."""
    byte_ms, op_ms = 1e3 * nbytes / PEAK_BYTES, 1e3 * ops / PEAK_OPS
    return {"bound_ms": max(byte_ms, op_ms),
            "bound_by": "bytes" if byte_ms >= op_ms else "operations"}


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise SystemExit(f"chip_smoke: FAIL: {msg}")


def median_ms(fn, runs: int = RUNS, warm: int = 3) -> float:
    """Median of CUDA-event times of ``fn()`` on the current stream."""
    import torch

    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end))
    return float(np.median(times))


GRAPH_CALLS = 20


def graph_ms(fn, calls: int = GRAPH_CALLS, runs: int = 10) -> float:
    """Device ms per call of ``fn`` from CUDA events around replays of a
    CUDA graph of ``calls`` back-to-back calls (median of ``runs``): a
    chain of launches without the host's launch cost between them, the
    device time where a profiler window stays incomplete.  For calls
    that only allocate and launch kernels, with no host synchronisation
    and no in-place update."""
    import torch

    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()    # warm-up outside the capture
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(calls):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(runs):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / calls)
    return float(np.median(times))


# runtime calls that each leave one device record (a kernel, a copy, a set)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cudaMemcpyAsync", "cudaMemsetAsync")
PROFILE_TRIES = 5


def device_profile(fn, calls: int = 1, tries: int = PROFILE_TRIES):
    """Run ``fn`` ``calls`` times under torch.profiler.  Returns (wall ms
    per call, device ms per call, [(name, ms per call)] of the device
    entries by total time); device ms is None when the profiler's window
    is not complete.  On an H100 the profiler dropped device records now
    and then: none, or one of ten, of a kernel's records in some windows
    (one or two of ten cluster launches in most), and up to 1 in 5,000 in a
    window of 20,000 launches.  So an entry's ms per call is its mean
    time per record times its launches per call (its records over
    ``calls``, rounded), which a dropped record does not lower; and a
    window counts only when its device records fall short of the host's
    launch and copy calls by at most 1% (one record for a small window),
    and is run again otherwise, up to ``tries`` times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(tries):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) * 1e3 / calls
        rows = prof.key_averages()
        entries = [e for e in rows if e.device_type == DeviceType.CUDA]
        dev = sorted(((e.key, e.self_device_time_total / 1e3 / e.count
                       * max(1, round(e.count / calls)))
                      for e in entries if e.count), key=lambda t: -t[1])
        total = sum(ms for _, ms in dev)
        api = sum(e.count for e in rows if e.device_type == DeviceType.CPU
                  and e.key in LAUNCH_APIS)
        records = sum(e.count for e in entries)
        if total > 0 and records >= api - max(1, api // 100):
            return wall, total, dev
        print(f"  (profiler window incomplete: {records} device records for "
              f"{api} host launch and copy calls)", flush=True)
    return wall, None, dev


def launches_per_call(fn, calls: int = 10) -> tuple[float, float, list]:
    """Run ``fn`` ``calls`` times under torch.profiler: the host's kernel
    launch calls per call, the device's kernel records per call, and the
    names of the device kernels.  A wrapper that is one kernel launch on
    the card gives 1, at most 1 (the profiler drops one or two of ten
    cluster launches' records) and one name.  A window with no device
    record at all (the profiler lost it whole: K7's at (16, 256, 256) on
    an H100 five times running in one run, short windows of microsecond
    kernels most often, while windows of thousands of launches kept 99%)
    is run again with four times the calls, up to PROFILE_TRIES times."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    for _ in range(PROFILE_TRIES):
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU,
                                 ProfilerActivity.CUDA]) as prof:
            for _ in range(calls):
                fn()
            torch.cuda.synchronize()
        rows = prof.key_averages()
        dev = [e for e in rows if e.device_type == DeviceType.CUDA]
        if dev:
            break
        calls *= 4
    host = sum(e.count for e in rows if e.device_type == DeviceType.CPU
               and e.key in LAUNCH_APIS[:3])
    return (host / calls, sum(e.count for e in dev) / calls,
            sorted(e.key for e in dev))


def host_breakdown(fn, targets, inner=()) -> tuple[float, dict]:
    """Wall ms of ``fn()`` and the ms spent in each group of host steps:
    ``targets`` lists (module, attribute, group); timers are patched onto
    those module attributes for the call.  A step called from inside
    another timed step counts only in the outer one, unless its group is
    in ``inner``: then it counts in its own group and its time leaves the
    enclosing timed step's (at any depth).  So the groups never
    overlap."""
    import threading

    spent = {key: 0.0 for _, _, key in targets}
    local = threading.local()

    def timed(f, key):
        def run(*a, **k):
            stack = local.__dict__.setdefault("stack", [])
            if stack and key not in inner:
                return f(*a, **k)
            stack.append(0.0)   # the time of timed steps nested in this one
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                ms = (time.perf_counter() - t0) * 1e3
                spent[key] += ms - stack.pop()
                if stack:
                    stack[-1] += ms
        return run

    saved = [(mod, name, getattr(mod, name)) for mod, name, _ in targets]
    try:
        for (mod, name, key), (_, _, f) in zip(targets, saved):
            setattr(mod, name, timed(f, key))
        t0 = time.perf_counter()
        fn()
        wall = (time.perf_counter() - t0) * 1e3
    finally:
        for mod, name, f in saved:
            setattr(mod, name, f)
    return wall, spent


def print_breakdown(what: str, wall: float, spent: dict) -> None:
    rest = wall - sum(spent.values())
    print(f"{what}, wall {wall:.2f} ms: "
          + "; ".join(f"{k} {v:.2f} ms ({v / wall:.1%})"
                      for k, v in spent.items())
          + f"; rest (device stages, transfers, glue) {rest:.2f} ms "
          f"({rest / wall:.1%})", flush=True)


def print_profile(what: str, fn) -> None:
    wall, dev_ms, top = device_profile(fn)
    if dev_ms is None:
        why = (f"profiler window incomplete after {PROFILE_TRIES} tries"
               if sum(ms for _, ms in top) > 0
               else "profiler saw no device activity")
        print(f"{what} profile: device time not measured ({why})",
              flush=True)
        return
    print(f"{what} profile: wall {wall:.2f} ms, device busy {dev_ms:.3f} "
          f"ms, device idle share {1 - dev_ms / wall:.4f}; top device "
          "entries (ms): "
          + "; ".join(f"{k[:60]} {v:.3f}" for k, v in top[:8]), flush=True)


def max_abs_err(name: str, got: tuple, want: tuple) -> int:
    """The largest |got - want| over the outputs, after checking their
    count, dtypes and shapes."""
    import torch

    torch.cuda.synchronize()
    check(len(got) == len(want), f"{name}: {len(got)} vs {len(want)} outputs")
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int32) - w.to(torch.int32))
                           .abs().max()))
    return err


# the longest twin window the profiler summarises: a twin call of some
# 80,000 launches (S5's, S10's) takes it about a minute
TWIN_PROFILE_MS = 1000


def compare_and_time(name: str, shape: str, kern, twin, timed: bool = True,
                     twin_calls: int = 10, bound: dict | None = None,
                     graph: bool = False, twin_runs: int = RUNS,
                     twin_warm: int = 3, twin_profile: bool = True):
    """Run ``kern`` and ``twin`` (each returns a tensor or a tuple of
    tensors) on the card, check dtype, shape and max_abs_err 0, and time
    both (the twin's profiler window over ``twin_calls`` calls, where
    those take under TWIN_PROFILE_MS and ``twin_profile``; its call time
    the median of ``twin_runs`` after ``twin_warm`` calls).  When
    timed, returns the kernel's entry of the JSON line: max_abs_err, ms
    and plain_ms (wrapper calls, CUDA events), device_ms (profiler),
    ``bound`` (``work(...)`` of these inputs), bound_us, bound_share (the
    bound over the device time) and library_ms (None: no single torch
    call computes these integer passes, the exact colorspace or the
    scan); with ``graph``, also graph_ms (``graph_ms``), and where the
    profiler's window stayed incomplete the bound's share is of graph_ms
    (bound_share_of says which)."""
    import torch

    got, want = kern(), twin()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    err = max_abs_err(name, got, want)
    if not timed:
        print(f"kernel {name} {shape}: max_abs_err {err} vs torch twin",
              flush=True)
        check(err == 0, f"{name} disagrees with its torch twin on {shape}")
        return None
    ms = median_ms(kern)
    plain_ms = median_ms(twin, runs=twin_runs, warm=twin_warm)
    _, k_dev, k_top = device_profile(kern, calls=10)
    t_dev = (device_profile(twin, calls=twin_calls)[1]
             if twin_profile and plain_ms * twin_calls < TWIN_PROFILE_MS
             else None)
    g_ms = graph_ms(kern) if graph else None
    # the share of the profiler's device time, else of the graph's
    share_of = k_dev or g_ms
    share = bound["bound_ms"] / share_of if share_of else None
    print(f"kernel {name} {shape}: max_abs_err {err} vs torch twin; "
          f"wrapper call {ms:.4f} ms, twin {plain_ms:.4f} ms (median of "
          f"{RUNS} and {twin_runs}, CUDA events); device time per call "
          "(profiler): "
          f"kernel {k_dev} ms, twin {t_dev} ms; "
          + ("" if g_ms is None else f"graph of {GRAPH_CALLS} calls (CUDA "
             f"events): {g_ms:.4f} ms per call; ")
          + "bound "
          f"{1e3 * bound['bound_ms']:.3f} us ({bound['bound_by']}), "
          f"{'not measured' if share is None else f'{share:.2%}'} of the "
          f"kernel's {'graph' if not k_dev and share else 'device'} time; "
          "its launches (ms per call): "
          + "; ".join(f"{k[:50]} {v:.4f}" for k, v in k_top), flush=True)
    check(err == 0, f"{name} disagrees with its torch twin on {shape}")
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "device_ms": k_dev, **bound, "bound_us": 1e3 * bound["bound_ms"],
           "bound_share": share,
           "bound_share_of": "profiler" if k_dev else "graph" if share
           else None, "library_ms": None}
    if graph:
        out["graph_ms"] = g_ms
    return out


def fresh_inputs(args, n: int):
    """A function that hands out one of ``n`` clones of ``args`` per call;
    the clones are all made here, before anything is timed."""
    copies = iter([[a.clone() for a in args] for _ in range(n)])
    return lambda: next(copies)


def planes(rng, b, n, lo, hi):
    """Half the images in [lo, hi), half over the full int16 range."""
    x = rng.integers(lo, hi, (b, n, n)).astype(np.int16)
    x[b // 2:] = rng.integers(-32768, 32768, (b - b // 2, n, n))
    return x


def mark_lists(rng, b, run=6):
    """Dering mark lists with same-row runs of ``run`` (run depth = wave
    number), in the C emission order."""
    out = []
    for _ in range(b):
        ms = []
        for r in sorted(rng.choice(np.arange(1, 255), 60, replace=False)):
            run0 = int(rng.integers(1, 240))
            cs = sorted(set(rng.integers(1, 250, 5).tolist()
                            + list(range(run0, run0 + run))))
            ms.extend([(int(r) << 8) | int(c) for c in cs])
        ms.sort(key=lambda m: ((m & 255), (m >> 8)))
        out.append(ms)
    return out


def out_of_order_marks(rng, b):
    """Dering mark lists whose same-row runs of adjacent columns come in
    descending column order (the depth planes refuse them; the scan's
    live reads chain through each run), cols 1..254, of varied length."""
    out = []
    for n in range(b):
        ms = []
        for r in sorted(rng.choice(np.arange(1, 255), 40 - n, replace=False)):
            c0 = int(rng.integers(1, 248))
            cs = sorted(set(rng.integers(1, 255, 3).tolist()
                            + list(range(c0, c0 + 6))), reverse=True)
            ms.extend((int(r) << 8) | c for c in cs)
        out.append(ms)
    return out


def sentinel_planes(rng, b):
    """Chroma coefficient planes with residue sentinels 5003..5006 in all
    three bands."""
    x = rng.integers(-300, 300, (b, 256, 256)).astype(np.int16)
    for i in range(b):
        for r0, c0 in ((0, 128), (128, 0), (128, 128)):
            rows = rng.integers(0, 128, 400)
            cols = rng.integers(0, 128, 400)
            x[i, r0 + rows, c0 + cols] = rng.integers(5003, 5007, 400)
    return x


# LL rows of dering marks whose transposed rows (j = 2 row) sit at the
# edges of K2's CTAs (j = 64c - 2 and 64c), row 0 (its row j - 1 wraps to
# 511) and row 255 (j = 510); columns 0 and 255 and runs of 3 and 6
EDGE_MARK_ROWS = (0, 31, 32, 63, 64, 95, 96, 127, 128, 159, 160, 191, 192,
                  223, 224, 255)
EDGE_MARK_COLS = (0, 1, 2, 100, 101, 102, 103, 104, 105, 253, 254, 255)
# band rows and columns of residue sentinels at K3's CTA edges (rows
# 32c - 1 and 32c of the LL level, plane rows 63/64 and 127/128), in
# columns 0 and 127 (whose pair delta is the dropped column-128 spill)
EDGE_BAND_ROWS = (0, 31, 32, 63, 64, 95, 96, 127)
EDGE_BAND_COLS = (0, 1, 63, 64, 126, 127)


def edge_marks(b):
    """``b`` dering mark lists, in the C emission order, with a mark at
    every (EDGE_MARK_ROWS, EDGE_MARK_COLS) cell."""
    ms = sorted(((r << 8) | c for r in EDGE_MARK_ROWS
                 for c in EDGE_MARK_COLS), key=lambda m: ((m & 255), (m >> 8)))
    return [list(ms) for _ in range(b)]


def dense_marks(b):
    """``b`` dering mark lists (C emission order) whose marked rows carry
    more marks than a warp has lanes: runs of 7 columns with a gap of
    one over columns 0..199 of four LL rows, two of them at a CTA edge."""
    ms = sorted(((r << 8) | c for r in (10, 31, 32, 100) for c in range(200)
                 if c % 8 != 7), key=lambda m: ((m & 255), (m >> 8)))
    return [list(ms) for _ in range(b)]


# the mark scan's inputs (mark_scan_inputs), each list in the C's order
# unless said
MARK_KINDS = ("out of order", "edges", "dense", "duplicates",
              "padding between", "mixed K")
# the mark scan's device time before it took rows in parallel (a thread
# an image, the records in list order), on kernel_phase's 16 planes of
# out-of-order marks: ms, PERF.md's row of the scan, NVIDIA H100 80GB
# HBM3 at 700 W
MARK_SCAN_WAS_MS = 0.2165


def random_marks(rng, n: int) -> list:
    """``n`` records at random LL rows 1..254 and columns 0..255, in
    random order (duplicates and adjacent cells among them)."""
    return [(int(r) << 8) | int(c) for r, c in
            zip(rng.integers(1, 255, n), rng.integers(0, 256, n))]


def mark_scan_inputs(rng, b, kind: str) -> tuple:
    """(planes (B, 512, 512) int16 in [-12, 12], recs (B, K) int32, valid
    (B, K) bool) for the mark scan.  "out of order": out_of_order_marks;
    "edges": edge_marks (rows 0 and 255, columns 0 and 255, each band's
    first and last rows); "dense": dense_marks (175 records a row, three
    chunks of the kernel's); "duplicates": out_of_order_marks with each
    record repeated up to three times and a third of them again at the
    end; "padding between": out_of_order_marks with padding records
    ((1 << 8) | 1, valid False) and records of live rows with valid False
    between the live ones; "mixed K": 0, 1, 37, 300, 1500 random records
    (random_marks) in turn by image."""
    from nhwcodec_tpu_torch.models import device_decode as tdd

    x = rng.integers(-12, 13, (b, 512, 512)).astype(np.int16)
    if kind in ("edges", "dense"):
        return x, *tdd.pad_marks((edge_marks if kind == "edges"
                                  else dense_marks)(b))
    if kind == "mixed K":
        return x, *tdd.pad_marks([random_marks(rng, (0, 1, 37, 300,
                                                     1500)[i % 5])
                                  for i in range(b)])
    lists = out_of_order_marks(rng, b)
    if kind == "out of order":
        return x, *tdd.pad_marks(lists)
    if kind == "duplicates":
        lists = [[m for m in ms for _ in range(int(rng.integers(1, 4)))]
                 + [ms[i] for i in rng.permutation(len(ms))[:len(ms) // 3]]
                 for ms in lists]
        return x, *tdd.pad_marks(lists)
    k = 2 * max(len(ms) for ms in lists) + 8
    recs = np.full((b, k), (1 << 8) | 1, np.int32)
    valid = np.zeros((b, k), bool)
    for n, ms in enumerate(lists):
        at = np.sort(rng.choice(k, len(ms), replace=False))
        recs[n, at], valid[n, at] = ms, True
        dead = np.setdiff1d(np.arange(k), at)[::2]
        recs[n, dead] = rng.choice(ms, dead.size)
    return x, recs, valid


def host_marks(x: np.ndarray, recs: np.ndarray,
               valid: np.ndarray) -> np.ndarray:
    """The host copy's C ``nhw_smooth_marks`` on each plane, with the
    image's live records (valid, row 1..255) in list order."""
    from nhwcodec_tpu_torch.host import native

    lib, ffi = native._load(), native.ffi()
    out = x.copy()
    for p, r, v in zip(out, recs, valid):
        live = np.ascontiguousarray(r[v & (r >= 256) & (r < 65536)],
                                    np.int32)
        lib.nhw_smooth_marks(ffi.cast("int16_t *", p.ctypes.data),
                             ffi.cast("const int32_t *", live.ctypes.data),
                             live.size)
    return out


def edge_sentinel_planes(rng, b):
    """Chroma coefficient planes in [-300, 300) with a residue sentinel
    5003..5006 at every (EDGE_BAND_ROWS, EDGE_BAND_COLS) cell of each of
    the three bands."""
    x = rng.integers(-300, 300, (b, 256, 256)).astype(np.int16)
    for r0, c0 in ((0, 128), (128, 0), (128, 128)):
        for r in EDGE_BAND_ROWS:
            for c in EDGE_BAND_COLS:
                x[:, r0 + r, c0 + c] = rng.integers(5003, 5007, b)
    return x


def residue_bound_plane(b):
    """``b`` copies of the residue-bound case and its depth planes: res =
    116 at transposed cell (40, 10) keeps it, res = 112 at (80, 100)
    smooths it (tests/test_torch_dwt.py)."""
    from nhwcodec_tpu_torch.models import device_decode as tdd

    jp = np.zeros((b, 512, 512), np.int16)
    jp[:, 10, 19:22] = (685, 100, 686)
    jp[:, 100, 39:42] = (686, 100, 686)
    dp, n_waves, _ = tdd.mark_depth_planes([[(20 << 8) | 10,
                                             (40 << 8) | 100]] * b)
    return jp, dp, n_waves


# K4's and K10's launch shapes (csrc/analysis.cu kShapes): n -> (CTAs a
# cluster, threads a CTA); CTA c owns rows [cR, (c + 1)R) of the
# transposed plane j and of x, R = n / cluster
ANALYSIS_SHAPES = {512: (8, 512), 256: (8, 256), 128: (4, 256)}
INT16_EXTREMES = (-32768, -32767, -1, 0, 1, 32766, 32767)


def analysis_path_shapes(b: int) -> tuple:
    """K4's and K10's (batch, n) on their paths for a batch of b images:
    Y levels 1 and 2, U+V levels 1 and 2."""
    return ((b, 512), (b, 256), (2 * b, 256), (2 * b, 128))


ANALYSIS_PATH_SHAPES = analysis_path_shapes(B)


def analysis_cta_edges(n: int) -> list:
    """The rows at which a CTA of K4/K10 at size ``n`` starts (c > 0)."""
    cluster = ANALYSIS_SHAPES[n][0]
    return [c * n // cluster for c in range(1, cluster)]


def extreme_planes(rng, b, n):
    """Planes of int16 extremes: all -32768, all 32767, a -32768/32767
    checkerboard, alternating rows, and INT16_EXTREMES at random, image
    by image in that order."""
    r, c = np.indices((n, n))
    pats = [np.full((n, n), -32768), np.full((n, n), 32767),
            np.where((r + c) % 2, 32767, -32768), np.where(r % 2, 32767, -32768)]
    x = np.empty((b, n, n), np.int16)
    for i in range(b):
        x[i] = (pats[i] if i < len(pats)
                else rng.choice(INT16_EXTREMES, (n, n)))
    return x


def parity_chain_planes(rng, b, n):
    """Planes whose transposed rows carry odd pair sums at every second
    row, across every CTA edge: the high_adj parity carry fires at every
    odd pair t < n/2 - 1.  Even columns are even, except on rows r = 2
    mod 4, where column 2i takes parity bit E[i]: (i >> 1) & 1 on even
    images (every low moment 1..n/2-2 odd there: the VI rows of j), i & 1
    on odd images (every high moment but the last: the 53 rows)."""
    x = 2 * rng.integers(-4000, 4000, (b, n, n))
    x[:, :, 1::2] = rng.integers(-8000, 8000, (b, n, n // 2))
    i = np.arange(n // 2)
    for im in range(b):
        x[im, 2::4, 0::2] += (i >> 1) & 1 if im % 2 == 0 else i & 1
    return x.astype(np.int16)


# amplitudes a with |a| & 63 in {31, 32, 33}, the dither's boundaries
DITHER_AMPLITUDES = (31, -32, 33, -31, 32, -33, 95, -96, 97, -95, 96, -97)


def dither_edge_planes(rng, b, n):
    """Zero planes with single values a (DITHER_AMPLITUDES) at even rows
    beside every CTA edge of K4/K10 (rows e - 2, e, e + 2) and at row 2,
    in even columns 2k0 beside the edges in moment space (k0 = e - 1, e
    for e an edge or n/2 - 1; every 8th pair besides).  An impulse a at
    (2 t0, 2 k0) makes the raw IV moments -a in rows k0 - 1 and k0 + 1 of
    j, whose column pass sees raw moments a at pairs t0 - 1 and t0 + 1:
    the dither of a feeds the next slot."""
    m = n // 2
    edges = analysis_cta_edges(n)
    rows = sorted({2} | {e + d for e in edges for d in (-2, 0, 2)})
    ks = sorted({k for e in edges + [m - 1, m // 2] for k in (e - 1, e)
                 if 1 <= k < m - 1} | set(range(4, m - 1, 8)))
    x = np.zeros((b, n, n), np.int16)
    for im in range(b):
        for ir, r in enumerate(rows):
            for ik, k in enumerate(ks):
                a = DITHER_AMPLITUDES[(ir + ik + im) % len(DITHER_AMPLITUDES)]
                x[im, r, 2 * k] = a
    return x


def switch_edge_planes(rng, b, n):
    """Planes in [-1800, 1800) with int16 extremes on the rows and columns
    that hold the last pair (n - 4 .. n - 1), the first (0 .. 2) and the
    middle (n/2 - 2 .. n/2 + 1): the last pair's edge terms in both
    passes, and the low moment n/2 - 1 and high moment 0 of every row,
    rows n/2 - 1 and n/2 of j, where VI switches to 53 on a CTA edge."""
    m = n // 2
    x = rng.integers(-1800, 1800, (b, n, n)).astype(np.int16)
    lines = [0, 1, 2, m - 2, m - 1, m, m + 1, n - 4, n - 3, n - 2, n - 1]
    for ln in lines:
        x[:, ln, :] = rng.choice(INT16_EXTREMES, (b, n))
        x[:, :, ln] = rng.choice(INT16_EXTREMES, (b, n))
    return x


# K1's launch shapes (csrc/dwt.cu kSynthShapes): n -> (CTAs a cluster,
# threads a CTA); CTA c owns rows [cR, (c + 1)R) of x and of the
# transposed plane, R = n / cluster
SYNTH_SHAPES = {512: (8, 512), 256: (8, 256), 128: (4, 256)}


def synth_path_shapes(b: int, entry: int = 8) -> tuple:
    """K1's (batch, n, side of the plane it is the corner of) on its
    paths: the decode's Y stage 1 and K5's synthesis at batch b, the
    transform's Y and U+V at its entry batch."""
    return ((b, 256, 512), (entry, 256, 512), (2 * entry, 128, 256))


def synth_edge_planes(rng, b, n):
    """Planes in [-2000, 2000) with int16 extremes on the rows at every
    CTA edge of K1 (cR - 1, cR) and rows 0 and n - 1, and on the columns
    of the first and last pairs and of the low/high boundary (0, 1,
    n/2 - 1, n/2, n/2 + 1, n - 1): a transposed row's first and last
    pairs, and every CTA's first and last source rows."""
    m, cluster = n // 2, SYNTH_SHAPES[n][0]
    x = rng.integers(-2000, 2000, (b, n, n)).astype(np.int16)
    rows = {0, n - 1} | {c * n // cluster + d for c in range(1, cluster)
                         for d in (-1, 0)}
    for ln in sorted(rows):
        x[:, ln, :] = rng.choice(INT16_EXTREMES, (b, n))
    for ln in (0, 1, m - 1, m, m + 1, n - 1):
        x[:, :, ln] = rng.choice(INT16_EXTREMES, (b, n))
    return x


# K7's tiles (csrc/dwt.cu kT7Rows, kT7Pairs): a CTA owns source rows
# [r0, r0 + 64) and output pairs [k0, k0 + 32), i.e. transposed rows
# [2 k0, 2 k0 + 64), of one plane
UNNORM_TILE = (64, 32)


def unnorm_path_shapes(b: int, entry: int = 8) -> tuple:
    """K7's (batch, n) on its paths: the HQ decode's and the fallback's Y
    stage 2 at batch b, the transform's Y and U+V at its entry batch."""
    return ((b, 512), (entry, 512), (2 * entry, 256))


def tile_edge_planes(rng, b, n):
    """Planes in [-2000, 2000) with int16 extremes on the rows at every
    row-tile edge of K7 (r0 - 1, r0) and rows 0 and n - 1, and on the
    columns of every pair-tile edge in both bands (k0 - 1 and k0 of L and
    of H: each tile's halo) and of unnorm_pair's own edges (0, 1, m - 2,
    m - 1 of L and of H)."""
    rows_t, pairs_t = UNNORM_TILE
    m = n // 2
    x = rng.integers(-2000, 2000, (b, n, n)).astype(np.int16)
    rows = {0, n - 1} | {r + d for r in range(rows_t, n, rows_t)
                         for d in (-1, 0)}
    ks = {0, 1, m - 2, m - 1} | {k + d for k in range(pairs_t, m, pairs_t)
                                 for d in (-1, 0)}
    for ln in sorted(rows):
        x[:, ln, :] = rng.choice(INT16_EXTREMES, (b, n))
    for k in sorted(ks):
        for ln in (k, m + k):
            x[:, :, ln] = rng.choice(INT16_EXTREMES, (b, n))
    return x


UNNORM_EDGE_INPUTS = {"int16 extremes": extreme_planes,
                      "tile edges": tile_edge_planes}

# K8's bands (csrc/dwt.cu kW8Rows): a CTA owns rows [j0, j0 + 32) of one
# transposed plane and stages rows j0 - 1 .. j0 + 32, modulo 512
WAVES_BAND = 32
# columns of the band-edge marks: both ends of a row (the column wrap)
# and the middle
WAVES_EDGE_COLS = (0, 1, 2, 255, 256, 509, 510, 511)
# an even row marked in 3 of every 4 columns (384 cells: 12 passes of 32)
WAVES_DENSE_ROW = 200


def band_edge_depth(b, n_waves):
    """``b`` (512, 512) uint8 depth planes, non-zero on even rows only:
    marks on every band's first and last even rows (j0, j0 + WAVES_BAND -
    2; row 0's row above wraps to 511, row 510's below is 511) in
    WAVES_EDGE_COLS, with depths 1 .. n_waves + 2 (some deeper than the
    waves reach); and row WAVES_DENSE_ROW in runs of 3 (depths 1, 2, 3)."""
    dp = np.zeros((b, 512, 512), np.uint8)
    rows = sorted(j0 + d for j0 in range(0, 512, WAVES_BAND)
                  for d in (0, WAVES_BAND - 2))
    for i, j in enumerate(rows):
        for k, c in enumerate(WAVES_EDGE_COLS):
            dp[:, j, c] = 1 + (i + k) % (n_waves + 2)
    c = np.arange(512)
    dp[:, WAVES_DENSE_ROW] = np.where(c % 4 == 3, 0, c % 4 + 1)
    return dp


def waves_planes(rng, b):
    """K8's transposed planes: image 0 and the first half of the batch in
    [-20, 21), where the waves fire on some cells and not on others and
    change the clipped output, the rest over the full int16 range (image 0
    is small at batch 1 too, where ``planes`` gives the full range)."""
    t = planes(rng, b, 512, -20, 21)
    t[0] = rng.integers(-20, 21, (512, 512))
    return t


def _band_case(n_waves, marked=True):
    def make(rng, b):
        dp = (band_edge_depth(b, 6) if marked
              else np.zeros((b, 512, 512), np.uint8))
        return waves_planes(rng, b), dp, n_waves
    return make


def _decode_marks_case(rng, b):
    from nhwcodec_tpu_torch.models import device_decode as tdd

    dp, n_waves, ok = tdd.mark_depth_planes(mark_lists(rng, b))
    check(ok, "decode marks are in order")
    return waves_planes(rng, b), dp, n_waves


# K8's inputs: name -> (rng, b) -> (transposed int16 plane (waves_planes),
# depth, n_waves)
WAVES_EDGE_INPUTS = {"band edges": _band_case(6),
                     "band edges, one wave": _band_case(1),
                     "unmarked": _band_case(3, marked=False),
                     "decode marks": _decode_marks_case}


ANALYSIS_EDGE_INPUTS = {"int16 extremes": extreme_planes,
                        "parity chains": parity_chain_planes,
                        "dither boundaries": dither_edge_planes,
                        "last pair, VI/53 switch": switch_edge_planes}


def cluster_edge_phase(dev) -> None:
    """K2 and K3 against their twins at batch 1, 3 and 16 (grids of 1, 3
    and 16 clusters) on random, near-flat (the waves fire), residue-bound
    and CTA-edge inputs, and K2 on rows with more marks than a warp has
    lanes."""
    import torch

    from nhwcodec_tpu_torch.models import device_decode as tdd
    from nhwcodec_tpu_torch.ops import dwt

    rng = np.random.default_rng(SEED + 3)
    for b in (1, 3, B):
        cases = []
        for what, jp, marks in (
                ("random", planes(rng, b, 512, -32768, 32768),
                 mark_lists(rng, b)),
                ("near-flat", planes(rng, b, 512, -2, 3), mark_lists(rng, b)),
                ("near-flat, CTA-edge marks", planes(rng, b, 512, -2, 3),
                 edge_marks(b)),
                ("near-flat, dense marked rows", planes(rng, b, 512, -2, 3),
                 dense_marks(b))):
            dp, n_waves, ok = tdd.mark_depth_planes(marks)
            check(ok, f"{what} marks are in order")
            cases.append((what, jp, dp, n_waves))
        cases.append(("residue bound", *residue_bound_plane(b)))
        for what, jp, dp, n_waves in cases:
            jt, dt = (torch.from_numpy(a).to(dev) for a in (jp, dp))
            compare_and_time(
                "y_stage2_full", f"({b},512,512) {what}, n_waves={n_waves}",
                lambda: dwt.y_stage2_full(jt, dt, n_waves),
                lambda: dwt.y_stage2_full_ref(jt, dt, n_waves), timed=False)
        for what, x in (("random", planes(rng, b, 256, -2000, 2000)),
                        ("sentinels", sentinel_planes(rng, b)),
                        ("CTA-edge sentinels", edge_sentinel_planes(rng, b))):
            xt = torch.from_numpy(x).to(dev)
            compare_and_time("uv_synth", f"({b},256,256) {what}",
                             lambda: dwt.uv_synth(xt),
                             lambda: dwt.uv_synth_ref(xt), timed=False)


def unnorm_edge_phase(dev) -> None:
    """K7 against its twin at batch 1, 3 and 16 at its path sizes (512,
    256, and 128 as a corner view of a 256 plane) on int16 extremes and
    values at every tile edge (UNNORM_EDGE_INPUTS)."""
    import torch

    from nhwcodec_tpu_torch.ops import dwt

    rng = np.random.default_rng(SEED + 8)
    for b in (1, 3, B):
        for what, gen in UNNORM_EDGE_INPUTS.items():
            worst = 0
            for n, side in ((512, 512), (256, 256), (128, 256)):
                parent = torch.from_numpy(rng.integers(
                    -32768, 32768, (b, side, side)).astype(np.int16)).to(dev)
                parent[:, :n, :n] = torch.from_numpy(gen(rng, b, n))
                x = parent[:, :n, :n]
                got = dwt.synth_unnorm_rows_t(x)
                worst = max(worst, int((got.to(torch.int32) - dwt
                                        .unnorm_rows_t_ref(x).to(torch.int32))
                                       .abs().max()))
            torch.cuda.synchronize()
            print(f"kernel synth_unnorm_rows_t at batch {b}, {what}: n = "
                  f"512, 256 and a 128 corner view, max_abs_err {worst} vs "
                  "torch twin", flush=True)
            check(worst == 0, f"K7 at batch {b} differs on {what}")


def waves_edge_phase(dev) -> None:
    """K8 against its twin at batch 1, 3 and 16 on its edge inputs
    (WAVES_EDGE_INPUTS), each call one launch."""
    import torch

    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.ops import dwt

    rng = np.random.default_rng(SEED + 9)
    for b in (1, 3, B):
        for what, gen in WAVES_EDGE_INPUTS.items():
            t_np, dp_np, n_waves = gen(rng, b)
            t, dp = (torch.from_numpy(a).to(dev) for a in (t_np, dp_np))
            before = build.LAUNCHES["synth_norm_rows_clip_waves"]
            got = dwt.synth_norm_rows_clip_waves(t, dp, n_waves)
            launches = build.LAUNCHES["synth_norm_rows_clip_waves"] - before
            want = dwt.synth_norm_rows_clip_waves_ref(t, dp, n_waves)
            err = int((got.to(torch.int32) - want.to(torch.int32))
                      .abs().max())
            # the pixels of image 0 that the waves change
            fired = int((want[0] != dwt.synth_norm_rows_clip_ref(t[:1])[0])
                        .sum())
            torch.cuda.synchronize()
            print(f"kernel synth_norm_rows_clip_waves at batch {b}, {what}, "
                  f"n_waves={n_waves}: {launches} launch, max_abs_err {err} "
                  f"vs torch twin; the waves change {fired} pixels of "
                  "image 0", flush=True)
            check(err == 0 and launches == 1,
                  f"K8 at batch {b} on {what}: {launches} launches, "
                  f"max_abs_err {err}")
            check((fired > 0) == bool(dp_np[0].any()),
                  f"K8 at batch {b} on {what}: the waves change {fired} "
                  "pixels of image 0")


def kernel_phase(dev) -> dict:
    import torch

    from nhwcodec_tpu_torch.models import device_decode as tdd
    from nhwcodec_tpu_torch.ops import dwt

    rng = np.random.default_rng(SEED)
    y512 = torch.from_numpy(planes(rng, B, 512, -2000, 2000)).to(dev)
    jp = torch.from_numpy(planes(rng, B, 512, -2, 3)).to(dev)
    dp_np, n_waves, ok = tdd.mark_depth_planes(mark_lists(rng, B))
    check(ok and n_waves >= 3, f"depth planes: ok={ok} n_waves={n_waves}")
    dp = torch.from_numpy(dp_np).to(dev)
    uv = torch.from_numpy(sentinel_planes(rng, 2 * B)).to(dev)

    # K1 at its paths' shapes, each a corner view (synth_path_shapes), and
    # on whole (B,512,512) planes; each call one launch of synth_cluster
    k1_rng = np.random.default_rng(SEED + 6)
    shapes = {}
    for b, n, side in synth_path_shapes(B):
        parent = torch.from_numpy(planes(k1_rng, b, side, -2000,
                                         2000)).to(dev)
        x = parent[:, :n, :n]
        shape = f"({b},{n},{n}) view of ({b},{side},{side}) int16"
        shapes[shape] = compare_and_time(
            "synth_level", shape, lambda: dwt.synth_level(x),
            lambda: dwt.synth_level_ref(x),
            bound=work(4 * b * n * n, OPS["synth_level"] * b * n * n),
            graph=True)
        check_one_launch("synth_level", shape, lambda: dwt.synth_level(x),
                         "synth_cluster")
    compare_and_time("synth_level", f"({B},512,512) int16",
                     lambda: dwt.synth_level(y512),
                     lambda: dwt.synth_level_ref(y512), timed=False)
    out = {"synth_level": shape_sums("synth_level", shapes, next(iter(
        shapes)))}

    px256, px512 = B * 256 * 256, B * 512 * 512
    cases = [
        ("y_stage2_full", f"({B},512,512) int16 + depth, n_waves={n_waves}",
         lambda: dwt.y_stage2_full(jp, dp, n_waves),
         lambda: dwt.y_stage2_full_ref(jp, dp, n_waves),
         work(4 * px512,
              OPS["y_stage2_full"] * px512 + wave_ops(dp, n_waves))),
        ("uv_synth", f"(2x{B},256,256) int16 with sentinels",
         lambda: dwt.uv_synth(uv), lambda: dwt.uv_synth_ref(uv),
         work(8 * px256, OPS["uv_synth"] * 2 * px256)),
    ]
    out.update({name: compare_and_time(name, shape, kern, twin, bound=bound,
                                       graph=True)
                for name, shape, kern, twin, bound in cases})
    # the waves did work on these inputs: one wave fewer changes pixels
    fewer = dwt.y_stage2_full(jp, dp, n_waves - 1)
    check(bool((fewer != dwt.y_stage2_full_ref(jp, dp, n_waves)).any()),
          "dering waves had no effect on the test planes")
    # K2's two-launch form before the clusters (K7 + K8) on the same inputs
    two = compare_and_time(
        "synth_unnorm_rows_t + synth_norm_rows_clip_waves (K2 as two "
        "launches)", f"({B},512,512) int16 + depth, n_waves={n_waves}",
        lambda: dwt.synth_norm_rows_clip_waves(dwt.synth_unnorm_rows_t(jp),
                                               dp, n_waves),
        lambda: dwt.y_stage2_full_ref(jp, dp, n_waves),
        bound=cases[0][4], graph=True)
    k2 = out["y_stage2_full"]
    print("kernel y_stage2_full against K7 + K8 on the same inputs: device "
          "time (profiler) "
          + (f"{k2['device_ms'] / two['device_ms']:.4f}"
             if k2["device_ms"] and two["device_ms"] else "not measured")
          + f", graph of {GRAPH_CALLS} calls "
          f"{k2['graph_ms'] / two['graph_ms']:.4f}, wrapper call "
          f"{k2['ms'] / two['ms']:.4f} of K7 + K8", flush=True)
    k2["two_launch_device_ms"] = two["device_ms"]
    k2["two_launch_graph_ms"] = two["graph_ms"]
    cluster_edge_phase(dev)

    # K7 at its paths' shapes (unnorm_path_shapes), each call one launch
    # of unnorm_rows_t_tile; its inputs from their own generator, so the
    # draws below stay as they were
    k7_rng = np.random.default_rng(SEED + 7)
    shapes = {}
    for b, n in unnorm_path_shapes(B):
        x7 = torch.from_numpy(planes(k7_rng, b, n, -2000, 2000)).to(dev)
        shape = f"({b},{n},{n}) int16"
        shapes[shape] = compare_and_time(
            "synth_unnorm_rows_t", shape, lambda: dwt.synth_unnorm_rows_t(x7),
            lambda: dwt.unnorm_rows_t_ref(x7).contiguous(),
            bound=work(4 * b * n * n, OPS["synth_unnorm_rows_t"] * b * n * n),
            graph=True)
        check_one_launch("synth_unnorm_rows_t", shape,
                         lambda: dwt.synth_unnorm_rows_t(x7),
                         "unnorm_rows_t_tile")
    out["synth_unnorm_rows_t"] = shape_sums("synth_unnorm_rows_t", shapes,
                                            f"({B},512,512) int16")
    unnorm_edge_phase(dev)

    # K8 and K9 at the HQ and fallback paths' shapes; K8 on the transposed
    # near-flat planes with the depth planes above, so its waves fire
    t = dwt.unnorm_rows_t_ref(jp).contiguous()
    y9 = torch.from_numpy(planes(rng, B, 512, -20000, 20000)).to(dev)
    cases = [
        ("synth_norm_rows_clip_waves",
         f"({B},512,512) int16 + depth, n_waves={n_waves}",
         lambda: dwt.synth_norm_rows_clip_waves(t, dp, n_waves),
         lambda: dwt.synth_norm_rows_clip_waves_ref(t, dp, n_waves),
         work(4 * px512, OPS["synth_norm_rows_clip_waves"] * px512
              + wave_ops(dp, n_waves))),
        ("synth_norm_rows_clip", f"({B},512,512) int16",
         lambda: dwt.synth_norm_rows_clip(y9),
         lambda: dwt.synth_norm_rows_clip_ref(y9),
         work(3 * px512, OPS["synth_norm_rows_clip"] * px512)),
    ]
    out.update({name: compare_and_time(name, shape, kern, twin, bound=bound,
                                       graph=True)
                for name, shape, kern, twin, bound in cases})
    check_one_launch("synth_norm_rows_clip_waves", cases[0][1], cases[0][2],
                     "waves_band")
    waves_edge_phase(dev)
    fewer = dwt.synth_norm_rows_clip_waves(t, dp, n_waves - 1)
    check(bool((fewer != dwt.synth_norm_rows_clip_waves_ref(t, dp, n_waves))
               .any()), "K8's dering waves had no effect on the test planes")
    # the mark scan works in place: each call takes its own clone of the
    # plane, made before any timing
    recs, valid = (torch.from_numpy(a).to(dev) for a in
                   tdd.pad_marks(out_of_order_marks(rng, B)))
    check(not tdd.mark_depth_planes(out_of_order_marks(
        np.random.default_rng(SEED), 1))[2], "scan marks are in order")
    x = torch.from_numpy(planes(rng, B, 512, -12, 13)).to(dev)
    k_in = fresh_inputs([x], 4 + RUNS + PROFILE_TRIES * 10)
    t_in = fresh_inputs([x], 4 + RUNS + PROFILE_TRIES)
    # the scan reads each live record's 3x3 cells and writes its centre
    live = int(valid.sum())
    out["smooth_marks_seq"] = compare_and_time(
        "smooth_marks_seq",
        f"({B},512,512) int16, {int(valid.sum())} out-of-order marks",
        lambda: dwt.smooth_marks_seq(*k_in(), recs, valid),
        lambda: dwt.smooth_marks_seq_ref(*t_in(), recs, valid),
        twin_calls=1,   # one step of some 12 launches a rank
        bound=work(5 * recs.numel() + 20 * live,
                   OPS["smooth_marks_seq"] * live))
    out["smooth_marks_seq"].update(mark_scan_phase(dev))
    return out


def mark_scan_phase(dev) -> dict:
    """The mark scan (``mark_rows``) against its twin at batch 1, 3 and
    16 and the host copy's C on every MARK_KINDS input, one launch a
    call; graphs of clone + scan and of the clone alone at batch 16 on
    the out-of-order, edge and dense lists beside MARK_SCAN_WAS_MS.
    Returns the out-of-order graphs' ms (graph_ms, clone_graph_ms)."""
    import torch

    from nhwcodec_tpu_torch.ops import dwt

    def scan(x, r, v):
        return dwt.smooth_marks_seq(x.clone(), r, v)

    def twin(x, r, v):
        return dwt.smooth_marks_seq_ref(x.clone(), r, v)

    rng = np.random.default_rng(SEED + 90)
    out = {}
    for kind in MARK_KINDS:
        x_np, r_np, v_np = mark_scan_inputs(rng, B, kind)
        x, r, v = (torch.from_numpy(a).to(dev) for a in (x_np, r_np, v_np))
        compare_batches("smooth_marks_seq", f"{kind} marks", scan, twin,
                        (x, r, v))
        got = scan(x, r, v).cpu().numpy()
        check(np.array_equal(got, host_marks(x_np, r_np, v_np)),
              f"smooth_marks_seq {kind} marks: differs from the host copy's "
              "C")
        check(kind == "mixed K" or (got != x_np).sum() > 100 * B,
              f"smooth_marks_seq {kind} marks: the scan smoothed little")
        if kind in ("out of order", "edges", "dense"):
            live = int((v & (r >= 256) & (r < 65536)).sum())
            g_ms = graph_ms(lambda: scan(x, r, v))
            c_ms = graph_ms(lambda: x.clone())
            print(f"kernel smooth_marks_seq ({B},512,512) {kind} marks, "
                  f"{live} live records (K {r.shape[1]}): graph of "
                  f"{GRAPH_CALLS} calls of clone + scan {g_ms:.4f} ms, of "
                  f"the clone alone {c_ms:.4f} ms (CUDA events); the "
                  f"design before: {MARK_SCAN_WAS_MS} ms device time on "
                  "the out-of-order planes (PERF.md)", flush=True)
            if kind == "out of order":
                out = {"graph_ms": g_ms, "clone_graph_ms": c_ms}
                xc = x.clone()
                check_one_launch("smooth_marks_seq", f"{kind} marks",
                                 lambda: dwt.smooth_marks_seq(xc, r, v),
                                 "mark_rows")
    return out


def colorspace_phase(dev) -> None:
    import torch

    from nhwcodec_tpu_torch.host.models import decoder
    from nhwcodec_tpu_torch.ops import colorspace

    allv = torch.arange(1 << 24, dtype=torch.int64, device=dev)
    ys = (allv >> 16).to(torch.uint8).reshape(64, 512, 512)
    us = ((allv >> 8) & 255).to(torch.uint8).reshape(64, 512, 512)
    vs = (allv & 255).to(torch.uint8).reshape(64, 512, 512)
    ys_h, us_h, vs_h = ys.cpu().numpy(), us.cpu().numpy(), vs.cpu().numpy()
    for q in (20, 17, 18, 16):
        t0 = time.perf_counter()
        got = colorspace.yuv_to_rgb(ys, us, vs, q).cpu().numpy()
        bad = 0
        for c in range(64):
            want = decoder.yuv_to_rgb(ys_h[c], us_h[c], vs_h[c], q)
            bad += int((got[c] != want).any(axis=-1).sum())
        ms16 = median_ms(lambda: colorspace.yuv_to_rgb(
            ys[:B], us[:B], vs[:B], q), runs=10)
        print(f"colorspace q{q} mode {colorspace.decode_mode(q)}: all 2^24 "
              f"(y,u,v) on the card vs decoder.yuv_to_rgb: {bad} mismatches "
              f"({time.perf_counter() - t0:.1f} s); {ms16:.4f} ms per "
              f"({B},512,512) batch", flush=True)
        check(bad == 0, f"colorspace q{q} differs from the host decoder")


def decode_phase(dev) -> dict:
    from nhwcodec_tpu_torch.host.models import decoder, encoder
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    gens = list(fixture_generators().values())
    t0 = time.perf_counter()
    q20 = [encoder.encode(gens[i % len(gens)](), 20) for i in range(B)]
    mixed = [encoder.encode(gens[i](), q)
             for i, q in enumerate((4, 14, 19, 21))]
    t_enc = time.perf_counter() - t0
    for name, data in zip(fixture_generators(), q20):
        check(sha256(data) == STREAM_SHA256[(name, 20)],
              f"host encoder's q20 {name} stream differs from the pinned "
              "digest")
    t0 = time.perf_counter()
    want = [decoder.decode(d) for d in q20 + mixed]
    t_host = time.perf_counter() - t0
    print(f"host: encoded {len(q20) + len(mixed)} streams in {t_enc:.1f} s; "
          f"host decoder {1e3 * t_host / len(want):.1f} ms/img", flush=True)

    build.reset_launches()
    t0 = time.perf_counter()
    out, m = tdp.decode_batch_device(q20, workers=1, chunk=B, device=dev)
    t_q20 = time.perf_counter() - t0
    out2, m2 = tdp.decode_batch_device(mixed, device=dev)
    launches = {k: build.LAUNCHES[k] for k in DECODE_KERNELS}

    check(m.failures == 0 and m2.failures == 0,
          f"decode failures: {m.failures} + {m2.failures}")
    for i, (w, g) in enumerate(zip(want, out + out2)):
        check(g is not None and g.shape == (512, 512, 3)
              and g.dtype == np.uint8, f"image {i}: bad output")
        check(np.array_equal(w, g), f"image {i} differs from decoder.decode")
    print(f"decode: {len(out)} q20 streams + mixed batch q4/14/19/21 "
          f"byte-identical to decoder.decode; launches {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the decode path was not launched: {launches}")

    t0 = time.perf_counter()
    again, _ = tdp.decode_batch_device(q20, workers=1, chunk=B, device=dev)
    t_again = time.perf_counter() - t0
    check(all(np.array_equal(a, b) for a, b in zip(again, out)),
          "second decode run differs")
    print(f"decode end to end, batch {B} q20 in one chunk: first run "
          f"{1e3 * t_q20 / B:.2f} ms/img, second run "
          f"{1e3 * t_again / B:.2f} ms/img", flush=True)

    t0 = time.perf_counter()
    pooled, mp = tdp.decode_batch_device(q20, device=dev)
    t_pool = time.perf_counter() - t0
    check(mp.failures == 0 and all(
        np.array_equal(a, b) for a, b in zip(pooled, out)),
        "default-pool decode differs")
    print(f"decode end to end, batch {B} q20, default pool "
          f"({os.cpu_count()} workers): {1e3 * t_pool / B:.2f} ms/img",
          flush=True)

    def one_chunk():
        tdp.decode_batch_device(q20, workers=1, chunk=B, device=dev)

    print_profile(f"decode, batch {B} q20 in one chunk", one_chunk)
    print_breakdown(f"decode breakdown, batch {B} q20 in one chunk",
                    *host_breakdown(one_chunk, decode_targets(),
                                   HUFFMAN_GROUPS))
    return launches


# the host automata of the Huffman decode, timed inside decode_y_front
HUFFMAN_GROUPS = ("host Huffman",)


def decode_targets():
    """The host steps of the decode, grouped for ``host_breakdown`` (with
    ``inner=HUFFMAN_GROUPS``: the Huffman decode inside the front counts
    as "host Huffman", the rest of the front as "host front")."""
    from nhwcodec_tpu_torch.host.models import decoder
    from nhwcodec_tpu_torch.host.ops import dc_plane, entropy
    from nhwcodec_tpu_torch.models import device_decode as tdd

    return [(tdd, "parse_nhw", "host front"),
            (dc_plane, "decode_dc_planes", "host front"),
            (decoder, "decode_y_front", "host front"),
            (entropy, "decode_y", "host Huffman"),
            (entropy, "decode_uv", "host Huffman"),
            (decoder, "decode_uv_front", "host front"),
            (decoder, "_dering_mark_y", "host dering"),
            (tdd, "mark_depth_planes", "host depth planes"),
            (decoder, "decode_uv_back", "host uv back"),
            (tdd, "front_to_torch", "front_to_torch copies")]


def decode_checked(what: str, datas, want, kernels, absent=(), **kw):
    """Decode ``datas`` through the pipeline with the launch counts set to
    0 just before; check every image against ``want``, that each of
    ``kernels`` was launched and none of ``absent``.  Returns (images,
    seconds, launches of ``kernels``)."""
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    build.reset_launches()
    t0 = time.perf_counter()
    out, m = tdp.decode_batch_device(datas, workers=1, **kw)
    sec = time.perf_counter() - t0
    launches = dict(build.LAUNCHES)
    check(m.failures == 0, f"{what}: {m.failures} decode failures")
    for i, (w, g) in enumerate(zip(want, out)):
        check(g is not None and g.shape == (512, 512, 3)
              and g.dtype == np.uint8, f"{what}, image {i}: bad output")
        check(np.array_equal(w, g),
              f"{what}, image {i} differs from decoder.decode")
    got = {k: launches[k] for k in kernels}
    print(f"decode {what}: {len(out)} images byte-identical to "
          f"decoder.decode; launches {got}"
          + "".join(f", {k} {launches[k]}" for k in absent), flush=True)
    check(all(v > 0 for v in got.values()),
          f"{what}: a kernel of the path was not launched: {got}")
    check(not any(launches[k] for k in absent),
          f"{what}: launched {[k for k in absent if launches[k]]}")
    return out, sec, got


def hq_decode_phase(dev) -> dict:
    """q23 and q22 batches of 16 and a mixed q20/22/23/21 batch, each in
    one chunk: the HQ branch (K7, the scatter, K8), not K2."""
    from nhwcodec_tpu_torch.host.models import decoder, encoder
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    gens = list(fixture_generators().values())
    t0 = time.perf_counter()
    batches = {q: [encoder.encode(gens[i % len(gens)](), q)
                   for i in range(B)] for q in (23, 22)}
    batches["mixed q20/22/23/21"] = [encoder.encode(gens[i](), q)
                                     for i, q in enumerate((20, 22, 23, 21))]
    want = {k: [decoder.decode(d) for d in v] for k, v in batches.items()}
    print(f"host: encoded and decoded the HQ batches in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = {}
    for what, datas in batches.items():
        name = f"q{what}" if isinstance(what, int) else what
        out, sec, got = decode_checked(
            f"{name}, batch {len(datas)} in one chunk", datas, want[what],
            ("synth_level", "uv_synth") + HQ_KERNELS,
            absent=("y_stage2_full",),
            chunk=len(datas), device=dev)
        if what == 23:
            launches = {k: got[k] for k in HQ_KERNELS}
            t0 = time.perf_counter()
            again, _ = tdp.decode_batch_device(datas, workers=1, chunk=B,
                                               device=dev)
            t_again = time.perf_counter() - t0
            check(all(np.array_equal(a, b) for a, b in zip(again, out)),
                  "second q23 decode run differs")
            print(f"decode end to end, batch {B} q23 in one chunk: first "
                  f"run {1e3 * sec / B:.2f} ms/img, second run "
                  f"{1e3 * t_again / B:.2f} ms/img", flush=True)

    def one_chunk():
        tdp.decode_batch_device(batches[23], workers=1, chunk=B, device=dev)

    hq_stage2_split(dev, batches[23])
    print_profile(f"decode, batch {B} q23 in one chunk", one_chunk)
    print_breakdown(f"decode breakdown, batch {B} q23 in one chunk",
                    *host_breakdown(one_chunk, decode_targets(),
                                   HUFFMAN_GROUPS))
    return launches


def hq_stage2_split(dev, datas) -> None:
    """The HQ Y stage 2 (``y_stage2_dense`` with HQ pairs: the LL1 copy
    into the plane, K7, the HQ scatter, K8) at the size of one chunk of
    ``datas``, op by op: under torch.profiler (every device entry, ms per
    call) and as a CUDA graph of back-to-back calls.  The HQ pairs are the
    chunk's own, from the host front; the coefficient and LL1 planes and
    the depth planes are drawn as kernel_phase draws them."""
    import torch

    from nhwcodec_tpu_torch.host.models import decoder as dec
    from nhwcodec_tpu_torch.host.ops import dc_plane
    from nhwcodec_tpu_torch.host.utils.container import parse_nhw
    from nhwcodec_tpu_torch.models import device_decode as tdd

    hqs = []
    for data in datas:
        s = parse_nhw(data)
        res_comp = dc_plane.decode_dc_planes(
            s.res_ch, s.highres_comp, s.res_U_64, s.res_V_64, s.quality,
            s.res_high)
        hqs.append(dec.decode_y_front(s, res_comp)[2])
    check(any(len(i) for i, _ in hqs), "the chunk has no HQ pair")
    b = len(datas)
    rng = np.random.default_rng(SEED + 10)
    dp_np, n_waves, ok = tdd.mark_depth_planes(mark_lists(rng, b))
    check(ok, "depth planes of the HQ split")
    args = (*tdd.front_to_torch(dev, planes(rng, b, 512, -2, 3),
                                planes(rng, b, 256, -2000, 2000), dp_np),
            n_waves, *tdd.front_to_torch(dev, *tdd.pad_hq(hqs)))
    torch.cuda.synchronize()
    _, dev_ms, entries = device_profile(lambda: tdd.y_stage2_dense(*args),
                                        calls=10)
    g_ms = graph_ms(lambda: tdd.y_stage2_dense(*args))
    print(f"HQ Y stage 2, batch {b} (y_stage2_dense, the q23 chunk's "
          f"{args[4].shape[1]} HQ pairs a plane, n_waves={n_waves}): device "
          f"time per call (profiler) {dev_ms} ms, graph of {GRAPH_CALLS} "
          f"calls (CUDA events) {g_ms:.4f} ms; device entries (ms per "
          "call): " + "; ".join(f"{k[:110]} {v:.4f}" for k, v in entries),
          flush=True)


def fallback_streams() -> list:
    """4 q20 and 4 q23 streams of the fixtures (the host copy's encoder),
    the forced fallback's inputs."""
    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.host.utils import fixtures

    gens = list(fixtures.GENERATORS.values())
    return [encoder.encode(gens[i % len(gens)](), q)
            for q in (20, 23) for i in range(4)]


class ScanCapture:
    """Inside a ``with``: the depth planes refused (the decode takes the
    sequential fallback), and each mark scan's inputs, (plane before the
    scan, recs, valid), recorded in ``calls``."""

    def __enter__(self):
        from nhwcodec_tpu_torch.models import device_decode as tdd
        from nhwcodec_tpu_torch.ops import dwt

        self.calls = []
        self._saved = tdd.mark_depth_planes, dwt.smooth_marks_seq
        scan = dwt.smooth_marks_seq

        def record(x, recs, valid):
            self.calls.append((x.clone(), recs, valid))
            return scan(x, recs, valid)

        tdd.mark_depth_planes = lambda marks: (None, 0, False)
        dwt.smooth_marks_seq = record
        return self

    def __exit__(self, *exc):
        from nhwcodec_tpu_torch.models import device_decode as tdd
        from nhwcodec_tpu_torch.ops import dwt

        tdd.mark_depth_planes, dwt.smooth_marks_seq = self._saved


def fallback_phase(dev) -> dict:
    """The sequential mark-scan fallback, forced by refusing the depth
    planes: 4 q20 and 4 q23 streams, chunks of 4 (K7, the scatter, the
    scan, K9), one scan a chunk; then the scan on each chunk's own
    inputs against its twin and the host copy's C, the q20 chunk's timed
    (graphs of clone + scan and of the clone) beside MARK_SCAN_WAS_MS."""
    from nhwcodec_tpu_torch.host.models import decoder
    from nhwcodec_tpu_torch.ops import dwt

    datas = fallback_streams()
    want = [decoder.decode(d) for d in datas]
    with ScanCapture() as cap:
        _, sec, got = decode_checked(
            "sequential fallback (depth planes refused), q20 x4 + q23 x4 in "
            "chunks of 4", datas, want,
            ("synth_level", "synth_unnorm_rows_t") + FALLBACK_KERNELS,
            absent=("y_stage2_full", "synth_norm_rows_clip_waves"),
            chunk=4, device=dev)
    print(f"decode end to end, sequential fallback: "
          f"{1e3 * sec / len(datas):.2f} ms/img (first run)", flush=True)
    check(got["smooth_marks_seq"] == 2 and len(cap.calls) == 2,
          f"sequential fallback: {got['smooth_marks_seq']} mark scans for 2 "
          "chunks")
    for q, (x, recs, valid) in zip((20, 23), cap.calls):
        what = f"the q{q} fallback chunk's own marks"
        compare_and_time("smooth_marks_seq", what,
                         lambda: dwt.smooth_marks_seq(x.clone(), recs, valid),
                         lambda: dwt.smooth_marks_seq_ref(x.clone(), recs,
                                                          valid),
                         timed=False)
        check(np.array_equal(
            dwt.smooth_marks_seq(x.clone(), recs, valid).cpu().numpy(),
            host_marks(*(a.cpu().numpy() for a in (x, recs, valid)))),
            f"smooth_marks_seq on {what}: differs from the host copy's C")
        if q == 20:
            live = int((valid & (recs >= 256) & (recs < 65536)).sum())
            g_ms = graph_ms(lambda: dwt.smooth_marks_seq(x.clone(), recs,
                                                         valid))
            c_ms = graph_ms(lambda: x.clone())
            print(f"kernel smooth_marks_seq {tuple(x.shape)} {what}, {live} "
                  f"live records (K {recs.shape[1]}): graph of {GRAPH_CALLS} "
                  f"calls of clone + scan {g_ms:.4f} ms, of the clone alone "
                  f"{c_ms:.4f} ms (CUDA events); the design before: "
                  f"{MARK_SCAN_WAS_MS} ms device time on kernel_phase's "
                  "out-of-order planes (PERF.md)", flush=True)
    return {k: got[k] for k in FALLBACK_KERNELS}


# the device entropy decode (entropy_on_device=True): E1 chain_starts and
# E2 y_runs_fixpoint, csrc/entropy.cu
ENTROPY_KERNELS = ("chain_starts", "y_runs_fixpoint")
# the work each function needs, in operations: a codeword start's peek,
# 5-step segment search, length, symbol and step to the next start; one
# step of the run automaton.  (E1's design does more: it builds each
# word's transfer function at all 32 offsets, so that the chain's words
# can be walked in parallel; CHAIN_OPS_OFFSET operations an offset, the
# floor of any design that walks every offset, beside the bound of
# record.)
CHAIN_OPS_START = 30
CHAIN_OPS_OFFSET = 30
RUN_OPS = 60
E1_KERNELS = {"chain_scan"}
# the graph time of the three-launch E1 this design replaced, on the q20
# chunk's Y words (ms, NVIDIA H100 80GB HBM3 at 700 W; PERF.md)
E1_WAS_GRAPH_MS = 0.1296
# E1's edge streams: words a stream around a 256-word tile and past the
# look-back's 32-tile window
E1_EDGE_WORDS = (1, 255, 256, 257, 300 * 256 + 17)
E2_KS = (64, 128, 256, 512, 1024)
E2_TWIN_DEPTH = 2048    # the runs of each stream the k = 1 twin walks
# the device time of the one-CTA E2 kernel this design replaced, on the
# same q20 chunk (ms, profiler; NVIDIA H100 80GB HBM3 at 700 W), by k
E2_WAS_MS = {64: 1.3238, 256: 0.6992, 1024: 1.1951}


def entropy_chunks(images) -> dict:
    """q -> (.nhw strings, parsed streams) of ``images`` host-encoded at
    q20 and q23: the chunks of 16 the entropy phases decode."""
    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.host.utils.container import parse_nhw

    t0 = time.perf_counter()
    out = {}
    for q in (20, 23):
        datas = [encoder.encode(img, q) for img in images]
        out[q] = (datas, [parse_nhw(d) for d in datas])
    print(f"host: encoded the entropy chunks (q20, q23) in "
          f"{time.perf_counter() - t0:.1f} s; q20 Y packets "
          f"{[s.packet1.size for s in out[20][1]]} words", flush=True)
    return out


def chain_cases(dev, parsed) -> dict:
    """E1's inputs, label -> (words, nbits, zone, s_max): the Y and UV
    words of the q20 chunk at batch 1 (the largest stream), 3 and 16, the
    near-flat fixture's Y words alone, and random words in both zone
    modes with bit counts off the word grid at batch 1, 3 and 16."""
    import torch

    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    def args(packets, zones, cap):
        words, nbits = edd._pack_words(packets, dev)
        return (words, nbits, torch.tensor(zones, dtype=torch.int32,
                                           device=dev),
                edd._s_max(int(nbits.max()), cap))

    sizes = [s.packet1.size for s in parsed]
    big = int(np.argmax(sizes))
    flat = list(fixture_generators()).index("flat")
    cases = {}
    for b, sel in ((1, [big]), (3, [big, flat, (big + 1) % len(parsed)]),
                   (len(parsed), range(len(parsed)))):
        ss = [parsed[i] for i in sel]
        cases[f"Y words, batch {b}"] = args(
            [s.packet1 for s in ss], [int(s.res_high < 4) for s in ss],
            edd.Y_P1)
        cases[f"UV words, batch {b}"] = args(
            [s.packet2 for s in ss], [0] * b, edd.UV_P1 + 1)
    cases[f"near_flat Y words ({sizes[flat]} words)"] = args(
        [parsed[flat].packet1], [int(parsed[flat].res_high < 4)], edd.Y_P1)
    rng = np.random.default_rng(SEED + 20)
    for b in (1, 3, B):
        words = rng.integers(0, 1 << 32, (b, 4099), dtype=np.uint64).astype(
            np.uint32)
        nbits = 32 * 4099 - 13 - 7 * np.arange(b)
        w = torch.from_numpy(words.view(np.int32)).to(dev)
        cases[f"random words, batch {b}, both zones"] = (
            w, torch.from_numpy(nbits.astype(np.int32)).to(dev),
            torch.from_numpy((np.arange(b) % 2).astype(np.int32)).to(dev),
            edd._s_max(int(nbits.max()), edd.Y_P1))
    return cases


def chain_edge_cases(dev, rng) -> dict:
    """E1's edge streams, label -> (words, nbits, zone, s_max): random
    words at each count of E1_EDGE_WORDS (a 256-word tile and one word
    either side, and 300 tiles), both zone modes, bit counts off the word
    grid, the last word of every third stream zero, at batch 1, 3 and
    16."""
    import torch

    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    cases = {}
    for nw in E1_EDGE_WORDS:
        for b in (1, 3, B):
            words = rng.integers(0, 1 << 32, (b, nw), dtype=np.uint64).astype(
                np.uint32)
            words[2::3, -1] = 0
            nbits = np.maximum(1, 32 * nw - 5 - 7 * np.arange(b))
            cases[f"{nw} words, batch {b}, both zones"] = (
                torch.from_numpy(words.view(np.int32)).to(dev),
                torch.from_numpy(nbits.astype(np.int32)).to(dev),
                torch.from_numpy((np.arange(b) % 2).astype(np.int32)).to(dev),
                edd._s_max(32 * nw, 1 << 20))
    return cases


def per_stream(a, b: int):
    """(L, B k) time-major per-run array -> (B, k L), runs in order."""
    return a.t().reshape(b, -1)


E2_EDGE_KINDS = ("random", "pinned tail", "carry through every chunk",
                 "k + 1 sweeps", "past the plane")
E2_EDGE_KS = (7, 37, 100)    # chunks a stream, none a power of two
# (k, L): 262,144 runs a stream, past the 225,280 a cluster of 8 stages
E2_LONG = (1024, 256)


def e2_edge_tuples(rng, b, k, length, kind: str) -> tuple:
    """(ebase, fields) (L, B k) int32 per-run tuples for E2, k chunks of
    ``length`` runs a stream, laid out as ``_runs_xs_batch`` lays them
    (chunk c of stream i in lane i k + c): "random" (random runs, 254-runs
    one in 20, three in ten of 1-5, advances of 1-11 so that the e_in
    thresholds near the start matter), "pinned tail" (stream i's runs
    past a cut at (i + 1) / (b + 1) of its runs are padding, so its later
    chunks are all pinned), "carry through every chunk" (only each
    stream's first
    run acts; the other runs lie below p1 - 1 but are not valid, so the
    window it leaves rides the shift relay through all k chunks, one a
    sweep: k sweeps), "k + 1 sweeps" (the same, but the first chunk's
    second run lies below its first, so its insert is made with the
    initial run_over and not with the floor the relay gives chunk 0: the
    chain starts a sweep late and the stream stops at the k + 1 cap, the
    only way past k sweeps at k >= 2; real streams' e_base increase),
    "past the plane" (random runs whose e_base crosses p1 - 1 in the
    middle of the stream)."""
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    p1 = edd.Y_P1
    runs = k * length
    shape = (b, runs)
    rle = np.where(rng.random(shape) < 0.3, rng.integers(1, 6, shape),
                   rng.integers(1, 256, shape))
    rle[rng.random(shape) < 0.05] = 254
    segm = rng.integers(0, 32, shape)
    segc = rng.integers(0, 6, shape)
    prev_run = (rng.random(shape) < 0.5).astype(np.int64)
    mem2 = rng.integers(0, 2, shape)
    valid = np.ones(shape, np.int64)
    adv = rng.integers(1, 12, shape)
    ebase = np.cumsum(adv, 1) - adv
    if kind == "pinned tail":
        for i in range(b):
            cut = runs * (i + 1) // (b + 1)
            valid[i, cut:] = 0
            ebase[i, cut:] = p1 + (1 << 20)
    elif kind == "carry through every chunk":
        valid[:, 1:] = 0
        rle[:, 0], segm[:, 0], segc[:, 0], prev_run[:, 0] = 1, 1, 1, 0
    elif kind == "k + 1 sweeps":
        # run 1 inserts (rle 4, the window clear, no run before) only
        # while run_over is -257: room = 5 + 4 - 257 against 2000 - 256
        valid[:, 2:] = 0
        ebase[:, 0], ebase[:, 1] = 2000, 5
        rle[:, :2] = (1, 4)
        segm[:, :2], segc[:, :2], prev_run[:, :2], mem2[:, :2] = 0, 0, 0, 0
    elif kind == "past the plane":
        ebase += p1 - 1 - ebase[:, runs // 2: runs // 2 + 1]
    fields = (rle | segm << 8 | segc << 13 | prev_run << 16 | mem2 << 17
              | valid << 18)

    def time_major(a):
        return np.ascontiguousarray(a.reshape(b * k, length).T).astype(
            np.int32)
    return time_major(ebase), time_major(fields)


def e2_check(what: str, kern, twin, b: int) -> tuple:
    """E2 against its twin: e_in, flags and sweeps equal.  Returns (the
    kernel's outputs, the twin's call ms)."""
    import torch

    got = kern()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    want = twin()
    end.record()
    end.synchronize()
    err = max(int((g.to(torch.int64) - w.to(torch.int64)).abs().max())
              for g, w in zip(got, want))
    print(f"kernel y_runs_fixpoint {what}: max_abs_err {err} vs torch twin "
          f"(e_in, flags, sweeps); sweeps per stream "
          f"{got[2].tolist()}; twin call {start.elapsed_time(end):.1f} ms",
          flush=True)
    check(err == 0, f"y_runs_fixpoint disagrees with its twin: {what}")
    return got, start.elapsed_time(end)


def entropy_kernel_phase(dev, chunks) -> dict:
    """E1 against its twin at batch 1, 3 and 16 on the q20 chunk's Y and
    UV words (chain_cases) and on the edge streams (chain_edge_cases),
    timed on the chunk's Y words and, alone, its UV words, each checked
    to be one launch and one fill; E2 against its twin at batch 1, 3 and 16
    (``e2_batches``) on the per-run tuples of the q20 and q23 chunks at
    the default k (``edd.K_CHUNKS``), at k = 1 to E2_TWIN_DEPTH runs of
    each stream, and at full depth (the one CTA reading most rows from
    global memory) equal to the default k's ys, and on the edge tuples
    (``e2_edge_phase``); timed at k in E2_KS with each k's sweeps and
    serial depth."""
    import torch

    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    out = {}
    cases = chain_cases(dev, chunks[20][1])
    cases.update(chain_edge_cases(dev, np.random.default_rng(SEED + 21)))
    for label, args in cases.items():
        timed = label in (f"Y words, batch {B}", f"UV words, batch {B}")
        words, nbits, _, s_max = args
        b, w = words.shape
        bound = None
        if timed:
            # the streams' own words (not the zero padding to W), the
            # symbol of every start below nbits and of the first past it
            # (the ones the decode reads), the counts
            starts = int(torch.clamp(edd.chain_starts_batch(*args)[1] + 1,
                                     max=s_max).sum())
            bound = work(int(nbits.to(torch.int64).sum()) // 8 + 8 * b
                         + 4 * starts + 4 * b, CHAIN_OPS_START * starts)
            # any design that walks every offset of every word
            floor = work(0, CHAIN_OPS_OFFSET * 32 * int(
                (nbits.to(torch.int64) + 31).div(32, rounding_mode="floor")
                .sum()))
        res = compare_and_time(
            "chain_starts", f"{label}: ({b},{w}) words, s_max {s_max}",
            lambda: edd.chain_starts_batch(*args),
            lambda: edd.chain_starts_ref(*args), timed=timed, bound=bound,
            graph=True)
        if not timed:
            continue
        print(f"kernel chain_starts {label}: {res['graph_ms']:.4f} ms "
              f"(graph of {GRAPH_CALLS} calls, CUDA events); bound "
              f"{1e3 * bound['bound_ms']:.3f} us ({bound['bound_by']}), "
              f"{bound['bound_ms'] / res['graph_ms']:.2%} of it; the floor "
              f"of a design that walks every offset "
              f"{1e3 * floor['bound_ms']:.3f} us, "
              f"{floor['bound_ms'] / res['graph_ms']:.2%}"
              + (f"; the design before: {E1_WAS_GRAPH_MS} ms (PERF.md)"
                 if label.startswith("Y") else ""), flush=True)
        host, records, names = launches_per_call(
            lambda: edd.chain_starts_batch(*args))
        print(f"kernel chain_starts {label}: {host:g} kernel launch "
              f"calls per call, kernels {sorted(set(names))}", flush=True)
        # one launch of E1's own, and the fill that zeroes its look-back
        # state (the ticket and the tiles' status words)
        own = {k for k in E1_KERNELS if any(k + "(" in n for n in names)}
        others = [n for n in names if not any(k + "(" in n
                                              for k in E1_KERNELS)]
        check(host == 2 and own == E1_KERNELS
              and all("FillFunctor" in n for n in others),
              f"chain_starts {label} is not one launch of "
              f"{sorted(E1_KERNELS)} and one fill")
        if label.startswith("Y"):
            out["chain_starts"] = {**res, "floor_us": 1e3 * floor["bound_ms"]}
        else:
            out["chain_starts"].update(
                uv_ms=res["ms"], uv_graph_ms=res["graph_ms"],
                uv_device_ms=res["device_ms"], uv_bound_us=res["bound_us"])

    p1 = edd.Y_P1
    k_def = edd.K_CHUNKS
    for q in (20, 23):
        parsed = chunks[q][1]
        b = len(parsed)
        syms, book, r_max = edd._y_run_inputs(parsed, p1, dev)
        k = min(k_def, r_max)
        xs, _ = edd._runs_xs_batch(syms, book, p1, r_max, k)
        length = xs[0].shape[0]
        cluster, cpc, rows = edd.fixpoint_layout(length, k)
        print(f"kernel y_runs_fixpoint q{q} chunk: {r_max} runs at most, "
              f"k={k}, L={length}; a cluster of {cluster} CTAs a stream, "
              f"{cpc} chunks a CTA, {rows} of {length} rows staged "
              f"({8 * rows * cpc} bytes a CTA)", flush=True)
        e2_batches(f"q{q} chunk, k={k}", xs, p1, k, b)
        got = edd.runs_fixpoint(*xs, p1, k)
        # the k = 1 fallback's one CTA stages what fits of each stream and
        # reads the rest from global memory
        xs1, _ = edd._runs_xs_batch(syms, book, p1, r_max, 1)
        one = edd.runs_fixpoint(*xs1, p1, 1)
        rows1 = edd.fixpoint_layout(xs1[0].shape[0], 1)[2]
        # the flags everywhere; e_in where a run can act (a chunk with no
        # such run is pinned, its inserts counted from 0)
        can_act = per_stream(xs[0], b)[:, :r_max] < p1 - 1
        check(torch.equal(per_stream(one[1], b)[:, :r_max],
                          per_stream(got[1], b)[:, :r_max])
              and torch.equal(per_stream(one[0], b)[:, :r_max][can_act],
                              per_stream(got[0], b)[:, :r_max][can_act]),
              f"y_runs_fixpoint q{q}: k=1 and k={k} ys differ")
        depth = [a[:E2_TWIN_DEPTH].contiguous() for a in xs1]
        e2_check(f"q{q} chunk of {b}, k=1, the first {E2_TWIN_DEPTH} runs "
                 "of each stream", lambda: edd.runs_fixpoint(*depth, p1, 1),
                 lambda: edd.runs_fixpoint_ref(*depth, p1, 1), b)
        print(f"kernel y_runs_fixpoint q{q}: k=1 at full depth ({rows1} "
              f"of {xs1[0].shape[0]} runs staged, the rest read from "
              f"global memory) equals k={k} on the flags and on the "
              f"{int(can_act.sum())} runs that can act (sweeps "
              f"{one[2].tolist()})", flush=True)
        if q != 20:
            continue
        twin_ms = e2_check(f"q20 chunk of {b}, k={k} (the twin timed)",
                           lambda: edd.runs_fixpoint(*xs, p1, k),
                           lambda: edd.runs_fixpoint_ref(*xs, p1, k), b)[1]
        per_k = {}
        for kk in E2_KS:
            xk, _ = edd._runs_xs_batch(syms, book, p1, r_max, kk)
            length, n = xk[0].shape
            # each valid run's tuple read (8 bytes), its e_in and flags
            # written (5), and the sweep counts; not the padding runs
            valid = int(((xk[1] >> 18) & 1).sum())
            bound = work(13 * valid + 4 * b, RUN_OPS * valid)
            ms = median_ms(lambda: edd.runs_fixpoint(*xk, p1, kk))
            _, dev_ms, _ = device_profile(
                lambda: edd.runs_fixpoint(*xk, p1, kk), calls=10)
            g_ms = graph_ms(lambda: edd.runs_fixpoint(*xk, p1, kk))
            sweeps = edd.runs_fixpoint(*xk, p1, kk)[2]
            smax = int(sweeps.max())
            per_k[kk] = {"ms": ms, "device_ms": dev_ms, "graph_ms": g_ms,
                         "sweeps": smax, "serial_depth": smax * length,
                         "length": length}
            print(f"kernel y_runs_fixpoint q20 chunk, k={kk}: L={length} "
                  f"runs a chunk, sweeps {sweeps.tolist()} (max {smax}), "
                  f"serial depth {smax * length} dependent steps; wrapper "
                  f"call {ms:.4f} ms (median of {RUNS}), device time per "
                  f"call (profiler) {dev_ms} ms, graph of {GRAPH_CALLS} "
                  f"calls {g_ms:.4f} ms per call "
                  f"({1e6 * g_ms / (smax * length):.1f} ns a dependent "
                  f"step); was (the one-CTA kernel, H100 at 700 W) "
                  f"{E2_WAS_MS.get(kk, 'not measured')} ms; bound "
                  f"{1e3 * bound['bound_ms']:.3f} us ({bound['bound_by']}"
                  f", {valid} runs)", flush=True)
            if kk == k:
                # the share of the profiler's device time, else of the
                # graph's, as compare_and_time takes it
                out["y_runs_fixpoint"] = {
                    "max_abs_err": 0, "ms": ms, "plain_ms": twin_ms,
                    "device_ms": dev_ms, **bound,
                    "bound_us": 1e3 * bound["bound_ms"],
                    "bound_share": bound["bound_ms"] / (dev_ms or g_ms),
                    "bound_share_of": "profiler" if dev_ms else "graph",
                    "library_ms": None, "graph_ms": g_ms, "k": kk}
        fastest = min(per_k, key=lambda kk: per_k[kk]["graph_ms"])
        print(f"kernel y_runs_fixpoint q20 chunk: the fastest k by graph "
              f"time is {fastest} ({per_k[fastest]['graph_ms']:.4f} ms); "
              f"the default is {k_def}", flush=True)
        out["y_runs_fixpoint"]["per_k"] = per_k
    e2_edge_phase(dev)
    return out


def e2_batches(what: str, xs, p1: int, k: int, b: int):
    """E2 on the first 1, 3 and ``b`` streams of (L, b k) tuples ``xs``
    against one twin call on all ``b``: the streams are independent, so
    the twin's first streams are its results on them.  Returns the twin's
    outputs."""
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    want = edd.runs_fixpoint_ref(*xs, p1, k)
    for bb in sorted({1, min(3, b), b}):
        sub = tuple(a[:, :bb * k].contiguous() for a in xs)
        got = edd.runs_fixpoint(*sub, p1, k)
        err = max_abs_err("y_runs_fixpoint", got,
                          (want[0][:, :bb * k], want[1][:, :bb * k],
                           want[2][:bb]))
        print(f"kernel y_runs_fixpoint {what}, batch {bb}: max_abs_err "
              f"{err} vs torch twin (e_in, flags, sweeps); sweeps "
              f"{got[2].tolist()}", flush=True)
        check(err == 0, f"y_runs_fixpoint disagrees with its twin: {what}, "
              f"batch {bb}")
    return want


def e2_edge_phase(dev) -> None:
    """E2 against its twin at batch 1, 3 and 16 on the edge tuples
    (``e2_edge_tuples``, 40 runs a chunk) at k = 1, 2 and E2_EDGE_KS (the
    "k + 1 sweeps" streams reach the cap), and on random streams longer
    than a cluster stages (E2_LONG: each CTA reads its last rows from
    global memory)."""
    import torch

    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    rng = np.random.default_rng(SEED + 60)
    p1 = edd.Y_P1
    cases = [(kind, k, 40) for kind in E2_EDGE_KINDS
             for k in (1, 2) + E2_EDGE_KS] + [("random", *E2_LONG)]
    for kind, k, length in cases:
        eb, f = e2_edge_tuples(rng, B, k, length, kind)
        xs = (torch.from_numpy(eb).to(dev), torch.from_numpy(f).to(dev))
        rows = edd.fixpoint_layout(length, k)[2]
        want = e2_batches(f"{kind} tuples, k={k}, L={length} ({rows} rows "
                          "staged)", xs, p1, k, B)
        if kind == "k + 1 sweeps":
            check(bool((want[2] == k + 1).all()),
                  f"{kind} at k={k}: sweeps {want[2].tolist()}")
    check(edd.fixpoint_layout(E2_LONG[1], E2_LONG[0])[2] < E2_LONG[1],
          "the long streams fit the staging")


def forced_fallback(edd):
    """A stand-in for ``edd.runs_fixpoint`` that runs the kernel and
    reports k + 1 sweeps for k > 1: the batch then takes the k = 1
    relaunch."""
    real = edd.runs_fixpoint

    def run(ebase, fields, p1, k):
        e_in, flags, sweeps = real(ebase, fields, p1, k)
        return e_in, flags, (sweeps * 0 + k + 1) if k > 1 else sweeps
    return real, run


def entropy_decode_phase(dev, chunks) -> dict:
    """The decode with entropy_on_device=True through the pipeline, each
    case in one chunk, byte-identical to decoder.decode, with E1 launched
    twice (Y, UV) and E2 at least once; with the option off neither.
    Then the q20 chunk with the option on and off in turns (on, off,
    off, on) with the host breakdown, and the device entropy decode's
    stages (entropy_stages)."""
    from nhwcodec_tpu_torch.host.models import decoder, encoder
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    gens = list(fixture_generators().values())
    cases = {f"q20 chunk of {B} (fixtures + random)": chunks[20][0],
             f"q23 chunk of {B}": chunks[23][0],
             "mixed q4/14/19/21": [encoder.encode(gens[i](), q) for i, q in
                                   enumerate((4, 14, 19, 21))],
             "mixed HQ q20/22/23/21": [encoder.encode(gens[i](), q)
                                       for i, q in
                                       enumerate((20, 22, 23, 21))],
             "identical rows [s, s, s]": [chunks[20][0][0]] * 3}
    t0 = time.perf_counter()
    want = {k: [decoder.decode(d) for d in v] for k, v in cases.items()}
    print(f"host: decoded the entropy cases in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)
    launches = {}
    for what, datas in cases.items():
        _, _, got = decode_checked(
            f"{what}, entropy on the device", datas, want[what],
            ENTROPY_KERNELS, chunk=len(datas), device=dev,
            entropy_on_device=True)
        check(got["chain_starts"] == 2 and got["y_runs_fixpoint"] == 1,
              f"{what}: E1 launched {got['chain_starts']} times, not 2, "
              f"or E2 {got['y_runs_fixpoint']}, not once")
        if not launches:
            launches = got
    q20 = cases[f"q20 chunk of {B} (fixtures + random)"]
    decode_checked(f"q20 chunk of {B}, entropy on the host", q20,
                   want[f"q20 chunk of {B} (fixtures + random)"],
                   DECODE_KERNELS, absent=ENTROPY_KERNELS, chunk=B,
                   device=dev)
    real, edd.runs_fixpoint = forced_fallback(edd)
    try:
        _, _, got = decode_checked(
            f"q20 chunk of {B}, entropy on the device, the fixpoint "
            "forced through the k = 1 fallback", q20,
            want[f"q20 chunk of {B} (fixtures + random)"], ENTROPY_KERNELS,
            chunk=B, device=dev, entropy_on_device=True)
    finally:
        edd.runs_fixpoint = real
    check(got["y_runs_fixpoint"] == 2,
          f"fallback: E2 launched {got['y_runs_fixpoint']} times, not 2")
    entropy_turns(dev, q20)
    entropy_stages(dev, chunks[20][1])
    return launches


def entropy_turns(dev, datas) -> None:
    """The q20 chunk through the pipeline in one chunk with the option on
    and off in turns (on, off, off, on), each turn's wall split over the
    host steps (the device entropy decode's two calls as their own
    groups)."""
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    targets = decode_targets() + [
        (edd, "decode_y_device_batch", "device Huffman Y (E1, prep, E2, "
         "emit, copy)"),
        (edd, "decode_uv_device_batch", "device Huffman UV (E1, scatter, "
         "copy)")]
    walls = {True: [], False: []}
    for on in (True, False, False, True):
        def one_chunk():
            tdp.decode_batch_device(datas, workers=1, chunk=B, device=dev,
                                    entropy_on_device=on)
        wall, spent = host_breakdown(one_chunk, targets, HUFFMAN_GROUPS)
        walls[on].append(wall)
        print_breakdown(f"decode breakdown, q20 chunk of {B}, entropy "
                        f"{'on the device' if on else 'on the host'}", wall,
                        spent)
    print(f"decode wall, q20 chunk of {B}, turns on/off/off/on: "
          f"on {walls[True]} ms, off {walls[False]} ms", flush=True)


def entropy_stages(dev, parsed, reps: int = 5) -> None:
    """The device entropy decode of one chunk split into its stages by
    CUDA events around each stage's function (median of ``reps`` calls):
    E1 (Y), the Y prep (book lookup, count sync, per-run tuples: E1's end
    to E2's start), E2, the Y emit, E1 (UV), the UV scatter; and the
    device-to-host copies of the two symbol planes."""
    import torch

    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    names = ("chain_starts_batch", "runs_fixpoint", "_runs_emit",
             "_uv_scatter_batch")
    saved = {n: getattr(edd, n) for n in names}
    spans = []

    def timed(name, f):
        def run(*a, **k):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            r = f(*a, **k)
            e.record()
            spans.append((name, s, e))
            return r
        return run

    rows = []
    try:
        for n in names:
            setattr(edd, n, timed(n, saved[n]))
        for _ in range(reps):
            spans.clear()
            y = edd.decode_y_planes(parsed, device=dev)
            uv = edd.decode_uv_planes(parsed, device=dev)
            torch.cuda.synchronize()
            (_, e1s, e1e), (_, e2s, e2e), (_, ems, eme), (_, u1s, u1e), \
                (_, uss, use) = spans
            rows.append([e1s.elapsed_time(e1e), e1e.elapsed_time(e2s),
                         e2s.elapsed_time(e2e), ems.elapsed_time(eme),
                         u1s.elapsed_time(u1e), uss.elapsed_time(use),
                         e1s.elapsed_time(eme), u1s.elapsed_time(use)])
    finally:
        for n, f in saved.items():
            setattr(edd, n, f)
    med = np.median(np.asarray(rows), axis=0)
    d2h_y = median_ms(lambda: y.cpu(), runs=10)
    d2h_uv = median_ms(lambda: uv.cpu(), runs=10)
    print(f"device entropy decode, q20 chunk of {len(parsed)}, stages (ms, "
          f"CUDA events, median of {reps}): E1 Y {med[0]:.4f}, Y prep "
          f"(book, count sync, per-run tuples) {med[1]:.4f}, E2 "
          f"(k={edd.K_CHUNKS}) "
          f"{med[2]:.4f}, Y emit {med[3]:.4f} (Y total {med[6]:.4f}); E1 UV "
          f"{med[4]:.4f}, UV scatter {med[5]:.4f} (UV total {med[7]:.4f}); "
          f"device-to-host copies {tuple(y.shape)} int16 {d2h_y:.4f}, "
          f"{tuple(uv.shape)} int16 {d2h_uv:.4f}", flush=True)


def encode_images(rng) -> np.ndarray:
    """The 11 fixture generators and 5 random images: (16, 512, 512, 3)."""
    gens = list(fixture_generators().values())
    rand = rng.integers(0, 256, (B - len(gens), 512, 512, 3), dtype=np.uint8)
    return np.concatenate([np.stack([g() for g in gens]), rand])


def requant_states(images: np.ndarray, q: int):
    """The host encoder's Y state at the requant tail (after mark +
    offset), as tests/test_device_requant.py builds it."""
    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.host.ops import (analysis, colorspace, prefilter,
                                             requant)

    out = []
    for img in images:
        y, _, _ = colorspace.downsample_yuv420(img, q)
        if q < T.HIGH2:
            y = prefilter.pre_process_y(y, q)
        jpeg = y.astype(np.int16).copy()
        process = np.zeros((512, 512), np.int16)
        analysis.wavelet_analysis(jpeg, process, 512, 0, 0)
        res256 = jpeg[:256, :256].copy()
        analysis.wavelet_analysis(jpeg, process, 256, 1, 0)
        requant.mark_res256(process, res256)
        requant.offset_y_recons256(jpeg, process, q, 8, part=1)
        out.append((jpeg, process, res256))
    return [np.stack([s[k] for s in out]) for k in range(3)]


def chain_planes(rng, b):
    """Dense small-delta planes with sentinels: long ladder chains
    (tests/test_device_requant.py)."""
    jpeg = rng.integers(-40, 40, (b, 512, 512)).astype(np.int16)
    process = rng.integers(-9, 9, (b, 512, 512)).astype(np.int16)
    res256 = rng.integers(-6, 6, (b, 256, 256)).astype(np.int16)
    mask = rng.random((b, 256, 256)) < 0.01
    res256 = np.where(mask, res256 + 16000, res256).astype(np.int16)
    mask2 = rng.random((b, 256, 256)) < 0.01
    return jpeg, process, np.where(~mask & mask2, res256 + 12000,
                                   res256).astype(np.int16)


def row_crossing_planes(rng, b):
    """Chain planes whose ladder reads cross rows: sentinels in columns 0
    and 255 of res256 on half the rows, and live band cells
    process[r, 511] (column 0's left term of row r + 1) and process[r, 256]
    (column 255's right term) (tests/test_torch_requant.py)."""
    jpeg, process, res256 = chain_planes(rng, b)
    for col in (0, 255):
        rows = rng.random((b, 256)) < 0.5
        res256[:, :, col] = np.where(
            rows, res256[:, :, col] + rng.choice([12000, 16000], (b, 256)),
            res256[:, :, col])
    process[:, :256, 511] = rng.integers(-12, 13, (b, 256))
    process[:, :256, 256] = rng.integers(-12, 13, (b, 256))
    return jpeg, process, res256


def encode_kernel_phase(dev, images: np.ndarray) -> dict:
    import torch

    from nhwcodec_tpu_torch.ops import colorspace, dwt

    rng = np.random.default_rng(SEED + 1)
    out = {}
    # K4 at the encode path's shapes: Y levels 1 and 2, U+V levels 1 and 2
    shapes = {}
    for b, n in ANALYSIS_PATH_SHAPES:
        for lo, hi in ((-32768, 32768), (-1800, 1800)):
            x = torch.from_numpy(rng.integers(lo, hi, (b, n, n)).astype(
                np.int16)).to(dev)
            res = compare_and_time(
                "analysis_level_jp", f"({b},{n},{n}) int16 in [{lo},{hi})",
                lambda: dwt.analysis_level_jp(x),
                lambda: dwt.analysis_level_jp_ref(x), timed=lo == -32768,
                bound=work(6 * b * n * n,
                           OPS["analysis_level_jp"] * b * n * n), graph=True)
            if res is not None:
                shapes[f"({b},{n},{n})"] = res
                check_one_launch("analysis_level_jp", f"({b},{n},{n})",
                                 lambda: dwt.analysis_level_jp(x))
    out["analysis_level_jp"] = shape_sums("analysis_level_jp", shapes,
                                          f"({B},512,512)")
    rgb = torch.from_numpy(images).to(dev)
    out["colorspace_down420"] = compare_and_time(
        "colorspace_down420", f"({B},512,512,3) uint8, q20",
        lambda: colorspace.rgb_to_yuv420(rgb, 20),
        lambda: colorspace.rgb_to_yuv420_ref(rgb, 20),
        bound=work(B * (512 * 512 * (3 + 2) + 2 * 256 * 256),
                   OPS["colorspace_down420"] * B * 512 * 512), graph=True)
    check_one_launch("colorspace_down420", f"({B},512,512,3)",
                     lambda: colorspace.rgb_to_yuv420(rgb, 20),
                     "colorspace_band")
    k6_rng = np.random.default_rng(SEED + 9)
    flat = np.stack([np.full((512, 512, 3), 255 * (i % 2), np.uint8)
                     for i in range(B)])
    for b in (1, 3, B):
        for what, imgs in (
                ("fixtures and random", images[:b]),
                ("random", k6_rng.integers(0, 256, (b, 512, 512, 3),
                                           dtype=np.uint8)),
                ("flat 0/255", flat[:b])):
            x = torch.from_numpy(np.ascontiguousarray(imgs)).to(dev)
            compare_and_time(
                "colorspace_down420", f"({b},512,512,3) {what}",
                lambda: colorspace.rgb_to_yuv420(x, 20),
                lambda: colorspace.rgb_to_yuv420_ref(x, 20), timed=False)
    # K5 on real q20 encode states, dense chain planes and row-crossing
    # reads.  K5 and its twin update jpeg and process in place, as the
    # encode path runs them, so each call takes its own clone of the
    # inputs, made before any timing: the times hold no copies
    for b in (1, 3):
        for what, arrays in (
                ("real q20 states", requant_states(images[:b], 20)),
                ("chain planes", chain_planes(rng, b)),
                ("row-crossing reads", row_crossing_planes(rng, b))):
            args = [torch.from_numpy(a).to(dev) for a in arrays]
            compare_and_time(
                "requant_tail", f"({b},512,512) x2 + ({b},256,256), {what}",
                lambda: dwt.requant_tail(*(a.clone() for a in args)),
                lambda: dwt.requant_tail_ref(*(a.clone() for a in args)),
                timed=False)
    for what, arrays in (("real q20 states", requant_states(images, 20)),
                         ("chain planes", chain_planes(rng, B)),
                         ("row-crossing reads", row_crossing_planes(rng, B))):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        timed = what == "real q20 states"
        k_in = fresh_inputs(args, 4 + RUNS + PROFILE_TRIES * 10 if timed
                            else 1)
        t_in = fresh_inputs(args, 4 + RUNS + PROFILE_TRIES if timed else 1)
        res = compare_and_time(
            "requant_tail", f"({B},512,512) x2 + ({B},256,256), {what}",
            lambda: dwt.requant_tail(*k_in()),
            lambda: dwt.requant_tail_ref(*t_in()), timed=timed,
            twin_calls=1,   # ~11,500 launches per twin call
            # reads the LL quadrants of jpeg and process and res256, writes
            # the two quadrants back and res_clean
            bound=work(12 * B * 256 * 256,
                       OPS["requant_tail"] * B * 256 * 256))
        out.setdefault("requant_tail", res)
    stages = requant_stages(dev, [torch.from_numpy(a).to(dev)
                                  for a in requant_states(images, 20)])
    out["requant_tail"]["stages"] = stages
    out["requant_tail"]["graph_ms"] = stages["graph_ms"]["all"]
    return out


def requant_stages(dev, args) -> dict:
    """K5's device time split into its three stages on the real q20
    states: the profiler's device entries of 10 calls grouped by kernel
    (K1's synth_cluster, requant_ladder, K4's analysis_cluster); and CUDA
    graphs of 20 calls: the whole tail on restored inputs (each call
    first copies the pristine LL quadrants of jpeg and process back, the
    only bytes the tail changes, and a graph of those copies alone is
    subtracted), K1 on the jpeg LL corner and K4 on a (B,256,256) plane,
    the ladder by difference."""
    import torch

    from nhwcodec_tpu_torch.ops import dwt

    k_in = fresh_inputs(args, 10 * PROFILE_TRIES)
    _, dev_ms, top = device_profile(lambda: dwt.requant_tail(*k_in()),
                                    calls=10)
    groups = {"synth (K1)": ("synth_cluster",),
              "requant_ladder": ("requant_ladder",),
              "re-analysis (K4)": ("analysis_cluster",)}
    prof = {g: sum(ms for key, ms in top if any(n in key for n in names))
            for g, names in groups.items()}
    held = [a.clone() for a in args]

    def restore():
        for h, a in zip(held[:2], args[:2]):
            h[:, :256, :256].copy_(a[:, :256, :256])

    def restored_tail():
        restore()
        dwt.requant_tail(*held)

    ll = torch.from_numpy(np.random.default_rng(SEED + 5).integers(
        -300, 300, (args[0].shape[0], 256, 256)).astype(np.int16)).to(dev)
    copies = graph_ms(restore)
    graph = {"all": graph_ms(restored_tail) - copies,
             "synth (K1)": graph_ms(
                 lambda: dwt.synth_level(args[0][:, :256, :256])),
             "re-analysis (K4)": graph_ms(lambda: dwt.analysis_level_jp(ll))}
    graph["requant_ladder"] = (graph["all"] - graph["synth (K1)"]
                               - graph["re-analysis (K4)"])
    print("kernel requant_tail by stage, q20 states: device ms per call "
          "(profiler, mean per record) "
          + "; ".join(f"{g} {v:.4f}" for g, v in prof.items())
          + (f" of {dev_ms:.4f}" if dev_ms else " (window incomplete)")
          + "; graphs of 20 calls (CUDA events): whole tail on restored "
          f"inputs {graph['all']:.4f} (its restoring copies {copies:.4f} "
          f"subtracted), K1 on the corner {graph['synth (K1)']:.4f}, "
          f"K4 on a (B,256,256) plane {graph['re-analysis (K4)']:.4f}, "
          f"requant_ladder by difference {graph['requant_ladder']:.4f}",
          flush=True)
    return {"profiler_ms": prof, "profiler_window_complete": bool(dev_ms),
            "graph_ms": graph}


def encode_colorspace_phase(dev, images: np.ndarray) -> None:
    import torch

    from nhwcodec_tpu_torch.host.ops import colorspace as hcs
    from nhwcodec_tpu_torch.ops import colorspace

    allv = torch.arange(1 << 24, dtype=torch.int64, device=dev)
    rgb = torch.stack([allv >> 16, (allv >> 8) & 255, allv & 255],
                      -1).to(torch.uint8).reshape(64, 512, 512, 3)
    rgb_h = rgb.cpu().numpy()
    for q in (20, 19, 18, 17, 16):
        t0 = time.perf_counter()
        if q >= 20:
            got = colorspace.rgb_to_yuv_full(rgb)
            how = "K6 per-pixel entry nhw_rgb_to_yuv_full"
        else:
            got = colorspace.rgb_to_yuv(rgb, q)
            how = "on-card torch path"
        got = [g.cpu().numpy() for g in got]
        bad = 0
        for c in range(0, 64, 8):
            want = hcs.rgb_to_yuv(rgb_h[c:c + 8], q)
            bad += int(sum((g[c:c + 8] != w) for g, w in zip(got, want))
                       .astype(bool).sum())
        print(f"encode colorspace q{q}: all 2^24 RGB through the {how} vs "
              f"colorspace.rgb_to_yuv: {bad} mismatching pixels "
              f"({time.perf_counter() - t0:.1f} s)", flush=True)
        check(bad == 0, f"encode colorspace q{q} differs from the host")
    y, u, v = (a.cpu().numpy() for a in colorspace.rgb_to_yuv420(
        torch.from_numpy(images).to(dev), 20))
    for i, img in enumerate(images):
        for g, w in zip((y[i], u[i], v[i]), hcs.downsample_yuv420(img, 20)):
            check(np.array_equal(g, w),
                  f"K6 4:2:0 output of image {i} differs from the host")
    print(f"encode colorspace: K6 Y/U/V of {len(images)} images equal "
          "colorspace.downsample_yuv420", flush=True)


def encode_phase(dev, images: np.ndarray, captured: dict) -> dict:
    """The encode service at q20 and OTHER_QS against the host copy; the
    host copy's encodes at the STREAM_QS qualities run under a
    StreamCapture, whose records go into ``captured`` (q -> records) for
    encode_scans_phase."""
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.host.ops import (entropy_enc, ll2, prefilter,
                                             quantize, requant, residue)
    from nhwcodec_tpu_torch.models import device_stages as tds
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import encoder as tenc
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    t0 = time.perf_counter()
    with StreamCapture() as cap:
        want = [host_encoder.encode(img, 20) for img in images]
    captured[20] = cap.records
    print(f"host encoder: {1e3 * (time.perf_counter() - t0) / B:.1f} ms/img "
          f"at q20", flush=True)
    names = list(fixture_generators())
    for name, w in zip(names, want):
        check(sha256(w) == STREAM_SHA256[(name, 20)],
              f"host encoder's q20 {name} stream differs from the pinned "
              "digest")

    build.reset_launches()
    t0 = time.perf_counter()
    got, m = tdp.encode_batch_device(images, 20, workers=1, chunk=B,
                                     device=dev)
    t_first = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in ENCODE_KERNELS}
    check(m.failures == 0, f"encode failures: {m.failures}")
    for i, (w, g) in enumerate(zip(want, got)):
        check(g == w, f"q20 stream {i} differs from the host encoder")
    print(f"encode: {B} q20 images byte-identical to the host encoder, the "
          f"{len(names)} fixtures' streams to the pinned digests of "
          f"nhwcodec_tpu.encode; launches {launches}", flush=True)
    check(all(v > 0 for v in launches.values()),
          f"a kernel of the encode path was not launched: {launches}")

    t0 = time.perf_counter()
    again, _ = tdp.encode_batch_device(images, 20, workers=1, chunk=B,
                                       device=dev)
    t_again = time.perf_counter() - t0
    check(again == got, "second encode run differs")
    print(f"encode end to end, batch {B} q20 in one chunk: first run "
          f"{1e3 * t_first / B:.2f} ms/img, second run "
          f"{1e3 * t_again / B:.2f} ms/img", flush=True)
    t0 = time.perf_counter()
    pooled, mp = tdp.encode_batch_device(images, 20, device=dev)
    t_pool = time.perf_counter() - t0
    check(mp.failures == 0 and pooled == got, "default-pool encode differs")
    print(f"encode end to end, batch {B} q20, default pool "
          f"({os.cpu_count()} workers): {1e3 * t_pool / B:.2f} ms/img",
          flush=True)

    for q in OTHER_QS:
        sel = quality_batch(images, q)
        out, mq = tdp.encode_batch_device(sel, q, device=dev)
        check(mq.failures == 0, f"q{q}: {mq.failures} failures")
        with StreamCapture() as cap:
            for i, (img, g) in enumerate(zip(sel, out)):
                check(g == host_encoder.encode(img, q),
                      f"q{q} stream {i} differs from the host encoder")
        if q in STREAM_QS or q in LL2_QS:
            captured[q] = cap.records
        check(sha256(out[0]) == STREAM_SHA256[(fixture_for(q), q)],
              f"q{q} {fixture_for(q)} stream differs from the pinned digest")
    print(f"encode: batches of 4 at q{'/'.join(map(str, OTHER_QS))} through "
          "the default pool byte-identical to the host encoder, one fixture "
          "each to the pinned digest of nhwcodec_tpu.encode", flush=True)

    def one_chunk():
        tdp.encode_batch_device(images, 20, workers=1, chunk=B, device=dev)

    print_profile(f"encode, batch {B} q20 in one chunk", one_chunk)
    targets = [(prefilter, "pre_process_y", "host pre-filter"),
               (requant, "mark_res256", "host mark + offset"),
               (requant, "offset_y_recons256", "host mark + offset"),
               (host_encoder, "encode_from_planes",
                "host encode_from_planes, other scans"),
               (entropy_enc, "wavlts2packet_tokenize", "host tokenizer"),
               *((m, f, "host stream stage") for m, f in (
                   (host_encoder, "_band_snap_pass"), (quantize, "offset_y"),
                   (quantize, "serpentine_y"),
                   (quantize, "merge_crossing_codes"),
                   (quantize, "select_codes"), (quantize, "cap_long_runs"),
                   (quantize, "offset_uv"), (quantize, "serpentine_uv"))),
               (ll2, "ll2_code_y", "host E16 LL2 coders"),
               (ll2, "y_highres_compression", "host E16 LL2 coders"),
               (ll2, "uv_highres_compression", "host E17"),
               *((m, f, "host E11 tail + E12") for m, f in (
                   (host_encoder, "_mid_q_band_cleanup"),
                   (host_encoder, "_pair_promotion"),
                   (residue, "res256_column_ladder"),
                   (residue, "res256_classify"),
                   (residue, "build_positional_stream"),
                   (residue, "finish_stream"))),
               (host_encoder, "encode_uv", "host encode_uv, the rest"),
               (tenc, "finish_deferred", "pack (device packer + container)"),
               (tds, "to_device", "host->device copies"),
               (tds, "to_host", "device->host copies (incl. device waits)")]
    print_breakdown(f"encode breakdown, batch {B} q20 in one chunk",
                    *host_breakdown(one_chunk, targets, ENCODE_SCAN_GROUPS))
    return launches


# ---------------------------------------------------------------------------
# the device encode scans' stream stage: the E11 snap passes, the E14
# quantizers and the E15 stream fixups (models/device_encode_scans.py)

SCAN_KERNELS = ("snap_pass", "offset_y", "merge_crossing")
# wrapper calls of a stream stage (q > LOW4): one snap_passes launch, one
# offset_y (three launches: offset_y_rows, offset_y_bands, offset_y_codes),
# one merge_crossing (one cluster launch)
SCAN_LAUNCHES = {"snap_pass": 1, "offset_y": 1, "merge_crossing": 1}
# q -> images of the encode batch whose host encodes are captured (the q20
# batch of 16, and the batches of 4 of OTHER_QS at q21, q19 and q17)
STREAM_QS = {20: B, 21: 4, 19: 4, 17: 4}
SZ = 65536
# the functions' own operations, counted from the sources: a snap-pass
# region position (the static count, the fixup, the decision); a plane
# position of offset_y's pass 1 (scans.cu offset_y_rows: the compares,
# arithmetic and selects of a step, 21) and of its pass 4 (offset_y_codes:
# the code map of a value, 24; the left-neighbour fixups' tests are not
# counted), and an LL position (passes 2-3); a stream position of the
# merge (its skip and fire test, a step of the walk)
SNAP_OPS = 30
OFFSET_Y_PASS1_OPS = 21
OFFSET_Y_PASS4_OPS = 24
OFFSET_Y_LL_OPS = 60
MERGE_OPS = 25


class StreamCapture:
    """A context that records, for each host encode run inside it, what
    goes into and comes out of the LL2 stage, the residue stage and the
    stream stage: ``records`` gains one dict per encode, opened when
    ``encode_y`` is called (before the E11 tail, and also at q <= LOW4,
    which has no E11 tail call), with "e11" (the (512, 512) Y plane at the
    first E11 call, ``_mid_q_band_cleanup`` at q17..q19, else
    ``_pair_promotion``), "pp", "res256", "resIII", "khead" (the plane,
    res256, resIII and kernel head that ``residue.res256_column_ladder``
    gets: the plane is pair promotion's output), "res" (the res1*, res3*
    and res5* sections of ``encode_y``'s result), "y" (the plane at the
    first snap pass), "uv" ([U, V] (256, 256) planes just before
    ``offset_uv``), "sel" ((sel1, sel2) of ``select_codes``), "im_nhw"
    (the 6 SZ stream the tokenizer or the packet builder got), and the LL2
    stage's: "ll2y" (the plane ``ll2.ll2_code_y`` got, "in", and left,
    "out", and its tree1, ch_res, exw and res4), "yhr"
    (``ll2.y_highres_compression``'s ch, res_low, highres_word and
    highres_mem), "ll2uv" (for U and V: the plane the host copy's C
    ``nhw_ll2_code_uv`` got and left, its tree1_uv and exw) and "uvhr"
    (``ll2.uv_highres_compression``'s input and bytes), and the chroma
    ladders': "uvcl" (for U and V: the jpeg, process, res256, strict and
    oob0 ``_uv_compare_ladder`` got, and the jpeg it left) and, at q >=
    LOW2, "uvsm" (for U and V: the process and res_uv
    ``_uv_sentinel_marking`` got, res256 and its oob tail as the (16896,)
    rf_ext, and the process it left), and the quantizer's and the low-q
    cleanups': "oy" (the plane ``quantize.offset_y`` got, "in", its
    quality "q" and the codes it left, "out"), at LOW6..LOW5 "low56" (q
    and the plane ``_low56_band_cleanup`` left; its input is "e11") and
    below LOW6 "lq" (q, xs, the (65792,) r3_ext as ``lowq_r3_ext`` builds
    it from the free-time kernel and tree1, and the plane
    ``_lowest_q_band_cleanup`` left; its input is "e11"), and the cleanups
    below LOW7: at q <= LOW9 "ll1" (q, the plane ``_low_q_ll1_cleanup``
    got, "in", and left, "out") and "uvs" (for U and V: the plane
    ``_uv_ll_smooth`` got and left), below LOW7 "vlq" (q, the plane
    ``_very_low_q_cleanup`` got and left).  It wraps the
    host copy's ``encoder.encode_y``, ``_mid_q_band_cleanup``,
    ``_pair_promotion``, ``_band_snap_pass``, ``_uv_compare_ladder``,
    ``_uv_sentinel_marking``, ``_low56_band_cleanup``,
    ``_lowest_q_band_cleanup``, ``_low_q_ll1_cleanup``,
    ``_very_low_q_cleanup`` and ``_uv_ll_smooth``, ``quantize.offset_y``,
    ``residue.res256_column_ladder``, ``quantize.offset_uv``,
    ``quantize.select_codes``, ``entropy_enc.wavlts2packet_tokenize`` /
    ``wavlts2packet``, ``ll2.ll2_code_y``, ``ll2.y_highres_compression``
    and ``ll2.uv_highres_compression`` for its duration, and
    ``native._load``, whose library it hands out behind a proxy that
    records ``nhw_ll2_code_uv`` (a cffi library's attributes cannot be
    replaced)."""

    def __init__(self):
        self.records: list[dict] = []

    def __enter__(self):
        from nhwcodec_tpu_torch.host import native
        from nhwcodec_tpu_torch.host.models import encoder
        from nhwcodec_tpu_torch.host.ops import (entropy_enc, ll2, quantize,
                                                 residue)

        rec = self.records
        self._saved = saved = [
            (encoder, "encode_y", encoder.encode_y),
            (encoder, "_mid_q_band_cleanup", encoder._mid_q_band_cleanup),
            (encoder, "_pair_promotion", encoder._pair_promotion),
            (residue, "res256_column_ladder", residue.res256_column_ladder),
            (encoder, "_band_snap_pass", encoder._band_snap_pass),
            (quantize, "offset_uv", quantize.offset_uv),
            (quantize, "select_codes", quantize.select_codes),
            (entropy_enc, "wavlts2packet_tokenize",
             entropy_enc.wavlts2packet_tokenize),
            (entropy_enc, "wavlts2packet", entropy_enc.wavlts2packet),
            (ll2, "ll2_code_y", ll2.ll2_code_y),
            (ll2, "y_highres_compression", ll2.y_highres_compression),
            (ll2, "uv_highres_compression", ll2.uv_highres_compression),
            (native, "_load", native._load),
            (encoder, "_uv_compare_ladder", encoder._uv_compare_ladder),
            (encoder, "_uv_sentinel_marking", encoder._uv_sentinel_marking),
            (quantize, "offset_y", quantize.offset_y),
            (encoder, "_low56_band_cleanup", encoder._low56_band_cleanup),
            (encoder, "_lowest_q_band_cleanup",
             encoder._lowest_q_band_cleanup),
            (encoder, "_low_q_ll1_cleanup", encoder._low_q_ll1_cleanup),
            (encoder, "_very_low_q_cleanup", encoder._very_low_q_cleanup),
            (encoder, "_uv_ll_smooth", encoder._uv_ll_smooth)]
        (encode_y, midq, pair, ladder, snap, offset_uv, select, tokenize,
         packet, ll2y, yhr, uvhr, load, uvcl, uvsm, offset_y, low56,
         lowest, ll1, vlq, uvs) = (f for *_, f in saved)

        def plane(pf):
            return np.array(pf[: 4 * SZ]).reshape(512, 512)

        def encode_y_w(*a, **k):
            rec.append({"uv": []})
            im_nhw, sec = encode_y(*a, **k)
            rec[-1]["res"] = {key: np.array(v) for key, v in sec.items()
                              if key[:4] in ("res1", "res3", "res5")}
            return im_nhw, sec

        def midq_w(pf, *a, **k):
            rec[-1].setdefault("e11", plane(pf))
            return midq(pf, *a, **k)

        def pair_w(pf, *a, **k):
            rec[-1].setdefault("e11", plane(pf))
            return pair(pf, *a, **k)

        def ladder_w(process, res256, q, res_setting, resIII=None,
                     kernel_head=None):
            rec[-1].update(pp=np.array(process), res256=np.array(res256),
                           resIII=np.array(resIII))
            if kernel_head is not None:     # q <= HIGH1
                rec[-1]["khead"] = np.array(kernel_head, np.int16)
            return ladder(process, res256, q, res_setting, resIII,
                          kernel_head=kernel_head)

        def snap_w(pf, rows, *a, **k):
            if rows.start == 1:     # the first of the three passes
                rec[-1]["y"] = plane(pf)
            return snap(pf, rows, *a, **k)

        def offset_uv_w(process, *a, **k):
            rec[-1]["uv"].append(np.array(process, np.int16))
            return offset_uv(process, *a, **k)

        def select_w(s):
            rec[-1]["sel"] = select(s)
            return rec[-1]["sel"]

        def tokenize_w(im_nhw, *a, **k):
            rec[-1]["im_nhw"] = np.array(im_nhw[: 6 * SZ], np.uint8)
            return tokenize(im_nhw, *a, **k)

        def packet_w(im_nhw, *a, **k):
            rec[-1]["im_nhw"] = np.array(im_nhw[: 6 * SZ], np.uint8)
            return packet(im_nhw, *a, **k)

        def ll2y_w(process, *a, **k):
            before = np.array(process, np.int16)
            tree1, ch_res, exw, res4 = ll2y(process, *a, **k)
            rec[-1]["ll2y"] = {"in": before, "out": np.array(process),
                               "tree1": np.array(tree1),
                               "ch_res": np.array(ch_res), "exw": list(exw),
                               "res4": list(res4)}
            return tree1, ch_res, exw, res4

        def yhr_w(*a, **k):
            out = yhr(*a, **k)
            rec[-1]["yhr"] = dict(zip(("ch", "res_low", "hr_word", "hr_mem"),
                                      (list(out[0]), int(out[1]),
                                       list(out[2]), list(out[3]))))
            return out

        def uvhr_w(tree_uv, *a, **k):
            out = uvhr(tree_uv, *a, **k)
            rec[-1]["uvhr"] = {"in": np.array(tree_uv), "out": list(out)}
            return out

        class Lib:
            """The host copy's C library, its LL2 UV coder recorded."""

            def __init__(self, lib):
                self._lib = lib

            def __getattr__(self, name):
                return getattr(self._lib, name)

            def nhw_ll2_code_uv(self, pf, tree1, exw, n_exw):
                ffi = native.ffi()

                def plane():
                    return np.frombuffer(ffi.buffer(pf, 2 * SZ), np.int16
                                         ).reshape(256, 256).copy()

                before = plane()
                self._lib.nhw_ll2_code_uv(pf, tree1, exw, n_exw)
                rec[-1].setdefault("ll2uv", []).append({
                    "in": before, "out": plane(),
                    "tree1": np.frombuffer(ffi.buffer(tree1, 4096),
                                           np.uint8).copy(),
                    "exw": np.frombuffer(ffi.buffer(exw, 4 * n_exw[0]),
                                         np.int32).tolist()})

        def load_w():
            lib = load()
            return None if lib is None else Lib(lib)

        def uvcl_w(jpeg, process, res256, strict, oob0=0):
            r = {"jpeg": np.array(jpeg, np.int16),
                 "process": np.array(process, np.int16),
                 "res256": np.array(res256, np.int16), "strict": strict,
                 "oob0": int(oob0)}
            uvcl(jpeg, process, res256, strict, oob0)
            r["out"] = np.array(jpeg, np.int16)
            rec[-1].setdefault("uvcl", []).append(r)

        def uvsm_w(process, res256, quality, res_uv, oob_tail=None):
            rf_ext = np.zeros(UV_RF_EXT, np.int16)
            rf_ext[:16384] = np.asarray(res256).reshape(-1)
            if oob_tail is not None:
                t = np.asarray(oob_tail, np.int16)
                rf_ext[16384: 16384 + t.size] = t
            r = {"process": np.array(process, np.int16), "rf_ext": rf_ext,
                 "res_uv": res_uv}
            uvsm(process, res256, quality, res_uv, oob_tail)
            r["out"] = np.array(process, np.int16)
            rec[-1].setdefault("uvsm", []).append(r)

        def offset_y_w(process, quality, m1):
            r = {"in": np.array(process, np.int16), "q": quality}
            offset_y(process, quality, m1)
            r["out"] = np.array(process, np.int16)
            rec[-1]["oy"] = r

        def low56_w(pf, q, ratio):
            rec[-1].setdefault("e11", plane(pf))
            low56(pf, q, ratio)
            rec[-1]["low56"] = {"q": q, "out": plane(pf)}

        def lowest_w(pf, resIII, q, ratio, tree1_y=None, y_original=None):
            from nhwcodec_tpu_torch.host.ops import prefilter

            rec[-1].setdefault("e11", plane(pf))
            kern = np.asarray(prefilter.final_low_kernel(y_original, q))
            r = {"q": q, "xs": encoder._lowest_q_xs(pf, q),
                 "r3": lowq_r3_ext(resIII, kern.reshape(-1)[
                     2 * SZ + 8: 2 * SZ + 12], tree1_y)}
            lowest(pf, resIII, q, ratio, tree1_y, y_original)
            r["out"] = plane(pf)
            rec[-1]["lq"] = r

        def cleanup_w(key, f):
            def run(pf, q, ratio):
                r = {"q": q, "in": plane(pf)}
                f(pf, q, ratio)
                r["out"] = plane(pf)
                rec[-1][key] = r
            return run

        def uvs_w(process):
            r = {"in": np.array(process, np.int16)}
            uvs(process)
            r["out"] = np.array(process, np.int16)
            rec[-1].setdefault("uvs", []).append(r)

        for (mod, name, _), f in zip(saved, (
                encode_y_w, midq_w, pair_w, ladder_w, snap_w, offset_uv_w,
                select_w, tokenize_w, packet_w, ll2y_w, yhr_w, uvhr_w,
                load_w, uvcl_w, uvsm_w, offset_y_w, low56_w, lowest_w,
                cleanup_w("ll1", ll1), cleanup_w("vlq", vlq), uvs_w)):
            setattr(mod, name, f)
        return self

    def __exit__(self, *exc):
        for mod, name, f in self._saved:
            setattr(mod, name, f)
        return False


def stack_records(records: list) -> dict:
    """The captured encodes as batches: "y" (B, 512, 512), "u", "v" (B,
    256, 256) int16, "im_nhw" (B, 6 SZ) uint8, "sel1", "sel2" (B,); and,
    where every record has them (q > LOW8), the residue stage's "e11"
    (but at LOW4, which has no E11 call), "pp" (B, 512, 512), "res256",
    "resIII" (B, 256, 256), "khead" (B, 4) int16 and "res" (a list of each
    image's res sections)."""
    for r in records:
        check("y" in r and len(r["uv"]) == 2 and "sel" in r
              and "im_nhw" in r,
              "a captured host encode lacks part of its stream stage")
    st = {"y": np.stack([r["y"] for r in records]),
          "u": np.stack([r["uv"][0] for r in records]),
          "v": np.stack([r["uv"][1] for r in records]),
          "im_nhw": np.stack([r["im_nhw"] for r in records]),
          "sel1": np.array([r["sel"][0] for r in records]),
          "sel2": np.array([r["sel"][1] for r in records])}
    if all("khead" in r for r in records):
        for key in ("e11", "pp", "res256", "resIII", "khead"):
            if all(key in r for r in records):   # no E11 call at LOW4
                st[key] = np.stack([r[key] for r in records])
        st["res"] = [r["res"] for r in records]
    return st


def device_stream_stage(y, u, v, q: int):
    """The port's stream stage on (B, 512, 512) Y and (B, 256, 256) U and
    V planes: Y's stage, then U's and V's, stage-major as the JAX
    composition runs them.  Returns (stream (B, 6 SZ + 16), sel1,
    sel2)."""
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    stream, sel1, sel2 = des._y_stream_stage(y, q)
    des._uv_stream_stage(stream, u, 0)
    des._uv_stream_stage(stream, v, 1)
    return stream, sel1, sel2


def host_stream_stage(st: dict, q: int) -> np.ndarray:
    """The host copy's stream stage (its C scans) on the captured planes,
    image by image as ``encoder.encode_y`` and ``encode_uv`` run it:
    returns the (B, 6 SZ) streams."""
    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.host.ops import quantize
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    out = []
    for k in range(len(st["y"])):
        process = st["y"][k].copy()
        pf = process.reshape(-1)
        for r0, r1, c0, c1, thr, yw, yw2, sec, g6, gc in des.snap_args(q):
            encoder._band_snap_pass(pf, range(r0, r1), c0, c1, thr, yw, yw2,
                                    sec, g6, gc)
        quantize.offset_y(process, q, 8)
        im = quantize.serpentine_y(process)
        quantize.merge_crossing_codes(im)
        quantize.select_codes(im)
        quantize.cap_long_runs(im)
        for comp, key in ((0, "u"), (1, "v")):
            p = st[key][k].copy()
            quantize.offset_uv(p, 8)
            quantize.serpentine_uv(im, p, comp)
        out.append(im[: 6 * SZ])
    return np.stack(out)


def stream_check(what: str, got, sel1, sel2, st: dict) -> None:
    """Each image's 6 SZ stream and sel1/sel2 byte for byte against the
    host copy's."""
    got = got[:, : 6 * SZ].cpu().numpy()
    for i in range(len(got)):
        diff = np.nonzero(got[i] != st["im_nhw"][i])[0]
        check(diff.size == 0, f"{what}: image {i}'s stream differs from the "
              f"host copy's at {diff[:8].tolist()}")
    check(np.array_equal(sel1.cpu().numpy(), st["sel1"])
          and np.array_equal(sel2.cpu().numpy(), st["sel2"]),
          f"{what}: sel1/sel2 {sel1.tolist()}/{sel2.tolist()} differ from "
          f"the host copy's {st['sel1'].tolist()}/{st['sel2'].tolist()}")


def encode_scans_phase(dev, captured: dict) -> dict:
    """The stream stage on the card (``_y_stream_stage`` +
    ``_uv_stream_stage``) once a batch on the planes captured from the
    host copy's own encodes: the encode batch's 16 images at q20 and 4
    images each at q21, q19 and q17 (q17 takes the second snap pass's
    other yw/yw2), each image's 6 SZ stream and sel1/sel2 byte for byte
    against the host's, with snap_pass (its three variants), offset_y and
    merge_crossing launched once a batch.  Times the q20 batch's stage (CUDA
    events, median of RUNS; a profile) beside the host copy's C scans on
    the same images (host timer, median of 5).  Returns the q20 batch's
    launches."""
    import torch

    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import device_scans as ds

    out = None
    for q, want_b in STREAM_QS.items():
        st = stack_records(captured[q])
        check(len(st["y"]) == want_b,
              f"q{q}: captured {len(st['y'])} host encodes, not {want_b}")
        y, u, v = (torch.from_numpy(st[k]).to(dev) for k in "yuv")
        build.reset_launches()
        stream, sel1, sel2 = device_stream_stage(y, u, v, q)
        torch.cuda.synchronize()
        launches = {k: build.LAUNCHES[k] for k in SCAN_KERNELS}
        check(launches == SCAN_LAUNCHES,
              f"q{q}: stream stage launches {launches}, not {SCAN_LAUNCHES}")
        stream_check(f"q{q} stream stage", stream, sel1, sel2, st)
        print(f"encode scans: stream stage at q{q}, batch {want_b}, "
              "byte-identical to the host copy's im_nhw and sel1/sel2 "
              f"(sel1 {st['sel1'].tolist()}, sel2 {st['sel2'].tolist()}); "
              f"launches {launches}", flush=True)
        if q != 20:
            continue
        out = launches
        dev_ms = median_ms(lambda: device_stream_stage(y, u, v, q))
        check(np.array_equal(host_stream_stage(st, q), st["im_nhw"]),
              "the host copy's stream stage on the captured planes differs "
              "from its own encode")
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            host_stream_stage(st, q)
            host.append((time.perf_counter() - t0) * 1e3)
        serp_ms = median_ms(lambda: ds.serpentine_y_device(y))
        print(f"encode scans: stream stage, batch {want_b} q20: device "
              f"{dev_ms:.4f} ms (CUDA events, median of {RUNS}), host copy's "
              f"C scans {float(np.median(host)):.2f} ms (host timer, median "
              f"of 5); the Y serpentine alone (one gather, a torch call) "
              f"{serp_ms:.4f} ms", flush=True)
        print_profile(f"encode scans stream stage, batch {want_b} q20",
                      lambda: device_stream_stage(y, u, v, q))
    return out


def snap_chain_planes(rng, b):
    """The adversarial chain plane of the JAX package's snap test: fixup
    chains through every variant's region, sentinels among them."""
    vals = np.array([7, 8, 9, -7, -8, -15, -16, 6, -6, 0, 12900, 10100],
                    np.int16)
    return rng.choice(vals, size=(b, 512, 512),
                      p=[.1, .1, .1, .1, .1, .15, .15, .05, .05, .05, .025,
                         .025])


def snap_spill_planes(rng, b):
    """Chain planes whose last region columns (255 and 510) hold alive
    values that fix up their right neighbour (16, -16, 24, -24) or snap
    (8, -8) in every row, and values the fixup moves (9, 20, -15, -23) in
    the spill columns 256 and 511."""
    x = snap_chain_planes(rng, b)
    for last in (255, 510):
        x[:, :, last] = rng.choice(np.array([16, -16, 24, -24, 8, -8],
                                            np.int16), (b, 512))
        x[:, :, last + 1] = rng.choice(np.array([9, 20, -15, -23, -17, 12],
                                                np.int16), (b, 512))
    return x


# runs of the fixup chain's two classes across S1's 16-column lane tiles:
# (first column, values): 17 then 18s (class 1: a 17 turns every 18 after
# it into 17), -16s (class 2 alternates -15 / -16 from its entry class),
# -17s (class 2 throughout); each crosses tile edges at 16 t
SNAP_TILE_RUNS = ((13, [17] + [18] * 40), (60, [-16] * 37),
                  (270, [17] + [18] * 60), (333, [-16] * 50),
                  (400, [-17] * 30), (150, [-17] * 20))


def snap_tile_edge_planes(rng, b):
    """Chain planes with, in every other row, the runs of SNAP_TILE_RUNS
    (fixup chains through S1's lane tiles, both classes, in both halves
    of the row), and two fully alive rows (301, 303: values of 7..25 and
    -7..-25 of both classes) in each image."""
    x = snap_chain_planes(rng, b)
    for r in range(2, 510, 2):
        for c0, vals in SNAP_TILE_RUNS:
            x[:, r, c0: c0 + len(vals)] = vals
    alive = np.array([7, 8, 9, 16, 17, 18, 24, 25, -7, -8, -9, -16, -17, -23,
                      -24, -25], np.int16)
    x[:, 301] = rng.choice(alive, (b, 512))
    x[:, 303] = rng.choice(alive, (b, 512))
    return x


def snap_spill_left_planes(rng, b):
    """Planes on which variant 3 (rows 256..510, columns 257..510) counts
    its left neighbour in variant 2's spill column 256: column 255 holds
    values that fix up column 256 (16, 24 over 9 and 20; -16, -24 over
    -15 and -23), column 257 +-9 with +-9 above and below and 0 on its
    right, so that below HIGH2 (yw 11) it snaps to +-7 unless column 256
    counts; column 256 small (0, 3, -5) in every fourth row."""
    x = snap_chain_planes(rng, b)
    x[:, 256:511, 255] = rng.choice(np.array([16, -16, 24, -24], np.int16),
                                    (b, 255))
    x[:, 256:511, 256] = rng.choice(np.array([9, 20, -15, -23], np.int16),
                                    (b, 255))
    x[:, 256:511:4, 256] = rng.choice(np.array([0, 3, -5], np.int16), (b, 64))
    x[:, 255:512, 257] = rng.choice(np.array([9, -9], np.int16), (b, 257))
    x[:, 255:512, 258] = 0
    return x


def offset_y_edge_planes(rng, b):
    """Planes in [-400, 400] with: row 255 in quads [0, -5, -5, 0] over a
    plane row 256 of [8, -7, -7, 0] (row 254 zero), so row 255's vertical
    fires write 10100 into row 256's columns 4k + 1 and 4k + 2, where
    without them pass 4 would write -8 (code 120) onto 4k + 1; rows 10 and
    11 all 5 and all -5 (the first promotion's parity chain across a whole
    row); rows 20 (band half) and 300 of multiples of 8 (pass 1's
    decrement chains)."""
    x = rng.integers(-400, 401, (b, 512, 512)).astype(np.int16)
    x[:, 254, :256] = 0
    x[:, 255, :256] = np.tile(np.array([0, -5, -5, 0], np.int16), 64)
    x[:, 256, :256] = np.tile(np.array([8, -7, -7, 0], np.int16), 64)
    x[:, 10, :256], x[:, 11, :256] = 5, -5
    eights = np.array([8, 16, 24, 32, 0, -8], np.int16)
    x[:, 20, 256:] = rng.choice(eights, (b, 256))
    x[:, 300, :] = rng.choice(eights, (b, 512))
    return x



# S2's relay edges: the columns of a pair of 5s and of a pair of -5s down
# the LL quadrant from row 1 (odd) into plane row 256, and, at each band
# edge b (rows 16 b + 15 -> 16 b + 16, b = 0..14), the columns of a pair of
# 5s on those two rows only
RELAY_PAIRS = ((100, 5), (200, -5))
RELAY_EDGE_COLS = tuple(8 + 6 * b for b in range(15))


def offset_y_relay_edge_planes(rng, b):
    """Planes in [-400, 400] on which passes 2-3's relay of ``pend``
    (S2's bands of 16 rows) needs every sweep and every band edge: down
    each pair of RELAY_PAIRS (columns c - 1, c) the rows fire vertically
    and are pended in turn, the first fire at row 1, so the band of rows
    16 k.. takes a pend from the band above and its exit flips with its
    entry (the twin takes 16 sweeps), and row 255's fire writes 10100
    into plane row 256; at the columns c - 1, c of RELAY_EDGE_COLS a band's
    last row fires vertically into the next band's first row, which
    without that pend would be a pass-3 pair (10300).  The columns c - 3..
    c + 1 around each are 0 elsewhere."""
    x = rng.integers(-400, 401, (b, 512, 512)).astype(np.int16)
    for c, val in RELAY_PAIRS:
        x[:, :257, c - 3: c + 2] = 0
        x[:, 1:257, c - 1: c + 1] = val
    for k, c in enumerate(RELAY_EDGE_COLS):
        r = 16 * k + 15
        x[:, :257, c - 3: c + 2] = 0
        x[:, r: r + 2, c - 1: c + 1] = 5
    return x


# the cap's classes: a run of L 128s crosses its count at in-run offsets
# 255 + 254 m; L = 257 + 254 m ends on a crossing's i + 2 (two demotes),
# L = 258 + 254 m on its i + 3 (one), other lengths leave a residual
RUN_LENGTHS = tuple(255 + 254 * m + d for m in range(4)
                    for d in range(-1, 4))


def stream_edge_streams(rng, b):
    """(B, 6 SZ + 16) uint8 Y streams, the UV half zero: 128-heavy codes
    with 136/120/153/155 among them; 128-runs of 255 + 254 m + d (m 0..3,
    d -1..3: RUN_LENGTHS) between 136/120/153/155 bytes; in image i, a
    crossing pattern (136/120, three 128s, 136/120) at 4 SZ - 12 + i % 12,
    within 8 bytes of the walk's end 4 SZ - 4 (both sides), and in odd
    images also a 128-run to the end of the Y part."""
    s = np.zeros((b, 6 * SZ + 16), np.uint8)
    codes = np.array([128, 128, 128, 128, 136, 120, 153, 155, 5], np.uint8)
    s[:, : 4 * SZ] = rng.choice(codes, (b, 4 * SZ))
    ends = np.array([136, 120, 153, 155], np.uint8)
    pos = 1000
    for length in RUN_LENGTHS:
        s[:, pos] = rng.choice(ends, b)
        s[:, pos + 1: pos + 1 + length] = 128
        s[:, pos + 1 + length: pos + 4 + length] = rng.choice(ends, (b, 3))
        pos += length + 40
    for i in range(b):
        at = 4 * SZ - 12 + i % 12
        s[i, at - 1] = 5
        s[i, at] = rng.choice(ends[:2])
        s[i, at + 1: at + 4] = 128
        if at + 4 < 4 * SZ:
            s[i, at + 4] = rng.choice(ends[:2])
        if i % 2:
            s[i, 4 * SZ - 700: 4 * SZ - 30] = 128
    return s


# S3's new design's edges (csrc/scans.cu merge_crossing): a thread's span
# of 64 positions, a warp's of 2,048, a CTA's of 32,768 (8 a stream)
MERGE_EDGE_KINDS = ("span edges", "state carries")


def merge_edge_streams(rng, b, kind: str):
    """(B, 6 SZ + 16) uint8 Y streams, the UV half zero, for S3's spans.
    "span edges": 5s (a skip of 1) but for a crossing pattern (136/120,
    three 128s, 136/120) starting 1..8 positions before every thread span
    edge (every 64th position; at CTA edges each distance in turn), so
    fires at a span's last 4 positions put their 201 in the next span
    (the next thread's, warp's or CTA's); and crossings 8..1 positions
    before the walk's end 4 SZ - 4.  "state carries": 5s but for a 128-run
    pattern at position e - 1 of every span edge e that leaves the cursor
    in state s (skips left) at e: s = 0 none, 1 (5, 128, 5), 2 (5, 128,
    128, 5), 3 (5, 128, 128, 128, 5), 4 a fire (136, 128, 128, 128, 120);
    s cycles with the edge and the image, so every state crosses thread,
    warp and CTA edges."""
    s = np.zeros((b, 6 * SZ + 16), np.uint8)
    s[:, : 4 * SZ] = 5
    ends = np.array([136, 120], np.uint8)
    edges = np.arange(64, 4 * SZ, 64)
    cyc = edges // 64 + edges // 2048 + edges // 32768
    for i in range(b):
        if kind == "span edges":
            at = edges - 1 - (cyc + i) % 8
            s[i, at] = rng.choice(ends, at.size)
            for k in (1, 2, 3):
                s[i, at + k] = 128
            s[i, at + 4] = rng.choice(ends, at.size)
            at = 4 * SZ - 12 + i % 8
            s[i, at - 1] = 5
            s[i, at] = rng.choice(ends)
            s[i, at + 1: at + 4] = 128
            s[i, at + 4] = rng.choice(ends)
        else:
            state = (cyc + i) % 5
            for st, pat in ((1, (5, 128, 5)), (2, (5, 128, 128, 5)),
                            (3, (5, 128, 128, 128, 5)),
                            (4, (136, 128, 128, 128, 120))):
                at = edges[state == st] - 1
                for k, val in enumerate(pat):
                    s[i, at + k] = val
    return s


def host_merge(s: np.ndarray) -> np.ndarray:
    """The host copy's C crossing merge on each stream."""
    from nhwcodec_tpu_torch.host.ops import quantize

    out = s.copy()
    for k in range(len(out)):
        quantize.merge_crossing_codes(out[k])
    return out


def host_stream_fixups(s: np.ndarray) -> tuple:
    """The host copy's merge, select and cap (its C scans) on each
    stream: (streams, sel1, sel2)."""
    from nhwcodec_tpu_torch.host.ops import quantize

    out, sels = s.copy(), []
    for k in range(len(out)):
        quantize.merge_crossing_codes(out[k])
        sels.append(quantize.select_codes(out[k]))
        quantize.cap_long_runs(out[k])
    return out, np.array([a for a, _ in sels]), np.array([c for _, c in sels])


def snap_edge_check(dev, rng, b: int) -> None:
    """S1 against its twin at batch b on the edge planes: each variant of
    q20 and q17's second alone, and the three variants of q20, q17 and q8
    as one launch (the twin checked against the variants one after
    another); the spill checked to move bytes, the tile-edge runs and the
    spill-left planes to do what they claim."""
    import torch

    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    for what, gen in SNAP_EDGE_KINDS.items():
        xt = torch.from_numpy(gen(rng, b)).to(dev)
        for a in des.snap_args(20) + des.snap_args(17)[1:2]:
            compare_and_time(
                "snap_pass", f"({b},512,512) {what} planes, rows "
                f"[{a[0]}, {a[1]}) columns [{a[2]}, {a[3]}) yw {a[5]}/{a[6]}",
                lambda: ds.snap_pass_device(xt, *a),
                lambda: ds.snap_pass_ref(xt, *a), timed=False)
            if what == "spill":
                got = ds.snap_pass_device(xt, *a)
                moved = (got[:, a[0]:a[1], a[3]]
                         != xt[:, a[0]:a[1], a[3]]).sum()
                check(int(moved) > 0, f"snap_pass: no spill into column "
                      f"{a[3]} at batch {b}")
        for q in (20, 17, 8):
            variants = des.snap_args(q)
            seq = xt
            for a in variants:
                seq = ds.snap_pass_ref(seq, *a)
            check(torch.equal(ds.snap_passes_ref(xt, variants), seq),
                  f"snap_passes_ref differs from its variants in turn on "
                  f"the {what} planes at q{q}")
            compare_and_time(
                "snap_pass", f"({b},512,512) {what} planes, the three "
                f"variants of q{q} in one launch",
                lambda: ds.snap_passes_device(xt, variants),
                lambda: ds.snap_passes_ref(xt, variants), timed=False)
            got = ds.snap_passes_device(xt, variants)
            if what == "tile edges":
                check(bool((got[:, 2:255:2, 271:331] == 17).all()),
                      "snap_pass: the class-1 run did not cross the tiles")
            if what == "spill left":
                big = xt[:, 256:511, 256].abs() >= 6
                out = got[:, 256:511, 257].abs()
                check(bool((out[big] == 9).all() and (out[~big] == 7).all()),
                      "snap_pass: variant 3 did not count the spill column")


# S1's edge planes: name -> generator
SNAP_EDGE_KINDS = {"chain": snap_chain_planes, "spill": snap_spill_planes,
                   "tile edges": snap_tile_edge_planes,
                   "spill left": snap_spill_left_planes}
# S1's device time before this design, three launches a batch on the q20
# batch (ms, CUDA events around a graph; PERF.md's row S1, NVIDIA H100
# 80GB HBM3 at 700 W)
S1_WAS_GRAPH_MS = 0.5176
# S3's device time before its one cluster launch (three launches, 16
# positions a thread, the maps built twice), and S11's before one cluster
# launch of a warp a row (three launches of a thread a row): ms, CUDA
# events around a graph, PERF.md's rows S3 and S11, NVIDIA H100 80GB HBM3
# at 700 W
S3_WAS_GRAPH_MS = 0.0524
S11_WAS_GRAPH_MS = 0.4391
# S10's before a warp a row and a look-back (S2's pass 1, then the rows
# walked from every entry state and again, a thread a walk), on the q16
# planes; S12's passes 1-3 before the warp relay (one launch, a CTA
# barrier a wavefront step) on the q12 planes, and its whole wrapper then
# (pass 4 and the far zeroings as torch ops), a call's CUDA events: ms,
# PERF.md's rows S10 and S12, NVIDIA H100 80GB HBM3 at 700 W
S10_WAS_GRAPH_MS = 0.3496
S12_WAS_GRAPH_MS = 0.2158
S12_WAS_CALL_MS = 1.0215
# S14's before the relay (one CTA of 64 threads a plane, each pass 184
# anti-diagonal steps with a CTA barrier each), on the captured q8 U and
# V planes twice (the same source)
S14_WAS_GRAPH_MS = 0.0615
# S2's before its passes 2-3 took bands and a relay (one CTA an image, a
# thread a column, rows in order), on the snapped q20 batch (the same
# source)
S2_WAS_GRAPH_MS = 0.2085


def host_offset_y(x: np.ndarray, q: int = 20) -> np.ndarray:
    """The host copy's C quantizer at quality q on each image."""
    from nhwcodec_tpu_torch.host.ops import quantize

    out = x.copy()
    for p in out:
        quantize.offset_y(p, q, 8)
    return out


def offset_y_split(x) -> None:
    """Print S2's three launches' device times on ``x`` (the profiler's
    means per record), passes 2-3's own bound and the sweeps each image
    took (the twin's, which takes the kernel's bands and relay)."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    _, _, top = device_profile(lambda: ds.offset_y_device(x, 8), calls=10)
    b = x.shape[0]
    ll = work(2 * 2 * b * 257 * 256, OFFSET_Y_LL_OPS * b * 256 * 256)
    sweeps = ds.offset_y_sweeps(x).cpu().tolist()
    print(f"kernel offset_y ({b},512,512) q20 snapped planes: launches (ms "
          "per call, profiler): " + "; ".join(f"{k[:40]} {v:.4f}"
                                              for k, v in top)
          + f"; passes 2-3's own bound {1e3 * ll['bound_ms']:.3f} us "
          f"({ll['bound_by']}); sweeps per image {sweeps}", flush=True)


def scan_kernel_phase(dev, captured: dict) -> dict:
    """S1-S3 against their twins (max_abs_err 0): timed on the q20
    batch's real planes and stream (snap_pass as the one launch of its
    three variants, also timed as three one-variant launches, the
    parent's pattern; offset_y on the snapped plane, with its three
    launches' split, passes 2-3's own bound and the relay's sweeps per
    image, at batch 1, 3 and 16 too and against the host copy's C;
    merge_crossing on the serpentine stream); then at batch 1, 3 and 16
    S1 on its edge planes (``snap_edge_check``), offset_y on its edge
    planes (row 255's vertical fires checked to write row 256), relay
    edge planes (checked to take every sweep) and random planes, each
    also against the host copy's C, and edge streams (128-runs of 255 +
    254 m + d, crossings at the walk's end), whose merge + select + cap
    on the card also equal the host copy's C scans."""
    import torch

    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    out = {}
    st = stack_records(captured[20])
    y = torch.from_numpy(st["y"]).to(dev)
    variants = des.snap_args(20)
    region = sum((r1 - r0) * (c1 - c0)
                 for r0, r1, c0, c1, *_ in variants)
    out["snap_pass"] = compare_and_time(
        "snap_pass", f"({B},512,512) int16, q20 planes, the 3 variants in "
        "one launch", lambda: ds.snap_passes_device(y, variants),
        lambda: ds.snap_passes_ref(y, variants),
        twin_calls=1, twin_runs=3,
        bound=work(2 * 2 * B * 512 * 512, SNAP_OPS * B * region),
        graph=True)
    three = graph_ms(lambda: [ds.snap_pass_device(y, *a) for a in variants])
    print(f"kernel snap_pass ({B},512,512) q20 planes: the one launch "
          f"{out['snap_pass']['graph_ms']:.4f} ms, the three variants as "
          f"three launches {three:.4f} ms (graph of {GRAPH_CALLS} calls, "
          f"CUDA events); the design before, three launches: "
          f"{S1_WAS_GRAPH_MS} ms (PERF.md)", flush=True)
    out["snap_pass"]["three_launches_graph_ms"] = three
    snapped = ds.snap_passes_device(y, variants)
    out["offset_y"] = compare_and_time(
        "offset_y", f"({B},512,512) int16, q20 snapped planes",
        lambda: ds.offset_y_device(snapped, 8),
        lambda: ds.offset_y_ref(snapped, 8), twin_calls=1, twin_runs=3,
        bound=work(4 * B * 512 * 512,
                   (OFFSET_Y_PASS1_OPS + OFFSET_Y_PASS4_OPS) * B * 512 * 512
                   + OFFSET_Y_LL_OPS * B * 256 * 256), graph=True)
    print(f"kernel offset_y ({B},512,512) q20: "
          f"{out['offset_y']['graph_ms']:.4f} ms (graph of {GRAPH_CALLS} "
          f"calls, CUDA events); the design before: {S2_WAS_GRAPH_MS} ms "
          "(PERF.md)", flush=True)
    offset_y_split(snapped)
    compare_batches("offset_y", "q20 snapped planes",
                    lambda a: ds.offset_y_device(a, 8),
                    lambda a: ds.offset_y_ref(a, 8), (snapped,))
    check(np.array_equal(ds.offset_y_device(snapped, 8).cpu().numpy(),
                         host_offset_y(snapped.cpu().numpy())),
          "offset_y on the q20 snapped planes differs from the host C")
    stream = torch.zeros((B, 6 * SZ + 16), dtype=torch.uint8, device=dev)
    stream[:, : 4 * SZ] = ds.serpentine_y_device(
        ds.offset_y_device(snapped, 8))
    out["merge_crossing"] = compare_and_time(
        "merge_crossing", f"({B},{6 * SZ + 16}) uint8, q20 streams",
        lambda: ds.merge_crossing_device(stream),
        lambda: ds.merge_crossing_ref(stream),
        bound=work(2 * stream.numel(), MERGE_OPS * B * 4 * SZ), graph=True)
    print(f"kernel merge_crossing ({B},{6 * SZ + 16}) q20: "
          f"{out['merge_crossing']['graph_ms']:.4f} ms (graph of "
          f"{GRAPH_CALLS} calls, CUDA events); the design before: "
          f"{S3_WAS_GRAPH_MS} ms (PERF.md)", flush=True)
    check_one_launch("merge_crossing", f"({B},{6 * SZ + 16}) q20 streams",
                     lambda: ds.merge_crossing_device(stream),
                     "merge_crossing")
    rng = np.random.default_rng(SEED + 30)
    for b in (1, 3, B):
        snap_edge_check(dev, rng, b)
        for what, x in (("edge", offset_y_edge_planes(rng, b)),
                        ("relay edge", offset_y_relay_edge_planes(rng, b)),
                        ("random [-400, 400]", rng.integers(
                            -400, 401, (b, 512, 512)).astype(np.int16))):
            xt = torch.from_numpy(x).to(dev)
            compare_and_time(
                "offset_y", f"({b},512,512) {what} planes",
                lambda: ds.offset_y_device(xt, 8),
                lambda: ds.offset_y_ref(xt, 8), timed=False)
            got = ds.offset_y_device(xt, 8)
            check(np.array_equal(got.cpu().numpy(), host_offset_y(x)),
                  f"offset_y on the {what} planes differs from the host C "
                  f"at batch {b}")
            if what == "edge":
                check(bool((got[:, 256, 1:256:4] == 128).all()),
                      "offset_y: row 255's vertical fires did not reach "
                      "row 256")
            if what == "relay edge":
                sweeps = ds.offset_y_sweeps(xt).tolist()
                check(sweeps == [ds.OY_BANDS] * b,
                      f"offset_y: the relay edge planes took {sweeps} "
                      "sweeps, not every one")
    print("encode scans: offset_y equals its twin and the host copy's C on "
          f"the edge, relay edge ({ds.OY_BANDS} sweeps each) and random "
          "planes at batch 1, 3 and 16", flush=True)
    for b in (1, 3, B):
        s = stream_edge_streams(rng, b)
        st_t = torch.from_numpy(s).to(dev)
        compare_and_time("merge_crossing", f"({b},{6 * SZ + 16}) edge "
                         "streams", lambda: ds.merge_crossing_device(st_t),
                         lambda: ds.merge_crossing_ref(st_t), timed=False)
        merged = ds.merge_crossing_device(st_t)
        sel, sel1, sel2 = ds.select_codes_device(merged)
        capped = ds.cap_long_runs_device(sel)
        want, w1, w2 = host_stream_fixups(s)
        check(np.array_equal(capped.cpu().numpy(), want)
              and np.array_equal(sel1.cpu().numpy(), w1)
              and np.array_equal(sel2.cpu().numpy(), w2),
              f"merge + select + cap on the card differ from the host "
              f"copy's on the edge streams at batch {b}")
    print("encode scans: merge + select + cap on the card equal the host "
          "copy's C scans on the edge streams at batch 1, 3 and 16",
          flush=True)
    for kind in MERGE_EDGE_KINDS:
        s = merge_edge_streams(rng, B, kind)
        st_t = torch.from_numpy(s).to(dev)
        compare_batches("merge_crossing", f"{kind} streams",
                        ds.merge_crossing_device, ds.merge_crossing_ref,
                        (st_t,))
        check(np.array_equal(ds.merge_crossing_device(st_t).cpu().numpy(),
                             host_merge(s)),
              f"merge_crossing on the {kind} streams differs from the host "
              "copy's C")
        ms = graph_ms(lambda: ds.merge_crossing_device(st_t))
        print(f"kernel merge_crossing ({B},{6 * SZ + 16}) {kind} streams: "
              f"{ms:.4f} ms (graph of {GRAPH_CALLS} calls, CUDA events)",
              flush=True)
    print("encode scans: merge_crossing equals its twin and the host copy's "
          f"C on the {', '.join(MERGE_EDGE_KINDS)} streams at batch 1, 3 "
          "and 16", flush=True)
    return out


# ---------------------------------------------------------------------------
# the device encode scans' residue stage: the E11 tail (mid-q cleanup, pair
# promotion) and E12 (column ladder, classify, positional streams)
# (models/device_encode_scans._y_residue_stage)

RESIDUE_KERNELS = ("pair_promotion", "column_ladder", "classify")
# wrapper calls of a residue stage (q > LOW4): one pair_promotion launch,
# one column_ladder (two launches: ladder_table, column_ladder), one
# classify (one launch of classify_bands, after the counts' zero fill)
RESIDUE_LAUNCHES = {k: 1 for k in RESIDUE_KERNELS}
# q -> images whose host encodes are captured: the StreamCapture records of
# encode_phase, and q18 (LOW2, the ladder's low2 branch), captured from 4
# host encodes of the encode batch inside encode_residue_phase
RESIDUE_QS = {20: B, 21: 4, 19: 4, 18: 4, 17: 4}
# the functions' own operations, counted from the sources: a region
# position of pair promotion (the two triple tests, the +-8 rules, the
# writes); a position of the column ladder (the three deltas, its branch
# chain, the band op, the carries); a position of classify (the delta, the
# band rules, the code map, the counts)
PP_OPS = 25
LADDER_OPS = 70
CLASSIFY_OPS = 40
# S5's device time before this design, one CTA an image, on the q20 batch
# (ms, CUDA events around a graph; PERF.md's row S5, NVIDIA H100 80GB HBM3
# at 700 W)
S4_WAS_GRAPH_MS = 0.1277
S5_WAS_GRAPH_MS = 0.2898
# S6's before its band rows took 6-class map scans (one CTA an image, a
# thread a column), on the q20 ladder outputs (the same source)
S6_WAS_GRAPH_MS = 0.2157


def host_classify_equal(plane, res256, got, q: int, rs: int) -> bool:
    """Whether ``got`` (classify's (plane', res256', n1, n3, n5) on the
    card) equals the host copy's C on each image of (plane, res256)."""
    from nhwcodec_tpu_torch.host.ops import residue

    gp, gr, *gn = (t.cpu().numpy() for t in got)
    for k, (hp, hr) in enumerate(zip(plane.cpu().numpy().copy(),
                                     res256.cpu().numpy().copy())):
        counts = residue.res256_classify(hp, hr, q, rs)
        if not (np.array_equal(gp[k], hp) and np.array_equal(gr[k], hr)
                and tuple(int(n[k]) for n in gn) == counts):
            return False
    return True


# columns whose cross-column pair check reads the next column's inputs at
# S5's 32-column block edges (31 reads 32, 63 reads 64), at a block's first
# columns (32, 64), and column 254 reading column 255, at row r + k (image
# k)
LADDER_EDGE_COLS = {31: 20, 32: 40, 63: 60, 64: 80, 254: 100}


def ladder_block_edge_inputs(b):
    """(plane, rf_ext) on which column j of LADDER_EDGE_COLS fires the
    cross-column pair check at row r (deltas 2, 2, 0 at rows r..r + 2,
    rf 0) on column j + 1's input deltas 2, 2, 1 there, while column
    j + 1's own walk (deltas 2, 2, 2 from row r - 1: 12400 at r - 1)
    lowers its rows r and r + 1 by 2: read as results, the check would
    not fire.  Everything else is 0."""
    p = np.zeros((b, 512, 512), np.int16)
    for k in range(b):
        for j, r in LADDER_EDGE_COLS.items():
            r += k
            p[k, r: r + 3, j] = (2, 2, 0)
            p[k, r - 1: r + 3, j + 1] = (2, 2, 2, 1)
    z = np.zeros((b, 256, 256), np.int16)
    return p, rf_ext_np(z, np.zeros((b, 4), np.int16), z)


def rf_ext_np(res256, khead, resIII) -> np.ndarray:
    """(B, SZ + 1024) int16: res256 and the tail the column ladder reads
    past it (``device_encode_scans._rf_ext`` on numpy arrays)."""
    import torch

    from nhwcodec_tpu_torch.models import device_encode_scans as des

    return des._rf_ext(*(torch.from_numpy(np.ascontiguousarray(a))
                         for a in (res256, khead, resIII))).numpy()


def pp_adversarial_planes(rng, b):
    """The adversarial plane of the JAX package's pair-promotion test:
    triples, +-8 pairs and +-6/7 neighbours everywhere."""
    vals = np.array([5, 6, 7, 8, -5, -6, -7, -8, 0, 9, -9, 12], np.int16)
    return rng.choice(vals, size=(b, 512, 512))


# motifs S4's tile-edge planes place at columns c - 2 .. c + 1 around each
# lane tile's last visit c, and the carry state each leaves across the
# edge: a tri at c - 1 (1), at c (5; -: 6), 8 beside a 6/7 and -8 beside a
# -6/-7 (4, 3), the band rows' 8/8 and -8/-8 pairs at c (7, 8) and at c - 1
# (2, 3)
PP_EDGE_MOTIFS = ((5, 6, 5, 0), (-5, -7, -4, 0), (0, 4, 7, 7),
                  (0, -4, -6, -7), (0, 6, 8, 0), (0, 0, 8, 7),
                  (0, -7, -8, 0), (0, 0, -8, -6), (0, 0, 8, 8),
                  (0, 0, -8, -8), (0, 8, 8, 0), (0, -8, -8, 0))
PP_EDGE_KINDS = ("tile edges", "runs of 8", "region starts")


def pp_tile_edge_planes(rng, b, kind: str):
    """(B, 512, 512) int16 planes for S4's lane tiles (8 columns a lane,
    ``device_scans.PP_TILE``; lane l's last visit is column c0 + 8 l + 7 of
    a region starting at visit c0): "tile edges" (a motif of
    PP_EDGE_MOTIFS at every tile's last visit of every region row, so that
    each of the nine carry states enters some lane), "runs of 8" (runs of
    8 or -8, 2 to 40 long, from every phase of a tile, so the band rows'
    9/9 and -9/-9 pairs chain across several tiles), "region starts" (a
    tri on each region's first visit, whose 10100 lands in column 256 or
    0, and motifs on its last visits).  Rows 0, 255, 256 and 511, outside
    both regions, hold motifs too; the rest is 0..3 and +-12."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    bg = np.array([0, 1, 2, 3, 12, -12], np.int16)
    p = rng.choice(bg, size=(b, 512, 512))
    for k in range(b):
        for row in range(512):
            c0 = 257 if row < 256 else 1
            if kind == "tile edges":
                for lane in range(ds.PP_LANES - 1):
                    c = c0 + ds.PP_TILE * lane + ds.PP_TILE - 1
                    m = PP_EDGE_MOTIFS[rng.integers(len(PP_EDGE_MOTIFS))]
                    p[k, row, c - 2: c + 2] = m
            elif kind == "runs of 8":
                c = c0 - 1 + int(rng.integers(0, 8))
                while c < c0 + 250:
                    n = int(rng.integers(2, 41))
                    p[k, row, c: min(c + n, c0 + 255)] = (
                        8 if rng.random() < 0.5 else -8)
                    c += n + int(rng.integers(1, 4))
            else:
                p[k, row, c0 - 1: c0 + 2] = ((5, 6, 7) if row % 2
                                             else (-4, -7, -5))
                m = PP_EDGE_MOTIFS[row % len(PP_EDGE_MOTIFS)]
                p[k, row, c0 + 250: c0 + 254] = m
    return p


def delta_inputs(rng, b):
    """The ladder's inputs as the JAX package's unit test draws them: a
    plane in [-12, 12], res256 = its LL quadrant +- 6, resIII in
    [-20, 20], a kernel head in [-5, 5].  Returns (plane, rf_ext, res256,
    resIII, khead)."""
    p = rng.integers(-12, 13, (b, 512, 512)).astype(np.int16)
    r256 = (p[:, :256, :256] + rng.integers(-6, 7, (b, 256, 256))
            ).astype(np.int16)
    resIII = rng.integers(-20, 21, (b, 256, 256)).astype(np.int16)
    khead = rng.integers(-5, 6, (b, 4)).astype(np.int16)
    return p, rf_ext_np(r256, khead, resIII), r256, resIII, khead


COL255_ROW0 = 10


def col255_edge_inputs(b):
    """(plane, rf_ext) on which column 255's walk after the barrier
    changes the result.  Image i, at row r = 10 + 13 i: column 255 holds
    deltas 2, 2, 0 at rows r..r + 2 (the cross-column pair check), band
    column 256 holds 2 at rows r..r + 2 and rf column 0 is 0 there, so
    with input values the check fires (mark 12400 at (r, 255)); but
    column 0 holds deltas 2, 2, 2 at rows r + 1..r + 3 and marks rf
    (r + 1, 0) 12400 first, so the C's check, which reads that mark,
    does not fire.  Everything else is 0."""
    p = np.zeros((b, 512, 512), np.int16)
    for i in range(b):
        r = COL255_ROW0 + 13 * i
        p[i, r: r + 2, 255] = 2
        p[i, r: r + 3, 256] = 2
        p[i, r + 1: r + 4, 0] = 2
    z = np.zeros((b, 256, 256), np.int16)
    return p, rf_ext_np(z, np.zeros((b, 4), np.int16), z)



# S6's class edges: each boundary between two classes of band values (lo,
# hi), with a step (res, v) whose band rule tells the two classes apart
# (res 3: below HIGH1 only; res 4: at res_setting 3 only); the first steps
# of lane tiles (8 steps a lane) where the entry class crosses them; the
# res of the other steps (every case: 0..1, 2, 3, 4, 5..6, 7, > 7, and <=
# res_setting) and their band values around every boundary; the marks the
# ladder writes (the only ones the C maps: others are 0 there, 149 in the
# JAX package and the port)
CLASS_EDGES = {(-8, -7): (0, -7), (-1, 0): (2, -6), (1, 2): (2, -8),
               (2, 3): (3, -6), (7, 8): (4, 7)}
CLASS_TILE_EDGES = (8, 128, 248)
CLASS_RES = np.array([0, 1, 2, 3, 4, 5, 6, 7, 8, 9, -2], np.int16)
CLASS_BAND = np.array([-12, -10, -9, -8, -7, -6, -5, -1, 0, 1, 2, 3, 7, 8,
                       9, 10, 16, 24, -16], np.int16)
CLASS_MARKS = np.array([14000, 14500, 12200, 12100, 12300, 12400, 14100,
                        12500, 12600, 14900], np.int16)


def classify_class_edge_inputs(rng, b) -> tuple:
    """(plane, res256, design) for S6: band row j of image k writes at
    steps e - 2 and e - 1 (e in CLASS_TILE_EDGES, a lane tile's first
    step) two values across one boundary of CLASS_EDGES, in either order,
    both kept (res -5), and its step e applies the rule that tells their
    classes apart, so that step e's result depends on the class the tile
    enters with (the boundaries, edges and orders taken in turn over the
    rows); design[k, j] = (e, first, second, res, v).  The other steps draw
    res from CLASS_RES, band values from CLASS_BAND, and one mark in 8
    from CLASS_MARKS."""
    shape = (b, 256, 256)
    marks = rng.integers(-40, 41, shape).astype(np.int16)
    res = rng.choice(CLASS_RES, shape)
    band = rng.choice(CLASS_BAND, shape)                 # [j, step]
    combos = [(edge, e, order) for edge in CLASS_EDGES
              for e in CLASS_TILE_EDGES for order in (0, 1)]
    design = np.zeros((b, 256, 5), np.int32)
    for k in range(b):
        for j in range(256):
            edge, e, order = combos[(j + 7 * k) % len(combos)]
            first, second = edge[::-1] if order else edge
            r, v = CLASS_EDGES[edge]
            band[k, j, e - 2: e + 1] = (first, second, v)
            res[k, e - 2: e + 1, j] = (-5, -5, r)        # [step, j]
            design[k, j] = (e, first, second, r, v)
    plane = rng.integers(-400, 401, (b, 512, 512)).astype(np.int16)
    plane[:, :256, :256] = marks + res
    plane[:, :256, 256:] = band
    high = rng.random(shape) < 1 / 8
    high[np.arange(b)[:, None, None], design[:, None, :, 0]
         + np.arange(-2, 1)[None, :, None], np.arange(256)] = False
    marks[high] = rng.choice(CLASS_MARKS, int(high.sum()))
    return plane, marks, design



def classify_edge_splits(plane, res256, out, design, q: int,
                         rs: int) -> set:
    """Check classify's output ``out`` on ``classify_class_edge_inputs``
    (``plane``, ``res256``, ``design``; numpy): each band row keeps its
    two values at steps e - 2 and e - 1, and its step e writes what the
    class of the value at e - 1 gives (``_classify_step`` with it).
    Returns the (lo, hi, e) whose two classes gave step e different
    results in some row."""
    import torch

    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.models import device_scans as ds

    k, j = np.indices(design.shape[:2])
    e, first, second = design[..., 0], design[..., 1], design[..., 2]
    check(np.array_equal(out[k, j, 256 + e - 2], first)
          and np.array_equal(out[k, j, 256 + e - 1], second),
          "classify edge inputs: the values at steps e - 2, e - 1 moved")
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.int32))  # noqa: E731
    step = [t(a) for a in (plane[k, e, j], res256[k, e, j],
                           plane[k, j, 256 + e])]
    got, alt = (ds._classify_step(q >= T.HIGH1, rs, t(bp), *step)[0]
                .numpy() for bp in (second, first))
    check(np.array_equal(out[k, j, 256 + e], got),
          "classify edge inputs: step e does not follow the class written "
          "before it")
    split = got != alt
    return {(int(min(a, c)), int(max(a, c)), int(x))
            for a, c, x in zip(first[split], second[split], e[split])}


def classify_expected_splits(q: int, rs: int) -> set:
    """The (lo, hi, e) of CLASS_EDGES x CLASS_TILE_EDGES whose step tells
    the classes apart at quality q and res_setting rs (res 3's rule
    below HIGH1, res 4's at rs < 4)."""
    from nhwcodec_tpu_torch.host import tables as T

    return {(lo, hi, e) for (lo, hi), (r, _) in CLASS_EDGES.items()
            for e in CLASS_TILE_EDGES
            if (r != 3 or q < T.HIGH1) and (r != 4 or rs < 4)}


# every code of the three positional streams
RESIDUE_CODES = np.array([121, 122, 123, 124, 125, 126, 140, 141, 144, 145,
                          148, 149], np.int16)


def stream_edge_rfs(rng, b) -> dict:
    """(B, 256, 256) int16 classify outputs for the positional streams:
    one with no code of any stream (only the row markers; random other
    values), one with a code at every position of columns 0..253, and one
    with one code a row at column 37 r mod 254, so that the 254 markers
    between a row's code and a lower next one are isolated and dropped
    (and kept before a higher one)."""
    none = rng.choice(np.array([0, 1, 5, 120, 130, 200, 12000, -3],
                               np.int16), (b, 256, 256))
    every = rng.choice(np.array([0, 7], np.int16), (b, 256, 256))
    every[:, :, :254] = rng.choice(RESIDUE_CODES, (b, 256, 254))
    iso = np.zeros((b, 256, 256), np.int16)
    rows = np.arange(256)
    iso[:, rows, (37 * rows) % 254] = rng.choice(RESIDUE_CODES, (b, 256))
    return {"no codes": none, "every position": every,
            "isolated markers": iso}


def host_positional_streams(rf: np.ndarray, q: int) -> tuple:
    """The host copy's build_positional_stream + finish_stream (its C) on
    each image's rf, the streams of quality q in order: (rf' (B, 256,
    256), [each image's sections])."""
    from nhwcodec_tpu_torch.host.ops import residue
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    rf = rf.copy()
    secs = [dict() for _ in rf]
    for key, codes, word_bits, q_min in des.RESIDUE_STREAMS:
        if q < q_min:
            continue
        for k in range(len(rf)):
            pos, words = residue.build_positional_stream(rf[k], codes, q)
            res, bit, _, word = residue.finish_stream(pos, words, word_bits)
            secs[k].update({key: res, key + "_bit": bit, key + "_word":
                            word[: word_bits * ((len(words) >> 3) + 1)]})
    return rf, secs


def host_residue_stage(st: dict, q: int) -> tuple:
    """The host copy's residue stage (its C scans) on the captured
    planes, image by image as ``encoder.encode_y`` runs it: returns the
    (B, 512, 512) planes after the LL2-zone rebuild and each image's res
    sections."""
    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.host.ops import residue

    rs = encoder._res_setting(q)
    planes, rfs = [], []
    for k in range(len(st["e11"])):
        process = st["e11"][k].copy()
        pf = process.reshape(-1)
        if T.LOW5 < q < T.NORM:
            encoder._mid_q_band_cleanup(pf, 8)
        encoder._pair_promotion(pf, q)
        res256 = st["res256"][k].copy()
        residue.res256_column_ladder(process, res256, q, rs, st["resIII"][k],
                                     kernel_head=st["khead"][k])
        residue.res256_classify(process, res256, q, rs)
        block = st["resIII"][k].copy()
        zone = block[:128, :128]
        zone[zone <= 8000] = 0
        process[:256, :256] = block
        planes.append(process)
        rfs.append(res256)
    _, secs = host_positional_streams(np.stack(rfs), q)
    return np.stack(planes), secs


def sections_equal(got: list, want: list) -> list:
    """The (image, section) pairs where two lists of res sections part."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        for key in sorted(set(g) | set(w)):
            if key not in g or key not in w or not np.array_equal(
                    np.asarray(g[key], np.uint8), np.asarray(w[key],
                                                             np.uint8)):
                bad.append((i, key))
    return bad


def residue_inputs(st: dict, dev) -> tuple:
    """The residue stage's captured inputs on ``dev``: (e11, res256,
    khead, resIII)."""
    import torch

    return tuple(torch.from_numpy(st[k]).to(dev)
                 for k in ("e11", "res256", "khead", "resIII"))


def encode_residue_phase(dev, images: np.ndarray, captured: dict) -> dict:
    """The residue stage on the card (``_y_residue_stage``) once a batch
    on the inputs captured from the host copy's own encodes: the encode
    batch's 16 images at q20 and 4 images each at q21, q19, q18 (captured
    here: LOW2, the column ladder's low2 branch) and q17.  Each batch's
    plane (the snap passes' input) byte for byte against the host's, pair
    promotion's output on the way, every res1/res3/res5 section, and,
    chained into ``_y_stream_stage`` and ``_uv_stream_stage`` on the
    captured U/V planes, each image's 6 SZ stream and sel1/sel2;
    pair_promotion, column_ladder and classify launched once a batch.
    Times the q20 batch's stage (CUDA events, median of RUNS; a profile)
    beside the host copy's C scans on the same inputs (host timer, median
    of 5).  Returns the q20 batch's launches."""
    import torch

    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    with StreamCapture() as cap:
        for img in quality_batch(images, T.LOW2):
            host_encoder.encode(img, T.LOW2)
    captured[T.LOW2] = cap.records
    out = None
    for q, want_b in RESIDUE_QS.items():
        st = stack_records(captured[q])
        check(len(st["y"]) == want_b and "e11" in st,
              f"q{q}: captured {len(st['y'])} host encodes with their "
              f"residue stage, not {want_b}")
        args = residue_inputs(st, dev)
        build.reset_launches()
        P, streams = des._y_residue_stage(*args, q)
        secs = des._residue_sections(streams)
        launches = {k: build.LAUNCHES[k] for k in RESIDUE_KERNELS}
        check(launches == RESIDUE_LAUNCHES,
              f"q{q}: residue stage launches {launches}, not "
              f"{RESIDUE_LAUNCHES}")
        diff = np.argwhere(P.cpu().numpy() != st["y"])
        check(diff.size == 0, f"q{q}: the residue stage's plane differs from "
              f"the host copy's at {diff[:8].tolist()}")
        e11 = args[0]
        if T.LOW5 < q < T.NORM:
            e11 = ds.mid_q_band_cleanup_device(e11)
        check(np.array_equal(ds.pair_promotion_device(e11).cpu().numpy(),
                             st["pp"]),
              f"q{q}: pair promotion differs from the host copy's")
        bad = sections_equal(secs, st["res"])
        check(not bad, f"q{q}: res sections differ from the host copy's at "
              f"(image, section) {bad[:8]}")
        u, v = (torch.from_numpy(st[k]).to(dev) for k in "uv")
        stream, sel1, sel2 = device_stream_stage(P, u, v, q)
        stream_check(f"q{q} residue + stream stages", stream, sel1, sel2, st)
        sizes = [{k: len(x) for k, x in s.items()} for s in secs[:1]]
        print(f"encode scans: residue stage at q{q}, batch {want_b}, "
              "byte-identical to the host copy: the plane, pair promotion's "
              f"output, the {len(secs[0])} res sections of each image "
              f"(image 0: {sizes[0]}), and chained into the stream stage "
              f"each image's im_nhw and sel1/sel2; launches {launches}",
              flush=True)
        if q != 20:
            continue
        out = launches
        dev_ms = median_ms(lambda: des._y_residue_stage(*args, q))
        t0 = time.perf_counter()
        des._residue_sections(streams)
        sec_ms = (time.perf_counter() - t0) * 1e3
        planes, hsecs = host_residue_stage(st, q)
        check(np.array_equal(planes, st["y"])
              and not sections_equal(hsecs, st["res"]),
              "the host copy's residue stage on the captured inputs differs "
              "from its own encode")
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            host_residue_stage(st, q)
            host.append((time.perf_counter() - t0) * 1e3)
        print(f"encode scans: residue stage, batch {want_b} q20: device "
              f"{dev_ms:.4f} ms (CUDA events, median of {RUNS}), the "
              f"sections to the host {sec_ms:.2f} ms (host timer, once); "
              f"host copy's C scans {float(np.median(host)):.2f} ms (host "
              "timer, median of 5)", flush=True)
        print_profile(f"encode scans residue stage, batch {want_b} q20",
                      lambda: des._y_residue_stage(*args, q))
    return out


def compare_batches(name: str, what: str, kern, twin, args: tuple) -> None:
    """``kern`` on the first 1, 3 and B images of ``args`` (batch-B
    tensors) against one call of ``twin`` on all B: the twins treat the
    images independently, so their first b results are their results on
    the first b images.  Checks max_abs_err 0."""
    want = twin(*args)
    want = want if isinstance(want, tuple) else (want,)
    for b in (1, 3, B):
        got = kern(*(a[:b] for a in args))
        got = got if isinstance(got, tuple) else (got,)
        err = max_abs_err(name, got, tuple(w[:b] for w in want))
        print(f"kernel {name} {tuple(args[0][:b].shape)} {what}: "
              f"max_abs_err {err} vs torch twin", flush=True)
        check(err == 0, f"{name} disagrees with its torch twin on {what} "
              f"at batch {b}")


def host_pair_promotion(x: np.ndarray, q: int = 20) -> np.ndarray:
    """The host copy's C ``_pair_promotion`` on each (512, 512) plane."""
    from nhwcodec_tpu_torch.host.models import encoder

    out = x.copy()
    for k in range(len(out)):
        flat = out[k].reshape(-1)
        encoder._pair_promotion(flat, q)
    return out


def pp_edge_check(dev, e11, rng) -> None:
    """S4 at batch 1, 3 and 16 against its twin on the captured q20 E11
    planes and on each kind of ``pp_tile_edge_planes``, whose lane-tile
    entry states (the twin's) must reach what each kind claims; on all of
    them at batch 16 against the host copy's C."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    planes = {"q20 E11 planes": e11}
    for kind in PP_EDGE_KINDS:
        planes[f"{kind} planes"] = torch.from_numpy(
            pp_tile_edge_planes(rng, B, kind)).to(dev)
    for what, x in planes.items():
        compare_batches("pair_promotion", what, ds.pair_promotion_device,
                        ds.pair_promotion_ref, (x,))
        got = ds.pair_promotion_device(x).cpu().numpy()
        check(np.array_equal(got, host_pair_promotion(x.cpu().numpy())),
              f"pair_promotion on the {what} differs from the host C")
        entries = ds.pair_promotion_entries(x).cpu().numpy()
        seen = [sorted(int(v) for v in np.unique(entries[:, r]) if v)
                for r in range(2)]
        print(f"kernel pair_promotion {what}: equal to the host C; carry "
              f"states entering a lane tile (band rows, lower rows) {seen}",
              flush=True)
        if what.startswith("tile edges"):
            check(seen[0] == list(range(1, 9)),
                  f"the tile edge planes carry {seen[0]} into the band "
                  "rows' tiles, not every state")


def residue_kernel_phase(dev, captured: dict) -> dict:
    """S4-S6 against their twins (max_abs_err 0): timed on the q20
    batch's captured inputs (pair_promotion on the E11 plane,
    column_ladder on pair promotion's output, classify on the ladder's);
    then at batch 1, 3 and 16 (``compare_batches``) on the adversarial
    pair-promotion plane, pair promotion on the q20 E11 planes and the
    tile-edge planes, also against the host copy's C (``pp_edge_check``),
    delta planes at q17, q18, q20 and q21 (ladder, then classify), and the column-255 and block-edge planes, whose marks
    on the card also equal the host copy's C; classify also at batch 1, 3
    and 16 on the q20 ladder outputs and on the class edge inputs at q20
    and q21 with res_setting 3, 4, 6 and 8 (checked to cross every class
    boundary the rules tell apart at the lane-tile edges), both against
    the host copy's C; and the positional streams
    (torch ops) on the card against the host copy's C on the edge rfs (no codes, a code at every
    position, isolated markers) at every stream."""
    import torch

    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.host.ops import residue
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    out = {}
    st = stack_records(captured[20])
    e11, res256, khead, resIII = residue_inputs(st, dev)
    plane_bytes = 2 * 512 * 512
    region = sum((r1 - r0) * (c1 - c0) for r0, r1, c0, c1, _ in ds.PP_REGIONS)
    out["pair_promotion"] = compare_and_time(
        "pair_promotion", f"({B},512,512) int16, q20 E11 planes",
        lambda: ds.pair_promotion_device(e11),
        lambda: ds.pair_promotion_ref(e11), twin_calls=2, twin_runs=5,
        bound=work(2 * B * plane_bytes, PP_OPS * B * region), graph=True)
    print(f"kernel pair_promotion ({B},512,512) q20: "
          f"{out['pair_promotion']['graph_ms']:.4f} ms (graph of "
          f"{GRAPH_CALLS} calls, CUDA events); the design before: "
          f"{S4_WAS_GRAPH_MS} ms (PERF.md)", flush=True)
    pp = ds.pair_promotion_device(e11)
    rf_ext = des._rf_ext(res256, khead, resIII)
    rs = host_encoder._res_setting(20)
    out["column_ladder"] = compare_and_time(
        "column_ladder", f"({B},512,512) int16 + ({B},{SZ + 1024}) rf_ext, "
        "q20 planes", lambda: ds.column_ladder_device(pp, rf_ext, 20, rs),
        lambda: ds.column_ladder_ref(pp, rf_ext, 20, rs), twin_calls=1,
        twin_runs=3, twin_warm=1, bound=work(B * (2 * plane_bytes + 2 * (2 * SZ + 1024)),
                                LADDER_OPS * B * 256 * 255), graph=True)
    print(f"kernel column_ladder ({B},512,512) q20: "
          f"{out['column_ladder']['graph_ms']:.4f} ms (graph of "
          f"{GRAPH_CALLS} calls, CUDA events; its two launches, the step's "
          f"table and the walk); the design before: {S5_WAS_GRAPH_MS} ms "
          "(PERF.md)", flush=True)
    lp, lrf = ds.column_ladder_device(pp, rf_ext, 20, rs)
    lrf = lrf.reshape(-1, 256, 256)
    out["classify"] = compare_and_time(
        "classify", f"({B},512,512) int16 + ({B},256,256) res256, q20 "
        "ladder outputs", lambda: ds.classify_device(lp, lrf, 20, rs),
        lambda: ds.classify_ref(lp, lrf, 20, rs), twin_calls=1, twin_runs=5,
        bound=work(B * (2 * plane_bytes + 4 * SZ + 12),
                   CLASSIFY_OPS * B * SZ), graph=True)
    print(f"kernel classify ({B},512,512) q20: "
          f"{out['classify']['graph_ms']:.4f} ms (graph of {GRAPH_CALLS} "
          f"calls, CUDA events); the design before: {S6_WAS_GRAPH_MS} ms "
          "(PERF.md)", flush=True)
    compare_batches("classify", "q20 ladder outputs",
                    lambda a, b: ds.classify_device(a, b, 20, rs),
                    lambda a, b: ds.classify_ref(a, b, 20, rs), (lp, lrf))
    check(host_classify_equal(lp, lrf, ds.classify_device(lp, lrf, 20, rs),
                              20, rs),
          "classify on the q20 ladder outputs differs from the host C")
    rng = np.random.default_rng(SEED + 40)
    x = torch.from_numpy(pp_adversarial_planes(rng, B)).to(dev)
    compare_batches("pair_promotion", "adversarial planes",
                    ds.pair_promotion_device, ds.pair_promotion_ref, (x,))
    pp_edge_check(dev, e11, rng)
    for q in (17, 18, 20, 21):
        rs = host_encoder._res_setting(q)
        p, rfe = (torch.from_numpy(a).to(dev)
                  for a in delta_inputs(rng, B)[:2])
        compare_batches(
            "column_ladder", f"delta planes q{q}",
            lambda a, b, q=q, rs=rs: ds.column_ladder_device(a, b, q, rs),
            lambda a, b, q=q, rs=rs: ds.column_ladder_ref(a, b, q, rs),
            (p, rfe))
        lp, lrf = ds.column_ladder_device(p, rfe, q, rs)
        compare_batches(
            "classify", f"delta-plane ladder outputs q{q}",
            lambda a, b, q=q, rs=rs: ds.classify_device(a, b, q, rs),
            lambda a, b, q=q, rs=rs: ds.classify_ref(a, b, q, rs),
            (lp, lrf.reshape(B, 256, 256)))
    for q in (20, 21):
        for rs in (3, 4, 6, 8):
            p_np, r_np, design = classify_class_edge_inputs(rng, B)
            p, rfc = torch.from_numpy(p_np).to(dev), torch.from_numpy(
                r_np).to(dev)
            compare_batches(
                "classify", f"class edge inputs q{q} res_setting {rs}",
                lambda a, b, q=q, rs=rs: ds.classify_device(a, b, q, rs),
                lambda a, b, q=q, rs=rs: ds.classify_ref(a, b, q, rs),
                (p, rfc))
            got = ds.classify_device(p, rfc, q, rs)
            check(host_classify_equal(p, rfc, got, q, rs),
                  f"classify on the class edge inputs differs from the host "
                  f"C at q{q} res_setting {rs}")
            check(classify_edge_splits(p_np, r_np, got[0].cpu().numpy(),
                                       design, q, rs)
                  == classify_expected_splits(q, rs),
                  f"classify edge inputs: a class edge not crossed at q{q} "
                  f"res_setting {rs}")
    print("encode scans: classify equals its twin at batch 1, 3 and 16 and "
          "the host copy's C on the q20 ladder outputs and on the class "
          "edge inputs (every boundary the rules tell apart crossed at "
          "steps 7/8, 127/128, 247/248) at q20 and q21, res_setting 3, 4, "
          "6 and 8", flush=True)
    rs = host_encoder._res_setting(20)
    for what, gen in (("column-255 edge", col255_edge_inputs),
                      ("block edge", ladder_block_edge_inputs)):
        p_np, rfe_np = gen(B)
        p, rfe = (torch.from_numpy(p_np).to(dev),
                  torch.from_numpy(rfe_np).to(dev))
        compare_batches("column_ladder", f"{what} planes",
                        lambda a, b: ds.column_ladder_device(a, b, 20, rs),
                        lambda a, b: ds.column_ladder_ref(a, b, 20, rs),
                        (p, rfe))
        gp, grf = (t.cpu().numpy()
                   for t in ds.column_ladder_device(p, rfe, 20, rs))
        for k in range(B):
            hp, hrf = p_np[k].copy(), rfe_np[k, :SZ].reshape(256, 256).copy()
            residue.res256_column_ladder(hp, hrf, 20, rs,
                                         np.zeros((256, 256), np.int16),
                                         kernel_head=np.zeros(4, np.int16))
            check(np.array_equal(gp[k], hp) and np.array_equal(
                grf[k].reshape(256, 256), hrf),
                f"column_ladder: {what} image {k} differs from the host C")
    print("encode scans: S4-S6 equal their twins at batch 1, 3 and 16 on "
          "adversarial, delta (q17/18/20/21), column-255 and block-edge "
          "inputs, the edge planes' ladder also the host copy's C",
          flush=True)
    for name, rf in stream_edge_rfs(rng, 3).items():
        want_rf, want = host_positional_streams(rf, 21)
        got = torch.from_numpy(rf).to(dev)
        streams = {}
        for key, codes, word_bits, _ in des.RESIDUE_STREAMS:
            got, *s = ds.positional_stream_device(
                got, *des._stream_tables(codes), word_bits)
            streams[key] = (*s, word_bits)
        bad = sections_equal(des._residue_sections(streams), want)
        check(not bad and np.array_equal(got.cpu().numpy(), want_rf),
              f"positional streams on the {name} rfs differ from the host "
              f"copy's C at {bad[:8]}")
    print("encode scans: the res1/res3/res5 positional streams on the card "
          "equal the host copy's C on the no-code, every-position and "
          "isolated-marker rfs", flush=True)
    return out


# ---------------------------------------------------------------------------
# the device encode scans' LL2 stage: E16 (the Y LL2 byte coding and run-delta
# compression) and E17 (the chroma LL2 coding and compression)
# (models/device_encode_scans._y_ll2_stage, _uv_ll2_stage,
# _uv_highres_stage, _ll2_sections)

LL2_KERNELS = ("ll2_code_y", "walk_visited")
LL2_LAUNCHES = {"ll2_code_y": 1, "walk_visited": 3}
# q -> images whose host encodes are captured: the StreamCapture records of
# encode_phase at q20 (the batch of 16), q21, q17, q16, q8 and q1 (its
# batches of 4), and q15, captured inside encode_ll2_phase.  q > LOW3 marks
# and nudges, q > LOW5 escapes in three bytes: q20 and q21 take both, q17
# and q16 only the second, q15 and below neither
LL2_QS = {20: B, 21: 4, 17: 4, 16: 4, 15: 4, 8: 4, 1: 4}
# the functions' own operations, counted from the sources: an LL2 position
# of ll2_code_y (the marking window, the 2a test, the cross-row tests, the
# unmark); a position a walk stages (its jump) and a step it takes
LL2_OPS = 45
WALK_STAGE_OPS = 4
WALK_STEP_OPS = 4
# the device time of the one-thread S8 kernel this design replaced, on
# the q20 batch's walks (ms, profiler; NVIDIA H100 80GB HBM3 at 700 W), by n
S8_WAS_MS = {24641: 0.2172, 65536: 0.2209, 8272: 0.1602}
# S7's one-CTA-an-image kernel on the q20 LL2 planes, device [graph] / call
# ms (run 3, PR 13, PERF.md)
S7_WAS_MS = (0.1476, 0.1487, 0.2084)


def stack_ll2(records: list, q: int) -> dict:
    """The captured encodes' LL2 stage as batches: "P" and "Pz" (B, 512,
    512) int16, the plane ``ll2.ll2_code_y`` got and left; "u", "v" and
    "uz", "vz" (B, 256, 256) int16, the planes the C ``nhw_ll2_code_uv``
    got and left; "secs", each image's E16 and E17 sections as the host
    copy's encode stores them, in ``ll2_sections``'s keys; "hr_mem", each
    image's highres_mem."""
    from nhwcodec_tpu_torch.host import tables as T

    for r in records:
        check("ll2y" in r and "yhr" in r and "uvhr" in r
              and len(r.get("ll2uv", ())) == 2,
              "a captured host encode lacks part of its LL2 stage (the UV "
              "LL2 coding is captured through the host copy's C library)")
    st = {"P": np.stack([r["ll2y"]["in"] for r in records]),
          "Pz": np.stack([r["ll2y"]["out"] for r in records]),
          "hr_mem": [np.array(r["yhr"]["hr_mem"], np.int64)
                     for r in records], "secs": []}
    for c, key in enumerate("uv"):
        st[key] = np.stack([r["ll2uv"][c]["in"] for r in records])
        st[key + "z"] = np.stack([r["ll2uv"][c]["out"] for r in records])
    for r in records:
        ly, yh, uvs = r["ll2y"], r["yhr"], r["ll2uv"]
        sec = {"exw_Y": ly["exw"], "res_low": yh["res_low"],
               "highres_word": np.array(yh["hr_word"], np.uint8),
               "hrcomp_y": yh["ch"], "tree1_y": ly["tree1"],
               "exw_uv": [0, 0] + uvs[0]["exw"] + [0, 0] + uvs[1]["exw"],
               "ch_res_uv": r["uvhr"]["out"], "tree1_u": uvs[0]["tree1"],
               "tree1_v": uvs[1]["tree1"]}
        if q > T.LOW3:
            sec["res4"] = np.array(ly["res4"], np.uint8)
        if q > T.LOW5:
            sec["res_U_64"] = np.packbits((uvs[0]["tree1"] >> 1) & 1)
            sec["res_V_64"] = np.packbits((uvs[1]["tree1"] >> 1) & 1)
        check(np.array_equal(r["uvhr"]["in"], np.concatenate(
            [uvs[0]["tree1"], uvs[1]["tree1"]]) & 252),
              "the host's UV highres input is not its tree1_uv & 252")
        st["secs"].append(sec)
    return st


def ll2_sections_equal(got: list, want: list) -> list:
    """The (image, section) pairs where two lists of LL2 sections part,
    compared as integers."""
    bad = []
    for i, (g, w) in enumerate(zip(got, want)):
        for key in sorted(set(g) | set(w)):
            if key not in g or key not in w or not np.array_equal(
                    np.asarray(g[key], np.int64), np.asarray(w[key],
                                                             np.int64)):
                bad.append((i, key))
    return bad


def ll2_sections(y: dict, uv: dict) -> tuple:
    """Each image's E16 and E17 sections in one dict, and hr_mem
    (``_ll2_sections`` and ``_uv_ll2_sections``)."""
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    secs, mems = des._ll2_sections(y)
    for sec, uv_sec in zip(secs, des._uv_ll2_sections(uv)):
        sec.update(uv_sec)
    return secs, mems


def device_ll2_stage(args: tuple, q: int):
    """The port's LL2 stage on (P, U, V) device planes: E16 on Y, E17's
    head on U and V, then E17.  Returns (Pz, Uz, Vz, y, uv): the zeroed
    planes and the dicts ``ll2_sections`` slices."""
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    P, U, V = args
    Pz, y = des._y_ll2_stage(P, q)
    u = des._uv_ll2_stage(U, q)
    v = des._uv_ll2_stage(V, q)
    return Pz, u[0], v[0], y, des._uv_highres_stage(u, v, q)


def host_ll2_code_uv(process: np.ndarray) -> tuple:
    """The host copy's C ``nhw_ll2_code_uv`` on a (256, 256) int16 plane,
    in place, as ``encoder.encode_uv`` calls it: (tree1_uv, exw)."""
    from nhwcodec_tpu_torch.host import native

    lib, ffi = native._load(), native.ffi()
    tree1 = np.zeros(4096, np.uint8)
    exw = np.empty(3 * 4096, np.int32)
    n = ffi.new("long *")
    lib.nhw_ll2_code_uv(ffi.cast("int16_t *", process.ctypes.data),
                        ffi.cast("uint8_t *", tree1.ctypes.data),
                        ffi.cast("int32_t *", exw.ctypes.data), n)
    return tree1, exw[: n[0]].tolist()


def host_ll2_stage(st: dict, q: int) -> list:
    """The host copy's LL2 stage (its C) on the captured planes, image by
    image as ``encoder.encode_y``, ``encode_uv`` and ``encode`` run it:
    returns each image's zeroed planes, ch, hr_mem and the UV bytes."""
    from nhwcodec_tpu_torch.host.ops import ll2

    out = []
    for k in range(len(st["P"])):
        process = st["P"][k].copy()
        tree1, ch_res, _, _ = ll2.ll2_code_y(process, q)
        ch, _, _, hr_mem = ll2.y_highres_compression(tree1, ch_res, q)
        t1 = []
        for key in "uv":
            p = st[key][k].copy()
            t1.append(host_ll2_code_uv(p)[0])
        tail = ll2.uv_highres_compression(np.concatenate(t1) & 252)
        out.append((process, ch, hr_mem, tail))
    return out


def record_walks(fn) -> list:
    """The successor arrays ``fn()`` hands ``walk_visited_device``, in
    order (the Y walk, its squeeze walk, the UV walk for a stage)."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    seen, walk = [], ds.walk_visited_device

    def rec(nxt, start=1):
        seen.append(nxt.clone())
        return walk(nxt, start)

    ds.walk_visited_device = rec
    try:
        fn()
    finally:
        ds.walk_visited_device = walk
    return seen


def ll2_inputs(st: dict, dev) -> tuple:
    """The LL2 stage's captured inputs on ``dev``: (P, U, V)."""
    import torch

    return tuple(torch.from_numpy(st[k]).to(dev) for k in ("P", "u", "v"))


def encode_ll2_phase(dev, images: np.ndarray, captured: dict) -> dict:
    """The LL2 stage on the card (``_y_ll2_stage``, ``_uv_ll2_stage`` for U
    and V, ``_uv_highres_stage``, ``_ll2_sections``,
    ``_uv_ll2_sections``) once a batch on the
    planes captured from the host copy's own encodes: the encode batch's 16
    images at q20 and 4 images each at q21, q17, q16, q15 (captured here),
    q8 and q1.  Each batch's zeroed Y, U and V planes, every E16 section
    (exw_Y, res4, res_low, highres_word, hrcomp_y, tree1_y), hr_mem,
    tree1_uv, the UV exw continuation, res_U_64/res_V_64 and ch_res's UV
    tail byte for byte against the host's, with ll2_code_y launched once a
    batch and walk_visited three times.  Times the q20 batch's stage (CUDA
    events, median of RUNS; a profile) beside the host copy's C on the same
    planes (host timer, median of 5).  Returns the q20 batch's
    launches."""
    import torch

    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    with StreamCapture() as cap:
        for img in quality_batch(images, 15):
            host_encoder.encode(img, 15)
    captured[15] = cap.records
    out = None
    for q, want_b in LL2_QS.items():
        st = stack_ll2(captured[q], q)
        check(len(st["P"]) == want_b,
              f"q{q}: captured {len(st['P'])} host encodes, not {want_b}")
        args = ll2_inputs(st, dev)
        build.reset_launches()
        Pz, Uz, Vz, y, uv = device_ll2_stage(args, q)
        secs, mems = ll2_sections(y, uv)
        launches = {k: build.LAUNCHES[k] for k in LL2_KERNELS}
        check(launches == LL2_LAUNCHES,
              f"q{q}: LL2 stage launches {launches}, not {LL2_LAUNCHES}")
        for got, key in ((Pz, "Pz"), (Uz, "uz"), (Vz, "vz")):
            diff = np.argwhere(got.cpu().numpy() != st[key])
            check(diff.size == 0, f"q{q}: the LL2 stage's {key} plane "
                  f"differs from the host copy's at {diff[:8].tolist()}")
        bad = ll2_sections_equal(secs, st["secs"])
        check(not bad, f"q{q}: LL2 sections differ from the host copy's at "
              f"(image, section) {bad[:8]}")
        bad = [i for i, (g, w) in enumerate(zip(mems, st["hr_mem"]))
               if not np.array_equal(g, w)]
        check(not bad, f"q{q}: hr_mem differs from the host copy's for "
              f"images {bad}")
        print(f"encode scans: LL2 stage at q{q}, batch {want_b}, "
              "byte-identical to the host copy: the zeroed Y, U and V planes, "
              f"the {len(secs[0])} E16/E17 sections of each image (res_low "
              f"{[s['res_low'] for s in secs]}, hrcomp_y bytes "
              f"{[len(s['hrcomp_y']) for s in secs]}, UV tail bytes "
              f"{[len(s['ch_res_uv']) for s in secs]}, escapes "
              f"{[len(s['exw_Y']) // 3 for s in secs]}) and hr_mem "
              f"({[len(m) for m in mems]} entries); launches {launches}",
              flush=True)
        if q != 20:
            continue
        out = launches
        dev_ms = median_ms(lambda: device_ll2_stage(args, q))
        t0 = time.perf_counter()
        ll2_sections(y, uv)
        sec_ms = (time.perf_counter() - t0) * 1e3
        hout = host_ll2_stage(st, q)
        check(all(np.array_equal(p, st["Pz"][k]) and ch == st["secs"][k][
            "hrcomp_y"] and hm == list(st["hr_mem"][k]) and tail == st[
                "secs"][k]["ch_res_uv"]
                  for k, (p, ch, hm, tail) in enumerate(hout)),
              "the host copy's LL2 stage on the captured planes differs "
              "from its own encode")
        host = []
        for _ in range(5):
            t0 = time.perf_counter()
            host_ll2_stage(st, q)
            host.append((time.perf_counter() - t0) * 1e3)
        print(f"encode scans: LL2 stage (E16 + E17), batch {want_b} q20: "
              f"device {dev_ms:.4f} ms (CUDA events, median of {RUNS}), the "
              f"sections to the host {sec_ms:.2f} ms (host timer, once); host "
              f"copy's C {float(np.median(host)):.2f} ms (host timer, median "
              "of 5)", flush=True)
        print_profile(f"encode scans LL2 stage, batch {want_b} q20",
                      lambda: device_ll2_stage(args, q))
    return out


def ll2_edge_planes(rng, b, kind: str) -> np.ndarray:
    """(B, 512, 512) int16 planes for S7: "runs and marks" (odd-heavy
    values with odd 4-runs starting at columns 120..125, so ending at
    123..128, escapes at positions 0 and 1, and values just above and
    below 10000 and 20000 and int16 extremes, each between even
    neighbours: no mark or nudge reaches them, as none does in a real
    plane, where the host's C, which keeps the plane in int16, would
    wrap), "all even", or "dense odd" (every LL2 value odd and small: the
    most marks and nudges)."""
    if kind == "all even":
        return (rng.integers(-200, 600, (b, 512, 512)) * 2).astype(np.int16)
    if kind == "band edges":
        return ll2_band_edge_planes(rng, b)
    if kind == "dense odd":
        return rng.choice(np.array([1, 3, 5, 7, 9, -1, -3], np.int16),
                          (b, 512, 512))
    x = rng.integers(-40, 300, (b, 512, 512)).astype(np.int16)
    x[:, :131, :131] |= rng.choice(np.array([1, 1, 1, 0], np.int16),
                                   (b, 131, 131))
    for r, c in enumerate(range(120, 126)):
        x[:, 2 * r + 1, c - 2: c + 6] = (11, 2, 13, 15, 17, 19, 4, 6)
    big = np.array([10001, 10003, 9999, 20001, 20003, 19999, 32767, -32768,
                    16001, 24001], np.int16)
    for i in range(b):
        rows, cols = rng.integers(0, 131, 24), 3 * rng.integers(0, 44, 24)
        x[i, rows, cols] = rng.choice(big, 24)
        for c in (cols - 1, cols + 1):
            x[i, rows[c >= 0], c[c >= 0]] &= ~1
    x[:, 0, 0] = np.where(np.arange(b) % 2, 300, -7)
    x[:, 0, 1] = np.where(np.arange(b) % 2, -5, 256)
    return x


LL2_EDGE_KINDS = ("runs and marks", "all even", "dense odd", "band edges")
# S7's relay chains: columns j..j + 2 of every LL2 row hold odd, odd, even
# and column j - 1 even, so row r nudges (r + 1, j) exactly where its value
# there is odd, and a nudge makes the next row's value even
LL2_CHAIN_COLS = (3, 30, 62, 95)
LL2_RUN_STARTS = (121, 122, 123, 124)


def ll2_band_edge_planes(rng, b) -> np.ndarray:
    """(B, 512, 512) int16 planes for S7's bands: odd-heavy values, and in
    every LL2 row the relay chains of LL2_CHAIN_COLS (values 4, 3, 5, 6 at
    j - 1..j + 2, row 0's 3 made 2): row r nudges column j exactly when r
    is odd, so every band's exact entry (pend from row 8 b - 1, an odd
    row) holds the chains' nudges while a band walked from no pend exits
    with none, and each sweep of the relay makes one more band exact: as
    many sweeps as bands.  Odd 4-runs start at LL2_RUN_STARTS (ending at
    124..127, across the lanes' 4-column edges) in random rows, in the
    halo rows each CTA marks below its own (rows 16 c + 16..16 c + 18) and
    in rows 128-130, which stay unmarked."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    x = rng.integers(-40, 300, (b, 512, 512)).astype(np.int16)
    x[:, :131, :131] |= rng.choice(np.array([1, 1, 1, 0], np.int16),
                                   (b, 131, 131))
    rows = ds.LL // ds.LL2_CTAS
    halo = [r + k for r in range(rows, ds.LL + 1, rows) for k in range(3)]
    run_rows = sorted(set(halo) | set(rng.choice(ds.LL, 24,
                                                 replace=False).tolist()))
    for r in run_rows:
        c = int(rng.choice(LL2_RUN_STARTS))
        x[:, r, c: c + 4] = (101, 7, 9, 13)
    for j in LL2_CHAIN_COLS:
        x[:, :ds.LL + 3, j - 1: j + 3] = (4, 3, 5, 6)
        x[:, 0, j] = 2
    return x


def walk_edge_rows(rng, b, kind: str) -> np.ndarray:
    """(B, n) int32 successors for S8: "jumps of 65" (every jump 65, n =
    24641, parks from 16384 on as the Y walk's), "jumps 255/256" (jumps of
    255 and 256 at random), "long jumps" (random jumps up to 4096, and one
    row walking 1 -> 65535), "parks" (random jumps of 1-3 with a park, a
    successor >= n, at every position with probability 1/50, and a
    non-increasing successor in image 0)."""
    if kind == "jumps of 65":
        idx = np.arange(24641)
        row = np.where(idx < 16384, idx + 65, 24641)
        return np.broadcast_to(row, (b, 24641)).astype(np.int32).copy()
    n = 65536
    idx = np.arange(n)[None]
    if kind == "jumps 255/256":
        return (idx + rng.choice([255, 256], (b, n))).astype(np.int32)
    if kind == "long jumps":
        x = (idx + rng.integers(1, 4097, (b, n))).astype(np.int32)
        x[0, 1] = n - 1
        return x
    x = (idx + rng.integers(1, 4, (b, n))).astype(np.int32)
    park = rng.random((b, n)) < 0.02
    x[park] = n + rng.integers(0, 1 << 20, int(park.sum()))
    x[0, 1000] = 1000
    return x


def squeeze_edge_rows(rng, b, q_gt_low5: bool):
    """(B, 65536) successors of the Y coder's squeeze walk (device_scans.
    _squeeze_nodes) over byte buffers whose 64 and 128 codes sit at the
    bound: codes at n_ch - 4..n_ch - 1 (the last node can take a 64 or a
    128 whose bytes reach past it, or land exactly on n_ch - 1), n_ch from
    2 to 49153."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    ch = rng.choice(np.array([64, 128, 3, 70, 200], np.int32), (b, 65536))
    n_ch = rng.integers(2, 49154, b).astype(np.int32)
    n_ch[0] = 2
    for i in range(b):
        k = int(n_ch[i])
        ch[i, max(k - 4, 1): k] = rng.choice(np.array([64, 128], np.int32),
                                             min(4, k - 1))
    return ds._squeeze_nodes(torch.from_numpy(ch), torch.from_numpy(n_ch),
                             q_gt_low5)[3].numpy()


WALK_SEGMENT_KINDS = ("onto segment ends", "over many segments",
                      "park in segment 0", "n not a multiple of s", "n = 1",
                      "start in the last segment")


def walk_segment_rows(rng, b, kind: str) -> tuple:
    """(B, n) int32 successors and the start for S8's segmented walk (s =
    2^walk_segment_log2(n) nodes a segment): "onto segment ends" (n =
    65536: jumps onto a segment's first node, its last, the node past its
    first, or by one), "over many segments" (jumps of 2 s to 12 s among
    jumps of 1-8), "park in segment 0" (the walk from 1 parks at node 3 +
    i of row i, inside the first segment), "n not a multiple of s" (n =
    40007, its last segment 71 nodes; jumps of 1-300), "n = 1" (the one
    node, parked or not), "start in the last segment" (n = 65536, start
    65436, jumps of 1-5)."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    n = {"n not a multiple of s": 40007, "n = 1": 1}.get(kind, 65536)
    s = 1 << ds.walk_segment_log2(n)
    idx = np.arange(n)[None]
    start = 1 if n > 1 else 0
    if kind == "onto segment ends":
        first = (idx // s + 1) * s
        pick = rng.integers(0, 4, (b, n))
        x = np.select([pick == 0, pick == 1, pick == 2],
                      [first, np.maximum(first - 1, idx + 1), first + 1],
                      idx + 1)
    elif kind == "over many segments":
        x = idx + np.where(rng.random((b, n)) < 0.2,
                           rng.integers(2 * s, 12 * s, (b, n)),
                           rng.integers(1, 9, (b, n)))
    elif kind == "park in segment 0":
        x = idx + rng.integers(1, 3, (b, n))
        for i in range(b):
            x[i, 3 + i: 5 + i] = n + i
    elif kind == "n not a multiple of s":
        x = idx + rng.integers(1, 301, (b, n))
    elif kind == "n = 1":
        x = rng.integers(0, 3, (b, n))
    else:
        x = idx + rng.integers(1, 6, (b, n))
        start = n - 100
    return x.astype(np.int32), start


def ll2_kernel_phase(dev, captured: dict) -> dict:
    """S7 and S8 against their twins (max_abs_err 0): timed on the q20
    batch's captured inputs (ll2_code_y on the planes ll2_code_y got, both
    values of gt_low3; walk_visited on the stage's three walks: the Y walk
    (16, 24641), the squeeze (16, 65536) and the UV walk (16, 8272), each
    also at batch 1, 3 and 16); then at batch 1, 3 and 16
    (``compare_batches``) on S7's edge planes with gt_low3 both ways and
    S8's edge rows, squeeze rows whose 64/128 codes sit at the bound and
    segment edge rows (``walk_segment_rows``, each with its start)."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    out = {}
    st = stack_ll2(captured[20], 20)
    args = ll2_inputs(st, dev)
    P = args[0]
    ll_bytes = B * (2 * 131 * 131 + 5 * ds.LL_N)
    out["ll2_code_y"] = compare_and_time(
        "ll2_code_y", f"({B},512,512) int16, q20 LL2 planes",
        lambda: ds.ll2_code_y_scan(P, True),
        lambda: ds.ll2_code_y_ref(P, True), twin_calls=1, twin_runs=5,
        bound=work(ll_bytes, LL2_OPS * B * ds.LL_N), graph=True)
    was = S7_WAS_MS
    print(f"kernel ll2_code_y ({B},512,512) q20 LL2 planes: "
          f"{out['ll2_code_y']['graph_ms']:.4f} ms (graph of {GRAPH_CALLS} "
          f"calls, CUDA events), call {out['ll2_code_y']['ms']:.4f} ms; the "
          f"design before: {was[0]} [{was[1]}] / {was[2]} ms (PERF.md); "
          f"sweeps a plane {ds.ll2_code_y_sweeps(P, True).tolist()}",
          flush=True)
    compare_and_time("ll2_code_y", "gt_low3 off, q20 LL2 planes",
                     lambda: ds.ll2_code_y_scan(P, False),
                     lambda: ds.ll2_code_y_ref(P, False), timed=False)
    walks = record_walks(lambda: device_ll2_stage(args, 20))
    check(len(walks) == 3, f"the LL2 stage made {len(walks)} walks, not 3")
    shapes = {}
    for what, nxt in zip(("Y walk", "squeeze walk", "UV walk"), walks):
        b, n = nxt.shape
        steps = int(ds.walk_visited_device(nxt).sum())
        seg = 1 << ds.walk_segment_log2(n)
        shapes[f"({b},{n})"] = compare_and_time(
            "walk_visited", f"({b},{n}) int32, the q20 batch's {what} "
            f"({steps} steps; segments of {seg}, {-(-n // seg)} a row; was "
            f"{S8_WAS_MS.get(n, 'not measured')} ms)",
            lambda x=nxt: ds.walk_visited_device(x),
            lambda x=nxt: ds.walk_visited_ref(x), twin_calls=1, twin_runs=5,
            bound=work(5 * b * n, WALK_STAGE_OPS * b * n
                       + WALK_STEP_OPS * steps), graph=True)
        compare_batches("walk_visited", f"the q20 batch's {what}",
                        ds.walk_visited_device, ds.walk_visited_ref, (nxt,))
    out["walk_visited"] = shape_sums("walk_visited", shapes,
                                     f"({B},65536)")
    rng = np.random.default_rng(SEED + 50)
    for kind in LL2_EDGE_KINDS:
        x = torch.from_numpy(ll2_edge_planes(rng, B, kind)).to(dev)
        for gt in (True, False):
            compare_batches("ll2_code_y", f"{kind} planes, gt_low3 {gt}",
                            lambda a, gt=gt: ds.ll2_code_y_scan(a, gt),
                            lambda a, gt=gt: ds.ll2_code_y_ref(a, gt), (x,))
        sweeps = ds.ll2_code_y_sweeps(x, True).tolist()
        print(f"kernel ll2_code_y {kind} planes: sweeps a plane {sweeps}",
              flush=True)
        if kind == "band edges":
            check(sweeps == [ds.LL2_BANDS] * B, "ll2_code_y: the band edge "
                  f"planes took {sweeps} sweeps, not one a band")
            print(f"kernel ll2_code_y ({B},512,512) band edge planes "
                  f"({ds.LL2_BANDS} sweeps): "
                  f"{graph_ms(lambda: ds.ll2_code_y_scan(x, True)):.4f} ms "
                  f"(graph of {GRAPH_CALLS} calls, CUDA events)", flush=True)
    for kind in ("jumps of 65", "jumps 255/256", "long jumps", "parks"):
        x = torch.from_numpy(walk_edge_rows(rng, B, kind)).to(dev)
        compare_batches("walk_visited", f"{kind} rows",
                        ds.walk_visited_device, ds.walk_visited_ref, (x,))
    for g5 in (True, False):
        x = torch.from_numpy(squeeze_edge_rows(rng, B, g5)).to(dev)
        compare_batches("walk_visited", f"squeeze rows, codes at the bound "
                        f"(q_gt_low5 {g5})", ds.walk_visited_device,
                        ds.walk_visited_ref, (x,))
    for kind in WALK_SEGMENT_KINDS:
        nxt, start = walk_segment_rows(rng, B, kind)
        compare_batches("walk_visited", f"{kind} rows, start {start}",
                        lambda a, st=start: ds.walk_visited_device(a, st),
                        lambda a, st=start: ds.walk_visited_ref(a, st),
                        (torch.from_numpy(nxt).to(dev),))
    print("encode scans: S7 and S8 equal their twins at batch 1, 3 and 16 on "
          "the LL2 edge planes (the band edge planes included), the stage's "
          "three walks, the walk edge rows and the segment edge rows",
          flush=True)
    return out


# ---------------------------------------------------------------------------
# the device encode scans composed: encode_batch_device(scans_on_device=True)
# (models/device_encode_scans.encode_batch_scans_device) with the chroma
# ladders (uv_compare_ladder_device, torch ops; uv_sentinel_marking_device,
# S9 uv_sentinel in csrc/uv.cu)

UV_RF_EXT = 16384 + 512    # res256 and the tail the sentinel marking reads
# q -> images of the encode batch encoded with the option on: the 16 of the
# q20 batch, 4 each (quality_batch) at q21, q19, q18 and q17, LOW4_QS and
# VLQ_QS
SCANS_DEVICE_QS = {20: B, 21: 4, 19: 4, 18: 4, 17: 4, 16: B, 15: 4, 14: 4,
                   13: 4, 12: 4, 11: 4, 8: 4, 1: 4}
# the calls timed in turns against the option off: q -> images
SCANS_DEVICE_TIMED = {20: B, 16: B, 13: 4, 8: 4}
SCANS_DEVICE_TURNS = 3
# the sentinel marking's operations a lane, counted from csrc/uv.cu (the
# two decisions' compares and selects, the run parity, the writes)
UVSM_OPS = 40
# S9's one-CTA-an-image kernel on the q20 U planes, device [graph] / call
# ms (run 2, PR 14, PERF.md; its device time was not measured)
S9_WAS_MS = (None, 0.0755, 0.0997)
UVSM_KINDS = ("drift", "d0 -5", "bands taken", "pair runs", "cta edges",
              "no drift")


def scans_device_launches(q: int) -> dict:
    """The kernel launches of one encode_batch_device(scans_on_device=True)
    call at quality q (1 <= q <= HIGH1): the front's K6 (q >= NORM), K4
    (Y's two levels, U + V's two) and K5 (q > LOW14), the stream, residue
    and LL2 stages' S1-S8 (at q <= LOW4 S10 in S2's place and no S4; at q
    <= LOW8 no E12: no S5, S6), S9 for U and V at q >= LOW2, S11 below
    LOW6, S12 below LOW7, S13 and S14 (U and V) at q <= LOW9."""
    from nhwcodec_tpu_torch.host import tables as T

    low4, e12, low9 = q <= T.LOW4, int(q > T.LOW8), q <= T.LOW9
    return {"colorspace_down420": int(q >= T.NORM), "analysis_level_jp": 4,
            "requant_tail": int(q > T.LOW14), **SCAN_LAUNCHES,
            "offset_y": int(not low4), **RESIDUE_LAUNCHES,
            "pair_promotion": int(not low4), "column_ladder": e12,
            "classify": e12, **LL2_LAUNCHES,
            "uv_sentinel": 2 if q >= T.LOW2 else 0,
            "offset_y_low4": int(low4),
            "lowest_q_band_cleanup": int(q < T.LOW6),
            "very_low_q_cleanup": int(q < T.LOW7),
            "low_q_ll1_cleanup": int(low9), "uv_ll_smooth": 2 * low9}


def scans_device_streams(q: int) -> int:
    """The positional streams (torch ops) of one call at quality q: res1
    above LOW8, res3 from LOW1, res5 from HIGH1; none at q <= LOW8."""
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    return sum(q >= q_min for *_, q_min in des.RESIDUE_STREAMS)


def stack_uv(records: list) -> dict:
    """The captured encodes' chroma ladders as batches, for U (0) and V
    (1): "cl" [(jpeg, process (B, 256, 256), res256 (B, 128, 128), oob0
    (B,), strict, the jpeg the host left)], and where every record has
    them (q >= LOW2) "sm" [(process (B, 256, 256), rf_ext (B, 16896),
    res_uv, the process the host left)]."""
    for r in records:
        check(len(r.get("uvcl", ())) == 2,
              "a captured host encode lacks its compare ladders")
    st = {"cl": [], "sm": []}
    for c in (0, 1):
        cl = [r["uvcl"][c] for r in records]
        st["cl"].append(tuple(np.stack([x[k] for x in cl]) for k in (
            "jpeg", "process", "res256")) + (
            np.array([x["oob0"] for x in cl], np.int16), cl[0]["strict"],
            np.stack([x["out"] for x in cl])))
        if all(len(r.get("uvsm", ())) == 2 for r in records):
            sm = [r["uvsm"][c] for r in records]
            st["sm"].append((np.stack([x["process"] for x in sm]),
                             np.stack([x["rf_ext"] for x in sm]),
                             sm[0]["res_uv"],
                             np.stack([x["out"] for x in sm])))
    return st


def uv_sentinel_edge_inputs(rng, b, kind: str) -> tuple:
    """(process (B, 256, 256) int16, rf_ext (B, 16896) int16) for S9.
    "drift": each row built against the window it will read (count_start
    tracked), lanes 1..125 random; rows r % 4 in (0, 2): lanes 0 and 126
    neutral, lane 127 places a pair (d0 5, d1 4, its band 0 slot free);
    r % 4 == 1: lane 0 writes 12900 into column 128 and res256 at lane
    127's r1 is 12896, so only the written value makes lane 127's pair;
    r % 8 == 3: column 128's initial value would make lane 127's pair, and
    lane 0's write takes it away; r % 8 == 7: lane 126 places a pair, so
    lane 127 is skipped.  96 rows drift, so the last rows read the oob
    tail and the zeros past res256.  The other kinds hold res256 at a
    constant c: "d0 -5" (most lanes d0 = -5, d1 on both sides of 0),
    "bands taken" (rows whose band 0, bands 0-1 or all three slots are
    taken), "pair runs" (rows of 128 pair candidates with free slots, of 127
    from lane 1, and runs of 31, 32 and 33 across the warps' edges)."""
    proc = rng.integers(-12, 13, (b, 256, 256)).astype(np.int16)
    rf = np.zeros((b, UV_RF_EXT), np.int16)
    rf[:, 16384: 16388] = rng.integers(-20, 21, (b, 4))
    if kind in ("cta edges", "no drift"):
        return uv_sentinel_row_inputs(rng, proc, rf, kind == "cta edges")
    if kind == "drift":
        rf[:, :16384] = rng.integers(-20, 21, (b, 16384))
        for i in range(b):
            p, f, cs = proc[i], rf[i], 0
            for r in range(128):
                mode = r % 4 if r % 4 != 3 else (3 if r % 8 == 3 else 4)
                if mode == 1:
                    f[cs + 128] = 12896
                elif mode == 3:
                    f[cs + 128] = -1
                d = rng.integers(-9, 10, 129)
                d[0] = 10 if mode in (1, 3) else 0
                d[125:129] = ((0, 0, 5, 4) if mode != 4 else (0, 5, 4, 0))
                p[r, :129] = f[cs: cs + 129] + d
                if mode in (1, 3):
                    p[r, 128] = 3               # lane 0's free slot
                p[r, 254:256] = 0               # lanes 126, 127 free
                cs += 128 + (mode in (0, 1, 2))
        return proc, rf
    c = rng.integers(-10, 3, (b, 1, 1))
    rf[:, :16384] = np.broadcast_to(c.reshape(b, 1), (b, 16384))
    if kind == "d0 -5":
        d = rng.choice(np.array([-5, -5, -5, -5, -2, -1, 0, 1, 2, -3, -4,
                                 5]), (b, 128, 129))
    else:
        d = rng.integers(-9, 10, (b, 128, 129))
    if kind == "pair runs":
        d[:, 0::4] = 5
        d[:, 1::4] = 5
        d[:, 1::4, 0] = 0
        d[:, 2::4, :] = 0
        for lo, hi in ((20, 51), (56, 88), (92, 125)):   # candidates lo..hi
            d[:, 2::4, lo: hi + 1] = 5
        proc[:, 0:128:4, 128:] = 0
        proc[:, 1:128:4, 128:] = 0
    proc[:, :128, :129] = (c + d).astype(np.int16)
    if kind == "bands taken":
        # rows 0 mod 3: band 0 taken; 1 mod 3: bands 0-1; 2 mod 3: all three
        taken = np.array([8, -8, 9, 300, -300])
        for k in range(3):
            for r0, c0 in ((0, 128), (128, 0), (128, 128))[: k + 1]:
                blk = proc[:, r0: r0 + 128, c0: c0 + 128][:, k::3]
                blk[:] = rng.choice(taken, blk.shape)
    return proc, rf


def uv_drift_rows(edges: bool) -> set:
    """The rows that drift in uv_sentinel_row_inputs: with ``edges``, the
    last row of each CTA of S9's cluster and the first of the next (15/16,
    31/32, .., 111/112), else none."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    rows = ds.UVSM_CTA_ROWS
    return ({r for c in range(1, ds.UVSM_CTAS) for r in (c * rows - 1,
                                                          c * rows)}
            if edges else set())


def uv_sentinel_row_inputs(rng, proc, rf, edges: bool) -> tuple:
    """S9's "cta edges" and "no drift" inputs on ``proc`` and ``rf``
    (uv_sentinel_edge_inputs): res256 random, each row built against the
    window it reads (count_start tracked), lanes 1..124 random; the rows of
    ``uv_drift_rows(edges)`` place a pair at lane 127 (d0 5, d1 4, lanes 0,
    125 and 126 neutral, lane 127's band 0 slot free), and every other row
    has d0 = 0 at lane 127, so it never drifts."""
    b = len(proc)
    drifting = uv_drift_rows(edges)
    rf[:, :16384] = rng.integers(-20, 21, (b, 16384))
    for i in range(b):
        p, f, cs = proc[i], rf[i], 0
        for r in range(128):
            d = rng.integers(-9, 10, 129)
            if r in drifting:
                d[0] = 0
                d[125:129] = (0, 0, 5, 4)
                p[r, 254:256] = 0
            else:
                d[127] = 0
            p[r, :129] = f[cs: cs + 129] + d
            cs += 128 + (r in drifting)
    return proc, rf


def uv_ladder_edge_inputs(rng, b) -> tuple:
    """(jpeg, process (B, 256, 256), res256 (B, 128, 128) int16, oob0 (B,)
    int16) for the compare ladder: differences scan in [-12, 12], one in
    three at +-3, the next one 0 as often; column 128 one past each row
    and, at the last position, oob0, so that nxt there is -1, 0 or 1."""
    jpeg = rng.integers(-32768, 32768, (b, 256, 256)).astype(np.int16)
    proc = rng.integers(-300, 300, (b, 256, 256)).astype(np.int16)
    r256 = rng.integers(-50, 51, (b, 128, 128)).astype(np.int16)
    scan = rng.integers(-12, 13, (b, 128, 128))
    pick = rng.integers(0, 3, scan.shape)
    scan = np.where(pick == 0, rng.choice([-3, 3], scan.shape),
                    np.where(pick == 1, 0, scan))
    scan[:, 127, 127] = np.where(np.arange(b) % 2, 3, -3)
    proc[:, :128, :128] = r256 + scan
    oob0 = rng.integers(-30, 31, b).astype(np.int16)
    nxt0 = np.roll(r256.reshape(b, -1), -1, 1).reshape(b, 128, 128)[:, :, 0]
    nxt0[:, 127] = oob0
    proc[:, :128, 128] = nxt0 + rng.integers(-1, 2, (b, 128))
    return jpeg, proc, r256, oob0


def host_uv_sentinel(process: np.ndarray, rf_ext: np.ndarray,
                     res_uv: int) -> np.ndarray:
    """The host copy's C sentinel marking on each image, as ``encode_uv``
    calls it (res256 and the oob tail from rf_ext)."""
    from nhwcodec_tpu_torch.host.models import encoder

    out = process.copy()
    for k in range(len(out)):
        encoder._uv_sentinel_marking(out[k], rf_ext[k, :16384], 20, res_uv,
                                     rf_ext[k, 16384:])
    return out


def encode_scans_device_phase(dev, images: np.ndarray,
                              captured: dict) -> dict:
    """encode_batch_device(scans_on_device=True) on the card: the encode
    batch's 16 images at q20 and at q16 in one call each (the 11
    fixtures also against STREAM_SHA256) and 4 each at q21, q19, q18,
    q17, q15, q14, q13, q12, q11, q8 and q1, every stream byte for byte
    against the host copy's encoder.encode, with the launches of each call
    (scans_device_launches: S9 twice at q >= 18, never below; S10 in S2's
    place and no S4 at q <= 16; S11 below q14; S12 below q13; no S5, S6
    or positional stream at q <= 12; S13 once and S14 twice at q <= 11;
    K5 above q6); q0 and q22 raise ValueError.  The host encodes at
    LOW4_QS and VLQ_QS run under a StreamCapture, whose records go into
    ``captured``.  Times the SCANS_DEVICE_TIMED calls in
    SCANS_DEVICE_TURNS turns against the option off in one chunk and
    through the default pool, splits the on path's wall at q20, q16 and
    q8 (host_breakdown, each device stage synchronised at its end) and
    profiles one q20 call.  Returns each quality's launches."""
    import torch

    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.host.ops import entropy_enc
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds
    from nhwcodec_tpu_torch.models import device_stages as tds
    from nhwcodec_tpu_torch.models import encoder as tenc
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    def on(imgs, q):
        return tdp.encode_batch_device(imgs, q, device=dev,
                                       scans_on_device=True)[0]

    names = list(fixture_generators())
    out, wants = {}, {}
    for q, want_b in SCANS_DEVICE_QS.items():
        sel = images if want_b == B else quality_batch(images, q)
        with StreamCapture() as cap:
            want = [host_encoder.encode(img, q) for img in sel]
        if q in LOW4_QS or q in VLQ_QS:
            captured[q] = cap.records
        n_streams = []
        stream_fn = ds.positional_stream_device
        ds.positional_stream_device = lambda *a: n_streams.append(
            1) or stream_fn(*a)
        build.reset_launches()
        try:
            got = on(sel, q)
        finally:
            ds.positional_stream_device = stream_fn
        torch.cuda.synchronize()
        want_l = scans_device_launches(q)
        launches = {k: build.LAUNCHES[k] for k in want_l}
        check(launches == want_l, f"scans on device q{q}: launches "
              f"{launches}, not {want_l}")
        check(len(n_streams) == scans_device_streams(q),
              f"scans on device q{q}: {len(n_streams)} positional streams, "
              f"not {scans_device_streams(q)}")
        bad = [i for i, (g, w) in enumerate(zip(got, want)) if g != w]
        check(len(got) == want_b and not bad, f"scans on device q{q}: "
              f"streams {bad} differ from the host copy's encoder")
        pinned = ([(n, q) for n in names] if want_b == B
                  else [(fixture_for(q), q)])
        pinned = [(i, key) for i, key in enumerate(pinned)
                  if key in STREAM_SHA256]
        check(all(sha256(got[i]) == STREAM_SHA256[key]
                  for i, key in pinned),
              f"scans on device q{q}: a fixture's stream differs from the "
              "pinned digest")
        print(f"encode scans on device: q{q}, batch {want_b} in one call, "
              f"byte-identical to the host copy's encoder ({len(pinned)} "
              "also to the pinned digests of nhwcodec_tpu.encode); launches "
              f"{launches}; {len(n_streams)} positional streams", flush=True)
        out[q], wants[q] = launches, want
    for q in (0, T.HIGH2):
        try:
            on(images[:1], q)
        except ValueError as e:
            check(f"1 <= q <= {T.HIGH1}" in str(e),
                  f"scans on device q{q}: message {e!r}")
            print(f"encode scans on device: q{q} raises "
                  f"{type(e).__name__}: {e}", flush=True)
        else:
            check(False, f"scans on device q{q} did not raise")

    for q, nb in SCANS_DEVICE_TIMED.items():
        imgs = images if nb == B else quality_batch(images, q)
        runs = {"option on, one call": lambda: on(imgs, q),
                f"option off, one chunk of {nb}": lambda:
                tdp.encode_batch_device(imgs, q, workers=1, chunk=nb,
                                        device=dev)[0],
                f"option off, default pool ({os.cpu_count()} workers)":
                lambda: tdp.encode_batch_device(imgs, q, device=dev)[0]}
        walls = {k: [] for k in runs}
        for turn in range(SCANS_DEVICE_TURNS):
            keys = list(runs)[turn:] + list(runs)[:turn]
            for k in keys:
                t0 = time.perf_counter()
                got = runs[k]()
                walls[k].append((time.perf_counter() - t0) * 1e3)
                check(got == wants[q], f"q{q} {k}: streams differ")
        for k, w in walls.items():
            print(f"encode scans on device, batch {nb} q{q} wall, {k}: "
                  + ", ".join(f"{x:.2f}" for x in w) + f" ms (median "
                  f"{float(np.median(w)):.2f}, "
                  f"{float(np.median(w)) / nb:.2f} ms/img; turns of "
                  f"{SCANS_DEVICE_TURNS}, orders rotated)", flush=True)

    def synced(f):
        def run(*a, **k):
            r = f(*a, **k)
            torch.cuda.synchronize()
            return r
        return run

    stages = [(des, n, "device stream stage")
              for n in ("_y_stream_stage", "_uv_stream_stage")]
    stages += [(des, n, "device residue stage") for n in (
        "_y_residue_stage",)]
    stages += [(des, n, "device LL2 stage") for n in (
        "_y_ll2_stage", "_uv_ll2_stage", "_uv_highres_stage")]
    stages += [(ds, n, "device UV ladders (compare ladder, S9)") for n in (
        "uv_compare_ladder_device", "uv_sentinel_marking_device")]
    stages += [(ds, n, "device cleanups below q13 (S12-S14)") for n in (
        "very_low_q_cleanup_device", "low_q_ll1_cleanup_device",
        "uv_ll_smooth_device")]
    targets = [(tds, "encode_front", "front (colorspace, pre-filter, "
                "analysis, requant)"),
               (des, "_host_e10", "host E10 part-0 offset + synthesis"),
               (des, "_kernel_slices", "host kernel slices"),
               (des, "_host_uv_ladder_in", "host UV greedy steps"),
               (des, "_host_uv_marking_in", "host UV greedy steps"),
               *stages,
               *((des, n, "section copies to the host") for n in (
                   "_ll2_sections", "_residue_sections",
                   "_uv_ll2_sections")),
               (entropy_enc, "wavlts2packet_tokenize", "host tokenizer"),
               (tenc, "finish_deferred", "pack (device packer + container)"),
               (tds, "to_device", "host->device copies")]
    saved = [(m, n, getattr(m, n)) for m, n, _ in stages]
    try:
        for m, n, f in saved:
            setattr(m, n, synced(f))
        for q in (20, 16, 8):
            print_breakdown(
                f"encode scans on device breakdown, batch {B} q{q} in one "
                "call (each device stage synchronised at its end)",
                *host_breakdown(lambda: on(images, q), targets,
                                ("host kernel slices",)))
    finally:
        for m, n, f in saved:
            setattr(m, n, f)
    print_profile(f"encode scans on device, batch {B} q20 in one call",
                  lambda: on(images, 20))
    return out


def uv_kernel_phase(dev, captured: dict) -> dict:
    """S9 against its twin (max_abs_err 0) and the host copy's C, timed on
    the U planes captured from the q20 batch's host encodes, untimed on the
    V planes and at q21, q19 and q18 (res_uv 4; the q17 encodes skip the
    marking); at batch 1, 3 and 16 on uv_sentinel_edge_inputs with res_uv
    4 and 5.  The compare ladder on the card against the host copy's C on
    the captured planes (strict both ways) and uv_ladder_edge_inputs."""
    import torch

    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.models import device_scans as ds

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = None
    for q in (20, 21, 19, 18):
        st = stack_uv(captured[q])
        if q == 20:
            st20 = st
        check(len(st["sm"]) == 2, f"q{q}: no captured sentinel marking")
        for c, (proc, rf, res_uv, want) in enumerate(st["sm"]):
            P, R = t(proc), t(rf)
            got = ds.uv_sentinel_marking_device(P, R, res_uv)
            check(np.array_equal(got.cpu().numpy(), want),
                  f"uv_sentinel q{q} {'UV'[c]}: differs from the host "
                  "copy's C")
            what = (f"({len(proc)},256,256) + ({len(proc)},{rf.shape[1]}) "
                    f"q{q} {'UV'[c]} planes, res_uv {res_uv}, rounds (sweeps)"
                    f" a plane {ds.uv_sentinel_sweeps(P, R, res_uv).tolist()}")
            nbytes = P.numel() * 4 + R.numel() * 2
            res = compare_and_time(
                "uv_sentinel", what,
                lambda: ds.uv_sentinel_marking_device(P, R, res_uv),
                lambda: ds.uv_sentinel_marking_ref(P, R, res_uv),
                timed=q == 20 and c == 0, twin_calls=1, twin_runs=5,
                bound=work(nbytes, UVSM_OPS * len(proc) * 16384),
                graph=True)
            if res:
                was = S9_WAS_MS
                print(f"kernel uv_sentinel {what}: {res['graph_ms']:.4f} ms "
                      f"(graph of {GRAPH_CALLS} calls, CUDA events), call "
                      f"{res['ms']:.4f} ms; the design before: "
                      f"{was[0] or 'n.m.'} [{was[1]}] / {was[2]} ms "
                      "(PERF.md)", flush=True)
            out = out or res
        for c, (jpeg, proc, r256, oob0, strict, want) in enumerate(st["cl"]):
            got = ds.uv_compare_ladder_device(t(jpeg), t(proc), t(r256),
                                              t(oob0), strict)
            check(np.array_equal(got.cpu().numpy(), want),
                  f"compare ladder q{q} {'UV'[c]}: differs from the host "
                  "copy's C")
    jpeg, proc, r256, oob0 = (t(x) for x in st20["cl"][0][:4])
    for strict in (False, True):
        ms = median_ms(lambda: ds.uv_compare_ladder_device(
            jpeg, proc, r256, oob0, strict))
        print(f"uv_compare_ladder_device (torch ops), q20 U planes batch "
              f"{len(jpeg)}, strict {strict}: {ms:.4f} ms a call (CUDA "
              f"events, median of {RUNS})", flush=True)
    print_profile(f"uv_compare_ladder_device, q20 U planes batch {B}",
                  lambda: ds.uv_compare_ladder_device(jpeg, proc, r256,
                                                      oob0, False))
    rng = np.random.default_rng(SEED + 60)
    jpeg, proc, r256, oob0 = uv_ladder_edge_inputs(rng, B)
    for strict in (False, True):
        got = ds.uv_compare_ladder_device(t(jpeg), t(proc), t(r256),
                                          t(oob0), strict).cpu().numpy()
        for k in range(B):
            want = jpeg[k].copy()
            encoder._uv_compare_ladder(want, proc[k].copy(), r256[k],
                                       strict, int(oob0[k]))
            check(np.array_equal(got[k], want), f"compare ladder edge "
                  f"image {k}, strict {strict}: differs from the host C")
    for kind in UVSM_KINDS:
        proc, rf = uv_sentinel_edge_inputs(rng, B, kind)
        for res_uv in (4, 5):
            P, R = t(proc), t(rf)
            compare_batches("uv_sentinel", f"{kind} planes, res_uv {res_uv}",
                            lambda a, b: ds.uv_sentinel_marking_device(
                                a, b, res_uv),
                            lambda a, b: ds.uv_sentinel_marking_ref(
                                a, b, res_uv), (P, R))
            got = ds.uv_sentinel_marking_device(P, R, res_uv).cpu().numpy()
            check(np.array_equal(got, host_uv_sentinel(proc, rf, res_uv)),
                  f"uv_sentinel {kind} planes, res_uv {res_uv}: differ from "
                  "the host copy's C")
        sweeps = ds.uv_sentinel_sweeps(P, R, 4).tolist()
        print(f"kernel uv_sentinel {kind} planes: rounds (sweeps) a plane "
              f"{sweeps}", flush=True)
        if kind in ("cta edges", "no drift"):
            drifts = uv_drift_rows(kind == "cta edges")
            check(all(np.flatnonzero(np.isin(g[:128, 255], (12400, 12600)))
                      .tolist() == sorted(drifts) for g in got),
                  f"uv_sentinel {kind} planes: lane 127 placed elsewhere "
                  f"than rows {sorted(drifts)}")
            check(kind == "cta edges" or sweeps == [1] * B,
                  f"uv_sentinel: the planes without drift took {sweeps} "
                  "sweeps")
        if kind in ("drift", "cta edges"):
            ms = graph_ms(lambda: ds.uv_sentinel_marking_device(P, R, 4))
            print(f"kernel uv_sentinel ({B},256,256) {kind} planes: "
                  f"{ms:.4f} ms (graph of {GRAPH_CALLS} calls, CUDA events)",
                  flush=True)
    print("encode scans: S9 equals its twin and the host copy's C on the "
          "captured q20/q21/q19/q18 planes and at batch 1, 3 and 16 on the "
          f"{', '.join(UVSM_KINDS)} planes; the compare ladder on the card "
          "equals the host copy's C on the captured planes and the edge "
          "planes, strict both ways", flush=True)
    return {"uv_sentinel": out}


# ---------------------------------------------------------------------------
# the device encode scans' low-q programs at q13..q16: S10 offset_y_low4
# (csrc/scans.cu), S11 lowest_q_band_cleanup (csrc/lowq.cu) and the low56
# cleanup (torch ops), in models/device_scans.py

LOW4_KERNELS = ("offset_y_low4", "lowest_q_band_cleanup")
# q -> images of the encode batch encoded with the option on at q <= LOW4,
# whose host encodes encode_scans_device_phase captures: the 16 at q16, 4
# each (quality_batch) at q15, q14 (low56) and q13 (LOW7, the lowest-q
# cleanup)
LOW4_QS = {16: B, 15: 4, 14: 4, 13: 4}
# the functions' own operations, counted from the sources: a position of
# pass 4 with the duty cycles (scans.cu oy4_step: the code map of a value,
# 24 as in OFFSET_Y_PASS4_OPS; the quant and quant6 tests and updates, 10;
# the quant4 pair rule's test and counter, 15; the fixups' tests and the
# pair rule's writes are not counted), which offset_y_low4 runs after pass
# 1 (OFFSET_Y_PASS1_OPS); a visit of the lowest-q cleanup (LQ_VISITS an
# image: loop A's 256 x 256, B + C's 256 x 511)
OY4_OPS = 49
LQ_OPS = 30
LQ_VISITS = 256 * 256 + 256 * 511
OY4_KINDS = ("random", "row ends", "row starts", "tile edges", "tick runs",
             "row chains")
OY4_VALUES = np.array([0, 7, -7, 8, -8, 9, -9, 12, -12, 13, -13, 14, -14,
                       15, -15, 22, -22, 23, -23, 30, -30, 31, -31, 38, 39,
                       46, 47, 6, -6, 200, -300, 10100, 12900, 14000],
                      np.int16)
LQ_KINDS = ("random", "pairR chain", "pairL column 0", "A into row 256",
            "r3 tail", "lane edges", "row chain")


def lowq_r3_ext(resIII, ktail, tree1) -> np.ndarray:
    """(ds.LQ_R3_EXT,) int16, as the host encoder's
    ``_lowest_q_band_cleanup`` builds it: resIII, then the tail its last
    rows read: ktail (the free-time kernel's [131080:131084]), the tree1
    chunk's size field 24593, and tree1's first 496 bytes as int16
    pairs."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    r3 = np.zeros(ds.LQ_R3_EXT, np.int16)
    r3[:SZ] = np.asarray(resIII).reshape(-1)
    r3[SZ: SZ + 4] = ktail
    r3[SZ + 4] = 24593
    t = np.asarray(tree1)[:496].astype(np.uint16)
    r3[SZ + 8:] = (t[0::2] | (t[1::2] << 8)).view(np.int16)
    return r3


def oy4_edge_planes(rng, b, kind: str) -> np.ndarray:
    """(B, 512, 512) int16 planes for S10.  "random": OY4_VALUES, which
    reach the -9/-8/9 fixups, the duty cycles (-15, -23, -31), the quant4
    pair rule (v >= 14 with (v & 510) & 7 == 6), escapes and sentinels.
    "row ends": rows of |v| <= 6 (no pair rule, fixup or counter) whose
    column 511 and the next row's column 0 hold a pair the quant4 rule
    takes, by row % 5: 31/22 (the next row's 22 becomes 24), 23/30 (23
    becomes 25, 28 pending), 30/31 (31 becomes 33), 22/31 (22 becomes 24,
    29 pending), none; quant4 advances only there, so every third pair
    fires, each kind in turn, and its write crosses the row end.  "row
    starts": rows of values in [-6, 0] whose columns 0 and 1 hold -15 and
    -23, with 1 + r % 6 -15s and 1 + r % 4 -23s in all, so quant and
    quant6 end most rows nonzero: only the reset at each row start masks
    columns 0 and 1 (codes 120 and 112; unmasked, 112 and 104).  The
    kinds of S10's lane tiles (16 columns a lane): "tile edges": rows of
    |v| <= 6 whose columns e - 1, e, e + 1 at every tile edge e hold, by
    (e / 16 + r) % 6, a fixup pending across the edge (-14, -7: -9; 8, -7:
    -8; 14, 7: 9), a pair for the quant4 rule (23, 30: up; 31, 22, 0:
    down, r2 false) or nothing, so lanes enter in every state; "tick
    runs": rows of 0 with runs of -15 or -23 (ticks of quant, quant6)
    across every other tile edge, of 6, 4, 13, 9, 1 and 24 in turn;
    "row chains": row 0 fires the pair rule at column 511 (quant4 0
    there), and every later row enters with a quant4 write pending at
    column 0 (state 3 or 4 of the row maps), advances quant4 twice (30, 31
    at columns 300 and 400) and fires the pair rule at column 511 into the
    next row again (31 | 22: down, 23 | 30: up, alternating)."""
    if kind == "random":
        return rng.choice(OY4_VALUES, (b, 512, 512))
    if kind == "tile edges":
        x = rng.integers(-6, 7, (b, 512, 512)).astype(np.int16)
        pats = ((-14, -7, 0), (8, -7, 0), (14, 7, 0), (23, 30, 0),
                (31, 22, 0), (0, 0, 0))
        for r in range(512):
            for e in range(16, 512, 16):
                x[:, r, e - 1: e + 2] = pats[(e // 16 + r) % 6]
        return x
    if kind == "tick runs":
        x = np.zeros((b, 512, 512), np.int16)
        for r in range(512):
            for k, e in enumerate(range(32, 512, 32)):
                n = (6, 4, 13, 9, 1, 24)[(k + r) % 6]
                x[:, r, e - n // 2: e - n // 2 + n] = (-15, -23)[(k + r) % 2]
        return x
    if kind == "row chains":
        x = rng.integers(-6, 7, (b, 512, 512)).astype(np.int16)
        x[:, :, 1] = 0
        x[:, 1:, 300: 302] = x[:, 1:, 400: 402] = (30, 31)
        for r in range(511):
            x[:, r, 511], x[:, r + 1, 0] = ((31, 22), (23, 30))[r % 2]
        return x
    if kind == "row ends":
        x = rng.integers(-6, 7, (b, 512, 512)).astype(np.int16)
        for r in range(511):
            if r % 5 < 4:
                x[:, r, 511], x[:, r + 1, 0] = ((31, 22), (23, 30), (30, 31),
                                                (22, 31))[r % 5]
        return x
    x = rng.integers(-6, 1, (b, 512, 512)).astype(np.int16)
    x[:, :, 0], x[:, :, 1] = -15, -23
    for r in range(512):
        x[:, r, 10: 10 + 10 * (r % 6): 10] = -15
        x[:, r, 300: 300 + 10 * (r % 4): 10] = -23
    return x


def lowq_edge_inputs(rng, b, kind: str) -> tuple:
    """(plane (B, 512, 512), r3_ext (B, ds.LQ_R3_EXT)) int16 for S11 at
    the LOW7 thresholds (15, 27, 10, 6, 3).  "random": values in [-40, 40],
    r3 in [-20, 20].  The others: r3 at +-50..200 (no r3 zeroing) and a
    plane of |v| <= 2 (no candidate) but for: "pairR chain": rows 256,
    258, .., 510 end 0, 16, -15 (pairR at 510 zeroes 511) and the next row
    starts 15, 0, which only the chained left neighbour 0 keeps (-15
    would make a pairL); "pairL column 0": rows 255, 257, .., 509 end 0,
    -15 and the next row starts 15, 0: pairL at column 0 zeroes the
    previous row's column 511 (row 255's in loop A's region); "A into
    row 256": rows 0..255 end 0, 11 and the next row starts -12 (row 256:
    -12, 100), so loop A's pairR at column 511 zeroes the next row's
    column 0, and row 256 keeps its -12 only without it; even rows hold
    -11, 11, 0 at columns 255..257 (pairL at 256 zeroes column 255); "r3
    tail": row 511's columns 256..510 alternate 27 and 100, and the tail
    past resIII, which only that row reads, alternates 0 and 500: only
    the r3 test zeroes a 27 there, where the tail is 0.  "lane edges" and
    "row chain": ``lq_lane_edges``, ``lq_row_chain``."""
    from nhwcodec_tpu_torch.models import device_scans as ds

    n = ds.LQ_R3_EXT
    if kind == "random":
        return (rng.integers(-40, 41, (b, 512, 512)).astype(np.int16),
                rng.integers(-20, 21, (b, n)).astype(np.int16))
    x = rng.integers(-2, 3, (b, 512, 512)).astype(np.int16)
    r3 = (rng.integers(50, 201, (b, n))
          * rng.choice(np.array([-1, 1]), (b, n))).astype(np.int16)
    if kind == "pairR chain":
        for r in range(256, 511, 2):
            x[:, r, 509:512] = (0, 16, -15)
            x[:, r + 1, 0:2] = (15, 0)
    elif kind == "pairL column 0":
        for r in range(255, 510, 2):
            x[:, r, 510:512] = (0, -15)
            x[:, r + 1, 0:2] = (15, 0)
    elif kind == "A into row 256":
        for r in range(256):
            x[:, r, 510:512] = (0, 11)
            x[:, r + 1, 0] = -12
        x[:, 256, 1] = 100
        x[:, 0:256:2, 255:258] = (-11, 11, 0)
    elif kind == "r3 tail":
        x[:, 511, 256:511:2] = 27
        x[:, 511, 257:511:2] = 100
        r3[:, SZ: SZ + 128] = np.where(np.arange(128) % 2 == 0, 0, 500)
    elif kind == "lane edges":
        lq_lane_edges(x, r3)
    else:
        lq_row_chain(x, r3)
    return x, r3


def lq_lane_edges(x, r3) -> None:
    """S11's lane tiles (16 columns of B + C a lane, 8 of loop A): at
    columns e - 2..e + 1 of every tile edge e of every row, pattern (e / 16
    + r) % 5 (loop A: (e / 8 + r) % 3), with V = 15 in B (columns up to
    256), 23 in C, 11 in loop A: 0 (5, -V, V, 0): pairL on the tile's
    first column zeroes the previous tile's last; 1 (0, V, -V, 0): pairR
    on the previous tile's last column, the tile enters pending; 2 (0, 9,
    V, -V): the previous tile's last visit writes 0 (B + C: the phase-2
    zeroing; loop A: its r3 test, set true there), so the tile enters with
    left 0 and its first visit's pairR fires; 3 (0, 17, V, -V, 5): in C above
    LOW10 the snap leaves +7 as the tile's entry, which keeps the first
    visit from pairR (at or below LOW10 the 17 goes to 0 and pairR fires);
    4 (0, -17, 8, 0): the snap leaves -7, which the first visit's pairL
    zeroes.  In place on (B, 512, 512) x and r3_ext."""
    for r in range(512):
        if r < 256:
            for e in range(264, 512, 8):
                p = (e // 8 + r) % 3
                x[:, r, e - 2: e + 2] = ((5, -11, 11, 0), (0, 11, -11, 0),
                                         (0, 9, 11, -11))[p]
                if p == 2:
                    r3[:, 128 + 128 * r + (e - 257) // 2] = 0
            continue
        for e in range(16, 512, 16):
            v = 15 if e <= 256 else 23
            pat = ((5, -v, v, 0), (0, v, -v, 0), (0, 9, v, -v),
                   (0, 17, v, -v, 5), (0, -17, 8, 0))[(e // 16 + r) % 5]
            x[:, r, e - 2: e - 2 + len(pat)] = pat


def lq_row_chain(x, r3) -> None:
    """A chain through all 256 rows of B + C: B's columns alternate 15,
    -15 and C's 23, -23 from column 0, so a row whose column-0 visit finds
    left 0 fires pairR at every even column through 510 (and zeroes column
    511: the next row enters with left 0 too), and one that finds column
    511's -23 fires nothing; each row's exit is its entry.  Rows 256 + 41
    k (k >= 1) reset it: odd k starts with 5 (nothing fires), even k with
    0, 0, so pairR fires from column 2 on whatever the entry.  Row 256
    enters from loop A's row 255, which ends 0, 11: in even images its r3
    test zeroes the 11 (row 256 enters with left 0), in odd ones the 11
    stays.  In place on (B, 512, 512) x and r3_ext."""
    cols = np.arange(512)
    x[:, 256:, :] = np.where(cols < 256, 15, 23) * np.where(cols % 2, -1, 1)
    for r in range(256 + 41, 512, 41):
        if (r - 256) // 41 % 2:
            x[:, r, 0] = 5
        else:
            x[:, r, :2] = 0
    x[:, 255, 510:512] = (0, 11)
    r3[0::2, 128 + 128 * 255 + 127] = 0


def host_offset_y_low4(x: np.ndarray) -> np.ndarray:
    """The host copy's C quantizer at q16 (the duty cycles) on each
    image."""
    return host_offset_y(x, 16)


def host_lowest_q(x: np.ndarray, r3: np.ndarray, q: int,
                  xs: np.ndarray) -> np.ndarray:
    """The host copy's C lowest-q cleanup (ratio 8) on each image, with
    its r3_ext row and thresholds."""
    from nhwcodec_tpu_torch.host import native

    lib, ffi = native._load(), native.ffi()
    out = x.copy()
    for k in range(len(out)):
        r = np.ascontiguousarray(r3[k], np.int16)
        lib.nhw_lowest_q_band_cleanup(
            ffi.cast("int16_t *", out[k].ctypes.data),
            ffi.cast("int16_t *", r.ctypes.data), 8, int(q > 10),
            *map(int, xs[k]))
    return out


def low4_kernel_phase(dev, captured: dict) -> dict:
    """S10, S11 and the low56 cleanup on the planes captured from the host
    copy's encodes at q16 (16 images), q15, q14 and q13 (4 each): S10 at
    all four against its twin and the host copy's C (timed at q16),
    low56 at q15 and q14 and S11 at q13 against the host copy's C, S11
    also against its twin (timed on the 4 q13 planes 4 times, a batch of
    16, and at batch 4); S10 timed and its launches checked (S2's pass 1
    and ``oy4_rows``, after a fill) on the q16 planes; then at batch 1, 3
    and 16 (``compare_batches``) S10 on OY4_KINDS (each timed at 16) and
    S11 on LQ_KINDS at q13 (the random ones at q10 too: gt_low10 both
    ways), each against the host copy's C too."""
    import torch

    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    out = {}
    plane = 2 * 512 * 512
    oy_in, oy_out = [], []
    for q, want_b in LOW4_QS.items():
        recs = captured[q]
        check(len(recs) == want_b and all("oy" in r for r in recs),
              f"q{q}: captured {len(recs)} host encodes, not {want_b}")
        oy_in.append(np.stack([r["oy"]["in"] for r in recs]))
        oy_out.append(np.stack([r["oy"]["out"] for r in recs]))
        x = t(oy_in[-1])
        got = ds.offset_y_low4_device(x, 8)
        check(np.array_equal(got.cpu().numpy(), oy_out[-1]),
              f"offset_y_low4 q{q}: differs from the host copy's C")
        if q == 16:
            out["offset_y_low4"] = compare_and_time(
                "offset_y_low4", f"({want_b},512,512) q{q} planes",
                lambda: ds.offset_y_low4_device(x, 8),
                lambda: ds.offset_y_low4_ref(x, 8), twin_calls=1,
                twin_runs=1, twin_warm=0,
                bound=work(2 * want_b * plane,
                           (OFFSET_Y_PASS1_OPS + OY4_OPS)
                           * want_b * 512 * 512), graph=True)
            print(f"kernel offset_y_low4 ({want_b},512,512) q{q} planes: "
                  f"{out['offset_y_low4']['graph_ms']:.4f} ms (graph of "
                  f"{GRAPH_CALLS} calls, CUDA events); the design before: "
                  f"{S10_WAS_GRAPH_MS} ms (PERF.md)", flush=True)
            check_launches("offset_y_low4", f"({want_b},512,512) q{q} planes",
                           lambda: ds.offset_y_low4_device(x, 8),
                           ("offset_y_rows", "oy4_rows"))
        e11 = np.stack([r["e11"] for r in recs]) if q < 16 else None
        if q in (15, 14):
            got = ds.low56_band_cleanup_device(t(e11), 19 if q == 15 else 20)
            check(np.array_equal(got.cpu().numpy(), np.stack(
                [r["low56"]["out"] for r in recs])),
                f"low56 q{q}: differs from the host copy's C")
            e = t(e11)
            ms = median_ms(lambda: ds.low56_band_cleanup_device(e, 19))
            print(f"low56_band_cleanup_device (torch ops), q{q} planes "
                  f"batch {want_b}: equal to the host copy's; {ms:.4f} ms a "
                  f"call (CUDA events, median of {RUNS})", flush=True)
        if q == 13:
            r3 = np.stack([r["lq"]["r3"] for r in recs])
            xs = np.array([r["lq"]["xs"] for r in recs], np.int32)
            check(all(tuple(v) == des.LOW7_XS for v in xs.tolist()),
                  f"q13: thresholds {xs.tolist()}, not {des.LOW7_XS}")
            P, R, X = t(e11), t(r3), t(xs)
            got = ds.lowest_q_band_cleanup_device(P, R, q, X)
            check(np.array_equal(got.cpu().numpy(), np.stack(
                [r["lq"]["out"] for r in recs])),
                "lowest_q_band_cleanup q13: differs from the host copy's C")
            k = B // want_b
            P, R, X = P.repeat(k, 1, 1), R.repeat(k, 1), X.repeat(k, 1)
            out["lowest_q_band_cleanup"] = compare_and_time(
                "lowest_q_band_cleanup",
                f"({B},512,512) + ({B},{ds.LQ_R3_EXT}) "
                f"r3_ext, the {want_b} q13 planes {k} times",
                lambda: ds.lowest_q_band_cleanup_device(P, R, 13, X),
                lambda: ds.lowest_q_band_cleanup_ref(P, R, 13, X),
                twin_calls=1, twin_runs=1, twin_warm=0,
                bound=work(B * (2 * plane + 2 * ds.LQ_R3_EXT),
                           LQ_OPS * B * LQ_VISITS), graph=True)
            print(f"kernel lowest_q_band_cleanup ({B},512,512) q13 planes: "
                  f"{out['lowest_q_band_cleanup']['graph_ms']:.4f} ms (graph "
                  f"of {GRAPH_CALLS} calls, CUDA events); the design before: "
                  f"{S11_WAS_GRAPH_MS} ms (PERF.md)", flush=True)
            check_one_launch("lowest_q_band_cleanup",
                             f"({B},512,512) q13 planes",
                             lambda: ds.lowest_q_band_cleanup_device(
                                 P, R, 13, X), "lowest_q_rows")
            P4, R4, X4 = P[:want_b], R[:want_b], X[:want_b]
            ms = median_ms(lambda: ds.lowest_q_band_cleanup_device(
                P4, R4, 13, X4))
            print(f"kernel lowest_q_band_cleanup ({want_b},512,512) q13 "
                  f"planes: wrapper call {ms:.4f} ms (CUDA events, median "
                  f"of {RUNS})", flush=True)
    # the twin on the q15, q14 and q13 planes as one batch (its launches,
    # not its batch, set its time)
    x = t(np.concatenate(oy_in[1:]))
    compare_and_time("offset_y_low4", f"({len(x)},512,512) q15, q14 and q13 "
                     "planes", lambda: ds.offset_y_low4_device(x, 8),
                     lambda: ds.offset_y_low4_ref(x, 8), timed=False)
    rng = np.random.default_rng(SEED + 70)
    for kind in OY4_KINDS:
        x = oy4_edge_planes(rng, B, kind)
        X = t(x)
        ms = graph_ms(lambda: ds.offset_y_low4_device(X, 8))
        print(f"kernel offset_y_low4 ({B},512,512) {kind} planes: {ms:.4f} "
              f"ms (graph of {GRAPH_CALLS} calls, CUDA events)", flush=True)
        compare_batches("offset_y_low4", f"{kind} planes",
                        lambda a: ds.offset_y_low4_device(a, 8),
                        lambda a: ds.offset_y_low4_ref(a, 8), (t(x),))
        check(np.array_equal(ds.offset_y_low4_device(t(x), 8).cpu().numpy(),
                             host_offset_y_low4(x)),
              f"offset_y_low4 {kind} planes: differ from the host copy's C")
    xs = np.tile(np.array(des.LOW7_XS, np.int32), (B, 1))
    for kind in LQ_KINDS:
        x, r3 = lowq_edge_inputs(rng, B, kind)
        X, R, S = t(x), t(r3), t(xs)
        ms = graph_ms(lambda: ds.lowest_q_band_cleanup_device(X, R, 13, S))
        print(f"kernel lowest_q_band_cleanup ({B},512,512) {kind} planes, "
              f"q13: {ms:.4f} ms (graph of {GRAPH_CALLS} calls, CUDA events)",
              flush=True)
        for q in (13, 10):
            compare_batches(
                "lowest_q_band_cleanup", f"{kind} planes, q{q}",
                lambda a, r, s: ds.lowest_q_band_cleanup_device(a, r, q, s),
                lambda a, r, s: ds.lowest_q_band_cleanup_ref(a, r, q, s),
                (t(x), t(r3), t(xs)))
            got = ds.lowest_q_band_cleanup_device(t(x), t(r3), q, t(xs))
            check(np.array_equal(got.cpu().numpy(),
                                 host_lowest_q(x, r3, q, xs)),
                  f"lowest_q_band_cleanup {kind} planes, q{q}: differ from "
                  "the host copy's C")
    print("encode scans: S10 equals its twin and the host copy's C on the "
          "captured q16/q15/q14/q13 planes and at batch 1, 3 and 16 on the "
          f"{', '.join(OY4_KINDS)} planes; S11 on the captured q13 planes and "
          f"on the {', '.join(LQ_KINDS)} planes at q13 and q10; low56 on the "
          "captured q15/q14 planes", flush=True)
    return out


# ---------------------------------------------------------------------------
# the device encode scans' programs below LOW7 (q1..q12): S12
# very_low_q_cleanup (vlq_rows: passes 1-4 and the far zeroings' masks;
# vlq_far: the far zeroings), S13 low_q_ll1_cleanup (ll1_rows) and S14
# uv_ll_smooth (uvs_relay) in csrc/vlq.cu, and the count-adaptive lowest-q
# thresholds as torch ops

VLQ_KERNELS = ("very_low_q_cleanup", "low_q_ll1_cleanup", "uv_ll_smooth")
# q -> images of the encode batch whose host encodes encode_scans_device_phase
# captures for vlq_kernel_phase (4 each): S12 at q12 (LOW8) and below, S13
# and S14 at q11 (LOW9) and below
VLQ_QS = {12: 4, 11: 4, 8: 4, 1: 4}
# the functions' own operations, counted from csrc/vlq.cu: a pass-1 window
# (5 reads, c1's 5 differences, absolutes and compares, the write ladder's
# 8 tests, c2's 6 more tests: 45), a wave visit (7 reads, the outer and
# inner tests' 6 differences, absolutes and compares, the mean, the write
# test, the mask bits: 35), an LL1 visit (the reads, 3 absolutes, 5
# compares, the select: 12)
VLQ_P1_OPS = 45
WAVE_OPS = 35
LL1_OPS = 12
# pass 4's fire test a position (3 differences, absolutes and compares:
# 10), the far zeroings a plane position (the absolute, the band's
# thresholds, the mask bits, the select: 6)
VLQ_P4_OPS = 10
VLQ_FAR_OPS = 6
VLQ_VISITS = (128 * 124, 2 * 126 * 126)   # pass 1; passes 2 and 3
UVS_VISITS = 2 * 62 * 62
VLQ_KINDS = ("random", "p1 chain", "wave left", "stale use4", "stale use0",
             "l2 in ll1", "warp edges")
# the qualities of each kind: q12 (LOW8: no pass 4, no level-2 zeroing),
# q11 and q8 (LOW9, LOW12: both, x1..x4 as at q12), q1 (LOW19: the widest
# thresholds); the stale carry acts at q <= LOW9 only
VLQ_EDGE_QS = {"random": (12, 11, 1), "p1 chain": (12, 1),
               "wave left": (12, 1), "stale use4": (11, 8),
               "stale use0": (11, 8), "l2 in ll1": (11, 1),
               "warp edges": (12, 11, 1)}
# the level-2 targets of the stale carry 4 and 0 (count - 1..count + 1
# plus 128, SZ and SZ + 128), flat in a (512, 512) plane
STALE_TARGETS = {c: [k + o for k in (c - 1, c, c + 1)
                     for o in (128, SZ, SZ + 128)] for c in (4, 0)}
LL1_KINDS = ("random", "zero chain", "row ends")
UVS_KINDS = ("random", "wave left", "pass 3 on pass 2")
# "pass 3 on pass 2": bumps (R - 1, C) = 4, (R, C) = 6 on a flat block at
# columns UVS_BUMP_COLS, rows R of UVS_BUMP_ROWS (the first list at even
# column groups, the second at odd); R = 32 and 33 put the rows pass 2
# writes on the edge between its warps, and each list meets every column
# mod 3 and mod 4, so every step's place between barriers 3 or 4 apart
UVS_BUMP_COLS = tuple(2 + 8 * g + g // 2 for g in range(8))
UVS_BUMP_ROWS = ((2, 8, 14, 20, 26, 32, 38, 44, 50, 56, 62),
                 (3, 9, 15, 21, 27, 33, 39, 45, 51, 57))
# counts of |v| >= 12 in rows 256..511 at the lowest-q thresholds' band
# edges (> 12500, > 10000, >= 7000)
XS_COUNTS = (6999, 7000, 10000, 10001, 12500, 12501)


def _smooth(rng, b, n, step, noise):
    """(B, n, n) int: a random walk along the columns plus one along the
    rows plus noise in [-noise, noise]: flat enough for the windows."""
    cols = np.cumsum(rng.integers(-step, step + 1, (b, 1, n)), 2)
    rows = np.cumsum(rng.integers(-step, step + 1, (b, n, 1)), 1)
    return cols + rows + rng.integers(-noise, noise + 1, (b, n, n))


def vlq_edge_planes(rng, b, kind: str) -> np.ndarray:
    """(B, 512, 512) int16 planes for S12, their level-1 bands random in
    [-40, 40] (most of them under the far zeroings' thresholds).
    "random": a smooth LL2 quadrant, every pass firing.  "p1 chain": each
    quadrant row starts 0, 0, 9, 4, 0, 7 (rows 500 apart, so passes 2 and
    3 never fire): window 0 writes 2 at column 2, and only that value
    makes window 1 write 1 at column 3 (with the 9, window 1 fires
    without a write).  "wave left": rows 4k and 4k + 2 alternate 2 and 18
    (pass 1 never fires there, pass 3 never on them), rows 4k + 1 hold 10
    and rows 4k + 3 1000: pass 2's visits (4k, j) write along row 4k + 1,
    and visit (4k, 1) writes 7 at (4k + 1, 2) from (4k + 1, 1) = 14, the
    write of visit (4k, 0) (from the 10 there: 6).  "stale use4" and
    "stale use0" (for q <= LOW9 with x3 = 6): ramps of slope 4 (no pass-1
    or pass-2 fire; pass 3 fires from row 3 on), row 2 20 higher, so row
    0's visits hit without firing before any fire, and pass 3's carry is
    stale.  use4: a plateau in row 120 makes a pass-1 fire, and row 0's
    columns 2..6 zigzag (no pass 4 there): the carry is 4, and only the
    stale zeroing takes STALE_TARGETS[4].  use0: no pass-1 fire; (0, 127)
    is 10, so carry 0 zeroes it during pass 3, and pass 3's visit (0, 125)
    then does not hit, where with the 10 it would fire and zero the bands
    around (1, 126) (rows 1-2 set so that pass 4 does not).  "l2 in ll1":
    a smooth quadrant, rows 128..255 and the level-2 band beside the
    quadrant in [-14, 14]: the level-2 zeroings (q <= LOW9) land in the
    LL1 cleanup's region.  "warp edges": a quadrant of +-300 and noise
    (nothing fires) but for smooth rows 29..36, 61..68 and 93..100, where
    the passes fire at visit rows 31/32, 63/64 and 95/96: the rows that
    lane 31 of one warp of S12's relay writes and lane 0 of the next
    reads."""
    x = rng.integers(-40, 41, (b, 512, 512)).astype(np.int16)
    off = rng.integers(-200, 201, (b, 1, 1))
    q_ = x[:, :128, :128]
    if kind in ("random", "l2 in ll1"):
        q_[:] = _smooth(rng, b, 128, 3, 2) + off
        if kind == "l2 in ll1":
            x[:, :256, 128:256] = rng.integers(-14, 15, (b, 256, 128))
            x[:, 128:256, :128] = rng.integers(-14, 15, (b, 128, 128))
        return x
    if kind == "warp edges":
        sign = np.where((np.arange(128)[:, None] + np.arange(128)) % 2, 1, -1)
        q_[:] = 300 * sign + rng.integers(-20, 21, (b, 128, 128))
        for r0 in (29, 61, 93):
            q_[:, r0: r0 + 8] = _smooth(rng, b, 128, 3, 2)[:, :8] + off
        return x
    if kind == "p1 chain":
        q_[:] = rng.integers(-3, 4, (b, 128, 128))
        q_[:, :, :6] = (0, 0, 9, 4, 0, 7)
        q_ += (np.arange(128) % 2 * 500).reshape(1, 128, 1) + off
        return x
    if kind == "wave left":
        alt = np.where(np.arange(128) % 2, 18, 2)
        q_[:, 0::4], q_[:, 1::4] = alt, 10
        q_[:, 2::4], q_[:, 3::4] = alt, 1000
        q_ += off
        return x
    ramp = 4 * (np.arange(128) - 127) + 10
    q_[:] = ramp
    q_[:, 2] += 20
    if kind == "stale use4":
        q_[:, 0, 2:7] += (0, 50, 0, 50, 0)
        q_[:, 120, 50:61] = 1000
        for t, v in zip(STALE_TARGETS[4], (5, -7, 10, 3, -11, 8, 0, 12, -1)):
            x.reshape(b, -1)[:, t] = v
    else:
        q_[:, 2, 126] = 2
        q_[:, 1, 124:128] = (10, 2, -2, 14)
        # the bands around (1, 126), which only that fire would zero
        for r, c in (((2, 4), (508, 510)), ((258, 260), (252, 254)),
                     ((258, 260), (508, 510)), ((1, 2), (253, 256)),
                     ((129, 130), (125, 128)), ((129, 130), (253, 256))):
            x[:, r[0]: r[1], c[0]: c[1]] = 3
        for t in STALE_TARGETS[0][1:]:     # all but (0, 127) itself
            x.reshape(b, -1)[:, t] = 5
    return x


def ll1_edge_planes(rng, b, kind: str) -> np.ndarray:
    """(B, 512, 512) int16 planes for S13.  "random": values in [-14,
    14].  The others |v| <= 2 but for: "zero chain": each row of 128..255
    holds 0, 8, 9, 0 every 4 columns: the 8 is zeroed (beside a small
    left value), and then the 9 (only beside the zeroed 8); "row ends":
    columns 0 and 255 hold 9 with 0 inside the region, the previous row's
    column 511 0 in even rows (then column 0 is zeroed) and 20 in odd ones,
    column 256 0 in rows r % 4 < 2 (then column 255 is zeroed) and 20
    else."""
    if kind == "random":
        return rng.integers(-14, 15, (b, 512, 512)).astype(np.int16)
    x = rng.integers(-2, 3, (b, 512, 512)).astype(np.int16)
    rows = x[:, 128:256]
    if kind == "zero chain":
        rows[:, :, 0:256:4], rows[:, :, 1:256:4] = 0, 8
        rows[:, :, 2:256:4], rows[:, :, 3:256:4] = 9, 0
    else:
        rows[:, :, 0], rows[:, :, 1] = 9, 0
        rows[:, :, 255], rows[:, :, 254] = 9, 0
        x[:, 127:255, 511] = np.where(np.arange(128) % 2, 20, 0)
        rows[:, :, 256] = np.where(np.arange(128) % 4 < 2, 0, 20)
    return x


def uvs_edge_planes(rng, b, kind: str) -> np.ndarray:
    """(B, 256, 256) int16 chroma planes for S14.  "random": a smooth LL2
    block (both passes firing), the rest in [-300, 300].  "wave left":
    rows 4k of the block alternate 6 and 0 (the second pass never fires
    there), rows 4k + 1 hold 0, rows 4k + 2 3 and rows 4k + 3 1000: the
    first pass's visits (4k, j) write along row 4k + 1, and visit (4k, 1)
    writes 3 at (4k + 1, 2) from (4k + 1, 1) = 1, the write of visit (4k,
    0) (from the 0 there: 2).  "pass 3 on pass 2": a flat block with
    bumps (R - 1, C) = 4, (R, C) = 6 (UVS_BUMP_ROWS): pass 2's visit (R -
    1, C - 1) writes 1 at (R, C), and pass 3's visit (R - 2, C - 1), which
    reads (R, C) as its row r + 2, fires only on that write (on the 6 it
    would not), writing 1 at (R - 1, C)."""
    x = rng.integers(-300, 301, (b, 256, 256)).astype(np.int16)
    off = rng.integers(-100, 101, (b, 1, 1))
    blk = x[:, :64, :64]
    if kind == "random":
        blk[:] = _smooth(rng, b, 64, 2, 1) + off
    elif kind == "pass 3 on pass 2":
        blk[:] = off
        for g, c in enumerate(UVS_BUMP_COLS):
            for r in UVS_BUMP_ROWS[g % 2]:
                blk[:, r - 1, c] += 4
                blk[:, r, c] += 6
    else:
        blk[:, 0::4] = np.where(np.arange(64) % 2, 0, 6)
        blk[:, 1::4], blk[:, 2::4], blk[:, 3::4] = 0, 3, 1000
        blk += off
    return x


def xs_count_planes(rng, counts) -> np.ndarray:
    """(len(counts), 512, 512) int16 planes with exactly counts[k] values of
    |v| >= 12 (in [12, 40], either sign) in rows 256..511, and the rest in
    [-11, 11] but for 100 values of -32768, which the host's int16 |v| does
    not count."""
    x = rng.integers(-11, 12, (len(counts), 512, 512)).astype(np.int16)
    for k, n in enumerate(counts):
        low = x[k, 256:].reshape(-1)
        pos = rng.permutation(low.size)
        low[pos[:n]] = rng.integers(12, 41, n) * rng.choice([-1, 1], n)
        low[pos[n: n + 100]] = -32768
    return x


def _host_each(fn, x: np.ndarray, *args) -> np.ndarray:
    out = x.copy()
    for p in out:
        fn(p, *args)
    return out


def host_vlq(x: np.ndarray, q: int) -> np.ndarray:
    """The host copy's C very-low-q cleanup (ratio 8) on each image."""
    from nhwcodec_tpu_torch.host.models import encoder

    return _host_each(lambda p: encoder._very_low_q_cleanup(
        p.reshape(-1), q, 8), x)


def host_ll1(x: np.ndarray, q: int) -> np.ndarray:
    """The host copy's C LL1 cleanup (ratio 8) on each image."""
    from nhwcodec_tpu_torch.host.models import encoder

    return _host_each(lambda p: encoder._low_q_ll1_cleanup(
        p.reshape(-1), q, 8), x)


def host_uvs(x: np.ndarray) -> np.ndarray:
    """The host copy's C chroma LL smoothing on each plane."""
    from nhwcodec_tpu_torch.host.models import encoder

    return _host_each(encoder._uv_ll_smooth, x)


def vlq_kernel_phase(dev, captured: dict) -> dict:
    """S12-S14 against their twins (max_abs_err 0) and the host copy's C:
    on the planes captured from the host copy's encodes at VLQ_QS (4
    each): S12 at q12, q11, q8 and q1 (the whole function, timed on the 4
    q12 planes 4 times, a batch of 16, beside the old design's passes and
    wrapper, and its launches checked: ``vlq_rows`` and ``vlq_far``), S13
    and S14 at q11, q8 and q1 (timed on the 4 q8 planes 4 times and on
    the q8 U and V planes twice: a batch of 16 each; S14 there also at
    batch 1, 3 and 16, one launch of ``uvs_relay`` beside the wrapper's
    copy, its graph beside S14_WAS_GRAPH_MS); then at batch 1, 3 and 16
    (``compare_batches``) S12 on VLQ_KINDS at their VLQ_EDGE_QS, S13 on
    LL1_KINDS with x1 10 and 11, S14 on UVS_KINDS (each kind's graph
    timed at batch 16), each also against the host copy's C; and the
    lowest-q thresholds on the card against the host's on
    xs_count_planes at q12, q11 and q10.  The twins' profiler windows of
    some 4,000-30,000 launches a call are not taken (their summaries cost
    about a minute)."""
    import torch

    from nhwcodec_tpu_torch.host import tables as T
    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    def t(x):
        return torch.from_numpy(np.ascontiguousarray(x)).to(dev)

    def same(got, want, what):
        check(np.array_equal(got.cpu().numpy(), want),
              f"{what}: differs from the host copy's C")

    out = {}
    plane, uvp, masks = 2 * 512 * 512, 2 * 256 * 256, 4 * 128 * 128
    for q, want_b in VLQ_QS.items():
        recs = captured[q]
        check(len(recs) == want_b and all("vlq" in r for r in recs),
              f"q{q}: captured {len(recs)} host encodes, not {want_b}")
        xs7 = encoder._VLQ_THRX(q, None)
        x = t(np.stack([r["vlq"]["in"] for r in recs]))
        same(ds.very_low_q_cleanup_device(x, q, xs7),
             np.stack([r["vlq"]["out"] for r in recs]),
             f"very_low_q_cleanup q{q}")
        k = B // want_b
        if q == T.LOW8:
            X = x.repeat(k, 1, 1)
            out["very_low_q_cleanup"] = compare_and_time(
                "very_low_q_cleanup", f"({B},512,512) the {want_b} q{q} "
                f"planes {k} times: the whole function",
                lambda: ds.very_low_q_cleanup_device(X, q, xs7),
                lambda: ds.very_low_q_cleanup_ref(X, q, xs7), twin_runs=1,
                twin_warm=0, twin_profile=False,
                bound=work(B * 2 * plane, B * (
                    VLQ_P1_OPS * VLQ_VISITS[0] + WAVE_OPS * VLQ_VISITS[1]
                    + VLQ_P4_OPS * 128 * 126
                    + VLQ_FAR_OPS * 512 * 512)),
                graph=True)
            print(f"kernel very_low_q_cleanup ({B},512,512) q{q} planes: "
                  f"{out['very_low_q_cleanup']['graph_ms']:.4f} ms (graph "
                  f"of {GRAPH_CALLS} calls, CUDA events), the whole "
                  f"function; the design before: passes 1-3 "
                  f"{S12_WAS_GRAPH_MS} ms (graph), the wrapper with pass 4 "
                  f"and the far zeroings {S12_WAS_CALL_MS} ms a call "
                  "(PERF.md)", flush=True)
            check_launches("very_low_q_cleanup", f"({B},512,512) q{q} "
                           "planes", lambda: ds.very_low_q_cleanup_device(
                               X, q, xs7), ("vlq_rows", "vlq_far"))
        else:
            compare_and_time(
                "very_low_q_cleanup", f"({want_b},512,512) q{q} planes",
                lambda: ds.very_low_q_cleanup_device(x, q, xs7),
                lambda: ds.very_low_q_cleanup_ref(x, q, xs7), timed=False)
        if q > T.LOW9:
            continue
        x1 = 10 if q > T.LOW14 else 11
        x = t(np.stack([r["ll1"]["in"] for r in recs]))
        same(ds.low_q_ll1_cleanup_device(x, x1),
             np.stack([r["ll1"]["out"] for r in recs]),
             f"low_q_ll1_cleanup q{q}")
        u = t(np.stack([p["in"] for r in recs for p in r["uvs"]]))
        same(ds.uv_ll_smooth_device(u),
             np.stack([p["out"] for r in recs for p in r["uvs"]]),
             f"uv_ll_smooth q{q}")
        timed = q == T.LOW12
        X = x.repeat(k, 1, 1) if timed else x
        U = u.repeat(B // len(u), 1, 1) if timed else u
        res = compare_and_time(
            "low_q_ll1_cleanup", f"({len(X)},512,512) q{q} planes, x1 {x1}",
            lambda: ds.low_q_ll1_cleanup_device(X, x1),
            lambda: ds.low_q_ll1_cleanup_ref(X, x1), timed=timed,
            twin_runs=3, twin_warm=1, twin_profile=False,
            bound=work(B * 2 * plane, B * LL1_OPS * 128 * 256), graph=True)
        out["low_q_ll1_cleanup"] = res or out.get("low_q_ll1_cleanup")
        res = compare_and_time(
            "uv_ll_smooth", f"({len(U)},256,256) q{q} U and V planes",
            lambda: ds.uv_ll_smooth_device(U),
            lambda: ds.uv_ll_smooth_ref(U), timed=timed, twin_runs=3,
            twin_warm=1, twin_profile=False,
            bound=work(B * 2 * uvp, B * WAVE_OPS * UVS_VISITS), graph=True)
        out["uv_ll_smooth"] = res or out.get("uv_ll_smooth")
        if timed:
            compare_batches("uv_ll_smooth", f"q{q} U and V planes",
                            ds.uv_ll_smooth_device, ds.uv_ll_smooth_ref,
                            (U,))
            print(f"kernel uv_ll_smooth ({len(U)},256,256) q{q} U and V "
                  f"planes: {res['graph_ms']:.4f} ms (graph of "
                  f"{GRAPH_CALLS} calls, CUDA events), {ds.uvs_steps()} "
                  f"relay steps; the design before: {S14_WAS_GRAPH_MS} ms "
                  "(graph, PERF.md)", flush=True)
            check_one_launch("uv_ll_smooth", f"q{q} U and V planes",
                             lambda: ds.uv_ll_smooth_device(U), "uvs_relay",
                             copy=True)

    rng = np.random.default_rng(SEED + 80)
    for kind in VLQ_KINDS:
        x = vlq_edge_planes(rng, B, kind)
        for q in VLQ_EDGE_QS[kind]:
            xs7 = encoder._VLQ_THRX(q, None)
            compare_batches(
                "very_low_q_cleanup", f"{kind} planes, q{q}",
                lambda a: ds.very_low_q_cleanup_device(a, q, xs7),
                lambda a: ds.very_low_q_cleanup_ref(a, q, xs7), (t(x),))
            same(ds.very_low_q_cleanup_device(t(x), q, xs7),
                 host_vlq(x, q), f"very_low_q_cleanup {kind} planes, q{q}")
    for kind in LL1_KINDS:
        x = ll1_edge_planes(rng, B, kind)
        for q in (T.LOW9, T.LOW14):
            x1 = 10 if q > T.LOW14 else 11
            compare_batches(
                "low_q_ll1_cleanup", f"{kind} planes, x1 {x1}",
                lambda a: ds.low_q_ll1_cleanup_device(a, x1),
                lambda a: ds.low_q_ll1_cleanup_ref(a, x1), (t(x),))
            same(ds.low_q_ll1_cleanup_device(t(x), x1), host_ll1(x, q),
                 f"low_q_ll1_cleanup {kind} planes, x1 {x1}")
    for kind in UVS_KINDS:
        x = uvs_edge_planes(rng, B, kind)
        compare_batches("uv_ll_smooth", f"{kind} planes",
                        ds.uv_ll_smooth_device, ds.uv_ll_smooth_ref, (t(x),))
        same(ds.uv_ll_smooth_device(t(x)), host_uvs(x),
             f"uv_ll_smooth {kind} planes")
        xd = t(x)
        print(f"kernel uv_ll_smooth ({B},256,256) {kind} planes: "
              f"{graph_ms(lambda: ds.uv_ll_smooth_device(xd)):.4f} ms (graph "
              f"of {GRAPH_CALLS} calls, CUDA events)", flush=True)
    x = xs_count_planes(rng, XS_COUNTS)
    for q in (T.LOW8, T.LOW9, T.LOW10):
        got = des.lowest_q_xs_device(t(x), q).cpu().tolist()
        want = [list(encoder._lowest_q_xs(p.reshape(-1), q)) for p in x]
        check(got == want, f"lowest-q thresholds q{q}: {got}, not {want}")
    print("encode scans: S12 equals its twin and the host copy's C on the "
          f"captured q{'/q'.join(map(str, VLQ_QS))} planes and at batch 1, "
          f"3 and 16 on the {', '.join(VLQ_KINDS)} planes; S13 and S14 on "
          "the captured q11/q8/q1 planes and on the "
          f"{', '.join(LL1_KINDS)} and {', '.join(UVS_KINDS)} planes; the "
          "lowest-q thresholds on the card equal the host's at every count "
          "band's edge", flush=True)
    return out


def transform_phase(dev) -> dict:
    """The transform entry on the card: encode_transform on the entry
    batch, decode_transform, and transform_step, each with the launch
    counts set to 0 just before; every output equal to the port's plain
    CPU path and the coefficients to the pinned digests of the JAX
    package's encode_transform.  Returns the launches of transform_step,
    the path's run."""
    import torch

    from nhwcodec_tpu_torch import entry as tentry
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import transform as ttr

    fn, (rgb,) = tentry.entry(dev)
    check(rgb.device == dev and tuple(rgb.shape) == tentry.ENTRY_SHAPE,
          f"entry batch {tuple(rgb.shape)} on {rgb.device}")
    t0 = time.perf_counter()
    want = ttr.encode_transform(rgb.cpu())
    want_rgb = ttr.decode_transform(*want)
    print(f"transform: the plain CPU path of the entry batch in "
          f"{time.perf_counter() - t0:.1f} s", flush=True)

    def run(what, f, kernels):
        build.reset_launches()
        out = f()
        torch.cuda.synchronize()
        got = dict(build.LAUNCHES)
        check({k: v for k, v in got.items() if v} == kernels,
              f"{what} launched {got}, expected {kernels}")
        return out, got

    n = len(rgb)
    coeffs, _ = run("encode_transform", lambda: fn(rgb),
                    {"analysis_level": 4})
    for g, w in zip(coeffs, want):
        check(g.dtype == torch.int16 and g.shape == w.shape
              and torch.equal(g.cpu(), w),
              f"encode_transform {tuple(g.shape)} differs from the CPU path")
    for i in range(n):
        check(transform_digest([c[i].cpu().numpy() for c in coeffs])
              == TRANSFORM_SHA256[i],
              f"encode_transform image {i} differs from the pinned digest")
    dec_kernels = {k: v for k, v in TRANSFORM_KERNELS.items()
                   if k != "analysis_level"}
    out, _ = run("decode_transform", lambda: ttr.decode_transform(*coeffs),
                 dec_kernels)
    check(out.dtype == torch.uint8 and torch.equal(out.cpu(), want_rgb),
          "decode_transform differs from the CPU path")
    step, launches = run("transform_step",
                         lambda: tentry.transform_step(rgb),
                         TRANSFORM_KERNELS)
    check(torch.equal(step.cpu(), want_rgb),
          "transform_step differs from the CPU path")
    print(f"transform: encode_transform of the entry batch ({n},512,512,3) "
          f"equal to the CPU path and to the {n} pinned digests of the JAX "
          f"package's encode_transform; decode_transform and transform_step "
          f"equal to the CPU path; transform_step launches "
          f"{ {k: launches[k] for k in TRANSFORM_KERNELS} }", flush=True)
    for what, f in (("encode_transform", lambda: fn(rgb)),
                    ("decode_transform",
                     lambda: ttr.decode_transform(*coeffs)),
                    ("transform_step", lambda: tentry.transform_step(rgb))):
        ms = median_ms(f)
        print(f"transform end to end, {what} at batch {n}: {ms / n:.4f} "
              f"ms/img ({ms:.4f} ms per call, median of {RUNS}, CUDA "
              "events)", flush=True)
        print_profile(f"{what}, batch {n}", f)
    return launches


def check_one_launch(name: str, shape: str, fn,
                     kernel: str = "analysis_cluster",
                     copy: bool = False) -> None:
    """Check under torch.profiler that a call of ``fn`` is one launch of
    one device kernel, ``kernel`` (with ``copy``, beside the wrapper's
    device-to-device copy: its records are not told apart from the
    kernel's, so the device's count is only checked to be positive)."""
    host, records, names = launches_per_call(fn)
    if copy:
        names = [n for n in names if not n.startswith("Memcpy DtoD")]
    print(f"kernel {name} {shape}: {host:g} kernel launch calls per call "
          f"on the host, {records:g} device kernel records per call "
          f"(profiler), kernels {sorted(set(n[:60] for n in names))}",
          flush=True)
    # the host's count is exact; the profiler drops device records of
    # cluster launches now and then (device_profile)
    check(host == 1 and len(set(names)) == 1
          and kernel in names[0] and 0 < records <= (2 if copy else 1),
          f"{name} {shape} is not one launch of {kernel}")


def check_launches(name: str, shape: str, fn, kernels: tuple) -> None:
    """Check under torch.profiler that a call of ``fn`` is one launch of
    each of ``kernels``, in that count on the host, and at most a fill
    (a memset) beside them on the card."""
    host, records, names = launches_per_call(fn)
    own = {k for k in kernels if any(k + "(" in n for n in names)}
    others = {n[:60] for n in names
              if not any(k + "(" in n for k in kernels)}
    print(f"kernel {name} {shape}: {host:g} kernel launch calls per call "
          f"on the host, {records:g} device records per call (profiler), "
          f"kernels {sorted(set(n[:60] for n in names))}", flush=True)
    check(host == len(kernels) and own == set(kernels)
          and all("emset" in n for n in others),
          f"{name} {shape} is not one launch each of {list(kernels)}")


def shape_sums(name: str, shapes: dict, main: str) -> dict:
    """Print and return the sums over the path shapes of ``name``'s timed
    results ``shapes`` (shape -> compare_and_time's entry): the ``main``
    shape's entry, with device_ms, graph_ms and bound of each shape and
    of all of them."""
    dev = [r["device_ms"] for r in shapes.values()]
    total = None if None in dev else sum(dev)
    graph = sum(r["graph_ms"] for r in shapes.values())
    bound = sum(r["bound_ms"] for r in shapes.values())
    print(f"kernel {name}: the {len(shapes)} path shapes: bound "
          f"{1e3 * bound:.3f} us, device time (profiler) "
          + ("not measured" if total is None else
             f"{total:.4f} ms ({bound / total:.2%})")
          + f", graph of {GRAPH_CALLS} calls {graph:.4f} ms "
          f"({bound / graph:.2%})", flush=True)
    out = dict(shapes[main])
    out["shapes"] = {s: {k: r[k] for k in ("device_ms", "graph_ms",
                                           "bound_ms", "ms")}
                     for s, r in shapes.items()}
    out["all_shapes"] = {"device_ms": total, "graph_ms": graph,
                         "bound_ms": bound}
    return out


def analysis_edge_phase(dev) -> None:
    """K4 and K10 against their twins at batch 1, 3 and 16 (grids of
    1-128 clusters) at the four path shapes on full-range, +-1800 and the
    edge inputs (ANALYSIS_EDGE_INPUTS), and K10 in place on the LL corners
    of its 512 and 256 outputs."""
    import torch

    from nhwcodec_tpu_torch.ops import dwt

    def err(got, want):
        return int((got.to(torch.int32) - want.to(torch.int32)).abs().max())

    rng = np.random.default_rng(SEED + 4)
    kinds = {"full range": lambda b, n: rng.integers(
                 -32768, 32768, (b, n, n)).astype(np.int16),
             "+-1800": lambda b, n: rng.integers(
                 -1800, 1800, (b, n, n)).astype(np.int16),
             **{k: (lambda b, n, g=g: g(rng, b, n))
                for k, g in ANALYSIS_EDGE_INPUTS.items()}}
    for b in (1, 3, B):
        for what, gen in kinds.items():
            worst = 0
            for bb, n in analysis_path_shapes(b):
                x = torch.from_numpy(gen(bb, n)).to(dev)
                j, p = dwt.analysis_level_jp(x)
                wj, wp = dwt.analysis_level_jp_ref(x)
                out = dwt.analysis_level(x)
                worst = max(worst, err(j, wj), err(p, wp),
                            err(out, dwt.analysis_level_ref(x)))
                if n >= 256:
                    h = n // 2
                    want = out.clone()
                    want[:, :h, :h] = dwt.analysis_level_ref(out[:, :h, :h])
                    corner = out[:, :h, :h]
                    dwt.analysis_level(corner, out=corner)
                    worst = max(worst, err(out, want))
            torch.cuda.synchronize()
            print(f"kernels analysis_level_jp and analysis_level at batch "
                  f"{b}, {what}: the four shapes and K10 in place on the LL "
                  f"corners, max_abs_err {worst} vs torch twins", flush=True)
            check(worst == 0, f"K4/K10 at batch {b} differ on {what}")


def cluster_info_phase(dev, timings: dict) -> None:
    """Print what the card allows for each cluster kernel and add it to
    the kernel's entry (K4 and K10 under "clusters", by n)."""
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.ops import dwt

    lib = build.load()
    for name, fn in (("merge_crossing", lib.nhw_merge_crossing_info),
                     ("lowest_q_band_cleanup",
                      lib.nhw_lowest_q_band_cleanup_info)):
        a = np.zeros(3, np.int32)
        build.check(fn.__name__, fn(a.ctypes.data))
        info = {"registers": int(a[0]), "shared_bytes": int(a[1]),
                "max_active_clusters": int(a[2])}
        print(f"kernel {name}: one cluster launch; {info['registers']} "
              f"registers per thread, {info['shared_bytes']} bytes of "
              f"shared memory per CTA, at most "
              f"{info['max_active_clusters']} clusters resident", flush=True)
        timings[name].update(info)

    for name in dwt.CLUSTER_KERNELS:
        info = dwt.cluster_info(name, dev)
        kernel, _, n = name.partition("/")
        print(f"kernel {name}: one cluster launch; {info['registers']} "
              f"registers per thread, {info['shared_bytes']} bytes of "
              f"shared memory per CTA, at most "
              f"{info['max_active_clusters']} clusters resident", flush=True)
        if n:
            timings[kernel].setdefault("clusters", {})[n] = info
        else:
            timings[kernel].update(info)


def transform_kernel_phase(dev) -> dict:
    """K10 against its twin at the transform's four shapes at batch 16,
    in the full int16 range (timed) and the range of real planes, and in
    place on the LL corner of a level-1 plane."""
    import torch

    from nhwcodec_tpu_torch.ops import dwt

    rng = np.random.default_rng(SEED + 2)
    shapes = {}
    for b, n in ANALYSIS_PATH_SHAPES:
        for lo, hi in ((-32767, 32768), (-1800, 1800)):
            x = torch.from_numpy(rng.integers(lo, hi, (b, n, n)).astype(
                np.int16)).to(dev)
            res = compare_and_time(
                "analysis_level", f"({b},{n},{n}) int16 in [{lo},{hi})",
                lambda: dwt.analysis_level(x),
                lambda: dwt.analysis_level_ref(x), timed=lo < -2000,
                bound=work(4 * b * n * n, OPS["analysis_level"] * b * n * n),
                graph=True)
            if res is not None:
                shapes[f"({b},{n},{n})"] = res
                check_one_launch("analysis_level", f"({b},{n},{n})",
                                 lambda: dwt.analysis_level(x))
    out = {"analysis_level": shape_sums("analysis_level", shapes,
                                        f"({B},512,512)")}
    for b, n in ((B, 512), (2 * B, 256)):
        h = n // 2
        l1 = dwt.analysis_level(torch.from_numpy(rng.integers(
            -32767, 32768, (b, n, n)).astype(np.int16)).to(dev))
        want = l1.clone()
        want[:, :h, :h] = dwt.analysis_level_ref(l1[:, :h, :h])
        corner = l1[:, :h, :h]
        dwt.analysis_level(corner, out=corner)
        torch.cuda.synchronize()
        err = int((l1.to(torch.int32) - want.to(torch.int32)).abs().max())
        print(f"kernel analysis_level in place on the ({b},{h},{h}) LL "
              f"corner of ({b},{n},{n}): max_abs_err {err} vs torch twin",
              flush=True)
        check(err == 0, f"analysis_level in place differs at n={n}")
    return out


def print_ptxas(kernels) -> None:
    """Print what ``nvcc -Xptxas -v`` said of each kernel whose mangled
    name holds one of ``kernels`` (registers, spills, static shared
    memory), from the build's log, and fail unless each was found with no
    spill: K2 and K8 share ``waves_norm_clip_row``, and K2 sits near its
    64-register cap."""
    from nhwcodec_tpu_torch.kernels import build

    log = build.lib_path().parent / "build.log"
    check(log.exists(), f"no build log beside {build.lib_path()}")
    found = set()
    for part in log.read_text().split("Compiling entry function '")[1:]:
        name = part.split("'", 1)[0]
        hit = [k for k in kernels if k in name]
        if hit:
            lines = [ln.split(":", 1)[-1].strip() for ln in part.splitlines()
                     if "spill" in ln or "Used" in ln]
            print(f"ptxas {hit[0]}: " + "; ".join(lines), flush=True)
            spills = [int(n) for n in re.findall(
                r"(\d+) bytes spill (?:stores|loads)", part)]
            check(bool(spills) and not any(spills),
                  f"ptxas: {hit[0]} spills ({'; '.join(lines)})")
            found.add(hit[0])
    check(found == set(kernels),
          f"ptxas: no entry for {sorted(set(kernels) - found)} in {log}")


def main() -> int:
    os.environ.setdefault("NHW_NATIVE_PGO", "0")  # no host PGO training run
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
    from nhwcodec_tpu_torch.host import native
    from nhwcodec_tpu_torch.kernels import build

    dev = torch.device("cuda", 0)
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True)
    print(smi.stdout.strip().splitlines()[0], flush=True)
    print(f"torch {torch.__version__} cuda {torch.version.cuda} "
          f"python {sys.version.split()[0]}", flush=True)
    t0 = time.perf_counter()
    print("native host library: "
          + ("loaded" if native.available() else "pure Python")
          + f" ({time.perf_counter() - t0:.1f} s)", flush=True)

    t0 = time.perf_counter()
    build.load()
    print(f"kernel build (nvcc, sm_90a) + load: "
          f"{time.perf_counter() - t0:.1f} s -> {build.lib_path()}",
          flush=True)
    print_ptxas(("y_stage2_cluster", "waves_band", "chain_scan",
                 "y_runs_fixpoint",
                 "snap_pass", "ladder_table", "offset_y_rows",
                 "offset_y_bands", "offset_y_codes", "merge_crossing",
                 "pair_promotion", "column_ladder", "classify_bands",
                 "ll2_code_y", "walk_visited", "uv_sentinel", "oy4_rows",
                 "lowest_q_rows", "vlq_rows", "vlq_far", "ll1_rows",
                 "uvs_relay", "mark_rows"))

    def phase(fn, *args):
        t0 = time.perf_counter()
        out = fn(*args)
        print(f"phase {fn.__name__}: {time.perf_counter() - t0:.1f} s",
              flush=True)
        return out

    # the paths first: a profiler window of very many launches (the K5
    # twin's) can leave later windows incomplete
    images = encode_images(np.random.default_rng(SEED))
    chunks = entropy_chunks(images)
    launches = phase(decode_phase, dev)
    launches.update(phase(hq_decode_phase, dev))
    launches.update(phase(fallback_phase, dev))
    launches.update(phase(entropy_decode_phase, dev, chunks))
    captured = {}
    launches.update(phase(encode_phase, dev, images, captured))
    launches.update(phase(encode_scans_phase, dev, captured))
    launches.update(phase(encode_residue_phase, dev, images, captured))
    launches.update(phase(encode_ll2_phase, dev, images, captured))
    # S1-S14 on the service path that runs them: S1-S9 at q20, S10 at q16,
    # S11 at q13, S12-S14 at q11
    on = phase(encode_scans_device_phase, dev, images, captured)
    launches.update({k: on[20][k] for k in (*SCAN_KERNELS, *RESIDUE_KERNELS,
                                            *LL2_KERNELS, "uv_sentinel")})
    launches["offset_y_low4"] = on[16]["offset_y_low4"]
    launches["lowest_q_band_cleanup"] = on[13]["lowest_q_band_cleanup"]
    launches.update({k: on[11][k] for k in VLQ_KERNELS})
    launches["analysis_level"] = phase(transform_phase, dev)["analysis_level"]
    # the kernels whose twins make the longest profiler windows (the scan's,
    # K5's, the column ladder's: 76,000 launches) last; the phases after
    # them use no profiler
    timings = phase(transform_kernel_phase, dev)
    timings.update(phase(ll2_kernel_phase, dev, captured))
    timings.update(phase(uv_kernel_phase, dev, captured))
    timings.update(phase(entropy_kernel_phase, dev, chunks))
    timings.update(phase(scan_kernel_phase, dev, captured))
    timings.update(phase(kernel_phase, dev))
    timings.update(phase(encode_kernel_phase, dev, images))
    timings.update(phase(low4_kernel_phase, dev, captured))
    timings.update(phase(vlq_kernel_phase, dev, captured))
    timings.update(phase(residue_kernel_phase, dev, captured))
    phase(cluster_info_phase, dev, timings)
    phase(analysis_edge_phase, dev)
    phase(colorspace_phase, dev)
    phase(encode_colorspace_phase, dev, images)
    check(not any(m.split(".")[0] in ("jax", "nhwcodec_tpu")
                  for m in sys.modules), "jax or nhwcodec_tpu was imported")

    kernels = [{"name": name, "route": "cuda", "source": src,
                "replaces": replaces, "launches": launches[name],
                **timings[name]}
               for name, (src, replaces) in KERNELS.items()]
    print(json.dumps({"kernels": kernels}))
    print(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
