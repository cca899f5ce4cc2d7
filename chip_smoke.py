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
   CUDA graph of back-to-back calls) beside the least time the card could
   take for the same bytes and operations.  K1 and K7 (at their three
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
}
DECODE_KERNELS = ("synth_level", "y_stage2_full", "uv_synth")
HQ_KERNELS = ("synth_unnorm_rows_t", "synth_norm_rows_clip_waves")
FALLBACK_KERNELS = ("synth_norm_rows_clip", "smooth_marks_seq")
ENCODE_KERNELS = ("analysis_level_jp", "requant_tail", "colorspace_down420")
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
    record at all (the profiler lost it whole, as it did once for K7 on an
    H100) is run again, up to PROFILE_TRIES times."""
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
    host = sum(e.count for e in rows if e.device_type == DeviceType.CPU
               and e.key in LAUNCH_APIS[:3])
    return (host / calls, sum(e.count for e in dev) / calls,
            sorted(e.key for e in dev))


def host_breakdown(fn, targets) -> tuple[float, dict]:
    """Wall ms of ``fn()`` and the ms spent in each group of host steps:
    ``targets`` lists (module, attribute, group); timers are patched onto
    those module attributes for the call.  A step called from inside
    another timed step counts only in the outer one, so the groups never
    overlap."""
    import threading

    spent = {key: 0.0 for _, _, key in targets}
    active = threading.local()

    def timed(f, key):
        def run(*a, **k):
            if getattr(active, "on", False):
                return f(*a, **k)
            active.on = True
            t0 = time.perf_counter()
            try:
                return f(*a, **k)
            finally:
                spent[key] += (time.perf_counter() - t0) * 1e3
                active.on = False
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


def compare_and_time(name: str, shape: str, kern, twin, timed: bool = True,
                     twin_calls: int = 10, bound: dict | None = None,
                     graph: bool = False):
    """Run ``kern`` and ``twin`` (each returns a tensor or a tuple of
    tensors) on the card, check dtype, shape and max_abs_err 0, and time
    both (the twin's profiler window over ``twin_calls`` calls).  When
    timed, returns the kernel's entry of the JSON line: max_abs_err, ms
    and plain_ms (wrapper calls, CUDA events), device_ms (profiler),
    ``bound`` (``work(...)`` of these inputs), bound_us, bound_share (the
    bound over the device time) and library_ms (None: no single torch
    call computes these integer passes, the exact colorspace or the
    scan); with ``graph``, also graph_ms (``graph_ms``)."""
    import torch

    got, want = kern(), twin()
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    torch.cuda.synchronize()
    check(len(got) == len(want), f"{name}: {len(got)} vs {len(want)} outputs")
    err = 0
    for g, w in zip(got, want):
        check(g.dtype == w.dtype and g.shape == w.shape,
              f"{name}: {g.dtype}{tuple(g.shape)} vs "
              f"{w.dtype}{tuple(w.shape)}")
        err = max(err, int((g.to(torch.int32) - w.to(torch.int32))
                           .abs().max()))
    if not timed:
        print(f"kernel {name} {shape}: max_abs_err {err} vs torch twin",
              flush=True)
        check(err == 0, f"{name} disagrees with its torch twin on {shape}")
        return None
    ms = median_ms(kern)
    plain_ms = median_ms(twin)
    _, k_dev, k_top = device_profile(kern, calls=10)
    t_dev = device_profile(twin, calls=twin_calls)[1]
    share = bound["bound_ms"] / k_dev if k_dev else None
    g_ms = graph_ms(kern) if graph else None
    print(f"kernel {name} {shape}: max_abs_err {err} vs torch twin; "
          f"wrapper call {ms:.4f} ms, twin {plain_ms:.4f} ms (median of "
          f"{RUNS}, CUDA events); device time per call (profiler): "
          f"kernel {k_dev} ms, twin {t_dev} ms; "
          + ("" if g_ms is None else f"graph of {GRAPH_CALLS} calls (CUDA "
             f"events): {g_ms:.4f} ms per call; ")
          + "bound "
          f"{1e3 * bound['bound_ms']:.3f} us ({bound['bound_by']}), "
          f"{'not measured' if share is None else f'{share:.2%}'} of the "
          "kernel's device time; its launches (ms per call): "
          + "; ".join(f"{k[:50]} {v:.4f}" for k, v in k_top), flush=True)
    check(err == 0, f"{name} disagrees with its torch twin on {shape}")
    out = {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms,
           "device_ms": k_dev, **bound, "bound_us": 1e3 * bound["bound_ms"],
           "bound_share": share, "library_ms": None}
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
        twin_calls=1,   # one step of ~12 launches per record index
        bound=work(5 * recs.numel() + 20 * live,
                   OPS["smooth_marks_seq"] * live))
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
                    *host_breakdown(one_chunk, decode_targets()))
    return launches


def decode_targets():
    """The host steps of the decode, grouped for ``host_breakdown``."""
    from nhwcodec_tpu_torch.host.models import decoder
    from nhwcodec_tpu_torch.host.ops import dc_plane, entropy
    from nhwcodec_tpu_torch.models import device_decode as tdd

    return [(tdd, "parse_nhw", "host front"),
            (dc_plane, "decode_dc_planes", "host front"),
            (decoder, "decode_y_front", "host front"),
            (entropy, "decode_uv", "host front"),
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
                    *host_breakdown(one_chunk, decode_targets()))
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


def fallback_phase(dev) -> dict:
    """The sequential mark-scan fallback, forced by refusing the depth
    planes: 4 q20 and 4 q23 streams, chunks of 4 (K7, the scatter, the
    scan, K9)."""
    from nhwcodec_tpu_torch.host.models import decoder, encoder
    from nhwcodec_tpu_torch.host.utils import fixtures
    from nhwcodec_tpu_torch.models import device_decode as tdd

    gens = list(fixtures.GENERATORS.values())
    datas = [encoder.encode(gens[i % len(gens)](), q)
             for q in (20, 23) for i in range(4)]
    want = [decoder.decode(d) for d in datas]
    depth_planes = tdd.mark_depth_planes
    tdd.mark_depth_planes = lambda marks: (None, 0, False)
    try:
        _, sec, got = decode_checked(
            "sequential fallback (depth planes refused), q20 x4 + q23 x4 in "
            "chunks of 4", datas, want,
            ("synth_level", "synth_unnorm_rows_t") + FALLBACK_KERNELS,
            absent=("y_stage2_full", "synth_norm_rows_clip_waves"),
            chunk=4, device=dev)
    finally:
        tdd.mark_depth_planes = depth_planes
    print(f"decode end to end, sequential fallback: "
          f"{1e3 * sec / len(datas):.2f} ms/img (first run)", flush=True)
    return {k: got[k] for k in FALLBACK_KERNELS}


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


def encode_phase(dev, images: np.ndarray) -> dict:
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.host.ops import prefilter, requant
    from nhwcodec_tpu_torch.models import device_stages as tds
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import encoder as tenc
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    t0 = time.perf_counter()
    want = [host_encoder.encode(img, 20) for img in images]
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
        # a fixture with a pinned digest first, then random and fixtures
        sel = images[[names.index(fixture_for(q)), (q + 5) % B,
                      len(names) + q % 5, (3 * q) % B]]
        out, mq = tdp.encode_batch_device(sel, q, device=dev)
        check(mq.failures == 0, f"q{q}: {mq.failures} failures")
        for i, (img, g) in enumerate(zip(sel, out)):
            check(g == host_encoder.encode(img, q),
                  f"q{q} stream {i} differs from the host encoder")
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
                "host encode_from_planes (scans + tokenize)"),
               (tenc, "finish_deferred", "pack (device packer + container)"),
               (tds, "to_device", "host->device copies"),
               (tds, "to_host", "device->host copies (incl. device waits)")]
    print_breakdown(f"encode breakdown, batch {B} q20 in one chunk",
                    *host_breakdown(one_chunk, targets))
    return launches


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
                     kernel: str = "analysis_cluster") -> None:
    """Check under torch.profiler that a call of ``fn`` is one launch of
    one device kernel, ``kernel``."""
    host, records, names = launches_per_call(fn)
    print(f"kernel {name} {shape}: {host:g} kernel launch calls per call "
          f"on the host, {records:g} device kernel records per call "
          f"(profiler), kernels {sorted(set(n[:60] for n in names))}",
          flush=True)
    # the host's count is exact; the profiler drops device records of
    # cluster launches now and then (device_profile)
    check(host == 1 and len(set(names)) == 1
          and kernel in names[0] and 0 < records <= 1,
          f"{name} {shape} is not one launch of {kernel}")


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
    from nhwcodec_tpu_torch.ops import dwt

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
    print_ptxas(("y_stage2_cluster", "waves_band"))

    # the paths first: a profiler window of very many launches (the K5
    # twin's) can leave later windows incomplete
    images = encode_images(np.random.default_rng(SEED))
    launches = decode_phase(dev)
    launches.update(hq_decode_phase(dev))
    launches.update(fallback_phase(dev))
    launches.update(encode_phase(dev, images))
    launches["analysis_level"] = transform_phase(dev)["analysis_level"]
    # the kernels whose twins make the longest profiler windows (the scan's,
    # K5's) last
    timings = transform_kernel_phase(dev)
    timings.update(kernel_phase(dev))
    timings.update(encode_kernel_phase(dev, images))
    cluster_info_phase(dev, timings)
    analysis_edge_phase(dev)
    colorspace_phase(dev)
    encode_colorspace_phase(dev, images)
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
