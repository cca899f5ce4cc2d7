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
   every image and stream byte for byte against the host decoder and
   encoder, and checks that every kernel of each path was launched on
   that path (launch counts set to 0 just before the path and read just
   after); profiles each service and splits its wall time over the host
   steps.
3. Holds each of the nine kernels and the mark scan to its torch twin on
   the card, at the shapes the decode and encode paths give them at
   batch 16, and times both (CUDA events around the wrapper call;
   torch.profiler device time).
4. Sweeps the decode colorspace over all 2^24 (y, u, v) triples in all
   four modes against the host decoder, and the encode colorspace over
   all 2^24 RGB triples (K6's per-pixel entry at q >= NORM, the on-card
   torch path for the gain and integer modes) against the host encoder.

Prints the card's name and power limit (nvidia-smi), one JSON line of
per-kernel results, and last a JSON status line.  Any failure raises and
exits non-zero; so does a machine without a CUDA card.  Imports no jax.

Run from the repository root:  python3 chip_smoke.py
"""

from __future__ import annotations

import json
import os
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
}
DECODE_KERNELS = ("synth_level", "y_stage2_full", "uv_synth")
HQ_KERNELS = ("synth_unnorm_rows_t", "synth_norm_rows_clip_waves")
FALLBACK_KERNELS = ("synth_norm_rows_clip", "smooth_marks_seq")
ENCODE_KERNELS = ("analysis_level_jp", "requant_tail", "colorspace_down420")


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


# runtime calls that each leave one device record (a kernel, a copy, a set)
LAUNCH_APIS = ("cudaLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernel",
               "cudaMemcpyAsync", "cudaMemsetAsync")
PROFILE_TRIES = 5


def device_profile(fn, calls: int = 1, tries: int = PROFILE_TRIES):
    """Run ``fn`` ``calls`` times under torch.profiler.  Returns (wall ms
    per call, device ms per call, [(name, ms per call)] of the device
    entries by total time); device ms is None when the profiler's window
    is not complete.  On an H100 the profiler dropped device records now
    and then: none, or one of ten, of a kernel's records in some windows,
    and up to 1 in 5,000 in a window of 20,000 launches.  So a window
    counts only when its device records fall short of the host's launch
    and copy calls by at most 1% (one record for a small window), which
    bounds the error of the device time to about that share, and is run
    again otherwise, up to ``tries`` times."""
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
        dev = sorted(((e.key, e.self_device_time_total / 1e3 / calls)
                      for e in entries), key=lambda t: -t[1])
        total = sum(ms for _, ms in dev)
        api = sum(e.count for e in rows if e.device_type == DeviceType.CPU
                  and e.key in LAUNCH_APIS)
        records = sum(e.count for e in entries)
        if total > 0 and records >= api - max(1, api // 100):
            return wall, total, dev
        print(f"  (profiler window incomplete: {records} device records for "
              f"{api} host launch and copy calls)", flush=True)
    return wall, None, dev


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
                     twin_calls: int = 10):
    """Run ``kern`` and ``twin`` (each returns a tensor or a tuple of
    tensors) on the card, check dtype, shape and max_abs_err 0, and time
    both (the twin's profiler window over ``twin_calls`` calls).  Returns
    {"max_abs_err", "ms", "plain_ms"} when timed."""
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
    k_dev = device_profile(kern, calls=10)[1]
    t_dev = device_profile(twin, calls=twin_calls)[1]
    print(f"kernel {name} {shape}: max_abs_err {err} vs torch twin; "
          f"wrapper call {ms:.4f} ms, twin {plain_ms:.4f} ms (median of "
          f"{RUNS}, CUDA events); device time per call (profiler): "
          f"kernel {k_dev} ms, twin {t_dev} ms", flush=True)
    check(err == 0, f"{name} disagrees with its torch twin on {shape}")
    return {"max_abs_err": err, "ms": ms, "plain_ms": plain_ms}


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


def kernel_phase(dev) -> dict:
    import torch

    from nhwcodec_tpu_torch.models import device_decode as tdd
    from nhwcodec_tpu_torch.ops import dwt

    rng = np.random.default_rng(SEED)
    # K1 gets the (B,256,256) corner of the (B,512,512) Y plane
    y512 = torch.from_numpy(planes(rng, B, 512, -2000, 2000)).to(dev)
    k1_in = y512[:, :256, :256]
    jp = torch.from_numpy(planes(rng, B, 512, -2, 3)).to(dev)
    dp_np, n_waves, ok = tdd.mark_depth_planes(mark_lists(rng, B))
    check(ok and n_waves >= 3, f"depth planes: ok={ok} n_waves={n_waves}")
    dp = torch.from_numpy(dp_np).to(dev)
    uv = torch.from_numpy(sentinel_planes(rng, 2 * B)).to(dev)

    cases = [
        ("synth_level", f"({B},256,256) view of ({B},512,512) int16",
         lambda: dwt.synth_level(k1_in), lambda: dwt.synth_level_ref(k1_in)),
        ("y_stage2_full", f"({B},512,512) int16 + depth, n_waves={n_waves}",
         lambda: dwt.y_stage2_full(jp, dp, n_waves),
         lambda: dwt.y_stage2_full_ref(jp, dp, n_waves)),
        ("uv_synth", f"(2x{B},256,256) int16 with sentinels",
         lambda: dwt.uv_synth(uv), lambda: dwt.uv_synth_ref(uv)),
    ]
    out = {name: compare_and_time(name, shape, kern, twin)
           for name, shape, kern, twin in cases}
    # the waves did work on these inputs: one wave fewer changes pixels
    fewer = dwt.y_stage2_full(jp, dp, n_waves - 1)
    check(bool((fewer != dwt.y_stage2_full_ref(jp, dp, n_waves)).any()),
          "dering waves had no effect on the test planes")
    # the residue bound is strict: res = 116 at (40, 10) keeps the cell,
    # res = 112 at (80, 100) smooths it (tests/test_torch_dwt.py)
    edge = np.zeros((1, 512, 512), np.int16)
    edge[0, 10, 19:22] = (685, 100, 686)
    edge[0, 100, 39:42] = (686, 100, 686)
    edge_dp, _, _ = tdd.mark_depth_planes([[(20 << 8) | 10,
                                            (40 << 8) | 100]])
    et = torch.from_numpy(edge).to(dev)
    edt = torch.from_numpy(edge_dp).to(dev)
    check(torch.equal(dwt.y_stage2_full(et, edt, 1),
                      dwt.y_stage2_full_ref(et, edt, 1)),
          "y_stage2_full differs from its twin at the residue bound")

    # K7-K9 at the HQ and fallback paths' shapes; K8 on the transposed
    # near-flat planes with the depth planes above, so its waves fire
    t = dwt.unnorm_rows_t_ref(jp).contiguous()
    y9 = torch.from_numpy(planes(rng, B, 512, -20000, 20000)).to(dev)
    cases = [
        ("synth_unnorm_rows_t", f"({B},512,512) int16",
         lambda: dwt.synth_unnorm_rows_t(y512),
         lambda: dwt.unnorm_rows_t_ref(y512).contiguous()),
        ("synth_norm_rows_clip_waves",
         f"({B},512,512) int16 + depth, n_waves={n_waves}",
         lambda: dwt.synth_norm_rows_clip_waves(t, dp, n_waves),
         lambda: dwt.synth_norm_rows_clip_waves_ref(t, dp, n_waves)),
        ("synth_norm_rows_clip", f"({B},512,512) int16",
         lambda: dwt.synth_norm_rows_clip(y9),
         lambda: dwt.synth_norm_rows_clip_ref(y9)),
    ]
    out.update({name: compare_and_time(name, shape, kern, twin)
                for name, shape, kern, twin in cases})
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
    out["smooth_marks_seq"] = compare_and_time(
        "smooth_marks_seq",
        f"({B},512,512) int16, {int(valid.sum())} out-of-order marks",
        lambda: dwt.smooth_marks_seq(*k_in(), recs, valid),
        lambda: dwt.smooth_marks_seq_ref(*t_in(), recs, valid),
        twin_calls=1)   # one step of ~12 launches per record index
    return out


def colorspace_phase(dev) -> None:
    import torch

    from nhwcodec_tpu.models import decoder
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
    from nhwcodec_tpu.models import decoder, encoder
    from nhwcodec_tpu.utils import fixtures
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    gens = list(fixtures.GENERATORS.values()) + list(
        fixtures.EXTREME_GENERATORS.values())
    t0 = time.perf_counter()
    q20 = [encoder.encode(gens[i % len(gens)](), 20) for i in range(B)]
    mixed = [encoder.encode(gens[i](), q)
             for i, q in enumerate((4, 14, 19, 21))]
    t_enc = time.perf_counter() - t0
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
    from nhwcodec_tpu.models import decoder
    from nhwcodec_tpu.ops import dc_plane, entropy
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
    from nhwcodec_tpu.models import decoder, encoder
    from nhwcodec_tpu.utils import fixtures
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    gens = list(fixtures.GENERATORS.values()) + list(
        fixtures.EXTREME_GENERATORS.values())
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

    print_profile(f"decode, batch {B} q23 in one chunk", one_chunk)
    print_breakdown(f"decode breakdown, batch {B} q23 in one chunk",
                    *host_breakdown(one_chunk, decode_targets()))
    return launches


def fallback_phase(dev) -> dict:
    """The sequential mark-scan fallback, forced by refusing the depth
    planes: 4 q20 and 4 q23 streams, chunks of 4 (K7, the scatter, the
    scan, K9)."""
    from nhwcodec_tpu.models import decoder, encoder
    from nhwcodec_tpu.utils import fixtures
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
    from nhwcodec_tpu.utils import fixtures

    gens = list(fixtures.GENERATORS.values()) + list(
        fixtures.EXTREME_GENERATORS.values())
    rand = rng.integers(0, 256, (B - len(gens), 512, 512, 3), dtype=np.uint8)
    return np.concatenate([np.stack([g() for g in gens]), rand])


def requant_states(images: np.ndarray, q: int):
    """The host encoder's Y state at the requant tail (after mark +
    offset), as tests/test_device_requant.py builds it."""
    from nhwcodec_tpu import tables as T
    from nhwcodec_tpu.ops import analysis, colorspace, prefilter, requant

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


def encode_kernel_phase(dev, images: np.ndarray) -> dict:
    import torch

    from nhwcodec_tpu_torch.ops import colorspace, dwt

    rng = np.random.default_rng(SEED + 1)
    out = {}
    # K4 at the encode path's shapes: Y levels 1 and 2, U+V levels 1 and 2
    for b, n in ((B, 512), (B, 256), (2 * B, 256), (2 * B, 128)):
        for lo, hi in ((-32768, 32768), (-1800, 1800)):
            x = torch.from_numpy(rng.integers(lo, hi, (b, n, n)).astype(
                np.int16)).to(dev)
            res = compare_and_time(
                "analysis_level_jp", f"({b},{n},{n}) int16 in [{lo},{hi})",
                lambda: dwt.analysis_level_jp(x),
                lambda: dwt.analysis_level_jp_ref(x), timed=lo == -32768)
            if n == 512 and res is not None:
                out["analysis_level_jp"] = res
    rgb = torch.from_numpy(images).to(dev)
    out["colorspace_down420"] = compare_and_time(
        "colorspace_down420", f"({B},512,512,3) uint8, q20",
        lambda: colorspace.rgb_to_yuv420(rgb, 20),
        lambda: colorspace.rgb_to_yuv420_ref(rgb, 20))
    # K5 on real q20 encode states and on dense chain planes.  K5 and its
    # twin update jpeg and process in place, as the encode path runs
    # them, so each call takes its own clone of the inputs, made before
    # any timing: the times hold no copies
    for what, arrays in (("real q20 states", requant_states(images, 20)),
                         ("chain planes", chain_planes(rng, B))):
        args = [torch.from_numpy(a).to(dev) for a in arrays]
        timed = what.startswith("r")
        k_in = fresh_inputs(args, 4 + RUNS + PROFILE_TRIES * 10 if timed
                            else 1)
        t_in = fresh_inputs(args, 4 + RUNS + PROFILE_TRIES if timed else 1)
        res = compare_and_time(
            "requant_tail", f"({B},512,512) x2 + ({B},256,256), {what}",
            lambda: dwt.requant_tail(*k_in()),
            lambda: dwt.requant_tail_ref(*t_in()), timed=timed,
            twin_calls=1)   # ~11,500 launches per twin call
        out.setdefault("requant_tail", res)
    return out


def encode_colorspace_phase(dev, images: np.ndarray) -> None:
    import torch

    from nhwcodec_tpu.ops import colorspace as hcs
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
    import nhwcodec_tpu
    from nhwcodec_tpu.models import encoder as host_encoder
    from nhwcodec_tpu.ops import prefilter, requant
    from nhwcodec_tpu_torch.models import device_stages as tds
    from nhwcodec_tpu_torch.kernels import build
    from nhwcodec_tpu_torch.models import encoder as tenc
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    t0 = time.perf_counter()
    want = [nhwcodec_tpu.encode(img, 20) for img in images]
    print(f"host encoder: {1e3 * (time.perf_counter() - t0) / B:.1f} ms/img "
          f"at q20", flush=True)

    build.reset_launches()
    t0 = time.perf_counter()
    got, m = tdp.encode_batch_device(images, 20, workers=1, chunk=B,
                                     device=dev)
    t_first = time.perf_counter() - t0
    launches = {k: build.LAUNCHES[k] for k in ENCODE_KERNELS}
    check(m.failures == 0, f"encode failures: {m.failures}")
    for i, (w, g) in enumerate(zip(want, got)):
        check(g == w, f"q20 stream {i} differs from nhwcodec_tpu.encode")
    print(f"encode: {B} q20 images byte-identical to nhwcodec_tpu.encode; "
          f"launches {launches}", flush=True)
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

    for q in (23, 22, 21, 19, 17, 16, 12, 8, 1):
        sel = images[[q % B, (q + 5) % B, 11 + q % 5, (3 * q) % B]]
        out, mq = tdp.encode_batch_device(sel, q, device=dev)
        check(mq.failures == 0, f"q{q}: {mq.failures} failures")
        for i, (img, g) in enumerate(zip(sel, out)):
            check(g == nhwcodec_tpu.encode(img, q),
                  f"q{q} stream {i} differs from nhwcodec_tpu.encode")
    print("encode: batches of 4 at q23/22/21/19/17/16/12/8/1 through the "
          "default pool byte-identical to nhwcodec_tpu.encode", flush=True)

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


def main() -> int:
    os.environ.setdefault("NHW_NATIVE_PGO", "0")  # no host PGO training run
    import torch

    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is false",
              file=sys.stderr)
        return 1
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
    build.load()
    print(f"kernel build (nvcc, sm_90a) + load: "
          f"{time.perf_counter() - t0:.1f} s -> {build.lib_path()}",
          flush=True)

    # the paths first: a profiler window of very many launches (the K5
    # twin's) can leave later windows incomplete
    images = encode_images(np.random.default_rng(SEED))
    launches = decode_phase(dev)
    launches.update(hq_decode_phase(dev))
    launches.update(fallback_phase(dev))
    launches.update(encode_phase(dev, images))
    timings = kernel_phase(dev)
    timings.update(encode_kernel_phase(dev, images))
    colorspace_phase(dev)
    encode_colorspace_phase(dev, images)
    check(not any(m == "jax" or m.startswith("jax.") for m in sys.modules),
          "jax was imported")

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
