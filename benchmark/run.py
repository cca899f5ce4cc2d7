"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python -m benchmark.run --workload <cell> --seed <n> --seconds <s> \\
        --trace <0|1>

From the root of a checkout.  Set-up makes the cell's pool of images from
the seed (and, for a decode cell, their streams with the reference
encoder, timed apart and left out of ``setup_s``), loads the program and
its kernels, and warms up every request the window will send.  The window is one closed-loop client: it sends a
request of the traffic's size, waits for the reply, sends the next at
once, and stops at the first reply after ``--seconds``.  Rates are taken
over every image and the whole window, the tail over every request.  With
``--trace 1`` a few requests inside the window are profiled and the
per-layer metrics are read from them.  Once the window has closed the
kept answers are compared with the plain reference, and the numbers
compared are printed beside their limits, last on standard error and last
in the result line, which is the last line of standard output.

Without a CUDA card, or with fewer than the cell asks for, the run fails
and prints no result.  So does a run after which ``jax``, ``jaxlib``,
``flax`` or ``nhwcodec_tpu`` is loaded.
"""

from __future__ import annotations

import argparse
import gc
import importlib
import json
import os
import sys
import time

import numpy as np

from benchmark import cells, check, trace
from benchmark.images import make_pool

MEGAPIXELS = 512 * 512 / 1e6
FORBIDDEN = ("jax", "jaxlib", "flax", "nhwcodec_tpu")
# the build and kernel caches, inside the checkout at fixed paths
CACHE_DIRS = {"TORCH_EXTENSIONS_DIR": "build/torch_extensions",
              "TRITON_CACHE_DIR": "build/triton"}


def process_start() -> float:
    """This process's start on the ``time.time()`` clock, from /proc (to
    the kernel's clock tick); the time of this call where /proc is not
    there."""
    try:
        with open("/proc/self/stat") as f:
            start_ticks = int(f.read().rsplit(")", 1)[1].split()[19])
        with open("/proc/stat") as f:
            btime = next(int(line.split()[1]) for line in f
                         if line.startswith("btime"))
        return btime + start_ticks / os.sysconf("SC_CLK_TCK")
    except (OSError, ValueError, IndexError, StopIteration):
        return time.time()


def forbidden_modules() -> list[str]:
    """Loaded modules whose top-level name is one of ``FORBIDDEN``,
    compared whole (``nhwcodec_tpu_torch`` is not ``nhwcodec_tpu``)."""
    return sorted({m.split(".")[0] for m in list(sys.modules)}
                  & set(FORBIDDEN))


def _entry(path: str):
    module, name = path.rsplit(".", 1)
    return getattr(importlib.import_module(module), name)


def _requests(pool_size: int, per_request: int) -> list[list[int]]:
    """The pool indices of each distinct request, in the order the window
    cycles them: request k takes the next ``per_request`` images of the
    pool, wrapping."""
    period = pool_size // np.gcd(pool_size, per_request)
    return [[(k * per_request + j) % pool_size for j in range(per_request)]
            for k in range(period)]


def run_cell(cell: cells.Cell, seed: int, seconds: float, traced: bool,
             device: str, pool_size: int | None = None,
             per_request: int | None = None, log=None,
             split: dict | None = None) -> dict:
    """One run of ``cell`` on one device: the result's fields (without
    the device's name), the checks and the set-up split (``split``: the
    parts already timed).  ``pool_size`` and ``per_request`` shrink the
    pool and the requests for tests on the CPU."""
    import torch

    t_start = process_start()
    log = log or (lambda msg: print(msg, file=sys.stderr, flush=True))
    tr, q = cell.traffic, cell.quality
    per_request = per_request or int(tr["images_per_request"])
    split = dict(split or {})

    t = time.time()
    call = _entry(tr["entry"])
    split["program_import_s"] = time.time() - t
    dev = torch.device(device)
    if dev.type == "cuda":
        t = time.time()
        torch.cuda.set_device(dev)
        torch.zeros(1, device=dev)
        split["cuda_context_s"] = time.time() - t
        t = time.time()
        from nhwcodec_tpu_torch.kernels import build
        build.load()
        split["kernel_load_s"] = time.time() - t
    t = time.time()
    pool = make_pool(seed)
    if pool_size:
        pool = pool[:pool_size]
    split["inputs_s"] = time.time() - t
    encode = tr["kind"] == "encode"
    if encode:
        inputs = pool
    else:
        # the reference's work is the yardstick's, not the program's:
        # timed apart and left out of setup_s
        t = time.time()
        inputs = check.reference_streams(pool, q)
        split["reference_s"] = time.time() - t

    requests = _requests(len(pool), per_request)
    batches = [np.ascontiguousarray(inputs[r]) if encode
               else [inputs[i] for i in r] for r in requests]
    options = dict(tr.get("options", {}))

    def send(k: int):
        b = batches[k % len(batches)]
        if encode:
            return call(b, q, device=dev, **options)
        return call(b, device=dev, **options)

    t = time.time()
    for k in range(len(batches)):   # every distinct request, once
        send(k)
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)
        torch.cuda.reset_peak_memory_stats(dev)
    split["warmup_s"] = time.time() - t
    setup_s = time.time() - t_start - split.get("reference_s", 0.0)

    # the requests whose answers are kept for the check: each with chance
    # 1 / keep_every, drawn from the seed, and the last one
    keep_rng = np.random.default_rng(int(seed) % (1 << 63))
    keep_p = 1.0 / int(tr.get("keep_every", 1))
    n_traced = int(tr.get("trace_requests", 2)) if traced else 0
    prof = None
    lat, kept, attempted, missing = [], [], 0, 0
    cpu0 = time.process_time()
    t0 = time.perf_counter()
    deadline = t0 + seconds
    k = 0
    while True:
        if k == 1 and n_traced:
            prof = torch.profiler.profile(
                activities=[torch.profiler.ProfilerActivity.CPU]
                + ([torch.profiler.ProfilerActivity.CUDA]
                   if dev.type == "cuda" else []),
                experimental_config=torch.profiler._ExperimentalConfig(
                    profile_all_threads=True))
            prof.__enter__()
        a = time.perf_counter()
        if prof is not None:
            with torch.profiler.record_function(trace.REQUEST_RANGE):
                answers, _ = send(k)
        else:
            answers, _ = send(k)
        b = time.perf_counter()
        if prof is not None and k == n_traced:
            prof.__exit__(None, None, None)
            traced_prof, prof = prof, None
        idxs = requests[k % len(requests)]
        lat.append(b - a)
        attempted += len(idxs)
        answers = list(answers or [])
        missing += sum(x is None for x in answers) + max(
            0, len(idxs) - len(answers))
        last = (idxs, answers)
        if (keep_rng.random() < keep_p
                or (n_traced and 1 <= k <= n_traced)):
            kept.append(last)
        del answers
        k += 1
        if b >= deadline and (not n_traced or k > n_traced):
            break
    if not kept or kept[-1] is not last:
        kept.append(last)      # the last request is always compared
    del last
    window_s = time.perf_counter() - t0
    cpu_s = time.process_time() - cpu0

    peak = 0
    if dev.type == "cuda":
        peak = int(torch.cuda.max_memory_allocated(dev))
    gc.collect()
    if dev.type == "cuda":
        torch.cuda.empty_cache()

    ok = attempted - missing
    lat_ms = np.array(lat) * 1e3
    side = "enc" if encode else "dec"
    e2e = {f"{side}_mpix_per_s": ok * MEGAPIXELS / window_s,
           f"{side}_p90_ms": float(np.percentile(lat_ms, 90)),
           "setup_s": setup_s}
    result = {"requests": len(lat), "window_s": window_s,
              "attempted": attempted, "peak": peak, "split": split}
    if n_traced:
        events = trace.read_events(traced_prof)
        sl = trace.make_slice(events, n_traced * per_request,
                              n_traced, q, tr.get("device_stages", []))
        values = {}
        for m in cell.per_layer:
            v = cells.reader(m["name"])(sl) if sl else None
            if v is not None:
                values[m["name"]] = float(v)
        busy = (trace.busy_s(sl), sl.window_s) if sl else None
        result["metrics"] = {m["name"]: {"value": values[m["name"]],
                                         "unit": m["unit"]}
                             for m in cell.per_layer if m["name"] in values}
        if busy is not None:
            result["busy_s"], result["traced_window_s"] = busy
        if sl is not None:
            result["breakdown"] = trace.breakdown(sl)
            cats = {}
            for e in events:
                cats[e.get("cat")] = cats.get(e.get("cat"), 0) + 1
            log(f"trace: {len(events)} events by category {cats}")
    else:
        missing_e2e = [m["name"] for m in cell.end_to_end
                       if m["name"] not in e2e]
        if missing_e2e:
            raise KeyError(f"the harness computes no {missing_e2e}")
        result["metrics"] = {m["name"]: {"value": float(e2e[m["name"]]),
                                         "unit": m["unit"]}
                             for m in cell.end_to_end}
    log(f"window: {len(lat)} requests, {attempted} images, {window_s:.3f} s;"
        f" latency ms p50 {np.percentile(lat_ms, 50):.2f} p90 "
        f"{np.percentile(lat_ms, 90):.2f} max {lat_ms.max():.2f}; set-up "
        f"{setup_s:.3f} s {json.dumps(split)}")
    # the host's own /proc/stat is no witness in a sandboxed machine; the
    # process's CPU time tells a slow host (same CPU an image) from more work
    log(f"process CPU in the window: {cpu_s:.2f} s, {cpu_s / window_s:.2f} "
        f"of {os.cpu_count()} cores, {1e3 * cpu_s / max(attempted, 1):.1f} "
        "ms an image")
    t = time.time()
    want = (check.reference_streams(pool, q) if encode
            else check.reference_images(inputs))
    checks = check.compare(kept, want)
    # failed: every image that never came, and every kept one that came
    # wrong (an absent kept answer is counted once, as never come)
    absent_kept = sum(len(idxs) - sum(a is not None for a in ans)
                      for idxs, ans in kept)
    result["failed"] = missing + checks["images_wrong"]["value"] - absent_kept
    result["correct"] = check.passed(checks)
    result["checks"] = checks
    log(f"reference and comparison: {time.time() - t:.3f} s")
    return result


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    for var, rel in CACHE_DIRS.items():
        os.environ[var] = str(cells.ROOT / rel)
    cell = cells.find(args.workload)
    split = {"interpreter_s": time.time() - process_start()}
    t = time.time()
    import torch
    split["torch_import_s"] = time.time() - t

    if not torch.cuda.is_available():
        print("benchmark: torch.cuda.is_available() is false; no result",
              file=sys.stderr)
        return 3
    if torch.cuda.device_count() < cell.chips:
        print(f"benchmark: {cell.name} needs {cell.chips} CUDA devices, "
              f"{torch.cuda.device_count()} visible; no result",
              file=sys.stderr)
        return 3
    if cell.chips != 1:
        print(f"benchmark: {cell.name} asks for {cell.chips} cards; this "
              "harness drives one; no result", file=sys.stderr)
        return 3
    r = run_cell(cell, args.seed, args.seconds, bool(args.trace), "cuda:0",
                 split=split)
    bad = forbidden_modules()
    if bad:
        print(f"benchmark: loaded after the window: {', '.join(bad)}; no "
              "result", file=sys.stderr)
        return 4
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
              "count": cell.chips, "memory_peak_bytes": r["peak"]}
    if args.trace:
        device["busy_s"] = r.get("busy_s", 0.0)
        device["window_s"] = r.get("traced_window_s", 0.0)
    out = {"correct": r["correct"], "attempted": r["attempted"],
           "failed": r["failed"], "metrics": r["metrics"], "device": device}
    if "breakdown" in r:
        out["breakdown"] = r["breakdown"]
    out["setup_split_s"] = r["split"]
    out["checks"] = r["checks"]
    for line in check.lines(r["checks"]):
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
