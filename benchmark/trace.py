"""The traced slice of a run: the profiler's records and what they say.

A traced run profiles a few requests inside its window with
``torch.profiler`` (the host's every thread, the chunks' pool too, and the
card), writes the Chrome trace to a temporary file, reads it back as a
list of complete events and hands a ``Slice`` to the metric readers.
Each profiled request sits in a ``bench.request`` range of the harness's
own; the slice runs from the first one's start to the last one's end.

Device entries are the kernels, copies and sets on the card's timeline.
As in ``chip_smoke.device_rows`` (commit a4a43cf), the ranges of
``torch.profiler.record_function`` that also show on the device's
timeline as annotations (the program's ``nhw.*``, the harness's
``bench.*``) are left out: they span the work inside them, and counting
them as busy would read the card as busy while it waits.
"""

from __future__ import annotations

import json
import os
import tempfile
from dataclasses import dataclass, field

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")
ANNOTATION_PREFIXES = ("nhw.", "bench.")
HOST_RANGE_CAT = "user_annotation"
REQUEST_RANGE = "bench.request"


@dataclass
class Slice:
    """The profiled requests of one run: ``events`` are the trace's
    complete events (``name``, ``cat``, ``ts`` and ``dur`` in
    microseconds, ``tid``), ``t0``/``t1`` the slice's bounds on the
    trace's clock; ``images`` and ``requests`` in the slice; the cell's
    ``quality`` and the device ``stages`` its path must run
    (``roofline.STAGES``)."""

    events: list
    t0: float
    t1: float
    images: int
    requests: int
    quality: int
    stages: list = field(default_factory=list)

    @property
    def window_s(self) -> float:
        return (self.t1 - self.t0) / 1e6


def is_device(e: dict) -> bool:
    """A kernel, copy or set on the card's timeline, not an annotation."""
    return (e.get("cat", "").lower() in DEVICE_CATS
            and not e.get("name", "").startswith(ANNOTATION_PREFIXES))


def _clip(e: dict, t0: float, t1: float) -> tuple[float, float] | None:
    a, b = max(e["ts"], t0), min(e["ts"] + e["dur"], t1)
    return (a, b) if b > a else None


def _union(spans: list) -> list:
    out: list = []
    for a, b in sorted(spans):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def busy_intervals(sl: Slice) -> list:
    """The merged intervals in which a device entry ran, in the slice."""
    return _union([s for e in sl.events if is_device(e)
                   for s in [_clip(e, sl.t0, sl.t1)] if s])


def busy_s(sl: Slice) -> float:
    return sum(b - a for a, b in busy_intervals(sl)) / 1e6


def kernel_s(sl: Slice) -> float:
    """The summed time of the kernels in the slice (copies and sets left
    out); kernels that overlap each count whole."""
    return sum(b - a for e in sl.events
               if is_device(e) and e["cat"].lower() == "kernel"
               for a, b in [_clip(e, sl.t0, sl.t1) or (0, 0)]) / 1e6


def host_range_s(sl: Slice, match) -> float:
    """Host seconds inside the program's ranges whose name satisfies
    ``match``, summed over threads (a thread's nested or repeated ranges
    count once)."""
    by_tid: dict = {}
    for e in sl.events:
        if (e.get("cat") == HOST_RANGE_CAT and match(e.get("name", ""))):
            s = _clip(e, sl.t0, sl.t1)
            if s:
                by_tid.setdefault(e.get("tid"), []).append(s)
    return sum(b - a for spans in by_tid.values()
               for a, b in _union(spans)) / 1e6


def breakdown(sl: Slice, top: int = 10) -> dict:
    """The device entries that took most time, and the device's idle time
    by the host range it fell in (the innermost ``nhw.*`` range on any
    thread that covers the gap's middle), in seconds."""
    ops: dict = {}
    for e in sl.events:
        if is_device(e):
            s = _clip(e, sl.t0, sl.t1)
            if s:
                ops[e["name"]] = ops.get(e["name"], 0.0) + (s[1] - s[0]) / 1e6
    ranges = [(e["ts"], e["ts"] + e["dur"], e["name"]) for e in sl.events
              if e.get("cat") == HOST_RANGE_CAT
              and e.get("name", "").startswith("nhw.")]
    gaps: dict = {}
    edge = sl.t0
    for a, b in busy_intervals(sl) + [[sl.t1, sl.t1]]:
        if a > edge:
            mid = (edge + a) / 2
            inside = [r for r in ranges if r[0] <= mid < r[1]]
            name = (max(inside)[2] if inside else "outside the nhw ranges")
            gaps[name] = gaps.get(name, 0.0) + (a - edge) / 1e6
        edge = max(edge, b)
    def ranked(d):
        return [[k, v] for k, v in sorted(d.items(), key=lambda t: -t[1])
                ][:top]
    return {"device_ops": ranked(ops), "idle_gaps": ranked(gaps)}


def read_events(prof) -> list:
    """The complete events of a finished ``torch.profiler.profile``,
    through a Chrome trace in a temporary file that is removed."""
    with tempfile.TemporaryDirectory(prefix="bench-trace-") as d:
        path = os.path.join(d, "trace.json")
        prof.export_chrome_trace(path)
        with open(path) as f:
            data = json.load(f)
    events = data["traceEvents"] if isinstance(data, dict) else data
    return [e for e in events if e.get("ph") == "X" and "dur" in e]


def make_slice(events: list, images: int, requests: int, quality: int,
               stages: list) -> Slice | None:
    """The slice between the first ``bench.request`` range's start and
    the last one's end, or None when the trace holds none."""
    reqs = [e for e in events if e.get("name") == REQUEST_RANGE
            and e.get("cat") == HOST_RANGE_CAT]
    if not reqs:
        return None
    t0 = min(e["ts"] for e in reqs)
    t1 = max(e["ts"] + e["dur"] for e in reqs)
    return Slice(events, t0, t1, images, requests, quality, list(stages))
