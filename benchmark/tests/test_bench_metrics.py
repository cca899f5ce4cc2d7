"""Each metric reader on a small synthetic profiler trace, the annotation
rule of the device sums, and the breakdown."""

from __future__ import annotations

import pytest

from benchmark import cells, roofline, trace


def X(name, cat, ts, dur, tid=1):
    return {"ph": "X", "name": name, "cat": cat, "ts": float(ts),
            "dur": float(dur), "tid": tid}


def _events():
    """A slice of 1000 us (two requests of 2 images) with: kernels of 100
    and 50 us, a copy of 50 us that overlaps the first kernel by 20 us, a
    set of 10 us; the program's ranges on two threads; the device's
    annotations (the ``nhw.*`` and ``bench.*`` ranges on the card's
    timeline), which span nearly everything and must not count."""
    return [
        X("bench.request", "user_annotation", 0, 600),
        X("bench.request", "user_annotation", 600, 400),
        X("bench.request", "gpu_user_annotation", 0, 1000, tid=7),
        X("nhw.encode.front", "gpu_user_annotation", 0, 990, tid=7),
        X("nhw.encode.front", "kernel", 5, 900, tid=7),  # by name: out
        X("colorspace_band", "kernel", 100, 100, tid=7),
        X("Memcpy HtoD", "gpu_memcpy", 180, 50, tid=8),
        X("analysis_cluster", "kernel", 700, 50, tid=7),
        X("Memset", "gpu_memset", 900, 10, tid=7),
        X("nhw.encode.front", "user_annotation", 10, 200, tid=1),
        X("nhw.encode.front", "user_annotation", 50, 100, tid=1),  # nested
        X("nhw.encode.front", "user_annotation", 10, 300, tid=2),
        X("nhw.encode.host_stage", "user_annotation", 300, 400, tid=1),
        X("nhw.scans.ll2_stage", "user_annotation", 400, 100, tid=1),
        X("nhw.scans.uv", "user_annotation", 450, 100, tid=1),
        X("aten::add", "cpu_op", 0, 5000),          # outside: clipped
        X("late kernel", "kernel", 1500, 100, tid=7),  # past the slice
    ]


def _slice(stages=("front",), quality=20):
    return trace.make_slice(_events(), images=4, requests=2,
                            quality=quality, stages=list(stages))


def test_slice_bounds_from_the_harness_ranges():
    sl = _slice()
    assert (sl.t0, sl.t1, sl.window_s) == (0.0, 1000.0, 0.001)
    assert trace.make_slice([X("k", "kernel", 0, 1)], 1, 1, 20, []) is None


def test_device_rule_leaves_annotations_out():
    sl = _slice()
    # kernels 100 + 50, the copy's 30 us past the kernel, the set's 10
    assert trace.busy_s(sl) == pytest.approx(190e-6)
    assert trace.kernel_s(sl) == pytest.approx(150e-6)
    assert not trace.is_device(X("nhw.x", "kernel", 0, 1))
    assert not trace.is_device(X("bench.request", "gpu_user_annotation",
                                 0, 1))
    assert trace.is_device(X("k", "Kernel", 0, 1))


def test_idle_share_reads():
    for name in ("idle_share.enc", "idle_share.dec"):
        assert cells.reader(name)(_slice()) == pytest.approx(81.0)
    empty = trace.Slice([], 0, 1000, 4, 2, 20, [])
    assert cells.reader("idle_share.enc")(empty) is None


def test_host_range_readers():
    sl = _slice()
    # thread 1: 10..210 (the nested range counts once), thread 2: 10..310
    assert cells.reader("front_ms.enc")(sl) == pytest.approx(0.5 / 4)
    assert cells.reader("host_stage_ms.enc")(sl) == pytest.approx(0.4 / 4)
    # 400..500 and 450..550 on one thread: 150 us
    assert cells.reader("scans_ms.enc")(sl) == pytest.approx(0.15 / 4)
    empty = trace.Slice([], 0, 1000, 4, 2, 20, [])
    for name in ("front_ms.enc", "host_stage_ms.enc", "scans_ms.enc",
                 "device_ms.dec", "kernel_roofline.enc"):
        assert cells.reader(name)(empty) is None


def test_device_ms_dec():
    assert cells.reader("device_ms.dec")(_slice(("decode",))) == \
        pytest.approx(0.19 / 4)


@pytest.mark.parametrize("name,stages,quality", [
    ("kernel_roofline.enc", ("front",), 20),
    ("kernel_roofline.enc", ("front", "scans"), 8),
    ("kernel_roofline.dec", ("decode",), 20)])
def test_kernel_roofline(name, stages, quality):
    got = cells.reader(name)(_slice(stages, quality))
    want = 100 * roofline.bound_s(list(stages), quality, 4) / 150e-6
    assert got == pytest.approx(want)


def test_roofline_bounds_by_hand():
    # the front at q20: K6 by bytes, K4 by bytes (6 a pixel at 30 ops
    # is 5 ops a byte, the int32 peak is under 5x the HBM one), K5 by ops
    k6 = max(1441792 / 3.35e12, 26 * 262144 / roofline.PEAK_OPS)
    k4 = sum(max(6 * b * n * n / 3.35e12, 30 * b * n * n / roofline.PEAK_OPS)
             for b, n in ((1, 512), (1, 256), (2, 256), (2, 128)))
    k5 = max(12 * 65536 / 3.35e12, 110 * 65536 / roofline.PEAK_OPS)
    assert roofline.front_s(20) == pytest.approx(k6 + k4 + k5)
    assert roofline.front_s(6) == pytest.approx(k6 + k4)
    assert roofline.scans_s(8) > roofline.scans_s(12) > roofline.scans_s(20)
    assert roofline.bound_s(["front", "scans"], 8, 16) == pytest.approx(
        16 * (roofline.front_s(8) + roofline.scans_s(8)))


def test_breakdown_names_gaps_by_the_host_range():
    b = trace.breakdown(_slice())
    assert b["device_ops"][0] == ["colorspace_band", pytest.approx(100e-6)]
    assert {n for n, _ in b["device_ops"]} == {
        "colorspace_band", "analysis_cluster", "Memcpy HtoD", "Memset"}
    gaps = dict(b["idle_gaps"])
    # 0..100 falls in the front ranges; 230..700 is named by the latest
    # started of the ranges that cover its middle (465: the host stage,
    # the LL2 stage and the UV range); 750..900 and 910..1000 fall
    # outside every range
    assert gaps["nhw.encode.front"] == pytest.approx(100e-6)
    assert gaps["nhw.scans.uv"] == pytest.approx(470e-6)
    assert gaps["outside the nhw ranges"] == pytest.approx(240e-6)
    assert sum(gaps.values()) == pytest.approx(810e-6)
    assert len(b["device_ops"]) <= 10 and len(b["idle_gaps"]) <= 10

