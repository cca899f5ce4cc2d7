"""The comparison that decides ``correct``: a run on the CPU, with the
harness's look for a card skipped, comes out correct, and comes out not
correct with the timed path broken underneath; each cell's control (the
reference with a guarantee broken) comes out not correct.

Small sizes: a pool of 4 images, 2 a request, a window of one request.
"""

from __future__ import annotations

import numpy as np
import pytest

from benchmark import cells, check, control, run
from benchmark.images import make_pool
from nhwcodec_tpu_torch.models import encoder as tenc
from nhwcodec_tpu_torch.parallel import device_pipeline as dp

SEED = 3000000019
# Cells measured on the card and left out of BENCHMARK.json, since their
# rates spread past any bound allowed: the pool encode and the decode.
# Their files stay, and these entries are all they need to come back.
LEFT_OUT = {
    "q20.enc.pool": {
        "workload": {"name": "q20.enc.pool", "config": "nhw_q20",
                     "traffic": "enc.pool", "chips": 1, "why": "pool"},
        "end_to_end": [],
        "per_layer": [{"name": "host_stage_ms.enc", "unit": "ms",
                       "better": "lower", "source": "program_span",
                       "layer": "host encode stage",
                       "moves": "enc_mpix_per_s"}],
    },
    "q20.dec.pool": {
        "workload": {"name": "q20.dec.pool", "config": "nhw_q20",
                     "traffic": "dec.pool", "chips": 1, "why": "decode"},
        "end_to_end": [{"name": "dec_mpix_per_s", "unit": "MP/s",
                        "better": "higher", "bound": 0.25,
                        "source": "host_clock"}],
        "per_layer": [{"name": n, "unit": u, "better": b,
                       "source": "device_trace", "layer": layer,
                       "moves": "dec_mpix_per_s"}
                      for n, u, b, layer in (
                          ("device_ms.dec", "ms", "lower", "decode back end"),
                          ("kernel_roofline.dec", "%", "higher", "kernels"),
                          ("idle_share.dec", "%", "lower", "device"))],
    },
}
NAMES = ["q20.enc.pool", "q20.dec.pool", "q20.enc.scans", "q8.enc.scans"]


def _find(name: str) -> cells.Cell:
    spec = cells.load_spec()
    if name in LEFT_OUT:
        entries = LEFT_OUT[name]
        spec["workloads"].append(entries["workload"])
        for m in entries["end_to_end"]:
            spec["end_to_end"].append(dict(m, workloads=[name]))
        for m in spec["end_to_end"]:
            if m["name"] == "enc_mpix_per_s" and name.startswith("q20.enc"):
                m["workloads"].append(name)
        spec["per_layer"] += [dict(m, workloads=[name])
                              for m in entries["per_layer"]]
        for m in spec["per_layer"]:
            if m["name"] in ("front_ms.enc", "kernel_roofline.enc",
                             "idle_share.enc") and ".enc." in name:
                m["workloads"].append(name)
    return cells.find(name, spec)


def _run(name: str, seconds: float = 0.01):
    cell = _find(name)
    return run.run_cell(cell, SEED, seconds, False, "cpu", pool_size=4,
                        per_request=2, log=lambda msg: None)


def _entry(name: str) -> str:
    return _find(name).traffic["entry"].rsplit(".", 1)[1]


@pytest.mark.parametrize("name", NAMES)
def test_sound_run_is_correct(name):
    r = _run(name, seconds=1.0)
    assert r["correct"] and r["failed"] == 0
    assert r["checks"]["images_wrong"]["value"] == 0
    assert r["checks"]["images_compared"]["value"] >= 2
    # the reference's streams are set-up of the yardstick, timed apart
    assert ("reference_s" in r["split"]) == (".dec." in name)


def _altered_stream(monkeypatch):
    was = tenc.finish_deferred

    def altered(deferred, device):
        out = was(deferred, device=device)
        out[0] = out[0][:-1] + bytes([out[0][-1] ^ 1])
        return out
    monkeypatch.setattr(tenc, "finish_deferred", altered)


def _altered_pixel(monkeypatch):
    was = dp.dd.decode_batch_device

    def altered(datas, device, entropy_on_device=False):
        out = was(datas, device, entropy_on_device)
        out[0] = np.array(out[0])
        out[0][0, 0, 0] ^= 1
        return out
    monkeypatch.setattr(dp.dd, "decode_batch_device", altered)


def _half_batch(monkeypatch, name):
    """Half of the batch left out, its answers taken from the rest."""
    fn = _entry(name)
    was = getattr(dp, fn)

    def half(batch, *a, **kw):
        h = (len(batch) + 1) // 2
        out, m = was(batch[:h], *a, **kw)
        return (out + out)[:len(batch)], m
    monkeypatch.setattr(dp, fn, half)


def _unchanged_state(monkeypatch, name):
    """A step that returns its state unchanged: every reply is the first
    one's."""
    fn = _entry(name)
    was, first = getattr(dp, fn), []

    def stale(batch, *a, **kw):
        if not first:
            first.append(was(batch, *a, **kw))
        return first[0]
    monkeypatch.setattr(dp, fn, stale)


FAULTS = {
    "answer altered": lambda mp, name: (
        _altered_pixel(mp) if "dec" in name else _altered_stream(mp)),
    "half of the batch": _half_batch,
    "state unchanged": _unchanged_state,
}


@pytest.mark.parametrize("fault", sorted(FAULTS))
@pytest.mark.parametrize("name", NAMES)
def test_broken_timed_path_is_not_correct(monkeypatch, name, fault):
    FAULTS[fault](monkeypatch, name)
    # long enough for the window's second request, whose batch differs
    # from the warm-up's first
    r = _run(name, seconds=2.5)
    assert not r["correct"]
    assert r["checks"]["images_wrong"]["value"] > 0 and r["failed"] > 0


@pytest.mark.parametrize("name", NAMES)
def test_control_is_not_correct(name):
    checks = control.control_checks(_find(name), SEED, pool_size=4)
    assert not check.passed(checks)
    assert checks["images_wrong"]["value"] > 0


def test_reference_against_itself_is_correct():
    pool = make_pool(SEED)[:2]
    want = check.reference_streams(pool, 20)
    checks = check.compare([([0, 1], list(want))], want)
    assert check.passed(checks)
    assert not check.passed(check.compare([([0, 1], [want[0]])], want))


def test_left_out_decode_cell_comes_back_from_entries_alone():
    cell = _find("q20.dec.pool")
    assert cell.traffic["kind"] == "decode" and cell.quality == 20
    assert {m["name"] for m in cell.end_to_end} == {"dec_mpix_per_s",
                                                    "setup_s"}
    assert all(callable(cells.reader(m["name"])) for m in cell.per_layer)
    assert callable(cells.control(cell.control))


def test_left_out_pool_cell_comes_back_from_entries_alone():
    cell = _find("q20.enc.pool")
    assert cell.traffic["kind"] == "encode" and cell.quality == 20
    assert cell.traffic["options"] == {}
    assert {m["name"] for m in cell.end_to_end} == {"enc_mpix_per_s",
                                                    "setup_s"}
    assert {m["name"] for m in cell.per_layer} == {
        "front_ms.enc", "host_stage_ms.enc", "kernel_roofline.enc",
        "idle_share.enc"}
    assert all(callable(cells.reader(m["name"])) for m in cell.per_layer)
    assert cell.control == "colorspace_f32"


def test_each_side_takes_its_configurations_control():
    assert _find("q20.enc.scans").control == "colorspace_f32"
    assert _find("q20.dec.pool").control == "yuv_to_rgb_bf16"
    assert _find("q8.enc.scans").control == "prefilter_skipped"
