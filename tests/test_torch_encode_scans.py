"""The device encode scans' stream stage (``models/device_scans.py``,
``models/device_encode_scans.py``) on the CPU, tolerance 0.

- Each twin and torch-op module equals the JAX package's function and the
  host copy's C scan at batch 2: the snap pass in its three variants (and
  q17's second-pass window) on the adversarial chain plane of
  tests/test_device_scans.py and on spill planes; ``offset_y`` (q20) on
  random and edge planes (row 255's vertical fires, whole-row parity
  chains); ``offset_uv``; merge, select and cap on random and run-heavy
  streams (128-runs of 255 + 254 m + d, crossings at 4 SZ - 4); the
  serpentines.
- ``_y_stream_stage`` + ``_uv_stream_stage`` reproduce the host copy's
  ``im_nhw`` and ``nhw_select1/2`` on real images at q20 (two fixtures),
  q21 and q17, with the inputs captured from the host copy's own encode
  by ``chip_smoke.StreamCapture``.
- ``scans_on_device=True`` raises below and above the range it runs,
  naming it.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.host.ops import quantize as hq
from nhwcodec_tpu_torch.host.utils import fixtures
from nhwcodec_tpu_torch.models import device_encode_scans as des
from nhwcodec_tpu_torch.models import device_scans as tds
from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

SZ = 65536
SNAP_VARIANTS = des.snap_args(20) + des.snap_args(17)[1:2]


@pytest.fixture(autouse=True)
def _one_thread():
    # beside the other workers of a parallel run, intra-op threads make
    # the twins' many small ops slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host_snap(x, a):
    r0, r1, c0, c1, thr, yw, yw2, sec, g6, gc = a
    out = []
    for p in x:
        ref = np.concatenate([p.reshape(-1).copy(), np.zeros(8, np.int16)])
        henc._band_snap_pass(ref, range(r0, r1), c0, c1, thr, yw, yw2, sec,
                             g6, gc)
        out.append(ref[: 4 * SZ].reshape(512, 512))
    return np.stack(out)


@pytest.mark.parametrize("kind", ["chain", "spill"])
@pytest.mark.parametrize("variant", range(len(SNAP_VARIANTS)))
def test_snap_pass_twin(kind, variant):
    a = SNAP_VARIANTS[variant]
    rng = np.random.default_rng(7 + variant)
    x = (cs.snap_chain_planes if kind == "chain" else cs.snap_spill_planes)(
        rng, 2)
    got = tds.snap_pass_device(torch.from_numpy(x), *a).numpy()
    assert np.array_equal(got, _host_snap(x, a))
    assert np.array_equal(got, np.asarray(jds.snap_pass_device(x, *a)))
    if kind == "spill":   # the spill column moves
        r0, r1, c1 = a[0], a[1], a[3]
        assert (got[:, r0:r1, c1] != x[:, r0:r1, c1]).any()


def _host_offset_y(x, q=20):
    out = []
    for p in x:
        ref = p.copy()
        hq.offset_y(ref, q, 8)
        out.append(ref)
    return np.stack(out)


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_offset_y_twin(kind):
    rng = np.random.default_rng(11)
    x = (rng.integers(-400, 401, (2, 512, 512)).astype(np.int16)
         if kind == "random" else cs.offset_y_edge_planes(rng, 2))
    got = tds.offset_y_device(torch.from_numpy(x), 8).numpy()
    assert np.array_equal(got, _host_offset_y(x))
    assert np.array_equal(got, np.asarray(jds.offset_y_device(x, 8)))


def test_offset_y_edge_planes_fire_into_row_256():
    """The edge planes do what they claim: passes 2-3 write 10100 into
    row 256 at 4k + 1 and 4k + 2, and the first promotion fires along
    rows 10 and 11."""
    x = cs.offset_y_edge_planes(np.random.default_rng(3), 1)
    rows = tds._offset_y_rows_ref(torch.from_numpy(x).to(torch.int32)
                                  .reshape(1, -1))
    p = tds._offset_y_ll_ref(rows.reshape(1, 512, 512))[0]
    assert (p[256, 1:256:4] == 10100).all()
    assert (p[256, 2:256:4] == 10100).all()
    assert (p[10, 1:254:2] == 12700).all()
    assert (p[11, 1:254:2] == 12900).all()


def test_offset_uv_twin():
    rng = np.random.default_rng(13)
    pu = rng.choice(np.array([7, 14, 8, -7, -8, 0, 200, -200, 12400, 7, 7],
                             np.int16), size=(2, 256, 256))
    got = tds.offset_uv_device(torch.from_numpy(pu), 8).numpy()
    assert np.array_equal(got, np.asarray(jds.offset_uv_device(pu, 8)))
    for k in range(2):
        ref = pu[k].copy()
        hq.offset_uv(ref, 8)
        assert np.array_equal(got[k], ref)


def _streams(kind):
    rng = np.random.default_rng(17)
    if kind == "edge":
        return cs.stream_edge_streams(rng, 2)
    s = np.zeros((2, 6 * SZ + 16), np.uint8)
    s[:, : 4 * SZ] = rng.choice(np.array([128, 136, 120, 5, 128, 128, 153],
                                         np.uint8), (2, 4 * SZ))
    return s


@pytest.mark.parametrize("kind", ["random", "edge"])
def test_merge_select_cap(kind):
    s = _streams(kind)
    merged = tds.merge_crossing_device(torch.from_numpy(s))
    assert np.array_equal(merged.numpy(),
                          np.asarray(jds.merge_crossing_device(s)))
    sel, s1, s2 = tds.select_codes_device(merged)
    js, j1, j2 = jds.select_codes_device(merged.numpy())
    assert np.array_equal(sel.numpy(), np.asarray(js))
    assert s1.tolist() == np.asarray(j1).tolist()
    assert s2.tolist() == np.asarray(j2).tolist()
    capped = tds.cap_long_runs_device(sel)
    assert np.array_equal(capped.numpy(),
                          np.asarray(jds.cap_long_runs_device(sel.numpy())))
    want, w1, w2 = cs.host_stream_fixups(s)
    assert np.array_equal(capped.numpy(), want)
    assert s1.tolist() == w1.tolist() and s2.tolist() == w2.tolist()
    if kind == "edge":
        # the streams exercise what they claim: fires at the walk's end,
        # demotions after the long runs
        assert (merged.numpy()[:, 4 * SZ - 12: 4 * SZ] == 201).any()
        assert ((want == 124) | (want == 123)).any()


def test_merge_crossing_twin_on_its_tiles():
    """Crossings on every tile, warp and CTA boundary of the twin's
    decomposition (16 positions a tile, 32 tiles a warp, 8 warps a CTA),
    each side of it."""
    s = np.full((1, 4 * SZ + 8), 128, np.uint8)
    for edge in range(16, 4 * SZ, 16):
        at = edge - 1 - (edge // 16) % 8      # 1..8 before the edge
        s[0, at], s[0, at + 4] = 136, 120
    got = tds.merge_crossing_device(torch.from_numpy(s)).numpy()
    assert (got == 201).sum() > 4 * SZ // 64
    ref = s[0].copy()
    hq.merge_crossing_codes(ref)
    assert np.array_equal(got[0], ref)
    assert np.array_equal(got, np.asarray(jds.merge_crossing_device(s)))


def test_serpentines():
    rng = np.random.default_rng(19)
    y = rng.integers(-300, 300, (2, 512, 512)).astype(np.int16)
    uv = rng.integers(-300, 300, (2, 256, 256)).astype(np.int16)
    gy = tds.serpentine_y_device(torch.from_numpy(y)).numpy()
    guv = tds.serpentine_uv_device(torch.from_numpy(uv)).numpy()
    assert np.array_equal(gy, np.asarray(jds.serpentine_y_device(y)))
    assert np.array_equal(guv, np.asarray(jds.serpentine_uv_device(uv)))
    for k in range(2):
        im = hq.serpentine_y(y[k])
        assert np.array_equal(gy[k], im[: 4 * SZ])
        hq.serpentine_uv(im, uv[k], 1)
        assert np.array_equal(guv[k], im[4 * SZ + 1: 6 * SZ: 2])


_IMAGES = {"texture_noise": fixtures.texture_noise,
           "gradient_circles": fixtures.gradient_circles}


@pytest.mark.parametrize("q, names", [
    (20, ("texture_noise", "gradient_circles")),
    (21, ("gradient_circles",)), (17, ("texture_noise",))])
def test_stream_stage_matches_host_encode(q, names):
    with cs.StreamCapture() as cap:
        for name in names:
            henc.encode(_IMAGES[name](), q)
    st = cs.stack_records(cap.records)
    assert len(st["y"]) == len(names)
    y, u, v = (torch.from_numpy(st[k]) for k in "yuv")
    stream, sel1, sel2 = cs.device_stream_stage(y, u, v, q)
    assert stream.shape == (len(names), 6 * SZ + 16)
    assert not stream[:, 6 * SZ:].any()
    cs.stream_check(f"q{q}", stream, sel1, sel2, st)


def test_stream_stage_range():
    y = torch.zeros((1, 512, 512), dtype=torch.int16)
    for q in (T.LOW4, T.HIGH2):
        with pytest.raises(NotImplementedError, match="offset_y_low4"):
            des._y_stream_stage(y, q)


def test_scans_on_device_message_names_the_range():
    img = np.zeros((1, 512, 512, 3), np.uint8)
    with pytest.raises(NotImplementedError,
                       match=rf"offset_y_low4.*uv_ll_smooth.*"
                       rf"{T.LOW4 + 1} <= q <= {T.HIGH1} run"):
        tdp.encode_batch_device(img, T.LOW4, device="cpu",
                                scans_on_device=True)
    with pytest.raises(ValueError, match=rf"1 <= q <= {T.HIGH1}"):
        tdp.encode_batch_device(img, T.HIGH2, device="cpu",
                                scans_on_device=True)


def test_wrappers_check_their_inputs():
    with pytest.raises(TypeError):
        tds.snap_pass_device(torch.zeros((1, 512, 512), dtype=torch.int32),
                             *SNAP_VARIANTS[0])
    with pytest.raises(ValueError):
        tds.snap_pass_device(torch.zeros((1, 512, 512), dtype=torch.int16),
                             10, 5, 1, 256, 6, 9, 9, False, False, 254)
    with pytest.raises(ValueError):
        tds.offset_y_device(torch.zeros((1, 256, 256), dtype=torch.int16))
    with pytest.raises(ValueError):
        tds.merge_crossing_device(torch.zeros((1, 4 * SZ - 1),
                                              dtype=torch.uint8))
