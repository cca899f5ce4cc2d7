"""The chroma ladders of the device encode scans
(``models/device_scans.py``: ``uv_compare_ladder_device``, torch ops, and
``uv_sentinel_marking_device`` with its twin ``uv_sentinel_marking_ref``)
on the CPU, tolerance 0.

- Each equals the JAX package's function (XLA:CPU, batch 2) and the host
  copy's C (``host.models.encoder._uv_compare_ladder`` /
  ``_uv_sentinel_marking``): the compare ladder on
  ``chip_smoke.uv_ladder_edge_inputs`` (differences at +-3 with the next
  one 0, oob0 at the last position) with ``strict`` both ways; the
  sentinel marking on ``chip_smoke.uv_sentinel_edge_inputs`` (pairs at
  lane 127 drifting the window into the oob tail, lane 0 writing the slot
  lane 127 reads, d0 = -5 with d1 on both sides of 0, band slots taken,
  runs of 128 and 127 pairs and runs across the warps' edges) with res_uv
  4 and 5.
- Both equal the host copy's own encode on the planes
  ``chip_smoke.StreamCapture`` captures from it, U and V.
- The wrappers check their inputs.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.host.utils import fixtures
from nhwcodec_tpu_torch.models import device_scans as tds


@pytest.fixture(autouse=True)
def _one_thread():
    # beside the other workers of a parallel run, intra-op threads make
    # the twins' many small ops slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _t(x):
    return torch.from_numpy(np.ascontiguousarray(x))


def _host_ladder(jpeg, proc, r256, oob0, strict):
    out = jpeg.copy()
    for k in range(len(out)):
        henc._uv_compare_ladder(out[k], proc[k].copy(), r256[k], strict,
                                int(oob0[k]))
    return out


@pytest.mark.parametrize("strict", [False, True])
def test_uv_compare_ladder(strict):
    jpeg, proc, r256, oob0 = cs.uv_ladder_edge_inputs(
        np.random.default_rng(21), 2)
    got = tds.uv_compare_ladder_device(*map(_t, (jpeg, proc, r256, oob0)),
                                       strict).numpy()
    want = np.asarray(jds.uv_compare_ladder_device(jpeg, proc, r256, oob0,
                                                   strict))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _host_ladder(jpeg, proc, r256, oob0, strict))
    # the inputs reach what they claim: the +-3 rules decide with nxt = 0,
    # and oob0 at the last position
    scan = proc[:, :128, :128].astype(np.int32) - r256
    nxt0 = (proc[:, :128, 1:129].astype(np.int32)
            - np.concatenate([r256.reshape(2, -1)[:, 1:], oob0[:, None]],
                             1).reshape(2, 128, 128))
    assert ((np.abs(scan) == 3) & (nxt0 == 0)).sum() > 100
    assert set(np.abs(scan[:, 127, 127])) == {3}
    assert np.array_equal(got[:, 128:], jpeg[:, 128:])


def test_uv_compare_ladder_oob0_decides_the_last_position():
    jpeg, proc, r256, oob0 = cs.uv_ladder_edge_inputs(
        np.random.default_rng(22), 2)
    proc[:, 127, 127] = r256[:, 127, 127] + 3
    proc[:, 127, 128] = oob0
    for strict, last in ((False, -1), (True, 0)):
        got = tds.uv_compare_ladder_device(
            *map(_t, (jpeg, proc, r256, oob0)), strict).numpy()
        assert np.array_equal(got[:, 127, 127] - r256[:, 127, 127],
                              [last, last])
        assert np.array_equal(got, _host_ladder(jpeg, proc, r256, oob0,
                                                strict))


@pytest.mark.parametrize("res_uv", [4, 5])
@pytest.mark.parametrize("kind", cs.UVSM_KINDS)
def test_uv_sentinel_marking(kind, res_uv):
    proc, rf = cs.uv_sentinel_edge_inputs(np.random.default_rng(23), 2,
                                          kind)
    got = tds.uv_sentinel_marking_device(_t(proc), _t(rf), res_uv).numpy()
    assert np.array_equal(got, np.asarray(jds.uv_sentinel_marking_device(
        proc, rf, res_uv)))
    assert np.array_equal(got, cs.host_uv_sentinel(proc, rf, res_uv))
    assert np.array_equal(got[:, :128, :128], proc[:, :128, :128])
    # the inputs reach what they claim
    col255 = (got[:, :128, 255] == 12400).sum(1)
    if kind == "drift":
        # lane 127 places in 96 rows, so the last rows read past res256
        assert (col255 == 96).all()
        # and lane 0's 12900 in column 128 decides lane 127 (rows 1 mod 4)
        assert (got[:, 1:128:4, 128] == 12900).all()
    elif kind == "pair runs":
        # the row of 128: the even lanes place, in their band 0 slot
        lanes = got[:, 0:128:4, 128:]
        assert (lanes[..., 0::2] == 12400).all()
        assert (lanes[..., 1::2] == proc[:, 0:128:4, 129::2]).all()
        # the row of 127 from lane 1: lane 127 places against column 128
        assert (got[:, 1:128:4, 255] == 12400).all()
    elif kind == "d0 -5":
        assert (got == 13000).sum() > 1000 if res_uv == 4 else True
    elif kind == "bands taken":
        # rows 2 mod 3 have no free slot: nothing is written
        rows = np.arange(2, 128, 3)
        for r0, c0 in ((0, 128), (128, 0), (128, 128)):
            assert np.array_equal(got[:, r0 + rows, c0: c0 + 128],
                                  proc[:, r0 + rows, c0: c0 + 128])
        assert (got[:, 128 + np.arange(0, 128, 3), :128] >= 12400).any()


def test_uv_ladders_equal_the_host_encode():
    with cs.StreamCapture() as cap:
        for img in (fixtures.texture_noise(), fixtures.gradient_circles()):
            henc.encode(img, 20)
    st = cs.stack_uv(cap.records)
    assert len(st["cl"]) == 2 and len(st["sm"]) == 2
    for jpeg, proc, r256, oob0, strict, want in st["cl"]:
        got = tds.uv_compare_ladder_device(*map(_t, (jpeg, proc, r256,
                                                     oob0)), strict)
        assert np.array_equal(got.numpy(), want)
        assert np.array_equal(want, np.asarray(jds.uv_compare_ladder_device(
            jpeg, proc, r256, oob0, strict)))
    for proc, rf, res_uv, want in st["sm"]:
        got = tds.uv_sentinel_marking_device(_t(proc), _t(rf), res_uv)
        assert np.array_equal(got.numpy(), want)
        assert (want != proc).any()
    assert [x[4] for x in st["cl"]] == [False, True]


def test_uv_ladders_check_their_inputs():
    p = torch.zeros((1, 256, 256), dtype=torch.int16)
    r = torch.zeros((1, 128, 128), dtype=torch.int16)
    oob = torch.zeros(1, dtype=torch.int16)
    with pytest.raises(TypeError):
        tds.uv_compare_ladder_device(p.int(), p, r, oob, False)
    with pytest.raises(ValueError):
        tds.uv_compare_ladder_device(p, p, r[:, :64], oob, False)
    with pytest.raises(ValueError):
        tds.uv_compare_ladder_device(p, p, r, oob.float(), False)
    rf = torch.zeros((1, tds.UV_RF_EXT), dtype=torch.int16)
    with pytest.raises(ValueError, match="drift"):
        tds.uv_sentinel_marking_device(p, rf[:, : tds.UV_RF_MIN - 1], 4)
    with pytest.raises(TypeError):
        tds.uv_sentinel_marking_device(p, rf.int(), 4)
    with pytest.raises(ValueError):
        tds.uv_sentinel_marking_device(p.transpose(1, 2), rf, 4)
    with pytest.raises(ValueError):
        tds.uv_sentinel_marking_device(p, torch.zeros((2, tds.UV_RF_EXT),
                                                      dtype=torch.int16), 4)
