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
  runs of 128 and 127 pairs and runs across the warps' edges, drifts at
  the rows on both sides of every CTA edge of the kernel's cluster, no
  drift at all) with res_uv 4 and 5.
- The twin takes the kernel's decomposition (every row from a guessed
  window start, the rows again while a start moves, within each CTA and
  then over the cluster's rounds): its rounds on the edge inputs (one
  without drift, all ``UVSM_CTAS + 1`` where drifts cross every CTA
  edge), and numpy transcriptions of the kernel's warp run parity
  (``block_scan.cuh`` ``run_parity_lanes4``, which S7 shares) and of its
  drift counts (the bytes gathered into a CTA's mask, the masks below)
  against the twin's prefix.
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
    elif kind == "cta edges":
        # a drift on both sides of every CTA edge, and nowhere else
        want = sorted(cs.uv_drift_rows(True))
        assert len(want) == 2 * (tds.UVSM_CTAS - 1)
        for k in range(2):
            assert np.flatnonzero(got[k, :128, 255] == 12400).tolist() \
                == want
    elif kind == "no drift":
        assert not np.isin(got[:, :128, 255], (12400, 12600)).any()
        assert (got != proc).sum() > 1000
    elif kind == "bands taken":
        # rows 2 mod 3 have no free slot: nothing is written
        rows = np.arange(2, 128, 3)
        for r0, c0 in ((0, 128), (128, 0), (128, 128)):
            assert np.array_equal(got[:, r0 + rows, c0: c0 + 128],
                                  proc[:, r0 + rows, c0: c0 + 128])
        assert (got[:, 128 + np.arange(0, 128, 3), :128] >= 12400).any()


@pytest.mark.parametrize("kind", ["no drift", "cta edges", "drift",
                                  "pair runs"])
def test_uv_sentinel_sweeps(kind):
    """The rounds of the kernel's decomposition reach what each input
    claims: one without drift; where drifts cross every CTA edge, CTA c
    takes its exact entry from round c and the last round finds nothing
    moved."""
    proc, rf = cs.uv_sentinel_edge_inputs(np.random.default_rng(24), 2,
                                          kind)
    sweeps = tds.uv_sentinel_sweeps(_t(proc), _t(rf), 4).tolist()
    if kind == "no drift":
        assert sweeps == [1, 1]
    elif kind in ("cta edges", "drift"):
        assert sweeps == [tds.UVSM_CTAS + 1] * 2
    else:
        # drifts, but res256 is constant: the guessed starts read the same
        # values, so the second round moves nothing
        assert sweeps == [2, 2]


def _run_parity_lanes4(f):
    """numpy transcription of block_scan.cuh ``run_parity_lanes4`` on
    (..., 32) lane nibbles (bit i: position 4 lane + i)."""
    f = f.astype(np.uint32)
    starts = f & ~(f << 1)
    even = f & ~(f + (starts & 5))
    fired = (even & 5) | (f & ~even & 0xA)
    gaps = f != 0xF
    last = (fired >> 3) & 1
    e = np.zeros_like(f)
    for lane in range(1, 32):
        below = gaps[..., :lane]
        idx = lane - 1 - np.argmax(below[..., ::-1], -1)
        got = np.take_along_axis(last, idx[..., None], -1)[..., 0]
        e[..., lane] = np.where(below.any(-1), got, 0)
    return (fired ^ (f & ~(f + 1) & (0 - e).astype(np.uint32))) & 0xF


@pytest.mark.parametrize("density", [0.2, 0.5, 0.8, 0.97])
def test_warp_run_parity_transcription(density):
    """The kernels' run parity of lane nibbles (S7's 2a fires, S9's
    placed pairs) equals the twins' ``_run_parity_fire`` on rows of 128
    candidates, runs across every lane edge and whole rows included."""
    rng = np.random.default_rng(int(density * 100))
    bits = rng.random((400, 128)) < density
    bits[0] = True
    bits[1, 3:] = True
    bits[2, 1::2] = True
    want = tds._run_parity_fire(torch.from_numpy(bits)).numpy()
    nib = (bits.reshape(400, 32, 4) * (1 << np.arange(4))).sum(-1)
    got = _run_parity_lanes4(nib)
    got_bits = ((got[..., None] >> np.arange(4)) & 1).astype(bool)
    assert np.array_equal(got_bits.reshape(400, 128), want)


def test_drift_count_transcription():
    """uv.cu's drift counts: a CTA's drift bytes gathered into a 16-bit
    mask (a multiply a word), row k's count the bits below k plus the
    masks of the CTAs above; against the twin's exclusive cumsum, on
    random drift vectors."""
    rng = np.random.default_rng(25)
    drift = rng.random((50, tds.UVQ)) < 0.3
    want = (torch.cumsum(torch.from_numpy(drift).long(), 1)
            - torch.from_numpy(drift).long()).numpy()
    rows = tds.UVSM_CTA_ROWS
    masks = []
    for c in range(tds.UVSM_CTAS):
        words = (drift[:, c * rows:(c + 1) * rows].reshape(50, 4, 4)
                 .astype(np.uint64) << (8 * np.arange(4, dtype=np.uint64))
                 ).sum(-1)
        nib = ((words * 0x01020408) >> 24) & 0xFF
        masks.append((nib << (4 * np.arange(4, dtype=np.uint64))).sum(-1))
    pop = np.vectorize(lambda x: bin(int(x)).count("1"))
    for c in range(tds.UVSM_CTAS):
        assert np.array_equal(masks[c], (drift[:, c * rows:(c + 1) * rows]
                                         * (1 << np.arange(rows))).sum(-1))
        entry = sum(pop(masks[d]) for d in range(c)) if c else 0
        for k in range(rows):
            n = entry + pop(masks[c] & ((1 << k) - 1))
            assert np.array_equal(n, want[:, c * rows + k])


def test_uv_sentinel_layout_is_the_kernels():
    """The twin's cluster and row constants are uv.cu's."""
    import re
    from pathlib import Path

    src = (Path(tds.__file__).resolve().parent.parent / "csrc" /
           "uv.cu").read_text()
    assert int(re.search(r"kUvCtas = (\d+);", src).group(1)) == \
        tds.UVSM_CTAS
    assert "kUvRows = kLanes / kUvCtas;" in src
    assert tds.UVSM_CTA_ROWS * tds.UVSM_CTAS == tds.UVQ


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
