"""The device encode scans' stream stage (``models/device_scans.py``,
``models/device_encode_scans.py``) on the CPU, tolerance 0.

- Each twin and torch-op module equals the JAX package's function and the
  host copy's C scan at batch 2: the snap pass in its three variants (and
  q17's second-pass window) on the adversarial chain plane of
  tests/test_device_scans.py and on spill planes; the three variants as
  one ``snap_passes_device`` call at q20, q17 and q8 against three JAX
  calls in turn, there and on chains of both fixup classes across the
  16-column lane tiles with a fully alive row, and on variant 3 counting
  variant 2's spill column (each kind checked on the C's output to do what
  it claims); the geometry rule refusing lists it does not cover and
  taking the variants in reverse order; ``offset_y`` (q20) on
  random and edge planes (row 255's vertical fires, whole-row parity
  chains) and on relay edge planes (a pend carried through every band,
  so the twin's relay takes every sweep; fires from each band's last row
  into the next band's first), the kernel's run parity of lane bits
  emulated against the twin's; ``offset_uv``; merge, select and cap on random and run-heavy
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


SNAP_KINDS = {"chain": cs.snap_chain_planes, "spill": cs.snap_spill_planes,
              "tile edges": cs.snap_tile_edge_planes,
              "spill left": cs.snap_spill_left_planes}


def _host_snaps(x, variants):
    out = x
    for a in variants:
        out = _host_snap(out, a)
    return out


@pytest.mark.parametrize("kind", list(SNAP_KINDS))
@pytest.mark.parametrize("q", [20, 17, 8])
def test_snap_passes_fused(kind, q):
    """The three variants in one call equal three JAX calls in turn and
    the host copy's C."""
    variants = des.snap_args(q)
    x = SNAP_KINDS[kind](np.random.default_rng(q), 2)
    got = tds.snap_passes_device(torch.from_numpy(x), variants).numpy()
    want = x
    for a in variants:
        want = np.asarray(jds.snap_pass_device(want, *a))
    assert np.array_equal(got, want)
    assert np.array_equal(got, _host_snaps(x, variants))


def test_snap_tile_edge_planes_chain_across_tiles():
    """The tile-edge runs do what they claim on the C's output: the class-1
    run turns every 18 into 17 across four lane tiles in variant 1's rows
    and variant 2's, the class-2 run of -16s alternates, the -17s turn
    into -16 after the first, and the alive rows move."""
    x = cs.snap_tile_edge_planes(np.random.default_rng(4), 2)
    h = _host_snaps(x, des.snap_args(20))
    assert (h[:, 2:255:2, 271:331] == 17).all()
    assert (h[:, 256:510:2, 14:54] == 17).all()
    run = h[:, 258, 60:97]
    assert set(np.unique(run)) == {-16, -15}
    assert (run[:, 1:] != run[:, :-1]).all()
    assert (h[:, 2:255:2, 401:429] == -16).all()   # 429: right > 0 at times
    assert (h[:, 301] != x[:, 301]).any() and (h[:, 303] != x[:, 303]).any()


def test_snap_spill_left_planes_count_the_spill():
    """Variant 2's spill moves column 256, and variant 3's column 257
    keeps +-9 where column 256 counts and snaps to +-7 where it does
    not."""
    x = cs.snap_spill_left_planes(np.random.default_rng(5), 2)
    h = _host_snaps(x, des.snap_args(20))
    rows = slice(256, 511)
    assert (h[:, rows, 256] != x[:, rows, 256]).any()
    big = np.abs(x[:, rows, 256]) >= 6
    assert set(np.unique(h[:, rows, 257][big])) == {-9, 9}
    assert set(np.unique(h[:, rows, 257][~big])) == {-7, 7}


def test_snap_passes_reverse_order():
    """The rule covers the variants in reverse order too: one call equals
    the three in turn."""
    variants = des.snap_args(20)[::-1]
    x = cs.snap_chain_planes(np.random.default_rng(8), 2)
    got = tds.snap_passes_device(torch.from_numpy(x), variants).numpy()
    assert np.array_equal(got, _host_snaps(x, variants))


@pytest.mark.parametrize("variants", [
    # variant 2's rows read the rows variant 1 writes
    [(1, 255, 257, 511, 6, 8, 4, 0, 1, 510),
     (2, 300, 300, 400, 6, 8, 4, 0, 0, 510)],
    # the row above reads what the first region wrote
    [(1, 255, 257, 511, 6, 8, 4, 0, 1, 510),
     (255, 300, 300, 400, 6, 8, 4, 0, 0, 510)],
    # a later region reads the spill column above and below
    [(256, 511, 1, 256, 6, 8, 9, 1, 0, 254),
     (257, 300, 256, 300, 7, 11, 11, 0, 0, 510)],
    # too many regions
    des.snap_args(20) + des.snap_args(20)[:1],
    [],
])
def test_snap_passes_refuses(variants):
    x = torch.zeros((1, 512, 512), dtype=torch.int16)
    with pytest.raises(ValueError, match="snap_passes"):
        tds.snap_passes_device(x, variants)


def _host_offset_y(x, q=20):
    out = []
    for p in x:
        ref = p.copy()
        hq.offset_y(ref, q, 8)
        out.append(ref)
    return np.stack(out)


OFFSET_Y_KINDS = {
    "random": lambda rng, b: rng.integers(-400, 401, (b, 512, 512)).astype(
        np.int16),
    "edge": cs.offset_y_edge_planes, "relay": cs.offset_y_relay_edge_planes}


@pytest.mark.parametrize("kind", ["random", "edge", "relay"])
def test_offset_y_twin(kind):
    rng = np.random.default_rng(11)
    x = OFFSET_Y_KINDS[kind](rng, 2)
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
    p = tds._offset_y_ll_ref(rows.reshape(1, 512, 512))[0][0]
    assert (p[256, 1:256:4] == 10100).all()
    assert (p[256, 2:256:4] == 10100).all()
    assert (p[10, 1:254:2] == 12700).all()
    assert (p[11, 1:254:2] == 12900).all()



def test_offset_y_relay_edge_planes():
    """The relay edge planes do what they claim: down each pair the rows
    fire vertically and are pended in turn from row 1, into plane row 256,
    so the relay takes every sweep; each band's last row fires into the
    next band's first, which the pend keeps from a pass-3 pair; and the
    twin's first sweep (no pend) differs from the result."""
    x = cs.offset_y_relay_edge_planes(np.random.default_rng(5), 2)
    xt = torch.from_numpy(x)
    assert tds.offset_y_sweeps(xt).tolist() == [tds.OY_BANDS] * 2
    rows = tds._offset_y_rows_ref(xt.to(torch.int32).reshape(2, -1))
    p = tds._offset_y_ll_ref(rows.clone().reshape(2, 512, 512))[0]
    for c, val in cs.RELAY_PAIRS:
        fired = 12100 if val > 0 else 12200
        assert (p[:, 1:256:2, c - 1] == fired).all()
        assert (p[:, 1:256:2, c] == 10100).all()
        assert (p[:, 2:257:2, c - 1: c + 1] == 10100).all()
    for k, c in enumerate(cs.RELAY_EDGE_COLS):
        r = 16 * k + 15
        assert (p[:, r, c - 1] == 12100).all() and (p[:, r, c] == 10100).all()
        assert (p[:, r + 1, c - 1: c + 1] == 10100).all()
    I = rows.reshape(2, 512, 512)[:, :257, :256]
    first, _ = tds._offset_y_bands(I, torch.zeros((2, tds.OY_BANDS, 256),
                                                  dtype=torch.bool))
    for k, c in enumerate(cs.RELAY_EDGE_COLS):
        assert (first[:, 16 * k + 16, c - 1] == 10300).all()


def _run_parity_lanes(f):
    """A numpy transcription of csrc/scans.cu run_parity_row on rows of
    256 candidates, (n, 256) bool: lane l's 8 bits, its runs' parity by
    adding their start bits, and the state entering its bit 0 from two
    ballots over the lanes."""
    bits = f.reshape(len(f), 32, 8).astype(np.int64) << np.arange(8)
    f8 = bits.sum(-1)
    starts = f8 & ~(f8 << 1)
    even = f8 & ~(f8 + (starts & 0x55))
    fired = (even & 0x55) | (f8 & ~even & 0xAA)
    gaps = f8 != 0xFF
    out = np.zeros_like(f8)
    for i in range(len(f)):
        for lane in range(32):
            below = np.nonzero(gaps[i, :lane])[0]
            e = (fired[i, below[-1]] >> 7) & 1 if len(below) else 0
            out[i, lane] = fired[i, lane] ^ (f8[i, lane] & ~(f8[i, lane] + 1)
                                             & -e)
    return ((out[..., None] >> np.arange(8)) & 1).astype(bool).reshape(
        len(f), 256)


def test_run_parity_of_lane_bits():
    """The kernel's run parity (lane bits, two ballots) equals the twin's
    ``_run_parity_fire`` on random rows, runs across many lanes, whole
    rows of candidates and lanes of 8 candidates between others."""
    rng = np.random.default_rng(17)
    f = rng.random((64, 256)) < rng.random((64, 1))
    f[0] = True
    f[1] = False
    f[2, 3:200] = True
    f[3] = np.repeat(rng.random(32) < 0.5, 8)
    f[4, 7::8] = False
    want = tds._run_parity_fire(torch.from_numpy(f)).numpy()
    assert np.array_equal(_run_parity_lanes(f), want)



def _offset_y_row_lanes(cur, nxt, pend):
    """A numpy transcription of csrc/scans.cu offset_y_row on rows of 256
    ((n, 256) int inputs of rows r and r + 1, bool pend): the range tests
    as each lane's 8-bit masks, the neighbours' bits across lane edges,
    the writes as codes merged two columns a word from the code table.
    Returns (row r's output, row r + 1's pend)."""
    n = len(cur)

    def lanes(b):                     # (n, 256) bool -> (n, 32) masks
        return (b.reshape(n, 32, 8).astype(np.int64) << np.arange(8)).sum(-1)

    def bits(m):
        return ((m[..., None] >> np.arange(8)) & 1).astype(bool).reshape(n, 256)

    def up(m):                        # the lane below's mask (lane 0: own)
        return np.concatenate([m[:, :1], m[:, :-1]], 1)

    def down(m):                      # the lane above's (lane 31: own)
        return np.concatenate([m[:, 1:], m[:, -1:]], 1)

    def rng_(x, lo, hi):
        return lanes((x >= lo) & (x <= hi))

    P = lanes(pend)
    pv, nv = rng_(cur, 4, 7) & ~P, rng_(cur, -7, -4) & ~P
    pn, nn = rng_(nxt, 4, 7), rng_(nxt, -7, -4)
    ok = np.full(32, 0xFF)
    ok[0], ok[31] = 0xFE, 0x7F
    lo = lambda m: (m << 1 | (up(m) >> 7 & 1)) & 0x1FF      # noqa: E731
    hi = lambda m: m >> 1 | (down(m) & 1) << 7               # noqa: E731
    fp, fm = ok & pv & lo(pv), ok & nv & lo(nv)
    fph, fmh = fp & hi(pv), fm & hi(nv)
    fpv, fmv = fp & ~fph & pn & lo(pn), fm & ~fmh & nn & lo(nn)
    fired = lanes(_run_parity_lanes(bits(fph | fmh | fpv | fmv)))
    fh, fvp, fvm = fired & (fph | fmh), fired & fpv, fired & fmv
    last = np.arange(32) < 31
    w1, w4, w5 = (m >> 1 | (down(m) & 1 & last) << 7 for m in (fh, fvp, fvm))
    fv, w = fvp | fvm, w1 | w4 | w5
    pend_next = (fv | fv >> 1 | ((w4 | w5) & 0x80)) & 0xFF
    m1, m2, m3 = w1 | ((P | fv) & ~w), fh & fph & ~w, fh & fmh & ~w
    keep = ~(P | fired | w) & 0xFF
    p3, n3 = rng_(cur, 5, 7) & keep, rng_(cur, -7, -5) & keep
    ok3 = np.where(last, 0xFF, 0x7F)
    f3p, f3n = ok3 & p3 & hi(p3), ok3 & n3 & hi(n3)
    fired3 = lanes(_run_parity_lanes(bits(f3p | f3n)))
    m6, m7 = fired3 & f3p, fired3 & f3n
    code = (bits(m1 | m3 | w5 | m7).astype(int) + 2 * bits(m2 | m3 | m6 | m7)
            + 4 * bits(w4 | w5 | m6 | m7))
    vals = np.array([0, 10100, 12700, 12900, 12100, 12200, 10300, 10204])
    return np.where(code > 0, vals[code], cur), bits(pend_next)


def test_offset_y_row_lane_masks():
    """The kernel's row step (range tests as lane masks, the writes as
    codes) equals the twin's ``_offset_y_row`` on random rows of small
    values, runs of candidates and pends, and on the relay edge planes'
    rows."""
    rng = np.random.default_rng(23)
    vals = np.array([4, 5, 6, 7, -4, -5, -6, -7, 0, 3, 8, -8, 10100])
    cur = rng.choice(vals, (96, 256))
    nxt = rng.choice(vals, (96, 256))
    cur[:32] = rng.integers(-9, 10, (32, 256))
    pend = rng.random((96, 256)) < rng.random((96, 1)) / 2
    x = cs.offset_y_relay_edge_planes(rng, 1)[0].astype(np.int64)
    cur = np.concatenate([cur, x[:256, :256]])
    nxt = np.concatenate([nxt, x[1:257, :256]])
    pend = np.concatenate([pend, rng.random((256, 256)) < 0.05])
    got = _offset_y_row_lanes(cur, nxt, pend)
    want = tds._offset_y_row(*(torch.from_numpy(a) for a in (cur, nxt, pend)))
    assert np.array_equal(got[0], want[0].numpy())
    assert np.array_equal(got[1], want[1].numpy())


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
    stream, sel1, sel2 = des._y_stream_stage(y, T.LOW8)
    assert stream.shape == (1, 6 * SZ + 16) and sel1.shape == (1,)
    for q in (0, T.HIGH2):
        with pytest.raises(ValueError, match="HQ residue stays on the host"):
            des._y_stream_stage(y, q)


def test_scans_on_device_message_names_the_range():
    img = np.zeros((1, 512, 512, 3), np.uint8)
    got, _ = tdp.encode_batch_device(img, T.LOW8, device="cpu",
                                     scans_on_device=True)
    assert got == [henc.encode(img[0], T.LOW8)]
    for q in (0, T.HIGH2):
        with pytest.raises(ValueError,
                           match=rf"1 <= q <= {T.HIGH1}, got q{q} "
                           r"\(above, the HQ residue runs on the host"):
            tdp.encode_batch_device(img, q, device="cpu",
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
