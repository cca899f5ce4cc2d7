"""The device encode scans' residue stage (``models/device_scans.py``,
``models/device_encode_scans._y_residue_stage``) on the CPU, tolerance 0.

- Each twin and torch-op module equals the JAX package's function and the
  host copy's C scan at batch 2: the mid-q band cleanup; pair promotion on
  the adversarial plane of tests/test_device_scans.py and on planes whose
  chains cross the kernel's 8-column lane tiles in every carry state
  (``chip_smoke.pp_tile_edge_planes``: motifs at every tile edge, runs of
  8 through several tiles, tris on each region's first visit), each kind
  checked to reach what it claims through the twin's tile entry states;
  the column ladder
  on delta planes at q17, q18, q20 and q21 and classify on its output,
  with the counts; the column ladder on planes where column 255's walk
  after the others changes the result (the twin walks it 4 steps behind
  column 0, as the kernel does), and on planes whose cross-column pair
  check reads the next column's inputs at the kernel's 32-column block
  edges (31 -> 32, 63 -> 64), at a block's first columns (32, 64) and at
  column 254 -> 255; classify on band rows whose written value crosses
  every class boundary at the kernel's lane-tile edges (steps 7 -> 8,
  127 -> 128, 247 -> 248) in every res case, at q20 and q21 with
  res_setting 3, 4, 6 and 8 (the inputs checked to cross them), and the
  kernel's band-rule masks emulated against ``_classify_step``; the
  res1/res3/res5 positional
  streams at word_bits 1 and 2 on the C's classify output and on edge rfs
  (no codes, a code at every position, isolated markers).
- The wrappers check their inputs.

The stage as a whole: tests/test_torch_encode_residue_stage.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.host.ops import residue as hres
from nhwcodec_tpu_torch.models import device_encode_scans as des
from nhwcodec_tpu_torch.models import device_scans as tds

SZ = 65536


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


def test_mid_q_band_cleanup():
    p = np.random.default_rng(3).integers(-20, 21, (2, 512, 512)).astype(
        np.int16)
    got = tds.mid_q_band_cleanup_device(_t(p)).numpy()
    assert np.array_equal(got, np.asarray(jds.mid_q_band_cleanup_device(p)))
    for k in range(2):
        ref = p[k].reshape(-1).copy()
        henc._mid_q_band_cleanup(ref, 8)
        assert np.array_equal(got[k].reshape(-1), ref)
    assert (got != p).any()


def test_pair_promotion_twin():
    pp = cs.pp_adversarial_planes(np.random.default_rng(7), 2)
    got = tds.pair_promotion_device(_t(pp)).numpy()
    assert np.array_equal(got, np.asarray(jds.pair_promotion_device(pp)))
    for k in range(2):
        ref = pp[k].reshape(-1).copy()
        henc._pair_promotion(ref, 20)
        assert np.array_equal(got[k].reshape(-1), ref)
    # every rule fires, and the first a - 1 writes reach columns 256 and 0
    for v in (12700, 12900, 10100, 10):
        assert (got == v).any()
    assert (got[:, 1:255, 256] == 10100).any()
    assert (got[:, 257:511, 0] == 10100).any()
    # rows outside both regions are untouched
    for r in (0, 255, 256, 511):
        assert np.array_equal(got[:, r], pp[:, r])


# the carry states the tile-edge planes must carry across a lane tile's
# first column, in the band rows and in the lower rows (no 8/8 rules there)
PP_EDGE_STATES = {"tile edges": (set(range(1, 9)), {1, 3, 4, 5, 6}),
                  "runs of 8": ({2, 3, 7, 8}, set()),
                  "region starts": (set(), set())}


@pytest.mark.parametrize("kind", cs.PP_EDGE_KINDS)
def test_pair_promotion_tile_edges(kind):
    """S4's lane tiles (8 columns a lane, a scan of the tiles' state maps):
    chains crossing the tiles' edges in every carry state, runs of 8 and
    -8 chaining 9/9 pairs across several tiles in the band rows, tris on
    each region's first visit (the 10100 in columns 256 and 0) and motifs
    in the rows outside both regions.  The twin equals the JAX function
    and the host copy's C, and the inputs reach what they claim."""
    x = cs.pp_tile_edge_planes(np.random.default_rng(11), 2, kind)
    got = tds.pair_promotion_device(_t(x)).numpy()
    assert np.array_equal(got, np.asarray(jds.pair_promotion_device(x)))
    for k in range(2):
        ref = x[k].reshape(-1).copy()
        henc._pair_promotion(ref, 20)
        assert np.array_equal(got[k].reshape(-1), ref)
    entries = tds.pair_promotion_entries(_t(x)).numpy()
    assert not entries[..., 0].any()
    for region, want in enumerate(PP_EDGE_STATES[kind]):
        seen = set(np.unique(entries[:, region])) - {0}
        assert seen == want, (region, seen)
    if kind == "runs of 8":
        # some band row carries a chain through three tiles in a row
        crossing = entries[:, 0, :, 1:] != 0
        assert (crossing[..., :-2] & crossing[..., 1:-1]
                & crossing[..., 2:]).any()
    if kind == "region starts":
        assert (got[:, 1:255, 256] == 10100).all()
        assert (got[:, 257:511, 0] == 10100).all()
    for r in (0, 255, 256, 511):
        assert np.array_equal(got[:, r], x[:, r])
        assert np.isin(x[:, r], (5, 6, 7, 8, -8)).any()


def _host_ladder(p, r256, resIII, khead, q):
    outp, outr = [], []
    for k in range(len(p)):
        hp, hr = p[k].copy(), r256[k].copy()
        hres.res256_column_ladder(hp, hr, q, henc._res_setting(q), resIII[k],
                                  kernel_head=khead[k])
        outp.append(hp)
        outr.append(hr)
    return np.stack(outp), np.stack(outr)


@pytest.mark.parametrize("q", [17, 18, 20, 21])
def test_column_ladder_then_classify(q):
    rng = np.random.default_rng(100 + q)
    p, rf_ext, r256, resIII, khead = cs.delta_inputs(rng, 2)
    rs = henc._res_setting(q)
    gp, grf = (x.numpy() for x in tds.column_ladder_device(_t(p), _t(rf_ext),
                                                           q, rs))
    hp, hr = _host_ladder(p, r256, resIII, khead, q)
    assert np.array_equal(gp, hp)
    assert np.array_equal(grf.reshape(2, 256, 256), hr)
    jp, jr = jds.column_ladder_device(p, rf_ext, q, rs)
    assert np.array_equal(gp, np.asarray(jp))
    assert np.array_equal(grf, np.asarray(jr))
    got = tds.classify_device(_t(gp), _t(grf.reshape(2, 256, 256)), q, rs)
    if q >= T.NORM:     # JAX's classify compiles once a flag set
        want = jds.classify_device(gp, grf.reshape(2, 256, 256), q, rs)
        for g, w in zip(got, want):
            assert np.array_equal(g.numpy(), np.asarray(w))
    for k in range(2):
        cp, cr = hp[k].copy(), hr[k].copy()
        counts = hres.res256_classify(cp, cr, q, rs)
        assert np.array_equal(got[0][k].numpy(), cp)
        assert np.array_equal(got[1][k].numpy(), cr)
        assert tuple(int(n[k]) for n in got[2:]) == counts
    n1, n3, n5 = (int(n.sum()) for n in got[2:])
    assert n1 > 0 and n3 > 0 and (n5 > 0) == (q >= T.HIGH1)
    if q == T.LOW2:     # the low2 branch's rf[cnt + D] / rf[cnt] marks
        assert ((grf == 14100) | (grf == 14000)).any()



@pytest.mark.parametrize("rs", [3, 4, 6, 8])
@pytest.mark.parametrize("q", [20, 21])
def test_classify_class_edges(q, rs):
    """On ``chip_smoke.classify_class_edge_inputs`` the twin (6-class maps
    a lane, the lanes chained, the walk again) equals the JAX function
    and the host copy's C, counts too, and every boundary the flags' rules
    tell apart is crossed at every lane-tile edge."""
    rng = np.random.default_rng(200 + q + rs)
    plane, r256, design = cs.classify_class_edge_inputs(rng, 2)
    got = tds.classify_device(_t(plane), _t(r256), q, rs)
    want = jds.classify_device(plane, r256, q, rs)
    for g, w in zip(got, want):
        assert np.array_equal(g.numpy(), np.asarray(w))
    for k in range(2):
        cp, cr = plane[k].copy(), r256[k].copy()
        counts = hres.res256_classify(cp, cr, q, rs)
        assert np.array_equal(got[0][k].numpy(), cp)
        assert np.array_equal(got[1][k].numpy(), cr)
        assert tuple(int(n[k]) for n in got[2:]) == counts
    assert cs.classify_edge_splits(plane, r256, got[0].numpy(), design, q,
                                   rs) == cs.classify_expected_splits(q, rs)
    codes = set(np.unique(got[1].numpy()).tolist())
    assert {0, 141, 121, 149} <= codes
    assert (144 in codes) == (148 in codes) == (q >= T.HIGH1)


# csrc/residue.cu classify_effect: per band rule, the classes of the value
# written before a step (bit c: class c) for which the step writes w
_EFFECT_MASKS = {"res01 -7/-8": 0x06, "res2 -7/-8": 0x07, "res2 -6": 0x02,
                 "hi -6/-7/-8": 0x02, "res3 -6..-9": 0x0F, "res4 7..9": 0x1C,
                 "dec16": 0x3F}


def _effect(res, v, hi1, rs):
    """A numpy transcription of classify_case + classify_effect: (w, mask)
    of a step with mark 0, pf = res, band value v."""
    dec16 = v > 15 and v % 8 == 0
    m78, m6 = v in (-7, -8), v == -6
    if res in (0, 1):
        return (-9, _EFFECT_MASKS["res01 -7/-8"]) if m78 else (v, 0)
    if res == 2:
        if dec16:
            return v - 1, _EFFECT_MASKS["dec16"]
        if m78:
            return -9, _EFFECT_MASKS["res2 -7/-8"]
        return (-9, _EFFECT_MASKS["res2 -6"]) if m6 else (v, 0)
    if res == 3:
        if hi1:
            return v, 0
        if dec16:
            return v - 1, _EFFECT_MASKS["dec16"]
        return ((-10, _EFFECT_MASKS["res3 -6..-9"]) if -9 <= v <= -6
                else (v, 0))
    if res <= rs:
        return v, 0
    if res == 4:
        return (v + 2, _EFFECT_MASKS["res4 7..9"]) if 7 <= v <= 9 else (v, 0)
    if res <= 6 or (res > 7 and hi1):
        return v, 0
    if dec16:
        return v - 1, _EFFECT_MASKS["dec16"]
    return (-9, _EFFECT_MASKS["hi -6/-7/-8"]) if m78 or m6 else (v, 0)


@pytest.mark.parametrize("q", [20, 21])
def test_classify_effect_masks(q):
    """The kernel's step as (w, class mask) equals ``_classify_step`` from
    a value of each class, for every rule and res_setting the path uses,
    and the classes are those of ``_band_class``."""
    vs = torch.arange(-40, 41, dtype=torch.int32)
    assert tds._band_class(vs).tolist() == [
        int(v >= -7) + int(v >= 0) + int(v >= 2) + int(v >= 3) + int(v >= 8)
        for v in vs.tolist()]
    reps = torch.tensor(tds._CLASS_VALUES, dtype=torch.int32)
    assert tds._band_class(reps).tolist() == list(range(6))
    hi1 = q >= T.HIGH1
    for rs in (3, 4, 6, 8):
        for res in (-2, 0, 1, 2, 3, 4, 5, 6, 7, 8, 9):
            z = torch.zeros((6, vs.numel()), dtype=torch.int32)
            got = tds._classify_step(hi1, rs, reps[:, None].expand_as(z),
                                     z + res, z, vs.expand_as(z))[0]
            for i, v in enumerate(vs.tolist()):
                w, m = _effect(res, v, hi1, rs)
                want = [w if (m >> c) & 1 else v for c in range(6)]
                assert got[:, i].tolist() == want, (rs, res, v)


def test_column_255_walk_after_the_others_matters():
    """On the edge planes column 255's cross-column pair check fires with
    its j + 1 reads taken from the input (the JAX package's main pass),
    and not with the results the C reads: the walk after the barrier
    changes rf (r, 255)."""
    p, rf_ext = cs.col255_edge_inputs(2)
    rs = henc._res_setting(20)
    gp, grf = (x.numpy() for x in tds.column_ladder_device(_t(p), _t(rf_ext),
                                                           20, rs))
    z = np.zeros((2, 256, 256), np.int16)
    hp, hr = _host_ladder(p, rf_ext[:, :SZ].reshape(2, 256, 256), z,
                          np.zeros((2, 4), np.int16), 20)
    assert np.array_equal(gp, hp) and np.array_equal(
        grf.reshape(2, 256, 256), hr)
    flags = (True, False, False, rs)
    _, (_, marks, _) = jds._cl_main(p, rf_ext, flags)
    first = np.asarray(marks)[:, :, 255].T          # (B, 255) rows
    for k in range(2):
        r = cs.COL255_ROW0 + 13 * k
        assert first[k, r] == 12400
        assert hr[k, r, 255] == 0 and hr[k, r + 1, 0] == 12400
    assert not np.array_equal(first, grf.reshape(2, 256, 256)[:, :255, 255])


def _stream_check(rf, q, word_bits_seen):
    """The three streams of quality q chained on the CPU against the JAX
    function (every output) and the host copy's C (sections, rf')."""
    want_rf, want = cs.host_positional_streams(rf, q)
    got, streams = _t(rf), {}
    for key, codes, word_bits, q_min in des.RESIDUE_STREAMS:
        if q < q_min:
            continue
        wt, rt = des._stream_tables(codes)
        jout = jds.positional_stream_device(got.numpy(), wt, rt, word_bits)
        got, *s = tds.positional_stream_device(got, wt, rt, word_bits)
        for g, w in zip([got, *s], jout):
            assert np.array_equal(g.numpy(), np.asarray(w)), key
        streams[key] = (*s, word_bits)
        word_bits_seen.add(word_bits)
    assert not cs.sections_equal(des._residue_sections(streams), want)
    assert np.array_equal(got.numpy(), want_rf)
    return want


@pytest.mark.parametrize("kind", ["no codes", "every position",
                                  "isolated markers"])
def test_positional_streams_on_edge_rfs(kind):
    rf = cs.stream_edge_rfs(np.random.default_rng(5), 2)[kind]
    seen = set()
    want = _stream_check(rf, T.HIGH1, seen)
    assert seen == {1, 2}
    if kind == "isolated markers":
        # some isolated 254 markers are dropped: fewer bytes than rows
        # plus codes would give without the dedupe
        pos, _ = hres.build_positional_stream(rf[0].copy(),
                                              des.RESIDUE_STREAMS[0][1], 21)
        assert len(hres.dedupe_markers(pos)) < len(pos)
    if kind == "every position":
        assert all(len(w["res3_word"]) > 2 for w in want)


def test_positional_streams_on_ladder_output():
    """The streams on dense codes: the host C's ladder and classify on
    delta planes at q21."""
    p, _, r256, resIII, khead = cs.delta_inputs(np.random.default_rng(9), 2)
    hp, hr = _host_ladder(p, r256, resIII, khead, 21)
    for k in range(2):
        hres.res256_classify(hp[k], hr[k], 21, henc._res_setting(21))
    _stream_check(hr, 21, set())


def test_wrappers_check_their_inputs():
    z = torch.zeros((1, 512, 512), dtype=torch.int16)
    r = torch.zeros((1, 256, 256), dtype=torch.int16)
    with pytest.raises(TypeError):
        tds.pair_promotion_device(z.int())
    with pytest.raises(ValueError):
        tds.pair_promotion_device(r)
    with pytest.raises(ValueError):
        tds.column_ladder_device(z, torch.zeros((1, SZ), dtype=torch.int16),
                                 20, 3)
    with pytest.raises(ValueError):
        tds.column_ladder_device(
            z, torch.zeros((2, SZ + 1024), dtype=torch.int16), 20, 3)
    with pytest.raises(ValueError):
        tds.classify_device(z, torch.zeros((1, 128, 128), dtype=torch.int16),
                            20, 3)
    with pytest.raises(ValueError):
        tds.positional_stream_device(r, np.zeros(256), np.zeros(256), 3)
    with pytest.raises(ValueError):
        tds.positional_stream_device(r, np.zeros(255), np.zeros(256), 1)


def test_column_ladder_block_edges():
    """At columns 31, 32, 63, 64 and 254 the pair check fires on the next
    column's input deltas while that column's own walk lowers them (the
    C's order: column j walks before j + 1): the twin equals the JAX
    function and the host copy's C, and the inputs do what they claim."""
    p, rf_ext = cs.ladder_block_edge_inputs(2)
    rs = henc._res_setting(20)
    gp, grf = (x.numpy() for x in tds.column_ladder_device(_t(p), _t(rf_ext),
                                                           20, rs))
    z = np.zeros((2, 256, 256), np.int16)
    hp, hr = _host_ladder(p, rf_ext[:, :SZ].reshape(2, 256, 256), z,
                          np.zeros((2, 4), np.int16), 20)
    assert np.array_equal(gp, hp)
    assert np.array_equal(grf.reshape(2, 256, 256), hr)
    jp, jr = jds.column_ladder_device(p, rf_ext, 20, rs)
    assert np.array_equal(gp, np.asarray(jp))
    assert np.array_equal(grf, np.asarray(jr))
    for k in range(2):
        for j, r in cs.LADDER_EDGE_COLS.items():
            r += k
            assert hr[k, r, j] == 12400 and hr[k, r - 1, j + 1] == 12400
            assert hp[k, r, j + 1] == p[k, r, j + 1] - 2
