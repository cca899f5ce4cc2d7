"""The device encode scans' LL2 stage, module by module
(``models/device_scans.py``: ``ll2_code_y_device`` with its twin
``ll2_code_y_ref``, ``ll2_code_uv_device``, ``y_highres_device``,
``uv_highres_device`` and ``walk_visited_device`` with its twin
``walk_visited_ref``) on the CPU, tolerance 0.

- Each equals the JAX package's function (XLA:CPU, batch 2) and the host
  copy's C (``host.ops.ll2``, ``nhw_ll2_code_uv``): the LL2 byte coding on
  ``chip_smoke.ll2_edge_planes`` (odd 4-runs ending at the row's end,
  values about 10000 and 20000, int16 extremes, escapes at positions 0
  and 1, all-even and dense-odd planes, and the band edge planes: relay
  chains of nudges through every band edge, 4-runs across the lanes'
  4-column edges, in the CTAs' halo rows and in rows 128-130) with
  gt_low3 both ways; the Y
  run-delta coder in each of its three modes, forced by long pair runs,
  with q_gt_low5 both ways; the UV coder; the walk against JAX's
  ``_walk_visited`` on seeded random monotone successors with parks, on
  ``chip_smoke.walk_edge_rows`` / ``squeeze_edge_rows`` and on the
  segmented walk's edges (``chip_smoke.walk_segment_rows``: jumps onto
  segment ends and over many segments, a park in the first segment, n
  off the segment grid, n = 1, a start in the last segment), and from
  every kind of start; the segment size against the kernel's limits.
- S7's twin takes the kernel's decomposition (the marks by a scan of the
  skip counter's 4-state maps over 4-position lane tiles, the nudge scan
  by bands of ``LL2_BAND_ROWS`` rows relayed): its sweeps on the edge
  planes (as many as bands on the band edge planes), and numpy
  transcriptions of the kernel's map composition (a byte permute) and
  lane scan against a plain skip walk; the layout against ``ll2.cu``.
- The wrappers check their inputs.

The stage as a whole: tests/test_torch_encode_ll2_stage.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.ops import ll2 as hll2
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


def _eq(got, want):
    return np.array_equal(np.asarray(got, np.int64), np.asarray(want,
                                                               np.int64))


@pytest.mark.parametrize("gt_low3", [True, False])
@pytest.mark.parametrize("kind", cs.LL2_EDGE_KINDS)
def test_ll2_code_y(kind, gt_low3):
    p = cs.ll2_edge_planes(np.random.default_rng(11), 2, kind)
    got = [x.numpy() for x in tds.ll2_code_y_device(_t(p), gt_low3)]
    want = [np.asarray(x) for x in jds.ll2_code_y_device(p, gt_low3)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _eq(g, w)
    Pz, tree1, ch_res, exw, n_exw, res4, n_res4 = got
    q = T.LOW3 + 1 if gt_low3 else T.LOW3
    for k in range(2):
        proc = p[k].copy()
        h_tree1, h_ch_res, h_exw, h_res4 = hll2.ll2_code_y(proc, q)
        assert _eq(Pz[k], proc)
        assert _eq(tree1[k], h_tree1) and _eq(ch_res[k], h_ch_res)
        assert _eq(exw[k, : n_exw[k]].reshape(-1), h_exw)
        if gt_low3:
            assert _eq(res4[k, : n_res4[k]], h_res4)
    # the inputs reach what they claim: marks and nudges, escapes
    vem, is24 = tds.ll2_code_y_ref(_t(p), gt_low3)
    ll = torch.from_numpy(p[:, :128, :128].astype(np.int32))
    base = tds._ll2y_marks(ll) if gt_low3 else ll
    if gt_low3:
        base = torch.where(base > 20000, base - 24000,
                           torch.where(base > 10000, base - 16000, base))
    nudged = (vem.reshape(2, 128, 128) != base).sum().item()
    if kind == "all even" or not gt_low3:
        assert nudged == 0
    else:
        assert nudged > 0 and is24.any()
    if kind == "runs and marks":
        assert (n_exw > 0).all() and (exw[:, :, 0] == 0).any()


def test_ll2_band_edges_reach_what_they_claim():
    """On the band edge planes every band's exact entry holds the chains'
    nudges (row 8 b's values at the chain columns come out one up) while
    a band walked from no pend exits with none, so the relay takes as many
    sweeps as bands; the 4-runs across the lanes' edges and in the CTAs'
    halo rows are marked, those in rows 128-130 are not read."""
    p = cs.ll2_edge_planes(np.random.default_rng(14), 2, "band edges")
    x = _t(p)
    assert tds.ll2_code_y_sweeps(x, True).tolist() == [tds.LL2_BANDS] * 2
    assert tds.ll2_code_y_sweeps(x, False).tolist() == [1, 1]
    vem, is24 = (v.reshape(2, 128, 128).numpy()
                 for v in tds.ll2_code_y_ref(x, True))
    cols = list(cs.LL2_CHAIN_COLS)
    nudged = vem[:, :, cols] - p[:, :128, cols]
    edges = np.arange(tds.LL2_BAND_ROWS, tds.LL, tds.LL2_BAND_ROWS)
    assert (nudged[:, edges] == 1).all()
    assert (nudged[:, 1::2] == 0).all() and (nudged[:, 2::2] == 1).all()
    # the runs: a mark in a CTA's first rows (another CTA's halo) and at
    # the row's end, across a lane edge
    rows = tds.LL // tds.LL2_CTAS
    for r in range(rows, tds.LL, rows):
        assert is24[:, r: r + 3].any()
    assert is24[:, :, min(cs.LL2_RUN_STARTS):].any()
    ll = p[:, 128:131, :128].astype(np.int64)
    odd4 = ((ll[..., :-3] & 1) & (ll[..., 1:-2] & 1) & (ll[..., 2:-1] & 1)
            & (ll[..., 3:] & 1)).astype(bool)
    assert (odd4 & (np.abs(ll[..., :-3] - ll[..., 3:]) > 1)).any(-1).all()


def _compose4(a, b):
    """numpy transcription of ll2.cu ``compose4``: "a then b" as a byte
    permute of b by a's bytes packed as nibbles."""
    x = (a | (a >> 4)) & 0x00FF00FF
    sel = (x | (x >> 8)) & 0xFFFF
    out = np.zeros_like(b)
    for n in range(4):
        k = (sel >> (4 * n)) & 7
        out |= ((b >> (8 * k)) & 0xFF) << (8 * n)
    return out


def test_skip_walk_scan_transcription():
    """ll2.cu's marking (each lane's 4 maps composed, a warp's inclusive
    scan by shuffles, each lane's walk from its entry) against a plain
    skip walk, on rows of every match density."""
    rng = np.random.default_rng(15)
    match = rng.random((300, 128)) < rng.random((300, 1))
    match[:, 125:] = False
    want = np.zeros((300, 128), np.int64)
    for r in range(300):
        j = 0
        while j < 125:
            if match[r, j]:
                want[r, j] = 24000
                want[r, j + 1: j + 4] = 16000
                j += 4
            else:
                j += 1
    hit, miss = 0x02010003, 0x02010000
    lanes = match.reshape(300, 32, 4)
    f = np.full((300, 32), 0x03020100, np.int64)
    for i in range(4):
        f = _compose4(f, np.where(lanes[..., i], hit, miss))
    for d in (1, 2, 4, 8, 16):
        g = np.concatenate([f[:, :d], f[:, :-d]], 1)
        f = np.where(np.arange(32) >= d, _compose4(g, f), f)
    e = np.concatenate([np.zeros((300, 1), np.int64), f[:, :-1] & 0xFF], 1)
    got = np.zeros((300, 32, 4), np.int64)
    sk = e
    for i in range(4):
        fire = (sk == 0) & lanes[..., i]
        got[..., i] = np.where(fire, 24000, np.where(sk > 0, 16000, 0))
        sk = np.where(fire, 3, np.maximum(sk - 1, 0))
    assert np.array_equal(got.reshape(300, 128), want)


def test_ll2_layout_is_the_kernels():
    """The twin's cluster and band constants are ll2.cu's."""
    import re
    from pathlib import Path

    src = (Path(tds.__file__).resolve().parent.parent / "csrc" /
           "ll2.cu").read_text()
    for name, want in (("kYCtas", tds.LL2_CTAS),
                       ("kYBandRows", tds.LL2_BAND_ROWS)):
        assert int(re.search(rf"{name} = (\d+);", src).group(1)) == want
    assert "kYBands = kLL / kYBandRows;" in src
    assert tds.LL2_BANDS * tds.LL2_BAND_ROWS == tds.LL


def test_ll2_code_y_scan_is_its_twin_on_cpu():
    p = _t(cs.ll2_edge_planes(np.random.default_rng(12), 3, "dense odd"))
    for g, w in zip(tds.ll2_code_y_scan(p, True), tds.ll2_code_y_ref(p,
                                                                     True)):
        assert torch.equal(g, w)


def test_ll2_code_uv():
    rng = np.random.default_rng(13)
    p = rng.integers(-30, 300, (2, 256, 256)).astype(np.int16)
    p[0, 0, :2] = (300, -4)
    p[1, 0, :2] = (-9, 256)
    got = [x.numpy() for x in tds.ll2_code_uv_device(_t(p))]
    want = [np.asarray(x) for x in jds.ll2_code_uv_device(p)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _eq(g, w)
    Pz, tree1, exw, n_exw = got
    for k in range(2):
        proc = p[k].copy()
        h_tree1, h_exw = cs.host_ll2_code_uv(proc)
        assert _eq(Pz[k], proc) and _eq(tree1[k], h_tree1)
        assert _eq(exw[k, : n_exw[k]].reshape(-1), h_exw)
    assert (n_exw > 20).all()


def _tree1_with_runs(rng, run: int, n_runs: int) -> np.ndarray:
    """(2, 16384) uint8 tree1 values (even): ``n_runs`` runs of ``run``
    equal values, then a random walk of mixed steps (deltas of 0, +-2, +-4,
    up to +-40, and jumps), so every node type of the mode appears."""
    out = np.zeros((2, 16384), np.uint8)
    for k in range(2):
        vals = rng.integers(0, 128, n_runs) * 2
        head = np.repeat(vals, run)[: 16384]
        steps = rng.choice(np.array([0, 0, 2, -2, 4, -4, 8, -8, 16, -16, 40,
                                     -40, 120]), 16384 - head.size)
        walk = (np.cumsum(steps) % 256) & 254
        out[k] = np.concatenate([head, walk]).astype(np.uint8)
    return out


@pytest.mark.parametrize("q_gt_low5", [True, False])
@pytest.mark.parametrize("mode", [0, 1, 2])
def test_y_highres(mode, q_gt_low5):
    rng = np.random.default_rng(20 + mode)
    run, n_runs = {0: (3, 400), 1: (10, 400), 2: (20, 400)}[mode]
    tree1 = _tree1_with_runs(rng, run, n_runs)
    ch_res = (tree1 | rng.integers(0, 2, tree1.shape)).astype(np.int32)
    h = np.zeros((2, tds.YH_PAD), np.int32)
    h[:, :16384] = tree1
    got = [x.numpy() for x in tds.y_highres_device(_t(h), _t(ch_res),
                                                    q_gt_low5)]
    want = [np.asarray(x) for x in jds.y_highres_device(h, ch_res,
                                                        q_gt_low5)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _eq(g, w)
    out, n_out, res_low, hw, n_hw, hm, n_hm = got
    assert (res_low == mode).all()
    q = T.LOW5 + 1 if q_gt_low5 else T.LOW5
    for k in range(2):
        h_out, h_rl, h_hw, h_hm = hll2.y_highres_compression(
            tree1[k], ch_res[k].astype(np.uint8), q)
        assert h_rl == mode
        assert _eq(out[k, : n_out[k]], h_out)
        assert _eq(hw[k, : n_hw[k]], h_hw) and _eq(hm[k, : n_hm[k]], h_hm)
    if q_gt_low5:
        assert (n_hm > 0).all()


def test_uv_highres():
    rng = np.random.default_rng(30)
    h = np.zeros((2, tds.UV_PAD), np.int32)
    for k in range(2):
        runs = np.repeat(rng.integers(0, 64, 300) * 4, rng.integers(
            2, 20, 300))[:4000]
        steps = rng.choice(np.array([0, 0, 4, -4, 8, -8, 16, -16, 60]),
                           8192 - runs.size)
        h[k, :8192] = np.concatenate([runs, np.cumsum(steps) % 256]) & 252
    got = [x.numpy() for x in tds.uv_highres_device(_t(h))]
    want = [np.asarray(x) for x in jds.uv_highres_device(h)]
    for g, w in zip(got, want):
        assert g.dtype == w.dtype and _eq(g, w)
    out, cnt = got
    for k in range(2):
        assert _eq(out[k, : cnt[k]], hll2.uv_highres_compression(
            h[k, :8192]))


@pytest.mark.parametrize("n", [8272, 24641, 65536])
def test_walk_visited_random(n):
    rng = np.random.default_rng(n)
    nxt = (np.arange(n)[None] + rng.integers(1, 70, (2, n))).astype(np.int32)
    park = rng.random((2, n)) < 0.01
    nxt[park] = n + rng.integers(0, 1000, int(park.sum()))
    got = tds.walk_visited_device(_t(nxt), 1).numpy()
    assert _eq(got, np.asarray(jds._walk_visited(nxt, 1)))
    assert got.sum() > 10


@pytest.mark.parametrize("kind", ["jumps of 65", "jumps 255/256",
                                  "long jumps", "parks", "squeeze",
                                  "squeeze at LOW5"])
def test_walk_visited_edge_rows(kind):
    rng = np.random.default_rng(40)
    if kind.startswith("squeeze"):
        nxt = cs.squeeze_edge_rows(rng, 3, kind == "squeeze")
    else:
        nxt = cs.walk_edge_rows(rng, 3, kind)
    got = tds.walk_visited_ref(_t(nxt), 1).numpy()
    # the parks row's non-increasing successor is a self-loop, which ends
    # the pointer-doubling closure too
    assert _eq(got, np.asarray(jds._walk_visited(nxt, 1)))
    assert got[:, 1].all()


@pytest.mark.parametrize("kind", cs.WALK_SEGMENT_KINDS)
def test_walk_twin_on_segment_edge_rows(kind):
    """The segmented twin against JAX's pointer doubling where the
    segments' edges matter: jumps onto a segment's first and last nodes,
    over many segments, a park in the first segment, n off the segment
    grid, n = 1, a start in the last segment."""
    nxt, start = cs.walk_segment_rows(np.random.default_rng(50), 3, kind)
    got = tds.walk_visited_ref(_t(nxt), start).numpy()
    assert _eq(got, np.asarray(jds._walk_visited(nxt, start)))
    assert got[:, start].all()
    s = 1 << tds.walk_segment_log2(nxt.shape[1])
    if kind == "onto segment ends":
        on = got[:, s::s].sum() + got[:, s - 1::s].sum()
        assert on > 50
    elif kind == "over many segments":
        idx = np.flatnonzero(got[0])
        assert (np.diff(idx // s) >= 2).sum() > 5
    elif kind == "park in segment 0":
        assert got[:, s:].sum() == 0
    elif kind == "start in the last segment":
        assert got[:, :start].sum() == 0 and (start // s + 1) * s == 65536


@pytest.mark.parametrize("n", [2, 3, 17, 64, 65, 1000, 4097])
def test_walk_twin_random_starts(n):
    """Every start, jumps short and long, against JAX's doubling."""
    rng = np.random.default_rng(n)
    nxt = (np.arange(n)[None] + rng.integers(1, 2 + n // 8, (2, n))).astype(
        np.int32)
    nxt[rng.random((2, n)) < 0.02] = n + 3
    for start in sorted({0, 1, n // 3, n - 2, n - 1}):
        got = tds.walk_visited_ref(_t(nxt), start).numpy()
        assert _eq(got, np.asarray(jds._walk_visited(nxt, start)))


def test_walk_segments_fit_the_kernel():
    """s = 2^walk_segment_log2(n) has s * s >= n, so a row of n <= 65536
    has at most kWalkMaxSegs segments of at most 2^kWalkMaxSegLog2 nodes
    (csrc/ll2.cu), and s is the least such power of two."""
    import re
    from pathlib import Path

    src = (Path(tds.__file__).resolve().parent.parent / "csrc" /
           "ll2.cu").read_text()
    segs_max = int(re.search(r"kWalkMaxSegs = (\d+);", src).group(1))
    log2_max = int(re.search(r"kWalkMaxSegLog2 = (\d+);", src).group(1))
    for n in range(1, tds.WALK_MAX_N + 1):
        lg = tds.walk_segment_log2(n)
        s = 1 << lg
        assert s * s >= n and (lg == 0 or (s // 2) ** 2 < n)
        assert lg <= log2_max and -(-n // s) <= segs_max


def test_wrappers_check_inputs():
    nxt = torch.zeros((2, 10), dtype=torch.int32)
    with pytest.raises(TypeError):
        tds.walk_visited_device(nxt.long())
    with pytest.raises(ValueError):
        tds.walk_visited_device(torch.zeros((1, 65537), dtype=torch.int32))
    with pytest.raises(ValueError):
        tds.walk_visited_device(nxt, 10)
    with pytest.raises(ValueError):
        tds.walk_visited_device(torch.zeros((2, 20), dtype=torch.int32)[:,
                                                                       ::2])
    with pytest.raises(TypeError):
        tds.ll2_code_y_scan(torch.zeros((1, 512, 512), dtype=torch.int32),
                            True)
    with pytest.raises(ValueError):
        tds.y_highres_device(torch.zeros((1, 16384), dtype=torch.int32),
                             torch.zeros((1, 16384), dtype=torch.int32),
                             True)
    with pytest.raises(ValueError):
        tds.uv_highres_device(torch.zeros((1, 8192), dtype=torch.int32))
