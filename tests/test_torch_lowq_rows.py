"""S11 ``lowest_q_band_cleanup`` in its cluster decomposition on the CPU,
tolerance 0 (exact).

- ``lowest_q_band_cleanup_ref`` (the twin: each visit a table of the next
  carry state from 5, the lane tiles' maps scanned, loop A's rows walked
  from their state 0, B + C's row maps composed per CTA and chained over
  the cluster from row 256's entry) equals the JAX package's function and
  the host copy's C at q13 and q10 on ``chip_smoke.lowq_edge_inputs``'
  "lane edges" (pairL on a tile's first column, pairR on its last, each
  carry state entering a tile, the +-7 snap as the carry above LOW10 and
  not below) and "row chain" (a chain through all 256 rows of B + C,
  reset by a few rows, entered from loop A's row 255 both ways), each
  kind checked on the C's output to do what it claims.
- ``lowest_q_band_cleanup_plan``'s lane entry states (loop A's and B +
  C's) equal the carries of a plain serial walk (the C's loops, in
  Python) at every lane's first visit, on those and on random planes.
- A numpy transcription of the kernel's packed steps (a visit's table as
  6-bit fields of bit masks, the lane's walks from the 5 states, 15-bit
  maps, the warps' shuffle scans,
  the CTAs' scans of their row maps, the cluster's words and their chain,
  the walk again with the lane-edge pairL and column 511's rule) equals
  the host copy's C.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.models import device_encode_scans as des
from nhwcodec_tpu_torch.models import device_scans as tds

SZ = 65536
IDENT = 0x4688
XS = np.array(des.LOW7_XS, np.int32)


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _inputs(kind, seed=61):
    x, r3 = cs.lowq_edge_inputs(np.random.default_rng(seed), 2, kind)
    return x, r3, np.tile(XS, (2, 1))


def _twin(x, r3, q, xs):
    return tds.lowest_q_band_cleanup_device(
        torch.from_numpy(x), torch.from_numpy(r3), q,
        torch.from_numpy(xs)).numpy()


@pytest.mark.parametrize("q", [13, 10])
@pytest.mark.parametrize("kind", ["lane edges", "row chain"])
def test_lowest_q_new_edges_match_jax_and_host(kind, q):
    x, r3, xs = _inputs(kind)
    got = _twin(x, r3, q, xs)
    want = cs.host_lowest_q(x, r3, q, xs)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jds.lowest_q_band_cleanup_device(
        x, r3, q, tuple(XS.tolist()))))
    if kind == "lane edges":
        r = np.arange(256, 512)
        for e in range(16, 512, 16):
            p = (e // 16 + r) % 5
            v = 15 if e <= 256 else 23
            # pairL on the tile's first column zeroes the last one's -V
            assert (want[:, r[p == 0], e - 1] == 0).all()
            assert (x[:, r[p == 0], e - 1] == -v).all()
            # the tile entered with left 0 fires pairR on its first
            assert (want[:, r[p == 2], e + 1] == 0).all()
            if e > 256:
                # the +7 carry keeps the first visit's value above LOW10
                kept = want[:, r[p == 3], e]
                assert ((kept == v) if q > T.LOW10 else (kept == 0)).all()
    else:
        active = np.zeros(256, bool)
        state = None
        for r in range(256, 512):
            k = (r - 256) // 41 if (r - 256) % 41 == 0 and r > 256 else 0
            if k:
                state = k % 2 == 0
            active[r - 256] = state
        for i in range(2):
            act = active.copy()
            act[:41] = i % 2 == 0      # row 256's entry from loop A
            assert np.array_equal(want[i, 256:, 511] == 0, act)


# --- a plain serial walk: the C's loops, a visit at a time


def _visit(vin, left, right, r3ok, thi, tlo, lo2, x5, snap):
    av, pl, pr, v = abs(vin), False, False, vin
    if 8 <= av < thi:
        if r3ok:
            v = 0
        elif abs(vin + left) < x5 and abs(right) < x5:
            v, pl = 0, True
        elif abs(vin + right) < x5 and abs(left) < x5:
            v, pr = 0, True
    a2 = abs(v)
    if 8 <= a2 < tlo and ((abs(left) < 8 and abs(right) < 8) or a2 < lo2):
        v = (7 if v >= 16 else -7 if v <= -16 else 0) if snap else 0
    return v, pl, pr


def _serial(x, r3, q, xs):
    """The walk in place: (out, the carry (left, pending) before each
    visit: loop A's (256, 256), B + C's (256, 511))."""
    O = x.astype(np.int64).tolist()
    r3 = r3.astype(np.int64).tolist()
    x1, x2, x3, x4, x5 = map(int, xs)
    snap = q > T.LOW10
    ca = [[None] * 256 for _ in range(256)]
    cb = [[None] * 511 for _ in range(256)]
    for r in range(256):
        row, left, pend = O[r], O[r][255], False
        for j in range(256, 512):
            right = row[j + 1] if j < 511 else O[r + 1][0]
            ca[r][j - 256] = (left, pend)
            ok = abs(r3[128 + 128 * r + (j - 256) // 2]) < x4
            v, pl, pr = _visit(row[j], left, right, ok, x3 + 2, x3, 0, x5,
                               False)
            row[j] = v
            if pl:
                row[j - 1] = 0
            if pr:
                if j < 511:
                    row[j + 1] = 0
                else:
                    O[r + 1][0] = 0
            left, pend = v, pr
    pend256 = pend
    for r in range(256, 512):
        row, left = O[r], O[r - 1][511]
        pend = pend256 if r == 256 else False
        for j in range(511):
            c = j >= 256
            seg = (x2 + 1, x2, x2 - 5, snap) if c else (x1 + 2, x1, x1 - 4,
                                                        False)
            cb[r - 256][j] = (left, pend)
            ok = abs(r3[(SZ >> 1) + 128 * (r - 256) + j // 2]) < x4 + c
            v, pl, pr = _visit(row[j], left, row[j + 1], ok, *seg[:3], x5,
                               seg[3])
            row[j] = v
            if pl:
                if j:
                    row[j - 1] = 0
                else:
                    O[r - 1][511] = 0
            if pr:
                row[j + 1] = 0
            left, pend = v, pr
    return np.array(O, np.int16), ca, cb


def _carry(state, before):
    """(left, pending) of a carry state, ``before`` the input at the
    column before."""
    return ((before, False), (0, False), (0, True), (7, False),
            (-7, False))[state]


@pytest.mark.parametrize("q", [13, 10])
@pytest.mark.parametrize("kind", ["random", "lane edges", "row chain",
                                  "A into row 256"])
def test_lowest_q_plan_matches_serial_walk(kind, q):
    x, r3, xs = _inputs(kind, 62)
    plan = tds.lowest_q_band_cleanup_plan(
        torch.from_numpy(x), torch.from_numpy(r3), q, torch.from_numpy(xs))
    a_entry = plan["a_entry"].numpy()
    lane_entry = plan["lane_entry"].numpy()
    for i in range(len(x)):
        out, ca, cb = _serial(x[i], r3[i], q, xs[i])
        assert np.array_equal(out, cs.host_lowest_q(x[i:i + 1], r3[i:i + 1],
                                                    q, xs[i:i + 1])[0])
        for r in range(256):
            for lane in range(32):
                j = 256 + 8 * lane
                assert ca[r][j - 256] == _carry(a_entry[i, r, lane],
                                                x[i, r, j - 1])
                j = 16 * lane
                before = x[i, 255 + r, 511] if j == 0 else x[i, 256 + r,
                                                             j - 1]
                assert cb[r][j] == _carry(lane_entry[i, r, lane], before)


# --- a numpy transcription of the kernel (csrc/lowq.cu lowest_q_rows)


def _at(f, s):
    return (f >> (3 * s)) & 7


def _then(f, g):
    r = np.zeros_like(f)
    for s in range(5):
        r |= _at(g, _at(f, s)) << (3 * s)
    return r


def _warp_scan(m, axis):
    m = np.moveaxis(m, axis, -1).copy()
    lane = np.arange(32)
    d = 1
    while d < 32:
        b = np.concatenate([m[..., :d], m[..., :-d]], -1)
        m = np.where(lane >= d, _then(b, m), m)
        d <<= 1
    e = np.concatenate([np.full_like(m[..., :1], IDENT), m[..., :-1]], -1)
    return np.moveaxis(m, -1, axis), np.moveaxis(e, -1, axis)


FIELDS = 1 | 1 << 6 | 1 << 18 | 1 << 24          # states 0, 1, 3, 4
STAY = 6 << 6 | 12 << 12 | 18 << 18 | 24 << 24


def _u(a):
    return np.asarray(a, np.int64) & 0xFFFFFFFF


def _table(x, xl, right, r3ok, thi, tlo, lo2, x5, snap):
    """lq_table: 6 bits a state at 6 s, 6 x the next state and pairL (bit
    5), from unsigned range tests and field bit masks of the four lefts."""
    w1 = np.where(thi > 8, thi - 8, 0)
    w2 = np.where(tlo > 8, tlo - 8, 0)
    m1, w = x5 - 1, np.where(x5 > 0, 2 * x5 - 1, 0)
    lbc = np.where(x5 > 0, 1 << 6, 0) | np.where(x5 > 7, 1 << 18 | 1 << 24,
                                                 0)
    av = np.abs(x)
    c1 = _u(av - 8) < w1
    c2 = _u(av - 8) < w2
    lo = av < lo2
    r8 = _u(right + 7) < 15
    rok = _u(right + m1) < w
    prv = _u(x + right + m1) < w
    xb = x + m1
    la = (np.where(_u(xb + xl) < w, 1, 0) | np.where(_u(xb) < w, 1 << 6, 0)
          | np.where(_u(xb + 7) < w, 1 << 18, 0)
          | np.where(_u(xb - 7) < w, 1 << 24, 0))
    lb = lbc | np.where(_u(xl + m1) < w, 1, 0)
    lc = (FIELDS & ~1) | np.where(_u(xl + 7) < 15, 1, 0)
    pair = c1 & ~r3ok
    pl = np.where(pair & rok, la, 0)
    pr = np.where(pair & prv, lb & ~pl, 0)
    f1 = np.where(c1 & r3ok, FIELDS, pl | pr)
    hit = np.where(c2, (np.where(r8, lc, 0) | np.where(lo, FIELDS, 0))
                   & ~f1, 0)
    hit6 = np.where(snap & (x >= 16), 18, np.where(snap & (x <= -16), 24, 6))
    return (pr + f1) * 6 + hit * hit6 + (6 << 12) + (pl << 5)


def _lane_map(tabs):
    """A lane's 15-bit map from its tables: the walks from the 5 states'
    offsets, each offset / 6 as (off * 43) >> 8."""
    offs = [np.full(tabs.shape[:-1], 6 * s, np.int64) for s in range(5)]
    for k in range(tabs.shape[-1]):
        offs = [(tabs[..., k] >> o) & 31 for o in offs]
    return sum(((o * 43) >> 8) << (3 * s) for s, o in enumerate(offs))


def _value(off, x):
    return np.where(off == 0, x, np.where(off == 18, 7, np.where(
        off == 24, -7, 0)))


def _walk(tabs, st, x):
    """A lane's walk again from state st: the exit offset, values and
    pairL bits."""
    off = 6 * st
    vals, pls = [], []
    for k in range(tabs.shape[-1]):
        pls.append((tabs[..., k] >> (off + 5)) & 1)
        off = (tabs[..., k] >> off) & 31
        vals.append(_value(off, x[..., k]))
    return off, np.stack(vals, -1), np.stack(pls, -1).astype(bool)


def _kernel_np(x, r3, q, xs):
    b = len(x)
    I = x.astype(np.int64)
    R = r3.astype(np.int64)
    x1, x2, x3, x4, x5 = (xs[:, k].astype(np.int64).reshape(b, 1, 1, 1)
                          for k in range(5))
    snap = q > T.LOW10
    out = I.copy()
    rows = np.arange(256).reshape(256, 1, 1)
    lane = np.arange(32).reshape(1, 32, 1)
    # loop A: lane l on columns 256 + 8 l + k
    k8 = np.arange(8).reshape(1, 1, 8)
    j = 256 + 8 * lane + k8                            # (1, 32, 8)
    xa = I[:, :256][:, rows, j]                        # (B, 256, 32, 8)
    xla = I[:, :256][:, rows, j - 1]
    nxt_row = I[:, 1:257, 0].reshape(b, 256, 1, 1)
    ra = np.where(j + 1 < 512, I[:, :256][:, rows, np.minimum(j + 1, 511)],
                  nxt_row)
    oka = np.abs(R[:, 128 + 128 * rows + (j - 256) // 2]) < x4
    ta = _table(xa, xla, ra, oka, x3 + 2, x3, 0, x5, False)
    _, exc = _warp_scan(_lane_map(ta), 2)
    st, va, pla = _walk(ta, _at(exc, 0), xa)
    nextpl = np.concatenate([pla[..., 1:], np.concatenate(
        [pla[:, :, 1:, :1], np.zeros_like(pla[:, :, :1, :1])], 2)], -1)
    va = np.where(nextpl, 0, va)
    flag = st[:, :, 31] == 12
    e256 = st[:, 255, 31] // 6
    t256 = _table(I[:, 256, 0], I[:, 255, 511], I[:, 256, 1],
                  np.abs(R[:, SZ >> 1]) < x4[:, 0, 0, 0], x1[:, 0, 0, 0] + 2,
                  x1[:, 0, 0, 0], x1[:, 0, 0, 0] - 4, x5[:, 0, 0, 0], False)
    va[:, 255, 31, 7] = np.where((t256 >> (6 * e256 + 5)) & 1, 0,
                                 va[:, 255, 31, 7])
    out[:, :256, 256:] = va.reshape(b, 256, 256)
    out[:, :256, 255] = np.where(pla[:, :, 0, 0], 0, out[:, :256, 255])
    # B + C: lane l on columns 16 l + k, lane 31's last not visited
    k16 = np.arange(16).reshape(1, 1, 16)
    j = 16 * lane + k16
    H = I[:, 256:]
    xb = H[:, rows, j]
    prev511 = I[:, 255:511, 511].reshape(b, 256, 1, 1)
    xlb = np.where(j > 0, H[:, rows, np.maximum(j - 1, 0)], prev511)
    rb = H[:, rows, np.minimum(j + 1, 511)]
    c = j >= 256
    okb = np.abs(R[:, (SZ >> 1) + 128 * rows + j // 2]) < x4 + c
    tb = _table(xb, xlb, rb, okb, np.where(c, x2 + 1, x1 + 2),
                np.where(c, x2, x1), np.where(c, x2 - 5, x1 - 4), x5,
                c & snap)
    tb[:, :, 31, 15] = STAY
    inc, lane_pre = _warp_scan(_lane_map(tb), 2)
    rm = np.zeros((b, 256), np.int64)
    for s in range(5):
        rm |= (_at(inc[:, :, 31], s) == 2).astype(np.int64) << (3 * s)
    rinc, row_pre = _warp_scan(rm.reshape(b, 8, 32), 2)
    pub = rinc[..., 31] | (flag[:, 31::32].astype(np.int64) << 18)
    pub[:, 7] |= e256 << 15
    e = (pub[:, 7] >> 15) & 7
    cta_e = np.zeros((b, 8), np.int64)
    for k in range(8):
        cta_e[:, k] = e
        e = _at(pub[:, k] & 0x7FFF, e)
    row_e = _at(row_pre, cta_e[..., None]).reshape(b, 256)
    lane_e = _at(lane_pre, row_e[..., None])
    st, vb, plb = _walk(tb, lane_e, xb)
    vb[:, :, 31, 15] = xb[:, :, 31, 15]
    nextpl = np.concatenate([plb[..., 1:], np.concatenate(
        [plb[:, :, 1:, :1], np.zeros_like(plb[:, :, :1, :1])], 2)], -1)
    vb = np.where(nextpl, 0, vb)
    pl0 = np.concatenate([(tb[:, 1:, 0, 0] >> 5) & 1,
                          np.zeros((b, 1), np.int64)], 1).astype(bool)
    vb[:, :, 31, 15] = np.where((st[:, :, 31] == 12) | pl0, 0,
                                vb[:, :, 31, 15])
    out[:, 256:] = vb.reshape(b, 256, 512)
    # loop A's column 0: the row above's pairR at 511 (the cluster's word
    # for a CTA's first row)
    above = np.concatenate([np.zeros((b, 1), bool), flag[:, :-1]], 1)
    above[:, 32::32] = ((pub[:, :7] >> 18) & 1).astype(bool)
    out[:, :256, 0] = np.where(above, 0, out[:, :256, 0])
    return out.astype(np.int16)


@pytest.mark.parametrize("q", [13, 10])
@pytest.mark.parametrize("kind", cs.LQ_KINDS)
def test_lowest_q_kernel_transcription_matches_host(kind, q):
    x, r3, xs = _inputs(kind, 63)
    assert np.array_equal(_kernel_np(x, r3, q, xs),
                          cs.host_lowest_q(x, r3, q, xs))
