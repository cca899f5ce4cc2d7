"""The device encode scans' low-q programs at q13..q16
(``models/device_scans.py``) on the CPU, tolerance 0.

- ``offset_y_low4_ref`` (S10's twin: the duty-cycle quantizer, each
  lane's tile of 16 columns a map of 8 states, the lane maps scanned, the
  row maps chained, each tile walked again, quant and quant6 as prefix
  counts of the row's ticks),
  ``lowest_q_band_cleanup_ref`` (S11's twin: loop A a row at a time, B +
  C's rows from both entry states, chained, walked again) and
  ``low56_band_cleanup_device`` (torch ops) equal the JAX package's
  functions at batch 2 on seeded planes, and the host copy's C
  (``quantize.offset_y`` at q16, ``nhw_lowest_q_band_cleanup``,
  ``_low56_band_cleanup``) on the edge planes of ``chip_smoke``
  (``oy4_edge_planes``, ``lowq_edge_inputs``), each checked to reach
  what it claims: a quant4 write across a row end, the counters' reset
  at a row start, writes pending across lane tiles, ticks counted across
  tiles, rows that enter pending and fire at column 511 again, pairR at column 510 chained into the next row's column
  0, pairL at column 0, loop A's writes into column 255 and row 256, r3
  reads in the tail past resIII; gt_low10 both ways; the LOW7 thresholds
  and two count-adaptive tuples (q11, q10), one per image too.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.models import device_encode_scans as des
from nhwcodec_tpu_torch.models import device_scans as tds


@pytest.fixture(autouse=True)
def _one_thread():
    # beside the other workers of a parallel run, intra-op threads make
    # the twins' many small ops slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _code(v):
    """Pass 4's code of a plain value past the dead zone."""
    return (np.asarray(v, np.int32) + 128) & 248


# ---------------------------------------------------------------------------
# S10: offset_y_low4


@pytest.mark.parametrize("kinds", [("random", "row ends"),
                                   ("row starts", "random")])
def test_offset_y_low4_twin_matches_jax_and_host(kinds):
    rng = np.random.default_rng(21)
    x = np.concatenate([cs.oy4_edge_planes(rng, 1, k) for k in kinds])
    got = tds.offset_y_low4_device(torch.from_numpy(x), 8).numpy()
    assert np.array_equal(got, np.asarray(jds.offset_y_low4_device(x, 8)))
    assert np.array_equal(got, cs.host_offset_y_low4(x))


@pytest.mark.parametrize("kind", ["tile edges", "tick runs", "row chains"])
def test_offset_y_low4_lane_tiles_match_jax_and_host(kind):
    """The twin's decomposition (lane tiles of 8-state maps, the row maps
    chained, the counters as prefix counts) on the lane-tile edge kinds."""
    x = cs.oy4_edge_planes(np.random.default_rng(45), 1, kind)
    got = tds.offset_y_low4_device(torch.from_numpy(x), 8).numpy()
    assert np.array_equal(got, np.asarray(jds.offset_y_low4_device(x, 8)))
    assert np.array_equal(got, cs.host_offset_y_low4(x))


def test_oy4_tile_edges_enter_lanes_in_every_state():
    """A fixup or a quant4 write pending at a tile's last column: lanes
    enter their tiles in each of the 8 states."""
    x = cs.oy4_edge_planes(np.random.default_rng(46), 1, "tile edges")
    plan = tds.offset_y_low4_plan(torch.from_numpy(x))
    seen = torch.bincount(plan["lane_entry"].flatten(), minlength=8)
    assert (seen[:6] > 1000).all() and (seen[6:] > 300).all()


def test_oy4_tick_runs_count_across_tiles():
    """In the host C's output the k-th tick of a row is masked where k is
    0 mod 6 (-15: code 120, else 112) or 0 mod 4 (-23: 112, else 104),
    though the runs cross the lanes' tiles."""
    x = cs.oy4_edge_planes(np.random.default_rng(47), 1, "tick runs")[0]
    out = cs.host_offset_y_low4(x[None])[0]
    for v, mod, masked, plain in ((-15, 6, 120, 112), (-23, 4, 112, 104)):
        t = x == v
        k = np.cumsum(t, 1) - 1
        assert (out[t] == np.where(k[t] % mod == 0, masked, plain)).all()
    runs = (x != 0) & (np.roll(x, 1, 1) != 0) & (np.arange(512) % 16 == 0)
    assert runs.sum() > 2000       # ticks on both sides of a tile edge


def test_oy4_row_chains_enter_pending_and_fire_at_511():
    """Every row after the first enters with a quant4 write pending at
    column 0 (up or down) and fires the pair rule at column 511 again."""
    x = cs.oy4_edge_planes(np.random.default_rng(48), 1, "row chains")
    plan = tds.offset_y_low4_plan(torch.from_numpy(x))
    ent = plan["entry"][0]
    assert ent[0] == 0 and set(ent[1:].tolist()) == {6, 7}
    assert (ent[1::2] == 7).all() and (ent[2::2] == 6).all()


def test_oy4_row_ends_cross_the_row_end():
    """The quant4 pair rule writes across row ends: where it fires, the
    next row's column 0 is coded as its value + 2 (31/22, 30/31) or column
    511 as its own + 2 (23/30, 22/31), in the host copy's C output, every
    kind in turn."""
    x = cs.oy4_edge_planes(np.random.default_rng(22), 1, "row ends")[0]
    out = cs.host_offset_y_low4(x[None])[0]
    kind = np.arange(511) % 5

    def up(got, v):
        return (got == _code(v + 2)) & (_code(v + 2) != _code(v))

    nxt, end = up(out[1:, 0], x[1:, 0]), up(out[:-1, 511], x[:-1, 511])
    for k in (0, 2):
        assert nxt[kind == k].sum() > 25 and not end[kind == k].any()
    for k in (1, 3):
        assert end[kind == k].sum() > 25 and not nxt[kind == k].any()
    assert 0.28 < (nxt | end)[kind < 4].mean() < 0.39   # every third pair


def test_oy4_row_starts_reset_the_counters():
    """Columns 0 and 1 (the row's first -15 and -23) are masked in every
    row, though most rows leave quant and quant6 nonzero: without the
    reset at the row start, they would not be."""
    x = cs.oy4_edge_planes(np.random.default_rng(23), 1, "row starts")[0]
    out = cs.host_offset_y_low4(x[None])[0]
    assert (out[:, 0] == 120).all() and (out[:, 1] == 112).all()
    n15 = (x == -15).sum(1)
    n23 = (x == -23).sum(1)
    assert (n15[:-1] % 6 != 0).mean() > 0.8
    assert (n23[:-1] % 4 != 0).mean() > 0.7
    assert _code(-15) == 112 and _code(-23) == 104   # unmasked


def test_oy4_random_planes_reach_every_rule():
    x = cs.oy4_edge_planes(np.random.default_rng(24), 1, "random")[0]
    out = cs.host_offset_y_low4(x[None])[0]
    for v in (-15, -23, -31, 31, 22, -9, 8, 200, -300, 10100, 14000):
        assert (x == v).sum() > 1000
    # a -7 after -14/-22/-30 is written -9 (code 120, not the dead zone's)
    f = x.reshape(-1)
    fix = np.nonzero((f[1:] == -7) & np.isin(f[:-1], (-14, -22, -30))
                     & (np.arange(1, f.size) % 512 != 0))[0] + 1
    assert fix.size > 100 and (out.reshape(-1)[fix] == 120).mean() > 0.9


# ---------------------------------------------------------------------------
# the low56 cleanup


@pytest.mark.parametrize("q", [T.LOW5, T.LOW6])
def test_low56_matches_jax_and_host(q):
    thrx2 = 19 if q == T.LOW5 else 20
    x = np.random.default_rng(25).integers(-30, 31, (2, 512, 512)).astype(
        np.int16)
    got = tds.low56_band_cleanup_device(torch.from_numpy(x), thrx2).numpy()
    assert np.array_equal(got, np.asarray(jds.low56_band_cleanup_device(
        x, thrx2)))
    for k in range(2):
        pf = x[k].reshape(-1).copy()
        henc._low56_band_cleanup(pf, q, 8)
        assert np.array_equal(got[k], pf.reshape(512, 512))
    # both halves and both snaps fire
    assert (got[:, 256:, :256] != x[:, 256:, :256]).any()
    assert (got[:, 256:, 256:] == 7).any() and (got[:, 256:, 256:] == -7).any()


# ---------------------------------------------------------------------------
# S11: the lowest-q band cleanup


def _lq(x, r3, q, xs):
    return tds.lowest_q_band_cleanup_device(
        torch.from_numpy(x), torch.from_numpy(r3), q,
        torch.from_numpy(np.asarray(xs, np.int32))).numpy()


@pytest.mark.parametrize("q", [T.LOW7, T.LOW10])
def test_lowest_q_twin_matches_jax_and_host(q):
    x, r3 = cs.lowq_edge_inputs(np.random.default_rng(26), 2, "random")
    xs = [henc._lowest_q_xs(p.reshape(-1), q) for p in x]
    assert xs[0] == xs[1]
    got = _lq(x, r3, q, xs)
    assert np.array_equal(got, np.asarray(jds.lowest_q_band_cleanup_device(
        x, r3, q, xs[0])))
    assert np.array_equal(got, cs.host_lowest_q(x, r3, q, np.array(xs)))


def test_lowest_q_thresholds_per_image():
    """Each image its own tuple: the LOW7 one, and the count-adaptive
    ones of q11 and q10 on a dense and a sparse plane."""
    rng = np.random.default_rng(27)
    x, r3 = cs.lowq_edge_inputs(rng, 3, "random")
    x[2] = np.where(rng.random(x[2].shape) < 0.04, x[2], 0)
    xs = [henc._lowest_q_xs(x[0].reshape(-1), T.LOW7),
          henc._lowest_q_xs(x[1].reshape(-1), T.LOW9),
          henc._lowest_q_xs(x[2].reshape(-1), T.LOW10)]
    assert xs[0] == des.LOW7_XS and len(set(xs)) == 3
    for q in (T.LOW9, T.LOW10):
        assert np.array_equal(_lq(x, r3, q, xs),
                              cs.host_lowest_q(x, r3, q, np.array(xs)))


@pytest.mark.parametrize("kind", cs.LQ_KINDS)
@pytest.mark.parametrize("q", [T.LOW7, T.LOW10])
def test_lowest_q_edges_match_host(kind, q):
    x, r3 = cs.lowq_edge_inputs(np.random.default_rng(28), 2, kind)
    xs = np.tile(np.array(des.LOW7_XS, np.int32), (2, 1))
    assert np.array_equal(_lq(x, r3, q, xs), cs.host_lowest_q(x, r3, q, xs))


def _edge_out(kind):
    x, r3 = cs.lowq_edge_inputs(np.random.default_rng(29), 1, kind)
    xs = np.array([des.LOW7_XS], np.int32)
    return x[0], cs.host_lowest_q(x, r3, T.LOW7, xs)[0]


def test_lowest_q_pair_r_chains_into_the_next_row():
    """pairR at column 510 zeroes 511, and the next row's column-0 visit
    reads that 0: its 15 stays (the old -15 would have made a pairL)."""
    x, out = _edge_out("pairR chain")
    r = np.arange(256, 511, 2)
    assert (x[r, 511] == -15).all() and (x[r + 1, 0] == 15).all()
    assert (out[r, 510] == 0).all() and (out[r, 511] == 0).all()
    assert (out[r + 1, 0] == 15).all()


def test_lowest_q_pair_l_at_column_0():
    """pairL at column 0 zeroes the previous row's column 511, which no
    visit of that row wrote (row 255's is loop A's)."""
    x, out = _edge_out("pairL column 0")
    r = np.arange(255, 510, 2)
    assert (x[r, 511] == -15).all() and (out[r, 511] == 0).all()
    assert (out[r, 510] == 0).all() and (out[r + 1, 0] == 0).all()
    assert (x[r + 1, 0] == 15).all()


def test_lowest_q_loop_a_writes_leave_its_region():
    """Loop A's pairR at column 511 zeroes the next row's column 0 (rows
    1..256; row 256's -12 would stay beside its 100), its pairL at column
    256 zeroes column 255."""
    x, out = _edge_out("A into row 256")
    assert (x[1:257, 0] == -12).all() and (out[1:257, 0] == 0).all()
    assert out[256, 1] == 100
    assert (x[0:256:2, 255] == -11).all() and (out[0:256:2, 255] == 0).all()
    assert (out[1:256:2, 255] == x[1:256:2, 255]).all()


def test_lowest_q_reads_the_tail_past_resIII():
    """Row 511's C visits read r3 at 65536 + (column - 256) // 2: only
    the tail's zeros make its 27s 0."""
    x, out = _edge_out("r3 tail")
    c = np.arange(0, 255, 2)
    zero = (c // 2) % 2 == 0
    assert (x[511, 256 + c] == 27).all()
    assert (out[511, 256 + c[zero]] == 0).all()
    assert (out[511, 256 + c[~zero]] == 27).all()


def test_lowest_q_gt_low10_snaps():
    """Above LOW10 the C segment's phase 2 snaps |v| >= 16 to +-7 (and
    the walk goes on from that value); at LOW10 and below it zeroes
    them.  Loop A's quadrant is the same both ways."""
    x, r3 = cs.lowq_edge_inputs(np.random.default_rng(30), 1, "random")
    xs = np.array([des.LOW7_XS], np.int32)
    hi = _lq(x, r3, T.LOW7, xs)[0]
    lo = _lq(x, r3, T.LOW10, xs)[0]
    assert (hi[:256] == lo[:256]).all()
    snap = (hi == np.sign(x[0]) * 7) & (lo == 0) & (np.abs(x[0]) >= 16)
    assert snap[256:, 256:511].sum() > 100 and not snap[:, :256].any()
    assert np.array_equal(hi, cs.host_lowest_q(x, r3, T.LOW7, xs)[0])
    assert np.array_equal(lo, cs.host_lowest_q(x, r3, T.LOW10, xs)[0])


def test_lowest_q_rejects_a_short_r3_ext():
    x = torch.zeros((1, 512, 512), dtype=torch.int16)
    xs = torch.tensor([des.LOW7_XS], dtype=torch.int32)
    r3 = torch.zeros((1, tds.LQ_R3_MIN - 1), dtype=torch.int16)
    with pytest.raises(ValueError, match="last plane row"):
        tds.lowest_q_band_cleanup_device(x, r3, T.LOW7, xs)
    with pytest.raises(TypeError):
        tds.lowest_q_band_cleanup_device(
            x, torch.zeros((1, tds.LQ_R3_EXT), dtype=torch.int16), T.LOW7,
            xs.to(torch.int64))
    assert tds.LQ_R3_MIN == 65664 and tds.LQ_R3_EXT == 65536 + 256
