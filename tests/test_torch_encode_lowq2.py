"""The device encode scans' programs below LOW7 (``models/device_scans.py``,
``models/device_encode_scans.lowest_q_xs_device``) on the CPU, tolerance
0.

- ``very_low_q_cleanup_ref`` (S12's twin: pass 1 as 124 column steps of
  the rows, passes 2 and 3 as the kernel's relay of row windows, each
  row's newest value the one the row above wrote a step before, then
  pass 4, the count masks and the far zeroings as ``vlq_far`` applies
  them), ``low_q_ll1_cleanup_ref``
  (S13's twin: 256 column steps of rows 128..255) and
  ``uv_ll_smooth_ref`` (S14's twin: both passes as anti-diagonal steps)
  equal the JAX package's functions at batch 2 on seeded planes (q12,
  q11 and q1; x1 10 and 11), and the host copy's C
  (``_very_low_q_cleanup``, ``_low_q_ll1_cleanup``, ``_uv_ll_smooth``) on
  the edge planes of ``chip_smoke`` (``vlq_edge_planes``,
  ``ll1_edge_planes``, ``uvs_edge_planes``), each checked on the C's own
  output to reach what it claims: a pass-1 write chained into the next
  window, a wave step whose left read is the same pass's write, fires at
  the relay's warp edges, pass 3's stale carry 4 and 0, a level-2 zeroing inside the LL1 cleanup's region,
  a zeroed left neighbour isolating the next value, the row ends.  On the
  stale-carry-0 planes the JAX function, which applies that zeroing after
  the passes, differs from the C; the port follows the C.
- ``lowest_q_xs_device`` equals the host copy's and the JAX package's
  ``_lowest_q_xs`` at q12, q11 and q10 on planes at each count band's
  edges, and the residue stage takes one tuple an image in a batch of
  mixed counts.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu.models import encoder as jenc
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


def _vlq(x, q):
    return tds.very_low_q_cleanup_device(torch.from_numpy(x), q,
                                         henc._VLQ_THRX(q, None)).numpy()


# ---------------------------------------------------------------------------
# S12: the very-low-q cleanup


@pytest.mark.parametrize("q", [T.LOW8, T.LOW9, T.LOW19])
def test_very_low_q_twin_matches_jax_and_host(q):
    x = cs.vlq_edge_planes(np.random.default_rng(31), 2, "random")
    got = _vlq(x, q)
    assert np.array_equal(got, np.asarray(jds.very_low_q_cleanup_device(
        x, q, henc._VLQ_THRX(q, None))))
    assert np.array_equal(got, cs.host_vlq(x, q))
    # every pass fires, and the far bands change
    _, masks = tds.very_low_q_passes_ref(torch.from_numpy(x), q,
                                         henc._VLQ_THRX(q, None))
    assert masks.flatten(2).any(2).all()
    assert (got[:, 256:] != x[:, 256:]).any()


@pytest.mark.parametrize("kind, q", [(k, q) for k in cs.VLQ_KINDS
                                     for q in cs.VLQ_EDGE_QS[k]])
def test_very_low_q_edges_match_host(kind, q):
    x = cs.vlq_edge_planes(np.random.default_rng(32), 2, kind)
    assert np.array_equal(_vlq(x, q), cs.host_vlq(x, q))


def test_vlq_warp_edges_match_jax_and_host():
    """Passes 2-3 fire at visit rows 31/32, 63/64 and 95/96, where lane 31
    of one warp of the relay writes the row that lane 0 of the next
    reads."""
    q = T.LOW9
    x = cs.vlq_edge_planes(np.random.default_rng(49), 2, "warp edges")
    got = _vlq(x, q)
    assert np.array_equal(got, np.asarray(jds.very_low_q_cleanup_device(
        x, q, henc._VLQ_THRX(q, None))))
    assert np.array_equal(got, cs.host_vlq(x, q))
    m = _masks(x, q)
    rows = (m[:, 1] | m[:, 2]).any(-1)
    assert rows[:, [31, 32, 63, 64, 95, 96]].all()
    assert not rows[:, 40:56].any()


def _masks(x, q):
    return tds.very_low_q_passes_ref(torch.from_numpy(x), q,
                                     henc._VLQ_THRX(q, None))[1].numpy()


@pytest.mark.parametrize("q", [T.LOW8, T.LOW19])
def test_vlq_pass1_write_chains_into_the_next_window(q):
    """Window 1 writes 1 at column 3 only from window 0's write at
    column 2 (with the 9 there, it fires without writing); passes 2 and
    3 never fire on these rows."""
    x = cs.vlq_edge_planes(np.random.default_rng(33), 2, "p1 chain")
    out = cs.host_vlq(x, q)
    assert (x[:, :128, 3] - x[:, :128, 0] == 4).all()
    assert (out[:, :128, 3] - x[:, :128, 0] == 1).all()
    m = _masks(x, q)
    assert m[:, 0, :, :2].all() and not m[:, 1:].any()


@pytest.mark.parametrize("q", [T.LOW8, T.LOW19])
def test_vlq_wave_step_reads_its_left_write(q):
    """Pass 2's visit (4k, 1) writes 7 above the 10 of (4k + 1, 2) from
    (4k + 1, 1) = 14, visit (4k, 0)'s write (from its 10: 6); pass 3 never
    fires."""
    x = cs.vlq_edge_planes(np.random.default_rng(34), 2, "wave left")
    out = cs.host_vlq(x, q)
    base = x[:, 1:128:4, :1]
    assert (x[:, 1:128:4, 1:3] - base == 0).all()
    assert (out[:, 1:128:4, 1] - base[..., 0] == 4).all()
    assert (out[:, 1:128:4, 2] - base[..., 0] == -3).all()
    m = _masks(x, q)
    assert m[:, 1, 0:126:4, :2].all() and not m[:, 2].any()


@pytest.mark.parametrize("q", [T.LOW9, T.LOW12])
def test_vlq_stale_carry_4(q):
    """Pass 3 hits in row 0 before any fire, with a pass-1 fire and no
    pass-2 fire: the stale carry 4 zeroes its level-2 targets under 11,
    12 and 13 (the 12 at 65541 stays), which no fire mask reaches."""
    x = cs.vlq_edge_planes(np.random.default_rng(35), 2, "stale use4")
    out = cs.host_vlq(x, q).reshape(2, -1)[:, cs.STALE_TARGETS[4]]
    assert (out == [0, 0, 0, 0, 0, 0, 0, 12, 0]).all()
    m = _masks(x, q).reshape(2, 4, -1)
    assert m[:, 0].any(1).all() and not m[:, 1].any()
    first_hit = m[:, 3].argmax(1)
    assert (first_hit < 128).all() and (first_hit < m[:, 2].argmax(1)).all()
    assert (_vlq(x, T.LOW8).reshape(2, -1)[:, cs.STALE_TARGETS[4]]
            != 0).sum() == 2 * 8   # no level-2 zeroing at q12


@pytest.mark.parametrize("q", [T.LOW9, T.LOW12])
def test_vlq_stale_carry_0_zeroes_what_pass_3_reads(q):
    """With no pass-1 or pass-2 fire, row 0's first hits zero (0, 127)
    (carry 0 - 1 + 128), and pass 3's visit (0, 125) then fails its test;
    with the 10 kept until after the passes (the JAX function's order) it
    fires and zeroes the bands around (1, 126)."""
    x = cs.vlq_edge_planes(np.random.default_rng(36), 2, "stale use0")
    out = cs.host_vlq(x, q)
    assert (x[:, 0, 127] == 10).all() and (out[:, 0, 127] == 0).all()
    assert not out.reshape(2, -1)[:, cs.STALE_TARGETS[0]].any()
    m = _masks(x, q)
    assert not m[:, :2].any() and m[:, 3, 0, :120].any(1).all()
    assert not m[:, 3, 0, 125].any() and not m[:, 2, 0].any()
    jax_out = np.asarray(jds.very_low_q_cleanup_device(
        x, q, henc._VLQ_THRX(q, None)))
    assert (jax_out[:, 2:4, 508:510] == 0).all()
    assert (out[:, 2:4, 508:510] == 3).all()
    assert (jax_out != out).sum() == 2 * 19


@pytest.mark.parametrize("q", [T.LOW9, T.LOW19])
def test_vlq_level2_zeroing_lands_in_the_ll1_region(q):
    """The composition runs the LL1 cleanup and then the very-low-q
    cleanup: the latter's level-2 zeroings change rows 128..255, columns
    0..255, after the former, and the twins chained equal the C's."""
    x = cs.vlq_edge_planes(np.random.default_rng(37), 2, "l2 in ll1")
    y = cs.host_ll1(x, q)
    z = cs.host_vlq(y, q)
    hit = (z != y)[:, 128:256, :256]
    assert hit.sum() > 1000 and not z[:, 128:256, :256][hit].any()
    assert (y != x)[:, 128:256, :256].any()
    x1 = 10 if q > T.LOW14 else 11
    got = tds.very_low_q_cleanup_device(
        tds.low_q_ll1_cleanup_device(torch.from_numpy(x), x1), q,
        henc._VLQ_THRX(q, None))
    assert np.array_equal(got.numpy(), z)


# ---------------------------------------------------------------------------
# S13: the LL1 cleanup


@pytest.mark.parametrize("q", [T.LOW9, T.LOW14])
def test_low_q_ll1_twin_matches_jax_and_host(q):
    x1 = 10 if q > T.LOW14 else 11
    x = cs.ll1_edge_planes(np.random.default_rng(38), 2, "random")
    got = tds.low_q_ll1_cleanup_device(torch.from_numpy(x), x1).numpy()
    assert np.array_equal(got, np.asarray(jds.low_q_ll1_cleanup_device(
        x, x1)))
    assert np.array_equal(got, cs.host_ll1(x, q))
    assert (got != x).sum() > 4000


@pytest.mark.parametrize("kind", cs.LL1_KINDS)
def test_low_q_ll1_edges_match_host(kind):
    x = cs.ll1_edge_planes(np.random.default_rng(39), 2, kind)
    for q in (T.LOW9, T.LOW14):
        got = tds.low_q_ll1_cleanup_device(
            torch.from_numpy(x), 10 if q > T.LOW14 else 11).numpy()
        assert np.array_equal(got, cs.host_ll1(x, q))


def test_low_q_ll1_zero_chain_and_row_ends():
    """The 9 beside an 8 is zeroed only because the 8 was (the walk's
    left value); column 0 reads the previous row's column 511, column 255
    column 256."""
    rng = np.random.default_rng(40)
    x = cs.ll1_edge_planes(rng, 1, "zero chain")
    out = cs.host_ll1(x, T.LOW9)[0, 128:256]
    assert (x[0, 128:256, 2:256:4] == 9).all()
    assert not out[:, 1:256:4].any() and not out[:, 2:256:4].any()
    x = cs.ll1_edge_planes(rng, 1, "row ends")
    out = cs.host_ll1(x, T.LOW9)[0, 128:256]
    r = np.arange(128)
    assert (out[:, 0] == np.where(r % 2, 9, 0)).all()
    assert (out[:, 255] == np.where(r % 4 < 2, 0, 9)).all()


# ---------------------------------------------------------------------------
# S14: the chroma LL smoothing


def test_uv_ll_smooth_twin_matches_jax_and_host():
    x = cs.uvs_edge_planes(np.random.default_rng(41), 2, "random")
    got = tds.uv_ll_smooth_device(torch.from_numpy(x)).numpy()
    assert np.array_equal(got, np.asarray(jds.uv_ll_smooth_device(x)))
    assert np.array_equal(got, cs.host_uvs(x))
    assert (got != x).sum() > 2000


def test_uv_ll_smooth_wave_step_reads_its_left_write():
    """The first pass's visit (4k, 1) writes 3 at (4k + 1, 2) from (4k +
    1, 1) = 1, visit (4k, 0)'s write (from its 0: 2); the second pass
    never fires on these rows."""
    x = cs.uvs_edge_planes(np.random.default_rng(42), 2, "wave left")
    out = cs.host_uvs(x)
    assert np.array_equal(tds.uv_ll_smooth_device(torch.from_numpy(x))
                          .numpy(), out)
    base = x[:, 1:64:4, 0]
    assert (out[:, 1:64:4, 1] - base == 1).all()
    assert (out[:, 1:64:4, 2] - base == 3).all()


def test_lowq2_wrappers_check_their_inputs():
    p = torch.zeros((1, 512, 512), dtype=torch.int16)
    with pytest.raises(ValueError, match="1 <= q < 13"):
        tds.very_low_q_cleanup_device(p, T.LOW7, henc._VLQ_THRX(12, None))
    with pytest.raises(ValueError, match="7 thresholds"):
        tds.very_low_q_cleanup_device(p, 12, (8, 13, 6, 11))
    with pytest.raises(ValueError, match="x1 12"):
        tds.low_q_ll1_cleanup_device(p, 12)
    with pytest.raises(TypeError):
        tds.low_q_ll1_cleanup_device(p.int(), 10)
    with pytest.raises(ValueError):
        tds.uv_ll_smooth_device(torch.zeros((1, 256, 256),
                                            dtype=torch.int16).transpose(1, 2))
    with pytest.raises(ValueError):
        tds.very_low_q_cleanup_device(p.transpose(1, 2), 12,
                                      henc._VLQ_THRX(12, None))


# ---------------------------------------------------------------------------
# the count-adaptive lowest-q thresholds


@pytest.mark.parametrize("q", [T.LOW8, T.LOW9, T.LOW10])
def test_lowest_q_xs_count_bands(q):
    """At each band edge of the count (6999/7000, 10000/10001,
    12500/12501) the device tuple equals the host copy's and the JAX
    package's; the -32768s do not count."""
    x = cs.xs_count_planes(np.random.default_rng(43), cs.XS_COUNTS)
    got = des.lowest_q_xs_device(torch.from_numpy(x), q)
    assert got.dtype == torch.int32 and got.shape == (len(x), 5)
    want = [henc._lowest_q_xs(p.reshape(-1), q) for p in x]
    assert [tuple(r) for r in got.tolist()] == want
    assert want == [jenc._lowest_q_xs(p.reshape(-1), q) for p in x]
    assert len(set(want)) == 4 and want[1] != want[0] and want[3] != want[2]
    assert des.lowest_q_xs_device(torch.from_numpy(x), T.LOW7).tolist() == [
        list(des.LOW7_XS)] * len(x)


def test_residue_stage_takes_one_tuple_an_image():
    """At q10 the residue stage (no E12: no stream) runs the lowest-q
    cleanup with each image's own tuple in a batch of mixed counts."""
    q = T.LOW10
    rng = np.random.default_rng(44)
    x = cs.xs_count_planes(rng, (5000, 8000, 11000, 13000))
    b = len(x)
    resIII = rng.integers(-20, 21, (b, 256, 256)).astype(np.int16)
    res256 = rng.integers(-20, 21, (b, 256, 256)).astype(np.int16)
    khead, ktail = (rng.integers(-20, 21, (b, 4)).astype(np.int16)
                    for _ in range(2))
    tree1 = rng.integers(0, 256, (b, 16384)).astype(np.uint8)
    P, streams = des._y_residue_stage(
        *(torch.from_numpy(a) for a in (x, res256, khead, resIII)), q,
        torch.from_numpy(ktail), torch.from_numpy(tree1))
    assert streams == {} and des._residue_sections(streams, b) == [{}] * b
    xs = np.array([henc._lowest_q_xs(p.reshape(-1), q) for p in x])
    assert len({tuple(r) for r in xs}) == b
    r3 = np.stack([cs.lowq_r3_ext(resIII[k], ktail[k], tree1[k])
                   for k in range(b)])
    want = cs.host_lowest_q(x, r3, q, xs)
    block = resIII.copy()
    block[:, :128, :128][block[:, :128, :128] <= 8000] = 0
    want[:, :256, :256] = block
    assert np.array_equal(P.numpy(), want)
