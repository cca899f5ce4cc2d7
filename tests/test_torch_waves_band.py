"""The band form of K8 (``synth_norm_rows_clip_waves``), checked on the CPU.

On the card each call is one launch of ``waves_band`` (csrc/dwt.cu): a
CTA owns kW8Rows rows j0.. of one transposed plane, stages rows j0 - 1 ..
j0 + kW8Rows (modulo 512) with 16-byte copies, and each warp finishes
kW8RowsPerWarp of them, one even and one odd, with
``waves_norm_clip_row``: the row's marked cells compacted onto the lanes
(up to 32 a pass), each wave's reads before its writes, the normalised
pass and the clip.  K2's cluster kernel runs the same routine on its own
rows, with the neighbours at its CTA edges in the peer CTAs.

Here a numpy emulation of that decomposition, with the band and warp
sizes read from the source, rebuilds K8's output on the edge inputs of
``chip_smoke.WAVES_EDGE_INPUTS`` (marks on every band's first and last
rows, on row 0 and 510, in columns 0 and 511, a row of 384 marks, depths
past n_waves, one wave, no marks), equal to
``synth_norm_rows_clip_waves_ref`` and to
``synth_norm_rows_clip_waves_pallas`` in interpret mode, tolerance 0; on
those inputs the waves change image 0's output at batch 1 and 3 too.  It
also checks that no wave writes a row that another row's wave reads (so
the warps and CTAs may run in any order: both orders give the same
planes), that every row is finished once, and that K2's rows through the
same routine equal ``y_stage2_full_pallas`` on the cluster-edge inputs of
tests/test_torch_cluster_edges.py.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import dwt

N = 512
SOURCE = Path(dwt.__file__).resolve().parent.parent / "csrc" / "dwt.cu"
TEXT = SOURCE.read_text()
K = {name: int(v) for name, v in
     re.findall(r"constexpr int (k(?:W8|Y2)\w+) = (\d+);", TEXT)}
ROWS, THREADS = K["kW8Rows"], K["kW8Threads"]
WARP_ROWS = ROWS // (THREADS // 32)
Y2_ROWS = N // K["kY2Cluster"]
Y2_WARP_ROWS = Y2_ROWS // (K["kY2Threads"] // 32)
SCRATCH = 4 * N   # kRowScratch: a list of a whole row's cells, 4 bytes each


def test_band_shape_follows_the_source():
    assert chip_smoke.WAVES_BAND == ROWS and N % ROWS == 0
    # one even and one odd row a warp, in K8 and K2 alike
    assert WARP_ROWS == 2 and Y2_WARP_ROWS == 4
    assert "const int lr0 = warp * kW8RowsPerWarp;" in TEXT
    assert "const int lr0 = warp * (kY2Rows / kY2Warps);" in TEXT
    assert re.search(r"waves_band<<<dim3\(kY / kW8Rows, batch\), "
                     r"kW8Threads, kW8Smem", TEXT)
    # staged row s is row (j0 - 1 + s) mod 512, s < kW8Rows + 2
    assert "i < (kW8Rows + 2) * (kY / 8)" in TEXT
    assert "const int j = (j0 - 1 + s) & (kY - 1);" in TEXT
    # 67,584 bytes and 512 threads: two CTAs an SM, so batch 16's 256
    # CTAs fit the card's 132 SMs at once
    smem = 2 * (ROWS + 2) * N + THREADS // 32 * SCRATCH
    assert smem == 67584 and 2 * smem <= 227 * 1024
    assert 2 * THREADS <= 2048 and 16 * N // ROWS <= 2 * 132
    # the shared routine: K2 and K8 each call it once, nothing else
    # computes a wave
    assert TEXT.count("waves_norm_clip_row(") == 3
    assert TEXT.count("wave_cell(up, mid, dn") == 2


def _wrap16(v):
    return ((v + 32768) & 65535) - 32768


def _norm_row(row):
    """unnorm_pair + norm_value + clip on a whole row (csrc/lifting.cuh)."""
    m = N // 2
    lo, hi = row[:m].astype(np.int64), row[m:].astype(np.int64)
    k = np.arange(m)
    l1, hm1, hp1 = np.append(lo[1:], 0), np.insert(hi[:-1], 0, 0), \
        np.append(hi[1:], 0)
    e = _wrap16(lo * 8)
    o = _wrap16(np.where(k < m - 1, (l1 + lo) * 4, lo * 8))
    even = _wrap16(e - np.where(k == 0, hi * 4, (hi + hm1) * 2))
    odd = _wrap16(o + np.where(k == 0, 5 * hi - hp1, np.where(
        k == m - 1, 5 * hi - hm1, 6 * hi - hp1 - hm1)))
    out = np.empty(N, np.int64)
    out[0::2], out[1::2] = even, odd
    # upfilter53VI; numpy's >> on int64 is the arithmetic (floor) shift
    return np.clip(_wrap16(np.where(out > 0, out + 32, out)) >> 6, 0,
                   255).astype(np.uint8)


# the order of a row's cells in the compacted list: lane l's cells 64 s +
# 2 l + {0, 1}, s < 8, after those of lanes 0 .. l - 1
LIST_ORDER = (64 * (np.arange(16)[None, :] >> 1) + 2 * np.arange(32)[:, None]
              + (np.arange(16)[None, :] & 1)).ravel()


def finish_row(up, mid, dn, depth, n_waves, log):
    """waves_norm_clip_row on one row: ``mid`` (int64, in place) gets the
    waves, the output row is returned.  A row whose waves run appends its
    number of passes of 32 cells to ``log``."""
    assert sorted(LIST_ORDER) == list(range(N))
    last = min(n_waves, int(depth.max()))
    if last > 0:
        cells = LIST_ORDER[depth[LIST_ORDER] != 0]
        assert 4 * cells.size <= SCRATCH   # the list fits the warp's scratch
        log.append(-(-cells.size // 32))
        for r in range(1, last + 1):
            # every lane's reads of this wave, all passes, then the writes
            cs = cells[depth[cells] == r]
            cl, cr = (cs - 1) % N, (cs + 1) % N
            x, le, ri, u, d = mid[cs], mid[cl], mid[cr], up[cs], dn[cs]
            res = (x * 8 - le - ri - u - d - up[cl] - up[cr] - dn[cl]
                   - dn[cr])
            val = (x * 4 + le + ri + u + d + 4) >> 3
            take = np.abs(res) < 116
            mid[cs[take]] = val[take]
    return _norm_row(mid)


def emulate_k8(t, depth, n_waves, reverse=False):
    """K8's bands and warps on (B, 512, 512) int16 planes ``t``; the CTAs
    and warps run in order, or in reverse order.  Returns the uint8
    output and the log."""
    b = t.shape[0]
    out = np.zeros((b, N, N), np.uint8)
    done = np.zeros((b, N), np.int64)
    log = []
    order = (lambda r: r[::-1]) if reverse else (lambda r: r)
    for i in order(range(b)):
        for j0 in order(range(0, N, ROWS)):              # blockIdx.x
            staged = t[i, (j0 - 1 + np.arange(ROWS + 2)) % N].astype(np.int64)
            orig = staged.copy()
            written, read = set(), set()
            for w in order(range(ROWS // WARP_ROWS)):   # warps
                for lr in range(w * WARP_ROWS, (w + 1) * WARP_ROWS):
                    s = lr + 1
                    before = len(log)
                    out[i, j0 + lr] = finish_row(
                        staged[s - 1], staged[s], staged[s + 1],
                        depth[i, j0 + lr], n_waves, log)
                    done[i, j0 + lr] += 1
                    if len(log) > before:   # its waves read s - 1, s + 1
                        read |= {s - 1, s + 1}
                    if (staged[s] != orig[s]).any():
                        written.add(s)
            # the waves wrote only even rows of the band, and no row that
            # a wave read: the halo rows and the odd rows stay as staged
            assert not written & read
            assert all(s % 2 == 1 for s in written)   # row j0 - 1 + s even
            assert 0 not in written and ROWS + 1 not in written
    assert (done == 1).all()
    return out, log


def _inputs(kind, b=2):
    return chip_smoke.WAVES_EDGE_INPUTS[kind](np.random.default_rng(61), b)


def test_band_edge_inputs_hold_what_they_claim():
    _, dp, n_waves = _inputs("band edges")
    assert n_waves == 6 and not dp[:, 1::2].any()
    rows = set(np.nonzero(dp[0].any(1))[0].tolist())
    firsts = set(range(0, N, ROWS))
    lasts = {j0 + ROWS - 2 for j0 in firsts}
    assert rows == firsts | lasts | {chip_smoke.WAVES_DENSE_ROW}
    assert {0, N - 2} <= rows
    assert dp[0, :, 0].any() and dp[0, :, N - 1].any()
    assert (dp[0] > n_waves).any()
    assert (dp[0, chip_smoke.WAVES_DENSE_ROW] > 0).sum() > 32
    assert not _inputs("unmarked")[1].any()
    assert _inputs("band edges, one wave")[2] == 1


@pytest.mark.parametrize("kind", sorted(chip_smoke.WAVES_EDGE_INPUTS))
def test_emulated_bands_rebuild_the_twin(kind):
    t, dp, n_waves = _inputs(kind)
    tt, dpt = torch.from_numpy(t), torch.from_numpy(dp)
    want = dwt.synth_norm_rows_clip_waves_ref(tt, dpt, n_waves).numpy()
    np.testing.assert_array_equal(
        np.asarray(pallas_dwt.synth_norm_rows_clip_waves_pallas(
            jnp.asarray(t), jnp.asarray(dp), n_waves, interpret=True)), want)
    np.testing.assert_array_equal(
        dwt.synth_norm_rows_clip_waves(tt, dpt, n_waves).numpy(), want)
    got, log = emulate_k8(t, dp, n_waves)
    np.testing.assert_array_equal(got, want)
    np.testing.assert_array_equal(emulate_k8(t, dp, n_waves, True)[0], want)
    if kind == "unmarked":
        assert not log
    if kind.startswith("band edges"):
        # rows of one pass and the row of 12 passes of 32 cells
        assert 1 in log and 12 in log
        # the waves did work on these inputs
        assert (got != dwt.synth_norm_rows_clip_ref(tt).numpy()).any()


@pytest.mark.parametrize("b", [1, 3])
@pytest.mark.parametrize("kind", sorted(chip_smoke.WAVES_EDGE_INPUTS))
def test_waves_change_image_0_at_every_batch(kind, b):
    # image 0 is small-range at every batch size, so the waves change its
    # clipped output at batch 1 too (and the edge cases test waves that run)
    t, dp, n_waves = chip_smoke.WAVES_EDGE_INPUTS[kind](
        np.random.default_rng(62), b)
    assert np.abs(t[0].astype(np.int32)).max() <= 20
    tt, dpt = torch.from_numpy(t[:1]), torch.from_numpy(dp[:1])
    fired = (dwt.synth_norm_rows_clip_waves_ref(tt, dpt, n_waves)
             != dwt.synth_norm_rows_clip_ref(tt)).numpy()
    assert fired.any() == (kind != "unmarked")
    if kind.startswith("band edges"):
        # on a band's first or last row, past the column wrap too
        edges = [j0 + d for j0 in range(0, N, ROWS) for d in (0, ROWS - 2)]
        assert fired[0, edges].any()
        assert fired[0][:, [0, N - 1]].any()


def emulate_k2_back_end(t, depth, n_waves):
    """K2's rows after its row pass: CTA c of an image's cluster owns rows
    64c .. 64c + 63 of the transposed plane ``t``, warp w finishes rows
    4w .. 4w + 3 with the same routine; the rows above its first and
    below its last lie in the neighbouring CTAs (modulo the cluster)."""
    b = t.shape[0]
    out = np.zeros((b, N, N), np.uint8)
    for i in range(b):
        plane = t[i].astype(np.int64)
        for c in range(N // Y2_ROWS):
            for w in range(Y2_ROWS // Y2_WARP_ROWS):
                for lr in range(w * Y2_WARP_ROWS, (w + 1) * Y2_WARP_ROWS):
                    j = Y2_ROWS * c + lr
                    out[i, j] = finish_row(plane[(j - 1) % N], plane[j],
                                           plane[(j + 1) % N], depth[i, j],
                                           n_waves, [])
    return out


def _k2_inputs(kind):
    """tests/test_torch_cluster_edges.py's K2 inputs."""
    rng = np.random.default_rng(51)
    if kind == "residue bound":
        return chip_smoke.residue_bound_plane(2)
    lo, hi = (-32768, 32768) if kind == "full range" else (-2, 3)
    marks = (chip_smoke.dense_marks(2) if kind == "dense rows"
             else chip_smoke.edge_marks(2))
    dp, n_waves, ok = tdd.mark_depth_planes(marks)
    assert ok
    return chip_smoke.planes(rng, 2, 512, lo, hi), dp, n_waves


@pytest.mark.parametrize("kind", ["near-flat", "full range",
                                  "residue bound", "dense rows"])
def test_k2_through_the_shared_routine_matches_pallas(kind):
    jp, dp, n_waves = _k2_inputs(kind)
    want = np.asarray(pallas_dwt.y_stage2_full_pallas(
        jnp.asarray(jp), jnp.asarray(dp), n_waves, interpret=True))
    t = dwt.unnorm_rows_t_ref(torch.from_numpy(jp)).contiguous().numpy()
    np.testing.assert_array_equal(emulate_k2_back_end(t, dp, n_waves), want)
