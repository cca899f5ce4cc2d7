"""The decode's mark scan (``ops/dwt.smooth_marks_seq``, kernel
``mark_rows``) on the CPU, tolerance 0.

Its twin (``smooth_marks_seq_ref``) takes the kernel's decomposition: a
record reads only the earlier writes of its own LL row, so the rows are
independent, and step t applies every live record of rank t in its
(image, row) (``smooth_marks_ranks``).  It equals the JAX package's
sequential scan (``y_stage2_device(..., fused=False)`` through the port's
``y_stage2_seq``), the host decoder's per-mark loop and the host copy's C
``nhw_smooth_marks`` on every ``chip_smoke.MARK_KINDS`` list: out of
order, edges (rows 0 and 255, columns 0 and 255), dense (175 records a
row, several of the kernel's chunks), duplicates of one cell, padding
records between live ones, and a batch of very different K.  Records of
row 0 write nothing in the port (the decoder emits rows 1..254; JAX
would read past the plane's start), so JAX gets them as padding.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import decoder
from nhwcodec_tpu.models import device_decode as jdd
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import dwt

N = 512
# images a kind: "mixed K" cycles through five list lengths
BATCH = {kind: 5 if kind == "mixed K" else 2 for kind in cs.MARK_KINDS}


def _live(recs, valid):
    return valid & (recs >= 256) & (recs < 65536)


def _host_loop(x, recs, valid):
    """The host decoder's per-mark loop (decoder.decode_y_back) on each
    plane, over the image's live records in list order."""
    out = x.copy()
    for p, r in zip(out, np.where(_live(recs, valid), recs, -1)):
        flat = p.reshape(-1)
        for rec in r[r >= 0].tolist():
            scan = ((rec >> 8) << 10) + (rec & 255)
            if abs(decoder._lap8(flat, scan, N)) < 116:
                flat[scan] = np.int16(
                    ((int(flat[scan]) << 2) + int(flat[scan - 1])
                     + int(flat[scan + 1]) + int(flat[scan - N])
                     + int(flat[scan + N]) + 4) >> 3)
    return out


def _scan(x, recs, valid):
    return dwt.smooth_marks_seq(torch.from_numpy(x.copy()),
                                torch.from_numpy(recs),
                                torch.from_numpy(valid)).numpy()


@pytest.mark.parametrize("kind", cs.MARK_KINDS)
def test_mark_scan_twin_matches_the_host(kind):
    x, recs, valid = cs.mark_scan_inputs(np.random.default_rng(61),
                                         BATCH[kind], kind)
    got = _scan(x, recs, valid)
    np.testing.assert_array_equal(got, cs.host_marks(x, recs, valid))
    np.testing.assert_array_equal(got, _host_loop(x, recs, valid))
    # the scan smoothed at least half the cells its records name
    live = _live(recs, valid)
    cells = {(i, int(recs[i, j])) for i, j in zip(*np.nonzero(live))}
    assert (got != x).sum() >= len(cells) // 2


@pytest.mark.parametrize("kind", cs.MARK_KINDS)
def test_mark_scan_stage_matches_jax(kind):
    rng = np.random.default_rng(62)
    _, recs, valid = cs.mark_scan_inputs(rng, BATCH[kind], kind)
    b = len(recs)
    # near-flat coefficients, so the 8-neighbour residue stays under 116
    jp = rng.integers(-2, 3, (b, N, N)).astype(np.int16)
    proc = (jp[:, :256, :256] >> 1).astype(np.int16)
    idx = rng.integers(0, N * N, (b, 64)).astype(np.int32)
    dl = rng.integers(-60, 61, (b, 64)).astype(np.int16)
    want = np.asarray(jdd.y_stage2_device(
        jnp.asarray(jp), jnp.asarray(proc), jnp.asarray(idx),
        jnp.asarray(dl), jnp.asarray(recs),
        jnp.asarray(_live(recs, valid)), fused=False))
    got = tdd.y_stage2_seq(*tdd.front_to_torch("cpu", jp, proc, idx, dl,
                                               recs, valid)).numpy()
    np.testing.assert_array_equal(got, want)


def test_mark_ranks_count_the_earlier_records_of_the_row():
    rng = np.random.default_rng(63)
    recs = rng.integers(0, 1 << 17, (3, 400)).astype(np.int32)
    recs[:, ::3] = rng.integers(1, 5, (3, 134)) << 8 | rng.integers(0, 4,
                                                                    (3, 134))
    valid = rng.random((3, 400)) < 0.8
    img, k, rank = (a.numpy() for a in dwt.smooth_marks_ranks(
        torch.from_numpy(recs), torch.from_numpy(valid)))
    seen, want = {}, []
    for i, j in zip(*np.nonzero(_live(recs, valid))):
        key = (i, recs[i, j] >> 8)
        want.append(seen.get(key, 0))
        seen[key] = want[-1] + 1
    assert list(zip(img, k)) == list(zip(*np.nonzero(_live(recs, valid))))
    assert rank.tolist() == want
    assert max(want) >= 20


def test_mark_scan_rows_are_independent():
    """Each LL row's records alone give that row what the whole list
    gives it: rows 31/32 and 63/64 sit on the edges of the kernel's
    bands, and the list interleaves them."""
    rng = np.random.default_rng(64)
    x = rng.integers(-12, 13, (1, N, N)).astype(np.int16)
    ms = cs.random_marks(rng, 600) + [
        (r << 8) | c for c in range(40, 0, -1) for r in (31, 32, 63, 64)]
    recs, valid = tdd.pad_marks([ms])
    whole = _scan(x, recs, valid)
    for r in (31, 32, 63, 64, int(ms[0] >> 8)):
        alone = _scan(x, recs, valid & (recs >> 8 == r))
        np.testing.assert_array_equal(alone[0, 2 * r], whole[0, 2 * r])
        assert (alone[0, 2 * r] != x[0, 2 * r]).any()
