"""The edges that the cluster form of K2 and K3 creates, held to the JAX
package on the CPU with tolerance 0.

K2 (``y_stage2_full``) runs one cluster of 8 CTAs per image, CTA c owning
rows 64c..64c+63 of the transposed plane; a dering mark on row 64c reads
row 64c - 1 in the previous CTA, and row 0 reads row 511 in the last.
K3 (``uv_synth``) runs one cluster of 4 CTAs per plane, with LL rows
32c..32c+31 and plane rows 64c..64c+63 in CTA c.  The inputs put marks
and residue sentinels on those edges, and on the first and last columns
(``chip_smoke.edge_marks``, ``edge_sentinel_planes``), and rows with more
marks than a warp of K2 has lanes (``dense_marks``); the JAX side runs
the Pallas kernels in interpret mode and the plain XLA reference, the
port's side its torch twins, which the kernels equal on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import (EDGE_BAND_COLS, EDGE_BAND_ROWS, EDGE_MARK_COLS,
                        EDGE_MARK_ROWS, dense_marks, edge_marks,
                        edge_sentinel_planes, planes, residue_bound_plane)
from nhwcodec_tpu.models import device_decode as jdd
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import dwt


def _k2_inputs(kind):
    rng = np.random.default_rng(51)
    if kind == "residue bound":
        return residue_bound_plane(2)
    lo, hi = (-32768, 32768) if kind == "full range" else (-2, 3)
    marks = dense_marks(2) if kind == "dense rows" else edge_marks(2)
    dp, n_waves, ok = tdd.mark_depth_planes(marks)
    assert ok
    return planes(rng, 2, 512, lo, hi), dp, n_waves


def test_edge_marks_sit_on_every_cta_edge():
    dp, n_waves, ok = tdd.mark_depth_planes(edge_marks(1))
    assert ok and n_waves == 6
    rows = set(np.nonzero(dp[0].any(1))[0].tolist())
    # both sides of every CTA edge of K2, and the wrapping rows
    want = {0, 510} | {64 * c for c in range(1, 8)} | {
        64 * c - 2 for c in range(1, 8)}
    assert want <= rows and all(j % 2 == 0 for j in rows)
    assert rows == {2 * r for r in EDGE_MARK_ROWS}
    assert dp[0][:, 0].any() and dp[0][:, 255].any()
    assert set(np.nonzero(dp[0].any(0))[0].tolist()) == set(EDGE_MARK_COLS)


@pytest.mark.parametrize("kind", ["near-flat", "full range",
                                  "residue bound", "dense rows"])
def test_y_stage2_full_cta_edges_match_pallas(kind):
    jp, dp, n_waves = _k2_inputs(kind)
    want = np.asarray(pallas_dwt.y_stage2_full_pallas(
        jnp.asarray(jp), jnp.asarray(dp), n_waves, interpret=True))
    got = dwt.y_stage2_full(torch.from_numpy(jp), torch.from_numpy(dp),
                            n_waves).numpy()
    np.testing.assert_array_equal(got, want)
    if kind == "near-flat":
        # the waves fired on every marked row and column of the near-flat
        # image, both sides of each CTA edge and the wrapping rows included
        t = dwt.unnorm_rows_t_ref(torch.from_numpy(jp))
        changed = (dwt.dering_waves_ref(t, torch.from_numpy(dp), n_waves)
                   != t).numpy()[0]
        assert set(np.nonzero(changed.any(1))[0].tolist()) == {
            2 * r for r in EDGE_MARK_ROWS}
        assert set(np.nonzero(changed.any(0))[0].tolist()) == set(
            EDGE_MARK_COLS)


def test_y_stage2_full_cta_edges_match_xla():
    # the same edge marks through the JAX stage function (fused=False),
    # which takes the post-dering LL1 separately and transposes it in
    rng = np.random.default_rng(52)
    jp = planes(rng, 2, 512, -2, 3)
    proc = (jp[:, :256, :256] >> 1).astype(np.int16)
    dp, n_waves, _ = tdd.mark_depth_planes(edge_marks(2))
    want = np.asarray(jdd.y_stage2_dense_device(
        jnp.asarray(jp), jnp.asarray(proc), None, None, jnp.asarray(dp),
        n_waves, fused=False))
    got = tdd.y_stage2_dense(*tdd.front_to_torch("cpu", jp, proc, dp),
                             n_waves).numpy()
    np.testing.assert_array_equal(got, want)


def test_edge_sentinels_sit_on_every_cta_edge():
    x = edge_sentinel_planes(np.random.default_rng(53), 1)[0]
    sent = (x >= 5003) & (x <= 5006)
    for r0, c0 in ((0, 128), (128, 0), (128, 128)):
        band = sent[r0:r0 + 128, c0:c0 + 128]
        assert set(np.nonzero(band.any(1))[0].tolist()) == set(EDGE_BAND_ROWS)
        assert set(np.nonzero(band.any(0))[0].tolist()) == set(EDGE_BAND_COLS)
    # plane rows 63/64 and 127/128 (K3's CTA edges of the 256 plane)
    assert sent[[63, 64, 127, 128]].any(1).all()
    # every sentinel kind, in column 127 of each band (the dropped spill)
    assert set(np.unique(x[sent]).tolist()) == {5003, 5004, 5005, 5006}
    assert sent[:128, 255].any() and sent[128:, 127].any()


@pytest.mark.parametrize("ref", ["pallas", "xla"])
def test_uv_synth_cta_edges_match_jax(ref):
    x = edge_sentinel_planes(np.random.default_rng(54), 3)
    if ref == "pallas":
        want = pallas_dwt.uv_synth_pallas(jnp.asarray(x), interpret=True)
    else:
        want = jdd.uv_synth_device(jnp.asarray(x), fused=False)
    got = dwt.uv_synth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, np.asarray(want))
