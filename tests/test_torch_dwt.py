"""nhwcodec_tpu_torch.ops.dwt: the torch twins of the decode's synthesis
kernels equal the JAX reference on the same numpy-seeded inputs.

The JAX side runs through its plain XLA reference (``fused=False``),
the way tests/test_device_decode.py holds the Pallas kernels, and for
K7-K9 also through the Pallas kernels in interpret mode.  The
tolerance is 0: the codec is integer-exact.  The kernels themselves
are held to these twins on the card (tests/test_torch_cuda.py,
chip_smoke.py).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhwcodec_tpu.models import device_decode as jdd
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import dwt


def _planes(rng, b, n, lo=-2000, hi=2000):
    """Half moderate values, half the full int16 range (wrap edges)."""
    x = rng.integers(lo, hi, (b, n, n)).astype(np.int16)
    x[b // 2:] = rng.integers(-32768, 32768, (b - b // 2, n, n))
    return x


def _random_marks(rng, b, run=6):
    """Mark lists with same-row runs of ``run`` marks (so up to ``run``
    waves), in the C emission order, as tests/test_device_decode.py."""
    marks_list = []
    for _ in range(b):
        ms = []
        for r in sorted(rng.choice(np.arange(1, 255), 60, replace=False)):
            run0 = int(rng.integers(1, 240))
            cs = sorted(set(rng.integers(1, 250, 5).tolist()
                            + list(range(run0, run0 + run))))
            ms.extend([(int(r) << 8) | int(c) for c in cs])
        ms.sort(key=lambda m: ((m & 255), (m >> 8)))
        marks_list.append(ms)
    return marks_list


@pytest.mark.parametrize("n", [128, 256])
def test_synth_level_ref_matches_jax(n):
    rng = np.random.default_rng(n)
    x = _planes(rng, 4, n)
    want = np.asarray(jdd._synth_level(jnp.asarray(x), fused=False))
    got = dwt.synth_level_ref(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)
    # the wrapper takes the twin for a CPU tensor, and counts no launch
    before = dict(build.LAUNCHES)
    np.testing.assert_array_equal(dwt.synth_level(torch.from_numpy(x)).numpy(),
                                  want)
    assert build.LAUNCHES == before


def test_synth_level_on_a_corner_view():
    # y_stage1 hands the kernel the (B, 256, 256) corner of a 512 plane
    rng = np.random.default_rng(5)
    x = _planes(rng, 2, 512)
    view = torch.from_numpy(x)[:, :256, :256]
    want = np.asarray(jdd._synth_level(jnp.asarray(x[:, :256, :256]),
                                       fused=False))
    np.testing.assert_array_equal(dwt.synth_level(view).numpy(), want)


def test_y_stage2_full_ref_matches_jax():
    rng = np.random.default_rng(3)
    b = 2
    # image 0 is near flat, so the 8-neighbour residue is small and
    # every wave smooths cells; image 1 spans the full int16 range
    jp = _planes(rng, b, 512, -2, 3)
    proc = (jp[:, :256, :256] >> 1).astype(np.int16)
    dp, n_waves, ok = tdd.mark_depth_planes(_random_marks(rng, b))
    assert ok and n_waves >= 6
    want = np.asarray(jdd.y_stage2_dense_device(
        jnp.asarray(jp), jnp.asarray(proc), None, None, jnp.asarray(dp),
        n_waves, fused=False))
    # the JAX stage transposes the post-dering LL1 in itself
    jp_t = jp.copy()
    jp_t[:, :256, :256] = proc.transpose(0, 2, 1)
    got = dwt.y_stage2_full(torch.from_numpy(jp_t), torch.from_numpy(dp),
                            n_waves).numpy()
    np.testing.assert_array_equal(got, want)
    # the waves did work: one wave fewer gives another image
    fewer = dwt.y_stage2_full(torch.from_numpy(jp_t), torch.from_numpy(dp),
                              n_waves - 1).numpy()
    assert (fewer != want).any()
    # and through the port's stage function, which does the transpose
    got2 = tdd.y_stage2_dense(*tdd.front_to_torch("cpu", jp, proc, dp),
                              n_waves).numpy()
    np.testing.assert_array_equal(got2, want)


def test_dering_residue_bound_is_strict():
    # jp row C with L band (p, x, q) at columns R-1..R+1 and H = 0 puts
    # (4(p+x), 8x, 4(x+q)) in column C, rows 2R-1..2R+1, of the transposed
    # plane, so the mark at (2R, C) sees res = 56x - 4(p+q): 116 (kept) at
    # (20, 10) and 112 (smoothed) at (40, 100)
    jp = np.zeros((1, 512, 512), np.int16)
    jp[0, 10, 19:22] = (685, 100, 686)
    jp[0, 100, 39:42] = (686, 100, 686)
    proc = jp[:, :256, :256].transpose(0, 2, 1).copy()
    dp, n_waves, ok = tdd.mark_depth_planes([[(20 << 8) | 10,
                                              (40 << 8) | 100]])
    assert ok and n_waves == 1
    t = dwt.unnorm_rows_t_ref(torch.from_numpy(jp))
    waved = dwt.dering_waves_ref(t, torch.from_numpy(dp), 1)
    assert waved[0, 40, 10] == t[0, 40, 10] == 800
    assert waved[0, 80, 100] != t[0, 80, 100]
    want = np.asarray(jdd.y_stage2_dense_device(
        jnp.asarray(jp), jnp.asarray(proc), None, None, jnp.asarray(dp),
        n_waves, fused=False))
    got = dwt.y_stage2_full(torch.from_numpy(jp), torch.from_numpy(dp),
                            n_waves).numpy()
    np.testing.assert_array_equal(got, want)


def _sentinel_planes(rng, b):
    x = rng.integers(-300, 300, (b, 256, 256)).astype(np.int16)
    for i in range(b):
        for r0, c0 in ((0, 128), (128, 0), (128, 128)):
            rows = rng.integers(0, 128, 400)
            cols = rng.integers(0, 128, 400)
            x[i, r0 + rows, c0 + cols] = rng.integers(5003, 5007, 400)
    # the column next to the LL edge, whose tgt+1 delta spills over
    x[:, 5, 128 + 127] = 5005
    x[:, 200, 127] = 5006
    return x


def test_uv_synth_ref_matches_jax():
    rng = np.random.default_rng(11)
    x = _sentinel_planes(rng, 3)
    want = np.asarray(jdd.uv_synth_device(jnp.asarray(x), fused=False))
    got = dwt.uv_synth(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("n", [256, 512])
def test_synth_unnorm_rows_t_matches_pallas(n):
    x = _planes(np.random.default_rng(20 + n), 2, n)
    want = np.asarray(pallas_dwt.synth_unnorm_rows_t_pallas(
        jnp.asarray(x), interpret=True))
    before = dict(build.LAUNCHES)
    got = dwt.synth_unnorm_rows_t(torch.from_numpy(x))
    assert build.LAUNCHES == before and got.is_contiguous()
    np.testing.assert_array_equal(got.numpy(), want)


def test_synth_norm_rows_clip_matches_pallas():
    # moderate planes reach both ends of the clip, full-range ones wrap
    x = _planes(np.random.default_rng(31), 2, 512, -20000, 20000)
    want = np.asarray(pallas_dwt.synth_norm_rows_clip_pallas(
        jnp.asarray(x), interpret=True))
    assert (want == 0).any() and (want == 255).any()
    got = dwt.synth_norm_rows_clip(torch.from_numpy(x))
    assert got.dtype == torch.uint8
    np.testing.assert_array_equal(got.numpy(), want)


def test_synth_norm_rows_clip_waves_matches_pallas_and_jax():
    rng = np.random.default_rng(41)
    b = 2
    # near-flat planes, so the waves fire (see test_y_stage2_full_ref)
    jp = _planes(rng, b, 512, -2, 3)
    proc = (jp[:, :256, :256] >> 1).astype(np.int16)
    dp, n_waves, ok = tdd.mark_depth_planes(_random_marks(rng, b))
    assert ok and n_waves >= 6
    idx = rng.integers(0, 512 * 512, (b, 64)).astype(np.int32)
    dl = rng.integers(-60, 61, (b, 64)).astype(np.int16)
    want = np.asarray(jdd.y_stage2_dense_device(
        jnp.asarray(jp), jnp.asarray(proc), jnp.asarray(idx),
        jnp.asarray(dl), jnp.asarray(dp), n_waves, fused=False))
    got = tdd.y_stage2_dense(*tdd.front_to_torch("cpu", jp, proc, dp),
                             n_waves, *tdd.front_to_torch("cpu", idx, dl))
    np.testing.assert_array_equal(got.numpy(), want)
    # K8's twin alone on the post-scatter plane, against the Pallas kernel
    jp_t = jp.copy()
    jp_t[:, :256, :256] = proc.transpose(0, 2, 1)
    t = tdd.hq_scatter_t(dwt.synth_unnorm_rows_t(torch.from_numpy(jp_t)),
                         torch.from_numpy(idx), torch.from_numpy(dl))
    dpt = torch.from_numpy(dp)
    pal = np.asarray(pallas_dwt.synth_norm_rows_clip_waves_pallas(
        jnp.asarray(t.numpy()), jnp.asarray(dp), n_waves, interpret=True))
    np.testing.assert_array_equal(
        dwt.synth_norm_rows_clip_waves(t, dpt, n_waves).numpy(), pal)
    np.testing.assert_array_equal(pal, want)
    # the waves did work: one wave fewer gives another image
    fewer = dwt.synth_norm_rows_clip_waves(t, dpt, n_waves - 1).numpy()
    assert (fewer != want).any()


@pytest.mark.parametrize("call", [
    lambda: dwt.synth_level(torch.zeros((1, 256, 256), dtype=torch.int32)),
    lambda: dwt.synth_level(torch.zeros((1, 200, 200), dtype=torch.int16)),
    lambda: dwt.uv_synth(torch.zeros((1, 128, 128), dtype=torch.int16)),
    lambda: dwt.y_stage2_full(torch.zeros((1, 512, 512), dtype=torch.int16),
                              torch.zeros((1, 512, 512), dtype=torch.int16),
                              1),
    lambda: dwt.synth_unnorm_rows_t(torch.zeros((1, 64, 64),
                                                dtype=torch.int16)),
    lambda: dwt.synth_norm_rows_clip(torch.zeros((1, 256, 128),
                                                 dtype=torch.int16)),
    lambda: dwt.synth_norm_rows_clip_waves(
        torch.zeros((1, 256, 256), dtype=torch.int16),
        torch.zeros((1, 256, 256), dtype=torch.uint8), 1),
    lambda: dwt.smooth_marks_seq(torch.zeros((1, 512, 512), dtype=torch.int16),
                                 torch.zeros((1, 8), dtype=torch.int64),
                                 torch.zeros((1, 8), dtype=torch.bool)),
])
def test_wrappers_reject_bad_inputs(call):
    with pytest.raises((TypeError, ValueError)):
        call()
