"""The port's CUDA kernels equal their torch twins on the card.

Marked ``cuda``: each test skips without a CUDA card.  On a GPU machine:
    python -m pytest tests/test_torch_cuda.py -q
chip_smoke.py runs the same checks at the decode path's full shapes.
"""

import numpy as np
import pytest
import torch

from chip_smoke import (ANALYSIS_EDGE_INPUTS, WAVES_EDGE_INPUTS,
                        analysis_path_shapes)
from nhwcodec_tpu.models import decoder, encoder
from nhwcodec_tpu.utils import fixtures
from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import colorspace, dwt

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    return torch.device("cuda")


def _planes(rng, b, n, lo, hi):
    x = rng.integers(lo, hi, (b, n, n)).astype(np.int16)
    x[b // 2:] = rng.integers(-32768, 32768, (b - b // 2, n, n))
    return x


@pytest.mark.parametrize("n", [128, 256, 512])
def test_synth_level_kernel(cuda, n):
    x = torch.from_numpy(_planes(np.random.default_rng(n), 3, n, -2000,
                                 2000)).to(cuda)
    before = build.LAUNCHES["synth_level"]
    got = dwt.synth_level(x)
    assert build.LAUNCHES["synth_level"] == before + 1
    torch.testing.assert_close(got, dwt.synth_level_ref(x), rtol=0, atol=0)
    view = x[:, : n // 2, : n // 2] if n > 128 else x
    torch.testing.assert_close(dwt.synth_level(view),
                               dwt.synth_level_ref(view), rtol=0, atol=0)


# K1 is one cluster launch: batch 1, 3 and 16, corner views of 512 and 256
# planes and whole 512 planes, int16 extremes and values at the CTA edges
SYNTH_CASES = [(256, 512), (128, 256), (512, 512)]


def _synth_planes(kind, rng, b, n):
    from chip_smoke import extreme_planes, synth_edge_planes

    return (extreme_planes if kind == "extremes" else synth_edge_planes)(
        rng, b, n)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["extremes", "CTA edges"])
@pytest.mark.parametrize("n, side", SYNTH_CASES)
def test_synth_level_cluster_kernel(cuda, n, side, kind, b):
    rng = np.random.default_rng(50 + b)
    parent = torch.from_numpy(rng.integers(-32768, 32768, (b, side, side))
                              .astype(np.int16)).to(cuda)
    parent[:, :n, :n] = torch.from_numpy(_synth_planes(kind, rng, b, n))
    view = parent[:, :n, :n]
    before = build.LAUNCHES["synth_level"]
    got = dwt.synth_level(view)
    assert build.LAUNCHES["synth_level"] == before + 1
    assert got.is_contiguous()
    torch.testing.assert_close(got, dwt.synth_level_ref(view), rtol=0, atol=0)


@pytest.mark.parametrize("n, side", SYNTH_CASES)
def test_synth_level_is_one_launch(cuda, n, side):
    from chip_smoke import launches_per_call

    x = torch.zeros((4, side, side), dtype=torch.int16, device=cuda)
    host, records, names = launches_per_call(
        lambda: dwt.synth_level(x[:, :n, :n]))
    assert host == 1 and len(set(names)) == 1
    assert "synth_cluster" in names[0] and 0 < records <= 1


def test_synth_level_misaligned_view_raises(cuda):
    # a base 8 bytes past a 16-byte boundary; a row stride of 260
    views = (torch.zeros((2, 256, 264), dtype=torch.int16,
                         device=cuda)[..., 4:260],
             torch.zeros((2, 256, 260), dtype=torch.int16,
                         device=cuda)[..., :256])
    for view in views:
        with pytest.raises(RuntimeError, match="misaligned"):
            dwt.synth_level(view)


def test_y_stage2_full_kernel(cuda):
    rng = np.random.default_rng(7)
    jp = torch.from_numpy(_planes(rng, 2, 512, -2, 3)).to(cuda)
    marks = []
    for _ in range(2):
        ms = []
        for r in sorted(rng.choice(np.arange(1, 255), 60, replace=False)):
            c0 = int(rng.integers(1, 240))
            ms.extend((int(r) << 8) | c for c in range(c0, c0 + 6))
        marks.append(sorted(ms, key=lambda m: ((m & 255), (m >> 8))))
    dp_np, n_waves, ok = tdd.mark_depth_planes(marks)
    assert ok and n_waves == 6
    dp = torch.from_numpy(dp_np).to(cuda)
    for w in (0, 1, n_waves):
        torch.testing.assert_close(dwt.y_stage2_full(jp, dp, w),
                                   dwt.y_stage2_full_ref(jp, dp, w),
                                   rtol=0, atol=0)


def test_y_stage2_full_kernel_residue_bound(cuda):
    # res = 116 at (40, 10) keeps the cell, res = 112 at (80, 100)
    # smooths it (see tests/test_torch_dwt.py)
    jp = np.zeros((1, 512, 512), np.int16)
    jp[0, 10, 19:22] = (685, 100, 686)
    jp[0, 100, 39:42] = (686, 100, 686)
    dp, n_waves, _ = tdd.mark_depth_planes([[(20 << 8) | 10,
                                             (40 << 8) | 100]])
    jt, dt = torch.from_numpy(jp).to(cuda), torch.from_numpy(dp).to(cuda)
    torch.testing.assert_close(dwt.y_stage2_full(jt, dt, n_waves),
                               dwt.y_stage2_full_ref(jt, dt, n_waves),
                               rtol=0, atol=0)


def test_uv_synth_kernel(cuda):
    rng = np.random.default_rng(9)
    x = rng.integers(-300, 300, (4, 256, 256)).astype(np.int16)
    for r0, c0 in ((0, 128), (128, 0), (128, 128)):
        x[:, r0 + rng.integers(0, 128, 500), c0 + rng.integers(0, 128, 500)] \
            = rng.integers(5003, 5007, 500)
    xt = torch.from_numpy(x).to(cuda)
    torch.testing.assert_close(dwt.uv_synth(xt), dwt.uv_synth_ref(xt),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the cluster kernels K2 and K3 at batch 1, 3 and 16, on the CTA edges


def _k2_case(kind, b):
    from chip_smoke import (dense_marks, edge_marks, mark_lists,
                            residue_bound_plane)

    rng = np.random.default_rng(60 + b)
    if kind == "residue bound":
        return residue_bound_plane(b)
    lo, hi = (-32768, 32768) if kind == "random" else (-2, 3)
    marks = {"CTA edges": edge_marks, "dense rows": dense_marks}.get(
        kind, lambda b: mark_lists(rng, b))(b)
    dp, n_waves, ok = tdd.mark_depth_planes(marks)
    assert ok
    return _planes(rng, b, 512, lo, hi), dp, n_waves


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["random", "near-flat", "residue bound",
                                  "CTA edges", "dense rows"])
def test_y_stage2_full_cluster_kernel(cuda, kind, b):
    jp, dp, n_waves = _k2_case(kind, b)
    jp, dp = (torch.from_numpy(a).to(cuda) for a in (jp, dp))
    for w in (0, 1, n_waves):
        before = build.LAUNCHES["y_stage2_full"]
        got = dwt.y_stage2_full(jp, dp, w)
        assert build.LAUNCHES["y_stage2_full"] == before + 1
        torch.testing.assert_close(got, dwt.y_stage2_full_ref(jp, dp, w),
                                   rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["random", "sentinels", "CTA edges"])
def test_uv_synth_cluster_kernel(cuda, kind, b):
    from chip_smoke import edge_sentinel_planes, sentinel_planes

    rng = np.random.default_rng(70 + b)
    x = {"random": lambda: _planes(rng, b, 256, -2000, 2000),
         "sentinels": lambda: sentinel_planes(rng, b),
         "CTA edges": lambda: edge_sentinel_planes(rng, b)}[kind]()
    xt = torch.from_numpy(x).to(cuda)
    before = build.LAUNCHES["uv_synth"]
    got = dwt.uv_synth(xt)
    assert build.LAUNCHES["uv_synth"] == before + 1
    torch.testing.assert_close(got, dwt.uv_synth_ref(xt), rtol=0, atol=0)


@pytest.mark.parametrize("name", dwt.CLUSTER_KERNELS)
def test_cluster_kernels_fit_the_card(cuda, name):
    info = dwt.cluster_info(name, cuda)
    assert info["max_active_clusters"] >= 1
    assert 0 < info["shared_bytes"] <= 232448
    assert 0 < info["registers"] <= 128


def test_colorspace_on_the_card(cuda):
    rng = np.random.default_rng(1)
    y, u, v = rng.integers(0, 256, (3, 512, 512)).astype(np.uint8)
    for q in (20, 17, 18, 16):
        got = colorspace.yuv_to_rgb(*(torch.from_numpy(a).to(cuda)
                                      for a in (y, u, v)), q)
        np.testing.assert_array_equal(got.cpu().numpy(),
                                      decoder.yuv_to_rgb(y, u, v, q))


def test_decode_batch_on_the_card(cuda):
    gens = list(fixtures.GENERATORS.values())
    datas = [encoder.encode(gens[i % len(gens)](), q)
             for i, q in enumerate((20, 20, 4, 19))]
    got = tdd.decode_batch_device(datas, device=cuda)
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decoder.decode(d))


# ---------------------------------------------------------------------------
# the encode slice: K4, K5, K6


def _analysis_planes(kind, rng, b, n):
    if kind in ANALYSIS_EDGE_INPUTS:
        return ANALYSIS_EDGE_INPUTS[kind](rng, b, n)
    lo, hi = (-32768, 32768) if kind == "random" else (-1800, 1800)
    return rng.integers(lo, hi, (b, n, n)).astype(np.int16)


# K4 and K10 are one cluster launch each: the encode path's four shapes at
# batch 1, 3 and 16, full-range, +-1800 and edge inputs
ANALYSIS_KINDS = ["random", "1800", *ANALYSIS_EDGE_INPUTS]


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ANALYSIS_KINDS)
def test_analysis_level_jp_kernel(cuda, kind, b):
    rng = np.random.default_rng(80 + b)
    for bb, n in analysis_path_shapes(b):
        x = torch.from_numpy(_analysis_planes(kind, rng, bb, n)).to(cuda)
        before = build.LAUNCHES["analysis_level_jp"]
        got = dwt.analysis_level_jp(x)
        assert build.LAUNCHES["analysis_level_jp"] == before + 1
        for g, w in zip(got, dwt.analysis_level_jp_ref(x)):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        if n > 128:
            view = x[:, : n // 2, : n // 2]
            for g, w in zip(dwt.analysis_level_jp(view),
                            dwt.analysis_level_jp_ref(view)):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_analysis_level_jp_through_corner_views(cuda):
    # K5's call: from its 256-stride scratch into the 512-stride LL
    # corners of jpeg and process
    rng = np.random.default_rng(90)
    x = torch.from_numpy(_analysis_planes("random", rng, 16, 256)).to(cuda)
    jpeg = torch.full((16, 512, 512), 7, dtype=torch.int16, device=cuda)
    process = torch.full_like(jpeg, -7)
    build.check("nhw_analysis_level_jp", build.load().nhw_analysis_level_jp(
        x.data_ptr(), 256 * 256, 256, jpeg.data_ptr(), 512 * 512, 512,
        process.data_ptr(), 512 * 512, 512, 16, 256,
        torch.cuda.current_stream(cuda).cuda_stream))
    want_j, want_p = dwt.analysis_level_jp_ref(x)
    torch.testing.assert_close(jpeg[:, :256, :256], want_j, rtol=0, atol=0)
    torch.testing.assert_close(process[:, :256, :256], want_p, rtol=0, atol=0)
    assert (jpeg[:, 256:] == 7).all() and (jpeg[:, :, 256:] == 7).all()
    assert (process[:, 256:] == -7).all() and (process[:, :, 256:] == -7).all()


def test_analysis_misaligned_view_raises(cuda):
    # a base 8 bytes past a 16-byte boundary; a row stride of 260
    views = (torch.zeros((2, 256, 264), dtype=torch.int16,
                         device=cuda)[..., 4:260],
             torch.zeros((2, 256, 260), dtype=torch.int16,
                         device=cuda)[..., :256])
    for view in views:
        with pytest.raises(RuntimeError, match="misaligned"):
            dwt.analysis_level_jp(view)
        with pytest.raises(RuntimeError, match="misaligned"):
            dwt.analysis_level(view)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["real q20 states", "chain planes",
                                  "row-crossing reads"])
def test_requant_tail_kernel(cuda, kind, b):
    from chip_smoke import (chain_planes, encode_images, requant_states,
                            row_crossing_planes)

    rng = np.random.default_rng(7 + b)
    arrays = {"real q20 states": lambda: requant_states(
                  encode_images(np.random.default_rng(2026))[:b], 20),
              "chain planes": lambda: chain_planes(rng, b),
              "row-crossing reads": lambda: row_crossing_planes(rng, b)}[kind]()
    args = [torch.from_numpy(a).to(cuda) for a in arrays]
    want = dwt.requant_tail_ref(*(a.clone() for a in args))
    before = build.LAUNCHES["requant_tail"]
    got = dwt.requant_tail(*args)
    assert build.LAUNCHES["requant_tail"] == before + 1
    assert got[0] is args[0] and got[1] is args[1]
    for g, w in zip(got, want):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_colorspace_down420_kernel(cuda):
    rgb = torch.from_numpy(np.random.default_rng(2).integers(
        0, 256, (3, 512, 512, 3), dtype=np.uint8)).to(cuda)
    before = build.LAUNCHES["colorspace_down420"]
    got = colorspace.rgb_to_yuv420(rgb, 20)
    assert build.LAUNCHES["colorspace_down420"] == before + 1
    for g, w in zip(got, colorspace.rgb_to_yuv420_ref(rgb, 20)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    for g, w in zip(colorspace.rgb_to_yuv_full(rgb),
                    colorspace.rgb_to_yuv(rgb, 20)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def _k6_images(what, b):
    rng = np.random.default_rng(2026)
    if what == "fixtures":
        gens = list({**fixtures.GENERATORS,
                     **fixtures.EXTREME_GENERATORS}.values())
        return np.stack([gens[i % len(gens)]() for i in range(b)])
    if what == "random":
        return rng.integers(0, 256, (b, 512, 512, 3), dtype=np.uint8)
    return np.stack([np.full((512, 512, 3), 255 * (i % 2), np.uint8)
                     for i in range(b)])


# K6 is one launch of the band kernel: batch 1, 3 and 16 on the fixtures,
# random images and flat 0 / 255 images
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("what", ["fixtures", "random", "flat 0/255"])
def test_colorspace_down420_band_kernel(cuda, what, b):
    rgb = torch.from_numpy(_k6_images(what, b)).to(cuda)
    before = build.LAUNCHES["colorspace_down420"]
    got = colorspace.rgb_to_yuv420(rgb, 20)
    assert build.LAUNCHES["colorspace_down420"] == before + 1
    for g, w in zip(got, colorspace.rgb_to_yuv420_ref(rgb, 20)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_colorspace_down420_is_one_launch(cuda):
    from chip_smoke import launches_per_call

    rgb = torch.zeros((4, 512, 512, 3), dtype=torch.uint8, device=cuda)
    host, records, names = launches_per_call(
        lambda: colorspace.rgb_to_yuv420(rgb, 20))
    assert host == 1 and 0 < records <= 1 and len(set(names)) == 1
    assert "colorspace_band" in names[0]


def test_colorspace_down420_misaligned_input_raises(cuda):
    # a contiguous image one byte past a 16-byte boundary
    flat = torch.zeros(2 * 512 * 512 * 3 + 1, dtype=torch.uint8, device=cuda)
    rgb = flat[1:].view(2, 512, 512, 3)
    assert rgb.is_contiguous() and rgb.storage_offset() == 1
    with pytest.raises(RuntimeError, match="misaligned"):
        colorspace.rgb_to_yuv420(rgb, 20)


# K6's per-pixel function, which the band kernel calls, over all 2^24 RGB
# triples against the host encoder at the qualities K6 serves (q >= NORM)
@pytest.mark.parametrize("q", [20, 23])
def test_rgb_to_yuv_full_exhaustive(cuda, q):
    from nhwcodec_tpu.ops import colorspace as hcs

    allv = torch.arange(1 << 24, dtype=torch.int64, device=cuda)
    rgb = torch.stack([allv >> 16, (allv >> 8) & 255, allv & 255],
                      -1).to(torch.uint8).reshape(64, 512, 512, 3)
    got = [g.cpu().numpy() for g in colorspace.rgb_to_yuv_full(rgb)]
    rgb_h = rgb.cpu().numpy()
    for c in range(0, 64, 8):
        for g, w in zip(got, hcs.rgb_to_yuv(rgb_h[c:c + 8], q)):
            np.testing.assert_array_equal(g[c:c + 8], w)


def test_encode_batch_on_the_card(cuda):
    import nhwcodec_tpu
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    imgs = np.stack([g() for g in fixtures.GENERATORS.values()])
    build.reset_launches()
    got, m = tdp.encode_batch_device(imgs, 20, workers=1, device=cuda)
    assert m.failures == 0
    assert got == [nhwcodec_tpu.encode(im, 20) for im in imgs]
    assert all(build.LAUNCHES[k] > 0 for k in
               ("analysis_level_jp", "requant_tail", "colorspace_down420"))


# ---------------------------------------------------------------------------
# the HQ decode and the sequential fallback: K7, K8, K9 and the mark scan


@pytest.mark.parametrize("n", [256, 512])
def test_synth_unnorm_rows_t_kernel(cuda, n):
    x = torch.from_numpy(_planes(np.random.default_rng(n + 1), 3, n, -2000,
                                 2000)).to(cuda)
    before = build.LAUNCHES["synth_unnorm_rows_t"]
    got = dwt.synth_unnorm_rows_t(x)
    assert build.LAUNCHES["synth_unnorm_rows_t"] == before + 1
    assert got.is_contiguous()
    torch.testing.assert_close(got, dwt.unnorm_rows_t_ref(x), rtol=0, atol=0)
    view = x[:, : n // 2, : n // 2]
    torch.testing.assert_close(dwt.synth_unnorm_rows_t(view),
                               dwt.unnorm_rows_t_ref(view), rtol=0, atol=0)


# K7 is one launch of 64 x 32 tiles: its path shapes ((16,512,512) on the
# HQ decode, (8,512,512) and (16,256,256) in the transform) and (B,128,128)
# corner views, at batch 1, 3, 8 and 16, on int16 extremes and values at
# every tile edge
UNNORM_CASES = [(512, 512), (256, 256), (128, 256)]


@pytest.mark.parametrize("b", [1, 3, 8, 16])
@pytest.mark.parametrize("kind", ["int16 extremes", "tile edges"])
@pytest.mark.parametrize("n, side", UNNORM_CASES)
def test_synth_unnorm_rows_t_tile_kernel(cuda, n, side, kind, b):
    from chip_smoke import UNNORM_EDGE_INPUTS

    rng = np.random.default_rng(70 + b)
    parent = torch.from_numpy(rng.integers(-32768, 32768, (b, side, side))
                              .astype(np.int16)).to(cuda)
    parent[:, :n, :n] = torch.from_numpy(UNNORM_EDGE_INPUTS[kind](rng, b, n))
    view = parent[:, :n, :n]
    before = build.LAUNCHES["synth_unnorm_rows_t"]
    got = dwt.synth_unnorm_rows_t(view)
    assert build.LAUNCHES["synth_unnorm_rows_t"] == before + 1
    assert got.is_contiguous()
    torch.testing.assert_close(got, dwt.unnorm_rows_t_ref(view), rtol=0,
                               atol=0)


@pytest.mark.parametrize("n, side", UNNORM_CASES)
def test_synth_unnorm_rows_t_is_one_launch(cuda, n, side):
    from chip_smoke import launches_per_call

    x = torch.zeros((4, side, side), dtype=torch.int16, device=cuda)
    host, records, names = launches_per_call(
        lambda: dwt.synth_unnorm_rows_t(x[:, :n, :n]))
    assert host == 1 and 0 < records <= 1 and len(set(names)) == 1
    assert "unnorm_rows_t_tile" in names[0]


def test_synth_unnorm_rows_t_misaligned_view_raises(cuda):
    # a base 8 bytes past a 16-byte boundary; a row stride of 260
    views = (torch.zeros((2, 256, 264), dtype=torch.int16,
                         device=cuda)[..., 4:260],
             torch.zeros((2, 256, 260), dtype=torch.int16,
                         device=cuda)[..., :256])
    for view in views:
        with pytest.raises(RuntimeError, match="misaligned"):
            dwt.synth_unnorm_rows_t(view)


def test_synth_norm_rows_clip_waves_kernel(cuda):
    from chip_smoke import mark_lists

    rng = np.random.default_rng(8)
    jp = torch.from_numpy(_planes(rng, 2, 512, -2, 3)).to(cuda)
    t = dwt.unnorm_rows_t_ref(jp).contiguous()
    dp_np, n_waves, ok = tdd.mark_depth_planes(mark_lists(rng, 2))
    assert ok and n_waves >= 6
    dp = torch.from_numpy(dp_np).to(cuda)
    for w in (0, 1, n_waves):
        before = build.LAUNCHES["synth_norm_rows_clip_waves"]
        got = dwt.synth_norm_rows_clip_waves(t, dp, w)
        assert build.LAUNCHES["synth_norm_rows_clip_waves"] == before + 1
        torch.testing.assert_close(
            got, dwt.synth_norm_rows_clip_waves_ref(t, dp, w), rtol=0, atol=0)


# K8 is one launch of 32-row bands: batch 1, 3 and 16 on marks at every
# band edge and both column ends, a row of 384 marks, depths past n_waves,
# one wave, no marks and the decode's marks (chip_smoke.WAVES_EDGE_INPUTS)
@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", sorted(WAVES_EDGE_INPUTS))
def test_synth_norm_rows_clip_waves_band_kernel(cuda, kind, b):
    t_np, dp_np, n_waves = WAVES_EDGE_INPUTS[kind](
        np.random.default_rng(80 + b), b)
    t, dp = (torch.from_numpy(a).to(cuda) for a in (t_np, dp_np))
    before = build.LAUNCHES["synth_norm_rows_clip_waves"]
    got = dwt.synth_norm_rows_clip_waves(t, dp, n_waves)
    assert build.LAUNCHES["synth_norm_rows_clip_waves"] == before + 1
    want = dwt.synth_norm_rows_clip_waves_ref(t, dp, n_waves)
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    # the waves change image 0 wherever it is marked, at every batch
    fired = (want[0] != dwt.synth_norm_rows_clip_ref(t[:1])[0]).any()
    assert bool(fired) == (kind != "unmarked")


def test_synth_norm_rows_clip_waves_is_one_launch(cuda):
    from chip_smoke import launches_per_call

    t_np, dp_np, n_waves = WAVES_EDGE_INPUTS["band edges"](
        np.random.default_rng(83), 16)
    t, dp = (torch.from_numpy(a).to(cuda) for a in (t_np, dp_np))
    host, records, names = launches_per_call(
        lambda: dwt.synth_norm_rows_clip_waves(t, dp, n_waves))
    assert host == 1 and 0 < records <= 1 and len(set(names)) == 1
    assert "waves_band" in names[0]


def _offset_view(dtype, shape, offset, cuda):
    """A contiguous view of ``shape`` at element ``offset`` of a buffer."""
    n = int(np.prod(shape))
    return torch.zeros(n + 16, dtype=dtype, device=cuda)[
        offset:offset + n].view(shape)


def test_synth_norm_rows_clip_waves_misaligned_view_raises(cuda):
    shape = (2, 512, 512)
    t = torch.zeros(shape, dtype=torch.int16, device=cuda)
    dp = torch.zeros(shape, dtype=torch.uint8, device=cuda)
    for args in ((_offset_view(torch.int16, shape, 1, cuda), dp),
                 (t, _offset_view(torch.uint8, shape, 2, cuda))):
        with pytest.raises(RuntimeError, match="misaligned"):
            dwt.synth_norm_rows_clip_waves(*args, 1)


def test_y_stage2_full_misaligned_depth_raises(cuda):
    # K2 reads the depth rows with 16-byte loads: a base 2 bytes past a
    # 16-byte boundary is refused
    shape = (2, 512, 512)
    jp = torch.zeros(shape, dtype=torch.int16, device=cuda)
    with pytest.raises(RuntimeError, match="misaligned"):
        dwt.y_stage2_full(jp, _offset_view(torch.uint8, shape, 2, cuda), 1)


def test_hq_scatter_int16_on_the_card(cuda):
    # test_hq_scatter_duplicates_wrap's inputs: duplicates accumulate and
    # the sums cross +-32768; the in-place int16 scatter_add_ equals the
    # int32 scatter wrapped once, and the host's int16 np.add.at
    from nhwcodec_tpu_torch.ops.lifting import wrap16

    n = 512
    rng = np.random.default_rng(13)
    b = 2
    u = rng.integers(-3000, 3000, (b, n, n)).astype(np.int16)
    u[0, 3, 7] = 32700
    u[1, 400, 2] = -32700
    idx = np.zeros((b, 16), np.int32)
    dl = np.zeros((b, 16), np.int16)
    idx[0, :6] = [3 * n + 7] * 4 + [n * n - 1, 5]
    dl[0, :6] = [56, 32, -32, 56, 30000, 30000]
    idx[1, :5] = [400 * n + 2] * 3 + [n * n - 1] * 2
    dl[1, :5] = [-56, -56, 32, -32000, -32000]
    host = u.copy()
    for i in range(b):
        np.add.at(host[i].reshape(-1), idx[i], dl[i])
    t = torch.from_numpy(u.transpose(0, 2, 1).copy()).to(cuda)
    idx_d, dl_d = torch.from_numpy(idx).to(cuda), torch.from_numpy(dl).to(cuda)
    idx_t = ((idx_d & (n - 1)) << 9) | (idx_d >> 9)
    flat = t.reshape(b, n * n).to(torch.int32)
    flat.scatter_add_(1, idx_t.to(torch.int64), dl_d.to(torch.int32))
    want = wrap16(flat).to(torch.int16).view(b, n, n)
    got = tdd.hq_scatter_t(t, idx_d, dl_d)
    assert got is t   # in place
    torch.testing.assert_close(got, want, rtol=0, atol=0)
    np.testing.assert_array_equal(got.cpu().numpy(), host.transpose(0, 2, 1))


@pytest.mark.parametrize("n", [256, 512])
def test_synth_norm_rows_clip_kernel(cuda, n):
    x = torch.from_numpy(_planes(np.random.default_rng(n + 2), 3, n, -20000,
                                 20000)).to(cuda)
    before = build.LAUNCHES["synth_norm_rows_clip"]
    got = dwt.synth_norm_rows_clip(x)
    assert build.LAUNCHES["synth_norm_rows_clip"] == before + 1
    torch.testing.assert_close(got, dwt.synth_norm_rows_clip_ref(x), rtol=0,
                               atol=0)


def test_smooth_marks_seq_kernel(cuda):
    from chip_smoke import out_of_order_marks

    rng = np.random.default_rng(10)
    x = torch.from_numpy(_planes(rng, 3, 512, -12, 13)).to(cuda)
    recs, valid = (torch.from_numpy(a).to(cuda) for a in
                   tdd.pad_marks(out_of_order_marks(rng, 3)))
    want = dwt.smooth_marks_seq_ref(x.clone(), recs, valid)
    assert (want != x).any()
    before = build.LAUNCHES["smooth_marks_seq"]
    got = dwt.smooth_marks_seq(x.clone(), recs, valid)
    assert build.LAUNCHES["smooth_marks_seq"] == before + 1
    torch.testing.assert_close(got, want, rtol=0, atol=0)


def _hq_streams():
    gens = list(fixtures.GENERATORS.values())
    return [encoder.encode(gens[i % len(gens)](), q)
            for i, q in enumerate((23, 23, 22, 20))]


def test_hq_decode_on_the_card(cuda):
    datas = _hq_streams()
    build.reset_launches()
    got = tdd.decode_batch_device(datas, device=cuda)
    assert build.LAUNCHES["synth_unnorm_rows_t"] == 1
    assert build.LAUNCHES["synth_norm_rows_clip_waves"] == 1
    assert build.LAUNCHES["y_stage2_full"] == 0
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decoder.decode(d))


def test_fallback_decode_on_the_card(cuda, monkeypatch):
    datas = _hq_streams()
    monkeypatch.setattr(tdd, "mark_depth_planes",
                        lambda marks: (None, 0, False))
    build.reset_launches()
    got = tdd.decode_batch_device(datas, device=cuda)
    assert build.LAUNCHES["smooth_marks_seq"] == 1
    assert build.LAUNCHES["synth_norm_rows_clip"] == 1
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decoder.decode(d))


# ---------------------------------------------------------------------------
# the transform path: K10, and K1/K7/K9 in decode_transform


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ANALYSIS_KINDS)
def test_analysis_level_kernel(cuda, kind, b):
    rng = np.random.default_rng(90 + b)
    for bb, n in analysis_path_shapes(b):
        x = torch.from_numpy(_analysis_planes(kind, rng, bb, n)).to(cuda)
        before = build.LAUNCHES["analysis_level"]
        got = dwt.analysis_level(x)
        assert build.LAUNCHES["analysis_level"] == before + 1
        torch.testing.assert_close(got, dwt.analysis_level_ref(x), rtol=0,
                                   atol=0)
        # in place on the LL corner of the level-1 plane
        h = n // 2
        if h >= 128:
            want = got.clone()
            want[:, :h, :h] = dwt.analysis_level_ref(got[:, :h, :h])
            corner = got[:, :h, :h]
            assert dwt.analysis_level(corner, out=corner) is corner
            torch.testing.assert_close(got, want, rtol=0, atol=0)


def test_transform_step_on_the_card(cuda):
    from nhwcodec_tpu_torch import entry as tentry
    from nhwcodec_tpu_torch.models import transform as ttr

    fn, (rgb,) = tentry.entry(cuda)
    rgb = rgb[:2]
    want = ttr.encode_transform(rgb.cpu())
    build.reset_launches()
    coeffs = fn(rgb)
    assert build.LAUNCHES["analysis_level"] == 4
    for g, w in zip(coeffs, want):
        torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    build.reset_launches()
    out = tentry.transform_step(rgb)
    assert build.LAUNCHES["analysis_level"] == 4
    assert all(build.LAUNCHES[k] == 2 for k in
               ("synth_level", "synth_unnorm_rows_t", "synth_norm_rows_clip"))
    torch.testing.assert_close(out.cpu(), ttr.decode_transform(*want),
                               rtol=0, atol=0)


# ---------------------------------------------------------------------------
# the device entropy decode: E1 chain_starts and E2 y_runs_fixpoint


@pytest.fixture(scope="module")
def q20_chunk():
    """The q20 chunk of chip_smoke.py's entropy phases, parsed: the 11
    fixtures and 5 random images of seed 2026."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    from chip_smoke import SEED, encode_images
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.host.utils.container import parse_nhw

    return [parse_nhw(host_encoder.encode(img, 20))
            for img in encode_images(np.random.default_rng(SEED))]


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["Y", "UV", "random"])
def test_chain_starts_kernel(cuda, q20_chunk, kind, b):
    from chip_smoke import chain_cases
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    label = {"Y": f"Y words, batch {b}", "UV": f"UV words, batch {b}",
             "random": f"random words, batch {b}, both zones"}[kind]
    args = chain_cases(cuda, q20_chunk)[label]
    before = build.LAUNCHES["chain_starts"]
    got = edd.chain_starts_batch(*args)
    assert build.LAUNCHES["chain_starts"] == before + 1
    for g, w in zip(got, edd.chain_starts_ref(*args)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("k", [64, 1])
def test_y_runs_fixpoint_kernel(cuda, q20_chunk, k, b):
    """E2 equals its twin on the chunk's per-run tuples; at k = 1 (one
    thread walks every run) on each stream's first 2048 runs."""
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    streams = q20_chunk[-b:]   # the random images' streams come last
    syms, book, r_max = edd._y_run_inputs(streams, edd.Y_P1, cuda)
    k = min(k, r_max)
    xs, _ = edd._runs_xs_batch(syms, book, edd.Y_P1, r_max, k)
    if k == 1:
        xs = [a[:2048].contiguous() for a in xs]
    before = build.LAUNCHES["y_runs_fixpoint"]
    got = edd.runs_fixpoint(*xs, edd.Y_P1, k)
    assert build.LAUNCHES["y_runs_fixpoint"] == before + 1
    for g, w in zip(got, edd.runs_fixpoint_ref(*xs, edd.Y_P1, k)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_entropy_kernels_reject_bad_inputs(cuda):
    from nhwcodec_tpu_torch.ops import entropy_decode_device as edd

    words = torch.zeros((2, 64), dtype=torch.int32, device=cuda)
    nbits = torch.full((2,), 64 * 32, dtype=torch.int32, device=cuda)
    zone = torch.zeros(2, dtype=torch.int32, device=cuda)
    with pytest.raises(TypeError):
        edd.chain_starts_batch(words.to(torch.int64), nbits, zone, 128)
    with pytest.raises(ValueError):
        edd.chain_starts_batch(words[:, ::2], nbits, zone, 128)
    ebase = torch.zeros((8, 128), dtype=torch.int32, device=cuda)
    fields = torch.zeros_like(ebase)
    with pytest.raises(TypeError):
        edd.runs_fixpoint(ebase.float(), fields, edd.Y_P1, 64)
    with pytest.raises(ValueError):
        edd.runs_fixpoint(ebase.t(), fields.t(), edd.Y_P1, 64)
    with pytest.raises(ValueError):
        edd.runs_fixpoint(ebase, fields, edd.Y_P1, 3)


def test_entropy_on_device_decode_on_the_card(cuda):
    datas = _hq_streams()
    build.reset_launches()
    got = tdd.decode_batch_device(datas, device=cuda, entropy_on_device=True)
    assert build.LAUNCHES["chain_starts"] == 2
    assert build.LAUNCHES["y_runs_fixpoint"] >= 1
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decoder.decode(d))
    build.reset_launches()
    tdd.decode_batch_device(datas, device=cuda)
    assert build.LAUNCHES["chain_starts"] == 0
    assert build.LAUNCHES["y_runs_fixpoint"] == 0


# the device encode scans' stream stage: S1 snap_pass, S2 offset_y and S3
# merge_crossing (csrc/scans.cu) on chip_smoke.py's edge inputs


def _scan_inputs(what, b):
    import chip_smoke as cs

    rng = np.random.default_rng(70 + b)
    return {"chain": cs.snap_chain_planes, "spill": cs.snap_spill_planes,
            "edge": cs.offset_y_edge_planes,
            "random": lambda r, n: r.integers(-400, 401, (n, 512, 512))
            .astype(np.int16),
            "streams": cs.stream_edge_streams}[what](rng, b)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["chain", "spill"])
def test_snap_pass_kernel(cuda, kind, b):
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    x = torch.from_numpy(_scan_inputs(kind, b)).to(cuda)
    for a in des.snap_args(20) + des.snap_args(17)[1:2]:
        before = build.LAUNCHES["snap_pass"]
        got = ds.snap_pass_device(x, *a)
        assert build.LAUNCHES["snap_pass"] == before + 1
        torch.testing.assert_close(got, ds.snap_pass_ref(x, *a), rtol=0,
                                   atol=0)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["edge", "random"])
def test_offset_y_kernel(cuda, kind, b):
    from nhwcodec_tpu_torch.models import device_scans as ds

    x = torch.from_numpy(_scan_inputs(kind, b)).to(cuda)
    before = build.LAUNCHES["offset_y"]
    got = ds.offset_y_device(x, 8)
    assert build.LAUNCHES["offset_y"] == before + 1
    torch.testing.assert_close(got, ds.offset_y_ref(x, 8), rtol=0, atol=0)
    if kind == "edge":   # row 255's vertical fires reach row 256
        assert bool((got[:, 256, 1:256:4] == 128).all())


@pytest.mark.parametrize("b", [1, 3, 16])
def test_merge_crossing_kernel(cuda, b):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_scans as ds

    s = _scan_inputs("streams", b)
    x = torch.from_numpy(s).to(cuda)
    before = build.LAUNCHES["merge_crossing"]
    got = ds.merge_crossing_device(x)
    assert build.LAUNCHES["merge_crossing"] == before + 1
    torch.testing.assert_close(got, ds.merge_crossing_ref(x), rtol=0, atol=0)
    sel, sel1, sel2 = ds.select_codes_device(got)
    want, w1, w2 = cs.host_stream_fixups(s)
    np.testing.assert_array_equal(ds.cap_long_runs_device(sel).cpu().numpy(),
                                  want)
    assert sel1.tolist() == w1.tolist() and sel2.tolist() == w2.tolist()


@pytest.mark.parametrize("q", [20, 17])
def test_stream_stage_on_the_card(cuda, q):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder

    # the capture wraps the port's host copy, so its encoder runs here
    with cs.StreamCapture() as cap:
        for img in (fixtures.texture_noise(), fixtures.gradient_circles()):
            host_encoder.encode(img, q)
    st = cs.stack_records(cap.records)
    y, u, v = (torch.from_numpy(st[k]).to(cuda) for k in "yuv")
    build.reset_launches()
    stream, sel1, sel2 = cs.device_stream_stage(y, u, v, q)
    torch.cuda.synchronize()
    assert {k: build.LAUNCHES[k] for k in cs.SCAN_KERNELS} == cs.SCAN_LAUNCHES
    cs.stream_check(f"q{q}", stream, sel1, sel2, st)


def test_scan_kernels_reject_bad_inputs(cuda):
    from nhwcodec_tpu_torch.models import device_scans as ds

    plane = torch.zeros((2, 512, 512), dtype=torch.int16, device=cuda)
    with pytest.raises(TypeError):
        ds.offset_y_device(plane.to(torch.int32))
    with pytest.raises(ValueError):
        ds.snap_pass_device(plane.transpose(1, 2), 1, 255, 257, 511, 6, 9, 9,
                            False, True, 510)
    with pytest.raises(ValueError):
        ds.merge_crossing_device(torch.zeros((2, 1000), dtype=torch.uint8,
                                             device=cuda))


# the device encode scans' residue stage: S4 pair_promotion, S5
# column_ladder and S6 classify (csrc/residue.cu) on chip_smoke.py's edge
# inputs


@pytest.mark.parametrize("b", [1, 3, 16])
def test_pair_promotion_kernel(cuda, b):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_scans as ds

    x = torch.from_numpy(cs.pp_adversarial_planes(
        np.random.default_rng(80 + b), b)).to(cuda)
    before = build.LAUNCHES["pair_promotion"]
    got = ds.pair_promotion_device(x)
    assert build.LAUNCHES["pair_promotion"] == before + 1
    torch.testing.assert_close(got, ds.pair_promotion_ref(x), rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("q", [17, 18, 20, 21, "column 255"])
def test_column_ladder_and_classify_kernels(cuda, q, b):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.models import device_scans as ds

    if q == "column 255":
        q, (p, rfe) = 20, cs.col255_edge_inputs(b)
    else:
        p, rfe = cs.delta_inputs(np.random.default_rng(90 + q + b), b)[:2]
    p, rfe = torch.from_numpy(p).to(cuda), torch.from_numpy(rfe).to(cuda)
    rs = host_encoder._res_setting(q)
    before = dict(build.LAUNCHES)
    lp, lrf = ds.column_ladder_device(p, rfe, q, rs)
    for g, w in zip((lp, lrf), ds.column_ladder_ref(p, rfe, q, rs)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)
    lrf = lrf.reshape(b, 256, 256)
    got = ds.classify_device(lp, lrf, q, rs)
    assert build.LAUNCHES["column_ladder"] == before["column_ladder"] + 1
    assert build.LAUNCHES["classify"] == before["classify"] + 1
    for g, w in zip(got, ds.classify_ref(lp, lrf, q, rs)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("q", [20, 18])
def test_residue_stage_on_the_card(cuda, q):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    with cs.StreamCapture() as cap:
        for img in (fixtures.texture_noise(), fixtures.gradient_circles()):
            host_encoder.encode(img, q)
    st = cs.stack_records(cap.records)
    build.reset_launches()
    P, streams = des._y_residue_stage(*cs.residue_inputs(st, cuda), q)
    secs = des._residue_sections(streams)
    assert {k: build.LAUNCHES[k] for k in cs.RESIDUE_KERNELS} == \
        cs.RESIDUE_LAUNCHES
    np.testing.assert_array_equal(P.cpu().numpy(), st["y"])
    assert not cs.sections_equal(secs, st["res"])
    u, v = (torch.from_numpy(st[k]).to(cuda) for k in "uv")
    stream, sel1, sel2 = cs.device_stream_stage(P, u, v, q)
    cs.stream_check(f"q{q}", stream, sel1, sel2, st)


def test_residue_kernels_reject_bad_inputs(cuda):
    from nhwcodec_tpu_torch.models import device_scans as ds

    plane = torch.zeros((2, 512, 512), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        ds.pair_promotion_device(plane.transpose(1, 2))
    with pytest.raises(ValueError):
        ds.column_ladder_device(plane, torch.zeros(
            (2, 65536 + 1024), dtype=torch.int16), 20, 3)
    with pytest.raises(ValueError):
        ds.classify_device(plane, torch.zeros(
            (2, 256, 256), dtype=torch.int16, device=cuda).transpose(1, 2),
            20, 3)


# the device encode scans' LL2 stage: S7 ll2_code_y and S8 walk_visited
# (csrc/ll2.cu) on chip_smoke.py's edge inputs


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("gt_low3", [True, False])
@pytest.mark.parametrize("kind", ["runs and marks", "all even", "dense odd"])
def test_ll2_code_y_kernel(cuda, kind, gt_low3, b):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_scans as ds

    x = torch.from_numpy(cs.ll2_edge_planes(
        np.random.default_rng(100 + b), b, kind)).to(cuda)
    before = build.LAUNCHES["ll2_code_y"]
    got = ds.ll2_code_y_scan(x, gt_low3)
    assert build.LAUNCHES["ll2_code_y"] == before + 1
    for g, w in zip(got, ds.ll2_code_y_ref(x, gt_low3)):
        torch.testing.assert_close(g, w, rtol=0, atol=0)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("kind", ["jumps of 65", "jumps 255/256",
                                  "long jumps", "parks", "squeeze",
                                  "squeeze at LOW5"])
def test_walk_visited_kernel(cuda, kind, b):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_scans as ds

    rng = np.random.default_rng(110 + b)
    if kind.startswith("squeeze"):
        nxt = cs.squeeze_edge_rows(rng, b, kind == "squeeze")
    else:
        nxt = cs.walk_edge_rows(rng, b, kind)
    x = torch.from_numpy(nxt).to(cuda)
    before = build.LAUNCHES["walk_visited"]
    got = ds.walk_visited_device(x, 1)
    assert build.LAUNCHES["walk_visited"] == before + 1
    torch.testing.assert_close(got, ds.walk_visited_ref(x, 1), rtol=0,
                               atol=0)


@pytest.mark.parametrize("q", [20, 16])
def test_ll2_stage_on_the_card(cuda, q):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.models import device_encode_scans as des

    with cs.StreamCapture() as cap:
        for img in (fixtures.texture_noise(), fixtures.gradient_circles()):
            host_encoder.encode(img, q)
    st = cs.stack_ll2(cap.records, q)
    build.reset_launches()
    Pz, Uz, Vz, y, uv = cs.device_ll2_stage(cs.ll2_inputs(st, cuda), q)
    secs, mems = cs.ll2_sections(y, uv)
    assert {k: build.LAUNCHES[k] for k in cs.LL2_KERNELS} == \
        cs.LL2_LAUNCHES
    for got, key in ((Pz, "Pz"), (Uz, "uz"), (Vz, "vz")):
        np.testing.assert_array_equal(got.cpu().numpy(), st[key])
    assert not cs.ll2_sections_equal(secs, st["secs"])
    for g, w in zip(mems, st["hr_mem"]):
        np.testing.assert_array_equal(g, w)


def test_ll2_kernels_reject_bad_inputs(cuda):
    from nhwcodec_tpu_torch.models import device_scans as ds

    plane = torch.zeros((2, 512, 512), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        ds.ll2_code_y_scan(plane.transpose(1, 2), True)
    with pytest.raises(ValueError):
        ds.walk_visited_device(torch.zeros((2, 1 << 17), dtype=torch.int32,
                                           device=cuda))
    with pytest.raises(ValueError):
        ds.walk_visited_device(torch.zeros((2, 64), dtype=torch.int32,
                                           device=cuda)[:, ::2])


# the device encode scans composed: S9 uv_sentinel (csrc/uv.cu), the compare
# ladder's torch ops and encode_batch_device(scans_on_device=True)


@pytest.mark.parametrize("b", [1, 3, 16])
@pytest.mark.parametrize("res_uv", [4, 5])
@pytest.mark.parametrize("kind", ["drift", "d0 -5", "bands taken",
                                  "pair runs"])
def test_uv_sentinel_kernel(cuda, kind, res_uv, b):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_scans as ds

    proc, rf = cs.uv_sentinel_edge_inputs(np.random.default_rng(120 + b), b,
                                          kind)
    P, R = torch.from_numpy(proc).to(cuda), torch.from_numpy(rf).to(cuda)
    before = build.LAUNCHES["uv_sentinel"]
    got = ds.uv_sentinel_marking_device(P, R, res_uv)
    assert build.LAUNCHES["uv_sentinel"] == before + 1
    torch.testing.assert_close(got, ds.uv_sentinel_marking_ref(P, R, res_uv),
                               rtol=0, atol=0)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  cs.host_uv_sentinel(proc, rf, res_uv))


@pytest.mark.parametrize("strict", [False, True])
def test_uv_compare_ladder_on_the_card(cuda, strict):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_scans as ds

    args = cs.uv_ladder_edge_inputs(np.random.default_rng(130), 16)
    got = ds.uv_compare_ladder_device(
        *(torch.from_numpy(a).to(cuda) for a in args), strict)
    want = ds.uv_compare_ladder_device(
        *(torch.from_numpy(a) for a in args), strict)
    torch.testing.assert_close(got.cpu(), want, rtol=0, atol=0)


@pytest.mark.parametrize("q", [20, 18, 17])
def test_scans_on_device_on_the_card(cuda, q):
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    images = np.stack([fixtures.texture_noise(), fixtures.gradient_circles()])
    build.reset_launches()
    got, _ = tdp.encode_batch_device(images, q, device=cuda,
                                     scans_on_device=True)
    want = cs.scans_device_launches(q)
    assert {k: build.LAUNCHES[k] for k in want} == want
    assert got == [host_encoder.encode(img, q) for img in images]


def test_uv_sentinel_rejects_bad_inputs(cuda):
    from nhwcodec_tpu_torch.models import device_scans as ds

    p = torch.zeros((2, 256, 256), dtype=torch.int16, device=cuda)
    rf = torch.zeros((2, ds.UV_RF_EXT), dtype=torch.int16, device=cuda)
    with pytest.raises(ValueError):
        ds.uv_sentinel_marking_device(p, rf[:, : ds.UV_RF_MIN - 1], 4)
    with pytest.raises(ValueError):
        ds.uv_sentinel_marking_device(p.transpose(1, 2), rf, 4)
    with pytest.raises(ValueError):
        ds.uv_sentinel_marking_device(p, rf.cpu(), 4)
