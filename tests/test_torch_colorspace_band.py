"""The band form of K6 (``colorspace_down420``), checked on the CPU.

On the card each call is one launch of ``colorspace_band``
(csrc/colorspace.cu): a CTA owns kBandRows output chroma rows r0.. of one
image, one warp converts each of its input rows (the halo row 2 r0 - 1,
chroma only, and the 2 kBandRows rows it owns, whose Y it stores), 16
pixels a lane, takes the horizontal [1,2,1]/4 of the lane's even columns
(the previous lane's last value by a shuffle, column 0 pair-averaged)
into the band's shared rows, and after a barrier the vertical [1,2,1]/4
of 4 columns a thread (chroma row 0 pair-averages input rows 0 and 1).

Here a numpy emulation of that ownership, with the band size read from
the source, rebuilds Y, U and V from the per-pixel values equal to
``rgb_to_yuv420_ref`` and ``colorspace_down420_pallas`` in interpret mode,
tolerance 0: each Y row and each chroma output written once, the halo
recompute at most 1/8, no band row read before it is made.  The per-pixel
function swaps three conversions for exact adds (u8 -> f64 from the bits,
truncations by adding 2^52 or 2^23 rounding toward zero); over all 2^24
RGB triples the values those tricks truncate lie in the ranges where
they are exact.  The card holds the arithmetic itself to the host over
all 2^24 triples (``tests/test_torch_cuda.py``, ``chip_smoke.py``).
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nhwcodec_tpu.ops import pallas_colorspace as pcs
from nhwcodec_tpu.utils import fixtures
from nhwcodec_tpu_torch.ops import colorspace

SOURCE = (Path(colorspace.__file__).resolve().parent.parent / "csrc"
          / "colorspace.cu")
TEXT = SOURCE.read_text()
R = int(re.search(r"constexpr int kBandRows = (\d+);", TEXT).group(1))
N, H = 512, 256


def test_band_shape_follows_the_source():
    assert re.search(r"kBandIn = 2 \* kBandRows \+ 1;", TEXT)
    assert re.search(r"kBandThreads = 32 \* kBandIn;", TEXT)
    assert re.search(r"colorspace_band<<<dim3\(kH / kBandRows, batch\), "
                     r"kBandThreads", TEXT)
    # one warp an input row, 16 pixels a lane; 256 vertical tasks fit
    assert N // 32 == 16 and R * H // 4 <= 32 * (2 * R + 1)
    # the halo recompute: one row for every 2R owned
    assert 1 / (2 * R) <= 1 / 8


def _hdec(lanes):
    """Each lane's 8 horizontally decimated values from its 16 (32, 16):
    the first from the previous lane's last value (the shuffle; lane 0
    pair-averages column 0)."""
    c = lanes.astype(np.int64)
    left = np.concatenate([c[:1, 15], c[:-1, 15]])   # shfl_up by 1
    h = np.empty((32, 8), np.int64)
    h[:, 0] = (left + 2 * c[:, 0] + c[:, 1] + 2) >> 2
    h[0, 0] = (c[0, 0] + c[0, 1] + 1) >> 1
    h[:, 1:] = (c[:, 1:14:2] + 2 * c[:, 2:15:2] + c[:, 3:16:2] + 2) >> 2
    return h


def emulate(y_px, u_px, v_px):
    """K6's band ownership on one image's per-pixel Y, U, V (512, 512):
    -> (Y, U, V) as the kernel stores them."""
    Y = np.zeros((N, N), np.int16)
    out = [np.zeros((H, H), np.uint8) for _ in range(2)]
    y_count = np.zeros(N, np.int64)
    o_count = np.zeros((H, H), np.int64)
    computed = 0
    for r0 in range(0, H, R):                    # blockIdx.x
        band = [np.full((2 * R + 1, H), -1, np.int64) for _ in range(2)]
        for warp in range(2 * R + 1):
            row = 2 * r0 - 1 + warp
            if row < 0:
                continue
            computed += 1
            if warp > 0:                         # an owned row
                Y[row] = y_px[row]
                y_count[row] += 1
            for hb, px in zip(band, (u_px, v_px)):
                hb[warp] = _hdec(px[row].reshape(32, 16)).ravel()
        t = np.arange(R * H // 4)                # the vertical tasks
        i, c = t // (H // 4), (4 * (t % (H // 4)))[:, None] + np.arange(4)
        i = np.broadcast_to(i[:, None], c.shape)
        first = r0 + i == 0
        for hb, o in zip(band, out):
            up, mid, dn = (hb[2 * i + d, c] for d in range(3))
            assert (mid >= 0).all() and (dn >= 0).all()
            assert (first | (up >= 0)).all()
            o[r0 + i, c] = np.where(first, (mid + dn + 1) >> 1,
                                    (up + 2 * mid + dn + 2) >> 2)
        np.add.at(o_count, (r0 + i, c), 1)
    assert (y_count == 1).all() and (o_count == 1).all()
    assert computed - N <= N / 8
    return Y, out[0], out[1]


def _images():
    rng = np.random.default_rng(2026)
    return np.stack([fixtures.gradient_circles(),
                     rng.integers(0, 256, (N, N, 3), dtype=np.uint8),
                     np.where(rng.random((N, N, 1)) < 0.5, 0,
                              255).repeat(3, -1).astype(np.uint8)])


def test_emulated_bands_rebuild_the_twin():
    rgb = _images()
    t = torch.from_numpy(rgb)
    want = [w.numpy() for w in colorspace.rgb_to_yuv420_ref(t, 20)]
    pallas = pcs.colorspace_down420_pallas(jnp.asarray(rgb), interpret=True)
    for w, p in zip(want, pallas):
        np.testing.assert_array_equal(w, np.asarray(p))
    px = [p.numpy() for p in colorspace.rgb_to_yuv_full(t)]
    for i in range(len(rgb)):
        got = emulate(px[0][i], px[1][i], px[2][i])
        for g, w in zip(got, want):
            np.testing.assert_array_equal(g, w[i])


def test_conversion_tricks_hold_over_every_rgb_triple():
    # u8 -> f64: the double with high word 0x43300000 and low word v is
    # 2^52 + v, minus 2^52 exactly v
    v = np.arange(256, dtype=np.uint64)
    two52 = np.float64(2.0 ** 52)
    assert ((0x4330000000000000 | v).view(np.float64) == two52 + v).all()
    assert ((0x4330000000000000 | v).view(np.float64) - two52
            == v.astype(np.float64)).all()
    # the truncated values: Y's v = ys + 0.5 in [0, 2^52), so rounding
    # v + 2^52 toward zero gives 2^52 + floor(v); the chroma's float32 w
    # in [0, 2^23), so w + 2^23 toward zero gives 2^23 + floor(w)
    lo_y, hi_y, lo_w, hi_w = np.inf, -np.inf, np.inf, -np.inf
    g, b = (a.ravel().astype(np.float64) for a in np.meshgrid(
        np.arange(256), np.arange(256), indexing="ij"))
    for r8 in range(256):
        r = np.full_like(g, r8)
        ys = 0.299 * r + 0.587 * g
        ys = ys + 0.114 * b
        y = ys + 0.5
        lo_y, hi_y = min(lo_y, y.min()), max(hi_y, y.max())
        for c in (-0.1687 * r - 0.3313 * g + 0.5 * b,
                  0.5 * r - 0.4187 * g - 0.0813 * b):
            c32 = c.astype(np.float32)
            w = np.where(c32 >= 0, c32 + np.float32(128.5),
                         c32 + np.float32(128.4))
            assert w.dtype == np.float32
            lo_w, hi_w = min(lo_w, w.min()), max(hi_w, w.max())
    # the ranges the source states: [0.5, 256) and [0.8999939, 256]
    assert 0.5 <= lo_y and hi_y < 256 and hi_y < 2.0 ** 31
    assert lo_w == np.float32(128.4) - np.float32(127.5) and hi_w == 256
