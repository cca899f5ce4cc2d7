# Frozen copy of nhwcodec_tpu_torch/host/ops/colorspace.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Encoder colorspace: RGB -> YUV + 4:2:0 chroma downsample.

Reference behavior: encoder/colorspace.c:55-260 (downsample_YUV420).
Quality-dependent paths:
- q>=20: float JPEG matrix, trunc-toward-zero with +0.5 (+128.5/+128.4f
  for chroma depending on sign)
- q=19/18: Y scaled by float32 0.975/0.93
- q=17:   Y,U,V scaled by 0.94
- q<=16:  integer BT.601-ish matrix scaled by per-quality Qtz

Then 2:1 horizontal smoothing of U/V at even columns and 2:1 vertical
averaging -> 256x256 chroma planes.  All passes are pure array programs
(the reference's in-place raster scans only ever read unmodified odd
columns / original rows).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

QTZ = {
    T.LOW4: 32375, T.LOW5: 31262, T.LOW6: 28786, T.LOW7: 27607,
    T.LOW8: 27830, T.LOW9: 27522, T.LOW10: 25570, T.LOW11: 23540,
    T.LOW12: 21540, T.LOW13: 20640, T.LOW14: 19670, T.LOW15: 18820,
    T.LOW16: 18000, T.LOW17: 17100, T.LOW18: 16500, T.LOW19: 15900,
}

_HALF_POS = np.float64(np.float32(128.5))   # == 128.5
_HALF_NEG = np.float64(np.float32(128.4))   # 128.40000152587890625


def _clip_u8_c(v: np.ndarray) -> np.ndarray:
    """The reference's (v>>8)!=0 clip pattern on ints."""
    return np.where((v >> 8) != 0, np.where(v < 0, 0, 255), v).astype(np.uint8)


def rgb_to_yuv(rgb: np.ndarray, quality: int
               ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """(512,512,3) uint8 (reference byte order) -> (Y int16 512x512,
    U uint8 512x512, V uint8 512x512) before chroma downsampling."""
    r = rgb[..., 0].astype(np.float64)
    g = rgb[..., 1].astype(np.float64)
    b = rgb[..., 2].astype(np.float64)

    if quality <= T.LOW4:
        ri = rgb[..., 0].astype(np.int64)
        gi = rgb[..., 1].astype(np.int64)
        bi = rgb[..., 2].astype(np.int64)
        qtz = QTZ[quality]
        y = (((66 * ri + 129 * gi + 25 * bi) * qtz + 4194304) >> 23) + 16
        u = (((-38 * ri - 74 * gi + 112 * bi) * qtz + 4194304) >> 23) + 128
        v = (((112 * ri - 94 * gi - 18 * bi) * qtz + 4194304) >> 23) + 128
        return (y.astype(np.int16), _clip_u8_c(u), _clip_u8_c(v))

    ysum = 0.299 * r + 0.587 * g + 0.114 * b
    cb = -0.1687 * r - 0.3313 * g + 0.5 * b
    cr = 0.5 * r - 0.4187 * g - 0.0813 * b

    if quality >= T.NORM:
        y = np.trunc(ysum + 0.5)
    elif quality in (T.LOW1, T.LOW2):
        yq = np.float64(np.float32(0.975 if quality == T.LOW1 else 0.93))
        y = np.trunc(ysum * yq + 0.5)
    else:  # LOW3
        y = np.trunc(ysum * 0.94 + 0.5)
        cb = cb * 0.94
        cr = cr * 0.94

    # the reference stores the chroma sum into a float variable
    # (encoder/colorspace.c:60 "float color_balance"), so the double sum
    # rounds to float32 first and the +-half add happens in float32
    cb32 = cb.astype(np.float32)
    cr32 = cr.astype(np.float32)
    half_p = np.float32(128.5)
    half_n = np.float32(128.4)
    u = np.trunc(np.where(cb32 >= 0, cb32 + half_p, cb32 + half_n)
                 ).astype(np.int64)
    v = np.trunc(np.where(cr32 >= 0, cr32 + half_p, cr32 + half_n)
                 ).astype(np.int64)
    return (y.astype(np.int16), _clip_u8_c(u), _clip_u8_c(v))


def downsample_chroma(c: np.ndarray) -> np.ndarray:
    """4:2:0 downsample of one (512,512) uint8 chroma plane -> (256,256)
    uint8 (encoder/colorspace.c:220-256): horizontal [1,2,1]/4 smoothing at
    even columns (first column pair-averaged), then vertical [1,2,1]/4 at
    even rows (first row pair-averaged)."""
    c = c.astype(np.int32)
    h = np.empty((512, 256), np.int32)
    h[:, 0] = (c[:, 0] + c[:, 1] + 1) >> 1
    even = c[:, 2:511:2]
    h[:, 1:] = (c[:, 1:510:2] + 2 * even + c[:, 3:512:2] + 2) >> 2

    out = np.empty((256, 256), np.int32)
    out[0] = (h[0] + h[1] + 1) >> 1
    out[1:] = (h[1:510:2] + 2 * h[2:511:2] + h[3:512:2] + 2) >> 2
    return out.astype(np.uint8)


def downsample_yuv420(rgb: np.ndarray, quality: int
                      ) -> tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Full encoder colorspace stage: (512,512,3) uint8 ->
    (Y (512,512) int16, U (256,256) uint8, V (256,256) uint8)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        if quality <= T.LOW4:
            mode, yq, qtz = 3, 0.0, QTZ[quality]
        elif quality >= T.NORM:
            mode, yq, qtz = 0, 0.0, 0
        elif quality in (T.LOW1, T.LOW2):
            mode = 1
            yq = float(np.float32(0.975 if quality == T.LOW1 else 0.93))
            qtz = 0
        else:  # LOW3
            mode, yq, qtz = 2, 0.0, 0
        rgb_c = np.ascontiguousarray(rgb, np.uint8)
        y = np.empty((512, 512), np.int16)
        u = np.empty((256, 256), np.uint8)
        v = np.empty((256, 256), np.uint8)
        lib.nhw_downsample_yuv420(
            ffi.cast("const uint8_t *", rgb_c.ctypes.data), mode, yq, qtz,
            ffi.cast("int16_t *", y.ctypes.data),
            ffi.cast("uint8_t *", u.ctypes.data),
            ffi.cast("uint8_t *", v.ctypes.data))
        return y, u, v

    y, u, v = rgb_to_yuv(rgb, quality)
    return y, downsample_chroma(u), downsample_chroma(v)
