"""The encoder's RGB -> YUV in float32 where the configuration states
float64 (q >= 20, the C reference's double sums): the step that a faster
colorspace kernel would tempt."""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.reference.ops import colorspace


def _clip_u8(v: np.ndarray) -> np.ndarray:
    return np.where((v >> 8) != 0, np.where(v < 0, 0, 255), v).astype(
        np.uint8)


def downsample_yuv420_f32(rgb: np.ndarray, quality: int):
    f = np.float32
    r, g, b = (rgb[..., k].astype(f) for k in range(3))
    y = np.trunc(f(0.299) * r + f(0.587) * g + f(0.114) * b + f(0.5))
    cb = f(-0.1687) * r - f(0.3313) * g + f(0.5) * b
    cr = f(0.5) * r - f(0.4187) * g - f(0.0813) * b
    u = np.trunc(np.where(cb >= 0, cb + f(128.5), cb + f(128.4)))
    v = np.trunc(np.where(cr >= 0, cr + f(128.5), cr + f(128.4)))
    return (y.astype(np.int16),
            colorspace.downsample_chroma(_clip_u8(u.astype(np.int64))),
            colorspace.downsample_chroma(_clip_u8(v.astype(np.int64))))


@contextlib.contextmanager
def patch():
    was = colorspace.downsample_yuv420
    colorspace.downsample_yuv420 = downsample_yuv420_f32
    try:
        yield
    finally:
        colorspace.downsample_yuv420 = was
