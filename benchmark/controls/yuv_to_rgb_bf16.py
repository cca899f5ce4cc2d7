"""The decoder's YUV -> RGB in bfloat16 where the configuration states
float64 (q >= 20, the C reference's double sums): the step that a faster
colour conversion on the card would tempt.

float32, the precision just below, differs from float64 on 36 of the
2^24 (Y, U, V) triples (the G channel), and on none that the pool's
images reach, so it could not fail the check; bfloat16 is the next
below.  numpy has no bfloat16: each value and each operation's result
is rounded to it (round to nearest even on the float32's top 16 bits)."""

from __future__ import annotations

import contextlib

import numpy as np

from benchmark.reference.models import decoder


def bf16(x) -> np.ndarray:
    u = np.asarray(x, np.float32).view(np.uint32)
    u = (u + np.uint32(0x7FFF) + ((u >> 16) & 1)) & np.uint32(0xFFFF0000)
    return u.view(np.float32)


def yuv_to_rgb_bf16(y, u, v, quality):
    uf = bf16(bf16(u.astype(np.float32)) - 128)
    vf = bf16(bf16(v.astype(np.float32)) - 128)
    yq = bf16(y.astype(np.float32))

    def mul(c, x):
        return bf16(bf16(np.float32(c)) * x)

    r = bf16(bf16(yq + mul(1.402, vf)) + 0.5)
    g = bf16(bf16(bf16(yq - mul(0.34414, uf)) - mul(0.71414, vf)) + 0.5)
    b = bf16(bf16(yq + mul(1.772, uf)) + 0.5)
    rgb = np.trunc(np.stack([r, g, b], axis=-1)).astype(np.int64)
    return np.where((rgb >> 8) != 0, np.where(rgb < 0, 0, 255),
                    rgb).astype(np.uint8)


@contextlib.contextmanager
def patch():
    was = decoder.yuv_to_rgb
    decoder.yuv_to_rgb = yuv_to_rgb_bf16
    try:
        yield
    finally:
        decoder.yuv_to_rgb = was
