"""The benchmark's seeded 512x512 images.

Frozen copies, at commit a4a43cf, of the content families of
``nhwcodec_tpu_torch/host/utils/fixtures.py`` (``gradient_circles``,
``texture_noise``, ``sharp_blocks``, ``near_flat``, ``photo_waves``) and of
``nhwcodec_tpu_torch/tools/fuzz_wave.py`` (``_blur`` and the blocks, octave
noise and blurred noise kinds of ``make_image``), with the constants that
the originals fix or draw turned into a level and a seeded draw.  Pure
uniform noise, which no photo pipeline sends, is left out.

A pool holds every family at every level once (``FAMILIES`` x ``LEVELS``
images), in an order drawn from the seed, so every seed asks the codec
for the same mix of content and only the draws within each image differ.
Imports neither torch nor the program.
"""

from __future__ import annotations

import numpy as np

N = 512
LEVELS = 4


def _grid() -> tuple[np.ndarray, np.ndarray]:
    y, x = np.mgrid[0:N, 0:N].astype(np.float64)
    return y, x


def _u8(img: np.ndarray) -> np.ndarray:
    return np.clip(img, 0, 255).astype(np.uint8)


def _blur(img: np.ndarray, k: int) -> np.ndarray:
    out = img.astype(np.float32)
    for axis in (0, 1):
        acc = np.zeros_like(out)
        for d in range(-k, k + 1):
            acc += np.roll(out, d, axis=axis)
        out = acc / (2 * k + 1)
    return out


def gradient_circles(rng: np.random.Generator, level: int) -> np.ndarray:
    """Smooth gradients with a soft circle; the level shortens the
    waves."""
    y, x = _grid()
    fx, fy = (37.0, 53.0) if level == 0 else (37.0 / (level + 1),
                                              53.0 / (level + 1))
    r = (x / 2 + y / 4 + rng.uniform(0, 256)) % 256
    g = 128 + 90 * np.sin(x / fx + rng.uniform(0, 6.3)) * np.cos(y / fy)
    cy, cx = rng.uniform(64, 448, 2)
    d = np.sqrt((x - cx) ** 2 + (y - cy) ** 2)
    b = 255 * np.exp(-d / 150.0)
    return _u8(np.stack([r, g, b], axis=-1))


def texture_noise(rng: np.random.Generator, level: int) -> np.ndarray:
    """Band-limited texture plus Gaussian noise of 6-24 levels."""
    y, x = _grid()
    ph = rng.uniform(0, 6.3, 2)
    base = (110 + 60 * np.sin(x / 11.0 + ph[0] + np.sin(y / 23.0) * 2.0)
            + 40 * np.cos(y / 7.0 + ph[1]))
    img = base[..., None] + rng.normal(0, 6 * (level + 1), (N, N, 3))
    img[..., 1] += 25 * np.sin(x / 91.0)
    img[..., 2] -= 25 * np.cos(y / 71.0)
    return _u8(img)


def sharp_blocks(rng: np.random.Generator, level: int) -> np.ndarray:
    """Hard edges, flat blocks and thin lines; 20-80 blocks."""
    img = np.full((N, N, 3), 200.0)
    for _ in range(20 * (level + 1)):
        y0, x0 = rng.integers(0, N - 64, 2)
        h, w = rng.integers(16, 128, 2)
        img[y0:y0 + h, x0:x0 + w] = rng.integers(0, 256, 3)
    for _ in range(10 * (level + 1)):
        img[int(rng.integers(0, N)), :, :] = rng.integers(0, 256)
    for _ in range(10 * (level + 1)):
        img[:, int(rng.integers(0, N)), :] = rng.integers(0, 256)
    return _u8(img)


def near_flat(rng: np.random.Generator, level: int) -> np.ndarray:
    """Nearly flat with faint noise (0.8-3.2 levels) and two bands."""
    img = np.full((N, N, 3), float(rng.integers(40, 216)))
    img += rng.normal(0, 0.8 * (level + 1), (N, N, 3))
    r0, c0 = rng.integers(0, N - 40, 2)
    img[r0:r0 + 40, :, 0] += 3
    img[:, c0:c0 + 10, 2] -= 4
    return _u8(img)


def photo_waves(rng: np.random.Generator, level: int) -> np.ndarray:
    """Photo-like smooth waves plus sensor noise of 4-16 levels, grey."""
    y, x = _grid()
    p = (128 + 80 * np.sin(x / 17.0 + rng.uniform(0, 6.3))
         * np.cos(y / 23.0) + rng.normal(0, 4 * (level + 1), (N, N)))
    return np.ascontiguousarray(np.repeat(_u8(p)[..., None], 3, axis=-1))


def blocks(rng: np.random.Generator, level: int) -> np.ndarray:
    """Random flat blocks of 8-64 pixels (fuzz kind 1)."""
    bs = (8, 16, 32, 64)[level]
    base = rng.integers(0, 256, (N // bs, N // bs, 3))
    return _u8(np.kron(base, np.ones((bs, bs, 1), np.int64)))


def octave_noise(rng: np.random.Generator, level: int) -> np.ndarray:
    """Noise summed over four octaves (fuzz kind 4), amplitude 20-50."""
    img = np.zeros((N, N, 3))
    for oct_ in (8, 32, 128, 512):
        coarse = rng.normal(0, 1, (oct_, oct_, 3))
        img += np.kron(coarse, np.ones((N // oct_, N // oct_, 1))
                       ) * (oct_ ** 0.5)
    return _u8(128 + 10 * (level + 2) * img / np.abs(img).max())


def blurred_noise(rng: np.random.Generator, level: int) -> np.ndarray:
    """Photo-like blurred noise (fuzz kind 7), box radius 2-7."""
    return _u8(_blur(rng.integers(0, 256, (N, N, 3)), (2, 3, 5, 7)[level]))


FAMILIES = (gradient_circles, texture_noise, sharp_blocks, near_flat,
            photo_waves, blocks, octave_noise, blurred_noise)
POOL = len(FAMILIES) * LEVELS


def make_pool(seed: int) -> np.ndarray:
    """The (POOL, 512, 512, 3) uint8 images of ``seed``: each family at
    each level once, in a seeded order."""
    rng = np.random.default_rng(seed)
    jobs = [(f, lv) for f in FAMILIES for lv in range(LEVELS)]
    order = rng.permutation(len(jobs))
    out = np.empty((len(jobs), N, N, 3), np.uint8)
    for k, j in enumerate(order):
        fam, lv = jobs[j]
        out[k] = fam(np.random.default_rng([seed, int(j)]), lv)
    return out
