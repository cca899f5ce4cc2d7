# Frozen copy of nhwcodec_tpu_torch/host/ops/geometry.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Serpentine interleave geometry.

The encoder stores Y coefficients in 4-pixel vertical boustrophedon strips
and U/V interleaved even/odd in 8-pixel strips
(encoder/nhw_encoder.c:2111-2132, 2542-2570).  On decode these are fixed
permutations (decoder/nhw_decoder.c:71-91, 904-932), precomputed once here
as gather index maps — a single vectorized take on either host or device.
"""

from __future__ import annotations

import functools

import numpy as np

from benchmark.reference import tables as T

N = 2 * T.IM_DIM  # 512


@functools.cache
def y_deserpentine_map() -> np.ndarray:
    """perm[plane_linear_index] = symbol_stream_index (Y, 512x512)."""
    perm = np.empty(N * N, dtype=np.int64)
    k = np.arange(8)
    cols_in_k = np.where(k < 4, k, 7 - k)
    rows_in_k = np.where(k < 4, 0, 1)
    for strip in range(N // 4):
        base_col = strip * 4
        for i in range(N // 2):
            s = strip * (8 * (N // 2)) + i * 8
            rows = 2 * i + rows_in_k
            cols = base_col + cols_in_k
            perm[rows * N + cols] = s + k
    return perm


@functools.cache
def uv_deserpentine_map() -> np.ndarray:
    """perm[plane_linear_index] = symbol_pair_index (U/V, 256x256).

    The shared UV stream interleaves U at even and V at odd offsets; the
    returned map indexes symbol *pairs*: stream index = 2*perm + (0 for U,
    1 for V).
    """
    D = T.IM_DIM
    perm = np.empty(D * D, dtype=np.int64)
    k = np.arange(16)
    cols_in_k = np.where(k < 8, k, 15 - k)
    rows_in_k = np.where(k < 8, 0, 1)
    for strip in range(D // 8):
        base_col = strip * 8
        for i in range(D // 2):
            s = strip * (16 * (D // 2)) + i * 16
            rows = 2 * i + rows_in_k
            cols = base_col + cols_in_k
            perm[rows * D + cols] = s + k
    return perm


def deserpentine_y(symbols: np.ndarray, xp=np) -> np.ndarray:
    """(262144,) symbol stream -> (512, 512) coefficient plane."""
    return xp.take(symbols, y_deserpentine_map(), axis=-1).reshape(
        symbols.shape[:-1] + (N, N)
    )


def deserpentine_uv(symbols: np.ndarray, component: int, xp=np) -> np.ndarray:
    """(131072,) shared UV stream -> (256, 256) plane.

    component 0 = U (even offsets), 1 = V (odd offsets).
    """
    D = T.IM_DIM
    idx = 2 * uv_deserpentine_map() + component
    return xp.take(symbols, idx, axis=-1).reshape(symbols.shape[:-1] + (D, D))
