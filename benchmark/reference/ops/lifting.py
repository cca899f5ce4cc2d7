# Frozen copy of nhwcodec_tpu_torch/host/ops/lifting.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Integer 5/3-style lifting synthesis filters, vectorized over rows.

Reference behavior: decoder/filters.c:143-194 (upfilter53I / upfilter53III /
upfilter53VI) composed by decoder/wavelet_filterbank.c:52-235.  The reference
walks one row at a time with scalar loops; here every filter is a pure
elementwise/slice expression over an (..., M) low band and (..., M) high
band, so a whole plane (and a whole batch, via ``vmap``) synthesizes in one
fused VPU pass on TPU.

int16 semantics: the C code stores every intermediate into ``short``.  All
arithmetic here runs in int32 and is wrapped to int16 exactly at the points
where the C stores, via ``wrap16``.

Works with either numpy or jax.numpy as the array namespace (pass ``xp``).
"""

from __future__ import annotations

import numpy as np


def wrap16(x, xp=np):
    """Truncate int32 to int16 with two's-complement wraparound."""
    return ((x + 32768) & 65535) - 32768


def _synth_native(L, H, fn_name: str):
    """Dispatch one synthesis row pass to the native runtime.  L, H:
    (..., M) numpy int arrays; returns (..., 2M) int32 like the pure
    path."""
    from benchmark.reference import native

    lib = native._load()
    ffi = native.ffi()
    Lc = np.ascontiguousarray(L, np.int16)
    Hc = np.ascontiguousarray(H, np.int16)
    M = Lc.shape[-1]
    rows = Lc.size // M
    out = np.empty(Lc.shape[:-1] + (2 * M,), np.int32)
    getattr(lib, fn_name)(
        ffi.cast("const int16_t *", Lc.ctypes.data),
        ffi.cast("const int16_t *", Hc.ctypes.data), rows, M,
        ffi.cast("int32_t *", out.ctypes.data))
    return out


def synth_unnorm(L, H, xp=np):
    """upfilter53I + upfilter53III: one un-normalized (x8) synthesis row pass.

    L, H: (..., M) int arrays (the low/high halves of each row).
    Returns (..., 2M) int32 array of wrapped-int16 values.
    """
    if xp is np:
        from benchmark.reference import native

        if native.available():
            return _synth_native(L, H, "nhw_synth_unnorm")

    L = L.astype(xp.int32)
    H = H.astype(xp.int32)
    M = L.shape[-1]

    # upfilter53I (decoder/filters.c:143-154)
    even = xp.concatenate([L[..., : M - 1] << 3, L[..., M - 1:] << 3], axis=-1)
    odd = xp.concatenate(
        [(L[..., 1:] + L[..., : M - 1]) << 2, L[..., M - 1:] << 3], axis=-1
    )
    even = wrap16(even, xp)
    odd = wrap16(odd, xp)

    # upfilter53III lifting adds (decoder/filters.c:156-169)
    sub_even = xp.concatenate(
        [H[..., :1] << 2, (H[..., 1:] + H[..., : M - 1]) << 1], axis=-1
    )
    add_odd = xp.concatenate(
        [
            5 * H[..., :1] - H[..., 1:2],
            6 * H[..., 1 : M - 1] - H[..., 2:] - H[..., : M - 2],
            5 * H[..., M - 1 :] - H[..., M - 2 : M - 1],
        ],
        axis=-1,
    )
    even = wrap16(even - sub_even, xp)
    odd = wrap16(odd + add_odd, xp)

    out = xp.stack([even, odd], axis=-1)
    return out.reshape(out.shape[:-2] + (2 * M,))


def synth_norm(L, H, xp=np):
    """upfilter53I + upfilter53VI: final synthesis row pass with /64
    normalization (+32 rounding of positives only, decoder/filters.c:171-194).
    """
    if xp is np:
        from benchmark.reference import native

        if native.available():
            return _synth_native(L, H, "nhw_synth_norm")

    L = L.astype(xp.int32)
    H = H.astype(xp.int32)
    M = L.shape[-1]

    even = xp.concatenate([L[..., : M - 1] << 3, L[..., M - 1:] << 3], axis=-1)
    odd = xp.concatenate(
        [(L[..., 1:] + L[..., : M - 1]) << 2, L[..., M - 1:] << 3], axis=-1
    )
    even = wrap16(even, xp)
    odd = wrap16(odd, xp)

    sub_even = xp.concatenate(
        [H[..., :1] << 2, (H[..., 1:] + H[..., : M - 1]) << 1], axis=-1
    )
    add_odd = xp.concatenate(
        [
            5 * H[..., :1] - H[..., 1:2],
            6 * H[..., 1 : M - 1] - H[..., 2:] - H[..., : M - 2],
            5 * H[..., M - 1 :] - H[..., M - 2 : M - 1],
        ],
        axis=-1,
    )
    even = wrap16(even - sub_even, xp)
    odd = wrap16(odd + add_odd, xp)

    even = wrap16(xp.where(even > 0, even + 32, even), xp) >> 6
    odd = wrap16(xp.where(odd > 0, odd + 32, odd), xp) >> 6

    out = xp.stack([even, odd], axis=-1)
    return out.reshape(out.shape[:-2] + (2 * M,))
