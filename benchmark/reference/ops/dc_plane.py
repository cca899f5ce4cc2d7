# Frozen copy of nhwcodec_tpu_torch/host/ops/dc_plane.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""LL2 DC-plane reconstruction from the ``res_ch`` RLE stream.

Reference behavior: decoder/nhw_decoder.c:1665-2026.  The stream encodes the
Y 128x128 LL2 plane (3 selectable RLE modes, keyed on ``RES_HIGH & 3``) and
the U/V 64x64 LL2 planes, all as byte-deltas against the running previous
value, plus optional dense-escape bytes (``highres_comp``) and U/V LSB
bit-planes.  Output layout matches the C ``res_comp`` buffer:

    [0:16384)      Y LL2 (row-major 128x128)
    [16384:20480)  U LL2 (64x64)
    [20480:24576)  V LL2 (64x64)

This is an inherently serial byte automaton with data-dependent advancement;
it runs on host (it is ~KBs of work per image).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

_Y_LL2 = T.IM_SIZE >> 2          # 16384
_UV_LL2 = T.IM_SIZE >> 4         # 4096


def decode_dc_planes(
    res_ch: np.ndarray,
    highres_comp: np.ndarray,
    res_U_64: np.ndarray,
    res_V_64: np.ndarray,
    quality: int,
    res_high: int,
) -> np.ndarray:
    """Return the reconstructed res_comp[24577] uint8 buffer."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        ch = np.ascontiguousarray(res_ch, np.uint8)
        hrc = np.ascontiguousarray(highres_comp, np.uint8)
        off = np.ascontiguousarray(T.UV_SMALL_DC_OFFSET.reshape(-1),
                                   np.int32)
        # +64 slack: a corrupt stream can legally reach the loop bound
        # with a multi-write code and overshoot by a few bytes; valid
        # streams never write past 96*IM_DIM+1 (the returned view)
        rc = np.zeros(96 * T.IM_DIM + 1 + 64, np.uint8)
        err = lib.nhw_decode_dc_planes(
            ffi.cast("const uint8_t *", ch.ctypes.data),
            ffi.cast("const uint8_t *", hrc.ctypes.data),
            ffi.cast("const int32_t *", off.ctypes.data),
            1 if quality > T.LOW5 else 0, res_high & 3,
            ffi.cast("uint8_t *", rc.ctypes.data), ch.size, hrc.size)
        if err != 0:
            raise ValueError("corrupt or truncated res_ch stream")
        if quality > T.LOW5:
            u_bits = np.unpackbits(res_U_64)[: _UV_LL2]
            v_bits = np.unpackbits(res_V_64)[: _UV_LL2]
            rc[_Y_LL2:_Y_LL2 + _UV_LL2] += u_bits << 1
            start_v = _Y_LL2 + _UV_LL2
            rc[start_v:start_v + _UV_LL2] += v_bits << 1
        return rc[: 96 * T.IM_DIM + 1]

    ch_list = res_ch.tolist()
    hr = highres_comp.tolist()
    rc = [0] * (96 * T.IM_DIM + 1)
    rc[0] = ch_list[0]
    use_hr = quality > T.LOW5
    mode = res_high & 3

    i = 1
    a = 0
    j = 1
    if mode == 0:
        while j < _Y_LL2:
            c = ch_list[i]
            if c >= 128:
                if use_hr:
                    rc[j] = hr[a]
                    j += 1
                    a += 1
                rc[j] = ((c - 128) << 1) & 255
                j += 1
            elif c < 16:
                run = (c >> 3) & 1
                v = rc[j - 1]
                for _ in range(run + 2):
                    rc[j] = v
                    j += 1
                low = c & 7
                if low == 1:
                    rc[j] = (rc[j - 1] + 2) & 255
                    j += 1
                elif low == 2:
                    rc[j] = (rc[j - 1] + 2) & 255
                    j += 1
                    rc[j] = (rc[j - 1] - 2) & 255
                    j += 1
                elif low == 3:
                    rc[j] = (rc[j - 1] + 2) & 255
                    j += 1
                    rc[j] = rc[j - 1]
                    j += 1
                elif low == 4:
                    rc[j] = (rc[j - 1] - 2) & 255
                    j += 1
                    rc[j] = (rc[j - 1] + 2) & 255
                    j += 1
                elif low == 5:
                    rc[j] = (rc[j - 1] - 2) & 255
                    j += 1
                    rc[j] = rc[j - 1]
                    j += 1
                elif low == 6:
                    rc[j] = (rc[j - 1] - 2) & 255
                    j += 1
                elif low == 7:
                    rc[j] = (rc[j - 1] + 4) & 255
                    j += 1
            elif c < 32:
                step = 4 if c >= 24 else 2
                rc[j] = (rc[j - 1] + step) & 255
                j += 1
                rc[j] = (((c & 7) << 1) - 8 + rc[j - 1]) & 255
                j += 1
            elif c < 64:
                c -= 32
                rc[j] = (((c >> 3) << 1) - 6 + rc[j - 1]) & 255
                j += 1
                rc[j] = (((c & 7) << 1) - 8 + rc[j - 1]) & 255
                j += 1
            else:
                i = _decode_3byte(ch_list, i, rc, j)
                j += 3
            i += 1
    elif mode == 1:
        while j < _Y_LL2:
            c = ch_list[i]
            if c >= 128:
                if use_hr:
                    rc[j] = hr[a]
                    j += 1
                    a += 1
                rc[j] = ((c - 128) << 1) & 255
                j += 1
            elif c < 32:
                run = (c >> 2) & 7
                v = rc[j - 1]
                for _ in range(run + 2):
                    rc[j] = v
                    j += 1
                low = c & 3
                if low == 1:
                    rc[j] = (rc[j - 1] + 2) & 255
                    j += 1
                elif low == 2:
                    rc[j] = (rc[j - 1] - 2) & 255
                    j += 1
                elif low == 3:
                    rc[j] = rc[j - 1]
                    j += 1
            elif c < 64:
                c -= 32
                rc[j] = (((c >> 3) << 1) - 4 + rc[j - 1]) & 255
                j += 1
                rc[j] = (((c & 7) << 1) - 8 + rc[j - 1]) & 255
                j += 1
            else:
                i = _decode_3byte(ch_list, i, rc, j)
                j += 3
            i += 1
    else:  # mode == 2
        while j < _Y_LL2:
            c = ch_list[i]
            if c >= 128:
                if use_hr:
                    rc[j] = hr[a]
                    j += 1
                    a += 1
                rc[j] = ((c - 128) << 1) & 255
                j += 1
            elif c < 64:
                run = c & 63
                v = rc[j - 1]
                for _ in range(run + 2):
                    rc[j] = v
                    j += 1
            else:
                i = _decode_3byte(ch_list, i, rc, j)
                j += 3
            i += 1

    rc[_Y_LL2] = ch_list[i]
    i += 1

    # U and V 64x64 planes, one shared pass (decoder/nhw_decoder.c:1882-1979)
    off = T.UV_SMALL_DC_OFFSET
    j = _Y_LL2 + 1
    end = _Y_LL2 + (T.IM_SIZE >> 3)
    while j < end:
        c = ch_list[i]
        if c >= 192:
            c -= 192
            k = c >> 2
            rc[j] = (int(off[k][0]) + rc[j - 1]) & 255
            j += 1
            rc[j] = (int(off[k][1]) + rc[j - 1]) & 255
            j += 1
            low = c & 3
            if low == 0:
                rc[j] = rc[j - 1]
            elif low == 1:
                rc[j] = (rc[j - 1] + 4) & 255
            elif low == 2:
                rc[j] = (rc[j - 1] - 4) & 255
            else:
                rc[j] = (rc[j - 1] + 8) & 255
            j += 1
        elif c >= 128:
            rc[j] = ((c - 128) << 2) & 255
            j += 1
        elif c >= 64:
            run = (c >> 3) & 7
            v = rc[j - 1]
            if run == 7:
                run = (c & 7) + 7
                for _ in range(run + 2):
                    rc[j] = v
                    j += 1
            else:
                for _ in range(run + 2):
                    rc[j] = v
                    j += 1
                low = c & 7
                if low == 1:
                    rc[j] = (rc[j - 1] + 4) & 255
                    j += 1
                elif low == 2:
                    rc[j] = (rc[j - 1] + 4) & 255
                    j += 1
                    rc[j] = (rc[j - 1] - 4) & 255
                    j += 1
                elif low == 3:
                    rc[j] = (rc[j - 1] + 4) & 255
                    j += 1
                    rc[j] = (rc[j - 1] - 4) & 255
                    j += 1
                    rc[j] = rc[j - 1]
                    j += 1
                elif low == 4:
                    rc[j] = (rc[j - 1] - 4) & 255
                    j += 1
                    rc[j] = (rc[j - 1] + 4) & 255
                    j += 1
                    rc[j] = rc[j - 1]
                    j += 1
                elif low == 5:
                    rc[j] = (rc[j - 1] - 4) & 255
                    j += 1
                    rc[j] = (rc[j - 1] + 4) & 255
                    j += 1
                elif low == 6:
                    rc[j] = (rc[j - 1] - 4) & 255
                    j += 1
                elif low == 7:
                    rc[j] = (rc[j - 1] + 8) & 255
                    j += 1
        else:
            rc[j] = (((c >> 3) << 2) - 16 + rc[j - 1]) & 255
            j += 1
            rc[j] = (((c & 7) << 2) - 16 + rc[j - 1]) & 255
            j += 1
        i += 1

    out = np.array(rc, dtype=np.int64)

    if quality > T.LOW5:
        # re-add U/V LSB bit-planes (decoder/nhw_decoder.c:1983-2026)
        u_bits = np.unpackbits(res_U_64)[: _UV_LL2]
        v_bits = np.unpackbits(res_V_64)[: _UV_LL2]
        out[_Y_LL2:_Y_LL2 + _UV_LL2] += u_bits.astype(np.int64) << 1
        start_v = _Y_LL2 + _UV_LL2
        out[start_v:start_v + _UV_LL2] += v_bits.astype(np.int64) << 1
        out &= 255

    return out.astype(np.uint8)


def _decode_3byte(ch: list, i: int, rc: list, j: int) -> int:
    """Shared 3-value escape: two stream bytes -> three deltas
    (decoder/nhw_decoder.c:1753-1773)."""
    c = ch[i] - 64
    rc[j] = ((((c >> 1) & 31) << 1) - 32 + rc[j - 1]) & 255
    t = (c & 1) << 3
    i += 1
    t |= ch[i] >> 5
    rc[j + 1] = ((t << 1) - 16 + rc[j]) & 255
    rc[j + 2] = (((ch[i] & 31) << 1) - 32 + rc[j + 1]) & 255
    return i
