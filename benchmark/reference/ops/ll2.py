# Frozen copy of nhwcodec_tpu_torch/host/ops/ll2.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""LL2 DC-plane byte-coding and run/delta compression (encoder side).

Reference behavior: the LL2 coding loop of encode_image
(encoder/nhw_encoder.c:636-743), Y_highres_compression
(encoder/compress_pixel.c:471-876) and highres_compression
(encoder/compress_pixel.c:878-1022).

These are irregular byte-stream builders with data-dependent scan
advancement; they run as host-side sequential passes over the 16K-entry
DC plane (the decoder inverts them in utils/dc_plane.py -> ops/dc_plane).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

D = 256
N = 512
SZ = 65536


def ll2_code_y(process: np.ndarray, quality: int):
    """LL2 coefficient plane -> byte codes + escapes + parity run stream
    (encoder/nhw_encoder.c:636-743).  Mutates ``process`` (zeroes the LL2
    block, odd-pattern propagation nudges).

    Returns (tree1[16384] uint8, ch_res[16384] uint8, exw list[int],
    res4 list[int]).
    """
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        tree1 = np.zeros(16384, np.uint8)
        ch_res = np.zeros(16384, np.uint8)
        exw_a = np.empty(3 * 16384, np.int32)
        res4_a = np.empty(16384 + 256, np.int32)
        n_exw = ffi.new("long *")
        n_res4 = ffi.new("long *")
        lib.nhw_ll2_code_y(
            ffi.cast("int16_t *", process.ctypes.data),
            ffi.cast("uint8_t *", tree1.ctypes.data),
            ffi.cast("uint8_t *", ch_res.ctypes.data),
            ffi.cast("int32_t *", exw_a.ctypes.data), n_exw,
            ffi.cast("int32_t *", res4_a.ctypes.data), n_res4,
            1 if quality > T.LOW3 else 0)
        return (tree1, ch_res, exw_a[: n_exw[0]].tolist(),
                res4_a[: n_res4[0]].tolist())

    pf = process.reshape(-1)
    tree1 = np.zeros(16384, np.uint8)
    ch_res = np.zeros(16384, np.uint8)
    exw: list[int] = []
    res4: list[int] = []

    # greedy 4-run odd marking (638-657); parity unchanged by the even
    # sentinels so later windows see original parities
    if quality > T.LOW3:
        for r in range(128):
            base = r * N
            j = 0
            while j < 125:
                a = base + j
                if (pf[a] & 1) and (pf[a + 1] & 1) and (pf[a + 2] & 1) \
                        and (pf[a + 3] & 1) \
                        and abs(int(pf[a]) - int(pf[a + 3])) > 1:
                    pf[a] += 24000
                    pf[a + 1] += 16000
                    pf[a + 2] += 16000
                    pf[a + 3] += 16000
                    j += 4
                else:
                    j += 1

    a_out = 0
    for r in range(128):
        base = r * N
        i_flat = r * N
        stage = 0
        for j in range(128):
            cnt = base + j
            scan = int(pf[cnt])

            if quality > T.LOW3 and scan > 10000:
                if scan > 20000:
                    scan -= 24000
                    res4.append(j + 1)
                    stage += 1
                else:
                    scan -= 16000
            elif (scan & 1) and cnt > i_flat and (pf[cnt + 1] & 1):
                if j < 126 and (pf[cnt + 2] & 1):
                    if abs(scan - int(pf[cnt + 2])) > 1 and quality > T.LOW3:
                        pf[cnt + 1] += 1
                elif i_flat < (SZ - N - 2) and (pf[cnt + N] & 1) \
                        and (pf[cnt + N + 1] & 1) and not (pf[cnt + N + 2] & 1):
                    if pf[cnt + N] < 10000 and quality > T.LOW3:
                        pf[cnt + N] += 1
            elif (scan & 1) and i_flat >= N and i_flat < (SZ - 3 * N):
                if (pf[cnt + N] & 1) and (pf[cnt + N + 1] & 1):
                    if (pf[cnt + 2 * N] & 1) and not (pf[cnt + 3 * N] & 1):
                        if pf[cnt + N] < 10000 and quality > T.LOW3:
                            pf[cnt + N] += 1

            if scan > 255 and (j > 0 or i_flat > 0):
                exw += [r, j + 128, min(scan - 255, 255)]
                tree1[a_out] = tree1[a_out - 1]
                ch_res[a_out] = tree1[a_out - 1]
                a_out += 1
                pf[cnt] = 0
            elif scan < 0 and (j > 0 or i_flat > 0):
                exw += [r, j, -max(scan, -255)]
                tree1[a_out] = tree1[a_out - 1]
                ch_res[a_out] = tree1[a_out - 1]
                a_out += 1
                pf[cnt] = 0
            else:
                scan = 255 if scan > 255 else (0 if scan < 0 else scan)
                ch_res[a_out] = scan
                tree1[a_out] = scan & 254
                a_out += 1
                pf[cnt] = 0

        if quality > T.LOW3:
            if not stage:
                res4.append(128)
            else:
                res4[-1] += 128

    return tree1, ch_res, exw, res4


def _escape(ch_comp: list, highres: np.ndarray, ch_res: np.ndarray,
            hr_word: list, hr_mem: list, i: int, quality: int) -> int:
    """The 128-escape emission shared by all three modes
    (encoder/compress_pixel.c:563-578 etc.).  Returns the new i."""
    if quality > T.LOW5:
        ch_comp.append(128)
        ch_comp.append(128 + (int(highres[i]) >> 1))
        ch_comp.append(128 + (int(highres[i + 1]) >> 1))
        hr_word.append(int(ch_res[i]))
        hr_mem.append(i)
        return i + 1
    ch_comp.append(128)
    ch_comp.append(128 + (int(highres[i]) >> 1))
    return i


def y_highres_compression(tree1: np.ndarray, ch_res: np.ndarray,
                          quality: int, tail: np.ndarray | None = None):
    """Pick the RLE mode and pack the Y LL2 byte plane
    (encoder/compress_pixel.c:471-876).

    ``tail``: the bytes the reference reads past tree1[16384] — its 24577-
    byte tree1 chunk is carved from the freed nhw_kernel buffer, so the
    tail aliases kernel data (kernel[139280:], see models.encoder).

    Returns (ch_comp list[int], res_low, highres_word list[int],
    highres_mem list[int]).
    """
    pad = np.zeros(8193 + 64, np.int32)
    if tail is not None:
        n = min(len(tail), len(pad))
        pad[:n] = tail[:n]
    h = np.concatenate([tree1.astype(np.int32), pad])

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        cr = np.ascontiguousarray(ch_res, np.uint8)
        out = np.empty(3 * 16384 + 8, np.int32)
        hw = np.empty(16384, np.int32)
        hm = np.empty(16384, np.int32)
        n_out = ffi.new("long *")
        res_low_out = ffi.new("int *")
        n_hw = ffi.new("long *")
        n_hm = ffi.new("long *")
        lib.nhw_y_highres_compression(
            ffi.cast("const int32_t *", h.ctypes.data), h.size,
            ffi.cast("const uint8_t *", cr.ctypes.data),
            1 if quality > T.LOW5 else 0,
            ffi.cast("int32_t *", out.ctypes.data), n_out, res_low_out,
            ffi.cast("int32_t *", hw.ctypes.data), n_hw,
            ffi.cast("int32_t *", hm.ctypes.data), n_hm)
        return (out[: n_out[0]].tolist(), res_low_out[0],
                hw[: n_hw[0]].tolist(), hm[: n_hm[0]].tolist())

    # mode-select run statistics (482-497)
    e = 0
    Y = 0
    a = 0
    i = 1
    cap = len(h) - 1
    while i < 16384:
        while i < cap and h[i] == h[i - 1]:
            e += 1
            if e < 16:
                if e == 8:
                    a += 1
                i += 1
            elif e == 16:
                Y += 1
                break
        e = 0
        i += 1
    a += Y

    ch: list[int] = []
    hr_word: list[int] = []
    hr_mem: list[int] = []
    ch.append(int(h[0]))

    if Y > 299:
        res_low = 2
    elif a > 179:
        res_low = 1
    else:
        res_low = 0

    if res_low == 0:
        i = 1
        a = 0
        while i < 16384:
            scan = int(h[i]) - int(h[i - 1])
            count = int(h[i + 1]) - int(h[i])
            if scan == 0 and count == 0:
                if h[i + a + 2] == h[i + a + 1]:
                    a += 1
                i += a + 2
                code = a << 3
                d1 = int(h[i]) - int(h[i - 1])
                d2 = int(h[i + 1]) - int(h[i])
                if d1 == 2:
                    if d2 == -2:
                        code += 2
                        i += 1
                    elif d2 == 0:
                        code += 3
                        i += 1
                    else:
                        code += 1
                elif d1 == -2:
                    if d2 == 2:
                        code += 4
                        i += 1
                    elif d2 == 0:
                        code += 5
                        i += 1
                    else:
                        code += 6
                elif d1 == 4:
                    code += 7
                else:
                    i -= 1
                ch.append(code)
                a = 0
                i += 1
                continue
            if abs(scan) <= 6 and abs(count) <= 8:
                s = scan + 6
                c = count + 8
                if s == 12 or c == 16:
                    if i < 16382 and abs(int(h[i + 2]) - int(h[i + 1])) <= 32:
                        e3 = int(h[i + 2]) - int(h[i + 1]) + 32
                        s += 26
                        c += 8
                        if s == 64 or c == 32 or e3 == 64:
                            i = _escape(ch, h, ch_res, hr_word, hr_mem, i,
                                        quality)
                        else:
                            c >>= 1
                            ch.append(64)
                            ch.append(64 + s + (c >> 3))
                            ch.append(((c & 7) << 5) + (e3 >> 1))
                            i += 2
                    else:
                        i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
                else:
                    if s < 8:
                        ch.append(32 + (s << 2) + (c >> 1))
                    elif s == 8:
                        ch.append(16 + (c >> 1))
                    else:
                        ch.append(24 + (c >> 1))
                    i += 1
            elif abs(scan) <= 32 and abs(count) <= 16 and i < 16382 \
                    and abs(int(h[i + 2]) - int(h[i + 1])) <= 32:
                s = scan + 32
                c = count + 16
                e3 = int(h[i + 2]) - int(h[i + 1]) + 32
                if s == 64 or c == 32 or e3 == 64:
                    i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
                else:
                    c >>= 1
                    ch.append(64)
                    ch.append(64 + s + (c >> 3))
                    ch.append(((c & 7) << 5) + (e3 >> 1))
                    i += 2
            else:
                i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
            i += 1
    elif res_low == 1:
        i = 1
        a = 0
        while i < 16384:
            scan = int(h[i]) - int(h[i - 1])
            count = int(h[i + 1]) - int(h[i])
            if scan == 0 and count == 0:
                while a < 7 and h[i + a + 2] == h[i + a + 1]:
                    a += 1
                i += a + 2
                code = a << 2
                d1 = int(h[i]) - int(h[i - 1])
                if d1 == 2:
                    code += 1
                elif d1 == -2:
                    code += 2
                elif d1 == 0:
                    code += 3
                else:
                    i -= 1
                ch.append(code)
                a = 0
                i += 1
                continue
            if abs(scan) <= 4 and abs(count) <= 8:
                s = scan + 4
                c = count + 8
                if s == 8 or c == 16:
                    if i < 16382 and abs(int(h[i + 2]) - int(h[i + 1])) <= 32:
                        e3 = int(h[i + 2]) - int(h[i + 1]) + 32
                        s += 28
                        c += 8
                        if s == 64 or c == 32 or e3 == 64:
                            i = _escape(ch, h, ch_res, hr_word, hr_mem, i,
                                        quality)
                        else:
                            c >>= 1
                            ch.append(64)
                            ch.append(64 + s + (c >> 3))
                            ch.append(((c & 7) << 5) + (e3 >> 1))
                            i += 2
                    else:
                        i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
                else:
                    ch.append(32 + (s << 2) + (c >> 1))
                    i += 1
            elif abs(scan) <= 32 and abs(count) <= 16 and i < 16382 \
                    and abs(int(h[i + 2]) - int(h[i + 1])) <= 32:
                s = scan + 32
                c = count + 16
                e3 = int(h[i + 2]) - int(h[i + 1]) + 32
                if s == 64 or c == 32 or e3 == 64:
                    i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
                else:
                    c >>= 1
                    ch.append(64)
                    ch.append(64 + s + (c >> 3))
                    ch.append(((c & 7) << 5) + (e3 >> 1))
                    i += 2
            else:
                i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
            i += 1
    else:  # res_low == 2
        i = 1
        a = 0
        while i < 16384:
            scan = int(h[i]) - int(h[i - 1])
            count = int(h[i + 1]) - int(h[i])
            if scan == 0 and count == 0:
                while a < 63 and h[i + a + 2] == h[i + a + 1]:
                    a += 1
                i += a + 1
                ch.append(a)
                a = 0
                i += 1
                continue
            if abs(scan) <= 32 and abs(count) <= 16 and i < 16382 \
                    and abs(int(h[i + 2]) - int(h[i + 1])) <= 32:
                s = scan + 32
                c = count + 16
                e3 = int(h[i + 2]) - int(h[i + 1]) + 32
                if s == 64 or c == 32 or e3 == 64:
                    i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
                else:
                    c >>= 1
                    ch.append(64)
                    ch.append(64 + s + (c >> 3))
                    ch.append(((c & 7) << 5) + (e3 >> 1))
                    i += 2
            else:
                i = _escape(ch, h, ch_res, hr_word, hr_mem, i, quality)
            i += 1

    # squeeze pass (838-866): drop the 64 marker byte and keep only the
    # second byte of each q>LOW5 escape triple
    j = len(ch)
    out = [ch[0]]
    i = 1
    while i < j - 1:
        if ch[i] == 64:
            out.append(ch[i + 1])
            out.append(ch[i + 2])
            i += 2
        elif ch[i] == 128:
            if quality > T.LOW5:
                out.append(ch[i + 2])
                i += 2
            else:
                i += 1
                out.append(ch[i])
        else:
            out.append(ch[i])
        i += 1
    if i < j:
        out.append(ch[j - 1])

    return out, res_low, hr_word, hr_mem


def uv_highres_compression(tree1_uv: np.ndarray,
                           tail: np.ndarray | None = None):
    """U/V 64x64 LL2 plane compression appended after the Y section
    (encoder/compress_pixel.c:878-1014).  ``tree1_uv``: the 8192 bytes at
    tree1[16384:24576], already &252-masked by the caller.
    Returns the appended byte list."""
    pad = np.zeros(80, np.int32)
    if tail is not None:
        n = min(len(tail), 80)
        pad[:n] = tail[:n]
    h = np.concatenate([tree1_uv.astype(np.int32), pad])

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        out = np.empty(2 * 8192 + 8, np.int32)
        n_out = ffi.new("long *")
        lib.nhw_uv_highres_compression(
            ffi.cast("const int32_t *", h.ctypes.data),
            ffi.cast("int32_t *", out.ctypes.data), n_out)
        return out[: n_out[0]].tolist()

    n = 8192
    ch: list[int] = [int(h[0])]
    i = 1
    a = 0
    res = 0
    while i < n:
        scan = int(h[i]) - int(h[i - 1])
        count = int(h[i + 1]) - int(h[i])
        if scan == 0 and count == 0:
            while h[i + a + 2] == h[i + a + 1]:
                a += 1
                if a < 7:
                    continue
                if a == 7 or res == 1:
                    res = 1
                    if a < 14:
                        continue
                break
            i += a + 1
            if res == 1:
                ch.append(64 + (7 << 3) + a - 7)
            else:
                i += 1
                code = 64 + (a << 3)
                d1 = int(h[i]) - int(h[i - 1])
                d2 = int(h[i + 1]) - int(h[i])
                d3 = int(h[i + 2]) - int(h[i + 1])
                if d1 == 4:
                    if d2 == -4:
                        if d3 == 0:
                            code += 3
                            i += 2
                        else:
                            code += 2
                            i += 1
                    else:
                        code += 1
                elif d1 == -4:
                    if d2 == 4:
                        if d3 == 0:
                            code += 4
                            i += 2
                        else:
                            code += 5
                            i += 1
                    else:
                        code += 6
                elif d1 == 8:
                    code += 7
                else:
                    i -= 1
                ch.append(code)
            a = 0
            res = 0
            i += 1
            continue
        if abs(scan) <= 4 and abs(count) <= 4:
            if scan == 0 and count == 4:
                res = 0
            elif scan == 0 and count == -4:
                res = 1
            elif scan == 4 and count == 0:
                res = 2
            elif scan == -4 and count == 0:
                res = 3
            elif scan == 4 and count == 4:
                res = 4
            elif scan == 4 and count == -4:
                res = 5
            elif scan == -4 and count == 4:
                res = 6
            elif scan == -4 and count == -4:
                res = 7
            d3 = int(h[i + 2]) - int(h[i + 1])
            if d3 == 0:
                ch.append(128 + 64 + (res << 2))
                i += 2
            elif d3 == 4:
                ch.append(128 + 64 + (res << 2) + 1)
                i += 2
            elif d3 == -4:
                ch.append(128 + 64 + (res << 2) + 2)
                i += 2
            elif d3 == 8:
                ch.append(128 + 64 + (res << 2) + 3)
                i += 2
            else:
                s = scan + 16
                c = count + 16
                ch.append((s << 1) + (c >> 2))
                i += 1
            res = 0
        elif abs(scan) <= 16 and abs(count) <= 16:
            s = scan + 16
            c = count + 16
            if s == 32 or c == 32:
                ch.append(128 + (int(h[i]) >> 2))
            else:
                ch.append((s << 1) + (c >> 2))
                i += 1
        else:
            ch.append(128 + (int(h[i]) >> 2))
        i += 1
    return ch
