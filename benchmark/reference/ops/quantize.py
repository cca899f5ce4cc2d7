# Frozen copy of nhwcodec_tpu_torch/host/ops/quantize.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Scalar quantization to code bytes + serpentine interleave (encoder).

Reference behavior: offsetY / offsetUV (encoder/image_processing.c:108-521),
the Y/UV serpentine interleaves and the crossing-merge / select-code /
run-cap stream fixups (encoder/nhw_encoder.c:2100-2252, 2542-2570,
2840-2868).

offsetY carries per-row duty-cycle counters (quant/quant6, q<=LOW4), an
image-wide pair-balancing counter (quant4) and neighbour feedback through
just-written values, so it replays sequentially; the serpentine interleave
itself is a fixed permutation (shared with ops/geometry)."""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T
from benchmark.reference.ops import geometry

D = 256
N = 512
SZ = 65536

EXTRA_WORDS1 = [10, 12, 14, 18, 20, 22, 26, 28, 30, 34, 36, 38, 42, 44, 46,
                50, 52, 54, 58]
EXTRA_WORDS2 = [60, 62, 66, 68, 70, 74, 76, 78, 82, 84, 86, 90, 92, 94, 98,
                100, 102, 106, 108]


def offset_y(process: np.ndarray, quality: int, m1: int) -> None:
    """Quantize the full Y coefficient plane to code bytes in place
    (encoder/image_processing.c:185-521).  C reads one short past the
    plane at the last position (heap slack, zero in practice).

    All four passes only act on (or near) nonzero coefficients and the
    fixups only ever write to nonzero targets, so each pass iterates the
    sparse candidate set in raster order with live reads; zero positions
    become 128 in bulk afterwards (backward reads distinguish only the
    sign/range of earlier codes, identical for 0 and 128)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        pf = np.concatenate([process.reshape(-1), np.zeros(8, np.int16)])
        lib.nhw_offset_y(ffi.cast("int16_t *", pf.ctypes.data), quality, m1,
                         1 if quality <= T.LOW4 else 0)
        process.reshape(-1)[:] = pf[:4 * SZ]
        return

    pf = np.concatenate([process.reshape(-1), np.zeros(8, np.int16)])

    # pass 1: even-pair decrements in the bands (194-237)
    cand = np.nonzero(pf[: 4 * SZ] > 7)[0]
    for i in cand.tolist():
        if not (i >= 2 * SZ or (i & 511) >= D):
            continue
        if (i & 511) >= 2 * D - 1:
            continue
        a = int(pf[i])
        if a > 7 and int(pf[i + 1]) > 7:
            if not (a & 7) and not (pf[i + 1] & 7):
                if a > 15:
                    if i > 0:
                        if int(pf[i - 1]) <= 0:
                            pf[i] = a - 1
                        elif int(pf[i + 1]) > 15:
                            if (i & 511) < 2 * D - 2 and int(pf[i + 2]) <= 0:
                                pf[i + 1] -= 1
                elif int(pf[i + 1]) > 15:
                    if (i & 511) < 2 * D - 2 and int(pf[i + 2]) <= 0:
                        pf[i + 1] -= 1

    # passes 2 + 3: pair promotions (241-309), q>LOW4; sparse with skips
    if quality > T.LOW4:
        av = np.abs(pf[: 2 * SZ].reshape(D, N)[:, :D])
        rr, cc = np.nonzero((av > 3) & (av < 8))
        by_row: dict[int, list[int]] = {}
        for k in range(len(rr)):
            by_row.setdefault(int(rr[k]), []).append(int(cc[k]))
        for r in range(D):
            cols = by_row.get(r)
            if not cols:
                continue
            base = r * N
            skip_until = 1
            for j in cols:
                if j < skip_until or j >= D - 1:
                    continue
                a = base + j
                v = int(pf[a])
                if 3 < v < 8:
                    if 3 < int(pf[a - 1]) <= 7:
                        if 3 < int(pf[a + 1]) <= 7:
                            pf[a] = 12700
                            pf[a - 1] = 10100
                            skip_until = j + 2
                        elif 3 < int(pf[a + N - 1]) <= 7 \
                                and 3 < int(pf[a + N]) <= 7:
                            pf[a - 1] = 12100
                            pf[a] = 10100
                            pf[a + N - 1] = 10100
                            pf[a + N] = 10100
                            skip_until = j + 2
                elif -8 < v < -3:
                    if -8 < int(pf[a - 1]) <= -4:
                        if -8 < int(pf[a + 1]) <= -4:
                            pf[a] = 12900
                            pf[a - 1] = 10100
                            skip_until = j + 2
                        elif -8 < int(pf[a + N - 1]) <= -4 \
                                and -8 < int(pf[a + N]) <= -4:
                            pf[a - 1] = 12200
                            pf[a] = 10100
                            pf[a + N - 1] = 10100
                            pf[a + N] = 10100
                            skip_until = j + 2

        av = np.abs(pf[: 2 * SZ].reshape(D, N)[:, :D])
        rr, cc = np.nonzero((av >= 5) & (av <= 7))
        by_row = {}
        for k in range(len(rr)):
            by_row.setdefault(int(rr[k]), []).append(int(cc[k]))
        for r in range(D):
            cols = by_row.get(r)
            if not cols:
                continue
            base = r * N
            skip_until = 0
            for j in cols:
                if j < skip_until or j >= D - 1:
                    continue
                a = base + j
                v = int(pf[a])
                if v in (5, 6, 7) and int(pf[a + 1]) in (5, 6, 7):
                    pf[a] = 10300
                    skip_until = j + 2
                elif v in (-5, -6, -7) and int(pf[a + 1]) in (-5, -6, -7):
                    pf[a] = 10204
                    skip_until = j + 2

    # pass 4: the quantizer (312-520), sparse over nonzero coefficients
    low4 = quality <= T.LOW4
    zmask = pf[: 4 * SZ] == 0
    cand = np.nonzero(~zmask)[0]
    quant = quant6 = quant4 = 0
    cur_row = -1
    for i in cand.tolist():
        row = i >> 9
        if row != cur_row:
            quant = 0
            quant6 = 0
            cur_row = row
        a = int(pf[i])
        if a == 0:
            continue  # consumed by a forward write

        if a > 10000:
            pf[i] = {10100: 128, 12700: 127, 12900: 129, 10204: 125,
                     10300: 126, 12100: 121, 12200: 122}[a]
            continue

        if a > 127:
            exw = ((a & 0xfff8) - 128) >> 3
            pf[i] = EXTRA_WORDS1[min(exw, 18)]
            continue
        if a < -127:
            exw = (((-a) & 0xfff8) - 128) >> 3
            pf[i] = EXTRA_WORDS2[min(exw, 18)]
            continue

        if a < -12 and ((-a) & 7) == 6:
            if (i & 511) < 2 * D - 1 and pf[i + 1] == -7:
                pf[i + 1] = -9

        if a < 0:
            if a == -7 and pf[i + 1] == 8 and (i & 511) < 2 * D - 1:
                pf[i] = -8
                a = -8
            a = -a
            if a > 14 and (a & 7) == 7 and 0 < int(pf[i + 1]) < 8:
                a -= 2
            if low4:
                if a == 15:
                    if not quant:
                        a &= 504
                        quant = 1
                    else:
                        quant = (quant + 1) % 6
                elif a > 22 and (a & 7) == 7:
                    if not quant6:
                        a &= 504
                        quant6 = 1
                    else:
                        quant6 = (quant6 + 1) % 4
                else:
                    a &= 504
            else:
                if (a & 7) < 7:
                    a &= 504
            a = -a
        elif a == 8 and pf[i + 1] == -7 and (i & 511) < 2 * D - 1:
            pf[i + 1] = -8
        elif a > 12 and (a & 7) >= 6:
            if (i & 511) < 2 * D - 1 and pf[i + 1] == 7:
                pf[i + 1] = 9

        if a >= 14 and int(pf[i + 1]) >= 14 and low4:
            if i >= 2 * SZ or (i & 511) >= D:
                q2 = a & 510
                q3 = int(pf[i + 1]) & 510
                if (q2 & 7) == 6 and (q3 & 7) == 6 \
                        and ((a & 1) == 1 or (pf[i + 1] & 1) == 1):
                    if 0 < (i & 511) < 2 * D - 2:
                        vm = int(pf[i - 1])
                        if -8 < vm < -2:
                            r1 = 1
                        elif vm < -7:
                            r1 = 0 if ((-vm) & 7) < 6 else 1
                        else:
                            r1 = 0
                        vp = int(pf[i + 2])
                        if -8 < vp < -2:
                            r2 = 1
                        elif vp < -7:
                            r2 = 0 if ((-vp) & 7) < 6 else 1
                        else:
                            r2 = 0
                    else:
                        r1 = r2 = 0

                    if not quant4:
                        b = int(pf[i + 1])
                        if (a & 504) == (b & 504):
                            if a >= b:
                                if not r1:
                                    a += 2
                                    pf[i + 1] = b - 2
                            else:
                                if not r2:
                                    pf[i + 1] = b + 2
                        elif a <= b:
                            if not r1:
                                a += 2
                                pf[i + 1] = b - 2
                        else:
                            if not r2:
                                pf[i + 1] = b + 2
                        quant4 = 1
                    else:
                        quant4 = (quant4 + 1) % 3

        if -m1 < a < m1:
            pf[i] = 128
            continue
        a += 128
        pf[i] = a & 248
    pf[: 4 * SZ][zmask] = 128
    process.reshape(-1)[:] = pf[:4 * SZ]


def offset_uv(process: np.ndarray, m2: int) -> None:
    """Quantize one chroma coefficient plane in place
    (encoder/image_processing.c:108-183).  Same one-past heap read as
    offset_y at the last position."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        pf = np.concatenate([process.reshape(-1), np.zeros(8, np.int16)])
        lib.nhw_offset_uv(ffi.cast("int16_t *", pf.ctypes.data), m2)
        process.reshape(-1)[:] = pf[:SZ]
        return

    pf = np.concatenate([process.reshape(-1), np.zeros(8, np.int16)])
    i = 0
    while i < SZ:
        a = int(pf[i])
        if a > 10000:
            code = {12400: 124, 12600: 126, 12900: 122, 13000: 130}.get(a)
            if code is not None:
                pf[i] = code
                i += 1
                continue
        if a > 127:
            exw = ((a & 0xfff8) - 128) >> 3
            pf[i] = EXTRA_WORDS1[min(exw, 18)]
            i += 1
            continue
        if a < -127:
            exw = (((-a) & 0xfff8) - 128) >> 3
            pf[i] = EXTRA_WORDS2[min(exw, 18)]
            i += 1
            continue

        if a in (-7, -8):
            if (i & 255) < D - 1 and int(pf[i + 1]) in (-7, -8):
                pf[i] = 120
                pf[i + 1] = 120
                i += 2
                continue
            a = -a
            if -8 < int(pf[i + 1]) < 0:
                if (a & 7) < 6:
                    a &= 504
            else:
                if (a & 7) < 7:
                    a &= 504
            a = -a
        elif a < 0:
            a = -a
            if -8 < int(pf[i + 1]) < 0:
                if (a & 7) < 6:
                    a &= 504
            else:
                if (a & 7) < 7:
                    a &= 504
            a = -a
        elif a > 6 and (a & 7) >= 6:
            if (i & 255) < D - 1 and pf[i + 1] == 7:
                pf[i + 1] = 8

        if -m2 < a < m2:
            pf[i] = 128
        else:
            pf[i] = (a + 128) & 248
        i += 1
    process.reshape(-1)[:] = pf[:SZ]


# ---------------------------------------------------------------------------
# serpentine + stream fixups


def serpentine_y(process: np.ndarray) -> np.ndarray:
    """4-px vertical boustrophedon Y interleave
    (encoder/nhw_encoder.c:2111-2132) via the shared permutation."""
    from benchmark.reference import native

    perm = geometry.y_deserpentine_map()
    out = np.zeros(6 * SZ, np.uint8)
    pf = np.ascontiguousarray(process.reshape(-1), np.int16)
    if native.available() and perm.dtype == np.int64:
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_scatter_u8(
            ffi.cast("const int16_t *", pf.ctypes.data),
            ffi.cast("const int64_t *", perm.ctypes.data), 4 * SZ,
            ffi.cast("uint8_t *", out.ctypes.data), 1, 0)
        return out
    out[: 4 * SZ][perm] = (pf & 255).astype(np.uint8)
    return out


def serpentine_uv(im_nhw: np.ndarray, process: np.ndarray,
                  component: int) -> None:
    """8-px serpentine UV interleave, U even / V odd offsets
    (encoder/nhw_encoder.c:2542-2570, 2840-2868)."""
    from benchmark.reference import native

    perm = geometry.uv_deserpentine_map()
    pf = np.ascontiguousarray(process.reshape(-1), np.int16)
    if (native.available() and perm.dtype == np.int64
            and im_nhw.flags.c_contiguous):
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_scatter_u8(
            ffi.cast("const int16_t *", pf.ctypes.data),
            ffi.cast("const int64_t *", perm.ctypes.data), SZ,
            ffi.cast("uint8_t *", im_nhw.ctypes.data), 2,
            4 * SZ + component)
        return
    stream = np.empty(SZ, np.uint8)
    stream[perm] = (pf & 255).astype(np.uint8)
    im_nhw[4 * SZ + component: 6 * SZ + component - 1: 2] = stream


def merge_crossing_codes(s: np.ndarray) -> None:
    """Merge 136/120 codes across 3-gap 128 runs into 132-135 + 201
    (encoder/nhw_encoder.c:2136-2160).  Cursor semantics matter."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_merge_crossing(ffi.cast("uint8_t *", s.ctypes.data))
        return

    i = 0
    end = 4 * SZ - 4
    while i < end:
        if s[i] != 128 and s[i + 1] == 128:
            if s[i + 2] == 128:
                if s[i + 3] == 128:
                    v0 = int(s[i])
                    v4 = int(s[i + 4])
                    if v0 == 136 and v4 == 136:
                        s[i] = 132
                        s[i + 4] = 201
                        i += 4
                    elif v0 == 136 and v4 == 120:
                        s[i] = 133
                        s[i + 4] = 201
                        i += 4
                    elif v0 == 120 and v4 == 136:
                        s[i] = 134
                        s[i + 4] = 201
                        i += 4
                    elif v0 == 120 and v4 == 120:
                        s[i] = 135
                        s[i + 4] = 201
                        i += 4
                    else:
                        i += 3
                else:
                    i += 2
            else:
                i += 1
        i += 1


def select_codes(s: np.ndarray) -> tuple[int, int]:
    """Promote isolated 136/120 codes to select codes 153/155/157/159
    (encoder/nhw_encoder.c:2162-2217).  Returns (nhw_select1, nhw_select2).
    """
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        o1 = ffi.new("long *")
        o2 = ffi.new("long *")
        lib.nhw_select_codes(ffi.cast("uint8_t *", s.ctypes.data), o1, o2)
        return int(o1[0]), int(o2[0])

    s[0:4] = 128
    s[4 * SZ - 4: 4 * SZ] = 128
    sel1 = sel2 = 0
    cand = np.nonzero((s[4: 4 * SZ - 4] == 136) | (s[4: 4 * SZ - 4] == 120)
                      )[0] + 4
    for i in cand.tolist():
        v = int(s[i])
        if v not in (136, 120):
            continue
        nxt = int(s[i + 1])
        if s[i + 2] == 128 and nxt in (120, 136) and s[i - 1] == 128 \
                and s[i - 2] == 128 and s[i - 3] == 128 and s[i - 4] == 128:
            s[i + 1] = 157 if nxt == 120 else 159
            sel2 += 1
        elif s[i - 1] == 128 and nxt in (120, 136) and s[i + 2] == 128 \
                and s[i + 3] == 128 and s[i + 4] == 128 and s[i + 5] == 128:
            s[i + 1] = 157 if nxt == 120 else 159
            sel2 += 1
        elif s[i - 1] == 128 and s[i - 2] == 128 and s[i - 3] == 128 \
                and s[i - 4] == 128 and s[i + 1] == 128:
            s[i] = 153 if v == 136 else 155
            sel1 += 1
        elif s[i - 1] == 128 and s[i + 1] == 128 and s[i + 2] == 128 \
                and s[i + 3] == 128 and s[i + 4] == 128:
            s[i] = 153 if v == 136 else 155
            sel1 += 1
    return sel1, sel2


def cap_long_runs(s: np.ndarray) -> None:
    """Demote select codes at >255-long 128 runs
    (encoder/nhw_encoder.c:2220-2252)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_cap_long_runs(ffi.cast("uint8_t *", s.ctypes.data))
        return

    def demote(k: int) -> None:
        if s[k] == 153:
            s[k] = 124
        elif s[k] == 155:
            s[k] = 123

    i = 0
    count = 0
    while i < 4 * SZ:
        while s[i] == 128 and s[i + 1] == 128:
            count += 1
            if count > 255:
                demote(i)
                demote(i + 1)
                demote(i + 2)
                demote(i + 3)
                i -= 1
                count = 0
            else:
                i += 1
        if count >= 252:
            demote(i + 1)
        count = 0
        i += 1
