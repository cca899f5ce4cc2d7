# Frozen copy of nhwcodec_tpu_torch/host/ops/residue.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Y residue classification ladder and positional side-streams.

Reference behavior: the res256 marker ladder (encoder/nhw_encoder.c:1084-
1326), the residue classification loop (:1329-1420), the q>HIGH1
first-order adjustments (:1426-1496), and the res1/res3/res5 positional
stream builders (:1498-1887) whose shared pack shape also serves res6
(encoder/wavelet_filterbank.c:568-702).

These passes carry raster state (marks in res256 feed later deltas; band
nudges at transposed positions are re-read by later iterations), so they
run as sequential host passes with live in-place reads — the encoder-side
mirror of ops/streams.py which the bit-exact decoder already inverts.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

D = 256
N = 512
SZ = 65536

# cached (word_tab, repl_tab) lookup pairs for the native positional
# stream builder, keyed by the codes mapping
_POS_STREAM_TABS: dict = {}


def _band_w1(pf, st):
    v = int(pf[st])
    if v == 7:
        if 0 <= int(pf[st - 1]) < 8:
            pf[st] = v + 2
    elif v == 8:
        if -2 <= int(pf[st - 1]) < 8:
            pf[st] = v + 2


def _band_w2(pf, st):
    v = int(pf[st])
    if v < -14:
        if ((-v) & 7) == 0 or ((-v) & 7) == 7:
            pf[st] = v + 1
    elif v == 7 or (v & 65534) == 8:
        if int(pf[st - 1]) >= -2:
            pf[st] = v + 3


def _band_w3(pf, st):
    v = int(pf[st])
    if v < -14:
        if ((-v) & 7) == 0 or ((-v) & 7) == 7:
            pf[st] = v + 1
    elif v >= 0 and ((v + 2) & 65532) == 8:
        if int(pf[st - 1]) >= -2:
            pf[st] = 10
    elif v > 14 and (v & 7) == 7:
        pf[st] = v + 1


def res256_column_ladder(process: np.ndarray, res256: np.ndarray,
                         quality: int, res_setting: int,
                         resIII: np.ndarray | None = None,
                         kernel_head: np.ndarray | None = None) -> None:
    """Column-major vertical-gradient marking (encoder/nhw_encoder.c:1084-
    1326).  Mutates process (level-1 LL/band planes, 512-wide) and res256
    (marks 12100..12600/14000..14900).

    The reference reads res256[count+2*IM_DIM] past the allocation on the
    last row; that address aliases (in order): 4 slack shorts holding the
    free-chunk remnant of the nhw_kernel buffer at kernel[65536:65540]
    (row 128 cols 0..3; col 0 is never written by the kernel pass, so it
    is 0 under the deterministic zero-fill — pass via ``kernel_head``),
    the next chunk's size field [17,2,0,0], then the live resIII data.
    Writes stay in-bounds."""
    pf = process.reshape(-1)
    oob = np.zeros(1024, np.int16)
    if kernel_head is not None:
        oob[0:4] = np.asarray(kernel_head, np.int16)[:4]
    oob[4:8] = [17, 2, 0, 0]
    if resIII is not None:
        r3 = resIII.reshape(-1)
        oob[8:] = r3[:1016]
    rf = np.concatenate([res256.reshape(-1), oob])

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_column_ladder(
            ffi.cast("int16_t *", pf.ctypes.data),
            ffi.cast("int16_t *", rf.ctypes.data), quality,
            1 if quality >= T.LOW1 else 0, 1 if quality == T.LOW2 else 0,
            1 if quality >= T.HIGH1 else 0, res_setting)
        res256.reshape(-1)[:] = rf[:SZ]
        return

    for j in range(D):
        for r in range(D - 1):
            scan = r * N + j
            cnt = r * D + j
            res = int(pf[scan]) - int(rf[cnt])
            a = int(pf[scan + N]) - int(rf[cnt + D])
            b2 = int(pf[scan + 2 * N]) - int(rf[cnt + 2 * D])
            st = (j << 9) + r + D  # transposed band position

            if res == 2 and a == 2 and b2 >= 2:
                if b2 < 5 or b2 > 6:
                    rf[cnt] = 12400
                    pf[scan + N] -= 2
                    pf[scan + 2 * N] -= 2
            elif ((res == 2 and a == 3) or (res == 3 and a == 2)) \
                    and 1 < b2 < 6:
                rf[cnt] = 12400
                pf[scan + N] -= 2
                pf[scan + 2 * N] -= 2
            elif res == 3 and a == 3:
                if 0 < b2 < 6:
                    rf[cnt] = 12400
                    pf[scan + N] -= 2
                    pf[scan + 2 * N] -= 2
                elif quality >= T.LOW1:
                    rf[cnt] = 12100
                    pf[scan + N] = rf[cnt + D]
            elif a == -4 and res in (2, 3) and b2 in (2, 3):
                if res == 2 and b2 == 2:
                    pf[scan + N] += 1
                else:
                    rf[cnt] = 12400
                    pf[scan + N] -= 2
                    pf[scan + 2 * N] -= 2
            elif res == 1 and a == 3 and b2 == 2:
                if r > 0:
                    if (int(pf[scan - N]) - int(rf[cnt - D])) >= 0:
                        rf[cnt] = 12400
                        pf[scan + N] -= 2
                        pf[scan + 2 * N] -= 2
            elif (res in (3, 4, 5) or res > 6) and (a == 3 or (a & 65534) == 4):
                if res > 6:
                    rf[cnt] = 12500
                    pf[scan + N] = rf[cnt + D]
                elif quality >= T.LOW1:
                    rf[cnt] = 12100
                    pf[scan + N] = rf[cnt + D]
                elif quality == T.LOW2:
                    if res < 5 and a == 5:
                        rf[cnt + D] = 14100
                    elif res >= 5:
                        rf[cnt] = 14100
                    elif res == 3 and a >= 4:
                        rf[cnt + D] = 14100
                    pf[scan + N] = rf[cnt + D]
            elif res in (2, 3) and a in (2, 3):
                if b2 in (0, 1):
                    if (int(pf[scan + 1]) - int(rf[cnt + 1])) in (2, 3):
                        if (int(pf[scan + N + 1]) - int(rf[cnt + D + 1])) in (2, 3):
                            if (int(pf[scan + 2 * N + 1])
                                    - int(rf[cnt + 2 * D + 1])) > 0:
                                rf[cnt] = 12400
                                pf[scan + N] -= 2
                                pf[scan + 2 * N] -= 2
            elif a == 4 and res in (-2, -3) and (-b2) in (2, 3):
                if res == -2 and b2 == -2:
                    pf[scan + N] -= 1
                else:
                    rf[cnt] = 12300
                    pf[scan + N] += 2
                    pf[scan + 2 * N] += 2
            elif (res in (-3, -4, -5) or res < -7) and a in (-3, -4, -5):
                if res < -7:
                    rf[cnt] = 12600
                    pf[scan + N] = rf[cnt + D]
                elif quality >= T.LOW1:
                    rf[cnt] = 12200
                    pf[scan + N] = rf[cnt + D]
                elif quality == T.LOW2:
                    if res > -5 and a == -5:
                        rf[cnt + D] = 14000
                    elif res <= -5:
                        rf[cnt] = 14000
                    elif res == -3 and a <= -4:
                        rf[cnt + D] = 14000
                    pf[scan + N] = rf[cnt + D]
            elif a in (-2, -3):
                if res in (-2, -3):
                    if -b2 > 0:
                        rf[cnt] = 12300
                        pf[scan + N] += 2
                        pf[scan + 2 * N] += 2
                    elif res == -3 and quality >= T.HIGH1:
                        rf[cnt] = 14500
                    elif -b2 == 0:
                        if (int(pf[scan + 1]) - int(rf[cnt + 1])) in (-2, -3):
                            if (int(pf[scan + N + 1])
                                    - int(rf[cnt + D + 1])) in (-2, -3):
                                if (int(pf[scan + 2 * N + 1])
                                        - int(rf[cnt + 2 * D + 1])) < 0:
                                    rf[cnt] = 12300
                                    pf[scan + N] += 2
                                    pf[scan + 2 * N] += 2
                    elif res == -2:
                        _band_w2(pf, st)
                    else:
                        _lw3(pf, rf, cnt, st, quality)
                elif res == -1 and a == -3 and b2 == -2:
                    if r > 0:
                        if (int(pf[scan - N]) - int(rf[cnt - D])) <= 0:
                            rf[cnt] = 12300
                            pf[scan + N] += 2
                            pf[scan + 2 * N] += 2
                elif res == -1:
                    if -b2 == 3:
                        rf[cnt] = 12300
                        pf[scan + N] += 2
                        pf[scan + 2 * N] += 2
                    else:
                        _band_w1(pf, st)
                elif res == -4:
                    if -b2 > 1 and -b2 < 4:
                        rf[cnt] = 12300
                        pf[scan + N] += 2
                        pf[scan + 2 * N] += 2
                    else:
                        _lw5(pf, rf, cnt, st, res, quality)
            elif res == 0 or res == -1:
                _band_w1(pf, st)
            elif res == -2:
                _band_w2(pf, st)
            elif res == -3:
                _lw3(pf, rf, cnt, st, quality)
            elif res < -res_setting:
                _lw5(pf, rf, cnt, st, res, quality)

    res256.reshape(-1)[:] = rf[:SZ]


def _lw3(pf, rf, cnt, st, quality):
    if quality >= T.HIGH1:
        rf[cnt] = 14500
    else:
        _band_w3(pf, st)


def _lw5(pf, rf, cnt, st, res, quality):
    rf[cnt] = 14000
    if res == -4:
        v = int(pf[st])
        if v in (-7, -8):
            if -8 < int(pf[st - 1]) < 2:
                pf[st] = -9
    elif res < -6:
        if res < -7 and quality >= T.HIGH1:
            rf[cnt] = 14900
        else:
            v = int(pf[st])
            if v < -14:
                if ((-v) & 7) == 0 or ((-v) & 7) == 7:
                    pf[st] = v + 1
            elif v in (7, 8):
                if -1 <= int(pf[st - 1]) < 8:
                    pf[st] = v + 3


def res256_classify(process: np.ndarray, res256: np.ndarray, quality: int,
                    res_setting: int) -> tuple[int, int, int]:
    """Convert deltas/marks to residue codes 121..149
    (encoder/nhw_encoder.c:1329-1420).  Returns the raw (res1, res3, res5)
    word counts."""
    pf = process.reshape(-1)
    rf = res256.reshape(-1)
    n1 = n3 = n5 = 0

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        counts = np.zeros(3, np.int64)
        lib.nhw_classify(
            ffi.cast("int16_t *", pf.ctypes.data),
            ffi.cast("int16_t *", rf.ctypes.data),
            1 if quality >= T.HIGH1 else 0, res_setting,
            ffi.cast("long *", counts.ctypes.data))
        return int(counts[0]), int(counts[1]), int(counts[2])

    for r in range(D):
        for j in range(D):
            scan = r * N + j
            cnt = r * D + j
            mark = int(rf[cnt])
            if mark < 12000:
                res = int(pf[scan]) - mark
                rf[cnt] = 0
                st = (j << 9) + r + D
                if res == 0 or res == 1:
                    v = int(pf[st])
                    if v in (-7, -8):
                        if -8 < int(pf[st - 1]) < 2:
                            pf[st] = -9
                elif res == 2:
                    v = int(pf[st])
                    if v > 15 and not (v & 7):
                        pf[st] = v - 1
                    elif v in (-7, -8):
                        if int(pf[st - 1]) <= 1:
                            pf[st] = -9
                    elif v == -6:
                        if -8 < int(pf[st - 1]) <= -1:
                            pf[st] = -9
                elif res == 3:
                    if quality >= T.HIGH1:
                        rf[cnt] = 144
                        n5 += 1
                    else:
                        v = int(pf[st])
                        if v > 15 and not (v & 7):
                            pf[st] = v - 1
                        elif v <= 0 and (((-v) + 2) & 65532) == 8:
                            if int(pf[st - 1]) <= 2:
                                pf[st] = -10
                elif res > res_setting:
                    rf[cnt] = 141
                    n1 += 1
                    if res == 4:
                        v = int(pf[st])
                        if v == 7 or (v & 65534) == 8:
                            if 0 <= int(pf[st - 1]) < 8:
                                pf[st] = v + 2
                    elif res > 6:
                        if res > 7 and quality >= T.HIGH1:
                            rf[cnt] = 148
                            n5 += 1
                            n1 += 1
                        else:
                            v = int(pf[st])
                            if v > 15 and not (v & 7):
                                pf[st] = v - 1
                            elif v in (-6, -7, -8):
                                if -8 < int(pf[st - 1]) < 0:
                                    pf[st] = -9
            else:
                code = {14000: 140, 14500: 145, 12200: 122, 12100: 121,
                        12300: 123, 12400: 124, 14100: 141, 12500: 125,
                        12600: 126, 14900: 149}[mark]
                rf[cnt] = code
                if code in (140, 141):
                    n1 += 1
                elif code == 145:
                    n5 += 1
                elif code in (122, 121, 123, 124):
                    n3 += 1
                elif code in (125, 126):
                    n3 += 1
                    n1 += 1
                elif code == 149:
                    n5 += 1
                    n1 += 1
    return n1, n3, n5


WFO_ADJ = {141: ((0, -5),), 140: ((0, 5),), 144: ((0, -3),), 145: ((0, 3),),
           121: ((0, -4), (1, -3)), 122: ((0, 4), (1, 3)),
           123: ((0, 2), (1, 2), (2, 2)), 124: ((0, -2), (1, -2), (2, -2)),
           126: ((0, 9), (1, 3)), 125: ((0, -9), (1, -3)),
           148: ((0, -8),), 149: ((0, 8),)}


def adjust_first_order(res256: np.ndarray, wfo: np.ndarray) -> None:
    """q>HIGH1: apply residue codes to the saved first-order plane
    (encoder/nhw_encoder.c:1426-1496).  wfo: flat (IM_SIZE,) int16, indexed
    transposed ((j<<8)+r)."""
    rf = res256.reshape(-1)
    for r in range(D):
        for j in range(D - 2):
            code = int(rf[r * D + j])
            if code:
                base = (j << 8) + r
                for off, dv in WFO_ADJ.get(code, ()):
                    wfo[base + off] += dv


def build_positional_stream(res256: np.ndarray, codes: dict[int, tuple],
                            quality: int):
    """Shared res1/res3/res5 builder (encoder/nhw_encoder.c:1498-1635 and
    twins).  ``codes``: map code -> (word_value, replacement_code_or_0).
    Scans res256 row-major; column 254 emits the row marker 254 and zeroes
    the pair.  Returns (res_bytes, bit_bytes, word_bytes) as uint8 arrays
    (word packing width chosen by the caller via pack2).
    """
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        key = tuple(sorted(codes.items()))
        tabs = _POS_STREAM_TABS.get(key)
        if tabs is None:
            wt = np.full(256, -1, np.int32)
            rt = np.zeros(256, np.int16)
            for c, (w, repl) in codes.items():
                wt[c] = w
                rt[c] = repl
            tabs = _POS_STREAM_TABS[key] = (wt, rt)
        wt, rt = tabs
        pos = np.empty(SZ + 2 * D, np.int32)
        wrd = np.empty(SZ, np.int32)
        n_pos = ffi.new("long *")
        n_words = ffi.new("long *")
        lib.nhw_build_positional_stream(
            ffi.cast("int16_t *", res256.ctypes.data),
            ffi.cast("const int32_t *", wt.ctypes.data),
            ffi.cast("const int16_t *", rt.ctypes.data),
            ffi.cast("int32_t *", pos.ctypes.data), n_pos,
            ffi.cast("int32_t *", wrd.ctypes.data), n_words)
        return pos[: n_pos[0]].tolist(), wrd[: n_words[0]].tolist()

    rf = res256.reshape(-1)
    positions: list[int] = []
    words: list[int] = []

    for r in range(D):
        j = 0
        while j < D:
            scan = r * D + j
            if j == D - 2:
                rf[scan] = 0
                rf[scan + 1] = 0
                positions.append(D - 2)
                j += 2
                continue
            code = int(rf[scan])
            if code in codes:
                w, repl = codes[code]
                positions.append(j)
                rf[scan] = repl
                words.append(w)
            j += 1
    return positions, words


def dedupe_markers(positions: list[int]) -> list[int]:
    """Drop isolated 254 markers whose neighbours ascend
    (encoder/nhw_encoder.c:1552-1565)."""
    n = len(positions)
    out = [positions[0]]
    for i in range(1, n - 1):
        v = positions[i]
        if v == D - 2:
            if positions[i - 1] != D - 2 and positions[i + 1] != D - 2:
                if positions[i - 1] <= positions[i + 1]:
                    out.append(v)
            else:
                out.append(v)
        else:
            out.append(v)
    out.append(positions[n - 1])
    return out


def delta_pair_pack(deduped: list[int]) -> list[int]:
    """Pair-delta packing of the >>1 stream
    (encoder/nhw_encoder.c:1576-1592)."""
    sr = [v >> 1 for v in deduped]
    out = [sr[0]]
    i = 1
    n = len(sr)
    while i < n - 1:
        d1 = sr[i] - sr[i - 1]
        if 0 <= d1 < 8:
            d2 = sr[i + 1] - sr[i]
            if 0 <= d2 < 16:
                out.append(128 + (d1 << 4) + d2)
                i += 2
                continue
        out.append(sr[i])
        i += 1
    return out


def _pack_bits(vals: list[int], bits: int) -> tuple[np.ndarray, int]:
    """Pack LSBs of vals, 8/bits per byte, C's (len>>3)+1-block sizing."""
    y = len(vals) >> 3
    padded = vals + [0] * ((y << 3) + 8 - len(vals))
    out = []
    for i in range(0, (y << 3) + 8, 8):
        if bits == 1:
            b = 0
            for k in range(8):
                b = (b << 1) | (padded[i + k] & 1)
            out.append(b)
        else:  # 2-bit pairs -> two bytes per 8 entries
            b = 0
            for k in range(4):
                b = (b << 2) | (padded[i + k] & 3)
            out.append(b)
            b = 0
            for k in range(4, 8):
                b = (b << 2) | (padded[i + k] & 3)
            out.append(b)
    return np.array(out, np.uint8), len(out)


def finish_stream(positions: list[int], words: list[int], word_bits: int):
    """Marker dedupe + delta pack + bit/word planes; returns
    (res uint8, bit uint8, bit_len, word uint8) — the file sections."""
    from benchmark.reference import native

    if native.available() and positions:
        lib = native._load()
        ffi = native.ffi()
        pos = np.asarray(positions, np.int32)
        wrd = np.asarray(words, np.int32) if words \
            else np.empty(0, np.int32)
        res_out = np.empty(pos.size + 8, np.uint8)
        bit_out = np.empty((pos.size >> 3) + 8, np.uint8)
        word_out = np.empty(2 * ((wrd.size >> 3) + 8), np.uint8)
        n_res = ffi.new("long *")
        bit_len = ffi.new("long *")
        n_word = ffi.new("long *")
        lib.nhw_finish_stream(
            ffi.cast("const int32_t *", pos.ctypes.data), pos.size,
            ffi.cast("const int32_t *", wrd.ctypes.data), wrd.size,
            word_bits,
            ffi.cast("uint8_t *", res_out.ctypes.data), n_res,
            ffi.cast("uint8_t *", bit_out.ctypes.data), bit_len,
            ffi.cast("uint8_t *", word_out.ctypes.data), n_word)
        return (res_out[: n_res[0]].copy(), bit_out[: bit_len[0]].copy(),
                int(bit_len[0]), word_out[: n_word[0]].copy())

    deduped = dedupe_markers(positions)
    packed = delta_pair_pack(deduped)
    non_marker = [v for v in deduped if v != D - 2]
    bit_plane, _ = _pack_bits(non_marker, 1)
    bit_len = (len(non_marker) >> 3) + 1
    word_plane, _ = _pack_bits(words, word_bits)
    return (np.array(packed, np.uint8), bit_plane[:bit_len], bit_len,
            word_plane)
