# Frozen copy of nhwcodec_tpu_torch/host/models/encoder.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""NHW encode pipeline (bit-exact vs the reference nhw-enc).

Stage order mirrors encode_image (encoder/nhw_encoder.c:103-2878) but is
re-expressed array-first: the transforms, marking passes and scatter
nudges are vectorized plane programs (ops.analysis / ops.requant), while
the raster-carried passes (residue ladders, quantizer duty cycles, stream
builders) replay sequentially on host — see the ops modules for the
file:line behavior contracts.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T
from benchmark.reference.ops import (analysis, colorspace, ll2, quantize, requant,
                              residue)

D = 256
N = 512
SZ = 65536


class EncoderState:
    """Mutable encode state: the two working planes + emitted sections."""

    def __init__(self, quality: int, ratio: int = 8):
        self.q = quality
        self.ratio = ratio
        self.sections: dict[str, np.ndarray | int | list] = {}


def _res_setting(q: int) -> int:
    if q >= T.NORM:
        return 3
    if q >= T.LOW2:
        return 4
    if q >= T.LOW5:
        return 6
    return 8


def _band_snap_pass(pf: np.ndarray, rows: range, col0: int, col1: int,
                    ratio_thr: int, y_wavelet: int, y_wavelet2: int,
                    second_rule: bool, snap_guard6: bool,
                    guard_col: int | None = None) -> None:
    """Shared coefficient snap/dead-zone pass
    (encoder/nhw_encoder.c:1923-2098, three band variants).

    Positions below the threshold are zeroed in visit order; the pair
    fixups only ever write to above-threshold positions, so the gaps
    between candidates hold their initial values until visited and can be
    zeroed in vectorized spans as the scan passes them."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_snap_pass(
            ffi.cast("int16_t *", pf.ctypes.data), rows.start, rows.stop,
            col0, col1, ratio_thr, y_wavelet, y_wavelet2,
            1 if second_rule else 0, 1 if snap_guard6 else 0,
            guard_col if guard_col is not None else col1 - 1)
        return

    plane = pf[: 4 * SZ].reshape(N, N)
    region = plane[rows.start: rows.stop, col0: col1]
    alive = np.abs(region) >= ratio_thr
    gc = guard_col if guard_col is not None else col1 - 1

    for rr in range(region.shape[0]):
        base = (rows.start + rr) * N
        cols = np.nonzero(alive[rr])[0]
        prev = col0
        for j0 in cols.tolist():
            j = col0 + int(j0)
            if prev < j:
                pf[base + prev: base + j] = 0
            prev = j + 1
            a = base + j
            v = int(pf[a])
            if abs(v) < y_wavelet2:
                cnt = 0
                if abs(int(pf[a - 1])) + 2 >= 8:
                    cnt += 1
                if abs(int(pf[a + 1])) + 2 >= 8:
                    cnt += 1
                if abs(int(pf[a - N])) + 2 >= 8:
                    cnt += 1
                if abs(int(pf[a + N])) + 2 >= 8:
                    cnt += 1
                if cnt < 3 and -y_wavelet < v < y_wavelet:
                    if snap_guard6:
                        if v < -6:
                            pf[a] = -7
                        elif v > 6:
                            pf[a] = 7
                    else:
                        pf[a] = -7 if v < 0 else 7
                elif second_rule and not cnt and abs(v) < y_wavelet2:
                    pf[a] = -7 if v < 0 else 7

            e = int(pf[a])
            if abs(e) > 6:
                if e >= 8 and (e & 7) < 2:
                    if 7 < int(pf[a + 1]) < 10000:
                        pf[a + 1] -= 1
                elif e == -7 and pf[a + 1] == 8:
                    pf[a] = -8
                elif e == 8 and pf[a + 1] == -7:
                    pf[a + 1] = -8
                elif e < -7 and ((-e) & 7) < 2:
                    n1 = int(pf[a + 1])
                    if n1 < -14 and n1 < 10000:
                        if ((-n1) & 7) == 7:
                            pf[a + 1] = n1 + 1
                        elif ((-n1) & 7) < 2 and j < gc \
                                and int(pf[a + 2]) <= 0:
                            pf[a + 1] = n1 + 1
        if prev < col1:
            pf[base + prev: base + col1] = 0


def _tree1_tail(yplane: np.ndarray, quality: int, offset: int):
    """Bytes the reference reads past its tree1 allocation.

    The tree1 chunk's tail content depends on where malloc places it:
    for some images it aliases the freed nhw_kernel data, for others it
    is untouched heap (zero under the deterministic zero-fill contract)
    — the placement itself shifts with image content, so no single
    emulation reproduces every case.  The reads are value-dead: the only
    bytes they reach are boundary escape literals whose decoded value
    the DC automaton overwrites (bit 7 is the only live bit, masked by
    utils.container.discarded_escape_positions) — so the zero tail is
    used, which matches the deterministic reference everywhere except
    inside that masked class."""
    return None


def encode_y(yplane: np.ndarray, quality: int, ratio: int = 8,
             y_original: np.ndarray | None = None, pre=None,
             requant_done: bool = False):
    """Y pipeline: (512,512) int16 pre-processed luma -> quantized
    serpentine stream + all Y side sections.  Returns (im_nhw, sections).
    ``y_original``: the un-prefiltered luma (the reference's heap-tail
    kernel aliasing reads derive from it, see _tree1_tail).
    ``pre``: optional device-computed transform state (jpeg, process,
    res256, snap) from models.device_stages.analysis_y — bit-identical
    to the host analysis below; the host scans continue from it.
    ``requant_done``: the caller already ran the requant feedback block
    (host mark + offset part=1, then models.device_requant's fused tail)
    and ``pre`` holds the post-block state.
    """
    q = quality
    if y_original is None:
        y_original = yplane
    sec: dict = {}
    if pre is not None:
        jpeg, process, res256, snap = pre
        # np.array: the host scans mutate these in place (device-exported
        # buffers are read-only views)
        jpeg = np.array(jpeg, np.int16)
        process = np.array(process, np.int16)
        res256 = np.array(res256, np.int16)
        snap = (None if snap is None
                else np.array(snap, np.int16).reshape(-1))
    else:
        jpeg = yplane.astype(np.int16).copy()
        process = np.zeros((N, N), np.int16)

        snap = analysis.wavelet_analysis(jpeg, process, N, 0, 0,
                                         snapshot=q > T.HIGH1)
        res256 = jpeg[:D, :D].copy()
        analysis.wavelet_analysis(jpeg, process, D, 1, 0)

    if q > T.LOW14 and not requant_done:
        requant.mark_res256(process, res256)
        requant.offset_y_recons256(jpeg, process, q, ratio, part=1)
        analysis.wavelet_synthesis(jpeg, process, D, 0)
        requant.unmark_res256(process, res256)
        requant.requant_scan_ladder(jpeg, process, res256)
        analysis.wavelet_analysis(jpeg, process, D, 1, 0)

    pf = process.reshape(-1)

    if q <= T.LOW9:
        _low_q_ll1_cleanup(pf, q, ratio)
    if q < T.LOW7:
        _very_low_q_cleanup(pf, q, ratio)

    resIII = process[:D, :D].copy()

    tree1_y, ch_res_y, exw, res4 = ll2.ll2_code_y(process, q)
    sec["exw_Y"] = exw
    if q > T.LOW3:
        sec["res4"] = np.array(res4, np.uint8)

    hrcomp, res_low, hr_word, hr_mem = ll2.y_highres_compression(
        tree1_y, ch_res_y, q, tail=_tree1_tail(y_original, q, 0))
    sec["res_low"] = res_low
    sec["highres_word"] = np.array(hr_word, np.uint8)
    sec["hrcomp_y"] = hrcomp
    sec["tree1_y"] = tree1_y

    process[:D, :D] = resIII

    wfo = None
    if q > T.LOW8:
        ht_out: list = []
        requant.offset_y_recons256(
            jpeg, process, q, ratio, part=0,
            highres_mem=np.array(hr_mem, np.int64),
            highres_tmp_out=ht_out)
        if ht_out:
            sec["_highres_tmp"] = ht_out[0]
        analysis.wavelet_synthesis(jpeg, process, D, 0)
        if q > T.HIGH1:
            wfo = np.empty(SZ, np.int16)
            wfo.reshape(D, D)[:] = jpeg[:D, :D]
            wfo = wfo.reshape(-1)

    if T.LOW5 < q < T.NORM:
        _mid_q_band_cleanup(pf, ratio)
    elif T.LOW6 <= q <= T.LOW5:
        _low56_band_cleanup(pf, q, ratio)
    elif q < T.LOW6:
        _lowest_q_band_cleanup(pf, resIII, q, ratio, tree1_y,
                               y_original)

    if q > T.LOW4:
        _pair_promotion(pf, q)

    res_setting = _res_setting(q)
    if q > T.LOW8:
        # the res256 chunk slack aliases the freed kernel's row-128 head
        # up to q=HIGH1; the q>HIGH1 first-order-plane allocation shifts
        # the layout and leaves untouched (zero-filled) heap there
        if q <= T.HIGH1:
            from benchmark.reference.ops import prefilter

            kern = (prefilter.final_low_kernel(y_original, q)
                    if q <= T.LOW4 else prefilter.kernel_for(y_original, q))
            khead = np.asarray(kern).reshape(-1)[65536:65540].astype(
                np.int16)
        else:
            khead = None
        residue.res256_column_ladder(process, res256, q, res_setting,
                                     resIII, kernel_head=khead)
        n1, n3, n5 = residue.res256_classify(process, res256, q, res_setting)

    if q > T.HIGH1 and wfo is not None:
        residue.adjust_first_order(res256, wfo)
        if _CAPTURE_WFO:
            global _LAST_WFO
            _LAST_WFO = wfo.copy()

    if q > T.LOW8:
        pos, words = residue.build_positional_stream(
            res256, {141: (1, 0), 140: (0, 0), 126: (0, 122), 125: (1, 121),
                     148: (1, 144), 149: (0, 145)}, q)
        r1, r1bit, r1bitlen, r1word = residue.finish_stream(pos, words, 1)
        sec["res1"] = r1
        sec["res1_bit"] = r1bit
        sec["res1_word"] = r1word[: (len(words) >> 3) + 1]

    if q >= T.LOW1:
        pos, words = residue.build_positional_stream(
            res256, {121: (1, 0), 122: (0, 0), 123: (2, 0), 124: (3, 0)}, q)
        r3, r3bit, r3bitlen, r3word = residue.finish_stream(pos, words, 2)
        sec["res3"] = r3
        sec["res3_bit"] = r3bit
        sec["res3_word"] = r3word[: 2 * ((len(words) >> 3) + 1)]

    if q >= T.HIGH1:
        pos, words = residue.build_positional_stream(
            res256, {144: (1, 0), 145: (0, 0)}, q)
        r5, r5bit, r5bitlen, r5word = residue.finish_stream(pos, words, 1)
        sec["res5"] = r5
        sec["res5_bit"] = r5bit
        sec["res5_word"] = r5word[: (len(words) >> 3) + 1]

    # rebuild the level-2 quadrant: LL2 keeps only >8000 codes
    # (encoder/nhw_encoder.c:1893-1910)
    block = resIII.copy()
    ll2_zone = block[:128, :128]
    ll2_zone[ll2_zone <= 8000] = 0
    process[:D, :D] = block

    # snap/dead-zone passes (1914-2098)
    if q > T.HIGH2:
        yw, yw2 = 8, 4
    else:
        yw, yw2 = 9, 9
    _band_snap_pass(pf, range(1, 255), D + 1, 2 * D - 1, ratio - 2, yw, yw2,
                    second_rule=False, snap_guard6=True)

    if q > T.HIGH2:
        yw, yw2 = 8, 4
    elif q > T.LOW3:
        yw, yw2 = 8, 9
    else:
        yw, yw2 = 9, 9
    _band_snap_pass(pf, range(D, 511), 1, D, ratio - 2, yw, yw2,
                    second_rule=True, snap_guard6=False, guard_col=D - 2)

    yw = 8 if q > T.HIGH2 else 11
    _band_snap_pass(pf, range(D, 511), D + 1, 2 * D - 1, ratio - 1, yw, yw,
                    second_rule=False, snap_guard6=False)

    quantize.offset_y(process, q, ratio)

    hq = None
    if q > T.HIGH1:
        band = requant.im_recons_wavelet_band(process)
        hq = _hq_residue(snap, wfo, band, q)
        sec.update(hq)

    im_nhw = quantize.serpentine_y(process)
    quantize.merge_crossing_codes(im_nhw)
    sel1, sel2 = quantize.select_codes(im_nhw)
    quantize.cap_long_runs(im_nhw)
    sec["nhw_select1"] = sel1
    sec["nhw_select2"] = sel2
    return im_nhw, sec


def _hq_residue(snap, wfo, band, q):
    """q>HIGH1 residue streams res6/char_res1/qsetting3
    (encoder/wavelet_filterbank.c:498-707): half-synthesize the saved
    first-order LL + dequantized band, diff vs the analysis snapshot,
    emit positional corrections."""
    from benchmark.reference.ops.lifting import synth_unnorm

    wfo2 = wfo.reshape(D, D)
    band2 = band.reshape(D, D)
    whs = synth_unnorm(wfo2, band2).reshape(-1).astype(np.int16)

    thr = 30 if q > T.HIGH2 else 34
    diff = snap.astype(np.int32) - whs.astype(np.int32)
    marks = np.zeros(2 * SZ, np.int32)
    qset3: list[int] = []
    if q > T.HIGH2:
        big = np.abs(diff) > 56
        sel = (np.abs(diff) > thr) & big
        marks[sel] = np.where(diff[sel] > 0, 32000, 32500)
    sel2 = (np.abs(diff) > thr) & (marks == 0)
    marks[sel2] = np.where(diff[sel2] > 0, 30000, 31000)

    if q > T.HIGH2:
        for i in np.nonzero((marks == 32000) | (marks == 32500))[0].tolist():
            qset3.append((i << 1) + (1 if marks[i] == 32500 else 0))

    positions: list[int] = []
    words: list[int] = []
    char_res1: list[int] = []
    for row in range(D):
        base = row * N
        j = 0
        while j < N:
            scan = base + j
            if j == D - 2 or j == N - 2:
                positions.append(D - 2)
                if j == D - 2:
                    m = int(marks[scan])
                    if m == 30000:
                        char_res1.append(base >> 1)
                    elif m == 31000:
                        char_res1.append((base >> 1) + 1)
                    m = int(marks[scan + 1])
                    if m == 30000:
                        char_res1.append((base >> 1) + 2)
                    elif m == 31000:
                        char_res1.append((base >> 1) + 3)
                j += 2
                continue
            m = int(marks[scan])
            if m == 30000:
                positions.append(j & 255)
                words.append(0)
            elif m == 31000:
                positions.append(j & 255)
                words.append(1)
            j += 1

    r6, r6bit, bit_len, r6word = residue.finish_stream(positions, words, 1)
    out = {
        "res6": r6,
        "res6_bit": r6bit,
        "res6_word": r6word[: (len(words) >> 3) + 1],
        "char_res1": np.array(char_res1, np.uint16),
    }
    if q > T.HIGH2:
        out["qsetting3"] = np.array(qset3, np.uint32)
    return out


# ---------------------------------------------------------------------------
# low-quality cleanup ladders (encoder/nhw_encoder.c:285-621, 783-968)
# implemented with the quality sweep milestone


def _low_q_ll1_cleanup(pf, q, ratio):
    """q<=LOW9 isolated-coefficient zeroing in the lower LL1 half
    (encoder/nhw_encoder.c:285-309)."""
    x1 = 10 if q > T.LOW14 else 11

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_low_q_ll1_cleanup(
            ffi.cast("int16_t *", pf.ctypes.data), x1, ratio)
        return

    for r in range(128, 256):
        base = r * N
        for j in range(D):
            scan = base + j
            v = abs(int(pf[scan]))
            if ratio <= v < x1:
                if abs(int(pf[scan - 1])) < ratio \
                        and abs(int(pf[scan + 1])) < ratio:
                    pf[scan] = 0
                elif v == ratio:
                    if abs(int(pf[scan - 1])) < ratio \
                            or abs(int(pf[scan + 1])) < ratio:
                        pf[scan] = 0


def _VLQ_THRX(q, pf):
    if q == T.LOW8:
        return (8, 13, 6, 11, 34, 14, 15)
    if T.LOW12 <= q <= T.LOW9:
        return (8, 13, 6, 11, 34, 15, 15)
    if q == T.LOW13:
        return (10, 15, 9, 14, 36, 17, 17)
    if T.LOW16 <= q <= T.LOW14:
        return (11, 15, 10, 15, 36, 17, 17)
    if q == T.LOW17:
        return (11, 15, 10, 15, 36, 18, 18)
    if q == T.LOW18:
        return (11, 15, 10, 15, 36, 19, 20)
    return (11, 15, 10, 15, 36, 20, 21)  # LOW19


def _vlq_zero_bands(pf, count_pos, x5, x6, q, e34=False):
    """Zero small coefficients at the transposed band positions of one LL2
    column (encoder/nhw_encoder.c:417-431 shape)."""
    c2 = count_pos << 1
    for off in (D, D + 1, 3 * D, 3 * D + 1):
        if abs(int(pf[c2 + off])) < x6:
            pf[c2 + off] = 0
    for off in (2 * SZ, 2 * SZ + 1, 2 * SZ + N, 2 * SZ + N + 1):
        if abs(int(pf[c2 + off])) < x6 + 6:
            pf[c2 + off] = 0
    e = 2 * SZ + D
    thr = 34 if e34 else x5
    for off in (e, e + 1, e + N, e + N + 1):
        if abs(int(pf[c2 + off])) < thr:
            pf[c2 + off] = 0


def _vlq_zero_l2(pf, count_pos):
    """q<=LOW9 level-2 band zeroing (encoder/nhw_encoder.c:436-441)."""
    if abs(int(pf[count_pos + 128])) < 11:
        pf[count_pos + 128] = 0
    if abs(int(pf[count_pos + SZ])) < 12:
        pf[count_pos + SZ] = 0
    if abs(int(pf[count_pos + SZ + 128])) < 13:
        pf[count_pos + SZ + 128] = 0


def _very_low_q_cleanup(pf, q, ratio):
    """q<LOW7 LL2 window smoothing + band zeroing ladders
    (encoder/nhw_encoder.c:311-621)."""
    x1, x2, x3, x4, x5, x6, x7 = _VLQ_THRX(q, pf)

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_very_low_q_cleanup(
            ffi.cast("int16_t *", pf.ctypes.data),
            1 if q <= T.LOW9 else 0, x1, x2, x3, x4, x5, x6, x7)
        return

    # C shares one `count` local across passes 1-3; pass 3's q<=LOW9
    # block can consume a stale value (nhw_encoder.c:571-579)
    carry = 0

    # pass 1: 4-px horizontal windows in LL2 rows (383-486)
    for r in range(128):
        base = r * N
        for j in range(124):
            scan = base + j
            p0 = int(pf[scan])
            p1 = int(pf[scan + 1])
            p2 = int(pf[scan + 2])
            p3 = int(pf[scan + 3])
            p4 = int(pf[scan + 4])
            if abs(p4 - p0) < x1 and abs(p4 - p3) < x1 \
                    and abs(p1 - p0) < x1 and abs(p3 - p1) < x1 \
                    and abs(p3 - p2) < x2 - 2:
                if p3 - p1 > 5 and p2 - p3 >= 0:
                    pf[scan + 2] = p3
                elif p1 - p3 > 5 and p2 - p3 <= 0:
                    pf[scan + 2] = p3
                elif p1 - p3 > 5 and p2 - p1 >= 0:
                    pf[scan + 2] = p1
                elif p3 - p1 > 5 and p2 - p1 <= 0:
                    pf[scan + 2] = p1
                elif p3 - p2 > 0 and p2 - p1 > 0:
                    pass
                elif p1 - p2 > 0 and p2 - p3 > 0:
                    pass
                else:
                    pf[scan + 2] = (p3 + p1) >> 1
                for cnt in range(1, 4):
                    _vlq_zero_bands(pf, scan + cnt, x5, x6, q)
                carry = 4
                if q <= T.LOW9:
                    for cnt in range(1, 4):
                        _vlq_zero_l2(pf, scan + cnt)
            elif abs(p4 - p0) < x2 + 1 and abs(p4 - p3) < x2 + 1 \
                    and abs(p1 - p0) < x2 + 1:
                if abs(p3 - p1) < x2 + 6 and abs(p3 - p2) < x2 + 6:
                    if (p3 - p2 >= 0 and p2 - p1 >= 0) \
                            or (p3 - p2 <= 0 and p2 - p1 <= 0):
                        for cnt in range(1, 4):
                            _vlq_zero_bands(pf, scan + cnt, x5, x6, q)
                        carry = 4
                        if q <= T.LOW9:
                            for cnt in range(1, 4):
                                _vlq_zero_l2(pf, scan + cnt)

    # pass 2: vertical cross windows (488-533)
    for r in range(126):
        base = r * N
        for j in range(126):
            scan = base + j
            if abs(int(pf[scan + 1]) - int(pf[scan + 4 * D + 1])) < x3 \
                    and abs(int(pf[scan + 2 * D])
                            - int(pf[scan + 2 * D + 2])) < x3:
                if abs(int(pf[scan + 2 * D + 1])
                       - int(pf[scan + 2 * D])) < x4 - 1 \
                        and abs(int(pf[scan + 1])
                                - int(pf[scan + 2 * D + 1])) < x4:
                    e = (int(pf[scan + 1]) + int(pf[scan + 4 * D + 1])
                         + int(pf[scan + 2 * D])
                         + int(pf[scan + 2 * D + 2]) + 2) >> 2
                    if abs(e - int(pf[scan + 2 * D])) < 5 \
                            or abs(e - int(pf[scan + 2 * D + 2])) < 5:
                        pf[scan + 2 * D + 1] = e
                    carry = scan + 2 * D + 1
                    _vlq_zero_bands(pf, carry, 32, x6, q, e34=False)
                    if q <= T.LOW9:
                        for e2 in range(3):
                            _vlq_zero_l2(pf, carry + e2 - 1)

    # pass 3: second cross variant (535-583)
    for r in range(126):
        base = r * N
        for j in range(126):
            scan = base + j
            if abs(int(pf[scan + 2]) - int(pf[scan + 1])) < x3 \
                    and abs(int(pf[scan + 1]) - int(pf[scan])) < x3:
                if abs(int(pf[scan]) - int(pf[scan + 2 * D])) < x3 \
                        and abs(int(pf[scan + 2])
                                - int(pf[scan + 2 * D + 2])) < x3:
                    if abs(int(pf[scan + 4 * D + 1])
                           - int(pf[scan + 2 * D])) < x3 \
                            and abs(int(pf[scan + 2 * D])
                                    - int(pf[scan + 2 * D + 1])) < x4:
                        e = (int(pf[scan + 1]) + int(pf[scan + 4 * D + 1])
                             + int(pf[scan + 2 * D])
                             + int(pf[scan + 2 * D + 2]) + 1) >> 2
                        if abs(e - int(pf[scan + 2 * D])) < 5 \
                                or abs(e - int(pf[scan + 2 * D + 2])) < 5:
                            pf[scan + 2 * D + 1] = e
                        carry = scan + 2 * D + 1
                        _vlq_zero_bands(pf, carry, 32, x6, q, e34=False)
                    if q <= T.LOW9:
                        for e2 in range(3):
                            _vlq_zero_l2(pf, carry + e2 - 1)

    # pass 4: q<=LOW9 3-px flats (585-620)
    if q <= T.LOW9:
        for r in range(128):
            base = r * N
            for j in range(126):
                scan = base + j
                if abs(int(pf[scan + 2]) - int(pf[scan + 1])) < x7 \
                        and abs(int(pf[scan + 2]) - int(pf[scan])) < x7 \
                        and abs(int(pf[scan + 1]) - int(pf[scan])) < x7:
                    cnt = scan + 1
                    _vlq_zero_bands(pf, cnt, 34, x6, q, e34=True)
                    _vlq_zero_l2(pf, cnt)


def _mid_q_band_cleanup(pf, ratio):
    """LOW5<q<NORM: snap small lower-half coefficients to +-7
    (encoder/nhw_encoder.c:785-803).  Pure vector pass."""
    lower = pf[2 * SZ:].reshape(D, 2 * D)
    left = lower[:, :D]
    av = np.abs(left)
    m = (av >= ratio) & (av < 9)
    left[m] = np.where(left[m] > 0, 7, -7)
    right = lower[:, D:]
    av = np.abs(right)
    m = (av >= ratio) & (av <= 14)
    right[m] = np.where(right[m] > 0, 7, -7)


def _low56_band_cleanup(pf, q, ratio):
    """q in (LOW5, LOW6): dead-zone the lower half
    (encoder/nhw_encoder.c:804-832).  Pure vector pass."""
    thrx2 = 19 if q == T.LOW5 else 20
    lower = pf[2 * SZ:].reshape(D, 2 * D)
    left = lower[:, :D]
    av = np.abs(left)
    left[(av >= ratio) & (av < 11)] = 0
    right = lower[:, D:]
    av = np.abs(right)
    m = (av >= ratio) & (av < thrx2)
    right[m] = np.where(right[m] >= 14, 7,
                        np.where(right[m] <= -14, -7, 0))


def _lowest_q_xs(pf, q):
    """Count-adaptive thresholds for the q<LOW6 band cleanup
    (encoder/nhw_encoder.c:843-878): the LOW7 tuple is fixed; below
    that the lower-half population >= 12 picks the base tuple, with
    LOW9/LOW10- additive bumps."""
    if q == T.LOW7:
        return 15, 27, 10, 6, 3
    x1, x2, x3, x4, x5 = 16, 28, 11, 8, 5
    count = int(np.count_nonzero(
        np.abs(pf[2 * SZ: 4 * SZ]) >= 12))
    if count > 12500:
        x1, x2, x3, x4, x5 = 19, 31, 13, 9, 6
    elif count > 10000:
        x1, x2, x3, x4, x5 = 18, 30, 12, 8, 6
    elif count >= 7000:
        x1, x2, x3, x4, x5 = 17, 29, 11, 8, 5
    if q == T.LOW9:
        if count > 12500:
            x1 += 1
            x2 += 1
            x3 += 1
            x4 += 1
            x5 += 1
        else:
            x1 += 1
    elif q <= T.LOW10:
        if count > 12500:
            x1 += 3
            x2 += 3
            x3 += 2
            x4 += 3
            x5 += 3
        else:
            x1 += 3
            x2 += 2
            x3 += 2
            x4 += 2
            x5 += 2
    return x1, x2, x3, x4, x5


def _lowest_q_band_cleanup(pf, resIII, q, ratio, tree1_y=None,
                           y_original=None):
    """q<LOW6 band dead-zoning with count-adaptive thresholds
    (encoder/nhw_encoder.c:833-968).  resIII: flat level-2 snapshot.

    The last plane row reads resIII past its allocation; that address
    aliases the live tree1 chunk: 4 leftover shorts of the freed
    nhw_kernel buffer (kernel[131080:131084] — resIII reuses the freed
    kernel chunk, and the next chunk's prev_size field keeps the old
    data), the chunk size field 24593, and tree1's LL2 code bytes as
    int16 pairs — all reproduced here."""
    x1, x2, x3, x4, x5 = _lowest_q_xs(pf, q)
    oob = np.zeros(256, np.int16)
    if y_original is not None:
        from benchmark.reference.ops import prefilter

        kern = prefilter.final_low_kernel(y_original, q).astype(np.int16)
        oob[0:4] = kern.reshape(-1)[131080:131084]
    oob[4] = 24593  # the tree1 chunk's size field
    if tree1_y is not None:
        t = tree1_y[:496].astype(np.uint16)
        oob[8:8 + 248] = (t[0::2] | (t[1::2] << 8)
                          ).astype(np.uint16).view(np.int16)
    r3 = np.concatenate([resIII.reshape(-1), oob])

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        r3c = np.ascontiguousarray(r3, np.int16)
        lib.nhw_lowest_q_band_cleanup(
            ffi.cast("int16_t *", pf.ctypes.data),
            ffi.cast("int16_t *", r3c.ctypes.data),
            ratio, 1 if q > T.LOW10 else 0, x1, x2, x3, x4, x5)
        return

    for r in range(D):
        base = r * N
        i = base
        for j in range(D, 2 * D):
            scan = base + j
            v = int(pf[scan])
            if ratio <= abs(v) < x3 + 2:
                if abs(int(r3[(((i >> 1) + (j - D)) >> 1) + 128])) < x4:
                    pf[scan] = 0
                elif abs(v + int(pf[scan - 1])) < x5                         and abs(int(pf[scan + 1])) < x5:
                    pf[scan] = 0
                    pf[scan - 1] = 0
                elif abs(v + int(pf[scan + 1])) < x5                         and abs(int(pf[scan - 1])) < x5:
                    pf[scan] = 0
                    pf[scan + 1] = 0
            v = int(pf[scan])
            if ratio <= abs(v) < x3:
                if abs(int(pf[scan - 1])) < ratio                         and abs(int(pf[scan + 1])) < ratio:
                    pf[scan] = 0

    for r in range(D, 2 * D):
        base = r * N
        i = base - 2 * SZ  # C: i - 2*IM_SIZE
        for j in range(D):
            scan = base + j
            v = int(pf[scan])
            if ratio <= abs(v) < x1 + 2:
                if abs(int(r3[(((i >> 1) + j) >> 1) + (SZ >> 1)])) < x4:
                    pf[scan] = 0
                elif abs(v + int(pf[scan - 1])) < x5                         and abs(int(pf[scan + 1])) < x5:
                    pf[scan] = 0
                    pf[scan - 1] = 0
                elif abs(v + int(pf[scan + 1])) < x5                         and abs(int(pf[scan - 1])) < x5:
                    pf[scan] = 0
                    pf[scan + 1] = 0
            v = int(pf[scan])
            if ratio <= abs(v) < x1:
                if abs(int(pf[scan - 1])) < ratio                         and abs(int(pf[scan + 1])) < ratio:
                    pf[scan] = 0
                elif abs(v) < x1 - 4:
                    pf[scan] = 0
        for j in range(D, 2 * D - 1):
            scan = base + j
            v = int(pf[scan])
            if ratio <= abs(v) < x2 + 1:
                if abs(int(r3[(((i >> 1) + (j - D)) >> 1)
                              + (SZ >> 1) + 128])) < x4 + 1:
                    pf[scan] = 0
                elif abs(v + int(pf[scan - 1])) < x5                         and abs(int(pf[scan + 1])) < x5:
                    pf[scan] = 0
                    pf[scan - 1] = 0
                elif abs(v + int(pf[scan + 1])) < x5                         and abs(int(pf[scan - 1])) < x5:
                    pf[scan] = 0
                    pf[scan + 1] = 0
            v = int(pf[scan])
            if ratio <= abs(v) < x2:
                if abs(int(pf[scan - 1])) < ratio                         and abs(int(pf[scan + 1])) < ratio:
                    if q > T.LOW10:
                        if v >= 16:
                            pf[scan] = 7
                        elif v <= -16:
                            pf[scan] = -7
                        else:
                            pf[scan] = 0
                    else:
                        pf[scan] = 0
                elif abs(v) < x2 - 5:
                    if q > T.LOW10:
                        if v >= 16:
                            pf[scan] = 7
                        elif v <= -16:
                            pf[scan] = -7
                        else:
                            pf[scan] = 0
                    else:
                        pf[scan] = 0


def _pair_promotion(pf: np.ndarray, q: int) -> None:
    """Paired-code promotion to sentinels 10100-12900
    (encoder/nhw_encoder.c:970-1074)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_pair_promotion(ffi.cast("int16_t *", pf.ctypes.data))
        return

    # HL band: rows 1..254, cols 257..510
    for r in range(1, 255):
        base = r * N
        for j in range(D + 1, 2 * D - 1):
            a = base + j
            v = int(pf[a])
            if 4 < v < 8:
                if 3 < int(pf[a - 1]) <= 7 and 3 < int(pf[a + 1]) <= 7:
                    pf[a] = 12700
                    pf[a - 1] = 10100
                    pf[a + 1] = 10100
            elif -8 < v < -4:
                if -8 < int(pf[a - 1]) <= -4 and -8 < int(pf[a + 1]) <= -4:
                    pf[a] = 12900
                    pf[a - 1] = 10100
                    pf[a + 1] = 10100
            elif v == -7 and int(pf[a + 1]) in (-6, -7):
                pf[a] = 10204
                pf[a + 1] = 10100
            elif v == 7 and pf[a + 1] == 7:
                pf[a] = 10300
                pf[a + 1] = 10100
            elif v == 8:
                if (int(pf[a - 1]) & 65534) == 6 \
                        or (int(pf[a + 1]) & 65534) == 6:
                    pf[a] = 10
                elif pf[a + 1] == 8:
                    pf[a] = 9
                    pf[a + 1] = 9
            elif v == -8:
                if ((-int(pf[a - 1])) & 65534) == 6 \
                        or ((-int(pf[a + 1])) & 65534) == 6:
                    pf[a] = -9
                elif pf[a + 1] == -8:
                    pf[a] = -9
                    pf[a + 1] = -9

    # lower half: rows 257..510, cols 1..254
    for r in range(257, 511):
        base = r * N
        for j in range(1, D - 1):
            a = base + j
            v = int(pf[a])
            if 4 < v < 8:
                if 3 < int(pf[a - 1]) <= 7 and 3 < int(pf[a + 1]) <= 7:
                    pf[a] = 12700
                    pf[a - 1] = 10100
                    pf[a + 1] = 10100
            elif -8 < v < -4:
                if -8 < int(pf[a - 1]) <= -4 and -8 < int(pf[a + 1]) <= -4:
                    pf[a] = 12900
                    pf[a - 1] = 10100
                    pf[a + 1] = 10100
            elif v in (-6, -7):
                if pf[a + 1] == -7:
                    pf[a] = 10204
                    pf[a + 1] = 10100
                elif pf[a - N] == -7:
                    if abs(int(pf[a + D])) < 8:
                        pf[a + D] = 10204
                    pf[a] = 10100
            elif v == 7:
                if pf[a + 1] == 7:
                    pf[a] = 10300
                    pf[a + 1] = 10100
                elif pf[a - N] == 7:
                    if abs(int(pf[a + D])) < 8:
                        pf[a + D] = 10300
                    pf[a] = 10100
            elif v == 8:
                if (int(pf[a - 1]) & 65534) == 6 \
                        or (int(pf[a + 1]) & 65534) == 6:
                    pf[a] = 10
            elif v == -8:
                if ((-int(pf[a - 1])) & 65534) == 6 \
                        or ((-int(pf[a + 1])) & 65534) == 6:
                    pf[a] = -9


_V_OFF_OVERRIDE: int | None = None  # diagnostics: res256 slack reseat
_U_OFF_OVERRIDE: int | None = None
# diagnostics: capture the q>HIGH1 first-order plane (the third slack
# placement's V-chunk one-past reads alias its interior at a layout-
# fixed offset — wave 55's combo traced to wfo[32160]); the fuzz
# classifier flips this on to derive placement-probe tails
_CAPTURE_WFO: bool = False
_LAST_WFO: np.ndarray | None = None
# diagnostics: explicit V-chunk slack shorts (the third observed
# placement — the chunk lands so its one-past read hits first-order-
# plane content, small positive values; see VALIDATION.md)
_V_TAIL_OVERRIDE: np.ndarray | None = None


class DeferredEncode:
    """An encode with every host stage done and only the Huffman bit
    packing pending — finish_deferred() packs a batch of these in ONE
    device program (ops.entropy_device._pack_rows)."""

    __slots__ = ("quality", "sections", "tokens")

    def __init__(self, quality, sections, tokens):
        self.quality = quality
        self.sections = sections
        self.tokens = tokens


def _assemble_packet(q: int, sec: dict, pk) -> bytes:
    from benchmark.reference.utils import container

    sec["tree1"] = pk.tree1
    sec["tree2"] = pk.tree2
    sec["tree_end"] = pk.tree_end
    sec["size_data1"] = pk.size_data1
    sec["size_data2"] = pk.size_data2
    sec["select_word1"] = pk.select_word1
    sec["select_word2"] = pk.select_word2
    sec["nhw_select1"] = pk.nhw_select1
    sec["nhw_select2"] = pk.nhw_select2
    sec["encode"] = pk.encode_words
    return container.write_nhw(q, sec["res_low"], pk.wavelet_type, sec)


def encode_from_planes(yplane: np.ndarray, u8u: np.ndarray,
                       u8v: np.ndarray, quality: int,
                       y_original: np.ndarray | None = None,
                       pre_y=None, pre_u=None, pre_v=None,
                       requant_done: bool = False,
                       defer_pack: bool = False) -> bytes | DeferredEncode:
    """Full encode given the (possibly pre-processed) Y plane and the
    downsampled chroma planes — everything after colorspace/pre-filter
    (encoder/nhw_encoder.c:121-2878 + write_compressed_file).
    ``pre_y``/``pre_u``/``pre_v``: device-computed transform states
    (models.device_stages) — the host scans consume them directly.
    ``defer_pack``: return a DeferredEncode (tokenized, bit packing
    pending) for batched device packing via finish_deferred()."""
    from benchmark.reference.ops import entropy_enc
    from benchmark.reference.utils import container

    q = quality
    ratio = 8
    if y_original is None:
        y_original = yplane
    im_nhw, sec = encode_y(yplane, q, ratio, y_original, pre=pre_y,
                           requant_done=requant_done)

    # what the reference's compare ladder reads one short past its
    # res256 chunk: the chunk slack aliases the U plane's bytes at flat
    # offset 32768 (U, and V at q<=LOW5), or the Y LL2 snapshot value
    # highres_tmp[8192] when the q>LOW5 highres path ran in between
    uf = np.ascontiguousarray(u8u, np.uint8).reshape(-1)
    u_off = 32768 if _U_OFF_OVERRIDE is None else _U_OFF_OVERRIDE
    oob_u = int(np.uint16(int(uf[u_off])
                          | (int(uf[u_off + 1]) << 8)).view(np.int16))
    sec.pop("_highres_tmp", None)
    # malloc traces of the reference (plain binary, zero-filled heap,
    # layout-preserving logging preload — VALIDATION.md "allocator
    # placement: traced root cause"): V's res256 chunk slack aliases
    # the freed downsampled-U byte plane at byte offset 32768 — unless
    # a single 4096-byte allocation just before it splits the freed
    # U-plane slot instead of landing on coalesced stream-buffer
    # remnants, which shifts the chunk one malloc slot and moves the
    # slack to U-plane offset 36864.  Which way glibc goes depends on
    # tcache/coalescing over the content-sized stream buffers freed
    # earlier; the dominant placement (32768) is used here and the
    # residual class (6 of 3213 fuzzed combos; the four v_off-sensitive
    # ones all close under the alternate placement) is pinned by
    # tests/test_alloc_slack.py.
    v_off = 32768 if _V_OFF_OVERRIDE is None else _V_OFF_OVERRIDE

    def _u8_pairs(off, k=4):
        return np.array(
            [np.uint16(int(uf[off + 2 * i])
                       | (int(uf[off + 2 * i + 1]) << 8)).view(np.int16)
             for i in range(k)], np.int16)

    tail_u = _u8_pairs(u_off)
    tail_v = (_u8_pairs(v_off) if _V_TAIL_OVERRIDE is None
              else np.asarray(_V_TAIL_OVERRIDE, np.int16))
    oob_v = int(tail_v[0])

    proc_u, t1u, exw_u = encode_uv(u8u, q, 0, ratio, oob0=oob_u,
                                   oob_tail=tail_u, pre=pre_u)
    quantize.serpentine_uv(im_nhw, proc_u, 0)
    proc_v, t1v, exw_v = encode_uv(u8v, q, 1, ratio, oob0=oob_v,
                                   oob_tail=tail_v, pre=pre_v)
    quantize.serpentine_uv(im_nhw, proc_v, 1)

    sec["exw_Y"] = sec["exw_Y"] + [0, 0] + exw_u + [0, 0] + exw_v

    if q > T.LOW5:
        sec["res_U_64"] = np.packbits((t1u >> 1) & 1)
        sec["res_V_64"] = np.packbits((t1v >> 1) & 1)

    # UV LL2 compression appended to the Y stream
    # (encoder/compress_pixel.c:878-1022); masks the UV planes to &252
    tree_uv = np.concatenate([t1u, t1v]) & 252
    ch_res = sec.pop("hrcomp_y") + ll2.uv_highres_compression(
        tree_uv, tail=_tree1_tail(y_original, q, 8192))
    sec["ch_res"] = np.array(ch_res, np.uint8)

    if defer_pack:
        return DeferredEncode(q, sec,
                              entropy_enc.wavlts2packet_tokenize(im_nhw))
    pk = entropy_enc.wavlts2packet(im_nhw, sec["nhw_select1"],
                                   sec["nhw_select2"])
    return _assemble_packet(q, sec, pk)


def encode(pixels: np.ndarray, quality: int = 20,
           block_variance: bool = False) -> bytes:
    """Encode a (512,512,3) uint8 pixel array to .nhw bytes.

    ``block_variance``: enable the reference's dead E6 block-variance
    smoother (call commented out at encoder/nhw_encoder.c:112; its
    intended gate q <= LOW6 is preserved) — byte-exact vs an oracle
    build with the call re-enabled (tests/test_block_variance.py)."""
    from benchmark.reference.ops import prefilter

    y, u, v = colorspace.downsample_yuv420(pixels, quality)
    if block_variance and quality <= T.LOW6:
        y = prefilter.block_variance_avg(y)
    y_orig = y
    if quality < T.HIGH2:
        y = prefilter.pre_process_y(y, quality)
    return encode_from_planes(y, u, v, quality, y_original=y_orig)


def encode_bmp(bmp_path, nhw_path, quality: int = 20) -> None:
    from pathlib import Path

    from benchmark.reference.utils import bmp as bmp_io

    data = encode(bmp_io.read_bmp512(bmp_path), quality)
    Path(nhw_path).write_bytes(data)


# ---------------------------------------------------------------------------
# UV pipeline (encoder/nhw_encoder.c:2256-2570 / 2572-2868)


def _pre_processing_uv(jpeg: np.ndarray, quality: int) -> None:
    """8-neighbour laplacian nudge (encoder/image_processing.c:2428-2464),
    reads the unmodified copy - pure array pass."""
    p = jpeg.astype(np.int32)
    lap = np.zeros_like(p)
    lap[1:-1, 1:-1] = (
        (p[1:-1, 1:-1] << 3)
        - p[1:-1, :-2] - p[1:-1, 2:] - p[:-2, 1:-1] - p[2:, 1:-1]
        - p[:-2, :-2] - p[2:, :-2] - p[:-2, 2:] - p[2:, 2:])
    if quality < T.LOW6:
        d = np.where(np.abs(lap) >= 14, 2, np.where(np.abs(lap) > 5, 1, 0))
        jpeg -= (np.sign(lap) * d).astype(np.int16)
    else:
        jpeg -= np.where(lap > 5, 1, np.where(lap < -5, -1, 0)).astype(np.int16)


def _uv_compare_ladder(jpeg: np.ndarray, process: np.ndarray,
                       res256: np.ndarray, strict: bool,
                       oob0: int = 0) -> None:
    """Post-synthesis LL1 compare (encoder/nhw_encoder.c:2316-2335 U,
    2629-2647 V; V uses strict inequality on the +-2 neighbour rule).

    ``oob0``: the value the reference reads at res256[16384] (one short
    past its 16384-short chunk) for the final position's +-2 rule — the
    chunk slack deterministically aliases earlier live buffers (the
    chroma plane bytes / the Y LL2 snapshot, see encode_uv)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        r16 = np.ascontiguousarray(res256.reshape(-1), np.int16)
        lib.nhw_uv_compare_ladder(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int16_t *", process.ctypes.data),
            ffi.cast("int16_t *", r16.ctypes.data), 1 if strict else 0,
            int(oob0))
        return

    pf = process.reshape(-1)
    jf = jpeg.reshape(-1)
    rf = res256.reshape(-1)
    for r in range(128):
        for j in range(128):
            e = r * D + j
            cnt = r * 128 + j
            scan = int(pf[e]) - int(rf[cnt])
            nxt = (int(pf[e + 1]) - int(rf[cnt + 1])) if cnt + 1 < 16384 \
                else int(pf[e + 1]) - int(oob0)
            if scan > 10:
                k = -6
            elif scan > 7:
                k = -3
            elif scan > 4:
                k = -2
            elif scan > 3:
                k = -1
            elif scan > 2 and (nxt > 0 if strict else nxt >= 0):
                k = -1
            elif scan < -10:
                k = 6
            elif scan < -7:
                k = 3
            elif scan < -4:
                k = 2
            elif scan < -3:
                k = 1
            elif scan < -2 and (nxt < 0 if strict else nxt <= 0):
                k = 1
            else:
                k = 0
            jf[e] = np.int16(int(rf[cnt]) + k)


def _uv_sentinel_marking(process: np.ndarray, res256: np.ndarray,
                         quality: int, res_uv: int,
                         oob_tail: np.ndarray | None = None) -> None:
    """Band sentinels 12400/12600/12900/13000 (encoder/nhw_encoder.c:2372-
    2424).  The reference's count register advances by 2 on each
    12400/12600 placement; a placement at a row's final position overruns
    the row and desynchronizes count from the grid for every later row —
    reproduced with a running counter over an extended res256 (zero tail
    for the drift overrun past 16384)."""
    from benchmark.reference import native

    tail = np.zeros(512, np.int16)
    if oob_tail is not None:
        t = np.asarray(oob_tail, np.int16)
        tail[: t.size] = t
    rf_ext = np.concatenate([
        np.ascontiguousarray(res256.reshape(-1), np.int16), tail])

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_uv_sentinel_marking(
            ffi.cast("int16_t *", process.ctypes.data),
            ffi.cast("const int16_t *", rf_ext.ctypes.data),
            rf_ext.size, res_uv)
        return

    pf = process.reshape(-1)
    rf = rf_ext.astype(np.int64)
    count = 0
    for base in range(0, 2 * SZ >> 2, D):
        scan = base
        j = 0
        while j < 128:
            d0 = int(pf[scan]) - int(rf[count])
            d1 = int(pf[scan + 1]) - int(rf[count + 1])
            placed = False
            if 3 < d0 < 7 and 2 < d1 < 7:
                for off in (128, SZ >> 1, (SZ >> 1) + 128):
                    if abs(int(pf[scan + off])) < 8:
                        pf[scan + off] = 12400
                        placed = True
                        break
            elif -7 < d0 < -3 and -8 < d1 < -2:
                for off in (128, SZ >> 1, (SZ >> 1) + 128):
                    if abs(int(pf[scan + off])) < 8:
                        pf[scan + off] = 12600
                        placed = True
                        break
            if placed:
                count += 2
                scan += 2
                j += 2
                continue
            if abs(d0) > res_uv:
                code = None
                if d0 > 0:
                    code = 12900
                elif d0 == -5:
                    code = 13000 if d1 < 0 else None
                else:
                    code = 13000
                if code:
                    for off in (128, SZ >> 1, (SZ >> 1) + 128):
                        if abs(int(pf[scan + off])) < 8:
                            pf[scan + off] = code
                            break
            count += 1
            scan += 1
            j += 1

def _uv_ll_smooth(process: np.ndarray) -> None:
    """q<=LOW9 LL smoothing (encoder/nhw_encoder.c:2438-2477)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_uv_ll_smooth(ffi.cast("int16_t *", process.ctypes.data))
        return

    pf = process.reshape(-1)
    thr3, thr4 = 5, 8
    for r in range(62):
        for j in range(62):
            scan = r * D + j
            if abs(int(pf[scan + 1]) - int(pf[scan + 2 * D + 1])) < thr3 \
                    and abs(int(pf[scan + D]) - int(pf[scan + D + 2])) < thr3:
                if abs(int(pf[scan + D + 1]) - int(pf[scan + D])) < thr4 - 1 \
                        and abs(int(pf[scan + 1]) - int(pf[scan + D + 1])) < thr4:
                    pf[scan + D + 1] = np.int16(
                        (int(pf[scan + 1]) + int(pf[scan + 2 * D + 1])
                         + int(pf[scan + D]) + int(pf[scan + D + 2]) + 2) >> 2)
    for r in range(62):
        for j in range(62):
            scan = r * D + j
            if abs(int(pf[scan + 2]) - int(pf[scan + 1])) < thr3 \
                    and abs(int(pf[scan + 1]) - int(pf[scan])) < thr3:
                if abs(int(pf[scan]) - int(pf[scan + D])) < thr3 \
                        and abs(int(pf[scan + 2]) - int(pf[scan + D + 2])) < thr3:
                    if abs(int(pf[scan + 2 * D + 1]) - int(pf[scan + D])) < thr3 \
                            and abs(int(pf[scan + D]) - int(pf[scan + D + 1])) < thr4:
                        pf[scan + D + 1] = np.int16(
                            (int(pf[scan + 1]) + int(pf[scan + 2 * D + 1])
                             + int(pf[scan + D]) + int(pf[scan + D + 2]) + 1) >> 2)


def encode_uv(plane_u8: np.ndarray, quality: int, component: int,
              ratio: int = 8, oob0: int = 0,
              oob_tail: np.ndarray | None = None, pre=None):
    """One chroma plane -> (quantized 256x256 code plane, tree1_uv[4096],
    exw continuation list).  component: 0=U, 1=V.
    ``pre``: optional device-computed (jpeg, process, res256) from
    models.device_stages.analysis_uv."""
    q = quality
    if pre is not None:
        jpeg, process, res256 = pre
        jpeg = np.array(jpeg, np.int16)
        process = np.array(process, np.int16)
        res256 = np.array(res256, np.int16)
    else:
        jpeg = plane_u8.astype(np.int16).copy()
        process = np.zeros((D, D), np.int16)

        if q <= T.LOW6:
            process[:] = jpeg  # pre_processing_UV copies then nudges jpeg
            _pre_processing_uv(jpeg, q)

        analysis.wavelet_analysis(jpeg, process, D, 0, 0)
        res256 = jpeg[:128, :128].copy()

        if q <= T.LOW4:
            # per-band |v|-window zeroing; elementwise, so vectorized
            for rs, cs, hi in ((slice(0, 128), slice(128, 256), 24),
                               (slice(128, 256), slice(0, 128), 32),
                               (slice(128, 256), slice(128, 256), 48)):
                blk = process[rs, cs]
                v = np.abs(blk.astype(np.int32))
                blk[(v >= ratio) & (v < hi)] = 0

        analysis.wavelet_analysis(jpeg, process, 128, 1, 0)

    requant.offset_uv_recons256(jpeg, process, q, ratio, comp=1)
    analysis.wavelet_synthesis(jpeg, process, 128, 0)
    _uv_compare_ladder(jpeg, process, res256, strict=(component == 1),
                       oob0=oob0)
    analysis.wavelet_analysis(jpeg, process, 128, 1, 0)

    resIII = process[:128, :128].copy()
    requant.offset_uv_recons256(jpeg, process, q, ratio, comp=0)
    analysis.wavelet_synthesis(jpeg, process, 128, 0)

    res_uv = 4 if q > T.LOW3 else 5
    if q >= T.LOW2:
        _uv_sentinel_marking(process, res256, q, res_uv, oob_tail)

    process[:128, :128] = resIII

    if q <= T.LOW9:
        _uv_ll_smooth(process)

    # LL2 byte-coding + exw continuation (2484-2515 / 2783-2813)
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        tree1_uv = np.zeros(4096, np.uint8)
        exw_a = np.empty(3 * 4096, np.int32)
        n_exw = ffi.new("long *")
        lib.nhw_ll2_code_uv(
            ffi.cast("int16_t *", process.ctypes.data),
            ffi.cast("uint8_t *", tree1_uv.ctypes.data),
            ffi.cast("int32_t *", exw_a.ctypes.data), n_exw)
        quantize.offset_uv(process, ratio)
        return process, tree1_uv, exw_a[: n_exw[0]].tolist()

    pf = process.reshape(-1)
    tree1_uv = np.zeros(4096, np.uint8)
    exw: list[int] = []
    a_out = 0
    for r in range(64):
        for j in range(64):
            scan = int(pf[r * D + j])
            if scan > 255 and (j > 0 or r > 0):
                exw += [r, j + 128, min(scan - 255, 255)]
                tree1_uv[a_out] = tree1_uv[a_out - 1]
                a_out += 1
                pf[r * D + j] = 0
            elif scan < 0 and (j > 0 or r > 0):
                exw += [r, j, -max(scan, -255)]
                tree1_uv[a_out] = tree1_uv[a_out - 1]
                a_out += 1
                pf[r * D + j] = 0
            else:
                scan = 255 if scan > 255 else (0 if scan < 0 else scan)
                tree1_uv[a_out] = scan & 254
                a_out += 1
                pf[r * D + j] = 0

    quantize.offset_uv(process, ratio)
    return process, tree1_uv, exw
