# Frozen copy of nhwcodec_tpu_torch/host/ops/requant.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Reconstruction-aware requantization of LL1/LL2 (encoder side).

Reference behavior: offsetY_recons256 / offsetUV_recons256
(encoder/image_processing.c:2600-3353) and the requant feedback block of
encode_image (encoder/nhw_encoder.c:125-283, 2310-2340).

Structure: the position-independent passes (sentinel marking, scatter
nudges, dead-zone/mask quantization) are vectorized; the few passes with
raster-carried state (greedy run marking, neighbour feedback through
just-written values, per-row duty-cycle counters at low quality) run as
sparse sequential replays over candidate positions — the same technique
as the decoder's Gauss-Seidel passes.

All planes are flat/2-D int16 numpy arrays; C's flat-pointer reads that
cross row boundaries are reproduced by operating on flattened views.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T
from benchmark.reference.ops.lifting import wrap16

D = 256
N = 512
SZ = 65536


# ---------------------------------------------------------------------------
# requant feedback block (encoder/nhw_encoder.c:141-283)


def mark_res256(process: np.ndarray, res256: np.ndarray) -> None:
    """Sentinel-mark res256 from the stage-2 band coefficients
    (encoder/nhw_encoder.c:144-177).  process: (512,512); res256: (256,256).
    Pure vector pass (reads are unmodified)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_mark_res256(
            ffi.cast("const int16_t *", process.ctypes.data),
            ffi.cast("int16_t *", res256.ctypes.data))
        return

    p = process[:D, :D].astype(np.int32)
    r_idx, c_idx = np.mgrid[0:D, 0:D]
    band = (r_idx >= 128) | (c_idx >= 128)

    neg = p < 0
    nmod = (-p) & 7
    add16 = band & (((p < -7) & ((nmod == 7) | (nmod == 0)))
                    | ((p > 4) & (p <= 7)))
    add12_simple = band & (
        ((p < -4) & (p >= -7))
        | ((p >= 0) & ~((p >= 2) & (p < 5)) & (((p & 7) == 0) | ((p & 7) == 1))))

    # the 2..4 case checks diagonal neighbours in the full 512-wide plane
    flat = process.reshape(-1).astype(np.int32)
    scan = r_idx * N + c_idx
    ok_range = (scan >= (2 * D + 1)) & ((r_idx * N + c_idx) < (2 * SZ - N - 1))
    up = np.abs(flat[np.clip(scan - (N + 1), 0, flat.size - 1)]) != 0
    dn = np.abs(flat[np.clip(scan + (N + 1), 0, flat.size - 1)]) != 0
    add12_diag = band & (p >= 2) & (p < 5) & ok_range & (up | dn)

    res256 += (16000 * add16 + 12000 * (add12_simple | add12_diag)
               ).astype(np.int16)


def unmark_res256(process: np.ndarray, res256: np.ndarray) -> None:
    """Remove sentinels and nudge the corresponding level-1 band
    coefficients (encoder/nhw_encoder.c:183-216).  Scatter is bijective."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_unmark_res256(
            ffi.cast("int16_t *", process.ctypes.data),
            ffi.cast("int16_t *", res256.ctypes.data))
        return

    flat = process.reshape(-1)
    r, c = np.nonzero(res256 > 10000)
    hi = res256[r, c] > 14000
    res256[r, c] -= np.where(hi, 16000, 12000).astype(np.int16)

    i = (r.astype(np.int64) << 9)
    j = c.astype(np.int64)
    tgt = np.full(r.shape, -1, np.int64)
    m = (i < SZ) & (j >= 128)
    tgt[m] = (i[m] >> 8) + ((j[m] - 128) << 10) + N
    m = (i >= SZ) & (j < 128)
    tgt[m] = ((i[m] - SZ) >> 8) + (j[m] << 10) + 1
    m = (i >= SZ) & (j >= 128)
    tgt[m] = ((i[m] - SZ) >> 8) + ((j[m] - 128) << 10) + N + 1
    sel = tgt >= 0
    np.add.at(flat, tgt[sel], np.where(hi[sel], 1, -1).astype(np.int16))


def requant_scan_ladder(jpeg: np.ndarray, process: np.ndarray,
                        res256: np.ndarray) -> None:
    """Compare reconstructed LL1 vs saved res256 and nudge coefficients
    (encoder/nhw_encoder.c:218-279).  Left-neighbour reads see the
    just-updated value, so candidates replay sequentially in raster order
    with live in-place reads.  Writes land in jpeg[:256,:256] (baseline
    im_jpeg[e]=res256 for every position)."""
    pf = process.reshape(-1)
    jf = jpeg.reshape(-1)

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        r16 = np.ascontiguousarray(res256.reshape(-1), np.int16)
        lib.nhw_scan_ladder(
            ffi.cast("int16_t *", jf.ctypes.data),
            ffi.cast("int16_t *", pf.ctypes.data),
            ffi.cast("int16_t *", r16.ctypes.data))
        return

    r256 = res256.reshape(-1).astype(np.int32)

    jpeg[:D, :D] = res256

    idx = np.arange(SZ, dtype=np.int64)
    e_of = (idx >> 8 << 9) + (idx & 255)
    delta0 = pf[e_of].astype(np.int64) - r256
    cand = np.nonzero(np.abs(delta0) > 1)[0]

    for cnt in cand.tolist():
        e = int((cnt >> 8) << 9) + (cnt & 255)
        scan = int(pf[e]) - int(r256[cnt])
        if scan > 11:
            m = -7
        elif scan > 7:
            m = -4
        elif scan > 5:
            m = -2
        elif scan > 4:
            m = -1
        elif scan < -11:
            m = 7
        elif scan < -7:
            m = 4
        elif scan < -5:
            m = 2
        elif scan < -4:
            m = 1
        elif abs(scan) > 1:
            # neighbour-informed +-1/2 (encoder/nhw_encoder.c:232-276)
            a = int(pf[e + 1]) - (int(r256[cnt + 1]) if cnt + 1 < SZ else 0)
            if abs(a) > 4:
                if a > 0:
                    a += -7 if a > 11 else -4 if a > 7 else -2 if a > 5 else -1
                else:
                    a += 7 if a < -11 else 4 if a < -7 else 2 if a < -5 else 1
            if cnt > 0:
                left = int(pf[e - 1]) - int(r256[cnt - 1])
            else:
                left = 0  # C reads the zero shorts just before both arrays
            a += left
            if scan >= 4 and a >= 1:
                m = -1
            elif scan <= -4 and a <= -1:
                m = 1
            elif scan == 3 and a >= 0:
                m = -1
            elif scan == -3 and a <= 0:
                m = 1
            elif abs(a) >= 3:
                if scan > 0 and a > 0:
                    m = -1
                elif scan < 0 and a < 0:
                    m = 1
                elif a >= 5:
                    m = -2
                elif a <= -5:
                    m = 2
                elif a >= 4:
                    m = -1
                elif a <= -4:
                    m = 1
                else:
                    m = 0
            else:
                m = 0
        else:
            m = 0

        if m:
            jf[e] = np.int16(int(r256[cnt]) + m)
            pf[e] = np.int16(int(pf[e]) + m)


# ---------------------------------------------------------------------------
# offsetY_recons256 (encoder/image_processing.c:2600-3190)


def offset_y_recons256(jpeg: np.ndarray, process: np.ndarray, quality: int,
                       m1: int, part: int,
                       highres_mem: np.ndarray | None = None,
                       highres_tmp_out: list | None = None) -> None:
    """LL2 + level-2 band requantization (encoder/image_processing.c:2600).
    Mutates jpeg/process (512-wide planes).  part=1 marks in-place for the
    feedback loop; part=0 finalizes codes.  ``highres_mem`` (part=0,
    q>LOW5) re-injects positions saved by Y_highres_compression."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        ht = np.empty(SZ >> 2, np.int16)
        if not part and quality > T.LOW5 and highres_mem is not None:
            hm = np.ascontiguousarray(highres_mem, np.int32)
            hm_ptr = ffi.cast("const int32_t *", hm.ctypes.data)
            n_mem = hm.size
        else:
            hm_ptr = ffi.NULL
            n_mem = 0
        lib.nhw_offset_y_recons256(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int16_t *", process.ctypes.data),
            quality, m1, part,
            ffi.cast("int16_t *", ht.ctypes.data), hm_ptr, n_mem)
        if not part and highres_tmp_out is not None:
            highres_tmp_out.append(ht)
        return

    pf = process.reshape(-1)
    jf = jpeg.reshape(-1)

    # --- greedy odd-run marking in LL2 rows (2608-2638)
    if quality > T.LOW3:
        for r in range(128):
            base = r * N
            j = 0
            while j < 125:
                a = base + j
                if (pf[a] & 1) and (pf[a + 1] & 1) and (pf[a + 2] & 1) \
                        and (pf[a + 3] & 1) and abs(int(pf[a]) - int(pf[a + 3])) > 1:
                    if not part:
                        pf[a] += 16000
                        pf[a + 1] += 16000
                        pf[a + 2] += 16000
                        pf[a + 3] += 16000
                    else:
                        pf[a] += 16000
                        pf[a + 2] += 16000
                    j += 4
                else:
                    j += 1

    # --- odd-pattern propagation + part=1 LSB masking (2640-2695)
    for r in range(128):
        base = r * N
        i_flat = r * N  # C's i
        j = 0
        while j < 128:
            a = base + j
            v = int(pf[a])
            if v > 10000:
                if not part:
                    jf[a] = pf[a]
                else:
                    pf[a] = np.int16(v - 16000)
                    jf[a] = pf[a]
                    nxt = int(pf[a + 1])
                    if 0 < nxt < 256:
                        jf[a + 1] = np.int16(nxt & 65534)
                    else:
                        jf[a + 1] = pf[a + 1]
                    j += 1
                j += 1
                continue
            if (v & 1) and a > i_flat and (pf[a + 1] & 1):
                if j < 126 and (pf[a + 2] & 1):
                    if abs(v - int(pf[a + 2])) > 1 and quality > T.LOW3:
                        pf[a + 1] += 1
                elif i_flat < (SZ - N - 2) and (pf[a + N] & 1) \
                        and (pf[a + N + 1] & 1) and not (pf[a + N + 2] & 1):
                    if pf[a + N] < 10000 and quality > T.LOW3:
                        pf[a + N] += 1
            elif (v & 1) and i_flat >= N and i_flat < (SZ - 3 * N):
                if (pf[a + N] & 1) and (pf[a + N + 1] & 1):
                    if (pf[a + 2 * N] & 1) and not (pf[a + 3 * N] & 1):
                        if pf[a + N] < 10000 and quality > T.LOW3:
                            pf[a + N] += 1
            if part:
                if 0 < v < 256:
                    jf[a] = np.int16(int(pf[a]) & 65534)
                else:
                    jf[a] = pf[a]
            j += 1

    # --- part=0: strip sentinels, save highres_tmp, mask LSBs (2697-2719)
    if not part:
        highres_tmp = np.empty(SZ >> 2, np.int16)
        t = 0
        for r in range(128):
            base = r * N
            for j in range(128):
                a = base + j
                v = int(pf[a])
                if v < 10000:
                    highres_tmp[t] = v
                    jf[a] = np.int16(v & 65534) if 0 <= v < 256 else pf[a]
                else:
                    pf[a] = np.int16(v - 16000)
                    highres_tmp[t] = pf[a]
                    jf[a] = pf[a]
                t += 1
        if highres_tmp_out is not None:
            highres_tmp_out.append(highres_tmp)
        if quality > T.LOW5 and highres_mem is not None:
            for mem in highres_mem.tolist():
                jj = mem >> 7
                aa = mem & 127
                jf[(jj << 9) + aa] = highres_tmp[mem]

    # --- q>LOW4: band pair/sentinel promotions (2759-2853)
    if quality > T.LOW4:
        # HL band: rows 0..127, cols 129..254
        for r in range(128):
            base = r * N
            j = 129
            while j < 255:
                a = base + j
                _promote_band_pair(pf, jf, a)
                j += 1 + _promote_band_pair.consumed
        # lower half: rows 128..254, cols 1..254
        for r in range(128, 255):
            base = r * N
            j = 1
            while j < 255:
                a = base + j
                _promote_band_pair(pf, jf, a)
                j += 1 + _promote_band_pair.consumed

        if not part:
            # 15700/15800 +-5/6/7 pair markers (2855-2906)
            for r in range(128):
                base = r * N
                j = 128
                while j < 255:
                    a = base + j
                    v = int(pf[a])
                    if v in (5, 6, 7) and int(pf[a + 1]) in (5, 6, 7):
                        pf[a] = 15700
                        j += 1
                    elif v in (-5, -6, -7) and int(pf[a + 1]) in (-5, -6, -7):
                        pf[a] = 15800
                        j += 1
                    j += 1
            for r in range(128, 256):
                base = r * N
                j = 0
                while j < 255:
                    a = base + j
                    v = int(pf[a])
                    if v in (5, 6, 7) and int(pf[a + 1]) in (5, 6, 7):
                        pf[a] = 15700
                        j += 1
                    elif v in (-5, -6, -7) and int(pf[a + 1]) in (-5, -6, -7):
                        pf[a] = 15800
                        j += 1
                    j += 1

    # --- band quantization with marker expansion (2909-3133)
    _quantize_band(jpeg, process, quality, m1, part, rows=range(128),
                   cols=(128, 256))
    _quantize_band(jpeg, process, quality, m1, part, rows=range(128, 256),
                   cols=(0, 256))

    # --- part=0: isolated-coefficient damping (3135-3189); the
    # reference loop stops at row 254 (i < 2*IM_SIZE - 2*IM_DIM)
    if not part:
        thr_diag = 16 if quality <= T.LOW4 else 8
        for r in range(1, 255):
            base = r * N
            for j in range(1, 255):
                e = base + j
                if abs(int(jf[e])) < 8:
                    continue
                if (abs(int(jf[e - N - 1])) >= thr_diag
                        or abs(int(jf[e - N])) >= 8
                        or abs(int(jf[e - N + 1])) >= thr_diag
                        or abs(int(jf[e - 1])) >= 8
                        or abs(int(jf[e + 1])) >= 8
                        or abs(int(jf[e + N - 1])) >= thr_diag
                        or abs(int(jf[e + N])) >= 8
                        or abs(int(jf[e + N + 1])) >= thr_diag):
                    continue
                if r >= 128 or j >= 128:
                    jf[e] += np.int16(-1 if jf[e] > 0 else 1)


def _promote_band_pair(pf: np.ndarray, jf: np.ndarray, a: int) -> None:
    """One position of the +-4..7 sentinel promotion
    (encoder/image_processing.c:2765-2803).  Sets .consumed to the number
    of extra positions the caller must skip."""
    _promote_band_pair.consumed = 0
    v = int(pf[a])
    if 3 < v < 8:
        if 3 < int(pf[a - 1]) <= 7:
            if 3 < int(pf[a + 1]) <= 7:
                pf[a - 1] = 15300
                pf[a] = 0
                jf[a] = 5
                jf[a + 1] = 5
                _promote_band_pair.consumed = 1
            elif 3 < int(pf[a + N - 1]) <= 7:
                if 3 < int(pf[a + N]) <= 7:
                    pf[a - 1] = 15500
                    jf[a] = 5
                    pf[a + N - 1] = 15500
                    jf[a + N] = 5
                    pf[a + N] = 0
                    _promote_band_pair.consumed = 1
    elif -8 < v < -3:
        if -8 < int(pf[a - 1]) <= -4:
            if -8 < int(pf[a + 1]) <= -4:
                pf[a - 1] = 15400
                pf[a] = 0
                jf[a] = -6
                jf[a + 1] = -5
                _promote_band_pair.consumed = 1
            elif -8 < int(pf[a + N - 1]) <= -4:
                if -8 < int(pf[a + N]) <= -4:
                    pf[a - 1] = 15600
                    jf[a] = -5
                    pf[a + N - 1] = 15600
                    jf[a + N] = -5
                    pf[a + N] = 0
                    _promote_band_pair.consumed = 1


def _quantize_band(jpeg: np.ndarray, process: np.ndarray, quality: int,
                   m1: int, part: int, rows, cols) -> None:
    """Marker expansion + dead-zone quantization of one band region
    (encoder/image_processing.c:2909-3020, identical 3022-3133).  Per-row
    quant/quant6 duty counters at q<=LOW4; neighbour feedback through
    im_process[i+j+1]."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        c0_, c1_ = cols
        lib.nhw_quantize_band(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int16_t *", process.ctypes.data),
            1 if quality <= T.LOW4 else 0, m1, part,
            rows.start, rows.stop, c0_, c1_)
        return

    pf = process.reshape(-1)
    jf = jpeg.reshape(-1)
    c0, c1 = cols
    for r in rows:
        base = r * N
        quant = 0
        quant6 = 0
        j = c0
        while j < c1:
            a = int(pf[base + j])
            if a > 15000:
                if a == 15300:
                    jf[base + j] = 5
                    j += 3
                elif a == 15400:
                    jf[base + j] = -5
                    j += 3
                elif a == 15500:
                    jf[base + j] = 5
                    j += 2
                elif a == 15600:
                    jf[base + j] = -5
                    j += 2
                elif a == 15700:
                    jf[base + j] = 6
                    jf[base + j + 1] = 6
                    j += 2
                elif a == 15800:
                    jf[base + j] = -6
                    jf[base + j + 1] = -6
                    j += 2
                else:
                    j += 1
                continue

            if a < -12 and ((-a) & 7) == 6:
                if j < 255 and pf[base + j + 1] == -7:
                    pf[base + j + 1] = -8

            if a < 0:
                if a == -7 and j < 255 and pf[base + j + 1] == 8:
                    pf[base + j] = -8
                    a = -8
                a = -a
                if quality <= T.LOW4:
                    if a == 15:
                        if not quant:
                            a &= 65528
                            quant = 1
                        else:
                            quant = (quant + 1) % 6
                    elif a > 22 and (a & 7) == 7:
                        if not quant6:
                            a &= 65528
                            quant6 = 1
                        else:
                            quant6 = (quant6 + 1) % 4
                    else:
                        a &= 65528
                else:
                    if (a & 7) < 7:
                        a &= 65528
                a = -a
            elif a == 8 and j < 255 and pf[base + j + 1] == -7:
                pf[base + j + 1] = -8
            elif a > 12 and not part and (a & 7) >= 6:
                if j < 255 and pf[base + j + 1] == 7:
                    pf[base + j + 1] = 8

            if -m1 < a < m1:
                jf[base + j] = 0
                j += 1
                continue
            a += 128
            if a < 0:
                a = -((-a) & 65528)
            else:
                a &= 65528
            jf[base + j] = np.int16(a - 125 if a > 128 else a - 131)
            j += 1


# ---------------------------------------------------------------------------
# offsetUV_recons256 (encoder/image_processing.c:3192-3353)


def offset_uv_recons256(jpeg: np.ndarray, process: np.ndarray, quality: int,
                        m1: int, comp: int) -> None:
    """Chroma LL2 + band requantization on (256,256) planes."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_offset_uv_recons256(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int16_t *", process.ctypes.data),
            1 if quality > T.LOW5 else 0, m1, comp)
        return

    pf = process.reshape(-1)
    jf = jpeg.reshape(-1)

    # LL2 64x64 (3198-3242)
    if comp:
        if quality > T.LOW5:
            i = 0
            while i < (SZ >> 2):
                if (i & 255) < 64:
                    if not (i >> 8):
                        jf[i] = pf[i]
                        jf[i + 1] = np.int16(wrap16(int(pf[i + 1]) & 65534))
                    else:
                        jf[i] = np.int16(wrap16(int(pf[i]) & 65534))
                        jf[i + 1] = pf[i + 1]
                    i += 1
                i += 1
        else:
            for i in range(SZ >> 2):
                if (i & 255) < 64:
                    jf[i] = np.int16(wrap16((int(pf[i]) & 65532) + 1))
    else:
        for i in range(SZ >> 2):
            if (i & 255) < 64:
                v = int(pf[i])
                jf[i] = np.int16(v & 65534) if 0 < v < 256 else pf[i]

    # band regions (3244-3353): rows 0..63 cols 64..127, rows 64..127 all
    def band(row_range, col_range):
        for r in row_range:
            base = r * D
            j = col_range[0]
            while j < col_range[1]:
                i = base + j
                a = int(pf[i])
                if a in (-7, -8) and not comp:
                    if j < 127 and int(pf[i + 1]) in (-7, -8):
                        jf[i] = -11
                        jf[i + 1] = -11
                        j += 2
                        continue
                if a < 0:
                    a = -a
                    nxt = int(pf[i + 1]) if i + 1 < SZ else 0
                    if -8 < nxt < 0:
                        if (a & 7) < 6:
                            a &= 65528
                    else:
                        if (a & 7) < 7:
                            a &= 65528
                    a = -a
                if -m1 < a < m1:
                    jf[i] = 0
                    j += 1
                    continue
                a += 128
                if a < 0:
                    a = -((-a) & 65528)
                else:
                    a &= 65528
                jf[i] = np.int16(a - 125 if a > 128 else a - 131)
                j += 1

    band(range(64), (64, 128))
    band(range(64, 128), (0, 128))


# ---------------------------------------------------------------------------
# im_recons_wavelet_band (encoder/image_processing.c:523-556)

_EXTRA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 2, 0, 3, 0, 0, 0, 4, 0, 5, 0, 6, 0,
    0, 0, 7, 0, 8, 0, 9, 0, 0, 0, 10, 0,
    11, 0, 12, 0, 0, 0, 13, 0, 14, 0, 15, 0, 0, 0, 16, 0, 17, 0, 18, 0,
    0, 0, 19, 0,
    -1, 0, -2, 0, 0, 0, -3, 0, -4, 0, -5, 0, 0, 0, -6, 0, -7, 0, -8, 0,
    0, 0, -9, 0, -10, 0,
    -11, 0, 0, 0, -12, 0, -13, 0, -14, 0, 0, 0, -15, 0, -16, 0, -17, 0,
    0, 0, -18, 0, -19,
], dtype=np.int32)

# the reference indexes extra_table[a] for any band code with (a&7)!=0,
# including a>=109 — a static out-of-bounds read into the neighbouring
# .rodata (alignment padding, extra_words2, extra_words1, then unrelated
# constants).  These 147 bytes are the deterministic layout of the
# reference build (dumped from the oracle binary at the extra_table
# symbol); they feed real res6/qsetting3 stream decisions at q>HIGH1.
_EXTRA_TABLE = np.concatenate([
    _EXTRA_TABLE[:109],
    np.array([
    0, 0, 0, 60, 62, 66, 68, 70, 74, 76, 78, 82, 84, 86, 90, 92, 94, 98,
    100, 102, 106, 108, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 10, 12, 14,
    18, 20, 22, 26, 28, 30, 34, 36, 38, 42, 44, 46, 50, 52, 54, 58, 0, 120,
    0, 120, 0, 116, 39, -100, 49, 68, 47, 116, 39, 116, 39, 116, 39, 116,
    39, 100, 50, -88, 47, 116, 39, 5, 0, 6, 0, -5, -1, -7, -1, -60, 59, 0,
    0, 5, 0, 5, 0, 40, 60, 0, 0, -6, -1, -5, -1, 6, 0, 6, 0, -6, -1, -6,
    -1, -11, -1, -11, -1, 2, 3, 3, 2, 21, -59, -1, -1, -87, -60, -1, -1,
    -42, -60, -1, -1, -53, -68, -1, -1, 6, -61, -1, -1, 6, -61, -1, -1, 6,
    -61, -1, -1
    ], dtype=np.int32)])


def im_recons_wavelet_band(process: np.ndarray) -> np.ndarray:
    """Dequantize the post-offsetY HL band codes back to coefficients
    (encoder/image_processing.c:523-556).  Returns flat (IM_SIZE,) int16."""
    pf = process.reshape(-1)
    band = np.zeros(SZ, np.int16)
    r = 0
    for row in range(D):
        j = 0
        while j < D:
            scan = row * N + D + j
            a = int(pf[scan]) & 0xFFFF  # codes are byte-valued here
            if a == 128:
                r += 1
                j += 1
                continue
            if a == 127:
                # C writes band[-1]/band[SZ] into heap slack at the plane
                # edges; numpy would wrap/raise, so clamp to no-ops
                if r >= 1:
                    band[r - 1] = 5
                band[r] = 6
                if r + 1 < SZ:
                    band[r + 1] = 5
                r += 2
                j += 2
                continue
            if a == 129:
                if r >= 1:
                    band[r - 1] = -5
                band[r] = -7
                if r + 1 < SZ:
                    band[r + 1] = -5
                r += 2
                j += 2
                continue
            if (a & 7) != 0:
                ex = int(_EXTRA_TABLE[a])
                if ex > 0:
                    band[r] = T.WVLT_ENERGY_NHW + (ex << 3)
                else:
                    band[r] = (ex << 3) - T.WVLT_ENERGY_NHW
                r += 1
                j += 1
                continue
            band[r] = a - 125 if a > 0x80 else a - 131
            r += 1
            j += 1
    return band
