# Frozen copy of nhwcodec_tpu_torch/host/models/decoder.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""NHW decode pipeline (bit-exact vs the reference nhw-dec).

Stage structure mirrors decoder/nhw_decoder.c:54-1476 but is re-expressed
array-first: fixed-permutation de-serpentine, vectorized lifting filterbank
passes, scatter-add residue application, and *sparse* sequential passes for
the few raster-order (Gauss-Seidel) filters whose updates feed later reads.

The heavy plane transforms (`ops.lifting`, deringing, upsampling, colorspace)
are pure array programs shared by the JAX device path; the entropy decode and
stream unpacking run on host.
"""

from __future__ import annotations

import heapq

import numpy as np

from benchmark.reference import tables as T
from benchmark.reference.ops import dc_plane, entropy, geometry, streams
from benchmark.reference.ops.lifting import synth_norm, synth_unnorm
from benchmark.reference.utils import bmp as bmp_io
from benchmark.reference.utils.container import NHWStreams, parse_nhw

D = T.IM_DIM          # 256
N = 2 * D             # 512
SZ = T.IM_SIZE        # 65536


def _apply_at(flat: np.ndarray, idx: np.ndarray, delta: int) -> None:
    if len(idx):
        np.add.at(flat, idx, np.int16(delta))


def _read0(flat: np.ndarray, idx: int) -> int:
    """Read with the reference's effective out-of-bounds semantics: the C
    code reads just past the Y plane on the last row; those bytes are the
    zero slack of a fresh mmap'd allocation."""
    return int(flat[idx]) if 0 <= idx < len(flat) else 0


# ---------------------------------------------------------------------------
# Y pipeline


def _expand_sentinels_y(flat: np.ndarray, count0: int, quality: int) -> None:
    """Sentinel expansion + band dering nudges
    (decoder/nhw_decoder.c:493-607).  ``count0`` is the live value the C
    code carries into the third loop's neighbour counter (a reproduced
    reference quirk).  Modifies ``flat`` (512*512 linear int16) in place."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_expand_sentinels_y(
            ffi.cast("int16_t *", flat.ctypes.data), count0,
            1 if quality < T.HIGH3 else 0)
        return

    def expand_top(scan: int, j: int) -> None:
        v = flat[scan]
        if v == 1008:
            flat[scan - 1] = 5
            flat[scan + 1] = 5
            flat[scan] = 5 if j < D else 6
        elif v == 1009:
            flat[scan - 1] = -5
            flat[scan + 1] = -5
            flat[scan] = -6 if j < D else -7
        elif v == 1010:
            flat[scan] = 5
            flat[scan + 1] = 5
            flat[scan + N] = 5
            flat[scan + N + 1] = 5
        elif v == 1011:
            flat[scan] = -5
            flat[scan + 1] = -5
            flat[scan + N] = -5
            flat[scan + N + 1] = -5
        elif v == 1006:
            flat[scan] = -6
            flat[scan + 1] = -6
        elif v == 1007:
            flat[scan] = 6
            flat[scan + 1] = 6

    def expand_bottom(scan: int) -> None:
        v = flat[scan]
        if v == 1008:
            flat[scan - 1] = 5
            flat[scan] = 6
            flat[scan + 1] = 5
        elif v == 1009:
            flat[scan - 1] = -5
            flat[scan] = -7
            flat[scan + 1] = -5
        elif v == 1006:
            if (scan & 511) < D:
                flat[scan] = -7
                flat[scan + 1] = -7
            else:
                flat[scan - D] = -7
                flat[scan - 3 * D] = -7
                flat[scan] = 0
        elif v == 1007:
            if (scan & 511) < D:
                flat[scan] = 7
                flat[scan + 1] = 7
            else:
                flat[scan - D] = 7
                flat[scan - 3 * D] = 7
                flat[scan] = 0

    # region 1: top 256 rows, all 512 columns (decoder/nhw_decoder.c:493-529)
    for scan in np.nonzero(flat[: 2 * SZ] > 1000)[0].tolist():
        if flat[scan] > 1000:
            expand_top(scan, scan & 511)

    # region 2: bottom 256 rows, left 256 columns (:531-559)
    lower = flat[2 * SZ:].reshape(D, N)
    r, c = np.nonzero(lower[:, :D] > 1000)
    for k in range(len(r)):
        scan = 2 * SZ + int(r[k]) * N + int(c[k])
        if flat[scan] > 1000:
            expand_bottom(scan)

    # region 3: bottom 256 rows, right 256 columns (:561-607) — includes the
    # +-1 dering nudge whose neighbour counter starts from a stale value
    band = flat[2 * SZ:].reshape(D, N)[:, D:]
    av = np.abs(band)
    cond = (band > 1000) | ((av > 8) & (av < 16) & (quality < T.HIGH3))
    r, c = np.nonzero(cond)
    count = count0
    for k in range(len(r)):
        j = D + int(c[k])
        scan = 2 * SZ + int(r[k]) * N + j
        v = int(flat[scan])
        if v > 1000:
            expand_bottom(scan)
        elif 8 < abs(v) < 16 and quality < T.HIGH3:
            if D < j < N - 1:
                if abs(_read0(flat, scan - 1)) < 8:
                    count += 1
                if abs(_read0(flat, scan + 1)) < 8:
                    count += 1
                if abs(_read0(flat, scan - N)) < 8:
                    count += 1
                if abs(_read0(flat, scan + N)) < 8:
                    count += 1
                if count >= 2:
                    flat[scan] = v + 1 if v > 0 else v - 1
                count = 0


def _isolated_smooth_y(flat: np.ndarray, quality: int) -> None:
    """Isolated-coefficient damping (decoder/nhw_decoder.c:660-711).
    Raster Gauss-Seidel: a damped 9 becomes 8 and unblocks later pixels —
    processed sparsely in raster order with live reads."""
    diag_thr = 16 if quality <= T.LOW4 else 8
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_isolated_smooth(ffi.cast("int16_t *", flat.ctypes.data),
                                diag_thr)
        return

    plane = flat[: 2 * SZ].reshape(D, N)
    r, c = np.nonzero(np.abs(plane[1:255, 1:255]) > 8)
    for k in range(len(r)):
        row = int(r[k]) + 1
        col = int(c[k]) + 1
        scan = row * N + col
        v = int(flat[scan])
        if abs(v) <= 8:
            continue
        if (abs(flat[scan - N - 1]) > diag_thr or abs(flat[scan - N]) > 8
                or abs(flat[scan - N + 1]) > diag_thr
                or abs(flat[scan - 1]) > 8 or abs(flat[scan + 1]) > 8
                or abs(flat[scan + N - 1]) > diag_thr
                or abs(flat[scan + N]) > 8
                or abs(flat[scan + N + 1]) > diag_thr):
            continue
        if row >= 128 or col >= 128:
            flat[scan] = v - 1 if v > 0 else v + 1


def _lap8(a: np.ndarray, scan: int, stride: int) -> int:
    return ((int(a[scan]) << 3)
            - int(a[scan - 1]) - int(a[scan + 1])
            - int(a[scan - stride]) - int(a[scan + stride])
            - int(a[scan - stride - 1]) - int(a[scan + stride - 1])
            - int(a[scan - stride + 1]) - int(a[scan + stride + 1]))


def _lap_plane(p: np.ndarray) -> np.ndarray:
    """8-neighbour laplacian over the interior of a 2-D int plane."""
    p = p.astype(np.int64)
    lap = np.zeros(p.shape, dtype=np.int64)
    lap[1:-1, 1:-1] = (
        (p[1:-1, 1:-1] << 3)
        - p[1:-1, :-2] - p[1:-1, 2:]
        - p[:-2, 1:-1] - p[2:, 1:-1]
        - p[:-2, :-2] - p[2:, :-2]
        - p[:-2, 2:] - p[2:, 2:]
    )
    return lap


def _dering_mark_y(proc: np.ndarray) -> list[int]:
    """Edge-detect marking pass (decoder/nhw_decoder.c:789-839).

    Walks column pairs (anchor columns 1,3,..,253) over rows 1..254 of the
    256x256 LL1 block; a mark (+16000) changes later laplacians, so after a
    vectorized candidate scan, each placed mark re-queues the few later
    anchors it influences.  Returns packed row*256+col mark positions
    (marks removed from ``proc`` afterwards, :829-839)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        marks = np.zeros(SZ, np.int32)
        n = lib.nhw_dering_mark(ffi.cast("int16_t *", proc.ctypes.data),
                                ffi.cast("int32_t *", marks.ctypes.data))
        return marks[:n].tolist()

    lap = _lap_plane(proc[: 2 * SZ].reshape(D, N)[:, :D])

    res_a = lap[1:255, 1:254:2]
    cnt_a = lap[1:255, 2:255:2]
    cond = (
        ((res_a > 41) & (res_a < 108) & (cnt_a < 16))
        | ((res_a < -41) & (res_a > -108) & (cnt_a > -16))
        | ((cnt_a > 41) & (cnt_a < 108) & (res_a < 16))
        | ((cnt_a < -41) & (cnt_a > -108) & (res_a > -16))
    )
    rr, cc = np.nonzero(cond)
    heap: list[tuple[int, int]] = [(int(rr[k]) + 1, 1 + 2 * int(cc[k]))
                                   for k in range(len(rr))]
    heapq.heapify(heap)
    seen: set[tuple[int, int]] = set()

    def queue_influenced(row: int, col: int, after: tuple[int, int]) -> None:
        # anchors (r2, c2) whose res (at c2) or count (at c2+1) laplacian
        # neighbourhood contains (row, col)
        for r2 in (row - 1, row, row + 1):
            if not 1 <= r2 <= 254:
                continue
            for c2 in range(col - 2, col + 2):
                if 1 <= c2 <= 253 and (c2 & 1) and (r2, c2) > after:
                    heapq.heappush(heap, (r2, c2))

    while heap:
        anchor = heapq.heappop(heap)
        if anchor in seen:
            continue
        seen.add(anchor)
        row, col = anchor
        res = _lap8(proc, row * N + col, N)
        cnt = _lap8(proc, row * N + col + 1, N)
        if 41 < res < 108 and cnt < 16:
            mark = col
        elif -108 < res < -41 and cnt > -16:
            mark = col
        elif 41 < cnt < 108 and res < 16:
            mark = col + 1
        elif -108 < cnt < -41 and res > -16:
            mark = col + 1
        else:
            continue
        proc[row * N + mark] += 16000
        queue_influenced(row, mark, anchor)

    out: list[int] = []
    plane = proc[: 2 * SZ].reshape(D, N)
    r, c = np.nonzero(plane[1:255, :D] > 10000)
    for k in range(len(r)):
        row = int(r[k]) + 1
        col = int(c[k])
        out.append(row * D + col)
        plane[row, col] -= 16000
    return out


def _pos_of(v: np.ndarray) -> np.ndarray:
    """Packed res-stream position -> 512-stride scan index."""
    return ((v & 65280) << 1) + (v & 255)


def _y_scatter_arrays(q, sub1, add1, sub5, add5, add43, sub43, add2, sub2):
    """Transform-domain residue add-back as one flat (idx, delta) scatter
    pair (decoder/nhw_decoder.c:721-787).  All entries are += adds, so
    application order is free."""
    idxs: list[np.ndarray] = []
    dels: list[np.ndarray] = []

    def put(pos: np.ndarray, d: int) -> None:
        idxs.append(pos.astype(np.int64))
        dels.append(np.full(pos.shape, d, np.int16))

    if q >= T.HIGH1:
        put(_pos_of(sub5), -3)
        put(_pos_of(add5), 3)
    if q > T.LOW8:
        e = 5 if q >= T.LOW2 else (7 if q >= T.LOW5 else 9)
        put(_pos_of(sub1), -e)
        put(_pos_of(add1), e)
    if q >= T.LOW1:
        p = _pos_of(sub43)
        put(p, -4)
        put(p + N, -3)
        p = _pos_of(add43)
        put(p, 4)
        put(p + N, 3)
        for off in (0, N, 2 * N):
            put(_pos_of(add2) + off, 2)
            put(_pos_of(sub2) + off, -2)

    if not idxs:
        return np.zeros(0, np.int64), np.zeros(0, np.int16)
    return np.concatenate(idxs), np.concatenate(dels)


def _y_hq_scatter_arrays(q, sub6, add6, char_res1, qsetting3):
    """HQ residue injection on the row-synthesized x8 plane as one flat
    (idx, delta) scatter pair (decoder/nhw_decoder.c:747-787 via
    wavelet_synthesis2; q>HIGH1 only)."""
    idxs: list[np.ndarray] = []
    dels: list[np.ndarray] = []

    def put(pos: np.ndarray, d) -> None:
        idxs.append(pos.astype(np.int64))
        dels.append(np.broadcast_to(np.asarray(d, np.int16),
                                    pos.shape).copy())

    if q > T.HIGH1:
        put(sub6, -32)
        put(add6, 32)
        v = char_res1.astype(np.int64)
        m = v & 3
        pos = ((v - m) << 1) + D - 2 + ((m >> 1) & 1)
        put(pos, np.where(m & 1, -32, 32).astype(np.int16))
    if q > T.HIGH2:
        v = qsetting3.astype(np.int64)
        put(v >> 1, np.where(v & 1, -56, 56).astype(np.int16))

    if not idxs:
        return np.zeros(0, np.int64), np.zeros(0, np.int16)
    return np.concatenate(idxs), np.concatenate(dels)


def _apply_pairs(flat: np.ndarray, idx: np.ndarray,
                 delta: np.ndarray) -> None:
    if len(idx):
        np.add.at(flat, idx, delta)


def decode_y_front(s: NHWStreams, res_comp: np.ndarray, sym=None):
    """Host front of the Y decode: entropy decode, de-serpentine,
    positional stream unpack, sentinel expansion, LL2 placement, res4
    parity, exw escapes, isolated smoothing
    (decoder/nhw_decoder.c:54-711).  Returns (coefficient plane
    (512*512,) int16, transform-domain scatter pair, HQ scatter pair) —
    everything the synthesis back end (host or device) consumes.
    ``sym``: optional pre-decoded Y symbol plane (e.g. from
    ops.entropy_decode_device.decode_y_device_batch — bit-equal to the
    host automaton); None runs the host C decode."""
    q = s.quality
    if sym is None:
        sym = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                               s.select_word2, s.res_high)
    jpeg = geometry.deserpentine_y(sym).reshape(-1).astype(np.int16)

    # positional stream pre-processing (decoder/nhw_decoder.c:93-491)
    z = np.zeros(0, np.int64)
    sub1 = add1 = sub5 = add5 = sub6 = add6 = z
    add43 = sub43 = add2 = sub2 = z
    count0 = 4 * SZ  # de-serpentine leaves count at 4*IM_SIZE
    if q > T.LOW8:
        sub1, add1 = streams.decode_stream2(s.res1, s.res1_bit, s.res1_word)
        count0 = streams.stream_entry_count(len(s.res1_bit))
    if q >= T.HIGH1:
        sub5, add5 = streams.decode_stream2(s.res5, s.res5_bit, s.res5_word)
    if q > T.HIGH1:
        sub6, add6 = streams.decode_stream2(
            s.res6, s.res6_bit, s.res6_word,
            row_step=D, first_count=D, pack_shift=0)
    if q >= T.LOW1:
        add43, sub43, add2, sub2 = streams.decode_stream4(
            s.res3, s.res3_bit, s.res3_word)
        count0 = streams.stream_entry_count(len(s.res3_bit))

    _expand_sentinels_y(jpeg, count0, q)

    # LL2 placement (decoder/nhw_decoder.c:609-616)
    plane = jpeg.reshape(N, N)
    plane[:128, :128] = res_comp[: SZ >> 2].reshape(128, 128).astype(np.int16)

    # res4 parity re-add (decoder/nhw_decoder.c:618-645): 128 and >128
    # entries advance the row counter (>128 after use); each entry makes
    # 4 consecutive values odd — idempotent, so the scatter vectorizes
    if q > T.LOW3 and len(s.res4):
        b4 = s.res4.astype(np.int64)
        bump = b4 >= 128
        cnt = np.cumsum(bump) - bump           # exclusive: count at use
        sel = b4 != 128
        e4 = (cnt[sel] << 9) + b4[sel] - np.where(b4[sel] > 128, 129, 1)
        idx = (e4[:, None] + np.arange(4)).reshape(-1)
        jpeg[idx] |= 1

    # exw_Y escapes, Y section (decoder/nhw_decoder.c:647-658)
    exw = np.concatenate([s.exw_Y.astype(np.int64), np.zeros(4, np.int64)])
    i = 0
    while i < len(s.exw_Y):
        if not exw[i] and not exw[i + 1]:
            break
        if exw[i + 1] >= 128:
            val = exw[i + 2] + 255
            exw[i + 1] -= 128
        else:
            val = -exw[i + 2]
        jpeg[(exw[i] << 9) + exw[i + 1]] = val
        i += 3

    _isolated_smooth_y(jpeg, q)

    scat = _y_scatter_arrays(q, sub1, add1, sub5, add5,
                             add43, sub43, add2, sub2)
    hq = _y_hq_scatter_arrays(q, sub6, add6, s.char_res1, s.qsetting3)
    return jpeg, scat, hq


def decode_y_back(jpeg: np.ndarray, scat, hq, q: int) -> np.ndarray:
    """Host synthesis back end of the Y decode (the device replica is
    models.device_decode.decode_y_back_device): level-2 synthesis,
    residue scatter, deringing, level-1 synthesis with HQ injection,
    mark smoothing, final row synthesis, clip."""
    plane = jpeg.reshape(N, N)

    # level-2 synthesis (wavelet_synthesis(im, 256, 0, 1))
    proc = np.zeros(4 * SZ, dtype=np.int16)
    blk = plane[:D, :D]
    t1 = synth_unnorm(blk[:, :128], blk[:, 128:D]).astype(np.int16)
    ll1 = synth_norm(t1.T[:, :128], t1.T[:, 128:D])
    proc.reshape(N, N)[:D, :D] = ll1.astype(np.int16)

    # transform-domain residue add-back (decoder/nhw_decoder.c:721-787)
    _apply_pairs(proc, *scat)

    marks = _dering_mark_y(proc)

    # transpose LL1 into the coefficient plane (decoder/nhw_decoder.c:841-844)
    jp = jpeg.reshape(N, N)
    jp[:D, :D] = proc.reshape(N, N)[:D, :D].T

    # level-1 column synthesis + HQ residue injection (wavelet_synthesis2)
    from benchmark.reference import native

    nat = native.available()
    if nat:
        lib = native._load()
        ffi = native.ffi()
        proc = np.empty(4 * SZ, np.int16)
        lib.nhw_synth_plane_unnorm16(
            ffi.cast("const int16_t *", jp.ctypes.data), N,
            ffi.cast("int16_t *", proc.ctypes.data))
        _apply_pairs(proc, *hq)
        jpeg = np.empty(4 * SZ, np.int16)
        lib.nhw_transpose16(
            ffi.cast("const int16_t *", proc.ctypes.data), N,
            ffi.cast("int16_t *", jpeg.ctypes.data))
    else:
        proc = synth_unnorm(jp[:, :D], jp[:, D:]).reshape(-1).astype(np.int16)
        _apply_pairs(proc, *hq)
        jpeg = proc.reshape(N, N).T.copy().reshape(-1)

    # smooth marked pixels (decoder/nhw_decoder.c:850-867), x8 domain
    if nat and marks:
        lib = native._load()
        ffi = native.ffi()
        mk = np.asarray(marks, np.int32)
        lib.nhw_smooth_marks(ffi.cast("int16_t *", jpeg.ctypes.data),
                             ffi.cast("const int32_t *", mk.ctypes.data),
                             mk.size)
    else:
        for rec in marks:
            scan = ((rec >> 8) << 10) + (rec & 255)
            res = _lap8(jpeg, scan, N)
            if abs(res) < 116:
                jpeg[scan] = np.int16(
                    ((int(jpeg[scan]) << 2)
                     + int(jpeg[scan - 1]) + int(jpeg[scan + 1])
                     + int(jpeg[scan - N]) + int(jpeg[scan + N]) + 4) >> 3)

    # final row synthesis (wavelet_synthesis(im, 512, ..., Y=3)) + clip
    jp = jpeg.reshape(N, N)
    if nat:
        out = np.empty((N, N), np.uint8)
        lib.nhw_synth_plane_norm_clip(
            ffi.cast("const int16_t *", np.ascontiguousarray(jp).ctypes.data),
            N, ffi.cast("uint8_t *", out.ctypes.data))
        return out
    y = synth_norm(jp[:, :D], jp[:, D:])
    return np.clip(y, 0, 255).astype(np.uint8)


def decode_y(s: NHWStreams, res_comp: np.ndarray) -> np.ndarray:
    """Full Y decode: symbol stream -> (512,512) uint8 plane."""
    jpeg, scat, hq = decode_y_front(s, res_comp)
    return decode_y_back(jpeg, scat, hq, s.quality)


# ---------------------------------------------------------------------------
# UV pipeline


def _uv_sentinels(jpeg: np.ndarray, proc: np.ndarray) -> None:
    """UV residue sentinels 5003-5006 (decoder/nhw_decoder.c:991-1069).
    Reads the coefficient plane, adjusts the synthesized half-res plane;
    the adjustments are pure scatter-adds."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_uv_sentinels(ffi.cast("int16_t *", jpeg.ctypes.data),
                             ffi.cast("int16_t *", proc.ctypes.data))
        return

    half = SZ >> 1

    def handle(scan: int, tgt: int) -> None:
        v = int(jpeg[scan])
        if v == 5005:
            proc[tgt] -= 4
            proc[tgt + 1] -= 4
            jpeg[scan] = 0
        elif v == 5006:
            proc[tgt] += 4
            proc[tgt + 1] += 4
            jpeg[scan] = 0
        elif v == 5003:
            proc[tgt] -= 6
            jpeg[scan] = 0
        elif v == 5004:
            proc[tgt] += 6
            jpeg[scan] = 0

    jp = jpeg.reshape(D, D)
    r, c = np.nonzero(jp[:128, 128:] > 5000)
    for k in range(len(r)):
        scan = int(r[k]) * D + 128 + int(c[k])
        handle(scan, scan - 128)

    r, c = np.nonzero(jp[128:, :] > 5000)
    for k in range(len(r)):
        col = int(c[k])
        scan = (128 + int(r[k])) * D + col
        handle(scan, scan - half - (128 if col >= 128 else 0))


def _uv_sharpen(proc: np.ndarray, quality: int) -> None:
    """Laplacian sharpen (decoder/nhw_decoder.c:1082-1109), raster
    Gauss-Seidel.  Each update shifts at most 4 later laplacians by <=3
    each, so candidates within 12 of the threshold cover all reachable
    triggers; they are then replayed in raster order with live reads."""
    thr = 35 if quality <= T.LOW6 else 60
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_uv_sharpen(ffi.cast("int16_t *", proc.ctypes.data), thr)
        return

    lap = _lap_plane(proc.reshape(D, D))
    r, c = np.nonzero(np.abs(lap[1:255, 1:255]) > thr - 13)
    for k in range(len(r)):
        scan = (int(r[k]) + 1) * D + int(c[k]) + 1
        res = _lap8(proc, scan, D)
        if res > thr:
            proc[scan] += 3 if res > 160 else 2
        elif res < -thr:
            proc[scan] -= 3 if res < -160 else 2


def _upsample2x(plane: np.ndarray) -> np.ndarray:
    """Bilinear x2, vertical then horizontal, u8 domain
    (decoder/nhw_decoder.c:1137-1181)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        pc = np.ascontiguousarray(plane, np.int16)
        out = np.empty((N, N), np.uint8)
        lib.nhw_upsample2x(ffi.cast("int16_t *", pc.ctypes.data),
                           ffi.cast("uint8_t *", out.ctypes.data))
        return out

    p = plane.astype(np.int32)
    v = np.empty((N, D), dtype=np.int32)
    v[0: N - 2: 2] = p[: D - 1]
    v[1: N - 1: 2] = (p[: D - 1] + p[1:] + 1) >> 1
    v[N - 2] = p[D - 1]
    v[N - 1] = p[D - 1]
    h = np.empty((N, N), dtype=np.int32)
    h[:, 0: N - 2: 2] = v[:, : D - 1]
    h[:, 1: N - 1: 2] = (v[:, : D - 1] + v[:, 1:] + 1) >> 1
    h[:, N - 2] = v[:, D - 1]
    h[:, N - 1] = v[:, D - 1]
    return h.astype(np.uint8)


def decode_uv_front(s: NHWStreams, res_comp: np.ndarray, sym_uv: np.ndarray,
                    component: int, exw_start: int) -> tuple[np.ndarray, int]:
    """Host front of one chroma plane: de-serpentine, LL2 placement, exw
    escapes (decoder/nhw_decoder.c:904-979).  Returns (coefficient plane
    (256*256,) int16, exw index after this component's section)."""
    q = s.quality
    jpeg = geometry.deserpentine_uv(sym_uv, component).reshape(-1).astype(np.int16)

    # LL2 placement 64x64, +1 at low quality (decoder/nhw_decoder.c:943-963)
    ll2_off = (SZ >> 2) + component * (SZ >> 4)
    ll2 = res_comp[ll2_off: ll2_off + (SZ >> 4)].reshape(64, 64).astype(np.int16)
    if q <= T.LOW5:
        ll2 = ll2 + 1
    jpeg.reshape(D, D)[:64, :64] = ll2

    # exw escapes for this component (decoder/nhw_decoder.c:965-979,
    # 1257-1269; the V section has no terminator check)
    exw = np.concatenate([s.exw_Y.astype(np.int64), np.zeros(4, np.int64)])
    i = exw_start
    while i < len(s.exw_Y):
        if component == 0 and not exw[i] and not exw[i + 1]:
            break
        if exw[i + 1] >= 128:
            val = exw[i + 2] + 255
            e1 = exw[i + 1] - 128
        else:
            val = -exw[i + 2]
            e1 = exw[i + 1]
        jpeg[(exw[i] << 8) + e1] = val
        i += 3
    return jpeg, i


def decode_uv_synth(jpeg: np.ndarray) -> np.ndarray:
    """Host synthesis core of one chroma plane (device replica:
    models.device_decode.uv_synth_device): level-2 synthesis, residue
    sentinels, full synthesis to 256x256.  Mutates ``jpeg``; returns the
    pre-sharpen (256*256,) int16 plane."""
    from benchmark.reference import native

    jp = jpeg.reshape(D, D)
    nat = native.available() and jp.flags.c_contiguous
    if nat:
        lib = native._load()
        ffi = native.ffi()
        proc = np.zeros(SZ, dtype=np.int16)
        # level-2 synthesis (wavelet_synthesis(im, 128, 0, 0)); the
        # intermediate jpeg[:128,:128] mutation is overwritten below
        lib.nhw_synthesis_stage(
            ffi.cast("int16_t *", jp.ctypes.data),
            ffi.cast("int16_t *", proc.ctypes.data), D, 128, 1, 2)
    else:
        t1 = synth_unnorm(jp[:128, :64], jp[:128, 64:128]).astype(np.int16)
        ll1 = synth_norm(t1.T[:, :64], t1.T[:, 64:128])
        proc = np.zeros(SZ, dtype=np.int16)
        proc.reshape(D, D)[:128, :128] = ll1.astype(np.int16)

    _uv_sentinels(jpeg, proc)

    # transpose 128x128, then full synthesis to 256x256
    jp = jpeg.reshape(D, D)
    jp[:128, :128] = proc.reshape(D, D)[:128, :128].T
    if nat:
        out = np.empty((D, D), np.int16)
        lib.nhw_synthesis_stage(
            ffi.cast("int16_t *", jp.ctypes.data),
            ffi.cast("int16_t *", out.ctypes.data), D, D, 1, 2)
        return out.reshape(-1)
    t2 = synth_unnorm(jp[:, :128], jp[:, 128:]).astype(np.int16)
    out = synth_norm(t2.T[:, :128], t2.T[:, 128:])
    return out.reshape(-1).astype(np.int16)


def decode_uv_back(proc: np.ndarray, q: int) -> np.ndarray:
    """Sharpen + clip + bilinear upsample -> (512,512) uint8
    (decoder/nhw_decoder.c:1082-1181)."""
    _uv_sharpen(proc, q)
    np.clip(proc, 0, 255, out=proc)
    return _upsample2x(proc.reshape(D, D))


def decode_uv_plane(s: NHWStreams, res_comp: np.ndarray, sym_uv: np.ndarray,
                    component: int, exw_start: int) -> tuple[np.ndarray, int]:
    """Decode one chroma plane -> (512,512) uint8.  Returns (plane,
    exw index after this component's section)."""
    jpeg, next_i = decode_uv_front(s, res_comp, sym_uv, component, exw_start)
    proc = decode_uv_synth(jpeg)
    return decode_uv_back(proc, s.quality), next_i


# ---------------------------------------------------------------------------
# full decode


def _y_exw_end(s: NHWStreams) -> int:
    exw = np.concatenate([s.exw_Y.astype(np.int64), np.zeros(4, np.int64)])
    i = 0
    while i < len(s.exw_Y):
        if not exw[i] and not exw[i + 1]:
            break
        i += 3
    return i


def decode_planes(data: bytes) -> tuple[np.ndarray, np.ndarray, np.ndarray, int]:
    """Decode a .nhw byte string -> (Y, U, V) 512x512 uint8 planes + quality."""
    s = parse_nhw(data)
    res_comp = dc_plane.decode_dc_planes(
        s.res_ch, s.highres_comp, s.res_U_64, s.res_V_64,
        s.quality, s.res_high)

    y = decode_y(s, res_comp)

    sym_uv = entropy.decode_uv(s.packet2, s.tree2, s.tree_end)

    # the exw continuation skips the Y terminator "0,0" as 2 bytes, not 3
    # (decoder/nhw_decoder.c:965: exw1+=2)
    exw1 = _y_exw_end(s)
    u, exw1 = decode_uv_plane(s, res_comp, sym_uv, 0, exw1 + 2)
    v, _ = decode_uv_plane(s, res_comp, sym_uv, 1, exw1 + 2)
    return y, u, v, s.quality


def yuv_to_rgb(y: np.ndarray, u: np.ndarray, v: np.ndarray,
               quality: int) -> np.ndarray:
    """YUV->RGB with the reference's per-quality float semantics
    (decoder/nhw_decoder_cli.c:133-283).  Returns (512,512,3) uint8 in the
    reference's byte order."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        if quality >= T.NORM:
            mode, yinv = 0, 0.0
        elif quality == T.LOW3:
            mode, yinv = 1, float(np.float32(T.Y_INV[quality]))
        elif quality in (T.LOW1, T.LOW2):
            mode, yinv = 2, float(np.float32(T.Y_INV[quality]))
        else:
            mode, yinv = 3, float(np.float32(T.Y_INV[quality]))
        ya = np.ascontiguousarray(y, np.uint8)
        ua = np.ascontiguousarray(u, np.uint8)
        va = np.ascontiguousarray(v, np.uint8)
        out = np.empty((512, 512, 3), np.uint8)
        lib.nhw_yuv_to_rgb(
            ffi.cast("const uint8_t *", ya.ctypes.data),
            ffi.cast("const uint8_t *", ua.ctypes.data),
            ffi.cast("const uint8_t *", va.ctypes.data),
            ffi.cast("uint8_t *", out.ctypes.data), mode, yinv,
            T.R_COMP, T.G_COMP, T.B_COMP)
        return out

    if quality >= T.NORM or quality in (T.LOW1, T.LOW2, T.LOW3):
        uf = u.astype(np.float64) - 128.0
        vf = v.astype(np.float64) - 128.0
        if quality >= T.NORM:
            yq = y.astype(np.float64)
            r = yq + 1.402 * vf + 0.5
            g = yq - 0.34414 * uf - 0.71414 * vf + 0.5
            b = yq + 1.772 * uf + 0.5
        elif quality == T.LOW3:
            yinv = np.float64(np.float32(T.Y_INV[quality]))
            yq = y.astype(np.float64)
            r = (yq + 1.402 * vf) * yinv + 0.5
            g = (yq - 0.34414 * uf - 0.71414 * vf) * yinv + 0.5
            b = (yq + 1.772 * uf) * yinv + 0.5
        else:  # LOW1 / LOW2: Y pre-scaled in float32
            yinv = np.float32(T.Y_INV[quality])
            yq = (y.astype(np.float32) * yinv).astype(np.float64)
            r = yq + 1.402 * vf + 0.5
            g = yq - 0.34414 * uf - 0.71414 * vf + 0.5
            b = yq + 1.772 * uf + 0.5
        rgb = np.trunc(np.stack([r, g, b], axis=-1)).astype(np.int64)
    else:
        # integer matrix path, q<=LOW4 (decoder/nhw_decoder_cli.c:237-283)
        yinv = np.float32(T.Y_INV[quality])
        yi = y.astype(np.int64) * 298
        ui = u.astype(np.int64)
        vi = v.astype(np.int64)
        half = np.float32(128.5)

        def chan(acc: np.ndarray) -> np.ndarray:
            f = acc.astype(np.float32) * yinv + half
            return np.trunc(f).astype(np.int64) >> 8

        r = chan(yi + 409 * vi + T.R_COMP)
        g = chan(yi - 100 * ui - 208 * vi + T.G_COMP)
        b = chan(yi + 516 * ui + T.B_COMP)
        rgb = np.stack([r, g, b], axis=-1)

    out = np.where((rgb >> 8) != 0, np.where(rgb < 0, 0, 255), rgb)
    return out.astype(np.uint8)


def decode(data: bytes) -> np.ndarray:
    """Decode .nhw bytes -> (512,512,3) uint8 pixel array (reference byte
    order, see utils.bmp)."""
    y, u, v, q = decode_planes(data)
    return yuv_to_rgb(y, u, v, q)


def decode_to_bmp(nhw_path, bmp_path) -> None:
    """CLI-equivalent: .nhw file -> .bmp file, byte-identical to nhw-dec."""
    from pathlib import Path

    rgb = decode(Path(nhw_path).read_bytes())
    bmp_io.write_bmp512(bmp_path, rgb)
