# Frozen copy of nhwcodec_tpu_torch/host/ops/prefilter.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Y pre-processing ("neatness/sharpness" filter).

Reference behavior: pre_processing (encoder/image_processing.c:558-2426).

The filter computes an 8-neighbour gradient kernel with a 4-bit
error-feedback accumulator carried along the raster scan, then walks the
kernel in column pairs nudging pixels.  For q>LOW4 (q>=17) the walk is a
small local automaton (the ``e``/``a`` carries below); for q<=LOW4 the
reference adds ~40 interacting duty-cycle counters (t1..t44) — that path
lands with the low-quality sweep.

The kernel's gradient sums are vectorized; the 4-bit accumulator chain
and the pair walk run as fast host scans over flat lists (the carries are
single-pixel, mapping to a ``lax.scan`` on device).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

N = 512
SZ4 = 4 * 65536


def _gradient_sums(plane: np.ndarray) -> tuple[np.ndarray, np.ndarray]:
    """res (signed 8-neighbour gradient sum) and count (abs sum) for the
    interior (encoder/image_processing.c:605-618)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        pc = np.ascontiguousarray(plane, np.int16)
        res = np.zeros((N, N), np.int32)
        cnt = np.zeros((N, N), np.int32)
        lib.nhw_gradient_sums(ffi.cast("int16_t *", pc.ctypes.data),
                              ffi.cast("int32_t *", res.ctypes.data),
                              ffi.cast("int32_t *", cnt.ctypes.data))
        return res, cnt

    p = plane.astype(np.int32)
    res = np.zeros((N, N), np.int32)
    cnt = np.zeros((N, N), np.int32)
    c = p[1:-1, 1:-1]
    ws = [c - p[1:-1, :-2], c - p[1:-1, 2:], c - p[:-2, 1:-1],
          c - p[2:, 1:-1], c - p[:-2, 2:], c - p[:-2, :-2],
          c - p[2:, :-2], c - p[2:, 2:]]
    res[1:-1, 1:-1] = sum(ws)
    cnt[1:-1, 1:-1] = sum(np.abs(w) for w in ws)
    return res, cnt


def _kernel_pass_simple(res: np.ndarray, cnt: np.ndarray) -> np.ndarray:
    """nhw_kernel for q>LOW4 (encoder/image_processing.c:601-764 with the
    low-quality gates off): res4 is a 4-bit accumulator carried across the
    whole raster (reset on res==0)."""
    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        rf = np.ascontiguousarray(res.reshape(-1), np.int32)
        cf = np.ascontiguousarray(cnt.reshape(-1), np.int32)
        out = np.zeros(SZ4, np.int32)
        lib.nhw_kernel_simple(ffi.cast("int32_t *", rf.ctypes.data),
                              ffi.cast("int32_t *", cf.ctypes.data),
                              ffi.cast("int32_t *", out.ctypes.data))
        return out

    kernel = np.zeros(SZ4, np.int32)
    rf = res.reshape(-1).tolist()
    cf = cnt.reshape(-1).tolist()
    kf = kernel  # numpy for final store; build in list for speed
    out = [0] * SZ4
    res4 = 0
    for r in range(1, 511):
        base = r * N
        for scan in range(base + 1, base + 511):
            v = rf[scan]
            if v < 0:
                res4 = 15 * (-v) + cf[scan] + ((res4 + 2) >> 2)
                out[scan] = -(res4 >> 4)
                res4 &= 15
            elif v > 0:
                res4 = 15 * v + cf[scan] + ((res4 + 2) >> 2)
                out[scan] = res4 >> 4
                res4 &= 15
            else:
                out[scan] = 0
                res4 = 0
    kf[:] = out
    return kernel


# Identity-keyed single-entry caches with a weakref liveness guard:
# content keys (tobytes + hash of a 512KB plane) cost ~0.3 ms per
# encode; identity keys are free.  A stale id can never alias — the
# weakref must still resolve to the SAME object for a hit.  Contract:
# callers must not mutate the keyed plane in place between the
# pre-filter and the encoder's kernel-head read (encode() never does;
# both copy before filtering).
_KERNEL_CACHE: dict[int, tuple] = {}

# final q<=LOW4 kernel state (post pair-walk/sentinel/sharpen mutations):
# the encoder's q<LOW6 cleanup reads the reference's freed-kernel slack,
# which reflects this free-time state, not the initial kernel pass
_FINAL_KERNEL_CACHE: dict[int, tuple] = {}


def _fingerprint(arr):
    """64 strided samples of the plane — a cheap staleness probe for the
    identity key: a caller that reuses the same ndarray object with new
    contents between encodes (the contract forbids in-place mutation,
    but lower-level entry points accept caller-owned planes) is caught
    unless the mutation misses every sampled element."""
    if isinstance(arr, np.ndarray) and arr.size:
        flat = arr.reshape(-1)
        return flat[:: max(1, flat.size // 64)].copy()
    return None


def _cache_get(cache: dict, arr: np.ndarray, quality: int):
    ent = cache.get(id(arr))
    if ent is not None:
        wref, q0, fp, val = ent
        if (q0 == quality and wref() is arr
                and (fp is None or np.array_equal(fp, _fingerprint(arr)))):
            return val
    return None


def _cache_put(cache: dict, arr: np.ndarray, quality: int, val) -> None:
    import weakref

    cache.clear()
    try:
        cache[id(arr)] = (weakref.ref(arr), quality, _fingerprint(arr), val)
    except TypeError:  # non-weakref-able input (plain lists in tests)
        pass


def final_low_kernel(yplane: np.ndarray, quality: int) -> np.ndarray:
    """The nhw_kernel contents at free time for the q<=LOW4 path (flat
    int32).  Computed as a side effect of _pre_process_y_low and cached;
    replays the pre-filter if called first."""
    hit = _cache_get(_FINAL_KERNEL_CACHE, yplane, quality)
    if hit is None:
        _pre_process_y_low(yplane, quality)
        hit = _cache_get(_FINAL_KERNEL_CACHE, yplane, quality)
    return hit


def kernel_for(yplane: np.ndarray, quality: int) -> np.ndarray:
    """The nhw_kernel plane (flat int32) — also needed by the encoder to
    reproduce the reference's heap-tail reads past its tree1 buffer.
    Cached by plane identity (computed once per encode)."""
    hit = _cache_get(_KERNEL_CACHE, yplane, quality)
    if hit is not None:
        return hit

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        pc = np.ascontiguousarray(yplane, np.int16)
        k = np.zeros(SZ4, np.int32)
        lib.nhw_kernel_simple_fused(ffi.cast("int16_t *", pc.ctypes.data),
                                    ffi.cast("int32_t *", k.ctypes.data))
    else:
        res_a, cnt_a = _gradient_sums(yplane)
        k = _kernel_pass_simple(res_a, cnt_a)
    _cache_put(_KERNEL_CACHE, yplane, quality, k)
    return k


def pre_process_y(yplane: np.ndarray, quality: int) -> np.ndarray:
    """(512,512) int16 luma -> pre-filtered luma (new array)."""
    if quality <= T.LOW4:
        return _pre_process_y_low(yplane, quality)

    jpeg = yplane.astype(np.int16).copy()
    kernel = kernel_for(yplane, quality)

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        kc = np.ascontiguousarray(kernel, np.int32)
        lib.nhw_pair_walk_simple(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int32_t *", kc.ctypes.data))
        return jpeg

    jf = jpeg.reshape(-1)
    kf = kernel.tolist()
    a = 0
    for r in range(1, 511):
        base = r * N
        j = 1
        while j < 510:
            s0 = base + j       # scan-1 in the C pair walk
            s1 = base + j + 1   # scan
            res = kf[s0]
            count = kf[s1]

            # >176/201 nudges (encoder/image_processing.c:813-837)
            if res > 201:
                jf[s0] -= 2
                e = 4
            elif res < -201:
                jf[s0] += 2
                e = 3
            elif res > 176:
                jf[s0] -= 1
                e = 2
            elif res < -176:
                jf[s0] += 1
                e = 1
            else:
                e = 0
            if count > 201:
                if e == 0 or e == 3:
                    jf[s1] -= 2
                elif e != 4:
                    jf[s1] -= 1
            elif count < -201:
                if e == 0 or e == 4:
                    jf[s1] += 2
                elif e != 3:
                    jf[s1] += 1
            elif count > 176:
                if e != 4:
                    jf[s1] -= 1
            elif count < -176:
                if e != 3:
                    jf[s1] += 1

            # the +-10..32 ladder (encoder/image_processing.c:1927-1990)
            if 10 < res < 32:
                if abs(count) >= 23:
                    if res < 16:
                        if 0 < count < 32 and res > 11:
                            jf[s1] += 1
                        jf[s0] += 1
                        a = 0
                        j += 2
                        continue
                    else:
                        jf[s0] += 2 if not a else 1
                        a = 0
                        j += 2
                        continue
            elif -32 < res < -10:
                if abs(count) >= 23:
                    if res > -16:
                        if -32 < count < 0 and res < -11:
                            jf[s1] -= 1
                        jf[s0] -= 1
                        a = 0
                        j += 2
                        continue
                    else:
                        jf[s0] -= 2 if not a else 1
                        a = 0
                        j += 2
                        continue

            a = 0
            if 10 < count < 32:
                if abs(res) >= 23:
                    if count < 16:
                        if 0 < res < 32 and count > 11:
                            jf[s0] += 1
                        jf[s1] += 1
                    else:
                        jf[s1] += 2
                        a = 1
            elif -32 < count < -10:
                if abs(res) >= 23:
                    if count > -16:
                        if -32 < res < 0 and count < -11:
                            jf[s0] -= 1
                        jf[s1] -= 1
                    else:
                        jf[s1] -= 2
                        a = 1
            j += 2
    return jpeg


# ---------------------------------------------------------------------------
# q<=LOW4 path (encoder/image_processing.c:570-2423): the full duty-cycle
# automaton.  ~40 interacting counters carried across the raster walk; a
# faithful sequential transcription (candidates are dense at low quality,
# so no sparse shortcut applies).

SHARPNESS = {T.LOW4: 59, T.LOW5: 54, T.LOW6: 49, T.LOW7: 44, T.LOW8: 41,
             T.LOW9: 35, T.LOW10: 17, T.LOW11: 1, T.LOW12: 0, T.LOW13: 0,
             T.LOW14: 0, T.LOW15: 24, T.LOW16: 24, T.LOW17: 36,
             T.LOW18: 45, T.LOW19: 48}


def _n1_for(q: int) -> int:
    if q > T.LOW11:
        return 36
    if q == T.LOW11:
        return 24
    if q == T.LOW12:
        return 10
    if q == T.LOW13:
        return 6
    return {T.LOW14: 36, T.LOW15: 36, T.LOW16: 36, T.LOW17: 36,
            T.LOW18: 56, T.LOW19: 60}.get(q, 36)


def _kernel_pass_low4(res_arr, cnt_arr, sharpness, sharpn2):
    """nhw_kernel for q<=LOW4 (encoder/image_processing.c:601-764): the
    res4 accumulator plus the 20000/-20000/7000 sentinel machinery."""
    out = [0] * SZ4
    rf = res_arr.reshape(-1).tolist()
    cf = cnt_arr.reshape(-1).tolist()
    res4 = 0
    res3 = 0
    a = 0
    t1 = t2 = t4 = t5 = t6 = t7 = 0
    for r in range(1, 511):
        base = r * N
        for j in range(1, 511):
            scan = base + j
            v = rf[scan]
            if v < 0:
                res4 = 15 * (-v) + cf[scan] + ((res4 + 2) >> 2)
                res2 = -(res4 >> 4)
                res4 &= 15
                if res2 == -sharpn2:
                    if t7 < 3:
                        res2 = -sharpn2 - 1
                        t7 += 1
                if abs(v) <= sharpn2 and abs(res2) > sharpn2 \
                        and abs(res2) <= sharpn2 + 20:
                    if j > 1 and abs(out[scan - 1]) <= (sharpness >> 1):
                        res3 = 0
                    if not res3:
                        out[scan] = -20000
                        res3 = 1
                    else:
                        out[scan] = res2
                        if not t1:
                            res3 = 0
                            t1 = 1
                        else:
                            if res3 == 1:
                                res3 = 2
                            else:
                                res3 = 0
                                if t1 == 1:
                                    t1 = 2
                                elif t1 == 2:
                                    t1 = 3
                                else:
                                    t1 = 0
                else:
                    out[scan] = res2
            elif v > 0:
                res4 = 15 * v + cf[scan] + ((res4 + 2) >> 2)
                res2 = res4 >> 4
                res4 &= 15
                if v <= sharpn2 and res2 > sharpn2 and res2 <= sharpn2 + 20:
                    if j > 1 and abs(out[scan - 1]) <= (sharpness >> 1):
                        a = 0
                    elif j > 1 and (abs(out[scan - 1]) > 10000
                                    or out[scan - 1] == sharpn2 + 21):
                        if not t4:
                            a = 0
                            if not t2:
                                t2 = 1
                            t4 = 1
                        else:
                            t4 = 0
                    elif j > 1 and out[scan - 1] == -(sharpn2 + 21):
                        if not t5:
                            t5 = 1
                        else:
                            if not t4:
                                a = 0
                                if not t2:
                                    t2 = 1
                                t4 = 1
                            else:
                                t4 = 0
                            if t5 == 1:
                                t5 = 2
                            else:
                                t5 = 0
                    elif j > 1 and out[scan - 1] == sharpn2 + 22:
                        out[scan - 1] = 7000
                    if not a:
                        out[scan] = 20000
                        a = 1
                    else:
                        out[scan] = res2
                        if not t2:
                            a = 0
                            t2 = 1
                        else:
                            if a == 1:
                                a = 2
                            else:
                                a = 0
                                if t2 == 1:
                                    t2 = 2
                                elif t2 == 2:
                                    t2 = 3
                                else:
                                    t2 = 0
                elif res2 == sharpn2 + 21:
                    if not t6:
                        out[scan] = 7000
                    else:
                        out[scan] = res2
                    t6 += 1
                else:
                    out[scan] = res2
            else:
                out[scan] = 0
                res4 = 0
    return out


def _pair_walk_low(jf, pf, kf, quality, sharpness, sharpn2, n1,
                   sharp_on):
    """The q<=LOW4 pair walk (encoder/image_processing.c:770-1991), with
    the lower-quality smoothing and the +-10..32 ladder gates."""
    low_on = quality <= T.LOW6
    ladder_on = (quality > T.LOW6
                 or (quality <= T.LOW10 and quality > T.LOW13))
    a = 0
    t1 = t2 = t3 = t4 = t5 = 0
    t6 = 8
    t7 = t8 = t9 = 0
    t10 = 10
    t11 = 15
    t12 = t13 = t14 = t15 = t16 = t17 = 0
    t18 = 8
    t19 = t20 = t21 = t22 = t23 = t24 = t25 = t26 = t27 = 0
    t28 = t29 = t30 = t31 = t32 = t33 = t34 = t35 = t36 = t37 = 0
    t38 = t39 = t40 = t41 = t42 = t43 = 0
    t44 = 2
    w1 = w2 = 0
    w3 = 20
    w4 = w5 = w6 = w7 = w8 = 0

    for r in range(1, 511):
        base = r * N
        i_flat = base
        j = 1
        while j < 510:
            s0 = base + j
            s1 = base + j + 1
            res = kf[s0]
            count = kf[s1]

            if low_on:
                if 4 < abs(res) < n1:
                    sc = s0
                    if abs(pf[sc - N] - pf[sc - 1]) < 4 \
                            and abs(pf[sc - 1] - pf[sc + N]) < 4 \
                            and abs(pf[sc + N] - pf[sc + 1]) < 4 \
                            and abs(pf[sc + 1] - pf[sc - N]) < 4:
                        jf[sc] = ((pf[sc] << 2) + pf[sc - 1] + pf[sc + 1]
                                  + pf[sc - N] + pf[sc + N] + 4) >> 3
                if 4 < abs(count) < n1:
                    sc = s1
                    if abs(pf[sc - N] - pf[sc - 1]) < 4 \
                            and abs(pf[sc - 1] - pf[sc + N]) < 4 \
                            and abs(pf[sc + N] - pf[sc + 1]) < 4 \
                            and abs(pf[sc + 1] - pf[sc - N]) < 4:
                        jf[sc] = ((pf[sc] << 2) + pf[sc - 1] + pf[sc + 1]
                                  + pf[sc - N] + pf[sc + N] + 4) >> 3

            # --- the t-automaton (838-1924)
            if not t1:
                t2 = 0
                if abs(res) > sharpness:
                    if res > 0:
                        jf[s0] += 2
                    else:
                        jf[s0] -= 2
                    if abs(count) > sharpn2 or t8 == 1:
                        kf[s0] = 0
                        if (t19 < SZ4 or (3 <= t20 < SZ4)) \
                                and abs(res) > sharpness + 96 and t6 > 0 \
                                and i_flat > 2 * N:  # C: 4*IM_DIM
                            if t20 >= 3 and t19 >= 2 * SZ4:
                                t6 = 7000000
                                t20 = 2 * SZ4
                            if 0 < t19 < SZ4:
                                if t20 > 2 or (t20 == 2 and t6 > 3
                                               and not t23) \
                                        or (t20 == 2 and t6 > 14 and t23 > 0):
                                    if t23 == 1:
                                        t6 = 5000000
                                    t23 += 1
                                    t21 += 1
                                    if t21 >= 2:
                                        t19 = 2 * SZ4
                            if not t19:
                                t6 += 1
                                t20 = 1
                            t19 += 1
                    t2 = 1
                if abs(count) > sharpness:
                    if (t2 == 1 or t12 == 1) and (not t14 or t14 == 4
                                                  or t14 == 5):
                        if not t3 and t2 == 1:
                            if abs(res) > 3000:
                                res = sharpn2 + 5 if res > 0 \
                                    else -sharpn2 - 5
                            if abs(count) > 3000:
                                count = sharpn2 + 22 if count > 0 \
                                    else -sharpn2 - 22
                            if abs(res) < (abs(count) >> 2):
                                if res > 0:
                                    jf[s0] -= 1
                                else:
                                    jf[s0] += 1
                                kf[s0] = res
                                if count > 0:
                                    jf[s1] += 2
                                else:
                                    jf[s1] -= 2
                                if abs(res) > sharpn2:
                                    kf[s1] = 0
                            else:
                                if count > 0:
                                    jf[s1] += 1
                                else:
                                    jf[s1] -= 1
                            t3 = 1
                        else:
                            if count > 0:
                                jf[s1] += 2
                            else:
                                jf[s1] -= 2
                            if abs(res) > sharpn2:
                                kf[s1] = 0
                            if t3 == 1:
                                t3 = 2
                            elif t3 == 2:
                                t3 = 3
                            else:
                                t3 = 0
                    else:
                        if count > 0:
                            jf[s1] += 2
                        else:
                            jf[s1] -= 2
                        if abs(res) > sharpn2:
                            kf[s1] = 0
                    if t14 == 2:
                        t14 = 1
                        t26 = 3
                        if t25 > 0:
                            t25 += 1
                    if t14 == 1:
                        if t26 < 4:
                            t26 += 1
                        else:
                            t14 = 2
                            t26 = 0
                if abs(res) > sharpness or abs(count) > sharpness:
                    t13 = 1
                if t14 == 1 or t14 == 2:
                    t27 += 1
                else:
                    t27 = 0
                if t27 > 2:
                    t14 = 1
                if t14 == 1:
                    t14 = 4
                    if not t25:
                        t15 += 1
                        t25 = 1
                    else:
                        t25 += 1
                        if t25 > 3:
                            t25 = 0
                t1 = 1
            else:
                if abs(res) > sharpness:
                    if res > 0:
                        jf[s0] += 1
                    else:
                        jf[s0] -= 1
                    t1 += 1
                    t4 += 1
                if abs(count) > sharpness:
                    if count > 0:
                        jf[s1] += 1
                    else:
                        jf[s1] -= 1
                    t1 += 1
                    t4 += 1

                if t4 < 10:
                    t17 = 1 if (t4 == t10 and t1 == t11) else 0
                else:
                    if t4 > 10 or t1 != 15:
                        if not t18:
                            t17 = 1
                            t18 = 1
                        else:
                            t17 = 0
                            t18 += 1
                            if t18 > 15:
                                t18 = 0
                    elif t4 == t10 and t1 == t11:
                        t17 = 1
                    else:
                        t17 = 0

                if t6 > 6000000:
                    t6 = 0
                    t22 = 0
                elif t6 > 4000000:
                    t6 = 0
                    t22 = 1 if t21 == 1 else 0

                if t17 == 1 or t1 > 2000003:
                    if not t6:
                        t6 = 1
                        t14 = 0
                        if not t22:
                            t7 += 1
                        if t22 == 1:
                            t22 = 0
                    else:
                        t6 += 1
                        t1 += 1
                        if t4 > 900000 and t1 == 12:
                            t4 = 8
                        if t1 > 3000000:
                            t1 = 12
                            t4 = 8
                        elif 2000006 < t1 < 2500000:
                            t1 = 14
                            t4 = 10
                        if not t15:
                            t14 = 1
                            t15 = 1
                        else:
                            t14 = 0
                            t15 += 1
                            if t15 > 9:
                                t15 = 0
                        if t6 > 15 and t7 < 4:
                            t6 = 0
                            if t19 > 0:
                                t20 += 1
                    if t4 == 8 or (t4 == 10 and w3 > 16):
                        if w3 < 21:
                            t4 = 0
                            w3 += 1
                        elif t4 == 8:
                            w3 = 0
                        else:
                            if w4 < 2:
                                t4 = 8
                                t1 = 12
                                w4 += 1
                            else:
                                t4 = 0
                                w4 = 0
                    else:
                        t4 = 0
                    t8 = 0
                    t5 = 0
                    t12 = 0
                    if t7 == 3:
                        if not t6:
                            t10, t11 = 10, 15
                        else:
                            t10, t11 = 8, 12
                    elif t7 == 1:
                        if t9 < 2:
                            t10, t11 = 10, 15
                            t9 += 1
                        else:
                            t10, t11 = 8, 12
                            t9 += 1
                            if t9 >= 3:
                                t9 = 0
                    elif t7 == 2:
                        t10, t11 = 8, 12
                    else:
                        if (t6 == 10 or t6 == 11) and not t7:
                            t10, t11 = 6, 9
                        elif t7 >= 4:
                            if not t16:
                                t10, t11 = 10, 15
                                t16 = 1
                                if (w7 == 2 or w7 == 4) and t24 == 14:
                                    if w7 == 2:
                                        t1 = 2000005
                                else:
                                    t4 = 1000000
                                    t1 = 9
                            elif t16 == 1:
                                t10, t11 = 8, 12
                                t16 = 2
                                w5 += 1
                                if w5 != 3:
                                    t4 = 10
                                    t1 += 2
                                elif 0 < t1 < 30:
                                    t1 = (-t1) >> 2
                                else:
                                    t4 = 10
                                    t1 += 2
                            elif t16 == 2:
                                t10, t11 = 10, 15
                                t16 = 3
                                t4 = 1000000
                                w6 += 1
                                if w6 == 6 or w6 == 10:
                                    t1 = 10
                            elif t16 == 3:
                                t10, t11 = 8, 12
                                t16 = 4
                                t4 = 8
                                t1 -= 4
                            elif t16 == 4:
                                t10, t11 = 10, 15
                                t16 = 5
                            elif t16 == 5:
                                t10, t11 = 10, 15
                                t16 = 6
                                t4 = 10
                                t1 = 2000000
                            elif t16 == 6:
                                t10, t11 = 8, 12
                                t16 = 7
                                t4 = 8
                                t1 = 3000000
                            elif t16 == 7:
                                t10, t11 = 8, 12
                                t16 = 8
                                t4 = 1000000
                            elif t16 == 8:
                                t10, t11 = 8, 12
                                if not t24:
                                    t16 = 1
                                    t24 = 1
                                    t4 = 1000000
                                elif t24 == 1:
                                    t16 = 2
                                    t24 = 2
                                elif t24 == 2:
                                    t16 = 1
                                    t24 = 3
                                    t4 = 1000000
                                elif t24 == 3:
                                    t16 = 2
                                    t24 = 4
                                elif t24 == 4:
                                    t16 = 1
                                    t24 = 5
                                    t1 = 2999998
                                elif t24 == 5:
                                    t16 = 0
                                    t24 = 6
                                elif t24 == 6:
                                    t16 = 3
                                    t24 = 7
                                elif t24 == 7:
                                    t16 = 3
                                    t24 = 8
                                    t1 = 7
                                elif t24 == 8:
                                    t16 = 1
                                    t24 = 9
                                elif t24 == 9:
                                    t16 = 8
                                    t24 = 10
                                    t4 = 1000000
                                elif t24 == 10:
                                    t16 = 1
                                    t24 = 11
                                    t4 = 8
                                    t1 = 11
                                elif t24 == 11:
                                    t16 = 0
                                    t24 = 12
                                elif t24 == 12:
                                    t16 = 1
                                    t24 = 13
                                elif t24 == 13:
                                    t16 = 0
                                    t24 = 14
                                elif t24 == 14:
                                    t16 = 1
                                    t24 = 15
                                    w7 += 1
                                    if w2 == 0:
                                        t1 = 1999978
                                    elif w2 == 1:
                                        t1 = 1999982
                                    else:
                                        t1 = 1999993
                                elif t24 == 15:
                                    t16 = 0
                                    t24 = 12
                                    if w2 == 1 or w2 == 3:
                                        t1 = -5
                                    else:
                                        t1 = 2000005
                                    w2 += 1
                        else:
                            t10 = 10 if t10 == 8 else 8
                            t11 = 15 if t11 == 12 else 12
                elif t1 >= 15:
                    if not t4:
                        t8 += 1
                    else:
                        t8 = 0
                        t5 = 0
                        t12 = 0
                    t1 += 1
                    if t4 < 2 and t29 > 0 and t14 == 4:
                        if not t31:
                            t14 = 3
                            t31 += 1
                        elif t31 == 1:
                            t14 = 3
                            t31 += 1
                        elif t31 == 2:
                            t14 = 0
                            t15 = 0
                            t31 += 1
                    if t14 == 5 and not t35 and 4 < t32 < 8:
                        t14 = 1
                        t32 -= 1
                        t35 += 1
                else:
                    if t1 == 6 and not w8:
                        t1 += 1
                        w8 += 1
                        t44 = -100000
                    elif t44 < -90000:
                        t1 += 1
                        w8 += 1
                        t44 = 0
                    else:
                        if t44 < 3:
                            t44 += 1
                        else:
                            t1 += 3
                            t44 = 0

                    if t29 > 0 and (t14 == 4 or t14 == 5 or t39 == 2
                                    or t41 > 0):
                        if t4 < 2 and t1 == 15 and (t14 == 4
                                                    or (t14 == 5 and t32 > 2)):
                            if t32 in (0, 2, 3) or (7 < t32 < 500000):
                                if t32 > 7 and t14 == 5:
                                    t14 = 1
                                    t32 = 1000000
                                else:
                                    if not t34:
                                        t34 = 1
                                    else:
                                        t14 = 5
                                        t34 = 0
                            if not t32:
                                t14 = 5
                            t32 += 1
                        elif t32 in (4, 5, 7):
                            if t37 == 4:
                                t14 = 3
                            elif t37 == 15:
                                t14 = 3
                                t32 += 1
                            elif t32 == 7:
                                if t37 > -345000:
                                    if t14 == 4:
                                        if not t42:
                                            t37 -= 10000
                                        if t38 > 0:
                                            t42 += 1
                                            if t42 > 0 or (not t42
                                                           and t43 > 3):
                                                if not t42:
                                                    if t43 == 14:
                                                        t14 = 3
                                                    elif t43 == 24:
                                                        t14 = 4
                                                    else:
                                                        t14 = 1
                                                else:
                                                    t14 = 1
                                                t39 = 0
                                                if t42 > 5:
                                                    t42 = -1
                                                    t43 += 1
                                            elif t42 == -1:
                                                t14 = 3
                                                t39 = 2
                                                t40 = -2
                                                t42 = 0
                                            else:
                                                t39 = 0
                                        else:
                                            t14 = 5
                                            t39 = 1
                                            t42 = 0
                                    elif t39 >= 1:
                                        t38 += 1
                                        if t39 < 2:
                                            if t38 in (2, 4, 6, 9):
                                                t39 = 2
                                            else:
                                                t39 = 0
                                        else:
                                            t40 += 1
                                            if t38 == 8:
                                                t39 = 0
                                                t40 = 0
                                            if t40 > 2:
                                                t40 = 0
                                                t39 = 0
                                        if 1 <= t38 <= 10:
                                            t14 = 4
                                    else:
                                        t40 = 1
                                        if t38 == 1:
                                            t39 = 2
                            if t37 >= 0:
                                t37 += 1
                        elif t32 == 6 and t36 < 118:
                            if t14 == 4 or t14 == 5 or t41 == 0 or t41 > 3:
                                t36 += 1
                            if t41 > 3 and t36 < 8:
                                t41 = 0
                            if t36 == 1:
                                t14, t41 = 1, 0
                            elif t36 == 2:
                                t14, t41 = 2, 0
                            elif t36 == 3:
                                t14, t41 = 1, 0
                            elif t36 == 4:
                                t14, t41 = 3, 0
                            elif t36 == 5:
                                t14 = 3
                                t41 += 1
                            elif t36 == 6:
                                t14, t41 = 0, 0
                            elif t36 == 7:
                                t14, t41 = 2, 0
                            elif t36 == 8:
                                t14, t41 = 2, 4
                            elif t36 == 15:
                                t14, t41 = 1, 0
                            elif t36 == 31:
                                t14 = 3
                                t41 += 1
                            elif t36 == 47:
                                t14, t41 = 2, 0
                            elif t36 == 100:
                                t14 = 0
                                t41 += 1
                            elif t36 == 116:
                                t14, t41 = 2, 0

                        if t28 < 14 and t1 > 7:
                            if t14 == 5 and not t28 and not t33 and t1 > 13 \
                                    and t31 > 0:
                                t30 = 1
                                t33 = t30 + 1
                            else:
                                t30 += 1
                            if not t28 and t30 > t33 + 10 and t33 > 0 \
                                    and t14 == 4:
                                t14 = 3
                                t15 += 6
                                t28 += 1
                            elif t28 == 1 and t30 > t33 + 70 and t14 == 4 \
                                    and t1 == 11:
                                t15 = 1
                                t1 = 13
                                t28 += 1
                            elif t28 == 2 and t31 > 2 and t1 == 15 \
                                    and t15 > 1:
                                t15 = 15
                                t33 = t30
                                t1 = 6
                                t28 += 1
                            elif t28 == 3 and t30 > t33 + 3 and t31 > 2:
                                t15 = 0
                                t28 += 1
                            elif t28 == 5 and t30 > t33 + 22 and t31 > 2 \
                                    and t1 == 12:
                                t15 = 3
                                t1 = 9
                                t28 += 1
                            elif t28 == 4 and t30 > t33 + 6 and t1 == 15:
                                t14 = 1
                                t15 += 6
                                t1 += 1
                                t28 += 1
                            elif t28 == 6 and t30 > t33 + 54:
                                t14 = 2
                                t15 = 3
                                t1 = 3
                                t28 += 1
                            elif t28 == 7 and t30 > t33 + 57:
                                t14 = 2
                                t15 = 8
                                t1 = 8
                                t28 += 1
                            elif t28 == 8 and t30 > t33 + 84:
                                t14 = 2
                                t15 = 7
                                t1 = 7
                                t28 += 1
                            elif t28 == 9 and t30 > t33 + 111:
                                t14 = 2
                                t15 = 3
                                t1 = 7
                                t28 += 1
                            elif t28 == 10 and t30 > t33 + 116:
                                t14 = 1
                                t15 = 0
                                t1 = 1
                                t4 = 8
                                t28 += 1
                            elif t28 == 11 and t30 > t33 + 185:
                                t14 = 0
                                t15 = 4
                                t1 = -17
                                t28 += 1
                            elif t28 == 12 and t30 > t33 + 187:
                                t14 = 3
                                t15 = 3
                                t1 = -19
                                t28 += 1
                            elif t30 == t33 + 9:
                                t1 += (12 - t4) >> 2
                                t4 = 10
                            elif t28 > 0 and t1 == 15 and w1 < 11:
                                if t4 != 10:
                                    if w1 == 4 or w1 == 10:
                                        t4 = 10
                                    w1 += 1
                            elif t28 == 13 and t30 > t33 + 188:
                                t14 = 0
                                t15 = 3
                                t1 = -30
                                t28 += 1

                if t8 > 6 and not t4 and 1 < t1 < 15:
                    t5 += 1
                    if t5 < 35:
                        t1 = 0
                        if not t13:
                            t12 = 1
                            t13 = 1
                        else:
                            t12 = 0
                            t13 += 1
                            if t13 > 3:
                                t13 = 0
                    else:
                        t12 = 0

                if 15 < t1 < 1000000:
                    t1 = 0
                    t4 = 0
                    t29 += 1

            if sharpness < abs(res) <= sharpness + 20 \
                    and sharpness < abs(count) <= sharpness + 20:
                if res > 0 and count < 0:
                    jf[s0] += 1
                    jf[s1] -= 1
                    sharp_on[s0] = 2
                    sharp_on[s1] = 3
                elif res < 0 and count > 0:
                    jf[s0] -= 1
                    jf[s1] += 1
                    sharp_on[s0] = 3
                    sharp_on[s1] = 2

            # --- the +-10..32 ladder (1927-1990), gated
            if ladder_on:
                if 10 < res < 32:
                    if abs(count) >= 23:
                        if res < 16:
                            if 0 < count < 32 and res > 11:
                                jf[s1] += 1
                            jf[s0] += 1
                            a = 0
                            j += 2
                            continue
                        else:
                            jf[s0] += 2 if not a else 1
                            a = 0
                            j += 2
                            continue
                elif -32 < res < -10:
                    if abs(count) >= 23:
                        if res > -16:
                            if -32 < count < 0 and res < -11:
                                jf[s1] -= 1
                            jf[s0] -= 1
                            a = 0
                            j += 2
                            continue
                        else:
                            jf[s0] -= 2 if not a else 1
                            a = 0
                            j += 2
                            continue
                a = 0
                if 10 < count < 32:
                    if abs(res) >= 23:
                        if count < 16:
                            if 0 < res < 32 and count > 11:
                                jf[s0] += 1
                            jf[s1] += 1
                        else:
                            jf[s1] += 2
                            a = 1
                elif -32 < count < -10:
                    if abs(res) >= 23:
                        if count > -16:
                            if -32 < res < 0 and count < -11:
                                jf[s0] -= 1
                            jf[s1] -= 1
                        else:
                            jf[s1] -= 2
                            a = 1
            j += 2


def _sentinel_pass_low4(jf, kf, sharp_on, sharpness, sharpn2):
    """Sentinel resolution + strong sharpening with backtracking cursors
    (encoder/image_processing.c:1994-2310)."""
    t1 = t2 = t3 = t4 = t5 = t6 = 0
    for r in range(1, 511):
        base = r * N
        j = 1
        e = 0
        t = 0
        f = 0
        while j < 509:
            s0 = base + j
            s1 = base + j + 1
            res = kf[s0]
            count = kf[s1]

            if abs(res) > 6000:
                if res == 20000:
                    if not t3:
                        kf[s0] = 0
                        t3 = 1
                    else:
                        kf[s0] = 5000
                        t3 = 2 if t3 == 1 else 0
                elif res == -20000:
                    if not t4:
                        kf[s0] = 0
                        t4 = 1
                    else:
                        kf[s0] = -5000
                        t4 = 2 if t4 == 1 else 0
                elif res == 7000:
                    kf[s0] = sharpn2 + 22
                if not t2:
                    if count == 20000:
                        if not t5:
                            kf[s1] = 0
                            t5 = 1
                        else:
                            kf[s1] = 5000
                            t5 = 2 if t5 == 1 else 0
                    elif count == -20000:
                        if not t6:
                            kf[s1] = 0
                            t6 = 1
                        else:
                            kf[s1] = -5000
                            t6 = 2 if t6 == 1 else 0
                    elif count == 7000:
                        kf[s1] = sharpn2 + 22
                    t2 = 1
                else:
                    t2 = 0
                if not t1:
                    t1 = 1
                    j += 2
                    continue
                t1 = 0
                # C falls through into the sharpening checks with the
                # sentinel res value (image_processing.c:2082-2089)
            elif abs(count) > 6000:
                if count == 20000:
                    if not t5:
                        kf[s1] = 0
                        t5 = 1
                    else:
                        kf[s1] = 5000
                        t5 = 2 if t5 == 1 else 0
                elif count == -20000:
                    if not t6:
                        kf[s1] = 0
                        t6 = 1
                    else:
                        kf[s1] = -5000
                        t6 = 2 if t6 == 1 else 0
                elif count == 7000:
                    kf[s1] = sharpn2 + 22
                j += 2
                continue

            if abs(res) > sharpness + 20 \
                    and (sharpness >> 1) < abs(count) <= sharpn2:
                if res > 0:
                    jf[s0] += 1
                    sharp_on[s0] = 1
                    if count > 0:
                        jf[s1] += 2
                        sharp_on[s1] = 1
                    if s1 >= 2 * N + 2:  # C: 4*IM_DIM+2
                        sc = s1 - N
                        res2 = kf[sc]
                        if res2 > 4:
                            jf[sc] += 1
                            sharp_on[sc] = 1
                        sc -= 1
                        res3 = kf[sc]
                        if res3 > 4:
                            jf[sc] += 1
                            sharp_on[sc] = 1
                        if res2 < -24 and not t:
                            jf[sc + 1] -= 1
                            sharp_on[sc + 1] = 1
                        if res3 < -24 and not t:
                            jf[sc] -= 1
                            sharp_on[sc] = 1
                    e = 0
                    f = 0
                elif res < 0:
                    jf[s0] -= 1
                    sharp_on[s0] = 1
                    if count < 0:
                        jf[s1] -= 2
                        sharp_on[s1] = 1
                    if s1 >= 2 * N + 2:  # C: 4*IM_DIM+2
                        sc = s1 - N
                        res2 = kf[sc]
                        if res2 < -4:
                            jf[sc] -= 1
                            sharp_on[sc] = 1
                        sc -= 1
                        res3 = kf[sc]
                        if res3 < -4:
                            jf[sc] -= 1
                            sharp_on[sc] = 1
                        if res2 > 24 and not t:
                            jf[sc + 1] += 1
                            sharp_on[sc + 1] = 1
                        if res3 > 24 and not t:
                            jf[sc] += 1
                            sharp_on[sc] = 1
                    e = 0
                    f = 0
                if t == 1:
                    j += 1
                    t = 0
                elif t == 2:
                    j += 3
                    t = 0
                j += 2
            elif abs(count) > sharpness + 20 \
                    and (sharpness >> 1) < abs(res) <= sharpn2:
                if count > 0:
                    jf[s1] += 1
                    sharp_on[s1] = 1
                    if res > 0:
                        jf[s0] += 2
                        sharp_on[s0] = 1
                    if s1 >= 2 * N + 2:  # C: 4*IM_DIM+2
                        sc = s1 - (N + 1)
                        res2 = kf[sc]
                        if res2 > 4:
                            jf[sc] += 1
                            sharp_on[sc] = 1
                        sc += 1
                        res3 = kf[sc]
                        if res3 > 4:
                            jf[sc] += 1
                            sharp_on[sc] = 1
                        if res2 < -24 and not t:
                            jf[sc - 1] -= 1
                            sharp_on[sc - 1] = 1
                        if res3 < -24 and not t:
                            jf[sc] -= 1
                            sharp_on[sc] = 1
                    e = 0
                    f = 0
                elif count < 0:
                    jf[s1] -= 1
                    sharp_on[s1] = 1
                    if res < 0:
                        jf[s0] -= 2
                        sharp_on[s0] = 1
                    if s1 >= 2 * N + 2:  # C: 4*IM_DIM+2
                        sc = s1 - (N + 1)
                        res2 = kf[sc]
                        if res2 < -4:
                            jf[sc] -= 1
                            sharp_on[sc] = 1
                        sc += 1
                        res3 = kf[sc]
                        if res3 < -4:
                            jf[sc] -= 1
                            sharp_on[sc] = 1
                        if res2 > 24 and not t:
                            jf[sc - 1] += 1
                            sharp_on[sc - 1] = 1
                        if res3 > 24 and not t:
                            jf[sc] += 1
                            sharp_on[sc] = 1
                    e = 0
                    f = 0
                if t == 1:
                    j += 1
                    t = 0
                elif t == 2:
                    j += 3
                    t = 0
                j += 2
            else:
                e += 1
                if not t:
                    f += 1
                if e == 2:
                    j -= 3
                    e = 0
                    t = 1
                elif t == 1:
                    j += 1
                    t = 0
                    e = 0
                    if f == 4:
                        if abs(kf[base + j + 1 - 5]) <= sharpn2 \
                                or abs(kf[base + j + 1 - 2]) <= sharpn2:
                            j -= 5
                            t = 2
                        f = 0
                elif t == 2:
                    j += 3
                    t = 0
                    e = 0
                    f = 0
                j += 2


def _pair_sharpen_low4(jf, kf, sharp_on, sharpness, sharpn2):
    """Final paired-pixel sharpening pass
    (encoder/image_processing.c:2312-2420)."""
    for r in range(1, 511):
        base = r * N
        j = 1
        while j < 510:
            s0 = base + j
            s1 = base + j + 1
            res = kf[s0]
            count = kf[s1]

            if abs(res) > 4000 or abs(count) > 4000:
                j += 2
                continue

            if sharpness < abs(res) <= sharpness + 20 \
                    and sharpness < abs(count) <= sharpness + 20:
                if sharp_on[s0] != 1 and sharp_on[s1] != 1:
                    if res > 0 and count > 0:
                        if res >= count:
                            if sharp_on[s0] != 2:
                                jf[s0] += 1
                            elif sharp_on[s1] != 2:
                                jf[s1] += 1
                        else:
                            if sharp_on[s1] != 2:
                                jf[s1] += 1
                            elif sharp_on[s0] != 2:
                                jf[s0] += 1
                    elif res < 0 and count < 0:
                        if res <= count:
                            if sharp_on[s0] != 3:
                                jf[s0] -= 1
                            elif sharp_on[s1] != 3:
                                jf[s1] -= 1
                        else:
                            if sharp_on[s1] != 3:
                                jf[s1] -= 1
                            elif sharp_on[s0] != 3:
                                jf[s0] -= 1
                    elif j < 507 \
                            and sharpness < abs(kf[s1 + 1]) <= sharpness + 20:
                        if (count > 0 and kf[s1 + 1] > 0) \
                                or (count < 0 and kf[s1 + 1] < 0):
                            j -= 1
                elif j < 507 \
                        and sharpness < abs(kf[s1 + 1]) <= sharpness + 20:
                    if (count > 0 and kf[s1 + 1] > 0) \
                            or (count < 0 and kf[s1 + 1] < 0):
                        j -= 1
            elif abs(res) > sharpness + 56 and abs(count) > sharpness + 56:
                if not sharp_on[s0] and not sharp_on[s1]:
                    if res > 0 and count < 0:
                        jf[s0] += 1
                        jf[s1] -= 1
                    elif res < 0 and count > 0:
                        jf[s0] -= 1
                        jf[s1] += 1
                    elif abs(res) > sharpness + 96 \
                            and abs(count) > sharpness + 96:
                        if res > 0 and count > 0:
                            if res > count:
                                jf[s0] += 1
                            else:
                                jf[s1] += 1
                        elif res < 0 and count < 0:
                            if res < count:
                                jf[s0] -= 1
                            else:
                                jf[s1] -= 1
            elif abs(res) > sharpness + 160 \
                    and sharpn2 < abs(count) <= sharpn2 + 20:
                if not sharp_on[s0] and not sharp_on[s1]:
                    if res > 0 and count > 0:
                        jf[s1] -= 1
                    elif res < 0 and count < 0:
                        jf[s1] += 1
                    elif j < 505 and abs(kf[s1 + 1]) > sharpness + 160 \
                            and abs(kf[s1 + 2]) <= sharpn2:
                        j -= 1
                elif j < 505 and abs(kf[s1 + 1]) > sharpness + 160 \
                        and abs(kf[s1 + 2]) > sharpn2 + 20:
                    j -= 1
            elif abs(count) > sharpness + 160 \
                    and sharpn2 < abs(res) <= sharpn2 + 20:
                if not sharp_on[s0] and not sharp_on[s1]:
                    if res > 0 and count > 0:
                        jf[s0] -= 1
                    elif res < 0 and count < 0:
                        jf[s0] += 1
                    elif j < 507 \
                            and sharpn2 < abs(kf[s1 + 1]) <= sharpn2 + 20:
                        j -= 1
                else:
                    j -= 1
            else:
                j -= 1
            j += 2


def _pre_process_y_low(yplane: np.ndarray, quality: int) -> np.ndarray:
    """q<=LOW4 path: low-quality kernel, the t1..t44 pair walk and the two
    sharpening epilogue passes (encoder/image_processing.c:558-2423)."""
    from benchmark.reference import native

    sharpness = SHARPNESS.get(quality, 0)
    sharpn2 = 10 if sharpness < 10 else sharpness
    n1 = _n1_for(quality)

    jpeg = yplane.astype(np.int16).copy()
    jf = jpeg.reshape(-1)

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        res_a, cnt_a = _gradient_sums(yplane)
        rf = np.ascontiguousarray(res_a.reshape(-1), np.int32)
        cf = np.ascontiguousarray(cnt_a.reshape(-1), np.int32)
        kern = np.zeros(SZ4, np.int32)
        lib.nhw_kernel_low4(ffi.cast("int32_t *", rf.ctypes.data),
                            ffi.cast("int32_t *", cf.ctypes.data),
                            ffi.cast("int32_t *", kern.ctypes.data),
                            sharpness, sharpn2)
        sharp = np.zeros(SZ4, np.uint8)
        low_on = 1 if quality <= T.LOW6 else 0
        ladder_on = 1 if (quality > T.LOW6
                          or (quality <= T.LOW10
                              and quality > T.LOW13)) else 0
        pfa = np.ascontiguousarray(yplane.reshape(-1), np.int16)
        lib.nhw_pair_walk_low(
            ffi.cast("int16_t *", jf.ctypes.data),
            ffi.cast("int16_t *", pfa.ctypes.data),
            ffi.cast("int32_t *", kern.ctypes.data),
            ffi.cast("uint8_t *", sharp.ctypes.data),
            low_on, ladder_on, sharpness, sharpn2, n1)
        lib.nhw_sentinel_pass_low4(
            ffi.cast("int16_t *", jf.ctypes.data),
            ffi.cast("int32_t *", kern.ctypes.data),
            ffi.cast("uint8_t *", sharp.ctypes.data), sharpness, sharpn2)
        lib.nhw_pair_sharpen_low4(
            ffi.cast("int16_t *", jf.ctypes.data),
            ffi.cast("int32_t *", kern.ctypes.data),
            ffi.cast("uint8_t *", sharp.ctypes.data), sharpness, sharpn2)
        _cache_put(_FINAL_KERNEL_CACHE, yplane, quality, kern)
        return jpeg

    res_a, cnt_a = _gradient_sums(yplane)
    kf = _kernel_pass_low4(res_a, cnt_a, sharpness, sharpn2)

    pf = yplane.reshape(-1).tolist()  # nhw_process = unmodified copy
    sharp_on = [0] * SZ4

    _pair_walk_low(jf, pf, kf, quality, sharpness, sharpn2, n1, sharp_on)
    _sentinel_pass_low4(jf, kf, sharp_on, sharpness, sharpn2)
    _pair_sharpen_low4(jf, kf, sharp_on, sharpness, sharpn2)
    _cache_put(_FINAL_KERNEL_CACHE, yplane, quality,
               np.asarray(kf, np.int32))
    return jpeg


def block_variance_avg(yplane: np.ndarray) -> np.ndarray:
    """E6: 8x8 block variance smoother (encoder/image_processing.c:
    2466-2598) — dead in the reference (call commented out at
    encoder/nhw_encoder.c:112, intended gate q <= LOW6); flag-enabled
    here via encode(block_variance=True).

    All reads come from an unmodified snapshot and every write site is
    distinct, so the whole pass is one masked 3x3 smoothing — pure
    vectorized selects (TPU-trivial), no scan:

    - pass 1: blocks with integer variance < 1500 smooth their 6x6
      interior;
    - pass 2: adjacent low-variance blocks (right / below, excluding the
      last block row as base and block column 63 as base) smooth their
      shared seam lines.
    """
    snap = np.asarray(yplane, np.int16).astype(np.int32)

    blocks = snap.reshape(64, 8, 64, 8)
    avg = (blocks.sum(axis=(1, 3)) + 32) >> 6
    d = blocks - avg[:, None, :, None]
    mask = (d * d).sum(axis=(1, 3)) < 1500  # (64, 64) low-variance blocks

    sm = snap.copy()
    c = snap
    sm[1:-1, 1:-1] = ((c[1:-1, 1:-1] << 3)
                      + c[1:-1, :-2] + c[1:-1, 2:]
                      + c[:-2, 1:-1] + c[2:, 1:-1]
                      + c[:-2, :-2] + c[:-2, 2:]
                      + c[2:, :-2] + c[2:, 2:] + 8) >> 4

    pos = np.zeros((64, 8, 64, 8), bool)
    pos[:, 1:7, :, 1:7] = mask[:, None, :, None]
    # vertical seams: block (r, j) cols 7 and 8 (= col 0 of (r, j+1)),
    # rows 1..6, when both blocks are low-variance (r <= 62, j <= 62)
    seam_r = mask[:63, :63] & mask[:63, 1:64]
    pos[:63, 1:7, :63, 7] |= seam_r[:, None, :]
    pos[:63, 1:7, 1:64, 0] |= seam_r[:, None, :]
    # horizontal seams: block (r, j) row 7 and row 0 of (r+1, j),
    # cols 1..6
    seam_b = mask[:63, :63] & mask[1:64, :63]
    pos[:63, 7, :63, 1:7] |= seam_b[:, :, None]
    pos[1:64, 0, :63, 1:7] |= seam_b[:, :, None]

    out = np.where(pos.reshape(512, 512), sm, snap)
    return out.astype(np.int16)
