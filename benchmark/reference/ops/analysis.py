# Frozen copy of nhwcodec_tpu_torch/host/ops/analysis.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Integer 5/3-style lifting ANALYSIS filters + the 2-D filterbank driver.

Reference behavior: encoder/filters.c:55-386 (downfilter53 / II / VI / IV)
composed by encoder/wavelet_analysis (encoder/wavelet_filterbank.c:52-302).
The reference walks rows with scalar loops and an error-feedback dither
whose state is local to each coefficient (the dither fed into slot k+1
depends only on the raw value at slot k), so every filter vectorizes into
pure slice expressions over whole planes — one VPU pass per subband on TPU.

int16 semantics: the C stores into ``short`` at every output; arithmetic
here runs in int32/int64 with ``wrap16`` at exactly those points.

The 2-D driver replicates the reference's two-plane buffer dance
(im_jpeg / im_process): horizontal RAW pass -> transpose -> per-half
column passes -> LL-quadrant transpose-back.  Both planes persist between
calls; untouched regions carry earlier-stage subbands (a format-relevant
behavior, see encoder/wavelet_filterbank.c:143-184).
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.ops.lifting import synth_norm, synth_unnorm, wrap16

# ---------------------------------------------------------------------------
# 1-D building blocks (rows = leading axes, filtered axis last)


def _down_native(X, fn_name: str):
    """Dispatch one analysis row pass to the native runtime.  X: (..., n)
    numpy int16 array; returns (low, high) int16 (..., n/2) pairs."""
    from benchmark.reference import native

    lib = native._load()
    ffi = native.ffi()
    Xc = np.ascontiguousarray(X, np.int16)
    n = Xc.shape[-1]
    rows = Xc.size // n
    low = np.empty(Xc.shape[:-1] + (n // 2,), np.int16)
    high = np.empty_like(low)
    getattr(lib, fn_name)(
        ffi.cast("const int16_t *", Xc.ctypes.data), rows, n,
        ffi.cast("int16_t *", low.ctypes.data),
        ffi.cast("int16_t *", high.ctypes.data))
    return low, high


def _low_raw(X, xp=np):
    """Un-normalized lowpass moments r[k] (encoder/filters.c:367-384):
    r[0]=6X0+4X1-2X2; r[k]=6X[2k]+2(X[2k-1]+X[2k+1])-(X[2k-2]+X[2k+2]);
    r[M-1]=6X[N-2]+2(X[N-3]+X[N-1])-(X[N-4]+X[N-2]).  int64."""
    X = X.astype(xp.int64)
    n = X.shape[-1]
    first = 6 * X[..., :1] + 4 * X[..., 1:2] - 2 * X[..., 2:3]
    c = X[..., 2:n - 2:2]
    mid = (6 * c + 2 * (X[..., 1:n - 3:2] + X[..., 3:n - 1:2])
           - (X[..., 0:n - 4:2] + X[..., 4:n:2]))
    last = (6 * X[..., n - 2:n - 1] + 2 * (X[..., n - 3:n - 2]
            + X[..., n - 1:n]) - (X[..., n - 4:n - 3] + X[..., n - 2:n - 1]))
    return xp.concatenate([first, mid, last], axis=-1)


def _high_adj(X, xp=np):
    """Parity-adjusted neighbour sums a[k] for the highpass lifting
    (encoder/filters.c:62-81): a[k]=X[2k]+X[2k+2]; odd slots get +1 when
    both a[k] and a[k-1] are odd.  Returns (a_adj, r) with
    r[k]=X[2k+1]-(a_adj>>1) for k<M-1 (int64)."""
    X = X.astype(xp.int64)
    n = X.shape[-1]
    a = X[..., 0:n - 2:2] + X[..., 2:n:2]          # M-1 entries
    prev_odd = xp.concatenate(
        [xp.zeros_like(a[..., :1]), a[..., :-1] & 1], axis=-1)
    k_odd = (xp.arange(a.shape[-1]) & 1).astype(a.dtype)
    adj = a + ((a & 1) & prev_odd & k_odd)
    r = X[..., 1:n - 1:2] - (adj >> 1)
    return r


def _round_pos(r, add, shift, xp=np):
    """C pattern: r>=0 ? (r+add)>>shift : -((-r+add)>>shift)."""
    return xp.where(r >= 0, (r + add) >> shift, -((-r + add) >> shift))


def down_iv(X, xp=np):
    """downfilter53IV both phases (encoder/filters.c:346-386): raw
    moments, no normalization.  Returns (low, high) wrapped to int16."""
    if xp is np:
        from benchmark.reference import native

        if native.available():
            return _down_native(X, "nhw_down_iv")

    low = wrap16(_low_raw(X, xp), xp)
    Xl = X.astype(xp.int64)
    n = X.shape[-1]
    h = 2 * Xl[..., 1:n - 1:2] - (Xl[..., 0:n - 2:2] + Xl[..., 2:n:2])
    hl = (Xl[..., n - 1:n] - Xl[..., n - 2:n - 1]) << 1
    high = wrap16(xp.concatenate([h, hl], axis=-1), xp)
    return low, high


def down_53(X, xp=np):
    """Plain downfilter53 (encoder/filters.c:55-114): /16 lowpass with
    sign-symmetric rounding, /2 highpass with positive-biased rounding."""
    if xp is np:
        from benchmark.reference import native

        if native.available():
            return _down_native(X, "nhw_down_53")

    low = _round_pos(_low_raw(X, xp), 8, 4, xp)
    r = _high_adj(X, xp)
    h = xp.where(r > 0, (r + 1) >> 1, r >> 1)
    Xl = X.astype(xp.int64)
    n = X.shape[-1]
    hl = (Xl[..., n - 1:n] - Xl[..., n - 2:n - 1] + 1) >> 1
    high = xp.concatenate([h, hl], axis=-1)
    return wrap16(low, xp), wrap16(high, xp)


def _dither(r, xp=np):
    """Error-feedback dither f(r) (encoder/filters.c:155-156): the residue
    of r mod 64, quartered, folded to [-8,8] with the sign of r."""
    rm = xp.where(r >= 0, r, -r) & 63
    mag = xp.where(rm < 32, rm >> 2, -((64 - rm) >> 2))
    return xp.where(r >= 0, mag, -mag)


def down_vi(X, xp=np):
    """downfilter53VI == downfilter53II (encoder/filters.c:116-287):
    lowpass r normalized /64 after adding the previous slot's dither
    (through an int16 store), highpass /8."""
    if xp is np:
        from benchmark.reference import native

        if native.available():
            return _down_native(X, "nhw_down_vi")

    r = _low_raw(X, xp)
    d = _dither(r, xp)
    d_prev = xp.concatenate([xp.zeros_like(d[..., :1]), d[..., :-1]], axis=-1)
    low = _round_pos(wrap16(r + d_prev, xp), 32, 6, xp)

    rh = _high_adj(X, xp)
    h = _round_pos(rh, 4, 3, xp)
    Xl = X.astype(xp.int64)
    n = X.shape[-1]
    hl = wrap16(Xl[..., n - 1:n] - Xl[..., n - 2:n - 1], xp) >> 3
    high = xp.concatenate([h, hl], axis=-1)
    return wrap16(low, xp), wrap16(high, xp)


# ---------------------------------------------------------------------------
# 2-D driver over the persistent (jpeg, process) plane pair


def _zero_clear(process: np.ndarray, norder: int) -> None:
    """encoder/wavelet_filterbank.c:57-60: flat positions
    [k*512, k*512+norder/2) for k < norder/2, interpreted in the plane's
    own width."""
    flat = process.reshape(-1)
    w = process.shape[-1]
    step = 512 // w  # rows advanced per 512 flat elements
    for k in range(norder // 2):
        flat[k * 512: k * 512 + norder // 2] = 0


def wavelet_analysis(jpeg: np.ndarray, process: np.ndarray, norder: int,
                     last_stage: int, res_high: int,
                     snapshot: bool = False,
                     wvlts_order: int = 2) -> np.ndarray | None:
    """One analysis stage, mutating jpeg/process in place
    (encoder/wavelet_filterbank.c:52-302).  Returns the q>HIGH1 snapshot
    (first 2*IM_SIZE elements of the transposed raw plane) when requested.
    """
    from benchmark.reference import native

    if (native.available() and jpeg.dtype == np.int16
            and jpeg.flags.c_contiguous and process.flags.c_contiguous
            and jpeg.shape == process.shape):
        lib = native._load()
        ffi = native.ffi()
        w = jpeg.shape[-1]
        want = bool(snapshot and not last_stage)
        snap = np.empty(2 * 65536, np.int16) if want else None
        lib.nhw_analysis_stage(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int16_t *", process.ctypes.data),
            w, norder, last_stage, wvlts_order,
            1 if want else 0,
            ffi.cast("int16_t *", snap.ctypes.data) if want else ffi.NULL)
        return snap

    _zero_clear(process, norder)
    h = norder // 2

    low, high = down_iv(jpeg[:norder, :norder])
    process[:norder, :h] = low.astype(np.int16)
    process[:norder, h:norder] = high.astype(np.int16)

    jpeg[:norder, :norder] = process[:norder, :norder].T

    snap = None
    if snapshot and not last_stage:
        snap = jpeg.reshape(-1)[:2 * 65536].copy()

    filt = down_vi  # RES_HIGH==0 -> VI; else II (identical filters)
    low, high = filt(jpeg[:h, :norder])
    process[:h, :h] = low.astype(np.int16)
    process[:h, h:norder] = high.astype(np.int16)

    low, high = down_53(jpeg[h:norder, :norder])
    process[h:norder, :h] = low.astype(np.int16)
    process[h:norder, h:norder] = high.astype(np.int16)

    if last_stage != wvlts_order - 1:
        jpeg[:h, :h] = process[:h, :h].T
    return snap


def wavelet_synthesis(jpeg: np.ndarray, process: np.ndarray, norder: int,
                      last_stage: int, wvlts_order: int = 2) -> None:
    """Encoder-internal synthesis stage, mutating jpeg/process in place
    (encoder/wavelet_filterbank.c:305-496): un-normalized row pass,
    transpose, normalized row pass, optional transpose-back."""
    from benchmark.reference import native

    if (native.available() and jpeg.dtype == np.int16
            and jpeg.flags.c_contiguous and process.flags.c_contiguous
            and jpeg.shape == process.shape):
        lib = native._load()
        ffi = native.ffi()
        lib.nhw_synthesis_stage(
            ffi.cast("int16_t *", jpeg.ctypes.data),
            ffi.cast("int16_t *", process.ctypes.data),
            jpeg.shape[-1], norder, last_stage, wvlts_order)
        return

    h = norder // 2
    t = synth_unnorm(jpeg[:norder, :h], jpeg[:norder, h:norder])
    process[:norder, :norder] = t.astype(np.int16)

    jpeg[:norder, :norder] = process[:norder, :norder].T

    t = synth_norm(jpeg[:norder, :h], jpeg[:norder, h:norder])
    process[:norder, :norder] = t.astype(np.int16)

    if last_stage != wvlts_order - 1:
        jpeg[:norder, :norder] = process[:norder, :norder].T
