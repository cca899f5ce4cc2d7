# Frozen copy of nhwcodec_tpu_torch/host/ops/entropy.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Static-Huffman bitstream decode (Y and UV passes).

Faithful reformulation of the reference decode automaton
(decoder/compress_pixel.c:49-641).  Codes are canonical and at most 14 bits:
a 9-bit LUT resolves short codes; the all-ones 5-bit prefix switches to a
second LUT with explicit long-code escape ladders at size 11.  When zone
coding is active (container mode byte < 4), a 15-bit "zone" fast path
(9-bit word 0x1 + 6-bit index) can appear at any symbol start, and
LUT-decoded symbol indices >= ZONE1 are shifted by UNZONE1.

The per-symbol state machine (run/select-word reinsertion consulting decoded
history, decoder/compress_pixel.c:296-341) is inherently serial; this host
implementation is the bit-exact reference path.  The throughput path batches
images across host workers while the TPU runs the plane transforms.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

_NT1 = T.NHW_TABLE1.astype(np.int64).tolist()
_NT2 = T.NHW_TABLE2.astype(np.int64).tolist()
# extra_table is declared with 109 entries but indexed up to [109] in the
# reference (word==ZONE1-1); that out-of-bounds read lands on zero padding
# before the next static table, so index 109 behaves as 0.
_EXTRA = T.EXTRA_TABLE.tolist() + [0]


def bits_of_words(words: np.ndarray, pad_words: int = 4) -> np.ndarray:
    """MSB-first bit expansion of little-endian u32 code words."""
    w = np.concatenate([words.astype("<u4"), np.zeros(pad_words, "<u4")])
    return np.unpackbits(w.byteswap().view(np.uint8))


def padded_words(words: np.ndarray, pad_words: int = 8) -> np.ndarray:
    """Native-endian u32 code words + zero tail for the C bit window."""
    return np.ascontiguousarray(
        np.concatenate([words.astype(np.uint32, copy=False),
                        np.zeros(pad_words, np.uint32)]))


def expand_bits(b: np.ndarray) -> np.ndarray:
    """u8 bytes -> per-bit 0/1 array, MSB first (select/bit planes)."""
    return np.unpackbits(np.ascontiguousarray(b, dtype=np.uint8))


def build_y_book(tree1: np.ndarray) -> tuple[list, list]:
    """Reconstruct the Y codebook (decoder/compress_pixel.c:92-123).

    Returns (value, run_length) lists per symbol index; literals have run 1;
    run words have value 128.
    """
    t = tree1.tolist()
    dec: list[int] = []
    i = 0
    while i < len(t):
        if t[i] == 3:
            dec.extend([3] * t[i + 1])
            i += 1
        else:
            dec.append(t[i])
        i += 1
    e = len(dec)
    inter = [0] * (e + 1)
    k = 0
    for i in range(0, e, 2):
        inter[i] = dec[k]
        k += 1
    for i in range(1, e, 2):
        inter[i] = dec[k]
        k += 1
    vals: list[int] = []
    rles: list[int] = []
    i = 0
    while i < e:
        if inter[i] == 3:
            vals.append(128)
            rles.append(inter[i + 1])
            i += 1
        else:
            vals.append(inter[i] & 0xFF)
            rles.append(1)
        i += 1
    return vals, rles


def build_uv_book(tree2: np.ndarray, tree_end: int) -> tuple[list, list]:
    """Reconstruct the UV codebook (decoder/compress_pixel.c:452-478).

    Values are even; an even stream byte is a (value, run-length) pair, an
    odd byte is a literal of value&0xFE with run 1.
    """
    t = tree2.tolist()
    dec: list[int] = []
    i = 0
    while i < len(t):
        if t[i] == 128:
            dec.extend([128] * t[i + 1])
            i += 1
        else:
            dec.append(t[i])
        i += 1
    e = tree_end
    dec += [0] * max(0, e + 1 - len(dec))
    inter = [0] * (e + 1)
    k = 0
    for i in range(0, e, 2):
        inter[i] = dec[k]
        k += 1
    for i in range(1, e, 2):
        inter[i] = dec[k]
        k += 1
    vals: list[int] = []
    rles: list[int] = []
    i = 0
    while i < e:
        if not (inter[i] & 1):
            vals.append(inter[i])
            rles.append(inter[i + 1])
            i += 1
        else:
            vals.append(inter[i] & 0xFE)
            rles.append(1)
        i += 1
    return vals, rles


def _next_symbol(bits: list, pos: int, zone_on: bool) -> tuple[int, int]:
    """Decode one code word starting at bit ``pos``.

    Returns (symbol_index, new_pos).  Mirrors the automaton in
    decoder/compress_pixel.c:130-290; the zone fast path and UNZONE shift
    apply only when ``zone_on``.
    """
    if zone_on:
        v = 0
        for k in range(9):
            v = (v << 1) | bits[pos + k]
        if v == 0x1:
            v = 0
            for k in range(9, 15):
                v = (v << 1) | bits[pos + k]
            return v + T.ZONE1, pos + 15  # SKIP_ZONE: no UNZONE shift

    tr = 0
    size = 0
    while True:
        tr = (tr << 1) | bits[pos + size]
        size += 1
        if tr == 0x1F:
            # all-ones prefix: switch to the long-code table (5 more bits)
            tr = 0
            for _ in range(5):
                tr = (tr << 1) | bits[pos + size]
                size += 1
            dec = _NT2[tr << 4]
            if dec != 0 and size == dec >> 9:
                break
            while True:
                tr = (tr << 1) | bits[pos + size]
                size += 1
                if size == 0xB:
                    dec = _NT2[tr << 3]
                    if dec != 0 and size == dec >> 9:
                        break
                    if tr == 0x3:
                        v = 0
                        for _ in range(6):
                            v = (v << 1) | bits[pos + size]
                            size += 1
                        dec = v + 110
                        break
                    if tr == 0x23:
                        v = 0
                        for _ in range(6):
                            v = (v << 1) | bits[pos + size]
                            size += 1
                        if v < 46:
                            dec = v + 174
                            break
                        v = (v << 1) | bits[pos + size]
                        size += 1
                        if v < 104:  # 7-bit read; (v>>1) is the 6-bit value
                            dec = (v >> 1) + ((v >> 1) - 46) + (v & 1) + 174
                            break
                        v = (v << 1) | bits[pos + size]
                        size += 1
                        if v < 246:
                            dec = (6 + (((v >> 2) - 52) * 3)
                                   + (v >> 2) + (v & 3) + 174)
                            break
                        v = (v << 1) | bits[pos + size]
                        size += 1
                        dec = v - 492 + 270
                        break
                    continue
                dec = _NT2[tr << (14 - size)]
                if dec != 0 and size == dec >> 9:
                    break
            break
        dec = _NT1[tr]
        if dec != 0 and size == dec >> 9:
            break

    sym = dec & T.MSW
    if zone_on and sym >= T.ZONE1:
        sym += T.UNZONE1
    return sym, pos + size


def decode_y(
    packet1: np.ndarray,
    tree1: np.ndarray,
    select_word1: np.ndarray,
    select_word2: np.ndarray,
    res_high: int,
    p1: int = 4 * T.IM_SIZE,
) -> np.ndarray:
    """Decode the Y symbol plane (decoder/compress_pixel.c:49-444)."""
    vals, rles = build_y_book(tree1)
    sel1 = expand_bits(select_word1).tolist()
    sel2 = expand_bits(select_word2).tolist()
    zone_on = res_high < 4

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        words = padded_words(packet1)
        nt1 = np.array(_NT1, np.int32)
        nt2 = np.array(_NT2, np.int32)
        va = np.array(vals, np.int32)
        rl = np.array(rles, np.int32)
        s1 = np.ascontiguousarray(np.array(sel1 + [0] * 8, np.uint8))
        s2 = np.ascontiguousarray(np.array(sel2 + [0] * 8, np.uint8))
        ex = np.array(_EXTRA, np.int8)
        out = np.zeros(p1 + 512, np.int16)
        rc = lib.nhw_decode_y(
            ffi.cast("uint32_t *", words.ctypes.data),
            ffi.cast("int32_t *", nt1.ctypes.data),
            ffi.cast("int32_t *", nt2.ctypes.data),
            ffi.cast("int32_t *", va.ctypes.data),
            ffi.cast("int32_t *", rl.ctypes.data),
            ffi.cast("uint8_t *", s1.ctypes.data),
            ffi.cast("uint8_t *", s2.ctypes.data),
            1 if zone_on else 0,
            ffi.cast("int8_t *", ex.ctypes.data),
            ffi.cast("int16_t *", out.ctypes.data), p1,
            32 * words.size, va.size, s1.size, s2.size)
        if rc != 0:
            raise ValueError("corrupt or truncated Y symbol stream")
        return out[:p1].copy()

    out = [0] * (p1 + 512)
    bits = bits_of_words(packet1).tolist()
    pos = 0
    e = 0
    mem = mem2 = nhw_ac1 = 0
    run_over = -257
    t = t2 = 0
    extra = _EXTRA

    while True:
        dec, pos = _next_symbol(bits, pos, zone_on)
        word = vals[dec]
        rle = rles[dec]

        if word == 0x80:
            mem += 1
            if mem2 == 1:
                if e >= 5 and not (out[e - 2] or out[e - 3] or out[e - 4] or out[e - 5]):
                    out[e] = -11 if not sel2[t2] else 11
                    t2 += 1
                    e += 1
                elif rle >= 4 and not out[e - 2]:
                    out[e] = -11 if not sel2[t2] else 11
                    t2 += 1
                    e += 1
                mem2 = 0
            elif mem == 2 and not nhw_ac1:
                if (e >= 4
                        and not (out[e - 1] or out[e - 2] or out[e - 3] or out[e - 4])
                        and (e + rle - 257) >= run_over):
                    out[e] = 11 if not sel1[t] else -11
                    t += 1
                    e += 1
                    mem = 1
                elif (rle >= 4 and e > 0 and not out[e - 1]
                        and (e + rle - 257) >= run_over):
                    out[e] = 11 if not sel1[t] else -11
                    t += 1
                    e += 1
                    mem = 1
            elif (rle >= 4 and e > 0 and not out[e - 1] and not nhw_ac1
                    and (e + rle - 257) >= run_over):
                out[e] = 11 if not sel1[t] else -11
                t += 1
                e += 1
                mem = 1

            if rle == 254:
                nhw_ac1 = 1
                mem = 0
                run_over = e
            else:
                nhw_ac1 = 0
            e += rle
        else:
            mem = mem2 = nhw_ac1 = 0
            if word == 136:
                out[e] = 11
                e += 1
                mem2 = 1
            elif word == 120:
                out[e] = -11
                e += 1
                mem2 = 1
            elif word == 132:
                out[e] = 11
                out[e + 4] = 11
                e += 5
            elif word == 133:
                out[e] = 11
                out[e + 4] = -11
                e += 5
            elif word == 134:
                out[e] = -11
                out[e + 4] = 11
                e += 5
            elif word == 135:
                out[e] = -11
                out[e + 4] = -11
                e += 5
            elif word == 127:
                out[e] = 1008
                e += 1
            elif word == 129:
                out[e] = 1009
                e += 1
            elif word == 125:
                out[e] = 1006
                e += 1
            elif word == 126:
                out[e] = 1007
                e += 1
            elif word == 121:
                out[e] = 1010
                e += 1
            elif word == 122:
                out[e] = 1011
                e += 1
            elif word == 124:
                out[e] = 11
                e += 1
            elif word == 123:
                out[e] = -11
                e += 1
            elif word < T.ZONE1 and extra[word]:
                x = extra[word]
                out[e] = (T.WVLT_ENERGY_NHW + (x << 3) if x > 0
                          else (x << 3) - T.WVLT_ENERGY_NHW)
                e += 1
            elif word > 0x80:
                out[e] = word - T.INV_QUANT1
                e += 1
            else:
                out[e] = word - T.INV_QUANT2
                e += 1

        if e >= p1 - 1:
            break
    return np.array(out[:p1], dtype=np.int16)


def decode_uv(
    packet2: np.ndarray,
    tree2: np.ndarray,
    tree_end: int,
    p1: int = 2 * T.IM_SIZE - 1,
) -> np.ndarray:
    """Decode the interleaved U/V symbol plane
    (decoder/compress_pixel.c:446-641).  Zone coding never applies to UV."""
    vals, rles = build_uv_book(tree2, tree_end)
    extra = _EXTRA

    from benchmark.reference import native

    if native.available():
        lib = native._load()
        ffi = native.ffi()
        words = padded_words(packet2)
        nt1 = np.array(_NT1, np.int32)
        nt2 = np.array(_NT2, np.int32)
        va = np.array(vals, np.int32)
        rl = np.array(rles, np.int32)
        ex = np.array(_EXTRA, np.int8)
        out = np.zeros(p1 + 512, np.int16)
        rc = lib.nhw_decode_uv(
            ffi.cast("uint32_t *", words.ctypes.data),
            ffi.cast("int32_t *", nt1.ctypes.data),
            ffi.cast("int32_t *", nt2.ctypes.data),
            ffi.cast("int32_t *", va.ctypes.data),
            ffi.cast("int32_t *", rl.ctypes.data),
            ffi.cast("int8_t *", ex.ctypes.data),
            ffi.cast("int16_t *", out.ctypes.data), p1,
            32 * words.size, va.size)
        if rc != 0:
            raise ValueError("corrupt or truncated UV symbol stream")
        return out[:2 * T.IM_SIZE].copy()

    out = [0] * (p1 + 512)
    bits = bits_of_words(packet2).tolist()
    pos = 0
    e = 0
    while True:
        dec, pos = _next_symbol(bits, pos, zone_on=False)
        word = vals[dec]
        if word == 0x80:
            e += rles[dec]
        elif word < T.ZONE1:
            x = extra[word]
            if x:
                out[e] = (T.WVLT_ENERGY_NHW + (x << 3) if x > 0
                          else (x << 3) - T.WVLT_ENERGY_NHW)
            elif word > 0x80:
                out[e] = word - T.INV_QUANT1
            else:
                out[e] = word - T.INV_QUANT2
            e += 1
        elif word == 124:
            out[e] = 5005
            e += 1
        elif word == 126:
            out[e] = 5006
            e += 1
        elif word == 122:
            out[e] = 5003
            e += 1
        elif word == 130:
            out[e] = 5004
            e += 1
        elif word > 0x80:
            out[e] = word - T.INV_QUANT1
            e += 1
        else:
            out[e] = word - T.INV_QUANT2
            e += 1
        if e >= p1 - 1:
            break
    return np.array(out[:2 * T.IM_SIZE], dtype=np.int16)
