# Frozen copy of nhwcodec_tpu_torch/host/utils/container.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
""".nhw container layout (parse + serialize).

Field order is the format contract (reference: encoder/nhw_encoder.c:3114-3218
== decoder/nhw_decoder.c:1494-1661):

    u8  RES_HIGH+wavelet_type   bits0-1: LL2 RLE mode; +4: zone coding OFF
    u8  quality                 1..23
    u16 size_tree1, u16 size_tree2, i32 size_data1, i32 size_data2
    u16 tree_end, u16 exw_Y_end
    [q>12]  u16 res1_len
    [q>=19] u16 res3_len, u16 res3_bit_len
    [q>17]  u16 res4_len
    [q>12]  u16 res1_bit_len
    [q>=21] u16 res5_len, u16 res5_bit_len
    [q>21]  u32 res6_len, u16 res6_bit_len, u16 char_res1_len
    [q>22]  u16 qsetting3_len
    u16 select1, u16 select2
    [q>15]  u16 highres_comp_len
    u16 end_ch_res
    ... section bytes in the order of parse_file (see fields below)
"""

from __future__ import annotations

import dataclasses
import struct

import numpy as np

from benchmark.reference import tables as T


@dataclasses.dataclass
class NHWStreams:
    """All sections of one .nhw file, as numpy arrays (host-side)."""

    res_high: int          # byte 0: (RES_LOW mode & 3) + (4 if zone coding off)
    quality: int           # byte 1

    tree1: np.ndarray      # u8[size_tree1]   Y codebook, RLE+interleaved
    tree2: np.ndarray      # u8[size_tree2]   UV codebook
    tree_end: int
    exw_Y: np.ndarray      # u8[exw_Y_end]    out-of-range escapes (Y,U,V)

    res1: np.ndarray       # u8[]  (q>12)
    res1_bit: np.ndarray
    res1_word: np.ndarray
    res3: np.ndarray       # u8[]  (q>=19)
    res3_bit: np.ndarray
    res3_word: np.ndarray  # length 2*res3_bit_len
    res4: np.ndarray       # u8[]  (q>17)
    res5: np.ndarray       # u8[]  (q>=21)
    res5_bit: np.ndarray
    res5_word: np.ndarray
    res6: np.ndarray       # u8[]  (q>21)
    res6_bit: np.ndarray
    res6_word: np.ndarray
    char_res1: np.ndarray  # u16[] (q>21)
    qsetting3: np.ndarray  # u32[] (q>22)

    select_word1: np.ndarray  # u8[select1]
    select_word2: np.ndarray  # u8[select2]

    res_U_64: np.ndarray   # u8[512] (q>15)
    res_V_64: np.ndarray   # u8[512] (q>15)
    highres_comp: np.ndarray  # u8[] (q>15)

    res_ch: np.ndarray     # u8[end_ch_res]  LL2 RLE stream
    packet1: np.ndarray    # u32[size_data1]             Y Huffman words
    packet2: np.ndarray    # u32[size_data2-size_data1]  UV Huffman words


_EMPTY_U8 = np.zeros(0, dtype=np.uint8)


def parse_nhw(data: bytes) -> NHWStreams:
    """Parse a .nhw byte string (decoder/nhw_decoder.c:1494-1661)."""
    pos = 0

    def u8() -> int:
        nonlocal pos
        v = data[pos]
        pos += 1
        return v

    def u16() -> int:
        nonlocal pos
        v = struct.unpack_from("<H", data, pos)[0]
        pos += 2
        return v

    def i32() -> int:
        nonlocal pos
        v = struct.unpack_from("<i", data, pos)[0]
        pos += 4
        return v

    def u32() -> int:
        nonlocal pos
        v = struct.unpack_from("<I", data, pos)[0]
        pos += 4
        return v

    def bytes_(n: int) -> np.ndarray:
        nonlocal pos
        v = np.frombuffer(data, dtype=np.uint8, count=n, offset=pos).copy()
        pos += n
        return v

    res_high = u8()
    quality = u8()
    if res_high > 6:
        raise ValueError("not an .nhw file (bad mode byte)")
    if not 1 <= quality <= 23:
        raise ValueError(f"invalid quality byte {quality}")

    size_tree1 = u16()
    size_tree2 = u16()
    size_data1 = i32()
    size_data2 = i32()
    tree_end = u16()
    exw_Y_end = u16()

    res1_len = res1_bit_len = 0
    res3_len = res3_bit_len = 0
    res4_len = 0
    res5_len = res5_bit_len = 0
    res6_len = res6_bit_len = char_res1_len = 0
    qsetting3_len = 0
    highres_comp_len = 0

    if quality > T.LOW8:
        res1_len = u16()
    if quality >= T.LOW1:
        res3_len = u16()
        res3_bit_len = u16()
    if quality > T.LOW3:
        res4_len = u16()
    if quality > T.LOW8:
        res1_bit_len = u16()
    if quality >= T.HIGH1:
        res5_len = u16()
        res5_bit_len = u16()
    if quality > T.HIGH1:
        res6_len = u32()
        res6_bit_len = u16()
        char_res1_len = u16()
        if quality > T.HIGH2:
            qsetting3_len = u16()
    select1 = u16()
    select2 = u16()
    if quality > T.LOW5:
        highres_comp_len = u16()
    end_ch_res = u16()

    tree1 = bytes_(size_tree1)
    tree2 = bytes_(size_tree2)
    exw_Y = bytes_(exw_Y_end)

    res1 = res1_bit = res1_word = _EMPTY_U8
    if quality > T.LOW8:
        res1 = bytes_(res1_len)
        res1_bit = bytes_(res1_bit_len)
        res1_word = bytes_(res1_bit_len)
    res4 = _EMPTY_U8
    if quality > T.LOW3:
        res4 = bytes_(res4_len)
    res3 = res3_bit = res3_word = _EMPTY_U8
    if quality >= T.LOW1:
        res3 = bytes_(res3_len)
        res3_bit = bytes_(res3_bit_len)
        res3_word = bytes_(2 * res3_bit_len)
    res5 = res5_bit = res5_word = _EMPTY_U8
    if quality >= T.HIGH1:
        res5 = bytes_(res5_len)
        res5_bit = bytes_(res5_bit_len)
        res5_word = bytes_(res5_bit_len)
    res6 = res6_bit = res6_word = _EMPTY_U8
    char_res1 = np.zeros(0, dtype=np.uint16)
    qsetting3 = np.zeros(0, dtype=np.uint32)
    if quality > T.HIGH1:
        res6 = bytes_(res6_len)
        res6_bit = bytes_(res6_bit_len)
        res6_word = bytes_(res6_bit_len)
        char_res1 = bytes_(2 * char_res1_len).view(np.uint16).copy()
        if quality > T.HIGH2:
            qsetting3 = bytes_(4 * qsetting3_len).view(np.uint32).copy()

    select_word1 = bytes_(select1)
    select_word2 = bytes_(select2)

    res_U_64 = res_V_64 = highres_comp = _EMPTY_U8
    if quality > T.LOW5:
        res_U_64 = bytes_(2 * T.IM_DIM)
        res_V_64 = bytes_(2 * T.IM_DIM)
        highres_comp = bytes_(highres_comp_len)

    res_ch = bytes_(end_ch_res)
    packet1 = bytes_(4 * size_data1).view(np.uint32).copy()
    packet2 = bytes_(4 * (size_data2 - size_data1)).view(np.uint32).copy()

    return NHWStreams(
        res_high=res_high, quality=quality,
        tree1=tree1, tree2=tree2, tree_end=tree_end, exw_Y=exw_Y,
        res1=res1, res1_bit=res1_bit, res1_word=res1_word,
        res3=res3, res3_bit=res3_bit, res3_word=res3_word,
        res4=res4,
        res5=res5, res5_bit=res5_bit, res5_word=res5_word,
        res6=res6, res6_bit=res6_bit, res6_word=res6_word,
        char_res1=char_res1, qsetting3=qsetting3,
        select_word1=select_word1, select_word2=select_word2,
        res_U_64=res_U_64, res_V_64=res_V_64, highres_comp=highres_comp,
        res_ch=res_ch, packet1=packet1, packet2=packet2,
    )


def serialize_nhw(s: NHWStreams) -> bytes:
    """Write the container (encoder/nhw_encoder.c:3100-3277)."""
    q = s.quality
    out = bytearray()
    out.append(s.res_high)
    out.append(q)
    out += struct.pack("<HH", len(s.tree1), len(s.tree2))
    n_p1, n_p2 = len(s.packet1), len(s.packet2)
    out += struct.pack("<ii", n_p1, n_p1 + n_p2)
    out += struct.pack("<HH", s.tree_end, len(s.exw_Y))
    if q > T.LOW8:
        out += struct.pack("<H", len(s.res1))
    if q >= T.LOW1:
        out += struct.pack("<HH", len(s.res3), len(s.res3_bit))
    if q > T.LOW3:
        out += struct.pack("<H", len(s.res4))
    if q > T.LOW8:
        out += struct.pack("<H", len(s.res1_bit))
    if q >= T.HIGH1:
        out += struct.pack("<HH", len(s.res5), len(s.res5_bit))
    if q > T.HIGH1:
        out += struct.pack("<IHH", len(s.res6), len(s.res6_bit),
                           len(s.char_res1))
        if q > T.HIGH2:
            out += struct.pack("<H", len(s.qsetting3))
    out += struct.pack("<HH", len(s.select_word1), len(s.select_word2))
    if q > T.LOW5:
        out += struct.pack("<H", len(s.highres_comp))
    out += struct.pack("<H", len(s.res_ch))

    out += s.tree1.tobytes()
    out += s.tree2.tobytes()
    out += s.exw_Y.tobytes()
    if q > T.LOW8:
        out += s.res1.tobytes() + s.res1_bit.tobytes() + s.res1_word.tobytes()
    if q > T.LOW3:
        out += s.res4.tobytes()
    if q >= T.LOW1:
        out += s.res3.tobytes() + s.res3_bit.tobytes() + s.res3_word.tobytes()
    if q >= T.HIGH1:
        out += s.res5.tobytes() + s.res5_bit.tobytes() + s.res5_word.tobytes()
    if q > T.HIGH1:
        out += s.res6.tobytes() + s.res6_bit.tobytes() + s.res6_word.tobytes()
        out += s.char_res1.tobytes()
        if q > T.HIGH2:
            out += s.qsetting3.tobytes()
    out += s.select_word1.tobytes()
    out += s.select_word2.tobytes()
    if q > T.LOW5:
        out += s.res_U_64.tobytes() + s.res_V_64.tobytes()
        out += s.highres_comp.tobytes()
    out += s.res_ch.tobytes()
    out += s.packet1.tobytes()
    out += s.packet2.tobytes()
    return bytes(out)


def write_nhw(quality: int, res_low: int, wavelet_type: int,
              sec: dict) -> bytes:
    """Serialize sections to .nhw bytes (encoder/nhw_encoder.c:3100-3218).

    ``sec`` keys follow models.encoder naming; lengths are derived from the
    arrays exactly as the reference writes them."""
    out = bytearray()
    out.append((res_low + wavelet_type) & 0xFF)
    out.append(quality & 0xFF)

    def u16(v):
        out.extend(struct.pack("<H", v & 0xFFFF))

    def i32(v):
        out.extend(struct.pack("<i", v))

    tree1 = sec["tree1"]
    tree2 = sec["tree2"]
    exw = sec["exw_Y"]
    u16(len(tree1))
    u16(len(tree2))
    i32(sec["size_data1"])
    i32(sec["size_data2"])
    u16(sec["tree_end"])
    u16(len(exw))
    if quality > T.LOW8:
        u16(len(sec["res1"]))
    if quality >= T.LOW1:
        u16(len(sec["res3"]))
        u16(len(sec["res3_bit"]))
    if quality > T.LOW3:
        u16(len(sec["res4"]))
    if quality > T.LOW8:
        u16(len(sec["res1_bit"]))
    if quality >= T.HIGH1:
        u16(len(sec["res5"]))
        u16(len(sec["res5_bit"]))
    if quality > T.HIGH1:
        out.extend(struct.pack("<I", len(sec["res6"])))
        u16(len(sec["res6_bit"]))
        u16(len(sec["char_res1"]))
    if quality > T.HIGH2:
        u16(len(sec["qsetting3"]))
    u16(sec["nhw_select1"])
    u16(sec["nhw_select2"])
    if quality > T.LOW5:
        u16(len(sec["highres_word"]))
    u16(len(sec["ch_res"]))

    out.extend(bytes(tree1))
    out.extend(bytes(tree2))
    out.extend(bytes(bytearray(exw)))
    if quality > T.LOW8:
        out.extend(bytes(sec["res1"]))
        out.extend(bytes(sec["res1_bit"]))
        out.extend(bytes(sec["res1_word"]))
    if quality > T.LOW3:
        out.extend(bytes(sec["res4"]))
    if quality >= T.LOW1:
        out.extend(bytes(sec["res3"]))
        out.extend(bytes(sec["res3_bit"]))
        out.extend(bytes(sec["res3_word"]))
    if quality >= T.HIGH1:
        out.extend(bytes(sec["res5"]))
        out.extend(bytes(sec["res5_bit"]))
        out.extend(bytes(sec["res5_word"]))
    if quality > T.HIGH1:
        out.extend(bytes(sec["res6"]))
        out.extend(bytes(sec["res6_bit"]))
        out.extend(bytes(sec["res6_word"]))
        out.extend(np.asarray(sec["char_res1"], np.uint16).tobytes())
    if quality > T.HIGH2:
        out.extend(np.asarray(sec["qsetting3"], np.uint32).tobytes())
    out.extend(bytes(sec["select_word1"]))
    out.extend(bytes(sec["select_word2"]))
    if quality > T.LOW5:
        out.extend(bytes(sec["res_U_64"]))
        out.extend(bytes(sec["res_V_64"]))
        out.extend(bytes(sec["highres_word"]))
    out.extend(bytes(sec["ch_res"]))
    out.extend(np.asarray(sec["encode"], np.uint32).tobytes())
    return bytes(out)


def dead_tail_byte_positions(data: bytes) -> set[int]:
    """File offsets of the word-plane / select-word tail bytes whose
    padding bits the reference encoder fills with uninitialized heap
    (encoder/nhw_encoder.c:1623-1629 and twins, compress_pixel.c:373-394).
    No decoder reads those bits; byte-exactness is defined modulo them.
    Returns the last two bytes of each *_word section and the last byte of
    each select-word section."""
    import struct as _s

    q = data[1]
    pos = 2
    size_tree1, size_tree2 = _s.unpack_from("<HH", data, pos)
    pos += 4
    size_data1, size_data2 = _s.unpack_from("<ii", data, pos)
    pos += 8
    tree_end, exw_end = _s.unpack_from("<HH", data, pos)
    pos += 4
    res1_len = res3_len = res3_bit = res4_len = res1_bit = 0
    res5_len = res5_bit = res6_len = res6_bit = char_res1 = qset3 = 0
    if q > T.LOW8:
        res1_len = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    if q >= T.LOW1:
        res3_len, res3_bit = _s.unpack_from("<HH", data, pos)
        pos += 4
    if q > T.LOW3:
        res4_len = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    if q > T.LOW8:
        res1_bit = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    if q >= T.HIGH1:
        res5_len, res5_bit = _s.unpack_from("<HH", data, pos)
        pos += 4
    if q > T.HIGH1:
        res6_len = _s.unpack_from("<I", data, pos)[0]
        pos += 4
        res6_bit, char_res1 = _s.unpack_from("<HH", data, pos)
        pos += 4
    if q > T.HIGH2:
        qset3 = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    sel1, sel2 = _s.unpack_from("<HH", data, pos)
    pos += 4
    if q > T.LOW5:
        pos += 2  # highres_comp_len
    pos += 2  # end_ch_res

    dead: set[int] = set()
    pos += size_tree1 + size_tree2 + exw_end
    if q > T.LOW8:
        pos += res1_len + res1_bit
        word = res1_bit  # word plane length == bit length for res1
        # only positions inside the section are dead: a zero-length
        # word plane must not mask the preceding live section's tail
        if word >= 2:
            dead.update({pos + word - 2, pos + word - 1})
        elif word == 1:
            dead.add(pos)
        pos += word
    if q > T.LOW3:
        pos += res4_len
    if q >= T.LOW1:
        pos += res3_len + res3_bit
        word = 2 * res3_bit
        # only positions inside the section are dead: a zero-length
        # word plane must not mask the preceding live section's tail
        if word >= 2:
            dead.update({pos + word - 2, pos + word - 1})
        elif word == 1:
            dead.add(pos)
        pos += word
    if q >= T.HIGH1:
        pos += res5_len + res5_bit
        word = res5_bit
        # only positions inside the section are dead: a zero-length
        # word plane must not mask the preceding live section's tail
        if word >= 2:
            dead.update({pos + word - 2, pos + word - 1})
        elif word == 1:
            dead.add(pos)
        pos += word
    if q > T.HIGH1:
        pos += res6_len + res6_bit
        word = res6_bit
        # only positions inside the section are dead: a zero-length
        # word plane must not mask the preceding live section's tail
        if word >= 2:
            dead.update({pos + word - 2, pos + word - 1})
        elif word == 1:
            dead.add(pos)
        pos += word
        pos += 2 * char_res1
    if q > T.HIGH2:
        pos += 4 * qset3
    if sel1 >= 1:
        dead.add(pos + sel1 - 1)
    pos += sel1
    if sel2 >= 1:
        dead.add(pos + sel2 - 1)
    return dead


def _res_ch_file_offset(data: bytes) -> tuple[int, int, int, int]:
    """(offset, length, quality, res_high) of the res_ch section."""
    import struct as _s

    res_high = data[0]
    q = data[1]
    pos = 2
    size_tree1, size_tree2 = _s.unpack_from("<HH", data, pos)
    pos += 12  # + size_data1/size_data2
    tree_end, exw_end = _s.unpack_from("<HH", data, pos)
    pos += 4
    res1_len = res3_len = res3_bit = res4_len = res1_bit = 0
    res5_len = res5_bit = res6_len = res6_bit = char_res1 = qset3 = 0
    hr_len = 0
    if q > T.LOW8:
        res1_len = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    if q >= T.LOW1:
        res3_len, res3_bit = _s.unpack_from("<HH", data, pos)
        pos += 4
    if q > T.LOW3:
        res4_len = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    if q > T.LOW8:
        res1_bit = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    if q >= T.HIGH1:
        res5_len, res5_bit = _s.unpack_from("<HH", data, pos)
        pos += 4
    if q > T.HIGH1:
        res6_len = _s.unpack_from("<I", data, pos)[0]
        pos += 4
        res6_bit, char_res1 = _s.unpack_from("<HH", data, pos)
        pos += 4
    if q > T.HIGH2:
        qset3 = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    sel1, sel2 = _s.unpack_from("<HH", data, pos)
    pos += 4
    if q > T.LOW5:
        hr_len = _s.unpack_from("<H", data, pos)[0]
        pos += 2
    end_ch_res = _s.unpack_from("<H", data, pos)[0]
    pos += 2
    pos += size_tree1 + size_tree2 + exw_end
    if q > T.LOW8:
        pos += res1_len + 2 * res1_bit
    if q > T.LOW3:
        pos += res4_len
    if q >= T.LOW1:
        pos += res3_len + 3 * res3_bit
    if q >= T.HIGH1:
        pos += res5_len + 2 * res5_bit
    if q > T.HIGH1:
        pos += res6_len + 2 * res6_bit + 2 * char_res1
    if q > T.HIGH2:
        pos += 4 * qset3
    pos += sel1 + sel2
    if q > T.LOW5:
        pos += 4 * T.IM_DIM + hr_len  # res_U_64 + res_V_64 + highres
    return pos, end_ch_res, q, res_high


def discarded_escape_positions(data: bytes) -> set[int]:
    """File offsets of Y-section escape literals whose decoded value is
    discarded: a q>LOW5 escape entering the DC automaton at j==16383
    writes its literal into rc[16384], which the next statement
    overwrites with the following stream byte
    (decoder/nhw_decoder.c:1876-1880).  The reference encoder sources
    these literals from its out-of-bounds tree1-tail read, so the low 7
    bits are uninitialized-heap-dependent; only the escape flag (bit 7)
    is live."""
    try:
        off, n, q, res_high = _res_ch_file_offset(data)
    except Exception:  # noqa: BLE001 — malformed header: nothing to mask
        return set()
    if q <= T.LOW5 or n == 0:
        return set()
    ch = data[off: off + n]
    mode = res_high & 3
    out: set[int] = set()
    i, j = 1, 1
    while j < 16384 and i < len(ch):
        c = ch[i]
        if c >= 128:
            if j == 16383:
                out.add(off + i)
            j += 2
            i += 1
        elif mode == 2:
            if c < 64:
                j += (c & 63) + 2
                i += 1
            else:
                i += 2
                j += 3
        elif mode == 0:
            if c < 16:
                j += ((c >> 3) & 1) + 2
                low = c & 7
                j += 2 if low in (2, 3, 4, 5) else (1 if low else 0)
                i += 1
            elif c < 64:
                j += 2
                i += 1
            else:
                i += 2
                j += 3
        else:  # mode == 1
            if c < 32:
                j += ((c >> 2) & 7) + 2
                if c & 3:
                    j += 1
                i += 1
            elif c < 64:
                j += 2
                i += 1
            else:
                i += 2
                j += 3
    return out


def equal_modulo_dead_bits(a: bytes, b: bytes) -> bool:
    """True when two .nhw files are byte-identical except in the
    uninitialized padding tail bytes (see dead_tail_byte_positions) and
    the discarded boundary-escape literals (see
    discarded_escape_positions, where only bit 7 is compared)."""
    if len(a) != len(b):
        return False
    if a == b:
        return True
    dead = dead_tail_byte_positions(a)
    esc = discarded_escape_positions(a)
    for i, (x, y) in enumerate(zip(a, b)):
        if x == y or i in dead:
            continue
        if i in esc and (x & 0x80) == (y & 0x80):
            continue
        return False
    return True
