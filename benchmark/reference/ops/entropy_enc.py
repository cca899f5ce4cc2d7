# Frozen copy of nhwcodec_tpu_torch/host/ops/entropy_enc.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Static-Huffman packetizer (encoder side).

Reference behavior: wavlts2packet (encoder/compress_pixel.c:53-469).
Two passes over the interleaved code stream (part 0 = Y, part 1 = UV):
run-length histogram with an adaptive minimum run length ``select``,
stable descending weight sort (the C bubble sort is stable), canonical
code emission with a 15-bit zone fast path, 32-bit MSB-first word
packing, and even/odd-interleaved RLE codebook serialization.

The histogram and bit-packing are vectorizable (prefix sums over code
lengths); this host version keeps the exact scan semantics including the
run-rewind (`tag`) re-emission of short runs.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T

SZ = 65536


class PacketResult:
    def __init__(self):
        self.encode_words: np.ndarray | None = None
        self.size_data1 = 0
        self.size_data2 = 0
        self.wavelet_type = 0
        self.tree1: np.ndarray | None = None
        self.tree2: np.ndarray | None = None
        self.tree_end = 0
        self.select_word1: np.ndarray | None = None
        self.select_word2: np.ndarray | None = None
        self.nhw_select1 = 0
        self.nhw_select2 = 0


def _histogram(s: np.ndarray, p1: int, p2: int):
    """First stage (compress_pixel.c:77-107): symbol counts + run counts."""
    rle_buf = np.zeros(256, np.int64)
    rle_128 = np.zeros(256, np.int64)
    e = 1
    c = 0
    i = p1
    while i < p2 - 1:
        if s[i] == 128:
            while i < p2 - 1 and s[i + 1] == 128:
                e += 1
                c = 1
                if e > 255:
                    rle_128[254] += 1
                    e = 1
                    c = 0
                    continue  # C: goto L_RUN1 re-tests s[i]==128 (it is)
                i += 1
        if c:
            rle_128[e] += 1
        else:
            rle_buf[s[i]] += 1
        e = 1
        c = 0
        i += 1
    return rle_buf, rle_128


_SYM_POSITIONS = ([i for i in range(0, 109, 2)] + [112]
                  + list(range(120, 141)) + list(range(144, 256, 4)))


def _build_codebook(rle_buf: np.ndarray, rle_128: np.ndarray, select: int):
    """L_RATIO stage (compress_pixel.c:132-252): entry list + stable
    descending sort.  Mutates rle_128 (runs below select are dropped
    cumulatively across retries).  Returns (entries, weights, select)."""
    thresh = 354
    while True:
        # weight2[128] is seeded from rle_buf[128] (symbol position 128 is
        # in the 120..140 range) before run weights are folded in; retries
        # reuse the previously-overwritten rle_buf[128] exactly like C
        w128 = int(rle_buf[128]) if rle_buf[128] > 0 else 0
        w128 += sum(j * int(rle_128[j]) for j in range(2, 256)
                    if rle_128[j] > 0)
        for j in range(2, select):
            rle_128[j] = 0
        for j in range(select, 256):
            if rle_128[j] > 0:
                w128 -= j * int(rle_128[j])
        rle_buf[128] = w128

        entries: list[int] = []
        weights: list[int] = []
        for j in range(select, 256):
            if rle_128[j] > 0:
                entries.append((j << 8) | 128)
                weights.append(int(rle_128[j]))
        for i in _SYM_POSITIONS:
            if rle_buf[i] > 0:
                entries.append((1 << 8) | i)
                weights.append(int(rle_buf[i]))
        if len(entries) <= thresh:
            break
        select += 1
        if select >= 100:
            raise OverflowError("codebook overflow")

    order = sorted(range(len(entries)), key=lambda x: -weights[x])
    entries = [entries[x] for x in order]
    weights = [weights[x] for x in order]
    return entries, weights, select


def _pack_select_bits(bits) -> tuple[np.ndarray, int]:
    bits = np.asarray(bits, np.uint8)
    c = len(bits)
    b = (c >> 3) + 1
    out = np.zeros(b << 3, np.uint8)
    out[:c] = bits & 1
    packed = np.packbits(out)
    return packed, b


def _serialize_tree1(entries: list[int]) -> tuple[np.ndarray, list[int]]:
    """Returns (serialized tree1, the interleaved codebook content) —
    the reference leaves that content in its shared stack buffer
    (encoder/compress_pixel.c:58 ``codebook[580]``), where the tree2
    pass's trailing-run overread later consumes it."""
    raw: list[int] = []
    for t in entries:
        if (t >> 8) == 1:
            raw.append(t & 0xFF)
        else:
            raw.append(3)
            raw.append(t >> 8)
    cb = raw[0::2] + raw[1::2]
    out: list[int] = []
    i = 0
    c = 0
    while i < len(cb):
        if cb[i] == 3:
            c += 1
            i += 1
            continue
        if c > 0:
            out.append(3)
            out.append(c)
            c = 0
            continue
        out.append(cb[i])
        i += 1
    if c > 0:  # trailing marker run is flushed against the stack slack
        out.append(3)
        out.append(c)
    return np.array(out, np.uint8), cb


def _serialize_tree2(entries: list[int], prev_cb: list[int] | None = None
                     ) -> tuple[np.ndarray, int]:
    """``prev_cb``: the Y pass's interleaved codebook content.  The
    reference's RLE loop (encoder/compress_pixel.c:446-456) chases a
    trailing 128-run past ``tree_end`` with an unbounded ``goto``, so
    when the UV codebook ends in a run the count absorbs whatever
    consecutive 128s the Y pass left in the shared ``codebook[580]``
    stack buffer beyond the UV length — emulated here (the decoder
    never expands entries past tree_end, so the inflation is
    value-dead; proven by reference-decode equality)."""
    raw: list[int] = []
    for t in entries:
        if (t >> 8) == 1:
            raw.append((t & 0xFF) | 1)
        else:
            raw.append(t & 0xFF)  # 128
            raw.append(t >> 8)
    tree_end = len(raw)
    cb = raw[0::2] + raw[1::2]
    out: list[int] = []
    i = 0
    c = 0
    while i < len(cb):
        if cb[i] == 128:
            c += 1
            i += 1
            continue
        if c > 0:
            out.append(128)
            out.append(c)
            c = 0
            continue
        out.append(cb[i])
        i += 1
    if c > 0:
        if prev_cb is not None:
            j = len(cb)
            while j < len(prev_cb) and prev_cb[j] == 128:
                c += 1
                j += 1
        out.append(128)
        out.append(c)
    return np.array(out, np.uint8), tree_end


class _BitPacker:
    """32-bit MSB-first word packer (compress_pixel.c:329-356); plain
    Python ints for speed, materialized to uint32 at the end."""

    def __init__(self):
        self.words = [0] * 80000
        self.a = 0
        self.pack = 0

    def put(self, code: int, nbits: int) -> None:
        pack = self.pack + nbits
        if pack <= 32:
            self.words[self.a] |= (code << (32 - pack)) & 0xFFFFFFFF
        else:
            match = pack - 32
            w = self.words
            a = self.a
            w[a] |= code >> match
            a += 1
            w[a] |= (code << (32 - match)) & 0xFFFFFFFF
            self.a = a
            pack = match
        self.pack = pack


class TokenizedPacket:
    """Host-tokenized Huffman stream awaiting (batched) device packing.

    The sequential half of wavlts2packet has run — histogram, codebook,
    the run/select token automaton, tree/select serialization — and only
    the bit packing (a parallel prefix over code lengths,
    ops.entropy_device.pack_token_rows) is pending.  ``pos``/``zone``
    hold per-part codebook positions and zone flags; empty ``pos`` means
    ``res`` is already complete (pure-Python fallback host-packed it)."""

    __slots__ = ("pos", "zone", "res")

    def __init__(self):
        self.pos: list[np.ndarray] = []
        self.zone: list[bool] = []
        self.res = PacketResult()


def wavlts2packet_tokenize(im_nhw: np.ndarray) -> TokenizedPacket:
    """Run everything in wavlts2packet except the bit packing; pair with
    pack_tokenized_batch, which packs many images' parts in one device
    program.  Byte-identical end result to the host packer
    (tests/test_entropy_device.py)."""
    from benchmark.reference import native

    tp = TokenizedPacket()
    if not native.available():
        # the pure-Python tokenizer path host-packs inline; the batch
        # packer passes the finished result through
        tp.res = wavlts2packet(im_nhw, 0, 0)
        return tp

    lib = native._load()
    ffi = native.ffi()
    res = tp.res
    s = np.ascontiguousarray(im_nhw, np.uint8)
    sp = ffi.cast("uint8_t *", s.ctypes.data)
    sel1 = np.zeros(1 << 17, np.uint8)
    sel2 = np.zeros(1 << 17, np.uint8)
    n_sel1 = ffi.new("long *", 0)
    n_sel2 = ffi.new("long *", 0)

    color = int(s[4 * SZ])
    s[4 * SZ] = 3
    y_cb: list[int] | None = None

    for part in (0, 1):
        if part == 0:
            p1, p2, select0 = 0, 4 * SZ, 4
        else:
            s[4 * SZ] = color
            s[6 * SZ - 1] = s[6 * SZ - 2]
            p1, p2, select0 = 4 * SZ, 6 * SZ, 3

        rle_buf = np.zeros(256, np.int64)
        rle_128 = np.zeros(256, np.int64)
        lib.nhw_histogram(sp, p1, p2,
                          ffi.cast("int64_t *", rle_buf.ctypes.data),
                          ffi.cast("int64_t *", rle_128.ctypes.data))
        entries, weights, select = _build_codebook(rle_buf, rle_128, select0)
        k = len(entries)

        sym_pos = np.zeros(256, np.int32)
        run_pos = np.zeros(256, np.int32)
        for idx, t in enumerate(entries):
            if (t >> 8) == 1:
                sym_pos[t & 0xFF] = idx
            else:
                run_pos[t >> 8] = idx

        b_top = 1 if entries and entries[0] == ((1 << 8) | 128) else 0
        if part == 0 and b_top == 0 and k > 290:
            raise OverflowError("Y codebook >290 without top run symbol")
        if part == 1 and select != 4 and k > 290:
            raise OverflowError("UV codebook >290")
        zone = 1 if (select == 4 and b_top == 1 and part == 0) else 0

        tokens = np.empty(6 * SZ + 64, np.int32)
        n_tok = lib.nhw_tokenize(
            sp, p1, p2, select,
            ffi.cast("uint8_t *", sel1.ctypes.data), n_sel1,
            ffi.cast("uint8_t *", sel2.ctypes.data), n_sel2,
            ffi.cast("int32_t *", tokens.ctypes.data), tokens.size)
        if n_tok < 0:
            raise OverflowError("token stream exceeds buffer")
        pos = np.empty(n_tok, np.int32)
        lib.nhw_map_tokens(
            ffi.cast("const int32_t *", tokens.ctypes.data), n_tok,
            ffi.cast("const int32_t *", sym_pos.ctypes.data),
            ffi.cast("const int32_t *", run_pos.ctypes.data),
            ffi.cast("int32_t *", pos.ctypes.data))
        tp.pos.append(pos)
        tp.zone.append(bool(zone))

        if part == 0:
            res.wavelet_type = 4 if (select > 4 or b_top == 0) else 0
            res.select_word1, _ = _pack_select_bits(sel1[: n_sel1[0]])
            res.nhw_select1 = len(res.select_word1)
            res.select_word2, _ = _pack_select_bits(sel2[: n_sel2[0]])
            res.nhw_select2 = len(res.select_word2)
            res.tree1, y_cb = _serialize_tree1(entries)
        else:
            res.tree2, res.tree_end = _serialize_tree2(entries, y_cb)
    return tp


def wavlts2packet(im_nhw: np.ndarray, nhw_select1: int,
                  nhw_select2: int) -> PacketResult:
    """Both Huffman passes over the full 6*IM_SIZE code stream."""
    from benchmark.reference import native

    if native.available():
        return _wavlts2packet_native(im_nhw, native)
    res = PacketResult()
    s = im_nhw.tolist()  # plain ints: the scan loops dominate otherwise
    packer = _BitPacker()

    color = s[4 * SZ]
    s[4 * SZ] = 3
    sel1_bits: list[int] = []
    sel2_bits: list[int] = []

    for part in (0, 1):
        if part == 0:
            p1, p2, select = 0, 4 * SZ, 4
        else:
            s[4 * SZ] = color
            s[6 * SZ - 1] = s[6 * SZ - 2]
            p1, p2, select = 4 * SZ, 6 * SZ, 3
            packer.a += 1
            packer.pack = 0

        rle_buf, rle_128 = _histogram(s, p1, p2)
        sym_codes = [(int(T.HUFFMAN_CODES[k]), int(T.HUFFMAN_LENS[k]))
                     for k in range(290)]
        entries, weights, select = _build_codebook(rle_buf, rle_128, select)
        k = len(entries)

        sym_pos = [0] * 256
        run_pos = [0] * 256
        for idx, t in enumerate(entries):
            if (t >> 8) == 1:
                sym_pos[t & 0xFF] = idx
            else:
                run_pos[t >> 8] = idx

        b_top = 1 if entries and entries[0] == ((1 << 8) | 128) else 0
        if part == 0 and b_top == 0 and k > 290:
            raise OverflowError("Y codebook >290 without top run symbol")
        if part == 1 and select != 4 and k > 290:
            raise OverflowError("UV codebook >290")
        zone = 1 if (select == 4 and b_top == 1 and part == 0) else 0

        e = 1
        tag = 0
        i = p1
        while i < p2 - 1:
            pixel = s[i]

            if pixel == 153:
                sel1_bits.append(0)
                i += 1
                continue
            if pixel == 155:
                sel1_bits.append(1)
                i += 1
                continue
            if pixel == 157:
                sel2_bits.append(0)
                i += 1
                continue
            if pixel == 159:
                sel2_bits.append(1)
                i += 1
                continue

            if pixel != 128 and 120 < pixel < 136:
                pos = sym_pos[pixel]
                if pixel > 131:
                    i += 4
            else:
                if pixel == 128:
                    overflow = False
                    while i < p2 - 1 and s[i + 1] == 128:
                        e += 1
                        if e > 255:
                            e = 254
                            i -= 1
                            overflow = True
                            break
                        i += 1
                    if not overflow and 1 < e < select:
                        i -= e - 1
                        tag = e
                        e = 1
                pos = sym_pos[pixel] if e == 1 else run_pos[e]

            while True:
                if 110 <= pos < 174 and zone:
                    packer.put(64 | (pos - 110), 15)
                else:
                    p = pos
                    if p >= 174 and zone:
                        p -= 64
                    packer.put(*sym_codes[p])
                e = 1
                if tag > 0:
                    tag -= 1
                    if tag > 0:
                        i += 1
                        # C re-enters L_JUMP with the stale pixel (==128)
                        pos = sym_pos[128]
                        continue
                break
            i += 1

        if part == 0:
            res.size_data1 = packer.a + 1
            res.wavelet_type = 4 if (select > 4 or b_top == 0) else 0
            res.select_word1, _ = _pack_select_bits(sel1_bits)
            res.nhw_select1 = len(res.select_word1)
            res.select_word2, _ = _pack_select_bits(sel2_bits)
            res.nhw_select2 = len(res.select_word2)
            res.tree1, y_cb = _serialize_tree1(entries)
        else:
            res.size_data2 = packer.a + 1
            res.tree2, res.tree_end = _serialize_tree2(entries, y_cb)

    res.encode_words = np.array(packer.words[: res.size_data2], np.uint32)
    return res


def _wavlts2packet_native(im_nhw: np.ndarray, native) -> PacketResult:
    """Native-scan variant: histogram + emit run in C, codebook build and
    serialization stay in Python (identical results to the list path)."""
    lib = native._load()
    ffi = native.ffi()
    res = PacketResult()
    s = np.ascontiguousarray(im_nhw, np.uint8)
    sp = ffi.cast("uint8_t *", s.ctypes.data)

    words = np.zeros(80000, np.uint32)
    wp = ffi.cast("uint32_t *", words.ctypes.data)
    sel1 = np.zeros(1 << 17, np.uint8)
    sel2 = np.zeros(1 << 17, np.uint8)
    n_sel1 = ffi.new("long *", 0)
    n_sel2 = ffi.new("long *", 0)
    pack_out = ffi.new("int *", 0)

    color = int(s[4 * SZ])
    s[4 * SZ] = 3
    a = 0
    pack = 0

    for part in (0, 1):
        if part == 0:
            p1, p2, select0 = 0, 4 * SZ, 4
        else:
            s[4 * SZ] = color
            s[6 * SZ - 1] = s[6 * SZ - 2]
            p1, p2, select0 = 4 * SZ, 6 * SZ, 3
            a += 1
            pack = 0

        rle_buf = np.zeros(256, np.int64)
        rle_128 = np.zeros(256, np.int64)
        lib.nhw_histogram(sp, p1, p2,
                          ffi.cast("int64_t *", rle_buf.ctypes.data),
                          ffi.cast("int64_t *", rle_128.ctypes.data))
        entries, weights, select = _build_codebook(rle_buf, rle_128, select0)
        k = len(entries)

        sym_pos = np.zeros(256, np.int32)
        run_pos = np.zeros(256, np.int32)
        for idx, t in enumerate(entries):
            if (t >> 8) == 1:
                sym_pos[t & 0xFF] = idx
            else:
                run_pos[t >> 8] = idx

        b_top = 1 if entries and entries[0] == ((1 << 8) | 128) else 0
        if part == 0 and b_top == 0 and k > 290:
            raise OverflowError("Y codebook >290 without top run symbol")
        if part == 1 and select != 4 and k > 290:
            raise OverflowError("UV codebook >290")
        zone = 1 if (select == 4 and b_top == 1 and part == 0) else 0

        codes = np.zeros(354, np.uint32)
        lens = np.zeros(354, np.int32)
        codes[:290] = T.HUFFMAN_CODES
        lens[:290] = T.HUFFMAN_LENS

        a = lib.nhw_emit(sp, p1, p2, select, zone,
                         ffi.cast("int32_t *", sym_pos.ctypes.data),
                         ffi.cast("int32_t *", run_pos.ctypes.data),
                         ffi.cast("uint32_t *", codes.ctypes.data),
                         ffi.cast("int32_t *", lens.ctypes.data),
                         wp, words.size, a, pack,
                         ffi.cast("uint8_t *", sel1.ctypes.data), n_sel1,
                         ffi.cast("uint8_t *", sel2.ctypes.data), n_sel2,
                         pack_out)
        if a < 0:
            # mirrors the reference's overload guard
            # (encoder/compress_pixel.c:234,270-271) but fails cleanly
            # instead of corrupting the heap
            raise OverflowError("packed stream exceeds word buffer")
        pack = pack_out[0]

        if part == 0:
            res.size_data1 = a + 1
            res.wavelet_type = 4 if (select > 4 or b_top == 0) else 0
            res.select_word1, _ = _pack_select_bits(sel1[: n_sel1[0]])
            res.nhw_select1 = len(res.select_word1)
            res.select_word2, _ = _pack_select_bits(sel2[: n_sel2[0]])
            res.nhw_select2 = len(res.select_word2)
            res.tree1, y_cb = _serialize_tree1(entries)
        else:
            res.size_data2 = a + 1
            res.tree2, res.tree_end = _serialize_tree2(entries, y_cb)

    res.encode_words = words[: res.size_data2].copy()
    return res
