# Frozen copy of nhwcodec_tpu_torch/host/ops/streams.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""Positional residue side-stream decode (res1/res3/res5/res6).

Reference behavior: decoder/nhw_decoder.c:93-491.  Each stream is a list of
packed column positions with row-advance markers (byte 127), pair-delta
escapes (>=128: two positions from one byte), an LSB bit-plane re-add, and a
final routing pass that splits positions into add/subtract (or 4-way, for
res3) lists using a packed decision-word plane.

Stage A (delta undo) is serial over a few thousand bytes and runs on host;
stages B/C are vectorized.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference import tables as T
from benchmark.reference.ops.entropy import expand_bits


def _positions(res: np.ndarray, n_entries: int, row_step: int,
               first_count: int, pack_shift: int) -> np.ndarray:
    """Stage A: undo pair-deltas and row markers.

    ``row_step``: count increment per marker (1 for res1/3/5, IM_DIM for
    res6).  ``pack_shift``: how the row counter is packed with the column
    (8 for the u16 streams, 0 for res6 whose counter is already a linear
    offset).  Returns int64 array of length ``n_entries`` (zero padded).
    """
    from benchmark.reference import native

    if native.available() and len(res) and n_entries:
        lib = native._load()
        ffi = native.ffi()
        rc = np.ascontiguousarray(res, np.uint8)
        pos = np.zeros(n_entries, np.int64)
        lib.nhw_stream_positions(
            ffi.cast("const uint8_t *", rc.ctypes.data), rc.size,
            ffi.cast("int64_t *", pos.ctypes.data), n_entries,
            row_step, first_count, pack_shift)
        return pos

    r = res.tolist()
    pos = [0] * n_entries
    stage = 0
    if r[0] == 127:
        count = first_count
    else:
        pos[stage] = r[0] << 1
        stage += 1
        count = 0

    n = len(r)
    for i in range(1, n):
        c = r[i]
        if c >= 128:
            e = (c - 128) >> 4
            scan = c & 15
            if r[i - 1] != 127:
                j = (pos[stage - 1] & 255) + (e << 1) if stage > 0 else (e << 1)
            else:
                r[i] = 127
                count += 2 * row_step
                continue
            if j >= 254:
                count += row_step
                r[i] = 127
            else:
                pos[stage] = j + (count << pack_shift)
                stage += 1
            j += scan << 1
            if j >= 254:
                count += row_step
                r[i] = 127
            else:
                pos[stage] = j + (count << pack_shift)
                stage += 1
        elif c == 127:
            count += row_step
        else:
            if stage > 0 and (c << 1) < (pos[stage - 1] & 255) and r[i - 1] != 127:
                count += row_step
            pos[stage] = (c << 1) + (count << pack_shift)
            stage += 1
    return np.array(pos, dtype=np.int64)


def _add_bits(pos: np.ndarray, bit: np.ndarray) -> np.ndarray:
    bits = expand_bits(bit).astype(np.int64)
    out = pos.copy()
    out[: len(bits)] += bits[: len(out)]
    return out


def decode_stream2(res: np.ndarray, bit: np.ndarray, word: np.ndarray,
                   row_step: int = 1, first_count: int = 1,
                   pack_shift: int = 8) -> tuple[np.ndarray, np.ndarray]:
    """res1/res5/res6-style stream -> (sub_positions, add_positions).

    word-plane bit 1 routes to the subtract list, 0 to the add list
    (decoder/nhw_decoder.c:150-181, 244-277, 339-387).
    """
    bit_len = len(bit)
    pos = _positions(res, bit_len << 3, row_step, first_count, pack_shift)
    pos = _add_bits(pos, bit)
    if pack_shift == 8:
        pos &= 0xFFFF  # the reference stores these in unsigned short
    if bit_len == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z
    wbits = expand_bits(word).astype(bool)[: (bit_len - 1) * 8]
    routed = pos[: (bit_len - 1) * 8]
    return routed[wbits], routed[~wbits]


def decode_stream4(res: np.ndarray, bit: np.ndarray, word: np.ndarray
                   ) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """res3-style stream -> 4 position lists keyed by 2-bit selectors
    (decoder/nhw_decoder.c:392-491).

    Returns (add43, sub43, add2, sub2): selector 0 -> +4/+3 pair,
    1 -> -4/-3 pair, 2 -> +2 triple, 3 -> -2 triple.
    """
    bit_len = len(bit)
    pos = _positions(res, bit_len << 3, 1, 1, 8)
    pos = _add_bits(pos, bit) & 0xFFFF
    if bit_len == 0:
        z = np.zeros(0, dtype=np.int64)
        return z, z, z, z
    n_fields = ((bit_len << 1) - 2) * 4
    w = word.astype(np.int64)
    sel = np.stack([(w >> 6) & 3, (w >> 4) & 3, (w >> 2) & 3, w & 3],
                   axis=-1).reshape(-1)[:n_fields]
    routed = pos[:n_fields]
    return (routed[sel == 0], routed[sel == 1],
            routed[sel == 2], routed[sel == 3])


def stream_entry_count(bit_len: int) -> int:
    """Number of routed entries = 8*(bit_len-1); the trailing byte of the
    word plane is never consumed (reference loop bound)."""
    return max(0, (bit_len - 1) * 8)
