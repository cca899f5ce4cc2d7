# Frozen copy of nhwcodec_tpu_torch/host/tables.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""NHW format constants.

These are *data* constants of the .nhw bitstream format (canonical Huffman
code tables, escape-value tables, per-quality scaling factors).  Any
interoperable NHW implementation must agree on them byte-for-byte; they are
transcribed here from the published format reference (decoder/tables.h:46-189,
decoder/nhw_decoder_cli.c:168-254, decoder/nhw_decoder.c:1482) and kept in
plain Python/NumPy form so they can be shipped to device as ``jnp`` constants.
"""

from __future__ import annotations

import numpy as np

# ---------------------------------------------------------------------------
# Geometry (decoder/codec.h:60-63): planes are fixed-size.
IM_DIM = 256          # Y coefficient plane is (2*IM_DIM)^2; U/V are IM_DIM^2
IM_SIZE = IM_DIM * IM_DIM

# Quality levels (decoder/codec.h:66-89). q runs 1..23; 20 is the default.
HIGH3, HIGH2, HIGH1, NORM = 23, 22, 21, 20
LOW1, LOW2, LOW3, LOW4, LOW5, LOW6, LOW7, LOW8 = 19, 18, 17, 16, 15, 14, 13, 12
LOW9, LOW10, LOW11, LOW12, LOW13, LOW14 = 11, 10, 9, 8, 7, 6
LOW15, LOW16, LOW17, LOW18, LOW19, LOW20 = 5, 4, 3, 2, 1, 0

# Huffman decode automaton parameters (decoder/tables.h:46-49).
DEPTH1 = 354   # max codebook depth
ZONE1 = 110    # first zone-word symbol index
UNZONE1 = 64   # index shift applied when zone coding is active
MSW = 511      # symbol-index mask in the decode LUT entries

WVLT_ENERGY_NHW = 123  # base magnitude for escape-coded coefficients

# ---------------------------------------------------------------------------
# extra_table[109]: signed escape values for symbol indices < ZONE1
# (decoder/tables.h:52-57).  Non-zero entry k means the decoded coefficient is
# +-(WVLT_ENERGY_NHW + 8*|k|) with the sign of k.
EXTRA_TABLE = np.array([
    0, 0, 0, 0, 0, 0, 0, 0, 0, 0, 1, 0, 2, 0, 3, 0, 0, 0, 4, 0, 5, 0, 6, 0,
    0, 0, 7, 0, 8, 0, 9, 0, 0, 0, 10, 0,
    11, 0, 12, 0, 0, 0, 13, 0, 14, 0, 15, 0, 0, 0, 16, 0, 17, 0, 18, 0,
    0, 0, 19, 0,
    -1, 0, -2, 0, 0, 0, -3, 0, -4, 0, -5, 0, 0, 0, -6, 0, -7, 0, -8, 0,
    0, 0, -9, 0, -10, 0,
    -11, 0, 0, 0, -12, 0, -13, 0, -14, 0, 0, 0, -15, 0, -16, 0, -17, 0,
    0, 0, -18, 0, -19,
], dtype=np.int32)
assert EXTRA_TABLE.shape == (ZONE1 - 1,)


def _lut(entries: dict[int, int], size: int = 512) -> np.ndarray:
    t = np.zeros(size, dtype=np.uint16)
    for k, v in entries.items():
        t[k] = v
    return t


# Huffman decode LUT #1 (decoder/tables.h:59-123): indexed by the
# left-aligned first bits of a code; entry = (bit_length << 9) | symbol_index.
# Stored sparsely — the table is mostly zero.
NHW_TABLE1 = _lut({
    0: 1024,
    2: 1537, 4: 1538,
    6: 2053, 7: 2054, 10: 2051, 11: 2052,
    24: 2567, 25: 2568, 26: 2569,
    54: 3082, 55: 3083,
    112: 3596, 113: 3597,
    **{232 + k: 4110 + k for k in range(12)},
    **{456 + k: 4634 + k for k in range(8)},
    **{488 + k: 4642 + k for k in range(8)},
})

# Huffman decode LUT #2 (decoder/tables.h:125-189): used after the 5-one
# prefix (0x1F) switches the automaton to the long-code path.
NHW_TABLE2 = _lut({
    0: 5686, 8: 5687,
    16: 6754, 18: 6755, 20: 6756, 22: 6757,
    **{32 + 4 * k: 6226 + k for k in range(8)},
    64: 5170, 80: 5171, 96: 5172, 112: 5173,
    128: 5162, 144: 5163, 160: 5164, 176: 5165,
    192: 5166, 208: 5167, 224: 5168, 240: 5169,
    256: 5688, 264: 5689,
    **{272 + k: 7270 + k for k in range(8)},
    **{288 + 4 * k: 6234 + k for k in range(8)},
    **{320 + 8 * k: 5706 + k for k in range(8)},
    **{384 + 8 * k: 5690 + k for k in range(16)},
})

# ---------------------------------------------------------------------------
# Inverse quantization offsets (decoder/compress_pixel.c:125-126).
INV_QUANT1 = 125
INV_QUANT2 = 131

# Per-quality inverse Y gain applied during YUV->RGB on decode
# (decoder/nhw_decoder_cli.c:168-254).  Index by quality q (1..19 used).
Y_INV = {
    LOW1: 1.025641, LOW2: 1.075269, LOW3: 1.063830,
    LOW4: 1.012139, LOW5: 1.048174, LOW6: 1.138331, LOW7: 1.186945,
    LOW8: 1.177434, LOW9: 1.190611, LOW10: 1.281502, LOW11: 1.392014,
    LOW12: 1.521263, LOW13: 1.587597, LOW14: 1.665887, LOW15: 1.741126,
    LOW16: 1.820444, LOW17: 1.916257, LOW18: 1.985939, LOW19: 2.060881,
}

# Integer YUV->RGB matrix constants for q<=LOW4 (decoder/codec.h:96-98).
R_COMP = -56992 - 128
G_COMP = 34784 - 128
B_COMP = -70688 - 128

# UV LL2 small-DC-offset pair table (decoder/nhw_decoder.c:1482).
UV_SMALL_DC_OFFSET = np.array(
    [[0, 4], [0, -4], [4, 0], [-4, 0], [4, 4], [4, -4], [-4, 4], [-4, -4]],
    dtype=np.int32,
)


# ---------------------------------------------------------------------------
# Canonical Huffman code table (encoder side of the same format contract the
# decode LUTs above invert; published reference encoder/tree.h:58-140).
# HUFFMAN_CODES[i] = MSB-aligned-on-emit code value, HUFFMAN_LENS[i] = bits.

HUFFMAN_CODES = np.array([
    0x0000, 0x0002, 0x0004, 0x000a, 0x000b, 0x0006, 0x0007, 0x0018,
    0x0019, 0x001a, 0x0036, 0x0037, 0x0070, 0x0071, 0x00e8, 0x00e9,
    0x00ea, 0x00eb, 0x00ec, 0x00ed, 0x00ee, 0x00ef, 0x00f0, 0x00f1,
    0x00f2, 0x00f3, 0x01c8, 0x01c9, 0x01ca, 0x01cb, 0x01cc, 0x01cd,
    0x01ce, 0x01cf, 0x01e8, 0x01e9, 0x01ea, 0x01eb, 0x01ec, 0x01ed,
    0x01ee, 0x01ef, 0x03e8, 0x03e9, 0x03ea, 0x03eb, 0x03ec, 0x03ed,
    0x03ee, 0x03ef, 0x03e4, 0x03e5, 0x03e6, 0x03e7, 0x07c0, 0x07c1,
    0x07e0, 0x07e1, 0x07f0, 0x07f1, 0x07f2, 0x07f3, 0x07f4, 0x07f5,
    0x07f6, 0x07f7, 0x07f8, 0x07f9, 0x07fa, 0x07fb, 0x07fc, 0x07fd,
    0x07fe, 0x07ff, 0x07e8, 0x07e9, 0x07ea, 0x07eb, 0x07ec, 0x07ed,
    0x07ee, 0x07ef, 0x0f88, 0x0f89, 0x0f8a, 0x0f8b, 0x0f8c, 0x0f8d,
    0x0f8e, 0x0f8f, 0x0fc8, 0x0fc9, 0x0fca, 0x0fcb, 0x0fcc, 0x0fcd,
    0x0fce, 0x0fcf, 0x1f08, 0x1f09, 0x1f0a, 0x1f0b, 0x3f10, 0x3f11,
    0x3f12, 0x3f13, 0x3f14, 0x3f15, 0x3f16, 0x3f17,
    *[0x1f0c0 + k for k in range(64)],
    *[0x1f8c0 + k for k in range(46)],
    *[0x3f1dc + k for k in range(12)],
    *[0x7e3d0 + k for k in range(38)],
    *[0xfc7ec + k for k in range(20)],
], dtype=np.uint32)
assert HUFFMAN_CODES.shape == (290,)

HUFFMAN_LENS = np.array(
    [2, 3, 3, 4, 4, 4, 4, 5, 5, 5, 6, 6, 7, 7]
    + [8] * 12 + [9] * 16 + [10] * 12 + [11] * 28 + [12] * 16
    + [13] * 4 + [14] * 8 + [17] * 110 + [18] * 12 + [19] * 38 + [20] * 20,
    dtype=np.int32)
assert HUFFMAN_LENS.shape == (290,)
