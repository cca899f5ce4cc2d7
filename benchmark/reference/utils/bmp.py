# Frozen copy of nhwcodec_tpu_torch/host/utils/bmp.py at commit a4a43cf (the benchmark's
# reference); package paths rewritten to benchmark.reference.
"""BMP I/O with the reference codec's byte-order conventions.

The reference treats BMP pixel bytes as (R,G,B) triplets in file order and
does NOT flip bottom-up rows (encoder/nhw_encoder.c:3086-3093 flips only when
the header height is negative; decoder/nhw_decoder_cli.c:130-163 writes the
same way), so encode->decode roundtrips are self-consistent.  We reproduce
exactly that: ``read_bmp512`` returns the pixel bytes as a (512, 512, 3)
array in *file order* — whatever colour/row convention the file used.
"""

from __future__ import annotations

import struct
from pathlib import Path

import numpy as np

HEADER_SIZE = 54


def write_bmp512(path: Path | str, pixels: np.ndarray) -> None:
    """Write a (512,512,3) uint8 array as a minimal 24bpp BMP.

    Bytes are written in array order (reference convention: no row flip,
    triplets stored as given).  Matches decoder/nhw_decoder_cli.c:61-65
    header layout.
    """
    pixels = np.ascontiguousarray(pixels, dtype=np.uint8)
    assert pixels.shape == (512, 512, 3)
    data = pixels.tobytes()
    header = bytearray(HEADER_SIZE)
    header[0:2] = b"BM"
    struct.pack_into("<I", header, 2, len(data) + HEADER_SIZE)
    struct.pack_into("<I", header, 10, HEADER_SIZE)
    struct.pack_into("<I", header, 14, 40)          # BITMAPINFOHEADER
    struct.pack_into("<i", header, 18, 512)          # width
    struct.pack_into("<i", header, 22, 512)          # height (positive)
    struct.pack_into("<H", header, 26, 1)            # planes
    struct.pack_into("<H", header, 28, 24)           # bpp
    struct.pack_into("<I", header, 34, len(data))    # image size
    Path(path).write_bytes(bytes(header) + data)


def read_bmp512(path: Path | str) -> np.ndarray:
    """Read a 24bpp 512x512 BMP the way the reference encoder does.

    Validates width==height==512, 24bpp, uncompressed; flips rows only when
    height<0 (encoder/nhw_encoder.c:3089-3093).  Returns (512,512,3) uint8 in
    file byte order.
    """
    raw = Path(path).read_bytes()
    if raw[0:2] != b"BM":
        raise ValueError("not a BMP file")
    data_offset = struct.unpack_from("<I", raw, 10)[0]
    dib = struct.unpack_from("<I", raw, 14)[0]
    if dib >= 40:
        width = struct.unpack_from("<i", raw, 18)[0]
        height = struct.unpack_from("<i", raw, 22)[0]
        bpp = struct.unpack_from("<H", raw, 28)[0]
        compression = struct.unpack_from("<I", raw, 30)[0]
    else:  # BITMAPCOREHEADER
        width = struct.unpack_from("<H", raw, 18)[0]
        height = struct.unpack_from("<H", raw, 20)[0]
        bpp = struct.unpack_from("<H", raw, 24)[0]
        compression = 0
    if width != 512 or abs(height) != 512:
        raise ValueError("NHW requires 512x512 images")
    if bpp != 24 or compression != 0:
        raise ValueError("NHW requires uncompressed 24bpp BMP")
    pixels = np.frombuffer(
        raw, dtype=np.uint8, count=512 * 512 * 3, offset=data_offset
    ).reshape(512, 512, 3)
    if height < 0:
        pixels = pixels[::-1]
    return pixels.copy()
