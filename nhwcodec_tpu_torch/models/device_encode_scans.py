"""The full-device encode configuration, in parts.

Port of ``nhwcodec_tpu.models.device_encode_scans``.  The JAX function
``encode_batch_scans_device`` runs every post-transform raster scan of
the encoder on the device, stage-major: each device stage runs once for
the whole batch.  This module holds its last two stages so far, cut from
the JAX function into helpers that a later ``encode_batch_scans_device``
calls, each once for the whole batch:

- ``_y_residue_stage``: the E11 tail (the mid-q band cleanup, pair
  promotion) and E12 (the res256 column ladder, classify, the res1, res3
  and res5 positional streams) on the plane after the host's E10 part-0
  offset and synthesis, then the LL2-zone rebuild; ``_residue_sections``
  slices each image's res sections out of its streams on the host;
- ``_y_stream_stage``: the three E11 snap passes, the E14 Y quantizer
  and the E15 serpentine, crossing merge, select codes and run cap;
- ``_uv_stream_stage``: the E14 chroma quantizer and serpentine of one
  component, written into the stream's UV half.

The residue stage's plane goes straight into the stream stage.  Y's
merge, select and cap run before any UV byte is written: the select
reads up to five bytes past a candidate, so near 4 SZ it reads the UV
half, which must still be zero then.  Together they give the res
sections, the whole 6 SZ ``im_nhw`` and ``nhw_select1/2``,
byte-identical to the host copy's ``encoder.encode_y`` from its E11 tail
on and ``encode_uv``'s ``offset_uv`` + ``quantize.serpentine_uv``
(tests/test_torch_encode_residue_stage.py,
tests/test_torch_encode_scans.py).
The stages cover LOW4 < q <= HIGH1; q <= LOW4 needs ``offset_y_low4``
and the low-q cleanups.
"""

from __future__ import annotations

import numpy as np
import torch

from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models.encoder import _res_setting
from nhwcodec_tpu_torch.models import device_scans as ds

D = 256
N = 512
SZ = 65536
RATIO = 8


def snap_args(q: int) -> list[tuple]:
    """The three snap passes' arguments at quality q, in order:
    (r0, r1, col0, col1, thr, yw, yw2, second_rule, snap_guard6, gc) for
    ``device_scans.snap_pass_device`` (encoder/nhw_encoder.c:1914-2098;
    the host copy's ``encoder.encode_y``)."""
    r = RATIO
    yw1 = (8, 4) if q > T.HIGH2 else (9, 9)
    if q > T.HIGH2:
        yw2 = (8, 4)
    elif q > T.LOW3:
        yw2 = (8, 9)
    else:
        yw2 = (9, 9)
    yw3 = 8 if q > T.HIGH2 else 11
    return [(1, 255, D + 1, 2 * D - 1, r - 2, *yw1, False, True, 2 * D - 2),
            (D, 511, 1, D, r - 2, *yw2, True, False, D - 2),
            (D, 511, D + 1, 2 * D - 1, r - 1, yw3, yw3, False, False,
             2 * D - 2)]


# the positional streams in the order the C builds them: (key, code ->
# (word value, replacement code), word bits, lowest quality); each stream's
# replacements feed the next (res1 turns 126/125/148/149 into 122/121/144/145)
RESIDUE_STREAMS = (
    ("res1", {141: (1, 0), 140: (0, 0), 126: (0, 122), 125: (1, 121),
              148: (1, 144), 149: (0, 145)}, 1, T.LOW8 + 1),
    ("res3", {121: (1, 0), 122: (0, 0), 123: (2, 0), 124: (3, 0)}, 2,
     T.LOW1),
    ("res5", {144: (1, 0), 145: (0, 0)}, 1, T.HIGH1))
# rf_ext's tail after res256: the kernel head, the next chunk's size field
# [17, 2, 0, 0], then resIII (host.ops.residue.res256_column_ladder)
CHUNK_FIELD = (17, 2, 0, 0)


def _stream_tables(codes: dict) -> tuple:
    wt = np.full(256, -1, np.int32)
    rt = np.zeros(256, np.int32)
    for c, (w, r) in codes.items():
        wt[c], rt[c] = w, r
    return wt, rt


def _rf_ext(res256: torch.Tensor, khead: torch.Tensor,
            resIII: torch.Tensor) -> torch.Tensor:
    """(B, SZ + 1024) int16: res256 and the tail the column ladder reads
    past it (JAX device_encode_scans.py:190-195)."""
    b = res256.shape[0]
    rf_ext = torch.empty((b, ds.RF_EXT), dtype=torch.int16,
                         device=res256.device)
    rf_ext[:, :SZ] = res256.reshape(b, SZ)
    rf_ext[:, SZ: SZ + 4] = khead
    rf_ext[:, SZ + 4: SZ + 8] = torch.tensor(CHUNK_FIELD, dtype=torch.int16,
                                             device=res256.device)
    rf_ext[:, SZ + 8:] = resIII.reshape(b, SZ)[:, : ds.RF_EXT - SZ - 8]
    return rf_ext


def _y_residue_stage(P: torch.Tensor, res256: torch.Tensor,
                     khead: torch.Tensor, resIII: torch.Tensor, q: int):
    """The E11 tail and E12 on the (B, 512, 512) int16 plane after the
    host's E10 part-0 offset and synthesis, with res256 and resIII (B,
    256, 256) int16 and khead (B, 4) int16 (the prefilter kernel's
    [65536:65540]), then the LL2-zone rebuild.  Returns (the plane that
    ``_y_stream_stage`` takes, {key: (packed, n_packed, bit_bytes,
    n_nonmarker, word_bytes, n_words, word_bits)} for the streams of
    quality q, device tensors as ``positional_stream_device`` gives
    them)."""
    if not T.LOW4 < q <= T.HIGH1:
        raise NotImplementedError(
            f"the device residue stage covers {T.LOW4 + 1}..{T.HIGH1}, got "
            f"q{q} (the low56 and lowest-q band cleanups are not ported)")
    b = P.shape[0]
    ds._check_plane(P, "residue stage plane", N)
    for x, name, shape in ((res256, "res256", (b, D, D)),
                           (resIII, "resIII", (b, D, D)),
                           (khead, "khead", (b, 4))):
        ds._check(x, f"residue stage {name}", torch.int16, shape)
    if T.LOW5 < q < T.NORM:
        P = ds.mid_q_band_cleanup_device(P)
    P = ds.pair_promotion_device(P)
    rs = _res_setting(q)
    P, rf = ds.column_ladder_device(P, _rf_ext(res256, khead, resIII), q, rs)
    P, rf, *_ = ds.classify_device(P, rf.reshape(b, D, D), q, rs)
    streams = {}
    for key, codes, word_bits, q_min in RESIDUE_STREAMS:
        if q >= q_min:
            rf, *out = ds.positional_stream_device(
                rf, *_stream_tables(codes), word_bits)
            streams[key] = (*out, word_bits)
    block = resIII.clone()
    zone = block[:, :128, :128]
    zone.masked_fill_(zone <= 8000, 0)
    P[:, :D, :D] = block
    return P, streams


def _residue_sections(streams: dict) -> list[dict]:
    """Each image's res sections from ``_y_residue_stage``'s streams, as
    the host's ``encode_y`` stores them: "resK" (the packed positions),
    "resK_bit" ((n_nonmarker >> 3) + 1 bytes) and "resK_word" ((n_words
    >> 3) + 1 blocks of word_bits bytes), uint8 arrays (JAX :202-224)."""
    host = {key: [t.cpu().numpy() for t in s[:6]]
            for key, s in streams.items()}
    b = len(next(iter(host.values()))[0]) if host else 0
    out = [dict() for _ in range(b)]
    for key, (pk, npk, bit, nnm, wrd, nw) in host.items():
        word_bits = streams[key][6]
        for k in range(b):
            out[k][key] = pk[k, : npk[k]].astype(np.uint8)
            out[k][key + "_bit"] = bit[k, : (int(nnm[k]) >> 3) + 1]
            out[k][key + "_word"] = wrd[k, : word_bits * (
                (int(nw[k]) >> 3) + 1)]
    return out


def _y_stream_stage(P: torch.Tensor, q: int):
    """(B, 512, 512) int16 Y plane after the LL2-zone rebuild, just
    before the first snap pass -> (stream (B, 6 SZ + 16) uint8 with the Y
    part written and the UV half zero, sel1 (B,) int32, sel2 (B,)
    int32)."""
    if not T.LOW4 < q <= T.HIGH1:
        raise NotImplementedError(
            f"the device stream stage covers {T.LOW4 + 1}..{T.HIGH1}, got "
            f"q{q} (offset_y_low4 is not ported)")
    for args in snap_args(q):
        P = ds.snap_pass_device(P, *args)
    P = ds.offset_y_device(P, RATIO)
    stream = torch.zeros((P.shape[0], 6 * SZ + 16), dtype=torch.uint8,
                         device=P.device)
    stream[:, : 4 * SZ] = ds.serpentine_y_device(P)
    stream = ds.merge_crossing_device(stream)
    stream, sel1, sel2 = ds.select_codes_device(stream)
    return ds.cap_long_runs_device(stream), sel1, sel2


def _uv_stream_stage(stream: torch.Tensor, Pm2: torch.Tensor,
                     comp: int) -> torch.Tensor:
    """Quantize one chroma component's (B, 256, 256) int16 plane (after
    its LL2 coding, just before ``offset_uv``) and write its serpentine
    at offsets 4 SZ + comp, + 2, ... of ``stream`` (0 = U, 1 = V), in
    place; returns ``stream``."""
    su = ds.serpentine_uv_device(ds.offset_uv_device(Pm2, RATIO))
    stream[:, 4 * SZ + comp: 6 * SZ + comp - 1: 2] = su
    return stream
