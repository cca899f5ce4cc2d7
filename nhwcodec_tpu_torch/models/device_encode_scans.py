"""The full-device encode configuration, in parts.

Port of ``nhwcodec_tpu.models.device_encode_scans``.  The JAX function
``encode_batch_scans_device`` runs every post-transform raster scan of
the encoder on the device, stage-major: each device stage runs once for
the whole batch.  This module holds its last three stages so far, cut
from the JAX function into helpers that a later
``encode_batch_scans_device`` calls, each once for the whole batch:

- ``_y_ll2_stage``: E16, the Y LL2 byte coding and run-delta
  compression, on the plane after the low-q cleanups; ``_uv_ll2_stage``
  (one chroma component's LL2 byte coding) and ``_uv_highres_stage``
  (E17, the two components' run-delta compression); ``_ll2_sections``
  slices each image's E16 sections, and the ``hr_mem`` list that the
  host's part-0 offset takes, out of them on the host, and
  ``_uv_ll2_sections`` the E17 sections;
- ``_y_residue_stage``: the E11 tail (the mid-q band cleanup, pair
  promotion) and E12 (the res256 column ladder, classify, the res1, res3
  and res5 positional streams) on the plane after the host's E10 part-0
  offset and synthesis, then the LL2-zone rebuild; ``_residue_sections``
  slices each image's res sections out of its streams on the host;
- ``_y_stream_stage``: the three E11 snap passes, the E14 Y quantizer
  and the E15 serpentine, crossing merge, select codes and run cap;
- ``_uv_stream_stage``: the E14 chroma quantizer and serpentine of one
  component, written into the stream's UV half.

The LL2 stage covers q1..HIGH1 and its sections are byte-identical to
the host copy's ``ll2.ll2_code_y`` + ``ll2.y_highres_compression``, its C
``nhw_ll2_code_uv`` and ``ll2.uv_highres_compression``
(tests/test_torch_encode_ll2_stage.py).  The residue stage's plane goes
straight into the stream stage.  Y's merge, select and cap run before
any UV byte is written: the select reads up to five bytes past a
candidate, so near 4 SZ it reads the UV half, which must still be zero
then.  Together they give the res sections, the whole 6 SZ ``im_nhw``
and ``nhw_select1/2``, byte-identical to the host copy's
``encoder.encode_y`` from its E11 tail on and ``encode_uv``'s
``offset_uv`` + ``quantize.serpentine_uv``
(tests/test_torch_encode_residue_stage.py,
tests/test_torch_encode_scans.py).
The residue and stream stages cover LOW4 < q <= HIGH1; q <= LOW4 needs
``offset_y_low4`` and the low-q cleanups.
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


# ---------------------------------------------------------------------------
# the LL2 stage: E16 and E17 (JAX device_encode_scans.py:104-133, 341-370)


def _ll2_range(q: int) -> None:
    if not 1 <= q <= T.HIGH1:
        raise ValueError(f"the device LL2 stage covers q1..q{T.HIGH1}, got "
                         f"q{q} (above, the HQ residue stays on the host)")


def _y_ll2_stage(P: torch.Tensor, q: int):
    """E16 on the (B, 512, 512) int16 Y plane after the low-q cleanups,
    as the host copy's ``ll2.ll2_code_y`` gets it: the LL2 byte coding,
    then the run-delta compression of tree1 followed by the zero tail the
    C reads past it.  Returns (the plane with its LL2 block zeroed, a
    dict of the device tensors that ``_ll2_sections`` slices)."""
    _ll2_range(q)
    ds._check_plane(P, "LL2 stage plane", N)
    Pz, tree1, ch_res, exw, n_exw, res4, n_res4 = ds.ll2_code_y_device(
        P, q > T.LOW3)
    h = torch.zeros((P.shape[0], ds.YH_PAD), dtype=torch.int32,
                    device=P.device)
    h[:, : ds.YH_N] = tree1
    hr, n_hr, res_low, hw, n_hw, hm, n_hm = ds.y_highres_device(
        h, ch_res.to(torch.int32), q > T.LOW5)
    return Pz, {"q": q, "tree1": tree1, "exw": exw, "n_exw": n_exw,
                "res4": res4, "n_res4": n_res4, "hrcomp": hr,
                "n_hrcomp": n_hr, "res_low": res_low, "hr_word": hw,
                "n_hw": n_hw, "hr_mem": hm, "n_hm": n_hm}


def _uv_ll2_stage(Pm: torch.Tensor, q: int):
    """E17's head for one chroma component: the (B, 256, 256) int16
    plane as ``encode_uv``'s LL2 coding reads it -> (the plane with its
    LL2 block zeroed, ``offset_uv``'s input, tree1_uv (B, 4096) uint8, exw
    (B, 4096, 3) int32, n_exw (B,) int32)."""
    _ll2_range(q)
    return ds.ll2_code_uv_device(Pm)


def _uv_highres_stage(u: tuple, v: tuple, q: int):
    """E17 on the two components' ``_uv_ll2_stage`` results: the
    run-delta compression of their tree1_uv, &252-masked, followed by the
    zero tail the C reads past them.  Returns a dict of device tensors for
    ``_uv_ll2_sections``: ch_res's UV tail and its count, and the
    components' tree1_uv and exw."""
    _ll2_range(q)
    t1u, t1v = u[1], v[1]
    b = t1u.shape[0]
    for t, name in ((t1u, "tree1_u"), (t1v, "tree1_v")):
        ds._check(t, f"UV highres {name}", torch.uint8, (b, ds.UV_N // 2))
    h = torch.zeros((b, ds.UV_PAD), dtype=torch.int32, device=t1u.device)
    h[:, : ds.UV_N] = torch.cat([t1u, t1v], 1).to(torch.int32) & 252
    tail, n_tail = ds.uv_highres_device(h)
    return {"q": q, "tail": tail, "n_tail": n_tail, "tree1_u": t1u,
            "tree1_v": t1v, "exw_u": u[2], "n_u": u[3], "exw_v": v[2],
            "n_v": v[3]}


def _ll2_sections(y: dict) -> tuple:
    """Each image's E16 sections from ``_y_ll2_stage``, as the host's
    ``encode_y`` stores them: "exw_Y" (list), "res4" (above LOW3),
    "res_low", "highres_word", "hrcomp_y" (list) and "tree1_y" (JAX
    :113-133).  Returns (the sections, each image's hr_mem as int64: the
    list the host's part-0 offset takes, before E17 runs)."""
    q = y["q"]
    h = {k: t.cpu().numpy() for k, t in y.items() if k != "q"}
    secs, mems = [], []
    for k in range(len(h["tree1"])):
        sec = {"exw_Y": h["exw"][k, : h["n_exw"][k]].reshape(-1).tolist()}
        if q > T.LOW3:
            sec["res4"] = h["res4"][k, : h["n_res4"][k]].astype(np.uint8)
        sec["res_low"] = int(h["res_low"][k])
        sec["highres_word"] = h["hr_word"][k, : h["n_hw"][k]].astype(
            np.uint8)
        sec["hrcomp_y"] = h["hrcomp"][k, : h["n_hrcomp"][k]].tolist()
        sec["tree1_y"] = h["tree1"][k]
        secs.append(sec)
        mems.append(h["hr_mem"][k, : h["n_hm"][k]].astype(np.int64))
    return secs, mems


def _uv_ll2_sections(uv: dict) -> list[dict]:
    """Each image's E17 sections from ``_uv_highres_stage`` (JAX
    :351-370): "exw_uv", the exw continuation [0, 0] + exw_u + [0, 0] +
    exw_v that ``encode`` appends to exw_Y, "ch_res_uv" (list), the UV
    tail it appends to hrcomp_y, "tree1_u", "tree1_v" and, above LOW5,
    "res_U_64" and "res_V_64"."""
    h = {k: t.cpu().numpy() for k, t in uv.items() if k != "q"}
    out = []
    for k in range(len(h["tail"])):
        sec = {"exw_uv": (
            [0, 0] + h["exw_u"][k, : h["n_u"][k]].reshape(-1).tolist()
            + [0, 0] + h["exw_v"][k, : h["n_v"][k]].reshape(-1).tolist()),
            "ch_res_uv": h["tail"][k, : h["n_tail"][k]].tolist(),
            "tree1_u": h["tree1_u"][k], "tree1_v": h["tree1_v"][k]}
        if uv["q"] > T.LOW5:
            sec["res_U_64"] = np.packbits((h["tree1_u"][k] >> 1) & 1)
            sec["res_V_64"] = np.packbits((h["tree1_v"][k] >> 1) & 1)
        out.append(sec)
    return out
