"""The full-device encode configuration.

Port of ``nhwcodec_tpu.models.device_encode_scans``.
``encode_batch_scans_device(images, quality)`` runs every post-transform
raster scan of the encoder on the device, stage-major: each host step
runs image by image, each device stage once for the whole batch.  The
host keeps the front's pre-filter and requant automata, the E10 greedy
offsets with their transforms, the chroma greedy offsets, the tokenizer
and the container.  The stages, in the order the composition runs them:

- the front (``device_stages.encode_front``: colorspace, pre-filter,
  analysis, requant), as ``encode_batch_device`` runs it;
- ``_y_ll2_stage``: E16, the Y LL2 byte coding and run-delta
  compression; ``_ll2_sections`` slices each image's E16 sections, and
  the ``hr_mem`` list that the host's part-0 offset takes, out of it on
  the host;
- ``_host_e10``: the host's E10 part-0 offset and synthesis;
- ``_y_residue_stage``: the E11 tail (the mid-q band cleanup, pair
  promotion) and E12 (the res256 column ladder, classify, the res1, res3
  and res5 positional streams), then the LL2-zone rebuild;
  ``_residue_sections`` slices each image's res sections on the host;
- ``_y_stream_stage``: the three E11 snap passes, the E14 Y quantizer
  and the E15 serpentine, crossing merge, select codes and run cap;
- per chroma component: the host's offset_uv part 1 and synthesis
  (``_host_uv_ladder_in``), ``device_scans.uv_compare_ladder_device``,
  the host's analysis, resIII, offset_uv part 0 and synthesis
  (``_host_uv_marking_in``), ``device_scans.uv_sentinel_marking_device``
  (q >= LOW2), then ``_uv_ll2_stage`` (the chroma LL2 byte coding) and
  ``_uv_stream_stage`` (the E14 chroma quantizer and serpentine, written
  into the stream's UV half);
- ``_uv_highres_stage``: E17, the two components' run-delta
  compression; ``_uv_ll2_sections`` slices the E17 sections;
- the host tokenizer and the device bit packer
  (``models.encoder.finish_deferred``).

Y's merge, select and cap run before any UV byte is written: the select
reads up to five bytes past a candidate, so near 4 SZ it reads the UV
half, which must still be zero then.  The streams are byte-identical to
``nhwcodec_tpu.encode`` at LOW4 < q <= HIGH1
(tests/test_torch_encode_scans_device.py); the stages on their own are
held to the host copy's encode (tests/test_torch_encode_scans.py,
tests/test_torch_encode_residue_stage.py,
tests/test_torch_encode_ll2_stage.py).  The LL2 stage covers q1..HIGH1;
q <= LOW4 needs ``offset_y_low4``, the low-q cleanups and
``uv_ll_smooth``, which are not ported.
"""

from __future__ import annotations

import numpy as np
import torch

from nhwcodec_tpu_torch.device import resolve_device
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as host_encoder
from nhwcodec_tpu_torch.host.models.encoder import _res_setting
from nhwcodec_tpu_torch.host.ops import (analysis, entropy_enc, prefilter,
                                         requant)
from nhwcodec_tpu_torch.models import device_scans as ds
from nhwcodec_tpu_torch.models import device_stages as stages
from nhwcodec_tpu_torch.models import encoder as tenc

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


# ---------------------------------------------------------------------------
# the composition (JAX device_encode_scans.py:47-376)


def _host_e10(jpegs: np.ndarray, procs: np.ndarray, mems: list,
              q: int) -> None:
    """The host's E10 part-0 offset (with each image's hr_mem) and
    synthesis on (B, 512, 512) int16 jpeg and process, in place."""
    for k in range(len(procs)):
        requant.offset_y_recons256(jpegs[k], procs[k], q, RATIO, part=0,
                                   highres_mem=mems[k], highres_tmp_out=[])
        analysis.wavelet_synthesis(jpegs[k], procs[k], D, 0)


def _kernel_heads(origs: list, q: int) -> np.ndarray:
    """(B, 4) int16: each image's pre-filter kernel at [65536:65540], what
    the column ladder reads past res256 (q > LOW4)."""
    return np.stack([np.asarray(prefilter.kernel_for(o, q)).reshape(-1)[
        SZ: SZ + 4] for o in origs]).astype(np.int16)


def _host_uv_ladder_in(jm: np.ndarray, pm: np.ndarray, q: int) -> None:
    """encode_uv's offset_uv part 1 and synthesis on (B, 256, 256) int16
    jpeg and process, in place: the compare ladder's inputs."""
    for k in range(len(pm)):
        requant.offset_uv_recons256(jm[k], pm[k], q, RATIO, comp=1)
        analysis.wavelet_synthesis(jm[k], pm[k], 128, 0)


def _host_uv_marking_in(jm: np.ndarray, pm: np.ndarray,
                        q: int) -> np.ndarray:
    """encode_uv after the compare ladder, in place: the analysis, resIII
    (returned, (B, 128, 128)), offset_uv part 0 and synthesis: the
    sentinel marking's input."""
    res3 = np.empty((len(pm), 128, 128), np.int16)
    for k in range(len(pm)):
        analysis.wavelet_analysis(jm[k], pm[k], 128, 1, 0)
        res3[k] = pm[k][:128, :128]
        requant.offset_uv_recons256(jm[k], pm[k], q, RATIO, comp=0)
        analysis.wavelet_synthesis(jm[k], pm[k], 128, 0)
    return res3


def _u8_pairs(u: np.ndarray) -> np.ndarray:
    """(B, 4) int16: the int16 pairs of each U byte plane at flat 32768,
    what the chroma ladders read past res256 (for U and V both; the host
    copy's ``encode_from_planes``)."""
    f = u.reshape(len(u), -1)[:, 32768: 32776].astype(np.uint16)
    return (f[:, 0::2] | (f[:, 1::2] << 8)).view(np.int16)


def _uv_component(stream, pre: tuple, tails: np.ndarray, q: int, comp: int,
                  dev):
    """One chroma component from the front's (jpeg, process, res256) host
    arrays: the host and device steps of encode_uv up to its LL2 coding,
    then ``_uv_stream_stage`` into ``stream``.  Returns
    ``_uv_ll2_stage``'s result."""
    jm, pm, r256 = (np.array(a, np.int16) for a in pre)
    _host_uv_ladder_in(jm, pm, q)
    R, oob = stages.to_device(dev, r256, tails)
    J = ds.uv_compare_ladder_device(*stages.to_device(dev, jm, pm), R,
                                    oob[:, 0], comp == 1)
    jm = np.array(J.cpu())
    res3 = _host_uv_marking_in(jm, pm, q)
    Pm, res3 = stages.to_device(dev, pm, res3)
    if q >= T.LOW2:
        b = len(pm)
        rf_ext = torch.zeros((b, ds.UV_RF_EXT), dtype=torch.int16,
                             device=Pm.device)
        rf_ext[:, : ds.UVQ_N] = R.reshape(b, -1)
        rf_ext[:, ds.UVQ_N: ds.UVQ_N + 4] = oob
        Pm = ds.uv_sentinel_marking_device(Pm, rf_ext,
                                           4 if q > T.LOW3 else 5)
    Pm[:, :128, :128] = res3
    res = _uv_ll2_stage(Pm, q)
    _uv_stream_stage(stream, res[0], comp)
    return res


def _tokens(stream: torch.Tensor) -> list:
    """The host tokenizer on each image's 6 SZ stream."""
    return [entropy_enc.wavlts2packet_tokenize(s)
            for s in stream[:, : 6 * SZ].cpu().numpy()]


def encode_batch_scans_device(images: np.ndarray, quality: int = 20,
                              device="cuda") -> list[bytes]:
    """(B, 512, 512, 3) uint8 -> list of .nhw byte strings, byte-identical
    to ``nhwcodec_tpu.encode``, with every raster scan after the front on
    ``device``: the stages of this module, each once for the whole batch.
    Raises ValueError outside 1 <= quality <= HIGH1 (above, the HQ residue
    runs on the host encoder) and NotImplementedError at q <= LOW4."""
    q = quality
    if not 1 <= q <= T.HIGH1:
        raise ValueError(f"scans_on_device covers 1 <= q <= {T.HIGH1}, got "
                         f"q{q} (above, the HQ residue runs on the host "
                         "encoder)")
    if q <= T.LOW4:
        raise NotImplementedError(
            f"scans_on_device at q{q}: q <= {T.LOW4} waits for slice e of "
            "the port: offset_y_low4, the low-q cleanups (low_q_ll1, "
            "very_low_q, low56 and lowest-q band cleanups) and uv_ll_smooth "
            f"are not ported; {T.LOW4 + 1} <= q <= {T.HIGH1} run")
    dev = resolve_device(device)
    images = np.asarray(images, np.uint8)
    _, origs, u8, _, pre_y, pre_u, pre_v = stages.encode_front(images, q, dev)
    jpegs, procs, res256 = (np.array(a, np.int16) for a in pre_y[:3])

    # Y: E16, the host's E10, the residue stage and the stream stage
    P, = stages.to_device(dev, procs)
    resIII = P[:, :D, :D].clone()
    Pz, y = _y_ll2_stage(P, q)
    secs, mems = _ll2_sections(y)
    procs = np.array(Pz.cpu())
    procs[:, :D, :D] = resIII.cpu().numpy()
    _host_e10(jpegs, procs, mems, q)
    P, r256, khead = stages.to_device(dev, procs, res256,
                                      _kernel_heads(origs, q))
    P, streams = _y_residue_stage(P, r256, khead, resIII, q)
    stream, sel1, sel2 = _y_stream_stage(P, q)

    # U, then V; both read the U plane's bytes past res256
    tails = _u8_pairs(u8)
    uv = [_uv_component(stream, pre, tails, q, comp, dev)
          for comp, pre in enumerate((pre_u, pre_v))]
    uv_secs = _uv_ll2_sections(_uv_highres_stage(*uv, q))

    deferred = []
    sel = np.stack([sel1.cpu().numpy(), sel2.cpu().numpy()], 1)
    for sec, res, uvs, (s1, s2), tokens in zip(
            secs, _residue_sections(streams), uv_secs, sel, _tokens(stream)):
        sec.update(res)
        sec["exw_Y"] = sec["exw_Y"] + uvs["exw_uv"]
        if q > T.LOW5:
            sec["res_U_64"] = uvs["res_U_64"]
            sec["res_V_64"] = uvs["res_V_64"]
        sec["ch_res"] = np.array(sec.pop("hrcomp_y") + uvs["ch_res_uv"],
                                 np.uint8)
        sec["nhw_select1"] = int(s1)
        sec["nhw_select2"] = int(s2)
        deferred.append(host_encoder.DeferredEncode(q, sec, tokens))
    return tenc.finish_deferred(deferred, device=dev)
