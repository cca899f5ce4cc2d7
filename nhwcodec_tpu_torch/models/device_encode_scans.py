"""The full-device encode configuration.

Port of ``nhwcodec_tpu.models.device_encode_scans``.
``encode_batch_scans_device(images, quality)`` runs every post-transform
raster scan of the encoder on the device, stage-major: each host step
runs image by image, each device stage once for the whole batch.  The
host keeps the front's pre-filter and requant automata, the E10 greedy
offsets with their transforms (q > LOW8), the chroma greedy offsets, the
tokenizer and the container.  The stages, in the order the composition
runs them:

- the front (``device_stages.encode_front``: colorspace, pre-filter,
  analysis, requant), as ``encode_batch_device`` runs it;
- the cleanups before the LL2 coding: at q <= LOW9
  ``device_scans.low_q_ll1_cleanup_device``, below LOW7
  ``device_scans.very_low_q_cleanup_device``;
- ``_y_ll2_stage``: E16, the Y LL2 byte coding and run-delta
  compression; ``_ll2_sections`` slices each image's E16 sections, and
  the ``hr_mem`` list that the host's part-0 offset takes, out of it on
  the host;
- ``_host_e10``: the host's E10 part-0 offset and synthesis, above LOW8
  only (at and below, the plane stays on the device: E16's output with
  resIII back in its LL2 quadrant);
- ``_y_residue_stage``: the E11 tail (the mid-q band cleanup above LOW5,
  the low56 cleanup at LOW6..LOW5, the lowest-q cleanup below LOW6 with
  its r3 tail built from resIII and its thresholds from each image's
  count below LOW7 (``lowest_q_xs_device``), the free-time kernel and
  E16's tree1, pair promotion above LOW4) and, above LOW8, E12 (the
  res256 column ladder, classify, the res1, res3 and res5 positional
  streams), then the LL2-zone rebuild; ``_residue_sections`` slices each
  image's res sections on the host;
- ``_y_stream_stage``: the three E11 snap passes, the E14 Y quantizer
  (``offset_y_low4``'s duty cycles at and below LOW4) and the E15
  serpentine, crossing merge, select codes and run cap;
- per chroma component: the host's offset_uv part 1 and synthesis
  (``_host_uv_ladder_in``), ``device_scans.uv_compare_ladder_device``,
  the host's analysis, resIII, offset_uv part 0 and synthesis
  (``_host_uv_marking_in``), ``device_scans.uv_sentinel_marking_device``
  (q >= LOW2), ``device_scans.uv_ll_smooth_device`` (q <= LOW9), then
  ``_uv_ll2_stage`` (the chroma LL2 byte coding) and ``_uv_stream_stage``
  (the E14 chroma quantizer and serpentine, written into the stream's UV
  half);
- ``_uv_highres_stage``: E17, the two components' run-delta
  compression; ``_uv_ll2_sections`` slices the E17 sections;
- the host tokenizer and the device bit packer
  (``models.encoder.finish_deferred``).

Y's merge, select and cap run before any UV byte is written: the select
reads up to five bytes past a candidate, so near 4 SZ it reads the UV
half, which must still be zero then.  The streams are byte-identical to
``nhwcodec_tpu.encode`` at 1 <= q <= HIGH1
(tests/test_torch_encode_scans_device.py); the stages on their own are
held to the host copy's encode (tests/test_torch_encode_scans.py,
tests/test_torch_encode_residue_stage.py,
tests/test_torch_encode_ll2_stage.py), the low-q programs to the JAX
package's and the host copy's C (tests/test_torch_encode_low4.py,
tests/test_torch_encode_lowq2.py).  Above HIGH1 the HQ residue stays on
the host encoder.
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
    the host copy's ``encoder.encode_y``), one ``snap_passes_device``
    call for the three: variant 1's rows (1..254) neither touch nor
    neighbour the rows variants 2 and 3 write, and variant 3 reads what
    variant 2 writes only in the same row (column 256)."""
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


# the lowest-q band cleanup's thresholds at LOW7 (host encoder._lowest_q_xs)
LOW7_XS = (15, 27, 10, 6, 3)
# below LOW7: by each image's count of |v| >= 12 in rows 256..511, the
# base tuples (count > 12500, > 10000, >= 7000, else) and the bumps at LOW9
# and at and below LOW10 (count > 12500, else)
LOWEST_Q_XS = ((19, 31, 13, 9, 6), (18, 30, 12, 8, 6), (17, 29, 11, 8, 5),
               (16, 28, 11, 8, 5))
LOWEST_Q_BUMPS = {T.LOW9: ((1, 1, 1, 1, 1), (1, 0, 0, 0, 0)),
                  T.LOW10: ((3, 3, 2, 3, 3), (3, 2, 2, 2, 2))}
TREE1_CHUNK_SIZE = 24593   # the tree1 chunk's size field, past resIII


def _stage_range(stage: str, q: int) -> None:
    if not 1 <= q <= T.HIGH1:
        raise ValueError(f"the device {stage} stage covers q1..q{T.HIGH1}, "
                         f"got q{q} (above, the HQ residue stays on the "
                         "host)")


def lowest_q_xs_device(P: torch.Tensor, q: int) -> torch.Tensor:
    """The lowest-q band cleanup's thresholds (q < LOW6) for each image of
    the (B, 512, 512) int16 plane it gets, as (B, 5) int32 on its device
    (the host copy's ``encoder._lowest_q_xs``): LOW7_XS at LOW7, else by
    the image's count of |v| >= 12 in rows 256..511 (|v| in int16, as the
    host's numpy takes it: -32768 does not count)."""
    b = P.shape[0]
    dev = P.device
    if q == T.LOW7:
        return torch.tensor(LOW7_XS, dtype=torch.int32,
                            device=dev).expand(b, 5).contiguous()
    count = (P[:, D:].abs() >= 12).flatten(1).sum(1).reshape(b, 1)
    tab = torch.tensor(LOWEST_Q_XS, dtype=torch.int32, device=dev)
    xs = torch.where(count > 12500, tab[0], torch.where(
        count > 10000, tab[1], torch.where(count >= 7000, tab[2], tab[3])))
    if q <= T.LOW9:
        bt = torch.tensor(LOWEST_Q_BUMPS[max(q, T.LOW10)], dtype=torch.int32,
                          device=dev)
        xs = xs + torch.where(count > 12500, bt[0], bt[1])
    return xs.contiguous()


def _r3_ext(resIII: torch.Tensor, ktail: torch.Tensor,
            tree1: torch.Tensor) -> torch.Tensor:
    """(B, LQ_R3_EXT) int16: resIII, then the heap-alias tail the lowest-q
    cleanup's last rows read: the free-time kernel's [131080:131084], the
    tree1 chunk's size field, and tree1's first 496 bytes as int16 pairs
    (the host encoder's ``_lowest_q_band_cleanup``; JAX
    device_encode_scans.py:158-167)."""
    b = resIII.shape[0]
    r3 = torch.zeros((b, ds.LQ_R3_EXT), dtype=torch.int16,
                     device=resIII.device)
    r3[:, :SZ] = resIII.reshape(b, SZ)
    r3[:, SZ: SZ + 4] = ktail
    r3[:, SZ + 4] = TREE1_CHUNK_SIZE
    t = tree1[:, :496].to(torch.int32)
    pairs = t[:, 0::2] | (t[:, 1::2] << 8)
    r3[:, SZ + 8:] = torch.where(pairs >= 1 << 15, pairs - (1 << 16),
                                 pairs).to(torch.int16)
    return r3


def _y_residue_stage(P: torch.Tensor, res256: torch.Tensor,
                     khead: torch.Tensor, resIII: torch.Tensor, q: int,
                     ktail: torch.Tensor | None = None,
                     tree1: torch.Tensor | None = None):
    """The E11 tail and, above LOW8, E12 on the (B, 512, 512) int16 plane
    after the host's E10 part-0 offset and synthesis (at and below LOW8,
    E16's output with resIII in its LL2 quadrant), with res256 and resIII
    (B, 256, 256) int16 and khead (B, 4) int16 (the prefilter kernel's
    [65536:65540], which only E12 reads), then the LL2-zone rebuild.
    Below LOW6 the lowest-q cleanup also takes ktail (B, 4) int16, the
    free-time kernel's [131080:131084], and the LL2 stage's tree1 (B,
    16384).  Returns (the
    plane that ``_y_stream_stage`` takes, {key: (packed, n_packed,
    bit_bytes, n_nonmarker, word_bytes, n_words, word_bits)} for the
    streams of quality q, device tensors as ``positional_stream_device``
    gives them; none at q <= LOW8)."""
    _stage_range("residue", q)
    b = P.shape[0]
    ds._check_plane(P, "residue stage plane", N)
    for x, name, shape in ((res256, "res256", (b, D, D)),
                           (resIII, "resIII", (b, D, D)),
                           (khead, "khead", (b, 4))):
        ds._check(x, f"residue stage {name}", torch.int16, shape)
    if T.LOW5 < q < T.NORM:
        P = ds.mid_q_band_cleanup_device(P)
    elif T.LOW6 <= q <= T.LOW5:
        P = ds.low56_band_cleanup_device(P, 19 if q == T.LOW5 else 20)
    elif q < T.LOW6:
        if ktail is None or tree1 is None:
            raise ValueError(f"the residue stage at q{q} needs ktail and "
                             "tree1 (the lowest-q cleanup's r3 tail)")
        ds._check(ktail, "residue stage ktail", torch.int16, (b, 4))
        P = ds.lowest_q_band_cleanup_device(
            P, _r3_ext(resIII, ktail, tree1), q, lowest_q_xs_device(P, q))
    if q > T.LOW4:
        P = ds.pair_promotion_device(P)
    streams = {}
    if q > T.LOW8:
        P, streams = _e12(P, res256, khead, resIII, q)
    block = resIII.clone()
    zone = block[:, :128, :128]
    zone.masked_fill_(zone <= 8000, 0)
    P[:, :D, :D] = block
    return P, streams


def _e12(P, res256, khead, resIII, q: int):
    """E12 (q > LOW8): the res256 column ladder, classify and the
    positional streams of quality q."""
    b = P.shape[0]
    rs = _res_setting(q)
    P, rf = ds.column_ladder_device(P, _rf_ext(res256, khead, resIII), q, rs)
    P, rf, *_ = ds.classify_device(P, rf.reshape(b, D, D), q, rs)
    streams = {}
    for key, codes, word_bits, q_min in RESIDUE_STREAMS:
        if q >= q_min:
            rf, *out = ds.positional_stream_device(
                rf, *_stream_tables(codes), word_bits)
            streams[key] = (*out, word_bits)
    return P, streams


def _residue_sections(streams: dict, b: int | None = None) -> list[dict]:
    """Each image's res sections from ``_y_residue_stage``'s streams, as
    the host's ``encode_y`` stores them: "resK" (the packed positions),
    "resK_bit" ((n_nonmarker >> 3) + 1 bytes) and "resK_word" ((n_words
    >> 3) + 1 blocks of word_bits bytes), uint8 arrays (JAX :202-224).
    b: the batch size, taken from the streams when None; at q <= LOW8
    there is no stream, and each of the b images gets an empty dict."""
    host = {key: [t.cpu().numpy() for t in s[:6]]
            for key, s in streams.items()}
    if b is None:
        b = len(next(iter(host.values()))[0])
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
    _stage_range("stream", q)
    P = ds.snap_passes_device(P, snap_args(q))
    P = (ds.offset_y_low4_device if q <= T.LOW4 else ds.offset_y_device)(
        P, RATIO)
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


def _kernel_slices(orig: np.ndarray, q: int) -> np.ndarray:
    """One image's pre-filter kernel slices, (2, 4) int16: the head at
    [65536:65540], which the column ladder reads past res256, and the tail
    at [131080:131084], which the lowest-q cleanup reads past resIII (q <
    LOW6).  Above LOW4 the kernel is ``kernel_for``'s; at and below, the
    low pre-filter's free-time kernel, taken from its cache right after
    the image's pre-filter (the cache holds one plane: later, it would
    run the pre-filter again)."""
    kern = (prefilter.kernel_for(orig, q) if q > T.LOW4
            else prefilter.final_low_kernel(orig, q))
    k = np.asarray(kern).reshape(-1)
    return np.stack([k[SZ: SZ + 4], k[2 * SZ + 8: 2 * SZ + 12]]).astype(
        np.int16)


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
    arrays: the host and device steps of encode_uv up to its LL2 coding
    (the smoothing at q <= LOW9 included), then ``_uv_stream_stage`` into
    ``stream``.  Returns
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
    if q <= T.LOW9:
        Pm = ds.uv_ll_smooth_device(Pm)
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
    Raises ValueError outside 1 <= quality <= HIGH1 (above, the HQ
    residue runs on the host encoder)."""
    q = quality
    if not 1 <= q <= T.HIGH1:
        raise ValueError(f"scans_on_device covers 1 <= q <= {T.HIGH1}, got "
                         f"q{q} (above, the HQ residue runs on the host "
                         "encoder)")
    dev = resolve_device(device)
    images = np.asarray(images, np.uint8)
    b = len(images)
    kslices = []
    _, _, u8, _, pre_y, pre_u, pre_v = stages.encode_front(
        images, q, dev, lambda o: kslices.append(_kernel_slices(o, q)))
    jpegs, procs, res256 = (np.array(a, np.int16) for a in pre_y[:3])

    # Y: the low-q cleanups, E16, the host's E10 (q > LOW8), the residue
    # stage and the stream stage
    P, r256, kslices = stages.to_device(dev, procs, res256,
                                        np.stack(kslices))
    if q <= T.LOW9:
        P = ds.low_q_ll1_cleanup_device(P, 10 if q > T.LOW14 else 11)
    if q < T.LOW7:
        P = ds.very_low_q_cleanup_device(P, q, host_encoder._VLQ_THRX(
            q, None))
    resIII = P[:, :D, :D].clone()
    Pz, y = _y_ll2_stage(P, q)
    secs, mems = _ll2_sections(y)
    if q > T.LOW8:
        procs = np.array(Pz.cpu())
        procs[:, :D, :D] = resIII.cpu().numpy()
        _host_e10(jpegs, procs, mems, q)
        P, = stages.to_device(dev, procs)
    else:
        P = Pz
        P[:, :D, :D] = resIII
    P, streams = _y_residue_stage(P, r256, kslices[:, 0], resIII, q,
                                  kslices[:, 1], y["tree1"])
    stream, sel1, sel2 = _y_stream_stage(P, q)

    # U, then V; both read the U plane's bytes past res256
    tails = _u8_pairs(u8)
    uv = [_uv_component(stream, pre, tails, q, comp, dev)
          for comp, pre in enumerate((pre_u, pre_v))]
    uv_secs = _uv_ll2_sections(_uv_highres_stage(*uv, q))

    deferred = []
    sel = np.stack([sel1.cpu().numpy(), sel2.cpu().numpy()], 1)
    for sec, res, uvs, (s1, s2), tokens in zip(
            secs, _residue_sections(streams, b), uv_secs, sel,
            _tokens(stream)):
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
