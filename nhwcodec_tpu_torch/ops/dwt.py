"""The DWT kernels of the decode and encode paths and their torch twins.

Port of ``nhwcodec_tpu.ops.pallas_dwt``: ``synth_level`` (K1,
``synth_level_pallas``), ``y_stage2_full`` (K2, ``y_stage2_full_pallas``),
``uv_synth`` (K3, ``uv_synth_pallas``), ``analysis_level_jp`` (K4,
``analysis_level_pallas_jp``), ``requant_tail`` (K5,
``requant_tail_pallas``), ``synth_unnorm_rows_t`` (K7,
``synth_unnorm_rows_t_pallas``), ``synth_norm_rows_clip_waves`` (K8,
``synth_norm_rows_clip_waves_pallas``), ``synth_norm_rows_clip`` (K9,
``synth_norm_rows_clip_pallas``) and ``analysis_level`` (K10,
``analysis_level_pallas``); and ``smooth_marks_seq``, the
dering mark scan of the decode's fallback (a ``lax.scan`` in
``models.device_decode.y_stage2_device``).  Each wrapper launches its CUDA kernel
(``csrc/*.cu``) for a CUDA tensor and raises if that fails; it takes its
plain torch twin (``*_ref``) only for a tensor on the CPU.  The twins
follow the kernels' decomposition (row pass stored transposed, second
row pass; the requant ladder as one left-to-right chain per row), so the
CPU tests hold that decomposition to the reference.  Launches are
counted in ``kernels.build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes

import torch

from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.kernels.build import check_arg as _check
from nhwcodec_tpu_torch.kernels.build import cuda_args as _cuda_args
from nhwcodec_tpu_torch.ops import analysis
from nhwcodec_tpu_torch.ops.lifting import synth_norm, synth_unnorm, wrap16


# ---------------------------------------------------------------------------
# torch twins


def unnorm_rows_t_ref(x: torch.Tensor) -> torch.Tensor:
    """Un-normalised row pass stored as int16, transposed: (B, n, n)."""
    m = x.shape[-1] // 2
    t = synth_unnorm(x[..., :m], x[..., m:]).to(torch.int16)
    return t.transpose(-2, -1)


def norm_rows_ref(t: torch.Tensor) -> torch.Tensor:
    """Normalised row pass: (B, n, n) -> int32 values."""
    m = t.shape[-1] // 2
    return synth_norm(t[..., :m], t[..., m:])


def synth_level_ref(x: torch.Tensor) -> torch.Tensor:
    """One 2-D synthesis level: norm_rows(int16(unnorm_rows(x))^T)."""
    return norm_rows_ref(unnorm_rows_t_ref(x)).to(torch.int16)


def dering_waves_ref(t: torch.Tensor, depth: torch.Tensor,
                     n_waves: int) -> torch.Tensor:
    """Dense dering waves on the transposed plane (device_decode.py
    y_stage2_dense_device, :283-301): wave r smooths the cells whose
    run depth is r and whose 8-neighbour residue is below 116."""
    dp = depth.to(torch.int32)
    x = t.to(torch.int32)
    for r in range(1, n_waves + 1):
        le = torch.roll(x, 1, 2)
        ri = torch.roll(x, -1, 2)
        up = torch.roll(x, 1, 1)
        dn = torch.roll(x, -1, 1)
        diag = (torch.roll(up, 1, 2) + torch.roll(up, -1, 2)
                + torch.roll(dn, 1, 2) + torch.roll(dn, -1, 2))
        res = x * 8 - le - ri - up - dn - diag
        new = (x * 4 + le + ri + up + dn + 4) >> 3
        x = torch.where((dp == r) & (res.abs() < 116), new, x)
    return x.to(torch.int16)


def synth_norm_rows_clip_ref(t: torch.Tensor) -> torch.Tensor:
    """Normalised row pass + clip: (B, n, n) int16 -> uint8."""
    return norm_rows_ref(t).clamp(0, 255).to(torch.uint8)


def synth_norm_rows_clip_waves_ref(t: torch.Tensor, depth: torch.Tensor,
                                   n_waves: int) -> torch.Tensor:
    """Waves, norm row pass, clip on the transposed plane -> u8."""
    return synth_norm_rows_clip_ref(dering_waves_ref(t, depth, n_waves))


def y_stage2_full_ref(jp: torch.Tensor, depth: torch.Tensor,
                      n_waves: int) -> torch.Tensor:
    """Un-norm row pass + transpose, waves, norm row pass, clip -> u8."""
    return synth_norm_rows_clip_waves_ref(unnorm_rows_t_ref(jp), depth,
                                          n_waves)


# the 3x3 stencil of the mark scan as flat offsets in a 512-wide plane:
# centre, left, right, up, down, then the four diagonals
_STENCIL = (0, -1, 1, -512, 512, -513, 511, -511, 513)


def smooth_marks_ranks(recs: torch.Tensor, valid: torch.Tensor):
    """The live records of (B, K) ``recs`` / ``valid`` (valid, row in
    1..255), in (image, list) order: (image, list index, rank), the rank
    being the count of the image's earlier live records in the same LL
    row."""
    rec = recs.to(torch.int64)
    img, k = (valid & (rec >= 256) & (rec < 65536)).nonzero(as_tuple=True)
    key = img * 256 + (rec[img, k] >> 8)
    order = torch.sort(key, stable=True)
    idx = torch.arange(key.numel(), device=recs.device)
    first = torch.ones_like(key, dtype=torch.bool)
    first[1:] = order.values[1:] != order.values[:-1]
    start = torch.cummax(torch.where(first, idx, 0), 0).values
    rank = torch.empty_like(idx)
    rank[order.indices] = idx - start
    return img, k, rank


def smooth_marks_seq_ref(x: torch.Tensor, recs: torch.Tensor,
                         valid: torch.Tensor) -> torch.Tensor:
    """The mark scan (device_decode.py y_stage2_device, :126-148), in
    place on the contiguous (B, 512, 512) int16 transposed plane ``x``:
    record k of image b (row << 8 | col of the LL block) smooths
    x[b][2 row][col] with live, flat reads; records with ``valid`` False
    or a row outside 1..255 write nothing.  As ``mark_rows`` takes it:
    a record reads only its own row's earlier writes, so the LL rows are
    independent; step t applies every live record of rank t in its (image,
    row) (``smooth_marks_ranks``) at once, as many steps as the longest
    row has records.  Returns ``x``."""
    b = x.shape[0]
    flat = x.view(b, -1)
    img, k, rank = smooth_marks_ranks(recs, valid)
    rec = recs.to(torch.int64)[img, k]
    scan = ((rec >> 8) << 10) + (rec & 255)
    order = torch.argsort(rank, stable=True)
    offs = torch.tensor(_STENCIL, device=x.device)
    start = 0
    for n in torch.bincount(rank).tolist():
        sel = order[start:start + n]
        start += n
        i, s = img[sel], scan[sel]
        g = flat[i[:, None], s[:, None] + offs].to(torch.int32)
        res = g[:, 0] * 8 - g[:, 1:].sum(1)
        new = (g[:, 0] * 4 + g[:, 1:5].sum(1) + 4) >> 3
        flat[i, s] = torch.where(res.abs() < 116, new, g[:, 0]).to(
            torch.int16)
    return x


def _sentinel_deltas(v: torch.Tensor):
    v = v.to(torch.int32)
    zero = torch.zeros_like(v)
    pair = torch.where(v == 5005, -4, torch.where(v == 5006, 4, zero))
    single = torch.where(v == 5003, -6, torch.where(v == 5004, 6, zero))
    return pair + single, pair, (v >= 5003) & (v <= 5006)


def uv_assemble_ref(x: torch.Tensor, ll1: torch.Tensor) -> torch.Tensor:
    """Residue sentinel deltas on the synthesized LL, the band clears and
    the LL transpose-back (pallas_dwt.py:353-372) -> (B, 256, 256)."""
    bands = (x[:, :128, 128:], x[:, 128:, :128], x[:, 128:, 128:])
    proc = ll1.to(torch.int32)
    d1 = torch.zeros_like(proc)
    cleared = []
    for band in bands:
        d0, dd1, clear = _sentinel_deltas(band)
        proc = proc + d0
        d1 = d1 + dd1
        cleared.append(torch.where(clear, torch.zeros_like(band), band))
    # the delta at tgt + 1 lands one column right; its column-128 spill
    # is outside the LL block
    proc = wrap16(proc + torch.nn.functional.pad(d1[:, :, :127], (1, 0)))
    top = torch.cat([proc.transpose(1, 2).to(torch.int16), cleared[0]], 2)
    return torch.cat([top, torch.cat(cleared[1:], 2)], 1)


def uv_synth_ref(x: torch.Tensor) -> torch.Tensor:
    """The whole chroma synthesis: 128 level, sentinels, 256 level."""
    ll1 = synth_level_ref(x[:, :128, :128])
    return synth_level_ref(uv_assemble_ref(x, ll1))


def analysis_level_jp_ref(x: torch.Tensor):
    """One analysis level -> (j, p), (B, n, n) int16 each: ``j`` is the
    raw IV row pass stored transposed; row k of ``p`` is VI (k < n/2) or
    plain 53 (k >= n/2) of row k of ``j``, as [low | high].  No LL
    transpose-back (device_stages._stage_xla)."""
    m = x.shape[-1] // 2
    j = torch.cat(analysis.down_iv(x), -1).to(torch.int16).transpose(-2, -1)
    top = torch.cat(analysis.down_vi(j[..., :m, :]), -1)
    bot = torch.cat(analysis.down_53(j[..., m:, :]), -1)
    return j.contiguous(), torch.cat([top, bot], -2).to(torch.int16)


def analysis_level_ref(x: torch.Tensor) -> torch.Tensor:
    """One analysis level with the LL transpose-back -> (B, n, n) int16:
    K4's ``p`` with its (n/2, n/2) LL quadrant transposed
    (``nhwcodec_tpu.models.transform._analysis_level``)."""
    h = x.shape[-1] // 2
    p = analysis_level_jp_ref(x)[1]
    p[..., :h, :h] = p[..., :h, :h].transpose(-2, -1).clone()
    return p


def unmark_ref(ll: torch.Tensor, res256: torch.Tensor):
    """unmark_res256 (encoder/nhw_encoder.c:183-216) on the synthesized
    (B,256,256) LL block: strip the 16000/12000 sentinels from res256
    and add +-1 at their region-mapped interleaved targets.  Returns
    (ll', res_clean), int32 values of wrapped int16."""
    v = res256.to(torch.int32)
    hi = v > 14000
    marked = v > 10000
    zero = torch.zeros_like(v)
    res_clean = v - torch.where(hi, 16000, torch.where(marked, 12000, zero))
    d = torch.where(marked, torch.where(hi, 1, -1), zero)
    delta = torch.zeros_like(v)
    # region (r<128, c>=128) -> (2(c-128)+1, 2r); (r>=128, c<128) ->
    # (2c, 2(r-128)+1); (r>=128, c>=128) -> (2(c-128)+1, 2(r-128)+1)
    delta[:, 1::2, 0::2] = d[:, :128, 128:].transpose(1, 2)
    delta[:, 0::2, 1::2] = d[:, 128:, :128].transpose(1, 2)
    delta[:, 1::2, 1::2] = d[:, 128:, 128:].transpose(1, 2)
    return wrap16(ll.to(torch.int32) + delta), res_clean


def _ladder_decide(scan: torch.Tensor, aa: torch.Tensor) -> torch.Tensor:
    """The +-7/4/2/1 nudge for scan = pf[e] - r256 and the adjusted,
    left-augmented neighbour term aa (encoder/nhw_encoder.c:218-279)."""
    w = torch.where
    z = torch.zeros_like(scan)
    big = w(scan > 11, -7, w(scan > 7, -4, w(scan > 5, -2, w(scan > 4, -1, w(
        scan < -11, 7, w(scan < -7, 4, w(scan < -5, 2, w(scan < -4, 1,
                                                          z))))))))
    inner = w((scan > 0) & (aa > 0), -1, w((scan < 0) & (aa < 0), 1, w(
        aa >= 5, -2, w(aa <= -5, 2, w(aa >= 4, -1, w(aa <= -4, 1, z))))))
    small = w((scan >= 4) & (aa >= 1), -1, w((scan <= -4) & (aa <= -1), 1, w(
        (scan == 3) & (aa >= 0), -1, w((scan == -3) & (aa <= 0), 1, w(
            aa.abs() >= 3, inner, z)))))
    return w(big != 0, big, w(scan.abs() > 1, small, z))


def _adjust_a(a: torch.Tensor) -> torch.Tensor:
    """The |a| > 4 pre-shrink of the right-neighbour delta
    (encoder/nhw_encoder.c:232-246)."""
    w = torch.where
    pos = w(a > 11, -7, w(a > 7, -4, w(a > 5, -2, -1)))
    neg = w(a < -11, 7, w(a < -7, 4, w(a < -5, 2, 1)))
    return w(a.abs() > 4, a + w(a > 0, pos, neg), a)


def ladder_ref(ll: torch.Tensor, res_clean: torch.Tensor,
               process: torch.Tensor) -> torch.Tensor:
    """requant_scan_ladder's nudges m, (B,256,256) int32, as one
    left-to-right chain per LL row: the left term reads the previous
    column's *updated* value, the right term the pre-ladder value.  At
    column 0 the C pointer reads the previous row's band cell
    process[r-1, 511], which the ladder never writes, so rows are
    independent; the sweep runs over columns, vectorised over rows and
    images.  At column 255 the right term crosses to process[r, 256] -
    res_clean[r+1, 0], and it is 0 past the last position."""
    b = ll.shape[0]
    r256 = res_clean
    p = process.to(torch.int32)
    scan0 = ll - r256
    right = torch.cat([ll[:, :, 1:], p[:, :256, 256:257]], 2)
    r_next = torch.nn.functional.pad(r256.reshape(b, -1)[:, 1:], (0, 1))
    a0 = _adjust_a(right - r_next.reshape(b, 256, 256))
    left = torch.nn.functional.pad(p[:, :255, 511] - r256[:, :255, 255],
                                   (1, 0))
    m = torch.empty_like(ll)
    for c in range(256):
        m[:, :, c] = _ladder_decide(scan0[:, :, c], a0[:, :, c] + left)
        left = ll[:, :, c] + m[:, :, c] - r256[:, :, c]
    return m


def requant_tail_ref(jpeg: torch.Tensor, process: torch.Tensor,
                     res256: torch.Tensor):
    """The requant feedback tail: level-2 synthesis of the 256 LL, unmark,
    the compare ladder, jp re-analysis.  Writes the new 256x256 LL
    quadrants into ``jpeg`` and ``process`` (nothing else of them
    changes) and returns (jpeg, process, res_clean)."""
    ll, res_clean = unmark_ref(synth_level_ref(jpeg[:, :256, :256]), res256)
    m = ladder_ref(ll, res_clean, process)
    j2, p2 = analysis_level_jp_ref(wrap16(res_clean + m).to(torch.int16))
    jpeg[:, :256, :256] = j2
    process[:, :256, :256] = p2
    return jpeg, process, res_clean.to(torch.int16)


# ---------------------------------------------------------------------------
# kernel wrappers


def synth_level(x: torch.Tensor) -> torch.Tensor:
    """K1: one 2-D synthesis level on (B, n, n) int16, n in {128, 256,
    512} -> contiguous (B, n, n) int16.  A view whose rows are contiguous
    (e.g. a corner block of a larger plane) is taken without a copy; on
    the card its base must be 16-byte aligned and its strides multiples
    of 8, or the kernel refuses it and this raises.  On the card one
    launch, a cluster of CTAs per plane."""
    _check(x, "synth_level", torch.int16, (None, None, None))
    b, n, n2 = x.shape
    if n != n2 or n not in (128, 256, 512):
        raise ValueError(f"synth_level: unsupported block {tuple(x.shape)}")
    if x.device.type == "cpu":
        return synth_level_ref(x)
    if x.stride(2) != 1:
        raise ValueError("synth_level: rows must be contiguous")
    lib, stream = _cuda_args(x)
    out = torch.empty((b, n, n), dtype=torch.int16, device=x.device)
    if b:
        with torch.cuda.device(x.device):
            build.check("nhw_synth_level", lib.nhw_synth_level(
                x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), b, n,
                stream))
        build.count("synth_level")
    return out


def y_stage2_full(jp: torch.Tensor, depth: torch.Tensor,
                  n_waves: int) -> torch.Tensor:
    """K2: decode Y stage 2 without an HQ scatter.  jp: (B, 512, 512)
    int16 with the post-dering LL1 transposed in; depth: (B, 512, 512)
    uint8 run positions (0 = no mark; the kernel requires marks on even
    rows only, which ``mark_depth_planes`` guarantees).  -> uint8.  On
    the card one launch, a cluster of 8 CTAs per image; both inputs must
    have 16-byte aligned bases, or the kernel refuses them and this
    raises."""
    _check(jp, "y_stage2_full jp", torch.int16, (None, 512, 512))
    _check(depth, "y_stage2_full depth", torch.uint8, tuple(jp.shape))
    n_waves = int(n_waves)
    if jp.device.type == "cpu" and depth.device.type == "cpu":
        return y_stage2_full_ref(jp, depth, n_waves)
    if not (jp.is_contiguous() and depth.is_contiguous()):
        raise ValueError("y_stage2_full: inputs must be contiguous")
    lib, stream = _cuda_args(jp, depth)
    b = jp.shape[0]
    out = torch.empty(jp.shape, dtype=torch.uint8, device=jp.device)
    if b:
        with torch.cuda.device(jp.device):
            build.check("nhw_y_stage2_full", lib.nhw_y_stage2_full(
                jp.data_ptr(), depth.data_ptr(), out.data_ptr(), b, n_waves,
                stream))
        build.count("y_stage2_full")
    return out


def uv_synth(x: torch.Tensor) -> torch.Tensor:
    """K3: (B, 256, 256) int16 chroma coefficient planes -> (B, 256, 256)
    int16 pre-sharpen planes.  On the card one launch, a cluster of 4
    CTAs per plane."""
    _check(x, "uv_synth", torch.int16, (None, 256, 256))
    if x.device.type == "cpu":
        return uv_synth_ref(x)
    if not x.is_contiguous():
        raise ValueError("uv_synth: input must be contiguous")
    lib, stream = _cuda_args(x)
    b = x.shape[0]
    out = torch.empty_like(x)
    if b:
        with torch.cuda.device(x.device):
            build.check("nhw_uv_synth", lib.nhw_uv_synth(
                x.data_ptr(), out.data_ptr(), b, stream))
        build.count("uv_synth")
    return out


# the cluster kernels, in the order of nhw_cluster_info (dwt.cu): K2, K3,
# then K4, K10 and K1 at each n, one cluster shape per n
CLUSTER_KERNELS = ("y_stage2_full", "uv_synth") + tuple(
    f"{name}/{n}"
    for name in ("analysis_level_jp", "analysis_level", "synth_level")
    for n in (512, 256, 128))


def cluster_info(name: str, device=None) -> dict:
    """What the card allows for the cluster kernel ``name`` (an entry of
    ``CLUSTER_KERNELS``: K2, K3, or K4 / K10 / K1 at one n, as
    ``"analysis_level/256"``), as its C entry point found it: registers
    per thread, shared memory per CTA in bytes, and the most clusters
    resident at once.  Raises where the card holds no cluster of the
    kernel."""
    info = (ctypes.c_int * 3)()
    with torch.cuda.device(device):
        build.check("nhw_cluster_info", build.load().nhw_cluster_info(
            CLUSTER_KERNELS.index(name), ctypes.addressof(info)))
    return {"registers": info[0], "shared_bytes": info[1],
            "max_active_clusters": info[2]}


def analysis_level_jp(x: torch.Tensor):
    """K4: one analysis level on (B, n, n) int16, n in {128, 256, 512}
    -> (j, p), contiguous (B, n, n) int16 each (see
    ``analysis_level_jp_ref``).  A view whose rows are contiguous (e.g.
    the LL corner of a larger plane) is taken without a copy; on the card
    its base must be 16-byte aligned and its strides multiples of 8, or
    the kernel refuses it and this raises.  On the card one launch, a
    cluster of CTAs per plane."""
    _check(x, "analysis_level_jp", torch.int16, (None, None, None))
    b, n, n2 = x.shape
    if n != n2 or n not in (128, 256, 512):
        raise ValueError(
            f"analysis_level_jp: unsupported block {tuple(x.shape)}")
    if x.device.type == "cpu":
        return analysis_level_jp_ref(x)
    if x.stride(2) != 1:
        raise ValueError("analysis_level_jp: rows must be contiguous")
    lib, stream = _cuda_args(x)
    j = torch.empty((b, n, n), dtype=torch.int16, device=x.device)
    p = torch.empty_like(j)
    if b:
        with torch.cuda.device(x.device):
            build.check("nhw_analysis_level_jp", lib.nhw_analysis_level_jp(
                x.data_ptr(), x.stride(0), x.stride(1), j.data_ptr(), n * n,
                n, p.data_ptr(), n * n, n, b, n, stream))
        build.count("analysis_level_jp")
    return j, p


def analysis_level(x: torch.Tensor,
                   out: torch.Tensor | None = None) -> torch.Tensor:
    """K10: one analysis level with the LL transpose-back on (B, n, n)
    int16, n in {128, 256, 512} (see ``analysis_level_ref``), written
    into ``out`` (default: a new contiguous tensor), which is returned.
    Views whose rows are contiguous are taken without a copy, and ``out``
    may be ``x`` itself: the level then runs in place (e.g. on the LL
    corner of a level-1 plane).  On the card both need 16-byte aligned
    bases and strides that are multiples of 8, or this raises; one
    launch, a cluster of CTAs per plane."""
    _check(x, "analysis_level", torch.int16, (None, None, None))
    b, n, n2 = x.shape
    if n != n2 or n not in (128, 256, 512):
        raise ValueError(f"analysis_level: unsupported block {tuple(x.shape)}")
    if out is None:
        out = torch.empty((b, n, n), dtype=torch.int16, device=x.device)
    _check(out, "analysis_level out", torch.int16, (b, n, n))
    if x.device.type == "cpu" and out.device.type == "cpu":
        return out.copy_(analysis_level_ref(x))
    if x.stride(2) != 1 or out.stride(2) != 1:
        raise ValueError("analysis_level: rows must be contiguous")
    lib, stream = _cuda_args(x, out)
    if b:
        with torch.cuda.device(x.device):
            build.check("nhw_analysis_level", lib.nhw_analysis_level(
                x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(),
                out.stride(0), out.stride(1), b, n, stream))
        build.count("analysis_level")
    return out


def requant_tail(jpeg: torch.Tensor, process: torch.Tensor,
                 res256: torch.Tensor):
    """K5: the requant feedback tail on jpeg, process (B, 512, 512) int16
    and res256 (B, 256, 256) int16 with its sentinels, as
    ``requant_tail_ref``: the new 256x256 LL quadrants are written into
    the caller's ``jpeg`` and ``process`` (nothing else of them changes)
    and (jpeg, process, res_clean) is returned.  Callers that need the
    inputs again pass clones.  On the card three launches: K1's cluster
    launch, the unmark + ladder table walk, K4's cluster launch."""
    _check(jpeg, "requant_tail jpeg", torch.int16, (None, 512, 512))
    _check(process, "requant_tail process", torch.int16, tuple(jpeg.shape))
    _check(res256, "requant_tail res256", torch.int16,
           (jpeg.shape[0], 256, 256))
    if all(t.device.type == "cpu" for t in (jpeg, process, res256)):
        return requant_tail_ref(jpeg, process, res256)
    if not all(t.is_contiguous() for t in (jpeg, process, res256)):
        raise ValueError("requant_tail: inputs must be contiguous")
    lib, stream = _cuda_args(jpeg, process, res256)
    b = jpeg.shape[0]
    res_clean = torch.empty_like(res256)
    scratch = torch.empty((2, b, 256, 256), dtype=torch.int16,
                          device=jpeg.device)
    if b:
        with torch.cuda.device(jpeg.device):
            build.check("nhw_requant_tail", lib.nhw_requant_tail(
                jpeg.data_ptr(), process.data_ptr(), res256.data_ptr(),
                res_clean.data_ptr(), scratch.data_ptr(), b, stream))
        build.count("requant_tail")
    return jpeg, process, res_clean


def synth_unnorm_rows_t(x: torch.Tensor) -> torch.Tensor:
    """K7: the un-normalised row pass stored transposed, (B, n, n) int16
    with n in {128, 256, 512} -> contiguous int16(unnorm_rows(x))^T.  A
    view whose rows are contiguous is taken without a copy; on the card
    its base must be 16-byte aligned and its strides multiples of 8, or
    the kernel refuses it and this raises.  On the card one launch of
    64 x 32 tiles, each transposed in the CTA's shared memory."""
    _check(x, "synth_unnorm_rows_t", torch.int16, (None, None, None))
    b, n, n2 = x.shape
    if n != n2 or n not in (128, 256, 512):
        raise ValueError(
            f"synth_unnorm_rows_t: unsupported block {tuple(x.shape)}")
    if x.device.type == "cpu":
        return unnorm_rows_t_ref(x).contiguous()
    if x.stride(2) != 1:
        raise ValueError("synth_unnorm_rows_t: rows must be contiguous")
    lib, stream = _cuda_args(x)
    out = torch.empty((b, n, n), dtype=torch.int16, device=x.device)
    if b:
        with torch.cuda.device(x.device):
            build.check("nhw_synth_unnorm_rows_t", lib.nhw_synth_unnorm_rows_t(
                x.data_ptr(), x.stride(0), x.stride(1), out.data_ptr(), b, n,
                stream))
        build.count("synth_unnorm_rows_t")
    return out


def synth_norm_rows_clip_waves(t: torch.Tensor, depth: torch.Tensor,
                               n_waves: int) -> torch.Tensor:
    """K8: dering waves, normalised row pass and clip on the transposed
    (B, 512, 512) int16 plane (after the HQ scatter); depth: (B, 512,
    512) uint8 run positions, non-zero on even rows only, as
    ``mark_depth_planes`` makes them.  -> uint8.  On the card one launch
    of 32-row bands, a warp a row; both inputs must have 16-byte aligned
    bases, or the kernel refuses them and this raises."""
    _check(t, "synth_norm_rows_clip_waves t", torch.int16, (None, 512, 512))
    _check(depth, "synth_norm_rows_clip_waves depth", torch.uint8,
           tuple(t.shape))
    n_waves = int(n_waves)
    if t.device.type == "cpu" and depth.device.type == "cpu":
        return synth_norm_rows_clip_waves_ref(t, depth, n_waves)
    if not (t.is_contiguous() and depth.is_contiguous()):
        raise ValueError("synth_norm_rows_clip_waves: inputs must be "
                         "contiguous")
    lib, stream = _cuda_args(t, depth)
    b = t.shape[0]
    out = torch.empty(t.shape, dtype=torch.uint8, device=t.device)
    if b:
        with torch.cuda.device(t.device):
            build.check("nhw_synth_norm_rows_clip_waves",
                        lib.nhw_synth_norm_rows_clip_waves(
                            t.data_ptr(), depth.data_ptr(), out.data_ptr(), b,
                            n_waves, stream))
        build.count("synth_norm_rows_clip_waves")
    return out


def synth_norm_rows_clip(t: torch.Tensor) -> torch.Tensor:
    """K9: the normalised row pass and the clip, (B, n, n) int16 with n
    in {128, 256, 512} -> uint8."""
    _check(t, "synth_norm_rows_clip", torch.int16, (None, None, None))
    b, n, n2 = t.shape
    if n != n2 or n not in (128, 256, 512):
        raise ValueError(
            f"synth_norm_rows_clip: unsupported block {tuple(t.shape)}")
    if t.device.type == "cpu":
        return synth_norm_rows_clip_ref(t)
    if not t.is_contiguous():
        raise ValueError("synth_norm_rows_clip: input must be contiguous")
    lib, stream = _cuda_args(t)
    out = torch.empty(t.shape, dtype=torch.uint8, device=t.device)
    if b:
        with torch.cuda.device(t.device):
            build.check("nhw_synth_norm_rows_clip", lib.nhw_synth_norm_rows_clip(
                t.data_ptr(), out.data_ptr(), b, n, stream))
        build.count("synth_norm_rows_clip")
    return out


def smooth_marks_seq(x: torch.Tensor, recs: torch.Tensor,
                     valid: torch.Tensor) -> torch.Tensor:
    """The dering mark scan of the decode's fallback, in place on the
    contiguous, 16-byte aligned (B, 512, 512) int16 transposed plane
    ``x`` (see ``smooth_marks_seq_ref``); recs: (B, K) int32, valid: (B,
    K) bool, as ``models.device_decode.pad_marks`` makes them.  Kernel
    ``mark_rows``: one launch, a CTA a band of 32 LL rows of an image,
    each row's records walked in order in shared memory.  Returns
    ``x``."""
    _check(x, "smooth_marks_seq x", torch.int16, (None, 512, 512))
    _check(recs, "smooth_marks_seq recs", torch.int32, (x.shape[0], None))
    _check(valid, "smooth_marks_seq valid", torch.bool, tuple(recs.shape))
    if not all(a.is_contiguous() for a in (x, recs, valid)):
        raise ValueError("smooth_marks_seq: inputs must be contiguous")
    if all(a.device.type == "cpu" for a in (x, recs, valid)):
        return smooth_marks_seq_ref(x, recs, valid)
    if x.data_ptr() % 16:
        raise ValueError("smooth_marks_seq: x must be 16-byte aligned")
    lib, stream = _cuda_args(x, recs, valid)
    b, k = recs.shape
    if b and k:
        with torch.cuda.device(x.device):
            build.check("nhw_smooth_marks_seq", lib.nhw_smooth_marks_seq(
                x.data_ptr(), recs.data_ptr(), valid.data_ptr(), k, b,
                stream))
        build.count("smooth_marks_seq")
    return x
