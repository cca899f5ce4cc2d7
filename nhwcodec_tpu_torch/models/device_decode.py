"""Device back end of the bit-exact batched decode, in torch.

Port of ``nhwcodec_tpu.models.device_decode`` with the same host/device
split:

- host front:  container parse, Huffman decode, positional streams,
               sentinel expansion, LL2/res4/exw, isolated smoothing
               (``host.models.decoder`` steps, the port's copy)
- device 1:    Y level-2 synthesis (K1) + transform-domain residue
               scatter-add; full UV synthesis (K3)
- host:        Y dering mark pass, UV sharpen + clip + upsample
- device 2:    Y stage 2: level-1 row pass, HQ residue scatter (q >
               HIGH1), dense dering waves, final row pass, clip -- K2
               for a batch without HQ entries, K7 + scatter + K8 for one
               with them; when same-row marks come out of column order,
               K7 + scatter + the sequential mark scan + K9
- device 3:    exact YUV -> RGB per quality group (ops.colorspace)
"""

from __future__ import annotations

import numpy as np
import torch

from nhwcodec_tpu_torch.host.models import decoder as dec
from nhwcodec_tpu_torch.host.ops import dc_plane, entropy
from nhwcodec_tpu_torch.host.utils.container import parse_nhw
from nhwcodec_tpu_torch.device import resolve_device
from nhwcodec_tpu_torch.ops import colorspace, dwt
from nhwcodec_tpu_torch.ops.lifting import wrap16

D = 256
N = 512
SZ = 65536


def front_to_torch(device, *arrays: np.ndarray) -> tuple[torch.Tensor, ...]:
    """The host front's numpy state (coefficient planes, padded scatter
    pairs, post-dering LL1 blocks, depth planes) -> tensors on device."""
    dev = torch.device(device)
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(dev)
                 for a in arrays)


def y_stage1(jpeg: torch.Tensor, idx: torch.Tensor,
             delta: torch.Tensor) -> torch.Tensor:
    """(B,512,512) int16 coefficient plane + padded transform-domain
    scatter (idx int32, delta int16) -> (B,256,256) int16 LL1 block.

    The scatter covers rows 0..255 of the 512-stride plane; the JAX
    reference drops indices beyond (``mode="drop"``), and so does this
    mask (the host front emits no negative index).  The adds run in
    int32 and wrap once: the sum mod 2^16 equals the int16 adds."""
    b = jpeg.shape[0]
    ll1 = dwt.synth_level(jpeg[:, :D, :D])
    buf = torch.zeros((b, D, N), dtype=torch.int32, device=jpeg.device)
    buf[:, :, :D] = ll1
    keep = (idx >= 0) & (idx < D * N)
    buf.view(b, D * N).scatter_add_(
        1, torch.where(keep, idx, 0).to(torch.int64),
        torch.where(keep, delta.to(torch.int32), 0))
    return wrap16(buf[:, :, :D]).to(torch.int16)


def hq_scatter_t(t: torch.Tensor, idx: torch.Tensor,
                 delta: torch.Tensor) -> torch.Tensor:
    """The HQ residue scatter-add, in place on the transposed level-1
    plane ``t``, which is returned: t (B,512,512) contiguous int16 that
    the caller owns (K7's fresh output), padded pairs idx (B,K) int32 in
    [0, 2^18) (``pad_hq`` checks that on the host) and delta (B,K)
    int16.  Index i of the untransposed plane lands at ((i & 511) << 9)
    | (i >> 9); the padding pair (0, 0) adds nothing.  One int16
    ``scatter_add_``: integer adds wrap modulo 2^16 in any order, so
    duplicates give what the host's int16 ``np.add.at`` gives."""
    idx_t = ((idx & (N - 1)) << 9) | (idx >> 9)
    t.view(t.shape[0], N * N).scatter_add_(1, idx_t.to(torch.int64), delta)
    return t


def _jp(jpeg: torch.Tensor, post_ll1: torch.Tensor) -> torch.Tensor:
    """The coefficient plane with the post-dering LL1 transposed back."""
    jp = jpeg.clone()
    jp[:, :D, :D] = post_ll1.transpose(1, 2)
    return jp


def y_stage2_dense(jpeg: torch.Tensor, post_ll1: torch.Tensor,
                   depth: torch.Tensor, n_waves: int,
                   hq_idx: torch.Tensor | None = None,
                   hq_delta: torch.Tensor | None = None) -> torch.Tensor:
    """Y stage 2 with the dering marks as depth waves -> (B,512,512)
    uint8 Y planes: K2 without HQ pairs, else K7, the HQ scatter and
    K8."""
    jp = _jp(jpeg, post_ll1)
    if hq_idx is None:
        return dwt.y_stage2_full(jp, depth, n_waves)
    t = hq_scatter_t(dwt.synth_unnorm_rows_t(jp), hq_idx, hq_delta)
    return dwt.synth_norm_rows_clip_waves(t, depth, n_waves)


def y_stage2_seq(jpeg: torch.Tensor, post_ll1: torch.Tensor,
                 hq_idx: torch.Tensor, hq_delta: torch.Tensor,
                 recs: torch.Tensor, valid: torch.Tensor) -> torch.Tensor:
    """Y stage 2 with the sequential mark scan, for marks that
    ``mark_depth_planes`` cannot make into waves: K7, the HQ scatter, the
    scan, K9 (device_decode.py y_stage2_device)."""
    t = hq_scatter_t(dwt.synth_unnorm_rows_t(_jp(jpeg, post_ll1)), hq_idx,
                     hq_delta)
    return dwt.synth_norm_rows_clip(dwt.smooth_marks_seq(t, recs, valid))


# ---------------------------------------------------------------------------
# host-side padding (copied from the reference module, which imports jax)


def _bucket(n: int, lo: int = 8) -> int:
    k = lo
    while k < n:
        k <<= 1
    return k


def pad_scatter(pairs) -> tuple[np.ndarray, np.ndarray]:
    """[(idx, delta)] per image -> (B, K) int32/int16 zero-padded (index
    0 + delta 0 is a no-op add)."""
    k = _bucket(max((len(i) for i, _ in pairs), default=0))
    b = len(pairs)
    idx = np.zeros((b, k), np.int32)
    dl = np.zeros((b, k), np.int16)
    for n, (i, d) in enumerate(pairs):
        idx[n, : len(i)] = i
        dl[n, : len(i)] = d
    return idx, dl


def pad_hq(hqs) -> tuple[np.ndarray, np.ndarray]:
    """``pad_scatter`` of the HQ pairs, which must index the (512*512,)
    plane: raises ValueError on the host for any index outside [0, 2^18),
    where the transposed remap would be wrong."""
    for n, (i, _) in enumerate(hqs):
        if len(i) and (int(np.min(i)) < 0 or int(np.max(i)) >= N * N):
            raise ValueError(f"image {n}: HQ index outside [0, {N * N})")
    return pad_scatter(hqs)


def pad_marks(marks_list) -> tuple[np.ndarray, np.ndarray]:
    """Per-image mark record lists -> ((B, K) int32 recs, (B, K) bool)."""
    k = _bucket(max((len(m) for m in marks_list), default=0))
    b = len(marks_list)
    recs = np.full((b, k), (1 << 8) | 1, np.int32)
    valid = np.zeros((b, k), bool)
    for n, m in enumerate(marks_list):
        recs[n, : len(m)] = m
        valid[n, : len(m)] = True
    return recs, valid


def mark_depth_planes(marks_list):
    """Per-image packed mark records -> ((B,512,512) uint8 depth plane
    in transposed-plane coordinates, n_waves, ok).  ok=False when some
    image emitted same-row marks out of column order."""
    b = len(marks_list)
    dp = np.zeros((b, N, N), np.uint8)
    n_waves = 1
    for n, m in enumerate(marks_list):
        if not m:
            continue
        a = np.asarray(m, np.int64)
        rows = a >> 8
        cols = a & 255
        for r in np.unique(rows):
            cs = cols[rows == r]
            if cs.size > 1 and not np.all(np.diff(cs) > 0):
                return None, 0, False
        grid = np.zeros((256, 257), bool)
        grid[rows, cols] = True
        idx = np.arange(257)
        start = np.where(grid & ~np.roll(grid, 1, axis=1), idx, -1)
        start[:, 0] = np.where(grid[:, 0], 0, -1)
        rs = np.maximum.accumulate(start, axis=1)
        rp = np.where(grid, idx - rs + 1, 0).astype(np.uint8)
        dp[n, 2 * rows, cols] = rp[rows, cols]
        n_waves = max(n_waves, int(rp.max()))
    return dp, n_waves, True


# ---------------------------------------------------------------------------
# batch orchestration


def decode_batch_device(datas, device="cuda") -> list[np.ndarray]:
    """Batched bit-exact decode with the synthesis back end and the
    colorspace on ``device``: .nhw byte strings -> (512,512,3) uint8 RGB
    arrays, byte-identical to ``nhwcodec_tpu.models.decoder.decode``."""
    dev = resolve_device(device)
    b = len(datas)
    parsed = [parse_nhw(data) for data in datas]
    quals = [s.quality for s in parsed]

    ys, scats, hqs, us, vs = [], [], [], [], []
    for s in parsed:
        res_comp = dc_plane.decode_dc_planes(
            s.res_ch, s.highres_comp, s.res_U_64, s.res_V_64,
            s.quality, s.res_high)
        jpeg, scat, hq = dec.decode_y_front(s, res_comp)
        ys.append(jpeg.reshape(N, N))
        scats.append(scat)
        hqs.append(hq)
        sym_uv = entropy.decode_uv(s.packet2, s.tree2, s.tree_end)
        exw1 = dec._y_exw_end(s)
        ju, exw1 = dec.decode_uv_front(s, res_comp, sym_uv, 0, exw1 + 2)
        jv, _ = dec.decode_uv_front(s, res_comp, sym_uv, 1, exw1 + 2)
        us.append(ju.reshape(D, D))
        vs.append(jv.reshape(D, D))

    idx, dl = pad_scatter(scats)
    jpeg_d, idx_d, dl_d, uv_d = front_to_torch(
        dev, np.stack(ys), idx, dl, np.stack(us + vs))
    proc_ll1 = y_stage1(jpeg_d, idx_d, dl_d).cpu().numpy()
    pre_uv_d = dwt.uv_synth(uv_d)  # runs while the host derings

    # host dering (sequential; mutates the LL1 block exactly like the
    # reference's in-place pass)
    marks_list = []
    post = np.empty_like(proc_ll1)
    for i in range(b):
        p512 = np.zeros(4 * SZ, np.int16)
        p512.reshape(N, N)[:D, :D] = proc_ll1[i]
        marks_list.append(dec._dering_mark_y(p512))
        post[i] = p512.reshape(N, N)[:D, :D]
    # the HQ pairs go to the device only when some image has one (a q > 21
    # stream of a flat image has none); the K2 branch needs none
    hq_idx, hq_dl = pad_hq(hqs)
    has_hq = any(len(i) for i, _ in hqs)
    dp, n_waves, ok = mark_depth_planes(marks_list)
    if ok:
        post_d, dp_d = front_to_torch(dev, post, dp)
        hq_d = front_to_torch(dev, hq_idx, hq_dl) if has_hq else (None, None)
        y_planes = y_stage2_dense(jpeg_d, post_d, dp_d, n_waves, *hq_d)
    else:  # same-row marks out of column order: the sequential scan
        y_planes = y_stage2_seq(jpeg_d, *front_to_torch(
            dev, post, hq_idx, hq_dl, *pad_marks(marks_list)))

    # host: UV sharpen (sequential) + clip + upsample
    pre_uv = pre_uv_d.cpu().numpy()
    uv_planes = np.empty((2 * b, N, N), np.uint8)
    for i in range(2 * b):
        uv_planes[i] = dec.decode_uv_back(pre_uv[i].reshape(-1).copy(),
                                          quals[i % b])
    u_d, v_d = front_to_torch(dev, uv_planes[:b], uv_planes[b:])

    out: list = [None] * b
    for q in sorted(set(quals)):
        sel = [i for i in range(b) if quals[i] == q]
        sel_d = torch.tensor(sel, device=dev)
        rgb = colorspace.yuv_to_rgb(y_planes[sel_d], u_d[sel_d], v_d[sel_d],
                                    q).cpu().numpy()
        for n, i in enumerate(sel):
            out[i] = rgb[n]
    return out
