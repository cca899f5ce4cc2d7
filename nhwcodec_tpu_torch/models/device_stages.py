"""Device front end of the byte-exact batched encode, in torch.

Port of ``nhwcodec_tpu.models.device_stages``: functional replicas of the
host encoder's in-place transform stages, producing the exact (jpeg,
process, res256, snap) state the host scans consume:

- Y:   wavelet_analysis(512, 0) -> res256 snapshot -> wavelet_analysis(256, 1)
       (encoder/nhw_encoder.c:121-139 / encoder/wavelet_filterbank.c:52-302)
- UV:  pre_processing_UV (q <= LOW6) -> wavelet_analysis(256, 0) -> res256
       -> LOW4 band dead-zone -> wavelet_analysis(128, 1)
       (encoder/nhw_encoder.c:2256-2314 / image_processing.c:2428-2464)

Every analysis level is K4 (``ops.dwt.analysis_level_jp``); the LL
transpose-back, the splices, the UV pre-filter and the dead-zone are
torch ops on the tensors' device.  The level-2 planes come back from K4
as new tensors, and the level-1 planes are updated in place (they are
K4's own outputs).  Equality with the JAX package and the host:
tests/test_torch_analysis.py, tests/test_torch_encode.py.
"""

from __future__ import annotations

import numpy as np
import torch

from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.ops import prefilter, requant
from nhwcodec_tpu_torch.ops import colorspace, dwt

D = 256
N = 512


def to_device(device, *arrays) -> tuple[torch.Tensor, ...]:
    """Numpy arrays -> tensors on ``device`` that never share the arrays'
    memory (the callers may update them in place); tensors -> the same
    tensors on ``device``."""
    dev = torch.device(device)
    return tuple(a.to(dev) if isinstance(a, torch.Tensor)
                 else torch.tensor(a, device=dev) for a in arrays)


def to_host(*tensors: torch.Tensor) -> tuple[np.ndarray, ...]:
    """Tensors -> host numpy arrays."""
    return tuple(t.cpu().numpy() for t in tensors)


def _last_level(jpeg: torch.Tensor, process: torch.Tensor,
                res: torch.Tensor) -> None:
    """The last level on the LL block ``res``: no transpose-back, so its
    (j, p) land as they are."""
    h = res.shape[-1]
    j2, p2 = dwt.analysis_level_jp(res)
    process[:, :h, :h] = p2
    jpeg[:, :h, :h] = j2


def analysis_y(y: torch.Tensor):
    """(B, 512, 512) int16 pre-processed luma -> (jpeg, process, res256,
    snap): the exact post-second-analysis state of encode_y
    (models/encoder.py) before the requant ladder.  snap is the first
    2*IM_SIZE elements of the level-1 row pass, (B, 256, 512)."""
    j1, p1 = dwt.analysis_level_jp(y.to(torch.int16))
    snap = j1[:, :D, :].clone()
    jpeg = j1
    jpeg[:, :D, :D] = p1[:, :D, :D].transpose(1, 2)
    res256 = jpeg[:, :D, :D].clone()
    _last_level(jpeg, p1, res256)
    return jpeg, p1, res256, snap


def _pre_processing_uv_device(jpeg: torch.Tensor,
                              quality: int) -> torch.Tensor:
    """8-neighbour laplacian nudge (encoder/image_processing.c:2428-2464),
    device replica of models.encoder._pre_processing_uv."""
    p = jpeg.to(torch.int32)
    lap = torch.zeros_like(p)
    lap[..., 1:-1, 1:-1] = (p[..., 1:-1, 1:-1] * 8
                            - p[..., 1:-1, :-2] - p[..., 1:-1, 2:]
                            - p[..., :-2, 1:-1] - p[..., 2:, 1:-1]
                            - p[..., :-2, :-2] - p[..., 2:, :-2]
                            - p[..., :-2, 2:] - p[..., 2:, 2:])
    if quality < T.LOW6:
        a = lap.abs()
        d = torch.where(a >= 14, 2, torch.where(a > 5, 1, 0))
        nudge = torch.sign(lap) * d
    else:
        nudge = torch.where(lap > 5, 1, torch.where(lap < -5, -1, 0))
    return (p - nudge).to(torch.int16)


def analysis_uv(c: torch.Tensor, quality: int):
    """(B, 256, 256) uint8 downsampled chroma -> (jpeg, process, res256):
    the exact encode_uv state after its second analysis
    (encoder/nhw_encoder.c:2256-2314), with the q <= LOW6 pre-filter and
    the q <= LOW4 band dead-zone."""
    jpeg = c.to(torch.int16)
    if quality <= T.LOW6:
        jpeg = _pre_processing_uv_device(jpeg, quality)
    jpeg, process = dwt.analysis_level_jp(jpeg)
    jpeg[:, :128, :128] = process[:, :128, :128].transpose(1, 2)
    res256 = jpeg[:, :128, :128].clone()
    if quality <= T.LOW4:
        # band dead-zones before the second level (encode_uv LOW4 pass)
        for rows, cols, hi in ((slice(None, 128), slice(128, None), 24),
                               (slice(128, None), slice(None, 128), 32),
                               (slice(128, None), slice(128, None), 48)):
            band = process[:, rows, cols]
            a = band.to(torch.int32).abs()
            process[:, rows, cols] = torch.where((a >= 8) & (a < hi),
                                                 torch.zeros_like(band), band)
    _last_level(jpeg, process, res256)
    return jpeg, process, res256


def _analysis_all(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
                  quality: int):
    """Y, then U and V as one batch of 2B planes."""
    pre_y = analysis_y(y)
    b = u.shape[0]
    uv = analysis_uv(torch.cat([u, v]), quality)
    return (pre_y, tuple(a[:b] for a in uv), tuple(a[b:] for a in uv))


def analysis_front_device(y, u, v, quality: int, device):
    """Batched device analysis of the (possibly host-pre-filtered) Y
    planes (B, 512, 512) int16 and the downsampled chroma planes (B, 256,
    256) uint8, numpy or tensors.  Returns host numpy trees ((y_jpeg,
    y_process, y_res256, y_snap), (u_jpeg, u_process, u_res256),
    (v_...)) ready for the host scans."""
    y, u, v = to_device(device, y, u, v)
    pre_y, pre_u, pre_v = _analysis_all(y, u, v, quality)
    return to_host(*pre_y), to_host(*pre_u), to_host(*pre_v)


def colorspace_front_device(rgb: torch.Tensor, quality: int):
    """Device colorspace only (the q < HIGH2 path: the host Y pre-filter
    runs between colorspace and analysis).  (B,512,512,3) uint8 tensor
    -> (Y int16, U, V uint8) tensors on its device."""
    return colorspace.rgb_to_yuv420(rgb, quality)


def encode_front_device(rgb: torch.Tensor, quality: int):
    """The whole front end for the qualities with no Y pre-filter (q >
    HIGH1): colorspace (K6) and analysis on the device, all transform
    state out as host numpy trees ((y, u, v), pre_y, pre_u, pre_v)."""
    if quality <= T.HIGH1:
        raise ValueError(f"encode_front_device: q > {T.HIGH1} only, "
                         f"got q{quality}")
    y, u, v = colorspace.rgb_to_yuv420(rgb, quality)
    pre_y, pre_u, pre_v = _analysis_all(y, u, v, quality)
    return (to_host(y, u, v), to_host(*pre_y), to_host(*pre_u),
            to_host(*pre_v))


def encode_front(images: np.ndarray, quality: int, dev):
    """The encode's front for a (B, 512, 512, 3) uint8 batch: D1
    colorspace (K6 at q >= NORM), H1 the host Y pre-filter (q < HIGH2), D2
    analysis (K4), H1b the host requant mark + offset(part=1) and D3 the
    requant tail (K5) (q > LOW14).  Returns host arrays (y1s, origs, u, v,
    pre_y, pre_u, pre_v): the pre-filtered and the original Y planes, the
    chroma planes and the transform states; pre_y is (jpeg, process,
    res256, snap) after the requant block, so the host encode skips its own
    (``requant_done``)."""
    rgb, = to_device(dev, images)
    if quality > T.HIGH1:
        (y, u, v), pre_y, pre_u, pre_v = encode_front_device(rgb, quality)
        y1s = origs = list(y)
    else:
        y_d, u_d, v_d = colorspace_front_device(rgb, quality)
        y, u, v = to_host(y_d, u_d, v_d)
        origs = list(y)
        y1s = ([prefilter.pre_process_y(o, quality) for o in origs]
               if quality < T.HIGH2 else origs)
        pre_y, pre_u, pre_v = analysis_front_device(
            np.stack(y1s), u_d, v_d, quality, dev)
    if quality > T.LOW14:
        # imported here: models.device_requant imports this module
        from nhwcodec_tpu_torch.models import device_requant

        # the host greedy mark + offset(part=1) automata, then the rest of
        # the requant block on the device
        jpegs, procs, r256s = (np.array(a, np.int16) for a in pre_y[:3])
        for k in range(len(images)):
            requant.mark_res256(procs[k], r256s[k])
            requant.offset_y_recons256(jpegs[k], procs[k], quality, 8,
                                       part=1)
        pre_y = device_requant.requant_tail_device(
            jpegs, procs, r256s, dev) + (pre_y[3],)
    return y1s, origs, u, v, pre_y, pre_u, pre_v
