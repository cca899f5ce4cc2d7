"""The exact colorspaces of both directions, in torch float ops.

Decode, YUV -> RGB: port of ``nhwcodec_tpu.ops.colorspace_device
.yuv_to_rgb_device_exact``.  The JAX package replays the reference's
float math in integer limbs because the TPU has no float64; a CUDA card
has IEEE float64 and float32, so this is the host decoder's own
definition (``models/decoder.py:771-810``, decoder/nhw_decoder_cli.c:
133-283) written as torch tensor ops in the same evaluation order.  Each
multiply and add is its own torch op, so no multiply-add is fused into
one rounding; no fused op (addcmul, lerp, alpha=) is used.

Modes: 0 q >= NORM, plain float64; 1 q == LOW3, float64 with the gain
applied before the +0.5; 2 q in (LOW1, LOW2), Y pre-scaled in float32;
3 q <= LOW4, integer matrix with a float32 gain.

Encode, RGB -> YUV 4:2:0: port of ``colorspace_device
.rgb_to_yuv420_device_exact`` and its Pallas twin
``pallas_colorspace.colorspace_down420_pallas`` (K6).  The twin
``rgb_to_yuv420_ref`` is the host float chain (``host.ops.colorspace
.rgb_to_yuv``, encoder/colorspace.c:55-260) in the same
order, then the integer [1,2,1]/4 decimation.  ``rgb_to_yuv420``
launches K6 (``csrc/colorspace.cu``) for a CUDA tensor at q >= NORM; the
other qualities run the twin's torch ops on the tensor's device, as the
JAX package runs them as plain XLA.
"""

from __future__ import annotations

import numpy as np
import torch

from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.ops.colorspace import QTZ
from nhwcodec_tpu_torch.kernels import build


def decode_mode(quality: int) -> int:
    if quality >= T.NORM:
        return 0
    if quality == T.LOW3:
        return 1
    if quality in (T.LOW1, T.LOW2):
        return 2
    return 3


def yuv_to_rgb(y: torch.Tensor, u: torch.Tensor, v: torch.Tensor,
               quality: int) -> torch.Tensor:
    """(..., H, W) uint8 planes -> (..., H, W, 3) uint8 RGB, equal to
    ``models.decoder.yuv_to_rgb`` for every input."""
    mode = decode_mode(quality)
    f64, f32 = torch.float64, torch.float32
    if mode == 3:
        yinv = torch.tensor(np.float32(T.Y_INV[quality]), device=y.device)
        half = torch.tensor(np.float32(128.5), device=y.device)
        yi = y.to(torch.int64) * 298
        ui = u.to(torch.int64)
        vi = v.to(torch.int64)

        def chan(acc):
            f = acc.to(f32) * yinv
            f = f + half
            return f.trunc().to(torch.int64) >> 8

        r = chan(yi + 409 * vi + T.R_COMP)
        g = chan(yi - 100 * ui - 208 * vi + T.G_COMP)
        b = chan(yi + 516 * ui + T.B_COMP)
    else:
        uf = u.to(f64) - 128.0
        vf = v.to(f64) - 128.0
        if mode == 2:
            yinv32 = torch.tensor(np.float32(T.Y_INV[quality]),
                                  device=y.device)
            yq = (y.to(f32) * yinv32).to(f64)
        else:
            yq = y.to(f64)
        r = yq + 1.402 * vf
        g = yq - 0.34414 * uf
        g = g - 0.71414 * vf
        b = yq + 1.772 * uf
        if mode == 1:
            yinv = float(np.float32(T.Y_INV[quality]))
            r = r * yinv
            g = g * yinv
            b = b * yinv
        r, g, b = r + 0.5, g + 0.5, b + 0.5
        r, g, b = (c.trunc().to(torch.int64) for c in (r, g, b))
    return torch.stack([r, g, b], dim=-1).clamp(0, 255).to(torch.uint8)


# ---------------------------------------------------------------------------
# encode direction


def _clip_u8(v: torch.Tensor) -> torch.Tensor:
    """The reference's (v>>8)!=0 clip pattern on ints -> uint8."""
    return torch.where((v >> 8) != 0, torch.where(v < 0, 0, 255),
                       v).to(torch.uint8)


def _f32(x: float, like: torch.Tensor) -> torch.Tensor:
    return torch.tensor(np.float32(x), device=like.device)


def rgb_to_yuv(rgb: torch.Tensor, quality: int):
    """(..., H, W, 3) uint8 -> (Y int16, U, V uint8), (..., H, W) each,
    before the chroma decimation; equal to ``ops.colorspace.rgb_to_yuv``
    for every input."""
    if quality <= T.LOW4:
        r, g, b = (rgb[..., c].to(torch.int64) for c in range(3))
        qtz = QTZ[quality]
        y = (((66 * r + 129 * g + 25 * b) * qtz + 4194304) >> 23) + 16
        u = (((-38 * r - 74 * g + 112 * b) * qtz + 4194304) >> 23) + 128
        v = (((112 * r - 94 * g - 18 * b) * qtz + 4194304) >> 23) + 128
        return y.to(torch.int16), _clip_u8(u), _clip_u8(v)

    r, g, b = (rgb[..., c].to(torch.float64) for c in range(3))
    ysum = 0.299 * r
    ysum = ysum + 0.587 * g
    ysum = ysum + 0.114 * b
    cb = -0.1687 * r
    cb = cb - 0.3313 * g
    cb = cb + 0.5 * b
    cr = 0.5 * r
    cr = cr - 0.4187 * g
    cr = cr - 0.0813 * b
    if quality >= T.NORM:
        y = ysum + 0.5
    elif quality in (T.LOW1, T.LOW2):
        y = ysum * float(np.float32(0.975 if quality == T.LOW1 else 0.93))
        y = y + 0.5
    else:  # LOW3
        y = ysum * 0.94
        y = y + 0.5
        cb = cb * 0.94
        cr = cr * 0.94
    # the reference stores each chroma sum in a float (encoder/
    # colorspace.c:60), so the +-half add is a float32 add
    half_p, half_n = _f32(128.5, rgb), _f32(128.4, rgb)

    def chroma(c):
        c32 = c.to(torch.float32)
        w = torch.where(c32 >= 0, c32 + half_p, c32 + half_n)
        return _clip_u8(w.trunc().to(torch.int64))

    return y.trunc().to(torch.int16), chroma(cb), chroma(cr)


def down420(c: torch.Tensor) -> torch.Tensor:
    """Integer 4:2:0 decimation (encoder/colorspace.c:220-256): [1,2,1]/4
    at even columns (the first pair-averaged), then the same at even
    rows.  (..., 512, 512) uint8 -> (..., 256, 256) uint8."""
    c = c.to(torch.int32)
    h = torch.cat([(c[..., :, :1] + c[..., :, 1:2] + 1) >> 1,
                   (c[..., :, 1:510:2] + 2 * c[..., :, 2:511:2]
                    + c[..., :, 3:512:2] + 2) >> 2], -1)
    o = torch.cat([(h[..., :1, :] + h[..., 1:2, :] + 1) >> 1,
                   (h[..., 1:510:2, :] + 2 * h[..., 2:511:2, :]
                    + h[..., 3:512:2, :] + 2) >> 2], -2)
    return o.to(torch.uint8)


def rgb_to_yuv420_ref(rgb: torch.Tensor, quality: int):
    """The encode colorspace twin: (B,512,512,3) uint8 -> (Y (B,512,512)
    int16, U, V (B,256,256) uint8), equal to
    ``ops.colorspace.downsample_yuv420`` per image."""
    y, u, v = rgb_to_yuv(rgb, quality)
    return y, down420(u), down420(v)


def _check_rgb(rgb: torch.Tensor, name: str) -> None:
    build.check_arg(rgb, name, torch.uint8, (None, 512, 512, 3))
    if rgb.device.type == "cuda" and not rgb.is_contiguous():
        raise ValueError(f"{name}: input must be contiguous")


def rgb_to_yuv420(rgb: torch.Tensor, quality: int):
    """The exact encode colorspace with 4:2:0 chroma: (B,512,512,3)
    uint8 -> (Y (B,512,512) int16, U, V (B,256,256) uint8).  K6 for a
    CUDA tensor at q >= NORM; the twin otherwise.  K6 reads the image
    with 16-byte loads: a CUDA tensor must be contiguous and start on a
    16-byte boundary, else this raises (RuntimeError, misaligned)."""
    _check_rgb(rgb, "rgb_to_yuv420")
    if rgb.device.type == "cpu" or quality < T.NORM:
        return rgb_to_yuv420_ref(rgb, quality)
    lib, stream = build.cuda_args(rgb)
    b = rgb.shape[0]
    y = torch.empty(rgb.shape[:3], dtype=torch.int16, device=rgb.device)
    u = torch.empty((b, 256, 256), dtype=torch.uint8, device=rgb.device)
    v = torch.empty_like(u)
    if b:
        with torch.cuda.device(rgb.device):
            build.check("nhw_colorspace_down420", lib.nhw_colorspace_down420(
                rgb.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(), b,
                stream))
        build.count("colorspace_down420")
    return y, u, v


def rgb_to_yuv_full(rgb: torch.Tensor):
    """K6's per-pixel function without the decimation, q >= NORM:
    (B,512,512,3) uint8 -> (Y int16, U, V uint8), (B,512,512) each.  It
    lets an exhaustive sweep hold every pixel's chroma to the host."""
    _check_rgb(rgb, "rgb_to_yuv_full")
    if rgb.device.type == "cpu":
        return rgb_to_yuv(rgb, T.NORM)
    lib, stream = build.cuda_args(rgb)
    y = torch.empty(rgb.shape[:3], dtype=torch.int16, device=rgb.device)
    u = torch.empty(rgb.shape[:3], dtype=torch.uint8, device=rgb.device)
    v = torch.empty_like(u)
    if y.numel():
        with torch.cuda.device(rgb.device):
            build.check("nhw_rgb_to_yuv_full", lib.nhw_rgb_to_yuv_full(
                rgb.data_ptr(), y.data_ptr(), u.data_ptr(), v.data_ptr(),
                y.numel(), stream))
        build.count("rgb_to_yuv_full")
    return y, u, v
