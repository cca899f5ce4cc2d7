"""The least device time of a cell's work: peaks and per-image bounds.

Frozen copy, at commit a4a43cf, of ``chip_smoke.py``'s peaks
(``PEAK_BYTES``, ``PEAK_OPS``), ``work`` and the operation counts of the
kernels that the benchmark's paths run (``OPS``, ``SNAP_OPS``,
``MERGE_OPS``, ``OFFSET_Y_PASS1_OPS``, ``OY4_OPS``, ``LL1_OPS``), applied
to one 512x512 image.  A stage's bound is the larger of its bytes, each
input byte read and each output byte written once at the HBM peak, and
its counted operations at the int32 peak.  What a stage must do depends
only on the image's shapes and the quality, never on which kernels or
torch operations do it, so a later change to the program cannot move the
numerator.  Work that depends on the data (the dering waves, the S8
walks, the bit packing, the relay sweeps) is left out: the sum is a lower
bound, and a share of it never passes 100% unless the time leaves out
work.
"""

from __future__ import annotations

# H100 SXM at 700 W (NVIDIA's data sheet): HBM bytes/s; int32 adds,
# shifts, compares and selects on 64 lanes of 132 SMs at 1.98 GHz
PEAK_BYTES = 3.35e12
PEAK_OPS = 132 * 64 * 1.98e9

OPS = {"synth_level": 30, "y_stage2_full": 32, "uv_synth": 48,
       "analysis_level_jp": 30, "requant_tail": 110,
       "colorspace_down420": 26}
SNAP_OPS = 30
MERGE_OPS = 25
OFFSET_Y_PASS1_OPS = 21
OY4_OPS = 49
LL1_OPS = 12
SZ = 65536          # a stream section's bytes (chip_smoke.SZ)

# qualities (nhwcodec_tpu_torch/host/tables.py)
LOW14, LOW9, LOW8, LOW7, LOW4 = 6, 11, 12, 13, 16


def work_s(nbytes: float, ops: float) -> float:
    """The least seconds the card could take to move ``nbytes`` and do
    ``ops`` operations."""
    return max(nbytes / PEAK_BYTES, ops / PEAK_OPS)


def _analysis() -> float:
    # K4 on Y at 512 and 256, on U and V at 256 and 128
    return sum(work_s(6 * b * n * n, OPS["analysis_level_jp"] * b * n * n)
               for b, n in ((1, 512), (1, 256), (2, 256), (2, 128)))


def front_s(quality: int) -> float:
    """The encode front of one image: colorspace and 4:2:0 (K6), both
    analysis levels (K4 x 4) and, at q > LOW14, the requant tail (K5)."""
    s = work_s(512 * 512 * (3 + 2) + 2 * 256 * 256,
               OPS["colorspace_down420"] * 512 * 512) + _analysis()
    if quality > LOW14:
        s += work_s(12 * 256 * 256, OPS["requant_tail"] * 256 * 256)
    return s


def scans_s(quality: int) -> float:
    """The encode scans of one image on the device (q1..q21): the snap
    passes (S1), the stream merge (S3), the LL2 coding (S7, its 131 x 131
    window and five words a position of the 256 x 256 LL), and below q17
    S10, below q14 S11, below q13 S12, below q12 S13 and S14 on U and V;
    each plane read and written once."""
    plane = 2 * 512 * 512
    s = (work_s(2 * plane, SNAP_OPS * 512 * 512)
         + work_s(2 * (6 * SZ + 16), MERGE_OPS * 4 * SZ)
         + work_s(2 * 131 * 131 + 5 * 256 * 256, 0))
    if quality <= LOW4:
        s += work_s(plane, (OFFSET_Y_PASS1_OPS + OY4_OPS) * 512 * 512)
    if quality <= LOW7:
        s += work_s(plane + 2 * 65792, 0)
    if quality <= LOW8:
        s += work_s(plane, 0)
    if quality <= LOW9:
        s += work_s(plane, LL1_OPS * 128 * 256)
        s += 2 * work_s(2 * 2 * 256 * 256, 0)
    return s


def decode_s(quality: int) -> float:
    """The decode back end of one image: K1, Y's stage 2 (K2), the chroma
    synthesis (K3) and YUV -> RGB (planes in, bytes out)."""
    return (work_s(4 * 256 * 256, OPS["synth_level"] * 256 * 256)
            + work_s(4 * 512 * 512, OPS["y_stage2_full"] * 512 * 512)
            + work_s(8 * 256 * 256, OPS["uv_synth"] * 2 * 256 * 256)
            + work_s(512 * 512 + 2 * 256 * 256 + 3 * 512 * 512, 0))


STAGES = {"front": front_s, "scans": scans_s, "decode": decode_s}


def bound_s(stages: list[str], quality: int, images: int) -> float:
    """The least device seconds of ``images`` images through ``stages``
    (names of ``STAGES``) at ``quality``."""
    return images * sum(STAGES[s](quality) for s in stages)
