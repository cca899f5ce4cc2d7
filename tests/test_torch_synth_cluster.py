"""The cluster form of K1 (``synth_level``), checked on the CPU.

On the card each call is one launch of ``synth_cluster`` (csrc/dwt.cu):
one cluster per plane, CTA c staging rows [cR, (c+1)R) of x through the
caller's plane and row strides, its un-normalised row pass sending pair k
of each row through ``rows_to_peers_t`` (csrc/cluster.cuh, K3's map) into
transposed rows 2k and 2k + 1 in the CTA that owns them, and each CTA's
normalised pass on its own transposed rows writing out rows
[cR, (c+1)R).

Here a numpy emulation of that ownership and exchange map, with the
launch shapes and pitches read from the source, rebuilds K1's output
from strided corner views at n = 128, 256 and 512 equal to
``synth_level_ref`` and ``synth_level_pallas`` in interpret mode,
tolerance 0; each word of the transposed plane is written once, each
warp's stores land in one CTA on 32 banks, and each warp's reads of the
staged rows fall on distinct banks.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import SYNTH_SHAPES
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu_torch.ops import dwt
from nhwcodec_tpu_torch.ops.lifting import synth_unnorm
from test_torch_analysis_cluster import _pack, _store, _unpack, peer_map

SOURCE = Path(dwt.__file__).resolve().parent.parent / "csrc" / "dwt.cu"
TEXT = SOURCE.read_text()


def test_launch_shapes_follow_the_source():
    table = re.search(r"kSynthShapes\[3\]\[3\] = \{(.*?)\};", TEXT,
                      re.S).group(1)
    shapes = {int(n): (int(c), int(t)) for n, c, t in
              re.findall(r"\{(\d+), (\d+), (\d+)\}", table)}
    assert shapes == SYNTH_SHAPES
    for b, n, _ in chip_smoke.synth_path_shapes(16):
        # 64-128 CTAs at the paths' batches, at most 8 a cluster
        assert b * shapes[n][0] >= 64 and shapes[n][0] <= 8
    for n in SYNTH_SHAPES:
        L = Layout(n)
        # about 100 KB of shared memory or less, so two CTAs fit an SM
        assert L.smem <= 100 * 1024
        # 512-thread CTAs pair on an SM at 64 registers a thread
        assert re.search(r"__launch_bounds__\(SynthLayout<kN>::kThreads, 2\)",
                         TEXT)


class Layout:
    """dwt.cu's SynthLayout<kN>, its pitches read from the source."""

    def __init__(self, n):
        body = re.search(r"struct SynthLayout \{(.*?)\n\};", TEXT,
                         re.S).group(1)
        extra = {name: int(add) for name, add in re.findall(
            r"(kInPitch|kTPitch) = kN \+ (\d+);", body)}
        self.n, self.m = n, n // 2
        self.cluster, self.threads = SYNTH_SHAPES[n]
        self.rows = n // self.cluster
        self.quarter = self.rows // 4
        self.in_pitch = n + extra["kInPitch"]
        self.t_pitch = n + extra["kTPitch"]
        self.smem = 2 * (self.rows * self.t_pitch
                         + 2 * self.quarter * self.in_pitch)


def emulate(flat, offset, plane, row, n):
    """K1 on the plane at element ``offset`` of the flat int16 buffer
    ``flat`` with row stride ``row`` (``plane`` is its plane stride, used
    by the caller): the staged copies, the exchange and the normalised
    pass.  Returns the (n, n) int16 output."""
    L = Layout(n)
    m, R, C = L.m, L.rows, L.cluster
    ts = np.zeros((C, R, L.t_pitch // 2), np.uint32)
    count = np.zeros(ts.shape, np.int64)
    k, rp, d0, d1 = peer_map(L.quarter, m, R, L.t_pitch, L.threads, 2, 1, 2)
    cols = np.arange(n)
    for c in range(C):
        for q in range(4):
            # stage_rows_async: rows cR + q Q.. through the row stride
            r0 = c * R + q * L.quarter
            staged = flat[offset + (r0 + np.arange(L.quarter))[:, None] * row
                          + cols]
            u = synth_unnorm(*(torch.from_numpy(staged.astype(np.int32))
                               .split(m, -1))).to(torch.int16).numpy()
            even, odd = u[:, 0::2], u[:, 1::2]
            for d, v in ((d0, even), (d1, odd)):
                _store(ts, count, d // R, d % R, r0 // 2 + rp,
                       _pack(v[2 * rp, k], v[2 * rp + 1, k]))
    assert (count[..., :n // 2] == 1).all() and not count[..., n // 2:].any()
    t = _unpack(ts[..., :n // 2]).reshape(n, n)
    # each CTA's normalised pass over its rows: out rows cR..
    return dwt.norm_rows_ref(torch.from_numpy(t)).to(torch.int16).numpy()


def _inputs(kind, b, side, n, seed):
    """(B, side, side) parent planes whose (n, n) corners are K1's input."""
    rng = np.random.default_rng(seed)
    x = rng.integers(-32768, 32768, (b, side, side)).astype(np.int16)
    x[:, :n, :n] = (chip_smoke.extreme_planes(rng, b, n) if kind == "extremes"
                    else chip_smoke.synth_edge_planes(rng, b, n))
    return x


@pytest.mark.parametrize("kind", ["extremes", "CTA edges"])
@pytest.mark.parametrize("n, side", [(128, 256), (128, 512), (256, 512),
                                     (512, 512)])
def test_emulated_map_rebuilds_the_twin(n, side, kind):
    b = 2
    x = _inputs(kind, b, side, n, seed=n + side)
    view = torch.from_numpy(x)[:, :n, :n]
    want = dwt.synth_level_ref(view).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(pallas_dwt.synth_level_pallas(
            jnp.asarray(x[:, :n, :n]), interpret=True)))
    flat = x.reshape(-1)
    for i in range(b):
        got = emulate(flat, i * side * side, side * side, side, n)
        np.testing.assert_array_equal(got, want[i])


def _read_wavefronts(addr_words):
    """Wavefronts of one warp's 2-byte shared loads, given each thread's
    4-byte word: the most distinct words on one bank."""
    banks = {}
    for w in set(int(a) for a in addr_words):
        banks.setdefault(w % 32, set()).add(w)
    return max(len(v) for v in banks.values())


@pytest.mark.parametrize("n", sorted(SYNTH_SHAPES))
def test_staged_reads_fall_on_distinct_banks(n):
    # a warp of the row pass takes 16 k of two row pairs: rows 2rp..2rp+3
    # of a quarter buffer; each of unnorm_pair's loads (L[k], L[k+1],
    # H[k-1], H[k], H[k+1]) is one wavefront
    L = Layout(n)
    m = n // 2
    k, rp, _, _ = peer_map(L.quarter, m, L.rows, L.t_pitch, L.threads, 2, 1,
                           2)
    pw = L.in_pitch // 2
    for w in range(k.size // 32):
        kk, pp = k[32 * w:32 * w + 32], rp[32 * w:32 * w + 32]
        for row in (2 * pp, 2 * pp + 1):
            for off in (0, 1, m - 1, m, m + 1):
                col = np.clip(kk + off, 0, n - 1)
                assert _read_wavefronts(row * pw + col // 2) == 1
