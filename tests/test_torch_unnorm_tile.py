"""The tile form of K7 (``synth_unnorm_rows_t``), checked on the CPU.

On the card each call is one launch of ``unnorm_rows_t_tile``
(csrc/dwt.cu): a CTA owns kT7Rows source rows r0.. and kT7Pairs output
pairs k0.. of one plane, stages each row's L[k0 ..] and H[k0 - 8 ..]
windows with 16-byte copies through the caller's plane and row strides
(a one-value halo on each side, nothing outside the row), runs the
un-normalised row pass through ``unnorm_pair_at`` (csrc/lifting.cuh) on
the staged windows, stores the results transposed into its own shared
tile (two source rows packed in a 32-bit word) and writes the tile out as
16-byte row segments.

Here a numpy emulation of those maps, with the tile sizes and pitches
read from the source, rebuilds K7's output at n = 128, 256 and 512 from
contiguous planes and corner views, equal to ``unnorm_rows_t_ref`` and to
``synth_unnorm_rows_t_pallas`` in interpret mode, tolerance 0; every
output element and tile word is written once, every staged read stays in
its row and plane, every value the row pass reads was staged, and each
warp's shared-memory stores (and the row pass's reads) fall on distinct
banks.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu_torch.ops import dwt

SOURCE = Path(dwt.__file__).resolve().parent.parent / "csrc" / "dwt.cu"
TEXT = SOURCE.read_text()
K = {name: int(v) for name, v in
     re.findall(r"constexpr int (kT7\w+) = (\d+);", TEXT)}
TR, TK, THREADS = K["kT7Rows"], K["kT7Pairs"], K["kT7Threads"]
LV, HV = K["kT7LVecs"], K["kT7HVecs"]
ODD, PAIR, TP = K["kT7OddRow"], K["kT7PairPitch"], K["kT7TPitch"]
VECS = LV + HV


def test_tile_shape_follows_the_source():
    assert chip_smoke.UNNORM_TILE == (TR, TK)
    # the tile's 16-byte vectors plus one on each side for the halo
    assert (LV, HV) == (TK // 8 + 1, TK // 8 + 2)
    # 22,016 bytes and 256 threads: 8 CTAs an SM
    smem = 4 * (TR // 2 * PAIR + 2 * TK * TP)
    assert smem == 22016 and 8 * smem <= 227 * 1024 and 8 * THREADS <= 2048
    for b, n in chip_smoke.unnorm_path_shapes(16):
        assert n % TR == 0 and n // 2 % TK == 0
    assert re.search(r"unnorm_rows_t_tile<<<dim3\(n / 2 / kT7Pairs, "
                     r"n / kT7Rows, batch\), kT7Threads", TEXT)


def _wrap16(v):
    return ((v + 32768) & 65535) - 32768


def _staged_row(r):
    """Word offset of staged row r."""
    return (r >> 1) * PAIR + (r & 1) * ODD


def _tasks(k0):
    """The row pass's tasks in issue order (thread + it * THREADS): local
    pair i, row pair rp."""
    g = np.arange(TR // 2 * TK)
    w = g >> 5
    return ((w % (TK // 4)) * 4 + (g & 3),
            (w // (TK // 4)) * 8 + ((g & 31) >> 2))


def emulate(flat, offset, plane, row, n):
    """K7 on the plane at element ``offset`` of the flat int16 buffer
    ``flat`` (plane stride ``plane``, row stride ``row``).  Returns the
    (n, n) int16 output."""
    m = n // 2
    out = np.zeros((n, n), np.int16)
    written = np.zeros((n, n), np.int64)
    plane_end = offset + (n - 1) * row + n   # past the plane's last value
    assert plane_end <= offset + plane or plane == 0
    for r0 in range(0, n, TR):             # blockIdx.y
        for k0 in range(0, m, TK):         # blockIdx.x
            staged = np.zeros(2 * (TR // 2 * PAIR), np.int64)
            filled = np.zeros(staged.shape, bool)
            i = np.arange(TR * VECS)
            r, v = i // VECS, i % VECS
            low = v < LV
            c = np.where(low, k0 + 8 * v, k0 + 8 * (v - LV - 1))
            keep = (c >= 0) & (c < m)
            start = offset + (r0 + r) * row
            src = start + np.where(low, c, m + c)
            dst = 2 * np.vectorize(_staged_row)(r) + 8 * v
            src, dst, start = src[keep], dst[keep], start[keep]
            # 16-byte copies that stay in their row and plane
            assert (src % 8 == 0).all() and (dst % 8 == 0).all()
            assert (src >= start).all() and (src + 8 <= start + n).all()
            assert (src + 8 <= plane_end).all()
            staged[dst[:, None] + np.arange(8)] = flat[src[:, None]
                                                       + np.arange(8)]
            filled[dst[:, None] + np.arange(8)] = True

            li, rp = _tasks(k0)
            k = k0 + li
            tile = np.zeros(2 * TK * TP, np.uint32)
            count = np.zeros(tile.shape, np.int64)
            vals = []
            for s in (0, 1):
                ls = 2 * np.vectorize(_staged_row)(2 * rp + s)
                hs = ls + 8 * LV + 8
                need = ((ls, 0, k >= 0), (ls, 1, k < m - 1), (hs, -1, k > 0),
                        (hs, 0, k >= 0), (hs, 1, k < m - 1))
                for base, d, used in need:
                    assert filled[(base + li + d)[used]].all()
                lk, hk = staged[ls + li], staged[hs + li]
                l1 = staged[ls + li + 1]
                hm1, hp1 = staged[hs + li - 1], staged[hs + li + 1]
                e = _wrap16(lk * 8)
                o = _wrap16(np.where(k < m - 1, (l1 + lk) * 4, lk * 8))
                sub_even = np.where(k == 0, hk * 4, (hk + hm1) * 2)
                add_odd = np.where(k == 0, 5 * hk - hp1, np.where(
                    k == m - 1, 5 * hk - hm1, 6 * hk - hp1 - hm1))
                vals.append((_wrap16(e - sub_even), _wrap16(o + add_odd)))
            for j, (a, b) in ((2 * li, (vals[0][0], vals[1][0])),
                              (2 * li + 1, (vals[0][1], vals[1][1]))):
                word = j * TP + rp
                np.add.at(count, word, 1)
                tile[word] = ((a & 65535) | ((b & 65535) << 16)).astype(
                    np.uint32)
            # every word of the tile's rows once, none of the padding
            used = (np.arange(2 * TK)[:, None] * TP
                    + np.arange(TR // 2)).ravel()
            assert (count[used] == 1).all() and count.sum() == used.size

            t16 = tile.view(np.int16)
            q = np.arange(2 * TK * TR // 8)
            j, v = q // (TR // 8), q % (TR // 8)
            assert (((2 * k0 + j) * n + r0 + 8 * v) % 8 == 0).all()
            for e8 in range(8):
                out[2 * k0 + j, r0 + 8 * v + e8] = t16[2 * (j * TP + 4 * v)
                                                       + e8]
                written[2 * k0 + j, r0 + 8 * v + e8] += 1
    assert (written == 1).all()
    return out


CASES = [(128, 128), (256, 256), (512, 512), (128, 256), (256, 512)]


@pytest.mark.parametrize("kind", sorted(chip_smoke.UNNORM_EDGE_INPUTS))
@pytest.mark.parametrize("n, side", CASES)
def test_emulated_tiles_rebuild_the_twin(n, side, kind):
    b = 2
    rng = np.random.default_rng(n + side)
    x = rng.integers(-32768, 32768, (b, side, side)).astype(np.int16)
    x[:, :n, :n] = chip_smoke.UNNORM_EDGE_INPUTS[kind](rng, b, n)
    view = torch.from_numpy(x)[:, :n, :n]
    want = dwt.unnorm_rows_t_ref(view).numpy()
    np.testing.assert_array_equal(
        want, np.asarray(pallas_dwt.synth_unnorm_rows_t_pallas(
            jnp.asarray(x[:, :n, :n]), interpret=True)))
    np.testing.assert_array_equal(dwt.synth_unnorm_rows_t(view).numpy(),
                                  want)
    flat = x.reshape(-1)
    for i in range(b):
        got = emulate(flat, i * side * side, side * side, side, n)
        np.testing.assert_array_equal(got, want[i])


def _wavefronts(words):
    """Wavefronts of one warp's 2- or 4-byte shared accesses: the most
    distinct words on one bank."""
    banks = {}
    for w in set(int(a) for a in words):
        banks.setdefault(w % 32, set()).add(w)
    return max(len(s) for s in banks.values())


@pytest.mark.parametrize("n", [128, 256, 512])
def test_shared_accesses_fall_on_distinct_banks(n):
    m = n // 2
    for k0 in range(0, m, TK):
        li, rp = _tasks(k0)
        for wp in range(li.size // 32):
            lane = slice(32 * wp, 32 * wp + 32)
            i, p = li[lane], rp[lane]
            # the two 32-bit stores into the tile: 32 banks each
            for j in (2 * i, 2 * i + 1):
                words = j * TP + p
                assert len({int(a) % 32 for a in words}) == 32
            # unnorm_pair_at's 2-byte reads of the staged rows (the even
            # rows in one instruction, the odd ones in the next)
            for s in (0, 1):
                ls = 2 * np.vectorize(_staged_row)(2 * p + s)
                for base, d in ((ls, 0), (ls, 1), (ls + 8 * LV + 8, -1),
                                (ls + 8 * LV + 8, 0), (ls + 8 * LV + 8, 1)):
                    assert _wavefronts((base + i + d) // 2) == 1
