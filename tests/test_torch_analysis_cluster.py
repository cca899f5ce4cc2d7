"""The cluster form of K4 (``analysis_level_jp``) and K10
(``analysis_level``), checked on the CPU.

On the card each call is one launch of ``analysis_cluster``
(csrc/analysis.cu): one cluster per plane, CTA c owning rows
[cR, (c+1)R) of the transposed plane j in its shared memory.  The row
pass sends each raw IV moment through ``rows_to_peers_t`` (csrc/
cluster.cuh) into the CTA that owns its row of j; each CTA runs the
column pass on its rows (VI above n/2, plain 53 below, the switch on a
CTA edge); K10 sends the low halves of the VI rows through a second
exchange into the owners of the LL rows (the transpose-back).

Here:
- the edge inputs of ``chip_smoke`` (int16 extremes, parity carries
  chained across every CTA edge, dither boundaries, the last pair and the
  VI/53 switch), which the card tests reuse, are held to what they claim;
- on them the torch twins equal ``analysis_level_pallas_jp`` /
  ``analysis_level_pallas`` in interpret mode at n = 256 and 512 and the
  XLA level at 128, tolerance 0;
- a numpy emulation of the kernel's ownership and exchange maps (which
  CTA, local row and word each value lands on, as the index arithmetic of
  ``rows_to_peers_t`` and ``analysis_cluster`` computes it, with the
  launch shapes read from the source) rebuilds j, p and out equal to the
  twins at every n, in place included, each word written once, each
  warp's stores in one CTA and on 32 banks.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from chip_smoke import ANALYSIS_EDGE_INPUTS, ANALYSIS_SHAPES
from nhwcodec_tpu.models import device_stages as jds
from nhwcodec_tpu.models import transform as TR
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu_torch.ops import analysis, dwt

SOURCE = Path(dwt.__file__).resolve().parent.parent / "csrc" / "analysis.cu"
KINDS = list(ANALYSIS_EDGE_INPUTS)


def _inputs(kind, b, n, seed=0):
    return ANALYSIS_EDGE_INPUTS[kind](np.random.default_rng(seed), b, n)


def test_launch_shapes_follow_the_source():
    table = re.search(r"kShapes\[3\]\[3\] = \{(.*?)\};", SOURCE.read_text(),
                      re.S).group(1)
    shapes = {int(n): (int(c), int(t)) for n, c, t in
              re.findall(r"\{(\d+), (\d+), (\d+)\}", table)}
    assert shapes == ANALYSIS_SHAPES
    # about one CTA a streaming multiprocessor (132 on an H100) or more at
    # the encode path's batches; at most 8 CTAs a cluster (the portable
    # limit), so (16, 512) takes 128
    for b, n in chip_smoke.ANALYSIS_PATH_SHAPES:
        assert b * shapes[n][0] >= 128 and shapes[n][0] <= 8


# ---------------------------------------------------------------------------
# the edge inputs hit what they claim


def _column_raw(j):
    """Raw lowpass moments along each row of j (b, n, n) -> (b, n, n/2),
    as low_raw computes them, int64."""
    x = j.astype(np.int64)
    m = x.shape[-1] // 2
    e, o = x[..., 0::2], x[..., 1::2]
    raw = np.empty(x.shape[:-1] + (m,), np.int64)
    raw[..., 0] = 6 * e[..., 0] + 4 * o[..., 0] - 2 * e[..., 1]
    right = np.concatenate([e[..., 2:], e[..., -1:]], -1)
    raw[..., 1:] = (6 * e[..., 1:] + 2 * (o[..., :-1] + o[..., 1:])
                    - (e[..., :-1] + right))
    return raw


@pytest.mark.parametrize("n", [128, 256, 512])
def test_edge_inputs_hit_their_cases(n):
    m = n // 2
    edges = chip_smoke.analysis_cta_edges(n)
    assert len(edges) == ANALYSIS_SHAPES[n][0] - 1 and m in edges
    x = _inputs("int16 extremes", 5, n)
    assert {-32768, 32767} <= set(np.unique(x).tolist())

    # parity chains: the carry of high_adj fires at every odd pair t <
    # m - 1 of the VI rows 1..m-2 (even image) and of the 53 rows
    # m..n-2 (odd image), so on both sides of every CTA edge
    j = dwt.analysis_level_jp_ref(torch.from_numpy(
        _inputs("parity chains", 2, n)))[0].numpy().astype(np.int64)
    a = j[..., 2:n - 2:2] + j[..., 4::2]            # pairs t = 1..m-2
    prev = j[..., 0:n - 4:2] + j[..., 2:n - 2:2]
    carry = (a & 1) & (prev & 1)
    odd_t = np.arange(1, m - 1) % 2 == 1
    assert carry[0, 1:m - 1][:, odd_t].all()
    assert carry[1, m:n - 1][:, odd_t].all()
    for e in edges:   # the pairs (e - 2, e) and (e, e + 2) both carry
        t = e // 2 - 1 if (e // 2 - 1) % 2 else e // 2
        assert carry[0, 1:m - 1, t - 1].all() and carry[1, m:n - 1, t - 1].all()

    # dither boundaries: the VI rows' raw moments take |r| & 63 = 31, 32
    # and 33 at pairs beside every CTA edge
    j = dwt.analysis_level_jp_ref(torch.from_numpy(
        _inputs("dither boundaries", 2, n)))[0].numpy()
    raw = np.abs(_column_raw(j[:, :m])) & 63
    for e in edges:
        near = raw[..., max(e // 2 - 2, 0):e // 2 + 2]
        assert {31, 32, 33} <= set(np.unique(near).tolist()), e

    # the last pair and the VI/53 switch: extremes on those lines
    x = _inputs("last pair, VI/53 switch", 2, n)
    for ln in (0, m - 1, m, n - 2, n - 1):
        for line in (x[:, ln, :], x[:, :, ln]):
            assert np.isin(line, chip_smoke.INT16_EXTREMES).all()


# ---------------------------------------------------------------------------
# the twins equal the JAX package on the edge inputs


def _jax_jp(x):
    if x.shape[-1] == 128:
        return jds._stage_xla(jnp.asarray(x))
    return pallas_dwt.analysis_level_pallas_jp(jnp.asarray(x), interpret=True)


def _jax_level(x):
    if x.shape[-1] == 128:
        return TR._analysis_level(jnp.asarray(x))
    return pallas_dwt.analysis_level_pallas(jnp.asarray(x), interpret=True)


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("n", [128, 256, 512])
def test_twins_match_jax_on_edge_inputs(kind, n):
    # two images: the parity-chain generator's VI and 53 planes
    x = _inputs(kind, 2, n, seed=n)
    tx = torch.from_numpy(x)
    for got, want in zip(dwt.analysis_level_jp_ref(tx), _jax_jp(x)):
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    np.testing.assert_array_equal(dwt.analysis_level_ref(tx).numpy(),
                                  np.asarray(_jax_level(x)))


# ---------------------------------------------------------------------------
# a numpy emulation of the kernel's maps


class Layout:
    """analysis.cu's Layout<kN>."""

    def __init__(self, n):
        self.n, self.m = n, n // 2
        self.cluster, self.threads = ANALYSIS_SHAPES[n]
        self.rows = n // self.cluster
        self.quarter = self.rows // 4
        self.pitch = n + 8
        self.ll_pitch = self.m + 8
        self.warp_rows = self.rows * 32 // self.threads


def peer_map(rows, m, dst_rows, dst_pitch, threads, stride, second, pairs):
    """rows_to_peers_t's tasks g = threadIdx.x + it * kThreads: moment k,
    row pair rp, and the destination rows d0 (and d1 when ``second``) of
    v0 (v1) in the transposed plane; checks that each (rp, k) comes once
    and that each warp's stores of one value go to one CTA and 32 banks."""
    run = 32 // pairs
    assert (rows // 2 * m) % threads == 0 and m % run == 0
    g = np.arange(rows // 2 * m)
    w = g >> 5
    k = (w % (m // run)) * run + (g & (run - 1))
    rp = (w // (m // run)) * pairs + (g & 31) // run
    assert np.unique(rp * m + k).size == g.size
    assert rp.max() == rows // 2 - 1 and k.max() == m - 1
    d0 = stride * k
    d1 = d0 + second
    for d in (d0, d1) if second else (d0,):
        rank = (d // dst_rows).reshape(-1, 32)
        assert (rank == rank[:, :1]).all()
        bank = np.sort((((d % dst_rows) * (dst_pitch // 2) + rp) % 32)
                       .reshape(-1, 32), axis=1)
        assert (bank == np.arange(32)).all()
    return k, rp, d0, d1


def _pack(lo_rows, hi_rows):
    """Two int16 source rows' values -> the 32-bit words, low half first."""
    return (lo_rows.astype(np.uint16).astype(np.uint32)
            | (hi_rows.astype(np.uint16).astype(np.uint32) << 16))


def _unpack(words):
    """(..., w) uint32 -> (..., 2w) int16, low half first."""
    return words.astype("<u4").view("<i2")


def _store(mem, count, rank, local, col, words):
    mem[rank, local, col] = words
    np.add.at(count, (rank, local, col), 1)


def emulate(x, out, ll_back, L):
    """One plane x (n, n) through the kernel's maps; writes out (K10) or
    returns (j, p) (K4).  Reads all of x before any write, as the kernel's
    first cluster.sync() orders it."""
    n, m, R, C = L.n, L.m, L.rows, L.cluster
    lo, hi = (v.numpy().astype(np.int16) for v in analysis.down_iv(
        torch.from_numpy(np.array(x))))
    # 1. the row pass, quarter by quarter, into the owners' rows of j
    js = np.zeros((C, R, L.pitch // 2), np.uint32)
    count = np.zeros(js.shape, np.int64)
    k, rp, d0, d1 = peer_map(L.quarter, m, R, L.pitch, L.threads, 1, m, 4)
    for c in range(C):
        for q in range(4):
            row0 = c * R + q * L.quarter
            r = row0 + 2 * rp
            for d, v in ((d0, lo), (d1, hi)):
                _store(js, count, d // R, d % R, row0 // 2 + rp,
                       _pack(v[r, k], v[r + 1, k]))
    assert (count[..., :n // 2] == 1).all() and not count[..., n // 2:].any()
    jrows = _unpack(js[..., :n // 2])          # (C, R, n)
    # 2-3. one warp per row of j: the column pass over the CTA's rows
    lrs = [w * L.warp_rows + i for w in range(L.threads // 32)
           for i in range(L.warp_rows)]
    assert sorted(lrs) == list(range(R))
    prow = np.empty_like(jrows)
    for c in range(C):
        f = analysis.down_vi if c < C // 2 else analysis.down_53
        prow[c] = torch.cat(f(torch.from_numpy(jrows[c])), -1).to(
            torch.int16).numpy()
    if not ll_back:
        return jrows.reshape(n, n), prow.reshape(n, n)
    # 4. K10: rows below the VI rows and the VI rows' high halves leave;
    # the low halves go through the exchange into the LL rows' owners
    out[m:] = prow[C // 2:].reshape(m, n)
    out[:m, m:] = prow[:C // 2, :, m:].reshape(m, m)
    recv = np.zeros((C, R, L.ll_pitch // 2), np.uint32)
    count = np.zeros(recv.shape, np.int64)
    t, rp, d0, _ = peer_map(R, m, R, L.ll_pitch, L.threads, 1, 0, 4)
    for c in range(C // 2):
        v = prow[c, :, :m]                      # values(r, t) = js[r][t]
        _store(recv, count, d0 // R, d0 % R, c * R // 2 + rp,
               _pack(v[2 * rp, t], v[2 * rp + 1, t]))
    assert (count[:C // 2, :, :m // 2] == 1).all()
    assert not count[C // 2:].any() and not count[..., m // 2:].any()
    out[:m, :m] = _unpack(recv[:C // 2, :, :m // 2]).reshape(m, m)
    return out


@pytest.mark.parametrize("n", [128, 256, 512])
def test_emulated_maps_rebuild_the_twins(n):
    L = Layout(n)
    x = np.concatenate([_inputs("parity chains", 2, n, seed=n + 1),
                        _inputs("int16 extremes", 3, n)[2:3]])
    tx = torch.from_numpy(x)
    want_j, want_p = (a.numpy() for a in dwt.analysis_level_jp_ref(tx))
    want_out = dwt.analysis_level_ref(tx).numpy()
    for i, plane in enumerate(x):
        j, p = emulate(plane, None, False, L)
        np.testing.assert_array_equal(j, want_j[i])
        np.testing.assert_array_equal(p, want_p[i])
        out = emulate(plane, np.full((n, n), 7, np.int16), True, L)
        np.testing.assert_array_equal(out, want_out[i])


@pytest.mark.parametrize("n", [256, 512])
def test_emulated_maps_in_place_on_the_ll_corner(n):
    # the transform's second level: out is x, the LL corner of the
    # level-1 plane
    L, h = Layout(n // 2), n // 2
    l1 = dwt.analysis_level_ref(torch.from_numpy(
        _inputs("last pair, VI/53 switch", 2, n, seed=3))).numpy()
    want = l1.copy()
    want[:, :h, :h] = dwt.analysis_level_ref(torch.from_numpy(
        l1[:, :h, :h].copy())).numpy()
    for plane in l1:
        corner = plane[:h, :h]
        assert emulate(corner, corner, True, L) is corner
    np.testing.assert_array_equal(l1, want)


# (kRows, kM, kDstRows, kDstPitch, kThreads) of each synthesis pass of K2
# and K3 (csrc/dwt.cu): K2's row pass by quarters, K3's 128 level, its
# transpose-back and its 256 level
SYNTH_PASSES = {"K2": (16, 256, 64, 514, 512), "K3 LL": (32, 64, 32, 162, 512),
                "K3 back": (32, 64, 64, 290, 512),
                "K3 256": (64, 128, 64, 258, 512)}


@pytest.mark.parametrize("name", list(SYNTH_PASSES))
def test_synthesis_map_is_unchanged(name):
    # with kStride 2, kSecond 1, kPairs 2 the shared rows_to_peers_t gives
    # K2 and K3 the map they had: 16 k of two row pairs a warp, pair k to
    # rows 2k and 2k + 1 of one CTA, 32 banks
    rows, m, dst_rows, pitch, threads = SYNTH_PASSES[name]
    k, rp, d0, d1 = peer_map(rows, m, dst_rows, pitch, threads, 2, 1, 2)
    g = np.arange(rows // 2 * m)
    w = g >> 5
    np.testing.assert_array_equal(k, (w % (m // 16)) * 16 + (g & 15))
    np.testing.assert_array_equal(rp, (w // (m // 16)) * 2 + ((g >> 4) & 1))
    np.testing.assert_array_equal(d0 // dst_rows, d1 // dst_rows)
