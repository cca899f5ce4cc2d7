"""E1, the codeword chain (``chain_starts_batch``, csrc/entropy.cu
``chain_scan``), in the kernel's decomposition on the CPU, tolerance 0:

- the length table on the peek's top 10 bits, with the segment search in
  the buckets it leaves to it, resolves every 20-bit peek of both zone
  modes to the peek LUT's (len, sym);
- the twin (256-word tiles, the warps' trajectories, the tiles'
  composites, each tile's entry from the prefix before it) equals a plain
  serial walk of each stream (every symbol, the zeros past the last
  start, the count) and the JAX package's pointer-doubling chain (the
  count and the symbols below it, where nbits lies inside the words: the
  JAX chain sticks at the last bit) on streams of 1, 255, 256 and 257
  words (a tile and one word either side), on 300 tiles and a few words,
  in both zone modes, with bit counts off the word grid, at 0 and at and
  past the last word;
- a numpy transcription of the kernel's look-back (warp 0, a lane a
  predecessor, 32 at a time, the composites that are out folded earliest
  first up to the nearest inclusive prefix) finds every tile's entry
  state and rank from the twin's composites, whatever mix of composites,
  prefixes and tiles not yet out it meets.

The segment-cascade JAX chain, the real Y and UV words and streams of
255 words padded to 256: tests/test_torch_entropy_decode.py.
"""

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nhwcodec_tpu.ops import entropy_decode_device as jedd  # noqa: E402
from nhwcodec_tpu_torch.ops import entropy_decode_device as edd  # noqa: E402


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _words(rng, b, nw):
    return rng.integers(0, 1 << 32, (b, nw), dtype=np.uint64).astype(
        np.uint32)


def _serial_chain(words, nbits, zone, s_max):
    """The plain reference: one walk along each stream from bit 0 with
    the peek LUT, every start within the words; (syms (B, s_max) with
    zeros past the last start, the starts below nbits)."""
    b, nw = words.shape
    syms = np.zeros((b, s_max), np.int32)
    counts = np.zeros(b, np.int32)
    for i in range(b):
        bits = np.unpackbits(words[i].astype(">u4").view(np.uint8))
        bits = np.concatenate([bits, np.zeros(edd.PEEK, np.uint8)])
        lut = edd._peek_lut(bool(zone[i]))
        weights = 1 << np.arange(edd.PEEK - 1, -1, -1)
        pos = rank = 0
        while pos < 32 * nw:
            e = int(lut[int(bits[pos: pos + edd.PEEK] @ weights)])
            if rank < s_max:
                syms[i, rank] = e & 0x3FF
            counts[i] += pos < nbits[i]
            rank += 1
            pos += e >> 10
    return syms, counts


def _check_chain(words, nbits, zone, s_max, zero_tail=()):
    """The twin against the plain serial chain (every symbol, the zeros,
    the count) and, where nbits < 32 W, the JAX pointer-doubling chain
    (the count, which it takes over its first s_max codewords only, and
    the symbols below it; the next one too on the rows in
    ``zero_tail``, whose last word is zero: the JAX chain sticks at the
    last bit past the words)."""
    nbits = np.asarray(nbits, np.int32)
    zone = np.asarray(zone, np.int32)
    got_s, got_c = (a.numpy() for a in edd.chain_starts_batch(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(nbits),
        torch.from_numpy(zone), s_max))
    want_s, want_c = _serial_chain(words, nbits, zone, s_max)
    np.testing.assert_array_equal(got_c, want_c)
    np.testing.assert_array_equal(got_s, want_s)
    jax_s, jax_c = (np.asarray(a) for a in jedd._codeword_chain_batch(
        jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zone), s_max))
    for i in np.flatnonzero(nbits < 32 * words.shape[1]):
        assert min(int(got_c[i]), s_max) == jax_c[i]  # JAX: s_max walked
        n = min(int(got_c[i]) + (i in zero_tail), s_max)
        np.testing.assert_array_equal(got_s[i, :n], jax_s[i, :n])
    return got_s, got_c


@pytest.mark.parametrize("zone", [0, 1])
def test_length_table_resolves_every_peek(zone):
    lut = edd._peek_lut(bool(zone))
    peek = torch.arange(1 << edd.PEEK, dtype=torch.int64)
    ln, sym = edd._codes(peek, torch.tensor(zone))
    np.testing.assert_array_equal(ln.numpy(), lut >> 10)
    np.testing.assert_array_equal(sym.numpy(), lut & 0x3FF)
    tab = edd._length_table()[zone]
    assert tab.shape == (1 << edd.LUT_BITS,) and (tab == 0).sum() <= 2
    # a non-zero bucket holds one length
    lens = (lut >> 10).reshape(1 << edd.LUT_BITS, -1)
    ok = tab != 0
    assert np.all(lens[ok].min(1) == lens[ok].max(1))
    assert np.all(lens[ok][:, 0] == tab[ok] & 31)


@pytest.mark.parametrize("nw", [1, 255, 256, 257])
def test_chain_twin_around_a_tile(nw):
    """Streams of a tile of words and one word either side (and of one
    word), both zone modes, bit counts off the word grid; the third
    stream's last word is zero (the layout of ``_pack_words``)."""
    rng = np.random.default_rng(100 + nw)
    words = _words(rng, 3, nw)
    words[2, -1] = 0
    nbits = [max(1, 32 * nw - 5), 16 * nw + 3, max(5, 32 * (nw - 1) - 1)]
    _check_chain(words, nbits, [0, 1, 1], edd._s_max(32 * nw, 1 << 20),
                 zero_tail=(2,))


def test_chain_twin_several_hundred_tiles():
    """300 tiles and 17 words (the look-back far past its 32-tile
    window), both zone modes; the symbols overrun s_max."""
    rng = np.random.default_rng(7)
    nw = 300 * edd.CHAIN_TILE + 17
    words = _words(rng, 2, nw)
    s, c = _check_chain(words, [32 * nw - 11, 32 * nw - 40], [1, 0],
                        1 << 18)
    assert (c > 1 << 18).all() and (s[:, -1] != 0).any()


def test_chain_twin_counts_and_zeros_at_the_ends():
    """nbits 0, 1, at the last word's end and past it; a stream of zero
    words (2-bit codes only); s_max above every chain's starts, whose
    tail the kernel's last tile zeroes."""
    rng = np.random.default_rng(9)
    nw = 257
    words = _words(rng, 5, nw)
    words[4] = 0
    s, c = _check_chain(words, [0, 1, 32 * nw, 32 * nw + 1000, 32 * nw],
                        [0, 1, 0, 1, 0], 1 << 14)
    assert c[0] == 0 and c[1] == 1 and c[4] == 16 * nw
    assert (s[4, 16 * nw:] == 0).all() and (s[:, -1] == 0).all()


def _serial_prefix(agg):
    """(tiles,) entry states and ranks: the tiles' composites applied in
    order from state 0, rank 0."""
    st, rk, out = 0, 0, []
    for a in agg:
        out.append((st, rk))
        v = int(a[st])
        st, rk = v & 0xFFFF, rk + (v >> 16)
    return out


def _look_back(agg, incl, tile, kinds, rng):
    """The kernel's look-back of ``tile`` (warp 0 of chain_scan), lane by
    lane: kinds[j] is what the warp reads of predecessor j, its status
    word and composite loaded at once (0 neither out yet, 1 its composite,
    2 its inclusive (state, rank) ``incl[j]``); a tile not yet out is out
    by the warp's next read (a spin).  Returns (entry state, entry rank,
    windows walked)."""
    lanes = np.arange(32)
    g_state, g_rank, base, windows = lanes.copy(), np.zeros(32, int), tile, 0
    while True:
        windows += 1
        pj = base - 1 - lanes
        kind = np.where(pj >= 0, kinds[np.maximum(pj, 0)], 2)
        ready, inc = kind != 0, kind == 2
        run = 32 if ready.all() else int(np.argmin(ready))
        first = int(np.argmax(inc)) if inc.any() else 32
        n = min(first, run)
        s, r = lanes.copy(), np.zeros(32, int)
        for i in range(n - 1, -1, -1):
            a = np.zeros(32, np.int64)
            a[:edd.MAXST] = agg[base - 1 - i]
            v = a[s]
            s, r = v & 0xFFFF, r + (v >> 16)
        g_state, g_rank = g_state[s], r + g_rank[s]
        base -= n
        if first < run:
            j = base - 1
            in_s, in_r = incl[j] if j >= 0 else (0, 0)
            return int(g_state[in_s]), int(in_r + g_rank[in_s]), windows
        # what was not out is out by the next read
        for j in range(max(base - 32, 0), base):
            if kinds[j] == 0:
                kinds[j] = 1 + (rng.random() < 0.3)


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_look_back_transcription(trial):
    rng = np.random.default_rng(20 + trial)
    nw = 90 * edd.CHAIN_TILE - 3
    words = _words(rng, 1, nw)
    agg = edd.chain_tile_composites(
        torch.from_numpy(words.view(np.int32)),
        torch.tensor([trial & 1], dtype=torch.int32))[0].numpy()
    want = _serial_prefix(agg)
    incl = []
    for a, (st, rk) in zip(agg, want):
        v = int(a[st])
        incl.append((v & 0xFFFF, rk + (v >> 16)))
    far = 0
    for tile in range(1, len(agg)):
        # inclusive prefixes out with probability 0.4 (none at trial 0
        # but tile 0's), composites the rest, a few not yet
        p_incl = (0.0, 0.4, 0.05)[trial]
        kinds = np.where(rng.random(tile) < p_incl, 2, 1)
        kinds[rng.random(tile) < 0.1] = 0
        kinds[0] = max(kinds[0], 0)
        got_s, got_r, windows = _look_back(agg, incl, tile, kinds, rng)
        assert (got_s, got_r) == want[tile], tile
        far = max(far, windows)
    assert far >= (3 if trial == 0 else 1)
