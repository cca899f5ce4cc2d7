"""Device Huffman decode of the Y and UV symbol planes, in torch.

Port of ``nhwcodec_tpu.ops.entropy_decode_device`` and
``nhwcodec_tpu.ops.entropy_chain_scan``, with the same public names and
results equal to the host copy's ``entropy.decode_y`` / ``decode_uv``
(the serial bit-cursor automata of decoder/compress_pixel.c:49-641):

1. **Codeword chain** (``chain_starts_batch``, kernel E1 ``chain_starts``
   in ``csrc/entropy.cu``).  The static code's 2^20 peek space is 26 (zone
   mode: 28) segments on which the length is constant and the symbol
   affine in the peek (``_segments``), so the (length, symbol) at a bit
   is one lookup on the peek's top 10 bits (``_length_table``), or a
   binary search over at most 32 thresholds in the buckets that span
   several segments.  The state of the chain at a 32-bit word boundary is
   the overhang of the current codeword into the word, one of 20 values;
   each word's transfer function over those 20 states composes
   associatively along the stream.  The kernel is one pass over tiles of
   256 words with decoupled look-back: each tile builds its words'
   functions once, publishes its composite, composes its predecessors'
   composites up to the nearest published prefix, and walks each word
   from its entry overhang, emitting the codeword starts at their ranks.
2. **Y automaton**, only at the run symbols: a literal's effect on the
   automaton is static (it resets the run counters and shifts known
   non-zero values into the 5-output window), so torch ops compute the
   per-symbol book fields, the static advance prefix, a 5-cell window
   summary of the literals before each run and the per-run input tuples
   (``_runs_xs_batch``).  The runs themselves are cut into K chunks and
   solved as a fixpoint of a chunk relay (``runs_fixpoint``, kernel E2
   ``y_runs_fixpoint``): the insert count crosses every chunk in one
   sweep as an exclusive prefix of the chunks' local counts, the rest of
   the carry by a one-chunk shift, until nothing changes or K + 1 sweeps
   have run.  Chunk 0 is pinned to the initial state, so a fixpoint is
   the sequential solution; a batch that hits the K + 1 bound is run
   again at K = 1, one chunk, the sequential automaton.  One scatter then
   writes the literals and the inserted select values (``_runs_emit``).
3. **UV** has no history rules: an exclusive cumsum of the advances and
   one scatter (``_uv_scatter_batch``).

Each wrapper launches its CUDA kernel for CUDA tensors and raises if that
fails; it takes its torch twin (``*_ref``, the same decomposition) only
for tensors on the CPU.  Launches are counted in
``kernels.build.LAUNCHES``.  The tables are built here from the port's
copy of the codec tables (``host.tables``).
"""

from __future__ import annotations

import functools

import numpy as np
import torch

from nhwcodec_tpu_torch.device import resolve_device
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.ops import entropy
from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.kernels.build import check_arg as _check
from nhwcodec_tpu_torch.kernels.build import cuda_args as _cuda_args

PEEK = 20           # longest code (HUFFMAN_LENS.max() == 20; zone escape 15)
MAXST = 20          # overhang states at a word boundary
WSTEPS = 16         # most codeword starts in a 32-bit word (shortest code 2)
NSEG = 32           # segment table size the binary search walks
CHAIN_TILE = 256    # words per CTA of E1 (csrc/entropy.cu kTile)
CHAIN_WARP = 32     # words a warp of E1's tile
LUT_BITS = 10       # the peek's bits E1's length table is indexed by
MAX_CHUNKS = 1024   # E2 runs one thread a chunk, a cluster a stream
K_CHUNKS = 512      # decode_y_planes' default chunks a stream: the fastest
                    # k of 64-1024 for E2 on a q20 chunk of 16 (H100)
FIX_CLUSTER = 8     # E2's most CTAs a stream (csrc/entropy.cu kFixCluster)
FIX_SMEM = 220 * 1024   # E2's staged tuples a CTA, bytes (kFixSmemMax)
Y_P1 = 4 * T.IM_SIZE
UV_P1 = 2 * T.IM_SIZE - 1


# ---------------------------------------------------------------------------
# static tables (host, built once)


@functools.lru_cache(maxsize=2)
def _peek_lut(zone_on: bool) -> np.ndarray:
    """peek20 -> sym | (len << 10): every table code maps to its index
    (zone mode shifts indices >= ZONE1 by UNZONE1, and the 9-bit 0x1
    prefix opens the 15-bit zone escape, which shadows its range,
    decoder/compress_pixel.c:141-158, 284-287)."""
    lut = np.full(1 << PEEK, 1 << 10, np.int32)
    codes = T.HUFFMAN_CODES.astype(np.int64)
    lens = T.HUFFMAN_LENS.astype(np.int64)
    for j in range(290):
        c, ln = int(codes[j]), int(lens[j])
        sym = j + T.UNZONE1 if (zone_on and j >= T.ZONE1) else j
        lo = c << (PEEK - ln)
        lut[lo: lo + (1 << (PEEK - ln))] = sym | (ln << 10)
    if zone_on:
        # escape: 000000001 kkkkkk ...... -> sym ZONE1 + k, len 15
        base = 1 << (PEEK - 9)
        for k in range(64):
            lo = base + (k << (PEEK - 15))
            lut[lo: lo + (1 << (PEEK - 15))] = (T.ZONE1 + k) | (15 << 10)
    return lut


@functools.lru_cache(maxsize=1)
def _y_word_tables() -> tuple[np.ndarray, ...]:
    """Per-word behaviour of the Y automaton's literals
    (decoder/compress_pixel.c:343-437): value at e, second value at e+4,
    whether there is one, cursor advance, mem2 set."""
    val1 = np.zeros(256, np.int32)
    val2 = np.zeros(256, np.int32)
    has2 = np.zeros(256, np.int32)
    adv = np.ones(256, np.int32)
    mem2 = np.zeros(256, np.int32)
    extra = np.concatenate([T.EXTRA_TABLE.astype(np.int32), [0]])
    fixed = {127: 1008, 129: 1009, 125: 1006, 126: 1007, 121: 1010,
             122: 1011, 124: 11, 123: -11}
    for w in range(256):
        if w in (136, 120):
            val1[w], mem2[w] = (11 if w == 136 else -11), 1
        elif w in (132, 133, 134, 135):
            val1[w] = 11 if w in (132, 133) else -11
            val2[w] = 11 if w in (132, 134) else -11
            has2[w], adv[w] = 1, 5
        elif w in fixed:
            val1[w] = fixed[w]
        elif w < T.ZONE1 and extra[w]:
            x = int(extra[w])
            val1[w] = (T.WVLT_ENERGY_NHW + (x << 3) if x > 0
                       else (x << 3) - T.WVLT_ENERGY_NHW)
        elif w > 0x80:
            val1[w] = w - T.INV_QUANT1
        else:
            val1[w] = w - T.INV_QUANT2
    return val1, val2, has2, adv, mem2


@functools.lru_cache(maxsize=1)
def _y_word_tables_packed() -> np.ndarray:
    """The five word tables in one int32 a word: val1 + 2048 in bits
    0-11, val2 code in 12-13 (0: 0, 1: +11, 2: -11), has2 bit 14,
    advance 5 bit 15, mem2 bit 16."""
    val1, val2, has2, adv, mem2 = _y_word_tables()
    assert val1.min() >= -2048 and val1.max() < 2048
    v2code = np.where(val2 == 0, 0, np.where(val2 > 0, 1, 2))
    return ((val1 + 2048) | (v2code << 12) | (has2 << 14)
            | ((adv == 5).astype(np.int32) << 15)
            | (mem2 << 16)).astype(np.int32)


@functools.lru_cache(maxsize=1)
def _uv_word_table() -> np.ndarray:
    """UV literal value per word (decoder/compress_pixel.c:575-637)."""
    val = np.zeros(256, np.int32)
    extra = np.concatenate([T.EXTRA_TABLE.astype(np.int32), [0]])
    fixed = {124: 5005, 126: 5006, 122: 5003, 130: 5004}
    for w in range(256):
        if w < T.ZONE1:
            x = int(extra[w])
            if x:
                val[w] = (T.WVLT_ENERGY_NHW + (x << 3) if x > 0
                          else (x << 3) - T.WVLT_ENERGY_NHW)
            else:
                val[w] = w - T.INV_QUANT2
        elif w in fixed:
            val[w] = fixed[w]
        elif w > 0x80:
            val[w] = w - T.INV_QUANT1
        else:
            val[w] = w - T.INV_QUANT2
    return val


@functools.lru_cache(maxsize=2)
def _segments(zone_on: bool):
    """(thresholds, lens, bases): the affine segments of ``_peek_lut``.
    For the segment with the greatest threshold <= peek, len = lens[s]
    and sym = bases[s] + (peek >> (20 - len))."""
    lut = _peek_lut(zone_on)
    lens = (lut >> 10).astype(np.int64)
    # MAXST and WSTEPS rest on code lengths in [2, 20]; a word walk that
    # under-steps would corrupt the chain silently
    assert int(lens.min()) >= 2 and int(lens.max()) <= MAXST, (
        f"Huffman code lengths [{lens.min()}, {lens.max()}] outside the "
        f"[2, {MAXST}] range assumed by MAXST/WSTEPS")
    syms = (lut & 0x3FF).astype(np.int64)
    base = syms - (np.arange(1 << PEEK) >> (PEEK - lens))
    key = (lens << 32) | (base & 0xFFFFFFFF)
    starts = np.concatenate([[0], np.nonzero(np.diff(key))[0] + 1])
    return (starts.astype(np.int64), lens[starts].astype(np.int32),
            base[starts].astype(np.int32))


@functools.lru_cache(maxsize=1)
def _seg_search_table() -> np.ndarray:
    """(2, 3, NSEG) int32: each zone's thresholds, lens and bases.  Both
    zones are padded to the longer one's segment count by repeating their
    last segment (the JAX package's ``_seg_tables``), then to NSEG with
    thresholds of 2^20, above every peek, so a 5-step binary search finds
    the greatest threshold <= peek."""
    segs = [_segments(zone) for zone in (False, True)]
    s = max(len(thr) for thr, _, _ in segs)
    assert s <= NSEG
    out = np.zeros((2, 3, NSEG), np.int32)
    for z, cols in enumerate(segs):
        for i, a in enumerate(cols):
            out[z, i, :len(a)] = a
            out[z, i, len(a):] = a[-1]
    out[:, 0, s:] = 1 << PEEK
    return out


@functools.lru_cache(maxsize=None)
def _seg_device(dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(_seg_search_table()).to(dev)


@functools.lru_cache(maxsize=1)
def _length_table() -> np.ndarray:
    """(2, 2^LUT_BITS) int32: per zone, the code at each bucket of the
    peek's top LUT_BITS bits as len | base << 5 (the symbol is base +
    (peek >> (20 - len))), or 0 where the bucket spans several segments
    and the binary search decides (two buckets of 1024 a zone)."""
    tab = _seg_search_table().astype(np.int64)
    lo = np.arange(1 << LUT_BITS, dtype=np.int64) << (PEEK - LUT_BITS)
    hi = lo + (1 << (PEEK - LUT_BITS)) - 1
    out = np.zeros((2, 1 << LUT_BITS), np.int32)
    for z in range(2):
        thr, ln, base = tab[z]
        s_lo = np.searchsorted(thr, lo, side="right") - 1
        s_hi = np.searchsorted(thr, hi, side="right") - 1
        out[z] = np.where(s_lo == s_hi, ln[s_lo] | (base[s_lo] << 5), 0)
    return out


@functools.lru_cache(maxsize=None)
def _lut_device(dev: torch.device) -> torch.Tensor:
    return torch.from_numpy(_length_table()).to(dev)


def _lens_syms(peek: torch.Tensor, zone: torch.Tensor):
    """(len, sym) int32 at each peek (int64 in [0, 2^20)) by the segment
    search; ``zone`` broadcasts against ``peek`` (non-zero: zone mode)."""
    tab = _seg_device(peek.device)
    # one search over both zones: zone 1's thresholds lifted by 2^20
    thr = (tab[:, 0].to(torch.int64)
           + (torch.arange(2, device=peek.device)[:, None] << PEEK))
    seg = torch.searchsorted(thr.reshape(-1),
                             (peek + ((zone != 0).to(torch.int64) << PEEK))
                             .contiguous(), right=True) - 1
    ln = tab[:, 1].reshape(-1)[seg]
    sym = tab[:, 2].reshape(-1)[seg] + (peek >> (PEEK - ln)).to(torch.int32)
    return ln, sym


def _codes(peek: torch.Tensor, zone: torch.Tensor):
    """(len, sym) int64 at each peek as E1 finds them: the length table's
    entry on the peek's top bits, the segment search where it is 0."""
    e = _lut_device(peek.device).to(torch.int64)[
        (zone != 0).to(torch.int64), peek >> (PEEK - LUT_BITS)]
    ln_s, sym_s = _lens_syms(peek, zone)
    ln = torch.where(e == 0, ln_s.to(torch.int64), e & 31)
    sym = torch.where(e == 0, sym_s.to(torch.int64),
                      (e >> 5) + (peek >> (PEEK - ln)))
    return ln, sym


def _check_book(vals: list, rles: list, kind: str) -> None:
    """Reject, on the host and before any launch, a codebook whose run
    words do not advance the cursor by 1..255: the emit scatters rely on
    every symbol advancing it (distinct positions), and the per-run
    packing holds rle in 8 bits (the format's run lengths are one byte,
    encoder/nhw_encoder.c:2220-2252; runs count from 1,
    encoder/compress_pixel.c:280-361)."""
    if any(r < 1 for r in rles):
        raise ValueError(
            f"malformed .nhw: {kind} codebook contains a run word with "
            "rle < 1 (device decode requires cursor-advancing symbols)")
    if any(r > 255 for r in rles):
        raise ValueError(
            f"malformed .nhw: {kind} codebook run length > 255")


# ---------------------------------------------------------------------------
# E1: the codeword chain


def _word_peeks(words: torch.Tensor) -> torch.Tensor:
    """(B, W) int32 code words -> (B, W, 32) int64 20-bit peeks at every
    bit offset of every word (words past the end read as zeros)."""
    wd = words.to(torch.int64) & 0xFFFFFFFF
    nxt = torch.nn.functional.pad(wd[:, 1:], (0, 1))
    k = torch.arange(32, device=words.device)
    win = (((wd[..., None] << k) & 0xFFFFFFFF)
           | (nxt[..., None] >> (32 - k)))
    return win >> (32 - PEEK)


def _chain_tiles(words: torch.Tensor, zone: torch.Tensor):
    """E1's per-tile work: each offset's code, each word's walk from
    every offset, the warps' trajectories, the tiles' warp entries and
    composites.  Returns (ln, sym (B, W, 32), traj (B, tiles, 8, 32, 20),
    warp_in (B, tiles, 8, 20), agg (B, tiles, 20)), int64."""
    b, w = words.shape
    dev = words.device
    i64 = torch.int64
    ln, sym = _codes(_word_peeks(words), zone[:, None, None])
    f = torch.zeros((b, w, 32), dtype=i64, device=dev)
    for p in range(31, -1, -1):
        q = p + ln[..., p]
        inner = torch.gather(f, -1, q.clamp(max=31)[..., None])[..., 0]
        f[..., p] = torch.where(q >= 32, (q - 32) | 256, inner + 256)
    tiles = -(-w // CHAIN_TILE)
    warps = CHAIN_TILE // CHAIN_WARP
    states = torch.arange(MAXST, dtype=i64, device=dev)
    fn = torch.cat([f[..., :MAXST],
                    states.expand(b, tiles * CHAIN_TILE - w, MAXST)], 1)
    fn = fn.reshape(b, tiles, warps, CHAIN_WARP, MAXST)
    s = states.expand(b, tiles, warps, MAXST)
    starts = torch.zeros_like(s)
    traj = []
    for i in range(CHAIN_WARP):
        v = torch.gather(fn[:, :, :, i], -1, s)
        starts = starts + (v >> 8)
        s = v & 0xFF
        traj.append(s | starts << 5)
    traj = torch.stack(traj, 3)                  # (B, tiles, 8, 32, 20)
    warp_fn = s | starts << 8
    s = states.expand(b, tiles, MAXST)
    starts = torch.zeros_like(s)
    warp_in = []
    for v in range(warps):
        warp_in.append(s | starts << 8)
        x = torch.gather(warp_fn[:, :, v], -1, s)
        starts = starts + (x >> 8)
        s = x & 0xFF
    warp_in = torch.stack(warp_in, 2)            # (B, tiles, 8, 20)
    agg = s | starts << 16                       # (B, tiles, 20)
    return ln, sym, traj, warp_in, agg


def chain_tile_composites(words: torch.Tensor, zone: torch.Tensor):
    """(B, tiles, 20) int64: each tile's composite as E1 publishes it,
    exit state | starts << 16 from each entry state."""
    return _chain_tiles(words, zone)[4]


def chain_starts_ref(words: torch.Tensor, nbits: torch.Tensor,
                     zone: torch.Tensor, s_max: int):
    """Torch twin of E1 in the kernel's decomposition: each offset's code
    (``_codes``); each word's walk from every offset, right to left (exit
    overhang | starts << 8; offsets 0-19 are its transfer function); tiles
    of CHAIN_TILE words, 8 warps of 32: each warp's words walked from every
    entry state (the trajectory: state after each word | starts since the
    warp's entry << 5), each tile's warps from every tile entry state, the
    tile's composite (exit | starts << 16); each tile's entry (state, rank)
    the inclusive prefix of the tile before it, which the kernel's
    look-back reaches by composing the published composites back to the
    nearest inclusive one; every word's entry state and rank two lookups
    in the trajectories (its rank the tile's, its warp's offset in the
    tile and its own in the warp: the kernel writes a warp's symbols at
    the last into a run it copies to the tile's ranks); each word walked
    from it, its starts' symbols scattered at their ranks below s_max
    (zeros after the last start); the count from the word holding bit
    nbits.  Returns (syms (B, s_max) int32,
    counts (B,) int32)."""
    b, w = words.shape
    dev = words.device
    i64 = torch.int64
    tiles = -(-w // CHAIN_TILE)
    warps = CHAIN_TILE // CHAIN_WARP
    ln, sym, traj, warp_in, agg = _chain_tiles(words, zone)
    e_state = torch.zeros(b, dtype=i64, device=dev)
    e_rank = torch.zeros(b, dtype=i64, device=dev)
    ent_s, ent_r = [], []
    for t in range(tiles):
        ent_s.append(e_state)
        ent_r.append(e_rank)
        out = torch.gather(agg[:, t], -1, e_state[:, None])[:, 0]
        e_rank = e_rank + (out >> 16)
        e_state = out & 0xFFFF
    ent_s, ent_r = torch.stack(ent_s, 1), torch.stack(ent_r, 1)
    wi = torch.gather(warp_in, -1, ent_s[:, :, None, None].expand(
        b, tiles, warps, 1))[..., 0]             # (B, tiles, 8)
    ws = wi & 0xFF
    tv = torch.gather(traj, -1, ws[..., None, None].expand(
        b, tiles, warps, CHAIN_WARP, 1))[..., 0]   # (B, tiles, 8, 32)
    word_state = torch.cat([ws[..., None], tv[..., :-1] & 31], -1)
    word_rank = (ent_r[..., None, None] + (wi >> 8)[..., None]
                 + torch.nn.functional.pad(tv[..., :-1] >> 5, (1, 0)))
    word_state = word_state.reshape(b, -1)[:, :w]
    word_rank = word_rank.reshape(b, -1)[:, :w]
    # each word walked from its entry: up to WSTEPS starts
    offs = torch.arange(32 + MAXST, device=dev)
    step = torch.cat([offs[:32] + ln, offs[32:].expand(b, w, MAXST)], -1)
    pos, positions = word_state[..., None], []
    for _ in range(WSTEPS):
        positions.append(pos)
        pos = torch.gather(step, -1, pos)
    pos_s = torch.cat(positions, -1)             # (B, W, 16)
    valid = pos_s < 32
    sym_s = torch.gather(sym, -1, pos_s.clamp(max=31))
    rank = word_rank[..., None] + torch.arange(WSTEPS, device=dev)
    idx = torch.where(valid & (rank < s_max), rank, s_max)
    out = torch.zeros((b, s_max + 1), dtype=torch.int32, device=dev)
    out.scatter_(1, idx.reshape(b, -1), sym_s.to(torch.int32).reshape(b, -1))
    lim = nbits.to(i64)
    jw = torch.clamp(lim >> 5, 0, w - 1)[:, None]
    gpos = jw[..., None] * 32 + torch.gather(pos_s, 1, jw[..., None].expand(
        b, 1, WSTEPS))
    below = (torch.gather(valid, 1, jw[..., None].expand(b, 1, WSTEPS))
             & (gpos < lim[:, None, None])).sum((1, 2))
    counts = torch.gather(word_rank, 1, jw)[:, 0] + below
    return out[:, :s_max].contiguous(), counts.to(torch.int32)


def chain_starts_batch(words: torch.Tensor, nbits: torch.Tensor,
                       zone: torch.Tensor, s_max: int):
    """Every codeword of each stream's chain from bit 0 (E1).

    words: (B, W) int32, the packed big-endian u32 code words, zero
    beyond each stream (codewords there decode as the all-zeros prefix);
    nbits: (B,) int32 bit counts; zone: (B,) int32, non-zero for the
    zone mode.
    Returns (syms (B, s_max) int32: the s-th codeword's symbol at s,
    zeros past the chain's last start in W words; counts (B,) int32: the
    starts below nbits).  On the card: a fill of the look-back state and
    one launch of ``chain_scan``."""
    _check(words, "chain_starts words", torch.int32, (None, None))
    _check(nbits, "chain_starts nbits", torch.int32, (words.shape[0],))
    _check(zone, "chain_starts zone", torch.int32, (words.shape[0],))
    if not all(a.is_contiguous() for a in (words, nbits, zone)):
        raise ValueError("chain_starts: inputs must be contiguous")
    if s_max < 1:
        raise ValueError(f"chain_starts: s_max {s_max} < 1")
    if all(a.device.type == "cpu" for a in (words, nbits, zone)):
        return chain_starts_ref(words, nbits, zone, s_max)
    lib, stream = _cuda_args(words, nbits, zone)
    b, w = words.shape
    dev = words.device
    if not (b and w):
        return (torch.zeros((b, s_max), dtype=torch.int32, device=dev),
                torch.zeros(b, dtype=torch.int32, device=dev))
    syms = torch.empty((b, s_max), dtype=torch.int32, device=dev)
    counts = torch.empty(b, dtype=torch.int32, device=dev)
    tiles = -(-w // CHAIN_TILE)
    # one fill zeroes the look-back's words: the ticket and the status
    # words (u64), then the composites at a 16-byte boundary
    head = -(-(1 + b * tiles) // 2) * 2
    scratch = torch.zeros(head + b * tiles * MAXST // 2, dtype=torch.int64,
                          device=dev)
    state, agg = scratch[:head], scratch[head:]
    with torch.cuda.device(dev):
        build.check("nhw_chain_starts", lib.nhw_chain_starts(
            words.data_ptr(), nbits.data_ptr(), zone.data_ptr(),
            _seg_device(dev).data_ptr(), _lut_device(dev).data_ptr(),
            state.data_ptr(), agg.data_ptr(), syms.data_ptr(),
            counts.data_ptr(), b, w, s_max, stream))
    build.count("chain_starts")
    return syms, counts


def _pack_words(packets: list, dev) -> tuple[torch.Tensor, torch.Tensor]:
    """The streams' u32 packets as one zero-padded (B, W) int32 tensor
    with W = longest + 1 (the chain's first start past a stream's end
    lies in that zero word) and the (B,) bit counts."""
    w = max(p.size for p in packets) + 1
    out = np.zeros((len(packets), w), np.uint32)
    for i, p in enumerate(packets):
        out[i, :p.size] = p
    nbits = np.asarray([p.size * 32 for p in packets], np.int32)
    return (torch.from_numpy(out.view(np.int32)).to(dev),
            torch.from_numpy(nbits).to(dev))


def _s_max(nbits_max: int, cap: int) -> int:
    """Symbols kept per stream: at least half the bits (2-bit codes),
    at most ``cap``, a power of two."""
    s = min(cap, max(64, nbits_max // 2 + 2))
    return 1 << (s - 1).bit_length()


def _pad_rows(rows, dev) -> torch.Tensor:
    """Ragged int rows -> (B, n) int32, zero-padded, n a power of two
    >= 64 (the JAX package's padding of books and select bits)."""
    n = 1 << max(6, (max(len(r) for r in rows) - 1).bit_length())
    out = np.zeros((len(rows), n), np.int32)
    for i, r in enumerate(rows):
        out[i, :len(r)] = r
    return torch.from_numpy(out).to(dev)


# ---------------------------------------------------------------------------
# Y: per-symbol fields, window summary and per-run tuples (torch ops)


def _y_book_rows(books: list, dev) -> torch.Tensor:
    """Per-stream book entries, one int32 each: word fields (packed
    table) << 10 | rle << 1 | is_run."""
    pk = _y_word_tables_packed()
    rows = [(pk[np.clip(np.asarray(v, np.int64), 0, 255)].astype(np.int64)
             << 10) | (np.asarray(r, np.int64) << 1)
            | (np.asarray(v) == 0x80) for v, r in books]
    return _pad_rows(rows, dev)


def _y_fields(syms: torch.Tensor, book: torch.Tensor) -> dict:
    """Per-symbol book lookup (one gather) and unpacked fields."""
    pe = torch.gather(book, 1, syms.clamp(0, book.shape[1] - 1).long())
    f = pe >> 10
    v2c = (f >> 12) & 3
    return {"is_run": (pe & 1) == 1, "rle": (pe >> 1) & 511,
            "wv1": (f & 0xFFF) - 2048,
            "wv2": torch.where(v2c == 1, 11, torch.where(v2c == 2, -11, 0)),
            "whas2": (f >> 14) & 1,
            "wadv": torch.where(((f >> 15) & 1) == 1, 5, 1),
            "wmem2": (f >> 16) & 1}


def _runs_window(is_run: torch.Tensor, wadv: torch.Tensor):
    """The literal window summary at each symbol: (m, c), m bit j-1 set
    where the j-th last cell the literals since the last run emitted is
    non-zero, c their cells clipped at 5; (0, 0) at a run.  Every literal
    emits at least one cell, so five shifted elementwise passes over
    symbols i, i-1, ..., i-4, stopped at a run, give what the JAX
    package's segmented associative scan (``_runs_seg_scan``) gives."""
    lit_mask = torch.where(wadv == 5, 17, 1)
    lit_cnt = torch.where(wadv == 5, 5, 1)
    m = torch.zeros_like(lit_mask)
    c = torch.zeros_like(lit_cnt)
    alive = torch.ones_like(is_run)
    for t in range(5):
        run_t = torch.nn.functional.pad(is_run[:, :is_run.shape[1] - t],
                                        (t, 0), value=True)
        alive = alive & ~run_t
        mk = torch.nn.functional.pad(lit_mask[:, :lit_mask.shape[1] - t],
                                     (t, 0))
        ck = torch.nn.functional.pad(lit_cnt[:, :lit_cnt.shape[1] - t],
                                     (t, 0))
        m = torch.where(alive, m | (mk << c.clamp(max=5)), m)
        c = torch.where(alive, c + ck, c)
    return m & 31, c.clamp(max=5)


def _runs_xs_batch(syms: torch.Tensor, book: torch.Tensor, p1: int,
                   r_max: int, k: int):
    """Per-run input tuples of the fixpoint, time-major.

    syms: (B, s_len) symbols; book: ``_y_book_rows``.  The first
    ``r_max`` runs of each stream, padded with invalid runs to k * L,
    chunk c of stream b holding runs [c L, (c+1) L) in lane b k + c.
    Returns ((ebase (L, B k) int32, fields (L, B k) int32), lits) with
    fields = rle | segm << 8 | segc << 13 | prev_run << 16 |
    prev_lit_mem2 << 17 | valid << 18, and lits the per-symbol arrays the
    emit needs."""
    b, s_len = syms.shape
    dev = syms.device
    f = _y_fields(syms, book)
    is_run, rle = f["is_run"], f["rle"]
    run_i = is_run.to(torch.int32)
    adv = torch.where(is_run, rle, f["wadv"])
    base_e = (torch.cumsum(adv, 1, dtype=torch.int32) - adv).to(torch.int32)
    runs_before = torch.cumsum(run_i, 1, dtype=torch.int32) - run_i
    segm, segc = _runs_window(is_run, f["wadv"])

    length = -(-r_max // k)
    r_pad = k * length
    # rank placement: run j of stream b at column j (runs past r_pad and
    # the literals go to a dropped column)
    tgt = torch.where(is_run & (runs_before < r_pad), runs_before, r_pad)
    run_idx = torch.full((b, r_pad + 1), s_len, dtype=torch.int64,
                         device=dev)
    run_idx.scatter_(1, tgt.long(), torch.arange(
        s_len, device=dev).expand(b, s_len).contiguous())
    run_idx = run_idx[:, :r_pad]
    vld = run_idx < s_len
    ri = run_idx.clamp(max=s_len - 1)
    packed = (rle | (run_i << 8) | (f["wmem2"] << 9) | (segm << 10)
              | (segc << 15))
    pk_ri = torch.gather(packed, 1, ri)
    pk_prev = torch.gather(packed, 1, (ri - 1).clamp(min=0))
    has_prev = (run_idx > 0) & vld
    prev_is_run = ((pk_prev >> 8) & 1) == 1
    fields = (torch.where(vld, pk_ri & 0xFF, 0)
              | torch.where(has_prev, ((pk_prev >> 10) & 31) << 8, 0)
              | torch.where(has_prev, ((pk_prev >> 15) & 7) << 13, 0)
              | (has_prev & prev_is_run).to(torch.int64) << 16
              | torch.where(has_prev & ~prev_is_run,
                            ((pk_prev >> 9) & 1) << 17, 0)
              | vld.to(torch.int64) << 18)
    ebase = torch.where(vld, torch.gather(base_e, 1, ri),
                        p1 + (1 << 20))

    def time_major(a):
        return a.to(torch.int32).reshape(b * k, length).t().contiguous()

    lits = {"is_run": is_run, "base_e": base_e, "runs_before": runs_before,
            "wv1": f["wv1"], "wv2": f["wv2"], "whas2": f["whas2"]}
    return (time_major(ebase), time_major(fields)), lits


def unpack_run_fields(fields: torch.Tensor) -> dict:
    """The per-run fields of ``_runs_xs_batch`` by name."""
    return {"rle": fields & 0xFF, "segm": (fields >> 8) & 31,
            "segc": (fields >> 13) & 7, "prev_run": ((fields >> 16) & 1) == 1,
            "prev_lit_mem2": (fields >> 17) & 1,
            "valid": ((fields >> 18) & 1) == 1}


# ---------------------------------------------------------------------------
# E2: the Y run automaton's chunk-relay fixpoint


def _run_steps(ebase: torch.Tensor, fields: torch.Tensor) -> list:
    """The carry-independent parts of each run's step: one dict of (n,)
    tensors a run, from the (L, n) per-run tuples."""
    x = unpack_run_fields(fields)
    rle = x.pop("rle")
    x.update(ebase=ebase, rle4=rle >= 4, is254=rle == 254,
             ac1_new=(rle == 254).to(torch.int32), rle5=rle.clamp(max=5),
             room=257 - rle)
    cols = {key: v.unbind(0) for key, v in x.items()}
    return [dict(zip(cols, t)) for t in zip(*cols.values())]


def runs_step(carry: tuple, x: dict, p1: int):
    """One run of the automaton over all lanes (decoder/compress_pixel.c:
    296-341 at a run word, with the literals since the last run folded
    into the window summary): carry (ins_cnt, mem, mem2, ac1, run_over,
    win) and the run's ``_run_steps`` entry -> (new carry, ev1, ev2,
    e_in).  Bit j - 1 of the window is set where the output j back is
    non-zero."""
    ins_cnt, mem_c, mem2_c, ac1_c, run_over, win_c = carry
    e_in = x["ebase"] + ins_cnt
    act = x["valid"] & (e_in < p1 - 1)
    prun = x["prev_run"]
    mem_in = torch.where(prun, mem_c, 0)
    mem2_in = torch.where(prun, mem2_c, x["prev_lit_mem2"])
    ac1_in = torch.where(prun, ac1_c, 0)
    win_in = (x["segm"] | (win_c << x["segc"])) & 31
    m2 = mem2_in == 1
    # the long run's insert (rle >= 4, output 1 back zero) and, right
    # after a run that inserted, the one with outputs 1..4 back zero; both
    # need room past run_over and no 254-run just before
    long_run = x["rle4"] & (e_in > 0) & ((win_in & 1) == 0)
    ev1 = (act & ~m2 & (ac1_in == 0) & (e_in - run_over >= x["room"])
           & (long_run | ((mem_in == 1) & (e_in >= 4)
                          & ((win_in & 15) == 0))))
    ev2 = act & m2 & (((e_in >= 5) & ((win_in & 30) == 0))
                      | (x["rle4"] & (e_in >= 2) & ((win_in & 2) == 0)))
    ins = (ev1 | ev2).to(torch.int32)
    is254 = x["is254"]
    # mem is read only through mem == 1 a run later, so it saturates at 2
    mem_new = torch.where(is254, 0, torch.where(ev1, 1, (mem_in + 1).clamp(
        max=2)))
    win_new = (((win_in << ins) | ins) << x["rle5"]) & 31
    new = (ins_cnt + ins, torch.where(act, mem_new, mem_c),
           torch.where(act, torch.where(m2, 0, mem2_in), mem2_c),
           torch.where(act, x["ac1_new"], ac1_c),
           torch.where(act & is254, e_in + ins, run_over),
           torch.where(act, win_new, win_c))
    return new, ev1, ev2, e_in


def fixpoint_layout(length: int, k: int):
    """E2's launch shape for (L, B k) tuples, as ``nhw_y_runs_fixpoint``
    computes it: (cluster, chunks a CTA, rows staged in shared memory).
    A cluster of min(k, FIX_CLUSTER) CTAs a stream, the chunks split in
    blocks of ceil(k / cluster); each CTA stages the rows of its chunks'
    tuples (8 bytes a run) that fit FIX_SMEM bytes, and its walks read
    the rest from global memory: the k = 1 fallback's one CTA stages
    28,160 runs, a q20 stream has some 78,000."""
    cluster = min(k, FIX_CLUSTER)
    cpc = -(-k // cluster)
    return cluster, cpc, min(length, FIX_SMEM // (8 * cpc))


def runs_fixpoint_ref(ebase: torch.Tensor, fields: torch.Tensor, p1: int,
                      k: int):
    """Torch twin of E2: sweeps of the run walk over the B k lanes, each
    followed by the relay, until no stream's in-carry changes or k + 1
    sweeps have run.  Relay: chunk c's insert count is the exclusive
    prefix of its stream's local counts, taken as E2 takes it: within
    each CTA's block of chunks (``fixpoint_layout``) plus the totals of
    the blocks before; mem, mem2, ac1, win and run_over come from chunk
    c - 1; chunk 0 and the chunks with no step below p1 - 1 are pinned to
    the initial state; run_over is raised to the chunk's floor (its
    first e_base - 256, below which every run_over acts alike).  A chunk
    whose in-carry did not change in a sweep keeps its last walk (its
    e_in, flags and out-carry), as E2 does not walk it again.  Returns
    (e_in (L, B k) int32, flags (L, B k) uint8 with ev1 in bit 0 and ev2
    in bit 1, sweeps (B,) int32: the sweep at which each stream's
    carries stopped changing, at most k + 1)."""
    length, n = ebase.shape
    b = n // k
    dev = ebase.device
    steps = _run_steps(ebase, fields)
    zi = torch.zeros(n, dtype=torch.int32, device=dev)
    carry_in = (zi, zi, zi, zi, torch.full_like(zi, -257), zi)
    carry_out = carry_in
    pin = ((torch.arange(n, device=dev) % k) == 0) | ~(ebase < p1 - 1).any(0)
    ro_floor = ebase[0] - 256
    cluster, cpc, _ = fixpoint_layout(length, k)
    e_in = torch.zeros((length, n), dtype=torch.int32, device=dev)
    flags = torch.zeros((length, n), dtype=torch.uint8, device=dev)
    sweeps = torch.full((b,), k + 1, dtype=torch.int32, device=dev)
    done = torch.zeros(b, dtype=torch.bool, device=dev)
    dirty = torch.ones(n, dtype=torch.bool, device=dev)

    def shift(a, v0):
        return torch.where(pin, v0, torch.nn.functional.pad(a[:-1], (1, 0)))

    def exclusive_prefix(delta):
        # per CTA block of cpc chunks, then the blocks' totals before it
        d = torch.nn.functional.pad(delta.reshape(b, k),
                                    (0, cluster * cpc - k))
        d = d.reshape(b, cluster, cpc)
        within = torch.cumsum(d, 2, dtype=torch.int32) - d
        tot = d.sum(2, dtype=torch.int32)
        before = torch.cumsum(tot, 1, dtype=torch.int32) - tot
        return (within + before[:, :, None]).reshape(b, -1)[:, :k].reshape(n)

    for it in range(1, k + 2):
        c = carry_in
        ev1s, ev2s, es = [], [], []
        for x in steps:
            c, ev1, ev2, e = runs_step(c, x, p1)
            ev1s.append(ev1)
            ev2s.append(ev2)
            es.append(e)
        carry_out = tuple(torch.where(dirty, a, o)
                          for a, o in zip(c, carry_out))
        if length:
            e_in = torch.where(dirty, torch.stack(es), e_in)
            flags = torch.where(dirty, torch.stack(ev1s).to(torch.uint8)
                                | (torch.stack(ev2s).to(torch.uint8) << 1),
                                flags)
        c = carry_out
        pref = exclusive_prefix(c[0] - carry_in[0])
        new_in = (torch.where(pin, 0, pref), shift(c[1], 0), shift(c[2], 0),
                  shift(c[3], 0), torch.maximum(shift(c[4], -257), ro_floor),
                  shift(c[5], 0))
        dirty = torch.stack([a != o for a, o in zip(new_in, carry_in)]
                            ).any(0)
        changed = dirty.reshape(b, k).any(1)
        sweeps = torch.where(~done & ~changed, it, sweeps)
        done = done | ~changed
        carry_in = new_in
        if bool(done.all()):
            break
    return e_in, flags, sweeps


def runs_fixpoint(ebase: torch.Tensor, fields: torch.Tensor, p1: int,
                  k: int):
    """The chunk-relay fixpoint of the Y run automaton (E2) on the
    per-run tuples of ``_runs_xs_batch``, (L, B k) int32 each, k chunks a
    stream (1 <= k <= MAX_CHUNKS).  Returns what ``runs_fixpoint_ref``
    returns; the ys do not depend on k, and at k = 1 the only chunk is
    pinned, so every sweep is the sequential automaton."""
    _check(ebase, "y_runs_fixpoint ebase", torch.int32, (None, None))
    _check(fields, "y_runs_fixpoint fields", torch.int32, tuple(ebase.shape))
    if not (ebase.is_contiguous() and fields.is_contiguous()):
        raise ValueError("y_runs_fixpoint: inputs must be contiguous")
    length, n = ebase.shape
    if not 1 <= k <= MAX_CHUNKS or n % k:
        raise ValueError(f"y_runs_fixpoint: k {k} must lie in "
                         f"[1, {MAX_CHUNKS}] and divide {n} lanes")
    if ebase.device.type == "cpu" and fields.device.type == "cpu":
        return runs_fixpoint_ref(ebase, fields, p1, k)
    lib, stream = _cuda_args(ebase, fields)
    dev = ebase.device
    e_in = torch.empty((length, n), dtype=torch.int32, device=dev)
    flags = torch.empty((length, n), dtype=torch.uint8, device=dev)
    sweeps = torch.zeros(n // k, dtype=torch.int32, device=dev)
    if length and n:
        with torch.cuda.device(dev):
            build.check("nhw_y_runs_fixpoint", lib.nhw_y_runs_fixpoint(
                ebase.data_ptr(), fields.data_ptr(), e_in.data_ptr(),
                flags.data_ptr(), sweeps.data_ptr(), length, n // k, k, p1,
                stream))
        build.count("y_runs_fixpoint")
    return e_in, flags, sweeps


# ---------------------------------------------------------------------------
# Y: the emit, and the batch


def _runs_emit(e_in: torch.Tensor, flags: torch.Tensor, lits: dict,
               sel1: torch.Tensor, sel2: torch.Tensor, p1: int, k: int):
    """Literals at their static advance plus the inserts before them,
    inserted values from each stream's select bits at their ranks; one
    scatter into a zeroed (B, p1 + 512) int16 plane -> (B, p1)."""
    b = sel1.shape[0]
    length, n = e_in.shape
    r_pad = k * length

    def per_stream(a):
        return a.t().reshape(b, r_pad)

    ev = per_stream(flags).to(torch.int32)
    ev1, ev2 = ev & 1, ev >> 1
    ins = ev1 | ev2
    pos_r = per_stream(e_in)
    ins_excl = torch.nn.functional.pad(torch.cumsum(ins, 1,
                                                    dtype=torch.int32), (1, 0))
    e_sym = lits["base_e"] + torch.gather(
        ins_excl, 1, lits["runs_before"].clamp(max=r_pad).long())
    lit = ~lits["is_run"] & (e_sym < p1 - 1)
    dump = p1 + 511       # no write below p1 + 3 lands here
    r1 = (torch.cumsum(ev1, 1) - 1).clamp(0, sel1.shape[1] - 1)
    r2 = (torch.cumsum(ev2, 1) - 1).clamp(0, sel2.shape[1] - 1)
    sv1 = torch.where(torch.gather(sel1, 1, r1) == 0, 11, -11)
    sv2 = torch.where(torch.gather(sel2, 1, r2) == 0, -11, 11)
    idx = [torch.where(lit, e_sym, dump),
           torch.where(lit & (lits["whas2"] == 1), e_sym + 4, dump),
           torch.where(ins == 1, pos_r, dump)]
    val = [lits["wv1"], lits["wv2"], torch.where(ev2 == 1, sv2, sv1)]
    out = torch.zeros((b, p1 + 512), dtype=torch.int16, device=sel1.device)
    out.scatter_(1, torch.cat([a.long() for a in idx], 1),
                 torch.cat([a.to(torch.int16) for a in val], 1))
    return out[:, :p1]


def _y_run_inputs(streams: list, p1: int, dev):
    """E1 and the books of parsed streams: (symbols (B, n) int32, book
    rows, r_max).  The automaton sees each stream's chain up to the
    batch's longest count + 1 (a stream's first start at or past its end
    included); r_max is the most runs among any stream's first count + 1
    symbols, and ``_runs_xs_batch`` drops the runs past r_max rounded up
    to its chunk grid (they lie past the plane)."""
    books = [entropy.build_y_book(s.tree1) for s in streams]
    for vals, rles in books:
        _check_book(vals, rles, "Y")
    words, nbits = _pack_words([s.packet1 for s in streams], dev)
    zone = torch.tensor([1 if s.res_high < 4 else 0 for s in streams],
                        dtype=torch.int32, device=dev)
    s_max = _s_max(int(nbits.max()), p1)
    syms, counts = chain_starts_batch(words, nbits, zone, s_max)
    book = _y_book_rows(books, dev)
    is_run = (torch.gather(book, 1, syms.clamp(0, book.shape[1] - 1).long())
              & 1) == 1
    live = torch.arange(s_max, device=dev) <= counts[:, None].long()
    n_max, r_max = torch.stack([counts.max().long() + 1,
                                (is_run & live).sum(1).max()]).tolist()
    return syms[:, :min(n_max, s_max)], book, max(r_max, 1)


def decode_y_planes(streams: list, p1: int = Y_P1,
                    k_chunks: int = K_CHUNKS,
                    device="cuda") -> torch.Tensor:
    """The Y symbol planes of parsed streams as one (B, p1) int16 tensor
    on ``device``: E1 for the batch's chain, torch ops for the per-run
    tuples, E2 at k_chunks chunks a stream (k_chunks = 1: the sequential
    automaton), and again at one chunk if the fixpoint hits its k + 1
    bound, torch ops for the emit."""
    if not 1 <= k_chunks <= MAX_CHUNKS:
        raise ValueError(f"k_chunks {k_chunks} outside [1, {MAX_CHUNKS}]")
    dev = resolve_device(device)
    syms, book, r_max = _y_run_inputs(streams, p1, dev)
    k = min(k_chunks, r_max)
    xs, lits = _runs_xs_batch(syms, book, p1, r_max, k)
    e_in, flags, sweeps = runs_fixpoint(*xs, p1, k)
    if k > 1 and int(sweeps.max()) > k:    # not converged: one chunk
        k = 1
        xs, lits = _runs_xs_batch(syms, book, p1, r_max, k)
        e_in, flags, _ = runs_fixpoint(*xs, p1, k)
    sel1 = _pad_rows([entropy.expand_bits(s.select_word1) for s in streams],
                     dev)
    sel2 = _pad_rows([entropy.expand_bits(s.select_word2) for s in streams],
                     dev)
    return _runs_emit(e_in, flags, lits, sel1, sel2, p1, k)


def decode_y_device_batch(streams: list, p1: int = Y_P1,
                          k_chunks: int = K_CHUNKS,
                          device="cuda") -> list[np.ndarray]:
    """Y symbol planes of parsed streams, each equal to the host copy's
    ``entropy.decode_y`` of the stream: (p1,) int16 numpy arrays."""
    out = decode_y_planes(streams, p1, k_chunks, device).cpu()
    return list(out.numpy())


# ---------------------------------------------------------------------------
# UV


def _uv_scatter_batch(syms: torch.Tensor, book: torch.Tensor,
                      p1: int) -> torch.Tensor:
    """UV book lookup, exclusive cumsum of the advances, one scatter of
    the literals whose cursor lies below p1 - 1 (decoder/compress_pixel.c:
    639-641) -> (B, 2 IM_SIZE) int16."""
    b = syms.shape[0]
    vr = torch.gather(book, 1, syms.clamp(0, book.shape[1] - 1).long())
    word = vr & 1023
    is_run = word == 0x80
    adv = torch.where(is_run, vr >> 10, 1)
    e_start = torch.cumsum(adv, 1, dtype=torch.int32) - adv
    live = (e_start < p1 - 1) & ~is_run
    val_t = torch.from_numpy(_uv_word_table()).to(syms.device)
    out = torch.zeros((b, p1 + 512), dtype=torch.int16, device=syms.device)
    out.scatter_(1, torch.where(live, e_start, p1 + 511).long(),
                 val_t[word.clamp(max=255)].to(torch.int16))
    return out[:, :2 * T.IM_SIZE]


def decode_uv_planes(streams: list, p1: int = UV_P1,
                     device="cuda") -> torch.Tensor:
    """The interleaved U/V symbol planes as one (B, 2 IM_SIZE) int16
    tensor on ``device``: E1 (zone coding never applies to UV) and the
    scatter."""
    dev = resolve_device(device)
    books = [entropy.build_uv_book(s.tree2, s.tree_end) for s in streams]
    for vals, rles in books:
        _check_book(vals, rles, "UV")
    words, nbits = _pack_words([s.packet2 for s in streams], dev)
    zone = torch.zeros(len(streams), dtype=torch.int32, device=dev)
    syms, _ = chain_starts_batch(words, nbits, zone,
                                 _s_max(int(nbits.max()), p1 + 1))
    book = _pad_rows([np.asarray(v, np.int64) | (np.asarray(r, np.int64)
                                                 << 10)
                      for v, r in books], dev)
    return _uv_scatter_batch(syms, book, p1)


def decode_uv_device_batch(streams: list, p1: int = UV_P1,
                           device="cuda") -> list[np.ndarray]:
    """UV symbol planes of parsed streams, each equal to the host copy's
    ``entropy.decode_uv`` of the stream: (2 IM_SIZE,) int16 numpy."""
    return list(decode_uv_planes(streams, p1, device).cpu().numpy())
