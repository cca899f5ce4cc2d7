"""Device formulations of the encoder's post-transform raster scans.

Port of ``nhwcodec_tpu.models.device_scans``, with the same public names
and results equal to the host copy's C scans
(``nhwcodec_tpu_torch.host.ops.quantize``, ``host.ops.residue``,
``host.models.encoder``, ``host.ops.ll2``).  This module holds the three
stages at the end of the scan pipeline: the LL2 stage (the E16 Y LL2
byte coding and run-delta compression, the E17 chroma LL2 coding and
compression), the residue stage (the E11 mid-q, low56 and lowest-q
cleanups and pair promotion, the E12 column ladder, classify and
positional streams) and the stream stage (the E11 snap passes, the E14
quantizers and the E15 stream fixups), the chroma ladders, and the
cleanups that run before the LL2 coding below LOW7 (the LL1 cleanup, the
very-low-q cleanup) and the chroma LL smoothing.

Fourteen programs carry a serial chain and are CUDA kernels, each beside
a torch twin (``*_ref``) of the same decomposition.  In
``csrc/scans.cu``:

- ``snap_passes_device`` (kernel ``snap_passes``; ``snap_pass_device``
  is a list of one): the neighbour count of the raster pass is static
  (the JAX module's analysis: alive values stay alive under every write
  the pass can make), so the only dynamic dependency is the
  left-neighbour fixup chain within a row, through the class of the
  neighbour's post-snap value (decrement, increment, neither).  One
  warp a row: each lane composes the 3-class maps of its tile of the
  region's columns, the warp scans the tiles' maps, each lane walks its
  tile again from its entry class.  A quality's three regions run in
  one launch, a row's regions in order (``_snap_plan`` checks a list).
- ``offset_y_device`` (kernel ``offset_y``, q > LOW4), three launches:
  pass 1's decrement chain one thread a row (a give never crosses a
  row); passes 2-3 on the LL quadrant a cluster of 8 CTAs an image, the
  input rows staged, a warp a band of ``OY_BAND_ROWS`` rows in order (the
  greedy pair rule within a row is the parity of the position in its run
  of candidates, from warp ballots); the only carry between rows is the
  vertical fires' writes into the next (``pend``), so each band walks
  from no pend, takes the exit of the band above and walks again while
  that entry changes (``_offset_y_ll_ref``); pass 4, the code map, one
  thread a position.
- ``offset_y_low4_device`` (kernel ``offset_y_low4``, q <= LOW4): S2's
  pass 1, then pass 4 with the duty-cycle counters.  quant and quant6 are
  prefix counts of a row's ticks; what steers the walk is one of
  ``OY4_STATES`` (quant4 and the write pending), so each position is a
  table of the next state: a warp a row, each lane composing its tile's
  tables into a map, a warp scan of the lane maps, the rows' maps
  chained over CTAs of ``OY4_ROWS`` rows by a look-back, each tile walked
  again from its entry (``offset_y_low4_plan``).
- ``merge_crossing_device`` (kernel ``merge_crossing``, one launch): the
  cursor walk is a 5-state skip machine whose per-position map depends
  only on the input bytes.  A cluster of ``MERGE_CTAS`` CTAs a stream, 64
  positions a thread loaded in 16-byte loads: each thread builds its
  map of 5 states once (15 bits, from bit masks of its bytes), the warps
  and then the CTA scan the maps, each CTA pushes its composite (and its
  map up to its last 4 positions with their fires from each state) to
  the cluster before one barrier, and each thread walks again from its
  entry state and writes its bytes from the fire bits in 16-byte stores
  (``merge_crossing_plan``).

In ``csrc/residue.cu``:

- ``pair_promotion_device`` (kernel ``pair_promotion``): the C's chain
  never leaves a row, and its carry between visits is one of nine
  states read through three classes; one warp a row, each lane the map
  of its 8-column tile's exit states, a warp scan of the maps, each lane
  walking its tile again from its entry state.
- ``column_ladder_device`` (kernel ``column_ladder``): the columns are
  independent walks over the rows but for column 255, whose flat j + 1
  reads see the other columns' results; 8 CTAs an image, a warp a block
  of 32 columns walking from shared memory (a step a lookup in a table
  of the step's effects, built by a first launch), column 255 on a
  second warp of CTA 0 ``LADDER_LAG`` steps behind column 0.
- ``classify_device`` (kernel ``classify``): the band rules read the
  value the previous step wrote only through its class (6 of them), so
  a band row is a scan of 6-class maps: 8 CTAs an image, a warp a band
  row, lane l composing the maps of steps 8 l..8 l + 7, a warp scan, and
  each lane walking its steps again from its entry class.

In ``csrc/ll2.cu``:

- ``ll2_code_y_scan`` (kernel ``ll2_code_y``), the serial part of
  ``ll2_code_y_device``: a cluster of ``LL2_CTAS`` CTAs an image; the
  4-run odd-marking pre-pass (a skip walk a row) a warp a row, a scan of
  the skip counter's 4-state maps; the nudge scan a warp a band of
  ``LL2_BAND_ROWS`` rows, the within-row 2a fires a run parity, the
  rows' ``pend`` carry relayed band to band and a band walked again
  while its entry changes (``_ll2y_sweeps``, S2's relay).
- ``walk_visited_device`` (kernel ``walk_visited``): the visited mask of
  a forward walk over static successors, one CTA a row, the jumps staged
  in shared memory and walked by segments: each segment's last node from
  every node (a thread a segment), the chain of segment entries (one
  thread, a hop a segment), each segment walked from its entry.  The Y
  highres walk, its squeeze walk and the UV highres walk use it.

In ``csrc/uv.cu``:

- ``uv_sentinel_marking_device`` (kernel ``uv_sentinel``): the chroma
  band sentinels, a cluster of ``UVSM_CTAS`` CTAs an image, a warp a
  row.  A pair at a row's last lane moves every later row's window, so
  every row walks from a guessed window start, again within its CTA
  while its start moves, and the CTAs swap their rows' drifts a round
  until they stand (``_uvsm_sweeps``).

In ``csrc/lowq.cu``:

- ``lowest_q_band_cleanup_device`` (kernel ``lowest_q_band_cleanup``, q <
  LOW6, one launch): the carry between visits is one of 5 states (left
  the input, 0, 0 with the value zeroed by pairR, +7, -7), so each visit
  is a table of the next state fixed by its inputs.  A cluster of
  ``LQ_CTAS`` CTAs an image, a warp a row, a lane a tile of visits: the
  warp scans its lanes' maps; loop A's rows walk again at once; B + C's
  row maps (entry state to the next row's) are composed per CTA, then
  chained over the cluster from row 256's entry, and each row walks again
  from its entry (``lowest_q_band_cleanup_plan``).

In ``csrc/vlq.cu``:

- ``very_low_q_cleanup_device`` (kernel ``very_low_q_cleanup``, q <
  LOW7), two launches: ``vlq_rows``, one CTA an image, the LL2 quadrant
  in shared memory: pass 1 a thread a row; passes 2 and 3 as wavefronts
  (row r's visit j at step 2r + j) relayed lane to lane by shuffles and
  warp to warp through shared memory, the warps 69 steps apart and a
  barrier every 4 steps (``_vlq_relay_pass``); pass 4; the
  count masks of the far zeroings out as bits (``very_low_q_plan``);
  then ``vlq_far`` zeroes what the masks reach outside the quadrant
  (``_vlq_far_ref``).
- ``low_q_ll1_cleanup_device`` (kernel ``ll1_rows``, q <= LOW9): a thread
  a row of 128..255.
- ``uv_ll_smooth_device`` (kernel ``uvs_relay``, q <= LOW9): one CTA a
  chroma plane, both passes as S12's relay on four warps, pass 3 a fixed
  number of steps behind pass 2 (``_uvs_relay_ref``).

The rows of S2's pass 1 and S13 are staged in shared memory, 32 a CTA,
a thread a row.

The rest are torch ops: the count-adaptive lowest-q thresholds (a count
and a ``torch.where`` ladder, in ``device_encode_scans``), the
serpentines (one gather each), the select
codes (shifts, run parity and two sums), the run cap (``cummax`` run
starts and a closed-form crossing count), ``offset_uv_device``, the mid-q
and low56 cleanups (elementwise), the positional streams (cumsum ranks and
scatters; the pair pack's skip walk is a run parity), and the LL2
coders' emissions: the escape fill ("last non-escape value", a
``cummax`` of indices), the per-node successors and emissions of the
highres walks (``torch.where`` chains, streak lengths by a reversed
``cummin``) and the compactions.

Each kernel wrapper launches its kernel for CUDA tensors and raises if
the build or the launch fails; it takes its twin only for tensors on the
CPU.  Launches are counted in ``kernels.build.LAUNCHES``.
"""

from __future__ import annotations

import ctypes
import functools

import numpy as np
import torch

from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.ops import geometry
from nhwcodec_tpu_torch.host.ops.quantize import EXTRA_WORDS1, EXTRA_WORDS2
from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.kernels.build import check_arg as _check
from nhwcodec_tpu_torch.kernels.build import cuda_args as _cuda_args

D = 256
N = 512
SZ = 65536

MERGE_TILE = 64                    # positions a thread of merge_crossing
MERGE_THREADS = 512                # threads a CTA (csrc/scans.cu kMThreads)
MERGE_SPAN = MERGE_TILE * MERGE_THREADS
MERGE_LEN = 4 * SZ                 # stream positions walked and written
MERGE_END = 4 * SZ - 4             # the cursor walk's end
MERGE_CTAS = MERGE_LEN // MERGE_SPAN   # CTAs a stream: one cluster of 8


# ---------------------------------------------------------------------------
# shared helpers


def _zpad(x: torch.Tensor, axis_pairs, fill) -> torch.Tensor:
    """Pad ``x`` with ``fill``: ``axis_pairs`` lists (axis, (before,
    after))."""
    for ax, (lo, hi) in axis_pairs:
        ax = ax % x.dim()
        parts = []
        for k in (lo, hi):
            shape = list(x.shape)
            shape[ax] = k
            parts.append(torch.full(shape, fill, dtype=x.dtype,
                                    device=x.device))
        x = torch.cat([parts[0], x, parts[1]], ax)
    return x


def _flat_shift_l(x: torch.Tensor, k: int = 1, fill=0) -> torch.Tensor:
    """x[..., i + k] at i, ``fill`` past the end."""
    return _zpad(x[..., k:], [(-1, (0, k))], fill)


def _flat_shift_r(x: torch.Tensor, k: int = 1, fill=0) -> torch.Tensor:
    """x[..., i - k] at i, ``fill`` before the start."""
    return _zpad(x[..., :-k], [(-1, (k, 0))], fill)


def _run_parity_fire(F: torch.Tensor) -> torch.Tensor:
    """fired = F & even(offset within the maximal F-run along the last
    axis): the greedy fire-and-consume-next rule over a static
    predicate."""
    idx = torch.arange(F.shape[-1], device=F.device, dtype=torch.int32)
    brk = torch.where(F, torch.full_like(idx, -1), idx.expand_as(F))
    start = torch.cummax(brk, dim=-1).values + 1
    return F & (((idx - start) & 1) == 0)


def _sentinel_code(a: torch.Tensor) -> torch.Tensor:
    """The >10000 sentinel -> code-byte map of offset_y pass 4 (other
    values unchanged)."""
    out = a
    for s, c in ((12200, 122), (12100, 121), (10300, 126), (10204, 125),
                 (12900, 129), (12700, 127), (10100, 128)):
        out = torch.where(a == s, c, out)
    return out


@functools.lru_cache(maxsize=8)
def _escape_table(dev: torch.device) -> torch.Tensor:
    """(2, 19) int32: EXTRA_WORDS1 (a > 127) and EXTRA_WORDS2 (a < -127)
    of the port's host quantizer."""
    return torch.tensor([EXTRA_WORDS1, EXTRA_WORDS2], dtype=torch.int32,
                        device=dev)


def _escape_code(a: torch.Tensor) -> torch.Tensor:
    """|a| > 127 escape words (EXTRA_WORDS1/2)."""
    tab = _escape_table(a.device)
    exw_p = torch.clamp(((a & 0xfff8) - 128) >> 3, 0, 18).long()
    exw_n = torch.clamp((((-a) & 0xfff8) - 128) >> 3, 0, 18).long()
    return torch.where(a > 127, tab[0][exw_p], tab[1][exw_n])


def _i32(x: torch.Tensor) -> torch.Tensor:
    return x.to(torch.int32)


def _check_plane(x: torch.Tensor, name: str, n: int) -> None:
    _check(x, name, torch.int16, (None, n, n))
    if not x.is_contiguous():
        raise ValueError(f"{name}: plane must be contiguous")


# ---------------------------------------------------------------------------
# E11: the snap passes (encoder/nhw_encoder.c:1923-2098)


def _snap_decide(v, cnt, yw: int, yw2: int, second_rule: bool,
                 snap_guard6: bool):
    """The snap decision for alive positions given their current value v
    and the static neighbour count (encoder/nhw_encoder.c:1923-1960)."""
    in_band = (v > -yw) & (v < yw)
    fire1 = (v.abs() < yw2) & (cnt < 3) & in_band
    if snap_guard6:
        s1 = torch.where(v < -6, -7, torch.where(v > 6, 7, v))
    else:
        s1 = torch.where(v < 0, -7, 7)
    out = torch.where(fire1, s1, v)
    if second_rule:
        fire2 = ~fire1 & (cnt == 0) & (v.abs() < yw2)
        out = torch.where(fire2, torch.where(v < 0, -7, 7), out)
    return out


SNAP_LANES = 32     # lanes a region's row (csrc/scans.cu snap_region)
SNAP_MAX = 3        # regions one launch walks (kSnapMax)


def snap_lane_cols(col0: int, col1: int) -> int:
    """Columns a lane of ``snap_passes`` takes of region [col0, col1) and
    its spill column: 8, or 16 past 256."""
    return 8 if col1 - col0 < 8 * SNAP_LANES else 16


def _snap_args(r0, r1, col0, col1) -> None:
    if not (0 <= r0 < r1 <= N and 0 <= col0 < col1 <= N):
        raise ValueError(f"snap_pass: bad region rows [{r0}, {r1}) "
                         f"columns [{col0}, {col1})")


def _snap_plan(variants) -> list[tuple]:
    """Check a list of snap regions for one fused walk and return it as
    tuples.  The walk reads the rows above and below a region from the
    input plane and walks the regions of a row in order in registers, so
    it equals the regions run one after another when no region's reads
    of the rows above and below (rows r0 - 1 .. r1 but its own, columns
    [col0, col1)) touch what an earlier region writes (rows [r0, r1),
    columns [col0, col1] with the spill column); reads in the same row
    may."""
    plan = [tuple(int(x) for x in v) for v in variants]
    if not 1 <= len(plan) <= SNAP_MAX:
        raise ValueError(f"snap_passes: 1..{SNAP_MAX} regions, got "
                         f"{len(plan)}")
    for k, v in enumerate(plan):
        if len(v) != 10:
            raise ValueError(f"snap_passes: region {k} has {len(v)} "
                             "arguments, not 10")
        r0, r1, c0, c1 = v[:4]
        _snap_args(r0, r1, c0, c1)
        for j, w in enumerate(plan[:k]):
            wr0, wr1, wc0, wc1 = w[:4]
            rows = any(max(lo, wr0) < min(hi, wr1)
                       for lo, hi in ((r0 - 1, r1 - 1), (r0 + 1, r1 + 1)))
            cols = max(c0, wc0) < min(c1, wc1 + 1)
            if rows and cols:
                raise ValueError(
                    f"snap_passes: region {k} (rows [{r0}, {r1}) columns "
                    f"[{c0}, {c1})) reads rows above or below that region "
                    f"{j} (rows [{wr0}, {wr1}) columns [{wc0}, {wc1}]) "
                    "writes; run them as separate calls")
    return plan


def _snap_class(e):
    """The class of a post-snap e that its right neighbour's fixup reads:
    1 the decrement, 2 the increment, 0 neither."""
    return torch.where((e >= 8) & ((e & 7) < 2), 1, torch.where(
        (e < -7) & (((-e) & 7) < 2), 2, 0))


def _snap_fix(I, right, k, gc_ok):
    """Value of I after its left neighbour's fixup, given the neighbour's
    class k (a tensor; 0 for a dead neighbour); right is I's right
    neighbour, gc_ok whether the neighbour's column lies below the guard
    column."""
    dec = (k == 1) & (I > 7) & (I < 10000)
    inc = (k == 2) & (I < -14) & ((((-I) & 7) == 7) | (
        (((-I) & 7) < 2) & gc_ok & (right <= 0)))
    return torch.where(dec, I - 1, torch.where(inc, I + 1, I))


def _snap_region(x, up, dn, rows, v):
    """One region on rows ``rows`` of ``x`` (B, R, 512) int32, the rows as
    the earlier regions left them; up and dn the input rows above and
    below.  The kernel's decomposition: each column's map from the 3
    entry classes, the maps composed over the lanes' tiles of
    ``snap_lane_cols`` columns from col0, the tiles chained from class 0,
    each tile walked from its entry."""
    r0, r1, c0, c1, thr, yw, yw2, sec, g6, gc = v
    b, nr, _ = x.shape
    cols = torch.arange(N, device=x.device)
    zero = torch.zeros_like(x[..., :1])
    left = torch.cat([zero, x[..., :-1]], -1)
    right = torch.cat([x[..., 1:], zero], -1)
    up_in = (rows - 1 >= r0)[None, :, None]
    l_tr = torch.where(cols > c0, left.abs() >= thr, left.abs() >= 6)
    u_tr = torch.where(up_in, up.abs() >= thr, up.abs() >= 6)
    cnt = (l_tr.to(torch.int32) + (right.abs() >= 6).to(torch.int32)
           + u_tr.to(torch.int32) + (dn.abs() >= 6).to(torch.int32))
    gc_ok = (cols - 1) < gc
    inreg = (cols >= c0) & (cols < c1)
    alive = x.abs() >= thr
    vals, trans = [], []
    for k in range(3):
        e = _snap_decide(_snap_fix(x, right, torch.full_like(x, k), gc_ok),
                         cnt, yw, yw2, sec, g6)
        vals.append(torch.where(alive, torch.where(
            (e == -7) & (right == 8), -8, e), 0))
        trans.append(torch.where(inreg & alive, _snap_class(e), 0))
    w = snap_lane_cols(c0, c1)
    span = SNAP_LANES * w           # the lanes' columns from c0
    t = torch.stack(trans, -1)[..., c0: c0 + span, :]
    t = torch.cat([t, torch.zeros_like(t[..., :span - t.shape[-2], :])], -2)
    t = t.reshape(b, nr, SNAP_LANES, w, 3)
    m = torch.arange(3, device=x.device).expand(b, nr, SNAP_LANES, 3)
    for i in range(w):              # each tile's map
        m = torch.gather(t[..., i, :], -1, m)
    k = torch.zeros_like(m[..., 0, :1])
    entry = []
    for i in range(SNAP_LANES):     # the tiles chained from class 0
        entry.append(k)
        k = torch.gather(m[..., i, :], -1, k)
    k = torch.cat(entry, -1)[..., None]
    kin = []
    for i in range(w):              # each tile walked from its entry
        kin.append(k)
        k = torch.gather(t[..., i, :], -1, k)
    kin = torch.cat(kin, -1).reshape(b, nr, span)[..., : N - c0]
    kin = torch.nn.functional.pad(kin, (c0, N - c0 - kin.shape[-1]))
    val = torch.gather(torch.stack(vals, -1), -1, kin[..., None])[..., 0]
    spill = _snap_fix(x, right, kin, gc_ok)
    return torch.where(inreg, val, torch.where(cols == c1, spill, x))


def snap_passes_ref(plane, variants):
    """Torch twin of ``snap_passes``: the regions of ``variants`` in
    order, each row's regions on the row as the earlier ones left it, the
    rows above and below read from the input (``_snap_plan``)."""
    plan = _snap_plan(variants)
    I = _i32(plane)
    zero = torch.zeros_like(I[:, :1])
    up_all = torch.cat([zero, I[:, :-1]], 1)      # row r - 1
    dn_all = torch.cat([I[:, 1:], zero], 1)       # row r + 1
    out = I.clone()
    for v in plan:
        r0, r1 = v[:2]
        rows = torch.arange(r0, r1, device=I.device)
        out[:, r0:r1] = _snap_region(out[:, r0:r1], up_all[:, r0:r1],
                                     dn_all[:, r0:r1], rows, v)
    return out.to(torch.int16)


def snap_pass_ref(plane, r0: int, r1: int, col0: int, col1: int, thr: int,
                  yw: int, yw2: int, second_rule: bool, snap_guard6: bool,
                  gc: int):
    """Torch twin of one ``snap_pass_device`` region."""
    return snap_passes_ref(plane, [(r0, r1, col0, col1, thr, yw, yw2,
                                    second_rule, snap_guard6, gc)])


def snap_passes_device(plane, variants):
    """The ``_band_snap_pass`` calls of ``variants`` (each (r0, r1, col0,
    col1, thr, yw, yw2, second_rule, snap_guard6, gc)) one after another
    on a (B, 512, 512) int16 plane, in one launch of kernel
    ``snap_passes``: a warp a row staged in shared memory, the regions of
    the row in order, a lane a tile of ``snap_lane_cols`` columns.
    Raises ValueError on a list whose fused walk would differ from the
    calls in turn (``_snap_plan``).  Returns a new plane."""
    _check_plane(plane, "snap_pass plane", N)
    plan = _snap_plan(variants)
    if plane.device.type == "cpu":
        return snap_passes_ref(plane, plan)
    lib, stream = _cuda_args(plane)
    out = torch.empty_like(plane)
    if plane.shape[0]:
        args = (ctypes.c_int * (10 * len(plan)))(
            *[x for v in plan for x in v])
        with torch.cuda.device(plane.device):
            build.check("nhw_snap_passes", lib.nhw_snap_passes(
                plane.data_ptr(), out.data_ptr(), plane.shape[0], len(plan),
                args, stream))
        build.count("snap_pass")
    return out


def snap_pass_device(plane, r0: int, r1: int, col0: int, col1: int,
                     thr: int, yw: int, yw2: int, second_rule: bool,
                     snap_guard6: bool, gc: int):
    """One ``_band_snap_pass`` on a (B, 512, 512) int16 plane, bit-exact
    vs the host copy's ``models.encoder._band_snap_pass``: rows [r0, r1),
    columns [col0, col1), threshold ``thr``, the snap window (yw, yw2),
    the second rule, the +-6 guard and the guard column ``gc`` of the
    fixup chain.  Returns a new plane (``snap_passes_device`` on a list of
    one)."""
    return snap_passes_device(plane, [(r0, r1, col0, col1, thr, yw, yw2,
                                       second_rule, snap_guard6, gc)])


# ---------------------------------------------------------------------------
# E14: the scalar quantizers (host.ops.quantize.offset_y / offset_uv)


def _offset_y_rows_ref(If):
    """Pass 1 (image_processing.c:194-237): the even-pair decrements, a
    left-to-right chain in each row (a give lands on the next column,
    never past column 510), the rows as a batch.  ``If``: (B, 4 SZ)
    int32."""
    b = If.shape[0]
    IL = _flat_shift_l(If).reshape(b, N, N)
    IL2 = _flat_shift_l(If, 2).reshape(b, N, N)
    IRs = _flat_shift_r(If).reshape(b, N, N)
    I = If.reshape(b, N, N)
    row = torch.arange(N, device=If.device)[:, None]
    out = torch.empty_like(I)
    d = torch.zeros_like(I[..., 0])
    for c in range(N):
        reg = ((row >= D) | (c >= D)) & (c < 2 * D - 1)        # (N, 1)
        pos = (row * N + c) > 0
        a = I[..., c] - d
        il = IL[..., c]
        outer = (reg[:, 0] & (a > 7) & (il > 7) & ((a & 7) == 0)
                 & ((il & 7) == 0))
        outer_r = ((il > 15) & ((il & 7) == 0) & (c < 2 * D - 2)
                   & (IL2[..., c] <= 0))
        big = a > 15
        right_pos = pos[:, 0] & (IRs[..., c] > 0)
        case_a = outer & big & pos[:, 0] & (IRs[..., c] <= 0)
        give = outer & outer_r & (~big | right_pos)
        out[..., c] = a - case_a.to(torch.int32)
        d = give.to(torch.int32)
    return out.reshape(b, -1)


OY_BANDS = 16                  # bands of passes 2-3 (csrc/scans.cu kOyBands)
OY_BAND_ROWS = D // OY_BANDS


def _offset_y_row(I_r, I_r1, pend):
    """Row r of passes 2-3 (image_processing.c:241-309), the columns on
    the last axis: the first pair promotion's fires on the row as row
    r - 1's vertical fires left it (``pend``: 10100 there), a vertical
    fire writing 10100 into the next row at j - 1 and j, then the second
    promotion on the finished row (its own writes only).  ``I_r``,
    ``I_r1``: the input rows r and r + 1.  Returns (row r's output, row
    r + 1's pend)."""
    colv = torch.arange(D, device=I_r.device)
    ok = (colv >= 1) & (colv < D - 1)
    ok3 = colv < D - 1
    v = torch.where(pend, 10100, I_r)
    vl = _flat_shift_r(v)
    vr = _flat_shift_l(v)
    n1l = _flat_shift_r(I_r1)
    fp = ok & (v > 3) & (v < 8) & (vl > 3) & (vl <= 7)
    fph = fp & (vr > 3) & (vr <= 7)
    fpv = fp & ~fph & (n1l > 3) & (n1l <= 7) & (I_r1 > 3) & (I_r1 <= 7)
    fn = ok & (v > -8) & (v < -3) & (vl > -8) & (vl <= -4)
    fnh = fn & (vr > -8) & (vr <= -4)
    fnv = (fn & ~fnh & (n1l > -8) & (n1l <= -4) & (I_r1 > -8)
           & (I_r1 <= -4))
    fired = _run_parity_fire(fph | fpv | fnh | fnv)
    fh = fired & (fph | fnh)
    fv = fired & (fpv | fnv)
    out = torch.where(fh, torch.where(fph, 12700, 12900), v)
    out = torch.where(fv, 10100, out)
    left_val = torch.where(fh, 10100, torch.where(fpv, 12100, 12200))
    wl = _flat_shift_l(fh | fv, 1, False)
    out = torch.where(wl, _flat_shift_l(left_val), out)
    pend = fv | _flat_shift_l(fv, 1, False)
    outr = _flat_shift_l(out)
    f3p = ok3 & (out >= 5) & (out <= 7) & (outr >= 5) & (outr <= 7)
    f3n = ok3 & (out >= -7) & (out <= -5) & (outr >= -7) & (outr <= -5)
    fired3 = _run_parity_fire(f3p | f3n)
    return torch.where(fired3, torch.where(f3p, 10300, 10204), out), pend


def _offset_y_bands(I, entry):
    """Every band of OY_BAND_ROWS rows walked in order from its entry
    pend (``entry``: (B, OY_BANDS, 256) bool) on the input rows 0..256
    ``I`` ((B, 257, 256) int32).  Returns (rows 0..255 out, each band's
    exit pend)."""
    b = I.shape[0]
    cur = I[:, :D].reshape(b, OY_BANDS, OY_BAND_ROWS, D)
    nxt = I[:, 1:].reshape(b, OY_BANDS, OY_BAND_ROWS, D)
    out = torch.empty_like(cur)
    pend = entry
    for k in range(OY_BAND_ROWS):
        out[:, :, k], pend = _offset_y_row(cur[:, :, k], nxt[:, :, k], pend)
    return out.reshape(b, D, D), pend


def _offset_y_ll_ref(p):
    """Passes 2-3 on the LL quadrant as the kernel takes them: every band
    walked from no pend, then each band's entry set to the exit of the
    band above and the bands walked again while an entry changes (after s
    sweeps bands 0..s - 1 are exact, so OY_BANDS sweeps at most); row
    255's exit written into plane row 256.  ``p``: (B, 512, 512) int32,
    updated in place.  Returns (p, the sweeps each image took, (B,)
    int32)."""
    b = p.shape[0]
    I = p[:, :D + 1, :D].clone()
    entry = torch.zeros((b, OY_BANDS, D), dtype=torch.bool, device=p.device)
    out, exits = _offset_y_bands(I, entry)
    sweeps = torch.ones(b, dtype=torch.int32, device=p.device)
    for _ in range(OY_BANDS - 1):
        want = torch.cat([torch.zeros_like(exits[:, :1]), exits[:, :-1]], 1)
        moved = (want != entry).flatten(1).any(1)
        if not bool(moved.any()):
            break
        entry = want
        out, exits = _offset_y_bands(I, entry)
        sweeps += moved.int()
    p[:, :D, :D] = out
    p[:, D, :D] = torch.where(exits[:, -1], 10100, I[:, D])
    return p, sweeps


def _offset_y_codes(If, m1: int):
    """Pass 4 (image_processing.c:312-520), q > LOW4: the fixup writes
    onto x + 1 computed from the pass's input, then the per-position code
    map.  ``If``: (B, 4 SZ) int32."""
    n = If.shape[-1]
    col = torch.arange(n, device=If.device) & (N - 1)
    IL = _flat_shift_l(If)
    incol = col < 2 * D - 1
    w_m9 = (If < -12) & (((-If) & 7) == 6) & incol & (IL == -7)
    neg = If < 0
    w_m8 = ~neg & (If == 8) & (IL == -7) & incol
    w_9 = (~neg & ~(If == 8) & (If > 12) & ((If & 7) >= 6) & incol
           & (IL == 7))
    plain = (If < 10000) & (If >= -10000) & (If.abs() <= 127)
    wv = torch.where(w_m9, -9, torch.where(w_m8, -8, 9))
    wmask = _flat_shift_r(plain & (w_m9 | w_m8 | w_9), 1, False)
    a = torch.where(wmask, _flat_shift_r(wv), If)
    sent = a > 10000
    esc = (a > 127) | (a < -127)
    a2 = torch.where((a == -7) & (IL == 8) & incol, -8, a)
    an = -a2
    dec2 = (an > 14) & ((an & 7) == 7) & (IL > 0) & (IL < 8)
    an = torch.where(dec2, an - 2, an)
    an = torch.where((an & 7) < 7, an & 504, an)
    aq = torch.where(a2 < 0, -an, a2)
    code = torch.where((aq > -m1) & (aq < m1), 128, (aq + 128) & 248)
    out = torch.where(sent, _sentinel_code(a),
                      torch.where(esc, _escape_code(a), code))
    return torch.where(If == 0, 128, out)


def offset_y_ref(plane, m1: int = 8):
    """Torch twin of ``offset_y``: pass 1 row by row, passes 2-3 by bands
    of the LL quadrant relayed, pass 4 elementwise."""
    b = plane.shape[0]
    If = _offset_y_rows_ref(_i32(plane).reshape(b, -1))
    p = _offset_y_ll_ref(If.reshape(b, N, N))[0]
    return _offset_y_codes(p.reshape(b, -1), m1).reshape(
        plane.shape).to(torch.int16)


def offset_y_device(plane, m1: int = 8):
    """``host.ops.quantize.offset_y`` on a (B, 512, 512) int16 plane for
    q > LOW4 (the path without the duty-cycle counters).  Returns the
    code plane, int16 (kernel ``offset_y``: three launches)."""
    _check_plane(plane, "offset_y plane", N)
    if plane.device.type == "cpu":
        return offset_y_ref(plane, m1)
    lib, stream = _cuda_args(plane)
    tmp = torch.empty_like(plane)
    out = torch.empty_like(plane)
    if plane.shape[0]:
        with torch.cuda.device(plane.device):
            build.check("nhw_offset_y", lib.nhw_offset_y(
                plane.data_ptr(), tmp.data_ptr(), out.data_ptr(),
                _escape_table(plane.device).data_ptr(), plane.shape[0], m1,
                stream))
        build.count("offset_y")
    return out


def offset_y_sweeps(plane):
    """The sweeps of ``offset_y``'s passes 2-3 over the bands of each
    image of a (B, 512, 512) int16 plane (1..OY_BANDS; the twin's, which
    takes the kernel's bands and relay), (B,) int32."""
    _check_plane(plane, "offset_y plane", N)
    b = plane.shape[0]
    If = _offset_y_rows_ref(_i32(plane).reshape(b, -1))
    return _offset_y_ll_ref(If.reshape(b, N, N))[1]


# The q <= LOW4 quantizer's pass 4 carries the duty-cycle counters quant
# (mod 6) and quant6 (mod 4), which reset at every row start, quant4 (mod
# 3), which runs on, and a write a step may leave pending on the next
# position.  quant and quant6 only choose whether a negative value is
# masked (an & 504), and no rule reads a masked value (the pair rule wants
# a >= 14, the fixups test a0 and the next input), so they do not steer
# the walk: each counts the row's earlier ticks (an == 15; an > 22 with an
# & 7 == 7), and a tick is masked where that count is 0 mod 6 (mod 4).
# What steers it is one of OY4_STATES: quant4 0..2 with nothing pending
# (0..2), or with a fixup pending (3..5: -9, -8 or 9; none of them fires a
# rule, and -9 and -8 take one code, so the next input, 7 or -7, tells
# which), or quant4 1 with the next value pending at its input - 2 (6, the
# up rule) or + 2 (7).  A position's next state from each is fixed by its
# inputs, from one evaluation of the rules (``_oy4_tables``), so it is a
# table of 8 states, 3 bits each.  At column 511 only the pair
# rule writes on, into the next row's column 0, so a row enters and
# leaves in one of OY4_ROW_STATES.
OY4_STATES = 8
OY4_ROW_STATES = (0, 1, 2, 6, 7)
OY4_TILE = 16                 # columns a lane (csrc/scans.cu kOy4Tile)
OY4_LANES = N // OY4_TILE     # lanes a row: one warp
OY4_ROWS = 16                 # rows a CTA, a warp each (kOy4Warps)
# the fixed entries: 3..5 -> 0..2, 6 and 7 -> 1
_OY4_FIXED = sum(n << (3 * s) for s, n in ((3, 0), (4, 1), (5, 2), (6, 1),
                                           (7, 1)))


def _oy4_pos(I):
    """Each position's inputs and fixed tests from pass 1's output ``I``
    ((B, 512, 512) int32): (i0, i1, i2, incol, reg4, r2ok), the next two
    inputs in flat order (0 past the plane)."""
    b = I.shape[0]
    flat = I.reshape(b, -1)
    i1 = _flat_shift_l(flat).reshape(I.shape)
    i2 = _flat_shift_l(flat, 2).reshape(I.shape)
    col = torch.arange(N, device=I.device)
    row = torch.arange(N, device=I.device)[:, None]
    return (I, i1, i2, col < N - 1, (row >= D) | (col >= D),
            (col > 0) & (col < N - 2))


def _oy4_tables(pos):
    """Each position's table (int64): bits 3 s..3 s + 2 the next state from
    state s.  From 0..2 the rules at the input: a fixup writes the next
    position, the quant4 pair rule fires at quant4 0 and advances it
    else.  3..5 go to 0..2 (a fixup's value fires no rule) and 6, 7 to 1:
    the pending value is the input -+ 2 of an input the pair rule took (>=
    14, & 6 == 6), whose & 7 (4, 5, 0 or 1) no rule takes."""
    i0, i1, i2, incol, reg4, r2ok = pos
    plain = (i0 != 0) & (i0 <= 127) & (i0 >= -127)
    fix = plain & incol & (
        ((i1 == -7) & (((i0 < -12) & (((-i0) & 7) == 6)) | (i0 == 8)))
        | ((i1 == 7) & (i0 > 12) & ((i0 & 7) >= 6)))
    pair = (plain & reg4 & (i0 >= 14) & (i1 >= 14) & ((i0 & 6) == 6)
            & ((i1 & 6) == 6) & (((i0 | i1) & 1) == 1))
    same = (i0 & 504) == (i1 & 504)
    up_a = pair & torch.where(same, i0 >= i1, i0 <= i1)
    r2 = r2ok & (((i2 > -8) & (i2 < -2)) | ((i2 < -7) & (((-i2) & 7) >= 6)))
    fixl, pairl = fix.long(), pair.long()
    n0 = torch.where(fix, 3, torch.where(pair, torch.where(
        up_a, 6, torch.where(r2, 1, 7)), 0))
    return (n0.long() | (1 + pairl + 3 * fixl) << 3
            | (2 + 3 * fixl - 2 * pairl) << 6 | _OY4_FIXED)


def _oy4_at(tab, s):
    return (tab >> (3 * s)) & 7


def _oy4_map(m):
    """(..., 8) next states -> one int64 map, 3 bits a state."""
    return sum(m[..., s] << (3 * s) for s in range(OY4_STATES))


def _oy4_then(f, g):
    """The map of f, then g (int64 maps)."""
    return sum(_oy4_at(g, _oy4_at(f, s)) << (3 * s)
               for s in range(OY4_STATES))


def offset_y_low4_plan(plane):
    """The kernel's decomposition of pass 4 on S2's pass-1 output, up to
    the walk again: {"I": pass 1's output (B, 512, 512) int32, "tab": each
    position's table, "lane_pre": each lane's exclusive prefix map over
    its row's tiles (B, 512, OY4_LANES), "row_map": each row's map over
    OY4_ROW_STATES (B, 512, 5), "entry": each row's entry state (B, 512),
    "lane_entry": each lane's (B, 512, OY4_LANES)}.  Each lane composes
    the tables of its OY4_TILE columns into its tile's map of 8 states,
    the warp scans the 32 maps, and the rows' maps chain from state 0:
    by CTAs of OY4_ROWS rows whose composites a look-back chains, then
    within each CTA."""
    b = plane.shape[0]
    dev = plane.device
    I = _offset_y_rows_ref(_i32(plane).reshape(b, -1)).reshape(b, N, N)
    tab = _oy4_tables(_oy4_pos(I))
    tiles = tab.reshape(b, N, OY4_LANES, OY4_TILE)
    s = torch.arange(OY4_STATES, device=dev).expand(
        b, N, OY4_LANES, OY4_STATES).clone()
    for k in range(OY4_TILE):
        s = _oy4_at(tiles[..., k, None], s)
    maps = _oy4_map(s)
    ident = int(_oy4_map(torch.arange(OY4_STATES)))
    pre = torch.empty_like(maps)
    acc = torch.full_like(maps[..., 0], ident)
    for lane in range(OY4_LANES):
        pre[..., lane] = acc
        acc = _oy4_then(acc, maps[..., lane])
    rs = torch.tensor(OY4_ROW_STATES, device=dev)
    row_map = _oy4_at(acc[..., None], rs)               # (B, 512, 5)
    to5 = torch.tensor([0, 1, 2, 0, 0, 0, 3, 4], device=dev)
    row_map = to5[row_map]
    # each CTA's composite of its rows' maps, chained from state 0
    cta = row_map.reshape(b, N // OY4_ROWS, OY4_ROWS, 5)
    comp = torch.arange(5, device=dev).expand(b, N // OY4_ROWS, 5)
    for k in range(OY4_ROWS):
        comp = cta[:, :, k].gather(2, comp)
    e = torch.zeros((b, 1), dtype=torch.long, device=dev)
    cta_entry = torch.empty((b, N // OY4_ROWS), dtype=torch.long, device=dev)
    for k in range(N // OY4_ROWS):
        cta_entry[:, k] = e[:, 0]
        e = comp[:, k].gather(1, e)
    entry = torch.empty((b, N // OY4_ROWS, OY4_ROWS), dtype=torch.long,
                        device=dev)
    e = cta_entry
    for k in range(OY4_ROWS):
        entry[:, :, k] = e
        e = cta[:, :, k].gather(2, e[..., None])[..., 0]
    entry = rs[entry.reshape(b, N)]
    lane_entry = _oy4_at(pre, entry[..., None])
    return {"I": I, "tab": tab, "lane_pre": pre, "row_map": row_map,
            "entry": entry, "lane_entry": lane_entry}


def offset_y_low4_ref(plane, m1: int = 8):
    """Torch twin of ``offset_y_low4``: pass 1 row by row (as S2's), the
    tables and maps of ``offset_y_low4_plan``, then each lane's tile
    walked again from its entry state for the values and the ticks, and
    the codes, with quant and quant6 from the ticks' prefix counts along
    the row."""
    b = plane.shape[0]
    p = offset_y_low4_plan(plane)
    I = p["I"]
    i0, i1, _, incol, _, _ = _oy4_pos(I)
    tiles = p["tab"].reshape(b, N, OY4_LANES, OY4_TILE)
    i0t = i0.reshape(b, N, OY4_LANES, OY4_TILE)
    s = p["lane_entry"]
    a0 = torch.empty_like(i0t)
    up = torch.empty(i0t.shape, dtype=torch.bool, device=I.device)
    for k in range(OY4_TILE):
        v = i0t[..., k]
        a0[..., k] = torch.where(s < 3, v, torch.where(
            s < 6, torch.where(v == 7, 9, -8), torch.where(s == 6, v - 2,
                                                           v + 2)))
        s = _oy4_at(tiles[..., k], s)
        up[..., k] = s == 6
    a0, up = a0.reshape(I.shape), up.reshape(I.shape)
    sent = a0 > 10000
    esc = ~sent & ((a0 > 127) | (a0 < -127))
    neg = (a0 < 0) & ~esc
    a1 = torch.where((a0 == -7) & (i1 == 8) & incol, -8, a0)
    an = -a1
    an = torch.where((an > 14) & ((an & 7) == 7) & (i1 > 0) & (i1 < 8),
                     an - 2, an)
    t15 = neg & (an == 15)
    t22 = neg & ~t15 & (an > 22) & ((an & 7) == 7)
    c15 = torch.cumsum(t15.int(), -1) - t15.int()
    c22 = torch.cumsum(t22.int(), -1) - t22.int()
    keep = (t15 & (c15 % 6 != 0)) | (t22 & (c22 % 4 != 0))
    a = torch.where(neg, -torch.where(keep, an, an & 504), a0 + 2 * up)
    code = torch.where((a > -m1) & (a < m1), 128, (a + 128) & 248)
    code = torch.where(esc, _escape_code(a0), code)
    code = torch.where(sent, _sentinel_code(a0), code)
    return torch.where(a0 == 0, 128, code).to(torch.int16)


def offset_y_low4_device(plane, m1: int = 8):
    """``host.ops.quantize.offset_y`` on a (B, 512, 512) int16 plane for q
    <= LOW4: pass 1 (no passes 2-3 at these qualities) and the quantizer
    with the duty-cycle counters.  Returns the code plane, int16 (kernel
    ``offset_y_low4``: S2's pass-1 launch, then one launch of a warp a
    row, OY4_ROWS rows a CTA chained by a look-back, after a fill of the
    look-back's words)."""
    _check_plane(plane, "offset_y_low4 plane", N)
    if plane.device.type == "cpu":
        return offset_y_low4_ref(plane, m1)
    lib, stream = _cuda_args(plane)
    b = plane.shape[0]
    tmp = torch.empty_like(plane)
    look = torch.empty(1 + b * (N // OY4_ROWS), dtype=torch.int32,
                       device=plane.device)
    out = torch.empty_like(plane)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_offset_y_low4", lib.nhw_offset_y_low4(
                plane.data_ptr(), tmp.data_ptr(), look.data_ptr(),
                out.data_ptr(), _escape_table(plane.device).data_ptr(), b,
                m1, stream))
        build.count("offset_y_low4")
    return out


def offset_uv_device(plane, m2: int = 8):
    """``host.ops.quantize.offset_uv`` on a (B, 256, 256) int16 plane, in
    torch ops: the 7 -> 8 fixup and the 120-pair greedy are both
    initial-value-pure (runs of 7s alternate from the run head; the
    pairs are the run parity), and the masking reads initial right
    neighbours."""
    _check(plane, "offset_uv plane", torch.int16, (None, D, D))
    b = plane.shape[0]
    If = _i32(plane).reshape(b, -1)
    n = If.shape[-1]
    idx = torch.arange(n, device=If.device, dtype=torch.int32)
    col = idx & (D - 1)
    IL = _flat_shift_l(If)
    incol = col < D - 1
    plain = (If <= 10000) & (If.abs() <= 127)
    R = If == 7
    Rp = _flat_shift_r(R, 1, False)
    is_start = R & ~(Rp & (col != 0))
    start = torch.cummax(torch.where(is_start, idx, -1), dim=1).values
    t7 = plain & (If > 6) & ((If & 7) >= 6) & (If != 7)
    fh = is_start & (col != 0) & _flat_shift_r(t7, 1, False)
    s0 = start.clamp(min=0)
    fh_at = torch.take_along_dim(fh.to(torch.int32), s0.long(), dim=1)
    fixed = R & (start >= 0) & ((fh_at ^ ((idx - s0) & 1)) == 1)
    v = torch.where(fixed, 8, If)
    m78 = (v == -7) | (v == -8)
    F = m78 & incol & ((IL == -7) | (IL == -8))
    fired = _run_parity_fire(F)
    is120 = fired | _flat_shift_r(fired, 1, False)
    an = -v
    neg_next = (IL > -8) & (IL < 0)
    keep = torch.where(neg_next, (an & 7) >= 6, (an & 7) >= 7)
    aq = torch.where(v < 0, -torch.where(keep, an, an & 504), v)
    code = torch.where((aq > -m2) & (aq < m2), 128, (aq + 128) & 248)
    # only the four mapped sentinels short-circuit; any other > 10000
    # value takes the escape path (the host dict .get miss)
    sent = (If == 12400) | (If == 12600) | (If == 12900) | (If == 13000)
    sent_code = torch.where(If == 12400, 124, torch.where(
        If == 12600, 126, torch.where(If == 12900, 122, 130)))
    esc = ((If > 127) & ~sent) | (If < -127)
    out = torch.where(sent, sent_code,
                      torch.where(esc, _escape_code(If), code))
    out = torch.where(is120, 120, out)
    return out.reshape(plane.shape).to(torch.int16)


# ---------------------------------------------------------------------------
# E15: serpentine interleave + the stream fixups
# (encoder/nhw_encoder.c:2111-2252; host.ops.quantize)


@functools.lru_cache(maxsize=1)
def _y_serp_inverse() -> np.ndarray:
    perm = np.asarray(geometry.y_deserpentine_map())
    inv = np.empty(perm.size, np.int64)
    inv[perm] = np.arange(perm.size)
    return inv


@functools.lru_cache(maxsize=1)
def _uv_serp_inverse() -> np.ndarray:
    perm = np.asarray(geometry.uv_deserpentine_map())
    inv = np.empty(perm.size, np.int64)
    inv[perm] = np.arange(perm.size)
    return inv


@functools.lru_cache(maxsize=8)
def _serp_index(kind: str, dev: torch.device) -> torch.Tensor:
    inv = _y_serp_inverse() if kind == "y" else _uv_serp_inverse()
    return torch.from_numpy(inv).to(dev)


def _serpentine(codes: torch.Tensor, kind: str) -> torch.Tensor:
    flat = (codes.reshape(codes.shape[0], -1) & 255).to(torch.uint8)
    return flat.index_select(1, _serp_index(kind, codes.device))


def serpentine_y_device(codes):
    """(B, 512, 512) int16 code plane -> (B, 4 SZ) uint8 stream (the Y
    part of im_nhw)."""
    _check(codes, "serpentine_y codes", torch.int16, (None, N, N))
    return _serpentine(codes, "y")


def serpentine_uv_device(codes):
    """(B, 256, 256) int16 -> (B, SZ) uint8 serpentine stream (the caller
    interleaves U at even and V at odd offsets of im_nhw[4 SZ:])."""
    _check(codes, "serpentine_uv codes", torch.int16, (None, D, D))
    return _serpentine(codes, "uv")


def _merge_steps(v: torch.Tensor):
    """Per position of a (B, >= 4 SZ + 8) int32 stream: the cursor's skip
    k (1..5, 1 at or past the walk's end), the fire pattern (positions
    before the end only) and the fire's code."""
    idx = torch.arange(v.shape[-1], device=v.device)
    v1, v2, v3, v4 = (_flat_shift_l(v, k) for k in (1, 2, 3, 4))
    c1 = (v != 128) & (v1 == 128)
    pat = c1 & (v2 == 128) & (v3 == 128)
    fire_p = (pat & ((v == 136) | (v == 120)) & ((v4 == 136) | (v4 == 120))
              & (idx < MERGE_END))
    k = torch.where(~c1, 1, torch.where(v2 != 128, 2, torch.where(
        v3 != 128, 3, torch.where(fire_p, 5, 4))))
    k = torch.where(idx < MERGE_END, k, 1)
    code = torch.where(v == 136, torch.where(v4 == 136, 132, 133),
                       torch.where(v4 == 136, 134, 135))
    return k, fire_p, code


def _walk_maps(km1: torch.Tensor, state: torch.Tensor,
               fire: torch.Tensor | None = None):
    """Walk the skip machine over the last axis of ``km1`` (k - 1 per
    position) from each of ``state``'s entries (a trailing axis); returns
    the states after the walk and, with ``fire`` (the fire patterns, the
    shape of ``km1``), the fires of each walk (..., positions, entries)."""
    fires = []
    for t in range(km1.shape[-1]):
        k = km1[..., t, None]
        if fire is not None:
            fires.append((state == 0) & fire[..., t, None])
        state = torch.where(state > 0, state - 1, k)
    return state, (torch.stack(fires, -2) if fire is not None else None)


def _then(f: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """The map of f, then g (5-state maps along the last axis)."""
    return torch.gather(g, -1, f)


def _scan_maps(maps: torch.Tensor, dim: int) -> tuple:
    """Inclusive and exclusive scans of 5-state maps (..., M, 5) along
    ``dim`` (the axis of M) by doubling steps, as a warp's shuffles
    compose them: (inclusive, exclusive)."""
    n = maps.shape[dim]
    ident = torch.arange(5, device=maps.device).expand_as(maps)
    idx = torch.arange(n, device=maps.device)
    shape = [1] * maps.dim()
    shape[dim] = n
    lane = idx.reshape(shape)
    inc = maps
    d = 1
    while d < n:
        before = torch.cat([ident.narrow(dim, 0, d),
                            inc.narrow(dim, 0, n - d)], dim)
        inc = torch.where(lane >= d, _then(before, inc), inc)
        d <<= 1
    exc = torch.cat([ident.narrow(dim, 0, 1), inc.narrow(dim, 0, n - 1)],
                    dim)
    return inc, exc


def merge_crossing_plan(s: torch.Tensor) -> dict:
    """The kernel's decomposition of ``merge_crossing`` on a (B, >= 4 SZ)
    uint8 stream: each thread's map over its 64 positions from the 5 entry
    states (skips left), the warps' inclusive scans of their 32 maps, the
    CTAs' scans of their 16 warp composites, each CTA's word (composite,
    its map up to its last 4 positions, their fires from each state), the
    cluster's chain of the 8 words from state 0, each thread's entry state
    and the fires of the previous CTA's last 4 positions a CTA starts from.
    Returns the step tensors (v, km1, fire_p, code) and "entry" (B,
    4096), "prev4" (B, 8, 4), "cta_entry" (B, 8)."""
    b, n = s.shape
    dev = s.device
    v = _i32(s)
    if n < MERGE_LEN + 8:
        v = torch.cat([v, v.new_zeros((b, MERGE_LEN + 8 - n))], 1)
    k, fire_p, code = _merge_steps(v)
    km1 = (k - 1)[:, :MERGE_LEN]
    fire_p = fire_p[:, :MERGE_LEN]
    warps = MERGE_THREADS // 32
    tk = km1.reshape(b, MERGE_CTAS, warps, 32, MERGE_TILE)
    tf = fire_p.reshape(tk.shape)
    ident = torch.arange(5, device=dev).expand(tk.shape[:-1] + (5,))
    maps, _ = _walk_maps(tk, ident)                # (B, 8, 16, 32, 5)
    inc, exc = _scan_maps(maps, 3)
    wmaps = inc[:, :, :, -1]                       # (B, 8, 16, 5)
    cinc, wpre = _scan_maps(wmaps, 2)
    comp = cinc[:, :, -1]                          # (B, 8, 5)
    # the CTA's last thread: its map over its first 60 positions after its
    # prefix, and the fires of its last 4 from each state
    last = (slice(None), slice(None), -1, -1)
    p60, _ = _walk_maps(tk[last][..., :MERGE_TILE - 4], ident[last])
    partial = _then(_then(wpre[:, :, -1], exc[last]), p60)
    _, tab = _walk_maps(tk[last][..., MERGE_TILE - 4:], ident[last],
                        tf[last][..., MERGE_TILE - 4:])   # (B, 8, 4, 5)
    e = torch.zeros((b, 1), dtype=torch.long, device=dev)
    entries, prev4 = [], [torch.zeros((b, 4), dtype=torch.bool, device=dev)]
    for c in range(MERGE_CTAS):
        entries.append(e[:, 0])
        if c + 1 < MERGE_CTAS:
            st = partial[:, c].gather(1, e)
            prev4.append(tab[:, c].gather(2, st[:, None].expand(b, 4, 1))
                         [..., 0])
        e = comp[:, c].gather(1, e)
    cta_entry = torch.stack(entries, 1)            # (B, 8)
    we = wpre.gather(3, cta_entry[:, :, None, None].expand(
        b, MERGE_CTAS, warps, 1))                  # (B, 8, 16, 1)
    entry = exc.gather(4, we[:, :, :, None].expand(
        b, MERGE_CTAS, warps, 32, 1))[..., 0]      # (B, 8, 16, 32)
    return {"v": v, "km1": km1, "fire_p": fire_p, "code": code,
            "entry": entry.reshape(b, -1), "prev4": torch.stack(prev4, 1),
            "cta_entry": cta_entry}


def merge_crossing_ref(s: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``merge_crossing`` in its decomposition
    (``merge_crossing_plan``): each thread walks its 64 positions again
    from its entry state for its fire bits; a thread's first 4 bytes take
    the previous thread's last 4 fires, a CTA's first thread the previous
    CTA's from the cluster's chain; out[i] = fire[i - 4] ? 201 : fire[i] ?
    code[i] : v[i] over [0, 4 SZ), the rest copied."""
    b = s.shape[0]
    plan = merge_crossing_plan(s)
    threads = MERGE_LEN // MERGE_TILE
    tk = plan["km1"].reshape(b, threads, MERGE_TILE)
    tf = plan["fire_p"].reshape(tk.shape)
    _, fire = _walk_maps(tk, plan["entry"][..., None], tf)
    fire = fire[..., 0]                             # (B, threads, 64)
    prev = torch.cat([torch.zeros_like(fire[:, :1, -4:]), fire[:, :-1, -4:]],
                     1)
    starts = torch.arange(MERGE_CTAS, device=s.device) * MERGE_THREADS
    prev[:, starts] = plan["prev4"]
    before = torch.cat([prev, fire[..., :-4]], -1).reshape(b, -1)
    fire = fire.reshape(b, -1)
    n = MERGE_LEN
    val = torch.where(before, 201, torch.where(
        fire, plan["code"][:, :n], plan["v"][:, :n]))
    out = s.clone()
    out[:, :n] = val.to(torch.uint8)
    return out


def merge_crossing_device(s):
    """``host.ops.quantize.merge_crossing_codes`` on a (B, >= 4 SZ)
    uint8 stream: 136/120 codes across 3-gap 128 runs merge into
    132-135 + 201.  The cursor walk's decisions depend only on the input
    bytes, so the result is a new stream (kernel ``merge_crossing``:
    one cluster launch of 8 CTAs a stream)."""
    _check(s, "merge_crossing stream", torch.uint8, (None, None))
    if not s.is_contiguous() or s.shape[1] < MERGE_LEN:
        raise ValueError("merge_crossing: stream must be contiguous and "
                         f"at least {MERGE_LEN} bytes")
    if s.device.type == "cpu":
        return merge_crossing_ref(s)
    lib, stream = _cuda_args(s)
    b, n = s.shape
    out = torch.empty_like(s)
    if b:
        with torch.cuda.device(s.device):
            build.check("nhw_merge_crossing", lib.nhw_merge_crossing(
                s.data_ptr(), out.data_ptr(), b, n, stream))
        build.count("merge_crossing")
    return out


def select_codes_device(s):
    """``host.ops.quantize.select_codes`` on a (B, >= 4 SZ) uint8
    stream: returns (stream', sel1, sel2).  Every == 128 test is
    write-invariant (a write replaces one non-128 value with another),
    the next-byte reads are initial, and the only chain is consumption by
    the previous candidate's c1/c2 fire: the run parity."""
    _check(s, "select_codes stream", torch.uint8, (None, None))
    n = s.shape[1]
    idx = torch.arange(n, device=s.device)
    v = torch.where((idx < 4) | ((idx >= 4 * SZ - 4) & (idx < 4 * SZ)),
                    128, _i32(s))
    e128 = v == 128
    vl1 = _flat_shift_l(v)

    def sr(x, k):
        return _flat_shift_r(x, k, False)

    def sl(x, k):
        return _flat_shift_l(x, k, False)

    cand = ((v == 136) | (v == 120)) & (idx >= 4) & (idx < 4 * SZ - 4)
    nxt_in = (vl1 == 120) | (vl1 == 136)
    back4 = sr(e128, 1) & sr(e128, 2) & sr(e128, 3) & sr(e128, 4)
    c1 = sl(e128, 2) & nxt_in & back4
    c2 = (sr(e128, 1) & nxt_in & sl(e128, 2) & sl(e128, 3) & sl(e128, 4)
          & sl(e128, 5))
    c3 = back4 & sl(e128, 1)
    c4 = sr(e128, 1) & sl(e128, 1) & sl(e128, 2) & sl(e128, 3) & sl(e128, 4)
    fired12 = _run_parity_fire(cand & (c1 | c2))
    consumed = sr(fired12, 1)
    fired34 = cand & ~consumed & ~(c1 | c2) & (c3 | c4)
    code12 = _flat_shift_r(torch.where(vl1 == 120, 157, 159))
    out = torch.where(sr(fired12, 1), code12, v)
    out = torch.where(fired34, torch.where(v == 136, 153, 155), out)
    sel1 = fired34.sum(-1, dtype=torch.int32)
    sel2 = fired12.sum(-1, dtype=torch.int32)
    return out.to(torch.uint8), sel1, sel2


def cap_long_runs_device(s):
    """``host.ops.quantize.cap_long_runs`` on a (B, >= 4 SZ) uint8
    stream, closed form per maximal 128-run: the count crosses 255 at
    in-run offsets 255 + 254 m; only the last crossing's i + 2 / i + 3
    reach past the run's end (demoting 153 -> 124 / 155 -> 123 there),
    and a residual count >= 252 demotes the first byte after the run.
    Runs are static (demotes replace non-128 values)."""
    _check(s, "cap_long_runs stream", torch.uint8, (None, None))
    v = _i32(s)
    idx = torch.arange(v.shape[-1], device=s.device, dtype=torch.int32)
    r128 = v == 128
    is_start = r128 & ~_flat_shift_r(r128, 1, False)
    start = torch.cummax(torch.where(is_start, idx, -1), dim=-1).values
    is_end = r128 & ~_flat_shift_l(r128, 1, False)
    L = idx - start + 1
    run_ok = is_end & (start < 4 * SZ) & (L >= 2) & (start >= 0)

    def is_cross(off):
        return (off >= 255) & (((off - 255) % 254) == 0)

    dem_both = run_ok & is_cross(L - 2)
    dem_one = run_ok & is_cross(L - 3)
    M = torch.where(L >= 257, (L - 257) // 254 + 1, 0)
    dem_res = run_ok & (L - 1 - 254 * M >= 252)
    dem = (_flat_shift_r(dem_both | dem_one | dem_res, 1, False)
           | _flat_shift_r(dem_both, 2, False))
    out = torch.where(dem & (v == 153), 124,
                      torch.where(dem & (v == 155), 123, v))
    return out.to(torch.uint8)


# ---------------------------------------------------------------------------
# E11 tail: the mid-q band cleanup and pair promotion
# (host.models.encoder._mid_q_band_cleanup / _pair_promotion,
#  encoder/nhw_encoder.c:785-803, 970-1074)


def mid_q_band_cleanup_device(plane):
    """``_mid_q_band_cleanup`` (LOW5 < q < NORM) on a (B, 512, 512) int16
    plane: small lower-half coefficients snap to +-7, elementwise (|v| in
    [8, 9) on the left half, [8, 14] on the right)."""
    _check_plane(plane, "mid_q_band_cleanup plane", N)
    I = _i32(plane)
    lower = I[:, D:]
    av = lower.abs()
    col = torch.arange(N, device=plane.device)
    m = (av >= 8) & torch.where(col < D, av < 9, av <= 14)
    out = I.clone()
    out[:, D:] = torch.where(m, torch.where(lower > 0, 7, -7), lower)
    return out.to(torch.int16)


def low56_band_cleanup_device(plane, thrx2: int):
    """``_low56_band_cleanup`` (LOW6 <= q <= LOW5; thrx2 19 at LOW5, 20 at
    LOW6) on a (B, 512, 512) int16 plane, elementwise on the lower half:
    |v| in [8, 11) on the left half becomes 0, |v| in [8, thrx2) on the
    right half +-7 from |v| >= 14, else 0."""
    _check_plane(plane, "low56_band_cleanup plane", N)
    I = _i32(plane)
    lower = I[:, D:]
    av = lower.abs()
    col = torch.arange(N, device=plane.device)
    left = col < D
    m = (av >= 8) & torch.where(left, av < 11, av < thrx2)
    snap = torch.where(lower >= 14, 7, torch.where(lower <= -14, -7, 0))
    out = I.clone()
    out[:, D:] = torch.where(m, torch.where(left, 0, snap), lower)
    return out.to(torch.int16)


# ---------------------------------------------------------------------------
# E11 at q < LOW6: the lowest-q band cleanup (host.models.encoder.
# _lowest_q_band_cleanup, encoder/nhw_encoder.c:833-968).  Loop A walks rows
# 0..255 over columns 256..511, each row on its own: its left boundary
# (column 255) and the right neighbour of column 511 (the next row's column
# 0) are read before anything writes them.  Loops B and C are one walk over
# columns 0..510 of rows 256..511, the parameters switching at column 256;
# it crosses a row only through column 511, which it never visits: the next
# row's column-0 visit reads it as its left neighbour, as it was or zeroed
# by the row's pairR at column 510.  So each row of B + C has two entry
# states, and its map from entry to exit (pairR at 510) chains the rows.

LQ_R3_EXT = SZ + 256            # resIII and the heap-alias tail
LQ_R3_MIN = ((SZ - 2) >> 1) + (SZ >> 1) + 128 + 1   # the last row's reads


# The kernel's decomposition (csrc/lowq.cu lowest_q_rows): a cluster of
# LQ_CTAS CTAs an image, CTA k on rows 32 k.. of loop A and 256 + 32 k.. of
# B + C; a warp a row, a lane a tile of LQ_A_TILE visits of loop A (columns
# 256 + 8 l..) or LQ_BC_TILE of B + C (columns 16 l..; lane 31 the last 15).
LQ_CTAS = 8
LQ_ROWS = D // LQ_CTAS
LQ_A_TILE = 8
LQ_BC_TILE = 16
# The carry into a visit: 0 (left the input at the column before), 1 (left
# 0), 2 (left 0, the visit's value zeroed by the last visit's pairR), 3
# (left +7), 4 (left -7).  A visit's table gives the next state from each:
# 2 after pairR, 1 where it wrote 0, 3 or 4 where it snapped to +-7, 0
# where it kept its input; state 2's is 1.
LQ_STATE_LEFT = (None, 0, 0, 7, -7)


def _lq_tables(x, xl, right, r3ok, thi, tlo, lo2, x5, snap):
    """Each visit's table over the 5 carry states, (next (..., 5) int64,
    pairL (..., 5) bool), from its input x, xl the input before it (state
    0's left), right the input after it and its r3 test.  Phase 1 writes 0
    where it fires, so phase 2 reads the neighbours as the visit found
    them.  lo2: |v| below it zeroes (0: never); snap: +-16 and beyond
    become +-7 instead of 0."""
    av = x.abs()
    c1 = (av >= 8) & (av < thi)
    z = c1 & r3ok
    c1n = c1 & ~r3ok
    rok = right.abs() < x5
    prv = (x + right).abs() < x5
    c2 = (av >= 8) & (av < tlo)
    lo = av < lo2
    r8 = right.abs() < 8
    hit_next = torch.where(snap & (x >= 16), 3, torch.where(
        snap & (x <= -16), 4, 1))
    nexts, pls = [], []
    for s, left in enumerate(LQ_STATE_LEFT):
        if s == 2:
            nexts.append(torch.ones_like(hit_next))
            pls.append(torch.zeros_like(c1))
            continue
        if left is None:
            left = xl
        else:
            left = torch.full_like(x, left)
        pl = c1n & ((x + left).abs() < x5) & rok
        pr = c1n & ~pl & prv & (left.abs() < x5)
        f1 = z | pl | pr
        hit = ~f1 & c2 & (((left.abs() < 8) & r8) | lo)
        nexts.append(torch.where(pr, 2, torch.where(f1, 1, torch.where(
            hit, hit_next, 0))))
        pls.append(pl)
    return torch.stack(nexts, -1).long(), torch.stack(pls, -1)


def _lq_value(state, x):
    """The value a visit leaves at input x when it moves to ``state``."""
    return torch.where(state == 0, x, torch.where(state == 3, 7, torch.where(
        state == 4, -7, 0)))


def _lq_lane_maps(nxt):
    """Each lane's map of its tile, composed in order from the visits'
    tables (..., tile, 5) -> (..., 5)."""
    m = torch.arange(5, device=nxt.device).expand(nxt.shape[:-2] + (5,))
    for k in range(nxt.shape[-2]):
        m = _then(m, nxt[..., k, :])
    return m


def _lq_walk(nxt, pl, state, x):
    """Each lane's tile walked from ``state`` (...) by its tables: (the
    exit state, the values (..., tile), pairL (..., tile))."""
    vals, pls = [], []
    for k in range(nxt.shape[-2]):
        s = state[..., None]
        pls.append(pl[..., k, :].gather(-1, s)[..., 0])
        state = nxt[..., k, :].gather(-1, s)[..., 0]
        vals.append(_lq_value(state, x[..., k]))
    return state, torch.stack(vals, -1), torch.stack(pls, -1)


def _lq_args(plane, r3_ext, xs) -> None:
    _check_plane(plane, "lowest_q_band_cleanup plane", N)
    b = plane.shape[0]
    _check(r3_ext, "lowest_q_band_cleanup r3_ext", torch.int16, (b, None))
    _check(xs, "lowest_q_band_cleanup xs", torch.int32, (b, 5))
    if r3_ext.shape[1] < LQ_R3_MIN:
        raise ValueError(f"lowest_q_band_cleanup r3_ext: rows of "
                         f"{r3_ext.shape[1]}; the last plane row reads up "
                         f"to {LQ_R3_MIN}")
    if not (r3_ext.is_contiguous() and xs.is_contiguous()):
        raise ValueError("lowest_q_band_cleanup: inputs must be contiguous")


def _lq_r3ok(r3, idx, thr):
    """|r3[image, idx]| < thr[image] for an index table (rows, cols)."""
    b = r3.shape[0]
    v = r3.gather(1, idx.reshape(1, -1).expand(b, -1)).reshape(
        (b,) + idx.shape)
    return v.abs() < thr.reshape(b, 1, 1)


def lowest_q_band_cleanup_plan(plane, r3_ext, quality: int, xs) -> dict:
    """The kernel's decomposition of ``lowest_q_band_cleanup``: each
    visit's table over the 5 carry states, each lane tile's map composed
    from them, the warps' scans of their 32 lane maps; loop A's rows walked
    from their state 0; B + C's rows' maps from their entry state to the
    next row's (pairR at 510 or not), composed over each CTA's 32 rows,
    then chained over the cluster's 8 CTAs from row 256's entry (loop A's
    row 255's exit).  Returns the inputs and tables ("x", "nxt", "pl", for
    loop A (B, 256, 32, 8) and B + C (B, 256, 32, 16)), loop A's lane
    entries and walk ("a_entry", "a_state", "a_vals", "a_pl") and B + C's
    entries: "e256" (B,),
    "cta_entry" (B, 8), "row_entry" (B, 256), "lane_entry" (B, 256, 32)."""
    _lq_args(plane, r3_ext, xs)
    dev = plane.device
    b = plane.shape[0]
    I = _i32(plane)
    r3 = _i32(r3_ext)
    x1, x2, x3, x4, x5 = (xs[:, k].to(torch.int32).reshape(b, 1, 1, 1)
                          for k in range(5))
    gt10 = torch.tensor(quality > T.LOW10, device=dev)
    no = torch.tensor(False, device=dev)
    row = torch.arange(D, device=dev).reshape(D, 1)
    col = torch.arange(D, device=dev).reshape(1, D)
    half = (row * D + col) >> 1
    lanes = torch.arange(32, device=dev)

    def tiles(a, t):
        return a.reshape(b, D, 32, t)

    # loop A: rows 0..255, columns 256..511 (a column's r3 value at its
    # half index)
    okA = _lq_r3ok(r3, half + 128, x4)
    xa = I[:, :D, D:]
    xla = I[:, :D, D - 1:N - 1]
    ra = torch.cat([I[:, :D, D + 1:], I[:, 1:D + 1, :1]], 2)
    ta = LQ_A_TILE
    na, pa = _lq_tables(tiles(xa, ta), tiles(xla, ta), tiles(ra, ta),
                        tiles(okA, ta), x3 + 2, x3, 0, x5, no)
    _, exc = _scan_maps(_lq_lane_maps(na), 2)
    a_entry = exc[..., 0]
    a_state, a_vals, a_pl = _lq_walk(na, pa, a_entry, tiles(xa, ta))
    e256 = a_state[:, D - 1, 31]
    # B + C: rows 256..511, columns 0..510 (column 511 not visited)
    H = I[:, D:]
    okH = torch.cat([_lq_r3ok(r3, half + (SZ >> 1), x4),
                     _lq_r3ok(r3, half + (SZ >> 1) + 128, x4 + 1)], 2)
    xlh = torch.cat([I[:, D - 1:N - 1, N - 1:], H[..., :-1]], 2)
    rh = torch.cat([H[..., 1:], H[..., -1:]], 2)
    tb = LQ_BC_TILE
    segc = (lanes >= 16).reshape(1, 1, 32, 1)
    nb, pb = _lq_tables(
        tiles(H, tb), tiles(xlh, tb), tiles(rh, tb), tiles(okH, tb),
        torch.where(segc, x2 + 1, x1 + 2), torch.where(segc, x2, x1),
        torch.where(segc, x2 - 5, x1 - 4), x5, segc & gt10)
    last = (slice(None), slice(None), 31, tb - 1)
    nb[last] = torch.arange(5, device=dev)
    pb[last] = False
    inc, lane_pre = _scan_maps(_lq_lane_maps(nb), 2)
    row_map = (inc[:, :, 31] == 2).long()       # the next row's entry
    cinc, row_pre = _scan_maps(row_map.reshape(b, LQ_CTAS, LQ_ROWS, 5), 2)
    comp = cinc[:, :, -1]
    e = e256[:, None]
    cta_entry = []
    for c in range(LQ_CTAS):
        cta_entry.append(e[:, 0])
        e = comp[:, c].gather(1, e)
    cta_entry = torch.stack(cta_entry, 1)
    row_entry = row_pre.gather(3, cta_entry[:, :, None, None].expand(
        b, LQ_CTAS, LQ_ROWS, 1)).reshape(b, D)
    lane_entry = lane_pre.gather(3, row_entry[:, :, None, None].expand(
        b, D, 32, 1))[..., 0]
    return {"xa": tiles(xa, ta), "na": na, "pa": pa, "a_entry": a_entry,
            "a_state": a_state,
            "a_vals": a_vals, "a_pl": a_pl, "e256": e256,
            "xb": tiles(H, tb), "nb": nb, "pb": pb, "cta_entry": cta_entry,
            "row_entry": row_entry, "lane_entry": lane_entry}


def lowest_q_band_cleanup_ref(plane, r3_ext, quality: int, xs):
    """Torch twin of ``lowest_q_band_cleanup`` in its decomposition
    (``lowest_q_band_cleanup_plan``): each lane walks its tile again from
    its entry state; pairL on a lane's first visit zeroes the previous
    lane's last column; loop A's pairL at 256 zeroes column 255, its pairR
    at 511 the next row's column 0; B + C's column 511 is zeroed by the
    row's pairR at 510 or by the next row's pairL at column 0 from state 0
    (its entry where there was no pairR), row 255's by row 256's from row
    256's entry."""
    plan = lowest_q_band_cleanup_plan(plane, r3_ext, quality, xs)
    b = plane.shape[0]
    out = _i32(plane).clone()

    def zero_before(vals, pl):
        """Each value zeroed by the next visit's pairL (the next lane's
        first for a lane's last)."""
        nxt = torch.cat([pl[..., 1:], torch.cat(
            [pl[:, :, 1:, :1], torch.zeros_like(pl[:, :, :1, :1])], 2)], -1)
        return torch.where(nxt, 0, vals)

    # loop A
    a_vals = zero_before(plan["a_vals"], plan["a_pl"])
    pl256 = plan["a_pl"][:, :, 0, 0]
    flag = plan["a_state"][:, :, 31] == 2
    # row 255's column 511: row 256's first visit from its entry
    e256 = plan["e256"]
    t256 = plan["pb"][:, 0, 0, 0].gather(1, e256[:, None])[:, 0]
    a_vals[:, D - 1, 31, -1] = torch.where(t256, 0,
                                           a_vals[:, D - 1, 31, -1])
    out[:, :D, D:] = a_vals.reshape(b, D, D)
    out[:, :D, D - 1] = torch.where(pl256, 0, out[:, :D, D - 1])
    out[:, 1:D, 0] = torch.where(flag[:, :-1], 0, out[:, 1:D, 0])
    # B + C
    st, vals, pl = _lq_walk(plan["nb"], plan["pb"], plan["lane_entry"],
                            plan["xb"])
    vals = zero_before(vals, pl)
    x511 = plan["xb"][:, :, 31, -1]
    pr510 = st[:, :, 31] == 2
    pl0 = torch.cat([plan["pb"][:, 1:, 0, 0, 0],
                     torch.zeros_like(pr510[:, :1])], 1)
    vals[:, :, 31, -1] = torch.where(pr510 | pl0, 0, x511)
    out[:, D:] = vals.reshape(b, D, N)
    return out.to(torch.int16)


def lowest_q_band_cleanup_device(plane, r3_ext, quality: int, xs):
    """``_lowest_q_band_cleanup`` (q < LOW6) on a (B, 512, 512) int16
    plane, bit-exact vs the host copy's C: r3_ext (B, >= LQ_R3_MIN) int16
    is resIII followed by the heap-alias tail the last rows read (the
    free-time kernel's [131080:131084], 24593, tree1's first 496 bytes as
    int16 pairs), xs (B, 5) int32 each image's (x1, x2, x3, x4, x5), and
    quality > LOW10 turns on C's +-7 snap.  Returns a new plane (kernel
    ``lowest_q_band_cleanup``: one launch, a cluster of 8 CTAs an image, a
    warp a row, each visit a table of the next carry state)."""
    _lq_args(plane, r3_ext, xs)
    if plane.device.type == "cpu":
        return lowest_q_band_cleanup_ref(plane, r3_ext, quality, xs)
    lib, stream = _cuda_args(plane, r3_ext, xs)
    b = plane.shape[0]
    out = torch.empty_like(plane)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_lowest_q_band_cleanup",
                        lib.nhw_lowest_q_band_cleanup(
                            plane.data_ptr(), r3_ext.data_ptr(),
                            xs.data_ptr(), out.data_ptr(), b,
                            r3_ext.shape[1], int(quality > T.LOW10), stream))
        build.count("lowest_q_band_cleanup")
    return out


# The two regions of pair promotion: (rows [r0, r1), columns [c0, c1),
# the band rules).  They share no row, and the C's chain never leaves a row:
# its promotions of 7/-7 pairs and the lower block's vertical cases are
# dead (4 < v < 8 and -8 < v < -4 take v = 7, -6 and -7 first), so the
# only reads of another row never happen.
PP_REGIONS = ((1, D - 1, D + 1, 2 * D - 1, True),
              (D + 1, 2 * D - 1, 1, D - 1, False))
# The kernel's decomposition of a region row (csrc/residue.cu
# pair_promotion_rows): its 256 columns c0 - 1 .. c0 + 254, 8 a lane; lane
# l walks visits c0 + 8 l .. c0 + 8 l + 7 (lane 31 the last 6) and writes
# columns c - 1, its own.
PP_TILE = 8
PP_LANES = 32
# The walk's carry between visits, (left, cur) as the last visit left
# them, is one of nine states: 0 (in, in), 1 (10100, in), 2 (9, in),
# 3 (-9, in), 4 (10, in), 5 (12700, 10100), 6 (12900, 10100), 7 (9, 9),
# 8 (-9, -9) ("in": the input value).  A visit reads them through three
# classes: A (0), B (1-4: left a constant, of the class "other"), C (5-8:
# cur a constant, which fires nothing).  So a visit is a table of the next
# state, fixed by its inputs: A's and B's the state the rule that fires
# leaves (none 0, the 12700 triple 5, the 12900 triple 6, 8 -> 10 4,
# -8 -> -9 3, 8/8 -> 9/9 7, -8/-8 -> -9/-9 8), C's PP_C_NEXT; each class's
# walks of two or more visits end in one state.
PP_LEFT = (0, 10100, 9, -9, 10, 12700, 12900, 9, -9)
PP_CUR = (0, 0, 0, 0, 0, 10100, 10100, 9, -9)
PP_C_NEXT = (0, 0, 0, 0, 0, 1, 1, 2, 3)
PP_CLASS = (0, 1, 1, 1, 1, 2, 2, 2, 2)
PP_CLASS_STATE = (0, 1, 5)       # the state each class's walk starts from


def _pp_fire(left, cur, right, band: bool):
    """The state a visit leaves when cur is the input: left the input
    (class A) or 0 (class B, "other"); 0 where no rule fires."""
    tri1 = ((cur > 4) & (cur < 8) & (left > 3) & (left <= 7) & (right > 3)
            & (right <= 7))
    tri2 = ((cur > -8) & (cur < -4) & (left > -8) & (left <= -4)
            & (right > -8) & (right <= -4))
    c6 = ((left & 65534) == 6) | ((right & 65534) == 6)
    c7 = (((-left) & 65534) == 6) | (((-right) & 65534) == 6)
    p9 = ~c6 & (right == 8) if band else torch.zeros_like(c6)
    pm9 = ~c7 & (right == -8) if band else torch.zeros_like(c7)
    e8 = torch.where(c6, 4, torch.where(p9, 7, 0))
    m8 = torch.where(c7, 3, torch.where(pm9, 8, 0))
    return torch.where(tri1, 5, torch.where(tri2, 6, torch.where(
        cur == 8, e8, torch.where(cur == -8, m8, 0))))


def _pp_tables(x, band: bool):
    """Each visit's next-state table of a lane's tile, (A's, B's) each
    (B, R, 32, 8), from x (B, R, 32, 10), the inputs at columns c - 1 ..
    c + 8 of the lane's first visit c."""
    v, r = x[..., 1:9], x[..., 2:10]
    return _pp_fire(x[..., :8], v, r, band), _pp_fire(
        torch.zeros_like(v), v, r, band)


def _pp_next(state, na, nb):
    c_next = torch.tensor(PP_C_NEXT, device=state.device)[state]
    return torch.where(state == 0, na, torch.where(state <= 4, nb, c_next))


def _pp_walk(x, tabs, state, nv, out: bool = False):
    """Each lane's tile walked from ``state`` (B, R, 32) by the visits'
    tables; nv (32,) the lane's visits.  Returns the exit state, and with
    ``out`` the tile's 8 columns: each visit's c - 1 (10100 where a triple
    fires from state 0, else the state's left value), then the carry's
    two values after the last."""
    na, nb = tabs
    dev = x.device
    left_c = torch.tensor(PP_LEFT, dtype=x.dtype, device=dev)
    cur_c = torch.tensor(PP_CUR, dtype=x.dtype, device=dev)
    cols = []
    for j in range(PP_TILE):
        on = j < nv
        if out:
            left = torch.where(state == 0, x[..., j], left_c[state])
            tri = (state == 0) & ((na[..., j] == 5) | (na[..., j] == 6))
            cur = torch.where(state <= 4, x[..., j], cur_c[state])
            cols.append(torch.where(on, torch.where(tri, 10100, left),
                                    torch.where(j == nv, left, cur)))
        state = torch.where(on, _pp_next(state, na[..., j], nb[..., j]),
                            state)
    return state, (torch.stack(cols, -1) if out else None)


def _pp_region_tiles(I, c0: int, band: bool):
    """A region's rows (I already cut to them) as lane tiles: (x (B, R,
    32, 10), each lane's inputs at columns c - 1 .. c + 8 of its first
    visit c; the visits' tables; the lanes' entry states (B, R, 32); nv
    (32,) their visits).  Each tile's map of exit states from the three
    entry classes (its walks from states 0, 1 and 5); an inclusive scan of
    the maps across the lanes by doubling steps, as the warp's shuffles
    compose them; a lane's entry the exclusive prefix applied to state
    0."""
    dev = I.device
    lane = torch.arange(PP_LANES, device=dev)
    nv = torch.where(lane == PP_LANES - 1, PP_TILE - 2, PP_TILE)
    cls = torch.tensor(PP_CLASS, device=dev)
    rows = I[..., c0 - 1:c0 - 1 + PP_LANES * PP_TILE]
    t = rows.reshape(*rows.shape[:2], PP_LANES, PP_TILE)
    nxt = torch.nn.functional.pad(t[..., 1:, :2], (0, 0, 0, 1))
    x = torch.cat([t, nxt], -1)
    tabs = _pp_tables(x, band)
    maps = torch.stack([_pp_walk(x, tabs, torch.full(
        x.shape[:3], s, dtype=torch.int64, device=dev), nv)[0]
        for s in PP_CLASS_STATE], -1)                     # (B, R, 32, 3)
    d = 1
    while d < PP_LANES:
        before = torch.cat([maps[:, :, :d], maps[:, :, :-d]], 2)
        comp = torch.gather(maps, -1, cls[before])
        maps = torch.where((lane >= d)[:, None], comp, maps)
        d <<= 1
    return (x, tabs, torch.nn.functional.pad(maps[:, :, :-1, 0], (1, 0)),
            nv)


def pair_promotion_entries(plane):
    """(B, 2, 254, 32) int64: each lane tile's entry state in the band
    rows (1..254) and the lower rows (257..510), as the kernel's scan
    finds them (0 where no chain crosses the tile's first column)."""
    I = _i32(plane)
    return torch.stack([_pp_region_tiles(I[:, r0:r1], c0, band)[2]
                        for r0, r1, c0, _, band in PP_REGIONS], 1)


def pair_promotion_ref(plane):
    """Torch twin of ``pair_promotion`` in the kernel's decomposition: a
    region row's 256 columns as 32 lane tiles of 8, each visit a table of
    the next state, the tiles' state maps scanned across the lanes
    (``_pp_region_tiles``), each tile walked again from its entry state.
    (The kernel copies a row whose visits hold no value of 5..8 or
    -8..-5: no rule fires there, and the walk leaves it as it is.)"""
    I = _i32(plane)
    out = I.clone()
    for r0, r1, c0, _, band in PP_REGIONS:
        x, tabs, entry, nv = _pp_region_tiles(I[:, r0:r1], c0, band)
        _, cols = _pp_walk(x, tabs, entry, nv, out=True)
        out[:, r0:r1, c0 - 1:c0 - 1 + PP_LANES * PP_TILE] = cols.reshape(
            *cols.shape[:2], -1)
    return out.to(torch.int16)


def pair_promotion_device(plane):
    """``_pair_promotion`` on a (B, 512, 512) int16 plane (q > LOW4),
    bit-exact vs the host copy's C scan.  Returns a new plane (kernel
    ``pair_promotion``: one launch, a warp a row, the row a scan of the
    lane tiles' state maps)."""
    _check_plane(plane, "pair_promotion plane", N)
    if plane.device.type == "cpu":
        return pair_promotion_ref(plane)
    lib, stream = _cuda_args(plane)
    out = torch.empty_like(plane)
    if plane.shape[0]:
        with torch.cuda.device(plane.device):
            build.check("nhw_pair_promotion", lib.nhw_pair_promotion(
                plane.data_ptr(), out.data_ptr(), plane.shape[0], stream))
        build.count("pair_promotion")
    return out


# ---------------------------------------------------------------------------
# E12 marking: the res256 column ladder (host.ops.residue.
# res256_column_ladder, encoder/nhw_encoder.c:1084-1326).  Column j's walk
# over rows 0..254 reads its own writes (rows r + 1, r + 2 of plane column
# j, its rf column, band row j) and the input values of column j + 1, which
# the C visits later.  Only column 255 reads other columns' results: its
# flat j + 1 reads land on band column 256 (row r's value there is column
# r's step-0 band write) and on rf column 0 of the next rows; so it walks
# again once the other columns are done.

RF_EXT = SZ + 1024       # res256 and the out-of-bounds tail the C reads


def _ladder_flags(quality: int, res_setting: int) -> tuple:
    return (quality >= T.LOW1, quality == T.LOW2, quality >= T.HIGH1,
            res_setting)


def _cl_band_op(case, v, bp):
    """The band ops on (band value, previous band value): case 0 none, 1
    w1, 2 w2, 3 w3, 4 lw5 at res == -4, 5 lw5 at res < -6."""
    neg_ok = (v < -14) & ((((-v) & 7) == 0) | (((-v) & 7) == 7))
    w1 = torch.where((v == 7) & (bp >= 0) & (bp < 8), v + 2,
                     torch.where((v == 8) & (bp >= -2) & (bp < 8), v + 2, v))
    w2 = torch.where(neg_ok, v + 1, torch.where(
        ((v == 7) | ((v & 65534) == 8)) & (bp >= -2), v + 3, v))
    w3 = torch.where(neg_ok, v + 1, torch.where(
        (v >= 0) & (((v + 2) & 65532) == 8) & (bp >= -2), 10,
        torch.where((v > 14) & ((v & 7) == 7), v + 1, v)))
    lw4 = torch.where(((v == -7) | (v == -8)) & (bp > -8) & (bp < 2), -9, v)
    lw6 = torch.where(neg_ok, v + 1, torch.where(
        ((v == 7) | (v == 8)) & (bp >= -1) & (bp < 8), v + 3, v))
    out = v
    for k, w in ((1, w1), (2, w2), (3, w3), (4, lw4), (5, lw6)):
        out = torch.where(case == k, w, out)
    return out


class _Fire:
    """The C's if/else chain as masks: each ``fire`` applies its writes
    where its condition holds and no earlier branch matched; ``set1``
    is v1 := rf[cnt + D]."""

    def __init__(self, rfc, rf1):
        z = torch.zeros_like(rfc)
        self.mark, self.rf1 = rfc, rf1
        self.d1, self.d2, self.case = z, z, z
        self.set1 = torch.zeros_like(rfc, dtype=torch.bool)
        self.done = torch.zeros_like(rfc, dtype=torch.bool)

    def fire(self, cond, mk=None, dd1=None, dd2=None, set1=False, bc=None):
        c = cond & ~self.done
        if mk is not None:
            self.mark = torch.where(c, mk, self.mark)
        if dd1 is not None:
            self.d1 = torch.where(c, dd1, self.d1)
        if dd2 is not None:
            self.d2 = torch.where(c, dd2, self.d2)
        if set1:
            self.set1 = self.set1 | c
        if bc is not None:
            self.case = torch.where(c, bc, self.case)
        self.done = self.done | cond

    def low2(self, cond, val: int, rf14, hit14):
        """LOW2's rf[cnt + D] / rf[cnt] writes, then v1 := rf[cnt + D]."""
        c = cond & ~self.done
        self.rf1 = torch.where(c & rf14, val, self.rf1)
        self.mark = torch.where(c & hit14, val, self.mark)
        self.set1 = self.set1 | c
        self.done = self.done | cond


def _cl_step(flags, carry, xs):
    """One row of the ladder, the columns as lanes: carry (v0, v1, vprev,
    markm1, rfc, bnd_prev), xs (pf row r + 2, rf rows r + 1 and r + 2, the
    band value (j, 256 + r), the j + 1 reads of plane rows r..r + 2 and rf
    rows r..r + 2, has_prev) -> (carry', (v0, mark, bnd))."""
    ge_low1, low2, ge_high1, res_setting = flags
    v0, v1, vprev, markm1, rfc, bnd_prev = carry
    v2, i_rf1, i_rf2, i_bnd, p_j1, p1_j1, p2_j1, r_j1, r1_j1, r2_j1, \
        has_prev = xs
    res = v0 - rfc
    a = v1 - i_rf1
    b2 = v2 - i_rf2
    f = _Fire(rfc, i_rf1)
    fire = f.fire
    # 1-3
    b = (res == 2) & (a == 2) & (b2 >= 2)
    fire(b & ((b2 < 5) | (b2 > 6)), mk=12400, dd1=-2, dd2=-2)
    f.done = f.done | b
    fire((((res == 2) & (a == 3)) | ((res == 3) & (a == 2)))
         & (b2 > 1) & (b2 < 6), mk=12400, dd1=-2, dd2=-2)
    b3 = (res == 3) & (a == 3)
    fire(b3 & (b2 > 0) & (b2 < 6), mk=12400, dd1=-2, dd2=-2)
    if ge_low1:
        fire(b3, mk=12100, set1=True)
    else:
        f.done = f.done | b3
    # 4-5
    b4 = (a == -4) & ((res == 2) | (res == 3)) & ((b2 == 2) | (b2 == 3))
    fire(b4 & (res == 2) & (b2 == 2), dd1=1)
    fire(b4, mk=12400, dd1=-2, dd2=-2)
    b5 = (res == 1) & (a == 3) & (b2 == 2)
    fire(b5 & has_prev & ((vprev - markm1) >= 0), mk=12400, dd1=-2, dd2=-2)
    f.done = f.done | b5
    # 6
    b6 = (((res == 3) | (res == 4) | (res == 5) | (res > 6))
          & ((a == 3) | ((a & 65534) == 4)))
    fire(b6 & (res > 6), mk=12500, set1=True)
    if ge_low1:
        fire(b6, mk=12100, set1=True)
    elif low2:
        f.low2(b6, 14100,
               torch.where((res < 5) & (a == 5), True, torch.where(
                   res >= 5, False, (res == 3) & (a >= 4))), res >= 5)
    else:
        f.done = f.done | b6
    # 7: the cross-column pair check
    pr, pr1, pr2 = p_j1 - r_j1, p1_j1 - r1_j1, p2_j1 - r2_j1
    b7 = ((res == 2) | (res == 3)) & ((a == 2) | (a == 3))
    fire(b7 & ((b2 == 0) | (b2 == 1)) & ((pr == 2) | (pr == 3))
         & ((pr1 == 2) | (pr1 == 3)) & (pr2 > 0), mk=12400, dd1=-2, dd2=-2)
    f.done = f.done | b7
    # 8-9
    b8 = (a == 4) & ((res == -2) | (res == -3)) & ((b2 == -2) | (b2 == -3))
    fire(b8 & (res == -2) & (b2 == -2), dd1=-1)
    fire(b8, mk=12300, dd1=2, dd2=2)
    b9 = (((res == -3) | (res == -4) | (res == -5) | (res < -7))
          & ((a == -3) | (a == -4) | (a == -5)))
    fire(b9 & (res < -7), mk=12600, set1=True)
    if ge_low1:
        fire(b9, mk=12200, set1=True)
    elif low2:
        f.low2(b9, 14000,
               torch.where((res > -5) & (a == -5), True, torch.where(
                   res <= -5, False, (res == -3) & (a <= -4))), res <= -5)
    else:
        f.done = f.done | b9
    # 10: a in (-2, -3)
    b10 = (a == -2) | (a == -3)
    g = b10 & ~f.done
    r23 = (res == -2) | (res == -3)
    fire(g & r23 & (b2 < 0), mk=12300, dd1=2, dd2=2)
    if ge_high1:
        fire(g & r23 & (res == -3), mk=14500)
    npair = (((pr == -2) | (pr == -3)) & ((pr1 == -2) | (pr1 == -3))
             & (pr2 < 0))
    fire(g & r23 & (b2 == 0) & npair, mk=12300, dd1=2, dd2=2)
    fire(g & r23 & (b2 == 0))
    fire(g & r23 & (res == -2), bc=2)
    if ge_high1:
        fire(g & r23, mk=14500)
    else:
        fire(g & r23, bc=3)
    b10b = g & (res == -1) & (a == -3) & (b2 == -2)
    fire(b10b & has_prev & ((vprev - markm1) <= 0), mk=12300, dd1=2, dd2=2)
    f.done = f.done | b10b
    fire(g & (res == -1) & (b2 == -3), mk=12300, dd1=2, dd2=2)
    fire(g & (res == -1), bc=1)
    b10d = g & (res == -4)
    fire(b10d & (b2 <= -2) & (b2 >= -3), mk=12300, dd1=2, dd2=2)
    fire(b10d, mk=14000, bc=4)
    f.done = f.done | b10
    # 11-14
    fire((res == 0) | (res == -1), bc=1)
    fire(res == -2, bc=2)
    if ge_high1:
        fire(res == -3, mk=14500)
    else:
        fire(res == -3, bc=3)
    c0 = (res < -res_setting) & ~f.done
    mark = torch.where(c0, 14000, f.mark)
    case = torch.where(c0 & (res == -4), 4, f.case)
    if ge_high1:
        mark = torch.where(c0 & (res < -7), 14900, mark)
        case = torch.where(c0 & (res < -6) & ~(res < -7), 5, case)
    else:
        case = torch.where(c0 & (res < -6), 5, case)
    v1f = torch.where(f.set1, f.rf1, v1 + f.d1)
    bnd = _cl_band_op(case, i_bnd, bnd_prev)
    return (v1f, v2 + f.d2, v0, mark, f.rf1, bnd), (v0, mark, bnd)


def _ladder_args(plane, rf_ext) -> None:
    _check_plane(plane, "column_ladder plane", N)
    _check(rf_ext, "column_ladder rf_ext", torch.int16, (plane.shape[0],
                                                        RF_EXT))
    if not rf_ext.is_contiguous():
        raise ValueError("column_ladder rf_ext: must be contiguous")


LADDER_LAG = 4     # column 255's steps behind column 0 (residue.cu Col255Src)
LADDER_TAB = 17 * 15 * 12 * 16   # the step's effect table (kLTab)
LADDER_RES_MAX = 8               # res_setting the table's classes cover


def column_ladder_ref(plane, rf_ext, quality: int, res_setting: int):
    """Torch twin of ``column_ladder``: columns 0..254 as lanes over rows
    0..254, every read an input value, and column 255 LADDER_LAG steps
    behind them, its j + 1 reads taken from the results at the time of
    its step: column r's step-0 band value at (r, 256), its own at (255,
    256) from its step 0 on, rf column 0 (final up to the row column 0
    has walked) and the tail."""
    _ladder_args(plane, rf_ext)
    flags = _ladder_flags(quality, res_setting)
    b = plane.shape[0]
    I, rfe = _i32(plane), _i32(rf_ext)
    out = I.clone()
    rf = rfe[:, :SZ].reshape(b, D, D).clone()
    j = D - 1                # column 255; the lanes are columns 0..254

    def rf_at(off, k):    # rf[(r + off) * 256 + c + k] at [r, c], c < 255
        return rfe[:, off * D + k: off * D + k + (D - 1) * D].reshape(
            b, D - 1, D)[..., :j]

    xs_all = (I[:, 2:D + 1, :j], rf_at(1, 0), rf_at(2, 0),
              I[:, :j, D:2 * D - 1].transpose(1, 2),
              I[:, 0:D - 1, 1:D], I[:, 1:D, 1:D],
              I[:, 2:D + 1, 1:D], rf_at(0, 1), rf_at(1, 1), rf_at(2, 1))
    z = torch.zeros_like(I[:, 0, :j])
    carry = (I[:, 0, :j], I[:, 1, :j], z, z, rfe[:, :j], I[:, :j, D - 1])
    tail = torch.stack([rfe[:, SZ], rfe[:, SZ + D]], 1)   # rf (256..257, 0)
    z1 = z[:, :1]
    carry255 = (I[:, 0, j, None], I[:, 1, j, None], z1, z1,
                rfe[:, j, None], I[:, j, j, None])
    for r in range(D - 1 + LADDER_LAG):
        if r < D - 1:
            xs = tuple(x[:, r] for x in xs_all) + (r > 0,)
            carry, (v0, mark, bnd) = _cl_step(flags, carry, xs)
            out[:, r, :j], rf[:, r, :j], out[:, :j, D + r] = v0, mark, bnd
        if r == D - 2:
            out[:, D - 1, :j], out[:, D, :j], rf[:, D - 1, :j] = (
                carry[0], carry[1], carry[4])
        s = r - LADDER_LAG          # column 255's step
        if s < 0:
            continue
        rf0 = torch.cat([rf[:, :, 0], tail], 1)            # rows 0..257
        xs = (I[:, s + 2, j, None], rfe[:, (s + 1) * D + j, None],
              rfe[:, (s + 2) * D + j, None], I[:, j, D + s, None],
              out[:, s, D, None], out[:, s + 1, D, None],
              out[:, s + 2, D, None], rf0[:, s + 1, None],
              rf0[:, s + 2, None], rf0[:, s + 3, None], s > 0)
        carry255, (v0, mark, bnd) = _cl_step(flags, carry255, xs)
        out[:, s, j], rf[:, s, j], out[:, j, D + s] = (v0[:, 0], mark[:, 0],
                                                       bnd[:, 0])
    out[:, D - 1, j], out[:, D, j], rf[:, D - 1, j] = (carry255[0][:, 0],
                                                       carry255[1][:, 0],
                                                       carry255[4][:, 0])
    return out.to(torch.int16), rf.reshape(b, SZ).to(torch.int16)


def column_ladder_device(plane, rf_ext, quality: int, res_setting: int):
    """``host.ops.residue.res256_column_ladder`` on a (B, 512, 512) int16
    plane and rf_ext, (B, SZ + 1024) int16: res256 and the tail the C
    reads past it (the kernel head, [17, 2, 0, 0], resIII[:1016]).
    Returns (plane', rf' (B, SZ) int16), bit-exact vs the host copy's C
    scan (kernel ``column_ladder``: one launch, 8 CTAs an image, each
    walking a block of 32 columns, a lane each, from shared memory, and
    CTA 0 column 255 LADDER_LAG steps behind column 0)."""
    _ladder_args(plane, rf_ext)
    ge_low1, low2, ge_high1, _ = _ladder_flags(quality, res_setting)
    if plane.device.type == "cpu":
        return column_ladder_ref(plane, rf_ext, quality, res_setting)
    if not 0 <= res_setting <= LADDER_RES_MAX:
        raise ValueError(f"column_ladder: res_setting {res_setting} outside "
                         f"0..{LADDER_RES_MAX}")
    lib, stream = _cuda_args(plane, rf_ext)
    b = plane.shape[0]
    out = torch.empty_like(plane)
    rf = torch.empty((b, SZ), dtype=torch.int16, device=plane.device)
    tab = torch.empty(LADDER_TAB, dtype=torch.int16, device=plane.device)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_column_ladder", lib.nhw_column_ladder(
                plane.data_ptr(), rf_ext.data_ptr(), out.data_ptr(),
                rf.data_ptr(), tab.data_ptr(), b, int(ge_low1), int(low2),
                int(ge_high1), res_setting, stream))
        build.count("column_ladder")
    return out, rf


# ---------------------------------------------------------------------------
# E12 classify: residue codes 121..149 (host.ops.residue.res256_classify,
# encoder/nhw_encoder.c:1329-1420).  The pf[scan] and rf[cnt] reads are
# input values; the only chain is band row j's st - 1 read of the value
# its previous step wrote, and the rules read that value only through
# ``_band_class``: a band row is a scan of 6-class maps.

_MARK_CODES = ((14000, 140), (14500, 145), (12200, 122), (12100, 121),
               (12300, 123), (12400, 124), (14100, 141), (12500, 125),
               (12600, 126))


def _classify_step(ge_high1: bool, res_setting: int, bnd_prev, pf_r, mark,
                   v):
    """One row of classify, the columns as lanes: (band value written at
    the previous row, plane row r, rf row r, band value (j, 256 + r)) ->
    (band', rf', n1, n3, n5), the counts per lane.  A mark >= 12000
    outside the ladder's set maps to 149."""
    low = mark < 12000
    res = pf_r - mark
    bp = bnd_prev
    dec16 = (v > 15) & ((v & 7) == 0)
    m78 = (v == -7) | (v == -8)
    b01 = low & ((res == 0) | (res == 1))
    bA = torch.where(m78 & (bp > -8) & (bp < 2), -9, v)
    b2m = low & (res == 2)
    bB = torch.where(dec16, v - 1, torch.where(
        m78 & (bp <= 1), -9, torch.where((v == -6) & (bp > -8) & (bp <= -1),
                                         -9, v)))
    b3m = low & (res == 3)
    bC = torch.where(dec16, v - 1, torch.where(
        (v <= 0) & ((((-v) + 2) & 65532) == 8) & (bp <= 2), -10, v))
    bhi = low & (res > res_setting)
    bD = torch.where(((v == 7) | ((v & 65534) == 8)) & (bp >= 0) & (bp < 8),
                     v + 2, v)
    bE = torch.where(dec16, v - 1, torch.where(
        ((v == -6) | (v == -7) | (v == -8)) & (bp > -8) & (bp < 0), -9, v))
    r148 = bhi & (res > 7) if ge_high1 else torch.zeros_like(bhi)
    bnd = torch.where(bhi & (res > 6) & ~r148, bE, v)
    bnd = torch.where(bhi & (res == 4), bD, bnd)
    if not ge_high1:
        bnd = torch.where(b3m, bC, bnd)
    bnd = torch.where(b2m, bB, torch.where(b01, bA, bnd))
    if ge_high1:
        rf_new = torch.where(b3m, 144, torch.where(r148, 148, torch.where(
            bhi, 141, torch.where(low, 0, mark))))
    else:
        rf_new = torch.where(bhi, 141, torch.where(low, 0, mark))
    hi = ~low
    code = torch.full_like(mark, 149)
    for m, c in _MARK_CODES:
        code = torch.where(mark == m, c, code)
    rf_new = torch.where(hi, code, rf_new)

    def any_of(*cs):
        return hi & sum((code == c) for c in cs).bool()

    n1 = bhi.int() + r148.int() + any_of(140, 141, 125, 126, 149).int()
    n3 = any_of(121, 122, 123, 124, 125, 126).int()
    n5 = (b3m.int() if ge_high1 else 0) + r148.int() + any_of(145, 149).int()
    return bnd, rf_new, n1, n3, n5


def _classify_args(plane, res256) -> None:
    _check_plane(plane, "classify plane", N)
    _check(res256, "classify res256", torch.int16, (plane.shape[0], D, D))
    if not res256.is_contiguous():
        raise ValueError("classify res256: must be contiguous")


CLASSIFY_LANES = 32             # lanes a band row (csrc/residue.cu)
CLASSIFY_STEPS = D // CLASSIFY_LANES
_CLASS_VALUES = (-8, -1, 0, 2, 3, 8)    # a band value of each class


def _band_class(v):
    """The class of a band value as the next step's rules read it: <= -8,
    -7..-1, 0..1, 2, 3..7, >= 8 -> 0..5 (csrc/residue.cu band_class)."""
    return sum((v >= t).int() for t in (-7, 0, 2, 3, 8))


def classify_ref(plane, res256, quality: int, res_setting: int):
    """Torch twin of ``classify``: lane l of band row j takes steps 8 l..
    8 l + 7; each lane's steps are walked from a value of each of the 6
    classes (its class map), the 32 lanes' maps chained from the class of
    (j, 255), and each lane walks its steps again from its entry class,
    ``_classify_step`` the step."""
    _classify_args(plane, res256)
    ge_high1 = quality >= T.HIGH1
    I, rf = _i32(plane), _i32(res256)
    b = I.shape[0]
    shape = (b, D, CLASSIFY_LANES, CLASSIFY_STEPS)   # band row, lane, step
    pf = I[:, :D, :D].transpose(1, 2).reshape(shape)
    mark = rf.transpose(1, 2).reshape(shape)
    band = I[:, :D, D:].reshape(shape)
    reps = torch.tensor(_CLASS_VALUES, dtype=torch.int32, device=I.device)
    bnd = reps.expand(*shape[:3], len(_CLASS_VALUES))
    for k in range(CLASSIFY_STEPS):
        bnd = _classify_step(ge_high1, res_setting, bnd, pf[..., k, None],
                             mark[..., k, None], band[..., k, None])[0]
    maps = _band_class(bnd).long()                   # (B, D, lanes, 6)
    entry = torch.empty(shape[:3], dtype=torch.long, device=I.device)
    e = _band_class(I[:, :D, D - 1]).long()
    for lane in range(CLASSIFY_LANES):
        entry[..., lane] = e
        e = maps[..., lane, :].gather(-1, e[..., None])[..., 0]
    bnd = reps[entry]
    band_out, codes = torch.empty_like(band), torch.empty_like(band)
    counts = torch.zeros((b, 3), dtype=torch.int32, device=plane.device)
    for k in range(CLASSIFY_STEPS):
        bnd, codes[..., k], *ns = _classify_step(
            ge_high1, res_setting, bnd, pf[..., k], mark[..., k],
            band[..., k])
        band_out[..., k] = bnd
        counts += torch.stack([n.sum((1, 2), dtype=torch.int32)
                               for n in ns], -1)
    out = I.clone()
    out[:, :D, D:] = band_out.reshape(b, D, D)
    rf_out = codes.reshape(b, D, D).transpose(1, 2)
    return (out.to(torch.int16), rf_out.to(torch.int16).contiguous(),
            counts[:, 0], counts[:, 1], counts[:, 2])


def classify_device(plane, res256, quality: int, res_setting: int):
    """``host.ops.residue.res256_classify`` on a (B, 512, 512) int16 plane
    and the ladder's (B, 256, 256) int16 res256.  Returns (plane',
    res256', n1, n3, n5), the counts (B,) int32 (kernel ``classify``: one
    launch of ``classify_bands``, 8 CTAs an image, a warp a band row, the
    chain a warp scan of 6-class maps, the counts summed in each CTA and
    added into the zeroed counts)."""
    _classify_args(plane, res256)
    if plane.device.type == "cpu":
        return classify_ref(plane, res256, quality, res_setting)
    lib, stream = _cuda_args(plane, res256)
    b = plane.shape[0]
    out = torch.empty_like(plane)
    rf = torch.empty_like(res256)
    counts = torch.zeros((b, 3), dtype=torch.int32, device=plane.device)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_classify", lib.nhw_classify(
                plane.data_ptr(), res256.data_ptr(), out.data_ptr(),
                rf.data_ptr(), counts.data_ptr(), b,
                int(quality >= T.HIGH1), res_setting, stream))
        build.count("classify")
    return out, rf, counts[:, 0], counts[:, 1], counts[:, 2]


# ---------------------------------------------------------------------------
# E12 streams: the positional side streams (host.ops.residue.
# build_positional_stream + finish_stream, encoder/nhw_encoder.c:1498-1887)

P_MAX = SZ + 512                  # positions a stream can list
_NO_POS = 1 << 20                 # fill past a list's end


def _compact(mask, vals, fill: int, size: int):
    """vals[mask], row-major order kept, into a (B, size) buffer filled
    with ``fill`` past the end: a cumsum rank and one scatter (the rest
    into a spill column).  Returns (buffer, counts (B,) int32)."""
    b = mask.shape[0]
    vals = vals.expand(mask.shape)
    m = mask.to(torch.int64)
    rank = torch.cumsum(m, 1) - m
    idx = torch.where(mask & (rank < size), rank, size)
    buf = torch.full((b, size + 1), fill, dtype=vals.dtype,
                     device=mask.device)
    buf.scatter_(1, idx, vals)
    return buf[:, :size], mask.sum(1, dtype=torch.int32)


def _pack_lsbs(v, bits: int):
    """Entries' low ``bits`` bits, 8 // bits an output byte, first entry in
    the high bits (``_pack_bits``)."""
    per = 8 // bits
    w = v.reshape(v.shape[0], -1, per) & ((1 << bits) - 1)
    shift = bits * torch.arange(per - 1, -1, -1, device=v.device)
    return (w << shift).sum(-1).to(torch.uint8)


def positional_stream_device(rf, wt, rt, word_bits: int):
    """``build_positional_stream`` + ``finish_stream`` on a (B, 256, 256)
    int16 post-classify res256, in torch ops.  ``wt``/``rt``: (256,) word
    value (-1: not a code of this stream) and replacement code per code.
    Returns (rf', packed (B, P_MAX) int32, n_packed, bit_bytes (B, P_MAX //
    8) uint8, n_nonmarker, word_bytes (B, SZ * word_bits // 8) uint8,
    n_words), the counts (B,) int32; the C's sections are their heads
    (``device_encode_scans._residue_sections``).  The delta-pair pack's
    cursor skips a position exactly when the one before it was visited
    and paired: the run parity of the pair flags."""
    _check(rf, "positional_stream rf", torch.int16, (None, D, D))
    if word_bits not in (1, 2):
        raise ValueError(f"positional_stream: word_bits {word_bits}")
    dev = rf.device
    b = rf.shape[0]
    wt = torch.as_tensor(wt, dtype=torch.int32, device=dev)
    rt = torch.as_tensor(rt, dtype=torch.int32, device=dev)
    if wt.shape != (256,) or rt.shape != (256,):
        raise ValueError("positional_stream: wt and rt must have 256 entries")
    code = _i32(rf).reshape(b, SZ)
    jcol = torch.arange(SZ, device=dev, dtype=torch.int32) & (D - 1)
    safe = code.clamp(0, 255).long()
    cw = wt[safe]
    is_code = (code >= 0) & (code < 256) & (cw >= 0) & (jcol < D - 2)
    marker = (jcol == D - 2).expand(b, SZ)
    rf_new = torch.where(is_code, rt[safe], code)
    rf_new = torch.where(marker | (jcol == D - 1), 0, rf_new)
    pos, npos = _compact(marker | is_code, jcol, _NO_POS, P_MAX)
    words, nwords = _compact(is_code, cw, 0, SZ)
    # drop isolated 254 markers between ascending neighbours
    idx = torch.arange(P_MAX, device=dev, dtype=torch.int32)
    prev = _flat_shift_r(pos, 1, _NO_POS)
    nxt = _flat_shift_l(pos, 1, _NO_POS)
    mid = (idx >= 1) & (idx < (npos - 1)[:, None])
    drop = (mid & (pos == D - 2) & (prev != D - 2) & (nxt != D - 2)
            & (prev > nxt))
    ded, nded = _compact((idx < npos[:, None]) & ~drop, pos, _NO_POS, P_MAX)
    # the delta-pair pack
    sr = ded >> 1
    d1 = sr - _flat_shift_r(sr, 1, 0)
    d2 = _flat_shift_l(sr, 1, 0) - sr
    pair = (d1 >= 0) & (d1 < 8) & (d2 >= 0) & (d2 < 16) & (idx >= 1)
    skipped = _flat_shift_r(_run_parity_fire(pair), 1, False)
    emit = (idx == 0) | (~skipped & (idx >= 1)
                         & (idx < (nded - 1)[:, None]))
    byte = torch.where(pair & (idx >= 1), 128 + (d1 << 4) + d2, sr)
    packed, npacked = _compact(emit, byte, 0, P_MAX)
    # the LSBs of the non-marker positions, and the words
    nm = (ded != D - 2) & (idx < nded[:, None])
    nmv, n_nm = _compact(nm, ded & 1, 0, P_MAX)
    return (rf_new.reshape(b, D, D).to(torch.int16), packed, npacked,
            _pack_lsbs(nmv, 1), n_nm, _pack_lsbs(words, word_bits), nwords)


# ---------------------------------------------------------------------------
# The chroma ladders of encode_uv (the host copy's
# encoder._uv_compare_ladder and _uv_sentinel_marking,
# encoder/nhw_encoder.c:2316-2424)

UVQ = 128                      # the chroma LL1 quadrant's side
UVQ_N = UVQ * UVQ
UV_RF_EXT = UVQ_N + 512        # res256 and the tail the drift reads
UV_RF_MIN = UVQ_N + 130 + 127  # csrc/uv.cu kRfMin
# the compare ladder's k by the difference scan, at clamp(scan, -11, 11) +
# 11; at scan = +-3 the rules also read nxt
_UV_LADDER_K = (6, 3, 3, 3, 2, 2, 2, 1, 0, 0, 0, 0, 0, 0, 0, -1, -2, -2, -2,
                -3, -3, -3, -6)


def uv_compare_ladder_device(jpeg, process, res256, oob0, strict: bool):
    """The post-synthesis LL1 compare on (B, 256, 256) int16 jpeg and
    process, (B, 128, 128) int16 res256 and oob0 (B,), the value read one
    past res256: a new jpeg whose (128, 128) LL quadrant is res256 + k.
    Every read is an initial value, so it is elementwise torch ops: k from
    a table on the clamped difference, and the +-3 rules against the next
    LL position's difference (flat e + 1 reaches process column 128 at j =
    127; res256's next is oob0 at the last position), ``strict`` (V) with
    > / <, else >= / <=."""
    b = jpeg.shape[0]
    for x, name in ((jpeg, "jpeg"), (process, "process")):
        _check(x, f"uv_compare_ladder {name}", torch.int16, (b, D, D))
    _check(res256, "uv_compare_ladder res256", torch.int16,
           (b, UVQ, UVQ))
    if oob0.shape != (b,) or oob0.is_floating_point():
        raise ValueError(f"uv_compare_ladder oob0: expected ({b},) integers, "
                         f"got {oob0.dtype}{tuple(oob0.shape)}")
    r = _i32(res256)
    rn = torch.cat([r.reshape(b, UVQ_N)[:, 1:],
                    _i32(oob0)[:, None]], 1)
    scan = _i32(process[:, :UVQ, :UVQ]) - r
    nxt = _i32(process[:, :UVQ, 1:UVQ + 1]) - rn.reshape(b, UVQ, UVQ)
    tab = torch.tensor(_UV_LADDER_K, dtype=torch.int32, device=r.device)
    k = tab[(scan.clamp(-11, 11) + 11).long()]
    up = (nxt > 0) if strict else (nxt >= 0)
    down = (nxt < 0) if strict else (nxt <= 0)
    k = k - ((scan == 3) & up).to(torch.int32) + ((scan == -3) & down).to(
        torch.int32)
    out = jpeg.clone()
    out[:, :UVQ, :UVQ] = (r + k).to(torch.int16)
    return out


def _uvsm_args(process, rf_ext) -> None:
    _check(process, "uv_sentinel_marking process", torch.int16,
           (None, D, D))
    b = process.shape[0]
    _check(rf_ext, "uv_sentinel_marking rf_ext", torch.int16, (b, None))
    if rf_ext.shape[1] < UV_RF_MIN:
        raise ValueError(f"uv_sentinel_marking rf_ext: rows of "
                         f"{rf_ext.shape[1]}; the drift reads up to "
                         f"{UV_RF_MIN}")
    if not (process.is_contiguous() and rf_ext.is_contiguous()):
        raise ValueError("uv_sentinel_marking: inputs must be contiguous")


def _uvsm_decide(d0, d1, b0, b1, b2, res_uv: int):
    """One lane's decision on its differences d0, d1 and its band slots'
    initial values: (pos, placed, code, slot), as csrc/uv.cu ``decide``:
    pos a 12400 pair (else 12600), placed a pair with a free slot, code
    the single sentinel (0: none), slot the first free one (3: none)."""
    pos = (d0 > 3) & (d0 < 7) & (d1 > 2) & (d1 < 7)
    neg = (d0 > -7) & (d0 < -3) & (d1 > -8) & (d1 < -2)
    slot = torch.where(b0.abs() < 8, 0, torch.where(
        b1.abs() < 8, 1, torch.where(b2.abs() < 8, 2, 3)))
    placed = (pos | neg) & (slot < 3)
    code = torch.where(d0 > 0, 12900, torch.where((d0 == -5) & (d1 >= 0),
                                                  0, 13000))
    code = torch.where(d0.abs() > res_uv, code, 0)
    return pos, placed, code, slot


def _uvsm_apply(visited, pos, placed, code, slot, bands):
    """The lane's band values after its turn: the written code in its
    first free slot where it fires, else the initial values."""
    code = torch.where(placed, torch.where(pos, 12400, 12600), code)
    fire = visited & (code != 0)
    return [torch.where(fire & (slot == s), code, band)
            for s, band in enumerate(bands)]


UVSM_CTAS = 8                      # csrc/uv.cu kUvCtas: a cluster an image
UVSM_CTA_ROWS = UVQ // UVSM_CTAS   # rows a CTA, a warp each (kUvRows)


def _uvsm_rows(p, rf, drifts, res_uv: int):
    """Every row of each image walked at once, row r from its window start
    128 r + ``drifts[:, r]`` (the drifts of the rows above as guessed), a
    row's lanes as columns: the lanes decide on their reads, the visited
    lanes are the run parity of the placed pairs, lane 127 decides again
    against the value lane 0 left in column 128.  ``p``: (B, 256, 256)
    int32, ``rf``: (B, >= 16641) int32, ``drifts``: (B, 128) int64.
    Returns (the rows' three band values, each (B, 128, 128), each row's
    drift (B, 128) bool: lane 127 visited and placed)."""
    b = p.shape[0]
    reads = torch.arange(UVQ + 1, device=p.device)
    start = torch.arange(UVQ, device=p.device) * UVQ + drifts
    sl = rf.gather(1, (start[..., None] + reads).reshape(b, -1)).reshape(
        b, UVQ, UVQ + 1)
    x = p[:, :UVQ, :UVQ + 1]
    bands = [p[:, :UVQ, UVQ:], p[:, UVQ:, :UVQ], p[:, UVQ:, UVQ:]]
    d0 = x[..., :UVQ] - sl[..., :UVQ]
    pos, placed, code, slot = _uvsm_decide(d0, x[..., 1:] - sl[..., 1:],
                                           *bands, res_uv)
    visited = ~_flat_shift_r(_run_parity_fire(placed), 1, False)
    w = _uvsm_apply(visited, pos, placed, code, slot, bands)
    # lane 127 against lane 0's band 0 value in column 128
    last = [x[..., -1:] for x in bands]
    pos, placed, code, slot = _uvsm_decide(
        d0[..., -1:], w[0][..., :1] - sl[..., -1:], *last, res_uv)
    w127 = _uvsm_apply(visited[..., -1:], pos, placed, code, slot, last)
    for band, band127 in zip(w, w127):
        band[..., -1:] = band127
    return w, (visited[..., -1:] & placed)[..., 0]


def _uvsm_sweeps(process, rf_ext, res_uv: int):
    """The rows as ``uv_sentinel`` takes them, in two levels: every row
    from no drift above; then, within each CTA's UVSM_CTA_ROWS rows, each
    row's drift count set to the CTA's entry count (the drifts of the CTAs
    above as known, 0 at first) plus the drifts of its rows above and the
    rows walked again while a count moves; then the CTAs' entry counts
    taken from the rows' drifts, a round, until the drifts stand (after s
    rounds CTAs 0..s - 1 are exact, so UVSM_CTAS + 1 rounds at most).
    Returns (the band values, the rounds each image took, (B,) int32)."""
    b = process.shape[0]
    p = _i32(process)
    rf = _i32(rf_ext)
    dev = p.device
    drifts = torch.zeros((b, UVQ), dtype=torch.long, device=dev)
    w, drift = _uvsm_rows(p, rf, drifts, res_uv)
    entry = torch.zeros((b, UVSM_CTAS), dtype=torch.long, device=dev)
    seen = torch.zeros_like(drift)
    rounds = torch.zeros(b, dtype=torch.int32, device=dev)
    active = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(UVSM_CTAS + 1):
        for _ in range(UVSM_CTA_ROWS + 1):
            d = drift.long().reshape(b, UVSM_CTAS, UVSM_CTA_ROWS)
            want = (entry[..., None] + torch.cumsum(d, 2) - d).reshape(b, UVQ)
            if bool((want == drifts).all()):
                break
            drifts = want
            w, drift = _uvsm_rows(p, rf, drifts, res_uv)
        rounds += active.int()
        # row 127's drift moves no window
        active &= (drift[:, :-1] != seen[:, :-1]).any(1)
        if not bool(active.any()):
            break
        seen = drift
        tot = drift.long().reshape(b, UVSM_CTAS, UVSM_CTA_ROWS).sum(2)
        entry = torch.cumsum(tot, 1) - tot
    return w, rounds


def uv_sentinel_marking_ref(process, rf_ext, res_uv: int):
    """Torch twin of ``uv_sentinel``: every row walked from a guessed
    window start, the rows walked again while a start moves, within each
    CTA and then over the cluster's rounds (``_uvsm_sweeps``); the rows'
    band values written into a copy of the plane."""
    _uvsm_args(process, rf_ext)
    w = _uvsm_sweeps(process, rf_ext, res_uv)[0]
    out = process.clone()
    out[:, :UVQ, UVQ:] = w[0].to(torch.int16)
    out[:, UVQ:, :UVQ] = w[1].to(torch.int16)
    out[:, UVQ:, UVQ:] = w[2].to(torch.int16)
    return out


def uv_sentinel_sweeps(process, rf_ext, res_uv: int):
    """The sweeps (the cluster's rounds) of ``uv_sentinel`` over each
    image's rows (1..UVSM_CTAS + 1; the twin's, which takes the kernel's
    guesses, passes and rounds), (B,) int32."""
    _uvsm_args(process, rf_ext)
    return _uvsm_sweeps(process, rf_ext, res_uv)[1]


def uv_sentinel_marking_device(process, rf_ext, res_uv: int):
    """The band sentinels 12400/12600/12900/13000 on (B, 256, 256) int16
    process planes against rf_ext (B, >= 16641) int16: res256 (16384),
    then the tail the reference reads past it (its oob values, then
    zeros).  Returns a new plane (kernel ``uv_sentinel``: one launch, a
    cluster of UVSM_CTAS CTAs an image, a warp a row, the planes staged
    in 16-byte copies: a CUDA plane off that grid raises)."""
    _uvsm_args(process, rf_ext)
    if process.device.type == "cpu":
        return uv_sentinel_marking_ref(process, rf_ext, res_uv)
    lib, stream = _cuda_args(process, rf_ext)
    b = process.shape[0]
    out = torch.empty_like(process)
    if b:
        with torch.cuda.device(process.device):
            build.check("nhw_uv_sentinel", lib.nhw_uv_sentinel(
                process.data_ptr(), rf_ext.data_ptr(), out.data_ptr(), b,
                rf_ext.shape[1], res_uv, stream))
        build.count("uv_sentinel")
    return out


# ---------------------------------------------------------------------------
# The programs below LOW7 (host.models.encoder._low_q_ll1_cleanup,
# _very_low_q_cleanup, _uv_ll_smooth; encoder/nhw_encoder.c:285-621,
# 2438-2477).  The LL1 cleanup's rows are independent walks: a visit reads
# its left neighbour as the walk left it (column 0 reads the previous row's
# column 511, which the walk never writes) and its right neighbour as it was.
# The very-low-q cleanup's pass 1 writes only within its row.  Its passes 2
# and 3, and the two passes of the chroma LL smoothing, share one
# recurrence: visit (r, j) reads rows r, r + 1 and r + 2 at columns j..j + 2
# and writes (r + 1, j + 1), so it depends only on visits (r, j - 1) and
# (r - 1, j + 1) and runs at wavefront step 2r + j; within a step no visit
# reads what another writes.  The very-low-q cleanup's far zeroings target
# the level-1 bands, which no pass reads, and are absorbing: they apply once
# after the passes, from fire masks.  The one exception is the stale-carry
# zeroing at carry 0, whose first target (0, 127) pass 3 and pass 4 read.

VLQ = 128                  # the LL2 quadrant the very-low-q passes walk
VLQ_P1 = VLQ - 4           # pass 1's visits a row
VLQ_WAVE = VLQ - 2         # the rows and the visits a row of passes 2-3
VLQ_MASKS = 4              # pass 1's fires, pass 2's, pass 3's, pass 3's hits
UVS = 64                   # the chroma LL2 block the smoothing walks


def _ll1_args(plane, x1: int) -> None:
    _check_plane(plane, "low_q_ll1_cleanup plane", N)
    if x1 not in (10, 11):
        raise ValueError(f"low_q_ll1_cleanup: x1 {x1}, not 10 or 11")


def low_q_ll1_cleanup_ref(plane, x1: int):
    """Torch twin of ``ll1_rows``: the 256 column steps of rows 128..255
    as a batch, the left neighbour as the walk left it, the right one as
    it was."""
    _ll1_args(plane, x1)
    I = _i32(plane)
    out = I.clone()
    rows = I[:, 128:D]
    left = I[:, 127:D - 1, N - 1]
    for j in range(D):
        v, right = rows[..., j], rows[..., j + 1]
        av = v.abs()
        lsm, rsm = left.abs() < 8, right.abs() < 8
        z = (av >= 8) & (av < x1) & ((lsm & rsm) | ((av == 8) & (lsm | rsm)))
        left = torch.where(z, 0, v)
        out[:, 128:D, j] = left
    return out.to(torch.int16)


def low_q_ll1_cleanup_device(plane, x1: int):
    """``_low_q_ll1_cleanup`` (q <= LOW9; x1 10 above LOW14, 11 at or
    below) on a (B, 512, 512) int16 plane: rows 128..255, columns 0..255,
    bit-exact vs the host copy's C.  Returns a new plane (kernel
    ``ll1_rows``: one launch of 32 staged rows a CTA, a thread a row)."""
    _ll1_args(plane, x1)
    if plane.device.type == "cpu":
        return low_q_ll1_cleanup_ref(plane, x1)
    lib, stream = _cuda_args(plane)
    out = plane.clone()
    if plane.shape[0]:
        with torch.cuda.device(plane.device):
            build.check("nhw_low_q_ll1_cleanup", lib.nhw_low_q_ll1_cleanup(
                plane.data_ptr(), out.data_ptr(), plane.shape[0], x1,
                stream))
        build.count("low_q_ll1_cleanup")
    return out


def _vlq_p1_ref(P, x1: int, x2: int):
    """Pass 1 on the (B, 128, 128) int32 LL2 quadrant P, in place: the
    124 column steps of the rows as a batch (a window's write at j + 2 is
    read by the next two steps).  Returns its fires (B, 128, 124) bool."""
    fires = []
    for j in range(VLQ_P1):
        p0, p1, p2, p3, p4 = (P[..., j + k] for k in range(5))
        c1 = (((p4 - p0).abs() < x1) & ((p4 - p3).abs() < x1)
              & ((p1 - p0).abs() < x1) & ((p3 - p1).abs() < x1)
              & ((p3 - p2).abs() < x2 - 2))
        b1 = (p3 - p1 > 5) & (p2 - p3 >= 0)
        b2 = ~b1 & (p1 - p3 > 5) & (p2 - p3 <= 0)
        b3 = ~b1 & ~b2 & (p1 - p3 > 5) & (p2 - p1 >= 0)
        b4 = ~b1 & ~b2 & ~b3 & (p3 - p1 > 5) & (p2 - p1 <= 0)
        rest = ~(b1 | b2 | b3 | b4)
        keep = rest & (((p3 - p2 > 0) & (p2 - p1 > 0))
                       | ((p1 - p2 > 0) & (p2 - p3 > 0)))
        wv = torch.where(b1 | b2, p3, torch.where(b3 | b4, p1,
                                                  (p3 + p1) >> 1))
        P[..., j + 2] = torch.where(c1 & ~keep, wv, p2)
        c2 = (~c1 & ((p4 - p0).abs() < x2 + 1) & ((p4 - p3).abs() < x2 + 1)
              & ((p1 - p0).abs() < x2 + 1) & ((p3 - p1).abs() < x2 + 6)
              & ((p3 - p2).abs() < x2 + 6)
              & (((p3 - p2 >= 0) & (p2 - p1 >= 0))
                 | ((p3 - p2 <= 0) & (p2 - p1 <= 0))))
        fires.append(c1 | c2)
    return torch.stack(fires, -1)


def _vlq_args(plane, quality: int, xs7) -> None:
    _check_plane(plane, "very_low_q_cleanup plane", N)
    if not 1 <= quality < T.LOW7 or len(xs7) != 7:
        raise ValueError(f"very_low_q_cleanup: q{quality} with {xs7}; it "
                         f"runs at 1 <= q < {T.LOW7} with 7 thresholds")


VLQ_WARP = 32                      # rows a warp of vlq_rows, a lane each
VLQ_FAR_ROWS = 16                  # plane rows a CTA of vlq_far
VLQ_MASK_WORDS = 4 * VLQ * 4 + 4   # an image's masks and flags (u32)
# the level-2 targets of pass 3's stale carry (``_vlq_far``): offset and
# threshold, each at carry - 1..carry + 1 (carry 4 after a pass-1 fire,
# else 0)
VLQ_STALE = ((128, 11), (SZ, 12), (SZ + 128, 13))


def _vlq_relay_pass(P, variant: int, x3: int, x4: int, rnd: int,
                    stale0=None):
    """One wave pass of the very-low-q cleanup (variant 2 or 3) on the
    (B, 128, 128) int32 quadrant P, in place, as ``vlq_rows`` walks it: a
    lane a row r < VLQ_WAVE, its visit j at step 2 r + j of its warp
    (the warps run 69 steps apart, lane 0 of each reading from shared
    memory the row the warp above wrote; the twin takes the steps of the
    rows together, the order the relay keeps).  Each row keeps its
    windows: row r at columns j..j + 2 (T, each new value the one row r -
    1 wrote a step before, passed a lane on; columns 0 and 127 and row 0
    are inputs) and row r + 1 (M: its own writes, then inputs); row r + 2
    at j + 1 is an input.  stale0 (B,) bool: images whose pass-3 hits in
    row 0 before its first fire zero (0, 127) below 11.  Returns (inner,
    outer) (B, 126, 126) bool in the visit frame."""
    b, dev = P.shape[0], P.device
    m = VLQ_WAVE
    r = torch.arange(VLQ, device=dev)
    r1, r2 = (r + 1).clamp(max=VLQ - 1), (r + 2).clamp(max=VLQ - 1)
    T0 = T1 = T2 = torch.zeros((b, VLQ), dtype=P.dtype, device=dev)
    M0, M1, M2 = (P[:, r1, k] for k in range(3))
    # (B, 128, 128): each row's visits, rows 126 and 127 idle
    inner_m = torch.zeros((b, VLQ, VLQ), dtype=torch.bool, device=dev)
    outer_m = torch.zeros_like(inner_m)
    fired0 = torch.zeros(b, dtype=torch.bool, device=dev)
    for s in range(-3, 3 * m - 2):
        # every row takes part in every step (the idle ones write back
        # what they read: a row writes only the row below it)
        j = s - 2 * r
        act = (r < m) & (j >= 0) & (j < m)
        jj = j.clamp(0, m - 1)
        B2 = P[:, r2, jj + 1]
        if variant == 2:
            outer = ((T1 - B2).abs() < x3) & ((M0 - M2).abs() < x3)
            inner = (outer & ((M1 - M0).abs() < x4 - 1)
                     & ((T1 - M1).abs() < x4))
        else:
            outer = (((T2 - T1).abs() < x3) & ((T1 - T0).abs() < x3)
                     & ((T0 - M0).abs() < x3) & ((T2 - M2).abs() < x3))
            inner = outer & ((B2 - M0).abs() < x3) & ((M0 - M1).abs() < x4)
        e = (T1 + B2 + M0 + M2 + rnd) >> 2
        w = inner & (((e - M0).abs() < 5) | ((e - M2).abs() < 5))
        val = torch.where(w, e, M1)
        P[:, r1, jj + 1] = torch.where(act, val, P[:, r1, jj + 1])
        inner_m[:, r, jj] = torch.where(act, inner, inner_m[:, r, jj])
        outer_m[:, r, jj] = torch.where(act, outer, outer_m[:, r, jj])
        if stale0 is not None and 0 <= s < m:     # row 0 in this step
            z = (stale0 & outer[:, 0] & ~inner[:, 0] & ~fired0
                 & (P[:, 0, VLQ - 1].abs() < 11))
            P[:, 0, VLQ - 1] = torch.where(z, 0, P[:, 0, VLQ - 1])
            fired0 |= inner[:, 0]
        # the relay: row r's next value at column j + 3, the write of row
        # r - 1 in this step (or an input)
        cin = j + 3
        relay = (r >= 1) & (cin >= 1) & (cin <= m)
        got = torch.where(relay, _flat_shift_r(val, 1),
                          P[:, r, cin.clamp(0, VLQ - 1)])
        sh = (cin >= 0) & (cin < VLQ)
        T0, T1, T2 = (torch.where(sh, T1, T0), torch.where(sh, T2, T1),
                      torch.where(sh, got, T2))
        nxt = P[:, r1, (j + 3).clamp(0, VLQ - 1)]
        M0, M1, M2 = (torch.where(act, val, M0), torch.where(act, M2, M1),
                      torch.where(act, nxt, M2))
    inner_m, outer_m = inner_m[:, :m, :m], outer_m[:, :m, :m]
    return inner_m, outer_m


def very_low_q_passes_ref(plane, quality: int, xs7):
    """Passes 1-3 of the very-low-q cleanup as ``vlq_rows`` walks them, on
    the LL2 quadrant of a copy of ``plane`` -> (the copy, masks (B, 4, 128,
    128) bool in the visit frame: pass 1's fires, pass 2's, pass 3's, pass
    3's hits)."""
    _vlq_args(plane, quality, xs7)
    x1, x2, x3, x4 = xs7[:4]
    out = plane.clone()
    P = _i32(plane[:, :VLQ, :VLQ])
    b = P.shape[0]
    masks = torch.zeros((b, VLQ_MASKS, VLQ, VLQ), dtype=torch.bool,
                        device=plane.device)
    masks[:, 0, :, :VLQ_P1] = _vlq_p1_ref(P, x1, x2)
    f2, _ = _vlq_relay_pass(P, 2, x3, x4, 2)
    stale0 = ~masks[:, 0].flatten(1).any(1) & ~f2.flatten(1).any(1)
    stale0 &= quality <= T.LOW9
    f3, h3 = _vlq_relay_pass(P, 3, x3, x4, 1, stale0)
    masks[:, 1, :VLQ_WAVE, :VLQ_WAVE] = f2
    masks[:, 2, :VLQ_WAVE, :VLQ_WAVE] = f3
    masks[:, 3, :VLQ_WAVE, :VLQ_WAVE] = h3
    out[:, :VLQ, :VLQ] = P.to(torch.int16)
    return out, masks


def _first_pos(m):
    """Each image's first set position of m (B, ...) in raster order, and
    whether it has one."""
    f = m.flatten(1)
    has = f.any(1)
    return torch.where(has, f.to(torch.int8).argmax(1), f.shape[1]), has


def very_low_q_plan(plane, quality: int, xs7):
    """What ``vlq_rows`` hands ``vlq_far``: {"quad": the LL2 quadrant
    after passes 1-3 and the stale carry's (0, 127) (B, 128, 128) int16,
    "masks": (B, 4, 128, 128) bool in the count frame (a count position
    (r, c) is plane position r * 512 + c): cnt1 (pass 1's fires, each at
    c + 1..c + 3), d23 (passes 2-3's fires at (r + 1, c + 1)), fe34 (pass
    4's fires at c + 1, q <= LOW9) and l2 (the level-2 zeroings': cnt1, d23
    and its row neighbours, fe34; q <= LOW9), "stale": (B,) int32, the
    stale carry's zeroing (0 none, 1 carry 4, 2 carry 0; q <= LOW9)}.
    Pass 4 reads the quadrant once passes 1-3 and the stale carry's
    zeroing of (0, 127) are done."""
    out, vm = very_low_q_passes_ref(plane, quality, xs7)
    x7 = xs7[6]
    low9 = quality <= T.LOW9
    p1, f2, f3, h3 = vm.unbind(1)
    b, dev = plane.shape[0], plane.device
    quad = _i32(out[:, :VLQ, :VLQ])
    stale = torch.zeros(b, dtype=torch.int32, device=dev)
    fe34 = torch.zeros_like(p1)
    if low9:
        hpos, has = _first_pos(h3)
        fpos, _ = _first_pos(f3)
        on = has & (hpos < fpos) & ~f2.flatten(1).any(1)
        any1 = p1.flatten(1).any(1)
        stale = torch.where(on, torch.where(any1, 1, 2), 0).int()
        z = (stale == 2) & (quad[:, 0, VLQ - 1].abs() < 11)
        quad[:, 0, VLQ - 1] = torch.where(z, 0, quad[:, 0, VLQ - 1])
        d = [(_flat_shift_l(quad, 2) - _flat_shift_l(quad, 1)).abs(),
             (_flat_shift_l(quad, 2) - quad).abs(),
             (_flat_shift_l(quad, 1) - quad).abs()]
        fire4 = (d[0] < x7) & (d[1] < x7) & (d[2] < x7)
        fire4[..., VLQ_WAVE:] = False
        fe34 = _flat_shift_r(fire4, 1, False)
    cnt1 = (_flat_shift_r(p1, 1, False) | _flat_shift_r(p1, 2, False)
            | _flat_shift_r(p1, 3, False))
    d23 = torch.zeros_like(f2)
    d23[:, 1:, 1:] = (f2 | f3)[:, :-1, :-1]
    l2 = torch.zeros_like(p1)
    if low9:
        l2 = (cnt1 | d23 | _flat_shift_r(d23, 1, False)
              | _flat_shift_l(d23, 1, False) | fe34)
    return {"quad": quad.to(torch.int16),
            "masks": torch.stack([cnt1, d23, fe34, l2], 1), "stale": stale}


def _up2(m):
    """(B, 128, 128) -> (B, 256, 256): each position over its 2 x 2 block
    (a count position's band targets c2 + 0/1 and c2 + row + 0/1)."""
    return m.repeat_interleave(2, 1).repeat_interleave(2, 2)


def _vlq_far_ref(plane, plan, xs7):
    """``vlq_far`` on a (B, 512, 512) int16 plane: outside the LL2
    quadrant each position is zeroed where a mask of ``plan`` reaches it
    and |v| lies below its threshold: the level-2 bands beside the
    quadrant by l2 (11, 12, 13), the level-1 bands by cnt (cnt1 | d23 |
    fe34) over each 2 x 2 block (x6, x6 + 6) and, in the last, by cnt1
    (x5), d23 (32) and fe34 (34); and the stale carry's targets (carry -
    1..carry + 1 at VLQ_STALE).  The quadrant is ``plan``'s.  Returns the
    new plane."""
    x5, x6 = xs7[4:6]
    cnt1, d23, fe34, l2 = plan["masks"].unbind(1)
    cnt = cnt1 | d23 | fe34
    v = _i32(plane).abs()
    z = torch.zeros(plane.shape, dtype=torch.bool, device=plane.device)
    z[:, :D, D:] = _up2(cnt) & (v[:, :D, D:] < x6)
    z[:, D:, :D] = _up2(cnt) & (v[:, D:, :D] < x6 + 6)
    e = v[:, D:, D:]
    z[:, D:, D:] = ((_up2(cnt1) & (e < x5)) | (_up2(d23) & (e < 32))
                    | (_up2(fe34) & (e < 34)))
    z[:, :VLQ, VLQ:D] = l2 & (v[:, :VLQ, VLQ:D] < 11)
    z[:, VLQ:D, :VLQ] = l2 & (v[:, VLQ:D, :VLQ] < 12)
    z[:, VLQ:D, VLQ:D] = l2 & (v[:, VLQ:D, VLQ:D] < 13)
    zf, vf = z.view(len(z), -1), v.view(len(v), -1)
    for mode, base in ((1, 3), (2, -1)):
        on = plan["stale"] == mode
        for o, thr in VLQ_STALE:
            for k in range(base, base + 3):
                zf[:, k + o] |= on & (vf[:, k + o] < thr)
    out = plane.masked_fill(z, 0)
    out[:, :VLQ, :VLQ] = plan["quad"]
    return out


def very_low_q_cleanup_ref(plane, quality: int, xs7):
    """Torch twin of ``very_low_q_cleanup_device``: ``very_low_q_plan``
    (passes 1-3 by the warp relay, the stale carry, pass 4, the count
    masks), then ``_vlq_far_ref``."""
    return _vlq_far_ref(plane, very_low_q_plan(plane, quality, xs7), xs7)


def very_low_q_cleanup_device(plane, quality: int, xs7):
    """``_very_low_q_cleanup`` (q < LOW7) on a (B, 512, 512) int16 plane,
    bit-exact vs the host copy's C; xs7 = (x1, .., x7), the host copy's
    ``encoder._VLQ_THRX(quality, None)``.  Returns a new plane (kernel
    ``very_low_q_cleanup``: ``vlq_rows``, one CTA an image, passes 1-4 on
    the quadrant in shared memory, passes 2-3 relayed lane to lane and
    warp to warp, the count masks out as bits; then ``vlq_far``, a CTA
    every VLQ_FAR_ROWS plane rows, the far zeroings in 16-byte
    accesses)."""
    _vlq_args(plane, quality, xs7)
    if plane.device.type == "cpu":
        return very_low_q_cleanup_ref(plane, quality, xs7)
    lib, stream = _cuda_args(plane)
    b = plane.shape[0]
    out = torch.empty_like(plane)
    masks = torch.empty((b, VLQ_MASK_WORDS), dtype=torch.int32,
                        device=plane.device)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_very_low_q_cleanup", lib.nhw_very_low_q_cleanup(
                plane.data_ptr(), out.data_ptr(), masks.data_ptr(), b,
                int(quality <= T.LOW9), *map(int, xs7), stream))
        build.count("very_low_q_cleanup")
    return out


# S14's relay (csrc/vlq.cu uvs_relay): the rows and visits a row of a
# pass, the staged row's pitch and the slack before row 0 (int16), a
# barrier every UVS_SYNC steps, warp 1 of a pass UVS_LAG steps behind
# warp 0, pass 3 UVS_DELAY steps behind pass 2, UVS_LEAD idle steps
# before a lane's visit 0
UVS_WAVE = UVS - 2
UVS_PITCH = 68
UVS_FRONT = 16
UVS_SYNC = 3
UVS_LAG = 65 + UVS_SYNC
UVS_DELAY = 2 * UVS_SYNC + 4
UVS_LEAD = 4


def uvs_steps() -> int:
    """The relay's steps: pass 3's row 61 visits column 61 in the last,
    rounded up to a barrier."""
    last = UVS_LEAD + UVS_LAG + 2 * (UVS_WAVE - 1 - 32) + UVS_DELAY + UVS_WAVE
    return -(-last // UVS_SYNC) * UVS_SYNC


def _uvs_relay_ref(P) -> None:
    """Both passes of the chroma LL smoothing on the (B, 64, 64) int32
    block P, in place, as ``uvs_relay`` walks them: 128 lanes, warp w & 1
    of pass 2 + (w >> 1), lane l on row r = 32 (w & 1) + l, its visit j at
    step s = j + UVS_LEAD + UVS_LAG (w & 1) + 2 l + UVS_DELAY (w >> 1).
    Each lane keeps its windows (row r at columns j..j + 2, each new value
    the one lane l - 1 wrote in the step before, else loaded; row r + 1;
    row r + 2 at j + 1), every load a step ahead; a load sees the block as
    it stood at the last barrier (every UVS_SYNC steps), so a lag or delay
    too short for the dependences reads a stale value here as it may on
    the card."""
    b, dev = P.shape[0], P.device
    lanes = torch.arange(128, device=dev)
    lane, w = lanes % 32, lanes // 32
    r = (w % 2) * 32 + lane
    pass3 = w >= 2
    j = -UVS_LEAD - UVS_LAG * (w % 2) - 2 * lane - UVS_DELAY * pass3
    # flat offsets of rows r, r + 1 and r + 2 (clamped to the block) in
    # the staged layout: pitch UVS_PITCH after UVS_FRONT of slack
    base = UVS_FRONT + UVS_PITCH * torch.stack(
        [r, (r + 1).clamp(max=UVS - 1), (r + 2).clamp(max=UVS - 1)])
    size = UVS_FRONT + UVS * UVS_PITCH + uvs_steps()
    live = torch.zeros((b, size), dtype=P.dtype, device=dev)
    cells = (UVS_FRONT + UVS_PITCH * torch.arange(UVS, device=dev)[:, None]
             + torch.arange(UVS, device=dev)).reshape(-1)
    live[:, cells] = P.reshape(b, -1)
    seen = live.clone()
    rnd = torch.where(pass3, 1, 2).to(P.dtype)
    zero = torch.zeros((b, 128), dtype=P.dtype, device=dev)
    t0 = t1 = t2 = m0 = m1 = m2 = b2 = mn = tn = zero
    for s in range(uvs_steps()):
        act = (r < UVS_WAVE) & (j >= 0) & (j < UVS_WAVE)
        b2n = seen[:, base[2] + j + 2]
        mnn = seen[:, base[1] + j + 4]
        tnn = seen[:, base[0] + j + 4]
        inner2 = (((t1 - b2).abs() < 5) & ((m0 - m2).abs() < 5)
                  & ((m1 - m0).abs() < 7) & ((t1 - m1).abs() < 8))
        inner3 = (((t2 - t1).abs() < 5) & ((t1 - t0).abs() < 5)
                  & ((t0 - m0).abs() < 5) & ((t2 - m2).abs() < 5)
                  & ((b2 - m0).abs() < 5) & ((m0 - m1).abs() < 8))
        inner = torch.where(pass3, inner3, inner2)
        e = (t1 + b2 + m0 + m2 + rnd) >> 2
        val = torch.where(act & inner, e, m1)
        live[:, (base[1] + j + 1)[act]] = val[:, act]
        # lane l - 1's value, within each warp (lane 0 keeps its own)
        recv = torch.where(lane > 0, val.roll(1, 1), val)
        cin = j + 3
        mid = (lane > 0) & (cin >= 1) & (cin <= UVS_WAVE)
        t0, t1, t2 = t1, t2, torch.where(mid, recv, tn)
        m0, m1, m2 = val, m2, mn
        b2, mn, tn = b2n, mnn, tnn
        j = j + 1
        if (s + 1) % UVS_SYNC == 0:
            seen = live.clone()
    P.copy_(live[:, cells].reshape(b, UVS, UVS))


def uv_ll_smooth_ref(process):
    """Torch twin of ``uvs_relay``: both passes on the 64 x 64 corner as
    the relay walks them (``_uvs_relay_ref``)."""
    _check(process, "uv_ll_smooth process", torch.int16, (None, D, D))
    out = process.clone()
    P = _i32(process[:, :UVS, :UVS])
    _uvs_relay_ref(P)
    out[:, :UVS, :UVS] = P.to(torch.int16)
    return out


def uv_ll_smooth_device(process):
    """``_uv_ll_smooth`` (q <= LOW9) on (B, 256, 256) int16 chroma
    planes, bit-exact vs the host copy's C: two smoothing passes over the
    LL2 block.  Returns a new plane (kernel ``uvs_relay``: one launch, one
    CTA a plane, the two passes walked together in shared memory, a lane a
    row)."""
    _check(process, "uv_ll_smooth process", torch.int16, (None, D, D))
    if not process.is_contiguous():
        raise ValueError("uv_ll_smooth process: plane must be contiguous")
    if process.device.type == "cpu":
        return uv_ll_smooth_ref(process)
    lib, stream = _cuda_args(process)
    out = process.clone()
    if process.shape[0]:
        with torch.cuda.device(process.device):
            build.check("nhw_uv_ll_smooth", lib.nhw_uv_ll_smooth(
                out.data_ptr(), process.shape[0], stream))
        build.count("uv_ll_smooth")
    return out


# ---------------------------------------------------------------------------
# E16/E17 walks: the visited mask of a forward walk over static successors.
# The highres coders' per-node successor and emission are pure functions of
# their input buffer, so each coder is one walk from node 1.

WALK_MAX_N = 1 << 16      # csrc/ll2.cu kWalkMaxN: jumps staged as uint16


def _walk_args(nxt, start: int) -> None:
    _check(nxt, "walk_visited nxt", torch.int32, (None, None))
    n = nxt.shape[1]
    if not 1 <= n <= WALK_MAX_N:
        raise ValueError(f"walk_visited: rows of {n} successors; a jump "
                         f"must fit 16 bits, so at most {WALK_MAX_N}")
    if not 0 <= start < n:
        raise ValueError(f"walk_visited: start {start} outside [0, {n})")
    if not nxt.is_contiguous():
        raise ValueError("walk_visited nxt: must be contiguous")


def walk_segment_log2(n: int) -> int:
    """log2 of S8's segment: the least power of two s with s * s >= n, so
    that a row of n <= 65536 nodes has at most 256 segments of at most
    256 nodes (csrc/ll2.cu kWalkMaxSegs, kWalkMaxSegLog2)."""
    return ((n - 1).bit_length() + 1) // 2


def walk_visited_ref(nxt, start: int = 1):
    """Torch twin of ``walk_visited``, in its decomposition, vectorised
    over rows and segments (s = 2^``walk_segment_log2(n)`` nodes each):
    (a) every node's last node within its segment on the walk from it, one
    backward step over all segments at a time; (b) the chain of segment
    entries from ``start``, a hop a segment (entry -> its last node -> that
    node's successor); (c) each segment walked from its entry, marking.
    The walk ends at the first successor outside (i, n)."""
    _walk_args(nxt, start)
    b, n = nxt.shape
    dev = nxt.device
    s = 1 << walk_segment_log2(n)
    segs = -(-n // s)
    idx = torch.arange(n, device=dev)
    x = nxt.long()
    jump = torch.where((x > idx) & (x < n), x - idx, 0)
    # padding nodes past n end their walk where they stand
    jump = torch.nn.functional.pad(jump, (0, segs * s - n)).reshape(b, segs,
                                                                    s)
    # (a)
    last = torch.zeros_like(jump)
    for o in range(s - 1, -1, -1):
        d = jump[:, :, o]
        leaves = (d == 0) | (o + d >= s)
        on = torch.gather(last, 2, (o + d).clamp(max=s - 1)[:, :, None])
        last[:, :, o] = torch.where(leaves, o, on[:, :, 0])
    # (b)
    rows = torch.arange(b, device=dev)
    flat_last, flat_jump = last.reshape(b, -1), jump.reshape(b, -1)
    entry = torch.full((b, segs + 1), -1, dtype=torch.long, device=dev)
    cur = torch.full((b,), start, dtype=torch.long, device=dev)
    alive = torch.ones(b, dtype=torch.bool, device=dev)
    for _ in range(segs):
        g = cur // s
        entry[rows, torch.where(alive, g, segs)] = cur
        p = g * s + flat_last[rows, cur]
        d = flat_jump[rows, p]
        alive = alive & (d > 0)
        cur = torch.where(alive, p + d, cur)
    # (c)
    vis = torch.zeros((b, segs * s), dtype=torch.bool, device=dev)
    cur = entry[:, :segs]
    live = cur >= 0
    seg = torch.arange(segs, device=dev)
    dump = segs * s
    vis = torch.nn.functional.pad(vis, (0, 1))
    for _ in range(s):
        at = torch.where(live, cur, dump)
        vis.scatter_(1, at, True)
        d = torch.gather(flat_jump, 1, at.clamp(max=dump - 1))
        cur = cur + d
        live = live & (d > 0) & (cur // s == seg)
    return vis[:, :n]


def walk_visited_device(nxt, start: int = 1):
    """The visited mask (B, n) bool of the walk start -> nxt[start] -> ...
    over (B, n) int32 successors, n <= 65536.  Successors increase
    (nxt[i] > i); one >= n parks the walk, and the walk also ends at one
    that does not increase.  The JAX package resolves it by pointer
    doubling (``_walk_visited``); here it is kernel ``walk_visited`` (one
    launch, one CTA a row, the walk by segments: ``walk_visited_ref``)."""
    _walk_args(nxt, start)
    if nxt.device.type == "cpu":
        return walk_visited_ref(nxt, start)
    lib, stream = _cuda_args(nxt)
    b, n = nxt.shape
    vis = torch.empty((b, n), dtype=torch.bool, device=nxt.device)
    if b:
        with torch.cuda.device(nxt.device):
            build.check("nhw_walk_visited", lib.nhw_walk_visited(
                nxt.data_ptr(), vis.data_ptr(), b, n, start,
                walk_segment_log2(n), stream))
        build.count("walk_visited")
    return vis


# ---------------------------------------------------------------------------
# E16 head: the Y LL2 byte coding (host.ops.ll2.ll2_code_y,
# encoder/nhw_encoder.c:636-743).  The 4-run odd marking is a skip walk a
# row (its windows see the original parities: the marks are even).  The
# odd-pattern nudges chain within a row only through the 2a fire's +1 on
# the next column, which makes that column even (a run parity), and into
# the next row (a 128-step scan carrying ``pend``).  Escapes emit the last
# non-escaped value.

LL = 128                 # the Y LL2 block's side
LL_ROW = LL + 3          # the scan's row: the reads at j = 126/127 reach
                         # plane columns 128-129 (the band area)
LL_N = LL * LL
UV_LL = 64               # the chroma LL2 block's side


LL2_CTAS = 8                        # csrc/ll2.cu kYCtas: a cluster an image
LL2_BAND_ROWS = 8                   # rows a band, a warp each (kYBandRows)
LL2_BANDS = LL // LL2_BAND_ROWS     # bands an image (kYBands)
LL2_LANE = 4                        # positions a lane (4 l..4 l + 3)
_LL2_ID = 0xE4                      # the identity map of the skip counter


def _skip_maps(match):
    """The skip walk's map at each position, the counter (0..3) before it
    to the counter after it, 2 bits a state: a match at counter 0 fires
    and leaves 3, else the counter counts down."""
    return torch.where(match, 0x93, 0x90)


def _compose4(a, b):
    """Maps "a then b", elementwise."""
    c = torch.zeros_like(a)
    for st in range(4):
        c |= ((b >> (2 * ((a >> (2 * st)) & 3))) & 3) << (2 * st)
    return c


def _ll2y_marks(ll):
    """The 4-run odd marking on the (B, R, 128) int32 LL2 rows as the
    kernel takes it, a warp a row: a window of four odd values with |v[j]
    - v[j + 3]| > 1 at j < 125 fires where the skip counter is 0, adds
    24000 at j and 16000 at j + 1..j + 3 (the skipped positions).  Lane l
    composes the counter's maps at positions 4 l..4 l + 3, the lanes'
    composites are scanned, and each lane walks its positions again from
    its entry state."""
    o = (ll & 1) == 1
    match = torch.zeros_like(o)
    match[..., :125] = (o[..., :125] & o[..., 1:126] & o[..., 2:127]
                        & o[..., 3:] & ((ll[..., :125] - ll[..., 3:]).abs()
                                        > 1))
    lanes = match.reshape(*match.shape[:-1], LL // LL2_LANE, LL2_LANE)
    maps = _skip_maps(lanes).to(torch.int32)
    comp = maps[..., 0]
    for i in range(1, LL2_LANE):
        comp = _compose4(comp, maps[..., i])
    # the lanes' exclusive scan: lane l's entry map is lanes 0..l - 1's
    entry = torch.full_like(comp, _LL2_ID)
    for lane in range(1, LL // LL2_LANE):
        entry[..., lane] = _compose4(entry[..., lane - 1], comp[..., lane - 1])
    state = entry & 3                    # the counter from 0 at position 0
    add = torch.zeros_like(maps)
    for i in range(LL2_LANE):
        fire = lanes[..., i] & (state == 0)
        add[..., i] = torch.where(fire, 24000, torch.where(state > 0, 16000,
                                                           0))
        state = torch.where(fire, 3, (state - 1).clamp(min=0))
    return ll + add.reshape(ll.shape)


def _ll2y_bands(w, gt_low3: bool, entry):
    """Every band of LL2_BAND_ROWS rows walked in order from its entry
    pend (``entry``: (B, LL2_BANDS, 131) int32) on the marked rows 0..130
    ``w`` ((B, 131, 131) int32), a row's columns as lanes.  Returns (vem,
    is24, each (B, 128, 128), each band's exit pend)."""
    b = w.shape[0]
    dev = w.device
    jc = torch.arange(LL_ROW, device=dev)
    none = torch.zeros((b, LL2_BANDS, LL_ROW), dtype=torch.bool, device=dev)
    vem = torch.empty((b, LL2_BANDS, LL2_BAND_ROWS, LL), dtype=torch.int32,
                      device=dev)
    is24 = torch.empty_like(vem, dtype=torch.bool)
    pend = entry

    def odd(x):
        return (x & 1) == 1

    for k in range(LL2_BAND_ROWS):
        r = torch.arange(LL2_BANDS, device=dev) * LL2_BAND_ROWS + k
        cur = w[:, r] + pend
        marked = cur > 10000 if gt_low3 else none
        c2 = _flat_shift_l(cur, 2)
        o1, o2 = odd(_flat_shift_l(cur)), odd(c2)
        # the within-row 2a fire: +1 on the next column
        f2a = (~marked & odd(cur) & (jc > 0) & o1 & (jc < 126) & o2
               & ((cur - c2).abs() > 1))
        fire = _run_parity_fire(f2a) if gt_low3 else none
        v = cur + _flat_shift_r(fire, 1, False).to(torch.int32)
        # the cross-row nudges: +1 on row r + 1, column j, from the rows
        # below as marked (a row only nudges the next one, at its column)
        n0 = w[:, r + 1]
        n1, n2 = _flat_shift_l(n0, 1), _flat_shift_l(n0, 2)
        live = ~marked & odd(v) & odd(n0) & odd(n1) & (n0 < 10000)
        left = (jc > 0) & o1
        rr = r[:, None]
        b2b = live & left & ~((jc < 126) & o2) & ~odd(n2) & (rr <= 126)
        b3 = (live & ~left & odd(w[:, r + 2]) & ~odd(w[:, r + 3])
              & (rr >= 1) & (rr <= 124))
        pend = ((b2b | b3) & (jc < LL) & gt_low3).to(torch.int32)
        hi = v > 20000 if gt_low3 else none
        mid = v > 10000 if gt_low3 else none
        out = torch.where(hi, v - 24000, torch.where(mid, v - 16000, v))
        vem[:, :, k] = out[..., :LL]
        is24[:, :, k] = hi[..., :LL]
    return vem.reshape(b, LL, LL), is24.reshape(b, LL, LL), pend


def _ll2y_sweeps(plane, gt_low3: bool):
    """The marks (``_ll2y_marks``), then the nudge scan as the kernel takes
    it: every band walked from no pend, then each band's entry set to the
    exit of the band above and the bands walked again while an entry
    changes (after s sweeps bands 0..s - 1 are exact, so LL2_BANDS sweeps
    at most).  Returns (vem (B, 16384) int32, is24 (B, 16384) bool, the
    sweeps each image took, (B,) int32)."""
    b = plane.shape[0]
    # rows 0..130: the cross-row reads of rows r + 1..r + 3 stay inside
    w = _i32(plane)[:, :LL_ROW, :LL_ROW].clone()
    if gt_low3:
        w[:, :LL, :LL] = _ll2y_marks(w[:, :LL, :LL])
    entry = torch.zeros((b, LL2_BANDS, LL_ROW), dtype=torch.int32,
                        device=plane.device)
    vem, is24, exits = _ll2y_bands(w, gt_low3, entry)
    sweeps = torch.ones(b, dtype=torch.int32, device=plane.device)
    for _ in range(LL2_BANDS - 1):
        want = torch.cat([torch.zeros_like(exits[:, :1]), exits[:, :-1]], 1)
        moved = (want != entry).flatten(1).any(1)
        if not bool(moved.any()):
            break
        entry = want
        vem, is24, exits = _ll2y_bands(w, gt_low3, entry)
        sweeps += moved.int()
    return vem.reshape(b, LL_N), is24.reshape(b, LL_N), sweeps


def ll2_code_y_ref(plane, gt_low3: bool):
    """Torch twin of ``ll2_code_y``: the marks by the skip counter's map
    scan, then the nudge scan by bands relayed (``_ll2y_sweeps``).
    Returns (vem (B, 16384) int32, each LL2 position's value after its
    nudges and unmark, is24 (B, 16384) bool, its 24000 marks)."""
    _check_plane(plane, "ll2_code_y plane", N)
    return _ll2y_sweeps(plane, gt_low3)[:2]


def ll2_code_y_sweeps(plane, gt_low3: bool):
    """The sweeps of ``ll2_code_y``'s nudge scan over the bands of each
    image of a (B, 512, 512) int16 plane (1..LL2_BANDS; the twin's, which
    takes the kernel's bands and relay), (B,) int32."""
    _check_plane(plane, "ll2_code_y plane", N)
    return _ll2y_sweeps(plane, gt_low3)[2]


def ll2_code_y_scan(plane, gt_low3: bool):
    """The serial part of ``ll2_code_y_device`` on a (B, 512, 512) int16
    plane: (vem, is24) as ``ll2_code_y_ref`` gives them (kernel
    ``ll2_code_y``: one launch, a cluster of LL2_CTAS CTAs an image, a warp
    a band of LL2_BAND_ROWS rows, the rows staged in 16-byte copies: a
    CUDA plane off that grid raises)."""
    _check_plane(plane, "ll2_code_y plane", N)
    if plane.device.type == "cpu":
        return ll2_code_y_ref(plane, gt_low3)
    lib, stream = _cuda_args(plane)
    b = plane.shape[0]
    vem = torch.empty((b, LL_N), dtype=torch.int32, device=plane.device)
    is24 = torch.empty((b, LL_N), dtype=torch.bool, device=plane.device)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_ll2_code_y", lib.nhw_ll2_code_y(
                plane.data_ptr(), vem.data_ptr(), is24.data_ptr(), b,
                int(gt_low3), stream))
        build.count("ll2_code_y")
    return vem, is24


def _escape_fill(v):
    """The LL2 coders' byte rule on (B, n) int32 values in raster order:
    position k > 0 escapes when v > 255 or v < 0 and repeats the previous
    tree1 byte, the last non-escaped value's ``& 254``.  Returns (esc_p,
    esc, clip (v clipped to 0..255), the repeated byte at each
    position)."""
    idx = torch.arange(v.shape[1], device=v.device, dtype=torch.int32)
    esc_p = (v > 255) & (idx > 0)
    esc = esc_p | ((v < 0) & (idx > 0))
    clip = v.clamp(0, 255)
    src = torch.cummax(torch.where(esc, -1, idx), dim=1).values
    prev = _flat_shift_r(src, 1, 0)
    return esc_p, esc, clip, torch.gather(clip & 254, 1, prev.long())


def _escape_words(v, esc_p, esc, side: int):
    """The escapes' (row, column (+ 128 above 255), magnitude) triples in
    raster order: ((B, n, 3) int32, the count of triples (B,))."""
    b, n = v.shape
    idx = torch.arange(n, device=v.device, dtype=torch.int32)
    jj = idx % side
    ev = torch.stack([(idx // side).expand(b, n),
                      torch.where(esc_p, jj + 128, jj),
                      torch.where(esc_p, (v - 255).clamp(max=255),
                                  -v.clamp(min=-255))], -1)
    m = esc.to(torch.int64)
    rank = torch.where(esc, torch.cumsum(m, 1) - m, n)
    buf = torch.zeros((b, n + 1, 3), dtype=torch.int32, device=v.device)
    buf.scatter_(1, rank[..., None].expand(b, n, 3), ev)
    return buf[:, :n], esc.sum(1, dtype=torch.int32)


def ll2_code_y_device(plane, gt_low3: bool):
    """``host.ops.ll2.ll2_code_y`` on (B, 512, 512) int16 planes, gt_low3
    = quality > LOW3.  Returns (plane' (its LL2 block zeroed), tree1 and
    ch_res (B, 16384) uint8, exw (B, 16384, 3) int32, n_exw (B,) (the C's
    exw list is the first n_exw triples), res4 (B, 16512) int32, n_res4
    (B,)): the marks and the nudge scan in ``ll2_code_y_scan``, the
    emissions in torch ops."""
    vem, is24 = ll2_code_y_scan(plane, gt_low3)
    b = plane.shape[0]
    esc_p, esc, clip, fill = _escape_fill(vem)
    tree1 = torch.where(esc, fill, clip & 254).to(torch.uint8)
    ch_res = torch.where(esc, fill, clip).to(torch.uint8)
    exw, n_exw = _escape_words(vem, esc_p, esc, LL)
    # res4: a row's 24000-mark columns (j + 1 each, the last + 128), or a
    # single 128 for a row without any
    m24 = is24.reshape(b, LL, LL)
    jr = torch.arange(LL, device=plane.device, dtype=torch.int32)
    last = m24 & (jr == torch.where(m24, jr, -1).amax(-1, keepdim=True))
    val = jr + 1 + 128 * last.to(torch.int32)
    grid_m = torch.cat([m24, ~m24.any(-1, keepdim=True)], 2)
    grid_v = torch.cat([val, torch.full((b, LL, 1), 128, dtype=torch.int32,
                                        device=plane.device)], 2)
    res4, n_res4 = _compact(grid_m.reshape(b, -1), grid_v.reshape(b, -1), 0,
                            LL * (LL + 1))
    out = plane.clone()
    out[:, :LL, :LL] = 0
    return out, tree1, ch_res, exw, n_exw, res4, n_res4


def ll2_code_uv_device(process):
    """``encode_uv``'s LL2 byte coding (the host copy's C
    ``nhw_ll2_code_uv``) on (B, 256, 256) int16 planes: the 64 x 64 block
    in raster order, escapes repeating the previous byte.  Returns
    (process' (its LL2 block zeroed), tree1_uv (B, 4096) uint8, exw (B,
    4096, 3) int32, n_exw (B,))."""
    _check(process, "ll2_code_uv plane", torch.int16, (None, D, D))
    b = process.shape[0]
    v = _i32(process[:, :UV_LL, :UV_LL]).reshape(b, UV_LL * UV_LL)
    esc_p, esc, clip, fill = _escape_fill(v)
    tree1 = torch.where(esc, fill, clip & 254).to(torch.uint8)
    exw, n_exw = _escape_words(v, esc_p, esc, UV_LL)
    out = process.clone()
    out[:, :UV_LL, :UV_LL] = 0
    return out, tree1, exw, n_exw


# ---------------------------------------------------------------------------
# E16/E17 run-delta compression (host.ops.ll2.y_highres_compression and
# uv_highres_compression, encoder/compress_pixel.c:471-1022): each node's
# successor and emission are functions of the input buffer, so the coder is
# a walk from node 1 (``walk_visited_device``) and a compaction of the
# visited nodes' emissions.  The Y coder picks its mode from per-image run
# statistics, in closed form per maximal run of equal pairs, and squeezes
# its bytes in a second walk over them.

YH_N = 16384
YH_PAD = YH_N + 8193 + 64      # tree1 and the tail the C reads past it
UV_N = 2 * UV_LL * UV_LL
UV_PAD = UV_N + 80
CH = 1 << 16                   # the Y coder's byte buffer
_FAR = 1 << 20


def _gather(h, pos):
    return torch.gather(h, 1, pos.clamp(0, h.shape[1] - 1).long())


def _streak(eq, idx):
    """E[i]: how many eq[k] hold in a row from k = i + 1 on (the equal
    pairs a run node at i can swallow), from the next false index by a
    reversed cummin."""
    npad = eq.shape[1]
    nf = torch.flip(torch.cummin(torch.flip(torch.where(eq, _FAR, idx),
                                            [1]), dim=1).values, [1])
    e = nf[:, (idx + 1).clamp(max=npad - 1).long()] - (idx + 1)
    return e.clamp(0, 1 << 19)


def _uv_nodes(h):
    """Each node's (emission, successor) of the UV coder over its (B,
    8272) int32 buffer; nodes from 8192 on park (successor 8272)."""
    npad = h.shape[1]
    idx = torch.arange(npad, device=h.device, dtype=torch.int32)
    h1, h2 = _flat_shift_l(h), _flat_shift_l(h, 2)
    scan = h - _flat_shift_r(h)
    count = h1 - h
    w = torch.where
    # a run of 2 + a equal values: up to 14 more pairs, then (below 7) the
    # pattern of the next three deltas
    a_run = _streak(h1 == h, idx).clamp(max=14)
    base = idx + a_run + 2
    g = [_gather(h, base + k) for k in (-1, 0, 1, 2)]
    d1, d2, d3 = g[1] - g[0], g[2] - g[1], g[3] - g[2]
    code0 = 64 + (a_run << 3)
    run_code = code0 + w(d1 == 4, w(d2 == -4, w(d3 == 0, 3, 2), 1),
                         w(d1 == -4, w(d2 == 4, w(d3 == 0, 4, 5), 6),
                           w(d1 == 8, 7, 0)))
    run_adv = w((d1 == 4) | (d1 == -4),
                w(d2 == -d1, w(d3 == 0, 3, 2), 1), w(d1 == 8, 1, 0))
    res1 = a_run >= 7
    run_nxt = w(res1, base, base + run_adv)
    run_emit = w(res1, 64 + 56 + a_run - 7, run_code)
    # the other nodes: a +-4 pair with its next delta, a +-16 pair, or the
    # value itself
    resv = torch.zeros_like(h)
    for k, (s, c) in enumerate(((0, 4), (0, -4), (4, 0), (-4, 0), (4, 4),
                                (4, -4), (-4, 4), (-4, -4))):
        resv = w((scan == s) & (count == c), k, resv)
    dd3 = h2 - h1
    quad = (dd3 == 0) | (dd3 == 4) | (dd3 == -4) | (dd3 == 8)
    q_add = w(dd3 == 0, 0, w(dd3 == 4, 1, w(dd3 == -4, 2, 3)))
    s16, c16 = scan + 16, count + 16
    pair_b = (s16 << 1) + (c16 >> 2)
    in4 = (scan.abs() <= 4) & (count.abs() <= 4)
    in16 = (scan.abs() <= 16) & (count.abs() <= 16)
    esc16 = (s16 == 32) | (c16 == 32)
    lit = 128 + (h >> 2)
    nr_emit = w(in4, w(quad, 192 + (resv << 2) + q_add, pair_b),
                w(in16 & ~esc16, pair_b, lit))
    nr_nxt = w(in4, w(quad, idx + 3, idx + 2),
               w(in16 & ~esc16, idx + 2, idx + 1))
    runb = (scan == 0) & (count == 0)
    nxt = w(idx < UV_N, w(runb, run_nxt, nr_nxt), npad)
    return _i32(w(runb, run_emit, nr_emit)), _i32(nxt)


def uv_highres_device(h):
    """``host.ops.ll2.uv_highres_compression`` on (B, 8272) int32 buffers
    (the two components' &252-masked tree1_uv, then the tail the C reads
    past them).  Returns (bytes (B, 8200) int32, count (B,) int32): the
    head byte h[0], then the visited nodes' emissions, one each."""
    _check(h, "uv_highres h", torch.int32, (None, UV_PAD))
    emit, nxt = _uv_nodes(h)
    idx = torch.arange(UV_PAD, device=h.device)
    live = walk_visited_device(nxt, 1) & (idx < UV_N) & (idx >= 1)
    vals, cnt = _compact(live, emit, 0, UV_N + 8)
    return torch.cat([h[:, :1], vals[:, : UV_N + 7]], 1), cnt + 1


def _yh_mode_select(h, eq, idx):
    """The Y coder's mode (B,) int32 from its run statistics
    (compress_pixel.c:482-497), in closed form per maximal run of equal
    pairs starting before 16384: Y counts the run's full 16s (the outer
    bound cuts them), a also its remainders of 8 or more, then res_low =
    2 if Y > 299, else 1 if a + Y > 179, else 0."""
    pr = _flat_shift_r(eq, 1, False)        # pair at k: h[k] == h[k - 1]
    start = pr & ~_flat_shift_r(pr, 1, False)
    end = pr & ~_flat_shift_l(pr, 1, False)
    sidx = torch.cummax(torch.where(start, idx, -1), dim=1).values
    p = torch.where(end, idx - sidx + 1, 0)
    s0 = torch.where(end, sidx, _FAR)
    started = s0 < YH_N
    full16 = p // 16
    centr = ((YH_N - s0 + 15) // 16).clamp(0, 1 << 19)
    yr = torch.where(started, torch.minimum(full16, centr), 0)
    rem = started & (s0 + 16 * full16 < YH_N) & ((p % 16) >= 8)
    y = yr.sum(1, dtype=torch.int32)
    a = (yr + rem.to(torch.int32)).sum(1, dtype=torch.int32) + y
    return torch.where(y > 299, 2, torch.where(a > 179, 1, 0)).to(
        torch.int32)


def _yh_nodes(h, eq, res_low, q_gt_low5: bool):
    """Each node's emissions (e0, e1, e2: up to three bytes), byte count,
    successor and escape flag for the Y coder in each image's mode
    ``res_low`` (B,), over (B, 24641) int32 h with its pairs eq (h[i + 1]
    == h[i]); nodes from 16384 on park."""
    npad = h.shape[1]
    idx = torch.arange(npad, device=h.device, dtype=torch.int32)
    h1, h2 = _flat_shift_l(h), _flat_shift_l(h, 2)
    scan = h - _flat_shift_r(h)
    count = h1 - h
    w = torch.where
    e = _streak(eq, idx)
    run0 = (scan == 0) & (count == 0)
    # the 3-byte triple, the same in every mode: scan + 32, count + 16 and
    # the next delta + 32 (h[i + 2] exists for i < 16382)
    s3, c3, e3v = scan + 32, count + 16, h2 - h1 + 32
    tri_ok = ((scan.abs() <= 32) & (count.abs() <= 16) & (idx < YH_N - 2)
              & ((h2 - h1).abs() <= 32) & (s3 != 64) & (c3 != 32)
              & (e3v != 64))
    cc = c3 >> 1
    # the escape: 128, h[i] / 2 + 128 and, above LOW5, h[i + 1] / 2 + 128
    esc_len, esc_step = (3, 2) if q_gt_low5 else (2, 1)
    e1 = w(tri_ok, 64 + s3 + (cc >> 3), 128 + (h >> 1))
    e2 = w(tri_ok, ((cc & 7) << 5) + (e3v >> 1),
           128 + (h1 >> 1) if q_gt_low5 else torch.zeros_like(h))
    rl = res_low[:, None]
    # mode 0: runs of 2-3, deltas +-2 / 4 after them; the 6 x 8 window
    a0 = (e >= 1).to(torch.int32)
    base0 = idx + a0 + 2
    d1 = _gather(h, base0) - _gather(h, base0 - 1)
    d2 = _gather(h, base0 + 1) - _gather(h, base0)
    c_add0 = w(d1 == 2, w(d2 == -2, 2, w(d2 == 0, 3, 1)),
               w(d1 == -2, w(d2 == 2, 4, w(d2 == 0, 5, 6)),
                 w(d1 == 4, 7, 0)))
    adv0 = w(((d1 == 2) | (d1 == -2)) & ((d2 == -d1) | (d2 == 0)), 2,
             w((d1 == 2) | (d1 == -2) | (d1 == 4), 1, 0))
    s0_, c0_ = scan + 6, count + 8
    plain0 = w(s0_ < 8, 32 + (s0_ << 2) + (c0_ >> 1),
               w(s0_ == 8, 16 + (c0_ >> 1), 24 + (c0_ >> 1)))
    win0 = ((scan.abs() <= 6) & (count.abs() <= 8) & (s0_ != 12)
            & (c0_ != 16))
    # mode 1: runs of 2-9, deltas +-2 / 0 after them; the 4 x 8 window
    a1 = e.clamp(max=7)
    base1 = idx + a1 + 2
    d1m = _gather(h, base1) - _gather(h, base1 - 1)
    c_add1 = w(d1m == 2, 1, w(d1m == -2, 2, w(d1m == 0, 3, 0)))
    adv1 = ((d1m == 2) | (d1m == -2) | (d1m == 0)).to(torch.int32)
    s1_ = scan + 4
    win1 = ((scan.abs() <= 4) & (count.abs() <= 8) & (s1_ != 8)
            & (count + 8 != 16))
    plain1 = 32 + (s1_ << 2) + ((count + 8) >> 1)
    # mode 2: runs of 2-65, no window
    a2 = e.clamp(max=63)
    run_e = w(rl == 0, (a0 << 3) + c_add0, w(rl == 1, (a1 << 2) + c_add1,
                                              a2))
    run_nxt = w(rl == 0, base0 + adv0, w(rl == 1, base1 + adv1,
                                         idx + a2 + 2))
    win = w(rl == 0, win0, w(rl == 1, win1, torch.zeros_like(win0)))
    plain = w(rl == 0, plain0, plain1)
    e0 = w(run0, run_e, w(win, plain, w(tri_ok, 64, 128)))
    ln = w(run0 | win, 1, w(tri_ok, 3, esc_len))
    nxt = w(run0, run_nxt, w(win, idx + 2, w(tri_ok, idx + 3,
                                             idx + esc_step)))
    isesc = ~run0 & ~win & ~tri_ok
    return (*map(_i32, (e0, e1, e2, ln, w(idx < YH_N, nxt, npad))), isesc)


def _scatter_bytes(live, lens, parts, head, width: int):
    """The live nodes' bytes in order into a (B, width) int32 buffer
    after the head byte: node i's byte k (k < lens) at 1 + (bytes of the
    live nodes before it) + k.  Returns (buffer, count)."""
    b = live.shape[0]
    lens = torch.where(live, lens, 0)
    off = 1 + torch.cumsum(lens, 1, dtype=torch.int32) - lens
    out = torch.zeros((b, width + 1), dtype=torch.int32, device=live.device)
    for k, ek in enumerate(parts):
        tgt = torch.where(live & (lens > k), off + k, width)
        out.scatter_(1, tgt.long(), ek)
    out = out[:, :width]
    out[:, 0] = head
    return out, 1 + lens.sum(1, dtype=torch.int32)


def _squeeze_nodes(ch, n_ch, q_gt_low5: bool):
    """The squeeze pass over the Y coder's bytes (compress_pixel.c:
    838-866): a 64 keeps the two bytes after it, a 128 the byte two (above
    LOW5) or one after it, any other byte itself.  Returns (e0, e1, bytes,
    successor); nodes from n_ch - 1 on park."""
    cidx = torch.arange(CH, device=ch.device, dtype=torch.int32)
    c1, c2 = _flat_shift_l(ch), _flat_shift_l(ch, 2)
    is64, is128 = ch == 64, ch == 128
    w = torch.where
    if q_gt_low5:
        nxt = w(is64 | is128, cidx + 3, cidx + 1)
        e0 = w(is64, c1, w(is128, c2, ch))
    else:
        nxt = w(is64, cidx + 3, w(is128, cidx + 2, cidx + 1))
        e0 = w(is64 | is128, c1, ch)
    nxt = w(cidx < (n_ch - 1)[:, None], nxt, CH)
    return e0, c2, _i32(w(is64, 2, 1)), nxt


def y_highres_device(h, ch_res, q_gt_low5: bool):
    """``host.ops.ll2.y_highres_compression`` on (B, 24641) int32 h (tree1
    and the tail the C reads past it) and (B, 16384) int32 ch_res, q_gt_low5
    = quality > LOW5.  Returns (out (B, 65536) int32, n_out, res_low,
    hr_word (B, 16384) int32, n_hw, hr_mem (B, 16384) int32, n_hm), the
    counts (B,) int32; the C's lists are the heads."""
    _check(h, "y_highres h", torch.int32, (None, YH_PAD))
    b = h.shape[0]
    _check(ch_res, "y_highres ch_res", torch.int32, (b, YH_N))
    idx = torch.arange(YH_PAD, device=h.device, dtype=torch.int32)
    eq = (_flat_shift_l(h) == h) & (idx + 1 < YH_PAD - 1)
    res_low = _yh_mode_select(h, eq, idx)
    e0, e1, e2, ln, nxt, isesc = _yh_nodes(h, eq, res_low, q_gt_low5)
    live = walk_visited_device(nxt, 1) & (idx < YH_N) & (idx >= 1)
    # the escapes' ch_res bytes and positions, in walk order
    esc = live & isesc
    pad = torch.zeros((b, YH_PAD - YH_N), dtype=torch.int32, device=h.device)
    hr_word, n_hw = _compact(esc, torch.cat([ch_res, pad], 1), 0, YH_N)
    hr_mem, n_hm = _compact(esc, idx, 0, YH_N)
    if not q_gt_low5:
        n_hw, n_hm = torch.zeros_like(n_hw), torch.zeros_like(n_hm)
    ch, n_ch = _scatter_bytes(live, ln, (e0, e1, e2), h[:, 0], CH)
    # the squeeze: its own walk over the bytes; the last byte is kept when
    # the walk lands on it
    s0, s1, slen, snxt = _squeeze_nodes(ch, n_ch, q_gt_low5)
    svis = walk_visited_device(snxt, 1)
    bound = (n_ch - 1)[:, None]
    cidx = torch.arange(CH, device=h.device, dtype=torch.int32)
    out, n_out = _scatter_bytes(svis & (cidx >= 1) & (cidx < bound), slen,
                                (s0, s1), ch[:, 0], CH)
    at = bound.clamp(min=0).long()
    tail = torch.gather(svis, 1, at)[:, 0] & (n_ch > 1)
    out = torch.where((cidx == n_out[:, None]) & tail[:, None],
                      torch.gather(ch, 1, at), out)
    return (out, n_out + tail.to(torch.int32), res_low, hr_word, n_hw,
            hr_mem, n_hm)
