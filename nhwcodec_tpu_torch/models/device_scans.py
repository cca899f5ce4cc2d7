"""Device formulations of the encoder's post-transform raster scans.

Port of ``nhwcodec_tpu.models.device_scans``, with the same public names
and results equal to the host copy's C scans
(``nhwcodec_tpu_torch.host.ops.quantize``, ``host.ops.residue``,
``host.models.encoder``, ``host.ops.ll2``).  This module holds the three
stages at the end of the scan pipeline: the LL2 stage (the E16 Y LL2
byte coding and run-delta compression, the E17 chroma LL2 coding and
compression), the residue stage (the E11 mid-q cleanup and pair
promotion, the E12 column ladder, classify and positional streams) and
the stream stage (the E11 snap passes, the E14 quantizers and the E15
stream fixups).

Eight programs carry a serial chain and are CUDA kernels, each beside a
torch twin (``*_ref``) of the same decomposition.  In ``csrc/scans.cu``:

- ``snap_pass_device`` (kernel ``snap_pass``): the neighbour count of the
  raster pass is static (the JAX module's analysis: alive values stay
  alive under every write the pass can make), so the only dynamic
  dependency is the left-neighbour fixup chain within a row.  One thread
  a row walks its region columns left to right with the left neighbour's
  post-snap value in a register, then does the self-overwrite and the
  spill write one column right of the region.
- ``offset_y_device`` (kernel ``offset_y``, q > LOW4), three launches:
  pass 1's decrement chain one thread a row (a give never crosses a
  row); passes 2-3 on the LL quadrant one CTA an image, a thread a
  column, rows in order (a vertical fire writes into the next row; the
  greedy pair rule within a row is the parity of the position in its run
  of candidates, the run starts a block-wide max-scan of ballots); pass
  4, the code map, one thread a position.
- ``merge_crossing_device`` (kernel ``merge_crossing``): the cursor walk
  is a 5-state skip machine whose per-position map depends only on the
  input bytes.  Each thread builds its 16-position tile's map from the 5
  entry states, a CTA composes its tiles, one warp a stream walks the
  CTAs' composites, and each tile walks again from its entry state.

In ``csrc/residue.cu``:

- ``pair_promotion_device`` (kernel ``pair_promotion``): the C's chain
  never leaves a row; one thread a row walks each region left to right.
- ``column_ladder_device`` (kernel ``column_ladder``): the columns are
  independent walks over the rows but for column 255, whose flat j + 1
  reads see the other columns' results; one CTA an image, a thread a
  column, column 255 again after a barrier.
- ``classify_device`` (kernel ``classify``): a walk over the rows a
  column, carrying the band value the previous row wrote.

In ``csrc/ll2.cu``:

- ``ll2_code_y_scan`` (kernel ``ll2_code_y``), the serial part of
  ``ll2_code_y_device``: the 4-run odd-marking pre-pass (a skip walk a
  row) and the 128-step nudge scan over the rows, one CTA an image and a
  thread a column; the within-row 2a fires are a run parity.
- ``walk_visited_device`` (kernel ``walk_visited``): the visited mask of
  a forward walk over static successors, one CTA a stream, the jumps
  staged in shared memory and walked by one thread.  The Y highres walk,
  its squeeze walk and the UV highres walk use it.

The rest are torch ops: the serpentines (one gather each), the select
codes (shifts, run parity and two sums), the run cap (``cummax`` run
starts and a closed-form crossing count), ``offset_uv_device``, the mid-q
cleanup (elementwise), the positional streams (cumsum ranks and
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

import functools

import numpy as np
import torch

from nhwcodec_tpu_torch.host.ops import geometry
from nhwcodec_tpu_torch.host.ops.quantize import EXTRA_WORDS1, EXTRA_WORDS2
from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.kernels.build import check_arg as _check
from nhwcodec_tpu_torch.kernels.build import cuda_args as _cuda_args

D = 256
N = 512
SZ = 65536

MERGE_TILE = 16                    # positions a thread of merge_crossing
MERGE_THREADS = 256                # threads a CTA (csrc/scans.cu kMThreads)
MERGE_SPAN = MERGE_TILE * MERGE_THREADS
MERGE_LEN = 4 * SZ                 # stream positions walked and written
MERGE_END = 4 * SZ - 4             # the cursor walk's end


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


def _snap_fixup(I, IL, e_left, left_alive, gc_ok: bool):
    """Value of a position after its alive left neighbour's fixup phase,
    given that neighbour's post-snap e (the elif chain; the e == 8 branch
    is unreachable: e >= 8 & (e & 7) < 2 matches first)."""
    dec = left_alive & (e_left >= 8) & ((e_left & 7) < 2)
    negdec = left_alive & (e_left < -7) & (((-e_left) & 7) < 2)
    v = torch.where(dec & (I > 7) & (I < 10000), I - 1, I)
    n_ok = negdec & (I < -14)
    inc7 = n_ok & (((-I) & 7) == 7)
    inc_lo = n_ok & (((-I) & 7) < 2) & ~inc7 & (IL <= 0)
    if not gc_ok:
        inc_lo = torch.zeros_like(inc_lo)
    return torch.where(inc7 | inc_lo, I + 1, v)


def _snap_args(r0, r1, col0, col1) -> None:
    if not (0 <= r0 < r1 <= N and 0 <= col0 < col1 <= N):
        raise ValueError(f"snap_pass: bad region rows [{r0}, {r1}) "
                         f"columns [{col0}, {col1})")


def snap_pass_ref(plane, r0: int, r1: int, col0: int, col1: int, thr: int,
                  yw: int, yw2: int, second_rule: bool, snap_guard6: bool,
                  gc: int):
    """Torch twin of ``snap_pass``: one walk per region row, left to
    right over the region's columns, the rows as a batch."""
    _snap_args(r0, r1, col0, col1)
    I = _i32(plane)
    zero = torch.zeros_like(I[:, :1, :])
    up = torch.cat([zero, I[:, :-1]], 1)          # row r - 1
    down = torch.cat([I[:, 1:], zero], 1)         # row r + 1
    rows = slice(r0, r1)
    Ir, up_r, dn_r = I[:, rows], up[:, rows], down[:, rows]
    row = torch.arange(r0, r1, device=I.device)[None, :]
    up_in = (row - 1 >= r0).expand(Ir.shape[:2])  # upper row in the region
    out = I.clone()
    orow = out[:, rows]
    e_prev = torch.zeros_like(Ir[..., 0])
    la = torch.zeros_like(Ir[..., 0], dtype=torch.bool)
    for c in range(col0, col1):
        cur = Ir[..., c]
        right = Ir[..., c + 1] if c + 1 < N else torch.zeros_like(cur)
        left = Ir[..., c - 1] if c > 0 else torch.zeros_like(cur)
        alive = cur.abs() >= thr
        l_tr = la if c > col0 else left.abs() >= 6
        u_tr = torch.where(up_in, up_r[..., c].abs() >= thr,
                           up_r[..., c].abs() >= 6)
        cnt = (l_tr.to(torch.int32) + (right.abs() >= 6).to(torch.int32)
               + u_tr.to(torch.int32)
               + (dn_r[..., c].abs() >= 6).to(torch.int32))
        v = _snap_fixup(cur, right, e_prev, la, c - 1 < gc)
        e = _snap_decide(v, cnt, yw, yw2, second_rule, snap_guard6)
        final = torch.where((e == -7) & (right == 8), -8, e)
        orow[..., c] = torch.where(alive, final, 0)
        e_prev = torch.where(alive, e, cur)
        la = alive
    if col1 < N:
        cur = Ir[..., col1]
        right = (Ir[..., col1 + 1] if col1 + 1 < N
                 else torch.zeros_like(cur))
        orow[..., col1] = _snap_fixup(cur, right, e_prev, la, col1 - 1 < gc)
    out[:, rows] = orow
    return out.to(torch.int16)


def snap_pass_device(plane, r0: int, r1: int, col0: int, col1: int,
                     thr: int, yw: int, yw2: int, second_rule: bool,
                     snap_guard6: bool, gc: int):
    """One ``_band_snap_pass`` on a (B, 512, 512) int16 plane, bit-exact
    vs the host copy's ``models.encoder._band_snap_pass``: rows [r0, r1),
    columns [col0, col1), threshold ``thr``, the snap window (yw, yw2),
    the second rule, the +-6 guard and the guard column ``gc`` of the
    fixup chain.  Returns a new plane (kernel ``snap_pass``)."""
    _check_plane(plane, "snap_pass plane", N)
    _snap_args(r0, r1, col0, col1)
    if plane.device.type == "cpu":
        return snap_pass_ref(plane, r0, r1, col0, col1, thr, yw, yw2,
                             second_rule, snap_guard6, gc)
    lib, stream = _cuda_args(plane)
    out = torch.empty_like(plane)
    if plane.shape[0]:
        with torch.cuda.device(plane.device):
            build.check("nhw_snap_pass", lib.nhw_snap_pass(
                plane.data_ptr(), out.data_ptr(), plane.shape[0], r0, r1,
                col0, col1, thr, yw, yw2, int(second_rule),
                int(snap_guard6), gc, stream))
        build.count("snap_pass")
    return out


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


def _offset_y_ll_ref(p):
    """Passes 2-3 (image_processing.c:241-309) on the LL quadrant, rows in
    order: the first pair promotion's fires, a vertical fire writing
    10100 into the next row (row 255's into plane row 256), then the
    second promotion on the finished row.  ``p``: (B, 512, 512) int32,
    updated in place."""
    colv = torch.arange(D, device=p.device)
    ok = (colv >= 1) & (colv < D - 1)
    ok3 = colv < D - 1
    pend = torch.zeros_like(p[:, 0, :D], dtype=torch.bool)
    for r in range(D):
        I_r, I_r1 = p[:, r, :D], p[:, r + 1, :D]
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
        # pass 3 on the finished row: own writes only
        outr = _flat_shift_l(out)
        f3p = ok3 & (out >= 5) & (out <= 7) & (outr >= 5) & (outr <= 7)
        f3n = ok3 & (out >= -7) & (out <= -5) & (outr >= -7) & (outr <= -5)
        fired3 = _run_parity_fire(f3p | f3n)
        p[:, r, :D] = torch.where(fired3, torch.where(f3p, 10300, 10204),
                                  out)
    p[:, D, :D] = torch.where(pend, 10100, p[:, D, :D])
    return p


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
    """Torch twin of ``offset_y``: pass 1 row by row, passes 2-3 row by
    row of the LL quadrant, pass 4 elementwise."""
    b = plane.shape[0]
    If = _offset_y_rows_ref(_i32(plane).reshape(b, -1))
    p = _offset_y_ll_ref(If.reshape(b, N, N))
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


def _walk_maps(km1: torch.Tensor, state: torch.Tensor) -> torch.Tensor:
    """Walk the skip machine over the last axis of ``km1`` (k - 1 per
    position) from each of ``state``'s entries (a trailing axis);
    returns the states after the walk."""
    for t in range(km1.shape[-1]):
        k = km1[..., t, None]
        state = torch.where(state > 0, state - 1, k)
    return state


def _compose_walk(maps: torch.Tensor, entry: torch.Tensor):
    """Entry states of consecutive maps along axis -2 of ``maps`` (...,
    M, 5), walked from ``entry`` (...): (entries (..., M), exit)."""
    entries = []
    s = entry
    for m in range(maps.shape[-2]):
        entries.append(s)
        s = torch.gather(maps[..., m, :], -1, s[..., None])[..., 0]
    return torch.stack(entries, -1), s


def _compose_maps(maps: torch.Tensor) -> torch.Tensor:
    """The composite of consecutive maps along axis -2 (..., M, 5)."""
    ident = torch.arange(5, device=maps.device).expand(
        maps.shape[:-2] + (5,))
    s = ident
    for m in range(maps.shape[-2]):
        s = torch.gather(maps[..., m, :], -1, s)
    return s


def merge_crossing_ref(s: torch.Tensor) -> torch.Tensor:
    """Torch twin of ``merge_crossing``: tile maps of 16 positions from
    the 5 entry states, composed 32 tiles a warp and 8 warps a CTA, the
    CTAs walked in order from state 0, the entries handed down to warps
    and tiles, and each tile walked again (16 + 4 positions) to write
    positions [start + 4, start + 20) (tile 0 also [0, 4))."""
    b, n = s.shape
    v = _i32(s)
    if n < MERGE_LEN + 32:
        v = torch.cat([v, v.new_zeros((b, MERGE_LEN + 32 - n))], 1)
    k, fire_p, code = _merge_steps(v)
    km1 = (k - 1)[:, :MERGE_LEN + MERGE_TILE]
    tiles = MERGE_LEN // MERGE_TILE
    ctas = MERGE_LEN // MERGE_SPAN
    tk = km1[:, :MERGE_LEN].reshape(b, tiles, MERGE_TILE)
    ident = torch.arange(5, device=s.device).expand(b, tiles, 5)
    maps = _walk_maps(tk, ident)                           # (B, tiles, 5)
    wmaps = maps.reshape(b, ctas, 8, 32, 5)
    warp_fn = _compose_maps(wmaps)                         # (B, ctas, 8, 5)
    cta_fn = _compose_maps(warp_fn)                        # (B, ctas, 5)
    cta_entry, _ = _compose_walk(cta_fn, torch.zeros(
        b, dtype=torch.long, device=s.device))             # (B, ctas)
    warp_entry, _ = _compose_walk(warp_fn, cta_entry)      # (B, ctas, 8)
    tile_entry, _ = _compose_walk(wmaps, warp_entry)       # (B, ctas, 8, 32)
    state = tile_entry.reshape(b, tiles)
    # each tile walks its 16 positions and the next tile's first 4
    span = MERGE_TILE + 4
    pos = (torch.arange(tiles, device=s.device)[:, None] * MERGE_TILE
           + torch.arange(span, device=s.device))          # (tiles, 20)
    wk = km1[:, pos]
    wf = fire_p[:, pos]
    fires = []
    for t in range(span):
        fires.append(wf[..., t] & (state == 0))
        state = torch.where(state > 0, state - 1, wk[..., t])
    fire = torch.stack(fires, -1)                          # (B, tiles, 20)
    own = pos[:, 4:]                                       # written
    val = torch.where(fire[..., :-4], 201, torch.where(
        fire[..., 4:], code[:, own], v[:, own]))
    out = s.clone()
    flat = own.reshape(-1)
    keep = flat < MERGE_LEN
    out[:, flat[keep]] = val.reshape(b, -1)[:, keep].to(torch.uint8)
    head = torch.where(fire[:, 0, :4], code[:, :4], v[:, :4])
    out[:, :4] = head.to(torch.uint8)
    return out


def merge_crossing_device(s):
    """``host.ops.quantize.merge_crossing_codes`` on a (B, >= 4 SZ)
    uint8 stream: 136/120 codes across 3-gap 128 runs merge into
    132-135 + 201.  The cursor walk's decisions depend only on the input
    bytes, so the result is a new stream (kernel ``merge_crossing``:
    three launches)."""
    _check(s, "merge_crossing stream", torch.uint8, (None, None))
    if not s.is_contiguous() or s.shape[1] < MERGE_LEN:
        raise ValueError("merge_crossing: stream must be contiguous and "
                         f"at least {MERGE_LEN} bytes")
    if s.device.type == "cpu":
        return merge_crossing_ref(s)
    lib, stream = _cuda_args(s)
    b, n = s.shape
    out = torch.empty_like(s)
    ctas = MERGE_LEN // MERGE_SPAN
    comp = torch.empty((b, ctas, 5), dtype=torch.int32, device=s.device)
    entry = torch.empty((b, ctas), dtype=torch.int32, device=s.device)
    if b:
        with torch.cuda.device(s.device):
            build.check("nhw_merge_crossing", lib.nhw_merge_crossing(
                s.data_ptr(), out.data_ptr(), comp.data_ptr(),
                entry.data_ptr(), b, n, stream))
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


# The two regions of pair promotion: (rows [r0, r1), columns [c0, c1),
# the band rules).  They share no row, and the C's chain never leaves a row:
# its promotions of 7/-7 pairs and the lower block's vertical cases are
# dead (4 < v < 8 and -8 < v < -4 take v = 7, -6 and -7 first), so the
# only reads of another row never happen.
PP_REGIONS = ((1, D - 1, D + 1, 2 * D - 1, True),
              (D + 1, 2 * D - 1, 1, D - 1, False))


def _pp_visit(left, cur, right, band: bool):
    """One visit of pair promotion's walk: (left, cur, right) as the walk
    left them -> the three after the visit's writes.  The 12700/12900
    triples write 10100 on both sides; +-8 becomes 10 / -9 beside a +-6/7
    neighbour; in the band block a 8/8 or -8/-8 pair becomes 9/9 or
    -9/-9."""
    tri1 = ((cur > 4) & (cur < 8) & (left > 3) & (left <= 7) & (right > 3)
            & (right <= 7))
    tri2 = ((cur > -8) & (cur < -4) & (left > -8) & (left <= -4)
            & (right > -8) & (right <= -4))
    e8, m8 = cur == 8, cur == -8
    c6 = ((left & 65534) == 6) | ((right & 65534) == 6)
    c7 = (((-left) & 65534) == 6) | (((-right) & 65534) == 6)
    p9 = e8 & ~c6 & (right == 8) if band else torch.zeros_like(e8)
    pm9 = m8 & ~c7 & (right == -8) if band else torch.zeros_like(m8)
    tri = tri1 | tri2
    cur2 = torch.where(tri1, 12700, torch.where(tri2, 12900, cur))
    cur2 = torch.where(e8 & c6, 10, torch.where(m8 & c7, -9, cur2))
    cur2 = torch.where(p9, 9, torch.where(pm9, -9, cur2))
    right2 = torch.where(tri, 10100, torch.where(
        p9, 9, torch.where(pm9, -9, right)))
    return torch.where(tri, 10100, left), cur2, right2


def pair_promotion_ref(plane):
    """Torch twin of ``pair_promotion``: one left-to-right walk a row of
    each region, the rows as a batch, the left neighbour's and the
    visited value in registers, the right neighbour read from the input
    (a visit writes a - 1, a and a + 1, so a value is final once the walk
    is one column past it)."""
    I = _i32(plane)
    out = I.clone()
    for r0, r1, c0, c1, band in PP_REGIONS:
        rows, o = I[:, r0:r1], out[:, r0:r1]
        left, cur = rows[..., c0 - 1], rows[..., c0]
        for c in range(c0, c1):
            left, cur, right = _pp_visit(left, cur, rows[..., c + 1], band)
            o[..., c - 1] = left
            left, cur = cur, right
        o[..., c1 - 1] = left
        o[..., c1] = cur
    return out.to(torch.int16)


def pair_promotion_device(plane):
    """``_pair_promotion`` on a (B, 512, 512) int16 plane (q > LOW4),
    bit-exact vs the host copy's C scan.  Returns a new plane (kernel
    ``pair_promotion``: one launch, one thread a row)."""
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
    from nhwcodec_tpu_torch.host import tables as T

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


def column_ladder_ref(plane, rf_ext, quality: int, res_setting: int):
    """Torch twin of ``column_ladder``: all 256 columns as lanes over rows
    0..254 (column 255 with its j + 1 reads from the input), then column
    255 alone again, in place, its j + 1 reads taken from the results at
    the time of the step: column r's step-0 band value at (r, 256), its
    own at (255, 256) from step 0 on, rf column 0 and the tail."""
    _ladder_args(plane, rf_ext)
    flags = _ladder_flags(quality, res_setting)
    b = plane.shape[0]
    I, rfe = _i32(plane), _i32(rf_ext)
    out = I.clone()
    rf = rfe[:, :SZ].reshape(b, D, D).clone()

    def rf_at(off, k):    # rf[(r + off) * 256 + j + k] at [r, j]
        return rfe[:, off * D + k: off * D + k + (D - 1) * D].reshape(
            b, D - 1, D)

    xs_all = (I[:, 2:D + 1, :D], rf_at(1, 0), rf_at(2, 0),
              I[:, :D, D:2 * D - 1].transpose(1, 2),
              I[:, 0:D - 1, 1:D + 1], I[:, 1:D, 1:D + 1],
              I[:, 2:D + 1, 1:D + 1], rf_at(0, 1), rf_at(1, 1), rf_at(2, 1))
    z = torch.zeros_like(I[:, 0, :D])
    carry = (I[:, 0, :D], I[:, 1, :D], z, z, rfe[:, :D], I[:, :D, D - 1])
    for r in range(D - 1):
        xs = tuple(x[:, r] for x in xs_all) + (r > 0,)
        carry, (v0, mark, bnd) = _cl_step(flags, carry, xs)
        out[:, r, :D], rf[:, r], out[:, :D, D + r] = v0, mark, bnd
    out[:, D - 1, :D], out[:, D, :D], rf[:, D - 1] = (carry[0], carry[1],
                                                      carry[4])
    # column 255 again
    j = D - 1
    rf_col0 = torch.cat([rf[:, :, 0], rfe[:, SZ, None],
                         rfe[:, SZ + D, None]], 1)            # rows 0..257
    carry = (I[:, 0, j, None], I[:, 1, j, None], z[:, :1], z[:, :1],
             rfe[:, j, None], I[:, j, j, None])
    for r in range(D - 1):
        xs = (I[:, r + 2, j, None], rfe[:, (r + 1) * D + j, None],
              rfe[:, (r + 2) * D + j, None], I[:, j, D + r, None],
              out[:, r, D, None], out[:, r + 1, D, None],
              out[:, r + 2, D, None], rf_col0[:, r + 1, None],
              rf_col0[:, r + 2, None], rf_col0[:, r + 3, None], r > 0)
        carry, (v0, mark, bnd) = _cl_step(flags, carry, xs)
        out[:, r, j], rf[:, r, j], out[:, j, D + r] = (v0[:, 0], mark[:, 0],
                                                       bnd[:, 0])
    out[:, D - 1, j], out[:, D, j], rf[:, D - 1, j] = (carry[0][:, 0],
                                                       carry[1][:, 0],
                                                       carry[4][:, 0])
    return out.to(torch.int16), rf.reshape(b, SZ).to(torch.int16)


def column_ladder_device(plane, rf_ext, quality: int, res_setting: int):
    """``host.ops.residue.res256_column_ladder`` on a (B, 512, 512) int16
    plane and rf_ext, (B, SZ + 1024) int16: res256 and the tail the C
    reads past it (the kernel head, [17, 2, 0, 0], resIII[:1016]).
    Returns (plane', rf' (B, SZ) int16), bit-exact vs the host copy's C
    scan (kernel ``column_ladder``: one launch, a CTA an image, a thread a
    column, column 255 again after a block barrier)."""
    _ladder_args(plane, rf_ext)
    ge_low1, low2, ge_high1, _ = _ladder_flags(quality, res_setting)
    if plane.device.type == "cpu":
        return column_ladder_ref(plane, rf_ext, quality, res_setting)
    lib, stream = _cuda_args(plane, rf_ext)
    b = plane.shape[0]
    out = torch.empty_like(plane)
    rf = torch.empty((b, SZ), dtype=torch.int16, device=plane.device)
    if b:
        with torch.cuda.device(plane.device):
            build.check("nhw_column_ladder", lib.nhw_column_ladder(
                plane.data_ptr(), rf_ext.data_ptr(), out.data_ptr(),
                rf.data_ptr(), b, int(ge_low1), int(low2), int(ge_high1),
                res_setting, stream))
        build.count("column_ladder")
    return out, rf


# ---------------------------------------------------------------------------
# E12 classify: residue codes 121..149 (host.ops.residue.res256_classify,
# encoder/nhw_encoder.c:1329-1420).  The pf[scan] and rf[cnt] reads are
# input values; the only chain is band row j's st - 1 read of the value
# the previous row's visit of column j wrote: a walk over rows a column.

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


def classify_ref(plane, res256, quality: int, res_setting: int):
    """Torch twin of ``classify``: one walk over the 256 rows, the columns
    as lanes, the band value written at the previous row carried."""
    from nhwcodec_tpu_torch.host import tables as T

    _classify_args(plane, res256)
    ge_high1 = quality >= T.HIGH1
    I, rf = _i32(plane), _i32(res256)
    out, rf_out = I.clone(), rf.clone()
    bnd = I[:, :D, D - 1]
    counts = torch.zeros((I.shape[0], 3), dtype=torch.int32,
                         device=plane.device)
    for r in range(D):
        bnd, rf_out[:, r], *ns = _classify_step(
            ge_high1, res_setting, bnd, I[:, r, :D], rf[:, r], I[:, :D, D + r])
        out[:, :D, D + r] = bnd
        counts += torch.stack([n.sum(-1, dtype=torch.int32) for n in ns], -1)
    return (out.to(torch.int16), rf_out.to(torch.int16), counts[:, 0],
            counts[:, 1], counts[:, 2])


def classify_device(plane, res256, quality: int, res_setting: int):
    """``host.ops.residue.res256_classify`` on a (B, 512, 512) int16 plane
    and the ladder's (B, 256, 256) int16 res256.  Returns (plane',
    res256', n1, n3, n5), the counts (B,) int32 (kernel ``classify``: one
    launch, a CTA an image, a thread a column, the counts summed in the
    CTA)."""
    from nhwcodec_tpu_torch.host import tables as T

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


def uv_sentinel_marking_ref(process, rf_ext, res_uv: int):
    """Torch twin of ``uv_sentinel``: the 128 rows in order with a row's
    lanes as columns and each image's window start carried: the lanes
    decide on their reads, the visited lanes are the run parity of the
    placed pairs, lane 127 decides again against the value lane 0 left in
    column 128, and its placed pair moves the next row's window by
    one."""
    _uvsm_args(process, rf_ext)
    b = process.shape[0]
    dev = process.device
    p = _i32(process)
    rf = _i32(rf_ext)
    out = process.clone()
    lanes = torch.arange(UVQ + 1, device=dev)
    count = torch.zeros((b, 1), dtype=torch.long, device=dev)
    for r in range(UVQ):
        sl = rf.gather(1, count + lanes)
        bands = [p[:, r, UVQ:], p[:, UVQ + r, :UVQ],
                 p[:, UVQ + r, UVQ:]]
        d0 = p[:, r, :UVQ] - sl[:, :UVQ]
        pos, placed, code, slot = _uvsm_decide(
            d0, p[:, r, 1:UVQ + 1] - sl[:, 1:], *bands, res_uv)
        visited = ~_flat_shift_r(_run_parity_fire(placed), 1, False)
        w = _uvsm_apply(visited, pos, placed, code, slot, bands)
        # lane 127 against lane 0's band 0 value in column 128
        last = [x[:, -1:] for x in bands]
        pos, placed, code, slot = _uvsm_decide(
            d0[:, -1:], w[0][:, :1] - sl[:, -1:], *last, res_uv)
        w127 = _uvsm_apply(visited[:, -1:], pos, placed, code, slot, last)
        for x, x127 in zip(w, w127):
            x[:, -1:] = x127
        out[:, r, UVQ:] = w[0].to(torch.int16)
        out[:, UVQ + r, :UVQ] = w[1].to(torch.int16)
        out[:, UVQ + r, UVQ:] = w[2].to(torch.int16)
        count = count + UVQ + (visited[:, -1:] & placed)
    return out


def uv_sentinel_marking_device(process, rf_ext, res_uv: int):
    """The band sentinels 12400/12600/12900/13000 on (B, 256, 256) int16
    process planes against rf_ext (B, >= 16641) int16: res256 (16384),
    then the tail the reference reads past it (its oob values, then
    zeros).  Returns a new plane (kernel ``uv_sentinel``: one launch, one
    CTA an image, a thread a lane)."""
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


def walk_visited_ref(nxt, start: int = 1):
    """Torch twin of ``walk_visited``: each row walked as a Python list,
    start -> nxt[start] -> ..., ending at the first successor outside
    (i, n)."""
    _walk_args(nxt, start)
    b, n = nxt.shape
    rows, cols = [], []
    for k, row in enumerate(nxt.cpu().tolist()):
        i = start
        while True:
            rows.append(k)
            cols.append(i)
            t = row[i]
            if not i < t < n:
                break
            i = t
    vis = np.zeros((b, n), bool)
    vis[rows, cols] = True
    return torch.from_numpy(vis).to(nxt.device)


def walk_visited_device(nxt, start: int = 1):
    """The visited mask (B, n) bool of the walk start -> nxt[start] -> ...
    over (B, n) int32 successors, n <= 65536.  Successors increase
    (nxt[i] > i); one >= n parks the walk, and the walk also ends at one
    that does not increase.  The JAX package resolves it by pointer
    doubling (``_walk_visited``); here it is kernel ``walk_visited`` (one
    launch, one CTA a row)."""
    _walk_args(nxt, start)
    if nxt.device.type == "cpu":
        return walk_visited_ref(nxt, start)
    lib, stream = _cuda_args(nxt)
    b, n = nxt.shape
    vis = torch.empty((b, n), dtype=torch.bool, device=nxt.device)
    if b:
        with torch.cuda.device(nxt.device):
            build.check("nhw_walk_visited", lib.nhw_walk_visited(
                nxt.data_ptr(), vis.data_ptr(), b, n, start, stream))
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


def _ll2y_marks(ll):
    """The 4-run odd marking on the (B, 128, 128) int32 LL2 block, one
    skip walk a row over j < 125, the rows as lanes: a window of four odd
    values with |v[j] - v[j + 3]| > 1 fires, adds 24000 at j and 16000 at
    j + 1..j + 3, and the walk resumes at j + 4."""
    o = (ll & 1) == 1
    match = torch.zeros_like(o)
    match[..., :125] = (o[..., :125] & o[..., 1:126] & o[..., 2:127]
                        & o[..., 3:] & ((ll[..., :125] - ll[..., 3:]).abs()
                                        > 1))
    fired = torch.zeros_like(o)
    skip = torch.zeros_like(ll[..., 0])
    for j in range(125):
        f = match[..., j] & (skip == 0)
        fired[..., j] = f
        skip = torch.where(f, 3, (skip - 1).clamp(min=0))
    f = fired.to(torch.int32)
    add = 24000 * f
    for k in (1, 2, 3):
        add[..., k:] += 16000 * f[..., :-k]
    return ll + add


def ll2_code_y_ref(plane, gt_low3: bool):
    """Torch twin of ``ll2_code_y``: the marks (``_ll2y_marks``), then the
    nudge scan over the 128 rows with a row's 131 columns as lanes,
    ``pend`` (the nudges into the next row) carried.  Returns (vem (B,
    16384) int32, each LL2 position's value after its nudges and unmark,
    is24 (B, 16384) bool, its 24000 marks)."""
    _check_plane(plane, "ll2_code_y plane", N)
    b = plane.shape[0]
    # rows 0..130: the cross-row reads of rows r + 1..r + 3 stay inside
    w = _i32(plane)[:, :LL_ROW, :LL_ROW].clone()
    if gt_low3:
        w[:, :LL, :LL] = _ll2y_marks(w[:, :LL, :LL])
    jc = torch.arange(LL_ROW, device=plane.device)
    none = torch.zeros_like(w[:, 0], dtype=torch.bool)
    pend = torch.zeros_like(w[:, 0])
    vem = torch.empty((b, LL, LL), dtype=torch.int32, device=plane.device)
    is24 = torch.empty((b, LL, LL), dtype=torch.bool, device=plane.device)

    def odd(x):
        return (x & 1) == 1

    for r in range(LL):
        cur = w[:, r] + pend
        marked = cur > 10000 if gt_low3 else none
        c2 = _flat_shift_l(cur, 2)
        o1, o2 = odd(_flat_shift_l(cur)), odd(c2)
        # the within-row 2a fire: +1 on the next column
        f2a = (~marked & odd(cur) & (jc > 0) & o1 & (jc < 126) & o2
               & ((cur - c2).abs() > 1))
        fire = _run_parity_fire(f2a) if gt_low3 else none
        v = cur + _flat_shift_r(fire, 1, False).to(torch.int32)
        # the cross-row nudges: +1 on row r + 1, column j
        n0, n1, n2 = (_flat_shift_l(w[:, r + 1], k) if k else w[:, r + 1]
                      for k in (0, 1, 2))
        live = ~marked & odd(v) & odd(n0) & odd(n1) & (n0 < 10000)
        left = (jc > 0) & o1
        b2b = (live & left & ~((jc < 126) & o2) & ~odd(n2)
               if gt_low3 and r <= 126 else none)
        b3 = (live & ~left & odd(w[:, r + 2]) & ~odd(w[:, r + 3])
              if gt_low3 and 1 <= r <= 124 else none)
        pend = ((b2b | b3) & (jc < LL)).to(torch.int32)
        hi = v > 20000 if gt_low3 else none
        mid = v > 10000 if gt_low3 else none
        out = torch.where(hi, v - 24000, torch.where(mid, v - 16000, v))
        vem[:, r] = out[:, :LL]
        is24[:, r] = hi[:, :LL]
    return vem.reshape(b, LL_N), is24.reshape(b, LL_N)


def ll2_code_y_scan(plane, gt_low3: bool):
    """The serial part of ``ll2_code_y_device`` on a (B, 512, 512) int16
    plane: (vem, is24) as ``ll2_code_y_ref`` gives them (kernel
    ``ll2_code_y``: one launch, one CTA an image, a thread a column)."""
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
