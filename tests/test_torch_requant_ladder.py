"""K5's ladder as a table walk (``requant_ladder``, csrc/requant.cu),
checked on the CPU.

The kernel replaces the compare ladder's branches by a walk over an
11-state table a column: the nudge decide(scan, aa) depends on aa only
through clamp(aa, -5, 5) and on scan only through clamp(scan, -12, 12),
so the state s = clamp(aa, -5, 5) steps as
s' = clamp(A[c+1] + scan[c] + decide(scan[c], s), -5, 5), a map that
depends on clamp(scan) and clamp(A[c+1] + scan[c], -12, 12) only.

Here, tolerance 0:
- the clamp claim holds exhaustively over scan in [-40, 40] and aa in
  [-2^17, 2^17] against the JAX package's decide, and the source's
  25 x 11 table is decide at the clamped points;
- a numpy emulation of the kernel (its unmark index map, pre-pass with
  the lane shuffles, packed next-state tables, walk and nudge lookup; its
  constants read from the source) equals ``dwt.ladder_ref``;
- the emulated tail equals ``requant_tail_pallas`` in interpret mode and
  the host sequence on real q20/23/16/9 states, adversarial chains,
  row-crossing reads, row 0 and column 255;
- the walkers' shared-memory accesses take the fewest wavefronts.
"""

import re
from pathlib import Path

import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from nhwcodec_tpu.models import device_requant as jdr
from nhwcodec_tpu.ops import pallas_dwt
from nhwcodec_tpu.utils import fixtures
from nhwcodec_tpu_torch.ops import dwt
from test_torch_requant import _host_block_inputs, _host_tail

SOURCE = Path(dwt.__file__).resolve().parent.parent / "csrc" / "requant.cu"
TEXT = SOURCE.read_text()


def _const(name):
    return int(re.search(rf"constexpr int {name} = ([^;]+);", TEXT).group(1)
               .split("//")[0].strip())


def _constants():
    """The kernel's constants, as the source defines them."""
    c = {name: _const(name) for name in ("kRows", "kAaClamp", "kScanClamp",
                                         "kBits")}
    c["kThreads"] = 32 * c["kRows"]
    assert re.search(r"constexpr int kThreads = 32 \* kRows;", TEXT)
    assert re.search(r"constexpr int kStates = 2 \* kAaClamp \+ 1;", TEXT)
    assert re.search(r"constexpr int kScans = 2 \* kScanClamp \+ 1;", TEXT)
    assert re.search(r"constexpr int kIdxPitch = kD \+ 8;", TEXT)
    assert re.search(r"constexpr int kStPitch = kD \+ 8;", TEXT)
    assert re.search(r"requant_ladder<<<dim3\(kD / kRows, batch\), kThreads",
                     TEXT)
    c["kStates"] = 2 * c["kAaClamp"] + 1
    c["kScans"] = 2 * c["kScanClamp"] + 1
    body = re.search(r"kDecide\[kScans\]\[kStates\] = \{(.*?)\n\};", TEXT,
                     re.S).group(1)
    rows = [[int(v) for v in row.split(",")]
            for row in re.findall(r"\{([-\d, ]+)\}", body)]
    c["kDecide"] = np.array(rows, np.int64)
    return c


C = _constants()


def _decide(scan, aa):
    return jdr._ladder_decide(np.asarray(scan), np.asarray(aa), xp=np)


def test_constants_and_launch_shape():
    assert C["kRows"] == 32          # one walker lane a row of a block
    assert C["kThreads"] <= 1024     # a warp a row in the parallel passes
    assert 256 % C["kRows"] == 0
    assert C["kStates"] == 11 and C["kScans"] == 25
    assert C["kStates"] * C["kBits"] <= 64
    assert C["kStates"] <= 1 << C["kBits"]
    assert C["kDecide"].shape == (C["kScans"], C["kStates"])
    # 128 blocks at batch 16: every SM holds at most one block's 32 walks,
    # and no grid puts fewer than 32 rows on its busiest SM of 132
    assert 16 * 256 // C["kRows"] == 128 and -(-16 * 256 // 132) == 32


def test_clamp_claim_is_exhaustive():
    a, s = C["kAaClamp"], C["kScanClamp"]
    aa = np.arange(-(1 << 17), (1 << 17) + 1, dtype=np.int64)
    for scan in range(-40, 41):
        sv = np.full_like(aa, scan)
        want = _decide(sv, aa)
        np.testing.assert_array_equal(_decide(sv, np.clip(aa, -a, a)), want)
        np.testing.assert_array_equal(
            _decide(np.clip(sv, -s, s), np.clip(aa, -a, a)), want)
        np.testing.assert_array_equal(
            C["kDecide"][min(max(scan, -s), s) + s, np.clip(aa, -a, a) + a],
            want)
    # and the port's twin agrees with the JAX package's decide
    sc, av = np.meshgrid(np.arange(-40, 41), np.arange(-300, 301))
    np.testing.assert_array_equal(
        dwt._ladder_decide(torch.from_numpy(sc), torch.from_numpy(av)).numpy(),
        _decide(sc, av))


def test_next_state_depends_on_the_clamped_base():
    # |decide| <= 7, so clamp(base + d, -5, 5) sees base only through
    # clamp(base, -12, 12)
    a, s = C["kAaClamp"], C["kScanClamp"]
    assert np.abs(C["kDecide"]).max() + a <= s
    d = C["kDecide"][:, None, :]
    base = np.arange(-200, 201)[None, :, None]
    np.testing.assert_array_equal(np.clip(base + d, -a, a),
                                  np.clip(np.clip(base, -s, s) + d, -a, a))


# ---------------------------------------------------------------------------
# a numpy emulation of requant_ladder


def _clean(v):
    return np.where(v > 14000, v - 16000, np.where(v > 10000, v - 12000, v))


def _adjust_a(a):
    return a + np.select(
        [a > 11, a > 7, a > 5, a > 4, a < -11, a < -7, a < -5, a < -4],
        [-7, -4, -2, -1, 7, 4, 2, 1], 0)


def _lut():
    """The kernel's kLut: entry s of word 25 sc + bc is clamp(bc - 12 +
    kDecide[sc][s], -5, 5) + 5, kBits bits each."""
    a, s, n = C["kAaClamp"], C["kScanClamp"], C["kScans"]
    i = np.arange(n * n)
    base = (i % n - s)[:, None]
    nxt = (np.clip(base + C["kDecide"][i // n], -a, a) + a).astype(np.uint64)
    shifts = (C["kBits"] * np.arange(C["kStates"])).astype(np.uint64)
    return np.bitwise_or.reduce(nxt << shifts, axis=1)


def emulate_ladder(syn, res256, process):
    """The kernel on (B, 256, 256) synthesized LL planes: returns
    (res_clean, m) as the pre-pass, walk and nudge lookup compute them."""
    b = syn.shape[0]
    syn, res = syn.astype(np.int64), res256.astype(np.int64)
    P = process.astype(np.int64)
    R, Cc = np.meshgrid(np.arange(256), np.arange(256), indexing="ij")
    # the unmark gather at (R, C)
    row = np.where(Cc & 1, 128 + (Cc >> 1), Cc >> 1)
    col = np.where(R & 1, 128 + (R >> 1), R >> 1)
    v = np.where((R | Cc) & 1, res[:, row, col], 0)
    delta = np.where(v > 14000, 1, np.where(v > 10000, -1, 0))
    rc = _clean(res)
    ll = ((syn + delta + 32768) & 65535) - 32768
    scan = ll - rc
    # lane l holds columns 8l..8l+7; __shfl_down_sync by 1 gives lane l
    # the next lane's first two, and lane 31 its own
    lanes = scan.reshape(b, 256, 32, 8)
    next0 = np.concatenate([lanes[:, :, 1:, 0], lanes[:, :, 31:, 0]], 2)
    next1 = np.concatenate([lanes[:, :, 1:, 1], lanes[:, :, 31:, 1]], 2)
    last = np.arange(32) == 31
    below = np.concatenate([_clean(res[:, 1:, 0]), np.zeros((b, 1),
                                                             np.int64)], 1)
    cross = np.where(last, (P[:, :256, 256] - below)[:, :, None], next0)
    a_next = np.concatenate([
        _adjust_a(lanes[..., 2:]), _adjust_a(cross)[..., None],
        np.where(last, 0, _adjust_a(next1))[..., None]], -1).reshape(b, 256,
                                                                     256)
    s, n = C["kScanClamp"], C["kScans"]
    idx = (np.clip(scan, -s, s) + s) * n + np.clip(a_next + scan, -s, s) + s
    left0 = np.concatenate([np.zeros((b, 1), np.int64),
                            P[:, :255, 511] - _clean(res[:, :255, 255])], 1)
    a = C["kAaClamp"]
    state = (np.clip(_adjust_a(scan[:, :, 1]) + left0, -a, a) + a).astype(
        np.uint64)
    lut = _lut()
    states = np.empty((b, 256, 256), np.int64)
    mask = np.uint64((1 << C["kBits"]) - 1)
    for c in range(256):
        states[:, :, c] = state
        state = (lut[idx[:, :, c]] >> (np.uint64(C["kBits"]) * state)) & mask
    assert states.max() < C["kStates"]
    return rc, C["kDecide"][idx // n, states]


def _emulated_tail(jpeg, process, res256):
    """The tail with the ladder emulated: (jpeg, process, res_clean)."""
    jpeg, process = jpeg.copy(), process.copy()
    syn = dwt.synth_level_ref(torch.from_numpy(jpeg[:, :256, :256])).numpy()
    rc, m = emulate_ladder(syn, res256, process)
    jll = (((rc + m) + 32768) & 65535) - 32768
    j2, p2 = dwt.analysis_level_jp_ref(torch.from_numpy(
        jll.astype(np.int16)))
    jpeg[:, :256, :256] = j2.numpy()
    process[:, :256, :256] = p2.numpy()
    return jpeg, process, rc.astype(np.int16)


def _check(jpeg, process, res256, pallas_images=1):
    # the emulated walk's nudges equal the twin's chain
    syn = dwt.synth_level_ref(torch.from_numpy(jpeg[:, :256, :256]))
    ll, rc = dwt.unmark_ref(syn, torch.from_numpy(res256))
    want_m = dwt.ladder_ref(ll, rc, torch.from_numpy(process)).numpy()
    got_rc, got_m = emulate_ladder(syn.numpy(), res256, process)
    np.testing.assert_array_equal(got_rc, rc.numpy())
    np.testing.assert_array_equal(got_m, want_m)
    # the emulated tail equals the host sequence and the Pallas kernel
    got = _emulated_tail(jpeg, process, res256)
    for i in range(jpeg.shape[0]):
        for g, h in zip(got, _host_tail(jpeg[i], process[i], res256[i])):
            np.testing.assert_array_equal(g[i], h)
    k = pallas_images
    pal = pallas_dwt.requant_tail_pallas(
        *(jnp.asarray(a[:k]) for a in (jpeg, process, res256)),
        interpret=True)
    for g, w in zip(got, pal):
        np.testing.assert_array_equal(g[:k], np.asarray(w))
    return got_m


@pytest.mark.parametrize("q", [20, 23, 16, 9])
def test_emulated_walk_on_real_states(q):
    states = [_host_block_inputs(fixtures.GENERATORS[n](), q)
              for n in ("gradient", "texture")]
    m = _check(*(np.stack([s[k] for s in states]) for k in range(3)))
    assert m.any()


def test_emulated_walk_on_adversarial_chains():
    m = _check(*chip_smoke.chain_planes(np.random.default_rng(7), 3))
    # long chains: many nudges, in every state class
    assert (m != 0).sum() > 10000


def test_emulated_walk_on_row_crossing_reads():
    # sentinels in columns 0 and 255, live band cells: row 0's column 0
    # reads nothing, column 255 crosses to process[r, 256] - rc[r+1, 0]
    # and row 255's to process[255, 256] alone
    jpeg, process, res256 = chip_smoke.row_crossing_planes(
        np.random.default_rng(11), 2)
    assert ((res256[:, :, 0] > 10000).any()
            and (res256[:, :, 255] > 10000).any())
    m = _check(jpeg, process, res256, pallas_images=2)
    flipped = process.copy()
    flipped[:, :256, 511] = -flipped[:, :256, 511]
    flipped[:, :256, 256] = -flipped[:, :256, 256]
    m2 = _check(jpeg, flipped, res256)
    assert not np.array_equal(m[:, :, 0], m2[:, :, 0])
    assert not np.array_equal(m[:, :, 255], m2[:, :, 255])


def _wavefronts(addr, width):
    """Shared-memory wavefronts of one warp access, ``width`` bytes a
    thread at byte addresses ``addr``: 16-byte accesses go in 4 phases of
    8 threads, 8-byte ones in 2 of 16; within a phase, the most distinct
    4-byte words on one bank."""
    per = 32 // (width // 4) if width > 4 else 32
    total = 0
    for p in range(0, 32, per):
        words = {(int(a) // 4 + w) for a in addr[p:p + per]
                 for w in range(max(1, width // 4))}
        banks = [w % 32 for w in words]
        total += max(banks.count(bk) for bk in set(banks))
    return total


def test_walker_accesses_take_the_fewest_wavefronts():
    t = np.arange(32)
    idx_pitch, st_pitch = 2 * (256 + 8), 256 + 8      # bytes
    for g in range(0, 32, 7):
        # 16-byte index loads: 512 bytes, at least 4 wavefronts
        assert _wavefronts(t * idx_pitch + 16 * g, 16) == 4
        # 8-byte state stores: 256 bytes, at least 2 wavefronts
        assert _wavefronts(t * st_pitch + 8 * g, 8) == 2
    # the parallel passes: a warp's row, 16 (8) contiguous bytes a lane
    assert _wavefronts(3 * idx_pitch + 16 * t, 16) == 4
    assert _wavefronts(5 * st_pitch + 8 * t, 8) == 2
