"""S3 ``merge_crossing`` in its cluster decomposition on the CPU, tolerance
0 (exact).

- ``merge_crossing_ref`` (the twin: 64 positions a thread, 16 warps a CTA,
  8 CTAs a stream, each CTA's composite, partial map and last-4 fires
  chained over the cluster) equals the JAX package's
  ``merge_crossing_device`` and the host copy's C (``merge_crossing_codes``)
  at batch 2 on ``chip_smoke.merge_edge_streams`` ("span edges": crossings
  1..8 positions before every thread span edge and before the walk's end;
  "state carries": each of the 5 cursor states across every span edge),
  each kind checked on the C's output to do what it claims.
- ``merge_crossing_plan``'s thread entry states, CTA entry states and the
  fires a CTA takes from the one before equal a plain serial walk's.
- A numpy transcription of the kernel's word-level steps (byte compares
  to bit masks, the 15-bit map of 5 states advanced a position at a
  time, the warps' shuffle scans, the CTAs' scans of their warps, the
  cluster's words and their chain, the walk again and the emission a
  word at a time) equals the host copy's C.
- Streams of 4 SZ, 4 SZ + 8 and 4 SZ + 37 bytes (rows the kernel reads a
  byte at a time) equal the C through the wrapper.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.host.ops import quantize as hq
from nhwcodec_tpu_torch.models import device_scans as tds

SZ = 65536
N = 4 * SZ
END = N - 4
THREADS, WARPS, CTAS, TILE = 512, 16, 8, 64
ONES, IDENT = 0x1249, 0x4688


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _host(s):
    out = s.copy()
    for k in range(len(out)):
        hq.merge_crossing_codes(out[k])
    return out


def _steps(s):
    """(k - 1, fire pattern) of every walked position of each stream."""
    v = np.zeros((len(s), N + 8), np.int64)
    v[:, :N] = s[:, :N]
    v0, v1, v2, v3, v4 = (v[:, k:k + N] for k in range(5))
    live = np.arange(N) < END
    c1 = (v0 != 128) & (v1 == 128) & live
    c2 = c1 & (v2 != 128)
    c3 = c1 & ~c2 & (v3 != 128)
    fire = (c1 & ~c2 & ~c3 & np.isin(v0, (136, 120))
            & np.isin(v4, (136, 120)))
    km1 = np.where(~c1, 0, np.where(c2, 1, np.where(c3, 2, np.where(
        fire, 4, 3))))
    return km1, fire


def _serial(s):
    """A plain serial walk of the cursor: the state (skips left) before
    each walked position and the fires, per stream."""
    km1, fire = _steps(s)
    states = np.zeros(km1.shape, np.int64)
    fires = np.zeros(km1.shape, bool)
    for b in range(len(s)):
        k, f = km1[b].tolist(), fire[b].tolist()
        st, row, fr = 0, [0] * N, [False] * N
        for i in range(N):
            row[i] = st
            if st == 0:
                fr[i] = f[i]
                st = k[i]
            else:
                st -= 1
        states[b], fires[b] = row, fr
    return states, fires


def _kinds():
    rng = np.random.default_rng(41)
    out = {k: cs.merge_edge_streams(rng, 2, k) for k in cs.MERGE_EDGE_KINDS}
    s = np.zeros((2, 6 * SZ + 16), np.uint8)
    s[:, :N] = rng.choice(np.array([128, 136, 120, 5, 128, 128, 153],
                                   np.uint8), (2, N))
    out["random"] = s
    return out


KINDS = _kinds()


@pytest.mark.parametrize("kind", cs.MERGE_EDGE_KINDS)
def test_merge_edge_streams_match_jax_and_host(kind):
    s = KINDS[kind]
    got = tds.merge_crossing_device(torch.from_numpy(s)).numpy()
    want = _host(s)
    assert np.array_equal(got, want)
    assert np.array_equal(got, np.asarray(jds.merge_crossing_device(s)))
    states, fires = _serial(s)
    edges = np.arange(TILE, N, TILE)
    if kind == "span edges":
        # 201s in the first 4 bytes of thread, warp and CTA spans, and
        # fires in the last 4 positions before the walk's end
        at = np.nonzero(want[:, :N] == 201)
        assert (at[1] % TILE < 4).sum() > 1000
        assert {p % 32768 for p in at[1]
                if p >= 32768 and p % 32768 < 4} == {0, 1, 2, 3}
        assert fires[:, END - 8:END].any()
    else:
        # every state crosses thread and CTA edges
        assert set(states[:, edges].ravel().tolist()) == set(range(5))
        cta = states[:, np.arange(32768, N, 32768)]
        assert set(cta.ravel().tolist()) == set(range(5))


@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_plan_matches_serial_walk(kind):
    s = KINDS[kind]
    plan = tds.merge_crossing_plan(torch.from_numpy(s))
    states, fires = _serial(s)
    assert np.array_equal(plan["entry"].numpy(), states[:, ::TILE])
    assert np.array_equal(plan["cta_entry"].numpy(),
                          states[:, ::TILE * THREADS])
    starts = np.arange(1, CTAS) * TILE * THREADS
    prev = np.stack([fires[:, a - 4:a] for a in starts], 1)
    assert np.array_equal(plan["prev4"][:, 1:].numpy(), prev)
    assert not plan["prev4"][:, 0].any()


# --- a numpy transcription of the kernel (csrc/scans.cu merge_crossing)

def _byte_bits(m):
    return (((m & 0x08040201) * 0x01010101) & 0xFFFFFFFF) >> 24


def _bits_bytes(b):
    return (((b * 0x00204081) & 0x01010101) * 0xFF) & 0xFFFFFFFF


def _vcmpeq4(w, pat):
    out = np.zeros_like(w)
    for i in range(4):
        eq = ((w >> (8 * i)) & 0xFF) == pat
        out |= np.where(eq, 0xFF << (8 * i), 0).astype(w.dtype)
    return out


def _at(f, s):
    return (f >> (3 * s)) & 7


def _then(f, g):
    r = np.zeros_like(f)
    for s in range(5):
        r |= _at(g, _at(f, s)) << (3 * s)
    return r


def _warp_scan(m, axis):
    """Inclusive scan of packed maps along ``axis`` (32 lanes) by the
    shuffles' doubling steps, and the exclusive prefixes."""
    m = np.moveaxis(m, axis, -1).copy()
    lane = np.arange(32)
    d = 1
    while d < 32:
        b = np.concatenate([m[..., :d], m[..., :-d]], -1)
        m = np.where(lane >= d, _then(b, m), m)
        d <<= 1
    e = np.concatenate([np.full_like(m[..., :1], IDENT), m[..., :-1]], -1)
    return np.moveaxis(m, -1, axis), np.moveaxis(e, -1, axis)


def _kernel_np(s):
    b = len(s)
    raw = np.zeros((b, N + 4), np.uint8)
    raw[:, :N] = s[:, :N]
    words = raw.view("<u4").astype(np.int64)          # (B, N / 4 + 1)
    t = np.arange(CTAS * THREADS)
    g0 = t * TILE
    v = np.stack([words[:, g0 // 4 + k] for k in range(16)], -1)
    look = np.where(g0 + TILE < N, words[:, np.minimum(g0 // 4 + 16,
                                                      words.shape[1] - 1)],
                    0)
    v = np.concatenate([v, look[..., None]], -1)       # (B, T, 17)
    masks = []
    for h in range(2):
        e = np.zeros(v.shape[:2], np.int64)
        a = np.zeros(v.shape[:2], np.int64)
        for k in range(9):
            w = v[..., 8 * h + k]
            e |= _byte_bits(_vcmpeq4(w, 0x80)) << (4 * k)
            a |= _byte_bits(_vcmpeq4(w, 0x88) | _vcmpeq4(w, 0x78)) << (4 * k)
        lim = END - (g0 + 32 * h)
        live = np.where(lim >= 32, 0xFFFFFFFF, np.where(
            lim <= 0, 0, (1 << np.clip(lim, 0, 31)) - 1))
        c1 = ~e & (e >> 1) & live & 0xFFFFFFFF
        c2 = c1 & (e >> 2)
        c3 = c2 & (e >> 3)
        f = c3 & a & (a >> 4) & 0xFFFFFFFF
        masks.append((c1, c2, c3, f))

    def km1(h, i):
        return sum((m >> i) & 1 for m in masks[h])

    # the two halves' maps as two chains, composed
    halves = []
    for h in range(2):
        p = np.full(v.shape[:2], IDENT, np.int64)
        for i in range(32):
            if h == 1 and i == 28:
                p28 = p.copy()
            tt = (p | (p >> 1) | (p >> 2)) & ONES
            p = p - tt + ((~tt) & ONES) * km1(h, i)
        halves.append(p)
    p60 = _then(halves[0], p28)
    p = _then(halves[0], halves[1]).reshape(b, CTAS, WARPS, 32)
    inc, exc = _warp_scan(p, 3)
    wm = np.concatenate([inc[..., 31], np.full((b, CTAS, 32 - WARPS), IDENT)],
                        -1)
    cinc, wpre = _warp_scan(wm, 2)
    comp = cinc[..., 31]
    last = (slice(None), slice(None), WARPS - 1, 31)
    f1 = masks[1][3].reshape(p.shape)[last]
    k1 = np.stack([km1(1, i).reshape(p.shape)[last] for i in range(32)], -1)
    tab = np.zeros((b, CTAS), np.int64)
    for s0 in range(5):
        st = np.full((b, CTAS), s0)
        for i in range(28, 32):
            z = st == 0
            tab |= (z & ((f1 >> i) & 1).astype(bool)).astype(np.int64) << (
                4 * s0 + i - 28)
            st = np.where(z, k1[..., i], st - 1)
    partial = _then(_then(wpre[..., WARPS - 1], exc[last]),
                    p60.reshape(p.shape)[last])
    pub = comp | (partial << 15) | (tab << 30)
    entry = np.zeros((b, CTAS), np.int64)
    prev4 = np.zeros((b, CTAS), np.int64)
    e = np.zeros(b, np.int64)
    for c in range(CTAS):
        entry[:, c] = e
        if c + 1 < CTAS:
            st = _at((pub[:, c] >> 15) & 0x7FFF, e)
            prev4[:, c + 1] = (pub[:, c] >> (30 + 4 * st)) & 15
        e = _at(pub[:, c] & 0x7FFF, e)
    st = _at(exc, _at(wpre[..., :WARPS], entry[..., None])[..., None])
    st = st.reshape(b, -1)
    fires = [np.zeros_like(st), np.zeros_like(st)]
    for h in range(2):
        if h:
            st = _at(halves[0], st0)      # the second half's entry
        st0 = st
        for i in range(32):
            z = st == 0
            fires[h] |= (z & ((masks[h][3] >> i) & 1).astype(bool)).astype(
                np.int64) << i
            st = np.where(z, km1(h, i), st - 1)
    last4 = fires[1] >> 28
    prev = np.concatenate([np.zeros((b, 1), np.int64), last4[:, :-1]], 1)
    prev[:, ::THREADS] = prev4
    pf = _bits_bytes(prev)
    m136 = _vcmpeq4(v[..., 0], 0x88)
    out = np.zeros((b, v.shape[1], 16), np.int64)
    for k in range(16):
        n136 = _vcmpeq4(v[..., k + 1], 0x88)
        fm = _bits_bytes((fires[k >> 3] >> (4 * (k & 7))) & 15)
        code = 0x87878787 - (m136 & 0x02020202) - (n136 & 0x01010101)
        word = (pf & 0xC9C9C9C9) | (~pf & ((fm & code) | (~fm & v[..., k])))
        out[..., k] = word & 0xFFFFFFFF
        pf, m136 = fm, n136
    res = s.copy()
    res[:, :N] = out.astype("<u4").view(np.uint8).reshape(b, N)
    return res


@pytest.mark.parametrize("kind", list(KINDS))
def test_merge_kernel_transcription_matches_host(kind):
    s = KINDS[kind]
    assert np.array_equal(_kernel_np(s), _host(s))


@pytest.mark.parametrize("n", [N, N + 8, N + 37])
def test_merge_crossing_any_length(n):
    rng = np.random.default_rng(n)
    s = rng.choice(np.array([128, 136, 120, 5, 128], np.uint8), (3, n))
    got = tds.merge_crossing_device(torch.from_numpy(s)).numpy()
    assert np.array_equal(got, _host(s))
