"""The device entropy decode's pieces equal the JAX package's: the static
tables, E1's twin (the codeword chain) against both JAX chain forms (on
random words, on streams of 255 words padded to one 256-word tile, on
real words; the tile edges and the look-back:
tests/test_torch_entropy_chain.py), the
five-pass literal window against the segmented scan, the per-run tuples
and E2's twin (the chunk-relay fixpoint) with its sweep count.
Tolerance 0.

JAX runs on the CPU here: the pointer-doubling chain at real streams and
the segment-cascade chain only at (2, 256) words, and the per-run
tuples and the fixpoint only on small real streams (near-flat and
gradient fixtures at q8 and q20), where XLA:CPU compiles in seconds.
"""

import functools

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from nhwcodec_tpu.models import encoder  # noqa: E402
from nhwcodec_tpu.ops import entropy, entropy_chain_scan as ecs  # noqa: E402
from nhwcodec_tpu.ops import entropy_decode_device as jedd  # noqa: E402
from nhwcodec_tpu.utils import container, fixtures  # noqa: E402
from nhwcodec_tpu_torch.ops import entropy_decode_device as edd  # noqa: E402

P1 = edd.Y_P1


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """The twins run many small torch ops one after another; beside the
    other workers of a parallel test run, intra-op threads only contend
    for the cores, so the module runs on one."""
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


@functools.lru_cache(maxsize=None)
def _stream(name: str, q: int):
    """The parsed stream of fixture ``name`` encoded at ``q``, encoded
    once for the module."""
    img = getattr(fixtures, name)()
    return container.parse_nhw(encoder.encode(img, q))


@pytest.mark.parametrize("name", ["_peek_lut", "_segments"])
@pytest.mark.parametrize("zone", [False, True])
def test_zone_tables_equal_jax(name, zone):
    mine = getattr(edd, name)(zone)
    ref = (getattr(jedd, name) if name == "_peek_lut" else ecs._segments)(
        zone)
    for a, b in zip(mine if isinstance(mine, tuple) else (mine,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("name", ["_y_word_tables", "_y_word_tables_packed",
                                  "_uv_word_table", "_seg_tables"])
def test_word_tables_equal_jax(name):
    if name == "_seg_tables":
        # the JAX package's (thresholds, lens, bases), each (2, S), are
        # the first S columns of the port's search table
        ref = ecs._seg_tables()
        mine = tuple(edd._seg_search_table()[:, i, :ref[i].shape[1]]
                     for i in range(3))
    else:
        mine, ref = getattr(edd, name)(), getattr(jedd, name)()
    for a, b in zip(mine if isinstance(mine, tuple) else (mine,),
                    ref if isinstance(ref, tuple) else (ref,)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("zone", [0, 1])
def test_segment_search_equals_peek_lut(zone):
    """The binary search over the padded segment table resolves every
    20-bit peek to the LUT's (len, sym), exhaustively."""
    lut = edd._peek_lut(bool(zone))
    peek = torch.arange(1 << edd.PEEK, dtype=torch.int64)
    ln, sym = edd._lens_syms(peek, torch.tensor(zone))
    np.testing.assert_array_equal(ln.numpy(), lut >> 10)
    np.testing.assert_array_equal(sym.numpy(), lut & 0x3FF)
    # the table the kernel searches: 2^20 padding, five steps reach it
    tab = edd._seg_search_table()[zone]
    assert tab[0, 0] == 0 and np.all(np.diff(tab[0]) >= 0)
    assert tab[0, -1] == 1 << edd.PEEK


@pytest.mark.parametrize("trial", [0, 1, 2])
def test_chain_twin_matches_both_jax_forms(trial):
    """Random words, both zone modes, bit counts off the word grid:
    ``syms[:count+1]`` and ``counts`` equal to the pointer-doubling and
    the segment-cascade chains."""
    rng = np.random.default_rng(3 + trial)
    nw, s_max = 256, 4096
    words = rng.integers(0, 1 << 32, (2, nw), dtype=np.uint64).astype(
        np.uint32)
    nbits = np.array([nw * 32 - 13, nw * 16 + 7], np.int32)
    zone = np.array([trial & 1, 1 - (trial & 1)], np.int32)
    got_s, got_c = edd.chain_starts_batch(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(nbits),
        torch.from_numpy(zone), s_max)
    assert got_s.dtype == torch.int32 and got_s.shape == (2, s_max)
    for fn in (jedd._codeword_chain_batch, ecs.chain_starts_batch):
        want_s, want_c = (np.asarray(a) for a in fn(
            jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zone),
            s_max))
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        for i in range(2):
            n = min(int(want_c[i]) + 1, s_max)
            np.testing.assert_array_equal(got_s[i, :n].numpy(),
                                          want_s[i, :n])


@pytest.mark.parametrize("zone", [0, 1])
def test_chain_twin_on_255_words_matches_both_jax_forms(zone):
    """Streams of 255 words and the zero word after them (one 256-word
    tile of the kernel, as ``_pack_words`` lays them out), bit counts off
    the word grid, against the pointer-doubling and the segment-cascade
    chains (the latter at the shape the test above compiled)."""
    rng = np.random.default_rng(40 + zone)
    words = np.zeros((2, 256), np.uint32)
    words[:, :255] = rng.integers(0, 1 << 32, (2, 255), dtype=np.uint64)
    nbits = np.array([255 * 32 - 3, 255 * 32], np.int32)
    zones = np.array([zone, 1 - zone], np.int32)
    got_s, got_c = edd.chain_starts_batch(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(nbits),
        torch.from_numpy(zones), 4096)
    for fn in (jedd._codeword_chain_batch, ecs.chain_starts_batch):
        want_s, want_c = (np.asarray(a) for a in fn(
            jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zones),
            4096))
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        for i in range(2):
            n = min(int(want_c[i]) + 1, 4096)
            np.testing.assert_array_equal(got_s[i, :n].numpy(),
                                          want_s[i, :n])


@pytest.mark.parametrize("nw", [1, 32, 94])
def test_chain_twin_on_odd_word_counts(nw):
    """Streams of nw words and the zero word after them (as
    ``_pack_words`` lays them out: W = 2, 33 and 95, off the twin's
    32-word groups) against the pointer-doubling chain."""
    rng = np.random.default_rng(nw)
    words = np.zeros((3, nw + 1), np.uint32)
    words[:, :nw] = rng.integers(0, 1 << 32, (3, nw), dtype=np.uint64)
    nbits = np.array([nw * 32, nw * 32 - 5, nw * 16 + 3], np.int32)
    zone = np.array([0, 1, 1], np.int32)
    s_max = 1 << (nw * 16 + 16).bit_length()
    got_s, got_c = edd.chain_starts_batch(
        torch.from_numpy(words.view(np.int32)), torch.from_numpy(nbits),
        torch.from_numpy(zone), s_max)
    want_s, want_c = (np.asarray(a) for a in jedd._codeword_chain_batch(
        jnp.asarray(words), jnp.asarray(nbits), jnp.asarray(zone), s_max))
    np.testing.assert_array_equal(got_c.numpy(), want_c)
    for i in range(3):
        n = min(int(want_c[i]) + 1, s_max)
        np.testing.assert_array_equal(got_s[i, :n].numpy(), want_s[i, :n])


def test_chain_twin_on_real_words():
    """The Y and UV words of real streams against the pointer-doubling
    chain (the form the JAX package runs on the CPU)."""
    streams = [_stream(g, q) for g, q in (("gradient_circles", 20),
                                          ("texture_noise", 8),
                                          ("near_flat", 23))]
    for packets, zones in (([s.packet1 for s in streams],
                            [int(s.res_high < 4) for s in streams]),
                           ([s.packet2 for s in streams], [0, 0, 0])):
        words, nbits = edd._pack_words(packets, "cpu")
        s_max = edd._s_max(int(nbits.max()), P1)
        zone = torch.tensor(zones, dtype=torch.int32)
        got_s, got_c = edd.chain_starts_batch(words, nbits, zone, s_max)
        want_s, want_c = (np.asarray(a) for a in jedd._codeword_chain_batch(
            jnp.asarray(words.numpy().view(np.uint32)),
            jnp.asarray(nbits.numpy()), jnp.asarray(zones, jnp.int32),
            s_max))
        np.testing.assert_array_equal(got_c.numpy(), want_c)
        for i in range(3):
            n = int(want_c[i]) + 1
            np.testing.assert_array_equal(got_s[i, :n].numpy(),
                                          want_s[i, :n])


@pytest.mark.parametrize("seed", [0, 1])
def test_five_pass_window_equals_segmented_scan(seed):
    rng = np.random.default_rng(seed)
    is_run = rng.random((3, 5000)) < [[0.1], [0.5], [0.9]]
    wadv = np.where(rng.random((3, 5000)) < 0.3, 5, 1).astype(np.int32)
    m, c = edd._runs_window(torch.from_numpy(is_run),
                            torch.from_numpy(wadv))
    wm, wc = jedd._runs_seg_scan(jnp.asarray(is_run), jnp.asarray(wadv))
    np.testing.assert_array_equal(m.numpy(), np.asarray(wm))
    np.testing.assert_array_equal(c.numpy(), np.asarray(wc))


def _jax_run_inputs(streams):
    """The JAX package's batch inputs of the fixpoint, as its
    decode_y_device_batch makes them: symbols, padded books, r_max."""
    s_max = 1 << (min(P1, max(64, max(s.packet1.size * 32 for s in streams)
                              // 2 + 2)) - 1).bit_length()
    sym_b, count_b = jedd._chain_batch_scan(streams, s_max)
    books = [entropy.build_y_book(s.tree1) for s in streams]

    def pad(rows):
        n = 1 << max(6, (max(len(r) for r in rows) - 1).bit_length())
        out = np.zeros((len(rows), n), np.int32)
        for i, r in enumerate(rows):
            out[i, :len(r)] = r
        return out

    v_b, r_b = pad([b[0] for b in books]), pad([b[1] for b in books])
    counts = np.asarray(count_b)
    runs = np.asarray(jedd._run_count_batch(sym_b, jnp.asarray(v_b),
                                            count_b))
    s_trim = min(jedd._bucket(int(counts.max()) + 1), s_max)
    r_max = jedd._bucket(int(max(runs.max(), 1)))
    return np.array(sym_b)[:, :s_trim], books, v_b, r_b, r_max


@pytest.mark.parametrize("q", [8, 20])
def test_run_tuples_and_fixpoint_twin_equal_jax(q):
    streams = [_stream(g, q) for g in ("near_flat", "gradient_circles")]
    syms, books, v_b, r_b, r_max = _jax_run_inputs(streams)
    k = min(64, r_max)
    xs_t, _ = jedd._runs_xs_batch(jnp.asarray(syms), jnp.asarray(v_b),
                                  jnp.asarray(r_b), P1, r_max, k)
    (ebase, fields), _ = edd._runs_xs_batch(
        torch.from_numpy(syms), edd._y_book_rows(books, "cpu"), P1, r_max,
        k)
    f = edd.unpack_run_fields(fields)
    for name, want in zip(("rle", "ebase", "segm", "segc", "prev_run",
                           "prev_lit_mem2", "valid"), xs_t):
        got = ebase if name == "ebase" else f[name]
        np.testing.assert_array_equal(got.numpy(), np.asarray(want),
                                      err_msg=name)

    (ins, ev1, ev2, e_in), iters = jedd._runs_fixpoint(xs_t, P1, k)
    got_e, got_f, sweeps = edd.runs_fixpoint(ebase, fields, P1, k)
    assert got_f.dtype == torch.uint8 and sweeps.shape == (2,)
    np.testing.assert_array_equal((got_f & 1).numpy() == 1, np.asarray(ev1))
    np.testing.assert_array_equal((got_f >> 1).numpy() == 1,
                                  np.asarray(ev2))
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(e_in))
    assert int(sweeps.max()) == int(iters)


def test_fixpoint_twin_sweep_count_per_stream_and_k1():
    """The batch's sweeps are the most of its streams'; at k = 1 the one
    chunk is pinned and the loop stops after its second sweep, as the
    JAX fixpoint does, with the same ys as at k = 64."""
    streams = [_stream(g, 20) for g in ("near_flat", "gradient_circles")]
    syms, book, r_max = edd._y_run_inputs(streams, P1, "cpu")
    xs64, _ = edd._runs_xs_batch(syms, book, P1, r_max, min(64, r_max))
    xs1, _ = edd._runs_xs_batch(syms, book, P1, r_max, 1)
    e64, f64, s64 = edd.runs_fixpoint(*xs64, P1, min(64, r_max))
    e1, f1, s1 = edd.runs_fixpoint(*xs1, P1, 1)
    assert s1.tolist() == [2, 2]
    (_, _, _, e_in), iters = jedd._runs_fixpoint(
        tuple(jnp.asarray(a) for a in _unpacked(xs1)), P1, 1)
    assert int(iters) == 2
    np.testing.assert_array_equal(e1.numpy(), np.asarray(e_in))
    flags64 = f64.t().reshape(2, -1)[:, :r_max]
    np.testing.assert_array_equal(f1.t().reshape(2, -1)[:, :r_max].numpy(),
                                  flags64.numpy())


def _unpacked(xs):
    """The port's (ebase, fields) as the JAX package's 7-tuple."""
    ebase, fields = xs
    f = edd.unpack_run_fields(fields)
    return (f["rle"].numpy(), ebase.numpy(), f["segm"].numpy(),
            f["segc"].numpy(), f["prev_run"].numpy(),
            f["prev_lit_mem2"].numpy(), f["valid"].numpy())
