"""The port's device entropy decode, whole: Y and UV symbol planes equal
to the host automata (``entropy.decode_y`` / ``decode_uv``) on real
streams at q1..q23 and a dense random stream, the decode with
``entropy_on_device=True`` byte-identical to ``decoder.decode``, and the
JAX package's three guards: identical rows, the fixpoint's k + 1 bound
falling back to one chunk, a malformed book rejected before any launch.
On the CPU (the kernels' torch twins); tolerance 0."""

import functools

import numpy as np
import pytest
import torch

from nhwcodec_tpu.models import decoder, encoder
from nhwcodec_tpu.ops import entropy
from nhwcodec_tpu.utils import container, fixtures
from nhwcodec_tpu_torch.host.ops import entropy as host_entropy
from nhwcodec_tpu_torch.kernels import build
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import entropy_decode_device as edd
from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

Q_LEVELS = (1, 8, 16, 20, 22, 23)


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


def _parsed(pairs):
    return [_stream(g, q) if isinstance(g, str)
            else container.parse_nhw(encoder.encode(g, q)) for g, q in pairs]


def _assert_planes(streams, **kw):
    ys = edd.decode_y_device_batch(streams, device="cpu", **kw)
    uvs = edd.decode_uv_device_batch(streams, device="cpu")
    _assert_equal_host(streams, ys, uvs)


def _assert_equal_host(streams, ys, uvs):
    for i, (s, y, uv) in enumerate(zip(streams, ys, uvs)):
        want_y = entropy.decode_y(s.packet1, s.tree1, s.select_word1,
                                  s.select_word2, s.res_high)
        want_uv = entropy.decode_uv(s.packet2, s.tree2, s.tree_end)
        assert y.dtype == np.int16 and uv.dtype == np.int16
        np.testing.assert_array_equal(y, want_y, err_msg=f"Y of stream {i}")
        np.testing.assert_array_equal(uv, want_uv,
                                      err_msg=f"UV of stream {i}")


@pytest.fixture(scope="module")
def q_levels_batch():
    """The texture and near-flat streams of every q level decoded as one
    batch (streams of both zone modes and of every length side by side):
    (streams, Y planes, UV planes)."""
    streams = _parsed([(g, q) for q in Q_LEVELS
                       for g in ("texture_noise", "near_flat")])
    return (streams, edd.decode_y_device_batch(streams, device="cpu"),
            edd.decode_uv_device_batch(streams, device="cpu"))


@pytest.mark.parametrize("q", Q_LEVELS)
def test_planes_equal_the_host_automata(q, q_levels_batch):
    i = 2 * Q_LEVELS.index(q)
    _assert_equal_host(*(a[i:i + 2] for a in q_levels_batch))


def test_planes_of_a_dense_random_stream():
    img = np.random.default_rng(2026).integers(0, 256, (512, 512, 3),
                                               dtype=np.uint8)
    streams = _parsed([(img, 20)])
    assert streams[0].packet1.size > 40000
    _assert_planes(streams)


def test_planes_one_chunk_automaton():
    """``k_chunks=1``: E2 at one chunk, the sequential automaton."""
    _assert_planes(_parsed([("near_flat", 16), ("gradient_circles", 23)]),
                   k_chunks=1)


def test_identical_rows_decode_alike():
    """Every row of an [s, s, s] batch decodes to the host plane."""
    s = _stream("gradient_circles", 20)
    _assert_planes([s, s, s])


def test_fixpoint_bound_falls_back_to_one_chunk(monkeypatch):
    """A fixpoint that reports k + 1 sweeps sends the batch through E2 at
    k = 1, which still decodes exactly."""
    real = edd.runs_fixpoint
    ks = []

    def fake(ebase, fields, p1, k):
        ks.append(k)
        e_in, flags, sweeps = real(ebase, fields, p1, k)
        return e_in, flags, sweeps * 0 + k + 1

    monkeypatch.setattr(edd, "runs_fixpoint", fake)
    _assert_planes(_parsed([("gradient_circles", 20), ("near_flat", 20)]))
    assert ks == [edd.K_CHUNKS, 1]


def test_malformed_book_rejected_before_any_launch(monkeypatch):
    """A run word with rle < 1 or > 255 raises on the host: no chain is
    extracted and no launch is counted."""
    with pytest.raises(ValueError, match="rle < 1"):
        edd._check_book([5, 7], [3, 0], "Y")
    with pytest.raises(ValueError, match="run length > 255"):
        edd._check_book([5, 128], [1, 256], "UV")
    edd._check_book([5, 7], [3, 1], "Y")

    def no_chain(*a, **k):
        raise AssertionError("chain extracted for a malformed book")

    s = _stream("near_flat", 20)
    before = dict(build.LAUNCHES)
    monkeypatch.setattr(edd, "chain_starts_batch", no_chain)
    monkeypatch.setattr(host_entropy, "build_y_book",
                        lambda tree: ([128, 5], [0, 1]))
    monkeypatch.setattr(host_entropy, "build_uv_book",
                        lambda tree, end: ([128, 6], [300, 1]))
    with pytest.raises(ValueError, match="rle < 1"):
        edd.decode_y_device_batch([s], device="cpu")
    with pytest.raises(ValueError, match="run length > 255"):
        edd.decode_uv_device_batch([s], device="cpu")
    assert build.LAUNCHES == before


@pytest.mark.parametrize("qs", [[20, 4, 14, 23], [19, 21, 22]],
                         ids=["mixed", "mixed-hq"])
def test_decode_with_entropy_on_device_matches_decoder(qs):
    gens = list(fixtures.GENERATORS.values())
    datas = [encoder.encode(gens[i % len(gens)](), q)
             for i, q in enumerate(qs)]
    got = tdd.decode_batch_device(datas, device="cpu",
                                  entropy_on_device=True)
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decoder.decode(d))


def test_pipeline_passes_the_option_through(monkeypatch):
    calls = []
    real = edd.decode_y_device_batch

    def spy(streams, **kw):
        calls.append(len(streams))
        return real(streams, **kw)

    monkeypatch.setattr(edd, "decode_y_device_batch", spy)
    datas = [encoder.encode(fixtures.near_flat(), 20),
             encoder.encode(fixtures.gradient_circles(), 8)]
    out, m = tdp.decode_batch_device(datas, workers=1, chunk=1,
                                     device="cpu", entropy_on_device=True)
    assert m.failures == 0 and calls == [1, 1]
    for d, g in zip(datas, out):
        np.testing.assert_array_equal(g, decoder.decode(d))
    calls.clear()
    tdp.decode_batch_device(datas, workers=1, device="cpu")
    assert calls == []


def test_wrappers_reject_bad_inputs():
    """Wrong types, shapes and strides raise before any device choice."""
    words = torch.zeros((2, 64), dtype=torch.int32)
    nbits = torch.full((2,), 64 * 32, dtype=torch.int32)
    zone = torch.zeros(2, dtype=torch.int32)
    with pytest.raises(TypeError):
        edd.chain_starts_batch(words.to(torch.int64), nbits, zone, 128)
    with pytest.raises(ValueError):
        edd.chain_starts_batch(words[:, ::2], nbits, zone, 128)
    with pytest.raises(ValueError):
        edd.chain_starts_batch(words, nbits[:1], zone, 128)
    ebase = torch.zeros((8, 128), dtype=torch.int32)
    fields = torch.zeros_like(ebase)
    with pytest.raises(TypeError):
        edd.runs_fixpoint(ebase.float(), fields, edd.Y_P1, 64)
    with pytest.raises(ValueError):
        edd.runs_fixpoint(ebase.t(), fields.t(), edd.Y_P1, 64)
    with pytest.raises(ValueError):
        edd.runs_fixpoint(ebase, fields, edd.Y_P1, 3)
    with pytest.raises(ValueError):
        edd.decode_y_device_batch([], device="cpu", k_chunks=0)
    with pytest.raises(ValueError):
        edd.decode_y_device_batch([], device="cpu",
                                  k_chunks=edd.MAX_CHUNKS + 1)
