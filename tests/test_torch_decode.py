"""The port's batched decode equals the JAX package's and the host decoder.

Streams come from the host encoder on the fixture generators.  The port
runs with ``device="cpu"`` (its kernels' torch twins), the JAX package
through its plain reference (``fused=False``).  Byte-identical RGB.
"""

import numpy as np
import pytest

from nhwcodec_tpu.models import decoder, encoder
from nhwcodec_tpu.models import device_decode as jdd
from nhwcodec_tpu.utils import fixtures
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.parallel import device_pipeline as tdp


def _streams(qs):
    gens = list(fixtures.GENERATORS.values())
    return [encoder.encode(gens[i % len(gens)](), q)
            for i, q in enumerate(qs)]


@pytest.mark.parametrize("qs", [[20, 20], [4, 14, 19, 21], [1, 1], [16, 16],
                                [22, 22], [23, 23], [20, 22, 23, 21]],
                         ids=["q20", "mixed", "q1", "q16", "q22", "q23",
                              "mixed-hq"])
def test_decode_batch_matches_jax_and_host(qs):
    datas = _streams(qs)
    got = tdd.decode_batch_device(datas, device="cpu")
    jax_out = jdd.decode_batch_device(datas, fused=False)
    for d, g, j in zip(datas, got, jax_out):
        assert g.shape == (512, 512, 3) and g.dtype == np.uint8
        np.testing.assert_array_equal(g, np.asarray(j))
        np.testing.assert_array_equal(g, decoder.decode(d))


def test_decode_pipeline_chunks_and_workers():
    datas = _streams([20, 3, 17, 20, 15])
    out, m = tdp.decode_batch_device(datas, workers=2, chunk=2, device="cpu")
    assert m.failures == 0 and m.images == 5
    for d, rgb in zip(datas, out):
        np.testing.assert_array_equal(rgb, decoder.decode(d))


def test_decode_pipeline_failure_isolation():
    datas = _streams([20, 20])
    bad = b"\x00\x01" + b"\x00" * 40  # structurally hopeless stream
    out, m = tdp.decode_batch_device([datas[0], bad, datas[1]], chunk=3,
                                     device="cpu")
    assert m.failures == 1
    assert out[1] is None
    np.testing.assert_array_equal(out[0], decoder.decode(datas[0]))
    np.testing.assert_array_equal(out[2], decoder.decode(datas[1]))


def test_decode_pipeline_with_an_hq_stream():
    # the q22 stream shares its chunk of 2 with a q3 one
    datas = _streams([20, 3, 22, 20, 15])
    out, m = tdp.decode_batch_device(datas, workers=2, chunk=2, device="cpu")
    assert m.failures == 0 and m.images == 5
    for d, rgb in zip(datas, out):
        np.testing.assert_array_equal(rgb, decoder.decode(d))


@pytest.mark.parametrize("q", [20, 23])
def test_decode_sequential_fallback(q, monkeypatch):
    # depth planes refused, as for same-row marks out of column order: the
    # decode takes the sequential mark scan and stays byte-identical
    from nhwcodec_tpu_torch.kernels import build

    datas = _streams([q, q])
    monkeypatch.setattr(tdd, "mark_depth_planes",
                        lambda marks: (None, 0, False))
    seen = []
    scan = tdd.dwt.smooth_marks_seq
    monkeypatch.setattr(tdd.dwt, "smooth_marks_seq",
                        lambda *a: seen.append(1) or scan(*a))
    before = dict(build.LAUNCHES)
    got = tdd.decode_batch_device(datas, device="cpu")
    assert seen and build.LAUNCHES == before
    for d, g in zip(datas, got):
        np.testing.assert_array_equal(g, decoder.decode(d))


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdp.decode_batch_device(_streams([20]), device="cuda")
