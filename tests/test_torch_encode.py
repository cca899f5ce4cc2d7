"""The port's batched encode equals the host encoder and the JAX
package's batched encode, byte for byte.

The port runs with ``device="cpu"`` (its kernels' torch twins), the JAX
package through its plain reference path.  Images are the fixture
generators and seeded random pixels.
"""

import logging

import numpy as np
import pytest

import nhwcodec_tpu
from nhwcodec_tpu.parallel import device_pipeline as jdp
from nhwcodec_tpu.utils import fixtures
from nhwcodec_tpu_torch.host.models import encoder as host_encoder
from nhwcodec_tpu_torch.models import device_stages as tds
from nhwcodec_tpu_torch.models import encoder as tenc
from nhwcodec_tpu_torch.parallel import device_pipeline as tdp


def _images(n, seed=0):
    gens = list(fixtures.GENERATORS.values())
    rng = np.random.default_rng(seed)
    return np.stack([gens[i]() if i < len(gens) else
                     rng.integers(0, 256, (512, 512, 3), dtype=np.uint8)
                     for i in range(n)])


def test_encode_batch_q20_matches_host_and_jax():
    imgs = _images(4)
    got, m = tdp.encode_batch_device(imgs, 20, workers=1, device="cpu")
    assert m.failures == 0 and m.images == 4
    assert got == [nhwcodec_tpu.encode(im, 20) for im in imgs]
    jax_out, jm = jdp.encode_batch_device(imgs, 20, workers=2, chunk=2)
    assert jm.failures == 0 and got == jax_out


@pytest.mark.parametrize("q", [23, 22, 21, 19, 17, 16, 12, 8, 1])
def test_encode_batch_every_branch_matches_host(q):
    """q > HIGH1 (fused front, snapshot), q21 (pre-filter, no HQ), the
    gain colorspaces (19, 17), the dead-zone (16), the UV pre-filter
    (12, 8), no requant tail (1)."""
    imgs = _images(5, seed=q)[[0, 4]]
    got, m = tdp.encode_batch_device(imgs, q, workers=1, device="cpu")
    assert m.failures == 0
    assert got == [nhwcodec_tpu.encode(im, q) for im in imgs]


def test_encode_pipeline_chunks_workers_and_host_pack():
    imgs = _images(5, seed=9)
    want = [nhwcodec_tpu.encode(im, 20) for im in imgs]
    got, m = tdp.encode_batch_device(imgs, 20, workers=2, chunk=2,
                                     device="cpu")
    assert m.failures == 0 and got == want
    got, m = tdp.encode_batch_device(imgs[:2], 20, workers=1, device="cpu",
                                     device_pack=False)
    assert m.failures == 0 and got == want[:2]


@pytest.mark.parametrize("q", [20, 23])
def test_encode_device_single_image(q):
    img = fixtures.texture_noise()
    want = nhwcodec_tpu.encode(img, q)
    assert tenc.encode_device(img, q, device="cpu") == want
    assert tenc.encode_device(img, q, device="cpu", device_pack=False) == want


def test_host_stage_failure_costs_one_image(monkeypatch):
    imgs = _images(3)
    real = host_encoder.encode_from_planes
    calls = []

    def flaky(*a, **k):
        calls.append(1)
        if len(calls) == 2:
            raise ValueError("injected host-stage failure")
        return real(*a, **k)

    monkeypatch.setattr(host_encoder, "encode_from_planes", flaky)
    got, m = tdp.encode_batch_device(imgs, 20, workers=1, chunk=3,
                                     device="cpu")
    assert m.failures == 1 and got[1] is None
    assert got[0] == nhwcodec_tpu.encode(imgs[0], 20)
    assert got[2] == nhwcodec_tpu.encode(imgs[2], 20)


def test_pack_failure_is_retried_image_by_image(monkeypatch):
    imgs = _images(3)
    real = tenc.finish_deferred
    calls = []

    def flaky(deferred, *a, **k):
        calls.append(len(deferred))
        if len(calls) in (1, 3):      # the chunk's pack, then image 1's
            raise OverflowError("injected pack failure")
        return real(deferred, *a, **k)

    monkeypatch.setattr(tenc, "finish_deferred", flaky)
    got, m = tdp.encode_batch_device(imgs, 20, workers=1, chunk=3,
                                     device="cpu")
    assert calls == [3, 1, 1, 1]
    assert m.failures == 1 and got[1] is None
    assert got[0] == nhwcodec_tpu.encode(imgs[0], 20)
    assert got[2] == nhwcodec_tpu.encode(imgs[2], 20)


def test_device_stage_failure_costs_the_chunk(monkeypatch, caplog):
    imgs = _images(4)

    def broken(*a, **k):
        raise RuntimeError("injected device failure")

    monkeypatch.setattr(tds, "colorspace_front_device", broken)
    with caplog.at_level(logging.WARNING):
        got, m = tdp.encode_batch_device(imgs, 20, workers=1, chunk=2,
                                         device="cpu")
    assert m.failures == 4 and got == [None] * 4
    assert "injected device failure" in caplog.text


def test_scans_on_device_is_outside_the_slice():
    # q1..q21 run (tests/test_torch_encode_scans_device.py); outside, the
    # option raises ValueError (above HIGH1 the HQ residue stays on the
    # host encoder)
    img = _images(1)
    got, _ = tdp.encode_batch_device(img, 12, device="cpu",
                                     scans_on_device=True)
    assert got == tdp.encode_batch_device(img, 12, device="cpu")[0]
    for q in (0, 22):
        with pytest.raises(ValueError, match="1 <= q <= 21"):
            tdp.encode_batch_device(img, q, device="cpu",
                                    scans_on_device=True)


def test_cuda_without_a_card_raises():
    import torch

    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present")
    with pytest.raises(RuntimeError, match="cuda"):
        tdp.encode_batch_device(_images(1), 20, device="cuda")
    with pytest.raises(RuntimeError, match="cuda"):
        tenc.encode_device(_images(1)[0], 20, device="cuda")
