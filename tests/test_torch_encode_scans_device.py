"""``encode_batch_device(images, q, scans_on_device=True)`` on the CPU:
every raster scan after the front through the port's device stages
(``models/device_encode_scans.encode_batch_scans_device``), the streams
byte for byte against ``nhwcodec_tpu.encode`` (the JAX package's host
encode) and the host copy's ``encoder.encode``: two fixtures at q20, one
each at q21, q18 (the sentinel marking's lowest quality), q17 (without
it), q16 (the duty-cycle quantizer), q15 and q14 (the low56 cleanup), q13
(the lowest-q cleanup), q12 (the very-low-q cleanup, no E10 or E12), q11
(the LL1 cleanup, the chroma smoothing, pass 4), q8 and q1; the q1..q21
sweep under ``slow``.  The option raises ValueError outside 1..HIGH1.
"""

import numpy as np
import pytest
import torch

import nhwcodec_tpu
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.host.utils import fixtures
from nhwcodec_tpu_torch.parallel import device_pipeline as tdp


@pytest.fixture(autouse=True)
def _one_thread():
    # beside the other workers of a parallel run, intra-op threads make
    # the twins' many small ops slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _check(names, q):
    images = np.stack([fixtures.GENERATORS.get(
        n, fixtures.EXTREME_GENERATORS.get(n))() for n in names])
    got, m = tdp.encode_batch_device(images, q, device="cpu",
                                     scans_on_device=True)
    assert m.images == len(names) and m.failures == 0 and m.wall_s > 0
    for img, g in zip(images, got):
        assert g == nhwcodec_tpu.encode(img, q)
        assert g == henc.encode(img, q)


@pytest.mark.parametrize("q, names", [
    (20, ("gradient", "texture")), (21, ("blocks",)), (18, ("photo2",)),
    (17, ("boundary",)), (16, ("maxnoise",)), (15, ("checker",)),
    (14, ("texture",)), (13, ("gradient",)), (12, ("photo2",)),
    (11, ("blocks",)), (8, ("saturated",)), (1, ("boundary",))])
def test_scans_on_device_matches_the_host_encode(q, names):
    _check(names, q)


@pytest.mark.slow
@pytest.mark.parametrize("q", range(1, T.HIGH1 + 1))
def test_scans_on_device_sweep(q):
    _check(list(fixtures.GENERATORS) + list(fixtures.EXTREME_GENERATORS), q)


def test_scans_on_device_range():
    img = np.zeros((1, 512, 512, 3), np.uint8)
    got, _ = tdp.encode_batch_device(img, T.LOW8, device="cpu",
                                     scans_on_device=True)
    assert got == [henc.encode(img[0], T.LOW8)]
    for q in (0, T.HIGH2):
        with pytest.raises(ValueError, match=rf"1 <= q <= {T.HIGH1}"):
            tdp.encode_batch_device(img, q, device="cpu",
                                    scans_on_device=True)
