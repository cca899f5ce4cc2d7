"""The device encode scans' residue stage as a whole
(``models/device_encode_scans._y_residue_stage`` and
``_residue_sections``) on the CPU, tolerance 0: it reproduces the host
copy's own encode at q20 (two fixtures), q21, q18 and q17, its inputs
captured by ``chip_smoke.StreamCapture`` — the plane the snap passes get,
every res section, and, chained with ``_y_stream_stage``,
``im_nhw[:4 SZ]`` and sel1/sel2 — runs at q12 (no E12, no stream) and
raises outside q1..q21.  Its
modules one by one: tests/test_torch_encode_residue.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.host.utils import fixtures
from nhwcodec_tpu_torch.models import device_encode_scans as des

SZ = 65536


@pytest.fixture(autouse=True)
def _one_thread():
    # beside the other workers of a parallel run, intra-op threads make
    # the twins' many small ops slower
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


_IMAGES = {"texture_noise": fixtures.texture_noise,
           "gradient_circles": fixtures.gradient_circles}


@pytest.mark.parametrize("q, names", [
    (20, ("texture_noise", "gradient_circles")),
    (21, ("gradient_circles",)), (18, ("texture_noise",)),
    (17, ("gradient_circles",))])
def test_residue_stage_matches_host_encode(q, names):
    with cs.StreamCapture() as cap:
        for name in names:
            henc.encode(_IMAGES[name](), q)
    st = cs.stack_records(cap.records)
    assert len(st["e11"]) == len(names)
    P, streams = des._y_residue_stage(*cs.residue_inputs(st, "cpu"), q)
    assert np.array_equal(P.numpy(), st["y"])
    secs = des._residue_sections(streams)
    assert not cs.sections_equal(secs, st["res"])
    assert {k[:4] for k in secs[0]} == {"res1", "res3", "res5"} & {
        key for key, *_, q_min in des.RESIDUE_STREAMS if q >= q_min}
    stream, sel1, sel2 = des._y_stream_stage(P, q)
    assert np.array_equal(stream[:, : 4 * SZ].numpy(),
                          st["im_nhw"][:, : 4 * SZ])
    assert sel1.tolist() == st["sel1"].tolist()
    assert sel2.tolist() == st["sel2"].tolist()


def test_residue_stage_range():
    z, r = (torch.zeros(s, dtype=torch.int16)
            for s in ((1, 512, 512), (1, 256, 256)))
    k = torch.zeros((1, 4), dtype=torch.int16)
    P, streams = des._y_residue_stage(z, r, k, r, T.LOW8, k,
                                      torch.zeros((1, 16384),
                                                  dtype=torch.uint8))
    assert P.shape == z.shape and streams == {}
    with pytest.raises(ValueError, match="needs ktail and tree1"):
        des._y_residue_stage(z, r, k, r, T.LOW8)
    for q in (0, T.HIGH2):
        with pytest.raises(ValueError, match="HQ residue stays on the host"):
            des._y_residue_stage(z, r, k, r, q)
    with pytest.raises(ValueError):
        des._y_residue_stage(z, r, torch.zeros((1, 3), dtype=torch.int16),
                             r, 20)
    with pytest.raises(TypeError):
        des._y_residue_stage(z, r.int(), k, r, 20)
