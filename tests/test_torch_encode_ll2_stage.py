"""The device encode scans' LL2 stage as a whole
(``models/device_encode_scans._y_ll2_stage``, ``_uv_ll2_stage``,
``_uv_highres_stage``, ``_ll2_sections`` and ``_uv_ll2_sections``) on
the CPU, tolerance 0: it reproduces the host copy's own encode at q20
(two fixtures), q21, q16, q15 and q4, its inputs captured by ``chip_smoke.StreamCapture`` — the
zeroed Y, U and V planes, every E16 and E17 section and hr_mem — and
raises outside q1..q21 and on planes of the wrong type or shape.  Its
modules one by one: tests/test_torch_encode_ll2.py.
"""

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as henc
from nhwcodec_tpu_torch.host.utils import fixtures
from nhwcodec_tpu_torch.models import device_encode_scans as des


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
    (21, ("gradient_circles",)), (16, ("texture_noise",)),
    (15, ("gradient_circles",)), (4, ("texture_noise",))])
def test_ll2_stage_matches_host_encode(q, names):
    with cs.StreamCapture() as cap:
        for name in names:
            henc.encode(_IMAGES[name](), q)
    st = cs.stack_ll2(cap.records, q)
    assert len(st["P"]) == len(names)
    Pz, Uz, Vz, y, uv = cs.device_ll2_stage(cs.ll2_inputs(st, "cpu"), q)
    for got, key in ((Pz, "Pz"), (Uz, "uz"), (Vz, "vz")):
        assert np.array_equal(got.numpy(), st[key])
    # the UV planes the LL2 coding left are the ones offset_uv got
    assert np.array_equal(Uz.numpy(), np.stack([r["uv"][0]
                                                for r in cap.records]))
    secs, mems = cs.ll2_sections(y, uv)
    assert not cs.ll2_sections_equal(secs, st["secs"])
    assert all(np.array_equal(g, w) for g, w in zip(mems, st["hr_mem"]))
    y_secs, _ = des._ll2_sections(y)
    assert set(y_secs[0]) == {"exw_Y", "res_low", "highres_word",
                              "hrcomp_y", "tree1_y"} | (
        {"res4"} if q > T.LOW3 else set())
    assert ("res_U_64" in des._uv_ll2_sections(uv)[0]) == (q > T.LOW5)


def test_ll2_stage_checks_its_inputs():
    P = torch.zeros((1, 512, 512), dtype=torch.int16)
    Pm = torch.zeros((1, 256, 256), dtype=torch.int16)
    for q in (0, T.HIGH2, T.HIGH3):
        with pytest.raises(ValueError, match="q1..q21"):
            des._y_ll2_stage(P, q)
        with pytest.raises(ValueError, match="q1..q21"):
            des._uv_ll2_stage(Pm, q)
    u = des._uv_ll2_stage(Pm, 20)
    with pytest.raises(ValueError, match="q1..q21"):
        des._uv_highres_stage(u, u, T.HIGH2)
    with pytest.raises(TypeError):
        des._y_ll2_stage(P.int(), 20)
    with pytest.raises(ValueError):
        des._y_ll2_stage(torch.zeros((1, 256, 256), dtype=torch.int16), 20)
    with pytest.raises(TypeError):
        des._uv_ll2_stage(Pm.int(), 20)
    with pytest.raises(ValueError):
        des._uv_ll2_stage(P, 20)
    with pytest.raises(ValueError):
        des._uv_highres_stage(u, (None, u[1][:, :100]), 20)
