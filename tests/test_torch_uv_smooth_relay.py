"""S14, the chroma LL smoothing (``models/device_scans.uv_ll_smooth_device``,
kernel ``uvs_relay``), on the CPU, tolerance 0.

Its twin (``uv_ll_smooth_ref`` through ``_uvs_relay_ref``) takes the
kernel's static schedule: 128 lanes, a lane a block row, pass 2 on warps 0
and 1, pass 3 on warps 2 and 3 a fixed delay behind, every load a step
ahead from the block as it stood at the last barrier.  It equals the JAX
package's ``uv_ll_smooth_device`` and the host copy's C
``_uv_ll_smooth`` on every ``chip_smoke.UVS_KINDS`` kind at batch 2; the
"pass 3 on pass 2" planes reach what they claim (pass 3's fire on pass
2's write, on rows 31/32 too) and tell a schedule one step short from
the right one; the schedule's constants are ``csrc/vlq.cu``'s.
"""

import re
from pathlib import Path

import numpy as np
import pytest
import torch

import chip_smoke as cs
from nhwcodec_tpu.models import device_scans as jds
from nhwcodec_tpu_torch.models import device_scans as tds

VLQ_CU = (Path(__file__).resolve().parent.parent / "nhwcodec_tpu_torch"
          / "csrc" / "vlq.cu")


@pytest.fixture(autouse=True)
def _one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _cu_constants() -> dict:
    """vlq.cu's S14 constants (constexpr ints named kUvs*), evaluated in
    order."""
    out = {}
    for name, expr in re.findall(r"constexpr int (kUvs\w*) =\s*([^;]+);",
                                 VLQ_CU.read_text()):
        expr = re.sub(r"//[^\n]*", "", expr).replace("/", "//")
        out[name] = eval(expr, {}, dict(out))
    return out


@pytest.mark.parametrize("kind", cs.UVS_KINDS)
def test_uv_smooth_relay_matches_jax_and_host(kind):
    x = cs.uvs_edge_planes(np.random.default_rng(71), 2, kind)
    got = tds.uv_ll_smooth_device(torch.from_numpy(x)).numpy()
    np.testing.assert_array_equal(got, cs.host_uvs(x))
    np.testing.assert_array_equal(got, np.asarray(jds.uv_ll_smooth_device(x)))
    # both passes write the rows on the edge between the warps: row 32
    # (row 31's visits, warp 0's last lane) and row 33 (warp 1's first)
    if kind != "wave left":
        assert (got[:, 32, 1:63] != x[:, 32, 1:63]).any()
        assert (got[:, 33, 1:63] != x[:, 33, 1:63]).any()


def test_pass3_on_pass2_planes_reach_their_claim():
    """Pass 2's visit (R - 1, C - 1) writes 1 at (R, C) (the 6 there);
    pass 3's visit (R - 2, C - 1) then fires, writing 1 at (R - 1, C)
    (the 4 there); on the 6 it would not (|6 - 1| = 5 is not under 5)."""
    x = cs.uvs_edge_planes(np.random.default_rng(72), 2, "pass 3 on pass 2")
    out = cs.host_uvs(x).astype(np.int32) - x[:, :1, :1]
    for g, c in enumerate(cs.UVS_BUMP_COLS):
        for r in cs.UVS_BUMP_ROWS[g % 2]:
            assert (out[:, r - 1, c] == 1).all(), (r, c)


@pytest.mark.parametrize("name, value", [
    ("UVS_DELAY", tds.UVS_DELAY - 1), ("UVS_LAG", tds.UVS_LAG - 1),
    ("UVS_SYNC", 2 * tds.UVS_SYNC)])
def test_a_schedule_one_step_short_reads_stale_values(name, value,
                                                      monkeypatch):
    """The twin's loads see the block as of the last barrier, so a delay
    of pass 3, a lag between the warps or a barrier interval one step
    short of the dependences differs from the C on the "pass 3 on pass 2"
    planes (whose bumps meet every column mod 3 and mod 4) and on smooth
    planes."""
    monkeypatch.setattr(tds, name, value)
    for kind in ("pass 3 on pass 2", "random"):
        x = cs.uvs_edge_planes(np.random.default_rng(73), 2, kind)
        P = torch.from_numpy(x[:, :64, :64].astype(np.int32))
        tds._uvs_relay_ref(P)
        assert (P.numpy() != cs.host_uvs(x)[:, :64, :64]).any(), kind


def test_the_schedule_is_vlq_cu_s():
    k = _cu_constants()
    assert (k["kUvs"], k["kUvsPitch"], k["kUvsWave"], k["kUvsSync"],
            k["kUvsLag"], k["kUvsDelay"], k["kUvsLead"], k["kUvsFront"]) == (
        tds.UVS, tds.UVS_PITCH, tds.UVS_WAVE, tds.UVS_SYNC, tds.UVS_LAG,
        tds.UVS_DELAY, tds.UVS_LEAD, tds.UVS_FRONT)
    assert k["kUvsSteps"] == tds.uvs_steps() == 204
    # the relay walks 204 steps with a barrier every 3, against the old
    # design's 2 x 184 with a barrier each
    assert tds.uvs_steps() // tds.UVS_SYNC == 68
