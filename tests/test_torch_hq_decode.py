"""The HQ residue scatter and the sequential mark-scan fallback of the
port's decode equal the JAX package's and the host decoder's.

Inputs come from numpy seeds; the JAX stages run through their plain
XLA reference (``fused=False``).  Tolerance 0.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import out_of_order_marks
from nhwcodec_tpu.models import decoder
from nhwcodec_tpu.models import device_decode as jdd
from nhwcodec_tpu_torch.models import device_decode as tdd
from nhwcodec_tpu_torch.ops import dwt

N = 512


def _stage_inputs(rng, b):
    # near-flat coefficients, so the 8-neighbour residue stays under 116
    # and the scan smooths cells
    jp = rng.integers(-2, 3, (b, N, N)).astype(np.int16)
    proc = (jp[:, :256, :256] >> 1).astype(np.int16)
    idx = rng.integers(0, N * N, (b, 64)).astype(np.int32)
    dl = rng.integers(-60, 61, (b, 64)).astype(np.int16)
    return jp, proc, idx, dl


def test_y_stage2_seq_matches_jax_scan():
    rng = np.random.default_rng(5)
    b = 2
    jp, proc, idx, dl = _stage_inputs(rng, b)
    # same-row runs in descending column order, cols 1..254: the depth
    # planes refuse them and the scan's live reads chain through each run
    marks = out_of_order_marks(rng, b)
    marks[-1] = marks[-1][:len(marks[-1]) // 2]  # padding records
    assert not tdd.mark_depth_planes(marks)[2]
    recs, valid = tdd.pad_marks(marks)
    assert not valid.all()
    want = np.asarray(jdd.y_stage2_device(
        jnp.asarray(jp), jnp.asarray(proc), jnp.asarray(idx),
        jnp.asarray(dl), jnp.asarray(recs), jnp.asarray(valid),
        fused=False))
    got = tdd.y_stage2_seq(*tdd.front_to_torch("cpu", jp, proc, idx, dl,
                                               recs, valid)).numpy()
    np.testing.assert_array_equal(got, want)
    # the scan did work: with every record padding the image differs
    none = tdd.y_stage2_seq(*tdd.front_to_torch(
        "cpu", jp, proc, idx, dl, recs, np.zeros_like(valid))).numpy()
    assert (none != want).any()


def test_smooth_marks_seq_ref_matches_the_host_loop():
    # the host decoder's per-mark loop (decoder.decode_y_back), live reads
    # in list order; records in both orders of one adjacent run, and at
    # col 0, whose left neighbour is the previous row's last cell
    rng = np.random.default_rng(9)
    x = rng.integers(-12, 13, (1, N, N)).astype(np.int16)
    marks = ([(7 << 8) | c for c in range(20, 26)]
             + [(9 << 8) | c for c in range(31, 25, -1)]
             + [(11 << 8) | 0, (11 << 8) | 255, (254 << 8) | 254])
    want = x[0].reshape(-1).copy()
    for rec in marks:
        scan = ((rec >> 8) << 10) + (rec & 255)
        if abs(decoder._lap8(want, scan, N)) < 116:
            want[scan] = np.int16(
                ((int(want[scan]) << 2) + int(want[scan - 1])
                 + int(want[scan + 1]) + int(want[scan - N])
                 + int(want[scan + N]) + 4) >> 3)
    recs, valid = tdd.pad_marks([marks])
    xt = torch.from_numpy(x.copy())
    got = dwt.smooth_marks_seq(xt, *tdd.front_to_torch("cpu", recs, valid))
    assert got is xt   # in place
    np.testing.assert_array_equal(got.numpy().reshape(-1), want)
    assert (want != x.reshape(-1)).sum() >= len(marks) - 4


def test_hq_scatter_duplicates_wrap():
    # host semantics: int16 np.add.at on the untransposed plane, then the
    # transpose; duplicates accumulate and the sums cross +-32768
    rng = np.random.default_rng(13)
    b = 2
    u = rng.integers(-3000, 3000, (b, N, N)).astype(np.int16)
    u[0, 3, 7] = 32700
    u[1, 400, 2] = -32700
    idx = np.zeros((b, 16), np.int32)     # padding pairs (0, 0) at the end
    dl = np.zeros((b, 16), np.int16)
    idx[0, :6] = [3 * N + 7] * 4 + [N * N - 1, 5]
    dl[0, :6] = [56, 32, -32, 56, 30000, 30000]
    idx[1, :5] = [400 * N + 2] * 3 + [N * N - 1] * 2
    dl[1, :5] = [-56, -56, 32, -32000, -32000]
    want = u.copy()
    for n in range(b):
        np.add.at(want[n].reshape(-1), idx[n], dl[n])
    assert want[0, 3, 7] < 0 and want[1, 400, 2] > 0   # both wrapped
    t = torch.from_numpy(u.transpose(0, 2, 1).copy())
    got = tdd.hq_scatter_t(t, torch.from_numpy(idx), torch.from_numpy(dl))
    np.testing.assert_array_equal(got.numpy(), want.transpose(0, 2, 1))
    jax_flat = jdd._scatter_add(jnp.asarray(u.reshape(b, -1)),
                                jnp.asarray(idx), jnp.asarray(dl))
    np.testing.assert_array_equal(np.asarray(jax_flat).reshape(b, N, N),
                                  want)


@pytest.mark.parametrize("bad", [N * N, -1])
def test_hq_index_out_of_range_raises_on_the_host(bad, monkeypatch):
    pairs = [(np.array([5, 9], np.int64), np.array([1, 1], np.int16)),
             (np.array([5, bad], np.int64), np.array([1, 1], np.int16))]
    with pytest.raises(ValueError, match="HQ index"):
        tdd.pad_hq(pairs)
    # and through the decode, before anything reaches the device
    from nhwcodec_tpu.models import encoder
    from nhwcodec_tpu.utils import fixtures

    front = decoder.decode_y_front

    def bad_front(s, res_comp):
        jpeg, scat, _ = front(s, res_comp)
        return jpeg, scat, pairs[1]

    monkeypatch.setattr(decoder, "decode_y_front", bad_front)
    with pytest.raises(ValueError, match="HQ index"):
        tdd.decode_batch_device([encoder.encode(fixtures.gradient_circles(),
                                                22)], device="cpu")
