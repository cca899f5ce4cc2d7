"""E2's twin in the cluster kernel's decomposition (the per-chunk skip of
chunks whose in-carry stands, the relay's prefix taken within each CTA's
block of chunks plus the blocks before) against the JAX package's
``_runs_fixpoint``: e_in, ev1, ev2 and the sweep count, tolerance 0.

On ``chip_smoke.e2_edge_tuples`` (random runs, pinned tails, a carry
through every chunk, the k + 1 cap, runs past the plane) at k = 1, 2, 7
and 37 chunks, on random streams longer than a cluster stages (k =
1024), and on small real streams at k = 37 and 100 (not powers of
two).  The launch shape (``fixpoint_layout``) against the constants
of ``csrc/entropy.cu``.  XLA:CPU compiles the fixpoint in a few seconds a
shape.
"""

import functools
import re
from pathlib import Path

import numpy as np
import pytest
import torch

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import chip_smoke as cs  # noqa: E402
from nhwcodec_tpu.models import encoder  # noqa: E402
from nhwcodec_tpu.ops import entropy_decode_device as jedd  # noqa: E402
from nhwcodec_tpu.utils import container, fixtures  # noqa: E402
from nhwcodec_tpu_torch.ops import entropy_decode_device as edd  # noqa: E402

P1 = edd.Y_P1
ENTROPY_CU = (Path(edd.__file__).resolve().parent.parent / "csrc"
              / "entropy.cu")


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    threads = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(threads)


def _unpacked(ebase, fields):
    """The port's (ebase, fields) as the JAX package's 7-tuple."""
    f = edd.unpack_run_fields(fields)
    return tuple(jnp.asarray(a) for a in (
        f["rle"].numpy(), ebase.numpy(), f["segm"].numpy(),
        f["segc"].numpy(), f["prev_run"].numpy(),
        f["prev_lit_mem2"].numpy(), f["valid"].numpy()))


def _against_jax(ebase, fields, k):
    """The twin's (e_in, flags, sweeps) after checking them against
    ``_runs_fixpoint`` on the same tuples."""
    got_e, got_f, sweeps = edd.runs_fixpoint(ebase, fields, P1, k)
    (_, ev1, ev2, e_in), iters = jedd._runs_fixpoint(
        _unpacked(ebase, fields), P1, k)
    np.testing.assert_array_equal(got_e.numpy(), np.asarray(e_in))
    np.testing.assert_array_equal((got_f & 1).numpy() == 1, np.asarray(ev1))
    np.testing.assert_array_equal((got_f >> 1).numpy() == 1,
                                  np.asarray(ev2))
    assert int(sweeps.max()) == int(iters)
    return got_e, got_f, sweeps


@pytest.mark.parametrize("k", [1, 2, 7, 37])
@pytest.mark.parametrize("kind", cs.E2_EDGE_KINDS)
def test_fixpoint_twin_on_edge_tuples(kind, k):
    eb, f = cs.e2_edge_tuples(np.random.default_rng(70 + k), 3, k, 20, kind)
    _, flags, sweeps = _against_jax(torch.from_numpy(eb),
                                    torch.from_numpy(f), k)
    if kind == "k + 1 sweeps" or k == 1:
        # at k = 1 the one chunk's run_over floor changes after sweep 1
        assert sweeps.tolist() == [k + 1] * 3
    elif kind == "carry through every chunk":
        assert sweeps.tolist() == [k] * 3
    if kind in ("random", "past the plane"):
        assert int((flags != 0).sum()) > 0


@functools.lru_cache(maxsize=None)
def _stream(name: str, q: int):
    return container.parse_nhw(encoder.encode(getattr(fixtures, name)(), q))


@pytest.mark.parametrize("k", [37, 100])
def test_fixpoint_twin_on_real_streams_at_odd_k(k):
    """A short stream (near-flat, its later chunks pinned padding) beside
    a long one, at k not a power of two; the ys equal k = 1's."""
    streams = [_stream(g, 20) for g in ("near_flat", "gradient_circles")]
    syms, book, r_max = edd._y_run_inputs(streams, P1, "cpu")
    xs, _ = edd._runs_xs_batch(syms, book, P1, r_max, k)
    e_k, f_k, sweeps = _against_jax(*xs, k)
    length = xs[0].shape[0]
    pinned = ~(xs[0].reshape(length, 2, k) < P1 - 1).any(0)
    assert bool(pinned[0].any()) and 1 < int(sweeps.max()) <= k
    xs1, _ = edd._runs_xs_batch(syms, book, P1, r_max, 1)
    _, f_1, _ = edd.runs_fixpoint(*xs1, P1, 1)
    np.testing.assert_array_equal(cs.per_stream(f_k, 2)[:, :r_max].numpy(),
                                  cs.per_stream(f_1, 2)[:, :r_max].numpy())


def _cu_int(name: str) -> str:
    m = re.search(rf"constexpr int {name} = ([^;]+);", ENTROPY_CU.read_text())
    assert m, name
    return m.group(1)


def test_fixpoint_layout_matches_the_kernel():
    """FIX_CLUSTER and FIX_SMEM are the kernel's; every k up to MAX_CHUNKS
    has at most kFixThreads chunks a CTA, every chunk a CTA of the
    cluster, and the staged rows fit."""
    assert int(_cu_int("kFixCluster")) == edd.FIX_CLUSTER
    assert eval(_cu_int("kFixSmemMax")) == edd.FIX_SMEM
    assert int(_cu_int("kMaxChunks")) == edd.MAX_CHUNKS
    threads = int(_cu_int("kFixThreads"))
    for k in range(1, edd.MAX_CHUNKS + 1):
        for length in (1, 77, 1217, 28160, 80000):
            cluster, cpc, rows = edd.fixpoint_layout(length, k)
            assert cluster == min(k, edd.FIX_CLUSTER)
            # the chunks fill the CTAs in order; CTAs past the last chunk
            # (k = 9: ranks 5-7) hold none and only relay
            assert cpc <= threads and cluster * cpc >= k
            assert -(-k // cpc) <= cluster and (k - 1) // cpc < cluster
            assert rows == min(length, edd.FIX_SMEM // (8 * cpc))
            assert 8 * rows * cpc <= edd.FIX_SMEM
    # the k = 1 fallback's one CTA and chip_smoke's long streams read
    # their last rows from global memory
    assert edd.fixpoint_layout(77859, 1)[2] == 28160
    k, length = cs.E2_LONG
    assert edd.fixpoint_layout(length, k) == (8, 128, 220)


def test_fixpoint_twin_on_a_stream_longer_than_the_staging():
    """Random tuples at chip_smoke.E2_LONG (k = 1024, 256 runs a chunk:
    past what a cluster stages) against JAX."""
    k, length = cs.E2_LONG
    eb, f = cs.e2_edge_tuples(np.random.default_rng(77), 2, k, length,
                              "random")
    _, flags, sweeps = _against_jax(torch.from_numpy(eb),
                                    torch.from_numpy(f), k)
    assert int((flags != 0).sum()) > 0 and int(sweeps.max()) > 2
