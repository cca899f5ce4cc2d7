"""Device times of the port's S1 (snap passes), S2 (offset_y), S5 (column
ladder), S6 (classify), S7 (ll2_code_y) and S9 (uv_sentinel) on the q20
batch, for one tree of the repo, and the split of a kernel of S2, S5, S7
or S9 between its phases.

Run from anywhere on a machine with a CUDA card:

    python3 tools/torch_scan_probe.py [--tree DIR] [--ladder-src FILE]
        [--offset-y-src FILE] [--uv-src FILE] [--ll2-src FILE] [--runs N]

``--tree`` is the root of the tree whose ``nhwcodec_tpu_torch`` and
``chip_smoke`` are measured (default: this script's repo).  The inputs
are the tree's own: ``chip_smoke``'s 16 encode images, their host
encodes at q20 captured by ``chip_smoke.StreamCapture``; S1 runs on the
captured Y planes before the snap passes, S2 on their output (the three
variants in turn), S5 on pair promotion's output of the captured E11
planes, S6 on the column ladder's output.  Times are CUDA events around
replays of a CUDA graph of 20 calls (``chip_smoke.graph_ms``): the three
snap variants as three ``snap_pass_device`` calls, and, where the tree has
``snap_passes_device``, as one call; ``offset_y_device`` (and, where the
tree has ``offset_y_sweeps``, the sweeps of its passes 2-3 per image);
``column_ladder_device``; ``classify_device``.

``--ladder-src`` takes a ``residue.cu`` of either column-ladder design,
patches ``%globaltimer`` stamps into a copy, builds it with ``nvcc`` for
sm_90a into a temporary directory, checks its output against the tree's
``column_ladder_device`` and reports per CTA, in µs from the CTA's start
(medians over CTAs and runs):

- one CTA an image (a thread a column, column 255 again after a block
  barrier): the end of the walk of columns 0..254 (with the copy of what
  the ladder leaves), of the barrier and its staging, of column 255's
  walk;
- 8 CTAs an image (``ladder_table`` first): the end of the staging, of
  the walk of the CTA's block (CTA 0 and the others apart), the start
  and end of column 255's walk in CTA 0, the write-back's start.

``--offset-y-src`` takes a ``scans.cu`` of the banded passes 2-3 (a
cluster of 8 CTAs an image, ``offset_y_bands``), patches stamps into a
copy the same way, checks its output against the tree's
``offset_y_device`` and reports, per CTA in µs from its start (medians
over CTAs and runs), the end of the staging with the range tests, of the
first sweep and of the kernel, on the snapped q20 planes and on
``chip_smoke.offset_y_relay_edge_planes`` (16 sweeps), with each input's
sweeps.

``--uv-src`` takes a ``uv.cu`` of either S9 design and ``--ll2-src`` an
``ll2.cu`` of either S7 design; each is stamped the same way, checked
against the tree's ``uv_sentinel_marking_device`` / ``ll2_code_y_scan``
and reported per CTA in µs from its start (medians over CTAs and runs):

- S9, one CTA an image (the rows in order): the end of the LL quadrant's
  copy, of row 0 and of the kernel;
- S9, a cluster of 8 CTAs an image (``uv_sentinel_rows``): the end of the
  staging, of the first round (its drifts exchanged) and of the kernel,
  and the mean cycles of a row's walk again (its SM's clock) and the walks
  again a CTA;
- S7, one CTA an image: the end of the marking and of the nudge scan;
- S7, a cluster of 8 CTAs an image (``ll2_code_y_bands``): the end of the
  staging, of the marking (with the cross-row tests), of the first sweep
  and of the kernel;

on the captured q20 planes (U and V for S9) and on the edge inputs that
take the most sweeps (``chip_smoke.uv_sentinel_edge_inputs`` "drift" and
"cta edges", ``chip_smoke.ll2_edge_planes`` "band edges"), with each
input's sweeps where the tree has ``uv_sentinel_sweeps`` /
``ll2_code_y_sweeps``.  Without the options, the JSON line also holds the
tree's S9 (U, V) and S7 (gt_low3 on) graph times on the q20 planes.

Prints the card's name and power limit, then one JSON line.
"""

from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

import numpy as np

REPO = Path(__file__).resolve().parent.parent
STAMPS = 8

STAMP_DEFS = r"""
__device__ unsigned long long g_ladder_stamp[65536 * 8];
__device__ __forceinline__ unsigned long long nhw_now() {
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  return t;
}
#define NHW_STAMP(k)                                                    \
  (g_ladder_stamp[(blockIdx.y * gridDim.x + blockIdx.x) * 8 + (k)] = \
       nhw_now())
"""

# (anchor, text inserted before it, text inserted after it)
ONE_CTA_PATCHES = (
    ("  // what the ladder leaves: rows 257..511, row 256's right half, "
     "column 511\n",
     "  if (threadIdx.x == 0) NHW_STAMP(0);\n", ""),
    ("    InputSrc src{p, rf, j};\n    ladder_walk(j, p, src, o, ro, f);\n",
     "", "    atomicMax(&g_ladder_stamp[blockIdx.x * 8 + 1], nhw_now());\n"),
    ("    Col255Src src{s_v2, s_rf, s_bnd, s_c256, s_rf0};\n"
     "    ladder_walk(c, p, src, o, ro, f);\n",
     "    NHW_STAMP(2);\n", "    NHW_STAMP(3);\n"),
)
BLOCK_PATCHES = (
    ("  volatile int* progress = reinterpret_cast<volatile int*>(lsm + "
     "kLProgress);\n", "", "  if (t == 0) NHW_STAMP(0);\n"),
    ("  if (w == 0) {\n    BlockSrc src{lsm, lane, blk == 0 ? progress : "
     "nullptr};\n    ladder_walk(src, tab_s);\n",
     "  if (t == 0) NHW_STAMP(1);\n", "    if (lane == 0) NHW_STAMP(2);\n"),
    ("      Col255Src src{lsm, progress};\n      ladder_walk(src, tab_s);\n",
     "      NHW_STAMP(3);\n", "      NHW_STAMP(4);\n"),
    ("  for (int i = t; i < kLPfRows * kLBlock; i += kLThreads) {\n",
     "  if (t == 0) NHW_STAMP(5);\n", ""),
)

OFFSET_Y_PATCHES = (
    ("  const int r0 = rank * kOyRows;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  cluster.sync();        // staged, every peer started\n",
     "  __syncthreads();\n  if (t == 0) NHW_STAMP(1);\n", ""),
    ("    pend = offset_y_band(st.rows, st.flags, st.tab, band_img, br, lane, "
     "0);\n", "",
     "  if (lane == 0)\n    atomicMax(&g_ladder_stamp[(blockIdx.y * gridDim.x "
     "+ blockIdx.x) * 8 + 2], nhw_now());\n"),
    ("  // row 255's vertical writes land in plane row 256\n",
     "  __syncthreads();\n  if (t == 0) NHW_STAMP(3);\n", ""),
)

# S9: a cluster of 8 CTAs an image; stamps 4 and 5 sum the cycles and the
# count of the rows' walks after the first
UV_ROWS_PATCHES = (
    ("  const size_t img = static_cast<size_t>(blockIdx.y) * kPlane;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  cluster.sync();        // staged, every peer started\n",
     "", "  if (t == 0) NHW_STAMP(1);\n"),
    ("    cluster.sync();\n    uint32_t bits[4];\n",
     "", "    if (s == 0 && t == 0) NHW_STAMP(2);\n"),
    ("        drift = uv_row(st.rf, k * kLanes + drifts, lane, res_uv, v);"
     "\n", "        const long long c0 = clock64();\n",
     "        if (lane == 0) {\n          unsigned long long* base = "
     "g_ladder_stamp + (blockIdx.y * gridDim.x + blockIdx.x) * 8;\n"
     "          atomicAdd(base + 4, "
     "static_cast<unsigned long long>(clock64() - c0));\n"
     "          atomicAdd(base + 5, 1ull);\n"
     "        }\n"),
    ("  int16_t* o = out + img;\n", "  if (t == 0) NHW_STAMP(3);\n", ""),
)
# S9: one CTA an image, the rows in order
UV_ONE_CTA_PATCHES = (
    ("  int16_t* o = out + static_cast<size_t>(blockIdx.x) * kPlane;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  if (j == 0) fire_s[0] = 0;\n",
     "", "  __syncthreads();\n  if (j == 0) NHW_STAMP(1);\n"),
    ("    count_start += kLanes + drift;\n  }\n",
     "    if (r == 0 && j == 0) NHW_STAMP(2);\n",
     "  if (j == 0) NHW_STAMP(3);\n"),
)
# S7: a cluster of 8 CTAs an image (stamp 4: the marking's end)
LL2_BANDS_PATCHES = (
    ("  const int r0 = rank * kYRows;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  const int gt = gt_low3 != 0;\n", "  if (t == 0) NHW_STAMP(1);\n", ""),
    ("  cluster.sync();        // staged and marked, every peer started\n",
     "", "  if (t == 0) NHW_STAMP(4);\n"),
    ("    const uint4 flags = ",
     "    if (s == 0 && t == 0) NHW_STAMP(2);\n", ""),
    ("  const size_t at = static_cast<size_t>(blockIdx.y) * kLLN + r0 * kLL;"
     "\n", "  if (t == 0) NHW_STAMP(3);\n", ""),
)
# S7: one CTA an image, the rows in order
LL2_ONE_CTA_PATCHES = (
    ("  uint8_t* io = is24 + static_cast<size_t>(blockIdx.x) * kLLN;\n",
     "", "  if (threadIdx.x == 0) NHW_STAMP(0);\n"),
    ("  if (t == 0) fire_s[0] = 0;\n  __syncthreads();\n",
     "", "  if (t == 0) NHW_STAMP(4);\n"),
    ("    io[r * kLL + j] = hi;\n  }\n",
     "", "  __syncthreads();\n  if (j == 0) NHW_STAMP(3);\n"),
)

STAMP_API = r"""
extern "C" int nhw_ladder_stamps(void* dst, int n, int reset) {
  if (reset) {
    static unsigned long long zero[65536 * 8];
    return cudaMemcpyToSymbol(g_ladder_stamp, zero, sizeof(zero));
  }
  return cudaMemcpyFromSymbol(dst, g_ladder_stamp,
                              sizeof(unsigned long long) * 8 * n);
}
"""


def blocks(src: str) -> bool:
    """Whether a residue.cu is the 8-CTAs-an-image design."""
    return "ladder_table" in src


def patch_stamps(src: str, patches) -> str:
    """A stamped copy of a kernel source: ``patches`` of (anchor, text
    before it, text after it)."""
    at = src.index("namespace {")
    src = src[:at] + STAMP_DEFS + src[at:]
    for anchor, before, after in patches:
        if src.count(anchor) != 1:
            raise SystemExit(f"torch_scan_probe: anchor not found once in "
                             f"the ladder source: {anchor!r}")
        src = src.replace(anchor, before + anchor + after)
    return src + STAMP_API


def build_stamped(src_path: Path, out_dir: Path, patches):
    """The stamped library of a kernel source."""
    from torch.utils.cpp_extension import CUDA_HOME

    cu = out_dir / f"{src_path.stem}_stamped.cu"
    cu.write_text(patch_stamps(src_path.read_text(), patches))
    lib = out_dir / f"lib{src_path.stem}_stamped.so"
    nvcc = str(Path(CUDA_HOME) / "bin" / "nvcc") if CUDA_HOME else "nvcc"
    subprocess.run([nvcc, "-gencode", "arch=compute_90a,code=sm_90a",
                    "-std=c++17", "-O3", "-shared", "-Xcompiler", "-fPIC",
                    "-I", str(src_path.parent), str(cu), "-o", str(lib)],
                   check=True)
    dll = ctypes.CDLL(str(lib))
    dll.nhw_ladder_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int,
                                      ctypes.c_int]
    dll.nhw_ladder_stamps.restype = ctypes.c_int
    return dll


def build_ladder(src_path: Path, out_dir: Path):
    """(the stamped column-ladder library, whether it is the 8-CTA
    design)."""
    new = blocks(src_path.read_text())
    dll = build_stamped(src_path, out_dir,
                        BLOCK_PATCHES if new else ONE_CTA_PATCHES)
    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_column_ladder.argtypes = [p] * (5 if new else 4) + [i] * 5 + [p]
    dll.nhw_column_ladder.restype = i
    return dll, new


def stamp_runs(dll, call, ctas: int, runs: int) -> np.ndarray:
    """(runs, ctas, STAMPS) µs from each CTA's first stamp."""
    import torch

    per_run = []
    stamps = np.zeros((ctas, STAMPS), np.uint64)
    for _ in range(runs):
        dll.nhw_ladder_stamps(None, ctas, 1)
        call()
        torch.cuda.synchronize()
        dll.nhw_ladder_stamps(stamps.ctypes.data, ctas, 0)
        s = stamps.astype(np.int64)
        per_run.append((s - s[:, :1]) / 1e3)
    return np.stack(per_run)


def raw_stamps(dll, call, ctas: int, runs: int) -> np.ndarray:
    """(runs, ctas, STAMPS) as the kernel left them (accumulators too)."""
    import torch

    out = []
    stamps = np.zeros((ctas, STAMPS), np.uint64)
    for _ in range(runs):
        dll.nhw_ladder_stamps(None, ctas, 1)
        call()
        torch.cuda.synchronize()
        dll.nhw_ladder_stamps(stamps.ctypes.data, ctas, 0)
        out.append(stamps.astype(np.int64))
    return np.stack(out)


def since_start(t: np.ndarray, k: int) -> float:
    """The median over runs and CTAs of stamp k in µs from stamp 0, over
    the CTAs that set it."""
    d = (t[..., k] - t[..., 0]) / 1e3
    d = d[t[..., k] > 0]
    return float(np.median(d)) if d.size else None


def uv_split(dll, rows: bool, inputs: dict, runs: int, cs) -> dict:
    """The stamped S9 on each input (process, rf_ext, res_uv): its output
    against the tree's uv_sentinel_marking_device, the sweeps, the stamps'
    medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_uv_sentinel.argtypes = [p, p, p, i, i, i, p]
    dll.nhw_uv_sentinel.restype = i
    out = {}
    for what, (x, rf, res_uv) in inputs.items():
        got = torch.empty_like(x)
        b = x.shape[0]

        def call():
            rc = dll.nhw_uv_sentinel(x.data_ptr(), rf.data_ptr(),
                                     got.data_ptr(), b, rf.shape[1], res_uv,
                                     torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.uv_sentinel_marking_device(x, rf,
                                                                res_uv)),
                 "the stamped uv_sentinel differs from the tree's")
        t = raw_stamps(dll, call, 8 * b if rows else b, runs)
        res = {"staged_us": since_start(t, 1),
               "first_us": since_start(t, 2), "end_us": since_start(t, 3),
               "ctas": int(t.shape[1]), "runs": runs,
               "event_ms": cs.median_ms(call)}
        if rows:
            walks = t[..., 5].sum()
            res["walk_again_cycles"] = (float(t[..., 4].sum() / walks)
                                        if walks else None)
            res["walks_again_per_cta"] = float(walks / t[..., 5].size)
        if hasattr(ds, "uv_sentinel_sweeps"):
            res["sweeps"] = ds.uv_sentinel_sweeps(x, rf, res_uv).tolist()
        out[what] = res
    return out


def ll2_split(dll, bands: bool, planes: dict, runs: int, cs) -> dict:
    """The stamped S7 on each plane (gt_low3 on): its output against the
    tree's ll2_code_y_scan, the sweeps, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_ll2_code_y.argtypes = [p, p, p, i, i, p]
    dll.nhw_ll2_code_y.restype = i
    out = {}
    for what, x in planes.items():
        b = x.shape[0]
        vem = torch.empty((b, 16384), dtype=torch.int32, device=x.device)
        is24 = torch.empty((b, 16384), dtype=torch.bool, device=x.device)

        def call():
            rc = dll.nhw_ll2_code_y(x.data_ptr(), vem.data_ptr(),
                                    is24.data_ptr(), b, 1,
                                    torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        want = ds.ll2_code_y_scan(x, True)
        cs.check(torch.equal(vem, want[0]) and torch.equal(is24, want[1]),
                 "the stamped ll2_code_y differs from the tree's")
        t = raw_stamps(dll, call, 8 * b if bands else b, runs)
        res = {"marked_us": since_start(t, 4), "end_us": since_start(t, 3),
               "ctas": int(t.shape[1]), "runs": runs,
               "event_ms": cs.median_ms(call)}
        if bands:
            res["staged_us"] = since_start(t, 1)
            res["first_sweep_us"] = since_start(t, 2)
        if hasattr(ds, "ll2_code_y_sweeps"):
            res["sweeps"] = ds.ll2_code_y_sweeps(x, True).tolist()
        out[what] = res
    return out


def build_design(src_path: Path, out_dir: Path, marker: str, new_patches,
                 old_patches):
    """(the stamped library of either design of a kernel source, whether
    it is the cluster design: ``marker`` in it)."""
    new = marker in src_path.read_text()
    return build_stamped(src_path, out_dir, new_patches if new
                         else old_patches), new


def offset_y_split(dll, planes: dict, runs: int, cs) -> dict:
    """The stamped passes 2-3 on each input: output against the tree's
    offset_y_device, the sweeps, the stamps' medians."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    p, i = ctypes.c_void_p, ctypes.c_int
    dll.nhw_offset_y.argtypes = [p, p, p, p, i, i, p]
    dll.nhw_offset_y.restype = i
    out = {}
    for what, x in planes.items():
        tmp, got = torch.empty_like(x), torch.empty_like(x)
        esc = ds._escape_table(x.device)

        def call():
            rc = dll.nhw_offset_y(x.data_ptr(), tmp.data_ptr(),
                                  got.data_ptr(), esc.data_ptr(), x.shape[0],
                                  8, torch.cuda.current_stream().cuda_stream)
            if rc:
                raise SystemExit(f"torch_scan_probe: stamped launch failed "
                                 f"{rc}")

        call()
        torch.cuda.synchronize()
        cs.check(torch.equal(got, ds.offset_y_device(x, 8)),
                 "the stamped offset_y differs from the tree's")
        t = stamp_runs(dll, call, 8 * x.shape[0], runs)
        med = lambda v: float(np.median(v))             # noqa: E731
        out[what] = {"sweeps": ds.offset_y_sweeps(x).tolist(),
                     "staged_us": med(t[..., 1]),
                     "first_sweep_us": med(t[..., 2]),
                     "end_us": med(t[..., 3]), "ctas": 8 * x.shape[0],
                     "runs": runs}
    return out


def ladder_split(dll, new: bool, pp, rf_ext, flags, rs, runs: int,
                 cs) -> dict:
    """Run the stamped kernel ``runs`` times on (pp, rf_ext): its output
    against the tree's, and the per-CTA phase times."""
    import torch

    from nhwcodec_tpu_torch.models import device_scans as ds

    b = pp.shape[0]
    ctas = 8 * b if new else b
    out = torch.empty_like(pp)
    rf = torch.empty((b, 65536), dtype=torch.int16, device=pp.device)
    tab = torch.empty(17 * 15 * 12 * 16, dtype=torch.int16, device=pp.device)

    def call():
        stream = torch.cuda.current_stream().cuda_stream
        ptrs = [pp.data_ptr(), rf_ext.data_ptr(), out.data_ptr(),
                rf.data_ptr()] + ([tab.data_ptr()] if new else [])
        rc = dll.nhw_column_ladder(*ptrs, b, *flags, rs, stream)
        if rc:
            raise SystemExit(f"torch_scan_probe: stamped launch failed {rc}")

    call()
    torch.cuda.synchronize()
    want_p, want_rf = ds.column_ladder_device(pp, rf_ext, 20, rs)
    cs.check(torch.equal(out, want_p) and torch.equal(rf, want_rf),
             "the stamped ladder differs from the tree's column_ladder")
    t = stamp_runs(dll, call, ctas, runs)               # (runs, ctas, 8)
    med = lambda v: float(np.median(v))                 # noqa: E731
    if not new:
        return {"design": "one CTA an image", "walk_end_us": med(t[..., 1]),
                "barrier_end_us": med(t[..., 2]),
                "tail_end_us": med(t[..., 3]),
                "tail_us": med(t[..., 3] - t[..., 2]), "ctas": ctas,
                "runs": runs, "event_ms": cs.median_ms(call)}
    cta0, rest = t[:, ::8], np.concatenate([t[:, k::8] for k in range(1, 8)],
                                           1)
    return {"design": "8 CTAs an image", "staged_us": med(t[..., 1]),
            "walk_end_us": med(rest[..., 2]),
            "cta0_walk_end_us": med(cta0[..., 2]),
            "col255_start_us": med(cta0[..., 3]),
            "col255_end_us": med(cta0[..., 4]),
            "write_back_start_us": med(t[..., 5]),
            "last_write_back_start_us": med(t[..., 5].max(-1)),
            "ctas": ctas, "runs": runs, "event_ms": cs.median_ms(call)}


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--tree", default=str(REPO))
    ap.add_argument("--ladder-src", default=None)
    ap.add_argument("--offset-y-src", default=None)
    ap.add_argument("--uv-src", default=None)
    ap.add_argument("--ll2-src", default=None)
    ap.add_argument("--runs", type=int, default=25)
    args = ap.parse_args()
    tree = Path(args.tree).resolve()
    sys.path.insert(0, str(tree))
    import torch

    if not torch.cuda.is_available():
        print("torch_scan_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nhwcodec_tpu_torch.host.models import encoder as host_encoder
    from nhwcodec_tpu_torch.models import device_encode_scans as des
    from nhwcodec_tpu_torch.models import device_scans as ds

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    images = cs.encode_images(np.random.default_rng(cs.SEED))
    with cs.StreamCapture() as cap:
        for img in images:
            host_encoder.encode(img, 20)
    st = cs.stack_records(cap.records)
    y = torch.from_numpy(st["y"]).to(dev)
    e11, res256, khead, resIII = cs.residue_inputs(st, dev)
    pp = ds.pair_promotion_device(e11)
    rf_ext = des._rf_ext(res256, khead, resIII)
    rs = host_encoder._res_setting(20)
    variants = des.snap_args(20)
    out = {"tree": str(tree), "batch": len(images)}
    out["snap_three_calls_graph_ms"] = cs.graph_ms(
        lambda: [ds.snap_pass_device(y, *a) for a in variants])
    if hasattr(ds, "snap_passes_device"):
        out["snap_one_call_graph_ms"] = cs.graph_ms(
            lambda: ds.snap_passes_device(y, variants))
    out["column_ladder_graph_ms"] = cs.graph_ms(
        lambda: ds.column_ladder_device(pp, rf_ext, 20, rs))
    lp, lrf = ds.column_ladder_device(pp, rf_ext, 20, rs)
    lrf = lrf.reshape(-1, 256, 256)
    out["classify_graph_ms"] = cs.graph_ms(
        lambda: ds.classify_device(lp, lrf, 20, rs))
    snapped = y
    for a in variants:
        snapped = ds.snap_pass_device(snapped, *a)
    out["offset_y_graph_ms"] = cs.graph_ms(
        lambda: ds.offset_y_device(snapped, 8))
    if hasattr(ds, "offset_y_sweeps"):
        out["offset_y_sweeps"] = ds.offset_y_sweeps(snapped).tolist()
    sm = cs.stack_uv(cap.records)["sm"]
    uv = {f"q20 {'UV'[c]} planes": tuple(
        torch.from_numpy(np.ascontiguousarray(a)).to(dev) for a in x[:2])
        + (x[2],) for c, x in enumerate(sm)}
    for what, (x, rf, res_uv) in uv.items():
        out[f"uv_sentinel_graph_ms {what}"] = cs.graph_ms(
            lambda: ds.uv_sentinel_marking_device(x, rf, res_uv))
        if hasattr(ds, "uv_sentinel_sweeps"):
            out[f"uv_sentinel_sweeps {what}"] = ds.uv_sentinel_sweeps(
                x, rf, res_uv).tolist()
    ll2 = torch.from_numpy(cs.stack_ll2(cap.records, 20)["P"]).to(dev)
    out["ll2_code_y_graph_ms"] = cs.graph_ms(
        lambda: ds.ll2_code_y_scan(ll2, True))
    if hasattr(ds, "ll2_code_y_sweeps"):
        out["ll2_code_y_sweeps"] = ds.ll2_code_y_sweeps(ll2, True).tolist()
    if args.uv_src:
        rng = np.random.default_rng(cs.SEED + 60)
        for kind in ("drift", "cta edges"):
            x, rf = cs.uv_sentinel_edge_inputs(rng, len(images), kind)
            uv[f"{kind} planes"] = (torch.from_numpy(x).to(dev),
                                    torch.from_numpy(rf).to(dev), 4)
        with tempfile.TemporaryDirectory() as d:
            dll, rows = build_design(Path(args.uv_src).resolve(), Path(d),
                                     "uv_sentinel_rows", UV_ROWS_PATCHES,
                                     UV_ONE_CTA_PATCHES)
            out["uv_split"] = uv_split(dll, rows, uv, args.runs, cs)
    if args.ll2_src:
        rng = np.random.default_rng(cs.SEED + 50)
        planes = {"q20 LL2 planes": ll2, "band edge planes": torch.from_numpy(
            cs.ll2_edge_planes(rng, len(images), "band edges")).to(dev)}
        with tempfile.TemporaryDirectory() as d:
            dll, bands = build_design(Path(args.ll2_src).resolve(), Path(d),
                                      "ll2_code_y_bands", LL2_BANDS_PATCHES,
                                      LL2_ONE_CTA_PATCHES)
            out["ll2_split"] = ll2_split(dll, bands, planes, args.runs, cs)
    if args.ladder_src:
        with tempfile.TemporaryDirectory() as d:
            dll, new = build_ladder(Path(args.ladder_src).resolve(),
                                    Path(d))
            flags = [int(x) for x in ds._ladder_flags(20, rs)[:3]]
            out["ladder_split"] = ladder_split(dll, new, pp, rf_ext, flags,
                                               rs, args.runs, cs)
    if args.offset_y_src:
        rng = np.random.default_rng(cs.SEED + 30)
        relay = torch.from_numpy(cs.offset_y_relay_edge_planes(
            rng, len(images))).to(dev)
        with tempfile.TemporaryDirectory() as d:
            dll = build_stamped(Path(args.offset_y_src).resolve(), Path(d),
                                OFFSET_Y_PATCHES)
            out["offset_y_split"] = offset_y_split(
                dll, {"q20 snapped planes": snapped, "relay edge planes":
                      relay}, args.runs, cs)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
