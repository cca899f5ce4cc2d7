"""Build and load the port's CUDA kernels (``csrc/*.cu``).

``nvcc`` compiles each ``csrc/*.cu`` to an object for ``sm_90a``
(Hopper), one process per source, all started together, and links the
objects into one shared library with a plain C interface, at first use.
The library lands in ``build/nhwcodec_tpu_torch/<hash>/libnhw_kernels.so``
beside the package, keyed by a hash of the sources and flags, and is
loaded with ``ctypes``.  Every C entry point returns
``cudaGetLastError()``; ``check`` turns a non-zero code into an
exception.  A failed build raises with the compiler's output.  Nothing
here runs at import time.

``LAUNCHES`` counts kernel launches per wrapper: each wrapper in
``ops/`` adds one where it launches its kernel, and nowhere else.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

PKG = Path(__file__).resolve().parent.parent
CSRC = PKG / "csrc"
BUILD_DIR = PKG.parent / "build" / "nhwcodec_tpu_torch"
LIB_NAME = "libnhw_kernels.so"
ARCH = ["-gencode", "arch=compute_90a,code=sm_90a"]
NVCC_FLAGS = [*ARCH, "-std=c++17", "-O3", "-Xcompiler", "-fPIC", "-Xptxas",
              "-v"]

_P, _I = ctypes.c_void_p, ctypes.c_int
# name -> argtypes; pointers and the stream are c_void_p, ints c_int
SIGNATURES = {
    # (x, plane_stride, row_stride, out, batch, n, stream)
    "nhw_synth_level": [_P, _I, _I, _P, _I, _I, _P],
    # (jp, depth, out, batch, n_waves, stream)
    "nhw_y_stage2_full": [_P, _P, _P, _I, _I, _P],
    # (x, out, batch, stream)
    "nhw_uv_synth": [_P, _P, _I, _P],
    # (kernel: 0 K2, 1 K3, 2-4 K4, 5-7 K10 and 8-10 K1 at n = 512, 256,
    #  128; int32[3] out: registers, shared bytes per CTA, most resident
    #  clusters)
    "nhw_cluster_info": [_I, _P],
    # (x, x_plane, x_row, j, j_plane, j_row, p, p_plane, p_row, batch, n,
    #  stream)
    "nhw_analysis_level_jp": [_P, _I, _I, _P, _I, _I, _P, _I, _I, _I, _I,
                              _P],
    # (x, x_plane, x_row, out, out_plane, out_row, batch, n, stream)
    "nhw_analysis_level": [_P, _I, _I, _P, _I, _I, _I, _I, _P],
    # (jpeg, process, res256, res_clean, scratch, batch, stream)
    "nhw_requant_tail": [_P, _P, _P, _P, _P, _I, _P],
    # (rgb, y, u, v, batch, stream)
    "nhw_colorspace_down420": [_P, _P, _P, _P, _I, _P],
    # (rgb, y, u, v, n_pixels, stream)
    "nhw_rgb_to_yuv_full": [_P, _P, _P, _P, _I, _P],
    # (x, plane_stride, row_stride, out, batch, n, stream)
    "nhw_synth_unnorm_rows_t": [_P, _I, _I, _P, _I, _I, _P],
    # (t, depth, out, batch, n_waves, stream)
    "nhw_synth_norm_rows_clip_waves": [_P, _P, _P, _I, _I, _P],
    # (t, out, batch, n, stream)
    "nhw_synth_norm_rows_clip": [_P, _P, _I, _I, _P],
    # (x, recs, valid, k, batch, stream)
    "nhw_smooth_marks_seq": [_P, _P, _P, _I, _I, _P],
    # (words, nbits, zone, seg_tab, lut, state, agg, syms, counts, batch,
    #  n_words, s_max, stream)
    "nhw_chain_starts": [_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (ebase, fields, e_in, flags, sweeps, length, batch, k, p1, stream)
    "nhw_y_runs_fixpoint": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _P],
    # (in, out, batch, n, args: int32[10 n], stream)
    "nhw_snap_passes": [_P, _P, _I, _I, _P, _P],
    # (in, tmp, out, esc, batch, m1, stream)
    "nhw_offset_y": [_P, _P, _P, _P, _I, _I, _P],
    # (in, out, batch, n, stream)
    "nhw_merge_crossing": [_P, _P, _I, _I, _P],
    # (int32[3] out: registers, shared bytes per CTA, most resident clusters)
    "nhw_merge_crossing_info": [_P],
    # (in, out, batch, stream)
    "nhw_pair_promotion": [_P, _P, _I, _P],
    # (plane, rf_ext, out, rf_out, tab, batch, low1, low2, hi1, res_setting,
    #  stream)
    "nhw_column_ladder": [_P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _P],
    # (plane, res256, out, rf_out, counts, batch, hi1, res_setting, stream)
    "nhw_classify": [_P, _P, _P, _P, _P, _I, _I, _I, _P],
    # (plane, vem, is24, batch, gt_low3, stream)
    "nhw_ll2_code_y": [_P, _P, _P, _I, _I, _P],
    # (nxt, visited, batch, n, start, seg_log2, stream)
    "nhw_walk_visited": [_P, _P, _I, _I, _I, _I, _P],
    # (process, rf_ext, out, batch, rf_len, res_uv, stream)
    "nhw_uv_sentinel": [_P, _P, _P, _I, _I, _I, _P],
    # (in, tmp, look, out, esc, batch, m1, stream)
    "nhw_offset_y_low4": [_P, _P, _P, _P, _P, _I, _I, _P],
    # (in, r3_ext, xs, out, batch, r3_len, gt_low10, stream)
    "nhw_lowest_q_band_cleanup": [_P, _P, _P, _P, _I, _I, _I, _P],
    # (int32[3] out: registers, shared bytes per CTA, most resident clusters)
    "nhw_lowest_q_band_cleanup_info": [_P],
    # (in, out, masks, batch, low9, x1, .., x7, stream)
    "nhw_very_low_q_cleanup": [_P, _P, _P, _I, _I] + [_I] * 7 + [_P],
    # (in, out, batch, x1, stream)
    "nhw_low_q_ll1_cleanup": [_P, _P, _I, _I, _P],
    # (uv, batch, stream)
    "nhw_uv_ll_smooth": [_P, _I, _P],
}

LAUNCHES = {"synth_level": 0, "y_stage2_full": 0, "uv_synth": 0,
            "analysis_level_jp": 0, "requant_tail": 0,
            "colorspace_down420": 0, "rgb_to_yuv_full": 0,
            "synth_unnorm_rows_t": 0, "synth_norm_rows_clip_waves": 0,
            "synth_norm_rows_clip": 0, "smooth_marks_seq": 0,
            "analysis_level": 0, "chain_starts": 0, "y_runs_fixpoint": 0,
            "snap_pass": 0, "offset_y": 0, "merge_crossing": 0,
            "pair_promotion": 0, "column_ladder": 0, "classify": 0,
            "ll2_code_y": 0, "walk_visited": 0, "uv_sentinel": 0,
            "offset_y_low4": 0, "lowest_q_band_cleanup": 0,
            "very_low_q_cleanup": 0, "low_q_ll1_cleanup": 0,
            "uv_ll_smooth": 0}

_lock = threading.Lock()
_count_lock = threading.Lock()
_lib = None


def count(name: str) -> None:
    with _count_lock:
        LAUNCHES[name] += 1


def reset_launches() -> None:
    with _count_lock:
        for k in LAUNCHES:
            LAUNCHES[k] = 0


def check_arg(x: torch.Tensor, name: str, dtype: torch.dtype,
              shape: tuple) -> None:
    """Raise unless ``x`` has ``dtype``, matches ``shape`` (None: any
    size) and lies on the CPU or a CUDA card."""
    if x.dtype != dtype:
        raise TypeError(f"{name}: expected {dtype}, got {x.dtype}")
    if x.dim() != len(shape) or any(
            s is not None and d != s for d, s in zip(x.shape, shape)):
        raise ValueError(f"{name}: expected shape {shape}, got "
                         f"{tuple(x.shape)}")
    if x.device.type not in ("cpu", "cuda"):
        raise ValueError(f"{name}: unsupported device {x.device}")


def cuda_args(*tensors: torch.Tensor):
    """The kernel library and the current stream of the tensors' card."""
    dev = tensors[0].device
    for t in tensors:
        if t.device != dev:
            raise ValueError(f"tensors on {dev} and {t.device}")
    return load(), torch.cuda.current_stream(dev).cuda_stream


def _nvcc() -> str:
    from torch.utils.cpp_extension import CUDA_HOME

    cand = [Path(CUDA_HOME) / "bin" / "nvcc"] if CUDA_HOME else []
    found = shutil.which("nvcc")
    if found:
        cand.append(Path(found))
    for c in cand:
        if c.is_file():
            return str(c)
    raise RuntimeError("nvcc not found (set CUDA_HOME or put nvcc on PATH)")


def _sources() -> list[Path]:
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for p in sorted(CSRC.glob("*.cu")) + sorted(CSRC.glob("*.cuh")):
        h.update(p.name.encode())
        h.update(p.read_bytes())
    return h.hexdigest()[:16]


def lib_path() -> Path:
    return BUILD_DIR / source_hash() / LIB_NAME


def _run_all(cmds: list[list[str]]) -> list[tuple[list[str], int, str]]:
    """Run the commands in parallel; (command, exit code, output) each."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.STDOUT, text=True))
             for cmd in cmds]
    outs = [p.communicate()[0] for _, p in procs]
    return [(cmd, p.returncode, text)
            for (cmd, p), text in zip(procs, outs)]


def _build(out: Path) -> None:
    out.parent.mkdir(parents=True, exist_ok=True)
    tag = f"{os.getpid()}.{threading.get_ident()}"
    nvcc = _nvcc()
    objs = [out.with_name(f"{src.stem}.{tag}.o") for src in _sources()]
    tmp = out.with_name(f"{LIB_NAME}.{tag}.tmp")
    try:
        results = _run_all([[nvcc, *NVCC_FLAGS, "-c", "-o", str(obj),
                             str(src)]
                            for src, obj in zip(_sources(), objs)])
        results += [] if any(rc for _, rc, _ in results) else _run_all(
            [[nvcc, *ARCH, "-shared", "-o", str(tmp), *map(str, objs)]])
        log = "".join(f"$ {' '.join(cmd)}\n{text}"
                      for cmd, _, text in results)
        if any(rc for _, rc, _ in results):
            raise RuntimeError(f"nvcc failed:\n{log}")
        (out.parent / "build.log").write_text(log)
        os.replace(tmp, out)   # atomic: a concurrent loader sees all or none
    finally:
        tmp.unlink(missing_ok=True)
        for obj in objs:
            obj.unlink(missing_ok=True)


def load():
    """The loaded kernel library (built first if its hash is new)."""
    global _lib
    with _lock:
        if _lib is None:
            path = lib_path()
            if not path.exists():
                _build(path)
            lib = ctypes.CDLL(str(path))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            lib.nhw_error_string.argtypes = [ctypes.c_int]
            lib.nhw_error_string.restype = ctypes.c_char_p
            _lib = lib
        return _lib


def check(name: str, code: int) -> None:
    """Raise if a C entry point reported a CUDA error."""
    if code != 0:
        msg = _lib.nhw_error_string(code).decode()
        raise RuntimeError(f"{name}: CUDA error {code}: {msg}")
