"""Where the cluster kernels K2 and K3 spend their time, on the card.

Times K2 (``y_stage2_full``) at 0, 1, 4 and all of its dering waves, K3
(``uv_synth``), and each of them built once more with every DSM store of
their row passes sent to the CTA itself instead of the peer that owns the
transposed row (the same instructions without the cluster's network;
that build computes wrong planes and is only timed), beside K7 + K8 and
K8 and K9 alone, on ``chip_smoke.py``'s batch-16 inputs of the kernel
phase.  Device ms per call from a CUDA graph of back-to-back calls and
from ``torch.profiler``.  Needs a CUDA card and ``nvcc``; run from the
repository root:

    python -m nhwcodec_tpu_torch.kernels.cluster_probe
"""

from __future__ import annotations

import ctypes
import subprocess
import sys

import numpy as np
import torch

from nhwcodec_tpu_torch.kernels import build

# the DSM store of rows_to_peers_t (cluster.cuh), and its local stand-in
_PEER = "int16_t* peer = cluster.map_shared_rank(dst, d0 / kDstRows);"
_SELF = ("int16_t* peer = cluster.map_shared_rank("
         "dst, static_cast<int>(cluster.block_rank()));")


def _self_store_library():
    """dwt.cu built with the row passes' DSM stores sent to the CTA itself:
    a patched copy of cluster.cuh beside a copy of dwt.cu, which includes
    it from its own directory first."""
    src = (build.CSRC / "cluster.cuh").read_text()
    if src.count(_PEER) != 1:
        raise RuntimeError("cluster.cuh: the row pass's DSM store line "
                           "changed")
    out = build.BUILD_DIR / "probe"
    out.mkdir(parents=True, exist_ok=True)
    (out / "cluster.cuh").write_text(src.replace(_PEER, _SELF))
    (out / "dwt_self.cu").write_text((build.CSRC / "dwt.cu").read_text())
    so = out / "libdwt_self.so"
    # analysis.cu, unpatched, holds nhw_cluster_info's K4/K10 half
    subprocess.run([build._nvcc(), *build.NVCC_FLAGS, "-shared", "-I",
                    str(build.CSRC), "-o", str(so), str(out / "dwt_self.cu"),
                    str(build.CSRC / "analysis.cu")],
                   check=True, capture_output=True, text=True)
    lib = ctypes.CDLL(str(so))
    for name in ("nhw_y_stage2_full", "nhw_uv_synth"):
        getattr(lib, name).argtypes = build.SIGNATURES[name]
    return lib


def main() -> int:
    if not torch.cuda.is_available():
        print("cluster_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nhwcodec_tpu_torch.models import device_decode as tdd
    from nhwcodec_tpu_torch.ops import dwt

    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip())
    dev = torch.device("cuda", 0)
    build.load()
    lib = _self_store_library()
    # the kernel phase's inputs, drawn in its order
    rng = np.random.default_rng(cs.SEED)
    cs.planes(rng, cs.B, 512, -2000, 2000)
    jp = torch.from_numpy(cs.planes(rng, cs.B, 512, -2, 3)).to(dev)
    dp_np, n_waves, _ = tdd.mark_depth_planes(cs.mark_lists(rng, cs.B))
    dp = torch.from_numpy(dp_np).to(dev)
    uv = torch.from_numpy(cs.sentinel_planes(rng, 2 * cs.B)).to(dev)

    def k2_self(w):
        out = torch.empty(jp.shape, dtype=torch.uint8, device=dev)
        build.check("probe K2", lib.nhw_y_stage2_full(
            jp.data_ptr(), dp.data_ptr(), out.data_ptr(), cs.B, w,
            torch.cuda.current_stream(dev).cuda_stream))

    def k3_self():
        out = torch.empty_like(uv)
        build.check("probe K3", lib.nhw_uv_synth(
            uv.data_ptr(), out.data_ptr(), uv.shape[0],
            torch.cuda.current_stream(dev).cuda_stream))

    cases = [(f"K2 n_waves={w}", lambda w=w: dwt.y_stage2_full(jp, dp, w))
             for w in (0, 1, 4, n_waves)]
    cases += [("K2, stores to itself, n_waves=0", lambda: k2_self(0)),
              (f"K2, stores to itself, n_waves={n_waves}",
               lambda: k2_self(n_waves)),
              ("K3", lambda: dwt.uv_synth(uv)),
              ("K3, stores to itself", k3_self),
              (f"K7 + K8, n_waves={n_waves}",
               lambda: dwt.synth_norm_rows_clip_waves(
                   dwt.synth_unnorm_rows_t(jp), dp, n_waves)),
              ("K8 n_waves=0", lambda: dwt.synth_norm_rows_clip_waves(
                  jp, dp, 0)),
              (f"K8 n_waves={n_waves}", lambda: dwt.synth_norm_rows_clip_waves(
                  jp, dp, n_waves)),
              ("K9", lambda: dwt.synth_norm_rows_clip(jp))]
    print(f"batch {cs.B}: K2 on ({cs.B},512,512), K3 on ({2 * cs.B},256,256); "
          "device ms per call: graph of "
          f"{cs.GRAPH_CALLS} calls (CUDA events) / torch.profiler")
    for turn in range(2):
        for what, fn in cases:
            print(f"  [{turn}] {what}: {cs.graph_ms(fn):.4f} / "
                  f"{cs.device_profile(fn, calls=10)[1]}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
