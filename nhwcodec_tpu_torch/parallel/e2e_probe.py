"""End-to-end times of the port's services on one card, many runs in one
process, so that two trees can be compared in turns.

After one warm-up call of each, times ``runs`` calls (default 9) of:
the encode of chip_smoke's 16 q20 images in one chunk, the decode of
their q20 streams and of 16 q23 streams in one chunk, the q20 decode
with ``entropy_on_device=True`` and the q20 encode with
``scans_on_device=True`` (host clock around ``encode_batch_device`` /
``decode_batch_device``, which end on host bytes and arrays), and
``encode_transform`` and ``transform_step`` on the entry batch of 8
(host clock after ``torch.cuda.synchronize()``).
Prints the card's name and power limit, then one JSON line: for each
service the median and quartiles of ms per image.  The streams come from
the tree's host encoder.  Needs a CUDA card; run from a tree's root:

    python -m nhwcodec_tpu_torch.parallel.e2e_probe [runs]
"""

from __future__ import annotations

import json
import subprocess
import sys
import time

import numpy as np
import torch


def _times(fn, runs: int, per: int) -> dict:
    fn()   # warm-up
    ms = []
    for _ in range(runs):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        ms.append((time.perf_counter() - t0) * 1e3 / per)
    q1, med, q3 = np.percentile(ms, [25, 50, 75])
    return {"median": med, "q1": q1, "q3": q3, "runs": ms}


def main() -> int:
    if not torch.cuda.is_available():
        print("e2e_probe: needs a CUDA card", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from nhwcodec_tpu_torch import entry as tentry
    from nhwcodec_tpu_torch.host.models import encoder
    from nhwcodec_tpu_torch.parallel import device_pipeline as tdp

    runs = int(sys.argv[1]) if len(sys.argv) > 1 else 9
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip(), flush=True)
    dev = torch.device("cuda", 0)
    images = cs.encode_images(np.random.default_rng(cs.SEED))
    b = len(images)
    streams = {q: [encoder.encode(img, q) for img in images] for q in (20, 23)}
    fn, (rgb,) = tentry.entry(dev)
    out = {
        "encode q20": _times(lambda: tdp.encode_batch_device(
            images, 20, workers=1, chunk=b, device=dev), runs, b),
        "decode q20": _times(lambda: tdp.decode_batch_device(
            streams[20], workers=1, chunk=b, device=dev), runs, b),
        "decode q23": _times(lambda: tdp.decode_batch_device(
            streams[23], workers=1, chunk=b, device=dev), runs, b),
        "decode q20, entropy on the card": _times(
            lambda: tdp.decode_batch_device(
                streams[20], workers=1, chunk=b, device=dev,
                entropy_on_device=True), runs, b),
        "encode q20, scans on the card": _times(
            lambda: tdp.encode_batch_device(
                images, 20, device=dev, scans_on_device=True), runs, b),
        "encode_transform": _times(lambda: fn(rgb), runs, len(rgb)),
        "transform_step": _times(lambda: tentry.transform_step(rgb), runs,
                                 len(rgb)),
    }
    print(json.dumps({"ms_per_img": out}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
