"""Pipelined batch encode and decode with the transforms on the GPU.

Port of ``nhwcodec_tpu.parallel.device_pipeline``.  The batch is cut
into chunks that run on a thread pool, so one chunk's host automata (the
C scans release the GIL) overlap other chunks' kernel launches.

Encode, per chunk:

  D1  device: exact colorspace + 4:2:0 (K6 at q >= NORM)
  H1  host:   Y pre-filter raster automaton (q < HIGH2)
  D2  device: both analysis levels of Y, U and V (K4)
  H1b host:   requant mark + offset(part=1) greedy automata (q > LOW14)
  D3  device: requant feedback tail (K5)
  H2  host:   residue/quantize/entropy scans and the tokenizer
  D4  device: the Huffman bit packing of the chunk (device_pack)

For q > HIGH1 (no Y pre-filter) D1 and D2 run back to back on the
device.  A failure of the chunk's device stages costs the chunk's
images; the host stage and the pack isolate each image.  With
``scans_on_device`` the whole batch takes the front and then
``models.device_encode_scans``, the raster scans on the device, in one
call (q17..q21).

Decode: a failed chunk is retried image by image, so one bad stream
costs one result, not the chunk.  With ``entropy_on_device`` each
chunk's Huffman decode runs on the device too.
"""

from __future__ import annotations

import logging
import os
import time
from concurrent.futures import ThreadPoolExecutor

import numpy as np

from nhwcodec_tpu_torch.host import tables as T
from nhwcodec_tpu_torch.host.models import encoder as host_encoder
from nhwcodec_tpu_torch.host.parallel.api import BatchMetrics
from nhwcodec_tpu_torch.device import resolve_device
from nhwcodec_tpu_torch.models import device_decode as dd
from nhwcodec_tpu_torch.models import device_encode_scans as des
from nhwcodec_tpu_torch.models import device_stages as ds
from nhwcodec_tpu_torch.models import encoder as tenc

log = logging.getLogger(__name__)


def _chunks(items, b: int, workers: int | None, chunk: int | None):
    """(items of one chunk, their batch indices) per chunk; the default
    chunk is B/workers, capped at 16."""
    n_workers = workers or os.cpu_count() or 1
    if chunk is None:
        chunk = max(1, min(16, -(-b // n_workers)))
    return n_workers, [(items[lo: lo + chunk],
                        list(range(lo, min(lo + chunk, b))))
                       for lo in range(0, b, chunk)]


def _run(fn, jobs, n_workers: int, *args) -> int:
    """Run ``fn(job..., *args)`` for every job, on a pool unless there is
    one worker or one job; returns the sum of the failure counts."""
    if n_workers == 1 or len(jobs) == 1:
        return sum(fn(*job, *args) for job in jobs)
    with ThreadPoolExecutor(max_workers=n_workers) as ex:
        futs = [ex.submit(fn, *job, *args) for job in jobs]
        return sum(f.result() for f in futs)


def _encode_chunk_device(images: np.ndarray, idxs: list[int], quality: int,
                         out: list, dev, device_pack: bool) -> int:
    """Run one chunk through D1..D4 into ``out``; returns its failure
    count."""
    try:
        y1s, origs, u, v, pre_y, pre_u, pre_v = ds.encode_front(
            images, quality, dev)
    except Exception:  # noqa: BLE001 — whole-chunk device failure
        log.warning("encode chunk %s failed in its device stages", idxs,
                    exc_info=True)
        return len(idxs)

    failures = 0
    snap_on = quality > T.HIGH1
    deferred: list[tuple[int, object]] = []
    for k, i in enumerate(idxs):
        try:
            r = host_encoder.encode_from_planes(
                y1s[k], u[k], v[k], quality, y_original=origs[k],
                pre_y=(pre_y[0][k], pre_y[1][k], pre_y[2][k],
                       pre_y[3][k] if snap_on else None),
                pre_u=tuple(a[k] for a in pre_u),
                pre_v=tuple(a[k] for a in pre_v),
                requant_done=quality > T.LOW14,
                defer_pack=device_pack)
        except Exception:  # noqa: BLE001 — per-image failure isolation
            log.warning("image %d failed in the host encode stage", i,
                        exc_info=True)
            failures += 1
            continue
        if device_pack:
            deferred.append((i, r))
        else:
            out[i] = r
    if not deferred:
        return failures
    try:
        streams = tenc.finish_deferred([d for _, d in deferred], device=dev)
        for (i, _), s in zip(deferred, streams):
            out[i] = s
        return failures
    except Exception:  # noqa: BLE001 — isolate a bad pack per image
        log.warning("chunk %s pack failed; packing image by image", idxs,
                    exc_info=True)
    for i, d in deferred:
        try:
            out[i] = tenc.finish_deferred([d], device=dev)[0]
        except Exception:  # noqa: BLE001 — per-image failure isolation
            log.warning("image %d failed to pack", i, exc_info=True)
            failures += 1
    return failures


def encode_batch_device(images: np.ndarray, quality: int = 20,
                        workers: int | None = None,
                        chunk: int | None = None, device="cuda",
                        device_pack: bool = True,
                        scans_on_device: bool = False
                        ) -> tuple[list[bytes | None], BatchMetrics]:
    """Encode a (B, 512, 512, 3) uint8 batch with the transforms on
    ``device`` and the raster scans on a host thread pool.

    Returns (.nhw byte strings in submission order, None for failures,
    and metrics), byte-identical to ``nhwcodec_tpu.encode``.
    ``workers``: host thread count (default: cpu count); ``chunk``:
    images per device batch (default: B/workers, capped 16);
    ``device_pack``: pack each chunk's Huffman bits on the device
    (default) instead of on the host.  ``scans_on_device=True``: every
    raster scan after the front on ``device`` too
    (``models.device_encode_scans.encode_batch_scans_device``), the whole
    batch in one call, with no chunks, no pool and no per-image
    isolation, as the JAX pipeline runs it: a failure raises, and
    ``workers``, ``chunk`` and ``device_pack`` do not apply.  It runs at
    1 <= q <= HIGH1 (q1..q21); above, the HQ residue stays on the host
    encoder, and q outside 1..HIGH1 raises ValueError."""
    if scans_on_device:
        dev = resolve_device(device)
        t0 = time.perf_counter()
        streams = des.encode_batch_scans_device(images, quality, dev)
        return streams, BatchMetrics(
            images=len(images), wall_s=time.perf_counter() - t0,
            megapixels=len(images) * 512 * 512 / 1e6)
    dev = resolve_device(device)
    t0 = time.perf_counter()
    b = len(images)
    images = np.asarray(images, np.uint8)
    n_workers, jobs = _chunks(images, b, workers, chunk)
    out: list[bytes | None] = [None] * b
    m = BatchMetrics(images=b, megapixels=b * 512 * 512 / 1e6)
    m.failures = _run(_encode_chunk_device, jobs, n_workers, quality, out,
                      dev, device_pack)
    m.wall_s = time.perf_counter() - t0
    return out, m


def _decode_chunk_device(datas: list, idxs: list[int], out: list,
                         device, entropy_on_device: bool) -> int:
    """Decode one chunk into ``out``; returns its failure count."""
    try:
        rgbs = dd.decode_batch_device(datas, device, entropy_on_device)
        for k, i in enumerate(idxs):
            out[i] = rgbs[k]
        return 0
    except Exception:  # noqa: BLE001 — fall back to per-image isolation
        log.debug("chunk %s failed; retrying image by image", idxs,
                  exc_info=True)
    failures = 0
    for k, i in enumerate(idxs):
        try:
            out[i] = dd.decode_batch_device([datas[k]], device,
                                            entropy_on_device)[0]
        except Exception:  # noqa: BLE001 — per-image failure isolation
            log.warning("image %d failed to decode", i, exc_info=True)
            failures += 1
    return failures


def decode_batch_device(datas: list, workers: int | None = None,
                        chunk: int | None = None, device="cuda",
                        entropy_on_device: bool = False
                        ) -> tuple[list, BatchMetrics]:
    """Decode a list of .nhw byte strings with the synthesis back end and
    the colorspace on ``device`` and the sequential automata on a host
    thread pool.  Returns (RGB arrays in submission order, None for
    failures, and metrics); byte-identical to the host decoder.
    ``chunk``: images per device batch (default: B/workers, capped 16);
    ``entropy_on_device``: the Huffman decode of each chunk on ``device``
    too (``models.device_decode.decode_batch_device``)."""
    dev = resolve_device(device)
    t0 = time.perf_counter()
    b = len(datas)
    n_workers, jobs = _chunks(list(datas), b, workers, chunk)
    out: list = [None] * b
    m = BatchMetrics(images=b, megapixels=b * 512 * 512 / 1e6)
    m.failures = _run(_decode_chunk_device, jobs, n_workers, out, dev,
                      entropy_on_device)
    m.wall_s = time.perf_counter() - t0
    return out, m
