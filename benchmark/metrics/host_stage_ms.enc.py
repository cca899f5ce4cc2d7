"""Host ms per image inside ``nhw.encode.host_stage``, the host encode
stage of the pool path (``models.encoder.host_stage``: the host scans and
the tokenizer), summed over the pool's threads."""

from benchmark import trace


def read(sl):
    s = trace.host_range_s(sl, lambda n: n == "nhw.encode.host_stage")
    return 1e3 * s / sl.images if s > 0 and sl.images else None
