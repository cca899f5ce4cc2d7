"""Host ms per image inside the encode front's ``nhw.encode.front`` range
(colorspace, pre-filter, analysis, requant, on either encode path),
summed over the threads that ran it."""

from benchmark import trace


def read(sl):
    s = trace.host_range_s(sl, lambda n: n == "nhw.encode.front")
    return 1e3 * s / sl.images if s > 0 and sl.images else None
