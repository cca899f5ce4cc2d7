"""Device busy ms per decoded image: the time in which a kernel, copy or
set ran on the card (annotations left out) over the slice's images."""

from benchmark import trace


def read(sl):
    s = trace.busy_s(sl)
    return 1e3 * s / sl.images if s > 0 and sl.images else None
