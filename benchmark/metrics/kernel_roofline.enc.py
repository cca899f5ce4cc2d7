"""The least device time of the slice's encode work (``roofline``: the
stages the cell's path must run, from its shapes and quality), as a share
of the summed time of every kernel in the slice, in %."""

from benchmark import roofline, trace


def read(sl):
    t = trace.kernel_s(sl)
    if t <= 0 or not sl.images:
        return None
    return 100 * roofline.bound_s(sl.stages, sl.quality, sl.images) / t
