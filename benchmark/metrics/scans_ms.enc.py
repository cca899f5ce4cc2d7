"""Host ms per image inside the device encode scans' ``nhw.scans.*``
ranges (``models.device_encode_scans``: the cleanups, the LL2, residue
and stream stages, host E10, the UV components)."""

from benchmark import trace


def read(sl):
    s = trace.host_range_s(sl, lambda n: n.startswith("nhw.scans."))
    return 1e3 * s / sl.images if s > 0 and sl.images else None
