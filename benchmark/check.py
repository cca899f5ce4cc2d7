"""The comparison that decides ``correct``: every kept answer of the window
against the plain reference (``benchmark.reference``), byte for byte.

An encode answer is a .nhw byte string, held to the reference encoder's
stream of the same image; a decode answer is a (512, 512, 3) uint8 image,
held to the reference decoder's image of the same stream.  An answer that
never came (None, or a reply with fewer answers than the request sent)
counts as wrong.  The limits: no image wrong, and at least one compared.
"""

from __future__ import annotations

import numpy as np

from benchmark.reference.models import decoder as ref_decoder
from benchmark.reference.models import encoder as ref_encoder

LIMIT_WRONG = 0
MIN_COMPARED = 1


def reference_streams(pool: np.ndarray, quality: int) -> list[bytes]:
    return [ref_encoder.encode(img, quality) for img in pool]


def reference_images(streams: list[bytes]) -> list[np.ndarray]:
    return [ref_decoder.decode(s) for s in streams]


def _same(got, want) -> bool:
    if got is None:
        return False
    if isinstance(want, bytes):
        return bytes(got) == want
    got = np.asarray(got)
    return got.shape == want.shape and bool(np.array_equal(got, want))


def compare(kept: list, want: list) -> dict:
    """``kept``: (pool indices, answers) of each kept request; ``want``:
    the reference's answer for each pool index.  Returns the numbers
    compared, each with its limit."""
    wrong = compared = 0
    for idxs, answers in kept:
        answers = list(answers or [])
        answers += [None] * (len(idxs) - len(answers))
        for i, got in zip(idxs, answers):
            compared += 1
            wrong += not _same(got, want[i])
    return {"images_wrong": {"value": wrong, "max": LIMIT_WRONG},
            "images_compared": {"value": compared, "min": MIN_COMPARED}}


def passed(checks: dict) -> bool:
    return all(("max" not in c or c["value"] <= c["max"])
               and ("min" not in c or c["value"] >= c["min"])
               for c in checks.values())


def lines(checks: dict) -> list[str]:
    """One line a number compared, beside its limit."""
    out = []
    for name, c in checks.items():
        if "max" in c:
            out.append(f"check {name} {c['value']} limit <= {c['max']}")
        if "min" in c:
            out.append(f"check {name} {c['value']} limit >= {c['min']}")
    return out
