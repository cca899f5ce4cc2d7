"""The encoder with the Y pre-filter left out (q < 22): the exact
pre-filter the configuration states is the largest host step of the
low-q front, so leaving it out is the step a faster encode would
tempt."""

from __future__ import annotations

import contextlib

from benchmark.reference.ops import prefilter


@contextlib.contextmanager
def patch():
    was = prefilter.pre_process_y
    prefilter.pre_process_y = lambda y, quality: y
    try:
        yield
    finally:
        prefilter.pre_process_y = was
