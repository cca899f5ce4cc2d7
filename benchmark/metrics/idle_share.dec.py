"""The share of the traced slice in which no kernel, copy or set ran on
the card (annotations left out), in %; nothing where nothing ran."""

from benchmark import trace


def read(sl):
    busy = trace.busy_s(sl)
    return 100 * (1 - busy / sl.window_s) if busy > 0 else None
