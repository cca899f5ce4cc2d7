"""Controls: the reference put in the program's place with one of the
configuration's guarantees broken (``benchmark.control`` runs them).

Each module holds one control: ``patch()``, a context manager under which
``benchmark.reference`` computes one step in the nearest precision below
the one the configuration states, or leaves out one exact step.  A
configuration names the control of each side by module name
(``"controls": {"encode": ..., "decode": ...}``).
"""
