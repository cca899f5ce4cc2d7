"""Run a cell's control: the reference in the program's place, with one
of the configuration's guarantees broken (``controls/<name>.py``), held
to the same comparison as a run's answers.

    python -m benchmark.control --workload <cell> --seeds <n> [<n> ...]

For each seed the control answers every image of the cell's pool, which
is every distinct answer a run compares; the line it prints gives the
numbers compared beside their limits and ``correct``, which has to come
out false.  Needs no card: the reference runs on the host.
"""

from __future__ import annotations

import argparse
import json
import sys

from benchmark import cells, check
from benchmark.images import make_pool


def control_checks(cell: cells.Cell, seed: int,
                   pool_size: int | None = None) -> dict:
    """The checks of the control's answers over the pool of ``seed``."""
    pool = make_pool(seed)[:pool_size]
    q = cell.quality
    patch = cells.control(cell.control)
    if cell.traffic["kind"] == "encode":
        want = check.reference_streams(pool, q)
        with patch():
            got = check.reference_streams(pool, q)
    else:
        streams = check.reference_streams(pool, q)
        want = check.reference_images(streams)
        with patch():
            got = check.reference_images(streams)
    return check.compare([(list(range(len(pool))), got)], want)


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    cell = cells.find(args.workload)
    for seed in args.seeds:
        c = control_checks(cell, seed)
        print(json.dumps({"workload": cell.name,
                          "control": cell.control, "seed": seed,
                          "correct": check.passed(c), "checks": c}),
              flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
