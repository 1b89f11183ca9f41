#!/usr/bin/env python3
"""Spreads of a cell's runs, to set the end-to-end metrics' bounds.

    python3 benchmark/spread.py SET_A_FILES... -- SET_B_FILES...

Each file holds one run's standard output (its last line is the result).
For each metric and set: the median, and the spread (the distance between
the first and third quartile of `statistics.quantiles(values, n=4)`, as a
share of the median); then the wider of the two sets' spreads and five
times it, the bound that spread suggests (never under 1%), and the
second set's median against the first's.
"""

from __future__ import annotations

import json
import statistics
import sys


def spread(values) -> float:
    q1, _, q3 = statistics.quantiles(values, n=4)
    return (q3 - q1) / statistics.median(values)


def read(paths):
    runs = []
    for p in paths:
        lines = [x for x in open(p).read().splitlines() if x.strip()]
        runs.append({k: v["value"] for k, v in json.loads(lines[-1])["metrics"].items()})
    return runs


def main(argv) -> int:
    cut = argv.index("--")
    sets = [read(argv[:cut]), read(argv[cut + 1:])]
    for name in sets[0][0]:
        vals = [[r[name] for r in s] for s in sets]
        sp = [spread(v) for v in vals]
        med = [statistics.median(v) for v in vals]
        print(json.dumps({"metric": name, "medians": med, "spreads": sp,
                          "widest": max(sp), "bound_5x": max(0.01, 5 * max(sp)),
                          "second_vs_first": med[1] / med[0] - 1,
                          "values": vals}))
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
