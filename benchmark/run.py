#!/usr/bin/env python3
"""Run one cell of the benchmark on the card and print its result line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout of the repository. The cell's files are found
by the names in BENCHMARK.json (see harness.py and README.md). The
program under test is the PyTorch / CUDA package at the checkout's root
(`..._tpu_torch`); this process never imports jax or the JAX package,
and exits without a result if it holds one once the window has closed.

Standard error gets the card's name and power limit first and, last, each
number the output check compared beside its limit. The last line of
standard output is the result: correct, attempted, failed, metrics (the
cell's end-to-end metrics, or with --trace 1 its per-layer metrics),
device (with --trace 1 also busy_s and window_s), breakdown (--trace 1)
and check (the numbers compared, each with its limit), last.

Exit codes: 0 with a result; 2 without a card (or fewer than the cell
asks for); 3 when jax or the JAX package was loaded; 1 on any other error.
"""

from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
ROOT = HERE.parent


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    # The port builds its kernels into build/torch_kernels/<hash>/ inside
    # this checkout, its only compile cache.
    sys.path[:0] = [str(HERE), str(ROOT)]
    import harness
    import roofline
    import torch

    cell = next((w for w in harness.load_benchmark(ROOT)["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"run.py: no workload {args.workload!r}", file=sys.stderr)
        return 1
    if not torch.cuda.is_available() or torch.cuda.device_count() < cell["chips"]:
        print(f"run.py: the cell needs {cell['chips']} CUDA device(s); "
              f"this machine has {torch.cuda.device_count()}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    print(roofline.card_line(), file=sys.stderr, flush=True)
    try:
        result = harness.run(ROOT, args.workload, args.seed, args.seconds,
                             bool(args.trace), device="cuda", t_start=T_START)
    except RuntimeError as exc:
        if harness.forbidden_modules():
            print(f"run.py: {exc}", file=sys.stderr)
            return 3
        raise
    found = harness.forbidden_modules()
    if found:
        print(f"run.py: the process holds {', '.join(found)}", file=sys.stderr)
        return 3
    for k, c in result["check"].items():
        print(f"check {k} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
