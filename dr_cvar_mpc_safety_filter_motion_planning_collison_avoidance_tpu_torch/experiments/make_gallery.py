"""The results gallery through the port's CLI: 4 scenarios x 2 presets.

    python -m dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch.experiments.make_gallery \
        [--skip_animate] [--device cuda|cpu] [--out build/gallery_torch]

Port of the JAX package's experiments/make_gallery.py.  Each scenario of
each preset runs through `cli --mode single` (with `--animate` unless
`--skip_animate`) and writes the JAX gallery's file names:

    <out>/Custom_Scenarios/<scenario>_results.png
    <out>/Custom_Scenarios/<scenario>_dr_cvar_halfspaces.png
    <out>/Custom_Scenarios/<scenario>_dr_cvar_animation.mp4 (or .gif)
    <out>/Paper_Scenarios/...   (the same names)

The default `<out>` is `build/gallery_torch/` beside the package
(git-ignored): `results/` holds the JAX package's published gallery and
is never written by default.  Where matplotlib is not installed the CLI
prints one line naming the plots it skips and still runs each scenario;
`--animate` needs matplotlib.
"""

from __future__ import annotations

import argparse
import os
import time
from pathlib import Path

from .. import cli
from ..config import DEFAULT_DEVICE

SCENARIOS = ("head_on", "overtaking", "intersection", "multi_obstacle")
PRESETS = (("custom", "Custom_Scenarios"), ("paper", "Paper_Scenarios"))
DEFAULT_OUT = Path(__file__).resolve().parents[2] / "build" / "gallery_torch"


def run(skip_animate: bool = False, device=DEFAULT_DEVICE,
        out=DEFAULT_OUT, scenarios=SCENARIOS, presets=PRESETS) -> dict:
    """Every scenario of every preset (the gallery's, unless fewer are
    given); returns {(preset, scenario): the CLI's result}."""
    results = {}
    for preset, subdir in presets:
        save_dir = os.path.join(out, subdir)
        for scenario in scenarios:
            t0 = time.time()
            argv = ["--scenario", scenario, "--preset", preset,
                    "--mode", "single", "--save_dir", save_dir,
                    "--device", str(device)]
            if not skip_animate:
                argv.append("--animate")
            print(f"=== {preset}/{scenario} ===", flush=True)
            results[preset, scenario] = cli.main(argv)
            print(f"=== {preset}/{scenario} done in "
                  f"{time.time() - t0:.1f}s ===", flush=True)
    return results


def main(argv=None):
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--skip_animate", action="store_true")
    parser.add_argument("--device", choices=["cpu", "cuda"],
                        default=DEFAULT_DEVICE)
    parser.add_argument("--out", default=str(DEFAULT_OUT),
                        help="output root (default: build/gallery_torch)")
    args = parser.parse_args(argv)
    return run(args.skip_animate, args.device, args.out)


if __name__ == "__main__":
    main()
