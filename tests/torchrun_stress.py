"""Many torchrun launches of the port's CLI at once, on the CPU: how often
a two-rank `--mesh data=2` timing sweep fails under load.

    python tests/torchrun_stress.py [--root CHECKOUT] [--concurrent 6]
                                    [--rounds 6]

Each round starts `--concurrent` launches of
`torchrun --standalone --nproc_per_node 2 -m <port>.cli --mode
timing_analysis --sample_sizes 10,20 --timing_runs 4 --device cpu
--mesh data=2` together (what tests/test_torch_parallel_cli.py runs,
times the workers of a loaded test run) and waits for them.  Prints each
failure's last lines and a count.  `--root` runs another checkout's
package (e.g. an earlier commit unpacked with `git archive`).
"""

import argparse
import os
import subprocess
import sys
import tempfile
from pathlib import Path

PKG = "dr_cvar_mpc_safety_filter_motion_planning_collison_avoidance_tpu_torch"


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--root", default=str(Path(__file__).parents[1]))
    parser.add_argument("--concurrent", type=int, default=6)
    parser.add_argument("--rounds", type=int, default=6)
    args = parser.parse_args(argv)
    env = dict(os.environ, OMP_NUM_THREADS="1", PYTHONPATH=args.root)
    failed = runs = 0
    for _ in range(args.rounds):
        with tempfile.TemporaryDirectory() as tmp:
            procs = [subprocess.Popen(
                [sys.executable, "-m", "torch.distributed.run",
                 "--standalone", "--nproc_per_node", "2", "-m",
                 f"{PKG}.cli", "--mode", "timing_analysis",
                 "--sample_sizes", "10,20", "--timing_runs", "4",
                 "--device", "cpu", "--mesh", "data=2", "--save_dir",
                 os.path.join(tmp, str(i))], cwd=tmp, env=env,
                stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True)
                for i in range(args.concurrent)]
            for proc in procs:
                out = proc.communicate(timeout=600)[0]
                runs += 1
                if proc.returncode != 0:
                    failed += 1
                    print(f"--- launch failed with code {proc.returncode}:")
                    print("\n".join(out.splitlines()[-12:]))
    print(f"failed {failed} of {runs} launches")
    return 0


if __name__ == "__main__":
    sys.exit(main())
