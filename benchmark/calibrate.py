"""Readings for the limits of ``correct``: for each seed, one process makes a
cell's inputs, runs its warm job and the jobs up to those its check
compares (a window of 0 seconds), and reads the check's numbers for the
program and for the control (the reference's EM in float32 with TF32
contractions in the program's place).  One JSON line a seed.

    python3 benchmark/calibrate.py --workload <cell> --seeds 11 12 13 ...
"""

import time

T0 = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def main(argv) -> int:
    p = argparse.ArgumentParser(prog="benchmark/calibrate.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seeds", type=int, nargs="+", required=True)
    args = p.parse_args(argv)
    from benchmark.harness import cell
    from benchmark.harness.spec import Spec

    spec = Spec()
    for seed in args.seeds:
        t0 = time.perf_counter()
        r = cell.run(spec, args.workload, seed, 0.0, False, "cuda", t0, control=True)
        print(json.dumps({"workload": args.workload, "seed": seed, "correct": r["correct"],
                          "attempted": r["attempted"],
                          "checks": {k: v["value"] for k, v in r["checks"].items()},
                          "readings": r["readings"],
                          "seconds": time.perf_counter() - t0}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main(sys.argv[1:]))
