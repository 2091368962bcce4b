"""Command line of a run:

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Prints, as the last line of standard output, one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``, with ``--trace 1`` also
``breakdown``, and ``checks``, each number compared beside its limit), and
the same numbers as the last lines of standard error.  Exits non-zero with
no result when torch sees no CUDA device or fewer than the cell asks for,
or when the process holds JAX or the JAX package once the window has
closed.
"""

from __future__ import annotations

import argparse
import json
import sys

FORBIDDEN = ("jax", "jaxlib", "flax", "colate_tpu")


def forbidden_modules() -> list:
    """Modules loaded whose top-level name is one of FORBIDDEN."""
    return sorted({m for m in sys.modules if m.split(".")[0] in FORBIDDEN})


def main(argv, t0: float) -> int:
    p = argparse.ArgumentParser(prog="benchmark/run.py")
    p.add_argument("--workload", required=True)
    p.add_argument("--seed", type=int, required=True)
    p.add_argument("--seconds", type=float, required=True)
    p.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = p.parse_args(argv)

    from benchmark.harness import cell
    from benchmark.harness.spec import Spec

    spec = Spec()
    chips = spec.workload(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"benchmark: the cell needs {chips} CUDA device(s); torch sees "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    result = cell.run(spec, args.workload, args.seed, args.seconds, bool(args.trace), "cuda", t0)
    found = forbidden_modules()
    if found:
        print(f"benchmark: the process loaded {', '.join(found)}", file=sys.stderr)
        return 3
    for name, c in result["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0
