"""Run one cell of ``BENCHMARK.json`` once and print its result line.

    python3 tcibench/run.py --workload <cell> --seed <n> --seconds <s> \
        --trace <0|1> [--control]

from the root of a checkout, on a machine with the CUDA cards the cell asks
for. The last line of standard output is one JSON object (``correct``,
``attempted``, ``failed``, ``metrics``, ``device``; with ``--trace 1`` also
``breakdown``; last, ``checks``: each number compared beside its limit); the
last lines of standard error name the same numbers. ``--trace 0`` reports
the cell's end-to-end metrics, ``--trace 1`` its per-layer metrics.
``--control`` runs the program in the configuration's lower precision (its
``control_valuetype``), the control that the check has to fail.

Exits 2 without the cards, 3 if JAX or the JAX package was loaded by the
time the result would be printed; then it prints no result.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parent.parent
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    ap.add_argument("--control", action="store_true")
    args = ap.parse_args(argv)

    from tcibench import core

    spec = core.load_spec()
    cell = next((w for w in spec["workloads"]
                 if w["name"] == args.workload), None)
    if cell is None:
        print(f"tcibench: no workload {args.workload!r}", file=sys.stderr)
        return 2
    import torch
    if not torch.cuda.is_available() or (
            torch.cuda.device_count() < cell["chips"]):
        print(f"tcibench: {args.workload} needs {cell['chips']} CUDA "
              f"device(s); torch.cuda.is_available() = "
              f"{torch.cuda.is_available()}", file=sys.stderr)
        return 2
    try:
        line, checks = core.run_cell(args.workload, args.seed, args.seconds,
                                     bool(args.trace), T_START,
                                     control=args.control)
        core.check_modules()
    except core.ForbiddenModules as exc:
        print(f"tcibench: {exc}", file=sys.stderr)
        return 3
    print(json.dumps(line), flush=True)
    for text in checks:
        print(text, file=sys.stderr, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
