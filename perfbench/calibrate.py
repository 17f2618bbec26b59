"""The readings that a cell's limits are set from (not run by the
benchmark's own runs).

    python3 perfbench/calibrate.py --workload <cell> --seeds 11,12,... \\
        --controls 3 --seconds <s> [--out readings.jsonl]

Runs the cell on each seed in one process (set-up, a window of ``--seconds``
at the cell's own load, the check), printing one JSON line a seed: the
program's readings and, on the first ``--controls`` seeds, the control's
(the reference in the precision below the configuration's, in the
program's place).  A limit lies above every sound reading of the program
and below the control's smallest (``limits/<cell>.json``).
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
# the package's directory, which Python puts first for a script, would
# shadow standard modules; the package is imported from the root
sys.path = [str(ROOT), str(ROOT / "src")] + [
    p for p in sys.path if Path(p or ".").resolve() != ROOT / "perfbench"]

from perfbench import harness  # noqa: E402


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--controls", type=int, default=3)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--out")
    args = ap.parse_args()
    bench = harness.benchmark()
    the_cell = harness.cell(bench, args.workload)
    harness.pin_caches()
    sink = open(args.out, "a") if args.out else None
    for k, seed in enumerate(int(s) for s in args.seeds.split(",")):
        t0 = time.perf_counter()
        out = harness.run_cell(args.workload, seed, args.seconds, False, bench=bench,
                               the_cell=the_cell, control=k < args.controls)
        line = {"cell": args.workload, "seed": seed, "correct": out["correct"],
                "program": {n: c["value"] for n, c in out["checks"].items()},
                "control": out.get("control"), "attempted": out["attempted"],
                "metrics": {n: m["value"] for n, m in out["metrics"].items()},
                "seconds": time.perf_counter() - t0}
        print(json.dumps(line), flush=True)
        if sink:
            sink.write(json.dumps(line) + "\n")
            sink.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
