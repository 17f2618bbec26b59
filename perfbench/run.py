"""Run one cell of BENCHMARK.json once and print its result line.

    python3 perfbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Needs the CUDA devices the cell asks for (else it exits 2 and prints no
result).  The last line of standard output is one JSON object; the numbers
the check compared, each beside its limit, are the last lines of standard
error and the last key of that object.
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


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    try:
        if not (ROOT / "src" / "repro_torch").is_dir():
            raise harness.RunError(f"the program (src/repro_torch) is not in {ROOT}", 1)
        bench = harness.benchmark()
        the_cell = harness.cell(bench, args.workload)
        harness.pin_caches()
        out = harness.run_cell(args.workload, args.seed, args.seconds, bool(args.trace),
                               bench=bench, the_cell=the_cell, t_start=T_START)
    except harness.RunError as e:
        print(f"perfbench: {e}", file=sys.stderr)
        return e.code
    for name, c in out["checks"].items():
        verdict = "ok" if c["limit"] is not None and c["value"] is not None \
            and c["value"] <= c["limit"] else "FAIL"
        print(f"check {name} {c['value']!r} limit {c['limit']!r} {verdict}", file=sys.stderr)
    print(f"correct {out['correct']}", file=sys.stderr, flush=True)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
