"""The card benchmark of litcoder_core_torch: one run of one cell.

    python3 cardbench/run.py --workload <cell> --seed <n> --seconds <s>
                             --trace <0|1>

Run from the root of a checkout on a machine with the cards the cell asks
for. The last line of standard output is the result as one JSON object;
the last lines of standard error are the compared numbers beside their
limits. Without a card, or with a forbidden module loaded after the window,
it prints no result and exits with a code other than 0.
"""

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seed", type=int, required=True)
    parser.add_argument("--seconds", type=float, required=True)
    parser.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = parser.parse_args(argv)

    sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
    from cardbench.environment import prepare
    prepare()
    from cardbench import harness

    try:
        result = harness.run_cell(args.workload, args.seed, args.seconds,
                                  bool(args.trace), t_start=T_START)
    except harness.NoCard as e:
        print(f"cardbench: {e}", file=sys.stderr)
        return 2
    found = harness.banned_modules()
    if found:
        print(f"cardbench: forbidden modules loaded: {', '.join(found)}",
              file=sys.stderr)
        return 3
    for line in harness.check_lines(result):
        print(line, file=sys.stderr, flush=True)
    print(json.dumps(harness.jsonable(result)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
