"""The readings the limits in workloads/<cell>.json are set from.

    python3 cardbench/calibrate.py --workload <cell> --seeds 1,2,... \
        [--control-seeds 1,2,3]

For each seed: the inputs, one job of the program, the reference and the
numbers that decide `correct` (the lower readings); for each control seed
also the control, the reference itself computed with TF32 on in the
program's place, judged by the same numbers (the upper readings). One JSON
line per seed. The benchmark's own runs never run the control.
"""

import argparse
import json
import sys
import time
from pathlib import Path

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))

from cardbench import harness  # noqa: E402
from cardbench.environment import prepare  # noqa: E402


def readings(name: str, seed: int, control: bool, device: str = "cuda",
             overrides=None) -> dict:
    import torch

    bench = harness.load_json(harness.ROOT / "BENCHMARK.json")
    cell = harness.load_cell(bench, name, seed, device, overrides)
    job = harness.new_job(cell)
    t0 = time.perf_counter()
    record = job.run_once()
    out = {"seed": seed, "job_s": time.perf_counter() - t0}
    job.release()
    t0 = time.perf_counter()
    out["program"] = job.check(record)
    out["reference_s"] = time.perf_counter() - t0
    if control:
        t0 = time.perf_counter()
        out["control"] = job.check_control()
        out["control_s"] = time.perf_counter() - t0
    del job, record
    if device == "cuda":
        torch.cuda.empty_cache()
    return out


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    parser.add_argument("--workload", required=True)
    parser.add_argument("--seeds", required=True)
    parser.add_argument("--control-seeds", default="")
    args = parser.parse_args(argv)
    prepare()
    control = {int(s) for s in args.control_seeds.split(",") if s}
    for seed in [int(s) for s in args.seeds.split(",")]:
        row = readings(args.workload, seed, seed in control)
        print(json.dumps(harness.jsonable(row)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
