"""The control on the card: the plain reference computed with TF32 in the
program's place, at each cell's own size, must come out not correct by the
cell's limits, while the program on the same seed comes out correct.
(calibrate.py reads the same numbers over many seeds.)"""

import pytest

from cardbench import calibrate, harness
from cardbench.compare import verdict

CELLS = [w["name"] for w in harness.load_json(
    harness.ROOT / "BENCHMARK.json")["workloads"]]


@pytest.mark.card
@pytest.mark.parametrize("cell", CELLS)
def test_control_fails_and_program_passes(cell, card):
    limits = harness.load_json(harness.BENCH_DIR / "workloads"
                               / f"{cell}.json")["limits"]
    row = calibrate.readings(cell, 2 ** 31 + 777, control=True)
    assert verdict(row["program"], limits)[0], row["program"]
    control = {k: v for k, v in row["control"].items() if k in limits}
    assert not verdict(control, {k: limits[k] for k in control})[0], control
