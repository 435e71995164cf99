"""On the card: each cell's control (the program's own TF32 path,
`calibrate.CONTROL`) comes out not correct, and the program at full fp32
comes out correct, at the cell's own size over fewer jobs than a run holds
(`gpbench/calibrate.py` reads as many as a run does; PERF.md gives those
readings). About four minutes on one H100."""

import pytest

from gpbench import calibrate
from gpbench.harness import spec

pytestmark = pytest.mark.card

# workload -> jobs
JOBS = {"maternp2_d3.pcg_n131072": 1, "grad_eq_d16.cg_n4096": 16, "maternp2_d3.fit_n16384": 6}


@pytest.mark.parametrize("workload", sorted(JOBS))
@pytest.mark.parametrize("seed", [2**31 + 11, 2**31 + 12, 2**31 + 13])
def test_control_fails_program_passes(card, workload, seed):
    cell = spec.cell(spec.load_benchmark(), workload)
    program = calibrate.readings(cell, seed, JOBS[workload], card, control=False)
    control = calibrate.readings(cell, seed, JOBS[workload], card, control=True)
    assert program["correct"], program
    assert not control["correct"], control
