"""The check fails what it must: a run of each cell at a tiny size on the
CPU (the harness's look for a card skipped, the rest of the run driven)
with each fault of ``faults.py`` planted under the timed path comes out
not correct, and so does the control, the reference one precision below
the configuration's in the program's place."""
from __future__ import annotations

import pytest

from swarmbench import tiny
from swarmbench.faults import FAULTS

tiny.pin_threads()


@pytest.mark.parametrize("fault", FAULTS)
@pytest.mark.parametrize("cell", tiny.CELLS)
def test_a_planted_fault_is_not_correct(cell, fault):
    from swarmbench import faults
    from swarmbench.drivers import swarm_round as D
    ctx = tiny.context(cell)
    ctx.faults = lambda: faults.planted(fault)
    out = D.run(ctx)
    assert not out["correct"], out["checks"]


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_control_is_not_correct(cell):
    from swarmbench.calibrate import LOWER
    from swarmbench.drivers import swarm_round as D
    from swarmbench.harness import checks
    ctx = tiny.context(cell)
    setup, _ = D.prepare(ctx.seed, ctx.workload, ctx.config, ctx.device)
    control = D.reference_readings(setup, LOWER[ctx.config["compute_dtype"]])
    ok, table = checks.verdict(D.judge(setup, control), ctx.workload["check"]["limits"])
    assert not ok, table
    sound = D.reference_readings(setup, "float32")
    ok, table = checks.verdict(D.judge(setup, sound), ctx.workload["check"]["limits"])
    assert ok, table
