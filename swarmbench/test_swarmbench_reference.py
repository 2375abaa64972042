"""The plain reference agrees with the port's round at a tiny size on
the CPU: the whole run of each cell (set-up, its check rounds through
``SwarmTrainer.round``, one timed round, the reference over the same
weights, data and draws) comes out correct, every compared number under
its limit."""
from __future__ import annotations

import pytest

from swarmbench import tiny

tiny.pin_threads()


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_port_round_agrees_with_the_reference(cell):
    from swarmbench.drivers import swarm_round as D
    ctx = tiny.context(cell)
    out = D.run(ctx)
    assert out["failed"] == 0 and out["attempted"] == 1
    assert out["correct"], out["checks"]
    assert out["checks"]["coord_mismatch"]["value"] == 0
    assert set(out["e2e"]) == {"round_s", "peak_mem_gib", "setup_s"}


def test_the_traced_run_reads_every_per_layer_metric_it_can_on_the_cpu():
    import importlib

    from swarmbench.drivers import swarm_round as D
    ctx = tiny.context(tiny.CELLS[0], trace=True)
    out = D.run(ctx)
    s = out["summary"]
    assert out["correct"] and s.profiled_rounds == 2 and s.window_us > 0
    assert s.facts["round_flops"] > 0 and s.facts["param_stats_bytes"] > 0
    assert importlib.import_module("swarmbench.metrics.mfu_pct").read(s) > 0
    # no device on the CPU: the device's metrics find nothing and are left out
    for name in ("local_phase_ms", "param_stats_roofline", "device_idle_pct"):
        assert importlib.import_module(f"swarmbench.metrics.{name}").read(s) is None


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_the_upload_observer_records_the_programs_own_upload(cell):
    """The check compares K1's upload as the coordinator got it, not the
    reference's statistics of the same weights read twice."""
    import torch

    from repro_torch.core import engine
    from swarmbench.drivers import swarm_round as D
    ctx = tiny.context(cell)
    setup, tr = D.prepare(ctx.seed, ctx.workload, ctx.config, ctx.device)
    D.install_weights(tr, setup.weights())
    handed = []
    orig = engine.swarm_distribution_matrix

    def spy(*a, **k):
        handed.append(orig(*a, **k).clone())
        return handed[-1]

    engine.swarm_distribution_matrix = spy
    try:
        prog, _ = D.check_rounds(tr, setup)
    finally:
        engine.swarm_distribution_matrix = orig
    assert len(prog.upload) == len(handed) == ctx.workload["check"]["rounds"]
    for got, want, ref in zip(prog.upload, handed, prog.features):
        assert torch.equal(got, want.float().cpu())
        assert got.shape == ref.shape and torch.allclose(got, ref, rtol=1e-4, atol=1e-6)
