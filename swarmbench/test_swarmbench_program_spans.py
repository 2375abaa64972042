"""The readers of the program's own spans (``forward_ms``, ``backward_ms``,
``optimizer_ms``, ``coordinator_host_ms``, through
``harness/program_spans.py``): the sums of the program's spans and the
harness's coordinator span over a profile's events;
a profiled round's share of them, ``backward_ms`` as the gradient's
kernels less the forward's; nothing from an empty profile, a profile
without the program's spans, a caller without a profile, or a device
time where no kernel was traced; a tiny traced run of the cell on the
CPU counts each span once a step or a round, and reads the host's time
in the coordinator."""
from __future__ import annotations

import importlib
from types import SimpleNamespace

import pytest

from swarmbench import tiny

tiny.pin_threads()
READERS = ["forward_ms", "backward_ms", "optimizer_ms", "coordinator_host_ms"]
DEVICE_READERS = READERS[:3]
COORD = "repro_torch.core.engine:_coordinate"


def _read(summary) -> dict:
    return {n: importlib.import_module(f"swarmbench.metrics.{n}").read(summary)
            for n in READERS}


def _event(name, start_us, end_us, cpu=True):
    from torch.autograd import DeviceType
    return SimpleNamespace(name=name, device_type=DeviceType.CPU if cpu else DeviceType.CUDA,
                           time_range=SimpleNamespace(start=start_us, end=end_us))


def _events(rounds: int, steps: int) -> list:
    """A round: ``steps`` local steps, each a 5-ms gradient around a
    2-ms forward, then a 1-ms optimizer; then a 30-ms coordinator;
    among other ops and the device-side copies of the spans."""
    out, t = [], 0.0
    for _ in range(rounds):
        for _ in range(steps):
            out += [_event("train.gradient", t, t + 5e3), _event("train.forward", t, t + 2e3),
                    _event("aten::mm", t, t + 1e3), _event("train.forward", t, t + 2e3, cpu=False),
                    _event("train.optimizer", t + 5e3, t + 6e3)]
            t += 6e3
        out.append(_event(COORD, t, t + 30e3))
        t += 30e3
    return out


def _summary(facts, rounds):
    from swarmbench.harness.trace import TraceSummary
    return TraceSummary(profiled_rounds=rounds, window_us=1e6, busy_us=5e5, span_device_us={},
                        kernel_us={}, facts=facts)


def test_the_readers_read_a_round_of_the_spans_sums():
    from swarmbench.harness import program_spans
    device_us = {"train.gradient": 2 * 4 * 10e3, "train.forward": 2 * 4 * 4e3,
                 "train.optimizer": 2 * 4 * 6e3, COORD: 2 * 1e3,
                 "swarmbench.round": 1e9}
    sums = program_spans.sums(_events(rounds=2, steps=4), device_us)
    assert sums == {
        "train.gradient": {"count": 8, "host_ms": pytest.approx(40.0), "device_ms": 80.0},
        "train.forward": {"count": 8, "host_ms": pytest.approx(16.0), "device_ms": 32.0},
        "train.optimizer": {"count": 8, "host_ms": pytest.approx(8.0), "device_ms": 48.0},
        COORD: {"count": 2, "host_ms": pytest.approx(60.0), "device_ms": 2.0}}
    got = _read(_summary({program_spans.KEY: sums}, rounds=2))
    assert got == pytest.approx({"forward_ms": 16.0, "backward_ms": 24.0, "optimizer_ms": 24.0,
                                 "coordinator_host_ms": 30.0})


def test_the_readers_find_nothing_where_nothing_was_traced():
    from swarmbench.harness import program_spans
    assert all(v is None for v in _read(_summary({}, rounds=2)).values())
    sums = program_spans.sums(_events(2, 4), {})       # the CPU: no kernel traced
    assert all("device_ms" not in s for s in sums.values())
    got = _read(_summary({program_spans.KEY: sums}, rounds=2))
    assert all(got[n] is None for n in DEVICE_READERS)
    assert got["coordinator_host_ms"] == pytest.approx(30.0)
    assert all(v is None for v in _read(_summary({program_spans.KEY: sums}, rounds=0)).values())
    # the parent's program: a profile without the program's spans
    assert program_spans.sums([_event("aten::mm", 0.0, 1.0)], {"aten::mm": 1.0}) == {}
    assert program_spans.facts(None) == {}              # no profile in the caller's frame


def test_a_tiny_traced_run_counts_the_spans_and_reads_the_coordinators_host_time():
    from swarmbench.drivers import swarm_round as D
    from swarmbench.harness import program_spans
    ctx = tiny.context(tiny.CELLS[0], trace=True)
    assert set(READERS) <= set(ctx.per_layer)
    setup, tr = D.prepare(ctx.seed, ctx.workload, ctx.config, ctx.device)
    D.install_weights(tr, setup.weights())
    rounds = ctx.workload["trace"]["profiled_rounds"]
    summary = D.profile_rounds(tr, setup, 0, rounds, D.metric_readers(ctx.per_layer))
    sums = summary.facts[program_spans.KEY]
    steps = ctx.workload["round"]["local_steps"]
    assert {n: s["count"] for n, s in sums.items()} == {
        "train.gradient": steps * rounds, "train.forward": steps * rounds,
        "train.optimizer": steps * rounds, COORD: rounds}
    assert sums["train.forward"]["host_ms"] < sums["train.gradient"]["host_ms"]
    got = _read(summary)
    assert all(got[n] is None for n in DEVICE_READERS), got   # no kernel on the CPU
    assert 0 < got["coordinator_host_ms"] == pytest.approx(
        sums[COORD]["host_ms"] / rounds)
