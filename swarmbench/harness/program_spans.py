"""The program's own spans (``repro_torch.utils.trace``) and the harness's
span around the coordinator in a traced run's profile, for the metric
readers that read them.

The program opens its spans only while a profiler is on, as
``record_function`` events of that profile. A span's device time is
what ``harness/trace.summarize`` gives the harness's own spans: the
kernels whose launching op started while the span was open (so the
device's idle is not in it); its host time is its event's wall on the
host. The coordinator's span is the harness's (``coordinator_ms``), read
here on the host alone: a program span inside it shifts the ids by which
torch's profiler links kernels to events, and so changes which kernels
``summarize`` counts twice there.

A reader's ``facts`` is :func:`facts`. The harness hands ``facts`` only
the run's ``Setup``, so it reads the finished profile from its caller's
frame (``drivers/swarm_round.profile_rounds``), and reduces it once,
whichever reader asks first. A program without the spans, or a caller
without a profile, gives no facts, and the readers return None; so does
a device time on the CPU, where no kernel is traced."""
from __future__ import annotations

import sys
import weakref

KEY = "program_spans"
SPANS = ("train.gradient", "train.forward", "train.optimizer")
COORDINATOR = "repro_torch.core.engine:_coordinate"

_reduced = weakref.WeakKeyDictionary()       # profile -> its sums


def sums(events, device_us: dict) -> dict:
    """``{name: {count, host_ms[, device_ms]}}`` of the program's spans
    and the coordinator's among a profile's ``events``; ``device_us`` is
    the device time of each span's kernels (``TraceSummary.span_device_us``),
    and a span without a kernel has no ``device_ms``."""
    from torch.autograd import DeviceType
    out = {}
    for e in events:
        if e.device_type == DeviceType.CPU and (e.name in SPANS or e.name == COORDINATOR):
            o = out.setdefault(e.name, {"count": 0, "host_ms": 0.0})
            o["count"] += 1
            o["host_ms"] += (e.time_range.end - e.time_range.start) / 1e3
    for name, o in out.items():
        if device_us.get(name):
            o["device_ms"] = device_us[name] / 1e3
    return out


def reduce(prof) -> dict:
    """:func:`sums` over a finished ``torch.profiler`` profile."""
    from swarmbench.harness import trace as tracing
    if prof not in _reduced:
        device_us = tracing.summarize(prof, SPANS, 1, 0.0).span_device_us
        _reduced[prof] = sums(prof.events(), device_us)
    return _reduced[prof]


def facts(setup) -> dict:
    from torch.profiler import profile
    caller = sys._getframe(1).f_locals.values()
    prof = next((v for v in caller if isinstance(v, profile)), None)
    out = reduce(prof) if prof is not None else {}
    if not out:
        return {}
    print("[swarmbench] program spans over the profiled rounds: " + "; ".join(
        f"{n} x{o['count']} host {o['host_ms']:.3f} device {o.get('device_ms', 0.0):.3f} ms"
        for n, o in sorted(out.items())), file=sys.stderr, flush=True)
    return {KEY: out}


def per_round(summary, name: str, key: str):
    """``key`` of span ``name`` summed over the profile, a profiled round."""
    s = summary.facts.get(KEY, {}).get(name, {})
    if key not in s or not summary.profiled_rounds:
        return None
    return s[key] / summary.profiled_rounds
