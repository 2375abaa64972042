"""The traced stretch of a run: ``torch.profiler`` over a few rounds,
reduced to what the per-layer metrics read (:class:`TraceSummary`) and
to the ``breakdown`` of the result line.

``device_busy_us`` is a copy of ``chip_smoke.py``'s ``device_busy_us``
(the union of the device's activity spans), here over every device
event that is not a span's annotation."""
from __future__ import annotations

from dataclasses import dataclass, field

ROUND_SPAN = "swarmbench.round"


@dataclass
class TraceSummary:
    profiled_rounds: int
    window_us: float                          # wall of the profiled stretch
    busy_us: float                            # union of device activity
    span_device_us: dict                      # span -> summed device time of its kernels
    kernel_us: dict                           # kernel name -> (launches, summed us)
    facts: dict = field(default_factory=dict)  # counts from shapes and the window (drivers/)
    breakdown: dict = field(default_factory=dict)


def _is_device(e, spans) -> bool:
    from torch.autograd import DeviceType
    return (e.device_type == DeviceType.CUDA and e.name not in spans
            and not getattr(e, "is_user_annotation", False))


def device_busy_us(events, spans=()):
    """(microseconds in which at least one device operation ran, its spans)."""
    intervals = sorted((e.time_range.start, e.time_range.end) for e in events
                       if _is_device(e, spans))
    busy, end = 0.0, float("-inf")
    for a, b in intervals:
        if b > end:
            busy += b - max(a, end)
            end = b
    return busy, intervals


def _host_spans(events, spans):
    from torch.autograd import DeviceType
    return sorted((e.time_range.start, e.time_range.end, e.name) for e in events
                  if e.device_type == DeviceType.CPU and e.name in spans)


def _label(t: float, host) -> str:
    """The innermost harness span the host was in at time ``t``."""
    best = None
    for s, e, name in host:
        if s <= t <= e and (best is None or e - s < best[1] - best[0]):
            best = (s, e, name)
    return "host between rounds" if best is None else f"host in {best[2]}"


def summarize(prof, spans, rounds: int, window_us: float) -> TraceSummary:
    from torch.autograd import DeviceType
    events = prof.events()
    span_set = set(spans) | {ROUND_SPAN}
    busy, intervals = device_busy_us(events, span_set)
    host = _host_spans(events, span_set)
    # a kernel belongs to every span that was open, on any thread, when the
    # op that launched it started: backward ops run on autograd's own
    # thread, outside the span's tree of children
    span_us = {}
    linked = 0.0
    for e in events:
        if e.device_type == DeviceType.CPU and e.kernels:
            us = sum(k.duration for k in e.kernels)
            linked += us
            t = e.time_range.start
            for s, end, name in host:
                if s <= t <= end:
                    span_us[name] = span_us.get(name, 0.0) + us
    kernels = {}
    for e in events:
        if _is_device(e, span_set):
            n, us = kernels.get(e.name, (0, 0.0))
            kernels[e.name] = (n + 1, us + (e.time_range.end - e.time_range.start))
    end = float("-inf")
    merged = []
    for a, b in intervals:                       # gaps between the union's pieces
        if merged and a <= end:
            end = max(end, b)
        else:
            merged.append([a, b])
            end = b
        merged[-1][1] = end
    gaps = sorted(((a1 - b0, a1) for (_, b0), (a1, _) in zip(merged, merged[1:])), reverse=True)
    top_ops = sorted(kernels.items(), key=lambda kv: -kv[1][1])[:10]
    breakdown = {"device_ops": [[name, us / 1e6] for name, (_, us) in top_ops],
                 "idle_gaps": [[_label(t, host), us / 1e6] for us, t in gaps[:10]]}
    return TraceSummary(profiled_rounds=rounds, window_us=window_us, busy_us=busy,
                        span_device_us=span_us, kernel_us=kernels, breakdown=breakdown,
                        facts={"kernel_us_linked": linked,
                               "kernel_us_all": sum(us for _, us in kernels.values())})
