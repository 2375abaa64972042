"""Per-layer metric readers, one module a metric, found by the metric's
name in ``BENCHMARK.json``. A reader has

- ``read(summary) -> float | None`` over a
  :class:`swarmbench.harness.trace.TraceSummary`; a reader that finds
  nothing to read returns None and the metric is left out of the line;
- optionally ``SPAN = "<module>:<function>"``: a program function that
  the traced run wraps in a ``record_function`` span of that name, for
  as long as the module has the function;
- optionally ``facts(setup) -> dict``: numbers the reader needs that
  come from the cell's shapes (operations, bytes), given the driver's
  ``Setup`` (``layout``, ``traffic``, ``config``, ``clients``); they
  land in ``summary.facts``."""


def span_ms(summary, span: str):
    """Device time of one round's kernels launched inside ``span`` (ms)."""
    us = summary.span_device_us.get(span)
    if not us or summary.profiled_rounds == 0:
        return None
    return us / summary.profiled_rounds / 1e3
