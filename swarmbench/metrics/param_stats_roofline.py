"""param_stats_roofline: K1's least time over its device time (%).

The least time is the round's leaves read once and the statistics
written once (``flops/param_stats.py``, from the leaves' shapes) at
3.35 TB/s; the device time is the ``param_stats_kernel`` launches'
summed duration in the profiled rounds."""
from swarmbench.flops import param_stats
from swarmbench.harness.peaks import bytes_bound_s

KERNEL = "param_stats_kernel"


def facts(setup) -> dict:
    return {"param_stats_bytes": param_stats.bytes_moved([s for _, s in setup.layout])}


def read(summary):
    us = sum(t for name, (_, t) in summary.kernel_us.items() if KERNEL in name)
    n_bytes = summary.facts.get("param_stats_bytes")
    if not us or not n_bytes:
        return None
    return 100.0 * bytes_bound_s(n_bytes) * summary.profiled_rounds / (us * 1e-6)
