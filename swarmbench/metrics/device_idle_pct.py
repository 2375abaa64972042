"""device_idle_pct: the share of the profiled stretch's wall time in
which no operation ran on the device (%), ``1 - busy / wall`` with busy
the union of the device's activity spans."""


def read(summary):
    if summary.window_us <= 0 or summary.busy_us <= 0:
        return None
    return 100.0 * (1.0 - summary.busy_us / summary.window_us)
