"""coordinator_ms: the device time (ms) of one round's kernels launched inside
the harness's span around engine._coordinate: the upload (K1), k-means (K2) and the brain storm."""
from swarmbench.metrics import span_ms

SPAN = "repro_torch.core.engine:_coordinate"


def read(summary):
    return span_ms(summary, SPAN)
