"""aggregate_ms: the device time (ms) of one round's kernels launched inside
the harness's span around engine._aggregate: Eq. 2."""
from swarmbench.metrics import span_ms

SPAN = "repro_torch.core.engine:_aggregate"


def read(summary):
    return span_ms(summary, SPAN)
