"""local_phase_ms: the device time (ms) of one round's kernels launched inside
the harness's span around engine.local_phase: the local steps (train step
and adam, vmapped over the clients)."""
from swarmbench.metrics import span_ms

SPAN = "repro_torch.core.engine:local_phase"


def read(summary):
    return span_ms(summary, SPAN)
