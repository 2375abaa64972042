"""eval_ms: the device time (ms) of one round's kernels launched inside
the harness's span around engine.eval_swarm: each client's val accuracy."""
from swarmbench.metrics import span_ms

SPAN = "repro_torch.core.engine:eval_swarm"


def read(summary):
    return span_ms(summary, SPAN)
