"""forward_ms: the device time (ms) of one profiled round's kernels launched
inside the program's ``train.forward`` spans: each local step's forward
pass, vmapped over the clients."""
from swarmbench.harness import program_spans

facts = program_spans.facts


def read(summary):
    return program_spans.per_round(summary, "train.forward", "device_ms")
