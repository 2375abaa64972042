"""backward_ms: the device time (ms) of one profiled round's kernels launched
inside the program's ``train.gradient`` spans but not their
``train.forward`` children: each local step's backward pass, vmapped
over the clients."""
from swarmbench.harness import program_spans

facts = program_spans.facts


def read(summary):
    both = program_spans.per_round(summary, "train.gradient", "device_ms")
    forward = program_spans.per_round(summary, "train.forward", "device_ms")
    if both is None or forward is None:
        return None
    return both - forward
