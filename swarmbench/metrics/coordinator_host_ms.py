"""coordinator_host_ms: the host's wall (ms) inside the harness's span around
engine._coordinate in one profiled round: issuing the upload (K1),
k-means and the brain storm, and waiting at the brain storm's first read
of the device (``core/bso.py``), which drains the local phase and eval
before it. Read under the profiler, which slows the host's issue."""
from swarmbench.harness import program_spans

SPAN = program_spans.COORDINATOR
facts = program_spans.facts


def read(summary):
    return program_spans.per_round(summary, SPAN, "host_ms")
