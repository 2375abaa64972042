"""The benchmark's own machinery: seeds, weights, draws, the
profiler's reduction, the peaks, the check that decides ``correct``."""
