# NOTE: deliberately NO xla_force_host_platform_device_count here —
# smoke tests and benches must see the single real CPU device; only
# repro.launch.dryrun / swarm_fleet set the 512-device stand-in flag.
import os
import sys

import pytest

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))


def pytest_addoption(parser):
    parser.addoption(
        "--runslow", action="store_true", default=False,
        help="run tests marked slow (extra seeds of the statistical "
             "parity tests — the nightly tier; tier-1 runs one seed)")


def pytest_configure(config):
    config.addinivalue_line(
        "markers",
        "slow: extra-seed replicas of statistical tests; skipped unless "
        "--runslow (nightly) — tier-1 keeps one pinned seed per test")
    config.addinivalue_line(
        "markers",
        "cuda: needs an NVIDIA card (the port's CUDA kernels); skips "
        "where torch.cuda.is_available() is false")


def pytest_collection_modifyitems(config, items):
    if config.getoption("--runslow"):
        return
    skip_slow = pytest.mark.skip(reason="needs --runslow (nightly tier)")
    for item in items:
        if "slow" in item.keywords:
            item.add_marker(skip_slow)
