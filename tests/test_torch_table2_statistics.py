"""Table II's Local and BSO-SL rows, whole fits, held statistically:
the reference's ``run_sweep_table`` against the port's on the same data
over seeds 0-4, at ``benchmarks/table2_methods.run``'s settings (the
full Table I at 20 px, squeezenet-dr, 10 rounds of 12 local steps, k 3,
adam lr 2e-3, batch 8). The two packages draw different random numbers
from one seed, so the rows agree only in distribution.

Marked ``slow`` (about 10 minutes on 8 CPU cores); run it with::

    PYTHONPATH=src python -m pytest -q --runslow tests/test_torch_table2_statistics.py
"""
import math

import pytest

torch = pytest.importorskip("torch")

import jax  # noqa: E402
import numpy as np  # noqa: E402
from scipy import stats  # noqa: E402

from repro.configs import get_config as jax_get_config  # noqa: E402
from repro.configs.base import OptimizerConfig as JaxOptimizerConfig  # noqa: E402
from repro.configs.base import SwarmConfig as JaxSwarmConfig  # noqa: E402
from repro.core.baselines import run_sweep_table as jax_run_sweep_table  # noqa: E402
from repro.data.dr import make_dr_swarm_data, scale_table  # noqa: E402
from repro.models import build_model as jax_build_model  # noqa: E402
from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config  # noqa: E402
from repro_torch.core.baselines import run_sweep_table  # noqa: E402
from repro_torch.models import build_model  # noqa: E402
from torch_parity import pin_torch_threads  # noqa: E402

pin_torch_threads()

SEEDS = range(5)
ROWS = ("local", "bso-sl")
# ROADMAP C (5 seeds a package at these settings): BSO-SL 0.488 for the
# reference against 0.424 for the port, |t| = 1.2. The standard error of
# the difference of two 5-seed means is then 0.064 / 1.2 = 0.053, and a
# seed's spread sqrt(5 / 2) x 0.053 = 0.084.
SEED_SD = 0.064 / 1.2 * math.sqrt(5 / 2)
T_CRIT = 3.355                   # Student's t, 8 degrees of freedom, two-sided 1%
BAND = T_CRIT * SEED_SD * math.sqrt(2 / len(SEEDS))   # 0.179


def _fits(seed: int):
    clients = make_dr_swarm_data(image_size=20, seed=seed, table=scale_table(1))
    jacc, _ = jax_run_sweep_table(
        jax_build_model(jax_get_config("squeezenet-dr")), clients,
        JaxSwarmConfig(n_clients=14, n_clusters=3, rounds=10, local_steps=12),
        JaxOptimizerConfig(name="adam", lr=2e-3), jax.random.PRNGKey(seed), methods=ROWS,
        batch_size=8)
    tacc, _ = run_sweep_table(
        build_model(get_config("squeezenet-dr")), clients,
        SwarmConfig(n_clients=14, n_clusters=3, rounds=10, local_steps=12),
        OptimizerConfig(name="adam", lr=2e-3), seed, methods=ROWS, batch_size=8, device="cpu")
    return jacc, tacc


@pytest.mark.slow
def test_table2_local_and_bso_rows_match_the_reference_in_distribution():
    """Each row's 5-seed mean within ``BAND`` of the reference's: the
    two-sided 1% band of a difference of 5-seed means at ROADMAP C's
    per-seed spread. Welch's t is printed beside it."""
    runs = [_fits(s) for s in SEEDS]
    for row in ROWS:
        ref = np.array([j[row] for j, _ in runs])
        port = np.array([t[row] for _, t in runs])
        t, p = stats.ttest_ind(ref, port, equal_var=False)
        print(f"[table2 {row}] reference {ref.round(4).tolist()} mean {ref.mean():.4f} sd "
              f"{ref.std(ddof=1):.4f}; port {port.round(4).tolist()} mean {port.mean():.4f} sd "
              f"{port.std(ddof=1):.4f}; Welch t {t:.3f}, p {p:.3f}; band {BAND:.3f}")
        assert abs(ref.mean() - port.mean()) <= BAND, \
            f"{row}: port mean {port.mean():.4f} off the reference's {ref.mean():.4f}"
