"""Quickstart on the PyTorch/CUDA port: the full BSO-SL protocol on the
synthetic DR swarm.

    PYTHONPATH=src python examples/quickstart_torch.py                 # on the card
    PYTHONPATH=src python examples/quickstart_torch.py --device cpu

14 clinics (Table-I-exact class distribution, scaled down by 8),
SqueezeNet clients, 3 clusters, the paper's p1=0.9 / p2=0.8. The
counterpart of ``examples/quickstart.py``, through ``repro_torch``:

1. the round engine, ``engine.run_rounds``: the whole multi-round
   protocol (local steps with on-device batch sampling, the
   distribution upload, k-means, the brain storm, Eq. 2 aggregation).
   The rounds run one after another; the reference scans them into one
   device program;
2. the hyper-parameter grid, a k x p1 x p2 mini-ablation of the knobs
   the paper fixes (``baselines.run_grid_table`` over
   ``engine.run_grid``). Its rows run in turn, where the reference
   vmaps them into one program;
3. the stateful ``SwarmTrainer`` replaying the same protocol round by
   round with per-round logs.
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import numpy as np

from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
from repro_torch.core.baselines import run_grid_table
from repro_torch.core.engine import (EngineConfig, make_client_eval, make_swarm_data,
                                     make_swarm_state, run_rounds, stack_eval_split)
from repro_torch.core.swarm import SwarmTrainer
from repro_torch.data.dr import TABLE_I, make_dr_swarm_data
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.utils.device import resolve_device

ROUNDS = 5
LOCAL_STEPS = 8
IMAGE_SIZE = 16
TABLE_DIV = 8                     # Table I's counts divided by this, at least 2 a nonzero cell
GRID_AXES = dict(k=(1, 3), p1=(0.9, 1.0), p2=(0.8,))


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    dev = resolve_device(args.device)

    table = np.maximum(TABLE_I // TABLE_DIV, (TABLE_I > 0).astype(np.int64) * 2)
    clients = make_dr_swarm_data(image_size=IMAGE_SIZE, seed=0, table=table)
    print(f"clinics: {len(clients)}, train sizes: {[c['n_train'] for c in clients]}, on {dev}")

    model = build_model(get_config("squeezenet-dr"))
    opt = make_optimizer(OptimizerConfig(name="adam", lr=2e-3))

    # ---- the round engine: every round through run_rounds ----
    cfg = EngineConfig(model=model, opt=opt, local_steps=LOCAL_STEPS, batch_size=8, lr=2e-3,
                       aggregation="bso", n_clusters=3, p1=0.9, p2=0.8)
    data = make_swarm_data(model.cfg, clients, device=dev)
    state = make_swarm_state(model, opt, clients, 0, device=dev)

    print(f"\nBSO-SL engine: {ROUNDS} rounds through run_rounds "
          f"(k={cfg.n_clusters}, p1={cfg.p1}, p2={cfg.p2})")
    state, metrics = run_rounds(state, data, cfg, ROUNDS)
    for r in range(ROUNDS):
        print(f"  round {r:3d} val_acc={float(metrics.mean_val_acc[r]):.4f} "
              f"loss={float(metrics.train_loss[r]):.4f} "
              f"replaces={int(metrics.n_replaced[r])} "
              f"swaps={int(metrics.n_swapped[r])}")

    scores = make_client_eval(model)(state.params,
                                     stack_eval_split(model.cfg, clients, "test", device=dev))
    print(f"mean per-clinic test accuracy (paper Eq. 3): {float(scores.mean()):.4f}")
    print(f"final clusters: {metrics.assignments[-1].tolist()}")
    print(f"final centers:  {metrics.centers[-1].tolist()}")

    # ---- the grid: a k x p1 x p2 mini-ablation ----
    swarm = SwarmConfig(n_clients=14, n_clusters=3, rounds=ROUNDS, local_steps=LOCAL_STEPS)
    n_rows = int(np.prod([len(v) for v in GRID_AXES.values()]))
    print(f"\nGrid: {GRID_AXES} - {n_rows} full fits through run_grid_table")
    results, _ = run_grid_table(model, clients, swarm, OptimizerConfig(name="adam", lr=2e-3), 2,
                                axes=GRID_AXES, batch_size=8, device=dev)
    for res in results:
        spec = ", ".join(f"{k}={v}" for k, v in res.items() if k != "acc")
        print(f"  {spec:<24s} test_acc={res['acc']:.4f}")

    # ---- the stateful wrapper: same protocol, per-round host logs ----
    swarm = SwarmConfig(n_clients=14, n_clusters=3, p1=0.9, p2=0.8, rounds=ROUNDS,
                        local_steps=LOCAL_STEPS)
    trainer = SwarmTrainer(model, clients, swarm, OptimizerConfig(name="adam", lr=2e-3), 0,
                           batch_size=8, aggregation="bso", device=dev)
    print("\nSwarmTrainer (one round a call):")
    trainer.fit(verbose=True)
    print(f"mean test accuracy: {trainer.mean_accuracy('test'):.4f}")


if __name__ == "__main__":
    main()
