"""The paper's Table II and Table III on the PyTorch/CUDA port.

    PYTHONPATH=src python examples/paper_tables_torch.py [--full]
    PYTHONPATH=src python examples/paper_tables_torch.py --device cpu

``--full`` uses the complete Table-I sample counts (3,657 images) and 8
rounds; without it Table I is divided by 8 and 4 rounds run, as in
``examples/paper_tables.py``. Both tables take
``benchmarks/table2_methods.py``'s and ``benchmarks/table3_archs.py``'s
settings: 20 px images, 14 clinics, k 3, 12 local steps, adam lr 2e-3,
batch 8, seed 0.

- Table II: the four methods (centralized, local, FedAvg, BSO-SL) of
  squeezenet-dr through ``baselines.run_sweep_table``; its rows run in
  turn, where the reference vmaps them into one program.
- Table III: BSO-SL over AlexNet, VGG, Inception and SqueezeNet clients
  (``baselines.run_method("bso-sl")``), one device-resident dataset
  shared by the four fits, one line an architecture with its seconds,
  accuracy, the paper's accuracy and its parameter count.
"""
import argparse
import os
import sys
import time

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

import torch

from repro_torch.configs import OptimizerConfig, SwarmConfig, get_config
from repro_torch.core.baselines import make_method_setup, run_method, run_sweep_table
from repro_torch.data.dr import make_dr_swarm_data, scale_table
from repro_torch.models import build_model
from repro_torch.utils.device import resolve_device

# the paper's accuracies (Eq. 3)
PAPER_TABLE2 = {"centralized": 0.4118, "local": 0.1924, "fedavg": 0.3719, "bso-sl": 0.3725}
ARCHS = ["alexnet-dr", "vgg-dr", "inception-dr", "squeezenet-dr"]
PAPER_TABLE3 = {"alexnet-dr": 0.3703, "vgg-dr": 0.4016, "inception-dr": 0.4216,
                "squeezenet-dr": 0.3725}

# the benchmarks' settings
IMAGE_SIZE = 20
LOCAL_STEPS = 12
BATCH = 8
SEED = 0


def scale_and_rounds(full: bool):
    """(Table I divisor, rounds): the full table and 8 rounds, else an
    eighth of it and 4."""
    return (1, 8) if full else (8, 4)


def _setup(data_scale: int, rounds: int):
    clients = make_dr_swarm_data(image_size=IMAGE_SIZE, seed=SEED,
                                 table=scale_table(data_scale))
    swarm = SwarmConfig(n_clients=14, n_clusters=3, rounds=rounds, local_steps=LOCAL_STEPS)
    return clients, swarm, OptimizerConfig(name="adam", lr=2e-3)


def _sync(dev) -> None:
    if dev.type == "cuda":
        torch.cuda.synchronize(dev)


def table2(full: bool = False, device=None) -> dict:
    """Table II's four methods as one ``run_sweep_table``; returns
    ``{method: Eq. 3 test acc}``."""
    dev = resolve_device(device)
    clients, swarm, opt = _setup(*scale_and_rounds(full))
    model = build_model(get_config("squeezenet-dr"))
    t0 = time.perf_counter()
    accs, _ = run_sweep_table(model, clients, swarm, opt, SEED, batch_size=BATCH, device=dev)
    _sync(dev)
    us = (time.perf_counter() - t0) * 1e6
    for m, acc in accs.items():
        print(f"table2/{m},{us / len(accs):.1f},acc={acc:.4f};paper_acc={PAPER_TABLE2[m]:.4f}")
    return accs


def table3(full: bool = False, device=None, archs=ARCHS) -> dict:
    """Table III: ``run_method("bso-sl")`` of each of ``archs`` on one
    shared dataset. Returns ``{arch: {"acc", "seconds", "params",
    "run"}}``, ``run`` the fit's ``MethodRun``."""
    dev = resolve_device(device)
    clients, swarm, opt = _setup(*scale_and_rounds(full))
    results, data = {}, None
    for arch in archs:
        model = build_model(get_config(arch))
        cfg, data = make_method_setup(model, clients, swarm, opt, batch_size=BATCH, data=data,
                                      device=dev)
        n = model.param_count(model.init(torch.Generator(device=dev).manual_seed(SEED)))
        t0 = time.perf_counter()
        acc, run = run_method("bso-sl", model, clients, swarm, opt, SEED, batch_size=BATCH,
                              cfg=cfg, data=data)
        _sync(dev)
        secs = time.perf_counter() - t0
        results[arch] = {"acc": acc, "seconds": secs, "params": n, "run": run}
        print(f"table3/{arch},{secs * 1e6:.1f},acc={acc:.4f};"
              f"paper_acc={PAPER_TABLE3[arch]:.4f};params={n}")
    return results


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--full", action="store_true")
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    print("=== Table II: method comparison ===")
    print("name,us_per_call,derived")
    r2 = table2(args.full, args.device)
    print("\npaper:      centralized 0.4118 | local 0.1924 | fedavg 0.3719 | bso-sl 0.3725")
    print("reproduced: " + " | ".join(f"{k} {v:.4f}" for k, v in r2.items()))

    print("\n=== Table III: model-agnostic sweep ===")
    print("name,us_per_call,derived")
    r3 = table3(args.full, args.device)
    print("\npaper:      alexnet 0.3703 | vgg 0.4016 | inception 0.4216 | squeezenet 0.3725")
    print("reproduced: " + " | ".join(f"{k.split('-')[0]} {v['acc']:.4f}"
                                      for k, v in r3.items()))
    return r2, r3


if __name__ == "__main__":
    main()
