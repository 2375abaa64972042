"""End-to-end training driver (counterpart of ``repro.launch.train``).

Two modes:
  * single   train one LM on synthetic non-IID token data (``--preset
             100m`` is the ~100M-parameter driver), adamw on a cosine
             schedule, with an optional ``--ckpt``;
  * swarm    the full BSO-SL protocol over simulated clients with any
             ported ``--arch``: the CNNs on Table-I data, an LM (dense,
             moe, ssm or hybrid) at its ``smoke()`` width on
             ``make_token_swarm_data``.

Both run on ``cuda`` unless ``--device`` names another device::

  PYTHONPATH=src python -m repro_torch.launch.train --mode single --preset 100m --steps 300
  PYTHONPATH=src python -m repro_torch.launch.train --mode swarm --arch granite-3-2b --rounds 2
  PYTHONPATH=src python -m repro_torch.launch.train --mode swarm --arch mamba2-370m --rounds 1
  PYTHONPATH=src python -m repro_torch.launch.train --mode single --preset tiny --device cpu
"""
from __future__ import annotations

import argparse
import time

import torch

from repro_torch.checkpoint import save_checkpoint
from repro_torch.configs import get_config
from repro_torch.configs.base import ModelConfig, OptimizerConfig, SwarmConfig
from repro_torch.core.swarm import SwarmTrainer
from repro_torch.data.dr import make_dr_swarm_data, scale_table
from repro_torch.data.tokens import make_lm_batches, make_token_swarm_data
from repro_torch.models import build_model
from repro_torch.optim.optimizers import make_optimizer
from repro_torch.optim.schedules import make_schedule
from repro_torch.train.steps import make_train_step
from repro_torch.utils.device import resolve_device

PRESETS = {
    # ~1M params: smoke
    "tiny": dict(n_layers=2, d_model=128, n_heads=4, n_kv_heads=2,
                 d_ff=512, vocab_size=512),
    # ~26M params: CI-scale end to end
    "26m": dict(n_layers=6, d_model=512, n_heads=8, n_kv_heads=4,
                d_ff=2048, vocab_size=2048),
    # ~104M params: the paper-scale end-to-end driver
    "100m": dict(n_layers=12, d_model=768, n_heads=12, n_kv_heads=4,
                 d_ff=3072, vocab_size=8192),
}


def preset_config(name: str) -> ModelConfig:
    return ModelConfig(arch_id=f"lm-{name}", family="dense", act="swiglu",
                       norm="rmsnorm", dtype="float32", param_dtype="float32",
                       scan_layers=False, **PRESETS[name])


def run_single(args) -> float:
    """Train one LM of ``args.preset`` (:func:`train_single`); returns the
    last step's cross-entropy, as the reference does."""
    return train_single(args)[1][-1]


def train_single(args, params=None):
    """Train one LM of ``args.preset`` for ``args.steps`` steps on
    ``make_lm_batches`` (client 0, ``args.seed``). ``params`` replaces
    the seeded init (a parity test passes the reference's). Returns
    ``(params, ce)``: the trained params and each step's cross-entropy,
    read on the host once at the end."""
    dev = resolve_device(args.device)
    cfg = preset_config(args.preset)
    model = build_model(cfg)
    if params is None:
        params = model.init(torch.Generator(device=dev).manual_seed(args.seed))
    print(f"[train] arch={cfg.arch_id} params={model.param_count(params):,} on {dev}")

    opt = make_optimizer(OptimizerConfig(name="adamw", lr=args.lr))
    opt_state = opt.init(params)
    sched = make_schedule("cosine", args.lr, warmup=max(10, args.steps // 20),
                          total_steps=args.steps)
    step_fn = make_train_step(model, opt)

    ces = []
    t0 = time.time()
    it = make_lm_batches(cfg.vocab_size, args.batch, args.seq, args.steps, client=0,
                         seed=args.seed)
    for i, batch in enumerate(it):
        b = {k: torch.as_tensor(v, device=dev) for k, v in batch.items()}
        params, opt_state, metrics = step_fn(params, opt_state, b, sched(i))
        ces.append(metrics["ce"].detach())
        if i % max(1, args.steps // 20) == 0 or i == args.steps - 1:
            ce, acc = float(metrics["ce"]), float(metrics["acc"])
            tok_s = (i + 1) * args.batch * args.seq / (time.time() - t0)
            print(f"step {i:5d} loss={ce:.4f} acc={acc:.4f} tok/s={tok_s:,.0f}")
    if args.ckpt:
        save_checkpoint(args.ckpt, params, step=args.steps)
        print(f"checkpoint saved to {args.ckpt}.npz")
    return params, torch.stack(ces).cpu().tolist()


def run_swarm(args):
    """BSO-SL over ``args.arch``; returns the mean test accuracy (Eq. 3)."""
    dev = resolve_device(args.device)
    cfg = get_config(args.arch)
    if cfg.family == "cnn":
        clients = make_dr_swarm_data(image_size=args.image_size, seed=args.seed,
                                     table=scale_table(args.data_scale))
    else:
        cfg = cfg.smoke()
        clients = make_token_swarm_data(args.clients, cfg.vocab_size, n_seqs=32, seq_len=64,
                                        seed=args.seed)
    model = build_model(cfg)
    swarm = SwarmConfig(n_clients=len(clients), n_clusters=args.clusters,
                        rounds=args.rounds, local_steps=args.local_steps)
    tr = SwarmTrainer(model, clients, swarm, OptimizerConfig(name="adam", lr=args.lr),
                      seed=args.seed, batch_size=args.batch, aggregation="bso", device=dev)
    tr.fit(verbose=True)
    acc = tr.mean_accuracy("test")
    print(f"[swarm] final mean test accuracy (Eq.3): {acc:.4f}")
    return acc


def parse_args(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--mode", default="single", choices=["single", "swarm"])
    ap.add_argument("--preset", default="tiny", choices=list(PRESETS))
    ap.add_argument("--arch", default="squeezenet-dr")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--rounds", type=int, default=5)
    ap.add_argument("--local-steps", type=int, default=5)
    ap.add_argument("--clients", type=int, default=14)
    ap.add_argument("--clusters", type=int, default=3)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=256)
    ap.add_argument("--image-size", type=int, default=16)
    ap.add_argument("--data-scale", type=int, default=8,
                    help="divide Table I counts by this for CPU runs")
    ap.add_argument("--lr", type=float, default=1e-3)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--ckpt", default="")
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    return ap.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    if args.mode == "single":
        return run_single(args)
    return run_swarm(args)


if __name__ == "__main__":
    main()
