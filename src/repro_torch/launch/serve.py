"""Serving launcher (counterpart of ``repro.launch.serve``).

* :func:`prefill_into_cache` is the per-token teacher-forcing reference
  that the engine's chunked prefill is held against;
* :func:`run_serve` generates for a few random prompts through the
  continuous-batching engine. Families without a chunked prefill are
  not ported yet and raise (the reference's per-token loop for them is
  not ported).

PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --tokens 32
(on the card; add ``--device cpu`` to run on the CPU)
"""
from __future__ import annotations

import argparse
import time

import numpy as np
import torch

from repro_torch.configs import get_config
from repro_torch.models import build_model
from repro_torch.serve import BucketSpec, generate
from repro_torch.train.steps import make_serve_step
from repro_torch.utils.device import resolve_device


def prefill_into_cache(model, params, prompts: torch.Tensor, cache):
    """Teacher-force prompts (B, P) through P decode steps at positions
    0..P-1; returns (the greedy token after the last, cache)."""
    step = make_serve_step(model)
    last = None
    for t in range(prompts.shape[1]):
        last, _, cache = step(params, prompts[:, t:t + 1], cache, t)
    return last, cache


def run_serve(arch: str, *, batch: int = 4, prompt_len: int = 8, tokens: int = 16,
              seed: int = 0, smoke: bool = True, verbose: bool = False, device=None):
    """Generate ``tokens`` greedy tokens for ``batch`` random prompts
    (numpy's generator from ``seed``, params from a torch generator
    seeded with it) in one bucket. Returns ``(gen, info)``: the
    (batch, tokens) int32 generations and a stats dict."""
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    model = build_model(cfg)
    if model.prefill is None:
        raise NotImplementedError(f"{arch}: no chunked prefill; the per-token serve loop "
                                  "is not ported")
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if verbose:
        print(f"[serve] arch={cfg.arch_id} params={model.param_count(params):,} on {dev}")
    prompts = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (batch, prompt_len),
                                                       dtype=np.int32)
    t0 = time.perf_counter()
    res = generate(model, params, list(prompts), max_new_tokens=tokens,
                   buckets=(BucketSpec(batch, prompt_len + tokens + 1),), device=dev)
    gen = np.asarray([r.tokens for r in res], np.int32)
    dt = time.perf_counter() - t0
    info = {"device": str(dev), "tok_per_s": tokens * batch / max(dt, 1e-9), "wall_s": dt}
    if verbose:
        print(f"decoded {tokens} tokens x {batch} seqs in {dt:.2f}s on {dev} "
              f"({info['tok_per_s']:.1f} tok/s)")
        print("sample:", gen[0].tolist())
    return gen, info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args()
    run_serve(args.arch, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
              seed=args.seed, device=args.device, verbose=True)


if __name__ == "__main__":
    main()
