"""Serving launcher (counterpart of ``repro.launch.serve``).

* :func:`prefill_into_cache` is the per-token teacher-forcing reference
  that the engine's chunked prefill is held against, and the only
  prefill of the families without one (ssm, hybrid, vlm, encdec);
* :func:`loop_generate` is the per-token loop: that prefill, then one
  greedy decode step a token;
* :func:`run_serve` generates for a few random prompts through the
  continuous-batching engine when the family has a chunked prefill and
  through the per-token loop otherwise, as the reference routes them.

PYTHONPATH=src python -m repro_torch.launch.serve --arch granite-3-2b --tokens 32
(on the card; add ``--device cpu`` to run on the CPU)

The encoder-decoder (whisper-base) decodes against its cross cache as
the reference's loop leaves it: zeros, since nothing runs the encoder
when serving.
"""
from __future__ import annotations

import argparse
import time
from dataclasses import replace

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


def loop_generate(model, params, prompts: torch.Tensor, tokens: int) -> torch.Tensor:
    """The per-token loop: prompts (B, P) teacher-forced into a fresh
    cache of P + tokens + 1 positions, the greedy token after the prompt
    first, then ``tokens - 1`` decode steps at positions P, P+1, ...
    Returns the (B, tokens) int32 generations on the prompts' device."""
    B, P = prompts.shape
    cache = model.init_cache(B, P + tokens + 1, prompts.device)
    tok, cache = prefill_into_cache(model, params, prompts, cache)
    step = make_serve_step(model)
    out = [tok]
    for i in range(tokens - 1):
        tok, _, cache = step(params, out[-1][:, None], cache, P + i)
        out.append(tok)
    return torch.stack(out, dim=1)


def run_serve(arch: str, *, batch: int = 4, prompt_len: int = 8, tokens: int = 16,
              seed: int = 0, smoke: bool = True, engine: str = "auto", verbose: bool = False,
              device=None, layers: int = 0):
    """Generate ``tokens`` greedy tokens for ``batch`` random prompts
    (numpy's generator from ``seed``, params from a torch generator
    seeded with it). ``engine="auto"`` takes the continuous-batching
    engine (one bucket) when the family has a chunked prefill and the
    per-token loop (:func:`loop_generate`) otherwise; ``"loop"`` forces
    the loop, ``"engine"`` the engine. ``layers`` > 0 cuts the config to
    that many (decoder) layers. Returns ``(gen, info)``: the (batch,
    tokens) int32 generations and a stats dict whose ``path`` names the
    path taken."""
    if engine not in ("auto", "engine", "loop"):
        raise ValueError(f"engine must be 'auto', 'engine' or 'loop', got {engine!r}")
    dev = resolve_device(device)
    cfg = get_config(arch)
    if smoke:
        cfg = cfg.smoke()
    if layers:
        cfg = replace(cfg, n_layers=layers)
    model = build_model(cfg)
    use_engine = engine == "engine" or (engine == "auto" and model.prefill is not None)
    params = model.init(torch.Generator(device=dev).manual_seed(seed))
    if verbose:
        print(f"[serve] arch={cfg.arch_id} params={model.param_count(params):,} on {dev}")
    prompts = np.random.default_rng(seed + 1).integers(0, cfg.vocab_size, (batch, prompt_len),
                                                       dtype=np.int32)
    t0 = time.perf_counter()
    if use_engine:
        res = generate(model, params, list(prompts), max_new_tokens=tokens,
                       buckets=(BucketSpec(batch, prompt_len + tokens + 1),), device=dev)
        gen = np.asarray([r.tokens for r in res], np.int32)
    else:
        gen = loop_generate(model, params, torch.as_tensor(prompts, device=dev),
                            tokens).cpu().numpy()
    dt = time.perf_counter() - t0
    info = {"path": "engine" if use_engine else "loop", "device": str(dev),
            "tok_per_s": tokens * batch / max(dt, 1e-9), "wall_s": dt}
    if verbose:
        print(f"decoded {tokens} tokens x {batch} seqs in {dt:.2f}s on {dev} "
              f"({info['tok_per_s']:.1f} tok/s, {info['path']} path)")
        print("sample:", gen[0].tolist())
    return gen, info


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--engine", choices=("auto", "engine", "loop"), default="auto")
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args()
    run_serve(args.arch, batch=args.batch, prompt_len=args.prompt_len, tokens=args.tokens,
              seed=args.seed, engine=args.engine, device=args.device, verbose=True)


if __name__ == "__main__":
    main()
