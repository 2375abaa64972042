"""Batched serving on the PyTorch/CUDA port: prefill + autoregressive
decode with the KV / SSM cache for any assigned architecture (its smoke
config). Attention-backed LMs go through the continuous-batching
engine (``repro_torch.serve``); the ssm, hybrid and encdec families
through the per-token loop. The counterpart of
``examples/serve_batched.py``.

    PYTHONPATH=src python examples/serve_batched_torch.py --arch granite-3-2b
    PYTHONPATH=src python examples/serve_batched_torch.py --arch mamba2-370m --device cpu
"""
import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch.serve import run_serve


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--arch", default="granite-3-2b")
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=8)
    ap.add_argument("--tokens", type=int, default=16)
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args(argv)
    return run_serve(args.arch, batch=args.batch, prompt_len=args.prompt_len,
                     tokens=args.tokens, device=args.device, verbose=True)


if __name__ == "__main__":
    main()
