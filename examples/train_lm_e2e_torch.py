"""End-to-end training on the PyTorch/CUDA port: train one LM for a few
hundred steps on the synthetic non-IID token stream (``launch.train``'s
single-model run). The counterpart of ``examples/train_lm_e2e.py``.

    PYTHONPATH=src python examples/train_lm_e2e_torch.py                 # small scale
    PYTHONPATH=src python examples/train_lm_e2e_torch.py --preset 100m --steps 300
    PYTHONPATH=src python examples/train_lm_e2e_torch.py --steps 60 --device cpu

At ``--preset 100m`` this is the paper-scale single-model run. The
checkpoint goes to ``build/train_lm_e2e_torch/ckpt.npz`` under the
repository root.
"""
import argparse
import math
import os
import sys
from pathlib import Path

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", "src"))

from repro_torch.launch import train as train_mod

CKPT = Path(__file__).resolve().parents[1] / "build" / "train_lm_e2e_torch" / "ckpt"


def main(argv=None):
    ap = argparse.ArgumentParser()
    ap.add_argument("--preset", default="tiny", choices=list(train_mod.PRESETS))
    ap.add_argument("--steps", type=int, default=150)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--device", default=None, help="cuda unless given (e.g. cpu)")
    args = ap.parse_args(argv)

    CKPT.parent.mkdir(parents=True, exist_ok=True)
    ns = argparse.Namespace(preset=args.preset, steps=args.steps, batch=args.batch,
                            seq=args.seq, lr=3e-3, seed=0, ckpt=str(CKPT), device=args.device)
    final_ce = train_mod.run_single(ns)
    floor = math.log(train_mod.PRESETS[args.preset]["vocab_size"])
    assert final_ce < 0.95 * floor, f"loss did not move ({final_ce} vs uniform {floor:.2f})"
    print(f"final CE {final_ce:.3f} (uniform floor {floor:.2f}) - checkpoint at {CKPT}.npz")
    return final_ce


if __name__ == "__main__":
    main()
