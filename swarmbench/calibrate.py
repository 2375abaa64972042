"""Readings that set a cell's limits (not run by the benchmark's runs).

    python3 swarmbench/calibrate.py --workload <cell> --seeds 1,2,3 [--control 1]
        [--faults unchanged,half_batch,...] [--fault-seeds 3]

In one process, for each seed: the program's check rounds and the
numbers of ``harness/checks.py`` against the float32 reference (the
lower readings); with ``--control 1`` the reference itself one precision
below the configuration's (TF32 for float32, float8 for bfloat16, see
``reference/precision.py``) in the program's place (the control's
readings); with ``--faults`` each planted fault of ``faults.py`` on the
first ``--fault-seeds`` seeds. One JSON line a reading on standard
output; with ``--dump <folder>`` each side's and the reference's raw
readings too, so that numbers can be worked out again without a card."""
from __future__ import annotations

import argparse
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent
LOWER = {"float32": "tfloat32", "bfloat16": "float8"}


def _raw(readings) -> dict:
    """A side's readings without the weights its eval scored (gigabytes a round)."""
    return {k: v for k, v in vars(readings).items() if k != "eval_weights"}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", required=True)
    ap.add_argument("--control", type=int, default=0)
    ap.add_argument("--faults", default="")
    ap.add_argument("--fault-seeds", type=int, default=3)
    ap.add_argument("--dump", default="", help="a folder for each reading's raw tensors")
    args = ap.parse_args(argv)
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    from swarmbench import run as R
    R.set_environment()
    import torch

    from swarmbench import faults as F
    from swarmbench.drivers import swarm_round as D
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda", 0) if torch.cuda.is_available() else torch.device("cpu")
    for line in R.card_lines():
        R.log(line)
    faults = [f for f in args.faults.split(",") if f]
    for i, seed in enumerate(int(s) for s in args.seeds.split(",")):
        ctx = R.load_context(args.workload, seed, 0.0, False)
        setup, tr = D.prepare(seed, ctx.workload, ctx.config, dev)

        def emit(side: str, readings, t0: float):
            kept = {}
            values = D.judge(setup, readings, kept)
            print(json.dumps({"workload": args.workload, "seed": seed, "side": side,
                              "values": values, "seconds": time.perf_counter() - t0}),
                  flush=True)
            if args.dump:
                Path(args.dump).mkdir(parents=True, exist_ok=True)
                torch.save({"side": _raw(readings), "reference": _raw(kept["reference"]),
                            "coord": kept["coord"]},
                           Path(args.dump) / f"{args.workload}_{seed}_{side}.pt")

        runs = ["program"] + (faults if i < args.fault_seeds else [])
        for side in runs:
            t0 = time.perf_counter()
            D.install_weights(tr, setup.weights())
            if side == "program":
                readings, _ = D.check_rounds(tr, setup)
            else:
                with F.planted(side):
                    readings, _ = D.check_rounds(tr, setup)
            emit(side, readings, t0)
        del tr
        if args.control:
            t0 = time.perf_counter()
            lower = LOWER[ctx.config["compute_dtype"]]
            control = D.reference_readings(setup, lower)
            emit(f"control_{lower}", control, t0)
        del setup
        if dev.type == "cuda":
            torch.cuda.empty_cache()
    return 0


if __name__ == "__main__":
    sys.exit(main())
