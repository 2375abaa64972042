"""The cells at sizes a CPU test holds: the same configuration files,
drivers, references and checks, with the traffic and the LM's widths cut
(granite-3-2b-l2: d 64, 4/2 heads of 16, ff 128, a 256-id vocabulary,
3 clients of 8 sequences of 16 tokens, batch 2, 2 local steps, the
cell's own k), run on the CPU. Two limits follow the widths and are the
tiny size's own, set from its readings on 13 seeds on the CPU: the
first step's gradient (program at most 4.74e-3, the float8 control at
least 2.04e-2: 1e-2) and loss (program at most 3.34e-4: 1e-3)."""
from __future__ import annotations

import json
import os
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parent.parent


CELLS = tuple(w["name"] for w in json.loads((ROOT / "BENCHMARK.json").read_text())["workloads"])


def pin_threads() -> None:
    """One share of the cores a pytest worker, as the repo's port tests do."""
    import torch
    workers = int(os.environ.get("PYTEST_XDIST_WORKER_COUNT", "1"))
    torch.set_num_threads(max(1, (os.cpu_count() or 1) // max(workers, 1)))


def context(name: str, seed: int = 2**31 + 7, seconds: float = 0.0, trace: bool = False):
    """The cell's run context, cut to a CPU's size, on the CPU."""
    for p in (str(ROOT), str(ROOT / "src")):
        if p not in sys.path:
            sys.path.insert(0, p)
    import torch

    from swarmbench import run as R
    w = R.load_json(ROOT / "swarmbench" / "workloads" / f"{name}.json")
    c = R.load_json(ROOT / "swarmbench" / "configs" / f"{w['config']}.json")
    per_layer = [m["name"] for m in R.metric_entries(R.load_json(ROOT / "BENCHMARK.json"), name,
                                                     True)]
    ctx = R.Context(name, {"name": name, "config": w["config"], "chips": 1}, w, c, seed,
                    seconds, trace, per_layer=per_layer)
    c["model"].update(hidden_size=64, num_attention_heads=4, num_key_value_heads=2,
                      head_dim=16, intermediate_size=128, vocab_size=256)
    w["data"].update(vocab=256, seq_len=16, n_clients=3, train_seqs=8)
    w["round"].update(n_clients=3, batch_size=2, local_steps=2)
    w["trace"]["profiled_rounds"] = 2
    w["check"]["limits"].update(first_grad_gap=1e-2, first_loss_gap=1e-3)
    ctx.device = torch.device("cpu")
    return ctx
