"""mfu_pct: the whole round's share of the card's peak (%): the model
FLOPs of the rounds (``flops/<config's flops module>``: forward and
backward of every local step's batch, the eval forward over the real
val rows) over the host-clock wall time of the traced run's unprofiled
rounds, divided by the peak of the configuration's compute type."""
import importlib

from swarmbench.harness.peaks import FLOPS


def facts(setup) -> dict:
    flops = importlib.import_module(f"swarmbench.flops.{setup.config['flops']}")
    val_rows = sum(len(c["val"][1]) for c in setup.clients)
    return {"round_flops": flops.round_flops(setup.traffic, setup.config["model"], val_rows),
            "peak_flops": FLOPS[setup.config["compute_dtype"]]}


def read(summary):
    f = summary.facts
    if not f.get("unprofiled_rounds") or not f.get("round_flops"):
        return None
    rate = f["round_flops"] * f["unprofiled_rounds"] / f["unprofiled_s"]
    return 100.0 * rate / f["peak_flops"]
