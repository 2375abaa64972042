"""Run one cell of the port's benchmark and print its result line.

    python3 swarmbench/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

from the root of a checkout that holds ``BENCHMARK.json``, this folder
and the program (``src/repro_torch``). The cell's entry in
``BENCHMARK.json`` names its configuration (``swarmbench/configs/<config>.json``);
its file ``swarmbench/workloads/<cell>.json`` names its driver
(``swarmbench/drivers/<driver>.py``), its traffic and its check's limits.
The last line of standard output is one JSON object: ``correct``,
``attempted`` (rounds), ``failed`` (rounds that raised or gave a
non-finite loss), ``metrics`` (the cell's end-to-end metrics, or with
``--trace 1`` its per-layer metrics), ``device``, with ``--trace 1``
``breakdown``, and last ``checks`` (each compared number with its
limit). Progress and the compared numbers go to standard error.

Exit codes: 0 with a result; 2 for a bad call or a checkout without the
program; 3 without enough CUDA cards; 4 when JAX, jaxlib, flax or the
JAX package ``repro`` was loaded."""
from __future__ import annotations

import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import importlib  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import platform  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402
from dataclasses import dataclass, field  # noqa: E402
from pathlib import Path  # noqa: E402

BENCH = Path(__file__).resolve().parent
ROOT = BENCH.parent
FENCED = ("jax", "jaxlib", "flax", "repro")
# build and kernel caches at fixed paths inside the checkout
CACHES = {"TORCH_EXTENSIONS_DIR": "torch_extensions", "TRITON_CACHE_DIR": "triton",
          "TORCHINDUCTOR_CACHE_DIR": "inductor"}
def set_environment(root: Path = ROOT) -> None:
    """The caches' folders, before torch loads."""
    for var, sub in CACHES.items():
        os.environ[var] = str(root / "build" / "swarmbench" / sub)


def log(msg: str) -> None:
    print(f"[swarmbench] {msg}", file=sys.stderr, flush=True)


@dataclass
class Context:
    name: str
    entry: dict             # the cell's entry in BENCHMARK.json
    workload: dict          # swarmbench/workloads/<cell>.json
    config: dict            # swarmbench/configs/<config>.json
    seed: int
    seconds: float
    trace: bool
    device: object = None
    t_start: float = T_START
    faults: object = None   # a callable giving a context manager (tests, calibration)
    per_layer: list = field(default_factory=list)   # the cell's per-layer metric names


def load_json(path: Path) -> dict:
    with open(path) as f:
        return json.load(f)


def load_context(name: str, seed: int, seconds: float, trace: bool, root: Path = ROOT) -> Context:
    manifest = load_json(root / "BENCHMARK.json")
    entry = next((w for w in manifest["workloads"] if w["name"] == name), None)
    if entry is None:
        raise KeyError(f"no workload {name!r} in BENCHMARK.json")
    workload = load_json(BENCH / "workloads" / f"{name}.json")
    config = load_json(BENCH / "configs" / f"{entry['config']}.json")
    return Context(name, entry, workload, config, seed, seconds, trace,
                   per_layer=[m["name"] for m in metric_entries(manifest, name, True)])


def fenced_modules() -> list:
    """Loaded modules whose top-level name is JAX's, jaxlib's, flax's or
    the JAX package's (whole names: ``repro_torch`` is not ``repro``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FENCED))


def metric_entries(manifest: dict, name: str, trace: bool) -> list:
    key = "per_layer" if trace else "end_to_end"
    return [m for m in manifest[key] if "workloads" not in m or name in m["workloads"]]


def card_lines() -> list:
    lines = []
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit,clocks.max.sm",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
        lines.append(f"card: {out.stdout.strip()}")
    except (OSError, subprocess.SubprocessError) as e:
        lines.append(f"card: nvidia-smi unavailable ({e})")
    cpu = f"{platform.machine()} x {os.cpu_count()}"
    try:
        out = subprocess.run(["lscpu"], capture_output=True, text=True, timeout=30)
        info = dict(ln.split(":", 1) for ln in out.stdout.splitlines() if ":" in ln)
        cpu = f"{info.get('Model name', '?').strip()} ({info.get('Vendor ID', '?').strip()}, " \
              f"family {info.get('CPU family', '?').strip()} model " \
              f"{info.get('Model', '?').strip()}) x {os.cpu_count()}"
    except (OSError, subprocess.SubprocessError):
        pass
    lines.append(f"host cpu: {cpu}")
    return lines


def result_line(ctx: Context, manifest: dict, out: dict, torch) -> dict:
    dev = ctx.device
    metrics = {}
    for m in metric_entries(manifest, ctx.name, ctx.trace):
        if ctx.trace:
            if out["summary"] is None:
                continue
            value = importlib.import_module(f"swarmbench.metrics.{m['name']}").read(out["summary"])
        else:
            value = out["e2e"].get(m["name"])
        if value is not None:
            metrics[m["name"]] = {"value": value, "unit": m["unit"]}
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(dev),
              "count": int(ctx.entry["chips"]), "memory_peak_bytes": out["peak"]}
    line = {"correct": out["correct"], "attempted": out["attempted"], "failed": out["failed"],
            "metrics": metrics, "device": device}
    if ctx.trace and out["summary"] is not None:
        s = out["summary"]
        device["busy_s"] = s.busy_us / 1e6
        device["window_s"] = s.window_us / 1e6
        line["breakdown"] = s.breakdown
    line["checks"] = out["checks"]
    return line


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)
    if not (ROOT / "src" / "repro_torch").is_dir():
        log(f"the program (src/repro_torch) is not in {ROOT}")
        return 2
    set_environment()
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    try:
        ctx = load_context(args.workload, args.seed, args.seconds, bool(args.trace))
    except (OSError, KeyError, ValueError) as e:
        log(f"bad workload: {e}")
        return 2
    import torch
    if not torch.cuda.is_available() or torch.cuda.device_count() < int(ctx.entry["chips"]):
        log(f"needs {ctx.entry['chips']} CUDA card(s); torch sees "
            f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}")
        return 3
    # the configurations state float32 where they state it: no TF32, on both sides
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ctx.device = torch.device("cuda", 0)
    for line in card_lines():
        log(line)
    driver = importlib.import_module(f"swarmbench.drivers.{ctx.workload['driver']}")
    out = driver.run(ctx)
    line = result_line(ctx, load_json(ROOT / "BENCHMARK.json"), out, torch)
    found = fenced_modules()
    if found:
        log(f"refused: the run loaded {', '.join(found)}")
        return 4
    log(f"rounds attempted: {out['attempted']}; correct: {line['correct']}; "
        f"{time.perf_counter() - T_START:.1f} s since the start")
    for name, c in line["checks"].items():
        print(f"check {name}: {c['value']!r} (limit {c['limit']!r})", file=sys.stderr, flush=True)
    print(json.dumps(line), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
