"""The import fence: nothing the benchmark runs loads JAX, jaxlib, flax
or the JAX package ``repro`` (compared by whole top-level name, since
the port's ``repro_torch`` begins with ``repro``); the plain reference
loads nothing of the program either; nothing under ``swarmbench/``
reads the JAX package's benchmark folder."""
from __future__ import annotations

import json
import re
import subprocess
import sys

from swarmbench import tiny

tiny.pin_threads()
BENCH = tiny.ROOT / "swarmbench"
FENCED = {"jax", "jaxlib", "flax", "repro"}


def _modules(folder: str) -> list:
    return sorted(f"swarmbench.{folder}.{p.stem}" for p in (BENCH / folder).glob("*.py")
                  if p.stem != "__init__")


def _loaded_after(imports: list) -> set:
    code = (f"import sys; sys.path[:0] = [{str(tiny.ROOT)!r}, {str(tiny.ROOT / 'src')!r}]\n"
            "import importlib, json, runpy\n"
            f"runpy.run_path({str(BENCH / 'run.py')!r}, run_name='swarmbench_run')\n"
            f"for m in {imports!r}: importlib.import_module(m)\n"
            "print(json.dumps(sorted({m.split('.')[0] for m in sys.modules})))\n")
    out = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True,
                         timeout=300, check=True, env={"PATH": "/usr/bin:/bin",
                                                       "OMP_NUM_THREADS": "1"})
    return set(json.loads(out.stdout.strip().splitlines()[-1]))


def test_nothing_the_benchmark_runs_loads_jax_or_the_jax_package():
    mods = ["swarmbench.run", "swarmbench.calibrate", "swarmbench.faults", "swarmbench.tiny"]
    for folder in ("drivers", "metrics", "reference", "flops", "generators", "harness"):
        mods += _modules(folder)
    top = _loaded_after(mods)
    assert "swarmbench" in top and "torch" in top
    assert not top & FENCED, top & FENCED


def test_the_reference_loads_nothing_of_the_program():
    top = _loaded_after(_modules("reference"))
    assert "repro_torch" not in top and not top & FENCED


def test_nothing_under_swarmbench_reads_the_jax_benchmarks():
    pattern = re.compile(r"""["'/]benchmarks(/|["'])""")
    for path in BENCH.rglob("*.py"):
        if path.name.startswith("test_"):
            continue
        assert not pattern.search(path.read_text()), path
