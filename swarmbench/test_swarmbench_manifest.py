"""BENCHMARK.json against the files it names and the benchmark's rules:
every cell's workload file, configuration, driver and metric readers
exist; every per-layer metric moves an end-to-end metric that every
cell of its ``workloads`` reports; names, units and lengths keep to the
allowed characters; the configuration files keep the program's
registered values but for ``reduced``; the window fits the check's
time with 24 cells."""
from __future__ import annotations

import importlib
import json
import re
import sys

import pytest

from swarmbench import tiny

tiny.pin_threads()
ROOT = tiny.ROOT
BENCH = ROOT / "swarmbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.\-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.\-]{1,16}$")
TOP_KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
# a width: a hidden, intermediate, latent, state or projection size, a head
# size, a key ending in _dim or _rank, an expansion, experts per token
WIDTHS = re.compile(r"((?<!vocab)_size$|_dim$|_rank$|expan|experts_per_tok)")

for p in (str(ROOT), str(ROOT / "src")):
    if p not in sys.path:
        sys.path.insert(0, p)


def manifest() -> dict:
    with open(ROOT / "BENCHMARK.json") as f:
        return json.load(f)


def workload_file(name: str) -> dict:
    with open(BENCH / "workloads" / f"{name}.json") as f:
        return json.load(f)


def config_file(name: str) -> dict:
    with open(BENCH / "configs" / f"{name}.json") as f:
        return json.load(f)


def test_manifest_keys_command_and_paths():
    m = manifest()
    assert set(m) == TOP_KEYS
    assert m["command"] == ["python3", "swarmbench/run.py"]
    assert m["paths"] == ["swarmbench"]
    assert (ROOT / m["command"][1]).is_file()
    assert len(json.dumps(m)) < 64 * 1024


def test_run_seconds_fits_the_check_with_24_cells():
    rs = manifest()["run_seconds"]
    assert isinstance(rs, int) and 1 <= rs <= 51
    assert (2 + 14 * 24) * (rs + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("cell", tiny.CELLS)
def test_cell_files_name_what_exists(cell):
    m = manifest()
    entry = next(w for w in m["workloads"] if w["name"] == cell)
    w = workload_file(cell)
    assert w["config"] == entry["config"] and w["traffic"] == entry["traffic"]
    assert entry["chips"] == 1
    c = config_file(entry["config"])
    assert c["name"] == entry["config"]
    importlib.import_module(f"swarmbench.drivers.{w['driver']}")
    importlib.import_module(f"swarmbench.generators.{w['data']['generator']}")
    importlib.import_module(f"swarmbench.reference.{c['reference']}")
    importlib.import_module(f"swarmbench.flops.{c['flops']}")
    from swarmbench.harness import checks, peaks
    assert set(w["check"]["limits"]) == set(checks.NAMES)
    assert c["compute_dtype"] in peaks.FLOPS
    reported = [x["name"] for x in m["end_to_end"]
                if "workloads" not in x or cell in x["workloads"]]
    assert "setup_s" in reported and len(reported) >= 2
    assert any(cell in x.get("workloads", [cell]) for x in m["per_layer"])


@pytest.mark.parametrize("cell", sorted(p.stem for p in (BENCH / "workloads").glob("*.json")))
def test_every_cell_file_names_files_that_exist(cell):
    w = workload_file(cell)
    c = config_file(w["config"])
    for module in (f"drivers.{w['driver']}", f"generators.{w['data']['generator']}",
                   f"reference.{c['reference']}", f"flops.{c['flops']}"):
        importlib.import_module(f"swarmbench.{module}")
    from swarmbench.harness import checks
    assert set(w["check"]["limits"]) == set(checks.NAMES)


def test_configs_entries_match_their_files():
    m = manifest()
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        assert c["file"] == f"swarmbench/configs/{c['name']}.json"
        f = config_file(c["name"])
        assert f["source"] == c["source"] and f["reduced"] == c["reduced"]
        assert len(c["reduced"]) <= 16
        for key in c["reduced"]:
            assert key in f["model"] and not WIDTHS.search(key), key


def test_per_layer_metrics_have_readers_and_move_a_reported_metric():
    m = manifest()
    e2e = {x["name"]: x for x in m["end_to_end"]}
    cells = [w["name"] for w in m["workloads"]]
    layers = {}
    for x in m["per_layer"]:
        reader = importlib.import_module(f"swarmbench.metrics.{x['name']}")
        assert callable(reader.read)
        assert x["moves"] in e2e
        for cell in x.get("workloads", cells):
            assert cell in cells
            assert "workloads" not in e2e[x["moves"]] or cell in e2e[x["moves"]]["workloads"]
        layers.setdefault(x["layer"], []).append(x["name"])
    assert any("mfu" in n for n in layers.get("round entry", []))


def test_names_units_and_text_keep_to_the_allowed_characters():
    m = manifest()
    names = []
    for x in m["end_to_end"] + m["per_layer"]:
        names.append(x["name"])
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        if "layer" in x:
            assert 1 <= len(x["layer"]) <= 200 and "\n" not in x["layer"]
        if "_roofline" in x["name"] or "mfu" in x["name"]:
            assert x["unit"] == "%"
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for w in m["workloads"]:
        names += [w["name"], w["traffic"]]
        assert 1 <= len(w["why"]) <= 200 and "\n" not in w["why"] and "\t" not in w["why"]
    for c in m["configs"]:
        names.append(c["name"])
        names += c["reduced"]
        assert 1 <= len(c["source"]) <= 200
    assert all(NAME.match(n) for n in names), names
    for kind in ("end_to_end", "per_layer", "workloads", "configs"):
        got = [x["name"] for x in m[kind]]
        assert len(got) == len(set(got))
    for path in BENCH.rglob("*"):
        rel = path.relative_to(ROOT).as_posix()
        assert "__pycache__" in rel or re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", rel), rel


def test_granite_file_keeps_the_registered_values_but_the_depth():
    from dataclasses import replace

    from repro_torch.configs import get_config
    from swarmbench.drivers.swarm_round import program_config
    c = config_file("granite-3-2b-l2")
    registered = get_config(c["program"]["arch_id"])
    assert program_config(c) == replace(registered, n_layers=c["model"]["num_hidden_layers"])
    assert registered.n_layers == 40 and c["reduced"] == ["num_hidden_layers"]


def test_set_environment_fixes_the_caches_under_the_checkout(monkeypatch, tmp_path):
    """Every cache under the checkout at a fixed path, before torch is loaded."""
    from swarmbench import run as R
    for var in R.CACHES:
        monkeypatch.setenv(var, "unset")        # restored when the test ends
    R.set_environment(tmp_path)
    for var, sub in R.CACHES.items():
        assert R.os.environ[var] == str(tmp_path / "build" / "swarmbench" / sub)
    R.set_environment(tmp_path)
    assert all(R.os.environ[v] == str(tmp_path / "build" / "swarmbench" / s)
               for v, s in R.CACHES.items())


def test_the_context_carries_the_cells_per_layer_metrics():
    from swarmbench import run as R
    m = manifest()
    for cell in tiny.CELLS:
        ctx = R.load_context(cell, 3, 1.0, True)
        assert ctx.per_layer == [x["name"] for x in m["per_layer"]
                                 if cell in x.get("workloads", [cell])]
        assert ctx.per_layer
