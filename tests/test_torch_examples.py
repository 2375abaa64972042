"""The port's five examples (``examples/*_torch.py``) on the CPU: each
``main([..., "--device", "cpu"])`` at its smallest settings, with what
it prints checked; and each imports only ``repro_torch`` of the repo
(no ``jax``, ``repro`` or ``benchmarks``).

Run it alone with::

    PYTHONPATH=src python -m pytest -q tests/test_torch_examples.py
"""
import ast
import importlib.util
import json
import math
import subprocess
import sys
from pathlib import Path

import pytest

torch = pytest.importorskip("torch")

from torch_parity import pin_torch_threads, subprocess_env  # noqa: E402

pin_torch_threads()

ROOT = Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "paper_tables", "serve_batched", "train_lm_e2e", "multi_pod_dryrun")


def _load(name: str):
    path = ROOT / "examples" / f"{name}_torch.py"
    spec = importlib.util.spec_from_file_location(f"{name}_torch", path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _quickstart(monkeypatch, capsys, tmp_path):
    mod = _load("quickstart")
    # one round of one local step on 2 images a nonzero Table-I cell
    monkeypatch.setattr(mod, "ROUNDS", 1)
    monkeypatch.setattr(mod, "LOCAL_STEPS", 1)
    monkeypatch.setattr(mod, "TABLE_DIV", 10 ** 6)
    monkeypatch.setattr(mod, "GRID_AXES", {"k": (1, 2)})
    mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert "clinics: 14" in out and "on cpu" in out
    assert "round   0 val_acc=" in out and "mean per-clinic test accuracy (paper Eq. 3)" in out
    assert "k=1" in out and "k=2" in out and out.count("test_acc=") == 2
    assert "[bso] round   0" in out and "mean test accuracy:" in out


def _paper_tables(monkeypatch, capsys, tmp_path):
    mod = _load("paper_tables")
    assert mod.scale_and_rounds(True) == (1, 8) and mod.scale_and_rounds(False) == (8, 4)
    monkeypatch.setattr(mod, "scale_and_rounds", lambda full: (10 ** 6, 1))
    monkeypatch.setattr(mod, "LOCAL_STEPS", 1)
    r2, r3 = mod.main(["--device", "cpu"])
    out = capsys.readouterr().out
    assert list(r2) == ["centralized", "local", "fedavg", "bso-sl"]
    assert list(r3) == mod.ARCHS
    for m, acc in r2.items():
        assert 0.0 <= acc <= 1.0 and f"table2/{m}," in out
    for arch, r in r3.items():
        assert 0.0 <= r["acc"] <= 1.0 and r["params"] > 0 and r["seconds"] > 0
        assert f"table3/{arch}," in out and f"paper_acc={mod.PAPER_TABLE3[arch]:.4f}" in out
        assert f"params={r['params']}" in out
    assert out.count("reproduced: ") == 2


def _serve_batched(monkeypatch, capsys, tmp_path):
    mod = _load("serve_batched")
    gen, info = mod.main(["--batch", "2", "--prompt-len", "4", "--tokens", "3",
                          "--device", "cpu"])
    out = capsys.readouterr().out
    assert gen.shape == (2, 3) and info["path"] == "engine" and info["device"] == "cpu"
    assert "[serve] arch=granite-3-2b-smoke" in out and "decoded 3 tokens x 2 seqs" in out


def _train_lm_e2e(monkeypatch, capsys, tmp_path):
    mod = _load("train_lm_e2e")
    monkeypatch.setattr(mod, "CKPT", tmp_path / "ckpt")
    ce = mod.main(["--steps", "40", "--batch", "4", "--seq", "32", "--device", "cpu"])
    out = capsys.readouterr().out
    assert ce < 0.95 * math.log(mod.train_mod.PRESETS["tiny"]["vocab_size"])
    assert "final CE" in out and (tmp_path / "ckpt.npz").is_file()


_DRYRUN_SCRIPT = """
import importlib.util, json, sys
from pathlib import Path
spec = importlib.util.spec_from_file_location("ex", sys.argv[1])
ex = importlib.util.module_from_spec(spec)
spec.loader.exec_module(ex)
ex.OUT = Path(sys.argv[2])
recs = ex.main(["--arch", "granite-3-2b", "--shape", "decode_32k", "--device", "cpu"])
print("RECORDS", json.dumps([[r["mesh"], r["ok"], r["roofline"]["dominant"]] for r in recs]))
"""


def _multi_pod_dryrun(monkeypatch, capsys, tmp_path):
    # a process group is process-wide: the census runs in a process of its own
    res = subprocess.run([sys.executable, "-c", _DRYRUN_SCRIPT,
                          str(ROOT / "examples" / "multi_pod_dryrun_torch.py"), str(tmp_path)],
                         cwd=ROOT, capture_output=True, text=True, timeout=300,
                         env={**subprocess_env(), "PYTHONPATH": str(ROOT / "src")})
    assert res.returncode == 0, res.stderr[-3000:]
    recs = json.loads(res.stdout.split("RECORDS ", 1)[1])
    assert recs == [["16x16", True, recs[0][2]]]
    assert "[dryrun] granite-3-2b" in res.stdout and "decode_32k" in res.stdout
    assert (tmp_path / "dryrun_granite-3-2b_decode_32k_16x16.json").is_file()


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_runs_on_the_cpu(name, monkeypatch, capsys, tmp_path):
    """Each example's ``main`` with ``--device cpu`` at its smallest
    settings (module constants cut where it has no flag for them), and
    what it prints."""
    {"quickstart": _quickstart, "paper_tables": _paper_tables,
     "serve_batched": _serve_batched, "train_lm_e2e": _train_lm_e2e,
     "multi_pod_dryrun": _multi_pod_dryrun}[name](monkeypatch, capsys, tmp_path)


@pytest.mark.parametrize("name", EXAMPLES)
def test_example_imports_no_jax_and_nothing_of_the_reference(name):
    tree = ast.parse((ROOT / "examples" / f"{name}_torch.py").read_text())
    mods = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            mods.update(a.name for a in node.names)
        elif isinstance(node, ast.ImportFrom):
            mods.add(node.module or "")
    tops = {m.split(".")[0] for m in mods}
    assert not tops & {"jax", "jaxlib", "repro", "benchmarks"}, tops
    assert "repro_torch" in tops
