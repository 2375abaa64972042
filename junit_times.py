"""Where a pytest run's time went, from its junit XML file.

Prints, for each file given, one JSON line: the tests counted as
pytest counts them (passed, failed, errors, skipped), the run's wall
time as the file records it, the per-test times summed over the port's
modules (``tests/test_torch_*.py``) and over the rest (the JAX
reference's), the slowest tests of each, and the failures by name.
Compare two runs of one command made back to back on one host::

    python -m pytest -q -n 6 --dist loadfile --junitxml=parent.xml   # on each tree
    python3 junit_times.py parent.xml change.xml
"""
import json
import sys
import xml.etree.ElementTree as ET


def summarize(path: str, top: int = 5) -> dict:
    suite = ET.parse(path).getroot()
    if suite.tag == "testsuites":
        suite = suite.find("testsuite")
    groups = {"port": [], "reference": []}
    failed, counts = [], {"passed": 0, "failed": 0, "errors": 0, "skipped": 0}
    for case in suite.iter("testcase"):
        module = case.get("classname", "").split(".")
        name = "::".join(["/".join(module) + ".py", case.get("name", "")])
        group = "port" if module[-1].startswith("test_torch_") else "reference"
        groups[group].append((float(case.get("time", 0.0)), name))
        if case.find("failure") is not None:
            counts["failed"] += 1
            failed.append(name)
        elif case.find("error") is not None:
            counts["errors"] += 1
            failed.append(name)
        elif case.find("skipped") is not None:
            counts["skipped"] += 1
        else:
            counts["passed"] += 1
    out = {"file": path, "wall_s": float(suite.get("time", 0.0)), **counts}
    for group, cases in groups.items():
        cases.sort(reverse=True)
        out[group] = {"tests": len(cases), "summed_s": round(sum(t for t, _ in cases), 3),
                      "slowest": [[round(t, 3), n] for t, n in cases[:top]]}
    out["failures"] = sorted(failed)
    return out


def main(argv=None) -> None:
    paths = sys.argv[1:] if argv is None else argv
    if not paths:
        raise SystemExit("usage: python3 junit_times.py RUN.xml [RUN.xml ...]")
    for path in paths:
        print(json.dumps(summarize(path)))


if __name__ == "__main__":
    main()
