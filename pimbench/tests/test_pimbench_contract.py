"""BENCHMARK.json keeps to the benchmark's contract, every name it uses
has its file, and no module of the benchmark imports JAX or the JAX
package (the reference not even the port)."""
import ast
import json
import re
from pathlib import Path

import pytest

from pimbench.harness import reader_of

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "pimbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
REFERENCE = ("reference", "templates", "tpch_gen", "tpch_schema", "refresh",
             "roofline", "compare")
FORBIDDEN = {"jax", "jaxlib", "flax", "repro"}


def _line(s, n=200):
    return isinstance(s, str) and 1 <= len(s) <= n and "\n" not in s \
        and "\t" not in s


def test_top_level_keys_and_limits():
    assert list(BENCH) == ["command", "paths", "run_seconds", "configs",
                           "workloads", "end_to_end", "per_layer"]
    assert BENCH["command"][:2] == ["python3", "pimbench/run.py"]
    assert all(_line(w) for w in BENCH["command"])
    assert "pimbench" in BENCH["paths"]
    assert isinstance(BENCH["run_seconds"], int)
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_keys():
    names = []
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["source"]) and _line(c["why"])
        assert c["file"].startswith("pimbench/") and (ROOT / c["file"]).exists()
        assert all(NAME.match(k) for k in c["reduced"]) and len(c["reduced"]) <= 16
        assert set(c["reduced"]) <= set(json.loads((ROOT / c["file"]).read_text()))
        names.append(c["name"])
    cells = []
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4) and _line(w["why"])
        assert w["config"] in names
        assert (PKG / "traffic" / f"{w['traffic']}.json").exists()
        cells.append(w["name"])
    assert len({(w["config"], w["traffic"]) for w in BENCH["workloads"]}) == len(cells)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves",
                          "workloads"}
        assert m["source"] in ("device_trace", "program_span",
                               "program_counter", "host_clock")
        assert m["moves"] in e2e and _line(m["layer"])
        for c in m.get("workloads", cells):
            assert c in cells
            moved = next(x for x in BENCH["end_to_end"] if x["name"] == m["moves"])
            assert c in moved.get("workloads", cells)
    for m in BENCH["end_to_end"] + BENCH["per_layer"]:
        assert m["better"] in ("lower", "higher") and UNIT.match(m["unit"])
        assert (PKG / "metrics" / (reader_of(m["name"]) + ".py")).exists()
    everything = names + cells + [m["name"] for m in BENCH["end_to_end"]
                                  + BENCH["per_layer"]]
    assert all(NAME.match(n) for n in everything)
    assert len(set(everything)) == len(everything)
    for m in BENCH["per_layer"]:
        if m["name"].endswith("_roofline") or "mfu" in m["name"]:
            assert m["unit"] == "%"


def test_every_cell_reports_setup_another_end_to_end_and_a_per_layer_metric():
    for w in BENCH["workloads"]:
        def has(m):
            return w["name"] in m.get("workloads", [w["name"]])
        e2e = [m["name"] for m in BENCH["end_to_end"] if has(m)]
        assert "setup_s" in e2e and len(e2e) >= 2
        assert any(has(m) for m in BENCH["per_layer"])


def _imports(path: Path):
    tree = ast.parse(path.read_text())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")),
                         ids=lambda p: str(p.relative_to(PKG)))
def test_no_module_imports_jax_or_the_jax_package(path):
    found = set(_imports(path))
    assert not found & FORBIDDEN, found & FORBIDDEN
    if path.parent == PKG and path.stem in REFERENCE:
        assert "repro_torch" not in found
