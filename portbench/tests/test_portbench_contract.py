"""BENCHMARK.json against the benchmark's format rules, and the imports that
the harness and its reference may not make."""

import ast
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
PKG = ROOT / "portbench"
BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
KEYS = {"command", "paths", "run_seconds", "configs", "workloads", "end_to_end", "per_layer"}
ENTRY_KEYS = {
    "configs": {"name", "source", "file", "reduced", "why"},
    "workloads": {"name", "config", "traffic", "chips", "why"},
    "end_to_end": {"name", "unit", "better", "bound", "source"},
    "per_layer": {"name", "unit", "better", "source", "layer", "moves"},
}
FORBIDDEN = {"jax", "jaxlib", "flax", "ai_crypto_trader_tpu", "bench"}


def _imports(path: Path) -> set:
    """Top-level names of every module ``path`` imports."""
    names = set()
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.Import):
            names |= {a.name.split(".")[0] for a in node.names}
        elif isinstance(node, ast.ImportFrom) and node.level == 0 and node.module:
            names.add(node.module.split(".")[0])
    return names


def test_the_file_has_exactly_the_required_keys():
    assert set(BENCH) == KEYS
    assert 1 <= BENCH["run_seconds"] <= 51
    assert len(json.dumps(BENCH)) <= 64 * 1024
    for group, keys in ENTRY_KEYS.items():
        for entry in BENCH[group]:
            extra = set(entry) - keys - ({"workloads"} if group in ("end_to_end", "per_layer") else set())
            assert keys <= set(entry) and not extra, (group, entry["name"])


@pytest.mark.parametrize("group", ["configs", "workloads", "end_to_end", "per_layer"])
def test_names_and_units_use_the_allowed_characters(group):
    names = [e["name"] for e in BENCH[group]]
    assert len(names) == len(set(names))
    for e in BENCH[group]:
        assert NAME.match(e["name"]), e["name"]
        if "unit" in e:
            assert UNIT.match(e["unit"]) and e["better"] in ("lower", "higher"), e
        for text in (e.get("why"), e.get("layer"), e.get("source")):
            assert text is None or (1 <= len(text) <= 200 and "\n" not in text and "\t" not in text)
    for w in BENCH["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)


def test_command_and_paths_stay_inside_the_benchmark():
    assert all(re.match(r"^[A-Za-z0-9_.\-/]{1,200}$", p) for p in BENCH["paths"])
    assert BENCH["paths"] == ["portbench"]
    assert len(BENCH["command"]) <= 32
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])


def test_every_cell_finds_its_files_by_name():
    configs = {c["name"]: c for c in BENCH["configs"]}
    cells = {w["name"] for w in BENCH["workloads"]}
    for w in BENCH["workloads"]:
        conf = json.loads((ROOT / configs[w["config"]]["file"]).read_text())
        assert (PKG / "kinds" / f"{conf['kind']}.py").is_file()
        assert (PKG / "traffic" / f"{w['traffic']}.json").is_file()
        assert conf["limits"]
    assert {w["config"] for w in BENCH["workloads"]} == set(configs)
    e2e = {m["name"] for m in BENCH["end_to_end"]}
    assert "setup_s" in e2e
    for m in BENCH["per_layer"]:
        assert (PKG / "metrics" / f"{m['name']}.py").is_file(), m["name"]
        assert m["moves"] in e2e and set(m.get("workloads", [])) <= cells
    for cell in cells:
        reported = [m for m in BENCH["end_to_end"] if cell in m.get("workloads", [cell])]
        assert len(reported) >= 2
        assert any(cell in m.get("workloads", []) for m in BENCH["per_layer"])


def test_bounds_stay_within_their_limits():
    for m in BENCH["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25
        assert m["source"] in ("host_clock", "device_trace")


@pytest.mark.parametrize("path", sorted(PKG.rglob("*.py")), ids=lambda p: str(p.relative_to(ROOT)))
def test_no_module_imports_jax_the_jax_package_or_the_old_bench(path):
    assert not _imports(path) & FORBIDDEN


@pytest.mark.parametrize("path", sorted((PKG / "reference").glob("*.py")), ids=lambda p: p.name)
def test_the_reference_imports_nothing_of_the_port(path):
    assert not {n for n in _imports(path) if n.startswith("ai_crypto_trader_tpu")}
    assert _imports(path) <= {"__future__", "numpy", "portbench"}
