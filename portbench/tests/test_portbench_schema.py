"""BENCHMARK.json against the benchmark's contract: its keys, names and
units, which cell reports which metric, and that every name it holds
finds its file under ``portbench/``."""

import json
import pathlib
import re
import sys

import pytest

CHECKOUT = pathlib.Path(__file__).resolve().parents[2]
if str(CHECKOUT) not in sys.path:
    sys.path.insert(0, str(CHECKOUT))

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
TOP = {"command", "paths", "run_seconds", "configs", "workloads",
       "end_to_end", "per_layer"}
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def bench():
    with open(CHECKOUT / "BENCHMARK.json") as f:
        return json.load(f)


def _line(s):
    return isinstance(s, str) and 1 <= len(s) <= 200 and "\n" not in s \
        and "\t" not in s


def test_keys_and_sizes(bench):
    assert set(bench) == TOP
    assert (CHECKOUT / "BENCHMARK.json").stat().st_size <= 64 * 1024
    assert 1 <= len(bench["paths"]) <= 16
    for p in bench["paths"]:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert not p.endswith("_torch")
    assert len(bench["command"]) <= 32 and all(_line(w)
                                               for w in bench["command"])
    assert 1 <= bench["run_seconds"] <= 51
    assert isinstance(bench["run_seconds"], int)
    assert 1 <= len(bench["configs"]) <= 24
    assert 1 <= len(bench["workloads"]) <= 24
    assert 1 <= len(bench["end_to_end"]) <= 16
    assert 1 <= len(bench["per_layer"]) <= 128


def test_entries_have_only_their_keys(bench):
    for c in bench["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert len(c["reduced"]) <= 16
    for w in bench["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] in (1, 4)
    for m in bench["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound",
                                          "source"}
        assert m["source"] in ("host_clock", "device_trace")
    for m in bench["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source",
                                          "layer", "moves"}
        assert m["source"] in SOURCES


def test_names_units_and_lines(bench):
    names = []
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        for e in bench[group]:
            assert NAME.match(e["name"]), e["name"]
            names.append((group, e["name"]))
    for w in bench["workloads"]:
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
        assert _line(w["why"])
    for c in bench["configs"]:
        assert all(NAME.match(k) for k in c["reduced"])
        assert _line(c["why"]) and _line(c["source"])
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert UNIT.match(m["unit"]), m["unit"]
        assert m["better"] in ("lower", "higher")
    for m in bench["per_layer"]:
        assert _line(m["layer"])
    metric_names = [n for g, n in names if g in ("end_to_end", "per_layer")]
    assert len(set(metric_names)) == len(metric_names)
    for g in ("configs", "workloads"):
        got = [n for gg, n in names if gg == g]
        assert len(set(got)) == len(got)


def test_bounds(bench):
    for m in bench["end_to_end"]:
        assert 0.01 <= m["bound"] <= 0.25, m
    assert any(m["name"] == "setup_s" for m in bench["end_to_end"])


def _reports(m, cell):
    return "workloads" not in m or cell in m["workloads"]


def test_every_cell_reports_setup_another_metric_and_a_layer(bench):
    for w in bench["workloads"]:
        e2e = [m["name"] for m in bench["end_to_end"]
               if _reports(m, w["name"])]
        assert "setup_s" in e2e and len(e2e) >= 2, w["name"]
        assert any(_reports(m, w["name"]) for m in bench["per_layer"])


def test_moves_names_an_end_to_end_metric_each_cell_reports(bench):
    e2e = {m["name"]: m for m in bench["end_to_end"]}
    cells = {w["name"] for w in bench["workloads"]}
    for m in bench["per_layer"]:
        assert m["moves"] in e2e, m
        for cell in m.get("workloads", cells):
            assert cell in cells
            assert _reports(e2e[m["moves"]], cell), (m["name"], cell)
    for m in bench["end_to_end"]:
        assert set(m.get("workloads", cells)) <= cells


def test_every_configuration_has_a_cell_and_pairs_are_unique(bench):
    used = {w["config"] for w in bench["workloads"]}
    assert used == {c["name"] for c in bench["configs"]}
    pairs = [(w["config"], w["traffic"]) for w in bench["workloads"]]
    assert len(set(pairs)) == len(pairs)
    four = sum(w["chips"] == 4 for w in bench["workloads"])
    assert four <= max(1, len(bench["workloads"]) // 4)


def test_every_name_finds_its_file(bench):
    root = CHECKOUT / bench["paths"][0]
    for c in bench["configs"]:
        f = CHECKOUT / c["file"]
        assert f.is_file() and f.resolve().is_relative_to(root.resolve())
        cfg = json.loads(f.read_text())
        assert cfg["name"] == c["name"]
        assert (root / "systems" / f"{cfg['system']}.py").is_file()
        assert (root / "reference"
                / f"{cfg.get('reference', cfg['name'])}.py").is_file()
        assert set(cfg["limits"])
    for w in bench["workloads"]:
        mix = json.loads((root / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert (root / "generators" / f"{mix['generator']}.py").is_file()
    for m in bench["end_to_end"] + bench["per_layer"]:
        assert (root / "metrics" / f"{m['name']}.py").is_file(), m["name"]
    for f in root.rglob("*"):
        if "__pycache__" in f.parts or not f.is_file():
            continue
        assert PATH.match(str(f.relative_to(CHECKOUT))), f


def test_the_command_names_no_file_outside_paths(bench):
    for word in bench["command"][1:]:
        if "/" in word or word.endswith(".py"):
            assert any(word.startswith(p + "/") for p in bench["paths"])


def test_a_full_check_fits_with_every_cell(bench):
    """2 + 14 x 24 runs, each run_seconds + 60 s, 2 x 90 s of compiling a
    cell and 1,200 s spare fit into 43,200 s."""
    cells = 24
    total = (2 + 14 * cells) * (bench["run_seconds"] + 60) \
        + cells * 2 * 90 + 1200
    assert total <= 43200
