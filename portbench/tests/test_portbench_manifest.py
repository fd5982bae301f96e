"""BENCHMARK.json against the benchmark's contract, and every name in it
backed by its files under portbench/."""
import json
import re
from pathlib import Path

import pytest

ROOT = Path(__file__).resolve().parents[2]
BENCH = ROOT / "portbench"
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SOURCES = {"device_trace", "program_span", "program_counter", "host_clock"}


@pytest.fixture(scope="module")
def m():
    return json.loads((ROOT / "BENCHMARK.json").read_text())


def _line(s: str) -> bool:
    return 1 <= len(s) <= 200 and "\n" not in s and "\t" not in s


def test_top_level_keys(m):
    assert set(m) == {"command", "paths", "run_seconds", "configs",
                      "workloads", "end_to_end", "per_layer"}
    assert m["paths"] == ["portbench"]
    assert m["command"][1] == "portbench/run.py"
    assert all(_line(w) for w in m["command"])
    assert isinstance(m["run_seconds"], int) and 1 <= m["run_seconds"] <= 51
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


def test_names_units_and_entries(m):
    metric_keys = {"name", "unit", "better", "source", "bound", "workloads",
                   "layer", "moves"}
    names = []
    for c in m["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert _line(c["why"]) and _line(c["source"])
        assert all(NAME.match(k) for k in c["reduced"])
        names.append(c["name"])
    for w in m["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"}
        assert w["chips"] == 1 and _line(w["why"])
        assert NAME.match(w["config"]) and NAME.match(w["traffic"])
    for x in m["end_to_end"] + m["per_layer"]:
        assert set(x) <= metric_keys
        assert UNIT.match(x["unit"]) and x["better"] in ("lower", "higher")
        assert x["source"] in SOURCES
    for x in m["end_to_end"]:
        assert x["source"] in ("host_clock", "device_trace")
        assert 0.01 <= x["bound"] <= 0.25
    for x in m["per_layer"]:
        assert "bound" not in x and _line(x["layer"])
    for group in ("configs", "workloads"):
        got = [x["name"] for x in m[group]]
        assert len(got) == len(set(got))
    metrics = [x["name"] for x in m["end_to_end"] + m["per_layer"]]
    assert len(metrics) == len(set(metrics))
    assert all(NAME.match(n) for n in names + metrics
               + [w["name"] for w in m["workloads"]])


def test_every_configuration_has_a_cell_and_its_files(m):
    used = {w["config"] for w in m["workloads"]}
    for c in m["configs"]:
        assert c["name"] in used
        path = ROOT / c["file"]
        assert path.is_file() and path.is_relative_to(BENCH)
        conf = json.loads(path.read_text())
        assert conf["reduced"] == c["reduced"] and conf["precision"]
    for w in m["workloads"]:
        assert (BENCH / "traffic" / f"{w['traffic']}.json").is_file()
        assert (BENCH / "limits" / f"{w['name']}.json").is_file()


def _cells_of(x, m):
    every = [w["name"] for w in m["workloads"]]
    return x.get("workloads", every)


def test_each_cell_reports_setup_another_end_to_end_and_a_layer(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    assert "setup_s" in e2e and "workloads" not in e2e["setup_s"]
    for w in m["workloads"]:
        own = [x["name"] for x in m["end_to_end"]
               if w["name"] in _cells_of(x, m)]
        assert "setup_s" in own and len(own) >= 2
        assert any(w["name"] in _cells_of(x, m) for x in m["per_layer"])


def test_every_layer_metric_moves_a_metric_its_cells_report(m):
    e2e = {x["name"]: x for x in m["end_to_end"]}
    for x in m["per_layer"]:
        assert x["moves"] in e2e
        for cell in _cells_of(x, m):
            assert cell in _cells_of(e2e[x["moves"]], m), (x["name"], cell)


def test_one_layer_name_per_layer(m):
    layers = {x["layer"] for x in m["per_layer"]}
    heads = [lay.split(":")[0] for lay in layers]
    assert len(heads) == len(set(heads))


def test_every_metric_has_its_reader(m):
    for x in m["end_to_end"] + m["per_layer"]:
        assert (BENCH / "metrics" / f"{x['name']}.py").is_file(), x["name"]


def test_traffic_mixes_are_data(m):
    for w in m["workloads"]:
        mix = json.loads((BENCH / "traffic" / f"{w['traffic']}.json")
                         .read_text())
        assert mix["loop"] in ("closed", "open", "convert")


def test_run_seconds_fit_the_full_check(m):
    runs = 2 + 14 * 24
    assert runs * (m["run_seconds"] + 60) + 24 * 180 + 1200 <= 43200
