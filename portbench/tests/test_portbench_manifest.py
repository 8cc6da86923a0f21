"""BENCHMARK.json against the benchmark's contract: names, units, keys, the
files each entry points to, and the check's budget."""

import json
import re
from pathlib import Path

import pytest

from portbench import check, harness
from portbench.metrics import reader

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")


def _line(text):
    return 1 <= len(text) <= 200 and "\n" not in text and "\t" not in text


def test_top_level_keys_and_command():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs", "workloads",
                          "end_to_end", "per_layer"}
    assert 1 <= len(BENCH["command"]) <= 32 and all(_line(w) for w in BENCH["command"])
    assert not any(w.startswith("/") or ".." in w for w in BENCH["command"])
    for p in BENCH["paths"]:
        assert re.fullmatch(r"[A-Za-z0-9_./-]{1,200}", p) and (REPO / p).is_dir()
    assert len((REPO / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("entry", BENCH["configs"] + BENCH["workloads"] + BENCH["end_to_end"]
                         + BENCH["per_layer"], ids=lambda e: e["name"])
def test_names(entry):
    assert NAME.match(entry["name"])
    for key in ("config", "traffic"):
        if key in entry:
            assert NAME.match(entry[key])
    for key in entry.get("reduced", []):
        assert NAME.match(key)
    if "unit" in entry:
        assert UNIT.match(entry["unit"]) and entry["better"] in ("lower", "higher")
    for key in ("why", "layer", "source"):
        if key in entry:
            assert _line(entry[key])


def test_names_unique_and_keys_exact():
    for group in ("configs", "workloads", "end_to_end", "per_layer"):
        names = [e["name"] for e in BENCH[group]]
        assert len(names) == len(set(names))
    for c in BENCH["configs"]:
        assert set(c) == {"name", "source", "file", "reduced", "why"}
        assert c["file"].startswith(BENCH["paths"][0] + "/") and (REPO / c["file"]).is_file()
        assert json.loads((REPO / c["file"]).read_text())["name"] == c["name"]
    for w in BENCH["workloads"]:
        assert set(w) == {"name", "config", "traffic", "chips", "why"} and w["chips"] in (1, 4)
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    for m in BENCH["end_to_end"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "bound", "source"}
        assert m["source"] in ("host_clock", "device_trace")
        assert 0.01 <= m["bound"] <= 0.25
    for m in BENCH["per_layer"]:
        assert set(m) - {"workloads"} == {"name", "unit", "better", "source", "layer", "moves"}
        assert m["source"] in ("device_trace", "program_span", "program_counter", "host_clock")
        assert m["moves"] in {e["name"] for e in BENCH["end_to_end"]}


@pytest.mark.parametrize("work", BENCH["workloads"], ids=lambda w: w["name"])
def test_each_cell_resolves_and_reports(work):
    _, config, traffic = harness.resolve(work["name"], BENCH)
    assert traffic["name"] == work["traffic"]
    e2e = [m["name"] for m in harness.cell_metrics(work["name"], BENCH, False)]
    assert "setup_s" in e2e and len(e2e) >= 2
    assert harness.cell_metrics(work["name"], BENCH, True)
    limits = json.loads((REPO / "portbench" / "limits" / f"{work['name']}.json").read_text())
    assert set(limits["limits"]) == set(check.NUMBERS)
    assert set(config["reduced"]) <= set(config["net"])


@pytest.mark.parametrize("metric", BENCH["per_layer"], ids=lambda m: m["name"])
def test_each_per_layer_metric_has_a_reader(metric):
    assert callable(reader(metric["name"]))
    for cell in metric.get("workloads", []):
        assert cell in {w["name"] for w in BENCH["workloads"]}


def test_run_seconds_fit_the_check_with_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    runs = 2 + 14 * 24
    assert runs * (s + 60) + 24 * 2 * 90 + 1200 <= 43200
