"""``BENCHMARK.json`` and the files it names: each parses, is found by
name, and keeps to the benchmark's rules on names, units, keys, lengths and
bounds."""

import importlib
import json
import re
from pathlib import Path

import pytest

from benchmark import harness, run

ROOT = harness.ROOT
MANIFEST = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
TEXT = re.compile(r"^[^\t\n]{1,200}$")
PATH = re.compile(r"^[A-Za-z0-9_./-]{1,200}$")
CELLS = [w["name"] for w in MANIFEST["workloads"]]
METRICS = MANIFEST["end_to_end"] + MANIFEST["per_layer"]


def test_top_level_keys_and_size():
    assert set(MANIFEST) == {"command", "paths", "run_seconds", "configs",
                             "workloads", "end_to_end", "per_layer"}
    assert (ROOT / "BENCHMARK.json").stat().st_size <= 64 * 1024


def test_command_and_paths():
    cmd, paths = MANIFEST["command"], MANIFEST["paths"]
    assert 1 <= len(cmd) <= 32 and all(TEXT.match(w) for w in cmd)
    assert 1 <= len(paths) <= 16
    for p in paths:
        assert PATH.match(p) and not p.startswith("/") and ".." not in p
        assert (ROOT / p).is_dir() and not p.endswith("_torch")
    for word in cmd:
        assert not word.startswith("/") and ".." not in word


def test_run_seconds_fits_a_full_check_at_24_cells():
    s = MANIFEST["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    assert (2 + 14 * 24) * (s + 60) + 24 * 2 * 90 + 1200 <= 43200


@pytest.mark.parametrize("entry", MANIFEST["configs"],
                         ids=lambda e: e["name"])
def test_config_entry(entry):
    assert set(entry) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(entry["name"]) and TEXT.match(entry["source"])
    assert TEXT.match(entry["why"]) and len(entry["reduced"]) <= 16
    path = ROOT / entry["file"]
    assert path.is_file() and entry["file"].startswith("benchmark/")
    config = json.loads(path.read_text())
    assert config["source"] == entry["source"]
    assert config["reduced"] == entry["reduced"]
    assert all(NAME.match(k) for k in entry["reduced"])
    assert any(w["config"] == entry["name"] for w in MANIFEST["workloads"])


def test_configs_distinct():
    entries = MANIFEST["configs"]
    for key in ("name", "file", "source"):
        assert len({e[key] for e in entries}) == len(entries)


@pytest.mark.parametrize("work", MANIFEST["workloads"],
                         ids=lambda w: w["name"])
def test_workload_entry_is_found_by_name(work):
    assert set(work) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(work["name"]) and NAME.match(work["traffic"])
    assert TEXT.match(work["why"]) and work["chips"] in (1, 4)
    cell = harness.load_cell(work["name"])
    assert cell.config["name"] == work["config"]
    kind = importlib.import_module(f"benchmark.kinds.{cell.traffic['kind']}")
    assert callable(kind.run) and callable(kind.control)
    names = {m["name"] for m in cell.end_to_end}
    assert "setup_s" in names and len(names) >= 2
    assert cell.per_layer
    for m in cell.per_layer:
        assert m["moves"] in names


def test_workloads_distinct_pairs_and_four_chip_share():
    pairs = {(w["config"], w["traffic"]) for w in MANIFEST["workloads"]}
    assert len(pairs) == len(CELLS) == len(set(CELLS))
    assert 1 <= len(CELLS) <= 24
    four = sum(w["chips"] == 4 for w in MANIFEST["workloads"])
    assert four <= max(1, len(CELLS) // 4)


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry(metric):
    assert NAME.match(metric["name"]) and UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    assert set(metric.get("workloads", [])) <= set(CELLS)
    if metric in MANIFEST["end_to_end"]:
        assert set(metric) - {"workloads"} == {"name", "unit", "better",
                                               "bound", "source"}
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25
    else:
        assert set(metric) == {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert metric["source"] in ("device_trace", "program_span",
                                    "program_counter", "host_clock")
        assert TEXT.match(metric["layer"])
        assert callable(run.metric_reader(metric["name"]))


def test_metric_names_distinct_and_setup_everywhere():
    names = [m["name"] for m in METRICS]
    assert len(names) == len(set(names))
    setup = [m for m in MANIFEST["end_to_end"] if m["name"] == "setup_s"]
    assert len(setup) == 1 and "workloads" not in setup[0]
    assert setup[0]["bound"] <= 0.25


def test_layers_named_alike():
    """Metrics of one layer name it letter for letter as PERF.md's list of
    layers does."""
    perf = (ROOT / "PERF.md").read_text()
    for layer in {m["layer"] for m in MANIFEST["per_layer"]}:
        assert f"**{layer}**" in perf


def test_every_file_is_named_from_name_characters():
    for path in (ROOT / "benchmark").rglob("*"):
        if "__pycache__" in path.parts or path.is_dir():
            continue
        rel = path.relative_to(ROOT).as_posix()
        assert PATH.match(rel), rel


@pytest.mark.parametrize("traffic", sorted(
    (ROOT / "benchmark" / "traffic").glob("*.json")), ids=lambda p: p.stem)
def test_traffic_files_parse(traffic):
    mix = json.loads(Path(traffic).read_text())
    assert NAME.match(traffic.stem)
    assert (ROOT / "benchmark" / "kinds" / f"{mix['kind']}.py").is_file()
    assert mix["in_flight"] == 1 and mix["message_bits"] > 64
