"""BENCHMARK.json and the files it names keep the benchmark's format:
names and units of the allowed characters, every configuration and cell
file present and consistent, every metric's reader present and agreeing
with its entry, the run length within the check's budget."""
import json
import math
import re

import pytest

from gfbench.harness import check, spec
from gfbench.tests.conftest import ROOT

BENCH = json.loads((ROOT / "BENCHMARK.json").read_text())
NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
WIDTH = re.compile(r"(hidden|intermediate|latent|state|proj|ffn|head|"
                   r"_dim$|_rank$|expansion|expand|per_tok)")
METRICS = BENCH["end_to_end"] + BENCH["per_layer"]


def test_top_level_keys():
    assert set(BENCH) == {"command", "paths", "run_seconds", "configs",
                          "workloads", "end_to_end", "per_layer"}
    assert BENCH["command"] == ["python3", "gfbench/run.py"]
    assert BENCH["paths"] == ["gfbench"]
    assert len((ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("name", [c["name"] for c in BENCH["configs"]]
                         + [w["name"] for w in BENCH["workloads"]]
                         + [m["name"] for m in METRICS])
def test_names(name):
    assert NAME.match(name), name


@pytest.mark.parametrize("metric", METRICS, ids=lambda m: m["name"])
def test_metric_entry_matches_its_reader(metric):
    assert UNIT.match(metric["unit"])
    assert metric["better"] in ("lower", "higher")
    r = spec.reader(metric["name"])
    assert (r.UNIT, r.BETTER, r.SOURCE) == (metric["unit"], metric["better"],
                                            metric["source"])
    if metric in BENCH["per_layer"]:
        assert set(metric) <= {"name", "unit", "better", "source", "layer",
                               "moves", "workloads"}
        assert (r.LAYER, r.MOVES) == (metric["layer"], metric["moves"])
        assert metric["moves"] in [m["name"] for m in BENCH["end_to_end"]]
        if metric["name"].endswith("_roofline_pct") or "mfu" in \
                metric["name"]:
            assert metric["unit"] == "%"
    else:
        assert metric["source"] in ("host_clock", "device_trace")
        assert 0.01 <= metric["bound"] <= 0.25


def test_every_cell_reports_setup_another_metric_and_a_layer():
    names = [m["name"] for m in BENCH["end_to_end"]]
    assert "setup_s" in names and len(names) >= 2
    for w in BENCH["workloads"]:
        cell = spec.load(w["name"])
        assert len(cell.metrics(False)) >= 2
        assert cell.metrics(True)


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_config_files(entry):
    conf = json.loads((ROOT / entry["file"]).read_text())
    assert conf["name"] == entry["name"]
    assert conf["source"] == entry["source"]
    assert conf["reduced"] == entry["reduced"]
    assert len(entry["reduced"]) <= 16
    for key in entry["reduced"]:
        assert NAME.match(key) and key in conf
        assert not WIDTH.search(key), f"{key} names a width"
    assert 1 <= len(entry["why"]) <= 200
    files = [c["file"] for c in BENCH["configs"]]
    assert files.count(entry["file"]) == 1
    assert any(w["config"] == entry["name"] for w in BENCH["workloads"])


@pytest.mark.parametrize("entry", BENCH["workloads"], ids=lambda w: w["name"])
def test_cell_files(entry):
    cell = spec.load(entry["name"])
    assert cell.chips in (1, 4)
    assert 1 <= len(entry["why"]) <= 200 and "\n" not in entry["why"]
    names = check.numbers(cell.workload["trainer"]["window_steps"])
    assert set(cell.workload["limits"]) == set(names)
    for key in names:
        assert cell.workload["limits"][key] > 0
    assert cell.reference.param_shapes(cell.config)
    for m in BENCH["per_layer"]:
        for w in m.get("workloads", []):
            assert w in [x["name"] for x in BENCH["workloads"]]


def test_pairs_unique_and_four_chip_cells_few():
    pairs = [(w["config"], w["traffic"]) for w in BENCH["workloads"]]
    assert len(pairs) == len(set(pairs))
    four = sum(w["chips"] == 4 for w in BENCH["workloads"])
    assert four <= max(1, len(BENCH["workloads"]) // 4)


def test_run_seconds_fits_a_full_check_of_24_cells():
    s = BENCH["run_seconds"]
    assert isinstance(s, int) and 1 <= s <= 51
    cells = 24
    assert (2 + 14 * cells) * (s + 60) + cells * 2 * 90 + 1200 <= 43200


def test_workload_and_traffic_files_have_cells():
    names = {w["name"] for w in BENCH["workloads"]}
    traffic = {w["traffic"] for w in BENCH["workloads"]}
    assert {p.stem for p in (ROOT / "gfbench/workloads").glob("*.json")} \
        == names
    assert {p.stem for p in (ROOT / "gfbench/traffic").glob("*.json")} \
        == traffic


def test_metric_readers_are_files_of_their_own():
    have = {p.stem for p in (ROOT / "gfbench/metrics").glob("*.py")} - \
        {"__init__"}
    assert have == {m["name"] for m in METRICS}


def test_config_sizes_are_published_widths():
    olmo = json.loads((ROOT / "gfbench/configs/olmo-1b.json").read_text())
    mg = json.loads((ROOT / "gfbench/configs/musicgen-large.json").read_text())
    assert (olmo["hidden_size"], olmo["num_hidden_layers"],
            olmo["intermediate_size"], olmo["vocab_size"]) == \
        (2048, 16, 8192, 50304)
    assert (mg["hidden_size"], mg["num_hidden_layers"], mg["ffn_dim"],
            mg["num_codebooks"], mg["vocab_size"]) == (2048, 48, 8192, 4,
                                                       2048)
    for conf in (olmo, mg):
        shapes = __import__(f"gfbench.reference.{conf['reference']}",
                            fromlist=["x"]).param_shapes(conf)
        assert sum(math.prod(s) for s, _ in shapes.values()) == \
            conf["parameters"]


@pytest.mark.parametrize("entry", BENCH["configs"], ids=lambda c: c["name"])
def test_as_run_keys_take_the_published_keys_place(entry):
    """The file's top level keeps the published keys; what the port runs
    otherwise sits under ``as_run`` and is what a cell's config reads."""
    conf = json.loads((ROOT / entry["file"]).read_text())
    cell = spec.load(next(w["name"] for w in BENCH["workloads"]
                          if w["config"] == entry["name"]))
    assert conf["as_run"]
    for key, value in conf["as_run"].items():
        assert cell.config[key] == value
        assert any(key in d for d in conf["departures"])
