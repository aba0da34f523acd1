"""BENCHMARK.json: its shape, its names, and every name resolving to files."""

import json
import re

import pytest

from benchmark.harness import spec as spec_mod

NAME = re.compile(r"^[A-Za-z0-9_][A-Za-z0-9_.-]{0,63}$")
UNIT = re.compile(r"^[A-Za-z0-9_/%.-]{1,16}$")
SPEC = spec_mod.load_spec()


def test_top_level_keys():
    assert set(SPEC) == {"command", "paths", "run_seconds", "configs", "workloads",
                         "end_to_end", "per_layer"}
    assert SPEC["command"] == ["python3", "benchmark/run.py"]
    assert SPEC["paths"] == ["benchmark"]
    assert 1 <= SPEC["run_seconds"] <= 51
    assert len((spec_mod.ROOT / "BENCHMARK.json").read_bytes()) <= 64 * 1024


@pytest.mark.parametrize("c", SPEC["configs"], ids=lambda c: c["name"])
def test_config_resolves(c):
    assert set(c) == {"name", "source", "file", "reduced", "why"}
    assert NAME.match(c["name"]) and all(NAME.match(k) for k in c["reduced"])
    assert c["file"].startswith("benchmark/configs/")
    cfg = spec_mod.config(SPEC, c["name"])
    assert cfg["name"] == c["name"] and "limits" in cfg


@pytest.mark.parametrize("w", SPEC["workloads"], ids=lambda w: w["name"])
def test_cell_resolves(w):
    assert set(w) == {"name", "config", "traffic", "chips", "why"}
    assert NAME.match(w["name"]) and NAME.match(w["traffic"]) and w["chips"] in (1, 4)
    assert len(w["why"]) <= 200 and "\n" not in w["why"]
    data = spec_mod.traffic(w["traffic"])
    assert int(data["check_jobs"]) >= 1
    spec_mod.driver(spec_mod.config(SPEC, w["config"]))
    e2e = {m["name"] for m in spec_mod.cell_metrics(SPEC, w["name"], False)}
    assert "setup_s" in e2e and len(e2e) >= 2
    per_layer = spec_mod.cell_metrics(SPEC, w["name"], True)
    assert per_layer and all(m["moves"] in e2e for m in per_layer)


@pytest.mark.parametrize("m", SPEC["end_to_end"] + SPEC["per_layer"],
                         ids=lambda m: m["name"])
def test_metric_resolves(m):
    """Each metric has a reader: its own file, or the one its name up to the
    first dot names."""
    assert NAME.match(m["name"]) and UNIT.match(m["unit"]) and m["better"] in ("lower", "higher")
    assert callable(spec_mod.reader(m["name"]))
    cells = {w["name"] for w in SPEC["workloads"]}
    assert set(m.get("workloads", [])) <= cells
    if m in SPEC["end_to_end"]:
        assert set(m) <= {"name", "unit", "better", "bound", "source", "workloads"}
        assert m["source"] in ("host_clock", "device_trace") and 0.01 <= m["bound"] <= 0.25
    else:
        assert set(m) <= {"name", "unit", "better", "source", "layer", "moves", "workloads"}
        assert m["moves"] in {e["name"] for e in SPEC["end_to_end"]}


def test_names_unique():
    for group in (SPEC["configs"], SPEC["workloads"],
                  SPEC["end_to_end"] + SPEC["per_layer"]):
        names = [x["name"] for x in group]
        assert len(names) == len(set(names))
    assert (len({(w["config"], w["traffic"]) for w in SPEC["workloads"]})
            == len(SPEC["workloads"]))


def test_every_config_has_a_cell():
    assert {c["name"] for c in SPEC["configs"]} == {w["config"] for w in SPEC["workloads"]}


def test_traffic_files_are_data():
    for w in SPEC["workloads"]:
        path = spec_mod.BENCH_DIR / "traffic" / f"{w['traffic']}.json"
        json.loads(path.read_text())


def test_reader_falls_back_to_the_name_before_the_dot():
    from benchmark.harness.runner import Run

    run = Run()
    run.stage_s = {"render": [0.5, 1.5], "tracker": [0.25]}
    assert spec_mod.reader("stage_ms.render")(run) == 1000.0
    assert spec_mod.reader("stage_ms.tracker")(run) == 250.0
    assert spec_mod.reader("stage_ms.vocoder")(run) is None
    with pytest.raises(SystemExit):
        spec_mod.reader("no_such_metric.job")
