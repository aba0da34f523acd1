"""BENCHMARK.json and the files it names, found by name.

A cell names a configuration (benchmark/configs/<config>.json) and a
traffic mix (benchmark/traffic/<traffic>.json); the configuration names the
driver that runs its cells (benchmark/drivers/<driver>.py, see
harness/runner.py); every metric is read by
benchmark/metrics/<metric>.py or, where there is none, by the reader named
by the metric's name up to its first dot (stage_ms.render ->
stage_ms.py), whose `read(run, name)` returns a number or None.
"""

from __future__ import annotations

import importlib.util
import json
from pathlib import Path

BENCH_DIR = Path(__file__).resolve().parent.parent
ROOT = BENCH_DIR.parent


def load_spec(root: Path = ROOT) -> dict:
    return json.loads((root / "BENCHMARK.json").read_text())


def cell(spec: dict, name: str) -> dict:
    for w in spec["workloads"]:
        if w["name"] == name:
            return w
    raise SystemExit(f"no workload named {name!r} in BENCHMARK.json")


def config(spec: dict, name: str, root: Path = ROOT) -> dict:
    for c in spec["configs"]:
        if c["name"] == name:
            return json.loads((root / c["file"]).read_text())
    raise SystemExit(f"no configuration named {name!r} in BENCHMARK.json")


def traffic(name: str, bench_dir: Path = BENCH_DIR) -> dict:
    return json.loads((bench_dir / "traffic" / f"{name}.json").read_text())


def _load(path: Path, module: str):
    spec = importlib.util.spec_from_file_location(module, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def driver(config: dict, bench_dir: Path = BENCH_DIR):
    """The module named by the configuration's "driver": <bench_dir>/drivers/<driver>.py.
    There is no default."""
    name = config.get("driver")
    if name is None:
        raise SystemExit(f"configuration {config.get('name')!r} has no \"driver\" key: "
                         f"it names the module {bench_dir / 'drivers'}/<driver>.py that runs "
                         "its cells")
    path = bench_dir / "drivers" / f"{name}.py"
    if not path.is_file():
        raise SystemExit(f"configuration {config.get('name')!r} names the driver {name!r}, "
                         f"and {path} is missing")
    return _load(path, f"bench_driver_{name}")


def cell_metrics(spec: dict, cell_name: str, trace: bool) -> list[dict]:
    """The metrics a run of the cell reports: its end-to-end ones, or with
    --trace 1 its per-layer ones (those listing the cell, or, without a
    `workloads` key, those whose end-to-end metric the cell reports)."""
    def here(m):
        return cell_name in m.get("workloads", [cell_name])
    e2e = [m for m in spec["end_to_end"] if here(m)]
    if not trace:
        return e2e
    names = {m["name"] for m in e2e}
    return [m for m in spec["per_layer"]
            if (cell_name in m["workloads"] if "workloads" in m
                else m["moves"] in names)]


def reader(metric: str):
    """The metric's read(run), from benchmark/metrics/<metric>.py, else from
    benchmark/metrics/<the name up to its first dot>.py."""
    for stem in dict.fromkeys((metric, metric.split(".")[0])):
        path = BENCH_DIR / "metrics" / f"{stem}.py"
        if path.exists():
            break
    else:
        raise SystemExit(f"no reader for metric {metric!r}: {path} is missing")
    mod = _load(path, f"bench_metric_{stem}")
    return lambda run: mod.read(run, metric)
