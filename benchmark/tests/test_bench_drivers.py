"""A configuration names the driver that runs its cells: the lookup, and a
driver written outside the harness run through it unchanged."""

import json
import time

import pytest

from benchmark.harness import runner, spec as spec_mod

SPEC = spec_mod.load_spec()

# An open-loop stand-in: job i is due at PERIOD * i after the window opens,
# each takes WORK of host time, and job STALL takes STALL_WORK, so the jobs
# due during it complete late.
STUB = '''
import time

from benchmark.harness.runner import settle

PERIOD, WORK, STALL, STALL_WORK = 0.01, 0.001, 10, 0.06


class State:
    longest = 1.0


def _spin(until):
    while time.perf_counter() < until:
        pass


def setup(config, data, seed, device):
    _spin(time.perf_counter() + data["setup_s"])
    settle(device)
    return State()


def window(state, seconds, trace_on, run, sample):
    t0 = time.perf_counter()
    i = 0
    while True:
        due = t0 + PERIOD * i
        _spin(due)
        _spin(time.perf_counter() + (STALL_WORK if i == STALL else WORK))
        done = time.perf_counter()
        run.jobs.append((due, done, 1.0))
        sample.offer(({"index": i}, 2 * i), 1.0)
        i += 1
        if done - t0 >= seconds:
            break
    run.window_s = done - t0


def check(state, items, device):
    gap = max(abs(out - 2 * job["index"]) for job, out in items)
    return {"gap": float(gap)}, int(gap > 0)
'''


def _layout(tmp_path, config: dict, driver: str | None = None) -> dict:
    """A benchmark directory under tmp_path with one configuration, one
    traffic mix and, where given, one driver; returns its spec."""
    for sub in ("configs", "traffic", "drivers"):
        (tmp_path / sub).mkdir()
    (tmp_path / "configs" / "stub.json").write_text(json.dumps(config))
    (tmp_path / "traffic" / "paced.json").write_text(
        json.dumps({"check_jobs": 4, "setup_s": 0.2}))
    if driver is not None:
        (tmp_path / "drivers" / "stub.py").write_text(driver)
    e2e = [dict(m, workloads=["stub.paced"]) for m in SPEC["end_to_end"]
           if m["name"] in ("job_ms_p95", "setup_s")]
    return {"configs": [{"name": "stub", "source": "a stand-in", "file": "configs/stub.json",
                         "reduced": [], "why": "a stand-in"}],
            "workloads": [{"name": "stub.paced", "config": "stub", "traffic": "paced",
                           "chips": 1, "why": "a stand-in"}],
            "end_to_end": e2e, "per_layer": []}


def _run(spec, tmp_path, seconds=0.3):
    return runner.run_cell(spec, "stub.paced", 2**31 + 11, seconds, False, "cpu",
                           time.perf_counter(), root=tmp_path, bench_dir=tmp_path)


@pytest.mark.parametrize("config,named", [
    ({"name": "stub", "limits": {}}, "\"driver\" key"),
    ({"name": "stub", "driver": "no_such_driver", "limits": {}}, "no_such_driver.py"),
], ids=["no driver key", "driver file missing"])
def test_missing_driver_exits_naming_it(tmp_path, config, named):
    """No default and no fallback: a configuration without a driver, or
    whose driver file is missing, stops the run with a message naming it."""
    spec = _layout(tmp_path, config)
    with pytest.raises(SystemExit) as e:
        _run(spec, tmp_path)
    assert named in str(e.value) and "stub" in str(e.value)
    assert str(tmp_path / "drivers") in str(e.value)


def test_every_config_names_an_existing_driver():
    for c in SPEC["configs"]:
        drv = spec_mod.driver(spec_mod.config(SPEC, c["name"]))
        assert all(callable(getattr(drv, f)) for f in ("setup", "window", "check"))


def test_open_loop_driver_needs_no_harness_edit(tmp_path):
    """A driver found by the lookup in a directory passed in runs through
    run_cell: its jobs are stamped with their due times, so the unchanged
    job_ms_p95 reader counts the stall's wait on the jobs due during it."""
    spec = _layout(tmp_path, {"name": "stub", "driver": "stub", "limits": {"gap": 0.0}},
                   STUB)
    out = _run(spec, tmp_path)
    assert out["correct"] is True and out["failed"] == 0
    assert out["attempted"] >= 25
    assert set(out["metrics"]) == {"job_ms_p95", "setup_s"}
    assert out["metrics"]["setup_s"]["value"] >= 0.2
    # jobs 11-14 are due during job 10's 60 ms and wait for it: the p95 of
    # ~30 jobs reads a wait, where each job's own work is 1 ms
    assert out["metrics"]["job_ms_p95"]["value"] > 15.0
    assert out["checks"] == {"gap": {"value": 0.0, "limit": 0.0}}
