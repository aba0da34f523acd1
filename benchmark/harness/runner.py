"""One run of one cell: set-up, the measured window, the check, the result.

The cell's configuration names its driver (its "driver" key), the module
benchmark/drivers/<driver>.py, which owns the program path, the loop and
the reference check. A driver provides three functions:

    setup(config, data, seed, device) -> state
        Builds the program and its inputs from the configuration, the
        traffic mix's data and --seed, runs its warm-up, and calls
        settle(device) last. `state.longest` is the seconds of audio of
        the longest job the mix sends: the check's Sample keeps a slot
        for one of them.
    window(state, seconds, trace_on, run, sample)
        Runs the measured loop until its rule closes the window, and fills
        `run` (a Run): `jobs`, one (due, done, seconds of audio) per
        completed job, where `due` is when the job was due (in a closed
        loop its submission) and `done` when its outputs were host arrays;
        `window_s`; and, with trace_on, whichever of `trace`, `stage_s`,
        `prepare_s`, `bound_s` and `frame_loops` apply. It offers each
        completed job with its output to `sample` (Sample.offer).
    check(state, items, device) -> (worst, failed)
        Frees what the program holds, then compares the sampled
        (job, output) items with the driver's own plain reference: the
        worst of each number over them, under the names of the
        configuration's `limits`, and how many items broke a limit.

The runner reads the device's memory peak after the window (settle() resets
it), the metrics from the Run, and prints the result.
"""

from __future__ import annotations

import gc
import json
import sys
import time

import numpy as np

from . import spec as spec_mod

FORBIDDEN = ("jax", "jaxlib", "flax", "cpp_audio_tpu")


class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.jobs = []          # (due, done, audio seconds) per job
        self.stage_s = {}       # stage -> seconds per job (traced runs)
        self.prepare_s = []     # batch staging spans (traced runs)
        self.trace = {}         # trace.reduce() of the profiled jobs
        self.bound_s = 0.0      # the voice-bank kernel's least time over them
        self.peak_mem_bytes = 0
        self.frame_loops = 0    # window jobs through the tracker's exact frame loop


class Sample:
    """A seeded reservoir of completed jobs, one slot kept for the longest
    take: a uniform sample of the window's jobs, drawn from the seed."""

    def __init__(self, seed: int, size: int, longest: float):
        self.rng = np.random.default_rng([seed, 3])
        self.size, self.longest = max(1, size - 1), longest
        self.kept, self.long, self.seen, self.seen_long = [], None, 0, 0

    def offer(self, item, seconds: float) -> None:
        if seconds >= self.longest:
            self.seen_long += 1
            if self.rng.integers(0, self.seen_long) == 0:
                self.long = item
        if self.seen < self.size:
            self.kept.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.kept[j] = item
        self.seen += 1

    def items(self) -> list:
        ids = {id(x) for x in self.kept}
        return self.kept + ([self.long] if self.long is not None and id(self.long) not in ids
                            else [])


def sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def settle(device: str) -> None:
    """The end of set-up: the device drained, and the set-up's objects
    collected and frozen out of the interpreter's collections (gc.freeze),
    as a latency-bound host would, so that a collection of the oldest
    generation, whose pauses scale with the set-up's heap, does not fall
    into the window. The device's memory peak is reset here."""
    sync(device)
    gc.collect()
    gc.freeze()
    if device == "cuda":
        import torch
        torch.cuda.reset_peak_memory_stats()


def forbidden_modules() -> list[str]:
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def result(run_ctx: Run, metrics: list[dict], worst: dict, failed: int, attempted: int,
           limits: dict, device_info: dict, trace_on: bool) -> dict:
    values = {}
    for m in metrics:
        v = spec_mod.reader(m["name"])(run_ctx)
        if v is not None:
            values[m["name"]] = {"value": v, "unit": m["unit"]}
    out = {"correct": failed == 0 and bool(worst), "attempted": attempted,
           "failed": failed, "metrics": values, "device": device_info}
    if trace_on and run_ctx.trace:
        out["device"] = dict(device_info, busy_s=run_ctx.trace["busy_s"],
                             window_s=run_ctx.trace["window_s"])
        out["breakdown"] = {"device_ops": run_ctx.trace["device_ops"],
                            "idle_gaps": run_ctx.trace["idle_gaps"]}
    out["checks"] = {k: {"value": worst[k], "limit": limits[k]} for k in limits}
    return out


def run_cell(spec: dict, workload: str, seed: int, seconds: float, trace_on: bool,
             device: str, t_start: float, *, root=spec_mod.ROOT,
             bench_dir=spec_mod.BENCH_DIR) -> dict:
    """A whole run on `device`; returns the result's dict. The cell's
    configuration file is found under `root`, its traffic mix and driver
    under `bench_dir`."""
    import torch

    cell = spec_mod.cell(spec, workload)
    config = spec_mod.config(spec, cell["config"], root)
    driver = spec_mod.driver(config, bench_dir)
    data = spec_mod.traffic(cell["traffic"], bench_dir)
    metrics = spec_mod.cell_metrics(spec, workload, trace_on)
    run_ctx = Run()
    state = driver.setup(config, data, seed, device)
    run_ctx.setup_s = time.perf_counter() - t_start
    sample = Sample(seed, int(data["check_jobs"]), state.longest)
    driver.window(state, seconds, trace_on, run_ctx, sample)
    if device == "cuda":
        run_ctx.peak_mem_bytes = int(torch.cuda.max_memory_allocated())
    ms = np.array([(b - a) * 1e3 for a, b, _s in run_ctx.jobs])
    print(f"window {run_ctx.window_s:.3f} s: {len(ms)} jobs, job ms median "
          f"{np.median(ms):.3f}, p95 {np.percentile(ms, 95):.3f}, max {ms.max():.3f}; "
          f"{run_ctx.frame_loops} through the tracker's frame loop", file=sys.stderr)
    attempted = len(run_ctx.jobs)
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": run_ctx.peak_mem_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    worst, failed = driver.check(state, sample.items(), device)
    found = forbidden_modules()
    if found:
        raise SystemExit(f"the run loaded {', '.join(found)}: the benchmark runs the "
                         "PyTorch port alone")
    out = result(run_ctx, metrics, worst, failed, attempted, config["limits"], info, trace_on)
    for k, v in out["checks"].items():
        print(f"check {k}: {v['value']!r} (limit {v['limit']!r})", file=sys.stderr)
    return out


def main(argv=None, *, t_start: float, device: str = "cuda") -> int:
    import argparse

    ap = argparse.ArgumentParser(description="Run one cell of the benchmark once.")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    a = ap.parse_args(argv)
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, a.workload)
    if device == "cuda":
        import torch
        if not torch.cuda.is_available() or torch.cuda.device_count() < int(cell["chips"]):
            print(f"{a.workload} needs {cell['chips']} CUDA device(s); "
                  f"torch sees {torch.cuda.device_count() if torch.cuda.is_available() else 0}",
                  file=sys.stderr)
            return 3
    out = run_cell(spec, a.workload, a.seed, a.seconds, bool(a.trace), device, t_start)
    print(json.dumps(out))
    return 0
