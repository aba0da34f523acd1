"""One run of one cell: set-up, the measured window, the check, the result.

Closed loop, one client: the next job (or batch of jobs) is submitted when
the previous one's outputs are host arrays. A job's time runs from its
submission to its outputs on the host. The window closes at the first
completion at or after --seconds, so no job is dropped or split.
"""

from __future__ import annotations

import gc
import json
import math
import sys
import time

import numpy as np

from . import counts, spec as spec_mod, trace
from .traffic import Traffic

FORBIDDEN = ("jax", "jaxlib", "flax", "cpp_audio_tpu")


def reference_config(config: dict) -> dict:
    """The plain reference's view of a configuration."""
    tr, vc = config["tracker"], config["vocoder"]
    env = tr["env_seconds"]
    sr = config["sample_rate"]
    return dict(
        window=config["window"], stride=config["stride"], sample_rate=sr,
        peaks_per_frame=config["peaks_per_frame"],
        tracker=dict(nearby_distance_tones=tr["nearby_distance_tones"],
                     min_volume=tr["min_volume"], max_track_pitches=tr["max_track_pitches"],
                     analysis_volume=tr["analysis_volume"], max_voices=config["max_voices"],
                     stereo_spread=tr["stereo_spread"], pan_seed=tr["pan_seed"],
                     phase_seed=tr["phase_seed"], n_slots=config["n_slots"],
                     stride=config["stride"], sample_rate=sr,
                     attack=float(int(0.5 + env[0] * sr)), hold=float(int(0.5 + env[1] * sr)),
                     release=float(int(0.5 + env[3] * sr)), tail_frames=config["tail_frames"]),
        vocoder=dict(sample_rate=sr, stride=vc["stride"], window=vc["window"],
                     edges=np.exp(np.linspace(np.log(vc["min_hz"]), np.log(vc["max_hz"]),
                                              vc["bands"] + 1)).tolist(),
                     vol_voc=vc["vol_voc"], vol_mod=vc["vol_mod"], vol_car=vc["vol_car"]),
        max_flips=int(config["limits"]["knife_edges"]))


class Run:
    """What a run measured; the metric readers read it."""

    def __init__(self):
        self.setup_s = 0.0
        self.window_s = 0.0
        self.jobs = []          # (submitted, done, audio seconds) per job
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


def _sync(device: str) -> None:
    if device == "cuda":
        import torch
        torch.cuda.synchronize()


def settle(device: str) -> None:
    """The end of set-up: the device drained, and the set-up's objects
    collected and frozen out of the interpreter's collections (gc.freeze),
    as a latency-bound host would, so that a collection of the oldest
    generation, whose pauses scale with the set-up's heap, does not fall
    into the window."""
    _sync(device)
    gc.collect()
    gc.freeze()


def measure(program, traffic: Traffic, seconds: float, trace_on: bool, device: str,
            run: Run, sample: Sample, t_start: float) -> None:
    """Warm-up (set-up) and the measured window."""
    import torch
    from torch.profiler import record_function

    batch = traffic.batch
    warm = traffic.warm_jobs()
    for i in range(0, len(warm), batch):
        if batch == 1:
            program.run_job(warm[i])
        else:
            program.run_batch(warm[i:i + batch])
    settle(device)
    if device == "cuda":
        torch.cuda.reset_peak_memory_stats()
    prof_jobs = int(traffic.data["profile_jobs"]) if trace_on else 0
    holder = {}
    t0 = time.perf_counter()
    run.setup_s = t0 - t_start
    i = 0
    profiling = None
    loops0 = program.frame_loops()
    profiled_jobs = []
    while True:
        jobs = [traffic.job(i + b) for b in range(batch)]
        if trace_on and i == 0:
            profiling = trace.profiled(holder, device)
            profiling.__enter__()
        timed = trace_on and i >= prof_jobs
        t_sub = time.perf_counter()
        with record_function("job"):
            if batch == 1:
                stages = {} if timed else None
                outs = [program.run_job(jobs[0], timings=stages)]
                if timed:
                    for k, v in stages.items():
                        run.stage_s.setdefault(k, []).append(v)
            else:
                if timed:
                    _sync(device)
                    tp = time.perf_counter()
                step = program.prepare_batch(jobs)
                if timed:
                    _sync(device)
                    run.prepare_s.append(time.perf_counter() - tp)
                outs = program.finish_batch(step, jobs)
        t_done = time.perf_counter()
        if profiling is not None and i + batch >= prof_jobs:
            profiling.__exit__(None, None, None)
            profiling = None
        for job, out in zip(jobs, outs):
            run.jobs.append((t_sub, t_done, job["seconds"]))
            if trace_on and i < prof_jobs:
                profiled_jobs.append(job)
            sample.offer((job, out), job["seconds"])
        i += batch
        # a traced run closes after at least one timed job past the profiled ones
        if t_done - t0 >= seconds and not (trace_on and i <= prof_jobs):
            break
    if profiling is not None:
        profiling.__exit__(None, None, None)
    run.window_s = t_done - t0
    run.frame_loops = program.frame_loops() - loops0
    ms = np.array([(b - a) * 1e3 for a, b, _s in run.jobs])
    print(f"window {run.window_s:.3f} s: {len(ms)} jobs, job ms median "
          f"{np.median(ms):.3f}, p95 {np.percentile(ms, 95):.3f}, max {ms.max():.3f}; "
          f"{run.frame_loops} through the tracker's frame loop", file=sys.stderr)
    if trace_on:
        run.trace = trace.reduce(holder.get("events", []))
        run.bound_s = sum(counts.kernel_bound(j["voices"], j["n"], program.block_size)["bound_s"]
                          for j in profiled_jobs)
    if device == "cuda":
        run.peak_mem_bytes = int(torch.cuda.max_memory_allocated())


def check(sample: Sample, config: dict, device: str) -> tuple[dict, int]:
    """The worst of each compared number over the sampled jobs, and how
    many sampled jobs broke a limit."""
    from benchmark.reference import chain as ref_chain

    from .program import host_peaks

    cfg = reference_config(config)
    limits = config["limits"]
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    for job, out in sample.items():
        freq, mag = host_peaks(out)
        got = dict(freq=freq, mag=mag, stereo=out["stereo"], vocoded=out["vocoded"],
                   dropped=out["dropped"])
        nums = ref_chain.compare(job, got, cfg, device)
        print(f"checked job {job['index']} (take {job['take']}, {job['seconds']:g} s): {nums}",
              file=sys.stderr)
        nums["knife_edges"] = float(nums.pop("info")["knife_edges_taken"])
        bad = False
        for k, v in nums.items():
            v = float(v) if math.isfinite(v) else float("inf")
            worst[k] = max(worst[k], v)
            bad |= not v <= limits[k]
        failed += bad
    return worst, failed


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
             device: str, t_start: float) -> dict:
    """A whole run on `device`; returns the result's dict."""
    import torch

    cell = spec_mod.cell(spec, workload)
    config = spec_mod.config(spec, cell["config"])
    data = spec_mod.traffic(cell["traffic"])
    metrics = spec_mod.cell_metrics(spec, workload, trace_on)
    run_ctx = Run()
    from .program import Program

    program = Program(config, device=device)
    traffic = Traffic(data, config, seed)
    sample = Sample(seed, int(data["check_jobs"]), max(traffic.lengths))
    measure(program, traffic, seconds, trace_on, device, run_ctx, sample, t_start)
    attempted = len(run_ctx.jobs)
    if device == "cuda":
        info = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": 1,
                "memory_peak_bytes": run_ctx.peak_mem_bytes}
    else:
        info = {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}
    del program
    if device == "cuda":
        torch.cuda.empty_cache()
    worst, failed = check(sample, config, device)
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
