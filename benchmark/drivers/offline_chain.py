"""The offline resynthesis chain, in a closed loop with one client.

The program is harness/program.Program (the device chain for one job, the
batched step for a batch), the inputs harness/traffic.Traffic's offline
takes. The next job (or batch of jobs) is submitted when the previous
one's outputs are host arrays, so a job is due at its submission, and its
time runs from there to its outputs on the host. The window closes at the first completion at or after --seconds, so
no job is dropped or split. The check holds the sampled jobs against the
plain reference (reference/chain.compare).
"""

from __future__ import annotations

import math
import sys
import time

import numpy as np

from benchmark.harness import counts, trace
from benchmark.harness.program import Program, host_peaks
from benchmark.harness.runner import settle, sync
from benchmark.harness.traffic import Traffic


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


def judged(out: dict) -> dict:
    """A job's program outputs as the reference reads them."""
    freq, mag = host_peaks(out)
    return dict(freq=freq, mag=mag, stereo=out["stereo"], vocoded=out["vocoded"],
                dropped=out["dropped"])


def compare(job: dict, got: dict, rc: dict, device: str) -> dict:
    """reference/chain.compare's numbers for one job, each under its limit's
    name (the knife-edges the reference took as `knife_edges`)."""
    from benchmark.reference import chain as ref_chain

    nums = ref_chain.compare(job, got, rc, device)
    nums["knife_edges"] = float(nums.pop("info")["knife_edges_taken"])
    return nums


class State:
    def __init__(self, config: dict, data: dict, seed: int, device: str):
        self.config, self.device = config, device
        self.program = Program(config, device=device)
        self.traffic = Traffic(data, config, seed)
        self.longest = max(self.traffic.lengths)


def setup(config: dict, data: dict, seed: int, device: str) -> State:
    """The program, the traffic, and one warm-up batch of each take length."""
    state = State(config, data, seed, device)
    program, traffic = state.program, state.traffic
    batch = traffic.batch
    warm = traffic.warm_jobs()
    for i in range(0, len(warm), batch):
        if batch == 1:
            program.run_job(warm[i])
        else:
            program.run_batch(warm[i:i + batch])
    settle(device)
    return state


def window(state: State, seconds: float, trace_on: bool, run, sample) -> None:
    """The measured window: with trace_on, the mix's `profile_jobs` under the
    profiler, then jobs timed stage by stage."""
    from torch.profiler import record_function

    program, traffic, device = state.program, state.traffic, state.device
    batch = traffic.batch
    prof_jobs = int(traffic.data["profile_jobs"]) if trace_on else 0
    holder = {}
    t0 = time.perf_counter()
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
                    sync(device)
                    tp = time.perf_counter()
                step = program.prepare_batch(jobs)
                if timed:
                    sync(device)
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
    if trace_on:
        run.trace = trace.reduce(holder.get("events", []))
        run.bound_s = sum(counts.kernel_bound(j["voices"], j["n"], program.block_size)["bound_s"]
                          for j in profiled_jobs)


def check(state: State, items: list, device: str) -> tuple[dict, int]:
    """The worst of each compared number over the sampled jobs, and how
    many sampled jobs broke a limit; the program is dropped first."""
    state.program = None
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    rc = reference_config(state.config)
    limits = state.config["limits"]
    worst = dict.fromkeys(limits, 0.0)
    failed = 0
    for job, out in items:
        nums = compare(job, judged(out), rc, device)
        print(f"checked job {job['index']} (take {job['take']}, {job['seconds']:g} s): {nums}",
              file=sys.stderr)
        bad = False
        for k, v in nums.items():
            v = float(v) if math.isfinite(v) else float("inf")
            worst[k] = max(worst[k], v)
            bad |= not v <= limits[k]
        failed += bad
    return worst, failed
