"""The readings that the limits of `correct` are set from, at a cell's own
sizes, in one process:

    python3 benchmark/calibrate.py --workload <name> --seeds 1 2 ... --control-seeds 1 2 3

For each of --seeds, `check_jobs` jobs from a stretch of the cell's
sequence of takes that the seed draws (its first SPAN jobs; one batch for
a batched cell) go through the program and each is compared with the plain
reference as a run's check compares it (drivers/offline_chain.compare):
the lower readings. For each of
--control-seeds, the same jobs' outputs come from the reference itself in
lower precision (the control, reference/precision.py) and are compared alike: the
upper readings. One JSON line per job, then a summary line.
"""

import json
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DEVICE = "cuda"
SPAN = 4096  # the stretch of a mix's sequence that the seeds draw from


def main() -> int:
    import argparse

    import torch

    from benchmark.harness import spec as spec_mod
    from benchmark.harness.program import Program
    from benchmark.harness.traffic import Traffic
    from benchmark.reference import chain as ref_chain
    from benchmark.reference.precision import Precision

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args()
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, a.workload)
    config = spec_mod.config(spec, cell["config"])
    data = spec_mod.traffic(cell["traffic"])
    if config.get("driver") != "offline_chain":
        raise SystemExit(f"{a.workload}: calibrate.py reads the offline chain's cells; its "
                         f"configuration's driver is {config.get('driver')!r}")
    drv = spec_mod.driver(config)
    rc = drv.reference_config(config)
    n_jobs = max(int(data["check_jobs"]), int(data["batch"]))

    def jobs_of(seed):
        traffic = Traffic(data, config, seed)
        first = int(np.random.default_rng([seed, 4]).integers(0, SPAN // n_jobs)) * n_jobs
        return traffic, [traffic.job(first + i) for i in range(n_jobs)]

    program = Program(config, device=DEVICE)
    lower, upper = {}, {}

    def record(kind, seed, job, nums, into):
        for k, v in nums.items():
            into[k] = max(into.get(k, 0.0), v) if kind == "program" else min(
                into.get(k, float("inf")), v)
        print(json.dumps({"kind": kind, "seed": seed, "job": job["index"],
                          "seconds": job["seconds"], **nums}), flush=True)

    for seed in a.seeds:
        traffic, jobs = jobs_of(seed)
        if traffic.batch == 1:
            outs = [program.run_job(j) for j in jobs[:int(data["check_jobs"])]]
        else:
            outs = program.run_batch(jobs[:traffic.batch])[:int(data["check_jobs"])]
        for job, out in zip(jobs, outs):
            t0 = time.perf_counter()
            nums = drv.compare(job, drv.judged(out), rc, DEVICE)
            nums["check_s"] = time.perf_counter() - t0
            record("program", seed, job, nums, lower)
    for seed in a.control_seeds:
        for job in jobs_of(seed)[1][:int(data["check_jobs"])]:
            got = ref_chain.outputs(job, rc, Precision("lower"), DEVICE)
            record("control", seed, job, drv.compare(job, got, rc, DEVICE), upper)
    torch.cuda.synchronize()
    print(json.dumps({"summary": a.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
