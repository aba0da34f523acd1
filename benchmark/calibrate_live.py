"""The readings that the limits of `correct` of a live cell are set from, at
the cell's own sizes, in one process:

    python3 benchmark/calibrate_live.py --workload live_resynth_127v.duplex_512 \
        --seconds 51 --seeds 1 2 ... --control-seeds 1 2 3

For each of --seeds, a whole run of the cell (runner.run_cell: set-up, the
open-loop window of --seconds, the check): the program's readings, the
lower ones. For each of --control-seeds, the stream of as many callbacks as
a window of --seconds at real time holds, and the callbacks the seed's
Sample draws from it, come from the reference itself in lower precision
(the control, reference/precision.py), compared as a run's check compares
the program (reference/live.compare): the upper readings. One JSON line per
run, then a summary line: the program's largest and the control's smallest
reading of each number.
"""

import json
import math
import sys
import time
from pathlib import Path

import numpy as np

ROOT = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(ROOT))
DEVICE = "cuda"


def main() -> int:
    import argparse

    from benchmark.harness import runner, spec as spec_mod
    from benchmark.reference import live as ref_live
    from benchmark.reference.precision import Precision

    ap = argparse.ArgumentParser()
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=51.0)
    ap.add_argument("--seeds", type=int, nargs="*", default=[])
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    a = ap.parse_args()
    spec = spec_mod.load_spec()
    cell = spec_mod.cell(spec, a.workload)
    config = spec_mod.config(spec, cell["config"])
    data = spec_mod.traffic(cell["traffic"])
    if config.get("driver") != "live_duplex":
        raise SystemExit(f"{a.workload}: calibrate_live.py reads the live duplex cells; its "
                         f"configuration's driver is {config.get('driver')!r}")
    drv = spec_mod.driver(config)
    limits = config["limits"]
    lower, upper = {}, {}

    def record(kind, seed, nums, into):
        for k in limits:
            v = nums[k]
            into[k] = max(into.get(k, 0.0), v) if kind == "program" else min(
                into.get(k, math.inf), v)
        print(json.dumps({"kind": kind, "seed": seed, **nums}), flush=True)

    for seed in a.seeds:
        out = runner.run_cell(spec, a.workload, seed, a.seconds, False, DEVICE,
                              time.perf_counter())
        record("program", seed, {k: v["value"] for k, v in out["checks"].items()}, lower)
    if a.control_seeds:
        rc = drv.reference_config(config, data)
        blk, sr = rc["block"], rc["sample_rate"]
        take = drv.take(config, data, DEVICE)
        n_cb = int(a.seconds * sr / blk) + 1
        fed = np.resize(take, n_cb * blk)
        for seed in a.control_seeds:
            sample = runner.Sample(seed, int(data["check_jobs"]), blk / sr)
            for i in range(n_cb):
                sample.offer(i, blk / sr)
            t0 = time.perf_counter()
            got = ref_live.outputs(fed, n_cb * blk, sorted(sample.items()), rc,
                                   Precision("lower"), DEVICE)
            stream, per, _info = ref_live.compare(fed, got, rc, DEVICE)
            nums = dict(stream)
            for k in ("resynth_gap", "vocoded_gap"):
                nums[k] = max(p[k] for p in per)
            nums["check_s"] = time.perf_counter() - t0
            record("control", seed, nums, upper)
    print(json.dumps({"summary": a.workload, "lower": lower, "upper": upper}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
