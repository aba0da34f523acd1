"""Tiny stand-ins for the cells' traffic, so a whole run fits a CPU test."""

import time

from benchmark.harness import runner, spec as spec_mod

TINY = {
    "single_60s": {"batch": 1, "take_seconds": [2], "voices": 8, "takes_seed": 17,
                   "shuffle_block": 4, "check_jobs": 2, "profile_jobs": 1},
    "batch16_60s": {"batch": 3, "take_seconds": [2], "voices": 8, "takes_seed": 17,
                    "shuffle_block": 3, "check_jobs": 2, "profile_jobs": 3},
    "clips_2-8s": {"batch": 1, "take_seconds": [2, 3], "voices": 8, "takes_seed": 19,
                   "shuffle_block": 4, "check_jobs": 2, "profile_jobs": 1},
}


def run_tiny(monkeypatch, workload: str, *, seed: int = 2**31 + 77, trace: bool = False,
             seconds: float = 0.5) -> dict:
    """One whole run of `workload` on the CPU with its traffic cut to TINY."""
    monkeypatch.setattr(spec_mod, "traffic", lambda name: TINY[name])
    return runner.run_cell(spec_mod.load_spec(), workload, seed, seconds, trace, "cpu",
                           time.perf_counter())
