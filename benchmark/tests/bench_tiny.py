"""Tiny stand-ins for the cells' traffic, so a whole run fits a CPU test: the
mix <traffic> is cut to tests/tiny/<traffic>.json, read by the cell's driver
as it reads the mix itself. A cell's stand-in is a data file of its own."""

import json
import time
from pathlib import Path

from benchmark.harness import runner, spec as spec_mod

TINY_DIR = Path(__file__).resolve().parent / "tiny"


def tiny_traffic(name: str, *_) -> dict:
    """The tiny stand-in of traffic mix `name` (spec.traffic's signature)."""
    return json.loads((TINY_DIR / f"{name}.json").read_text())


def run_tiny(monkeypatch, workload: str, *, seed: int = 2**31 + 77, trace: bool = False,
             seconds: float = 0.5) -> dict:
    """One whole run of `workload` on the CPU with its traffic cut to its stand-in."""
    monkeypatch.setattr(spec_mod, "traffic", tiny_traffic)
    return runner.run_cell(spec_mod.load_spec(), workload, seed, seconds, trace, "cpu",
                           time.perf_counter())
