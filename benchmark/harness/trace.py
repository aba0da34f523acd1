"""A traced stretch of a run: torch.profiler's trace, reduced to device busy
time (the union of the device's kernel, copy and set intervals), the
kernels' time by name, and the idle gaps labelled by what the host was doing.

The host's labels are the benchmark's own `record_function` ranges around
each job ("job", and inside it "outputs to host") and the innermost op the
host had open when the gap began.
"""

from __future__ import annotations

import json
import os
import tempfile
from contextlib import contextmanager

DEVICE_CATS = ("kernel", "gpu_memcpy", "gpu_memset")


@contextmanager
def profiled(holder: dict, device: str = "cuda"):
    """Profile the enclosed work; on exit holder["events"] has the trace's
    events (the chrome trace's list)."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    with profile(activities=acts) as prof:
        yield
        if device == "cuda":
            torch.cuda.synchronize()
    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        prof.export_chrome_trace(path)
        with open(path) as f:
            holder["events"] = json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def _merge(intervals):
    out = []
    for a, b in sorted(intervals):
        if out and a <= out[-1][1]:
            out[-1][1] = max(out[-1][1], b)
        else:
            out.append([a, b])
    return out


def reduce(events: list, top: int = 10) -> dict:
    """{busy_s, window_s, jobs_s, busy_in_jobs_s, kernel_s (by name),
    device_ops, idle_gaps}; the window spans the first "job" range's start
    to the last one's end; jobs_s is the time inside "job" ranges and
    busy_in_jobs_s the device's busy time within them."""
    dev = [e for e in events if e.get("ph") == "X" and e.get("cat") in DEVICE_CATS]
    host = [e for e in events if e.get("ph") == "X" and e.get("cat") in
            ("user_annotation", "cpu_op", "cuda_runtime")]
    jobs = [e for e in host if e.get("name") == "job"]
    if not jobs or not dev:
        return {}
    t0 = min(e["ts"] for e in jobs)
    t1 = max(e["ts"] + e["dur"] for e in jobs)
    busy = _merge([(max(t0, e["ts"]), min(t1, e["ts"] + e["dur"])) for e in dev
                   if e["ts"] + e["dur"] > t0 and e["ts"] < t1])
    kernel_s = {}
    for e in dev:
        kernel_s[e["name"]] = kernel_s.get(e["name"], 0.0) + e["dur"] * 1e-6
    gaps = []
    edges = [t0] + [x for iv in busy for x in iv] + [t1]
    for a, b in zip(edges[::2], edges[1::2]):
        if b > a:
            gaps.append((b - a, a))
    gaps.sort(reverse=True)
    idle = []
    for dur, at in gaps[:top]:
        open_ = [e for e in host if e["ts"] <= at < e["ts"] + e["dur"]]
        ann = [e["name"] for e in sorted(open_, key=lambda e: e["ts"])
               if e["cat"] == "user_annotation"]
        ops = [e for e in open_ if e["cat"] != "user_annotation"]
        inner = max(ops, key=lambda e: e["ts"])["name"] if ops else "host"
        idle.append(["/".join(ann + [inner]), dur * 1e-6])
    ops = sorted(kernel_s.items(), key=lambda kv: -kv[1])[:top]
    spans = _merge([(e["ts"], e["ts"] + e["dur"]) for e in jobs])
    in_jobs = sum(max(0.0, min(b, y) - max(a, x)) for a, b in busy for x, y in spans)
    return dict(busy_s=sum(b - a for a, b in busy) * 1e-6, window_s=(t1 - t0) * 1e-6,
                jobs_s=sum(b - a for a, b in spans) * 1e-6, busy_in_jobs_s=in_jobs * 1e-6,
                kernel_s=kernel_s, device_ops=[[k, v] for k, v in ops], idle_gaps=idle)
