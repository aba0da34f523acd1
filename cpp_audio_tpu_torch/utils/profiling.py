"""Tracing / profiling / observability utilities.

Reference analogs:
  - `profiling::ThreadCPUTimer` stage timers whose durations are exported via
    atomics and polled by the UI (rt.resynth.lib.periodicfft.cpp:140-179,
    rt.resynth.lib.cpp:1586-1617) -> StageTimer / StageDurations
  - `AsyncLogger` (RT-safe queue + printer thread with drop counting,
    include/audio_platforms.h:229-282) -> AsyncLogger (queue + worker thread;
    here it protects the render loop from I/O stalls rather than an RT thread)
  - `StringPlot` ASCII plots (used by main.test_fft.cpp:95) -> string_plot
  - torch.profiler hook for device traces (SURVEY §5.1 device equivalent)

Port of cpp_audio_tpu/utils/profiling.py: the host utilities are copies;
`device_trace` records with torch.profiler instead of jax.profiler.
"""

from __future__ import annotations

import contextlib
import queue
import threading
import time
from collections import defaultdict

import numpy as np


class StageDurations:
    """Last-duration-per-stage registry (the UI-poll gauges analog)."""

    def __init__(self):
        self._last: dict[str, float] = {}
        self._total: dict[str, float] = defaultdict(float)
        self._count: dict[str, int] = defaultdict(int)

    def record(self, stage: str, seconds: float) -> None:
        self._last[stage] = seconds
        self._total[stage] += seconds
        self._count[stage] += 1

    def last(self, stage: str) -> float | None:
        return self._last.get(stage)

    def mean(self, stage: str) -> float | None:
        c = self._count.get(stage)
        return self._total[stage] / c if c else None

    def summary(self) -> dict:
        return {s: {"last": self._last[s], "mean": self.mean(s),
                    "count": self._count[s]} for s in self._last}

    @contextlib.contextmanager
    def stage(self, name: str):
        t0 = time.perf_counter()
        try:
            yield
        finally:
            self.record(name, time.perf_counter() - t0)


class AsyncLogger:
    """Queue + worker-thread logger with drop counting.

    The producer side never blocks: messages beyond the queue capacity are
    counted as dropped (reference drop accounting, audio_platforms.h:260-270).
    """

    def __init__(self, sink=None, capacity: int = 4096):
        self._q: queue.Queue = queue.Queue(maxsize=capacity)
        self._sink = sink or (lambda msg: print(msg, flush=True))
        self.dropped = 0
        self._stop = False
        self._thread = threading.Thread(target=self._run, daemon=True)
        self._thread.start()

    def log(self, msg) -> None:
        try:
            self._q.put_nowait(msg)
        except queue.Full:
            self.dropped += 1

    def _run(self) -> None:
        while not self._stop or not self._q.empty():
            try:
                msg = self._q.get(timeout=0.1)
            except queue.Empty:
                continue
            self._sink(msg)

    def close(self) -> None:
        self._stop = True
        self._thread.join(timeout=2.0)


def string_plot(values, *, height: int = 16, width: int | None = None,
                log_y: bool = False) -> str:
    """ASCII plot (cpp.algorithms StringPlot, used by main.test_fft.cpp:95)."""
    v = np.asarray(values, np.float64)
    if width is not None and len(v) > width:
        edges = np.linspace(0, len(v), width + 1).astype(int)
        v = np.array([v[a:b].max() if b > a else 0.0
                      for a, b in zip(edges[:-1], edges[1:])])
    if log_y:
        v = np.log10(np.maximum(np.abs(v), 1e-12))
    lo, hi = float(v.min()), float(v.max())
    span = (hi - lo) or 1.0
    rows = []
    levels = np.clip(((v - lo) / span * (height - 1)).astype(int), 0, height - 1)
    for r in range(height - 1, -1, -1):
        rows.append("".join("*" if lv >= r else " " for lv in levels))
    return "\n".join(rows)


@contextlib.contextmanager
def device_trace(log_dir: str, *, device="cuda"):
    """torch.profiler trace (host activity, and the card's when `device` is
    a CUDA device) around a block, written as a Chrome trace to
    `log_dir`/trace.json — the device-side analog of the reference's
    per-stage CPU timers (SURVEY §5.1)."""
    import os

    import torch
    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
