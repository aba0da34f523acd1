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

Spans (the port's own; the JAX package has none): `span(name, device)`
marks a stretch of the program, such as a stage of the offline chain.
A span records only while a torch profiler is recording (a
`torch.profiler.profile` or `device_trace` block), or for the innermost
`timed()` sink; otherwise it costs one check and does nothing. A
recording span opens a `record_function` range of its name (so the
profiler's trace shows it, and the device's idle gaps inside it), and
keeps in SPANS: its name, its parent span, the id of the job or batch it
belongs to (the latest `chain` or `duplex` span's: one offline job or
batch, one live callback; or the next one's outside any of them), its
host start and end (`perf_counter_ns`), on a CUDA device a
pair of timing events recorded on the current stream without
synchronising (resolved when read), and the change of each program
counter in COUNTERS over the span. Parents and ids follow one thread's
spans: record from one thread at a time.
"""

from __future__ import annotations

import contextlib
import json
import queue
import threading
import time
from collections import defaultdict

import numpy as np
import torch
from torch.autograd import profiler as _autograd_profiler


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


# Program counters a span records the change of: name -> a reading (the
# modules that own the counters register them; analysis/device_tracker:
# "host_waits" and "frame_loops"; ops/cuda_render: "render_launches";
# analysis/chain: "pinned_outputs").
COUNTERS: dict = {}

# The live path's waits for the device (analysis/streaming,
# models/streaming_synth, models/carrier add to it): each host array it
# uploads and each device array it reads back to the host.
LIVE_WAITS = 0
COUNTERS["live_waits"] = lambda: LIVE_WAITS

# The spans that open a job id: one offline job or batch, one live callback.
JOB_SPANS = ("chain", "duplex")


class _Off:
    """The span of a stretch with nothing recording."""

    __slots__ = ()

    def __enter__(self):
        return None

    def __exit__(self, *exc):
        return False


_OFF = _Off()
_SINKS: list = []   # timed() sinks, innermost last
_OPEN: list = []    # the recording spans now open, innermost last
_CHAIN = [0, 0]     # the latest job span's id, job spans now open


class SpanRecord:
    """One recorded span. device_ms is None off a CUDA device, and until
    SpanStore.summary() resolves the events."""

    __slots__ = ("name", "parent", "id", "t0_ns", "t1_ns", "events", "device_ms",
                 "counts")

    def __init__(self, name, parent, id_, t0_ns, t1_ns, events, counts):
        self.name, self.parent, self.id = name, parent, id_
        self.t0_ns, self.t1_ns = t0_ns, t1_ns
        self.events, self.device_ms, self.counts = events, None, counts

    @property
    def host_ms(self) -> float:
        return (self.t1_ns - self.t0_ns) * 1e-6


class SpanStore:
    """The recorded spans, at most `cap`; past it a span is counted in
    `dropped` and not kept."""

    def __init__(self, cap: int = 1 << 14):
        self.cap = cap
        self.records: list[SpanRecord] = []
        self.dropped = 0

    def __len__(self) -> int:
        return len(self.records)

    def add(self, rec: SpanRecord) -> None:
        if len(self.records) < self.cap:
            self.records.append(rec)
        else:
            self.dropped += 1

    def reset(self) -> None:
        self.records = []
        self.dropped = 0

    def summary(self, first: int = 0) -> dict:
        """{"spans": {name: {"count", "jobs", "parent", "device_ms",
        "host_ms", <counter>...}}, "dropped", "cap"} over the records from
        index `first` on. "count" is the spans of the name, "jobs" the
        distinct job or batch ids among them; every other number is a
        mean per job or batch: the spans' device ms (None where a span has
        no device time), host ms and counter changes, summed per id.
        "parent" is the first span's parent. Waits for the device's events
        it resolves."""
        by_name: dict = {}
        for r in self.records[first:]:
            if r.events is not None:
                start, end = r.events
                end.synchronize()
                r.device_ms, r.events = start.elapsed_time(end), None
            by_name.setdefault(r.name, []).append(r)
        spans = {}
        for name, recs in by_name.items():
            jobs = len({r.id for r in recs})
            out = dict(count=len(recs), jobs=jobs, parent=recs[0].parent,
                       device_ms=(None if any(r.device_ms is None for r in recs)
                                  else sum(r.device_ms for r in recs) / jobs),
                       host_ms=sum(r.host_ms for r in recs) / jobs)
            for k in recs[0].counts:
                out[k] = sum(r.counts[k] for r in recs) / jobs
            spans[name] = out
        return dict(spans=spans, dropped=self.dropped, cap=self.cap)


SPANS = SpanStore()


def _counts() -> dict:
    return {k: f() for k, f in COUNTERS.items()}


class _Span:
    """A span with a profiler recording, or a timed() sink, or both."""

    __slots__ = ("name", "device", "sink", "rec", "range", "parent", "id", "counts",
                 "start", "t0_ns")

    def __init__(self, name: str, device):
        self.name = name
        dev = None if device is None else torch.device(device)
        self.device = dev if dev is not None and dev.type == "cuda" else None
        self.sink = _SINKS[-1] if _SINKS else None
        self.rec = _autograd_profiler._is_profiler_enabled

    def __enter__(self):
        if self.rec:
            if self.name in JOB_SPANS:
                _CHAIN[0] += 1
                _CHAIN[1] += 1
            self.id = _CHAIN[0] if _CHAIN[1] else _CHAIN[0] + 1
            self.parent = _OPEN[-1].name if _OPEN else None
            _OPEN.append(self)
            self.range = _autograd_profiler.record_function(self.name)
            self.range.__enter__()
            self.counts = _counts()
            self.start = None
            if self.device is not None:
                self.start = torch.cuda.Event(enable_timing=True)
                self.start.record(torch.cuda.current_stream(self.device))
            self.t0_ns = time.perf_counter_ns()
        return self

    def __exit__(self, *exc):
        if self.rec:
            t1_ns = time.perf_counter_ns()
            events = None
            if self.device is not None:
                end = torch.cuda.Event(enable_timing=True)
                end.record(torch.cuda.current_stream(self.device))
                events = (self.start, end)
            c1 = _counts()
            self.range.__exit__(*exc)
            _OPEN.remove(self)
            if self.name in JOB_SPANS:
                _CHAIN[1] -= 1
            SPANS.add(SpanRecord(self.name, self.parent, self.id, self.t0_ns, t1_ns,
                                 events, {k: c1[k] - v for k, v in self.counts.items()}))
        if self.sink is not None:
            self.sink.mark(self.name)
        return False


def span(name: str, device=None):
    """A context manager marking the enclosed stretch as span `name` of the
    work on `device` (events are recorded on a CUDA device only). With no
    profiler recording and no timed() sink it is one check: no range, no
    event, no clock read, no synchronisation."""
    if not (_SINKS or _autograd_profiler._is_profiler_enabled):
        return _OFF
    return _Span(name, device)


class _Sink:
    """timed()'s sink: at the exit of a span named in `names`, synchronise
    the device and store the wall seconds since the previous such exit
    (or the sink's start) under the span's name."""

    def __init__(self, timings: dict, device, names):
        self.timings, self.names = timings, frozenset(names)
        dev = torch.device(device)
        self.device = dev if dev.type == "cuda" else None
        self.last = 0.0

    def __enter__(self):
        _SINKS.append(self)
        self.last = time.perf_counter()
        return self

    def __exit__(self, *exc):
        _SINKS.remove(self)
        return False

    def mark(self, name: str) -> None:
        if name not in self.names:
            return
        if self.device is not None:
            torch.cuda.synchronize(self.device)
        now = time.perf_counter()
        self.timings[name] = now - self.last
        self.last = now


def timed(timings: dict | None, device, names):
    """A context manager: with a `timings` dict, the spans named in
    `names` that open inside it (and inside no inner timed()) store their
    walls in it, each from the previous one's end, the device
    synchronised at each (a measurement aid: the synchronisations cost
    overlap, so time the work without it). With None it does nothing."""
    return _OFF if timings is None else _Sink(timings, device, names)


@contextlib.contextmanager
def device_trace(log_dir: str, *, device="cuda"):
    """torch.profiler trace (host activity, and the card's when `device` is
    a CUDA device) around a block, written as a Chrome trace to
    `log_dir`/trace.json — the device-side analog of the reference's
    per-stage CPU timers (SURVEY §5.1) — and the summary of the spans
    recorded in it (SpanStore.summary) to `log_dir`/spans.json."""
    import os

    from torch.profiler import ProfilerActivity, profile

    activities = [ProfilerActivity.CPU]
    if torch.device(device).type == "cuda":
        activities.append(ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    first = len(SPANS)
    with profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, "trace.json"))
    with open(os.path.join(log_dir, "spans.json"), "w") as f:
        json.dump(SPANS.summary(first), f, indent=1)
