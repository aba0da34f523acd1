"""render_launches.*: the reader of the render span's "render_launches"
counter and its BENCHMARK.json entries."""

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.tests.bench_tiny import run_tiny
from cpp_audio_tpu_torch.utils import profiling

SPEC = spec_mod.load_spec()
CELLS = {".job": ("resynth_64v.single_60s", "job_ms_p95"),
         ".clips": ("resynth_64v.clips_2-8s", "audio_s_per_s"),
         ".serve": ("resynth_64v.batch16_60s", "audio_s_per_s")}


def _store(monkeypatch) -> profiling.SpanStore:
    store = profiling.SpanStore()
    monkeypatch.setattr(profiling, "SPANS", store)
    return store


def _plant(store, name, id_, counts):
    rec = profiling.SpanRecord(name, "chain", id_, 0, 1_000_000, None, counts)
    rec.device_ms = 1.0
    store.add(rec)


def test_entries_resolve():
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for c, (cell, moves) in CELLS.items():
        m = entries[f"render_launches{c}"]
        assert m["source"] == "program_counter" and m["workloads"] == [cell]
        assert m["moves"] == moves
        assert m["layer"] == entries["stage_gpu_ms.render"]["layer"]
        assert callable(spec_mod.reader(m["name"]))


@pytest.mark.parametrize("suffix", sorted(CELLS))
def test_reads_the_mean_per_job(monkeypatch, suffix):
    store = _store(monkeypatch)
    read = spec_mod.reader(f"render_launches{suffix}")
    assert read(None) is None                     # no spans
    for id_ in (1, 2):
        _plant(store, "tracker", id_, {"host_waits": 1, "frame_loops": 0})
        _plant(store, "render", id_, {"host_waits": 0, "frame_loops": 0,
                                      "render_launches": 1})
    _plant(store, "render", 2, {"host_waits": 0, "frame_loops": 0,
                                "render_launches": 2})   # a second render in job 2
    assert read(None) == pytest.approx((1 + 1 + 2) / 2)


def test_reads_nothing_without_the_counter(monkeypatch):
    """A program whose spans lack the counter (one without the render
    kernel) reads None, and the metric is left out."""
    store = _store(monkeypatch)
    _plant(store, "render", 1, {"host_waits": 0, "frame_loops": 0})
    for c in CELLS:
        assert spec_mod.reader(f"render_launches{c}")(None) is None


def test_traced_tiny_run_reports_the_counter(monkeypatch):
    """On the CPU the render is the plain twin: the span counts no launch."""
    _store(monkeypatch)
    got = run_tiny(monkeypatch, CELLS[".job"][0], trace=True)["metrics"]
    assert got["render_launches.job"]["value"] == 0.0
