"""The readers of the program's stage spans (stage_gpu_ms, host_ms,
host_waits), their BENCHMARK.json entries, and the idle gaps that
harness/trace.py puts down to the span open at the time."""

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.harness import trace
from benchmark.tests.bench_tiny import run_tiny
from cpp_audio_tpu_torch.utils import profiling

SPEC = spec_mod.load_spec()
STAGES = ("synth", "analysis", "vocoder", "tracker", "render")
CELLS = {"": "resynth_64v.single_60s", ".clips": "resynth_64v.clips_2-8s",
         ".serve": "resynth_64v.batch16_60s"}
WAITS = {".job": CELLS[""], ".clips": CELLS[".clips"], ".serve": CELLS[".serve"]}
NEW = ({f"stage_gpu_ms.{s}{c}": cell for c, cell in CELLS.items() for s in STAGES}
       | {f"host_ms.{s}{c}": cell for c, cell in CELLS.items() for s in ("tracker", "staging")}
       | {f"host_waits{c}": cell for c, cell in WAITS.items()})


def _store(monkeypatch) -> profiling.SpanStore:
    store = profiling.SpanStore()
    monkeypatch.setattr(profiling, "SPANS", store)
    return store


def _plant(store, name, id_, host_ms, device_ms, waits):
    rec = profiling.SpanRecord(name, "chain", id_, 0, int(host_ms * 1e6), None,
                               {"host_waits": waits, "frame_loops": 0})
    rec.device_ms = device_ms
    store.add(rec)


def test_new_entries_resolve():
    assert len(NEW) == 24
    entries = {m["name"]: m for m in SPEC["per_layer"]}
    for name, cell in NEW.items():
        m = entries[name]
        assert m["source"] == "program_span" and m["workloads"] == [cell]
        assert m["moves"] in {e["name"] for e in spec_mod.cell_metrics(SPEC, cell, False)}
        assert callable(spec_mod.reader(name))


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_reads_nothing_from_an_empty_store(monkeypatch, name):
    _store(monkeypatch)
    assert spec_mod.reader(name)(None) is None


def test_readers_take_means_per_job(monkeypatch):
    store = _store(monkeypatch)
    for id_ in (1, 2):
        _plant(store, "staging", id_, 6.0 + id_, 0.5, 0)
        for i, s in enumerate(STAGES):
            _plant(store, s, id_, 2.0 * (i + 1) * id_, 1.0 * (i + 1) + id_,
                   {"vocoder": 5, "tracker": 1}.get(s, 0))
    _plant(store, "tracker", 2, 3.0, 1.0, 2)   # a second tracker span in job 2
    read = lambda name: spec_mod.reader(name)(None)  # noqa: E731
    for c in CELLS:
        assert read(f"stage_gpu_ms.synth{c}") == pytest.approx(2.5)
        assert read(f"stage_gpu_ms.render{c}") == pytest.approx(6.5)
        assert read(f"stage_gpu_ms.tracker{c}") == pytest.approx((5.0 + 6.0 + 1.0) / 2)
        assert read(f"host_ms.tracker{c}") == pytest.approx((8.0 + 16.0 + 3.0) / 2)
        assert read(f"host_ms.staging{c}") == pytest.approx(7.5)
    for c in WAITS:
        assert read(f"host_waits{c}") == pytest.approx(6.0 + 1.0)


def test_traced_tiny_run_reports_the_host_spans(monkeypatch):
    """On the CPU the spans have host times and counts but no device
    times: host_ms and host_waits are reported, stage_gpu_ms left out."""
    _store(monkeypatch)
    out = run_tiny(monkeypatch, CELLS[""], trace=True)
    got = out["metrics"]
    assert {"host_ms.tracker", "host_ms.staging", "host_waits.job"} <= set(got)
    assert not any(k.startswith("stage_gpu_ms") for k in got)
    assert got["host_waits.job"]["value"] >= 1.0   # the tracker's flag read at least


def test_idle_gaps_name_the_open_span():
    """A gap inside the tracker's span reads job/chain/tracker/<op>; one in
    a batch's staging, outside any chain, job/staging/<op>."""
    def ann(name, ts, dur):
        return {"ph": "X", "cat": "user_annotation", "name": name, "ts": ts, "dur": dur}

    def op(name, ts, dur, cat="cpu_op"):
        return {"ph": "X", "cat": cat, "name": name, "ts": ts, "dur": dur}

    events = [ann("job", 0, 1000), ann("staging", 5, 190), op("aten::copy_", 8, 150),
              ann("chain", 200, 800), ann("tracker", 400, 300),
              op("cudaStreamSynchronize", 390, 300, "cuda_runtime"),
              op("k1", 0, 10, "kernel"), op("k2", 200, 200, "kernel"),
              op("k3", 700, 300, "kernel")]
    gaps = dict(trace.reduce(events)["idle_gaps"])
    assert set(gaps) == {"job/staging/aten::copy_", "job/chain/tracker/cudaStreamSynchronize"}
    assert gaps["job/chain/tracker/cudaStreamSynchronize"] == pytest.approx(300e-6)
