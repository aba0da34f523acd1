"""The readers of the program's "outputs" span (the chain's delivery of its
outputs to the host): host_ms.outputs and stage_gpu_ms.outputs, one entry
per offline cell, each read by the existing readers of any span by name.
A program without the span (one that returns device outputs) reads
nothing."""

import pytest

from benchmark.harness import spec as spec_mod
from benchmark.tests.bench_tiny import run_tiny
from cpp_audio_tpu_torch.utils import profiling

SPEC = spec_mod.load_spec()
CELLS = {"": "resynth_64v.single_60s", ".serve": "resynth_64v.batch16_60s",
         ".clips": "resynth_64v.clips_2-8s", ".df": "resynth_64v_df.single_60s"}
NEW = {f"{metric}.outputs{c}": cell for c, cell in CELLS.items()
       for metric in ("host_ms", "stage_gpu_ms")}


def _store(monkeypatch) -> profiling.SpanStore:
    store = profiling.SpanStore()
    monkeypatch.setattr(profiling, "SPANS", store)
    return store


@pytest.mark.parametrize("name", sorted(NEW))
def test_entry_resolves(name):
    m = {e["name"]: e for e in SPEC["per_layer"]}[name]
    assert m["source"] == "program_span" and m["workloads"] == [NEW[name]]
    assert m["layer"] == "outputs to the host (analysis/chain)"
    assert m["moves"] in {e["name"] for e in spec_mod.cell_metrics(SPEC, NEW[name], False)}
    assert callable(spec_mod.reader(name))


@pytest.mark.parametrize("name", sorted(NEW))
def test_reader_reads_the_outputs_span(monkeypatch, name):
    store = _store(monkeypatch)
    assert spec_mod.reader(name)(None) is None
    for id_, host_ms, device_ms in ((1, 3.0, 2.0), (2, 5.0, 4.0)):
        rec = profiling.SpanRecord("outputs", "chain", id_, 0, int(host_ms * 1e6), None,
                                   {"pinned_outputs": 3})
        rec.device_ms = device_ms
        store.add(rec)
    want = 4.0 if name.startswith("host_ms") else 3.0
    assert spec_mod.reader(name)(None) == pytest.approx(want)


def test_traced_tiny_run_reports_the_outputs_host_time(monkeypatch):
    """On the CPU the span has a host time and no device time."""
    _store(monkeypatch)
    got = run_tiny(monkeypatch, CELLS[""], trace=True)["metrics"]
    assert got["host_ms.outputs"]["value"] >= 0.0
    assert "stage_gpu_ms.outputs" not in got
