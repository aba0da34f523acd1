"""The port's stage spans (cpp_audio_tpu_torch.utils.profiling.span) in the
offline chain, on the CPU: off, they cost one check and record nothing;
under torch.profiler they nest as the chain runs, carry one id per job or
batch, count the step's waits for the device, and stay within the store's
cap; `timings=` reads the same spans."""

import json
import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpp_audio_tpu_torch.analysis import chain
from cpp_audio_tpu_torch.analysis import device_tracker as tdt
from cpp_audio_tpu_torch.analysis import resynth, vocoder
from cpp_audio_tpu_torch.core import events, voices
from cpp_audio_tpu_torch.models import sine_synth
from cpp_audio_tpu_torch.ops import envelopes
from cpp_audio_tpu_torch.utils import profiling
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
N = SR
STAGES = ["synth", "analysis", "vocoder", "tracker", "render"]


def _bank(seed: int):
    rng = np.random.default_rng(seed)
    notes = [events.Note(i, int(rng.uniform(0, N * 0.4)), int(rng.uniform(N * 0.6, N)),
                         float(rng.uniform(110, 1760)), float(rng.uniform(0.3, 1.0)),
                         float(rng.uniform(-1, 1))) for i in range(6)]
    cfg = sine_synth.SineSynthConfig(
        sample_rate=SR, block_size=1 << 13, dtype="float32",
        ahdsr=envelopes.AHDSR(attack=441, hold=100, decay=2000, release=8820, sustain=0.7))
    return sine_synth.bank_from_schedule(voices.schedule_from_notes(notes, pad_to=8), cfg)


ARGS = (resynth.ResynthConfig(sample_rate=SR, analysis_volume=1.0),
        vocoder.VocoderParams(sample_rate=SR),
        np.sign(np.sin(2 * np.pi * 110.0 * np.arange(N) / SR)))


def _single(**kw):
    return chain.run_offline_chain_device(_bank(1), N, *ARGS, block_size=1 << 13,
                                          device="cpu", **kw)


def _batch():
    step, _n = chain.prepare_offline_chain_device_batch(
        [_bank(2), _bank(3)], N, *ARGS, block_size=1 << 13, device="cpu")
    return step()


def _raise(*_a, **_k):
    raise AssertionError("called with no profiler recording")


def test_off_records_nothing(monkeypatch):
    """No profiler, no timings: no span kept, no range, no event, no
    synchronisation, no clock read."""
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(profiling._autograd_profiler, "record_function", _raise)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=_raise, perf_counter_ns=_raise))
    assert profiling.span("chain", "cpu") is profiling._OFF
    before = len(profiling.SPANS)
    _single()
    _batch()
    assert len(profiling.SPANS) == before


def _annotations(prof, tmp_path):
    path = tmp_path / "trace.json"
    prof.export_chrome_trace(str(path))
    evs = json.loads(path.read_text())["traceEvents"]
    names = {"chain", "staging", *STAGES}
    return sorted((e for e in evs if e.get("ph") == "X" and e.get("cat") == "user_annotation"
                   and e["name"] in names), key=lambda e: e["ts"])


def _inside(inner, outer):
    return outer["ts"] <= inner["ts"] and inner["ts"] + inner["dur"] <= outer["ts"] + outer["dur"]


def test_spans_nest_in_the_trace_and_the_store(tmp_path):
    first = len(profiling.SPANS)
    with profile(activities=[ProfilerActivity.CPU]) as prof:
        _single()
        _batch()
    ann = _annotations(prof, tmp_path)
    assert [e["name"] for e in ann] == ["chain", "staging", *STAGES,
                                        "staging", "chain", *STAGES]
    single, batch_staging, batch = ann[0], ann[7], ann[8]
    assert all(_inside(e, single) for e in ann[1:7])
    assert not _inside(batch_staging, batch) and batch_staging["ts"] < batch["ts"]
    assert all(_inside(e, batch) for e in ann[9:])
    stages = ann[9:]
    assert all(a["ts"] + a["dur"] <= b["ts"] for a, b in zip(stages, stages[1:]))

    recs = profiling.SPANS.records[first:]
    assert [(r.name, r.parent) for r in recs] == (
        [("staging", "chain")] + [(s, "chain") for s in STAGES] + [("chain", None)]
        + [("staging", None)] + [(s, "chain") for s in STAGES] + [("chain", None)])
    ids = [r.id for r in recs]
    assert len(set(ids[:7])) == 1 and len(set(ids[7:])) == 1 and ids[7] == ids[0] + 1
    assert all(r.device_ms is None and r.t1_ns >= r.t0_ns for r in recs)
    s = profiling.SPANS.summary(first)["spans"]
    assert set(s) == {"chain", "staging", *STAGES}
    assert all(v["jobs"] == 2 and v["count"] == 2 and v["device_ms"] is None
               for v in s.values())
    assert s["chain"]["host_ms"] >= sum(s[k]["host_ms"] for k in STAGES)


def test_host_waits_are_the_counters_by_hand():
    first = len(profiling.SPANS)
    with profile(activities=[ProfilerActivity.CPU]):
        step, _n = chain.prepare_offline_chain_device(
            _bank(4), N, *ARGS, block_size=1 << 13, device="cpu")
        waits = tdt.HOST_SYNCS + tdt.H2D_COPIES
        copies = tdt.H2D_COPIES
        loops = tdt.FRAME_LOOPS
        step()
        waits = tdt.HOST_SYNCS + tdt.H2D_COPIES - waits
        copies = tdt.H2D_COPIES - copies
        loops = tdt.FRAME_LOOPS - loops
    recs = {r.name: r for r in profiling.SPANS.records[first:]}
    assert set(recs) == {"staging", *STAGES}
    assert sum(recs[k].counts["host_waits"] for k in STAGES) == waits
    assert sum(recs[k].counts["frame_loops"] for k in STAGES) == loops
    # the vocoder's kernel matrix, one per band, and the tracker's flag read
    assert copies == recs["vocoder"].counts["host_waits"] == ARGS[1].count_bands
    assert recs["tracker"].counts["host_waits"] == 1
    assert recs["staging"].counts == {"host_waits": 0, "frame_loops": 0,
                                      "render_launches": 0, "live_waits": 0}
    # the CPU's render is the kernel's plain twin: no launch in any span;
    # the offline chain makes none of the live path's waits
    assert all(r.counts["render_launches"] == 0 for r in recs.values())
    assert all(r.counts["live_waits"] == 0 for r in recs.values())


def test_store_cap_counts_drops(monkeypatch):
    store = profiling.SpanStore(cap=2)
    monkeypatch.setattr(profiling, "SPANS", store)
    with profile(activities=[ProfilerActivity.CPU]):
        for _ in range(5):
            with profiling.span("x"):
                pass
    assert len(store) == 2 and store.dropped == 3
    assert store.summary()["dropped"] == 3 and store.summary()["spans"]["x"]["count"] == 2
    store.reset()
    assert len(store) == 0 and store.dropped == 0 and store.summary()["spans"] == {}


def test_summary_means_per_job():
    store = profiling.SpanStore()
    c = {"host_waits": 3, "frame_loops": 0}
    for id_, ms in ((1, 2.0), (1, 4.0), (2, 3.0)):
        store.add(profiling.SpanRecord("tracker", "chain", id_, 0, int(ms * 1e6), None, c))
    t = store.summary()["spans"]["tracker"]
    assert (t["count"], t["jobs"], t["parent"]) == (3, 2, "chain")
    assert t["host_ms"] == pytest.approx(4.5) and t["host_waits"] == 4.5
    assert t["device_ms"] is None


def test_timings_keep_their_keys_and_record_no_span():
    first = len(profiling.SPANS)
    timings = {}
    _single(timings=timings)
    assert list(timings) == STAGES and all(v > 0 for v in timings.values())
    assert len(profiling.SPANS) == first


def test_device_trace_writes_spans(tmp_path):
    with profiling.device_trace(str(tmp_path), device="cpu"):
        _single()
    assert (tmp_path / "trace.json").exists()
    spans = json.loads((tmp_path / "spans.json").read_text())
    assert set(spans["spans"]) == {"chain", "staging", *STAGES}
    assert spans["spans"]["chain"]["jobs"] == 1 and spans["dropped"] == 0
