"""The live path's duplex callback (LiveResynth.process) and its spans, on
the CPU: process() is feed() then pull() to the bit; under torch.profiler
each callback is one `duplex` span with one job id, the stage spans nest
under it, and the counter `live_waits` is the path's uploads and reads;
off the profiler nothing is recorded."""

import types

import numpy as np
import pytest
import torch
from torch.profiler import ProfilerActivity, profile

from cpp_audio_tpu_torch.analysis import resynth, streaming, vocoder
from cpp_audio_tpu_torch.core import events
from cpp_audio_tpu_torch.models import carrier, voicebank
from cpp_audio_tpu_torch.utils import profiling
import test_torch_cuda_kernels  # noqa: F401  (caps torch's threads)

SR = 44100
BLOCK = 512
LIVE = ("live_analysis", "live_tracker", "live_synth", "live_carrier", "live_vocoder")


def _signal(seconds: float = 0.6, seed: int = 5) -> np.ndarray:
    """A few seeded enveloped tones, the captured input."""
    rng = np.random.default_rng(seed)
    n = int(seconds * SR)
    t = np.arange(n)
    sig = np.zeros(n)
    for _ in range(4):
        f = rng.uniform(150.0, 1500.0)
        a, b = sorted(rng.integers(0, n, 2))
        sig[a:b] += rng.uniform(0.1, 0.4) * np.sin(2 * np.pi * f * t[a:b] / SR)
    return sig


def _live() -> streaming.LiveResynth:
    """A small live configuration with the vocoder leg on a held 110 Hz
    square carrier."""
    car = carrier.CarrierSynth(carrier.CarrierSynthConfig(
        sample_rate=SR, osc=carrier.CarrierOscMix(square=1.0)), device="cpu")
    car.on_event(events.Event(events.EventType.NOTE_ON, 0, 1, 110.0, 1.0))
    return streaming.LiveResynth(
        resynth.ResynthConfig(sample_rate=SR, window_size_seconds=0.05,
                              window_center_stride_seconds=0.025, analysis_volume=1.0),
        n_voices=16, vocoder_params=vocoder.VocoderParams(sample_rate=SR),
        carrier_synth=car, device="cpu")


def _blocks(sig):
    return [sig[i:i + BLOCK] for i in range(0, len(sig), BLOCK)]


def test_process_is_feed_then_pull_to_the_bit():
    sig = _signal()
    a, b = _live(), _live()
    for blk in _blocks(sig):
        got = a.process(blk)
        b.feed(blk)
        want = b.pull(len(blk))
        assert got.dtype == torch.float64 and got.shape == (len(blk), 2)
        assert torch.equal(got, want)
    assert a.stats == b.stats and a.stats.windows > 10 and a.stats.note_on >= 1
    assert float(got.abs().max()) > 0


def test_run_duplex_output_unchanged():
    """run_duplex through process() equals the loop of feed() and pull() it
    ran before, to the bit, with a short last block."""
    sig = _signal(0.5, seed=6)[:-100]
    got = _live().run_duplex(sig, block_size=BLOCK)
    b = _live()
    want = torch.cat([(b.feed(blk), b.pull(len(blk)))[1] for blk in _blocks(sig)])
    assert got.shape == (len(sig), 2) and torch.equal(got, want)


def _raise(*_a, **_k):
    raise AssertionError("called with no profiler recording")


def test_off_records_nothing(monkeypatch):
    """No profiler: no span kept, no range, no event, no synchronisation,
    no clock read; the counter still counts."""
    live = _live()
    monkeypatch.setattr(torch.cuda, "Event", _raise)
    monkeypatch.setattr(torch.cuda, "synchronize", _raise)
    monkeypatch.setattr(profiling._autograd_profiler, "record_function", _raise)
    monkeypatch.setattr(profiling, "time", types.SimpleNamespace(
        perf_counter=_raise, perf_counter_ns=_raise))
    assert profiling.span("duplex", "cpu") is profiling._OFF
    before, waits = len(profiling.SPANS), profiling.LIVE_WAITS
    for blk in _blocks(_signal(0.3)):
        live.process(blk)
    assert len(profiling.SPANS) == before
    assert profiling.LIVE_WAITS > waits


def _profiled_run():
    """Every callback of a stream under the profiler, with what each did
    counted by hand: windows completed, bank tables and carrier tables
    uploaded."""
    live = _live()
    tables = {"bank": 0, "carrier": 0}
    prepare, block = voicebank.prepare_bank_arrays, carrier._carrier_block

    def counting_prepare(*a, **k):
        args, statics = prepare(*a, **k)
        tables["bank"] += len(args)
        return args, statics

    def counting_block(fp, ip, vols, pl, *a, **k):
        tables["carrier"] += 4  # fp, ip, vols, pl: made on the host
        return block(fp, ip, vols, pl, *a, **k)

    mp = pytest.MonkeyPatch()
    mp.setattr(voicebank, "prepare_bank_arrays", counting_prepare)
    mp.setattr(carrier, "_carrier_block", counting_block)
    first = len(profiling.SPANS)
    by_hand = []
    try:
        with profile(activities=[ProfilerActivity.CPU]):
            for blk in _blocks(_signal()):
                w0, t0 = live.stats.windows, dict(tables)
                live.process(blk)
                windows = live.stats.windows - w0
                by_hand.append(dict(
                    windows=windows,
                    waits=(2 * windows + 1 + tables["bank"] - t0["bank"]
                           + tables["carrier"] - t0["carrier"])))
    finally:
        mp.undo()
    return live, profiling.SPANS.records[first:], by_hand


def test_one_id_per_callback_and_spans_nest_under_duplex():
    live, recs, by_hand = _profiled_run()
    duplex = [r for r in recs if r.name == "duplex"]
    assert len(duplex) == len(by_hand)
    ids = [r.id for r in duplex]
    assert ids == list(range(ids[0], ids[0] + len(ids)))
    assert all(r.parent is None for r in duplex)
    inner = [r for r in recs if r.name != "duplex"]
    assert {r.name for r in inner} == set(LIVE)
    assert all(r.parent == "duplex" and r.id in ids for r in inner)
    for d, hand in zip(duplex, by_hand):
        mine = [r for r in inner if r.id == d.id]
        assert all(d.t0_ns <= r.t0_ns <= r.t1_ns <= d.t1_ns for r in mine)
        names = sorted(r.name for r in mine)
        # a window completes before the pull: analysis and tracker only then
        want = ["live_carrier", "live_synth", "live_vocoder"]
        if hand["windows"]:
            want = ["live_analysis", "live_tracker"] + want
        assert names == sorted(want)
    windows = sum(h["windows"] for h in by_hand)
    assert windows == live.stats.windows > 10
    s = profiling.SpanStore()
    s.records = recs
    summary = s.summary()["spans"]
    assert summary["duplex"]["jobs"] == len(duplex)
    assert summary["live_analysis"]["jobs"] == summary["live_tracker"]["jobs"] == windows
    assert all(v["device_ms"] is None for v in summary.values())


def test_live_waits_are_the_uploads_and_reads_by_hand():
    _live_, recs, by_hand = _profiled_run()
    duplex = [r for r in recs if r.name == "duplex"]
    assert [r.counts["live_waits"] for r in duplex] == [h["waits"] for h in by_hand]
    # the stage spans share them out: the window up and the peaks down in
    # the analysis, the tables in the synth and the carrier, the modulator
    # block in the vocoder, none in the tracker
    per = {}
    for r in recs:
        if r.name != "duplex":
            per[r.name] = per.get(r.name, 0) + r.counts["live_waits"]
    assert per["live_tracker"] == 0
    assert per["live_analysis"] == 2 * sum(h["windows"] for h in by_hand)
    assert per["live_vocoder"] == len(duplex)
    assert sum(per.values()) == sum(h["waits"] for h in by_hand)
    assert per["live_carrier"] == 4 * len(duplex) and per["live_synth"] > 0
    assert all(r.counts["host_waits"] == 0 for r in recs)
