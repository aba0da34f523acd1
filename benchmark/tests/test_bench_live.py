"""The live duplex cell on the CPU at a small size (16 voices, a 3 s take):
the program against the plain live reference (reference/live.py), the
control, the faults that `correct` must catch, the traced run's metrics,
and a program without the duplex callback failing at set-up."""

import math
import time

import numpy as np
import pytest

from benchmark.harness import runner, spec as spec_mod
from benchmark.reference import live as ref_live
from benchmark.reference.precision import Precision
from benchmark.tests import bench_tiny
from cpp_audio_tpu_torch.utils import profiling

CELL = "live_resynth_127v.duplex_512"
SPEC = spec_mod.load_spec()
CONFIG = spec_mod.config(SPEC, spec_mod.cell(SPEC, CELL)["config"])
LIMITS = CONFIG["limits"]
DRIVER = spec_mod.driver(CONFIG)
SEED = 2**31 + 5
PER_LAYER = ("stage_gpu_ms.live_analysis.live", "stage_gpu_ms.live_synth.live",
             "stage_gpu_ms.live_carrier.live", "stage_gpu_ms.live_vocoder.live",
             "host_ms.duplex.live", "host_ms.live_tracker.live", "host_ms.live_synth.live",
             "live_waits.live", "device_idle_pct.live")


def _data(**kw) -> dict:
    return dict(bench_tiny.tiny_traffic("duplex_512"), **kw)


def _every_callback(monkeypatch):
    """The tiny mix with every callback of the window sampled."""
    monkeypatch.setattr(spec_mod, "traffic", lambda *_: _data(check_jobs=10**6))


@pytest.fixture(scope="module")
def stream():
    """One window of 1 s through the program on the CPU, every callback
    sampled: (state, the judged outputs, the whole-stream and per-callback
    numbers)."""
    data = _data(check_jobs=10**6)
    state = DRIVER.setup(CONFIG, data, SEED, "cpu")
    run = runner.Run()
    sample = runner.Sample(SEED, int(data["check_jobs"]), state.longest)
    DRIVER.window(state, 1.0, False, run, sample)
    stats = state.live.stats
    got = DRIVER.judged(state, sample.items())
    rc = DRIVER.reference_config(CONFIG, data)
    nums = ref_live.compare(DRIVER.fed(state), got, rc, "cpu")
    return state, stats, got, rc, nums


def test_program_matches_the_reference(stream):
    state, stats, got, _rc, (whole, per, info) = stream
    assert stats.windows >= 2 and stats.note_on >= 1 and info["windows"] == stats.windows
    assert len(per) == len(got["callbacks"]) == state.n_fed // state.block
    # not vacuous: sampled callbacks with both legs sounding
    assert sum(np.abs(c["synth"]).max() > 1e-3 for c in got["callbacks"]) >= 3
    assert sum(np.abs(c["vocoded"]).max() > 1e-3 for c in got["callbacks"]) >= 3
    worst, failed = DRIVER.check_numbers(whole, per, LIMITS)
    assert failed == 0 and set(worst) == set(LIMITS), worst
    assert worst["knife_edges"] == 0.0 and worst["dropped_gap"] == 0.0


def test_reference_against_itself_reads_zero(stream):
    state, _stats, got, rc, _nums = stream
    fed = DRIVER.fed(state)
    own = ref_live.outputs(fed, state.n_fed, [c["index"] for c in got["callbacks"][-6:]], rc,
                           Precision("float64"), "cpu")
    whole, per, _info = ref_live.compare(fed, own, rc, "cpu")
    assert whole == {"peak_db_gap": 0.0, "dropped_gap": 0.0, "knife_edges": 0.0}
    assert all(p["resynth_gap"] == 0.0 and p["vocoded_gap"] == 0.0 for p in per)


def test_control_breaks_a_limit(stream):
    state, _stats, got, rc, _nums = stream
    fed = DRIVER.fed(state)
    ctl = ref_live.outputs(fed, state.n_fed, [c["index"] for c in got["callbacks"]], rc,
                           Precision("lower"), "cpu")
    whole, per, _info = ref_live.compare(fed, ctl, rc, "cpu")
    _worst, failed = DRIVER.check_numbers(whole, per, LIMITS)
    assert failed >= 1
    assert max(p["resynth_gap"] for p in per) > LIMITS["resynth_gap"]
    assert max(p["vocoded_gap"] for p in per) > LIMITS["vocoded_gap"]


def _peaks_offset(monkeypatch):
    from cpp_audio_tpu_torch.ops import stft

    real = stft.extract_top_peaks
    monkeypatch.setattr(stft, "extract_top_peaks",
                        lambda *a, **k: (lambda fm: (fm[0], fm[1] + 0.2))(real(*a, **k)))


def _in_the_window(synth, synths: list) -> bool:
    """Whether `synth` is the window's: set-up's warm-up builds the first
    (`synths`: those seen so far)."""
    if synth not in synths:
        synths.append(synth)
    return synths.index(synth) >= 1


def _note_on_dropped(monkeypatch):
    """The window's synth takes its first note-on as played, and plays nothing."""
    from cpp_audio_tpu_torch.core import events
    from cpp_audio_tpu_torch.models import streaming_synth

    real = streaming_synth.StreamingSynth.on_event
    seen, seen_by = [], []

    def on_event(self, ev):
        if ev.type is events.EventType.NOTE_ON and not seen and _in_the_window(self, seen_by):
            seen.append(ev)
            return True
        return real(self, ev)
    monkeypatch.setattr(streaming_synth.StreamingSynth, "on_event", on_event)


def _vocoded_scaled(monkeypatch):
    from cpp_audio_tpu_torch.analysis import streaming

    real = streaming.StreamingVocoder.process
    monkeypatch.setattr(streaming.StreamingVocoder, "process",
                        lambda self, m, c: real(self, m, c) * 1.001)


def _synth_halved_once(monkeypatch):
    """One callback's synth leg at half level: the window's first with a voice."""
    from cpp_audio_tpu_torch.models import streaming_synth

    real = streaming_synth.StreamingSynth.compute
    done, seen_by = [], []

    def compute(self, t0, n):
        out = real(self, t0, n)
        if not done and float(out.abs().max()) > 0 and _in_the_window(self, seen_by):
            done.append(t0)
            return out * 0.5
        return out
    monkeypatch.setattr(streaming_synth.StreamingSynth, "compute", compute)


@pytest.mark.parametrize("fault,number", [
    (_peaks_offset, "peak_db_gap"), (_note_on_dropped, "resynth_gap"),
    (_vocoded_scaled, "vocoded_gap"), (_synth_halved_once, "resynth_gap")],
    ids=["peaks offset", "a note-on dropped", "vocoded leg scaled", "synth leg halved once"])
def test_fault_is_not_correct(monkeypatch, fault, number):
    """A whole run with the live path broken underneath, every callback
    checked: `correct` comes out false, on the number that reads the fault."""
    _every_callback(monkeypatch)
    fault(monkeypatch)
    out = runner.run_cell(SPEC, CELL, SEED, 1.0, False, "cpu", time.perf_counter())
    assert out["correct"] is False and out["failed"] >= 1
    assert out["checks"][number]["value"] > LIMITS[number]


def test_traced_run_reports_the_live_metrics(monkeypatch):
    out = bench_tiny.run_tiny(monkeypatch, CELL, trace=True)
    assert out["correct"] is True
    names = {m["name"] for m in spec_mod.cell_metrics(SPEC, CELL, True)}
    assert names == set(PER_LAYER)
    # on the CPU the spans have no device time and the trace no device op
    assert set(out["metrics"]) == {"host_ms.duplex.live", "host_ms.live_tracker.live",
                                   "host_ms.live_synth.live", "live_waits.live"}
    m = {k: v["value"] for k, v in out["metrics"].items()}
    assert m["host_ms.duplex.live"] > m["host_ms.live_synth.live"] > 0
    # a callback's waits: the modulator block, the carrier's 4 tables, the
    # bank's 5 when a voice sounds, 2 a window
    assert 5 <= m["live_waits.live"] <= 12


def test_live_waits_reader(monkeypatch):
    store = profiling.SpanStore()
    monkeypatch.setattr(profiling, "SPANS", store)
    read = spec_mod.reader("live_waits.live")
    assert read(None) is None
    for id_, waits in ((1, 10), (2, 12)):
        store.add(profiling.SpanRecord("duplex", None, id_, 0, 1_000_000, None,
                                       {"live_waits": waits}))
    assert read(None) == 11.0
    store.reset()
    # a program without the counter: the metric is left out
    store.add(profiling.SpanRecord("duplex", None, 1, 0, 1_000_000, None, {}))
    assert read(None) is None


def test_entries():
    metrics = {m["name"]: m for m in SPEC["per_layer"]}
    for name in PER_LAYER:
        m = metrics[name]
        assert m["workloads"] == [CELL] and m["moves"] == "job_ms_p95"
        assert callable(spec_mod.reader(name))
    e2e = {m["name"] for m in spec_mod.cell_metrics(SPEC, CELL, False)}
    assert e2e == {"job_ms_p95", "setup_s"}
    assert spec_mod.cell(SPEC, CELL)["chips"] == 1
    assert next(c for c in SPEC["configs"] if c["name"] == CONFIG["name"])["reduced"] == []


def test_program_without_the_duplex_callback_fails_at_setup(monkeypatch):
    """The parent commit's LiveResynth has no process(): a run stops at
    set-up, before any window."""
    from cpp_audio_tpu_torch.analysis import streaming

    monkeypatch.delattr(streaming.LiveResynth, "process")
    monkeypatch.setattr(spec_mod, "traffic", bench_tiny.tiny_traffic)
    with pytest.raises(AttributeError):
        runner.run_cell(SPEC, CELL, SEED, 1.0, False, "cpu", time.perf_counter())


def test_carrier_knife_edges_follow_the_side():
    """Where a sign flip lies within float32's reach of a sample the
    reference takes the side's sample; elsewhere its own."""
    rc = DRIVER.reference_config(CONFIG, _data())
    t0, n = 2_000_000, 4096
    own = ref_live.carrier(rc, t0, n, Precision("float64"))
    side = -own
    got, taken = ref_live.followed_carrier(rc, t0, n, [(t0, side)])
    assert 0 < taken < n // 50
    assert np.count_nonzero(got != own) == taken and math.isclose(np.abs(own).max(), 1.0)
