"""The live duplex path, in an open loop at the sound card's clock.

The program is cpp_audio_tpu_torch.analysis.streaming.LiveResynth, fed one
fixed take of captured audio (the traffic mix's: `voices` voices of the
offline mixes' generator, take 0 of `take_seed`, its float64 mono mixdown)
from the host, one callback of `block` samples at a time: process(block),
then the copy of its (block, 2) output to a host array.

Set-up builds the take, runs a separate LiveResynth through `warm_seconds`
of callbacks (at least two analysis windows), builds a fresh one for the
window and settles. In the window callback i is due at t0 + i * block /
sample_rate on perf_counter; the driver spin-waits for it (no sleep) and
runs a late callback as soon as the one before it is done, so nothing is
skipped and lateness carries on. The interpreter's collector is off in the
window (a live audio thread runs none). A job is one callback: (due, done,
block / sample_rate); the window closes at the first completion at or
after --seconds. With --trace 1, the `profile_callbacks` callbacks at the
window's middle run under the profiler, each in a "job" range; the trace
is read after the window.

For the check the driver keeps, by reference and with no device work, every
window's peaks as they enter the tracker, every synth event, and for each
callback its host output, its vocoded leg and the carrier blocks of it and
the three before; the sampled callbacks' are held against
reference/live.py, the synth leg as the output less the vocoded leg.
"""

from __future__ import annotations

import gc
import math
import os
import sys
import tempfile
import time
from collections import deque

import numpy as np

from benchmark.harness import trace
from benchmark.harness.program import program_configs
from benchmark.harness.runner import settle, sync
from benchmark.harness.traffic import voices
from benchmark.reference import live as ref_live
from benchmark.reference import synth as ref_synth
from benchmark.reference.precision import Precision

KINDS = {"NOTE_ON": "on", "NOTE_OFF": "off", "NOTE_CHANGE": "change"}


def reference_config(config: dict, data: dict) -> dict:
    """The plain reference's view of a configuration and a traffic mix."""
    tr, vc = config["tracker"], config["vocoder"]
    return dict(
        window=config["window"], stride=config["stride"], sample_rate=config["sample_rate"],
        block=int(data["block"]), peaks_per_frame=config["peaks_per_frame"],
        n_voices=config["n_voices"], max_flips=int(config["limits"]["knife_edges"]),
        tracker=dict(nearby_distance_tones=tr["nearby_distance_tones"],
                     min_volume=tr["min_volume"], max_track_pitches=tr["max_track_pitches"],
                     analysis_volume=tr["analysis_volume"], max_voices=config["max_voices"],
                     stereo_spread=tr["stereo_spread"], pan_seed=tr["pan_seed"]),
        synth=config["synth"], carrier=config["carrier"],
        vocoder=dict(stride=vc["stride"], window=vc["window"],
                     edges=np.exp(np.linspace(np.log(vc["min_hz"]), np.log(vc["max_hz"]),
                                              vc["bands"] + 1)).tolist(),
                     vol_voc=vc["vol_voc"], vol_mod=vc["vol_mod"], vol_car=vc["vol_car"]))


def take(config: dict, data: dict, device: str) -> np.ndarray:
    """The captured input: the fixed take's mono mixdown, host float64."""
    sr = config["sample_rate"]
    n = int(round(float(data["take_seconds"]) * sr))
    v = voices(np.random.default_rng([int(data["take_seed"]), 0, 0]), n, sr,
               int(data["voices"]), config["take"])
    return ref_synth.render(v, n, Precision("float64"), device).sum(dim=1).cpu().numpy()


def make_live(config: dict, device: str):
    """The program: LiveResynth at the configuration's settings, its vocoder
    leg on a CarrierSynth holding the carrier note from sample 0."""
    from cpp_audio_tpu_torch.analysis import streaming
    from cpp_audio_tpu_torch.core import events
    from cpp_audio_tpu_torch.models import carrier

    c = config["carrier"]
    rconfig, vparams = program_configs(config)
    car = carrier.CarrierSynth(carrier.CarrierSynthConfig(
        sample_rate=config["sample_rate"], osc=carrier.CarrierOscMix(**{c["shape"]: 1.0}),
        seed=c["seed"]), device=device)
    car.on_event(events.Event(events.EventType.NOTE_ON, 0, 1, c["hz"], c["velocity"]))
    return streaming.LiveResynth(rconfig, n_voices=config["n_voices"], vocoder_params=vparams,
                                 carrier_synth=car, device=device)


class State:
    def __init__(self, config: dict, data: dict, device: str):
        self.config, self.data, self.device = config, data, device
        self.block = int(data["block"])
        self.sr = int(config["sample_rate"])
        self.longest = self.block / self.sr
        self.take = take(config, data, device)
        self.live = None
        self.kept = None
        self.n_fed = 0
        self.dropped = (0, 0)  # the window's note-ons dropped by the tracker, the synth

    def input_block(self, i: int) -> np.ndarray:
        """Callback i's captured block (the take repeats past its end)."""
        a = (i * self.block) % len(self.take)
        blk = self.take[a:a + self.block]
        return blk if len(blk) == self.block else np.resize(self.take, a + self.block)[a:]


def _keep(live) -> dict:
    """Keep what the check reads, by reference: the peaks entering the
    tracker, the synth's events, the latest vocoded leg and the latest four
    carrier blocks."""
    kept = {"peaks": [], "events": [], "vocoded": None, "carrier": deque(maxlen=4)}
    step, on_event = live.tracker.step, live.synth.on_event
    process, compute = live.vocoder.process, live.carrier_synth.compute

    def tracker_step(peaks):
        kept["peaks"].append(peaks)
        return step(peaks)

    def synth_event(ev):
        kept["events"].append(ev)
        return on_event(ev)

    def vocode(mod, car):
        kept["vocoded"] = out = process(mod, car)
        return out

    def carrier_block(t0, n):
        out = compute(t0, n)
        kept["carrier"].append((t0, out))
        return out

    live.tracker.step, live.synth.on_event = tracker_step, synth_event
    live.vocoder.process, live.carrier_synth.compute = vocode, carrier_block
    return kept


def setup(config: dict, data: dict, seed: int, device: str) -> State:
    """The take, a warm-up LiveResynth through `warm_seconds` of callbacks
    (two analysis windows at least), and a fresh one for the window."""
    state = State(config, data, device)
    blk = state.block
    warm = max(float(data["warm_seconds"]) * state.sr, config["window"] + config["stride"])
    live = make_live(config, device)
    for i in range(int(math.ceil(warm / blk))):
        live.process(state.input_block(i)).cpu()
    del live
    state.live = make_live(config, device)
    state.kept = _keep(state.live)
    settle(device)
    return state


def _stop(prof, holder: dict, device: str) -> None:
    sync(device)
    prof.__exit__(None, None, None)
    holder["prof"] = prof


def _events(holder: dict) -> list:
    """The profiled stretch's trace events (the chrome trace's list)."""
    import json

    fd, path = tempfile.mkstemp(suffix=".json")
    os.close(fd)
    try:
        holder["prof"].export_chrome_trace(path)
        with open(path) as f:
            return json.load(f)["traceEvents"]
    finally:
        os.remove(path)


def window(state: State, seconds: float, trace_on: bool, run, sample) -> None:
    """The open loop; with trace_on, `profile_callbacks` callbacks at the
    window's middle under the profiler, each a "job" range."""
    from torch.profiler import ProfilerActivity, profile, record_function

    live, kept, device, blk = state.live, state.kept, state.device, state.block
    period = blk / state.sr
    n_prof = int(state.data["profile_callbacks"]) if trace_on else 0
    p0 = max(0, int(seconds / period / 2) - n_prof // 2)
    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if device == "cuda" else [])
    holder, prof = {}, None
    i = 0
    gc.disable()
    try:
        t0 = time.perf_counter()
        while True:
            due = t0 + i * period
            while time.perf_counter() < due:
                pass
            x = state.input_block(i)
            if n_prof and i == p0:
                prof = profile(activities=acts)
                prof.__enter__()
            if prof is not None:
                with record_function("job"):
                    out = live.process(x).cpu().numpy()
            else:
                out = live.process(x).cpu().numpy()
            done = time.perf_counter()
            if prof is not None and i == p0 + n_prof - 1:
                _stop(prof, holder, device)
                prof = None
            run.jobs.append((due, done, period))
            sample.offer((i, dict(out=out, vocoded=kept["vocoded"],
                                  carrier=list(kept["carrier"]))), period)
            i += 1
            if done - t0 >= seconds and i >= p0 + n_prof:
                break
    finally:
        gc.enable()
    run.window_s = done - t0
    state.n_fed = i * blk
    state.dropped = (live.stats.dropped_note_on, live.synth.dropped_note_on)
    if trace_on:
        run.trace = trace.reduce(_events(holder))


def _host(x) -> np.ndarray:
    return x.double().cpu().numpy() if hasattr(x, "cpu") else np.asarray(x, np.float64)


def _event(ev) -> tuple:
    """A synth event as reference/live.replay writes it: (time, kind,
    frequency, velocity, pan), the values a kind does not carry 0."""
    kind = KINDS[ev.type.name]
    if kind == "off":
        return (ev.time, kind, 0.0, 0.0, 0.0)
    return (ev.time, kind, float(ev.frequency), float(ev.velocity),
            float(ev.pan) if kind == "on" else 0.0)


def judged(state: State, items: list) -> dict:
    """The program's outputs as reference/live.compare reads them."""
    kept = state.kept
    cbs = []
    for i, got in sorted(items, key=lambda it: it[0]):
        voc = _host(got["vocoded"])
        cbs.append(dict(index=i, synth=got["out"] - voc[:, None], vocoded=voc,
                        carrier=[(t0, _host(c)) for t0, c in got["carrier"]]))
    return dict(n_fed=state.n_fed, peaks=kept["peaks"], dropped=state.dropped,
                events=[_event(ev) for ev in kept["events"]],
                callbacks=cbs)


def fed(state: State) -> np.ndarray:
    """Every sample the program was fed, in order."""
    n = state.n_fed
    return np.resize(state.take, n) if n > len(state.take) else state.take[:n]


def check_numbers(stream: dict, per: list, limits: dict) -> tuple[dict, int]:
    """The worst of each number, and how many sampled callbacks broke a
    limit (all of them where a whole-stream number did)."""
    worst = dict.fromkeys(limits, 0.0)

    def bad(nums):
        out = False
        for k, v in nums.items():
            if k in limits:
                v = float(v) if math.isfinite(v) else math.inf
                worst[k] = max(worst[k], v)
                out |= not v <= limits[k]
        return out

    stream_bad = bad(stream)
    per_bad = [bad(p) for p in per]
    return worst, max(1, len(per)) if stream_bad else sum(per_bad)


def check(state: State, items: list, device: str) -> tuple[dict, int]:
    """The sampled callbacks and the whole stream against reference/live.py;
    the program is dropped first."""
    got = judged(state, items)
    state.live = state.kept = None
    if device == "cuda":
        import torch
        torch.cuda.empty_cache()
    rc = reference_config(state.config, state.data)
    stream, per, info = ref_live.compare(fed(state), got, rc, device)
    print(f"checked the stream: {stream} {info}", file=sys.stderr)
    for p in per:
        print(f"checked callback {p['index']}: {p}", file=sys.stderr)
    return check_numbers(stream, per, state.config["limits"])
