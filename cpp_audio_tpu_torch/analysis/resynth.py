"""Offline analysis -> resynthesis pipeline (BASELINE config 4).

Mirrors RtResynth's analysis flow (source/rt.resynth.lib.cpp:1624-1759) in
offline form: the input is framed into sliding Gaussian windows (window
0.1814 s, stride 0.09 s defaults, rt.resynth.lib.cpp:945-946), every window's
sqmag spectrum and peaks are computed batched on the device (ops/stft.py),
then the host pitch pipeline (analysis/pitch.py, or the repo's C++ library,
native/pitchpipe.cpp) tracks notes across frames and the tracked notes render
through the control-rate voice bank (models/resynth_bank.py).

Event timing matches the reference: analysis result r is available when the
window ending at sample W + r*stride is full, and its NoteOn/Change/Off apply
from that sample on (PeriodicFFT::feed/onFullBuffer,
rt.resynth.lib.periodicfft.cpp:55-180).

Port of cpp_audio_tpu/analysis/resynth.py. The host trackers draw their
pans and phases from numpy RNGs, and the device tracker
(analysis/device_tracker.py) reads the same draws from pools
(`draw_pools`), so every tracker of both packages draws the same values.
`resynthesize` routes as the JAX package does (implementation="auto" by
default: the device tracker, or the native one for reference-semantics
harmonize configs). `resynthesize_feedback` keeps its summed stream, fed-back
mono mix and in-loop limiter on the device.
"""

from __future__ import annotations

from dataclasses import dataclass, field

import numpy as np
import torch

from ..models import resynth_bank
from ..ops import envelopes, stft
from ..utils import wav as wavio
from ..utils.interp import Itp
from ..utils.midi import Midi
from . import autotune as at
from . import pitch as pp

# reference reduceUnadjustedVolumes (include/audioelement.h:1270); analysis
# volumes are divided by it when playing notes (rt.resynth.lib.cpp:322-324)
REDUCE_UNADJUSTED_VOLUMES = 0.1


@dataclass
class ResynthConfig:
    sample_rate: int = 44100
    window_size_seconds: float = 0.1814
    window_center_stride_seconds: float = 0.09
    min_volume: float = 0.0001
    nearby_distance_tones: float = 0.4
    max_track_pitches: float = 1.0
    pitch_shift_pre_autotune: float = 0.0
    pitch_shift_post_autotune: float = 0.0
    pitch_harmonize_pre_autotune: float = 0.0
    pitch_harmonize_post_autotune: float = 0.0
    stereo_spread: float = 1.0
    analysis_volume: float = 1.0
    pitch_method: pp.PitchReductionMethod = pp.PitchReductionMethod.PONDERATE_BY_VOLUME
    volume_method: pp.VolumeReductionMethod = pp.VolumeReductionMethod.SUM_VOLUMES
    # autotune
    use_autotune: bool = False
    # "reference" replicates the reference's probe-miss duplicates;
    # "merged" is the intent semantics the device tracker computes
    # (pitch.harmonize_pitches docstring)
    harmonize_semantics: str = "reference"
    autotune_max_pitch: float = 150.0
    autotune_tolerance_pitches: float = 100.0
    autotune_kwargs: dict = field(default_factory=dict)
    # envelope (defaults rt.resynth.lib.cpp:957-961)
    env_attack_seconds: float = 0.0
    env_hold_seconds: float = 0.0
    env_decay_seconds: float = 0.0
    env_release_seconds: float = 0.0
    env_sustain_level: float = 1.0
    max_voices: int = 127
    dtype: str = "float32"
    seed: int = 0
    # Draw-index policy for pan/phase pools. "sequential" consumes draws in
    # the reference's RNG order (pan per accepted NoteOn, phase per packed
    # slot) — bit-faithful, but ONE flipped note decision shifts every
    # later note's draws and decorrelates the remaining render (measured
    # ~0 dB f32-TPU vs f64-host on dense workloads). "stable" keys both
    # pools by (frame * max_voices + accepted-on rank): a flipped decision
    # perturbs only its own note. Supported by the python host tracker and
    # the device tracker (native C++ is sequential-only).
    draw_indexing: str = "sequential"
    # Oracle replay: injected raw draw streams. pan_draw_values are U(-1,1)
    # pan draws (the reference's mersenne<SEEDED::No> stream consumed by
    # ResynthElementInitializer, rt.resynth.lib.cpp:116); phase_draw_values
    # are U(-1,1) start angles in rad/pi (mersenne<SEEDED::Yes>,
    # gen.crtp.h:152 — stored mod 2). None = numpy RNG from `seed`.
    pan_draw_values: object = None
    phase_draw_values: object = None

    @property
    def window_size(self) -> int:
        # even window size (getEvenWindowSizeFrames)
        w = int(0.5 + self.window_size_seconds * self.sample_rate)
        return w + (w % 2)

    @property
    def stride(self) -> int:
        return max(1, int(0.5 + self.window_center_stride_seconds * self.sample_rate))


@dataclass
class AnalysisFrameResult:
    """What the analysis produced at one stride (for observability/UI)."""

    frame_idx: int
    pitches: list
    note_on: int = 0
    note_change: int = 0
    note_off: int = 0
    dropped: int = 0


def analyze_arrays(signal, config: ResynthConfig, *, device="cuda"):
    """signal (mono) -> ((n_frames, k) freq, (n_frames, k) mag_db) tensors on
    `device`, frequency-sorted per frame, invalid entries marked by -inf mag.

    Peaks are extracted on the device (local maxima + QIFFT + top-k by
    magnitude, k = max_voices + 1) so only (frames, k) values cross to the
    host tracker.
    """
    dt = torch.float32 if config.dtype == "float32" else torch.float64
    sig = torch.as_tensor(signal, dtype=dt, device=torch.device(device))
    window = torch.as_tensor(stft.gaussian_window(config.window_size, sigmas=4.0),
                             dtype=dt, device=sig.device)
    fft_len = stft.fft_length_for(config.window_size)
    sq = stft._stft_sqmag(sig, window, window_size=config.window_size,
                          stride=config.stride, fft_length=fft_len)
    return stft._top_peaks(sq, sample_rate=config.sample_rate,
                           fft_length=fft_len, k=config.max_voices + 1)


def analyze(signal, config: ResynthConfig, *, device="cuda"):
    """signal (mono) -> per-frame [(freq, mag_db)] peak lists."""
    freq, mag = analyze_arrays(signal, config, device=device)
    return stft.top_peaks_to_lists(freq.cpu().numpy(), mag.cpu().numpy())


def _make_native_pipe(config: ResynthConfig):
    """Build a NativePitchPipe configured like the Python PitchTracker."""
    from .. import native as nat
    from ..utils import loudness

    li = loudness.phons_to_index(60.0)
    tables = at.autotune_tables(use_autotune=config.use_autotune,
                                **config.autotune_kwargs)
    pipe = nat.NativePitchPipe(
        nearby_distance_tones=config.nearby_distance_tones,
        min_volume=config.min_volume,
        max_track_pitches=config.max_track_pitches,
        shift_pre=config.pitch_shift_pre_autotune,
        shift_post=config.pitch_shift_post_autotune,
        harmonize_pre=config.pitch_harmonize_pre_autotune,
        harmonize_post=config.pitch_harmonize_post_autotune,
        autotune_max_pitch=config.autotune_max_pitch,
        autotune_tolerance=config.autotune_tolerance_pitches,
        pitch_method={pp.PitchReductionMethod.INTERVAL_CENTER: 0,
                      pp.PitchReductionMethod.MAX_VOLUME: 1,
                      pp.PitchReductionMethod.PONDERATE_BY_VOLUME: 2}[config.pitch_method],
        volume_method={pp.VolumeReductionMethod.MAX_VOLUME: 0,
                       pp.VolumeReductionMethod.SUM_VOLUMES: 1}[config.volume_method],
        max_voices=config.max_voices,
        analysis_volume=config.analysis_volume,
        loud_pitches=loudness.PITCHES, loud_spl=loudness.ELVS[li],
        allowed_pitches=tables.get("allowed"),
    )
    if tables["kind"] == "scale":
        pipe.set_scale(tables["root_pitch"], tables["scale"], tables["equidistant"])
    return pipe


class _PanDraws:
    """Per-note-on raw U(-1,1) pan draw source: injected
    config.pan_draw_values when present (falling back to the numpy RNG once
    exhausted), else the numpy RNG seeded by config.seed. Picklable (the
    checkpoint path snapshots the PitchTracker holding one)."""

    def __init__(self, config: ResynthConfig):
        self._rng = np.random.default_rng(config.seed)
        self._vals = (None if config.pan_draw_values is None
                      else np.asarray(config.pan_draw_values, np.float64))
        self._i = 0

    def __call__(self) -> float:
        i = self._i
        self._i = i + 1
        if self._vals is not None and i < len(self._vals):
            return float(self._vals[i])
        return float(self._rng.uniform(-1.0, 1.0))


def _pan_draw_fn(config: ResynthConfig):
    return _PanDraws(config)


class _LazyPool:
    """Indexed access into the numpy-RNG draw pool (grown lazily): pool[i]
    equals `default_rng(seed).uniform(lo, hi, cap)[i]` for any cap > i —
    the same arrays draw_pools() builds. Picklable (checkpoint snapshots)."""

    def __init__(self, seed: int, lo: float, hi: float):
        self._rng = np.random.default_rng(seed)
        self._lo, self._hi = lo, hi
        self._vals = np.zeros(0)

    def take(self, i: int) -> float:
        if i >= len(self._vals):
            grow = max(i + 1 - len(self._vals), 4096)
            self._vals = np.concatenate(
                [self._vals, self._rng.uniform(self._lo, self._hi, grow)])
        return float(self._vals[i])


def draw_pools(config: ResynthConfig, cap: int):
    """(pan, phase) draw pools of length `cap` for the batched tracker paths.

    Defaults reproduce the host tracker's numpy RNG; injected
    config.pan_draw_values / phase_draw_values (oracle replay) override the
    pool prefix — pan raw U(-1,1), phase mod 2 (rad/pi)."""
    pan = np.random.default_rng(config.seed).uniform(-1.0, 1.0, cap)
    phase = np.random.default_rng(0).uniform(0.0, 2.0, cap)
    if config.pan_draw_values is not None:
        v = np.asarray(config.pan_draw_values, np.float64)
        m = min(cap, len(v))
        pan[:m] = v[:m]
    if config.phase_draw_values is not None:
        v = np.mod(np.asarray(config.phase_draw_values, np.float64), 2.0)
        m = min(cap, len(v))
        phase[:m] = v[:m]
    return pan, phase


def track_native(peaks_per_frame, config: ResynthConfig):
    """C++ fast path of `track` (native/pitchpipe.cpp). Same event semantics;
    returns (tracked_notes, stats=None, n_dropped)."""
    pipe = _make_native_pipe(config)
    next_pan = _pan_draw_fn(config)
    voices: dict[int, resynth_bank.TrackedNote] = {}
    for frame_idx, freqmags in enumerate(peaks_per_frame):
        if freqmags:
            fr = np.asarray([fm[0] for fm in freqmags])
            mg = np.asarray([fm[1] for fm in freqmags])
        else:
            fr = np.zeros(0)
            mg = np.zeros(0)
        kinds, nids, freqs, vols = pipe.process_frame(fr, mg)
        for k, nid, f, v in zip(kinds, nids, freqs, vols):
            if k == 0:  # note on
                pan = config.stereo_spread * next_pan()
                voices[nid] = resynth_bank.TrackedNote(
                    frames=[(frame_idx, f, v)], pan=pan)
            elif k == 1:  # change
                voices[nid].frames.append((frame_idx, f, v))
            else:  # off
                voices[nid].release_frame = frame_idx
    return list(voices.values()), None, pipe.dropped


def track(peaks_per_frame, config: ResynthConfig, *, prefer_native: bool = True):
    """Run the pitch pipeline + tracking; returns (tracked_notes, frame_stats,
    n_dropped_noteon). Uses the C++ pipeline when built (native/pitchpipe.cpp);
    the pure-Python implementation below is the semantic reference."""
    if (prefer_native and config.harmonize_semantics == "reference"
            and config.draw_indexing != "stable"):
        # the C++ pipeline implements only the reference probe semantics
        # and sequential draw consumption
        from .. import native as nat

        if nat.available():
            return track_native(peaks_per_frame, config)
    return track_python(peaks_per_frame, config)


class PitchTracker:
    """Frame-incremental pitch pipeline + note tracking.

    One `step(freqmags)` per analysis stride; identical semantics to the
    reference's per-window `RtResynth::step` (rt.resynth.lib.cpp:1670-1759).
    Offline callers batch it (track_python); the live path (streaming.py)
    feeds it window by window.
    """

    def __init__(self, config: ResynthConfig):
        self.config = config
        self.midi = Midi()
        self.autotune_fn = at.mk_autotune_function(
            use_autotune=config.use_autotune, **config.autotune_kwargs
        )
        self._next_pan = _pan_draw_fn(config)
        self._stable_draws = config.draw_indexing == "stable"
        if self._stable_draws:
            # position-keyed pools (see ResynthConfig.draw_indexing)
            self._pan_pool = _LazyPool(config.seed, -1.0, 1.0)
            self._phase_pool = _LazyPool(0, 0.0, 2.0)
        self.played: list[pp.PlayedNote] = []
        self.voices: dict[int, resynth_bank.TrackedNote] = {}
        self.next_noteid = 0
        self.dropped_note_on = 0
        self.stats: list[AnalysisFrameResult] = []
        self.frame_idx = 0

    def step(self, freqmags) -> AnalysisFrameResult:
        config = self.config
        frame_idx = self.frame_idx
        self.frame_idx += 1

        pvs = pp.frequencies_to_pitches(self.midi, freqmags)
        intervals = pp.aggregate_pitches(config.nearby_distance_tones, pvs)
        reduced = pp.reduce_pitches(config.pitch_method, config.volume_method,
                                    config.min_volume, intervals)
        pp.shift_pitches(config.pitch_shift_pre_autotune, reduced)
        reduced = pp.harmonize_pitches(config.pitch_harmonize_pre_autotune,
                                       reduced, config.harmonize_semantics)
        tuned = pp.autotune_pitches(config.autotune_max_pitch,
                                    config.autotune_tolerance_pitches,
                                    self.autotune_fn, reduced)
        pp.shift_pitches(config.pitch_shift_post_autotune, tuned)
        tuned = pp.harmonize_pitches(config.pitch_harmonize_post_autotune,
                                     tuned, config.harmonize_semantics)
        pitch_changes, continue_playing = pp.track_pitches(
            config.max_track_pitches, tuned, self.played
        )
        order = pp.order_pitches_by_perceived_loudness(tuned)

        st = AnalysisFrameResult(frame_idx, [(p.midipitch, p.volume) for p in tuned])

        # note offs
        for j, cont in enumerate(continue_playing):
            if not cont:
                self.voices[self.played[j].noteid].release_frame = frame_idx
                st.note_off += 1

        # note changes / ons, loudest first (synthesize_sounds,
        # rt.resynth.lib.cpp:265-382)
        active = sum(continue_playing)
        on_rank = 0  # accepted note-ons this frame (stable draw key)
        for idx in order:
            pv = tuned[idx]
            new_freq = float(self.midi.midi_pitch_to_freq(pv.midipitch))
            # reference: volume = gain * pv.volume / reduceUnadjustedVolumes
            # (rt.resynth.lib.cpp:322-324), then NoteOn multiplies by
            # baseVolume = reduceUnadjustedVolumes (gen.crtp.h:425) — the two
            # cancel, so the rendered amplitude is gain * pv.volume.
            volume = config.analysis_volume * pv.volume
            pc = pitch_changes[idx]
            if pc is not None:
                note = self.played[pc]
                self.voices[note.noteid].frames.append((frame_idx, new_freq, volume))
                note.midi_pitch = pv.midipitch
                note.cur_freq = new_freq
                note.cur_velocity = volume
                st.note_change += 1
            else:
                if volume <= 0:
                    continue
                if active >= config.max_voices:
                    self.dropped_note_on += 1
                    st.dropped += 1
                    continue
                self.next_noteid += 1
                active += 1
                if self._stable_draws:
                    di = frame_idx * config.max_voices + on_rank
                    pan = config.stereo_spread * self._pan_pool.take(di)
                    phase = self._phase_pool.take(di) % 2.0
                else:
                    pan = config.stereo_spread * self._next_pan()
                    phase = None
                on_rank += 1
                self.voices[self.next_noteid] = resynth_bank.TrackedNote(
                    frames=[(frame_idx, new_freq, volume)], pan=pan,
                    phase=phase
                )
                self.played.append(pp.PlayedNote(frame_idx, self.next_noteid,
                                                 pv.midipitch, new_freq, volume))
                st.note_on += 1

        self.played = pp.remove_dead_notes(continue_playing, self.played)
        pp.sort_by_current_pitch(self.played)
        self.stats.append(st)
        return st

    def result(self):
        return list(self.voices.values()), self.stats, self.dropped_note_on

    # the autotune function is a closure over config (unpicklable); it is
    # deterministic in config, so render-state snapshots (analysis/checkpoint
    # .py) drop it and rebuild it on load
    def __getstate__(self):
        state = self.__dict__.copy()
        del state["autotune_fn"]
        return state

    def __setstate__(self, state):
        self.__dict__.update(state)
        self.autotune_fn = at.mk_autotune_function(
            use_autotune=self.config.use_autotune,
            **self.config.autotune_kwargs)


def track_python(peaks_per_frame, config: ResynthConfig):
    """Pure-python pitch pipeline + tracking (semantic reference)."""
    tracker = PitchTracker(config)
    for freqmags in peaks_per_frame:
        tracker.step(freqmags)
    return tracker.result()


def _render_config(config: ResynthConfig) -> resynth_bank.TrackedRenderConfig:
    sr = config.sample_rate
    ahdsr = envelopes.AHDSR(
        attack=int(0.5 + config.env_attack_seconds * sr), attack_itp=int(Itp.LINEAR),
        hold=int(0.5 + config.env_hold_seconds * sr),
        decay=int(0.5 + config.env_decay_seconds * sr), decay_itp=int(Itp.LINEAR),
        release=int(0.5 + config.env_release_seconds * sr), release_itp=int(Itp.LINEAR),
        sustain=config.env_sustain_level,
    )
    return resynth_bank.TrackedRenderConfig(
        # control frame f sounds at f*stride + window_size - 1: the offline
        # duplex loop analyzes the completed window BEFORE rendering that
        # same sample index, so a note from the window ending at sample W-1
        # already contributes at W-1 (rt.resynth.lib.cpp:1215-1231; pinned
        # sample-exactly by the assembled rtjob oracle, tools/rtjob_compare)
        sample_rate=sr, stride=config.stride,
        start_sample=config.window_size - 1,
        ahdsr=ahdsr,
        # "df32" = f32 compute with df32 analysis lanes (chain.py); the
        # render kernel itself runs f32 (df-phase path via the 17-field table)
        dtype="float32" if config.dtype == "df32" else config.dtype,
        phase_draw_values=config.phase_draw_values,
    )


def build_tables_native(freq, mag_db, config: ResynthConfig, total_frames: int,
                        rcfg: resynth_bank.TrackedRenderConfig | None = None):
    """Fused C++ host path: device peak arrays -> slot control table.

    One call runs the whole per-frame pitch pipeline + note tracking + slot
    packing (native/pitchpipe.cpp pitchpipe_run_offline) — bit-identical to
    track() + resynth_bank._build_slot_tables but without per-frame Python.
    """
    rcfg = rcfg or _render_config(config)
    pipe = _make_native_pipe(config)
    freq = np.asarray(freq, np.float64)
    n_frames = freq.shape[0]
    # draw pools sized to the hard upper bound (<= max_voices note-ons per
    # frame); pan per note-on (event order, PitchTracker.rng), phase per
    # packed note (_build_slot_tables rng(0))
    cap = n_frames * config.max_voices + 16
    pan_draws, phase_draws = draw_pools(config, cap)
    a = rcfg.ahdsr
    table, _n_notes = pipe.run_offline(
        freq, np.asarray(mag_db, np.float64),
        stride=rcfg.stride, n_slots=rcfg.n_slots, total_frames=total_frames,
        sample_rate=rcfg.sample_rate,
        attack=float(np.max(np.asarray(a.attack))),
        hold=float(np.max(np.asarray(a.hold))),
        decay=float(np.max(np.asarray(a.decay))),
        sustain=float(np.asarray(a.sustain)),
        release=float(np.max(np.asarray(a.release))),
        stereo_spread=config.stereo_spread,
        pan_draws=pan_draws, phase_draws=phase_draws,
    )
    return table


def resynthesize(signal, config: ResynthConfig, *, device_out: bool = False,
                 prefer_native: bool = True,
                 implementation: str = "auto",
                 device="cuda"):
    """Full offline chain: mono signal -> stereo resynthesis (T, 2): one
    host copy (numpy), or with device_out=True the tensor on `device`.

    implementation: "auto" takes the device-resident chain
    (chain.resynthesize_signal_device: the device tracker, incl.
    autotune/harmonize configs), except for reference-semantics harmonize
    configs, which go to "native"; "device" forces the device tracker;
    "native" takes the fused C++ table packer when the library is available
    and the draws are sequential (else the Python tracker); "python" forces
    the pure-Python tracker. prefer_native=False sends "auto" to "python"
    and keeps `track` off the C++ pipeline, as in the JAX package (resynth.py:
    474-475, 503-505). dtype "df32" routes as in the JAX package: the
    analysis runs at float64 and the render config's dtype is float32; the
    device route tracks with the fidelity tracker (a 17-field table).
    """
    if implementation not in ("auto", "device", "native", "python"):
        raise ValueError(f"unknown implementation {implementation!r}")
    if not prefer_native and implementation == "auto":
        implementation = "python"
    if (implementation == "auto"
            and config.harmonize_semantics == "reference"
            and (config.pitch_harmonize_pre_autotune != 0.0
                 or config.pitch_harmonize_post_autotune != 0.0)):
        # perf routing: the device tracker DOES implement reference probe
        # semantics (device_tracker._harmonize_lanes_reference), but as a
        # sequential lane loop; the native tracker is faster for these
        # configs. Explicit implementation="device" still gets the exact
        # device path.
        implementation = "native"
    if implementation in ("device", "auto"):
        from . import chain

        out = chain.resynthesize_signal_device(signal, config, device=device)
        return out if device_out else out.cpu().numpy()
    rcfg = _render_config(config)
    if implementation == "native":
        from .. import native as nat

        # the fused C++ table packer consumes draws sequentially only
        if nat.available() and config.draw_indexing != "stable":
            freq, mag = analyze_arrays(signal, config, device=device)
            n_frames = int(freq.shape[0])
            table = build_tables_native(freq.cpu().numpy(), mag.cpu().numpy(),
                                        config, n_frames + 8, rcfg)
            return resynth_bank.render_table(table, rcfg, device_out,
                                             device=device)
    peaks = analyze(signal, config, device=device)
    notes, _stats, _dropped = track(
        peaks, config,
        prefer_native=prefer_native and implementation != "python")
    return resynth_bank.render_tracked(notes, len(peaks), rcfg,
                                       device_out=device_out, device=device)


def resynthesize_feedback(signal, config: ResynthConfig, *,
                          feedback_gain: float, delay_seconds: float = 1.0,
                          max_level: float = 4.0, post_limit: bool = False,
                          extra_mix=None, device="cuda") -> torch.Tensor:
    """Resynthesis with delayed-output feedback into the analyzed stream.

    Reference (rt.resynth.lib.cpp:1629-1651): the analysis thread sums the
    live input with `analysis_output_feedback_gain` x the output delayed by a
    cyclic delay line of `output_delay_seconds` before feeding the FFT — the
    "feedback drone" feature. The coupled system is frame-causal (the output
    at time t depends on analysis frames <= t, which depend on the summed
    stream <= t, which depends on output <= t - delay), so it resolves
    exactly in ceil(n/delay) passes: each pass extends the summed stream by
    one delay-chunk using the previous pass's output, re-runs the batch
    pipeline on the prefix, and keeps the newly-valid chunk.

    The fed-back stream is the L+R sum of the POST-PROCESSED output
    (RtResynth::init_post publishes the mono sum after the post chain,
    rt.resynth.lib.cpp:1263-1273): with post_limit the master limiter is in
    the loop (Postprocessing::Limit — the only thing keeping a hot loop
    bounded), and `extra_mix` carries the other output legs (vocoder,
    direct voice/carrier) that the published output includes. Without
    post_limit the reference feeds back the RAW output (Postprocessing::
    None has no clamp — an unstable gain diverges, for real); offline we
    clamp the summed analysis stream at max_level instead, a documented
    repo improvement.

    The effective loop delay is `delay + 1` samples: the analysis aggregator
    pairs input[t] with the PREVIOUS iteration's published output (the
    output stream is one sample behind the input stream in the duplex loop),
    so the analyzed stream is input[t] + gain * output[t - 1 - delay] —
    pinned by the assembled rtjob oracle (tests/test_rtjob_oracle.py;
    a tap at exactly `delay` decorrelates at the second feedback
    generation).

    Returns the resynth leg only, a (T, 2) tensor on `device` (the caller
    composes legs + final post, as run_offline does; the full-stream
    limiter equals the in-loop streaming limiter because the follower
    recurrence is causal). The summed stream, the fed-back mono mix and
    the in-loop limiter stay on `device`: no pass copies to the host.
    """
    from ..ops import limiter as lim

    dev = torch.device(device)
    sig = torch.as_tensor(signal, dtype=torch.float64, device=dev)
    n = sig.shape[0]
    D = max(config.stride, int(0.5 + delay_seconds * config.sample_rate))
    if feedback_gain == 0.0:
        return resynthesize(sig, config, device_out=True, device=dev)
    Deff = D + 1
    out_mono = sig.new_zeros(n)  # delayed-feedback source (L+R sum, out.h:1268)
    summed = sig.clone()
    extra = None
    if extra_mix is not None:
        extra = sig.new_zeros((n, 2))
        m0 = min(n, len(extra_mix))
        extra[:m0] = torch.as_tensor(extra_mix[:m0], dtype=torch.float64, device=dev)
    for start in range(0, n, D):
        end = min(start + D, n)
        delayed = sig.new_zeros(end - start)
        src_lo = start - Deff
        if src_lo + (end - start) > 0:
            lo = max(src_lo, 0)
            delayed[lo - src_lo:] = out_mono[lo: src_lo + (end - start)]
        blk = sig[start:end] + feedback_gain * delayed
        if not post_limit:
            blk = torch.clamp(blk, -max_level, max_level)
        summed[start:end] = blk
        result = resynthesize(summed[:end], config, device_out=True,
                              device=dev).to(torch.float64)
        if extra is not None:
            m2 = min(result.shape[0], n)
            result[:m2] += extra[:m2]
        if post_limit:
            result, _p = lim.limit_streaming(result, sample_rate=config.sample_rate)
        m = result.sum(dim=1)
        out_mono[:min(m.shape[0], n)] = m[:n]
    return resynthesize(summed, config, device_out=True, device=dev)


def resynth_wav(in_path, out_path, config: ResynthConfig | None = None, *,
                device="cuda") -> np.ndarray:
    """WAV -> analysis -> resynthesis -> WAV (the `resynth` app scheme).
    The resynthesis runs on `device`; its (T, 2) output comes to the host
    once, for the WAV and the return."""
    data, sr = wavio.read_wav(in_path)
    mono = data.mean(axis=1)
    config = config or ResynthConfig()
    config.sample_rate = sr
    out = resynthesize(mono, config, device=device)
    wavio.write_wav(out_path, out, sr)
    return out
