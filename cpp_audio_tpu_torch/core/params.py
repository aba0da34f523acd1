"""Normalized parameter system: ParamSpec / Limits / Program.

Reference: include/paramspec.h, include/program.h, include/normalization.h and
the voice param plumbing of include/gen.voice.h:3-323 +
include/pernamespace.implparams.h — UI-facing params are normalized floats in
[0,1]; `Limits<P>` gives each param its natural range, programs are named
normalized float vectors (plus preferred seeds), and each SoundEngine mode
exposes its own subset of the master ImplParams enum.

Host copy of cpp_audio_tpu/core/params.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..models.voice_presets import (FreqXfade, Mode, VoiceProgram,
                                    _slow_iter_stored)
from ..utils.interp import Itp


@dataclass(frozen=True)
class ParamSpec:
    """UI metadata for one parameter (reference include/paramspec.h)."""

    name: str
    min: float = 0.0
    max: float = 1.0
    enum_values: tuple | None = None  # discrete params (interpolation kinds...)

    def normalize(self, v: float) -> float:
        """float32 like the reference's do_normalize_f (pernamespace.
        implparams.h via gen.voice.h's Limits<>); no clamping — factory
        values outside the limits store out-of-range like the reference's
        (e.g. Talkative bird's 0.05 xfade, the sweeps' sub-10Hz lows)."""
        if self.enum_values is not None:
            return float(self.enum_values.index(v))
        if self.max == self.min:
            return 0.0
        f = np.float32
        return float((f(v) - f(self.min)) / (f(self.max) - f(self.min)))

    def denormalize(self, x: float) -> float:
        if self.enum_values is not None:
            return self.enum_values[int(0.5 + x)]
        f = np.float32
        return float(f(self.min) + f(x) * (f(self.max) - f(self.min)))


@dataclass
class Program:
    """Named normalized parameter vector (reference include/program.h)."""

    name: str
    values: np.ndarray
    preferred_seeds: tuple = ()


class ImplParams(enum.IntEnum):
    """Master voice param enum (reference include/gen.voice.h:4-53)."""

    PINK_NOISE_LP_GAIN = 0
    PINK_NOISE_BP_GAIN = enum.auto()
    PINK_NOISE_BR_GAIN = enum.auto()
    PINK_NOISE_BP_OCTAVE_WIDTH_MIN = enum.auto()
    PINK_NOISE_BP_OCTAVE_WIDTH_MAX = enum.auto()
    CENTER_OCTAVE_MIN_LONG_TERM = enum.auto()
    CENTER_OCTAVE_MAX_LONG_TERM = enum.auto()
    CENTER_SHORT_TERM_RATIO = enum.auto()
    SECONDS_SLOW_ITER_SHORT_TERM = enum.auto()
    SECONDS_SLOW_ITER_LONG_TERM = enum.auto()
    ORDER_FILTERS = enum.auto()
    SINE_GAIN = enum.auto()
    SEED = enum.auto()
    RANDOM_PAN = enum.auto()
    PAN = enum.auto()
    GAIN = enum.auto()
    LOUDNESS_LEVEL = enum.auto()
    LOUDNESS_COMPENSATION_AMOUNT = enum.auto()
    LOUDNESS_REF_FREQ_INDEX = enum.auto()
    MARKOV_START_NODE = enum.auto()
    MARKOV_PRE_TRIES = enum.auto()
    MARKOV_MIN_PATH_LENGTH = enum.auto()
    MARKOV_ADDITIONAL_TRIES = enum.auto()
    MARKOV_ARTICULATIVE_PAUSE_LENGTH = enum.auto()
    INTERPOLATION = enum.auto()
    FREQ_SCATTER = enum.auto()
    LENGTH = enum.auto()
    LENGTH_EXPONENT = enum.auto()
    LENGTH_EXPONENT_SCATTER = enum.auto()
    XFADE_LENGTH = enum.auto()
    PHASE_RATIO1 = enum.auto()
    PHASE_RATIO2 = enum.auto()
    D1 = enum.auto()
    D2 = enum.auto()
    HARMONIC_ATTENUATION = enum.auto()
    MARKOV_XFADE_FREQ = enum.auto()
    FREQ_TRANSITION_LENGTH = enum.auto()
    FREQ_TRANSITION_INTERPOLATION = enum.auto()
    LOW_FREQ = enum.auto()
    HIGH_FREQ = enum.auto()


P = ImplParams
_ITPS = tuple(int(i) for i in Itp)
_XFADES = (FreqXfade.NO, FreqXfade.NON_TRIVIAL, FreqXfade.ALL)

# reference Limits<> (gen.voice.h:226-318 + gen.voice.cpp + loudness_enum_limits)
LIMITS: dict[ImplParams, ParamSpec] = {
    P.PINK_NOISE_LP_GAIN: ParamSpec("[1/f Noise] LPF Gain"),
    P.PINK_NOISE_BP_GAIN: ParamSpec("[1/f Noise] BPF Gain"),
    P.PINK_NOISE_BR_GAIN: ParamSpec("[1/f Noise] BRF Gain"),
    P.PINK_NOISE_BP_OCTAVE_WIDTH_MIN: ParamSpec("BPF Width Min", 0.0, 5.0),
    P.PINK_NOISE_BP_OCTAVE_WIDTH_MAX: ParamSpec("BPF Width Max", 0.0, 5.0),
    P.CENTER_OCTAVE_MIN_LONG_TERM: ParamSpec("Long Center Min", 0.0, 10.0),
    P.CENTER_OCTAVE_MAX_LONG_TERM: ParamSpec("Long Center Max", 0.0, 10.0),
    P.CENTER_SHORT_TERM_RATIO: ParamSpec("Short Center Ratio"),
    P.SECONDS_SLOW_ITER_SHORT_TERM: ParamSpec("Iter exp short"),
    P.SECONDS_SLOW_ITER_LONG_TERM: ParamSpec("Iter exp long"),
    P.ORDER_FILTERS: ParamSpec("Filters Order", 1.0, 258.0),
    P.SINE_GAIN: ParamSpec("[Sine] Gain"),
    P.SEED: ParamSpec("Seed", 0.0, 257.0),
    P.RANDOM_PAN: ParamSpec("Random pan", 0.0, 1.0),
    P.PAN: ParamSpec("Pan", -1.0, 1.0),
    P.GAIN: ParamSpec("Gain", 1.0, 60.0),
    P.LOUDNESS_LEVEL: ParamSpec("[Loudness] Level", 20.0, 100.0),
    P.LOUDNESS_COMPENSATION_AMOUNT: ParamSpec("[Loudness] Compensation"),
    P.LOUDNESS_REF_FREQ_INDEX: ParamSpec("[Loudness] Min comp. f. idx", 0.0, 10.0),
    P.MARKOV_START_NODE: ParamSpec("[Markov] Start node", 0.0, 2.0),
    P.MARKOV_PRE_TRIES: ParamSpec("[Markov] Num. pre tries", 0.0, 20.0),
    P.MARKOV_MIN_PATH_LENGTH: ParamSpec("[Markov] Min path length", 0.0, 20.0),
    P.MARKOV_ADDITIONAL_TRIES: ParamSpec("[Markov] Num. post tries", 0.0, 20.0),
    P.MARKOV_ARTICULATIVE_PAUSE_LENGTH: ParamSpec("Articulative pause length", 0.0, 0.5),
    P.INTERPOLATION: ParamSpec("Interpolation", enum_values=_ITPS),
    P.FREQ_SCATTER: ParamSpec("Frequency scatter"),
    P.LENGTH: ParamSpec("Length", 10.0, 500.0),
    P.LENGTH_EXPONENT: ParamSpec("Length Exponent", 0.0, 7.0),
    P.LENGTH_EXPONENT_SCATTER: ParamSpec("Length Exponent Scatter"),
    P.XFADE_LENGTH: ParamSpec("Crossfade length", 0.0023, 0.0454),
    P.PHASE_RATIO1: ParamSpec("Phase ratio 1"),
    P.PHASE_RATIO2: ParamSpec("Phase ratio 2"),
    P.D1: ParamSpec("D1", 0.0, 47.0),
    P.D2: ParamSpec("D2", 0.0, 47.0),
    P.HARMONIC_ATTENUATION: ParamSpec("Harmonic attenuation", 0.5, 0.98),
    P.MARKOV_XFADE_FREQ: ParamSpec("Xfade freq", enum_values=_XFADES),
    P.FREQ_TRANSITION_LENGTH: ParamSpec("Frequency transition length", 0.0, 0.5),
    P.FREQ_TRANSITION_INTERPOLATION: ParamSpec("Frequency Interpolation", enum_values=_ITPS),
    P.LOW_FREQ: ParamSpec("[Sweep] Low freq.", 10.0, 10000.0),
    P.HIGH_FREQ: ParamSpec("[Sweep] High freq.", 20.0, 40000.0),
}

# per-mode param subsets IN THE REFERENCE'S ARRAY ORDER (params_birds/
# params_robots/params_sweep/params_wind, gen.voice.h:55-208; pinned
# index-for-index against the compiled getPrograms() arrays by
# tests/test_reference_oracle.py::TestVoicePrograms). Notables: SWEEP has
# no SEED; WIND has no articulative-pause param (initialize_wind takes
# none) and interleaves its slow-iter params between the centers and the
# filter order; ROBOTS puts D1/D2/HARMONIC_ATTENUATION between the markov
# block and INTERPOLATION.
_PREFIX = [
    P.PINK_NOISE_LP_GAIN, P.PINK_NOISE_BP_GAIN, P.PINK_NOISE_BR_GAIN,
    P.PINK_NOISE_BP_OCTAVE_WIDTH_MIN, P.PINK_NOISE_BP_OCTAVE_WIDTH_MAX,
    P.CENTER_OCTAVE_MIN_LONG_TERM, P.CENTER_OCTAVE_MAX_LONG_TERM,
]
_SUFFIX = [
    P.SINE_GAIN, P.SEED, P.RANDOM_PAN, P.PAN, P.GAIN,
    P.LOUDNESS_LEVEL, P.LOUDNESS_COMPENSATION_AMOUNT, P.LOUDNESS_REF_FREQ_INDEX,
]
_MARKOV = [
    P.MARKOV_START_NODE, P.MARKOV_PRE_TRIES, P.MARKOV_MIN_PATH_LENGTH,
    P.MARKOV_ADDITIONAL_TRIES,
]
_RAMP = [
    P.INTERPOLATION, P.FREQ_SCATTER, P.LENGTH, P.LENGTH_EXPONENT,
    P.LENGTH_EXPONENT_SCATTER, P.XFADE_LENGTH,
]

MODE_PARAMS: dict[Mode, list[ImplParams]] = {
    Mode.BIRDS: _PREFIX + [P.ORDER_FILTERS] + _SUFFIX + _MARKOV
    + [P.MARKOV_ARTICULATIVE_PAUSE_LENGTH] + _RAMP
    + [P.MARKOV_XFADE_FREQ, P.FREQ_TRANSITION_LENGTH,
       P.FREQ_TRANSITION_INTERPOLATION, P.PHASE_RATIO1, P.PHASE_RATIO2],
    Mode.ROBOTS: _PREFIX + [P.ORDER_FILTERS] + _SUFFIX + _MARKOV
    + [P.MARKOV_ARTICULATIVE_PAUSE_LENGTH, P.D1, P.D2,
       P.HARMONIC_ATTENUATION] + _RAMP + [P.PHASE_RATIO1, P.PHASE_RATIO2],
    Mode.SWEEP: _PREFIX + [P.ORDER_FILTERS, P.SINE_GAIN, P.RANDOM_PAN, P.PAN,
                           P.GAIN, P.LOUDNESS_LEVEL,
                           P.LOUDNESS_COMPENSATION_AMOUNT,
                           P.LOUDNESS_REF_FREQ_INDEX, P.INTERPOLATION,
                           P.LENGTH, P.LENGTH_EXPONENT, P.XFADE_LENGTH,
                           P.LOW_FREQ, P.HIGH_FREQ],
    Mode.WIND: _PREFIX + [P.CENTER_SHORT_TERM_RATIO,
                          P.SECONDS_SLOW_ITER_SHORT_TERM,
                          P.SECONDS_SLOW_ITER_LONG_TERM, P.ORDER_FILTERS]
    + _SUFFIX + _MARKOV + _RAMP,
}

MAX_SECONDS_SLOW_ITER = 2.268


def get_param_specs(mode: Mode) -> list[ParamSpec]:
    return [LIMITS[p] for p in MODE_PARAMS[mode]]


# Params the factories store RAW, not normalized (make_common's
# commented-out normalize<> calls + the plain static_casts,
# gen.voice.h:504-533; SECONDS_SLOW_ITER_* live in log_2.268 space,
# gen.voice.h:645): value<P>() reads them back as m + stored.
RAW_STORED = frozenset({
    P.SEED, P.RANDOM_PAN, P.LOUDNESS_COMPENSATION_AMOUNT,
    P.LOUDNESS_REF_FREQ_INDEX, P.MARKOV_START_NODE, P.MARKOV_PRE_TRIES,
    P.MARKOV_MIN_PATH_LENGTH, P.MARKOV_ADDITIONAL_TRIES, P.D1, P.D2,
    P.FREQ_SCATTER, P.SECONDS_SLOW_ITER_LONG_TERM,
    P.SECONDS_SLOW_ITER_SHORT_TERM,
})
# ORDER_FILTERS is stored offset by its minimum (gen.voice.h:514)
_OFFSET_STORED = frozenset({P.ORDER_FILTERS})


def voice_program_to_normalized(vp: VoiceProgram) -> Program:
    """Encode a VoiceProgram into the normalized array of its mode."""
    order = MODE_PARAMS[vp.mode]
    vals = np.zeros(len(order))
    direct = {
        P.PINK_NOISE_LP_GAIN: vp.pink_lp_gain,
        P.PINK_NOISE_BP_GAIN: vp.pink_bp_gain,
        P.PINK_NOISE_BR_GAIN: vp.pink_br_gain,
        P.PINK_NOISE_BP_OCTAVE_WIDTH_MIN: vp.bp_width_min,
        P.PINK_NOISE_BP_OCTAVE_WIDTH_MAX: vp.bp_width_max,
        P.CENTER_OCTAVE_MIN_LONG_TERM: vp.center_octave_min,
        P.CENTER_OCTAVE_MAX_LONG_TERM: vp.center_octave_max,
        P.CENTER_SHORT_TERM_RATIO: vp.center_short_term_ratio,
        P.ORDER_FILTERS: vp.filter_order,
        P.SINE_GAIN: vp.sine_gain,
        P.SEED: 0.0,
        P.RANDOM_PAN: 0.0,
        P.PAN: 0.0,
        P.GAIN: vp.gain,
        P.LOUDNESS_LEVEL: vp.loudness_level,
        P.LOUDNESS_COMPENSATION_AMOUNT: vp.loudness_compensation,
        P.LOUDNESS_REF_FREQ_INDEX: vp.loudness_ref_freq_index,
        P.MARKOV_START_NODE: vp.start_node,
        P.MARKOV_PRE_TRIES: vp.pre_tries,
        P.MARKOV_MIN_PATH_LENGTH: vp.min_path_length,
        P.MARKOV_ADDITIONAL_TRIES: vp.additional_tries,
        P.MARKOV_ARTICULATIVE_PAUSE_LENGTH: vp.articulative_pause_seconds,
        P.INTERPOLATION: vp.interpolation,
        P.FREQ_SCATTER: vp.freq_scatter,
        P.LENGTH: vp.length_ms,
        P.LENGTH_EXPONENT: vp.length_exponent,
        P.LENGTH_EXPONENT_SCATTER: vp.length_exponent_scatter,
        P.XFADE_LENGTH: vp.xfade_seconds,
        P.PHASE_RATIO1: vp.phase_ratio1,
        P.PHASE_RATIO2: vp.phase_ratio2,
        P.D1: vp.d1,
        P.D2: vp.d2,
        P.HARMONIC_ATTENUATION: vp.harmonic_attenuation,
        P.MARKOV_XFADE_FREQ: vp.xfade_freq,
        P.FREQ_TRANSITION_LENGTH: vp.freq_transition_seconds,
        P.FREQ_TRANSITION_INTERPOLATION: vp.freq_interpolation,
        P.LOW_FREQ: vp.low_freq,
        P.HIGH_FREQ: vp.high_freq,
        # stored as log_2.268(seconds) in f32 like the reference
        # (gen.voice.h:645; glibc logf == f32-rounded f64 log — see
        # voice_presets._slow_iter_stored)
        P.SECONDS_SLOW_ITER_LONG_TERM: float(_slow_iter_stored(
            max(vp.seconds_slow_iter_long, 1e-9))),
        P.SECONDS_SLOW_ITER_SHORT_TERM: float(_slow_iter_stored(
            max(vp.seconds_slow_iter_short, 1e-9))),
    }
    for i, p in enumerate(order):
        v = direct[p]
        if p in RAW_STORED:
            vals[i] = float(np.float32(v))
        elif p in _OFFSET_STORED:
            vals[i] = float(np.float32(v - LIMITS[p].min))
        else:
            vals[i] = LIMITS[p].normalize(v)
    return Program(vp.name, vals, vp.preferred_seeds)


def normalized_to_voice_program(mode: Mode, prog: Program) -> VoiceProgram:
    """Decode a normalized Program back into a VoiceProgram."""
    order = MODE_PARAMS[mode]
    idx = {p: i for i, p in enumerate(order)}

    def raw(p, default=0.0):
        if p not in idx:
            return default
        return float(prog.values[idx[p]])

    def den(p, default=0.0):
        # the reference's read-back: denormalize<> for normalized storage,
        # value<> (m + stored) for raw/offset storage
        if p not in idx:
            return default
        v = float(prog.values[idx[p]])
        if p in RAW_STORED:
            return v
        if p in _OFFSET_STORED:
            return LIMITS[p].min + v
        return LIMITS[p].denormalize(v)

    return VoiceProgram(
        name=prog.name, mode=mode,
        start_node=int(0.5 + den(P.MARKOV_START_NODE)),
        pre_tries=int(0.5 + den(P.MARKOV_PRE_TRIES)),
        min_path_length=int(0.5 + den(P.MARKOV_MIN_PATH_LENGTH)),
        additional_tries=int(0.5 + den(P.MARKOV_ADDITIONAL_TRIES)),
        articulative_pause_seconds=den(P.MARKOV_ARTICULATIVE_PAUSE_LENGTH),
        interpolation=den(P.INTERPOLATION, int(Itp.LINEAR)),
        freq_scatter=den(P.FREQ_SCATTER),
        length_ms=den(P.LENGTH, 93.0),
        length_exponent=den(P.LENGTH_EXPONENT, 2.0),
        length_exponent_scatter=den(P.LENGTH_EXPONENT_SCATTER, 0.0),
        xfade_seconds=den(P.XFADE_LENGTH, 0.0295),
        phase_ratio1=den(P.PHASE_RATIO1),
        phase_ratio2=den(P.PHASE_RATIO2),
        d1=den(P.D1), d2=den(P.D2),
        harmonic_attenuation=den(P.HARMONIC_ATTENUATION, 0.0),
        xfade_freq=den(P.MARKOV_XFADE_FREQ, FreqXfade.NO),
        freq_transition_seconds=den(P.FREQ_TRANSITION_LENGTH, 0.14),
        freq_interpolation=den(P.FREQ_TRANSITION_INTERPOLATION, int(Itp.EASE_OUT_EXPO)),
        low_freq=den(P.LOW_FREQ), high_freq=den(P.HIGH_FREQ),
        gain=den(P.GAIN, 2.0),
        loudness_level=den(P.LOUDNESS_LEVEL, 30.0),
        loudness_compensation=den(P.LOUDNESS_COMPENSATION_AMOUNT, 1.0),
        loudness_ref_freq_index=int(0.5 + den(P.LOUDNESS_REF_FREQ_INDEX, 5)),
        sine_gain=den(P.SINE_GAIN, 1.0),
        filter_order=int(0.5 + den(P.ORDER_FILTERS, 1)),
        bp_width_min=den(P.PINK_NOISE_BP_OCTAVE_WIDTH_MIN),
        bp_width_max=den(P.PINK_NOISE_BP_OCTAVE_WIDTH_MAX),
        center_octave_min=den(P.CENTER_OCTAVE_MIN_LONG_TERM, 1.0),
        center_octave_max=den(P.CENTER_OCTAVE_MAX_LONG_TERM, 8.0),
        center_short_term_ratio=den(P.CENTER_SHORT_TERM_RATIO),
        seconds_slow_iter_long=float(
            MAX_SECONDS_SLOW_ITER ** raw(P.SECONDS_SLOW_ITER_LONG_TERM, 1.0)),
        seconds_slow_iter_short=float(
            MAX_SECONDS_SLOW_ITER ** raw(P.SECONDS_SLOW_ITER_SHORT_TERM, 1.0)),
        preferred_seeds=prog.preferred_seeds,
    )
