"""SoundEngine voice programs (reference include/gen.voice.h:700-810).

Presets are stored in natural units (the reference normalizes them into
[0,1] float arrays via Limits<>; the normalized Program plumbing lives in
core/params.py — these tables are the denormalized source of truth).

Common defaults from make_common (gen.voice.h:477-533): gain 2, loudness
level 30 phon, loudness compensation 1.0, loudness ref freq index 5 (63 Hz),
center octaves 1..8, filters order per preset.

Host copy of cpp_audio_tpu/models/voice_presets.py.
"""

from __future__ import annotations

import enum
from dataclasses import dataclass, field

import numpy as np

from ..utils.interp import Itp


class Mode(enum.Enum):
    BIRDS = "birds"
    ROBOTS = "robots"
    SWEEP = "sweep"
    WIND = "wind"


class FreqXfade(enum.Enum):
    NO = "no"
    NON_TRIVIAL = "non_trivial"
    ALL = "all"


@dataclass(frozen=True)
class VoiceProgram:
    name: str
    mode: Mode
    # markov
    start_node: int = 0
    pre_tries: int = 0
    min_path_length: int = 1
    additional_tries: int = 0
    articulative_pause_seconds: float = 0.0
    # ramps
    interpolation: int = int(Itp.LINEAR)
    freq_scatter: float = 0.0
    length_ms: float = 93.0
    length_exponent: float = 2.0
    length_exponent_scatter: float = 0.5
    xfade_seconds: float = 0.0295
    phase_ratio1: float = 0.0
    phase_ratio2: float = 0.0
    # robot
    d1: float = 0.0
    d2: float = 0.0
    harmonic_attenuation: float = 0.0
    # birds
    xfade_freq: FreqXfade = FreqXfade.NO
    freq_transition_seconds: float = 0.14
    freq_interpolation: int = int(Itp.EASE_OUT_EXPO)
    # sweep
    low_freq: float = 0.0
    high_freq: float = 0.0
    # loudness / mix
    gain: float = 2.0
    loudness_level: float = 30.0
    loudness_compensation: float = 1.0
    loudness_ref_freq_index: int = 5
    sine_gain: float = 1.0
    # wind
    filter_order: int = 1
    bp_width_min: float = 0.0
    bp_width_max: float = 0.0
    center_octave_min: float = 1.0
    center_octave_max: float = 8.0
    center_short_term_ratio: float = 0.0
    seconds_slow_iter_long: float = 1.0   # denormalized seconds
    seconds_slow_iter_short: float = 1.0
    pink_lp_gain: float = 0.0
    pink_bp_gain: float = 0.0
    pink_br_gain: float = 0.0
    preferred_seeds: tuple = ()


def _bird(name, start_node, pre_tries, min_path_length, additional_tries, itp_i,
          freq_scat, length, length_med_exp, length_scale_exp,
          articulative_pause, xfade, xfade_freq, freq_xfade, freq_i, seeds=()):
    # The reference's make_bird accepts a freq interpolation argument but
    # NEVER uses it: FREQ_TRANSITION_INTERPOLATION is stored from the MAIN
    # interpolation's traversal index (gen.voice.h:608-613 reuses `i`, the
    # `freq_i` parameter is dead) — pinned by the compiled voice oracle.
    # `freq_i` is kept here to document the call sites (gen.voice.h:700-735)
    # but, like the reference, the effective value is `itp_i`.
    del freq_i
    return VoiceProgram(
        name=name, mode=Mode.BIRDS, start_node=start_node, pre_tries=pre_tries,
        min_path_length=min_path_length, additional_tries=additional_tries,
        articulative_pause_seconds=articulative_pause, interpolation=itp_i,
        freq_scatter=freq_scat, length_ms=length, length_exponent=length_med_exp,
        length_exponent_scatter=length_scale_exp, xfade_seconds=xfade,
        xfade_freq=xfade_freq, freq_transition_seconds=freq_xfade,
        freq_interpolation=itp_i, preferred_seeds=tuple(seeds),
    )


def _robot(name, start_node, pre_tries, min_path_length, additional_tries,
           articulative_pause, itp_i, freq_scat, length, length_med_exp,
           length_scale_exp, xfade, d1, d2, har_att):
    return VoiceProgram(
        name=name, mode=Mode.ROBOTS, start_node=start_node, pre_tries=pre_tries,
        min_path_length=min_path_length, additional_tries=additional_tries,
        articulative_pause_seconds=articulative_pause, interpolation=itp_i,
        freq_scatter=freq_scat, length_ms=length, length_exponent=length_med_exp,
        length_exponent_scatter=length_scale_exp, xfade_seconds=xfade,
        d1=d1, d2=d2, harmonic_attenuation=har_att,
    )


def _sweep(name, itp_i, length, length_med_exp, xfade, low, high):
    # make_sweep passes filter_order 20 to make_common (gen.voice.h:565)
    return VoiceProgram(
        name=name, mode=Mode.SWEEP, interpolation=itp_i, length_ms=length,
        length_exponent=length_med_exp, length_exponent_scatter=0.0,
        xfade_seconds=xfade, low_freq=low, high_freq=high, min_path_length=1,
        filter_order=20,
    )


MAX_SECONDS_SLOW_ITER = 2.268  # gen.voice.h:624


def _noise_wind(name, filter_order, bp_width, bp_center, n_slow_iter, **kw):
    return VoiceProgram(
        name=name, mode=Mode.WIND, min_path_length=6,
        interpolation=int(Itp.PROPORTIONAL_VALUE_DERIVATIVE), freq_scatter=0.12,
        length_ms=93.3, length_exponent=2.0, length_exponent_scatter=0.5,
        xfade_seconds=0.0499, filter_order=filter_order,
        bp_width_min=bp_width[0], bp_width_max=bp_width[1],
        center_octave_min=bp_center[0], center_octave_max=bp_center[1],
        seconds_slow_iter_long=n_slow_iter,
        pink_bp_gain=1.0, pink_br_gain=0.0, sine_gain=0.0,
        **kw,
    )


def _sine_wind(name, bp_center, short_center_ratio, slow_long, slow_short):
    return VoiceProgram(
        name=name, mode=Mode.WIND, min_path_length=6,
        interpolation=int(Itp.LINEAR), freq_scatter=0.12, length_ms=93.3,
        length_exponent=2.0, length_exponent_scatter=0.5, xfade_seconds=0.0499,
        filter_order=1, loudness_compensation=1.0, sine_gain=0.1,
        center_octave_min=bp_center[0], center_octave_max=bp_center[1],
        center_short_term_ratio=short_center_ratio,
        seconds_slow_iter_long=slow_long, seconds_slow_iter_short=slow_short,
    )


def _mixed_wind(name, filter_order, bp_width, bp_center, n_slow_iter):
    p = _noise_wind(name, filter_order, bp_width, bp_center, n_slow_iter,
                    loudness_compensation=0.0)
    return VoiceProgram(**{**p.__dict__, "sine_gain": 0.01})


CIRC = int(Itp.EASE_INOUT_CIRC)
IN_EXPO = int(Itp.EASE_IN_EXPO)
OUT_EXPO = int(Itp.EASE_OUT_EXPO)
INOUT_EXPO = int(Itp.EASE_INOUT_EXPO)
LIN = int(Itp.LINEAR)
X = FreqXfade

# reference gen.voice.h:700-810
BIRD_PROGRAMS = [
    _bird("Standard & Cute bird", 0, 0, 1, 0, CIRC, 0.0, 93.0, 2.0, 0.5,
          0.02267, 0.0295, X.NO, 0.14, OUT_EXPO, [32, 48, 69, 180, 218, 240]),
    _bird("Scat bird", 0, 0, 3, 17, CIRC, 0.015, 10.0, 2.0, 0.5,
          0.0445, 0.0177, X.NON_TRIVIAL, 0.363, INOUT_EXPO,
          [4, 5, 23, 26, 34, 48, 58, 68, 73, 74, 75, 80, 85, 88, 109, 116, 124,
           125, 131, 141, 146, 165, 181, 205, 213, 214, 227, 232, 249]),
    _bird("Rhythmic bird", 1, 0, 3, 11, CIRC, 0.0, 19.8, 2.0, 0.0,
          0.03188, 0.01138, X.ALL, 0.0182, INOUT_EXPO,
          [19, 29, 32, 36, 38, 48, 79, 106, 112, 116, 123, 147, 162, 195, 213,
           247, 248, 250]),
    _bird("Slow bird", 0, 2, 1, 0, IN_EXPO, 0.0, 73.7, 2.0, 0.5,
          0.02267, 0.0295, X.NO, 0.14, OUT_EXPO, [63, 70, 83, 91, 110, 160, 197]),
    _bird("BiTone bird", 1, 0, 2, 0, IN_EXPO, 0.414, 78.6, 2.0, 0.5,
          0.09755, 0.0295, X.NO, 0.14, OUT_EXPO,
          [5, 15, 27, 31, 49, 58, 72, 74, 96, 108, 147, 149, 171, 174, 180, 194,
           199, 205, 252]),
    _bird("Happy bird 1", 1, 0, 4, 0, IN_EXPO, 0.414, 78.6, 2.0, 0.5,
          0.1326, 0.0454, X.NO, 0.14, OUT_EXPO,
          [119, 141, 149, 159, 88, 32, 45, 168, 206]),
    _bird("Happy bird 2", 1, 0, 4, 0, IN_EXPO, 0.414, 63.9, 1.19, 1.0,
          0.1326, 0.0454, X.NO, 0.14, OUT_EXPO,
          [8, 20, 23, 60, 76, 113, 143, 168, 169, 178, 180, 208, 217, 231]),
    _bird("Laughing bird", 1, 0, 2, 0, IN_EXPO, 0.414, 78.6, 2.0, 0.5,
          0.2193, 0.0295, X.ALL, 0.0725, OUT_EXPO,
          [20, 31, 39, 36, 37, 47, 68, 89, 94, 105, 108, 136, 144, 145, 148,
           161, 172, 174, 212, 246, 249]),
    _bird("Talkative bird", 0, 0, 6, 0, CIRC, 0.12, 93.3, 2.0, 0.5,
          0.152, 0.05, X.NON_TRIVIAL, 0.0998, OUT_EXPO,
          [9, 28, 33, 38, 53, 54, 83, 114, 117, 122, 131, 162, 168, 171, 187,
           196, 216, 220]),
]

ROBOT_PROGRAMS = [
    _robot("R2D2", 0, 0, 1, 1, 0.0835, LIN, 0.0, 19.8, 2.1, 0.39, 0.0053,
           6, 12, 0.98),
    _robot("Communication", 0, 0, 16, 14, 0.03188, CIRC, 0.0, 10.0, 1.89, 1.0,
           0.0053, 6, 10, 0.98),
]

SWEEP_PROGRAMS = [
    _sweep("Sweep 1", LIN, 73.0, 5.0, 0.0109, 0.0009, 20000.0),
    _sweep("Fullrange", LIN, 500.0, 5.0, 0.0109, 0.000226, 20000.0),
]

WIND_PROGRAMS = [
    _noise_wind("Medium wind in trees", 1, (0.0, 0.0), (1.0, 8.0), 2.268),
    _noise_wind("Steady wind", 4, (1.3, 1.3), (5.2, 5.5), 0.09),
    _noise_wind("Strong wind", 4, (3.8, 3.8), (1.0, 8.0), 2.268),
    _noise_wind("Vinyl cracks", 89, (3.45, 5.0), (8.1, 8.1), 0.000748),
    _noise_wind("Small animal eating", 61, (0.0, 5.0), (8.1, 8.1), 0.000227),
    _noise_wind("Heavy rain in a car", 33, (3.45, 5.0), (8.1, 8.1), 0.000227),
    _noise_wind("Light rain in a car", 89, (3.45, 5.0), (8.1, 8.1), 0.000227),
    _noise_wind("Heavy rain", 13, (5.0, 5.0), (7.8, 8.0), 0.000283),
    _noise_wind("Light rain", 13, (3.45, 3.45), (8.0, 8.3), 0.000227),
    _noise_wind("Bubbles", 129, (2.45, 3.25), (4.8, 8.3), 0.0229),
    _noise_wind("Earth rumbling", 30, (1.95, 5.0), (2.5, 3.2), 0.1589),
    _sine_wind("Sine wind", (4.6, 6.8), 0.2, 2.268, 0.0005),
    _sine_wind("Kettle whistle pure", (7.5, 7.7), 0.0, 0.0005, 0.0005),
    _mixed_wind("Kettle whistle mixed", 7, (0.9, 0.9), (7.5, 7.7), 0.00716),
]

# ProgramsI sorts programs by name (reference include/program.h:64-69), so
# program INDICES are alphabetical — kept here so index-based selection
# (apps --program N, the worklet useProgram) matches the reference's.
PROGRAMS = {
    Mode.BIRDS: sorted(BIRD_PROGRAMS, key=lambda p: p.name),
    Mode.ROBOTS: sorted(ROBOT_PROGRAMS, key=lambda p: p.name),
    Mode.SWEEP: sorted(SWEEP_PROGRAMS, key=lambda p: p.name),
    Mode.WIND: sorted(WIND_PROGRAMS, key=lambda p: p.name),
}


def get_program(mode: Mode, index_or_name) -> VoiceProgram:
    progs = PROGRAMS[mode]
    if isinstance(index_or_name, int):
        return progs[index_or_name]
    for p in progs:
        if p.name == index_or_name:
            return p
    raise KeyError(index_or_name)


# ---------------------------------------------------------------------------
# Effective engine configuration
# ---------------------------------------------------------------------------
# The reference never feeds a program's natural values to the SoundEngine
# directly: factories store them as float32 normalized params
# (make_common/make_bird/..., gen.voice.h:477-699) and setupAudioElement
# (gen.voice.h:882-1037) denormalizes in float32 and converts to the engine
# setters' types — int TRUNCATION for freq_xfade / articulative pause /
# slow-step counts (implicit float->int at the call sites) but ROUNDING
# (int(.5f + x)) for the envelope charac time. effective_engine_config
# replays that arithmetic exactly (pinned value-for-value against the
# compiled reference by tests/test_reference_oracle.py::TestVoicePrograms);
# the production renderers (models/soundengine.py scheduler, models/wind.py)
# consume these values, not the naturals.

_F = np.float32


def _rt(nat, lo, hi):
    """The float32 normalize->denormalize storage roundtrip a natural value
    suffers between a factory and setupAudioElement (do_normalize_f /
    do_denormalize_f over Limits<> [lo, hi])."""
    v = (_F(nat) - _F(lo)) / (_F(hi) - _F(lo))
    return _F(lo) + v * (_F(hi) - _F(lo))


def _slow_iter_stored(seconds) -> np.float32:
    """make_*_wind stores log(seconds)/log(2.268) unnormalized in float32
    (gen.voice.h:645,676-677,697). glibc's logf is correctly rounded, i.e.
    f32(log_f64(x)) — numpy's f32 log is NOT (SIMD path, ~1 ulp off), so
    compute in f64 and round each factor."""
    import math
    num = _F(math.log(float(_F(seconds))))
    den = _F(math.log(float(_F(MAX_SECONDS_SLOW_ITER))))
    return num / den


def effective_engine_config(p: VoiceProgram, sample_rate: int) -> dict:
    """Exact engine-facing values for a program (see block comment above).

    Keys mirror the engine setter calls in setupAudioElement
    (gen.voice.h:882-1037); only the keys the program's mode wires are
    present.
    """
    sr = sample_rate
    cfg: dict = {}
    cfg["itp"] = int(p.interpolation)
    xfade = _rt(p.xfade_seconds, 0.0023, 0.0454)
    cfg["env_charac_time"] = int(_F(0.5) + xfade * _F(sr))
    ex = _rt(p.length_exponent, 0.0, 7.0)
    if p.mode is Mode.SWEEP:
        cfg["length_exp"] = (float(ex), float(ex))
    else:
        var = _rt(p.length_exponent_scatter, 0.0, 1.0)
        cfg["length_exp"] = (float(ex * (_F(1) - var)),
                             float(ex * (_F(1) + var)))
        # FREQ_SCATTER is stored raw (make_common's commented-out
        # normalize, gen.voice.h:517) and read back identically
        cfg["freq_scatter"] = float(_F(p.freq_scatter))
        if p.mode is not Mode.WIND:
            cfg["phase_ratio1"] = float(_rt(p.phase_ratio1, 0.0, 1.0))
            cfg["phase_ratio2"] = float(_rt(p.phase_ratio2, 0.0, 1.0))
    cfg["length"] = float(_rt(p.length_ms, 10.0, 500.0))
    cfg["loudness"] = (sr, int(p.loudness_ref_freq_index),
                       float(_F(p.loudness_compensation)),
                       float(_rt(p.loudness_level, 20.0, 100.0)))
    cfg["filters_order"] = int(p.filter_order)

    if p.mode is Mode.WIND:
        m = _rt(p.bp_width_min, 0.0, 5.0)
        M = _rt(p.bp_width_max, 0.0, 5.0)
        cfg["width_range"] = (float(min(m, M)), float(max(m, M)))
        cfg["gains"] = (float(_rt(p.pink_lp_gain, 0.0, 1.0)),
                        float(_rt(p.pink_bp_gain, 0.0, 1.0)),
                        float(_rt(p.pink_br_gain, 0.0, 1.0)),
                        float(_rt(p.sine_gain, 0.0, 1.0)))
        # octaveToFreq: 10 * 2^denorm in f32 (gen.voice.h:855-870), swapped
        # into ascending order, then 2f/sr (sound.functions.h:58-62)
        # std::pow(2.f, m) is glibc powf (correctly rounded) — compute in
        # f64 and round, like _slow_iter_stored's logs
        f1 = _F(10.0) * _F(2.0 ** float(_rt(p.center_octave_min, 0.0, 10.0)))
        f2 = _F(10.0) * _F(2.0 ** float(_rt(p.center_octave_max, 0.0, 10.0)))
        lo, hi = (f1, f2) if f1 <= f2 else (f2, f1)
        cfg["center_inc_range"] = (float(_F(2.0) * lo / _F(sr)),
                                   float(_F(2.0) * hi / _F(sr)))
        # n_slow_steps = sr * 2.268^stored in f32 (gen.voice.h:966-967),
        # truncated by the int parameters of ConfigureFilters /
        # SetSlowParams / SlowIter::set_n_slow_steps
        n_long = _F(sr) * _F(float(_F(MAX_SECONDS_SLOW_ITER))
                             ** float(_slow_iter_stored(
                                 p.seconds_slow_iter_long)))
        n_short = _F(sr) * _F(float(_F(MAX_SECONDS_SLOW_ITER))
                              ** float(_slow_iter_stored(
                                  p.seconds_slow_iter_short)))
        cfg["n_slow_steps_long"] = int(n_long)
        # SetSlowParams' int parameter truncates, then
        # set_short_term_noise_rate(float) widens back (gen.voice.h:328-340)
        cfg["spec_short_rate"] = float(int(n_short))
        cfg["spec_short_amp"] = float(_rt(p.center_short_term_ratio,
                                          0.0, 1.0))
        cfg["init"] = (p.start_node, p.pre_tries, p.min_path_length,
                       p.additional_tries)
        return cfg

    cfg["gains"] = (float(_rt(p.sine_gain, 0.0, 1.0)),)
    pause = int(_rt(p.articulative_pause_seconds, 0.0, 0.5) * _F(sr))
    if p.mode is Mode.BIRDS:
        # set_freq_xfade takes int: denorm * sr TRUNCATES (gen.voice.h:1005)
        cfg["freq_xfade"] = int(_rt(p.freq_transition_seconds, 0.0, 0.5)
                                * _F(sr))
        cfg["freq_itp"] = int(p.freq_interpolation)
        cfg["init"] = (p.start_node, p.pre_tries, p.min_path_length,
                       p.additional_tries, p.xfade_freq, pause)
    elif p.mode is Mode.ROBOTS:
        # d1/d2 are stored and read raw (value<D1>, gen.voice.h:1027-1028)
        cfg["d1"] = float(_F(p.d1))
        cfg["d2"] = float(_F(p.d2))
        cfg["har_att"] = float(_rt(p.harmonic_attenuation, 0.5, 0.98))
        cfg["init"] = (p.start_node, p.pre_tries, p.min_path_length,
                       p.additional_tries, pause)
    else:  # SWEEP
        cfg["init"] = (float(_rt(p.low_freq, 10.0, 10000.0)),
                       float(_rt(p.high_freq, 20.0, 40000.0)))
    return cfg
