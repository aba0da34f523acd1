"""Autotune pitch snapping (reference source/rt.resynth.lib.autotune.cpp and
RtResynth::mkAutotuneFunction, source/rt.resynth.lib.cpp:1761-1873)."""

from __future__ import annotations

import enum
from bisect import bisect_left

import numpy as np

from ..utils.midi import (
    A_PITCH, MAX_AUDIBLE_MIDI_PITCH, NUM_HALFTONES_PER_OCTAVE, Midi, Note,
    half_tones_distance,
)


class AutotuneType(enum.Enum):
    MUSICAL_SCALE = "musical_scale"
    CHORD = "chord"
    FIXED_SIZE_INTERVALS = "fixed_size_intervals"


class MusicalScaleMode(enum.Enum):
    MAJOR = "major"
    MINOR_NATURAL = "minor_natural"
    MINOR_HARMONIC = "minor_harmonic"


class AutotuneChordFrequencies(enum.Enum):
    SINGLE_FREQ = "single_freq"
    HARMONICS = "harmonics"
    OCTAVE_PERIODIC = "octave_periodic"


class MusicalScalePitches:
    """Octave-folded closest-pitch snapping (autotune.cpp:89-142)."""

    def __init__(self, all_pitches):
        # first element 0., last 12. (root at next octave)
        self.pitches = list(all_pitches)
        self.equidistant = [
            0.5 * (self.pitches[i] + self.pitches[i + 1])
            for i in range(len(self.pitches) - 1)
        ]

    def closest_pitch(self, root_pitch: float, pitch: float) -> float:
        half_tones_dist = pitch - root_pitch
        octave_dist = half_tones_dist / NUM_HALFTONES_PER_OCTAVE
        # static_cast rounds toward zero; negatives get -1 (autotune.cpp:100-106)
        octaves_translation = int(octave_dist) if octave_dist >= 0.0 else int(octave_dist) - 1
        translated = pitch - octaves_translation * NUM_HALFTONES_PER_OCTAVE
        rel = translated - root_pitch
        i = 0
        while i < len(self.equidistant) and rel >= self.equidistant[i]:
            i += 1
        offset = rel - self.pitches[i]
        return pitch - offset


MAJOR_SCALE = MusicalScalePitches([0.0, 2.0, 4.0, 5.0, 7.0, 9.0, 11.0, 12.0])
MINOR_NATURAL_SCALE = MusicalScalePitches([0.0, 2.0, 3.0, 5.0, 7.0, 8.0, 10.0, 12.0])
MINOR_HARMONIC_SCALE = MusicalScalePitches([0.0, 2.0, 3.0, 5.0, 7.0, 8.0, 11.0, 12.0])


def get_musical_scale(mode: MusicalScaleMode) -> MusicalScalePitches:
    return {
        MusicalScaleMode.MAJOR: MAJOR_SCALE,
        MusicalScaleMode.MINOR_NATURAL: MINOR_NATURAL_SCALE,
        MusicalScaleMode.MINOR_HARMONIC: MINOR_HARMONIC_SCALE,
    }[mode]


def find_closest_pitch(pitch: float, sorted_pitches: list[float]) -> float | None:
    """Closest element of a sorted list (autotune.cpp:189-218)."""
    if not sorted_pitches:
        return None
    i = bisect_left(sorted_pitches, pitch)
    if i == len(sorted_pitches):
        return sorted_pitches[-1]
    if i == 0:
        return sorted_pitches[0]
    return (sorted_pitches[i]
            if abs(pitch - sorted_pitches[i]) < abs(pitch - sorted_pitches[i - 1])
            else sorted_pitches[i - 1])


def autotune_tables(
    *,
    use_autotune: bool = False,
    autotune_type: AutotuneType = AutotuneType.MUSICAL_SCALE,
    musical_scale_mode: MusicalScaleMode = MusicalScaleMode.MAJOR,
    musical_scale_root_note: Note = Note.Do,
    root_note_halftones_transpose: int = 0,
    chord_frequencies: AutotuneChordFrequencies = AutotuneChordFrequencies.HARMONICS,
    bit_chord: int = 0b10010001,
    intervals_size: int = 2,
):
    """Exact numeric tables driving autotune, for the native (C++) pipeline.

    Returns a dict: {"kind": "off"|"scale"|"allowed",
                     "root_pitch", "scale", "equidistant"  (scale mode),
                     "allowed" (chord/interval modes, the exact python list)}.
    """
    if not use_autotune:
        return {"kind": "off"}
    if autotune_type is AutotuneType.MUSICAL_SCALE:
        scale = get_musical_scale(musical_scale_mode)
        root_pitch = (A_PITCH + root_note_halftones_transpose
                      + half_tones_distance(Note.La, musical_scale_root_note))
        return {"kind": "scale", "root_pitch": float(root_pitch),
                "scale": np.asarray(scale.pitches),
                "equidistant": np.asarray(scale.equidistant)}
    if autotune_type is AutotuneType.CHORD:
        allowed = chord_allowed_pitches(musical_scale_root_note,
                                        root_note_halftones_transpose,
                                        chord_frequencies, bit_chord)
    else:
        allowed = intervals_allowed_pitches(musical_scale_root_note,
                                            root_note_halftones_transpose,
                                            intervals_size)
    return {"kind": "allowed", "allowed": np.asarray(allowed, np.float64)}


def mk_autotune_function(
    *,
    use_autotune: bool = False,
    autotune_type: AutotuneType = AutotuneType.MUSICAL_SCALE,
    musical_scale_mode: MusicalScaleMode = MusicalScaleMode.MAJOR,
    musical_scale_root_note: Note = Note.Do,
    root_note_halftones_transpose: int = 0,
    chord_frequencies: AutotuneChordFrequencies = AutotuneChordFrequencies.HARMONICS,
    bit_chord: int = 0b10010001,
    intervals_size: int = 2,
):
    """Build the pitch -> Optional[pitch] snapping function
    (rt.resynth.lib.cpp:1761-1873)."""
    if not use_autotune:
        return lambda p: p

    if autotune_type is AutotuneType.MUSICAL_SCALE:
        scale = get_musical_scale(musical_scale_mode)
        root_pitch = (A_PITCH + root_note_halftones_transpose
                      + half_tones_distance(Note.La, musical_scale_root_note))
        return lambda p: scale.closest_pitch(root_pitch, p)

    if autotune_type is AutotuneType.CHORD:
        allowed = chord_allowed_pitches(musical_scale_root_note,
                                        root_note_halftones_transpose,
                                        chord_frequencies, bit_chord)
        return lambda p: find_closest_pitch(p, allowed)

    # FIXED_SIZE_INTERVALS
    allowed = intervals_allowed_pitches(musical_scale_root_note,
                                        root_note_halftones_transpose,
                                        intervals_size)
    return lambda p: find_closest_pitch(p, allowed)


def chord_allowed_pitches(musical_scale_root_note: Note,
                          root_note_halftones_transpose: int,
                          chord_frequencies: AutotuneChordFrequencies,
                          bit_chord: int) -> list[float]:
    """Chord-mode allowed pitch set (rt.resynth.lib.cpp:1767-1827)."""
    offset = half_tones_distance(Note.Do, musical_scale_root_note)
    if offset < 0:
        offset += NUM_HALFTONES_PER_OCTAVE
    offset += root_note_halftones_transpose
    # lowest chord bit is C4+offset (C_pitch = A4 - 9 + 12, lib.cpp:1776-1778)
    c_pitch = A_PITCH + half_tones_distance(Note.La, Note.Do) + NUM_HALFTONES_PER_OCTAVE
    root_pitch = c_pitch + offset
    allowed: list[float] = []
    bits = [i for i in range(64) if (bit_chord >> i) & 1]
    if chord_frequencies in (AutotuneChordFrequencies.SINGLE_FREQ,
                             AutotuneChordFrequencies.OCTAVE_PERIODIC):
        single = chord_frequencies is AutotuneChordFrequencies.SINGLE_FREQ
        octaves = range(0, 1) if single else range(-5, 6)
        for octave in octaves:
            add = NUM_HALFTONES_PER_OCTAVE * octave
            for i in bits:
                allowed.append(root_pitch + i + add)
    else:  # Harmonics
        midi = Midi()
        n_harmo = 36
        for h in range(1, n_harmo + 1):
            add = int(0.5 + midi.midi_pitch_offset_nth_harmonic(h))
            for i in bits:
                allowed.append(root_pitch + add + i)
                allowed.append(root_pitch - add + i)
    allowed.sort()
    return allowed


def intervals_allowed_pitches(musical_scale_root_note: Note,
                              root_note_halftones_transpose: int,
                              intervals_size: int) -> list[float]:
    """Fixed-size-intervals allowed pitch set (rt.resynth.lib.cpp:1829-1862)."""
    o = half_tones_distance(Note.Do, musical_scale_root_note)
    if o < 0:
        o += NUM_HALFTONES_PER_OCTAVE
    offset = float(o + root_note_halftones_transpose)
    allowed = [offset]
    if intervals_size:
        v = offset - intervals_size
        while v > 0.0:
            allowed.append(v)
            v -= intervals_size
        v = offset + intervals_size
        while v < MAX_AUDIBLE_MIDI_PITCH:
            allowed.append(v)
            v += intervals_size
    allowed.sort()
    return allowed
