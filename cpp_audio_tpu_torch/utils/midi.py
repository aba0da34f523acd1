"""MIDI math: pitches, notes, tuning stretch (reference include/midi.h:10-292).

Pitch A4 = MIDI 69 = 440 Hz. Supports a "tuning stretch" factor like the
reference's `Midi_` (include/midi.h:234-276): with stretch s, one half-tone is a
frequency ratio of ``2**(s/12)``.

Pure-python scalar API plus vectorized helpers that accept numpy arrays.
"""

from __future__ import annotations

import enum
import math
from dataclasses import dataclass

import numpy as np

NUM_HALFTONES_PER_OCTAVE = 12
FREQ_A = 440.0
A_PITCH = 69.0
REF_A_OCTAVE = 4
MAX_AUDIBLE_MIDI_PITCH = 151.0  # ~50 kHz (reference include/midi.h:134)


class Note(enum.IntEnum):
    Do = 0
    Dod = 1
    Re = 2
    Red = 3
    Mi = 4
    Fa = 5
    Fad = 6
    Sol = 7
    Sold = 8
    La = 9
    Lad = 10
    Si = 11


_NOTE_NAMES = ["C", "C#", "D", "D#", "E", "F", "F#", "G", "G#", "A", "A#", "B"]


def note_name(n: Note) -> str:
    return _NOTE_NAMES[int(n)]


def half_tones_distance(a: Note, b: Note) -> int:
    return int(b) - int(a)


@dataclass(frozen=True)
class NoteOctave:
    """Well-tempered note + octave (reference include/midi.h:137-175)."""

    note: Note
    octave: int

    def add_halftones(self, n: int) -> "NoteOctave":
        total = int(self.note) + n
        octave = self.octave + total // NUM_HALFTONES_PER_OCTAVE
        note = Note(total % NUM_HALFTONES_PER_OCTAVE)
        return NoteOctave(note, octave)

    def dist_halftones(self, other: "NoteOctave") -> int:
        return half_tones_distance(self.note, other.note) + NUM_HALFTONES_PER_OCTAVE * (
            other.octave - self.octave
        )

    def __str__(self) -> str:
        return f"({note_name(self.note)} {self.octave})"


def midi_pitch_to_note_deviation(pitch: float) -> tuple[NoteOctave, float]:
    """Well-tempered note plus deviation in [-0.5, 0.5] half-tones.

    reference include/midi.h:192-199.
    """
    pitch_from_ref_a = pitch - A_PITCH
    half_tones_from_ref_a = round(pitch_from_ref_a)
    deviation = pitch_from_ref_a - half_tones_from_ref_a
    no = NoteOctave(Note.La, REF_A_OCTAVE).add_halftones(half_tones_from_ref_a)
    return no, deviation


class Midi:
    """Tuning math with optional stretch (reference include/midi.h:234-276)."""

    unity_tuning_stretch = 1.0

    def __init__(self, tuning_stretch: float = 1.0):
        self.tuning_stretch = tuning_stretch
        self.half_tone_ratio = 2.0 ** (tuning_stretch / NUM_HALFTONES_PER_OCTAVE)

    def get_pitch(self, note: NoteOctave) -> float:
        n = NoteOctave(Note.La, REF_A_OCTAVE).dist_halftones(note)
        return A_PITCH + self.tuning_stretch * n

    def frequency_to_midi_pitch(self, freq):
        """Vectorized; returns NaN for non-positive frequencies."""
        freq = np.asarray(freq, dtype=np.float64)
        with np.errstate(divide="ignore", invalid="ignore"):
            out = A_PITCH + (NUM_HALFTONES_PER_OCTAVE / self.tuning_stretch) * np.log2(
                freq / FREQ_A
            )
        out = np.where(freq > 0, out, np.nan)
        return float(out) if out.ndim == 0 else out

    def Ainterval_to_freq(self, interval_from_a):
        return FREQ_A * self.half_tone_ratio ** np.asarray(interval_from_a, dtype=np.float64)

    def midi_pitch_to_freq(self, pitch):
        out = self.Ainterval_to_freq(np.asarray(pitch, dtype=np.float64) - A_PITCH)
        return float(out) if np.ndim(out) == 0 else out

    def transpose_frequency(self, freq: float, n: int) -> float:
        return freq * self.half_tone_ratio**n

    def midi_pitch_offset_nth_harmonic(self, n: int) -> float:
        # the reference computes log2 in float32 (include/midi.h:270-272:
        # log2<is_constexpr>(static_cast<float>(n))); we keep float64, which
        # stays within 1 f32 ulp of it (pinned by tests/test_reference_oracle
        # .py at that tolerance — glibc log2f and numpy's f32 log2 themselves
        # disagree by 1 ulp, so bitwise parity is not meaningful here)
        return (NUM_HALFTONES_PER_OCTAVE / self.tuning_stretch) * math.log2(n)


def compute_harmonic_pitch_adds(n: int, midi: Midi | None = None) -> np.ndarray:
    """Integral midi-pitch offsets of harmonics 1..n (reference include/midi.h:279-287)."""
    midi = midi or Midi()
    return np.array(
        [int(0.5 + midi.midi_pitch_offset_nth_harmonic(i + 1)) for i in range(n)],
        dtype=np.float64,
    )


# module-level default-tuning vectorized helpers (hot-path friendly)
_DEFAULT = Midi()


def frequency_to_midi_pitch(freq):
    return _DEFAULT.frequency_to_midi_pitch(freq)


def midi_pitch_to_freq(pitch):
    return _DEFAULT.midi_pitch_to_freq(pitch)
