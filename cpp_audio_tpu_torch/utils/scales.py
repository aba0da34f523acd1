"""Musical scales: well-tempered, just, pythagorean (reference include/scales.h)."""

from __future__ import annotations

import numpy as np

from .midi import frequency_to_midi_pitch

# reference include/scales.h:5-22
WELL_TEMPERED_MINOR_ASC = np.array([0.0, 2.0, 3.0, 5.0, 7.0, 8.0, 10.0])
WELL_TEMPERED_MAJOR_ASC = np.array([0.0, 2.0, 4.0, 5.0, 7.0, 9.0, 11.0])


def mk_scale_from_freq_ratios(freq_ratios) -> np.ndarray:
    """Pitch offsets (first = 0) from frequency ratios (include/scales.h:26-39)."""
    pitches = np.asarray(frequency_to_midi_pitch(np.asarray(freq_ratios, dtype=np.float64)))
    return pitches - pitches[0]


def just_major_scale_asc() -> np.ndarray:
    # reference include/scales.h:54-67
    return mk_scale_from_freq_ratios(
        [1.0, 9.0 / 8.0, 5.0 / 4.0, 4.0 / 3.0, 3.0 / 2.0, 5.0 / 3.0, 15.0 / 8.0]
    )


def pythagorean_major_scale_asc() -> np.ndarray:
    # reference include/scales.h:70-86
    return mk_scale_from_freq_ratios(
        [1.0, 9.0 / 8.0, 81.0 / 64.0, 4.0 / 3.0, 3.0 / 2.0, 27.0 / 16.0, 243.0 / 128.0]
    )


def to_midi_pitches(root_pitch: float, scale_offsets) -> np.ndarray:
    """reference include/scales.h:88-97."""
    return root_pitch + np.asarray(scale_offsets, dtype=np.float64)
