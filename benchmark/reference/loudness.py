"""ISO 226:2003 equal-loudness contours at 29 frequencies, interpolated in
pitch (cpp.audio include/loudness.h:9-255): the perceived-loudness order of
the tracker's note-ons."""

from __future__ import annotations

import numpy as np

FREQS = np.array([20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0,
                  200.0, 250.0, 315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0,
                  1600.0, 2000.0, 2500.0, 3150.0, 4000.0, 5000.0, 6300.0, 8000.0,
                  10000.0, 12500.0])
ALPHA_F = np.array([0.532, 0.506, 0.480, 0.455, 0.432, 0.409, 0.387, 0.367, 0.349,
                    0.330, 0.315, 0.301, 0.288, 0.276, 0.267, 0.259, 0.253, 0.250,
                    0.246, 0.244, 0.243, 0.243, 0.243, 0.242, 0.242, 0.245, 0.254,
                    0.271, 0.301])
LU = np.array([-31.6, -27.2, -23.0, -19.1, -15.9, -13.0, -10.3, -8.1, -6.2, -4.5,
               -3.1, -2.0, -1.1, -0.4, 0.0, 0.3, 0.5, 0.0, -2.7, -4.1, -1.0, 1.7,
               2.5, 1.2, -2.1, -7.1, -11.2, -10.7, -3.1])
TF = np.array([78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4,
               11.4, 8.6, 6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0,
               -5.4, -1.5, 6.0, 12.6, 13.9, 12.3])
PITCHES = 69.0 + 12.0 * np.log2(FREQS / 440.0)


def _contour(ln: float) -> np.ndarray:
    af = 4.47e-3 * (10.0 ** (0.025 * ln) - 1.14) + (
        0.4 * 10.0 ** (((TF + LU) * 0.1) - 9.0)) ** ALPHA_F
    return 94.0 - LU + (10.0 / ALPHA_F) * np.log10(af)


CONTOURS = np.array([_contour((lv + 2) * 10.0) for lv in range(9)])


def phons_to_index(level: float) -> int:
    return max(0, min(CONTOURS.shape[0] - 1, int(level * 0.1) - 2))


def contour_db(pitch: float, level_index: int) -> float:
    """The contour's SPL (dB) at a MIDI pitch: linear between the two
    table pitches around it, the end values beyond the table."""
    elv = CONTOURS[level_index]
    i = int(np.clip(np.searchsorted(PITCHES, pitch, side="right"), 1, len(PITCHES) - 1))
    lo, hi = PITCHES[i - 1], PITCHES[i]
    if pitch <= lo:
        return float(elv[i - 1])
    if pitch >= hi:
        return float(elv[i])
    r = (pitch - lo) / (hi - lo)
    return float(r * elv[i] + (1.0 - r) * elv[i - 1])
