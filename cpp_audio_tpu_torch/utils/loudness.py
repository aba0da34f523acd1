"""ISO-226 equal-loudness volume adjustment (reference include/loudness.h).

The reference tabulates the ISO 226:2003 parameters at 29 frequencies
(include/loudness.h:9-150), derives equal-loudness contours for 20..100 phon
(include/loudness.h:188-216), interpolates **in pitch space**
(include/loudness.h:41-54,232-244) and converts dB to amplitude with a partial
(log_ratio) compensation (include/loudness.h:247-255).

Rebuilt here as numpy constants + vectorized numpy interpolation so a
whole voice bank's loudness volumes are computed in one shot.
"""

from __future__ import annotations

import numpy as np

from .midi import frequency_to_midi_pitch

N_FREQ = 29

FREQS = np.array(
    [20.0, 25.0, 31.5, 40.0, 50.0, 63.0, 80.0, 100.0, 125.0, 160.0, 200.0, 250.0,
     315.0, 400.0, 500.0, 630.0, 800.0, 1000.0, 1250.0, 1600.0, 2000.0, 2500.0,
     3150.0, 4000.0, 5000.0, 6300.0, 8000.0, 10000.0, 12500.0],
    dtype=np.float64,
)

# interpolation happens in pitch space (reference include/loudness.h:41-54)
PITCHES = frequency_to_midi_pitch(FREQS)

ALPHA_F = np.array(
    [0.532, 0.506, 0.480, 0.455, 0.432, 0.409, 0.387, 0.367, 0.349, 0.330, 0.315,
     0.301, 0.288, 0.276, 0.267, 0.259, 0.253, 0.250, 0.246, 0.244, 0.243, 0.243,
     0.243, 0.242, 0.242, 0.245, 0.254, 0.271, 0.301],
    dtype=np.float64,
)

LU = np.array(
    [-31.6, -27.2, -23.0, -19.1, -15.9, -13.0, -10.3, -8.1, -6.2, -4.5, -3.1, -2.0,
     -1.1, -0.4, 0.0, 0.3, 0.5, 0.0, -2.7, -4.1, -1.0, 1.7, 2.5, 1.2, -2.1, -7.1,
     -11.2, -10.7, -3.1],
    dtype=np.float64,
)

TF = np.array(
    [78.5, 68.7, 59.5, 51.1, 44.0, 37.5, 31.5, 26.5, 22.1, 17.9, 14.4, 11.4, 8.6,
     6.2, 4.4, 3.0, 2.2, 2.4, 3.5, 1.7, -1.3, -4.2, -6.0, -5.4, -1.5, 6.0, 12.6,
     13.9, 12.3],
    dtype=np.float64,
)

LN_DEFAULT = 40.0  # phons (reference include/loudness.h:218)


def compute_equal_loudness_volume(i: int, ln: float) -> float:
    """SPL (dB) of the equal-loudness contour at table index i for level ln phon.

    reference include/loudness.h:188-197 (ISO 226:2003 section 4.1 inverted).
    """
    alpha_f = ALPHA_F[i]
    lu = LU[i]
    tf = TF[i]
    af = 4.47e-3 * (10.0 ** (0.025 * ln) - 1.14) + (
        0.4 * 10.0 ** (((tf + lu) * 0.1) - 9.0)
    ) ** alpha_f
    return 94.0 - lu + (10.0 / alpha_f) * np.log10(af)


def _compute_elvs() -> np.ndarray:
    """Contours for 20,30,...,100 phon (reference include/loudness.h:208-216)."""
    return np.array(
        [[compute_equal_loudness_volume(i, (lv + 2) * 10.0) for i in range(N_FREQ)]
         for lv in range(9)],
        dtype=np.float64,
    )


ELVS = _compute_elvs()


def phons_to_index(level: float) -> int:
    # reference include/loudness.h:221-229: 20..100 phon -> index 0..8
    i = int(level * 0.1) - 2
    return max(0, min(ELVS.shape[0] - 1, i))


def _closest_interp(grid: np.ndarray, value):
    """(index, ratio) pair matching reference `closest` (include/loudness.h:152-186).

    ratio is the weight of `index`, 1-ratio the weight of `index-1`. Clamps at
    the table edges. Pure numpy (host-side; device kernels use dense LUTs of
    these values instead — see models.soundengine._loudness_lut).
    """
    value = np.asarray(value, np.float64)
    idx = np.clip(np.searchsorted(grid, value, side="right"), 1, N_FREQ - 1)
    lo = grid[idx - 1]
    hi = grid[idx]
    ratio = np.where(
        value <= lo, 1.0, np.where(value >= hi, 1.0, (value - lo) / (hi - lo))
    )
    # when value <= lo we stand on the *lower* point with weight 1
    idx = np.where(value <= lo, idx - 1, idx)
    return idx, ratio


def equal_loudness_volume_db(value, grid: np.ndarray, level_index: int):
    """Interpolated contour SPL (dB) at `value` (pitch or freq per `grid`)."""
    elv = ELVS[level_index]
    idx, ratio = _closest_interp(grid, value)
    vlo = elv[np.maximum(idx - 1, 0)]
    vhi = elv[idx]
    return ratio * vhi + (1.0 - ratio) * vlo


def db_to_amplitude(db, max_db, log_ratio):
    """reference include/loudness.h:247-255; values above max_db clamp to 1."""
    db = np.asarray(db, np.float64)
    return np.where(db > max_db, 1.0, 10.0 ** (log_ratio * (db - max_db) / 20.0))


def equal_loudness_volume_from_freq(freq, low_index: int = 0, log_ratio: float = 1.0,
                                    level: float = LN_DEFAULT):
    """Amplitude multiplier for equal loudness at `freq` (vectorized).

    reference include/loudness.h:273-275. `low_index` picks the reference
    frequency whose contour SPL maps to amplitude 1.
    """
    i = phons_to_index(level)
    max_db = ELVS[i][low_index]
    db = equal_loudness_volume_db(freq, FREQS, i)
    return db_to_amplitude(db, max_db, log_ratio)


def equal_loudness_volume_from_pitch(pitch, low_index: int = 0, log_ratio: float = 1.0,
                                     level: float = LN_DEFAULT):
    """Same as above but from midi pitch (reference include/loudness.h:276-278)."""
    i = phons_to_index(level)
    max_db = ELVS[i][low_index]
    db = equal_loudness_volume_db(pitch, PITCHES, i)
    return db_to_amplitude(db, max_db, log_ratio)
