"""Noise tables: white / atom / pink / grey (reference sound.cpp + noise.h).

The reference precomputes looping noise buffers once per sample rate
(getWhiteNoise/getPinkNoise/getGreyNoise, source/sound.cpp:3-47; durations
sr/0.05 ~ 20 s and sr/0.1 ~ 10 s of samples) and normalizes them to peak ~1
(normalize_audio, include/sound.h:95-118). Pink noise is the interpolated
Voss-McCartney construction with Gaussian sources: level i holds a value for
2^i samples and linearly interpolates to the next draw
(GaussianPinkNoiseAlgo + InterpolatedSignal, include/noise.h:11-159); grey
noise is pink noise through the equal-loudness FIR (GaussianGreyNoiseAlgo,
noise.h:167-211).

Host-generated (numpy) since they are one-time constants shipped to the
device. Host copy of cpp_audio_tpu/ops/noise.py; `grey_noise_table` takes the
equal-loudness FIR from this package's ops/fir.py.
"""

from __future__ import annotations

import functools

import numpy as np

from ..utils import loudness  # noqa: F401  (grey noise depends on the contour)

LOWEST_PINK_FREQUENCY = 10.0  # Hz (noise.h:59)


def n_pink_levels(sample_rate: int) -> int:
    """noise.h:75-78: smallest n with sample_rate / 2^n <= 20 Hz."""
    n = 1
    while sample_rate / (1 << n) > 2.0 * LOWEST_PINK_FREQUENCY:
        n += 1
    return n + 1  # relevantBits counts the top bit itself


def white_noise_table(n: int, seed: int = 12345) -> np.ndarray:
    rng = np.random.default_rng(seed)
    v = rng.standard_normal(n)
    return v / np.max(np.abs(v))


def atom_noise_table(n: int, seed: int = 12346) -> np.ndarray:
    rng = np.random.default_rng(seed)
    return np.where(rng.integers(0, 2, n) == 0, 1.0, -1.0)


def pink_noise_table(n: int, sample_rate: int = 44100, seed: int = 12347) -> np.ndarray:
    """Interpolated Voss-McCartney pink noise, normalized to peak 1."""
    rng = np.random.default_rng(seed)
    levels = n_pink_levels(sample_rate)
    total = np.zeros(n)
    for lv in range(levels):
        period = 1 << lv
        n_vals = n // period + 2
        vals = rng.standard_normal(n_vals)
        # linear interpolation between consecutive level draws
        t = np.arange(n) / period
        i0 = t.astype(np.int64)
        frac = t - i0
        total += vals[i0] * (1.0 - frac) + vals[i0 + 1] * frac
    total /= levels
    return total / np.max(np.abs(total))


def grey_noise_table(n: int, sample_rate: int = 44100, seed: int = 12348,
                     num_taps: int = 1023) -> np.ndarray:
    """Pink noise filtered by the equal-loudness FIR (noise.h:167-211)."""
    from .fir import loudness_fir_coefficients

    pink = pink_noise_table(n + num_taps, sample_rate, seed)
    h = loudness_fir_coefficients(sample_rate, 4096, num_taps)
    # FFT convolution (direct np.convolve is ~1e9 MACs at these sizes)
    m = len(pink) + num_taps - 1
    n_fft = 1 << int(np.ceil(np.log2(m)))
    out = np.fft.irfft(np.fft.rfft(pink, n_fft) * np.fft.rfft(h, n_fft), n_fft)
    out = out[num_taps : num_taps + n]
    return out / np.max(np.abs(out))


@functools.lru_cache(maxsize=8)
def get_noise_tables(sample_rate: int) -> dict:
    """Reference-sized looping tables (sound.cpp durations: sr/0.05 samples
    for white/pink, sr/0.1 for grey), with their abs-means (BufferIter's
    getAbsMean, sound.h:229)."""
    n = int(sample_rate / 0.05)
    n_grey = int(sample_rate / 0.1)
    white = white_noise_table(n)
    pink = pink_noise_table(n, sample_rate)
    grey = grey_noise_table(n_grey, sample_rate)
    return {
        "white": white, "pink": pink, "grey": grey,
        "white_abs_mean": float(np.mean(np.abs(white))),
        "pink_abs_mean": float(np.mean(np.abs(pink))),
        "grey_abs_mean": float(np.mean(np.abs(grey))),
    }
