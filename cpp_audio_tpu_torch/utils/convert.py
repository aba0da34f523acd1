"""Frame / frequency / angle conversions.

Angle convention follows the reference (include/sound.functions.h:57-76,
include/audioelement.h:1393): angles and angle increments are expressed in
units of **radian / pi**, so a full period is 2 and
``freq_to_angle_increment(f, sr) = 2 f / sr``.

All functions are plain arithmetic and work on python scalars, numpy arrays and
torch tensors alike.
"""

from __future__ import annotations


def sample_rate_milliseconds(sample_rate: int) -> float:
    return sample_rate / 1000.0


def sample_rate_nanoseconds(sample_rate: int) -> float:
    return sample_rate / 1e9


def nanos_per_frame(sample_rate: int) -> float:
    return 1e9 / sample_rate


def millis_per_frame(sample_rate: int) -> float:
    return 1e3 / sample_rate


def nanoseconds_to_frames(ns: float, sample_rate: int) -> int:
    # reference: include/sound.functions.h:21-26 (rounds to nearest)
    v = 0.5 + sample_rate_nanoseconds(sample_rate) * ns
    assert v >= 0.0
    return int(v)


def ms_to_frames(duration_ms: float, sample_rate: int) -> int:
    # reference: include/sound.functions.h:27-33
    assert duration_ms >= 0.0
    return int(0.5 + sample_rate_milliseconds(sample_rate) * duration_ms)


def frames_to_ms(n: int, sample_rate: int) -> float:
    return millis_per_frame(sample_rate) * n


def period_in_samples_to_freq(sample_rate, period):
    return sample_rate / period


def freq_to_period_in_samples(freq_hz: float, sample_rate: float) -> int:
    if freq_hz <= 0.0:
        return 1
    return int(sample_rate / freq_hz)


def get_nyquist_frequency(sample_rate):
    return period_in_samples_to_freq(sample_rate, 2)


def freq_to_angle_increment(freq, sample_rate):
    """Angle increment (rad/pi units) for a frequency. 2*f/sr."""
    return 2.0 * freq / sample_rate


def angle_increment_to_freq(inc, sample_rate):
    return inc * 0.5 * sample_rate


def angle_increment_to_period_in_continuous_samples(inc):
    # reference: include/sound.functions.h:70-76
    if inc == 0.0:
        return 1.0
    return 2.0 / abs(inc)


def freq_to_period_in_seconds(freq):
    if freq <= 0:
        return 1.0
    return 1.0 / freq
