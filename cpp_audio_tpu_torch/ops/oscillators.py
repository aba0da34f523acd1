"""Oscillator bank primitives — parallel over voices AND time.

The reference advances each oscillator one sample at a time (`Phased::step`,
include/audioelement.h:1450-1467). Here the full phase trajectory of a block
is computed in closed form, parallel over (voices, time) with no recurrence.
Angles are in units of rad/pi (period 2, include/sound.functions.h:57-62);
the anti-alias gain follows freqAliasingMultiplicator
(include/audioelement.h:466-483).

Port of cpp_audio_tpu/ops/oscillators.py: `chunked_cumsum` (a TPU workaround
for XLA's O(n^2) cumsum lowering) is plain `torch.cumsum` here.
"""

from __future__ import annotations

import math

import torch

from . import fastmath


def wrap_phase(phase):
    """Normalize phase into [0, 2) (reference phaseToNormalForm, audioelement.h:417-428)."""
    return torch.remainder(phase, 2.0)


def sine(phases):
    """sin of a rad/pi phase.

    float32 (the fast render path) uses the degree-9 sin(pi*x) polynomial
    (ops/fastmath.py, ~ -138 dB error — below f32 roundoff); float64 (the
    verification path) keeps the exact libm sin.
    """
    if phases.dtype == torch.float64:
        return torch.sin(math.pi * phases)
    return fastmath.sinpi(phases)


def freq_aliasing_multiplicator(increment):
    """Smooth gain fade approaching the aliasing limit.

    reference include/audioelement.h:466-483: with halfSamplesPerPeriod =
    1/|inc|, gain ramps 0 -> 1 as hspp goes 1 -> 4 (i.e. frequencies above
    sr/8 start fading, silent beyond Nyquist).
    """
    inc = torch.abs(torch.as_tensor(increment))
    hspp = torch.where(inc == 0.0, torch.full_like(inc, math.inf),
                       1.0 / torch.clamp(inc, min=1e-30))
    return torch.clamp((hspp - 1.0) / 3.0, 0.0, 1.0)


def mixdown(signals, gains):
    """Sum a voice bank into output channels: signals (V, T), gains (V, C)
    -> (T, C). This replaces the reference's serial `buffer[i] +=
    voice.imag(j)` accumulation (gen.crtp.h:350-378). Full float32: TF32 is
    off package-wide (device.use_highest_precision)."""
    return torch.einsum("vt,vc->tc", signals, gains.to(signals.dtype))
