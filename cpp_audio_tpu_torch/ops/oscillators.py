"""Oscillator bank primitives — parallel over voices AND time.

The reference advances each oscillator one sample at a time (`Phased::step`,
include/audioelement.h:1450-1467). Here the full phase trajectory of a block
is computed in closed form, parallel over (voices, time) with no recurrence.
Angles are in units of rad/pi (period 2, include/sound.functions.h:57-62);
the anti-alias gain follows freqAliasingMultiplicator
(include/audioelement.h:466-483).

Port of cpp_audio_tpu/ops/oscillators.py: `chunked_cumsum` (a TPU workaround
for XLA's O(n^2) cumsum lowering there) is torch.cumsum over chunk rows here,
which keeps the card's float scans reproducible. Waveform functions follow
include/sound.functions.h:86-138.

Functions that build a tensor from host values take `device=` (default
"cuda"); tensor arguments stay on their own device.
"""

from __future__ import annotations

import math

import torch

from ..device import to_tensor
from . import fastmath


def wrap_phase(phase):
    """Normalize phase into [0, 2) (reference phaseToNormalForm, audioelement.h:417-428)."""
    return torch.remainder(phase, 2.0)


def phase_trajectory(phase0, increments, *, axis: int = -1):
    """Integrate per-sample angle increments into per-sample phases.

    phase0: starting phase(s), shape = increments.shape without `axis`;
    increments: per-sample angle increments (rad/pi), any batch shape.
    Returns (phases, final_phase): each phase is the angle *after* stepping
    (the reference's step() advances the angle before the sample is read);
    final_phase re-enters the next block as phase0. The running sum is
    accumulated in float64 (chunked_cumsum: reproducible on a card) and
    wrapped before the cast back, so a float32 trajectory keeps its phase
    error at the float32 rounding of [0, 2) (the JAX package wraps chunk
    totals for the same reason).
    """
    inc = torch.as_tensor(increments)
    cum = chunked_cumsum(inc.to(torch.float64), axis=axis)
    p0 = to_tensor(phase0, inc.device, torch.float64).to(inc.device)
    phases = wrap_phase(p0.unsqueeze(axis) + cum).to(inc.dtype)
    return phases, phases.select(axis, -1)


def chunked_cumsum(x, *, axis: int = -1, chunk: int = 1024,
                   wrap: float | None = None):
    """Inclusive cumsum along `axis` in two levels: inside chunks of
    `chunk`, then over the chunk totals (recursively), as the JAX package's
    chunked_cumsum shapes it (its chunk is 128, sized for the TPU's matmul
    unit; the chunk changes only the association of the sums).

    On CUDA, torch.cumsum scans a tensor of one row with a look-back scan
    whose float sums differ from run to run, and a few long rows with one
    block per row (~5-8 ms per 2.6M samples). Here every scan has many short
    rows (a single row is scanned beside a zero row), so a long axis runs
    in parallel and the association is fixed: results are reproducible.
    wrap: the totals are taken mod `wrap` before recursing (phases: mod 2).
    """
    x = torch.as_tensor(x)
    if axis not in (-1, x.dim() - 1):
        return torch.movedim(chunked_cumsum(torch.movedim(x, axis, -1),
                                            chunk=chunk, wrap=wrap), -1, axis)
    T = x.shape[-1]
    rows = x.reshape(-1, T)
    if T <= chunk:
        if rows.shape[0] == 1:
            out = torch.cumsum(torch.cat([rows, torch.zeros_like(rows)]), dim=-1,
                               dtype=x.dtype)[:1]
        else:
            out = torch.cumsum(rows, dim=-1, dtype=x.dtype)
        return out.reshape(x.shape)
    pad = (-T) % chunk
    within = torch.cumsum(torch.nn.functional.pad(rows, (0, pad)).reshape(
        rows.shape[0], -1, chunk), dim=-1, dtype=x.dtype)
    totals = within[..., -1]
    if wrap is not None:
        totals = torch.remainder(totals, wrap)
    offsets = chunked_cumsum(totals, chunk=chunk, wrap=wrap) - totals
    out = (within + offsets[..., None]).reshape(rows.shape[0], -1)[:, :T]
    return out.reshape(x.shape)


def wrapped_cumsum(increments):
    """wrap(cumsum(increments)) along the last axis: the phases of
    `phase_trajectory` from phase0 = 0, summed in float64 (chunked_cumsum,
    reproducible on a card) and wrapped before the cast back."""
    inc = torch.as_tensor(increments)
    return wrap_phase(chunked_cumsum(inc.to(torch.float64), wrap=2.0)).to(inc.dtype)


def phase_trajectory_const(phase0, increment, n: int, *, dtype=torch.float32,
                           device="cuda"):
    """Phases for a constant frequency without cumsum error accumulation:
    phase[t] = wrap(phase0 + (t+1) * increment), (...,) -> (..., n)."""
    inc = to_tensor(increment, device, dtype)
    p0 = to_tensor(phase0, inc.device, dtype).to(inc.device)
    t = torch.arange(1, n + 1, dtype=dtype, device=inc.device)
    return wrap_phase(p0.unsqueeze(-1) + inc.unsqueeze(-1) * t)


def sine(phases):
    """sin of a rad/pi phase.

    float32 (the fast render path) uses the degree-9 sin(pi*x) polynomial
    (ops/fastmath.py, ~ -138 dB error — below f32 roundoff); float64 (the
    verification path) keeps the exact libm sin.
    """
    if phases.dtype == torch.float64:
        return torch.sin(math.pi * phases)
    return fastmath.sinpi(phases)


def cosine(phases):
    return torch.cos(math.pi * phases)


def saw(phases):
    """0..1 -> 0..1 then 1..2 -> -1..0 (reference sound.functions.h:127-138)."""
    return torch.where(phases <= 1.0, phases, phases - 2.0)


def square(phases):
    """+1 except (0.5, 1.5) -> -1 (reference sound.functions.h:86-95)."""
    return torch.where((phases > 0.5) & (phases < 1.5), -1.0, 1.0).to(phases.dtype)


def triangle(phases):
    """0..0.5 -> 0..1, 0.5..1.5 -> 1..-1, 1.5..2 -> -1..0 (sound.functions.h:114-125)."""
    return torch.where(phases < 0.5, 2.0 * phases,
                       torch.where(phases < 1.5, 2.0 - 2.0 * phases,
                                   -4.0 + 2.0 * phases))


def pulse(phases, pulse_width, high, low):
    """`high` while phase < width else `low` (reference sound.functions.h:97-112)."""
    return torch.where(phases < pulse_width, to_tensor(high, phases.device, phases.dtype),
                       to_tensor(low, phases.device, phases.dtype))


def pulse_train_levels(pulse_width):
    """DC-free (high, low) levels for a given width (PulseTrainAlgo_::setPulseWidth,
    include/audioelement.h:1699-1718): high = (2-w)/2, low = high-1."""
    w = torch.clamp(torch.as_tensor(pulse_width), 0.0, 2.0)
    high = 0.5 * (2.0 - w)
    return high, high - 1.0


def ring_modulate(a, b):
    """Elementwise product of two signals — RingModulationAlgo
    (include/audioelement.h:3183-3271: both members stepped in lockstep)."""
    return torch.as_tensor(a) * torch.as_tensor(b)


def ring_modulate_sines(inc1, inc2, n: int, *, phase1=0.0, phase2=0.0,
                        dtype=torch.float32, device="cuda"):
    """Two-sine ring mod at constant increments (the reference's Sounds
    cache `ringmods`, include/sounds.h:5-89): sin(pi*ph1(t)) * sin(pi*ph2(t))
    over n samples."""
    p1 = phase_trajectory_const(phase1, inc1, n, dtype=dtype, device=device)
    p2 = phase_trajectory_const(phase2, inc2, n, dtype=dtype, device=device)
    return ring_modulate(sine(p1), sine(p2))


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
