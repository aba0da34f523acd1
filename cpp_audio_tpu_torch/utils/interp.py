"""Interpolation / easing library (reference `itp::` namespace, cpp.algorithms).

The reference composes envelopes and frequency ramps from an easing-curve enum
(`itp::interpolation`) evaluated as
``itp::interpolate(kind, t, from, toMinusFrom, duration)`` (used at e.g.
include/audioelement.h:733,994 and include/gen.voice.h:446,459).

Curves are pure elementwise functions of normalized progress ``x in [0,1]``.
`ease` takes one curve; `ease_select` takes per-element curve codes and
selects among the curves present. `ease_np` is the host (numpy) twin used by
scheduling code. csrc/voicebank.cu carries the same 23 curves as a `switch`.

`PROPORTIONAL_VALUE_DERIVATIVE` (exponential interpolation, endpoint
dependent) is LINEAR in this endpoint-free table, as in the JAX package.
"""

from __future__ import annotations

import enum
import math

import numpy as np
import torch


class Itp(enum.IntEnum):
    LINEAR = 0
    PROPORTIONAL_VALUE_DERIVATIVE = 1
    EASE_IN_QUAD = 2
    EASE_OUT_QUAD = 3
    EASE_INOUT_QUAD = 4
    EASE_IN_CUBIC = 5
    EASE_OUT_CUBIC = 6
    EASE_INOUT_CUBIC = 7
    EASE_IN_QUART = 8
    EASE_OUT_QUART = 9
    EASE_INOUT_QUART = 10
    EASE_IN_QUINT = 11
    EASE_OUT_QUINT = 12
    EASE_INOUT_QUINT = 13
    EASE_IN_SINE = 14
    EASE_OUT_SINE = 15
    EASE_INOUT_SINE = 16
    EASE_IN_EXPO = 17
    EASE_OUT_EXPO = 18
    EASE_INOUT_EXPO = 19
    EASE_IN_CIRC = 20
    EASE_OUT_CIRC = 21
    EASE_INOUT_CIRC = 22


N_CURVES = 23


def _in_out(fin, fout):
    def f(x):
        return torch.where(x < 0.5, 0.5 * fin(2.0 * x),
                           0.5 + 0.5 * fout(2.0 * x - 1.0))

    return f


def _ease_in_quad(x):
    return x * x


def _ease_out_quad(x):
    return x * (2.0 - x)


def _ease_in_cubic(x):
    return x * x * x


def _ease_out_cubic(x):
    y = x - 1.0
    return y * y * y + 1.0


def _ease_in_quart(x):
    return x * x * x * x


def _ease_out_quart(x):
    y = x - 1.0
    return 1.0 - y * y * y * y


def _ease_in_quint(x):
    return x * x * x * x * x


def _ease_out_quint(x):
    y = x - 1.0
    return y * y * y * y * y + 1.0


def _ease_in_sine(x):
    return 1.0 - torch.cos(x * (math.pi / 2.0))


def _ease_out_sine(x):
    return torch.sin(x * (math.pi / 2.0))


def _ease_in_expo(x):
    # 2**(10(x-1)), pinned to exactly 0 at x=0 (Penner convention)
    return torch.where(x <= 0.0, 0.0, torch.exp2(10.0 * (x - 1.0)))


def _ease_out_expo(x):
    return torch.where(x >= 1.0, 1.0, 1.0 - torch.exp2(-10.0 * x))


def _ease_in_circ(x):
    return 1.0 - torch.sqrt(torch.clamp(1.0 - x * x, min=0.0))


def _ease_out_circ(x):
    y = x - 1.0
    return torch.sqrt(torch.clamp(1.0 - y * y, min=0.0))


_CURVES = {
    Itp.LINEAR: lambda x: x,
    # endpoint-dependent; approximated by LINEAR in the endpoint-free table
    Itp.PROPORTIONAL_VALUE_DERIVATIVE: lambda x: x,
    Itp.EASE_IN_QUAD: _ease_in_quad,
    Itp.EASE_OUT_QUAD: _ease_out_quad,
    Itp.EASE_INOUT_QUAD: _in_out(_ease_in_quad, _ease_out_quad),
    Itp.EASE_IN_CUBIC: _ease_in_cubic,
    Itp.EASE_OUT_CUBIC: _ease_out_cubic,
    Itp.EASE_INOUT_CUBIC: _in_out(_ease_in_cubic, _ease_out_cubic),
    Itp.EASE_IN_QUART: _ease_in_quart,
    Itp.EASE_OUT_QUART: _ease_out_quart,
    Itp.EASE_INOUT_QUART: _in_out(_ease_in_quart, _ease_out_quart),
    Itp.EASE_IN_QUINT: _ease_in_quint,
    Itp.EASE_OUT_QUINT: _ease_out_quint,
    Itp.EASE_INOUT_QUINT: _in_out(_ease_in_quint, _ease_out_quint),
    Itp.EASE_IN_SINE: _ease_in_sine,
    Itp.EASE_OUT_SINE: _ease_out_sine,
    Itp.EASE_INOUT_SINE: _in_out(_ease_in_sine, _ease_out_sine),
    Itp.EASE_IN_EXPO: _ease_in_expo,
    Itp.EASE_OUT_EXPO: _ease_out_expo,
    Itp.EASE_INOUT_EXPO: _in_out(_ease_in_expo, _ease_out_expo),
    Itp.EASE_IN_CIRC: _ease_in_circ,
    Itp.EASE_OUT_CIRC: _ease_out_circ,
    Itp.EASE_INOUT_CIRC: _in_out(_ease_in_circ, _ease_out_circ),
}


def ease(kind: Itp, x):
    """Easing curve value at normalized progress x (clamped to [0,1])."""
    return _CURVES[Itp(kind)](torch.clamp(x, 0.0, 1.0))


def ease_select(kind_codes, x, kinds=None):
    """Per-element easing where `kind_codes` is an integer tensor
    broadcastable against x.

    kinds: the curve codes that may occur (host ints); only those curves are
    evaluated. None evaluates all 23, like the JAX package's select over the
    whole table. Codes outside the table leave x unchanged (the select's
    default).
    """
    x = torch.clamp(x, 0.0, 1.0)
    out = x
    for k in (range(N_CURVES) if kinds is None else kinds):
        if int(k) in (Itp.LINEAR, Itp.PROPORTIONAL_VALUE_DERIVATIVE):
            continue  # identity: already the default
        out = torch.where(kind_codes == int(k), _CURVES[Itp(int(k))](x), out)
    return out


def ease_np(kind: Itp, x):
    """Host-side (pure numpy) easing — identical curves, no device dispatch.

    Use this in host scheduling paths (prep code runs per render).
    """
    x = np.clip(np.asarray(x, np.float64), 0.0, 1.0)
    k = Itp(kind)
    if k in (Itp.LINEAR, Itp.PROPORTIONAL_VALUE_DERIVATIVE):
        return x
    if k == Itp.EASE_IN_QUAD:
        return x * x
    if k == Itp.EASE_OUT_QUAD:
        return x * (2.0 - x)
    if k == Itp.EASE_IN_CUBIC:
        return x**3
    if k == Itp.EASE_OUT_CUBIC:
        return (x - 1.0) ** 3 + 1.0
    if k == Itp.EASE_IN_QUART:
        return x**4
    if k == Itp.EASE_OUT_QUART:
        return 1.0 - (x - 1.0) ** 4
    if k == Itp.EASE_IN_QUINT:
        return x**5
    if k == Itp.EASE_OUT_QUINT:
        return (x - 1.0) ** 5 + 1.0
    if k == Itp.EASE_IN_SINE:
        return 1.0 - np.cos(x * np.pi / 2)
    if k == Itp.EASE_OUT_SINE:
        return np.sin(x * np.pi / 2)
    if k == Itp.EASE_IN_EXPO:
        return np.where(x <= 0.0, 0.0, np.exp2(10.0 * (x - 1.0)))
    if k == Itp.EASE_OUT_EXPO:
        return np.where(x >= 1.0, 1.0, 1.0 - np.exp2(-10.0 * x))
    if k == Itp.EASE_IN_CIRC:
        return 1.0 - np.sqrt(np.maximum(0.0, 1.0 - x * x))
    if k == Itp.EASE_OUT_CIRC:
        return np.sqrt(np.maximum(0.0, 1.0 - (x - 1.0) ** 2))
    # in-out pairs
    pairs = {
        Itp.EASE_INOUT_QUAD: (Itp.EASE_IN_QUAD, Itp.EASE_OUT_QUAD),
        Itp.EASE_INOUT_CUBIC: (Itp.EASE_IN_CUBIC, Itp.EASE_OUT_CUBIC),
        Itp.EASE_INOUT_QUART: (Itp.EASE_IN_QUART, Itp.EASE_OUT_QUART),
        Itp.EASE_INOUT_QUINT: (Itp.EASE_IN_QUINT, Itp.EASE_OUT_QUINT),
        Itp.EASE_INOUT_SINE: (Itp.EASE_IN_SINE, Itp.EASE_OUT_SINE),
        Itp.EASE_INOUT_EXPO: (Itp.EASE_IN_EXPO, Itp.EASE_OUT_EXPO),
        Itp.EASE_INOUT_CIRC: (Itp.EASE_IN_CIRC, Itp.EASE_OUT_CIRC),
    }
    fin, fout = pairs[k]
    return np.where(
        x < 0.5, 0.5 * ease_np(fin, 2.0 * x), 0.5 + 0.5 * ease_np(fout, 2.0 * x - 1.0)
    )


def interpolate(kind: Itp, t, from_, to_minus_from, duration, *, device="cuda"):
    """Reference-compatible `itp::interpolate(kind, t, from, toMinusFrom, duration)`.

    Returns ``from + toMinusFrom * ease(t / duration)`` with t clamped into
    [0, duration]. For PROPORTIONAL_VALUE_DERIVATIVE the path is exponential:
    ``from * (to/from)**(t/duration)`` (requires from and to of the same sign
    and nonzero). A floating tensor t keeps its dtype and device; host values
    and integer tensors compute in float64 (the JAX package's x64 promotion)
    on `device`.
    """
    if torch.is_tensor(t) and t.is_floating_point():
        dt, dev = t.dtype, t.device
    else:
        dt = torch.float64
        dev = t.device if torch.is_tensor(t) else torch.device(device)
    t = t.to(dt) if torch.is_tensor(t) else torch.full((), float(t), dtype=dt, device=dev)
    dur = duration.to(dev, dt) if torch.is_tensor(duration) else torch.full(
        (), float(duration), dtype=dt, device=dev)
    x = torch.clamp(t / torch.clamp(dur, min=1e-30), 0.0, 1.0)
    if Itp(kind) == Itp.PROPORTIONAL_VALUE_DERIVATIVE:
        to = from_ + to_minus_from
        return from_ * torch.pow(to / from_, x)
    return from_ + to_minus_from * _CURVES[Itp(kind)](x)
