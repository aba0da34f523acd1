"""Fast transcendental approximations for the hot render kernels.

The oscillator banks (models/voicebank.py, models/resynth_bank.py,
csrc/voicebank.cu) spend most of their ALU time in `sin`. Because the
framework keeps every angle in rad/pi units (full cycle = 2, matching the
reference's convention, include/audioelement.h:1393), the argument is already
"range-reduced by construction": sin(pi*x) needs only x -> x - 2*round(x/2)
folding and an odd polynomial — no generic Payne-Hanek reduction like a
library sin(x).

sinpi_poly: max abs error 1.2e-7 in float32 (~ -138 dB), far below the -80 dB
fidelity bar (BASELINE.md). Coefficients are a least-squares fit of
sin(pi*z)/z on z in [-0.5, 0.5] (Chebyshev nodes), degree 9 — the same
numbers as cpp_audio_tpu/ops/fastmath.py and csrc/voicebank.cu.
"""

from __future__ import annotations

import torch

# sin(pi*z) = z*(C1 + C3 z^2 + C5 z^4 + C7 z^6 + C9 z^8), z in [-0.5, 0.5]
_C1 = 3.14159258
_C3 = -5.16770687
_C5 = 2.55003119
_C7 = -0.59804419
_C9 = 0.07721839


def _poly_sinpi(z):
    z2 = z * z
    return z * (_C1 + z2 * (_C3 + z2 * (_C5 + z2 * (_C7 + z2 * _C9))))


def sinpi(x):
    """sin(pi * x) for angles in rad/pi units, any range.

    Folds to the principal period with two rounds, then a degree-9 odd
    polynomial (torch.round rounds half to even, as jnp.round does).
    """
    x = x - 2.0 * torch.round(x * 0.5)          # -> [-1, 1]
    m = torch.round(x)                           # in {-1, 0, 1}
    z = x - m                                    # -> [-0.5, 0.5]
    s = 1.0 - 2.0 * torch.abs(m)                 # (-1)^m
    return s * _poly_sinpi(z)


def sinpi_principal(x):
    """sin(pi * x) for x ALREADY in [-1, 1) (e.g. from an int32 NCO bitcast).

    Saves the outer period fold of `sinpi`.
    """
    m = torch.round(x)
    z = x - m
    s = 1.0 - 2.0 * torch.abs(m)
    return s * _poly_sinpi(z)


def cospi(x):
    """cos(pi * x) = sin(pi * (x + 0.5))."""
    return sinpi(x + 0.5)
