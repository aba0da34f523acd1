"""One-pole IIR filter cascades — time-parallel via chunked scans.

The reference's `Filter<T, 1, KIND, ORDER>` (from cpp.algorithms; used at
include/audioelement.h:2058 for Low/HighPassAlgo and at
include/audioelement.h:1227 for volume smoothing) is a cascade of ORDER
identical one-pole sections, configured from an angle increment
(`initWithAngleIncrement`) and stepped one sample at a time.

Design: a first-order recurrence y[t] = a[t]*y[t-1] + b[t] is solved for a
whole block at once (parallel over voices and over time chunks); an
ORDER-deep cascade is ORDER chained scans. When the coefficient is constant
over the block (every mode except the noise-driven wind filters), the whole
cascade collapses to a single FFT convolution with the analytic impulse
response h[n] = alpha^N * C(n+N-1, N-1) * (1-alpha)^n — one O(T log T)
parallel op regardless of ORDER (the reference itself notes FFT is
preferable for steep filters, source/rt.resynth.lib.vocoder.cpp:735-737).

Coefficient mapping: the cascade's per-section magnitude follows the analog RC
prototype |H_lp|^2 = 1/(1+(f/fc)^2) that the reference's band-gain
compensation assumes (BandPassAlgo_::setCompensation's cross-check,
include/audioelement.h:2129-2143). We use the impulse-invariant mapping
alpha = 1 - exp(-pi * inc), whose time constant is proportional to the signal
period as the volume-smoothing comment requires (audioelement.h:1200).

Port of cpp_audio_tpu/ops/filters.py. torch has no associative scan, so
`linear_recurrence` runs on the chunked form of `chunked_affine_scan`: a
loop of elementwise steps inside chunks (vectorised over every chunk and
row), then the same recursion on the chunk carries. Host arrays go to
`device`; tensors stay on theirs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from ..device import to_tensor

# chunk of linear_recurrence's scan: 3 (c - 1) elementwise steps per level
# and log_c(L) levels make ~280 ops at L = 2.6M for c = 16 (64: ~700)
_SCAN_CHUNK = 16


def alpha_from_angle_increment(increment, *, device="cuda"):
    """EMA coefficient for a cutoff given as angle increment (rad/pi)."""
    inc = to_tensor(increment, device).abs()
    return 1.0 - torch.exp(-np.pi * inc)


def linear_recurrence(a, b, y0=0.0, *, axis: int = -1, device="cuda"):
    """Solve y[t] = a[t] * y[t-1] + b[t] for the whole block at once.

    a, b: same shape, time on `axis`. y0 broadcastable to the non-time shape.
    Returns y with the same shape as b.
    """
    return chunked_affine_scan(a, b, y0, axis=axis, chunk=_SCAN_CHUNK,
                               device=device)


def chunked_affine_scan(a, b, y0=0.0, *, axis: int = -1, chunk: int = 64,
                        device="cuda"):
    """Exact y[t] = a[t]*y[t-1] + b[t] in chunks.

    Time is reshaped to (L/chunk, chunk) so the sequential dependency runs
    only over the chunk axis — a loop of `chunk` elementwise steps, each
    vectorized over all (batch, L/chunk) lanes at once — then the same scan
    runs on the per-chunk carries (depth log_chunk L).

    Exact (not closed-form): every output is produced by the literal
    recurrence; chunk carries re-enter through the within-chunk cumulative
    coefficient product, so ordering differs from the sequential evaluation
    only by one product/add association per chunk boundary.
    """
    b = to_tensor(b, device)
    a = to_tensor(a, b.device, b.dtype)
    a, b = torch.broadcast_tensors(a, b)
    a = torch.movedim(a, axis, -1)
    b = torch.movedim(b, axis, -1)
    # fold y0 into the first step: y[0] = a[0]*y0 + b[0]
    y0 = to_tensor(y0, b.device, b.dtype)
    b = torch.cat([b[..., :1] + a[..., :1] * y0[..., None], b[..., 1:]], dim=-1)

    def scan_flat(a, b):
        L = b.shape[-1]
        if L <= 1:
            return b
        c = min(chunk, L)
        pad = (-L) % c
        if pad:
            # identity steps: y stays on the previous value
            a = torch.nn.functional.pad(a, (0, pad), value=1.0)
            b = torch.nn.functional.pad(b, (0, pad))
        nc = (L + pad) // c
        ac = a.reshape(*a.shape[:-1], nc, c)
        bc = b.reshape(*b.shape[:-1], nc, c)
        y, P = bc[..., 0], ac[..., 0]
        ys, Ps = [y], [P]
        for t in range(1, c):
            y = ac[..., t] * y + bc[..., t]
            P = P * ac[..., t]
            ys.append(y)
            Ps.append(P)
        ylocal = torch.stack(ys, dim=-1)
        Ploc = torch.stack(Ps, dim=-1)
        # carries: z[k] = A[k]*z[k-1] + B[k] over the chunk axis
        z = scan_flat(Ploc[..., -1], ylocal[..., -1])
        carry = torch.nn.functional.pad(z[..., :-1], (1, 0))
        out = ylocal + Ploc * carry[..., None]
        return out.reshape(*b.shape[:-1], L + pad)[..., :L]

    return torch.movedim(scan_flat(a, b), -1, axis)


def onepole_lowpass(x, alpha, y0=0.0, *, axis: int = -1, device="cuda"):
    """y[t] = y[t-1] + alpha*(x[t] - y[t-1]); alpha scalar, per-voice or per-sample."""
    x = to_tensor(x, device)
    alpha = torch.broadcast_to(to_tensor(alpha, x.device, x.dtype), x.shape)
    return linear_recurrence(1.0 - alpha, alpha * x, y0, axis=axis)


def onepole_highpass(x, alpha, y0=0.0, *, axis: int = -1, device="cuda"):
    """Complementary one-pole high-pass: x - lowpass(x)."""
    x = to_tensor(x, device)
    return x - onepole_lowpass(x, alpha, y0, axis=axis)


def cascade(x, alpha, order: int, *, kind: str = "lowpass", axis: int = -1,
            y0=0.0, device="cuda"):
    """ORDER identical one-pole sections in series (reference Filter<_,1,KIND,ORDER>).

    alpha may vary per sample (wind-mode noise-driven cutoffs). All
    sections start from the same y0 (default 0).
    """
    f = onepole_lowpass if kind == "lowpass" else onepole_highpass
    y = to_tensor(x, device)
    for _ in range(order):
        y = f(y, alpha, y0, axis=axis)
    return y


def cascade_impulse_response(alpha, order: int, length: int,
                             dtype=torch.float32, *, device="cuda"):
    """Analytic impulse response of an `order`-stage one-pole lowpass cascade.

    h[n] = alpha^order * C(n+order-1, order-1) * (1-alpha)^n, computed in log
    space for numerical stability at high orders (float32, as the JAX
    package).
    """
    alpha = to_tensor(alpha, device, torch.float32)
    n = torch.arange(length, dtype=torch.float32, device=alpha.device)
    log_binom = (torch.lgamma(n + order) - torch.lgamma(n + 1.0)
                 - math.lgamma(order))
    log_h = (order * torch.log(torch.clamp(alpha, min=1e-30)) + log_binom
             + n * torch.log(torch.clamp(1.0 - alpha, min=1e-30)))
    return torch.exp(log_h).to(dtype)


def cascade_fft(x, alpha, order: int, *, kind: str = "lowpass",
                ir_length: int | None = None, device="cuda"):
    """Constant-coefficient cascade via FFT convolution (time axis last).

    Equivalent to `cascade` with scalar alpha, but a single parallel op —
    the fast path for high-order offline filtering (e.g. wind programs with
    order up to ~89, source/main.birds.cpp:82).
    """
    x = to_tensor(x, device)
    T = x.shape[-1]
    if ir_length is None:
        ir_length = T
    h = cascade_impulse_response(alpha, order, ir_length, dtype=x.dtype,
                                 device=x.device)
    n_fft = 1
    while n_fft < T + ir_length - 1:
        n_fft *= 2
    X = torch.fft.rfft(x, n=n_fft)
    if kind != "highpass":
        return torch.fft.irfft(X * torch.fft.rfft(h, n=n_fft), n=n_fft)[..., :T].to(x.dtype)
    # N-stage complementary HP differs from x - LP^N; build it recursively:
    # hp^N(x) = hp(hp^{N-1}(x)); hp(x) = x - lp(x). In the frequency domain
    # HP^N = (1 - LP)^N, so convolve with the expanded impulse response.
    if order == 1:
        h_hp1 = -h
        h_hp1[0] += 1.0
        return torch.fft.irfft(X * torch.fft.rfft(h_hp1, n=n_fft), n=n_fft)[..., :T].to(x.dtype)
    h1 = cascade_impulse_response(alpha, 1, ir_length, dtype=x.dtype, device=x.device)
    delta = torch.zeros(n_fft, dtype=x.dtype, device=x.device)
    delta[0] = 1.0
    Hf1 = torch.fft.rfft(delta) - torch.fft.rfft(h1, n=n_fft)
    return torch.fft.irfft(X * Hf1 ** order, n=n_fft)[..., :T].to(x.dtype)


def band_gain_compensation(width_factor, order: int, *, device="cuda"):
    """Equal-center-power gain for the HP(LP) band-pass cascade.

    reference BandPassAlgo_::setCompensation (include/audioelement.h:2129-2144):
    compensation = (1 + 1/width_factor^2)^ORDER.
    """
    sq_inv = 1.0 / (to_tensor(width_factor, device) ** 2)
    return (1.0 + sq_inv) ** order
