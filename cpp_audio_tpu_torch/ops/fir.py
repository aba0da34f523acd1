"""FIR design + FFT convolution.

Replaces two reference components:
  - `fir_coefficients_by_f_sampling` (cpp.algorithms; used by
    include/loudness_filter.h:5-9 to build the equal-loudness FIR)
  - the Octave `firls` codegen path (source/main.gen_headers.cpp:35-126
    emitted a script producing loudness_filter_coefficients_gen.h) — here the
    least-squares design runs in-framework (numpy lstsq), no codegen.

Application is a single FFT convolution (ops.filters.cascade_fft pattern):
the reference's LoudnessCompensationFilterWithLatency
(include/audioelement.h:2327-2349) uses FFT convolution too and reports a
latency of (taps-1)/2 samples for the linear-phase filter.

Port of cpp_audio_tpu/ops/fir.py: the designs are host numpy copies;
`fft_convolve` runs torch.fft on the input's device and dtype (a host array
goes to `device`).
"""

from __future__ import annotations

import numpy as np
import torch

from ..device import to_tensor
from ..utils import loudness
from ..utils.convert import get_nyquist_frequency


def fir_by_freq_sampling(nyquist: float, mag_fn, fft_length: int, num_taps: int) -> np.ndarray:
    """Linear-phase FIR via frequency sampling.

    mag_fn maps frequency (0..nyquist) -> desired magnitude. Returns num_taps
    coefficients (host numpy, f64).
    """
    assert num_taps <= fft_length
    n_bins = fft_length // 2 + 1
    freqs = np.linspace(0.0, nyquist, n_bins)
    mags = np.array([float(mag_fn(f)) for f in freqs])
    # zero-phase ifft -> symmetric impulse response centered at 0
    h_full = np.fft.irfft(mags, n=fft_length)
    # center, truncate to num_taps, apply a Hann window to control truncation ripple
    h = np.roll(h_full, num_taps // 2)[:num_taps]
    w = np.hanning(num_taps)
    return h * w


def firls(num_taps: int, norm_freqs, desired) -> np.ndarray:
    """Least-squares linear-phase (type I) FIR design, like Octave's firls.

    norm_freqs: breakpoints in [0, 1] (1 = Nyquist), in pairs describing
    piecewise-linear desired magnitude like firls(n, F, A). num_taps must be
    odd (the reference uses 2i^2+1, main.gen_headers.cpp:126).
    """
    assert num_taps % 2 == 1, "type-I FIR needs odd length"
    M = (num_taps - 1) // 2
    # dense grid of the piecewise-linear target
    grid = np.linspace(0.0, 1.0, 2048)
    target = np.interp(grid, np.asarray(norm_freqs, np.float64), np.asarray(desired, np.float64))
    # amplitude of a symmetric FIR: A(w) = c0 + 2*sum_k c_k cos(k w), w = pi*grid
    w = np.pi * grid
    basis = np.concatenate(
        [np.ones((len(grid), 1)), 2.0 * np.cos(np.outer(w, np.arange(1, M + 1)))], axis=1
    )
    c, *_ = np.linalg.lstsq(basis, target, rcond=None)
    h = np.concatenate([c[:0:-1], [c[0]], c[1:]])
    return h


def loudness_fir_coefficients(sample_rate: int, fft_length: int, num_taps: int) -> np.ndarray:
    """Equal-loudness FIR (reference loudness_filter.h:5-9 semantics)."""
    nyq = get_nyquist_frequency(sample_rate)
    return fir_by_freq_sampling(
        nyq, lambda f: loudness.equal_loudness_volume_from_freq(f), fft_length, num_taps
    )


def loudness_fir_firls(sample_rate: int, num_taps: int) -> np.ndarray:
    """Least-squares loudness FIR — the in-framework replacement for the
    Octave codegen (main.gen_headers.cpp breakpoint scheme: piecewise-linear
    through the 29 ISO-226 table frequencies, normalized to max 1 like
    make_coefficients_by_least_squares, source/loudness_filter.cpp)."""
    nyq = get_nyquist_frequency(sample_rate)
    fs = [0.0] + list(loudness.FREQS) + [nyq]
    fs = [min(f, nyq) for f in fs]
    vols = [float(loudness.equal_loudness_volume_from_freq(f)) for f in fs]
    h = firls(num_taps, np.asarray(fs) / nyq, vols)
    return h / np.max(np.abs(h))


def fir_latency(num_taps: int) -> int:
    """Group delay of a linear-phase FIR in samples."""
    return (num_taps - 1) // 2


def fft_convolve(x, h, *, trim_latency: bool = False, device="cuda"):
    """FFT convolution along the last axis; output has the length of x.

    With trim_latency=True the output is advanced by (len(h)-1)//2 samples so
    a linear-phase filter is zero-delay (matches how the reference accounts
    for LoudnessCompensationFilterWithLatency's latency). h broadcasts
    against x's leading axes (one filter per row, or one for all).
    """
    x = to_tensor(x, device)
    h = to_tensor(h, x.device, x.dtype).to(x.device)
    T = x.shape[-1]
    L = h.shape[-1]
    n_fft = 1
    while n_fft < T + L - 1:
        n_fft *= 2
    y = torch.fft.irfft(torch.fft.rfft(x, n=n_fft) * torch.fft.rfft(h, n=n_fft), n=n_fft)
    d = (L - 1) // 2 if trim_latency else 0
    return y[..., d : d + T].to(x.dtype)
