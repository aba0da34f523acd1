"""Framed STFT + spectral peak extraction — batched over all frames at once.

The reference's PeriodicFFT feeds one sample at a time into a sliding window
and runs one FFT per stride (source/rt.resynth.lib.periodicfft.cpp:14-181,
windowing at :252-325). Offline there is no recurrence between frames: every
window is a view of the signal and ALL frames FFT together as one batched
rfft.

Window: half-Gaussian of `sigmas`=4 mirrored to a symmetric even-length
window (half_gaussian_window usage at rt.resynth.lib.periodicfft.cpp:288-293).

Peak extraction (`extractLocalMaxFreqsMags` / findFrequenciesSqMag from
cpp.algorithms, called at source/rt.resynth.lib.cpp:1591-1596): local maxima
of the squared-magnitude spectrum, refined with quadratic interpolation of the
dB values (QIFFT) to sub-bin frequency accuracy. The window is scaled so a
unit-amplitude sine at a bin center yields squared magnitude 1 (0 dB).

Port of cpp_audio_tpu/ops/stft.py. Dropped TPU workarounds: the reshape/concat
framing (a `Tensor.unfold` view here), the matmul DFT for small transforms
(torch.fft.rfft at every size) and the radix top-k select (a stable sort).
"""

from __future__ import annotations

import numpy as np
import torch


def half_gaussian_window(sigmas: float, half_size: int) -> np.ndarray:
    """Right half of a Gaussian window covering `sigmas` standard deviations."""
    i = np.arange(half_size, dtype=np.float64)
    x = sigmas * (i + 0.5) / half_size
    return np.exp(-0.5 * x * x)


def gaussian_window(window_size: int, sigmas: float = 4.0) -> np.ndarray:
    """Symmetric even-length Gaussian analysis window (reference default)."""
    if window_size % 2:
        raise ValueError(f"window_size must be even, got {window_size}")
    half = half_gaussian_window(sigmas, window_size // 2)
    return np.concatenate([half[::-1], half])


def fft_length_for(window_size: int, zero_padding_factor: int = 1) -> int:
    """Smallest power of two >= window_size * zero_padding_factor."""
    n = 1
    target = window_size * zero_padding_factor
    while n < target:
        n *= 2
    return n


def frame_signal(signal: torch.Tensor, window_size: int, stride: int,
                 n_frames: int) -> torch.Tensor:
    """(n_frames, window_size) sliding frames as a strided view."""
    if n_frames <= 0:
        return signal.new_zeros((0, window_size))
    return signal.unfold(0, window_size, stride)[:n_frames]


def _stft_sqmag(signal: torch.Tensor, window: torch.Tensor, *, window_size: int,
                stride: int, fft_length: int) -> torch.Tensor:
    """(n_frames, fft_length//2 + 1) squared magnitudes; frame f covers
    [f*stride, f*stride + window_size)."""
    n = signal.shape[0]
    n_frames = max(0, (n - window_size) // stride + 1)
    frames = frame_signal(signal, window_size, stride, n_frames) * window[None, :]
    # scale so a unit sine at a bin center gives sqmag 1
    scale = 2.0 / torch.sum(window)
    spec = torch.fft.rfft(frames, n=fft_length)
    return spec.abs() ** 2 * scale**2


def _peaks(sqmag: torch.Tensor, *, sample_rate: int, fft_length: int):
    """(is_peak, freq, mag_db), each shaped like sqmag: local maxima and
    their QIFFT-refined frequency and dB magnitude. Peaks at DC/Nyquist edges
    are suppressed by -600 dB sentinels."""
    eps = 1e-30
    db = 10.0 * torch.log10(torch.clamp(sqmag, min=eps))
    edge = torch.full_like(db[..., :1], -600.0)
    prev = torch.cat([edge, db[..., :-1]], dim=-1)
    nxt = torch.cat([db[..., 1:], edge], dim=-1)
    is_peak = (db > prev) & (db >= nxt) & (sqmag > eps)
    # QIFFT: parabola through (prev, db, next) in dB
    denom = prev - 2.0 * db + nxt
    delta = torch.where(torch.abs(denom) > 1e-12,
                        0.5 * (prev - nxt) / denom, 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    bins = torch.arange(db.shape[-1], dtype=db.dtype, device=db.device)
    freq = (bins[None, :] + delta) * (sample_rate / fft_length)
    mag_db = db - 0.25 * (prev - nxt) * delta
    return is_peak, freq, mag_db


def _top_peaks(sqmag: torch.Tensor, *, sample_rate: int, fft_length: int,
               k: int):
    """Top-k spectral peaks per frame -> (freq, mag_db), each (n_frames, k).

    Contract (cpp_audio_tpu/ops/stft.py:168 and :206-218):
      - top-k by interpolated magnitude, the earliest bin winning ties;
      - output in frequency order within each frame;
      - entries with no peak carry -inf magnitude and come after the finite
        ones, in bin order.
    Adjacent bins can never both be peaks (is_peak needs db > prev), so the
    spectrum is first pair-reduced to half width exactly as the JAX package
    does; the selection is then a STABLE sort (torch.topk is not stable).
    """
    is_peak, freq, mag_db = _peaks(sqmag, sample_rate=sample_rate,
                                   fft_length=fft_length)
    score = torch.where(is_peak, mag_db, -torch.inf)
    if score.shape[-1] % 2:
        score = torch.nn.functional.pad(score, (0, 1), value=-torch.inf)
        freq = torch.nn.functional.pad(freq, (0, 1))
    se, so = score[:, ::2], score[:, 1::2]
    pick = se >= so
    s2 = torch.where(pick, se, so)
    f2 = torch.where(pick, freq[:, ::2], freq[:, 1::2])
    # the score IS the winner's mag_db (only peaks can win)
    order = torch.sort(s2, dim=-1, descending=True, stable=True).indices[:, :k]
    top_db = torch.gather(s2, -1, order)
    top_freq = torch.gather(f2, -1, order)
    # frequency order within each frame, -inf entries last (stable: bin order)
    key = torch.where(torch.isfinite(top_db), top_freq, torch.inf)
    by_freq = torch.sort(key, dim=-1, stable=True).indices
    return torch.gather(top_freq, -1, by_freq), torch.gather(top_db, -1, by_freq)


def top_peaks_to_lists(freq, mag_db) -> list[list[tuple[float, float]]]:
    """Host conversion of _top_peaks output to per-frame lists."""
    freq = np.asarray(freq)
    mag_db = np.asarray(mag_db)
    valid = np.isfinite(mag_db)
    return [list(zip(freq[f][valid[f]].tolist(), mag_db[f][valid[f]].tolist()))
            for f in range(freq.shape[0])]
