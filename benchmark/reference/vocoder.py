"""The FFT vocoder of the mono mixdown against the carrier (cpp.audio
source/rt.resynth.lib.vocoder.cpp), with the modulator's band energies
taken from each band's analytic signal at a decimated rate.

Modulator, per band (lo, hi] Hz: the band's positive-frequency bins of the
whole signal's FFT (length n_fft, the power of two at or above n), inverse
transformed at length m (the power of two at or above the band's width plus
a 300 Hz guard, at least 4096) give its analytic signal z at the rate
sample_rate * m / n_fft, one value per d = n_fft / m samples; the energy
density 2|z|^2, windowed by the 4-sigma Gaussian w^2 taken every d samples
and read at frame f's start f * stride / d (linear between grid points, 0
past the end), scaled by 2 d (m / n_fft)^2, is the band's windowed energy
E; its amplitude is sqrt(2 E / sum(w^2)).
Carrier, per frame r of 2 * stride samples at stride `stride`: its FFT, each
bin scaled by the amplitude of its band in modulator frame rows[r], the
inverse FFT; the first half of frame r crossfades linearly with the second
half of frame r - 1. Output mix: vol_voc * vocoded + vol_mod * modulator +
vol_car * carrier.
"""

from __future__ import annotations

import numpy as np
import torch

from .analysis import fft_length, gaussian_window
from .precision import Precision

GUARD_HZ = 300.0
MIN_M = 4096


def band_plan(edges, n: int, sample_rate: int):
    n_fft = fft_length(n)
    guard = int(np.ceil(GUARD_HZ * n_fft / sample_rate))
    plan = []
    for lo, hi in zip(edges[:-1], edges[1:]):
        k_lo = int(np.floor(lo * n_fft / sample_rate)) + 1
        k_hi = min(int(np.floor(hi * n_fft / sample_rate)), n_fft // 2)
        m = MIN_M
        while m < k_hi - k_lo + 1 + guard:
            m *= 2
        plan.append((k_lo, k_hi, min(m, n_fft)))
    return n_fft, plan


def band_amps(mono: torch.Tensor, cfg: dict, prec: Precision) -> torch.Tensor:
    """(n_frames, n_bands) modulator band amplitudes."""
    sr, S, W = cfg["sample_rate"], cfg["stride"], cfg["window"]
    edges = cfg["edges"]
    n = mono.shape[0]
    n_frames = max(0, (n - W) // S + 1)
    dev = mono.device
    n_fft, plan = band_plan(edges, n, sr)
    X = torch.fft.rfft(prec.fft_in(mono), n=n_fft)
    w2 = gaussian_window(W) ** 2
    amps = []
    for k_lo, k_hi, m in plan:
        if k_hi < k_lo:
            amps.append(torch.zeros(n_frames, dtype=prec.dtype, device=dev))
            continue
        d = n_fft // m
        seg = X[k_lo:k_hi + 1].clone()
        if k_lo == 0:
            seg[0] *= 0.5
        if k_hi == n_fft // 2:
            seg[-1] *= 0.5
        z = torch.fft.ifft(seg, n=m)
        dens = (z.real ** 2 + z.imag ** 2).to(prec.dtype)
        dens = torch.where(torch.arange(m, device=dev) * d < n, dens, 0.0)
        gd = torch.as_tensor(w2[::d], dtype=prec.dtype, device=dev)
        pos = np.arange(n_frames) * S / d
        base = np.floor(pos).astype(np.int64)
        a = torch.as_tensor(pos - base, dtype=prec.dtype, device=dev)[:, None]
        idx = torch.as_tensor(base, device=dev)[:, None] + torch.arange(len(gd), device=dev)[None, :]
        padded = torch.cat([dens, dens.new_zeros(len(gd) + 2)])
        at = lambda i: padded[torch.clamp(i, max=padded.shape[0] - 1)]  # noqa: E731
        interp = at(idx) * (1.0 - a) + at(idx + 1) * a
        e = prec.matmul(interp, gd[:, None])[:, 0]
        band_e = 2.0 * d * (m / n_fft) ** 2 * e
        amps.append(torch.sqrt(torch.clamp(2.0 * band_e / float(w2.sum()), min=0.0)))
    return torch.stack(amps, dim=1)


def vocode(mono: torch.Tensor, carrier: torch.Tensor, cfg: dict,
           prec: Precision) -> torch.Tensor:
    """The output mix, (n_carrier_frames * stride,)."""
    sr, S, W = cfg["sample_rate"], cfg["stride"], cfg["window"]
    edges = np.asarray(cfg["edges"], np.float64)
    n = mono.shape[0]
    dev = mono.device
    amps = band_amps(mono, cfg, prec)
    n_mod = amps.shape[0]
    n_car = max(0, (n - 2 * S) // S + 1)
    offset = max(0, -(-(W - 2 * S) // S))
    rows = torch.as_tensor(np.clip(np.arange(n_car) - offset, 0, max(n_mod - 1, 0)), device=dev)
    nfft = fft_length(2 * S)
    hz = np.arange(nfft // 2 + 1) * (sr / nfft)
    band_of_bin = np.stack([(hz > lo) & (hz <= hi) for lo, hi in zip(edges[:-1], edges[1:])],
                           axis=1).astype(np.float64)  # (bins, bands)
    gains = prec.matmul(amps[rows], torch.as_tensor(band_of_bin.T, device=dev))
    car = carrier.to(prec.dtype)
    idx = (torch.arange(n_car, device=dev)[:, None] * S
           + torch.arange(2 * S, device=dev)[None, :])
    spec = torch.fft.rfft(prec.fft_in(car[idx]), n=nfft)
    sig = torch.fft.irfft(spec * prec.fft_in(gains), n=nfft)[:, :2 * S].to(prec.dtype)
    k = torch.arange(S, dtype=prec.dtype, device=dev)
    w_new = (k + 1.0) / S
    old = torch.cat([sig.new_zeros((1, S)), sig[:-1, S:]], dim=0)
    vocoded = (sig[:, :S] * w_new + old * (1.0 - w_new)).reshape(-1)
    L = vocoded.shape[0]
    return (cfg["vol_voc"] * vocoded + cfg["vol_mod"] * mono[:L].to(prec.dtype)
            + cfg["vol_car"] * car[:L])
