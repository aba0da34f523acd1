"""The analysis peaks: a sliding Gaussian STFT, its local maxima and their
quadratic-interpolated frequency and level.

Frame f covers samples [f * stride, f * stride + window) of the mono
mixdown, times a 4-sigma Gaussian window; its spectrum, scaled so that a
unit sine at a bin centre reads 1, is in dB; a bin is a peak where it is
above the bin before and not below the bin after (edges count as -600 dB);
a parabola through the three dB values gives the peak's frequency and level.
"""

from __future__ import annotations

import numpy as np
import torch

from .precision import Precision


def gaussian_window(size: int, sigmas: float = 4.0) -> np.ndarray:
    half = size // 2
    x = sigmas * (np.arange(half, dtype=np.float64) + 0.5) / half
    h = np.exp(-0.5 * x * x)
    return np.concatenate([h[::-1], h])


def fft_length(size: int) -> int:
    n = 1
    while n < size:
        n *= 2
    return n


def peaks(mono: torch.Tensor, *, window: int, stride: int, sample_rate: int,
          prec: Precision, frames_per_block: int = 128):
    """Every frame's local maxima as (frame, freq_hz, level_db) host float64
    arrays, ordered by frame and frequency."""
    n = mono.shape[0]
    n_frames = max(0, (n - window) // stride + 1)
    nfft = fft_length(window)
    w = torch.as_tensor(gaussian_window(window), dtype=prec.dtype, device=mono.device)
    scale = float((2.0 / w.double().sum()) ** 2)
    out_f, out_hz, out_db = [], [], []
    for f0 in range(0, n_frames, frames_per_block):
        f1 = min(n_frames, f0 + frames_per_block)
        idx = (torch.arange(f0, f1, device=mono.device)[:, None] * stride
               + torch.arange(window, device=mono.device)[None, :])
        spec = torch.fft.rfft(prec.fft_in(mono.to(prec.dtype)[idx] * w), n=nfft)
        sq = ((spec.real ** 2 + spec.imag ** 2) * scale).to(prec.dtype)
        db = 10.0 * torch.log10(torch.clamp(sq, min=1e-30))
        edge = torch.full_like(db[:, :1], -600.0)
        prev = torch.cat([edge, db[:, :-1]], dim=1)
        nxt = torch.cat([db[:, 1:], edge], dim=1)
        is_peak = (db > prev) & (db >= nxt) & (sq > 1e-30)
        den = prev - 2.0 * db + nxt
        delta = torch.where(den.abs() > 1e-12, 0.5 * (prev - nxt) / den, 0.0).clamp(-0.5, 0.5)
        bins = torch.arange(db.shape[1], dtype=db.dtype, device=db.device)[None, :]
        hz = (bins + delta) * (sample_rate / nfft)
        lvl = db - 0.25 * (prev - nxt) * delta
        fr, b = torch.nonzero(is_peak, as_tuple=True)
        out_f.append((fr + f0).cpu().numpy())
        out_hz.append(hz[fr, b].double().cpu().numpy())
        out_db.append(lvl[fr, b].double().cpu().numpy())
    if not out_f:
        return np.zeros(0, np.int64), np.zeros(0), np.zeros(0)
    return np.concatenate(out_f), np.concatenate(out_hz), np.concatenate(out_db)


def peak_gap_db(ref, freq_p: np.ndarray, mag_p: np.ndarray, *, bin_hz: float,
                fft_bins: int, span_db: float, floor_db: float,
                rank_margin_db: float) -> float:
    """The widest gap in dB between the reference's and the program's peaks.

    ref: peaks() of the reference (every local maximum). freq_p, mag_p: the
    program's (frames, k) top-k peaks (non-finite level: no peak). The
    peaks compared are those within span_db of the frame's loudest reference
    peak and above floor_db. Each such program peak is matched with the
    reference peak nearest in frequency; each such reference peak with the
    program's, where the program kept it: when the program's k are all
    taken, a reference peak less than rank_margin_db above the quietest
    peak kept may rank either side of the cut, and is not required. A match
    further than half a bin away counts as a gap of 999 dB (a missing or a
    spurious peak). Peaks within a bin of 0 Hz or of Nyquist are left out
    on both sides: the spectrum's ends count as -600 dB neighbours, so a
    first bin at or above the second is a peak whose interpolated level is
    ~60 dB above the bin's, and where the lowest bins lie flat at the noise
    floor float32 rounding decides whether it is one."""
    fr, hz, db = ref
    nyquist = bin_hz * (fft_bins - 1)
    inner = lambda h: (h > bin_hz) & (h < nyquist - bin_hz)  # noqa: E731
    worst = 0.0
    for f in range(freq_p.shape[0]):
        sel = (fr == f) & inner(hz)
        rh, rd = hz[sel], db[sel]
        ok = np.isfinite(mag_p[f])
        ph, pd = freq_p[f][ok].astype(np.float64), mag_p[f][ok].astype(np.float64)
        ph, pd = ph[inner(ph)], pd[inner(ph)]
        if len(rd) == 0:
            if (pd >= floor_db).any():
                return 999.0
            continue
        floor = max(rd.max() - span_db, floor_db)
        full = ok.all() and len(pd) > 0
        need_r = rd >= (max(floor, pd.min() + rank_margin_db) if full else floor)
        for a_h, a_d, b_h, b_d in ((rh[need_r], rd[need_r], ph, pd),
                                   (ph[pd >= floor], pd[pd >= floor], rh, rd)):
            if len(a_h) == 0:
                continue
            if len(b_h) == 0:
                return 999.0
            j = np.searchsorted(b_h, a_h)
            lo, hi = np.clip(j - 1, 0, len(b_h) - 1), np.clip(j, 0, len(b_h) - 1)
            near = np.where(np.abs(b_h[lo] - a_h) <= np.abs(b_h[hi] - a_h), lo, hi)
            if (np.abs(b_h[near] - a_h) > 0.5 * bin_hz).any():
                return 999.0
            worst = max(worst, float(np.abs(b_d[near] - a_d).max()))
    return worst
