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

from ..device import to_tensor
from ..utils.profiling import span


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


def rectangular_window(window_size: int) -> np.ndarray:
    return np.ones(window_size, dtype=np.float64)


def _host(x) -> np.ndarray:
    return x.detach().cpu().numpy() if torch.is_tensor(x) else np.asarray(x)


def fft_length_for(window_size: int, zero_padding_factor: int = 1) -> int:
    """Smallest power of two >= window_size * zero_padding_factor."""
    n = 1
    target = window_size * zero_padding_factor
    while n < target:
        n *= 2
    return n


def frame_signal(signal: torch.Tensor, window_size: int, stride: int,
                 n_frames: int) -> torch.Tensor:
    """(..., n_frames, window_size) sliding frames of the last axis as a
    strided view."""
    if n_frames <= 0:
        return signal.new_zeros((*signal.shape[:-1], 0, window_size))
    return signal.unfold(-1, window_size, stride)[..., :n_frames, :]


def _stft_sqmag(signal: torch.Tensor, window: torch.Tensor, *, window_size: int,
                stride: int, fft_length: int) -> torch.Tensor:
    """(..., n_frames, fft_length//2 + 1) squared magnitudes of the last
    axis (a leading batch axis: one batched rfft); frame f covers
    [f*stride, f*stride + window_size)."""
    n = signal.shape[-1]
    n_frames = max(0, (n - window_size) // stride + 1)
    frames = frame_signal(signal, window_size, stride, n_frames) * window
    # scale so a unit sine at a bin center gives sqmag 1
    scale = 2.0 / torch.sum(window)
    spec = torch.fft.rfft(frames, n=fft_length)
    return spec.abs() ** 2 * scale**2


def stft_sqmag(signal, window, stride: int, zero_padding_factor: int = 1,
               use_matmul_dft: bool | None = None, *, device="cuda") -> torch.Tensor:
    """(n_frames, n_bins) squared magnitudes in the signal's dtype. Frame f
    covers [f*stride, f*stride + len(window)). A tensor signal stays on its
    device; host data goes to `device`. use_matmul_dft is accepted for the
    JAX package's signature and ignored (its matmul DFT is a TPU
    workaround)."""
    del use_matmul_dft
    sig = to_tensor(signal, device)
    win = to_tensor(window, sig.device, sig.dtype).to(sig.device)
    ws = int(win.shape[0])
    return _stft_sqmag(sig, win, window_size=ws, stride=int(stride),
                       fft_length=fft_length_for(ws, zero_padding_factor))


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


def extract_local_max_freqs_mags(sqmag, sample_rate: int, fft_length: int,
                                 min_db: float = -200.0, *, device="cuda"):
    """Batched spectral peak extraction -> (is_peak, freq, mag_db) tensors
    shaped like sqmag; a host consumer filters by the mask."""
    is_peak, freq, mag_db = _peaks(to_tensor(sqmag, device), sample_rate=sample_rate,
                                   fft_length=fft_length)
    return is_peak & (mag_db > min_db), freq, mag_db


def extract_top_peaks(sqmag, sample_rate: int, fft_length: int, k: int = 127,
                      *, device="cuda"):
    """Top-k peak extraction on the device -> (freq, mag_db), each
    (n_frames, k), frequency-sorted, with -inf mag padding: only (frames, k)
    values cross to the host tracker."""
    return _top_peaks(to_tensor(sqmag, device), sample_rate=sample_rate,
                      fft_length=fft_length, k=k)


def _top_k_lanes(score: torch.Tensor, k: int, *carried: torch.Tensor):
    """The selection every top-k peak function shares: the k highest
    scores of each row, the earliest lane winning ties, returned in lane
    order with the -inf entries after the finite ones (stable: lane order
    among them). Rows are every index of the leading axes. Returns (top
    score, top lane (int64), *top carried), each (..., k).

    Adjacent bins can never both be peaks (is_peak needs db > prev), so the
    row is first pair-reduced to half width exactly as the JAX package does;
    the selection is then a STABLE sort (torch.topk is not stable). Lane
    order is frequency order: peak bins are >= 2 apart and QIFFT deltas are
    clipped to +-0.5 bin."""
    lane = torch.arange(score.shape[-1], device=score.device).expand_as(score)
    chans = (lane,) + carried
    if score.shape[-1] % 2:
        score = torch.nn.functional.pad(score, (0, 1), value=-torch.inf)
        chans = tuple(torch.nn.functional.pad(c, (0, 1)) for c in chans)
    pick = score[..., ::2] >= score[..., 1::2]
    s2 = torch.where(pick, score[..., ::2], score[..., 1::2])
    c2 = [torch.where(pick, c[..., ::2], c[..., 1::2]) for c in chans]
    if s2.shape[-1] < k:
        s2 = torch.nn.functional.pad(s2, (0, k - s2.shape[-1]), value=-torch.inf)
        c2 = [torch.nn.functional.pad(c, (0, k - c.shape[-1])) for c in c2]
    order = torch.sort(s2, dim=-1, descending=True, stable=True).indices[..., :k]
    top_s = torch.gather(s2, -1, order)
    top_c = [torch.gather(c, -1, order) for c in c2]
    key = torch.where(torch.isfinite(top_s), top_c[0], score.shape[-1])
    by_lane = torch.sort(key, dim=-1, stable=True).indices
    return (torch.gather(top_s, -1, by_lane),
            *(torch.gather(c, -1, by_lane) for c in top_c))


def _top_peaks(sqmag: torch.Tensor, *, sample_rate: int, fft_length: int,
               k: int):
    """Top-k spectral peaks per frame -> (freq, mag_db), each (..., n_frames,
    k): a leading batch axis goes through one top-k over the last axis.

    Contract (cpp_audio_tpu/ops/stft.py:168 and :206-218):
      - top-k by interpolated magnitude, the earliest bin winning ties;
      - output in frequency order within each frame;
      - entries with no peak carry -inf magnitude and come after the finite
        ones, in bin order.
    """
    is_peak, freq, mag_db = _peaks(sqmag, sample_rate=sample_rate,
                                   fft_length=fft_length)
    # the score IS the winner's mag_db (only peaks can win)
    top_db, _lane, top_freq = _top_k_lanes(
        torch.where(is_peak, mag_db, -torch.inf), k, freq)
    return top_freq, top_db


def _top_bins(sq: torch.Tensor, *, sample_rate: int, fft_length: int, k: int):
    """float32 top-k peak SELECTION -> (bins (F, k) int64 ascending, mag_db
    (F, k) with -inf padding and bin 0 on it): `_top_peaks`'s is_peak,
    score and stable top-k, carrying the integer bin instead of the QIFFT
    frequency (JAX stft.py:278). The selection front end of the hybrid
    double-grade analysis (ops/dfft_hybrid.hybrid_peaks_df32)."""
    is_peak, _freq, mag_db = _peaks(sq, sample_rate=sample_rate,
                                    fft_length=fft_length)
    top_db, bins = _top_k_lanes(torch.where(is_peak, mag_db, -torch.inf), k)
    return torch.where(torch.isfinite(top_db), bins, 0), top_db


def frames_sqmag_f64(frames: torch.Tensor, window: torch.Tensor,
                     scale: torch.Tensor, *, fft_length: int) -> torch.Tensor:
    """(F, nb) float64 squared magnitudes of float32 frames: the frames
    times the float64 window, one float64 rfft (cuFFT D2Z on the card),
    times the float64 unit-sine scale (2 / sum(w))^2. The double-grade
    spectrum the JAX package assembled from df32 pairs (ops/dfft.py,
    ops/dfft_hybrid.py) on a chip without float64."""
    spec = torch.fft.rfft(frames.to(torch.float64) * window[None, :],
                          n=fft_length)
    return (spec.real ** 2 + spec.imag ** 2) * scale


def _qifft_df(bins, sp, sc, sn, fin, *, nb: int, sample_rate: int,
              fft_length: int):
    """QIFFT refinement at selected bins, in float64 (JAX stft.py:405,
    there in df32 pairs): a parabola through the dB values of the (b-1, b,
    b+1) squared magnitudes sp, sc, sn, term for term as `_peaks`. The edge
    guards stay: -600 dB sentinels at bin 0 and bin nb-1, |denom| > 1e-12,
    delta clipped to +-0.5. fin: validity mask (False lanes get -inf mag).
    Returns (freq, mag_db), float64 (F, k)."""
    eps = 1e-30
    db = lambda x: 10.0 * torch.log10(torch.clamp(x, min=eps))  # noqa: E731
    dbp = torch.where(bins == 0, -600.0, db(sp))
    dbc = db(sc)
    dbn = torch.where(bins == nb - 1, -600.0, db(sn))
    denom = dbp - 2.0 * dbc + dbn
    pmn = dbp - dbn
    ok = torch.abs(denom) > 1e-12
    delta = torch.where(ok, 0.5 * pmn / torch.where(ok, denom, 1.0), 0.0)
    delta = torch.clamp(delta, -0.5, 0.5)
    freq = (delta + bins.to(torch.float64)) * (sample_rate / fft_length)
    mag = dbc - 0.25 * (pmn * delta)
    return freq, torch.where(fin, mag, -torch.inf)


def ladder_peaks_df(frames: torch.Tensor, window: torch.Tensor,
                    scale: torch.Tensor, *, sample_rate: int, fft_length: int,
                    k: int):
    """The "ladder" double-grade analysis of float32 frames: the float64
    spectrum (frames_sqmag_f64), then selection and values on it
    (_top_peaks_df), in the span "analysis_f64". Returns (freq, mag_db),
    float64 (F, k)."""
    with span("analysis_f64", frames.device):
        sq = frames_sqmag_f64(frames, window, scale, fft_length=fft_length)
        return _top_peaks_df(sq, sample_rate=sample_rate,
                             fft_length=fft_length, k=k)


def _top_peaks_df(sq: torch.Tensor, *, sample_rate: int, fft_length: int,
                  k: int):
    """Double-grade top-k peaks of a float64 squared-magnitude spectrum
    (the "ladder" analysis; JAX stft.py:318, there from a df32 spectrum).
    Returns (freq, mag_db), float64 (F, k), frequency-sorted, -inf padding.

    is_peak compares the float64 sqmag exactly; the selection score is the
    float32 dB of the sqmag, QIFFT-interpolated in float32 as JAX computes
    it (:361-372); the stable top-k carries each winner's float64 (b-1, b,
    b+1) triple, and the QIFFT at it runs in float64 (`_qifft_df`)."""
    F, nb = sq.shape
    eps = 1e-30
    zero = sq.new_zeros((F, 1))
    sq_p = torch.cat([zero, sq[:, :-1]], dim=1)
    sq_n = torch.cat([sq[:, 1:], zero], dim=1)
    lane = torch.arange(nb, device=sq.device)
    at_first = lane[None, :] == 0
    at_last = lane[None, :] == nb - 1
    sq_hi = sq.to(torch.float32)
    is_peak = (((sq_p < sq) | at_first) & (~(sq < sq_n) | at_last)
               & (sq_hi > eps))
    db32 = 10.0 * torch.log10(torch.clamp(sq_hi, min=eps))
    edge = torch.full_like(db32[:, :1], -600.0)
    prev32 = torch.cat([edge, db32[:, :-1]], dim=1)
    nxt32 = torch.cat([db32[:, 1:], edge], dim=1)
    denom32 = prev32 - 2.0 * db32 + nxt32
    ok = torch.abs(denom32) > 1e-12
    delta32 = torch.where(ok, 0.5 * (prev32 - nxt32)
                          / torch.where(ok, denom32, 1.0), 0.0)
    mag32 = db32 - 0.25 * (prev32 - nxt32) * torch.clamp(delta32, -0.5, 0.5)
    top_s, bins, sp, sc, sn = _top_k_lanes(
        torch.where(is_peak, mag32, -torch.inf), k, sq_p, sq, sq_n)
    return _qifft_df(bins, sp, sc, sn, torch.isfinite(top_s), nb=nb,
                     sample_rate=sample_rate, fft_length=fft_length)


def top_peaks_to_lists(freq, mag_db) -> list[list[tuple[float, float]]]:
    """Host conversion of _top_peaks output to per-frame lists."""
    freq = _host(freq)
    mag_db = _host(mag_db)
    valid = np.isfinite(mag_db)
    return [list(zip(freq[f][valid[f]].tolist(), mag_db[f][valid[f]].tolist()))
            for f in range(freq.shape[0])]


def peaks_to_lists(is_peak, freq, mag_db) -> list[list[tuple[float, float]]]:
    """Host conversion: per-frame sorted [(freq, mag_db), ...] lists."""
    is_peak, freq, mag_db = _host(is_peak), _host(freq), _host(mag_db)
    return [list(zip(freq[f][is_peak[f]].tolist(), mag_db[f][is_peak[f]].tolist()))
            for f in range(is_peak.shape[0])]


def db_to_mag(db):
    """DbToMag (rt.resynth.lib.algo.cpp:22-26)."""
    if torch.is_tensor(db):
        return torch.pow(10.0, db / 20.0)
    return 10.0 ** (np.asarray(db) / 20.0)
