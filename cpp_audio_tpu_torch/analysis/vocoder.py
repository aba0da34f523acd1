"""FFT vocoder (reference source/rt.resynth.lib.vocoder.cpp).

Pipeline per stride S (defaults: 5 ms stride, 0.10 s modulator window, 5
log-spaced bands 100..20000 Hz — rt.resynth.lib.cpp:987-992):
  modulator: Gaussian-windowed band energies (the reference's 4-sigma window,
             vocoder.cpp:241) -> per-band amplitude (FFTModulator,
             vocoder.cpp:101-163)
  carrier:   window of 2S samples, raw FFT -> scale each bin by its band's
             modulator amplitude -> IFFT (FFTCarrier, vocoder.cpp:396-475)
  output:    sample k of the new frame crossfades with sample k+S of the
             previous frame using a LINEAR equal-gain crossfade
             (vocoder.cpp:500-541; stride forced odd by good_stride,
             vocoder.cpp:84-93)

Port of cpp_audio_tpu/analysis/vocoder.py (both fast modulator paths — the
decimated single-sideband one and the full-band one — the exact per-window
modulator, the carrier vocode, `vocode` with its WAV taps, and the
filter-bank variant `vocode_filter_bank` on ops/filters.py's scans). The one-hot "strided sample" matmuls of the JAX package (a TPU
gather workaround) are plain indexing here, its chunked cumsum is the
port's ops/oscillators.chunked_cumsum (reproducible on a card), and the
matmul DFT is dropped.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from ..ops import stft as stft_ops
from ..ops.oscillators import chunked_cumsum
from . import device_tracker

MODULATOR_MAX_FFT = 2**16

# fast-modulator implementation selector ("decimated" | "full"), as in the
# JAX package: "decimated" shrinks each narrow band's ifft to a
# bandwidth-proportional length — same windowed band energies to ~1%.
FAST_MODULATOR_MODE = "decimated"
_SSB_GUARD_HZ = 300.0  # decimated rate >= band width + this (alias guard)
_MIN_SSB_M = 4096      # floor on the per-band ifft length


@dataclass(frozen=True)
class VocoderParams:
    """Defaults from rt.resynth.lib.cpp:986-999."""

    sample_rate: int = 44100
    env_follower_cutoff_ratio: float = 1.0 / 20.0
    modulator_window_size_seconds: float = 0.10
    stride_seconds: float = 0.005
    count_bands: int = 5
    min_freq: float = 100.0
    max_freq: float = 20000.0
    # output mix (voice/carrier/vocoder volumes, rt.resynth.lib.cpp:994-996)
    volume_modulator: float = 0.0
    volume_carrier: float = 0.0
    volume_vocoded: float = 1.0
    # the reference's 4-sigma Gaussian (vocoder.cpp:241); "rectangular" is
    # kept for A/B, as in the JAX package
    modulator_window_shape: str = "gaussian"

    def modulator_window_array(self) -> np.ndarray:
        W = self.modulator_window
        if self.modulator_window_shape == "gaussian":
            return stft_ops.gaussian_window(W, sigmas=4.0)
        return np.ones(W, np.float64)

    @property
    def stride(self) -> int:
        """good_stride: odd (vocoder.cpp:84-93)."""
        s = max(1, int(0.5 + self.stride_seconds * self.sample_rate))
        return s + 1 if s % 2 == 0 else s

    @property
    def modulator_window(self) -> int:
        w = max(1, int(0.5 + self.sample_rate * self.modulator_window_size_seconds))
        if w % 2 == 1:
            w += 1
        return min(MODULATOR_MAX_FFT, w)

    def band_freqs(self) -> np.ndarray:
        """count_bands+1 log-spaced edges (SetupParams::fill_freqs)."""
        return np.exp(np.linspace(np.log(self.min_freq), np.log(self.max_freq),
                                  self.count_bands + 1))


def _band_matrix(freq_edges: np.ndarray, n_bins: int, bin_hz: float) -> np.ndarray:
    """(n_bins, n_bands) indicator: bin b belongs to band i when its frequency
    lies in (edge_i, edge_{i+1}] (FFTModulator binning, vocoder.cpp:134-158)."""
    hz = np.arange(n_bins) * bin_hz
    m = np.zeros((n_bins, len(freq_edges) - 1))
    for i in range(len(freq_edges) - 1):
        m[:, i] = (hz > freq_edges[i]) & (hz <= freq_edges[i + 1])
    return m


def _window_sq(window: int, shape: str) -> np.ndarray:
    """w^2 of the modulator analysis window (host constant)."""
    if shape == "gaussian":
        w = stft_ops.gaussian_window(window, sigmas=4.0)
    else:
        w = np.ones(window, np.float64)
    return w * w


def _amps_from_band_energy(band_e, *, window: int, shape: str):
    """Band amplitude from windowed band energy E_w = sum_t w^2(t) x_b^2(t):
    amp = sqrt(2 E_w / sum(w^2)), so a unit-amplitude in-band sine reads
    amp 1 under any window shape."""
    sumw2 = float(np.sum(_window_sq(window, shape)))
    return torch.sqrt(torch.clamp(2.0 * band_e / sumw2, min=0.0))


def _strided_interp_read(C, *, d: int, stride: int, base: int, n_frames: int):
    """C[(f*stride + base)/d] for f < n_frames with linear interpolation at
    fractional positions; C is edge-replicated past its end. Frame
    f = d*j + i reads position j*stride + (i*stride + base)/d."""
    f = np.arange(n_frames)
    pos = (f % d * stride + base) / d
    offs = np.floor(pos).astype(np.int64)
    alpha = torch.as_tensor(pos - offs, dtype=C.dtype, device=C.device)
    last = C.shape[-1] - 1
    lo = (f // d) * stride + offs
    idx_lo = torch.as_tensor(np.minimum(lo, last), device=C.device)
    idx_hi = torch.as_tensor(np.minimum(lo + 1, last), device=C.device)
    device_tracker.H2D_COPIES += 3
    return C[..., idx_lo] * (1.0 - alpha) + C[..., idx_hi] * alpha


def _windowed_energy_at_frames(C, *, d: int, stride: int, window: int,
                               n_frames: int):
    """E[f] = C[(f*stride+window)/d] - C[(f*stride)/d] for f < n_frames,
    where C is an inclusive cumsum on a d-decimated grid (the rectangular-
    window box sum)."""
    hi = _strided_interp_read(C, d=d, stride=stride, base=window,
                              n_frames=n_frames)
    lo = _strided_interp_read(C, d=d, stride=stride, base=0,
                              n_frames=n_frames)
    return hi - lo


def _windowed_gauss_energy_conv(dens, *, d: int, stride: int, window: int,
                                shape: str, n_frames: int):
    """E_w[f] = sum_l g(l*d) * dens_interp(f*stride/d + l) for f < n_frames
    (g = the w^2 window kernel, dens on a d-decimated grid, linear
    interpolation at the per-residue-class alignment) as one matmul: frame
    f = d*j + i reads position j*S + (i*S)/d, so class i correlates dens
    with kernel k_i[l] = (1-a_i) g[l - q_i] + a_i g[l - q_i - 1] at output
    stride S, executed as a (rows, S) x (S, d*c) product plus c shifted
    diagonal adds (same form as the JAX package). dens (..., m): leading
    axes are a batch, one product for all of it."""
    S = stride
    gd = _window_sq(window, shape)[::d]
    Lg = gd.shape[0]
    K = Lg + S + 1  # kernel span covers the max class shift q_i <= S-1
    i = np.arange(d)
    pos = i * S / d
    q = np.floor(pos).astype(np.int64)
    alpha = pos - q
    u = np.arange(K)
    idx = u[None, :] - q[:, None]

    def safe_gd(v):
        return np.where((v >= 0) & (v < Lg), gd[np.clip(v, 0, Lg - 1)], 0.0)

    kern = (1.0 - alpha)[:, None] * safe_gd(idx) \
        + alpha[:, None] * safe_gd(idx - 1)

    J = -(-n_frames // d)
    c = -(-K // S)  # kernel chunks of S taps
    kpad = np.zeros((d, c * S))
    kpad[:, :K] = kern
    kmat = torch.as_tensor(kpad.reshape(d, c, S), dtype=dens.dtype,
                           device=dens.device)
    device_tracker.H2D_COPIES += 1
    rows = J + c - 1
    need = rows * S  # >= (J-1)*S + K; the extra taps are kernel zeros
    m = dens.shape[-1]
    lead = dens.shape[:-1]
    if need > m:
        dens = torch.nn.functional.pad(dens, (0, need - m))
    else:
        dens = dens[..., :need]
    M = torch.einsum("...rs,dcs->...rdc", dens.reshape(*lead, rows, S),
                     kmat)  # (..., rows, d, c)
    out = M[..., 0:J, :, 0]
    for cc in range(1, c):
        out = out + M[..., cc:cc + J, :, cc]
    return out.reshape(*lead, -1)[..., :n_frames]  # (J, d) interleave -> frames


def _modulator_band_amps_fast(signal, edges, *, window: int, stride: int,
                              n_frames: int, sample_rate: int, mode=None,
                              shape: str = "gaussian"):
    """O(n) band amplitudes over the whole signal -> (n_frames, n_bands);
    a (B, n) signal (a batch of jobs) -> (B, n_frames, n_bands), each FFT
    and product batched over the jobs.

    edges: band-edge frequencies (host values). mode: "decimated" (default)
    or "full". shape: "gaussian" (the reference's window) or "rectangular".
    """
    mode = mode or FAST_MODULATOR_MODE
    edges_t = tuple(float(e) for e in np.asarray(edges))
    fn = (_modulator_band_amps_decimated if mode == "decimated"
          else _modulator_band_amps_full)
    return fn(signal, edges=edges_t, window=window, stride=stride,
              n_frames=n_frames, sample_rate=sample_rate, shape=shape)


def _modulator_band_amps_decimated(signal, *, edges, window: int, stride: int,
                                   n_frames: int, sample_rate: int,
                                   shape: str = "gaussian"):
    """Decimated band energies: one whole-signal rfft, then per band a SMALL
    complex ifft of just that band's positive-frequency bins (single
    sideband at baseband) gives the band's analytic signal z at the rate
    fs_dec = sample_rate * m / n_fft; 2|z|^2 is the band's energy density,
    and windowed sums come from a Gaussian correlation (or a cumsum read at
    interpolated stride positions for the rectangular window). See the JAX
    package's docstring for the error budget (<=0.4% RMS per band)."""
    n = signal.shape[-1]
    lead = signal.shape[:-1]
    fdt = signal.dtype
    n_bands = len(edges) - 1
    if n_frames <= 0:
        return signal.new_zeros((*lead, 0, n_bands))
    n_fft, bands = ssb_bands(edges, n, sample_rate)
    half = n_fft // 2
    X = torch.fft.rfft(signal, n=n_fft)

    def ssb_energy(k_lo, k_hi, m):
        if k_hi < k_lo:
            return signal.new_zeros((*lead, n_frames))
        d = n_fft // m
        seg = X[..., k_lo:k_hi + 1]
        if k_lo == 0 or k_hi == half:  # DC / Nyquist have no conjugate partner
            seg = seg.clone()
            if k_lo == 0:
                seg[..., 0] = seg[..., 0] * 0.5
            if k_hi == half:
                seg[..., -1] = seg[..., -1] * 0.5
        z = torch.fft.ifft(seg, n=m)
        dens = z.real ** 2 + z.imag ** 2
        live = torch.arange(m, device=signal.device) * d < n
        dens = torch.where(live, dens, 0.0).to(fdt)
        if shape == "rectangular":
            delta = _windowed_energy_at_frames(
                chunked_cumsum(dens), d=d, stride=stride, window=window,
                n_frames=n_frames)
        else:
            delta = _windowed_gauss_energy_conv(
                dens, d=d, stride=stride, window=window, shape=shape,
                n_frames=n_frames)
        return 2.0 * d * (m / n_fft) ** 2 * delta

    band_e = torch.stack([ssb_energy(*band) for band in bands],
                         dim=-1)  # (..., n_frames, n_bands)
    return _amps_from_band_energy(band_e, window=window, shape=shape)


def ssb_bands(edges, n: int, sample_rate: int):
    """The decimated modulator's plan for an n-sample signal: (n_fft, [(k_lo,
    k_hi, m), ...]), the whole-signal FFT length and, per band, the
    positive-frequency bin range of the mask (hz > lo) & (hz <= hi) and the
    length m of the band's ifft (k_hi < k_lo: an empty band)."""
    n_fft = 1
    while n_fft < n:
        n_fft *= 2
    guard_bins = int(np.ceil(_SSB_GUARD_HZ * n_fft / sample_rate))
    bands = []
    for lo_hz, hi_hz in zip(edges[:-1], edges[1:]):
        k_lo = int(np.floor(lo_hz * n_fft / sample_rate)) + 1
        k_hi = min(int(np.floor(hi_hz * n_fft / sample_rate)), n_fft // 2)
        m = _MIN_SSB_M
        while m < k_hi - k_lo + 1 + guard_bins:
            m *= 2
        bands.append((k_lo, k_hi, min(m, n_fft)))
    return n_fft, bands


def _modulator_band_amps_full(signal, *, edges, window: int, stride: int,
                              n_frames: int, sample_rate: int,
                              shape: str = "gaussian"):
    """O(n) band amplitudes: per-band band-pass over the WHOLE signal (one
    big FFT + bin mask + ifft per band pair — two real band signals per
    complex ifft), then windowed energy: a w^2 correlation (gaussian) or
    box sums from a cumsum (rectangular)."""
    n = signal.shape[-1]
    n_bands = len(edges) - 1
    if n_frames <= 0:
        return signal.new_zeros((*signal.shape[:-1], 0, n_bands))
    n_fft = 1
    while n_fft < n:
        n_fft *= 2
    fdt = signal.dtype
    cdt = torch.complex128 if fdt == torch.float64 else torch.complex64
    X = torch.fft.fft(signal.to(cdt), n=n_fft)
    idx = torch.arange(n_fft, device=signal.device)
    hz = torch.minimum(idx, n_fft - idx).to(fdt) * (sample_rate / n_fft)
    ys = []
    for p in range(0, n_bands, 2):
        mask_a = ((hz > edges[p]) & (hz <= edges[p + 1])).to(fdt)
        if p + 1 < n_bands:
            mask_b = ((hz > edges[p + 1]) & (hz <= edges[p + 2])).to(fdt)
            z = torch.fft.ifft(X * torch.complex(mask_a, mask_b))
            pair = (z.real, z.imag)
        else:
            z = torch.fft.ifft(X * mask_a)
            pair = (z.real,)
        ys.extend(yy[..., :n] for yy in pair)
    if shape != "rectangular":
        band_e = torch.stack(
            [_windowed_gauss_energy_conv(y * y, d=1, stride=stride,
                                         window=window, shape=shape,
                                         n_frames=n_frames) for y in ys],
            dim=-1)
        return _amps_from_band_energy(band_e, window=window, shape=shape)
    y = torch.stack(ys, dim=-2)
    e = chunked_cumsum(y * y)  # (..., bands, n) inclusive
    # e[min(f*S + W, n-1)] - e[f*S]: the edge clamp of the JAX package
    starts = torch.arange(n_frames, device=signal.device) * stride
    ends = torch.clamp(starts + window, max=n - 1)
    band_e = (e[..., ends] - e[..., starts]).transpose(-1, -2)  # (..., n_frames, bands)
    return _amps_from_band_energy(band_e, window=window, shape=shape)


def _modulator_band_amps(signal, band_mat, *, window: int, stride: int,
                         fft_len: int, shape: str = "gaussian"):
    """(n_frames, n_bands) band amplitudes from sliding windowed FFTs: the
    literal FFTModulator form (vocoder.cpp:122-162) — per window, the
    squared-magnitude spectrum of the 4-sigma Gaussian-windowed frame
    (vocoder.cpp:241), band amplitude = sqrt(sum of sqmag over the band's
    bins). amp^2 = (4/(fft_len*sum(w^2))) * sum_bins |F|^2, so a unit
    in-band sine reads amp 1 under any window. The band sums are a full
    float32 matmul (TF32 is off package-wide: the JAX package's
    precision=HIGHEST)."""
    n = signal.shape[0]
    n_frames = max(0, (n - window) // stride + 1)
    frames = stft_ops.frame_signal(signal, window, stride, n_frames)
    win = (stft_ops.gaussian_window(window, sigmas=4.0) if shape == "gaussian"
           else np.ones(window, np.float64))
    frames = frames * torch.as_tensor(win, dtype=frames.dtype, device=frames.device)
    spec = torch.fft.rfft(frames, n=fft_len)
    scale = 2.0 / np.sqrt(fft_len * float((win * win).sum()))
    sq = spec.abs() ** 2 * scale**2
    return torch.sqrt(sq @ band_mat.to(sq.dtype))


def _carrier_vocode(carrier, band_amps, band_mat_full, *, stride: int,
                    fft_len: int):
    """Modulate carrier FFT frames by band amplitudes and overlap-crossfade.

    Returns the vocoded signal of length n_frames*stride (frame r covers
    output samples [r*stride, (r+1)*stride)). A batch: band_amps (B,
    frames, bands) against a per-job carrier (B, n) or one shared (n,)
    carrier (its frames transformed once) -> (B, n_frames*stride).
    """
    window = 2 * stride
    n = carrier.shape[-1]
    n_frames = max(0, (n - window) // stride + 1)
    frames = stft_ops.frame_signal(carrier, window, stride, n_frames)
    # per-bin gain from that frame's band amplitudes (modulate_bands); full
    # float32 (band_mat_full is 0/1, so the product is exact)
    gains = band_amps @ band_mat_full.T  # (..., frames, bins)
    spec = torch.fft.rfft(frames, n=fft_len)
    sig = torch.fft.irfft(spec * gains, n=fft_len)[..., :window]
    # LINEAR equal-gain crossfade of the first half of frame r with the
    # second half of frame r-1 (vocoder.cpp:538-541): step i = k+1 of the
    # new frame weighs (k+1)/stride
    k = torch.arange(stride, dtype=sig.dtype, device=sig.device)
    w_new = (k + 1.0) / stride
    w_old = 1.0 - w_new
    new_part = sig[..., :stride]
    old_part = torch.cat([sig.new_zeros((*sig.shape[:-2], 1, stride)),
                          sig[..., :-1, stride:]], dim=-2)
    return (new_part * w_new + old_part * w_old).reshape(*sig.shape[:-2], -1)


def modulator_alignment_rows(n: int, params: VocoderParams, n_mod_frames: int):
    """Modulator frame used by each carrier frame: the carrier frame covering
    output [r*S, (r+1)*S) takes the most recent modulator result available at
    its window end (2S + r*S), index r - ceil((W - 2S)/S), clamped."""
    S = params.stride
    W = params.modulator_window
    n_car_frames = max(0, (n - 2 * S) // S + 1)
    offset = max(0, -(-(W - 2 * S) // S))
    return np.clip(np.arange(n_car_frames) - offset, 0, max(n_mod_frames - 1, 0))


def _write_taps(debug_dir, sample_rate: int, taps: dict) -> None:
    """Each named stage signal (a tensor) to <debug_dir>/<name>.wav."""
    from pathlib import Path

    from ..utils import wav as wavio

    d = Path(debug_dir)
    d.mkdir(parents=True, exist_ok=True)
    for name, x in taps.items():
        wavio.write_wav(d / f"{name}.wav", x.cpu().numpy(), sample_rate)


def vocode_filter_bank(modulator, carrier, params: VocoderParams, *,
                       order: int = 1, device_out: bool = False,
                       debug_dir=None, device="cuda"):
    """Filter-bank + envelope-follower vocoder variant.

    The reference preserves this pre-FFT design in comments
    (rt.resynth.lib.vocoder.cpp:46-79 BandPass/EnvelopeFollower, :368-381
    Modulator::feed, :700-717 Carrier::feed, orders :735-737): per band b
    with edges (f_lo, f_hi):
      modulator band   m_b = LP_N(f_hi, HP_N(f_lo, modulator))
      band envelope  env_b = LP_1(f_lo * env_follower_cutoff_ratio, |m_b|)
      carrier band     c_b = LP_N(f_hi, HP_N(f_lo, carrier))
      vocoded          out = sum_b env_b * c_b
    This is where `env_follower_cutoff_ratio` (rt.resynth.lib.cpp:985,
    default 1/20) acts. Bands stack on a leading axis; each one-pole
    cascade is a chunked linear recurrence (ops/filters), float32 on
    `device`; the result is one host copy (numpy), or with device_out=True
    the tensor. debug_dir: per-band envelopes (clipped to +-1) and the raw
    vocoded signal as WAVs, the JAX package's taps.
    """
    from ..ops import filters as flt
    from ..utils.convert import freq_to_angle_increment

    dev = torch.device(device)
    sr = params.sample_rate
    n = min(len(modulator), len(carrier))
    if n == 0:
        out = torch.zeros(0, dtype=torch.float32, device=dev)
        return out if device_out else out.cpu().numpy()
    fdt = torch.float32
    mod = torch.as_tensor(modulator, dtype=fdt, device=dev)[:n]
    car = torch.as_tensor(carrier, dtype=fdt, device=dev)[:n]
    edges = params.band_freqs()
    f_lo = np.asarray(edges[:-1], np.float32)[:, None]     # (B, 1)
    f_hi = np.asarray(edges[1:], np.float32)[:, None]

    def alpha(f):
        return flt.alpha_from_angle_increment(
            np.asarray(freq_to_angle_increment(f, sr), np.float32), device=dev)

    a_lo, a_hi = alpha(f_lo), alpha(f_hi)
    a_env = alpha(f_lo * np.float32(params.env_follower_cutoff_ratio))

    def band_pass(x):
        y = flt.cascade(x[None, :].expand(len(edges) - 1, n), a_lo, order,
                        kind="highpass")
        return flt.cascade(y, a_hi, order, kind="lowpass")

    env = flt.cascade(band_pass(mod).abs(), a_env, 1, kind="lowpass")
    vocoded = torch.sum(env * band_pass(car), dim=0)
    out = (params.volume_vocoded * vocoded
           + params.volume_modulator * mod
           + params.volume_carrier * car)
    if debug_dir is not None:
        _write_taps(debug_dir, sr, {
            **{f"band_{b}": env[b].clamp(-1.0, 1.0) for b in range(env.shape[0])},
            "vocoded": vocoded})
    return out if device_out else out.cpu().numpy()


def vocode(modulator, carrier, params: VocoderParams, *,
           exact_modulator: bool = False, device_out: bool = False,
           debug_dir=None, device="cuda"):
    """Offline vocoder: (modulator, carrier) mono signals -> mono output.

    Output sample t mixes volume_modulator*modulator + volume_carrier*carrier
    + volume_vocoded*vocoded (Vocoder compute, vocoder.cpp:761-812).
    float32 on `device`; the result is one host copy (numpy), or with
    device_out=True the tensor. exact_modulator=True takes the per-window FFT
    modulator (`_modulator_band_amps`, the reference's own form) instead of
    the O(n) whole-signal one.

    debug_dir: when set, every stage is tapped to WAVs there — modulator,
    carrier, per-band envelope signals, and the raw vocoded signal (the
    reference's IMJ_DEBUG_VOCODER AsyncWavWriter taps,
    rt.resynth.lib.vocoder.cpp:165-174,248-252).
    """
    dev = torch.device(device)
    sr = params.sample_rate
    S = params.stride
    W = params.modulator_window
    n = min(len(modulator), len(carrier))
    modulator = torch.as_tensor(modulator, dtype=torch.float32, device=dev)[:n]
    carrier = torch.as_tensor(carrier, dtype=torch.float32, device=dev)[:n]

    car_fft = stft_ops.fft_length_for(2 * S)
    edges = params.band_freqs()
    bm_car = torch.as_tensor(_band_matrix(edges, car_fft // 2 + 1, sr / car_fft),
                             dtype=torch.float32, device=dev)
    n_mod_frames = max(0, (n - W) // S + 1)
    if n_mod_frames == 0:
        out = torch.zeros(0, dtype=torch.float32, device=dev)
        return out if device_out else out.cpu().numpy()
    if exact_modulator:
        mod_fft = stft_ops.fft_length_for(W)
        bm_mod = torch.as_tensor(_band_matrix(edges, mod_fft // 2 + 1, sr / mod_fft),
                                 dtype=torch.float32, device=dev)
        amps = _modulator_band_amps(modulator, bm_mod, window=W, stride=S,
                                    fft_len=mod_fft,
                                    shape=params.modulator_window_shape)
    else:
        amps = _modulator_band_amps_fast(
            modulator, edges, window=W, stride=S, n_frames=n_mod_frames,
            sample_rate=sr, shape=params.modulator_window_shape)
    rows = torch.as_tensor(modulator_alignment_rows(n, params, n_mod_frames),
                           device=dev)
    amps_aligned = amps[rows]
    vocoded = _carrier_vocode(carrier, amps_aligned, bm_car, stride=S,
                              fft_len=car_fft)
    out_len = vocoded.shape[0]
    if debug_dir is not None:
        # band envelopes at analysis rate, upsampled to audio rate by hold
        env = torch.repeat_interleave(amps_aligned, S, dim=0)[:out_len]
        _write_taps(debug_dir, sr, {
            "modulator": modulator, "carrier": carrier,
            **{f"band_{b}": env[:, b].clamp(-1.0, 1.0) for b in range(env.shape[1])},
            "vocoded": vocoded})
    out = (params.volume_vocoded * vocoded
           + params.volume_modulator * modulator[:out_len]
           + params.volume_carrier * carrier[:out_len])
    return out if device_out else out.cpu().numpy()
